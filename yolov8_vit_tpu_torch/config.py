"""Configuration types of the two-stage pipeline, the classifier's
training and the inspection service (PyTorch port).

The port's own copy of the classifier training config, the detection
config, the class set and the JSON-backed service config of
`yolov8_vit_tpu/config.py`, so nothing here imports the JAX package.  Field names and defaults are identical: engine
`meta.json` files and service `config.json` files written by the JAX
package load unchanged.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Sequence

# 'loss' is an alias of 'lose'
CLASS_NAMES: tuple[str, ...] = ("good", "broke", "lose", "uncovered", "circle")
LABEL_MAPPING: dict[str, int] = {
    "good": 0,
    "broke": 1,
    "lose": 2,
    "loss": 2,
    "uncovered": 3,
    "circle": 4,
}


@dataclasses.dataclass(frozen=True)
class CFG:
    """Classifier training hyper-parameters: SGD with momentum .9 and
    weight decay 1e-3 at a per-epoch cosine-annealed learning rate
    (train/vit_train.py); `pretrained` is the engine dir a retrain
    resumes from, the paths are the VOC XML dirs of the train and valid
    sets, relative to the service's workdir."""

    seed: int = 42
    img_size: tuple[int, int] = (224, 224)
    train_bs: int = 1
    num_classes: int = 5
    epoch: int = 10
    lr: float = 1e-4
    model_name: str = "vit_base_patch8_224.augreg_in21k"
    pretrained: str = "weights/vit_best"
    train_path: Sequence[str] = ("train/new_train", "train/circle",
                                 "train/2024/train_xmls", "train/new")
    valid_path: Sequence[str] = ("train/2024/valid_xmls", "train/new_valid")
    momentum: float = 0.9
    weight_decay: float = 1e-3

    @property
    def valid_bs(self) -> int:
        return self.train_bs * 2


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """Detection-stage parameters.

      - stage-1 EfficientNMS: IoU .65 / conf .25 / topk 100, multi-label;
      - stage-2 conf > .35 filter and area-sorted NMS at IoU .45;
      - crop inflation of ((side // 10) // 2) pixels per side.
    """

    input_size: tuple[int, int] = (640, 640)      # (H, W)
    variant: str = "s"                            # yolov8 n/s/m/l/x
    num_classes: int = 5
    reg_max: int = 16
    strides: tuple[int, ...] = (8, 16, 32)
    nms_iou: float = 0.65
    nms_conf: float = 0.25
    nms_topk: int = 100
    # unused; kept so meta.json files that record it still load
    nms_pre_topk: int = 512
    # "scan" is the only stage-1 NMS (kernel A, ops/nms.py)
    nms_impl: str = "scan"
    conf_second: float = 0.35
    custom_nms_iou: float = 0.45
    inflate_alpha: float = 0.05
    pad_value: int = 114


def detect_config_from_meta(meta_cfg: dict) -> DetectConfig:
    """DetectConfig from an engine meta.json "detect_cfg" dict (JSON lists
    become the tuples the frozen dataclass holds)."""
    kw = dict(meta_cfg)
    for key in ("input_size", "strides"):
        if key in kw:
            kw[key] = tuple(kw[key])
    return DetectConfig(**kw)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process-mesh layout (parallel/mesh.py): the data axis takes the
    processes the model axis leaves; `model_parallel` is the ViT's
    tensor-parallel degree (1 = data parallel only)."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1


class ServiceConfig:
    """JSON-backed mutable service config (thread-safe): keys `num`,
    `standard`, `class_config`, `detect_config`, read-modify-written by
    the retrain counter and the `/getConfig` route under one lock."""

    DEFAULTS = {
        "num": 0,
        "standard": 100,
        "class_config": {"epoch": 10},
        "detect_config": {},
    }

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                json.dump(self.DEFAULTS, f)

    def read(self) -> dict:
        with self._lock, open(self.path) as f:
            return json.load(f)

    def write(self, data: dict) -> None:
        with self._lock, open(self.path, "w") as f:
            json.dump(data, f)

    def update(self, **kv) -> dict:
        with self._lock:
            with open(self.path) as f:
                data = json.load(f)
            data.update(kv)
            with open(self.path, "w") as f:
                json.dump(data, f)
            return data

    def bump_and_check(self) -> tuple[int, bool]:
        """Increment the label counter; return (new_num, retrain_due).
        When num reaches `standard` the retrain is due and the counter
        resets to 0."""
        with self._lock:
            with open(self.path) as f:
                data = json.load(f)
            num = data.get("num", 0) + 1
            due = num >= data.get("standard", self.DEFAULTS["standard"])
            data["num"] = 0 if due else num
            with open(self.path, "w") as f:
                json.dump(data, f)
            return data["num"], due
