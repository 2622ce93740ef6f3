"""Configuration types of the two-stage pipeline (PyTorch port).

The port's own copy of the detection config and class set of
`yolov8_vit_tpu/config.py`, so nothing here imports the JAX package.
Field names and defaults are identical: engine `meta.json` files written
by the JAX package load unchanged.
"""
from __future__ import annotations

import dataclasses

CLASS_NAMES: tuple[str, ...] = ("good", "broke", "lose", "uncovered", "circle")


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
