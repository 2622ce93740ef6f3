"""The reference's `utils/trainClass.py` entry surface, backed by the
port's classifier trainer.

Name for name: `set_seed`, `cosine_anneal_schedule`, `crop_image`,
`build_model` (trainClass's argument order: pretrained before
modelName), `build_loss`, `train(CFG, log)`, `classExport`,
`buildInferModel`, `deliver`, `retrain(log)`.  The loss classes are the
functions of `train/losses.py`.
"""
from __future__ import annotations

import numpy as np

from yolov8_vit_tpu_torch.config import CFG as _CFG
from yolov8_vit_tpu_torch.data.voc import deliver  # noqa: F401
from yolov8_vit_tpu_torch.refapi import Network_Wrapper  # noqa: F401
from yolov8_vit_tpu_torch.train.classify import (set_seed, train, retrain,  # noqa: F401
                                                 build_infer_model)
from yolov8_vit_tpu_torch.train.classify import class_export as _class_export
from yolov8_vit_tpu_torch.train.dataset import crop_record
from yolov8_vit_tpu_torch.train.losses import (combined_loss as build_loss,  # noqa: F401
                                               focal_loss, label_smoothing_ce)  # noqa: F401
from yolov8_vit_tpu_torch.train.schedule import cosine_anneal_schedule  # noqa: F401


def crop_image(image_path: str, x_min, y_min, x_max, y_max,
               training: bool = False, rng=None) -> np.ndarray:
    """Open, inflate and crop: a random inflation of up to w / 10 a side
    at train, a fixed (w / 10) // 2 at eval (the reference code's
    behaviour)."""
    row = {"path": image_path,
           "objects": {"xmin": x_min, "ymin": y_min,
                       "xmax": x_max, "ymax": y_max}}
    return crop_record(row, training, rng or np.random.default_rng())


def build_model(CFG, pretrained: str | None = None,
                modelName: str | None = None, spec=None, device="cuda"):
    """trainClass's `build_model(CFG, pretrained=None, modelName=None)`;
    the argument order differs from `refapi.build_model`.  Returns (model,
    params)."""
    from yolov8_vit_tpu_torch import refapi
    return refapi.build_model(CFG, modelName or CFG.model_name,
                              pretrained, spec=spec, device=device)


def classExport(CFG=_CFG(), pretrained: str | None = None,
                modelName: str | None = None,
                out_dir: str = "weights/class_engine", spec=None) -> str:
    """`classExport`: the fine-tuned wrapper weights as a classify engine
    dir.  Host work: the tree is converted (or drawn) on the CPU and
    written, no model is built."""
    from yolov8_vit_tpu_torch.refapi import (spec_from_timm_name,
                                             wrapper_params)
    if spec is None:
        # the engine meta must describe the architecture the params came
        # from: class_export falls back to CFG.model_name, which for a
        # modelName override would write a meta.json that rebuilds the
        # wrong model at Engine load
        spec = spec_from_timm_name(modelName or CFG.model_name)
    params = wrapper_params(spec, CFG.num_classes, pretrained)
    return _class_export(params, CFG, out_dir, spec=spec)


def buildInferModel(path: str = "weights/class_engine", device="cuda"):
    """`buildInferModel`: the classify engine at `path` on `device`, or
    None (with a printed error) when it cannot be read."""
    return build_infer_model(path, device=device)
