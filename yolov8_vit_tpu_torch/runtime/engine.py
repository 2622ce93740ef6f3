"""Engine: load an engine directory and execute it (TRTModule's API).

    engine = Engine(path, device="cuda")
    engine.set_desired(["num_dets", "bboxes", "scores", "labels"])
    outputs = engine(tensor)            # e.g. a (1, 3, 640, 640) blob

The same API and output contracts as the JAX package's
`runtime/engine.py::Engine`, on the same directories (`meta.json` +
`params.msgpack`, written by either package's `save_engine`):

  "detect"    YOLOv8 (fused-BN layout) + DFL + stage-1 NMS; input a
              letterboxed blob, NCHW float [0, 1] RGB or NHWC; outputs
              num_dets / bboxes / scores / labels in letterboxed pixels.
  "classify"  the ViT classifier as stored (its attn_impl and quant run as
              they are); input NCHW or NHWC images in [-1, 1]; output
              "output", the logits.
  "two_stage" the whole pipeline on uint8 RGB frames (NHWC, or NCHW);
              outputs the TwoStagePipeline dict (TWO_STAGE_OUTPUTS).

An input whose second axis is 1 or 3 and whose last is not is taken as
NCHW and moved to NHWC.  Parameters stay in their stored dtypes; `dtype`
is the activation dtype (two_stage engines ingest uint8 frames).  The
JAX Engine's `aot/` blobs (jax.export and compiled XLA executables with
their host fingerprints) have no counterpart here: the port runs the
model eagerly and ignores that directory.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.config import detect_config_from_meta
from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
from yolov8_vit_tpu_torch.models.vit import ViTClassifier, ViTSpec
from yolov8_vit_tpu_torch.models.yolov8 import YOLOv8, detect_spec
from yolov8_vit_tpu_torch.runtime.detector import decode_predictions
from yolov8_vit_tpu_torch.weights import load_pipeline_tree, load_tree, \
    read_engine

DETECT_OUTPUTS = ("num_dets", "bboxes", "scores", "labels")
TWO_STAGE_OUTPUTS = ("num_dets", "boxes", "det_scores", "det_labels",
                     "final_valid", "cls_labels", "cls_scores")


def _maybe_nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 4 and x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
        return x.permute(0, 2, 3, 1)
    return x


class Engine:
    """Load an engine directory and execute it (TRTModule parity)."""

    def __init__(self, path: str, device="cuda", dtype=torch.float32):
        self.path = path
        self.device = _build.resolve_device(device)
        self.dtype = dtype
        self.meta, tree = read_engine(path)
        self.kind = self.meta["kind"]
        meta = self.meta
        if self.kind in ("detect", "two_stage"):
            self.det_cfg = detect_config_from_meta(meta.get("detect_cfg", {}))
            h, w = self.det_cfg.input_size
        if self.kind in ("classify", "two_stage"):
            self.vit_spec = ViTSpec(**meta.get("vit_spec", {}))
            self.num_classes = meta.get("num_classes", 5)
        # models are moved to the device before loading, so that the
        # derived buffers `load_tree` makes are made there
        if self.kind == "detect":
            self.model = YOLOv8(detect_spec(self.det_cfg,
                                            meta.get("det_spec")),
                                dtype=dtype).to(self.device)
            load_tree(self.model, tree["params"])
            self._desired = list(DETECT_OUTPUTS)
        elif self.kind == "classify":
            self.model = ViTClassifier(self.vit_spec, self.num_classes,
                                       dtype=dtype).to(self.device)
            load_tree(self.model, tree["params"])
            h = w = self.vit_spec.img_size
            self._desired = ["output"]
        elif self.kind == "two_stage":
            self.model = TwoStagePipeline(
                det_cfg=self.det_cfg, vit_spec=self.vit_spec,
                num_classes=self.num_classes,
                classify_budget=meta.get("classify_budget", 4),
                det_overrides=tuple(sorted(meta.get("det_spec", {}).items())),
                dtype=dtype, device=self.device)
            load_pipeline_tree(self.model, tree)
            self._desired = list(TWO_STAGE_OUTPUTS)
        else:
            raise ValueError(f"unknown engine kind {self.kind!r}")
        self.inp_info = [SimpleNamespace(shape=(1, 3, h, w))]
        self._input_dtype = torch.uint8 if self.kind == "two_stage" \
            else dtype

    def set_desired(self, names) -> None:
        """Select and order the outputs __call__ returns."""
        self._desired = list(names)

    @torch.no_grad()
    def __call__(self, tensor):
        x = _maybe_nchw_to_nhwc(torch.as_tensor(tensor))
        x = x.to(self.device, self._input_dtype)
        if self.kind == "detect":
            num, boxes, scores, labels = decode_predictions(
                self.model(x), self.det_cfg)
            outs = {"num_dets": num, "bboxes": boxes, "scores": scores,
                    "labels": labels}
        elif self.kind == "two_stage":
            outs = self.model(x.contiguous())
        else:
            outs = {"output": self.model(x)}
        picked = tuple(outs[n] for n in self._desired)
        return picked if len(picked) > 1 else picked[0]
