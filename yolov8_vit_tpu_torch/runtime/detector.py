"""Detection decode: raw YOLOv8 head maps -> stage-1 NMS'd detections."""
from __future__ import annotations

import torch

from yolov8_vit_tpu_torch.config import DetectConfig
from yolov8_vit_tpu_torch.models.yolov8 import flatten_head_outputs
from yolov8_vit_tpu_torch.ops.dfl import dfl_decode, make_anchors
from yolov8_vit_tpu_torch.ops.nms import efficient_nms_scan


def decode_predictions(head_outputs, cfg: DetectConfig):
    """Per-level head maps -> (num_dets (B,), boxes (B, T, 4), scores
    (B, T), labels (B, T)), boxes xyxy in letterboxed-input pixels, padded
    to cfg.nms_topk rows.  DFL decode and sigmoid run in f32 whatever the
    backbone's dtype: the NMS kept set is sensitive to their precision."""
    if cfg.nms_impl != "scan":
        raise ValueError(f"nms_impl={cfg.nms_impl!r} is not supported; "
                         f"use nms_impl='scan'")
    box_dist, cls_logits = flatten_head_outputs(head_outputs)
    box_dist = box_dist.to(torch.float32)
    anchors, stride = make_anchors(cfg.input_size, cfg.strides,
                                   device=box_dist.device)
    boxes = dfl_decode(box_dist, anchors, stride, cfg.reg_max)
    scores = torch.sigmoid(cls_logits.to(torch.float32))
    return efficient_nms_scan(boxes, scores, iou_threshold=cfg.nms_iou,
                              score_threshold=cfg.nms_conf,
                              max_output=cfg.nms_topk)
