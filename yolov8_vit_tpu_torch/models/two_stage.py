"""Two-stage pipeline: detect -> NMS -> inflate -> crop -> classify.

  images (B, H, W, 3) uint8
    -> letterbox to the detector input (bilinear)       [ops.letterbox]
    -> YOLOv8 forward                                   [models.yolov8]
    -> DFL decode + stage-1 EfficientNMS (kernel A)     [runtime.detector]
    -> un-letterbox, clip to the frame                  [ops.boxes]
    -> conf > .35 + area-sorted NMS (kernel B)          [ops.nms]
    -> integer box round + (side//10)//2 inflation      [ops.boxes]
    -> batch compaction to B * budget crop slots
    -> int8 crops in ViT patch layout (gather)          [ops.crop]
    -> classifier -> argmax: the ViT (kernels C-F by quant mode,
       models.vit) or SwinV2 (mt::window_attn, models.swin), whichever
       the spec names; either sits at `self.vit`

Shapes are static per input size, and nothing on the CUDA path waits for
the device: the whole forward enqueues on the current stream.
"""
from __future__ import annotations

import torch
from torch import nn

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.config import DetectConfig
from yolov8_vit_tpu_torch.models.swin import SwinV2Classifier, SwinV2Spec
from yolov8_vit_tpu_torch.models.vit import VIT_B8_224, ViTClassifier, ViTSpec
from yolov8_vit_tpu_torch.models.yolov8 import YOLOv8, detect_spec
from yolov8_vit_tpu_torch.ops import (area_sorted_nms, blob,
                                      crop_to_patches_i8, inflate_boxes,
                                      letterbox_fast, unletterbox_boxes)
from yolov8_vit_tpu_torch.runtime.detector import decode_predictions


class TwoStagePipeline(nn.Module):
    """Both models and the glue between them.  Parameters load from a
    flax-layout tree {"det": {"params": ...}, "vit": {"params": ...}}
    (`weights.load_tree`); the pipeline lives on `device`."""

    def __init__(self, det_cfg: DetectConfig = DetectConfig(),
                 vit_spec: ViTSpec | SwinV2Spec = VIT_B8_224,
                 num_classes: int = 5,
                 classify_budget: int = 4, dtype=torch.float32,
                 det_overrides: tuple = (), device="cuda"):
        super().__init__()
        self.device = _build.resolve_device(device)
        self.det_cfg = det_cfg
        self.vit_spec = vit_spec
        self.num_classes = num_classes
        self.classify_budget = classify_budget
        self.dtype = dtype
        self.det_overrides = det_overrides
        self.det = YOLOv8(detect_spec(det_cfg, det_overrides), dtype=dtype)
        cls = SwinV2Classifier if isinstance(vit_spec, SwinV2Spec) \
            else ViTClassifier
        self.vit = cls(vit_spec, num_classes, dtype=dtype)
        self.to(self.device)

    def classify(self, images: torch.Tensor, slot_img: torch.Tensor,
                 slot_boxes: torch.Tensor):
        """Crop + classify explicit slots -> (labels (K,) i32, scores (K,)
        f32 softmax probability of the argmax)."""
        vs = self.vit_spec
        crops = crop_to_patches_i8(images, slot_img, slot_boxes,
                                   (vs.img_size, vs.img_size), vs.patch)
        probs = torch.softmax(self.vit(crops).to(torch.float32), dim=-1)
        scores, labels = probs.max(dim=-1)
        return labels.to(torch.int32), scores

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> dict:
        """images (B, H, W, 3) uint8 RGB -> dict with static shapes
        (T = nms_topk):
          num_dets (B,) i32        stage-1 kept count
          boxes (B, T, 4) f32      xyxy in original image coords
          det_scores (B, T) f32
          det_labels (B, T) i32    stage-1 class, -1 padded
          final_valid (B, T) bool  survived conf > .35 + area-sorted NMS
          cls_labels (B, T) i32    stage-2 class, -1 where not classified
          cls_scores (B, T) f32    stage-2 softmax prob of the argmax
        """
        cfg = self.det_cfg
        b, h, w = images.shape[:3]
        t = cfg.nms_topk
        dev = images.device

        lb, ratio, dwdh = letterbox_fast(images, cfg.input_size,
                                         pad_value=cfg.pad_value,
                                         dtype=self.dtype)
        head = self.det(blob(lb).to(self.dtype))
        num_dets, boxes_lb, det_scores, det_labels = \
            decode_predictions(head, cfg)

        boxes = unletterbox_boxes(boxes_lb, ratio, dwdh)
        img_wh = torch.tensor([w, h, w, h], dtype=torch.float32, device=dev)
        boxes = torch.minimum(boxes.clamp_min(0.0), img_wh)
        final_valid = area_sorted_nms(
            boxes, det_scores, det_labels >= 0,
            iou_threshold=cfg.custom_nms_iou,
            score_threshold=cfg.conf_second)

        int_boxes = torch.round(boxes).to(torch.int32).to(torch.float32)
        inflated = inflate_boxes(int_boxes, img_wh[None, :2])
        inflated = torch.round(inflated).to(torch.int32)        # (B, T, 4)

        # batch compaction: validity first, then score; a stable descending
        # sort gives equal priorities lowest index first (top_k's order)
        k = b * self.classify_budget
        flat_valid = final_valid.reshape(-1)
        flat_scores = det_scores.reshape(-1)
        priority = torch.where(flat_valid, 1.0 + flat_scores, flat_scores)
        slot_idx = torch.sort(priority, descending=True,
                              stable=True).indices[:k]
        slot_valid = flat_valid[slot_idx]
        k_labels, k_scores = self.classify(
            images, slot_idx // t, inflated.reshape(-1, 4)[slot_idx])

        cls_labels = torch.full((b * t,), -1, dtype=torch.int32, device=dev)
        cls_scores = torch.zeros(b * t, dtype=torch.float32, device=dev)
        cls_labels[slot_idx] = torch.where(slot_valid, k_labels, -1)
        cls_scores[slot_idx] = torch.where(slot_valid, k_scores, 0.0)
        return {
            "num_dets": num_dets,
            "boxes": boxes,
            "det_scores": det_scores,
            "det_labels": det_labels,
            "final_valid": final_valid,
            "cls_labels": cls_labels.reshape(b, t),
            "cls_scores": cls_scores.reshape(b, t),
        }
