"""Aspect-preserving resize + pad ("letterbox").

    r        = min(W_out/w, H_out/h)
    new_wh   = (round(w*r), round(h*r))
    dw, dh   = (W_out-new_w)/2, (H_out-new_h)/2
    top,left = round(dh-0.1), round(dw-0.1)
    pad value 114, bilinear resize
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from yolov8_vit_tpu_torch.ops.resize import (resize_bilinear,
                                             resize_bilinear_mm)


def letterbox_params(in_hw: tuple[int, int], out_hw: tuple[int, int]):
    """Static letterbox geometry: (new_h, new_w, ratio, dw, dh, top, left)."""
    h, w = in_hw
    out_h, out_w = out_hw
    r = min(out_w / w, out_h / h)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = (out_w - new_w) / 2.0, (out_h - new_h) / 2.0
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    return new_h, new_w, r, dw, dh, top, left


def letterbox(img: torch.Tensor, out_hw: tuple[int, int],
              pad_value: int = 114):
    """Letterbox (..., H, W, C) to out_hw in img's dtype, the resize an
    exact gather (`resize_bilinear`).  Returns (image, ratio, (dw, dh))."""
    out_h, out_w = out_hw
    h, w = img.shape[-3], img.shape[-2]
    new_h, new_w, r, dw, dh, top, left = letterbox_params((h, w), out_hw)
    resized = img if (new_h, new_w) == (h, w) \
        else resize_bilinear(img, (new_h, new_w))
    padded = F.pad(resized, (0, 0, left, out_w - new_w - left,
                             top, out_h - new_h - top), value=pad_value)
    return padded, r, (dw, dh)


def letterbox_fast(img: torch.Tensor, out_hw: tuple[int, int],
                   pad_value: int = 114, dtype=torch.bfloat16):
    """Letterbox (..., H, W, C) uint8 frames to out_hw as floats in [0, 255]
    of `dtype`.  Returns (image, ratio, (dw, dh)); ratio and dwdh are Python
    floats that depend only on the shapes."""
    out_h, out_w = out_hw
    h, w = img.shape[-3], img.shape[-2]
    new_h, new_w, r, dw, dh, top, left = letterbox_params((h, w), out_hw)
    if (new_h, new_w) == (h, w):
        resized = img.to(dtype)
    else:
        resized = resize_bilinear_mm(img, (new_h, new_w), dtype).to(dtype)
    padded = F.pad(resized, (0, 0, left, out_w - new_w - left,
                             top, out_h - new_h - top), value=pad_value)
    return padded, r, (dw, dh)
