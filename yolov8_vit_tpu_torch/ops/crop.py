"""Batched crop + nearest resize for the second stage, as one gather.

Nearest-source contract for an integer box (x1, y1, x2, y2), w = x2 - x1:

    src_x(dst_x) = clip(x1 + min(dst_x * w // out_w, w - 1), 0, W - 1)

in integer arithmetic (the cv2 INTER_NEAREST mapping in exact rational
form).  On the card this is a plain index gather; the JAX package's
one-hot selection matmuls were a TPU device for the same bytes.
"""
from __future__ import annotations

import torch


def _source_indices(boxes: torch.Tensor, out_hw: tuple[int, int],
                    img_hw: tuple[int, int]):
    """Per-box nearest source rows (K, out_h) and cols (K, out_w)."""
    out_h, out_w = out_hw
    h, w = img_hw
    b = boxes.to(torch.int64)
    x1, y1, x2, y2 = b.unbind(-1)
    bw = (x2 - x1).clamp_min(1)[:, None]
    bh = (y2 - y1).clamp_min(1)[:, None]
    dx = torch.arange(out_w, device=b.device)[None]
    dy = torch.arange(out_h, device=b.device)[None]
    sx = (x1[:, None] + torch.minimum(dx * bw // out_w, bw - 1)).clamp(0, w - 1)
    sy = (y1[:, None] + torch.minimum(dy * bh // out_h, bh - 1)).clamp(0, h - 1)
    return sy, sx


def crop_and_resize_nearest_gather(img: torch.Tensor, boxes: torch.Tensor,
                                   out_hw: tuple[int, int]) -> torch.Tensor:
    """Crop integer xyxy `boxes` (K, 4) from `img` (H, W, C), nearest-
    resized to out_hw -> (K, h, w, C) in img's dtype, as one gather.
    Degenerate boxes (w <= 0) take a width of 1."""
    h, w = img.shape[0], img.shape[1]
    sy, sx = _source_indices(boxes, out_hw, (h, w))
    return img[sy[:, :, None], sx[:, None, :]]


def crop_and_resize_nearest(img: torch.Tensor, boxes: torch.Tensor,
                            out_hw: tuple[int, int]) -> torch.Tensor:
    """The JAX package's name for the same crop (its one-hot selection
    matmuls were a TPU device for this gather)."""
    return crop_and_resize_nearest_gather(img, boxes, out_hw)


def _patch_layout(crops: torch.Tensor, patch: int) -> torch.Tensor:
    """(K, h, w, C) -> (K, n_patches, patch, patch * C): patch rows ordered
    (pi, pj), trailing dims (u, (v, c))."""
    k, out_h, out_w, c = crops.shape
    nh, nw = out_h // patch, out_w // patch
    crops = crops.reshape(k, nh, patch, nw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return crops.reshape(k, nh * nw, patch, patch * c)


def crop_to_patches(img: torch.Tensor, boxes: torch.Tensor,
                    out_hw: tuple[int, int], patch: int) -> torch.Tensor:
    """`crop_and_resize_nearest` of one frame in ViT patch layout, bf16:
    (K, n_patches, patch, patch * C)."""
    crops = crop_and_resize_nearest_gather(img, boxes, out_hw)
    return _patch_layout(crops.to(torch.bfloat16), patch)


def crop_to_patches_i8(images: torch.Tensor, slot_img: torch.Tensor,
                       boxes: torch.Tensor, out_hw: tuple[int, int],
                       patch: int) -> torch.Tensor:
    """Crop `boxes` (K, 4) int xyxy from frames `images` (B, H, W, C) uint8,
    frame `slot_img` (K,) each, resized nearest to out_hw, in ViT patch
    layout: (K, n_patches, patch, patch*C) int8 holding pixel - 128, patch
    rows ordered (pi, pj), trailing dims (u, (v, c))."""
    _, h, w, c = images.shape
    sy, sx = _source_indices(boxes, out_hw, (h, w))
    si = slot_img.to(torch.int64)[:, None, None]
    crops = images[si, sy[:, :, None], sx[:, None, :]]     # (K, oh, ow, C)
    crops = (crops.to(torch.int16) - 128).to(torch.int8)
    return _patch_layout(crops, patch)
