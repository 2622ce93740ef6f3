"""Anchor generation + DFL (distribution focal) box decode."""
from __future__ import annotations

import numpy as np
import torch


def make_anchors(input_hw: tuple[int, int],
                 strides: tuple[int, ...] = (8, 16, 32),
                 grid_cell_offset: float = 0.5, device="cpu"):
    """Anchor points (A, 2) [x, y in feature units] and per-anchor strides
    (A, 1), f32; level-major, row-major, x fastest."""
    h, w = input_hw
    points, strides_out = [], []
    for s in strides:
        fh, fw = h // s, w // s
        sx = np.arange(fw, dtype=np.float32) + grid_cell_offset
        sy = np.arange(fh, dtype=np.float32) + grid_cell_offset
        gy, gx = np.meshgrid(sy, sx, indexing="ij")
        points.append(np.stack([gx, gy], axis=-1).reshape(-1, 2))
        strides_out.append(np.full((fh * fw, 1), s, dtype=np.float32))
    return (torch.from_numpy(np.concatenate(points)).to(device),
            torch.from_numpy(np.concatenate(strides_out)).to(device))


def dfl_decode(box_dist: torch.Tensor, anchors: torch.Tensor,
               stride_per_anchor: torch.Tensor,
               reg_max: int = 16) -> torch.Tensor:
    """(..., A, 4*reg_max) logits, bins ordered [l, t, r, b] -> (..., A, 4)
    xyxy boxes in input pixels: softmax expectation, anchor -/+ ltrb,
    times the stride."""
    *lead, a, _ = box_dist.shape
    probs = torch.softmax(box_dist.reshape(*lead, a, 4, reg_max), dim=-1)
    bins = torch.arange(reg_max, dtype=probs.dtype, device=probs.device)
    ltrb = probs @ bins
    x1y1 = anchors - ltrb[..., :2]
    x2y2 = anchors + ltrb[..., 2:]
    return torch.cat([x1y1, x2y2], dim=-1) * stride_per_anchor
