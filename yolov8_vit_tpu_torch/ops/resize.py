"""Bilinear resize as two separable matmuls (cv2 INTER_LINEAR index
semantics: half-pixel centers, edge-clamped)."""
from __future__ import annotations

import numpy as np
import torch


def interp_matrix(dst: int, src: int) -> np.ndarray:
    """(dst, src) bilinear interpolation matrix with cv2 half-pixel,
    clamped index semantics."""
    c = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    c0 = np.floor(c)
    f = (c - c0).astype(np.float32)
    i0 = np.clip(c0, 0, src - 1).astype(int)
    i1 = np.clip(c0 + 1, 0, src - 1).astype(int)
    m = np.zeros((dst, src), np.float32)
    m[np.arange(dst), i0] += 1 - f
    m[np.arange(dst), i1] += f
    return m


def resize_bilinear_mm(img: torch.Tensor, out_hw: tuple[int, int],
                       dtype=torch.bfloat16) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) in `dtype`: rows, then columns,
    each a matmul against an interpolation matrix in `dtype`."""
    h2, w2 = out_hw
    h, w = img.shape[-3], img.shape[-2]
    rh = torch.from_numpy(interp_matrix(h2, h)).to(img.device, dtype)
    rw = torch.from_numpy(interp_matrix(w2, w)).to(img.device, dtype)
    x = img.to(dtype)
    t = torch.einsum("nh,...hwc->...nwc", rh, x)
    return torch.einsum("mw,...nwc->...nmc", rw, t)
