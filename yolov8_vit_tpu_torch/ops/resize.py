"""Image resizes with OpenCV's index semantics.

  INTER_NEAREST:  sx = floor(dx * src/dst)           (no half-pixel shift)
  INTER_LINEAR:   sx = (dx + 0.5) * src/dst - 0.5    (half-pixel centers,
                  edge-clamped)

`resize_nearest` and `resize_bilinear` are exact gathers; inside the fused
pipeline the bilinear resize runs as two separable matmuls
(`resize_bilinear_mm`)."""
from __future__ import annotations

import numpy as np
import torch


def _nearest_indices(dst: int, src: int) -> np.ndarray:
    """cv2 INTER_NEAREST: sx = floor(dx * ifx) with ifx = 1.0 / ((double)
    dst / src), two double roundings, reproduced in float64."""
    ifx = 1.0 / (dst / src)
    idx = np.floor(np.arange(dst) * ifx).astype(np.int64)
    return np.minimum(idx, src - 1)


def resize_nearest(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) with cv2 INTER_NEAREST semantics."""
    h2, w2 = out_hw
    h, w = img.shape[-3], img.shape[-2]
    ri = torch.from_numpy(_nearest_indices(h2, h)).to(img.device)
    ci = torch.from_numpy(_nearest_indices(w2, w)).to(img.device)
    return img[..., ri[:, None], ci[None, :], :]


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) with cv2 INTER_LINEAR semantics:
    half-pixel centers, edge-clamped, f32 accumulation; an integer input
    is rounded (half to even) back to its dtype."""
    h2, w2 = out_hw
    h, w = img.shape[-3], img.shape[-2]
    x = img.to(torch.float32)

    def coords(dst: int, src: int):
        c = (np.arange(dst) + 0.5) * (src / dst) - 0.5
        c0 = np.floor(c)
        frac = torch.from_numpy((c - c0).astype(np.float32)).to(img.device)
        i0 = torch.from_numpy(np.clip(c0, 0, src - 1).astype(np.int64))
        i1 = torch.from_numpy(np.clip(c0 + 1, 0, src - 1).astype(np.int64))
        return i0.to(img.device), i1.to(img.device), frac

    r0, r1, rf = coords(h2, h)
    c0, c1, cf = coords(w2, w)
    rf, cf = rf[:, None, None], cf[None, :, None]
    top = x[..., r0[:, None], c0[None, :], :] * (1 - cf) \
        + x[..., r0[:, None], c1[None, :], :] * cf
    bot = x[..., r1[:, None], c0[None, :], :] * (1 - cf) \
        + x[..., r1[:, None], c1[None, :], :] * cf
    out = top * (1 - rf) + bot * rf
    if not img.is_floating_point():
        out = torch.round(out)
    return out.to(img.dtype)


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
