"""Image tensor preprocessing (device-side)."""
from __future__ import annotations

import torch


def blob(img: torch.Tensor) -> torch.Tensor:
    """Pixels in [0, 255] (NHWC, any dtype) -> float32 in [0, 1]."""
    return img.to(torch.float32) / 255.0


def normalize_pm1(img01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float images normalized with mean = std = 0.5 -> [-1, 1]
    (the classifier's normalization)."""
    return img01 * 2.0 - 1.0
