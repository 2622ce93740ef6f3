"""Image tensor preprocessing (device-side)."""
from __future__ import annotations

import torch


def blob(img: torch.Tensor) -> torch.Tensor:
    """Pixels in [0, 255] (NHWC, any dtype) -> float32 in [0, 1]."""
    return img.to(torch.float32) / 255.0
