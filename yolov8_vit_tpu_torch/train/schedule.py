"""Per-epoch cosine anneal of the learning rate (PyTorch port of
`yolov8_vit_tpu/train/schedule.py`):
    lr(t) = lr / 2 * (cos(pi * (t % T) / T) + 1)
"""
from __future__ import annotations

import math


def cosine_anneal_schedule(t: int, nb_epoch: int, lr: float) -> float:
    cos_inner = math.pi * (t % nb_epoch) / nb_epoch
    return float(lr / 2.0 * (math.cos(cos_inner) + 1.0))
