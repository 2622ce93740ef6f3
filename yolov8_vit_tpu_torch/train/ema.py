"""Exponential moving average of parameters (PyTorch port of
`yolov8_vit_tpu/train/ema.py`, ultralytics ModelEMA's ramp):
    d(t) = decay * (1 - exp(-t / tau)),   ema = ema * d + p * (1 - d).
"""
from __future__ import annotations

import math

import torch


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return torch.as_tensor(tree).detach().clone()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree]


class EMA:
    """EMA of a parameter tree (nested dicts of tensors, as
    `weights.module_tree` gives); `params` holds the averages in the same
    structure.  Each update is one fused multiply and one fused add over
    every leaf (`torch._foreach_*`), in place."""

    def __init__(self, params, decay: float = 0.9999, tau: float = 2000.0):
        self.decay = decay
        self.tau = tau
        self.updates = 0
        self.params = _clone(params)

    def _d(self) -> float:
        return self.decay * (1.0 - math.exp(-self.updates / self.tau))

    @torch.no_grad()
    def update(self, params) -> None:
        self.updates += 1
        d = self._d()
        ema = _leaves(self.params)
        new = [torch.as_tensor(v).detach().to(e.dtype)
               for e, v in zip(ema, _leaves(params))]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, new, alpha=1.0 - d)
