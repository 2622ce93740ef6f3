"""Classifier losses on one-hot float targets (PyTorch port of
`yolov8_vit_tpu/train/losses.py`):

  focal_loss           FocalLoss(alpha=1, gamma=2) over BCE-with-logits,
                       the mean over every (batch, class) element;
  label_smoothing_ce   label-smoothing cross entropy (eps 0.1) in the
                       reference's own form: softmax first, then -log of
                       the probabilities (not log-softmax);
  combined_loss        smooth / 6 + 5 focal / 6.
"""
from __future__ import annotations

import torch


def focal_loss(logits: torch.Tensor, targets_onehot: torch.Tensor,
               alpha: float = 1.0, gamma: float = 2.0) -> torch.Tensor:
    x, y = logits, targets_onehot
    # stable BCE-with-logits: max(x, 0) - x y + log(1 + exp(-|x|))
    bce = torch.clamp_min(x, 0) - x * y + torch.log1p(torch.exp(-x.abs()))
    p_t = torch.exp(-bce)
    return torch.mean(alpha * (1 - p_t) ** gamma * bce)


def label_smoothing_ce(logits: torch.Tensor, targets_onehot: torch.Tensor,
                       smoothing: float = 0.1) -> torch.Tensor:
    probs = torch.softmax(logits, dim=1)
    target_idx = torch.argmax(targets_onehot, dim=1)
    cross = -torch.log(probs.gather(1, target_idx[:, None]))[:, 0]
    smooth = -torch.mean(torch.log(probs), dim=1)
    return torch.mean((1.0 - smoothing) * cross + smoothing * smooth)


def combined_loss(logits: torch.Tensor,
                  targets_onehot: torch.Tensor) -> torch.Tensor:
    return (label_smoothing_ce(logits, targets_onehot) / 6.0
            + focal_loss(logits, targets_onehot) * 5.0 / 6.0)
