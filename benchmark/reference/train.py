"""Plain float32 training step of the inspection classifier: the ViT of
reference/vit.py under autograd, the service's loss and SGD.

  loss   smooth / 6 + 5 focal / 6 on one-hot targets, where
         smooth = mean over rows of (1 - .1) (-log p_target)
                  + .1 mean over classes of (-log p), p = softmax(logits);
         focal  = mean over every (row, class) of (1 - exp(-bce))^2 bce,
                  bce the binary cross entropy with logits
  SGD    g <- grad + wd p; m <- g on the first step, else g + momentum m;
         p <- p - lr m  (PyTorch's SGD, dampening 0, no Nesterov)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.vit import ViT


def loss_fn(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    p = torch.softmax(logits, 1)
    tgt = onehot.argmax(1)
    cross = -torch.log(p.gather(1, tgt[:, None]))[:, 0]
    smooth = -torch.log(p).mean(1)
    ls = ((1 - 0.1) * cross + 0.1 * smooth).mean()
    bce = F.binary_cross_entropy_with_logits(logits, onehot,
                                             reduction="none")
    focal = ((1 - torch.exp(-bce)) ** 2 * bce).mean()
    return ls / 6.0 + focal * 5.0 / 6.0


class Trainer:
    """SGD steps of the reference ViT on given batches."""

    def __init__(self, params: dict, cfg: dict, lr: float, momentum: float,
                 weight_decay: float):
        self.p = {k: v.detach().to(torch.float32).clone().requires_grad_(True)
                  for k, v in params.items()}
        self.cfg = cfg
        self.lr, self.mom, self.wd = lr, momentum, weight_decay
        self.m: dict = {}

    def step(self, imgs: torch.Tensor, onehot: torch.Tensor) -> float:
        vit = ViT({}, self.cfg)
        vit.p = self.p
        loss = loss_fn(vit(imgs), onehot)
        grads = torch.autograd.grad(loss, list(self.p.values()))
        with torch.no_grad():
            for (k, p), g in zip(self.p.items(), grads):
                g = g + self.wd * p
                self.m[k] = g.clone() if k not in self.m \
                    else g + self.mom * self.m[k]
                p -= self.lr * self.m[k]
        return float(loss.detach())
