"""ViT fine-tune: the train and eval steps and the epoch loop (PyTorch
port of `yolov8_vit_tpu/train/vit_train.py`).

SGD (momentum .9, weight decay 1e-3) at a per-epoch cosine-annealed
learning rate, the combined focal + label-smoothing loss on one-hot
targets, per-epoch validation with a confusion matrix, best-val-accuracy
checkpointing.  The model is `ViTClassifier.train_form()`: f32, every
leaf of the JAX params tree an nn.Parameter, forward and backward plain
PyTorch autograd (JAX computes them as plain XLA: no Pallas kernel lies on
the training path).  JAX's `mesh` (data / model parallel) has no
counterpart yet; the trainer runs on one `device`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.config import CFG
from yolov8_vit_tpu_torch.models.vit import ViTClassifier, ViTSpec, \
    VIT_B8_224
from yolov8_vit_tpu_torch.train.losses import combined_loss
from yolov8_vit_tpu_torch.train.schedule import cosine_anneal_schedule
from yolov8_vit_tpu_torch.weights import _reset, load_tree, module_tree


def make_optimizer(cfg: CFG, model: torch.nn.Module) -> torch.optim.SGD:
    """torch.optim.SGD over every parameter of the training form, in the
    JAX chain's order (add_decayed_weights, trace, sgd): g += wd * p, then
    m = g + momentum * m (m = g on the first step), then p -= lr * m.
    The train step sets lr per call (the cosine value of the epoch)."""
    return torch.optim.SGD(model.parameters(), lr=cfg.lr,
                           momentum=cfg.momentum, dampening=0.0,
                           weight_decay=cfg.weight_decay, nesterov=False,
                           foreach=True)


def _correct(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == onehot.argmax(-1)).sum()


def make_train_step(model: ViTClassifier,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """(imgs, onehot, lr) -> (loss, correct), one optimizer step on
    `model` in place.  Each parameter's `.grad` holds the step's gradient
    of the loss (weight decay is added out of place)."""

    def step(imgs, onehot, lr):
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        logits = model(imgs)
        loss = combined_loss(logits, onehot)
        loss.backward()
        optimizer.step()
        return loss.detach(), _correct(logits.detach(), onehot)

    return step


def make_eval_step(model: ViTClassifier, num_classes: int) -> Callable:
    """(imgs, onehot) -> (loss, correct, confusion (C, C) with
    [target, prediction] += 1)."""

    @torch.no_grad()
    def step(imgs, onehot):
        logits = model(imgs)
        loss = combined_loss(logits, onehot)
        pred, tgt = logits.argmax(-1), onehot.argmax(-1)
        conf = torch.zeros(num_classes, num_classes, dtype=torch.int64,
                           device=logits.device)
        conf.index_put_((tgt, pred), torch.ones_like(tgt), accumulate=True)
        return loss, (pred == tgt).sum(), conf

    return step


@dataclasses.dataclass
class ViTTrainer:
    """Epoch-loop orchestrator on `device` (the card unless the caller asks
    for "cpu")."""

    cfg: CFG = CFG()
    spec: ViTSpec = VIT_B8_224
    device: str | torch.device = "cuda"
    log_path: str | None = None         # result.json
    log_fn: Callable[[str], None] = print

    def __post_init__(self):
        self.device = _build.resolve_device(self.device)

    def init(self, params: dict | None = None):
        """(model, optimizer): the training form on `device`, loaded from a
        params tree when one is given, else drawn with the flax
        initializers from a CPU generator seeded by cfg.seed."""
        model = ViTClassifier(self.spec, self.cfg.num_classes)
        if params is not None:
            load_tree(model, params)
        else:
            _reset(model, torch.Generator().manual_seed(self.cfg.seed))
        model = model.train_form().to(self.device)
        return model, make_optimizer(self.cfg, model)

    def _batch(self, imgs, onehot):
        return (torch.as_tensor(imgs).to(self.device),
                torch.as_tensor(onehot).to(self.device))

    # ---- epoch loops ------------------------------------------------------
    def train_one_epoch(self, model, optimizer, loader: Iterable,
                        epoch0: int) -> tuple[float, float]:
        """One epoch in place -> (mean loss, accuracy %)."""
        lr = cosine_anneal_schedule(epoch0, self.cfg.epoch, self.cfg.lr)
        step = make_train_step(model, optimizer)
        total = n_steps = 0
        loss_sum = torch.zeros((), device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for imgs, onehot in loader:
            loss, c = step(*self._batch(imgs, onehot), lr)
            total += imgs.shape[0]
            loss_sum += loss
            correct += c
            n_steps += 1
        acc = 100.0 * int(correct) / max(total, 1)
        return float(loss_sum) / max(n_steps, 1), acc

    def valid_one_epoch(self, model, loader: Iterable):
        """-> (accuracy %, mean loss, confusion matrix (C, C) int64)."""
        step = make_eval_step(model, self.cfg.num_classes)
        nc = self.cfg.num_classes
        total = n_steps = 0
        loss_sum = torch.zeros((), device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        conf = torch.zeros(nc, nc, dtype=torch.int64, device=self.device)
        for imgs, onehot in loader:
            loss, c, cm = step(*self._batch(imgs, onehot))
            total += imgs.shape[0]
            loss_sum += loss
            correct += c
            conf += cm
            n_steps += 1
        acc = 100.0 * int(correct) / max(total, 1)
        return acc, float(loss_sum) / max(n_steps, 1), conf.cpu().numpy()

    # ---- full training ----------------------------------------------------
    def fit(self, model, optimizer, train_loader_fn, valid_loader_fn,
            save_checkpoint: Callable[[ViTClassifier], None] | None = None,
            log: bool = False, checkpointer=None,
            stop_after_epoch: int | None = None):
        """train_loader_fn / valid_loader_fn: () -> iterable of (imgs NHWC
        float32, onehot).  Trains `model` in place -> (model, optimizer,
        best val accuracy).

        Each epoch's metrics go to `log_path` (result.json rows keyed by
        epoch) when `log`; a new best val accuracy calls
        `save_checkpoint(model)`.  `checkpointer`
        (utils.checkpoint.TrainCheckpointer) saves the params, the
        momentum buffers and the best metric after every epoch and
        resumes from its latest step, carrying result.json's earlier rows
        forward; `stop_after_epoch` ends the run early (an interruption
        the checkpointer resumes)."""
        best_val_acc = 0.0
        results = {}
        start_epoch = 1
        if checkpointer is not None:
            latest = checkpointer.latest_step()
            if latest is not None:
                state = checkpointer.restore(
                    latest, template={"params": None, "opt_state": None,
                                      "extra": None})
                load_tree(model, state["params"])
                optimizer.load_state_dict(state["opt_state"])
                best_val_acc = float(state["extra"].get("best_val_acc", 0.0))
                start_epoch = latest + 1
                # the log below rewrites log_path wholesale: keep the rows
                # of the epochs before the resume
                if log and self.log_path and os.path.exists(self.log_path):
                    try:
                        with open(self.log_path) as f:
                            results = {int(k): v
                                       for k, v in json.load(f).items()}
                    except (OSError, ValueError):
                        results = {}
                self.log_fn(f"resumed from checkpoint step {latest} "
                            f"(best {best_val_acc:.2f}%)")
        for epoch in range(start_epoch, self.cfg.epoch + 1):
            t0 = time.time()
            tr_loss, tr_acc = self.train_one_epoch(
                model, optimizer, train_loader_fn(), epoch - 1)
            val_acc, val_loss, conf = self.valid_one_epoch(
                model, valid_loader_fn())
            norm_cm = conf / np.maximum(conf.sum(1, keepdims=True), 1)
            self.log_fn(f"Epoch {epoch}: train loss {tr_loss:.4f} "
                        f"acc {tr_acc:.2f}% | val loss {val_loss:.4f} "
                        f"acc {val_acc:.2f}%\n{norm_cm}")
            if log and self.log_path:
                results[epoch] = {"train_acc": tr_acc, "val_acc": val_acc,
                                  "loss": val_loss}
                os.makedirs(os.path.dirname(self.log_path) or ".",
                            exist_ok=True)
                with open(self.log_path, "w") as f:
                    json.dump(results, f, indent=4)
            if val_acc > best_val_acc:
                best_val_acc = val_acc
                if save_checkpoint is not None:
                    save_checkpoint(model)
                self.log_fn(f"New best model (val acc {val_acc:.3f}%)")
            if checkpointer is not None:
                checkpointer.save(epoch, module_tree(model),
                                  optimizer.state_dict(),
                                  extra={"best_val_acc": best_val_acc})
            self.log_fn(f"epoch:{epoch}, time:{time.time()-t0:.2f}s, "
                        f"best_val_acc:{best_val_acc:.2f}%")
            if stop_after_epoch is not None and epoch >= stop_after_epoch:
                break
        return model, optimizer, best_val_acc
