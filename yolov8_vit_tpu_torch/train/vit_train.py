"""ViT fine-tune: the train and eval steps and the epoch loop (PyTorch
port of `yolov8_vit_tpu/train/vit_train.py`).

SGD (momentum .9, weight decay 1e-3) at a per-epoch cosine-annealed
learning rate, the combined focal + label-smoothing loss on one-hot
targets, per-epoch validation with a confusion matrix, best-val-accuracy
checkpointing.  The model is `ViTClassifier.train_form()`: f32, every
leaf of the JAX params tree an nn.Parameter, forward and backward plain
PyTorch autograd (JAX computes them as plain XLA: no Pallas kernel lies on
the training path).

With a `mesh` (parallel/mesh.py: one process per device) each batch's
rows split over its "data" axis and the gradients are averaged over it
before the optimizer step; with a "model" axis above 1 the ViT's qkv,
proj, fc1 and fc2 split over it (parallel/sharding.py `tensor_parallel`).
A batch whose rows do not divide over the data axis (a valid loader's
tail) runs replicated: every rank takes the whole batch, the same math.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.config import CFG
from yolov8_vit_tpu_torch.models.vit import ViTClassifier, ViTSpec, \
    VIT_B8_224
from yolov8_vit_tpu_torch.parallel import sharding
from yolov8_vit_tpu_torch.parallel.distributed import is_primary
from yolov8_vit_tpu_torch.parallel.mesh import axis_group, axis_size
from yolov8_vit_tpu_torch.train.losses import combined_loss
from yolov8_vit_tpu_torch.train.schedule import cosine_anneal_schedule
from yolov8_vit_tpu_torch.utils.profiling import span
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
                    optimizer: torch.optim.Optimizer,
                    grad_sync: Callable[[], None] | None = None) -> Callable:
    """(imgs, onehot, lr) -> (loss, correct), one optimizer step on
    `model` in place.  Each parameter's `.grad` holds the step's gradient
    of the loss (weight decay is added out of place); `grad_sync`, when
    given, runs between the backward pass and the optimizer step (the
    data-parallel gradient mean).  Spans (utils/profiling.py `span`):
    `train.forward` (model and loss), `train.backward` (with `grad_sync`),
    `train.optim`."""

    def step(imgs, onehot, lr):
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            logits = model(imgs)
            loss = combined_loss(logits, onehot)
        with span("train.backward"):
            loss.backward()
            if grad_sync is not None:
                grad_sync()
        with span("train.optim"):
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


def params_tree(model: ViTClassifier, mesh=None) -> dict:
    """The model's whole tree of CPU tensors: a tensor-parallel model's
    split leaves gathered over the mesh's model axis (a collective: every
    rank of the mesh calls it)."""
    tree = module_tree(model)
    params = dict(model.named_parameters())
    for name in sharding.tp_leaves(model):
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node[part]
        node[leaf] = sharding.gather_leaf(mesh, name, params[name]).cpu()
    return tree


def _map_momentum(model, sd: dict, mesh, fn) -> dict:
    """An optimizer state_dict with each split parameter's momentum buffer
    passed through fn(mesh, name, buffer): `sharding.gather_leaf` for the
    whole buffers a checkpoint holds, `split_leaf` to resume from them."""
    split = set(sharding.tp_leaves(model))
    if not split:
        return sd
    names = [n for n, _ in model.named_parameters()]
    state = {}
    for i, st in sd["state"].items():
        st = dict(st)
        buf = st.get("momentum_buffer")
        if names[i] in split and buf is not None:
            st["momentum_buffer"] = fn(mesh, names[i], buf)
        state[i] = st
    return dict(sd, state=state)


@dataclasses.dataclass
class ViTTrainer:
    """Epoch-loop orchestrator on `device` (the card unless the caller asks
    for "cpu"), over `mesh` when one is given (every process of the mesh
    runs the same calls).  `ckpt_dir` is accepted for the JAX signature,
    which declares it and never reads it."""

    cfg: CFG = CFG()
    spec: ViTSpec = VIT_B8_224
    mesh: object = None                 # parallel.make_mesh(...) or None
    log_path: str | None = None         # result.json
    ckpt_dir: str = "weights/new_weight"
    log_fn: Callable[[str], None] = print
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = _build.resolve_device(self.device)

    def _data_axis(self) -> int:
        return axis_size(self.mesh, "data") if self.mesh is not None else 1

    def init(self, params: dict | None = None):
        """(model, optimizer): the training form on `device`, loaded from a
        params tree when one is given, else drawn with the flax
        initializers from a CPU generator seeded by cfg.seed.  Over a
        mesh the params are broadcast from its first rank, then split over
        its model axis."""
        model = ViTClassifier(self.spec, self.cfg.num_classes)
        if params is not None:
            load_tree(model, params)
        else:
            _reset(model, torch.Generator().manual_seed(self.cfg.seed))
        model = model.train_form().to(self.device)
        if self.mesh is not None and axis_size(self.mesh, "model") > 1:
            sharding.tensor_parallel(model, self.mesh)
        elif self.mesh is not None:
            with torch.no_grad():
                sharding.replicate(self.mesh,
                                   [p.data for p in model.parameters()])
        return model, make_optimizer(self.cfg, model)

    def params_tree(self, model) -> dict:
        """The model's whole params tree (`params_tree`)."""
        return params_tree(model, self.mesh)

    def _load_params(self, model, tree: dict) -> None:
        """Load a whole params tree, split where the model is split."""
        for name in sharding.tp_leaves(model):
            *path, leaf = name.split(".")
            tree = dict(tree)
            node = tree
            for part in path:
                node[part] = dict(node[part])
                node = node[part]
            node[leaf] = sharding.split_leaf(self.mesh, name,
                                             torch.as_tensor(node[leaf]))
        load_tree(model, tree)

    def _batch(self, imgs, onehot):
        return (torch.as_tensor(imgs).to(self.device),
                torch.as_tensor(onehot).to(self.device))

    def _split_rows(self, rows: int) -> bool:
        """True when a batch of `rows` splits over the mesh's data axis."""
        return self.mesh is not None and rows % self._data_axis() == 0

    def _data_sum(self, *ts: torch.Tensor) -> list[torch.Tensor]:
        """Each tensor summed over the data axis (one all-reduce)."""
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in ts])
        dist.all_reduce(flat, group=axis_group(self.mesh, "data"))
        out, off = [], 0
        for t in ts:
            out.append(flat[off:off + t.numel()].reshape(t.shape)
                       .to(t.dtype))
            off += t.numel()
        return out

    # ---- epoch loops ------------------------------------------------------
    def _train_steps(self, model, optimizer):
        """(the data-parallel step, the replicated step)."""
        rep = make_train_step(model, optimizer)
        if self.mesh is None:
            return rep, rep
        group = axis_group(self.mesh, "data")
        return make_train_step(
            model, optimizer, grad_sync=lambda: sharding.reduce_grads(
                model.parameters(), group, self._data_axis())), rep

    def train_one_epoch(self, model, optimizer, loader: Iterable,
                        epoch0: int) -> tuple[float, float]:
        """One epoch in place -> (mean loss, accuracy %).  Spans
        (utils/profiling.py `span`): `train.data` around each fetch from
        `loader` (the epoch's last finds it spent), `train.step` around
        each batch's upload, step and loss / accuracy sums."""
        lr = cosine_anneal_schedule(epoch0, self.cfg.epoch, self.cfg.lr)
        split_step, rep_step = self._train_steps(model, optimizer)
        total = n_steps = 0
        loss_sum = torch.zeros((), device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        batches = iter(loader)
        while True:
            with span("train.data"):
                item = next(batches, None)
            if item is None:
                break
            imgs, onehot = item
            with span("train.step"):
                batch = self._batch(imgs, onehot)
                if self._split_rows(imgs.shape[0]):
                    loss, c = split_step(
                        *sharding.shard_batch(self.mesh, batch), lr)
                    loss, c = self._data_sum(loss, c)
                    loss = loss / self._data_axis()
                else:
                    loss, c = rep_step(*batch, lr)
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
            batch = self._batch(imgs, onehot)
            if self._split_rows(imgs.shape[0]):
                loss, c, cm = self._data_sum(
                    *step(*sharding.shard_batch(self.mesh, batch)))
                loss = loss / self._data_axis()
            else:
                loss, c, cm = step(*batch)
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
        `save_checkpoint(model)` (on every rank of a mesh: it gathers the
        params, `params_tree`, and writes them on the primary rank).  `checkpointer`
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
                self._load_params(model, state["params"])
                optimizer.load_state_dict(_map_momentum(
                    model, state["opt_state"], self.mesh,
                    sharding.split_leaf))
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
            if log and self.log_path and is_primary():
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
                tree = self.params_tree(model)
                opt = _map_momentum(model, optimizer.state_dict(),
                                    self.mesh, sharding.gather_leaf)
                if is_primary():
                    checkpointer.save(epoch, tree, opt,
                                      extra={"best_val_acc": best_val_acc})
            self.log_fn(f"epoch:{epoch}, time:{time.time()-t0:.2f}s, "
                        f"best_val_acc:{best_val_acc:.2f}%")
            if stop_after_epoch is not None and epoch >= stop_after_epoch:
                break
        return model, optimizer, best_val_acc
