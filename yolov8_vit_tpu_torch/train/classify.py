"""Classifier training entry points (PyTorch port of
`yolov8_vit_tpu/train/classify.py`):

  retrain(log)       seed -> deliver -> train -> export the classify engine
  train(cfg, log)    build the datasets -> fit with best-val export
  class_export       trained params -> classify engine dir
  build_infer_model  engine dir -> the port's Engine (None if unreadable)

Training runs on `device`, the card unless the caller asks for "cpu";
asking for the card where there is none raises (`_build.resolve_device`).
With a `mesh` (parallel/mesh.py) every process of the mesh calls the same
function: the trainer splits rows over its data axis and the ViT over its
model axis, and only the primary rank writes files.
Engines are written by the port's `weights.save_engine` with the JAX
package's meta keys, so either package loads them.
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import Callable

import numpy as np
import torch

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.config import CFG
from yolov8_vit_tpu_torch.data.voc import deliver
from yolov8_vit_tpu_torch.models.vit import ViTSpec, VIT_B8_224
from yolov8_vit_tpu_torch.parallel.distributed import is_primary
from yolov8_vit_tpu_torch.runtime.engine import Engine
from yolov8_vit_tpu_torch.train.dataset import build_dataloaders
from yolov8_vit_tpu_torch.train.vit_train import ViTTrainer, params_tree
from yolov8_vit_tpu_torch.weights import read_engine, save_engine


def set_seed(seed: int = 42) -> None:
    """Seed the host's global generators (Python's, numpy's, torch's);
    the trainer's init and the data draw from their own generators made
    from cfg.seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _spec_for(cfg: CFG) -> ViTSpec:
    if "patch16" in cfg.model_name:
        return ViTSpec(patch=16)
    return VIT_B8_224


def class_export(params, cfg: CFG, out_dir: str,
                 spec: ViTSpec | None = None) -> str:
    """Write trained classifier params, a variables tree {"params": tree}
    (the layout engine dirs hold), as a classify engine dir."""
    spec = spec or _spec_for(cfg)
    return save_engine(out_dir, "classify", params,
                       {"vit_spec": dataclasses.asdict(spec),
                        "num_classes": cfg.num_classes,
                        "model_name": cfg.model_name})


def build_infer_model(path: str, device="cuda") -> Engine | None:
    try:
        return Engine(path, device=device)
    except (OSError, ValueError) as e:
        print(f"Error loading classify engine from {path}: {e}")
        return None


def _with_workdir(cfg: CFG, workdir: str) -> CFG:
    return dataclasses.replace(
        cfg,
        train_path=[os.path.join(workdir, p) for p in cfg.train_path],
        valid_path=[os.path.join(workdir, p) for p in cfg.valid_path])


def _barrier(mesh) -> None:
    if mesh is not None:
        torch.distributed.barrier()


def train(cfg: CFG = CFG(), log: bool = False, mesh=None,
          workdir: str = ".", init_params: dict | None = None,
          log_fn: Callable[[str], None] = print, device="cuda"):
    """Full fine-tune on `device` (over `mesh` when given) -> (trained
    model, best val accuracy); a tensor-parallel model holds its shard
    (`vit_train.params_tree` gathers it).

    Starts from `init_params` (a variables tree {"params": tree}) when
    given, else from the `cfg.pretrained` engine dir when it exists (a
    retrain resumes from the prior best), else from a random init seeded
    by cfg.seed.  The best-val params go to `weights/new_weight/best` as a
    classify engine."""
    trainer = ViTTrainer(
        cfg=cfg, spec=_spec_for(cfg), mesh=mesh,
        log_path=os.path.join(workdir, "train/result.json"),
        log_fn=log_fn, device=device)
    pre = os.path.join(workdir, cfg.pretrained)
    if init_params is None and os.path.isdir(pre):
        init_params = read_engine(pre)[1]
        log_fn(f"resumed from {pre}")
    model, optimizer = trainer.init(
        None if init_params is None else init_params["params"])

    train_data, valid_data = build_dataloaders(_with_workdir(cfg, workdir))
    epoch_box = {"n": 0}

    def train_loader():
        epoch_box["n"] += 1
        return train_data.batches(cfg.train_bs, epoch=epoch_box["n"],
                                  drop_last=True)

    def valid_loader():
        return valid_data.batches(cfg.valid_bs)

    best_dir = os.path.join(workdir, "weights/new_weight/best")

    def save_ckpt(m):
        tree = trainer.params_tree(m)
        if is_primary():
            class_export({"params": tree}, cfg, best_dir)

    model, _, best = trainer.fit(model, optimizer, train_loader,
                                 valid_loader, save_checkpoint=save_ckpt,
                                 log=log)
    _barrier(mesh)
    return model, best


def retrain(log: bool = False, cfg: CFG = CFG(), mesh=None,
            workdir: str = ".", log_fn: Callable[[str], None] = print,
            device="cuda"):
    """The service's retrain cycle: deliver the ingested labels (train/new)
    80 / 20 into train/new_train and train/new_valid, train, and export
    the best-val engine (the final params if no epoch set a best) to
    weights/class_engine.  Returns the best val accuracy."""
    device = _build.resolve_device(device)
    set_seed(cfg.seed)
    log_fn("Starting data delivery...")
    if is_primary():
        deliver(os.path.join(workdir, "train/new/"),
                os.path.join(workdir, "train/new_train"),
                os.path.join(workdir, "train/new_valid"))
        if log:
            result = os.path.join(workdir, "train/result.json")
            os.makedirs(os.path.dirname(result), exist_ok=True)
            with open(result, "w") as f:
                f.write("{}")
    _barrier(mesh)
    log_fn("Starting training...")
    model, best = train(cfg, log=log, mesh=mesh, workdir=workdir,
                        log_fn=log_fn, device=device)
    log_fn("Exporting engine...")
    latest = os.path.join(workdir, "weights/new_weight/best")
    out = os.path.join(workdir, "weights/class_engine")
    tree = None if os.path.isdir(latest) else \
        {"params": params_tree(model, mesh)}
    if is_primary():
        class_export(read_engine(latest)[1] if tree is None else tree,
                     cfg, out)
    _barrier(mesh)
    log_fn("Retraining process complete.")
    return best
