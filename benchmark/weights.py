"""Weights from the seed, made on the device in one draw: flax's
initializers (truncated lecun-normal kernels, zero biases, unit LayerNorm
scales, N(0, .02) position embedding, the detect head's bias priors),
in the layout of the shape tables under reference/.  Both the program and
the reference are handed the same tree."""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import vit as ref_vit
from benchmark.reference import yolov8 as ref_yolo

_TRUNC_STD = .87962566103423978      # std of N(0, 1) truncated to +-2


def sub_seed(seed: int, *tags: int) -> int:
    """A 64-bit seed of its own for each use of the run's seed."""
    return int(np.random.SeedSequence([seed, *tags]).generate_state(
        1, np.uint64)[0])


def _fill(shapes: dict, noise: torch.Tensor) -> dict:
    out, off = {}, 0
    for path, (shape, init) in shapes.items():
        n = math.prod(shape)
        if init == "lecun":
            fan_in = math.prod(shape[:-1])
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            t = noise[off:off + n].view(shape).clamp(-2.0, 2.0) * std
            off += n
        elif isinstance(init, tuple) and init[0] == "normal":
            t = noise[off:off + n].view(shape) * init[1]
            off += n
        elif init == "ones":
            t = torch.ones(shape, device=noise.device)
        elif init == "zeros":
            t = torch.zeros(shape, device=noise.device)
        else:
            t = torch.full(shape, float(init[1]), device=noise.device)
        out[path] = t
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        *parts, leaf = path.split(".")
        node = tree
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def make_tree(cfg: dict, seed: int, device) -> dict:
    """{"det": {"params"}, "vit": {"params"}} float32 on `device`."""
    det = ref_yolo.param_shapes(cfg["detector"])
    vit = ref_vit.param_shapes(cfg["vit"], cfg["num_classes"])
    total = sum(math.prod(s) for s, init in (*det.values(), *vit.values())
                if init == "lecun" or (isinstance(init, tuple)
                                       and init[0] == "normal"))
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(total, generator=gen, device=device)
    n_det = sum(math.prod(s) for s, init in det.values() if init == "lecun")
    return {"det": {"params": _nest(_fill(det, noise[:n_det]))},
            "vit": {"params": _nest(_fill(vit, noise[n_det:]))}}
