"""Synthetic inspection frames and the detect head fitted to them.

Frozen copies of the program's `utils/densify.py::make_cover_scenes` and
`fit_detect_head`, made on the device:

  * a frame is Gaussian sensor noise N(90, 18) clipped to uint8 with
    Poisson(lam) bright filled disks ("covers", at most 5) of radius 5.5-11%
    of the short side and a colour of 150-254 per channel;
  * the fit makes a random detector respond to covers at the deployment's
    density: a ridge regression of the P3 cls branch's last hidden map
    (the reference detector's own float32 features) onto +1 at anchors
    inside .35 r of a cover (and each cover's nearest anchor), -1
    elsewhere, rescaled so the background mean sits at logit -8 and the
    cover mean at +4; P4 and P5 silenced (logit -20); the P3 box
    distribution pinned to bin 12, so NMS collapses a cover's anchors to
    about one box.

The fitted tree is an input of the run, handed to the program and the
reference alike.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.pipeline import letterbox
from benchmark.reference.yolov8 import Detector


def cover_scenes(seed: int, n: int, hw, lam: float, device,
                 max_covers: int = 5):
    """(frames (n, H, W, 3) uint8 on `device`, per-frame [(cx, cy, r)]).
    A batch holds round(lam * n) covers, each in a frame drawn uniformly
    (a frame's count is then binomial, near Poisson(lam)), at most
    max_covers a frame: every batch carries the same work."""
    h, w = hw
    m = min(h, w)
    r_lo = max(4, int(0.055 * m))
    r_hi = max(r_lo + 1, int(0.11 * m))
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = (torch.randn((n, h, w, 3), generator=gen, device=device) * 18.0
              + 90.0).clamp_(0, 255).to(torch.uint8)
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    counts = np.zeros(n, int)
    for _ in range(int(round(lam * n))):
        free = np.nonzero(counts < max_covers)[0]
        counts[free[rng.integers(len(free))]] += 1
    covers = []
    for i in range(n):
        cs = []
        for _ in range(counts[i]):
            r = int(rng.integers(r_lo, r_hi))
            cx = int(rng.integers(r + 4, w - r - 4))
            cy = int(rng.integers(r + 4, h - r - 4))
            color = torch.as_tensor(rng.integers(150, 255, 3), device=device,
                                    dtype=torch.uint8)
            disk = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            frames[i][disk] = color
            cs.append((cx, cy, r))
        covers.append(cs)
    return frames, covers


def fit_head(tree: dict, cfg: dict, frames: torch.Tensor, covers,
             frac: float = 0.35, box_bin: int = 12,
             ridge: float = 1e-3) -> dict:
    """Fit the detect head of `tree` (in place) on the fit scenes (any
    frame size: they are letterboxed as the pipeline does); returns the
    tree."""
    d = cfg["detector"]
    flat = {}

    def walk(node, pre=""):
        for k, v in node.items():
            key = f"{pre}.{k}" if pre else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = v
    walk(tree["det"]["params"])
    det = Detector(flat, d)
    lb, ratio, (dw, dh) = letterbox(frames, d["input_size"])
    with torch.no_grad():
        det(lb / 255.0)
    fmap = det.taps.pop("cls0_1").permute(0, 2, 3, 1).to(torch.float64)
    stride = d["strides"][0]
    gh, gw = d["input_size"][0] // stride, d["input_size"][1] // stride
    dev = fmap.device
    ys, xs = torch.meshgrid(torch.arange(gh, device=dev),
                            torch.arange(gw, device=dev), indexing="ij")
    ax, ay = (xs + 0.5) * stride, (ys + 0.5) * stride
    mask = torch.zeros((len(covers), gh, gw), dtype=torch.bool, device=dev)
    if not any(covers):
        raise ValueError("the fit scenes hold no cover")
    for i, cs in enumerate(covers):
        for (cx, cy, r) in cs:
            d2 = (ax - (cx * ratio + dw)) ** 2 + (ay - (cy * ratio + dh)) ** 2
            mask[i] |= d2 < (frac * r * ratio) ** 2
            mask[i].view(-1)[int(d2.argmin())] = True
    x = fmap.reshape(-1, fmap.shape[-1])
    xb = torch.cat([x, torch.ones_like(x[:, :1])], 1)
    gram = xb.T @ xb
    lam = ridge * torch.trace(gram) / xb.shape[1]
    y = torch.where(mask.reshape(-1), 1.0, -1.0).to(torch.float64)
    wb = torch.linalg.solve(gram + lam * torch.eye(xb.shape[1], device=dev,
                                                   dtype=torch.float64),
                            xb.T @ y)
    pred = xb @ wb
    mp, mn = pred[y > 0].mean(), pred[y < 0].mean()
    alpha = 12.0 / (mp - mn)
    head = tree["det"]["params"]["detect"]
    kern = torch.zeros_like(head["cls0_2"]["kernel"])
    kern[0, 0, :, 0] = (alpha * wb[:-1]).to(kern.dtype)
    head["cls0_2"]["kernel"] = kern
    bias = torch.full_like(head["cls0_2"]["bias"], -20.0)
    bias[0] = (alpha * wb[-1] - 8.0 - alpha * mn).to(bias.dtype)
    head["cls0_2"]["bias"] = bias
    for i in (1, 2):
        head[f"cls{i}_2"]["kernel"] = torch.zeros_like(
            head[f"cls{i}_2"]["kernel"])
        head[f"cls{i}_2"]["bias"] = torch.full_like(
            head[f"cls{i}_2"]["bias"], -20.0)
    reg = d["reg_max"]
    onehot = torch.zeros(reg, device=dev)
    onehot[min(box_bin, reg - 1)] = 8.0
    head["box0_2"]["kernel"] = torch.zeros_like(head["box0_2"]["kernel"])
    head["box0_2"]["bias"] = onehot.repeat(4)
    return tree
