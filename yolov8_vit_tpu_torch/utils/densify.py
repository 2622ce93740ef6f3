"""Synthetic benchmark scenes: a dense detect head and cover scenes."""
from __future__ import annotations

import numpy as np
import torch

from yolov8_vit_tpu_torch.weights import as_tensor


def densify_detect_head(tree: dict, reg_max: int = 16) -> dict:
    """Re-bias a two-stage tree's detect head so a random-init pipeline
    emits many small disjoint detections: the DFL bins are biased low
    (small anchor-centered boxes) and the final convs sharpened (score and
    size diversity).  Mutates and returns `tree`."""
    head = tree["det"]["params"]["detect"]
    low = -2.0 * torch.arange(reg_max, dtype=torch.float32).repeat(4)
    for i in range(3):
        box = head[f"box{i}_2"]
        box["kernel"] = as_tensor(box["kernel"]) * 3.0
        box["bias"] = low.to(as_tensor(box["bias"]).dtype)
        cls = head[f"cls{i}_2"]
        cls["kernel"] = as_tensor(cls["kernel"]) * 40.0
    return tree


def fit_detect_head(tree: dict, pipeline, images: np.ndarray, covers,
                    frac: float = 0.35, box_bin: int = 12,
                    ridge: float = 1e-3, min_separation: float = 3.0) -> dict:
    """Make a random two-stage tree's detect head respond to scene content
    at production density (~1-2 covers per frame): ridge-fit the final P3
    1x1 cls conv (class 0) on the frozen random backbone's P3 cls features
    so planted covers score high and background low, silence P4/P5 and pin
    the P3 DFL distribution to one bin (boxes of ~2*box_bin*stride px, so
    NMS collapses each cover's anchor cluster to about one box).

    `pipeline` is a TwoStagePipeline whose detector already holds the
    tree's det params; `images`/`covers` come from `make_cover_scenes` (fit
    scenes; time on fresh ones).  Only head output convs change.  Mutates
    and returns `tree`; raises if the scenes hold no cover, warns if the
    fit separates covers from background by < `min_separation` sigma."""
    from yolov8_vit_tpu_torch.ops import blob, letterbox_fast

    cfg = pipeline.det_cfg
    stride = cfg.strides[0]
    imgs = torch.from_numpy(np.asarray(images)).to(pipeline.device)
    lb, ratio, (dw, dh) = letterbox_fast(imgs, cfg.input_size,
                                         pad_value=cfg.pad_value,
                                         dtype=pipeline.dtype)
    captured = []
    hook = pipeline.det.detect.cls0_1.register_forward_hook(
        lambda _m, _i, out: captured.append(out))
    try:
        with torch.no_grad():
            pipeline.det(blob(lb).to(pipeline.dtype))
    finally:
        hook.remove()
    fmap = captured[0].permute(0, 2, 3, 1).to(torch.float64).cpu().numpy()
    gh, gw = cfg.input_size[0] // stride, cfg.input_size[1] // stride
    c3 = fmap.shape[-1]

    # positive mask: anchor centers (letterboxed coords) inside frac * r of
    # a planted cover, plus always the nearest anchor of each cover
    ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    ax, ay = (xs + 0.5) * stride, (ys + 0.5) * stride
    mask = np.zeros((len(covers), gh, gw), bool)
    if not any(covers):
        raise ValueError("fit_detect_head: fit scenes contain no covers")
    for i, cs in enumerate(covers):
        for (cx, cy, r) in cs:
            d2 = (ax - (cx * ratio + dw)) ** 2 + (ay - (cy * ratio + dh)) ** 2
            mask[i] |= d2 < (frac * r * ratio) ** 2
            mask[i].flat[int(d2.argmin())] = True

    # ridge regression with a bias column, targets +-1
    x = fmap.reshape(-1, c3)
    xb = np.concatenate([x, np.ones((x.shape[0], 1))], 1)
    gram = xb.T @ xb
    lam = ridge * np.trace(gram) / xb.shape[1]
    y = np.where(mask.reshape(-1), 1.0, -1.0)
    wb = np.linalg.solve(gram + lam * np.eye(xb.shape[1]), xb.T @ y)
    pred = xb @ wb
    mp, mn = pred[y > 0].mean(), pred[y < 0].mean()
    sep = (mp - mn) / max(pred[y < 0].std(), 1e-12)
    if sep < min_separation:
        import warnings
        warnings.warn(f"fit_detect_head: cover/background separation is "
                      f"only {sep:.1f} sigma (<{min_separation})",
                      stacklevel=2)
    # affine rescale: background mean -> logit -8, cover mean -> +4
    alpha = 12.0 / (mp - mn)
    head = tree["det"]["params"]["detect"]
    kern = torch.zeros_like(as_tensor(head["cls0_2"]["kernel"]))
    kern[0, 0, :, 0] = torch.from_numpy(alpha * wb[:-1]).to(kern.dtype)
    head["cls0_2"]["kernel"] = kern
    bias = torch.full_like(as_tensor(head["cls0_2"]["bias"]), -20.0)
    bias[0] = float(alpha * wb[-1] - 8.0 - alpha * mn)
    head["cls0_2"]["bias"] = bias
    for i in (1, 2):
        head[f"cls{i}_2"]["kernel"] = torch.zeros_like(
            as_tensor(head[f"cls{i}_2"]["kernel"]))
        head[f"cls{i}_2"]["bias"] = torch.full_like(
            as_tensor(head[f"cls{i}_2"]["bias"]), -20.0)
    onehot = torch.zeros(cfg.reg_max)
    onehot[min(box_bin, cfg.reg_max - 1)] = 8.0
    box = head["box0_2"]
    box["kernel"] = torch.zeros_like(as_tensor(box["kernel"]))
    box["bias"] = onehot.repeat(4).to(as_tensor(box["bias"]).dtype)
    return tree


def make_cover_scenes(rng: np.random.Generator, n: int,
                      hw: tuple[int, int] = (640, 640), lam: float = 1.5,
                      max_covers: int = 5):
    """Field-camera-like frames: Gaussian sensor noise plus Poisson(`lam`)
    bright filled disks ("covers") per frame, radii 5.5-11% of the short
    side.  Returns (images uint8 (n, H, W, 3), per-image lists of
    (cx, cy, r))."""
    h, w = hw
    m = min(h, w)
    r_lo = max(4, int(0.055 * m))
    r_hi = max(r_lo + 1, int(0.11 * m))
    yy, xx = np.mgrid[0:h, 0:w]
    imgs, covers = [], []
    for _ in range(n):
        img = rng.normal(90.0, 18.0, (h, w, 3)).clip(0, 255).astype(np.uint8)
        k = min(int(rng.poisson(lam)), max_covers)
        cs = []
        for _ in range(k):
            r = int(rng.integers(r_lo, r_hi))
            cx = int(rng.integers(r + 4, w - r - 4))
            cy = int(rng.integers(r + 4, h - r - 4))
            color = rng.integers(150, 255, 3).astype(np.uint8)
            img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = color
            cs.append((cx, cy, r))
        imgs.append(img)
        covers.append(cs)
    return np.stack(imgs), covers
