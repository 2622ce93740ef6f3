"""YOLOv8 fine-tuning: dataset, train step, validation, the train loop and
the retrain (PyTorch port of `yolov8_vit_tpu/train/yolo_train.py`,
function for function).

  train(epochs, batch, data_root)   validate, fine-tune (lr0 = 1e-4, flat
                                    after warmup, EMA), validate the EMA
  yolo_retrain(workdir)             xml2txt -> train -> the detect engine
  validate(model, dataset, cfg)     decode + stage-1 NMS (kernel A on the
                                    card) at conf .25, then mAP

The model is `YOLOv8(...).train_form()`: f32, every tree leaf an
nn.Parameter, forward and backward plain PyTorch autograd (JAX computes
them as plain XLA: no Pallas kernel lies on the training step).  Each step
holds cuDNN's and cuBLAS's TF32 switches off over its forward, backward
and optimizer step (`models.yolov8.f32_training`), as the JAX reference
trains in f32.  The trainer runs on `device`, the card unless the caller
asks for the CPU; with a `mesh` (parallel/mesh.py, one process per
device) each step splits its batch's rows over the data axis and sums the
ranks' gradients of the whole batch's loss (`make_yolo_train_step`).

The dataset draws from one np.random.Generator in the JAX module's order
and reproduces its OpenCV calls in numpy (train/augment.py: uint8
RGB <-> HSV, the uint8 affine warp with a constant border; the letterbox
of serve/infer.py), so one seed gives the same batches bit for bit.
Images are read through serve/imageio.py.
"""
from __future__ import annotations

import dataclasses
import io
import os
from typing import Callable, Iterator

import numpy as np
import torch

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.config import DetectConfig
from yolov8_vit_tpu_torch.models.yolov8 import (YOLOv8, detect_spec,
                                                f32_training,
                                                flatten_head_outputs)
from yolov8_vit_tpu_torch.parallel import sharding
from yolov8_vit_tpu_torch.parallel.mesh import axis_group, axis_size
from yolov8_vit_tpu_torch.runtime.detector import decode_predictions
from yolov8_vit_tpu_torch.serve import imageio
from yolov8_vit_tpu_torch.serve.infer import _letterbox_host
from yolov8_vit_tpu_torch.train.augment import (hsv2rgb_u8, rgb2hsv_u8,
                                                warp_affine_u8)
from yolov8_vit_tpu_torch.train.ema import EMA
from yolov8_vit_tpu_torch.train.map_eval import evaluate_map
from yolov8_vit_tpu_torch.train.yolo_loss import yolo_detection_loss
from yolov8_vit_tpu_torch.weights import (_reset, load_tree, module_tree,
                                          read_engine, save_engine)

_F32 = np.float32


# --------------------------------------------------------------------------
# augmentations (ultralytics' model.train() recipe)
# --------------------------------------------------------------------------

def augment_hsv(img: np.ndarray, rng: np.random.Generator,
                hgain: float = 0.015, sgain: float = 0.7,
                vgain: float = 0.4) -> np.ndarray:
    """Random HSV jitter with the ultralytics default gains, applied by
    lookup table to OpenCV's uint8 HSV.  RGB uint8 in and out; the
    identity when every gain is 0."""
    if hgain == sgain == vgain == 0:
        return img
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = rgb2hsv_u8(img)
    x = np.arange(0, 256, dtype=np.float32)
    lut_h = ((x * r[0]) % 180).astype(np.uint8)
    lut_s = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_v = np.clip(x * r[2], 0, 255).astype(np.uint8)
    return hsv2rgb_u8(np.stack([lut_h[hsv[..., 0]], lut_s[hsv[..., 1]],
                                lut_v[hsv[..., 2]]], -1))


def random_affine(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                  rng: np.random.Generator, out_size: int,
                  degrees: float = 0.0, translate: float = 0.1,
                  scale: float = 0.5):
    """Random scale / translate (/ rotate) mapping img -> (out_size,
    out_size): s in [1 - scale, 1 + scale], a shift of +-translate *
    out_size, the image warped (uint8, border 114), the box corners moved
    by the same matrix and clipped, degenerate candidates dropped (w or h
    < 2 px, or area shrunk below 10 %).  A float image is taken to uint8
    by truncation, as the JAX module does.  Returns (image (out, out, 3)
    f32 in [0, 1], boxes, labels)."""
    h, w = img.shape[:2]
    s = rng.uniform(1 - scale, 1 + scale)
    a = np.deg2rad(rng.uniform(-degrees, degrees)) if degrees else 0.0
    cx, cy = w / 2, h / 2
    cos, sin = np.cos(a) * s, np.sin(a) * s
    tx = rng.uniform(0.5 - translate, 0.5 + translate) * out_size
    ty = rng.uniform(0.5 - translate, 0.5 + translate) * out_size
    m = np.array([[cos, -sin, tx - cos * cx + sin * cy],
                  [sin, cos, ty - sin * cx - cos * cy]], np.float32)
    src = img if img.dtype == np.uint8 else \
        np.clip(img * 255.0, 0, 255).astype(np.uint8)
    warped = warp_affine_u8(src, m, out_size, border=114)
    if len(boxes):
        corners = np.concatenate([
            boxes[:, [0, 1]], boxes[:, [2, 1]],
            boxes[:, [0, 3]], boxes[:, [2, 3]]], 0)          # (4n, 2)
        corners = corners @ m[:, :2].T + m[:, 2]
        corners = corners.reshape(4, -1, 2)
        new = np.concatenate([corners.min(0), corners.max(0)],
                             1).astype(np.float32)           # (n, 4)
        clipped = new.copy()
        clipped[:, [0, 2]] = clipped[:, [0, 2]].clip(0, out_size)
        clipped[:, [1, 3]] = clipped[:, [1, 3]].clip(0, out_size)
        wh_new = clipped[:, 2:] - clipped[:, :2]
        area_pre = ((boxes[:, 2] - boxes[:, 0]) *
                    (boxes[:, 3] - boxes[:, 1])) * s * s
        keep = (wh_new > 2).all(1) & \
            (wh_new[:, 0] * wh_new[:, 1] > 0.1 * np.maximum(area_pre, 1e-9))
        boxes, labels = clipped[keep], labels[keep]
    return warped.astype(np.float32) / 255.0, boxes, labels


# --------------------------------------------------------------------------
# dataset
# --------------------------------------------------------------------------

def _pad_labels(boxes, labels, max_gt: int):
    g = min(len(boxes), max_gt)
    pb = np.zeros((max_gt, 4), np.float32)
    pl = np.zeros((max_gt,), np.int32)
    pm = np.zeros((max_gt,), bool)
    pb[:g], pl[:g], pm[:g] = boxes[:g], labels[:g], True
    return pb, pl, pm


@dataclasses.dataclass
class YoloDataset:
    """fold0-layout dataset -> letterboxed batches with padded labels."""

    root: str                      # .../fold0
    split: str = "train"
    img_size: int = 640
    max_gt: int = 32
    # train-time recipe knobs (ultralytics model.train defaults)
    hsv: tuple = (0.015, 0.7, 0.4)
    translate: float = 0.1
    scale: float = 0.5
    degrees: float = 0.0

    def __post_init__(self):
        img_dir = os.path.join(self.root, "images", self.split)
        self.items = []
        if os.path.isdir(img_dir):
            for f in sorted(os.listdir(img_dir)):
                stem = os.path.splitext(f)[0]
                lbl = os.path.join(self.root, "labels", self.split,
                                   stem + ".txt")
                if os.path.exists(lbl):
                    self.items.append((os.path.join(img_dir, f), lbl))

    def __len__(self):
        return len(self.items)

    def _load(self, idx: int, augment: bool, rng: np.random.Generator):
        path, lbl = self.items[idx]
        img = imageio.imread_rgb(path)
        if img is None:
            raise OSError(f"cannot read image {path}")
        h, w = img.shape[:2]
        with open(lbl) as f:
            text = f.read()
        # an image without boxes has an empty label file
        rows = np.loadtxt(io.StringIO(text), ndmin=2, dtype=np.float32) \
            if text.strip() else np.zeros((0, 5), np.float32)
        labels = rows[:, 0].astype(np.int32)
        cxcywh = rows[:, 1:]
        boxes = np.stack([(cxcywh[:, 0] - cxcywh[:, 2] / 2) * w,
                          (cxcywh[:, 1] - cxcywh[:, 3] / 2) * h,
                          (cxcywh[:, 0] + cxcywh[:, 2] / 2) * w,
                          (cxcywh[:, 1] + cxcywh[:, 3] / 2) * h], -1) \
            if len(cxcywh) else np.zeros((0, 4), np.float32)

        if augment and rng.random() < 0.5:          # horizontal flip
            img = img[:, ::-1]
            boxes = boxes.copy()
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        if augment:                                  # HSV colour jitter
            img = augment_hsv(np.ascontiguousarray(img), rng, *self.hsv)

        lb_img, ratio, (dw, dh) = _letterbox_host(
            img, (self.img_size, self.img_size))
        boxes = boxes * ratio + np.array([dw, dh, dw, dh], np.float32)
        return (lb_img.astype(np.float32) / 255.0,
                *_pad_labels(boxes, labels, self.max_gt))

    def _mosaic(self, idx: int, rng: np.random.Generator):
        """4-image mosaic + random affine: four letterboxed images tile a
        2S canvas, a random scale / translate maps the canvas to S with
        the boxes remapped (scale 1 shows the canvas centre 1:1,
        ultralytics' random_perspective(border=-S/2))."""
        s = self.img_size
        picks = [idx] + [int(rng.integers(0, len(self.items)))
                         for _ in range(3)]
        canvas = np.zeros((2 * s, 2 * s, 3), np.float32)
        boxes_all, labels_all = [], []
        for q, i in enumerate(picks):
            img, bx, lb, mk = self._load(i, True, rng)
            oy, ox = (q // 2) * s, (q % 2) * s
            canvas[oy:oy + s, ox:ox + s] = img
            valid = bx[mk]
            if len(valid):
                boxes_all.append(valid + np.array([ox, oy, ox, oy],
                                                  np.float32))
                labels_all.append(lb[mk])
        if boxes_all:
            boxes = np.concatenate(boxes_all)
            labels = np.concatenate(labels_all)
        else:
            boxes = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int32)
        canvas, boxes, labels = random_affine(
            canvas, boxes, labels, rng, s, degrees=self.degrees,
            translate=self.translate, scale=self.scale)
        return (canvas.astype(np.float32),
                *_pad_labels(boxes, labels, self.max_gt))

    def batches(self, batch_size: int, augment: bool = False,
                seed: int = 0, mosaic: float = 1.0,
                drop_last: bool = True) -> Iterator[tuple]:
        """(imgs (B, S, S, 3) f32 in [0, 1], boxes (B, G, 4), labels
        (B, G), mask (B, G)) numpy batches.  drop_last=True (training)
        skips the tail partial batch; evaluation passes drop_last=False
        so the metrics cover every image."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.items)) if augment else \
            np.arange(len(self.items))
        stop = len(order) - batch_size + 1 if drop_last else len(order)
        for s in range(0, max(stop, 0 if drop_last else 1), batch_size):
            idxs = order[s:s + batch_size]
            if len(idxs) == 0:
                break
            chunk = []
            for i in idxs:
                if augment and rng.random() < mosaic and len(self.items) >= 4:
                    chunk.append(self._mosaic(int(i), rng))
                else:
                    chunk.append(self._load(int(i), augment, rng))
            yield tuple(np.stack([c[j] for c in chunk]) for j in range(4))


# --------------------------------------------------------------------------
# multi-scale resize: jax.image.resize(..., "bilinear") with its antialias
# --------------------------------------------------------------------------

def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of jax.image.scale_and_translate's
    triangle kernel (scale n_out / n_in, no translation), computed in f32
    as JAX computes them: the kernel widened by 1 / scale when it shrinks
    (the antialias), each output's weights normalised to sum 1, zero for
    samples outside the input."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = _F32(max(inv_scale, 1.0))
    sample = (np.arange(n_out, dtype=_F32) + _F32(0.5)) * _F32(inv_scale) \
        - _F32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=_F32)[:, None]) \
        / kernel_scale
    w = np.maximum(_F32(0), _F32(1) - np.abs(x))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, _F32(1)), _F32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, _F32(0)).astype(_F32)


def resize_bilinear_antialias(imgs: torch.Tensor, size: int) -> torch.Tensor:
    """jax.image.resize(imgs, (B, size, size, C), "bilinear") on NHWC
    f32: a scale-and-translate with the triangle kernel along H and W
    (antialiased when it shrinks).  Not ops/resize.py's function, which
    has cv2's semantics."""
    b, h, w, c = imgs.shape
    wy = torch.from_numpy(_resize_weights(h, size)).to(imgs.device)
    wx = torch.from_numpy(_resize_weights(w, size)).to(imgs.device)
    return torch.einsum("bhwc,hy,wx->byxc", imgs, wy, wx)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def make_lr_schedule(lr0: float, lrf: float, total_steps: int,
                     warmup_steps: int, cos_lr: bool = False):
    """ultralytics' LR shape: linear warmup over `warmup_steps`, then a
    linear decay lr0 -> lr0 * lrf over the run (cosine one-cycle when
    cos_lr); f32 arithmetic, as the JAX schedule's."""
    def sched(count):
        c = _F32(count)
        w = min((c + _F32(1.0)) / _F32(warmup_steps), _F32(1.0)) \
            if warmup_steps > 0 else _F32(1.0)
        frac = np.clip(c / _F32(max(float(total_steps), 1.0)), _F32(0),
                       _F32(1))
        if cos_lr:
            decay = lrf + (1.0 - lrf) * 0.5 * (
                _F32(1.0) + np.cos(_F32(np.pi) * frac))
        else:
            decay = (_F32(1.0) - frac) * (1.0 - lrf) + lrf
        return _F32(lr0 * w * decay)
    return sched


def param_group_label(path: tuple, leaf) -> str:
    """ultralytics `build_optimizer`'s partition by flax path: 'bias'
    (every bias: no decay, bias warmup), 'norm' (BatchNorm / LayerNorm
    scales: no decay), 'weight' (conv / linear kernels: weight decay)."""
    name = str(path[-1]) if path else ""
    if name == "bias":
        return "bias"
    modname = str(path[-2]) if len(path) >= 2 else ""
    if name == "scale" or modname in ("bn", "norm"):
        return "norm"
    if getattr(leaf, "ndim", 0) >= 2:
        return "weight"
    return "norm"


class YoloSGD:
    """ultralytics' SGD, update for update (as the JAX package's optax
    chain `make_yolo_optimizer`):

      * three groups by flax path (`param_group_label`), decay only on
        'weight';
      * the gradients' global norm clipped at 10 before anything else
        (torch.nn.utils.clip_grad_norm_);
      * nesterov momentum in torch's order (decay added to the gradient
        before the momentum buffer, update = g + mu v), torch.optim.SGD;
      * warmup over the first `warmup_steps` steps: the bias LR ramps DOWN
        from `warmup_bias_lr` to lr0 lf(epoch), the others up from 0,
        momentum `warmup_momentum` -> `momentum`;
      * the per-epoch stairstep lf(epoch) = (1 - e / E)(1 - lrf) + lrf
        (cosine one-cycle when cos_lr).

    The step's LR and momentum are computed in f32, as JAX's are."""

    def __init__(self, named_params: dict, lr0: float, lrf: float,
                 epochs: int, steps_per_epoch: int, warmup_steps: int,
                 cos_lr: bool = False, weight_decay: float = 5e-4,
                 momentum: float = 0.937, warmup_momentum: float = 0.8,
                 warmup_bias_lr: float = 0.1):
        groups: dict = {"bias": [], "weight": [], "norm": []}
        for name, p in named_params.items():
            groups[param_group_label(tuple(name.split(".")), p)].append(p)
        self.params = list(named_params.values())
        # group order as ultralytics builds it: bias, weight, norm
        self.sgd = torch.optim.SGD(
            [{"params": groups["bias"], "weight_decay": 0.0},
             {"params": groups["weight"], "weight_decay": weight_decay},
             {"params": groups["norm"], "weight_decay": 0.0}],
            lr=lr0, momentum=momentum, dampening=0.0, nesterov=True)
        self.lr0, self.lrf, self.epochs = lr0, lrf, epochs
        self.steps_per_epoch, self.warmup_steps = steps_per_epoch, \
            warmup_steps
        self.cos_lr, self.momentum = cos_lr, momentum
        self.warmup_momentum, self.warmup_bias_lr = warmup_momentum, \
            warmup_bias_lr
        self.count = 0

    def _lf(self, epoch: int):
        frac = _F32(epoch) / _F32(max(float(self.epochs), 1.0))
        if self.cos_lr:
            return self.lrf + (1.0 - self.lrf) * 0.5 * (
                _F32(1.0) + np.cos(_F32(np.pi) * frac))
        return (_F32(1.0) - frac) * (1.0 - self.lrf) + self.lrf

    def _interp(self, y0, y1):
        """np.interp(count, [0, warmup_steps], [y0, y1]), clamped."""
        if self.warmup_steps <= 0:
            return y1
        t = np.clip(_F32(self.count) / _F32(self.warmup_steps), _F32(0),
                    _F32(1))
        return y0 + (y1 - y0) * t

    def step(self) -> None:
        """One update from the parameters' .grad, then count += 1."""
        torch.nn.utils.clip_grad_norm_(self.params, 10.0)
        epoch = self.count // max(self.steps_per_epoch, 1)
        base = _F32(self.lr0 * self._lf(epoch))
        lr_w = float(self._interp(0.0, base))
        lr_b = float(self._interp(self.warmup_bias_lr, base))
        mu = float(self._interp(self.warmup_momentum, self.momentum))
        for group, lr in zip(self.sgd.param_groups, (lr_b, lr_w, lr_w)):
            group["lr"], group["momentum"] = lr, mu
        self.sgd.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)


def make_yolo_optimizer(named_params: dict, lr0: float, lrf: float,
                        epochs: int, steps_per_epoch: int,
                        warmup_steps: int, **kw) -> YoloSGD:
    """`YoloSGD` over a model's named parameters (flax paths joined by
    '.', as `named_parameters()` of the training form gives them)."""
    return YoloSGD(named_params, lr0, lrf, epochs, steps_per_epoch,
                   warmup_steps, **kw)


def make_yolo_train_step(model: YOLOv8, optimizer: YoloSGD, input_hw,
                         reg_max: int = 16, mesh=None, strides=(8, 16, 32)):
    """(imgs, boxes, labels, mask) tensors on the model's device ->
    (loss, parts), one optimizer step on `model` in place, in full f32
    (`f32_training`).  `strides` must be the head's: the loss builds its
    anchor grid from them.

    With a mesh (every rank passes the whole batch, the same params) each
    rank takes its rows over the data axis; the loss normalises by the
    whole batch's target-score sum and size, and the ranks' gradients are
    summed before the optimizer step (clip included), so the step is the
    whole batch's, as the JAX step sharded by XLA is.  The loss and parts
    returned are the whole batch's.  A batch whose rows do not divide over
    the data axis runs replicated."""
    n = axis_size(mesh, "data") if mesh is not None else 1
    group = axis_group(mesh, "data") if mesh is not None else None

    def step(imgs, boxes, labels, mask):
        split = group is not None and imgs.shape[0] % n == 0
        if split:
            imgs, boxes, labels, mask = sharding.shard_batch(
                mesh, (imgs, boxes, labels, mask))
        with f32_training():
            optimizer.zero_grad()
            bd, cl = flatten_head_outputs(model(imgs))
            loss, parts = yolo_detection_loss(
                bd, cl, boxes, labels, mask, input_hw, strides=strides,
                reg_max=reg_max, data_group=group if split else None)
            loss.backward()
            if split:
                sharding.reduce_grads(model.parameters(), group)
            optimizer.step()
        out = [loss.detach()] + [parts[k].detach() for k in sorted(parts)]
        if split:
            flat = torch.stack(out)
            torch.distributed.all_reduce(flat, group=group)
            out = list(flat)
        return out[0], dict(zip(sorted(parts), out[1:]))

    return step


@torch.no_grad()
def validate(model: YOLOv8, dataset: YoloDataset, cfg: DetectConfig,
             batch_size: int = 16, conf: float = 0.25) -> dict:
    """model.val's evaluation: the f32 model, decode + stage-1 NMS
    (`decode_predictions`: kernel A on the card), then mAP at conf .25."""
    device = next(model.parameters()).device
    preds, gts = [], []
    for imgs, boxes, labels, mask in dataset.batches(
            min(batch_size, max(len(dataset), 1)), drop_last=False):
        x = torch.from_numpy(imgs).to(device)
        num, bb, sc, lb = (t.cpu().numpy() for t in
                           decode_predictions(model(x), cfg))
        for i in range(len(imgs)):
            n = int(num[i])
            preds.append({"boxes": bb[i][:n], "scores": sc[i][:n],
                          "labels": lb[i][:n]})
            m = mask[i]
            gts.append({"boxes": boxes[i][m], "labels": labels[i][m]})
    return evaluate_map(preds, gts, cfg.num_classes, conf_threshold=conf)


def build_train_model(cfg: DetectConfig, weights: str | None = None,
                      device="cpu") -> YOLOv8:
    """The training form on `device`: loaded from a detect engine dir
    when `weights` is one, else drawn with the flax initializers from a
    CPU generator seeded with 0."""
    model = YOLOv8(detect_spec(cfg))
    if weights and os.path.isdir(weights):
        load_tree(model, read_engine(weights)[1]["params"])
    else:
        _reset(model, torch.Generator().manual_seed(0))
    return model.train_form().to(device)


def train(epochs: int, batch: int, data_root: str,
          cfg: DetectConfig = DetectConfig(variant="s"),
          lr0: float = 1e-4, weights: str | None = None,
          max_gt: int = 32, log_fn: Callable[[str], None] = print,
          skip_preval: bool = False, use_ema: bool = True, mesh=None,
          lrf: float = 1.0, cos_lr: bool = False,
          warmup_epochs: float = 3.0, multi_scale: bool = False,
          augment: bool = True, mosaic: float = 1.0, device="cuda"):
    """Fine-tune on `device` (the reference's train()).

    data_root: the fold0 directory (images / labels x train / val).
    weights: a detect-engine dir to resume from.  lrf / cos_lr /
    warmup_epochs / multi_scale are ultralytics' `model.train()` knobs;
    the reference's lr0 = lrf = 1e-4 call maps to lrf = 1.0 (flat after
    warmup).  multi_scale resizes each batch by a random factor in
    {0.75, 1, 1.25} (`resize_bilinear_antialias`).  Validates before
    (unless skip_preval) and after; the EMA params are validated and
    returned, as ultralytics exports them.
    With a `mesh`, every rank of it calls `train` alike: each step splits
    its batch over the data axis (`make_yolo_train_step`).
    Returns (params {"params": tree}, {"preval": ..., "final": ...})."""
    device = _build.resolve_device(device)
    resume = bool(weights and os.path.isdir(weights))
    model = build_train_model(cfg, weights if resume else None, device)
    if resume:
        log_fn(f"resumed from {weights}")
    size = cfg.input_size[0]

    train_ds = YoloDataset(data_root, "train", size, max_gt)
    val_ds = YoloDataset(data_root, "val", size, max_gt)
    metrics = {}
    if len(val_ds) and not skip_preval:
        metrics["preval"] = validate(model, val_ds, cfg)
        log_fn(f"val before training: {metrics['preval']}")

    steps_per_epoch = max(len(train_ds) // max(batch, 1), 1)
    warmup_steps = (max(round(warmup_epochs * steps_per_epoch), 100)
                    if warmup_epochs > 0 else 0)
    named = dict(model.named_parameters())
    opt = make_yolo_optimizer(named, lr0, lrf, epochs, steps_per_epoch,
                              warmup_steps, cos_lr=cos_lr)
    steps = {}

    def step_for(sz):
        if sz not in steps:
            steps[sz] = make_yolo_train_step(model, opt, (sz, sz),
                                             cfg.reg_max, mesh=mesh,
                                             strides=cfg.strides)
        return steps[sz]

    ema = EMA(named) if use_ema else None
    ms_rng = np.random.default_rng(0)
    for epoch in range(epochs):
        losses = []
        for imgs, boxes, labels, mask in train_ds.batches(
                batch, augment=augment, seed=epoch, mosaic=mosaic):
            sz = size
            if multi_scale:
                sz = int(round(size * ms_rng.choice((0.75, 1.0, 1.25))
                               / 64) * 64)
            imgs_d = torch.from_numpy(imgs).to(device)
            boxes_d = torch.from_numpy(boxes).to(device)
            if sz != size:
                with f32_training():
                    imgs_d = resize_bilinear_antialias(imgs_d, sz)
                boxes_d = boxes_d * (sz / size)
            loss, _ = step_for(sz)(imgs_d, boxes_d,
                                   torch.from_numpy(labels).to(device),
                                   torch.from_numpy(mask).to(device))
            if ema is not None:
                ema.update(named)
            losses.append(loss)
        mean = np.mean([float(v) for v in losses]) if losses \
            else float("nan")
        log_fn(f"epoch {epoch + 1}/{epochs}: loss {mean:.4f}")

    # ultralytics validates and exports the EMA weights
    if ema is not None and ema.updates:
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(ema.params[name])
    if len(val_ds):
        metrics["final"] = validate(model, val_ds, cfg)
        log_fn(f"val after training: {metrics['final']}")
    return {"params": module_tree(model)}, metrics


def yolo_retrain(workdir: str = ".",
                 cfg: DetectConfig = DetectConfig(variant="s"),
                 epochs: int = 1, batch: int = 1,
                 log_fn: Callable[[str], None] = print, device="cuda"):
    """The reference's yoloRetrain: convert the VOC XMLs of train/new into
    train/yolo/fold0, fine-tune (resuming from weights/detect_engine when
    it exists) and write the detect engine there, with the config in its
    meta.  Returns the metrics of `train`."""
    from yolov8_vit_tpu_torch.data.voc import xml2txt

    device = _build.resolve_device(device)
    fold = os.path.join(workdir, "train/yolo/fold0")
    n = xml2txt(os.path.join(workdir, "train/new"), fold)
    log_fn(f"converted {n} annotations")
    weights = os.path.join(workdir, "weights/detect_engine")
    params, metrics = train(epochs, batch, fold, cfg,
                            weights=weights if os.path.isdir(weights) else None,
                            log_fn=log_fn, device=device)
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["input_size"] = list(cfg_dict["input_size"])
    cfg_dict["strides"] = list(cfg_dict["strides"])
    save_engine(weights, "detect", params, {"detect_cfg": cfg_dict})
    log_fn("detect engine exported")
    return metrics
