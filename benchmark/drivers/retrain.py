"""The classifier retrain behind the service's trigger: the configuration's
ViT in its f32 training form through `ViTTrainer.train_one_epoch`, at
`CFG()`'s batch, learning rate and SGD settings, fed by a `ClassifierData`
over a seeded labelled set that set-up writes as JPEG frames with VOC
XML.  The harness's loader runs epoch after epoch of the data until the
window ends, and times how long the trainer waits on it.

Mix parameters: frames, objects (cover objects over the five classes),
height, width, quality (JPEG), workers (the data's decode threads),
setup_steps (the first steps, run in set-up through the window's own call
and feed, one call each), window_checked (the window's first steps, taken
inside its one long call), data_checked (evaluation crops of the data
stage compared), trace_seconds.  The reference follows every step from
the benchmark's weights on the batches the trainer was fed, up to the
window's `window_checked`-th.

train_samples_per_s: samples trained over the whole window's time.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

from benchmark import weights
from benchmark.reference.pipeline import exact_f32
from benchmark.reference.train import Trainer
from benchmark.weights import sub_seed

CLASS_RGB = ((200, 60, 50), (60, 200, 60), (210, 200, 60), (50, 60, 210),
             (60, 200, 210))


def write_dataset(seed: int, mix: dict, root: str, device) -> list:
    """`frames` JPEG frames of sensor noise N(110, 20) with `objects`
    filled disks in all (radius 5.5-11% of the short side), each of a
    class's colour (classes in turn), and a VOC XML each (class ids under
    <sort>), under root/.  Returns the objects: [(frame path, box,
    class)]."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image
    rng = np.random.default_rng(seed)
    h, w, n_frames = mix["height"], mix["width"], mix["frames"]
    counts = np.bincount(rng.integers(0, n_frames, mix["objects"]),
                         minlength=n_frames)
    gen = torch.Generator(device=device).manual_seed(seed)
    imgs = (torch.randn((n_frames, h, w, 3), generator=gen, device=device)
            * 20.0 + 110.0).clamp_(0, 255).to(torch.uint8).cpu().numpy()
    r_lo = max(4, int(0.055 * min(h, w)))
    r_hi = max(r_lo + 1, int(0.11 * min(h, w)))
    k = 0
    objects = []
    os.makedirs(root, exist_ok=True)
    for i, n in enumerate(counts):
        ann = ET.Element("annotation")
        ET.SubElement(ann, "filename").text = f"t{i:03d}.jpg"
        ET.SubElement(ann, "path").text = f"t{i:03d}.jpg"
        size = ET.SubElement(ann, "size")
        ET.SubElement(size, "width").text = str(w)
        ET.SubElement(size, "height").text = str(h)
        ET.SubElement(size, "depth").text = "3"
        for _ in range(n):
            cls = k % 5
            k += 1
            r = int(rng.integers(r_lo, r_hi))
            cx, cy = int(rng.integers(r, w - r)), int(rng.integers(r, h - r))
            yy, xx = np.ogrid[cy - r:cy + r + 1, cx - r:cx + r + 1]
            disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            imgs[i, cy - r:cy + r + 1, cx - r:cx + r + 1][disk] = \
                CLASS_RGB[cls]
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "sort").text = str(cls)
            box = ET.SubElement(obj, "bndbox")
            for key, v in (("xmin", cx - r), ("ymin", cy - r),
                           ("xmax", cx + r), ("ymax", cy + r)):
                ET.SubElement(box, key).text = str(v)
            objects.append((os.path.join(root, f"t{i:03d}.jpg"),
                            (cx - r, cy - r, cx + r, cy + r), cls))
        ET.ElementTree(ann).write(os.path.join(root, f"t{i:03d}.xml"))

    def encode(i):
        Image.fromarray(imgs[i]).save(os.path.join(root, f"t{i:03d}.jpg"),
                                      "JPEG", quality=mix["quality"])

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(encode, range(n_frames)))
    return objects


def eval_crop(path: str, box, size: int) -> np.ndarray:
    """The reference's evaluation crop of an object: each side moved out
    by (side // 10) // 2 (clamped), cut, nearest-resized to size x size as
    OpenCV's INTER_NEAREST computes it (source index floor(i * ifx) in
    double, ifx = 1 / (size / src)), uint8 RGB."""
    from PIL import Image
    with Image.open(path) as im:
        img = np.asarray(im.convert("RGB"))
    h, w = img.shape[:2]
    x1, y1, x2, y2 = box
    dx, dy = (x2 - x1) // 10 // 2, (y2 - y1) // 10 // 2
    img = img[max(0, y1 - dy):min(h, y2 + dy), max(0, x1 - dx):min(w, x2 + dx)]
    def index(src):
        ifx = 1.0 / (size / src)
        return np.minimum(np.floor(np.arange(size) * ifx).astype(np.int64),
                          src - 1)
    return img[index(img.shape[0])][:, index(img.shape[1])]


class Feed:
    """The trainer's loader: the data's batches, epoch after epoch, until
    `stop_at` (host clock) or `limit` batches; records the time the
    trainer waited for each batch and keeps every batch it hands out until
    the snapshot that `run`'s `snap` takes."""

    def __init__(self, data):
        self.data = data
        self.epoch = 0
        self._it = None
        self.wait_s = 0.0
        self.batches = 0
        self.kept: list = []
        self.keeping = True

    def _next(self, batch_size: int):
        while True:
            if self._it is None:
                self._it = self.data.batches(batch_size, self.epoch)
            try:
                return next(self._it)
            except StopIteration:
                self._it = None
                self.epoch += 1

    def run(self, batch_size: int, stop_at: float | None = None,
            limit: int | None = None, snap=None):
        """snap: (n, fn): once this call's first n batches are trained
        (the trainer asks for batch n + 1), call fn() and keep no more."""
        n = 0
        while (limit is None or n < limit) and (
                stop_at is None or time.perf_counter() < stop_at):
            if snap is not None and n == snap[0] and self.keeping:
                snap[1]()
                self.keeping = False
            t = time.perf_counter()
            b = self._next(batch_size)
            self.wait_s += time.perf_counter() - t
            self.batches += 1
            n += 1
            if self.keeping:
                self.kept.append((b[0].copy(), b[1].copy()))
            yield b


def _leaves(model) -> dict:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def setup(ctx) -> dict:
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    from yolov8_vit_tpu_torch.config import CFG
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.train.dataset import (ClassifierData,
                                                    split_by_circle)
    from yolov8_vit_tpu_torch.train.vit_train import ViTTrainer
    ctx.mark("import")
    root = tempfile.mkdtemp(prefix="bench_retrain_")
    state = {"root": root}
    try:
        state["objects"] = write_dataset(sub_seed(ctx.seed, 5), mix,
                                         os.path.join(root, "data"), dev)
        ctx.mark("data")
        v = cfg["vit"]
        spec = ViTSpec(img_size=v["img_size"], patch=v["patch"], dim=v["dim"],
                       depth=v["depth"], heads=v["heads"],
                       mlp_ratio=v["mlp_ratio"],
                       backbone_classes=v["backbone_classes"])
        # CFG()'s settings, at the configuration's crop size (CFG's own)
        tcfg = dataclasses.replace(CFG(), img_size=(v["img_size"],) * 2)
        tree = weights.make_tree(cfg, sub_seed(ctx.seed, 0), dev)
        trainer = ViTTrainer(cfg=tcfg, spec=spec, device=dev)
        model, opt = trainer.init(params=tree["vit"]["params"])
        import random
        objs, circ = split_by_circle([os.path.join(root, "data")],
                                     random.Random(sub_seed(ctx.seed, 6)))
        data = ClassifierData(tcfg, objs, circ, training=True,
                              seed=sub_seed(ctx.seed, 7),
                              workers=mix["workers"])
        state["eval_data"] = ClassifierData(tcfg, objs, circ, training=False,
                                            workers=mix["workers"])
        feed = Feed(data)
        ctx.mark("model_data")
        # the first steps, through the window's own call and feed: each
        # call trains one batch, so it returns that step's loss
        losses, first_grad = [], None
        for s in range(mix["setup_steps"]):
            loss, _ = trainer.train_one_epoch(
                model, opt, feed.run(tcfg.train_bs, limit=1), 0)
            losses.append(loss)
            if s == 0:
                # SGD's first momentum is the gradient it took (weight
                # decay added); a step that kept no state took none
                first_grad = {}
                for k, p in model.named_parameters():
                    m = opt.state.get(p, {}).get("momentum_buffer")
                    first_grad[k] = torch.zeros_like(p) if m is None \
                        else m.detach().clone()
        if dev != "cpu":
            torch.cuda.synchronize()
        ctx.mark("first_steps")
        state.update(tree=tree, trainer=trainer, model=model, opt=opt,
                     feed=feed, tcfg=tcfg, losses=losses,
                     first_grad={k: float(g.norm()) for k, g in
                                 first_grad.items()},
                     snap=None, hooks=None)
        if ctx.trace:
            from benchmark.trace import profiled
            with profiled(dev):
                trainer.train_one_epoch(model, opt,
                                        feed.run(tcfg.train_bs, limit=2), 0)
            ctx.mark("trace_warmup")
    except BaseException:
        close(state)
        raise
    return state


def close(state: dict) -> None:
    shutil.rmtree(state["root"], ignore_errors=True)


def window(ctx, state, seconds: float | None = None) -> dict:
    """The window: one call of train_one_epoch fed until `seconds` pass.
    In the first window, the parameters as it starts, and once its first
    `window_checked` steps are taken, are copied on the device (the
    snapshot the reference is held to; a copy of the leaves, no sync)."""
    feed, bs, model = state["feed"], state["tcfg"].train_bs, state["model"]
    seconds = seconds or ctx.seconds
    snap = None
    if feed.keeping:
        state["n_pre"] = len(feed.kept)
        state["p_pre"] = _leaves(model)

        def take():
            state["snap"] = _leaves(model)
        snap = (ctx.mix["window_checked"], take)
    n0, w0 = feed.batches, feed.wait_s
    t0 = time.perf_counter()
    state["trainer"].train_one_epoch(
        model, state["opt"], feed.run(bs, stop_at=t0 + seconds, snap=snap),
        0)
    if ctx.device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if feed.keeping:             # a window of fewer steps than checked
        snap[1]()
        feed.keeping = False
    steps = feed.batches - n0
    return {"e2e": {"train_samples_per_s": steps * bs / dt},
            "attempted": steps, "failed": 0, "window_s": dt, "steps": steps,
            "wait_ms": (feed.wait_s - w0) / max(steps, 1) * 1e3,
            "notes": [f"window: {steps} steps of batch {bs} in {dt:.4f} s; "
                      f"data epochs so far {feed.epoch}; mean wait for a "
                      f"batch {(feed.wait_s - w0) / max(steps, 1) * 1e3:.3f}"
                      f" ms"]}


def trace_slice(ctx, state, win) -> dict:
    from benchmark.trace import profiled
    traces = {}
    secs = ctx.mix["trace_seconds"]
    for host in (False, True):
        with profiled(ctx.device, host=host) as box:
            window(ctx, state, secs)
        traces[host] = box["trace"]
    return {"trace": traces[True], "device_trace": traces[False],
            "cfg": ctx.cfg, "mix": ctx.mix, "window_s": win["window_s"],
            "steps": win["steps"], "wait_ms": win["wait_ms"],
            "batch": state["tcfg"].train_bs}


def weights_flat(state: dict) -> dict:
    """The benchmark's ViT weights, the program's and the reference's
    start, by leaf name."""
    from benchmark.reference.pipeline import _flat
    return _flat(state["tree"]["vit"]["params"])


def _worst_gap(got: dict, want: dict, skip=frozenset()) -> float:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference leaf's norm and the median leaf's."""
    keys = [k for k in want if k not in skip]
    med = float(np.median([want[k] for k in keys]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keys)


def reference_readings(state: dict, ctx, tf32: bool = False) -> dict:
    """The reference's steps on the batches the trainer was fed, up to the
    snapshot, from the benchmark's weights; with `tf32`, the control (TF32
    products where the configuration states float32)."""
    tcfg = state["tcfg"]
    params = weights_flat(state)
    with exact_f32():
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        # the cosine schedule's value at epoch 0 is the base rate
        ref = Trainer(params, ctx.cfg["vit"], tcfg.lr, tcfg.momentum,
                      tcfg.weight_decay)
        p0 = {k: v.detach().clone() for k, v in ref.p.items()}
        losses, first, pre = [], None, p0
        for s, (imgs, onehot) in enumerate(state["feed"].kept):
            if s == state["n_pre"]:
                pre = {k: v.detach().clone() for k, v in ref.p.items()}
            losses.append(ref.step(torch.as_tensor(imgs, device=ctx.device),
                                   torch.as_tensor(onehot,
                                                   device=ctx.device)))
            if s == 0:
                first = {k: float(m.norm()) for k, m in ref.m.items()}
        change = {k: float((p.detach() - p0[k]).norm())
                  for k, p in ref.p.items()}
        window = {k: float((p.detach() - pre[k]).norm())
                  for k, p in ref.p.items()}
    # the losses the program returns: its one-batch set-up calls'
    return {"losses": losses[:ctx.mix["setup_steps"]], "first_grad": first,
            "change": change, "window": window}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: the loss of each step that returns its own
    (the set-up's one-batch calls), the first gradient, the change from
    the benchmark's weights to the snapshot and the window's own change
    (its first steps) by the worst leaf.  Leaves whose first gradient in
    the reference is under a thousandth of the median leaf's (moved by
    round-off alone) are left out of the changes."""
    g = ref["first_grad"]
    med = float(np.median(list(g.values())))
    quiet = frozenset(k for k, v in g.items() if v < 1e-3 * med)
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": _worst_gap(prog["first_grad"], g),
        "change_gap": _worst_gap(prog["change"], ref["change"], quiet),
        "window_gap": _worst_gap(prog["window"], ref["window"], quiet)}


def data_mismatch(state, n: int) -> int:
    """The data stage that the reference takes from the program (the
    training crops' augmentations are the program's random draws), held
    apart where it is deterministic: the first `n` evaluation crops of the
    program's ClassifierData, each as uint8 pixels, against the
    reference's crops of the objects the benchmark wrote; a crop with no
    identical reference crop of its class counts."""
    size = state["tcfg"].img_size[0]
    ref = {(eval_crop(p, b, size).tobytes(), c) for p, b, c in
           state["objects"]}
    miss = 0
    for i, (img, onehot) in enumerate(state["eval_data"].batches(1)):
        if i == n:
            break
        px = np.rint((img[0] + 1.0) / 2.0 * 255.0).astype(np.uint8)
        miss += (px.tobytes(), int(onehot[0].argmax())) not in ref
    return miss


def check(ctx, state, win) -> dict:
    """The program's steps up to the snapshot (its parameters are the
    tree's leaves, under the same names) against the reference's, and its
    data stage where it is deterministic."""
    p0 = weights_flat(state)
    snap, pre = state.pop("snap"), state.pop("p_pre")
    prog = {"losses": state["losses"], "first_grad": state["first_grad"],
            "change": {k: float((v - p0[k]).norm()) for k, v in snap.items()},
            "window": {k: float((v - pre[k]).norm()) for k, v in snap.items()}}
    del snap, pre
    for k in ("model", "opt", "trainer"):
        state.pop(k, None)
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    out = compare(prog, reference_readings(state, ctx))
    out["data_mismatch"] = data_mismatch(state, ctx.mix["data_checked"])
    return out


def control(ctx, state) -> dict:
    """The reference in TF32, the step below the float32 it states, in the
    program's place."""
    return compare(reference_readings(state, ctx, tf32=True),
                   reference_readings(state, ctx))
