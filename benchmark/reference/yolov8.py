"""Plain YOLOv8 detector (ultralytics `ultralytics/cfg/models/v8/yolov8.yaml`),
fused-BN inference form: every Conv block is conv + bias + SiLU, 'same'
padding k // 2, as ultralytics' autopad.  Weights are a flat dict keyed by
the flax-layout tree's paths joined with '.', conv kernels HWIO.

Plain torch in float32 (TF32 off, set by the caller), no kernel, no
cache.  `lowp` is the control's precision, a step below the bfloat16
the configuration states: every conv's operands cut to fp8 e4m3 with a
per-tensor scale (`fake_fp8`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def make_divisible(x: float, div: int = 8) -> int:
    return max(div, int(math.ceil(x / div)) * div)


class Widths:
    """Channel and repeat counts of one YOLOv8 scale (depth, width,
    max_channels), as ultralytics' parse_model computes them."""

    def __init__(self, depth: float, width: float, max_channels: int):
        self.depth, self.width, self.max_channels = depth, width, max_channels

    def ch(self, c: int) -> int:
        return make_divisible(min(c, self.max_channels) * self.width)

    def n(self, k: int) -> int:
        return max(round(k * self.depth), 1)


def _conv(shapes: dict, name: str, cin: int, cout: int, k: int,
          bias_init=0.0, block=True):
    pre = f"{name}.conv" if block else name
    shapes[f"{pre}.kernel"] = ((k, k, cin, cout), "lecun")
    shapes[f"{pre}.bias"] = ((cout,), ("const", bias_init))


def _c2f(shapes, name, cin, out, n):
    c = int(out * 0.5)
    _conv(shapes, f"{name}.cv1", cin, 2 * c, 1)
    for i in range(n):
        _conv(shapes, f"{name}.m{i}.cv1", c, c, 3)
        _conv(shapes, f"{name}.m{i}.cv2", c, c, 3)
    _conv(shapes, f"{name}.cv2", (2 + n) * c, out, 1)


def head_channels(w: Widths, num_classes: int, reg_max: int):
    """(c2, c3) of the decoupled head, from the P3 input width."""
    c_in = w.ch(256)
    return max(16, c_in // 4, reg_max * 4), max(c_in, min(num_classes, 100))


def param_shapes(cfg: dict) -> dict:
    """{path: (shape, init)} of the detector's tree, in forward order."""
    w = Widths(*cfg["scale"])
    nc, reg = cfg["num_classes"], cfg["reg_max"]
    ch, n = w.ch, w.n
    s: dict = {}
    _conv(s, "b0", 3, ch(64), 3)
    _conv(s, "b1", ch(64), ch(128), 3)
    _c2f(s, "b2", ch(128), ch(128), n(3))
    _conv(s, "b3", ch(128), ch(256), 3)
    _c2f(s, "b4", ch(256), ch(256), n(6))
    _conv(s, "b5", ch(256), ch(512), 3)
    _c2f(s, "b6", ch(512), ch(512), n(6))
    _conv(s, "b7", ch(512), ch(1024), 3)
    _c2f(s, "b8", ch(1024), ch(1024), n(3))
    _conv(s, "b9.cv1", ch(1024), ch(1024) // 2, 1)
    _conv(s, "b9.cv2", ch(1024) // 2 * 4, ch(1024), 1)
    _c2f(s, "n12", ch(1024) + ch(512), ch(512), n(3))
    _c2f(s, "n15", ch(512) + ch(256), ch(256), n(3))
    _conv(s, "n16", ch(256), ch(256), 3)
    _c2f(s, "n18", ch(256) + ch(512), ch(512), n(3))
    _conv(s, "n19", ch(512), ch(512), 3)
    _c2f(s, "n21", ch(512) + ch(1024), ch(1024), n(3))
    c2, c3 = head_channels(w, nc, reg)
    for i, cin in enumerate((ch(256), ch(512), ch(1024))):
        stride = cfg["strides"][i]
        prior = math.log(5.0 / nc / (640.0 / stride) ** 2)
        _conv(s, f"detect.box{i}_0", cin, c2, 3)
        _conv(s, f"detect.cls{i}_0", cin, c3, 3)
        _conv(s, f"detect.box{i}_1", c2, c2, 3)
        _conv(s, f"detect.box{i}_2", c2, 4 * reg, 1, 1.0, block=False)
        _conv(s, f"detect.cls{i}_1", c3, c3, 3)
        _conv(s, f"detect.cls{i}_2", c3, nc, 1, prior, block=False)
    return s


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x cut to fp8 e4m3 with one scale for the tensor (its amax to 448)."""
    s = x.abs().amax().clamp_min(1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Detector:
    """forward(frames01 NHWC f32 in [0, 1]) -> per level (box_dist, cls
    logits) NHWC; `taps` collects named intermediate maps."""

    def __init__(self, params: dict, cfg: dict, lowp: bool = False):
        self.p = {k: v.to(torch.float32) for k, v in params.items()}
        self.w = Widths(*cfg["scale"])
        self.cfg = cfg
        self.lowp = lowp
        self.taps: dict = {}

    def conv(self, x, name, stride=1, act=True, block=True):
        pre = f"{name}.conv" if block else name
        k = self.p[f"{pre}.kernel"].permute(3, 2, 0, 1)
        if self.lowp:
            x, k = fake_fp8(x), fake_fp8(k)
        y = F.conv2d(x, k, self.p[f"{pre}.bias"], stride=stride,
                     padding=k.shape[-1] // 2)
        return F.silu(y) if act else y

    def c2f(self, x, name, n, shortcut):
        y = self.conv(x, f"{name}.cv1")
        c = y.shape[1] // 2
        parts = [y[:, :c], y[:, c:]]
        for i in range(n):
            h = self.conv(self.conv(parts[-1], f"{name}.m{i}.cv1"),
                          f"{name}.m{i}.cv2")
            parts.append(parts[-1] + h if shortcut else h)
        return self.conv(torch.cat(parts, 1), f"{name}.cv2")

    def sppf(self, x, name):
        pools = [self.conv(x, f"{name}.cv1")]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.conv(torch.cat(pools, 1), f"{name}.cv2")

    def __call__(self, frames01: torch.Tensor):
        n = self.w.n
        x = frames01.permute(0, 3, 1, 2)
        x = self.conv(x, "b0", 2)
        x = self.conv(x, "b1", 2)
        x = self.c2f(x, "b2", n(3), True)
        p3 = self.c2f(self.conv(x, "b3", 2), "b4", n(6), True)
        p4 = self.c2f(self.conv(p3, "b5", 2), "b6", n(6), True)
        p5 = self.sppf(self.c2f(self.conv(p4, "b7", 2), "b8", n(3), True),
                       "b9")

        def up(t):
            return F.interpolate(t, scale_factor=2, mode="nearest")

        n4 = self.c2f(torch.cat([up(p5), p4], 1), "n12", n(3), False)
        n3 = self.c2f(torch.cat([up(n4), p3], 1), "n15", n(3), False)
        o4 = self.c2f(torch.cat([self.conv(n3, "n16", 2), n4], 1), "n18",
                      n(3), False)
        o5 = self.c2f(torch.cat([self.conv(o4, "n19", 2), p5], 1), "n21",
                      n(3), False)
        outs = []
        for i, f in enumerate((n3, o4, o5)):
            d = f"detect.box{i}"
            c = f"detect.cls{i}"
            b = self.conv(self.conv(f, f"{d}_0"), f"{d}_1")
            h = self.conv(self.conv(f, f"{c}_0"), f"{c}_1")
            if i == 0:
                self.taps["cls0_1"] = h
            b = self.conv(b, f"{d}_2", act=False, block=False)
            h = self.conv(h, f"{c}_2", act=False, block=False)
            outs.append((b.permute(0, 2, 3, 1), h.permute(0, 2, 3, 1)))
        return outs
