"""YOLOv8 detection stack, fused-BN inference layout (PyTorch port).

Same parameters and arithmetic as the JAX package's `YOLOv8(fused=True)`:
every ConvBlock is conv + bias + SiLU with the BatchNorm folded in.  The
public layout is NHWC (input frames and head maps), as in the JAX package;
inside, tensors are NCHW views of NHWC memory (torch's channels_last), so
the convolutions run on NHWC data without relayouts.

Module and buffer names follow the flax parameter tree
(`b0.conv.kernel` <-> params/b0/conv/kernel), which is what
`weights.load_tree` relies on.  Conv kernels are stored OIHW here and
HWIO in the tree.

With bf16 activations on the card, each ConvBlock is one launch of
kernel K (`ops.conv_block`, operator mt::conv_silu) on weights laid out
once in its bf16 layout, and C2f writes its branches into one buffer in
place of its concat.  f32 activations, the training form and CPU tensors
run the chain the kernel replaced (`_conv_silu`: an f32 conv of bf16
operands, + bias, SiLU, one cast), with the concat.

`YOLOv8.train_form()` is the model the detector's trainer updates (the
JAX trainer builds `YOLOv8(fused=True)` too and trains conv + bias): f32,
every tree leaf an nn.Parameter read by the forward itself.
`f32_training()` holds cuDNN's and cuBLAS's TF32 switches off around a
training step, backward included.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from yolov8_vit_tpu_torch.ops.conv_block import (chain_weight, conv_silu,
                                                 kernel_layout)
from yolov8_vit_tpu_torch.ops.library import TF32_LOCK as _TF32_LOCK
from yolov8_vit_tpu_torch.ops.library import cudnn_tf32 as _cudnn_tf32
from yolov8_vit_tpu_torch.weights import leaves_to_parameters


@dataclasses.dataclass(frozen=True)
class YOLOv8Spec:
    depth: float
    width: float
    max_channels: int
    num_classes: int = 5
    reg_max: int = 16
    strides: tuple[int, ...] = (8, 16, 32)


YOLOV8_VARIANTS: dict[str, YOLOv8Spec] = {
    "n": YOLOv8Spec(0.33, 0.25, 1024),
    "s": YOLOv8Spec(0.33, 0.50, 1024),
    "m": YOLOv8Spec(0.67, 0.75, 768),
    "l": YOLOv8Spec(1.00, 1.00, 512),
    "x": YOLOv8Spec(1.00, 1.25, 512),
}


def detect_spec(cfg, overrides=None) -> YOLOv8Spec:
    """YOLOv8Spec from a DetectConfig plus explicit field overrides (engine
    meta "det_spec"); reg_max and strides always come from the config."""
    spec = dataclasses.replace(YOLOV8_VARIANTS[cfg.variant],
                               num_classes=cfg.num_classes,
                               reg_max=cfg.reg_max, strides=cfg.strides)
    if overrides:
        spec = dataclasses.replace(spec, **dict(overrides))
    return spec


def _make_divisible(x: float, div: int = 8) -> int:
    return max(div, int(math.ceil(x / div)) * div)


def _ch(c: int, spec: YOLOv8Spec) -> int:
    return _make_divisible(min(c, spec.max_channels) * spec.width)


def _n(n: int, spec: YOLOv8Spec) -> int:
    return max(round(n * spec.depth), 1)


class Conv(nn.Module):
    """Params of a flax nn.Conv: kernel (OIHW here, HWIO in the tree) and
    bias."""
    hwio_leaves = ("kernel",)

    def __init__(self, cin: int, cout: int, k: int, bias_init: float = 0.0):
        super().__init__()
        self.bias_init = bias_init
        self.register_buffer("kernel", torch.zeros(cout, cin, k, k))
        self.register_buffer("bias", torch.zeros(cout))

    def reset(self, gen: torch.Generator) -> None:
        """flax defaults: lecun-normal (truncated) kernel, constant bias."""
        fan_in = self.kernel[0].numel()
        std = math.sqrt(1.0 / fan_in) / .87962566103423978
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                              generator=gen)
        self.bias.fill_(self.bias_init)


@contextlib.contextmanager
def f32_training():
    """Full f32 convolutions and matmuls for a whole training step, under
    _TF32_LOCK: the forward's conv_f32 calls hold the switch only while
    they launch, and autograd runs the backward's convolutions after they
    have returned, where PyTorch's default (cuDNN TF32 on) would apply.
    Both switches end as they started; a serving thread's conv_f32 waits
    for the step."""
    with _TF32_LOCK:
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev


def conv_f32(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
             bias: torch.Tensor | None = None,
             operands_in_bf16: bool = False) -> torch.Tensor:
    """f32 conv with 'same' padding and f32 accumulation.  When both
    operands hold bf16 values (`operands_in_bf16`), cuDNN may run it in
    TF32: a bf16 value is exact in TF32, so every product is exact and the
    sum is f32 as XLA's bf16 conv with f32 accumulation computes it.
    Otherwise TF32 is off (full f32 products), whatever the global flag.
    While a graph is traced (torch.export, AOTInductor) the conv is the
    operator mt::conv_f32, which carries the switch into the graph: a
    traced F.conv2d would run under whatever switch holds where the graph
    runs.  Eagerly it is F.conv2d itself, which autograd differentiates
    (the training forms); the operator has no backward."""
    if torch.compiler.is_compiling():
        return torch.ops.mt.conv_f32(x, kernel, bias, stride,
                                     operands_in_bf16)
    k = kernel.shape[-1]
    with _cudnn_tf32(operands_in_bf16):
        return F.conv2d(x, kernel, bias, stride=stride, padding=k // 2)


def _rounded_f32(kernel: torch.Tensor, dtype) -> torch.Tensor:
    """kernel rounded to the activation dtype, held as f32 for conv_f32."""
    return kernel.to(dtype).to(torch.float32)


def _derived_kernel(kernel: torch.Tensor, dtype) -> torch.Tensor:
    """A ConvBlock's derived kernel: for bf16 activations kernel K's bf16
    layout (`kernel_layout`), else the kernel rounded to `dtype` as f32."""
    if dtype == torch.bfloat16:
        return kernel_layout(kernel)
    return _rounded_f32(kernel, dtype)


def _conv_silu(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               stride: int) -> torch.Tensor:
    """The JAX ConvBlock: conv of x's-dtype operands (w: the kernel
    rounded to x's dtype, as f32) accumulated in f32, plus the bias in
    f32, SiLU, one rounding to x's dtype."""
    f32 = torch.float32
    y = conv_f32(x.to(f32), w, stride, operands_in_bf16=x.dtype != f32)
    return F.silu(y + bias.to(f32)[:, None, None]).to(x.dtype)


def _kernel_runs(x: torch.Tensor) -> bool:
    """Whether kernel K runs a bf16 ConvBlock on x: bf16 on the card."""
    return x.is_cuda and x.dtype == torch.bfloat16


def _block(x, w, bias, stride, out=None, residual=None):
    """One ConvBlock on x (an NCHW view of NHWC memory).  w is
    `_derived_kernel`'s (or the training form's f32 kernel): kernel K's
    bf16 layout launches mt::conv_silu where the kernel runs, which adds
    `residual` as a bf16 add and writes into `out` where given (NCHW views
    too; C2f passes them only where the kernel runs); anything else runs
    the chain."""
    if w.dtype == torch.bfloat16:
        if _kernel_runs(x):
            nhwc = (lambda t: None if t is None else t.permute(0, 2, 3, 1))
            y = conv_silu(nhwc(x), w, bias, stride, nhwc(residual), nhwc(out))
            return y.permute(0, 3, 1, 2)
        w = chain_weight(w)
    return _conv_silu(x, w, bias, stride)


class ConvBlock(nn.Module):
    live = False     # training form: the forward reads conv.kernel

    def __init__(self, cin: int, out: int, k: int = 1, s: int = 1):
        super().__init__()
        self.s = s
        self.conv = Conv(cin, out, k)

    def derive(self, dtype) -> None:
        self.register_buffer("w", _derived_kernel(self.conv.kernel, dtype),
                             persistent=False)

    def kernel_runs(self, x) -> bool:
        return not self.live and self.w.dtype == torch.bfloat16 \
            and _kernel_runs(x)

    def forward(self, x, out=None, residual=None):
        w = self.conv.kernel if self.live else self.w
        return _block(x, w, self.conv.bias, self.s, out, residual)


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool = True):
        super().__init__()
        self.shortcut = shortcut
        self.cv1 = ConvBlock(c, c, 3)
        self.cv2 = ConvBlock(c, c, 3)

    def forward(self, x, out=None):
        """out: where kernel K writes the result (C2f's buffer), the
        shortcut added in cv2's epilogue."""
        if out is not None:
            return self.cv2(self.cv1(x), out,
                            x if self.shortcut else None)
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Cross-stage partial fusion block (split + n bottlenecks + concat)."""

    def __init__(self, cin: int, out: int, n: int = 1,
                 shortcut: bool = False, e: float = 0.5):
        super().__init__()
        self.c = c = int(out * e)
        self.n = n
        self.cv1 = ConvBlock(cin, 2 * c, 1)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(c, shortcut))
        self.cv2 = ConvBlock((2 + n) * c, out, 1)

    def forward(self, x):
        c = self.c
        if self.cv1.kernel_runs(x):
            # cv1 and each bottleneck write their channels of one buffer,
            # which cv2 reads whole: the concat without a copy
            b, _, h, w = x.shape
            buf = x.new_empty((b, h, w, (2 + self.n) * c)).permute(0, 3, 1, 2)
            self.cv1(x, buf[:, :2 * c])
            for i in range(self.n):
                getattr(self, f"m{i}")(buf[:, (1 + i) * c:(2 + i) * c],
                                       buf[:, (2 + i) * c:(3 + i) * c])
            return self.cv2(buf)
        y = self.cv1(x)
        parts = [y[:, :c], y[:, c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 stride-1 maxpools."""

    def __init__(self, cin: int, out: int):
        super().__init__()
        c = cin // 2
        self.cv1 = ConvBlock(cin, c, 1)
        self.cv2 = ConvBlock(4 * c, out, 1)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, stride=1, padding=2))
        return self.cv2(torch.cat(pools, dim=1))


class DetectHead(nn.Module):
    """Decoupled anchor-free head: box-DFL branch + cls branch per level.
    The two branch-entry convs share their input and run as ONE conv on
    concatenated weights; the final 1x1 convs run in the promotion of
    input and param dtypes, as flax's nn.Conv does (f32 for f32 params).
    The training form concatenates the two entry kernels on each call, so
    each gets its own gradient."""
    live = False

    def __init__(self, spec: YOLOv8Spec, in_channels: Sequence[int]):
        super().__init__()
        self.spec = spec
        self.levels = len(in_channels)
        self.c2 = c2 = max(16, in_channels[0] // 4, spec.reg_max * 4)
        c3 = max(in_channels[0], min(spec.num_classes, 100))
        for i, cin in enumerate(in_channels):
            prior = math.log(5.0 / spec.num_classes
                             / (640.0 / spec.strides[i]) ** 2)
            setattr(self, f"box{i}_0", ConvBlock(cin, c2, 3))
            setattr(self, f"cls{i}_0", ConvBlock(cin, c3, 3))
            setattr(self, f"box{i}_1", ConvBlock(c2, c2, 3))
            setattr(self, f"box{i}_2", Conv(c2, 4 * spec.reg_max, 1, 1.0))
            setattr(self, f"cls{i}_1", ConvBlock(c3, c3, 3))
            setattr(self, f"cls{i}_2", Conv(c3, spec.num_classes, 1, prior))

    def derive(self, dtype) -> None:
        """entry{i}_w / entry{i}_b: level i's two branch-entry convs as one
        (`_derived_kernel`'s layout of the concatenated kernels)."""
        for i in range(self.levels):
            b0 = getattr(self, f"box{i}_0").conv
            c0 = getattr(self, f"cls{i}_0").conv
            self.register_buffer(
                f"entry{i}_w",
                _derived_kernel(torch.cat([b0.kernel, c0.kernel]), dtype),
                persistent=False)
            self.register_buffer(f"entry{i}_b", torch.cat([b0.bias, c0.bias]),
                                 persistent=False)

    @staticmethod
    def _out_conv(x: torch.Tensor, conv: Conv) -> torch.Tensor:
        """flax nn.Conv(dtype=None): computes in the promotion of the
        input's and the params' dtypes; a bf16 result rounds before the
        bf16 bias add, as flax's does."""
        dt = torch.promote_types(x.dtype, conv.kernel.dtype)
        f32 = torch.float32
        if dt == f32:
            return conv_f32(x.to(f32), conv.kernel.to(f32), 1,
                            conv.bias.to(f32))
        y = conv_f32(x.to(dt).to(f32), conv.kernel.to(dt).to(f32), 1,
                     operands_in_bf16=True)
        return y.to(dt) + conv.bias.to(dt)[:, None, None]

    def _entry(self, i: int):
        if not self.live:
            return getattr(self, f"entry{i}_w"), getattr(self, f"entry{i}_b")
        b0 = getattr(self, f"box{i}_0").conv
        c0 = getattr(self, f"cls{i}_0").conv
        return (torch.cat([b0.kernel, c0.kernel]),
                torch.cat([b0.bias, c0.bias]))

    def forward(self, feats):
        outs = []
        for i, f in enumerate(feats):
            y = _block(f, *self._entry(i), 1)
            b = getattr(self, f"box{i}_1")(y[:, :self.c2])
            c = getattr(self, f"cls{i}_1")(y[:, self.c2:])
            b = self._out_conv(b, getattr(self, f"box{i}_2"))
            c = self._out_conv(c, getattr(self, f"cls{i}_2"))
            outs.append((b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)))
        return outs


class YOLOv8(nn.Module):
    """Backbone + PAN neck + detect head.  forward(img NHWC in `dtype`, the
    activation dtype) returns per-level (box_dist (B, H, W, 4*reg_max),
    cls_logits (B, H, W, nc)) NHWC f32 maps."""

    def __init__(self, spec: YOLOv8Spec, dtype=torch.float32):
        super().__init__()
        self.spec = s = spec
        self.dtype = dtype

        def ch(c):
            return _ch(c, s)

        def n(k):
            return _n(k, s)

        self.b0 = ConvBlock(3, ch(64), 3, 2)
        self.b1 = ConvBlock(ch(64), ch(128), 3, 2)
        self.b2 = C2f(ch(128), ch(128), n(3), True)
        self.b3 = ConvBlock(ch(128), ch(256), 3, 2)
        self.b4 = C2f(ch(256), ch(256), n(6), True)
        self.b5 = ConvBlock(ch(256), ch(512), 3, 2)
        self.b6 = C2f(ch(512), ch(512), n(6), True)
        self.b7 = ConvBlock(ch(512), ch(1024), 3, 2)
        self.b8 = C2f(ch(1024), ch(1024), n(3), True)
        self.b9 = SPPF(ch(1024), ch(1024))
        self.n12 = C2f(ch(1024) + ch(512), ch(512), n(3), False)
        self.n15 = C2f(ch(512) + ch(256), ch(256), n(3), False)
        self.n16 = ConvBlock(ch(256), ch(256), 3, 2)
        self.n18 = C2f(ch(256) + ch(512), ch(512), n(3), False)
        self.n19 = ConvBlock(ch(512), ch(512), 3, 2)
        self.n21 = C2f(ch(512) + ch(1024), ch(1024), n(3), False)
        self.detect = DetectHead(s, [ch(256), ch(512), ch(1024)])
        self.prepare()

    def prepare(self) -> None:
        """Make the conv kernels rounded to `self.dtype` and the head's
        fused entry convs: at construction and after each load
        (weights.load_tree).  The training form has none."""
        for m in self.modules():
            if hasattr(m, "derive") and not getattr(m, "live", False):
                m.derive(self.dtype)

    def train_form(self) -> "YOLOv8":
        """This model's training form, in place: each tree leaf (every
        conv kernel and bias) becomes an nn.Parameter that the forward
        reads itself, and the derived buffers (ConvBlock.w, the head's
        entry{i}_w / _b) are dropped, so nothing goes stale after an
        optimizer step and `weights.module_tree` gives the trained leaves.
        f32 only, as the JAX trainer trains."""
        if self.dtype != torch.float32:
            raise ValueError(f"the training form is f32; got {self.dtype}")
        return leaves_to_parameters(self)

    def forward(self, img: torch.Tensor):
        if img.dtype != self.dtype:
            raise ValueError(f"YOLOv8 built for {self.dtype} activations, "
                             f"got {img.dtype}")
        x = img.permute(0, 3, 1, 2)          # NCHW view of NHWC memory
        x = self.b2(self.b1(self.b0(x)))
        p3 = self.b4(self.b3(x))
        p4 = self.b6(self.b5(p3))
        p5 = self.b9(self.b8(self.b7(p4)))

        def up(t):
            return F.interpolate(t, scale_factor=2, mode="nearest")

        n4 = self.n12(torch.cat([up(p5), p4], dim=1))
        n3 = self.n15(torch.cat([up(n4), p3], dim=1))
        o4 = self.n18(torch.cat([self.n16(n3), n4], dim=1))
        o5 = self.n21(torch.cat([self.n19(o4), p5], dim=1))
        return self.detect([n3, o4, o5])


def flatten_head_outputs(outs):
    """Per-level NHWC head maps -> (B, A, 4*reg_max), (B, A, nc); anchor
    order level-major, row-major, x fastest (as `make_anchors`)."""
    box = [b.reshape(b.shape[0], -1, b.shape[-1]) for b, _ in outs]
    cls = [c.reshape(c.shape[0], -1, c.shape[-1]) for _, c in outs]
    return torch.cat(box, dim=1), torch.cat(cls, dim=1)
