"""SwinV2 classifier (PyTorch port): SwinV2-B at 256 with window 16 as the
crop classifier, under the service's head ReLU -> Linear(1000, 128) ->
ReLU -> Linear(128, num_classes), as `ViTClassifier` wraps its ViT.

The backbone is timm's `SwinTransformerV2` (Liu et al. 2022, "Swin
Transformer V2"; microsoft/Swin-Transformer
configs/swinv2/swinv2_base_patch4_window16_256.yaml):

  patch embed   4x4 conv, stride 4 (3 -> C), LayerNorm
  stage i       patch merging before stages 2-4 (x[0::2, 0::2],
                x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2] concatenated,
                Linear(4C -> 2C, no bias), LayerNorm(2C)), then blocks
  block         x = x + LN1(WA(x)); x = x + LN2(fc2(GELU(fc1(x))))
                (res-post-norm, exact GELU, MLP ratio 4)
  WA            windows of ws x ws tokens, the grid rolled by (-s, -s) in
                every second block; qkv = x W + [q_bias, 0, v_bias]; cosine
                logits times exp(min(logit_scale, ln 100)) plus 16
                sigmoid(cpb(log-spaced relative coords)) at V1's index, plus
                the shift mask; softmax, P.V, proj
  end           LayerNorm, average pool, fc 1024 -> backbone_classes

A stage whose grid is no larger than the window takes the grid as its
window and no shift, as timm does (SwinV2-B/256: stage 3's 16 x 16 grid
is one window, stage 4's 8 x 8 grid one window of 64 tokens).  Every
LayerNorm has eps 1e-5.

Tree leaves are named after timm's state-dict keys under `model.` (a timm
checkpoint's leaves load without renaming; Linear weights (out, in), the
patch conv OIHW), and the service head after the ViT classifier's (`fc1`,
`fc2`, flax Dense kernel (in, out), bias).

Precision: activations in `dtype` between operations.  On CUDA in bf16
the window attention is `mt::window_attn` (ops/attention.py), one launch a
block from the qkv GEMM's output to proj's input; the GEMMs, LayerNorms,
GELU and merging are torch ops, and the classifier's forward runs as one
CUDA graph a crop shape (`SwinV2Classifier._replay`).  CPU tensors and
f32 run the plain attention (`window_attention_plain`).  Derived at each load
(`SwinV2Classifier.prepare`, which weights.load_tree calls): each block's
bias table 16 sigmoid(cpb(coords)) (heads, (2 ws - 1)^2) and clamped
logit scales in f32, weights in the activation dtype, and the patch
embedding folded for int8 crops (the shift masks are worked out per call:
from the token coordinates in the kernel, by timm's construction in the
plain version).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from yolov8_vit_tpu_torch.models.vit import Dense
from yolov8_vit_tpu_torch.ops.attention import (relative_coords,
                                                window_attention,
                                                window_attention_plain)
from yolov8_vit_tpu_torch.ops.library import add_launches, launch_counts


def _lecun_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """Fill `w` with flax's lecun-normal init (normal truncated to 2
    standard deviations, scaled to variance 1 / fan_in)."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std, -2 * std,
                                  2 * std, generator=gen))


@dataclasses.dataclass(frozen=True)
class SwinV2Spec:
    img_size: int = 256
    patch: int = 4
    embed_dim: int = 128
    depths: tuple = (2, 2, 18, 2)
    heads: tuple = (4, 8, 16, 32)
    window: int = 16
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-5
    backbone_classes: int = 1000

    def __post_init__(self):
        object.__setattr__(self, "depths", tuple(self.depths))
        object.__setattr__(self, "heads", tuple(self.heads))
        if len(self.depths) != len(self.heads):
            raise ValueError("one head count a stage")
        g = self.img_size // self.patch
        if g % (1 << (len(self.depths) - 1)):
            raise ValueError(f"a {g} x {g} patch grid does not halve "
                             f"{len(self.depths) - 1} times")

    def dim(self, stage: int) -> int:
        return self.embed_dim << stage

    def grid(self, stage: int) -> int:
        return (self.img_size // self.patch) >> stage

    def window_shift(self, stage: int, block: int) -> tuple[int, int]:
        """(window, shift) of a block: the grid itself and no shift where
        the grid is no larger than the window, else the window and, in
        every second block, half of it."""
        g = self.grid(stage)
        if g <= self.window:
            return g, 0
        return self.window, (self.window // 2 if block % 2 else 0)

    def windows_per_crop(self) -> int:
        """Attention windows of one crop's forward, over every block."""
        return sum(depth * (self.grid(i) // self.window_shift(i, 0)[0]) ** 2
                   for i, depth in enumerate(self.depths))


SWINV2_B_W16_256 = SwinV2Spec()
CPB_HIDDEN = 512        # the continuous position bias MLP's width (timm's)


class Linear(nn.Module):
    """A torch Linear's params, weight (out, in) and an optional bias."""

    def __init__(self, fin: int, fout: int, bias: bool = True):
        super().__init__()
        self.register_buffer("weight", torch.zeros(fout, fin))
        if bias:
            self.register_buffer("bias", torch.zeros(fout))
        else:
            self.bias = None

    def reset(self, gen: torch.Generator) -> None:
        _lecun_(self.weight, self.weight.shape[1], gen)
        if self.bias is not None:
            self.bias.zero_()

    def derive(self, dtype) -> None:
        """weight_c, bias_c: the params in the activation dtype."""
        self.register_buffer("weight_c", self.weight.to(dtype),
                             persistent=False)
        self.register_buffer("bias_c", None if self.bias is None
                             else self.bias.to(dtype), persistent=False)

    def forward(self, x):
        return F.linear(x, self.weight_c, self.bias_c)


class LayerNorm(nn.Module):
    """torch LayerNorm params {weight, bias}; statistics in f32 inside
    F.layer_norm, output in x's dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(dim))
        self.register_buffer("bias", torch.zeros(dim))

    def derive(self, dtype) -> None:
        self.register_buffer("weight_c", self.weight.to(dtype),
                             persistent=False)
        self.register_buffer("bias_c", self.bias.to(dtype), persistent=False)

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight_c, self.bias_c,
                            self.eps)


class WindowAttention(nn.Module):
    """qkv (no bias) with q_bias and v_bias, the continuous position bias
    MLP `cpb_mlp` (Linear(2, 512) + ReLU + Linear(512, heads, no bias)),
    per-head logit scales, proj."""

    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.register_buffer("logit_scale", torch.zeros(heads, 1, 1))
        self.register_buffer("q_bias", torch.zeros(dim))
        self.register_buffer("v_bias", torch.zeros(dim))
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.proj = Linear(dim, dim)
        self.cpb_mlp = nn.Sequential(Linear(2, CPB_HIDDEN), nn.ReLU(),
                                     Linear(CPB_HIDDEN, heads, bias=False))

    def reset(self, gen: torch.Generator) -> None:
        self.logit_scale.fill_(math.log(10.0))

    def derive(self, dtype) -> None:
        """qkv_bias_c: [q_bias, 0, v_bias] in the activation dtype; table:
        16 sigmoid(cpb(relative_coords)) (heads, (2 ws - 1)^2) and scale:
        exp(min(logit_scale, ln 100)) (heads,), both f32."""
        f32 = torch.float32
        dev = self.q_bias.device
        self.register_buffer(
            "qkv_bias_c", torch.cat([self.q_bias, torch.zeros_like(
                self.v_bias), self.v_bias]).to(dtype), persistent=False)
        w1, w2 = self.cpb_mlp[0], self.cpb_mlp[2]
        coords = relative_coords(self.window).to(dev)
        hid = torch.relu(coords @ w1.weight.to(f32).T + w1.bias.to(f32))
        table = 16 * torch.sigmoid(hid @ w2.weight.to(f32).T)
        self.register_buffer("table", table.T.contiguous(), persistent=False)
        scale = torch.clamp(self.logit_scale.to(f32),
                            max=math.log(1.0 / 0.01)).exp()
        self.register_buffer("scale", scale.reshape(-1), persistent=False)

    def forward(self, x):
        """x (B, H, W, C) -> proj(WA(x)) (B, H, W, C)."""
        qkv = F.linear(x, self.qkv.weight_c, self.qkv_bias_c)
        if qkv.is_cuda and qkv.dtype != torch.bfloat16:
            o = window_attention_plain(qkv, self.table, self.scale,
                                       self.window, self.shift, self.heads)
        else:       # the kernel on the card, the plain version on the CPU
            o = window_attention(qkv, self.table, self.scale,
                                 window=self.window, shift=self.shift,
                                 heads=self.heads)
        return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Res-post-norm block: x + LN1(WA(x)), then x + LN2(MLP(x))."""

    def __init__(self, spec: SwinV2Spec, stage: int, index: int):
        super().__init__()
        dim = spec.dim(stage)
        window, shift = spec.window_shift(stage, index)
        self.attn = WindowAttention(dim, spec.heads[stage], window, shift)
        self.norm1 = LayerNorm(dim, spec.ln_eps)
        self.mlp = Mlp(dim, int(dim * spec.mlp_ratio))
        self.norm2 = LayerNorm(dim, spec.ln_eps)

    def forward(self, x):
        x = x + self.norm1(self.attn(x))
        return x + self.norm2(self.mlp(x))


class PatchMerging(nn.Module):
    """2x2 neighbours concatenated (timm's order), Linear(4C -> 2C, no
    bias), LayerNorm(2C)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim, eps)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5) \
            .reshape(b, h // 2, w // 2, 4 * c)
        return self.norm(self.reduction(x))


class Stage(nn.Module):
    def __init__(self, spec: SwinV2Spec, stage: int):
        super().__init__()
        if stage:
            self.downsample = PatchMerging(spec.dim(stage - 1), spec.ln_eps)
        else:
            self.downsample = None
        self.blocks = nn.ModuleList(Block(spec, stage, j)
                                    for j in range(spec.depths[stage]))

    def forward(self, x):
        if self.downsample is not None:
            x = self.downsample(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class PatchEmbed(nn.Module):
    """The patch conv (`proj`, OIHW) and its LayerNorm (`norm`)."""

    def __init__(self, patch: int, dim: int, eps: float):
        super().__init__()
        self.proj = nn.Module()
        self.proj.register_buffer("weight", torch.zeros(dim, 3, patch, patch))
        self.proj.register_buffer("bias", torch.zeros(dim))
        self.norm = LayerNorm(dim, eps)

    def reset(self, gen: torch.Generator) -> None:
        w = self.proj.weight
        _lecun_(w, w[0].numel(), gen)
        self.proj.bias.zero_()

    def derive(self, dtype) -> None:
        """fold_w / fold_b: the patchify matmul's weights in f32 over patch
        pixels in (row, column, channel) order, for int8 crops holding
        pixel - 128 with the normalization pixel / 127.5 - 1 folded in."""
        f32 = torch.float32
        w = self.proj.weight.to(f32).permute(2, 3, 1, 0).reshape(
            -1, self.proj.weight.shape[0])
        self.register_buffer("fold_w", w / 127.5, persistent=False)
        self.register_buffer("fold_b", self.proj.bias.to(f32) + w.sum(0)
                             / 255.0, persistent=False)

    def forward(self, img, dtype, patch: int):
        """int8 crops (K, n_patches, patch, 3 patch) in ops.crop's layout
        -> (K, g, g, C) in `dtype`, normalised."""
        if img.dtype != torch.int8 or img.dim() != 4 \
                or img.shape[-2:] != (patch, 3 * patch):
            raise ValueError(f"expected int8 (K, n_patches, {patch}, "
                             f"{3 * patch}) crops, got {img.dtype} "
                             f"{tuple(img.shape)}")
        k, n = img.shape[:2]
        x = img.reshape(k, n, -1).to(torch.float32) @ self.fold_w + self.fold_b
        g = math.isqrt(n)
        n = self.norm
        return F.layer_norm(x, x.shape[-1:], n.weight.float(), n.bias.float(),
                            n.eps).to(dtype).reshape(k, g, g, -1)


class SwinV2(nn.Module):
    """Backbone + timm's classifier head (`head.fc`)."""

    def __init__(self, spec: SwinV2Spec):
        super().__init__()
        self.spec = spec
        self.patch_embed = PatchEmbed(spec.patch, spec.embed_dim, spec.ln_eps)
        self.layers = nn.ModuleList(Stage(spec, i)
                                    for i in range(len(spec.depths)))
        last = spec.dim(len(spec.depths) - 1)
        self.norm = LayerNorm(last, spec.ln_eps)
        self.head = nn.Module()
        self.head.fc = Linear(last, spec.backbone_classes)

    def forward(self, img, dtype):
        x = self.patch_embed(img, dtype, self.spec.patch)
        for stage in self.layers:
            x = stage(x)
        return self.head.fc(self.norm(x).mean(dim=(1, 2)))


class SwinV2Classifier(nn.Module):
    """Backbone logits -> ReLU -> 128 -> ReLU -> num_classes, in `dtype`
    (the activation dtype); `ViTClassifier`'s head and life cycle."""

    def __init__(self, spec: SwinV2Spec = SWINV2_B_W16_256,
                 num_classes: int = 5, hidden: int = 128,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.model = SwinV2(spec)
        self.fc1 = Dense(spec.backbone_classes, hidden)
        self.fc2 = Dense(hidden, num_classes)
        # attention windows of one crop (the runner's cls_windows counter)
        self.windows_per_crop = spec.windows_per_crop()
        self.prepare()

    def prepare(self) -> None:
        """Every submodule's derived buffers for `self.dtype`: at
        construction and after each load (weights.load_tree), which also
        drops the CUDA graphs captured over the old buffers."""
        for m in self.modules():
            if hasattr(m, "derive"):
                m.derive(self.dtype)
        self._graphs: dict = {}

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        if img.is_cuda and self.dtype == torch.bfloat16 \
                and not torch.cuda.is_current_stream_capturing():
            return self._replay(img)
        return self._forward(img)

    def _forward(self, img: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.model(img, self.dtype))
        return self.fc2(torch.relu(self.fc1(h)))

    def _replay(self, img: torch.Tensor) -> torch.Tensor:
        """The bf16 forward on the card (whose attention is the kernel; the
        plain version's index and mask uploads cannot be captured) as one
        CUDA graph a crop shape: the host enqueues one graph launch for the
        forward's ~270 kernels.  A shape's first call runs the forward as
        it is (which also loads the libraries and cuBLAS's workspace) and
        then captures it; each later call copies the crops into the graph's
        input, replays the graph and copies its logits out.  The kernels'
        launch counts (ops.launch_counts) grow by the captured launches at
        each replay, and not at the capture."""
        key = (tuple(img.shape), img.dtype, img.device)
        if key not in self._graphs:
            out = self._forward(img)
            before = launch_counts()
            static_in = img.clone()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static_out = self._forward(static_in)
            captured = {k: n - before[k] for k, n in launch_counts().items()}
            add_launches({k: -n for k, n in captured.items()})
            self._graphs[key] = (graph, static_in, static_out, captured)
            return out
        graph, static_in, static_out, captured = self._graphs[key]
        static_in.copy_(img)
        graph.replay()
        add_launches(captured)
        return static_out.clone()

