"""Vision Transformer classifier, W8A8 fused inference path (PyTorch port).

A timm-style ViT backbone (pre-norm blocks, LN eps 1e-6, cls token, learned
pos-embed, final LN on the cls token) wrapped by the MLP head ReLU ->
Linear(backbone_classes, 128) -> ReLU -> Linear(128, num_classes), as the
JAX package's `ViTClassifier`.  The port runs the `quant="w8a"`,
`attn_impl="fused"` path: every block is kernel D (attention sub-block)
then kernel C (MLP sub-block).  Other quant modes need the bf16/f32 fused
attention kernel (`_attn_block_kernel`), which a later slice ports.

Module and buffer names follow the flax parameter tree, as in yolov8.py.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from yolov8_vit_tpu_torch.ops.attention import fused_attention_block_i8
from yolov8_vit_tpu_torch.ops.quant import quant_mlp_ln_fused


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    img_size: int = 224
    patch: int = 8
    dim: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    backbone_classes: int = 1000
    ln_eps: float = 1e-6
    attn_impl: str = "xla"
    quant: str = "none"
    pad_tokens: int = 0

    def __post_init__(self):
        if self.attn_impl not in ("xla", "pallas", "fused"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.quant not in ("none", "dynamic", "w8", "w8a"):
            raise ValueError(f"unknown quant {self.quant!r}")
        if self.quant == "w8a" and self.attn_impl != "fused":
            raise ValueError("quant='w8a' requires attn_impl='fused'")
        if self.pad_tokens:
            if self.pad_tokens < self.tokens:
                raise ValueError(
                    f"pad_tokens {self.pad_tokens} < sequence {self.tokens}")
            if self.attn_impl == "pallas":
                raise ValueError("pad_tokens requires attn_impl 'fused' or "
                                 "'xla'")

    @property
    def tokens(self) -> int:
        return (self.img_size // self.patch) ** 2 + 1

    @property
    def seq_len(self) -> int:
        return self.pad_tokens if self.pad_tokens else self.tokens


VIT_B8_224 = ViTSpec()
VIT_B16_224 = ViTSpec(patch=16)


def require_ported(spec: ViTSpec) -> None:
    """Raise for a spec whose forward needs a kernel not yet ported."""
    if spec.quant != "w8a" or spec.attn_impl != "fused":
        raise NotImplementedError(
            f"ViT quant={spec.quant!r} attn_impl={spec.attn_impl!r} needs "
            f"the fused bf16/f32 attention kernel `_attn_block_kernel` "
            f"(yolov8_vit_tpu/ops/attention.py), not yet ported: see "
            f"ROADMAP.md, kernels still to port.  The port serves "
            f"quant='w8a' engines.")


class Dense(nn.Module):
    """flax nn.Dense params: kernel (in, out), bias (out,)."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.register_buffer("kernel", torch.zeros(fin, fout))
        self.register_buffer("bias", torch.zeros(fout))

    def reset(self, gen: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.kernel.shape[0]) / .87962566103423978
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                              generator=gen)
        self.bias.zero_()

    def forward(self, x):
        """flax Dense(dtype=x.dtype): operands and bias in x's dtype."""
        dt = x.dtype
        return x @ self.kernel.to(dt) + self.bias.to(dt)


class QDense(nn.Module):
    """Pre-quantized dense params {kernel_i8 (in, out), w_scale, bias}
    (ops.quant.prequantize_tree)."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.register_buffer("kernel_i8", torch.zeros(fin, fout,
                                                      dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(fout))
        self.register_buffer("bias", torch.zeros(fout))


class LayerNorm(nn.Module):
    """flax nn.LayerNorm params {scale, bias}; statistics in f32 with
    flax's fast variance E[x^2] - E[x]^2, output in `dtype`."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(dim))
        self.register_buffer("bias", torch.zeros(dim))

    def reset(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x, dtype):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(dtype)


class _Attn(nn.Module):
    def __init__(self, dim: int, dense):
        super().__init__()
        self.qkv = dense(dim, 3 * dim)
        self.proj = dense(dim, dim)


class Block(nn.Module):
    """Pre-norm transformer block.  Its params hold the w8a layout
    (QDense) when spec.quant == "w8a", else the float layout (Dense), which
    is what port-native init fills before prequantizing."""

    def __init__(self, spec: ViTSpec):
        super().__init__()
        self.spec = spec
        dense = QDense if spec.quant == "w8a" else Dense
        hidden = int(spec.dim * spec.mlp_ratio)
        self.norm1 = LayerNorm(spec.dim, spec.ln_eps)
        self.attn = _Attn(spec.dim, dense)
        self.norm2 = LayerNorm(spec.dim, spec.ln_eps)
        self.mlp_fc1 = dense(spec.dim, hidden)
        self.mlp_fc2 = dense(hidden, spec.dim)

    def forward(self, x, t_real=None):
        require_ported(self.spec)
        s = self.spec
        q, p = self.attn.qkv, self.attn.proj
        x = fused_attention_block_i8(
            x, self.norm1.scale, self.norm1.bias, q.kernel_i8, q.w_scale,
            q.bias, p.kernel_i8, p.w_scale, p.bias, heads=s.heads,
            ln_eps=s.ln_eps, t_real=t_real)
        f1, f2 = self.mlp_fc1, self.mlp_fc2
        return quant_mlp_ln_fused(
            x, self.norm2.scale, self.norm2.bias, f1.kernel_i8, f1.w_scale,
            f1.bias, f2.kernel_i8, f2.w_scale, f2.bias, ln_eps=s.ln_eps)


class PatchEmbed(nn.Module):
    """Patch-embedding conv params, kept in the tree's HWIO layout
    (patch, patch, 3, dim): the port patchifies as a matmul over patch
    pixels, never as a conv."""

    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.register_buffer("kernel", torch.zeros(patch, patch, 3, dim))
        self.register_buffer("bias", torch.zeros(dim))

    def reset(self, gen: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.kernel[..., 0].numel()) / .87962566103423978
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                              generator=gen)
        self.bias.zero_()


class ViT(nn.Module):
    """Backbone + timm-style classifier head."""

    def __init__(self, spec: ViTSpec):
        super().__init__()
        self.spec = spec
        self.patch_embed = PatchEmbed(spec.patch, spec.dim)
        self.register_buffer("cls_token", torch.zeros(1, 1, spec.dim))
        self.register_buffer("pos_embed", torch.zeros(1, spec.tokens, spec.dim))
        for i in range(spec.depth):
            setattr(self, f"block{i}", Block(spec))
        self.norm = LayerNorm(spec.dim, spec.ln_eps)
        self.head = Dense(spec.dim, spec.backbone_classes)

    def reset(self, gen: torch.Generator) -> None:
        self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def forward(self, patches: torch.Tensor, dtype) -> torch.Tensor:
        """patches (K, n_patches, patch, patch*3) int8 holding pixel - 128
        (ops.crop.crop_to_patches_i8 layout) -> (K, backbone_classes).  The
        [-1, 1] normalization (v + 0.5) / 127.5 folds into the embedding:
        x @ (W / 127.5) + (sum(W) / 255 + bias)."""
        s = self.spec
        if patches.dtype != torch.int8 or patches.dim() != 4 \
                or patches.shape[-2:] != (s.patch, 3 * s.patch):
            raise ValueError(f"expected int8 (K, n_patches, {s.patch}, "
                             f"{3 * s.patch}) patches, got {patches.dtype} "
                             f"{tuple(patches.shape)}")
        k = self.patch_embed.kernel
        w = k.reshape(s.patch * s.patch * 3, s.dim) / 127.5
        bias = self.patch_embed.bias + k.sum(dim=(0, 1, 2)) / 255.0
        b, n = patches.shape[:2]
        x = patches.reshape(b, n, -1).to(dtype) @ w.to(dtype)
        x = (x.to(torch.float32) + bias).to(dtype)
        cls = self.cls_token.to(dtype).expand(b, 1, s.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        t_real = None
        if s.pad_tokens and s.pad_tokens > s.tokens:
            x = F.pad(x, (0, 0, 0, s.pad_tokens - s.tokens))
            t_real = s.tokens
        for i in range(s.depth):
            x = getattr(self, f"block{i}")(x, t_real)
        return self.head(self.norm(x[:, 0], dtype))


class ViTClassifier(nn.Module):
    """Backbone logits -> ReLU -> 128 -> ReLU -> num_classes, all in
    `dtype` (the activation dtype)."""

    def __init__(self, spec: ViTSpec, num_classes: int = 5,
                 hidden: int = 128, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.model = ViT(spec)
        self.fc1 = Dense(spec.backbone_classes, hidden)
        self.fc2 = Dense(hidden, num_classes)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.model(patches, self.dtype))
        return self.fc2(torch.relu(self.fc1(h)))
