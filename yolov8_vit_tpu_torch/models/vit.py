"""Vision Transformer classifier (PyTorch port).

A timm-style ViT backbone (pre-norm blocks, LN eps 1e-6, cls token, learned
pos-embed, final LN on the cls token) wrapped by the MLP head ReLU ->
Linear(backbone_classes, 128) -> ReLU -> Linear(128, num_classes), as the
JAX package's `ViTClassifier`, for every spec it accepts.  A block is

  attention  attn_impl "fused": kernel D (quant "w8a") or kernel E;
             "xla": LN1, qkv, einsum attention, proj (torch ops);
             "pallas": the same with kernel F for the attention;
  MLP        quant "w8"/"w8a": kernel C; "none": LN2, Dense, exact GELU,
             Dense; "dynamic": the same with per-call int8 dense layers.

Module and buffer names follow the flax parameter tree, as in yolov8.py.
Buffers keep the dtype of the tree they were loaded from (a bf16-stored
engine stays bf16).  Weights in the activation dtype, the int8 kernels
transposed for the CUDA kernels and the int8 patch-embed fold are
non-persistent buffers made by
`ViTClassifier.prepare`, once per load (`weights.load_tree` calls it), not
per forward.

`ViTClassifier.train_form` turns an f32 float model into its training
form (train/vit_train.py): every tree leaf an nn.Parameter that the
forward reads itself, so autograd reaches each leaf the JAX trainer
trains; the serving forms keep their derived buffers.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from yolov8_vit_tpu_torch.ops.attention import (flash_attention,
                                                fused_attention_block,
                                                fused_attention_block_i8,
                                                sdpa_heads_plain)
from yolov8_vit_tpu_torch.ops.quant import (padded_t, quant_dense,
                                            quant_dense_fused,
                                            quant_mlp_ln_fused)
from yolov8_vit_tpu_torch.weights import leaves_to_parameters


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


class Dense(nn.Module):
    """flax nn.Dense params: kernel (in, out), bias (out,)."""

    live = False     # training form: the forward reads kernel and bias

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.register_buffer("kernel", torch.zeros(fin, fout))
        self.register_buffer("bias", torch.zeros(fout))

    def reset(self, gen: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.kernel.shape[0]) / .87962566103423978
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                              generator=gen)
        self.bias.zero_()

    def derive(self, dtype) -> None:
        """kernel_c, bias_c: kernel and bias in the activation dtype."""
        self.register_buffer("kernel_c", self.kernel.to(dtype),
                             persistent=False)
        self.register_buffer("bias_c", self.bias.to(dtype), persistent=False)

    def forward(self, x):
        """flax Dense(dtype=x.dtype): operands and bias in x's dtype."""
        if self.live:
            return x @ self.kernel + self.bias
        return x @ self.kernel_c + self.bias_c


class QuantDense(Dense):
    """nn.Dense's params with the int8 product, the weight quantized per
    call (quant="dynamic", ops.quant.quant_dense)."""

    def derive(self, dtype) -> None:
        """Nothing: the weight is quantized per call, as JAX does."""

    def forward(self, x):
        return quant_dense(x, self.kernel, self.bias)


class QDense(nn.Module):
    """Pre-quantized dense params {kernel_i8 (in, out), w_scale, bias}
    (ops.quant.prequantize_tree)."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.register_buffer("kernel_i8", torch.zeros(fin, fout,
                                                      dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(fout))
        self.register_buffer("bias", torch.zeros(fout))

    def derive(self, dtype) -> None:
        """kernel_t: the int8 kernel transposed to (out, in) and
        zero-padded to multiples of 16, the layout the CUDA kernels read
        (ops.quant.padded_t)."""
        self.register_buffer("kernel_t", padded_t(self.kernel_i8),
                             persistent=False)


class QuantDensePre(QDense):
    """int8 dense layer over pre-quantized params (kernel G,
    ops.quant.quant_dense_fused); output in `dtype`."""

    def __init__(self, fin: int, fout: int, dtype=torch.float32):
        super().__init__(fin, fout)
        self.dtype = dtype
        self.prepare()

    def prepare(self) -> None:
        """After a load (weights.load_tree calls it): the transposed
        kernel follows the loaded one."""
        self.derive(self.dtype)

    def forward(self, x):
        return quant_dense_fused(x, self.kernel_i8, self.w_scale, self.bias,
                                 w_t=self.kernel_t).to(self.dtype)


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
    """qkv and proj under the flax `attn` scope; forward is the unfused
    attention ("xla" and "pallas")."""

    def __init__(self, dim: int, dense):
        super().__init__()
        self.qkv = dense(dim, 3 * dim)
        self.proj = dense(dim, dim)

    def forward(self, h, heads: int, impl: str, t_real):
        b, t, d = h.shape
        qkv = self.qkv(h)
        if impl == "pallas":
            q, k, v = qkv.reshape(b, t, 3, heads, d // heads).unbind(2)
            o = flash_attention(q, k, v).to(h.dtype).reshape(b, t, d)
        else:
            o = sdpa_heads_plain(qkv, heads, t_real)
        return self.proj(o)


def _dense_classes(spec: ViTSpec):
    """(attention dense, MLP dense) module classes for `spec`.  The fused
    float attention (kernel E) takes the float params whatever the quant,
    as JAX's does."""
    if spec.quant == "w8a":
        return QDense, QDense
    dynamic = QuantDense if spec.quant == "dynamic" else Dense
    attn = Dense if spec.attn_impl == "fused" else dynamic
    return attn, QDense if spec.quant == "w8" else dynamic


class Block(nn.Module):
    """Pre-norm transformer block, params in the layout of `spec.quant`."""

    def __init__(self, spec: ViTSpec):
        super().__init__()
        self.spec = spec
        attn_dense, mlp_dense = _dense_classes(spec)
        hidden = int(spec.dim * spec.mlp_ratio)
        self.norm1 = LayerNorm(spec.dim, spec.ln_eps)
        self.attn = _Attn(spec.dim, attn_dense)
        self.norm2 = LayerNorm(spec.dim, spec.ln_eps)
        self.mlp_fc1 = mlp_dense(spec.dim, hidden)
        self.mlp_fc2 = mlp_dense(hidden, spec.dim)

    def forward(self, x, t_real=None):
        s = self.spec
        dt = x.dtype
        q, p = self.attn.qkv, self.attn.proj
        n1 = self.norm1
        if s.attn_impl == "fused" and s.quant == "w8a":
            x = fused_attention_block_i8(
                x, n1.scale, n1.bias, q.kernel_i8, q.w_scale, q.bias,
                p.kernel_i8, p.w_scale, p.bias, heads=s.heads,
                ln_eps=s.ln_eps, t_real=t_real, wqkv_t=q.kernel_t,
                wproj_t=p.kernel_t)
        elif s.attn_impl == "fused":
            x = fused_attention_block(
                x, n1.scale, n1.bias, q.kernel_c, q.bias, p.kernel_c,
                p.bias, heads=s.heads,
                ln_eps=s.ln_eps, t_real=t_real)
        else:
            x = x + self.attn(n1(x, dt), s.heads, s.attn_impl, t_real)
        f1, f2 = self.mlp_fc1, self.mlp_fc2
        if s.quant in ("w8", "w8a"):
            return quant_mlp_ln_fused(
                x, self.norm2.scale, self.norm2.bias, f1.kernel_i8,
                f1.w_scale, f1.bias, f2.kernel_i8, f2.w_scale, f2.bias,
                ln_eps=s.ln_eps, w1_t=f1.kernel_t, w2_t=f2.kernel_t)
        h = f2(F.gelu(f1(self.norm2(x, dt))))
        return x + h


class PatchEmbed(nn.Module):
    """Patch-embedding conv params, kept in the tree's HWIO layout
    (patch, patch, 3, dim): the port patchifies as a matmul over patch
    pixels in (row, column, channel) order, which is the conv."""

    live = False     # training form: NHWC images read kernel and bias

    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.register_buffer("kernel", torch.zeros(patch, patch, 3, dim))
        self.register_buffer("bias", torch.zeros(dim))

    def reset(self, gen: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.kernel[..., 0].numel()) / .87962566103423978
        nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std,
                              generator=gen)
        self.bias.zero_()

    def int8_fold(self):
        """(W / 127.5, bias + sum(W) / 255) in f32: the [-1, 1]
        normalization (v + 0.5) / 127.5 of int8 patches holding pixel - 128
        folded into the embedding.  sum(W) is taken in f32 and rounded once
        to the stored kernel's dtype, as XLA reduces a bf16 leaf."""
        k, f32 = self.kernel, torch.float32
        w = k.reshape(-1, k.shape[-1]).to(f32) / 127.5
        ksum = k.to(f32).sum(dim=(0, 1, 2)).to(k.dtype)
        return w, self.bias.to(f32) + ksum.to(f32) / 255.0

    def derive(self, dtype) -> None:
        """The patchify matmul's weights: fold_w / fold_b for int8 patches
        and w_patch for float ones (dtype-rounded, held as f32, bias f32);
        w_conv / b_conv in dtype for NHWC images (the flax conv)."""
        f32 = torch.float32
        fold_w, fold_b = self.int8_fold()
        kern = self.kernel.reshape(-1, self.kernel.shape[-1])
        for name, t in (("fold_w", fold_w.to(dtype).to(f32)),
                        ("fold_b", fold_b),
                        ("w_patch", kern.to(dtype).to(f32)),
                        ("b_patch", self.bias.to(f32)),
                        ("w_conv", kern.to(dtype)),
                        ("b_conv", self.bias.to(dtype))):
            self.register_buffer(name, t, persistent=False)


class ViT(nn.Module):
    """Backbone + timm-style classifier head."""

    live = False     # training form: the forward reads cls_token, pos_embed

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

    def derive(self, dtype) -> None:
        """cls token and position embedding in the activation dtype."""
        self.register_buffer("cls_c", self.cls_token.to(dtype),
                             persistent=False)
        self.register_buffer("pos_c", self.pos_embed.to(dtype),
                             persistent=False)

    def embed(self, img: torch.Tensor, dtype) -> torch.Tensor:
        """(B, n_patches, dim) token embeddings in `dtype`.

        img is either pre-blocked patches (B, n_patches, patch, 3 * patch)
        (ops.crop.crop_to_patches_i8 layout: int8 pixel - 128 with the
        normalization folded into the embedding, or float in [-1, 1]) with
        an f32-accumulated product plus bias rounded once, or NHWC images
        in [-1, 1], embedded as the flax conv(dtype) is: operands and bias
        in `dtype`."""
        s = self.spec
        pe = self.patch_embed
        f32 = torch.float32
        b = img.shape[0]
        if img.dim() == 4 and img.shape[-2:] == (s.patch, 3 * s.patch):
            if pe.live:
                raise ValueError("the training form takes NHWC images")
            if img.dtype == torch.int8:
                w, bias = pe.fold_w, pe.fold_b
            else:
                w, bias = pe.w_patch, pe.b_patch
            x = img.reshape(b, img.shape[1], -1).to(dtype).to(f32) @ w
            return (x + bias).to(dtype)
        if img.dim() != 4 or img.shape[-1] != 3:
            raise ValueError(f"expected NHWC images or (K, n_patches, "
                             f"{s.patch}, {3 * s.patch}) patches, got "
                             f"{tuple(img.shape)}")
        p = s.patch
        gh, gw = img.shape[1] // p, img.shape[2] // p
        patches = img[:, :gh * p, :gw * p].reshape(b, gh, p, gw, p, 3) \
            .permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
        if pe.live:
            return patches @ pe.kernel.reshape(-1, s.dim) + pe.bias
        return patches.to(dtype) @ pe.w_conv + pe.b_conv

    def forward(self, img: torch.Tensor, dtype) -> torch.Tensor:
        """img (see `embed`) -> (B, backbone_classes) logits in `dtype`."""
        s = self.spec
        x = self.embed(img, dtype)
        b = x.shape[0]
        cls, pos = (self.cls_token, self.pos_embed) if self.live \
            else (self.cls_c, self.pos_c)
        x = torch.cat([cls.expand(b, 1, s.dim), x], dim=1) + pos
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
        self.prepare()

    def prepare(self) -> None:
        """Make every submodule's derived buffers for `self.dtype`: at
        construction and after each load (weights.load_tree).  The
        training form has none."""
        for m in self.modules():
            if hasattr(m, "derive") and not getattr(m, "live", False):
                m.derive(self.dtype)

    def train_form(self) -> "ViTClassifier":
        """This model's training form, in place: each tree leaf (every
        kernel, bias, LayerNorm scale and bias, the patch embedding, the
        cls token and the position embedding) becomes an nn.Parameter, and
        the forward reads those tensors themselves, so autograd reaches
        every leaf that the JAX trainer updates.  The derived buffers are
        dropped: after an optimizer step nothing is stale, and
        `weights.module_tree` gives the trained leaves.  Only the model
        the trainer builds: f32, quant "none", attn_impl "xla"."""
        s = self.model.spec
        if self.dtype != torch.float32 or s.quant != "none" \
                or s.attn_impl != "xla":
            raise ValueError(f"the training form is f32 with quant 'none' "
                             f"and attn_impl 'xla'; got {self.dtype}, "
                             f"{s.quant!r}, {s.attn_impl!r}")
        return leaves_to_parameters(self)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.model(img, self.dtype))
        return self.fc2(torch.relu(self.fc1(h)))
