"""The float ViT's MLP sub-block as one operator: mt::mlp_block.

    out = x + fc2(gelu(fc1(LN2(x))))

at the rounding points of the port's plain expression (models/vit.py
`Block` with quant "none"): LayerNorm's f32 statistics with flax's fast
variance, rounded once to x's dtype; each flax Dense(dtype) a product
rounded to the dtype and a bias add in the dtype; the exact (erf) GELU in
f32, rounded; the residual's add in the dtype.  It replaces no TPU
kernel: the JAX package's float MLP is plain flax that XLA fuses on the
TPU, where the port ran it as about 17 device operations a block.

On the card this is csrc/mlp_block.cu (its source note gives the bound
and the design): bf16 activations in three launches, a row LayerNorm and
two wgmma GEMMs whose epilogues add the bias and apply GELU (fc1), or add
the bias and the residual (fc2).  CPU tensors run the plain expression.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from yolov8_vit_tpu_torch import _build

# the C entry points' arguments before the stream
_P, _I = ctypes.c_void_p, ctypes.c_int
_MLP_BLOCK_ARGS = (_P, _I, _I, _I, _P, _P, ctypes.c_float) + (_P,) * 7

def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float, dtype) -> torch.Tensor:
    """flax nn.LayerNorm over the last axis: statistics in f32 with the
    fast variance E[x^2] - E[x]^2 (clamped at 0), output in `dtype`."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale)
    return (y + bias).to(dtype)


def mlp_block_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                    ln_eps: float) -> torch.Tensor:
    """Plain version of mt::mlp_block: the Block's float MLP expression,
    weights and biases in x's dtype (the derived kernel_c / bias_c)."""
    h = F.gelu(layer_norm(x, ln_scale, ln_bias, ln_eps, x.dtype) @ w1 + b1)
    return x + (h @ w2 + b2)


def mlp_block(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2, *,
              ln_eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) -> x + fc2(gelu(fc1(LN2(x)))) (operator mt::mlp_block):
    LN params used in f32; w1 (D, H) and w2 (H, D) in the JAX (in, out)
    layout, they and the biases b1 (H,), b2 (D,) in x's dtype (a caller
    that runs many forwards passes them cast once: models/vit.py keeps
    the cast per load).  CUDA tensors launch the kernels (bf16, D and H
    multiples of 8, D at most 2048); CPU tensors run the plain version."""
    dt, f32 = x.dtype, torch.float32
    return torch.ops.mt.mlp_block(
        x.contiguous(), ln_scale.to(f32).contiguous(),
        ln_bias.to(f32).contiguous(), w1.to(dt).contiguous(),
        b1.to(dt).contiguous(), w2.to(dt).contiguous(),
        b2.to(dt).contiguous(), ln_eps)


def mlp_block_kernel(x, ln_scale, ln_bias, w1, b1, w2, b2,
                     ln_eps) -> torch.Tensor:
    """csrc/mlp_block.cu on CUDA tensors (operator mt::mlp_block)."""
    _build.require_cuda(x, ln_scale, ln_bias, w1, b1, w2, b2)
    d = x.shape[-1]
    hidden = w1.shape[1]
    bf16 = torch.bfloat16
    if (x.dtype != bf16 or any(t.dtype != bf16 for t in (w1, b1, w2, b2))
            or ln_scale.dtype != torch.float32
            or ln_bias.dtype != torch.float32 or d % 8 or d > 2048
            or hidden % 8
            or tuple(w1.shape) != (d, hidden) or tuple(w2.shape) != (hidden, d)
            or tuple(b1.shape) != (hidden,) or tuple(b2.shape) != (d,)
            or tuple(ln_scale.shape) != (d,) or tuple(ln_bias.shape) != (d,)
            or not all(t.is_contiguous() for t in (x, w1, w2))):
        raise ValueError(
            f"mt::mlp_block takes bf16 x (..., D), contiguous bf16 w1 (D, H), "
            f"w2 (H, D), b1 (H,), b2 (D,) and f32 LN params (D,), D (at most "
            f"2048) and H multiples of 8; got x {x.dtype} {tuple(x.shape)}, w1 "
            f"{w1.dtype} {tuple(w1.shape)}, w2 {w2.dtype} "
            f"{tuple(w2.shape)}, b1 {b1.dtype}, b2 {b2.dtype}, LN "
            f"{ln_scale.dtype}")
    # TMA and the kernels' 16-byte loads want 16-byte aligned bases
    x, ln_scale, ln_bias, w1, b1, w2, b2 = (
        t if t.data_ptr() % 16 == 0 else t.clone()
        for t in (x, ln_scale, ln_bias, w1, b1, w2, b2))
    m = x.numel() // d
    ln = torch.empty(m, d, dtype=bf16, device=x.device)
    h = torch.empty(m, hidden, dtype=bf16, device=x.device)
    out = torch.empty_like(x)
    _build.launch("mlp_block", "launch_mlp_block", _MLP_BLOCK_ARGS,
                  x.data_ptr(), m, d, hidden, ln_scale.data_ptr(),
                  ln_bias.data_ptr(), ln_eps, w1.data_ptr(), b1.data_ptr(),
                  w2.data_ptr(), b2.data_ptr(), ln.data_ptr(), h.data_ptr(),
                  out.data_ptr(), what="mlp_block")
    return out


def gelu_table(device) -> torch.Tensor:
    """fc1's GELU as the kernel computes it, for every bf16 bit pattern i
    (at i): a (65536,) int16 tensor of bf16 patterns on the card."""
    out = torch.empty(65536, dtype=torch.int16, device=device)
    _build.launch("mlp_block", "launch_gelu_table", (_P,), out.data_ptr(),
                  what="gelu_table")
    return out
