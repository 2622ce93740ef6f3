"""W8A8 dynamic quantization and the int8 MLP sub-block: kernel C.

  weights:      per-output-channel symmetric int8, scale = amax / 127,
                quantized once (`prequantize_tree`);
  activations:  per-row dynamic symmetric int8;
  products:     int8 x int8 accumulated exactly in int32, rescaled as
                y = (acc * s_x) * s_w + b.

`quant_mlp_ln_fused` is the ViT's whole pre-norm MLP sub-block; on the card
it is kernel C (csrc/quant_mlp.cu), which replaces yolov8_vit_tpu/ops/
quant.py `_quant_mlp_ln_kernel`.  Its source note gives its bound on the
H100 and its design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from yolov8_vit_tpu_torch import _build

MLP_SUFFIXES = ("mlp_fc1", "mlp_fc2")
# quant="w8a": the attention qkv/proj are pre-quantized as well
MLP_AND_ATTN_SUFFIXES = MLP_SUFFIXES + ("qkv", "proj")

# activation dtype codes of the kernels' C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_weight(w: torch.Tensor):
    """(in, out) f32 -> (int8 (in, out), scale (out,) f32), per out-channel."""
    w = w.to(torch.float32)
    scale = w.abs().amax(dim=0).clamp_min(1e-8) / 127.0
    w_i8 = torch.round(w / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return w_i8, scale


def quantize_act(x: torch.Tensor):
    """(..., in) f32 -> (int8, scale (..., 1)), per-row dynamic symmetric:
    round half to even, clip to +-127."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    x_i8 = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return x_i8, scale


def layernorm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """Row LayerNorm in f32: (x - mu) * rsqrt(var + eps) * scale + bias."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale + bias


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3))), in x's dtype
    (the formula of the TPU kernels' GELU, written out)."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * (x * x)))))
    return x * cdf


def int8_matmul(a_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """Exact int8 product (M, K) x (K, N) as f32: the int32 sum of int8
    products is computed exactly in float64 (|sum| < 2^53), then rounded
    to f32 as an int32 -> f32 conversion rounds."""
    return (a_i8.to(torch.float64) @ w_i8.to(torch.float64)).to(torch.float32)


def quant_dense_pre(x: torch.Tensor, w_i8: torch.Tensor,
                    w_scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(M, in) f32 @ pre-quantized int8 (in, out) -> f32 (plain form)."""
    x_i8, s_x = quantize_act(x)
    return int8_matmul(x_i8, w_i8) * s_x * w_scale[None, :] + bias[None, :]


def quant_dense(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., in) @ float w (in, out) through int8, the weight quantized
    per call (quant="dynamic"); f32-accumulated result in x's dtype.  The
    exact int32 product is `int8_matmul` on the CPU and torch._int_mm on
    the card (the JAX package computes it in XLA, outside its kernels)."""
    w_i8, s_w = quantize_weight(w)
    *lead, fin = x.shape
    x_i8, s_x = quantize_act(x.reshape(-1, fin).to(torch.float32))
    if x.is_cuda:
        rows = x_i8.shape[0]
        if rows <= 16:          # torch._int_mm takes more than 16 rows
            x_i8 = torch.cat([x_i8, x_i8.new_zeros(17 - rows, fin)])
        acc = torch._int_mm(x_i8, w_i8)[:rows].to(torch.float32)
    else:
        acc = int8_matmul(x_i8, w_i8)
    y = acc * s_x * s_w[None, :]
    if bias is not None:
        y = y + bias
    return y.reshape(*lead, -1).to(x.dtype)


def quant_mlp_ln_plain(x, ln_scale, ln_bias, w1_i8, s1, b1, w2_i8, s2, b2,
                       ln_eps: float = 1e-6) -> torch.Tensor:
    """Plain version of kernel C on (M, D) rows."""
    xf = x.to(torch.float32)
    h = layernorm_f32(xf, ln_scale, ln_bias, ln_eps)
    a = gelu_tanh(quant_dense_pre(h, w1_i8, s1, b1))
    y = quant_dense_pre(a, w2_i8, s2, b2)
    return (xf + y).to(x.dtype)


def quant_mlp_ln_fused(x: torch.Tensor, ln_scale, ln_bias, w1_i8, s1, b1,
                       w2_i8, s2, b2, ln_eps: float = 1e-6) -> torch.Tensor:
    """x + fc2(gelu(fc1(LN(x)))) with both matmuls W8A8.

    x (..., D) f32 or bf16; w1 (D, H) and w2 (H, D) int8 in the JAX (in,
    out) layout; scales, biases and LN params f32.  CUDA tensors launch
    kernel C; CPU tensors run the plain version."""
    *lead, d = x.shape
    hid = w1_i8.shape[1]
    xm = x.reshape(-1, d).contiguous()
    f32 = torch.float32
    vecs = [v.to(f32).contiguous() for v in (ln_scale, ln_bias, s1, b1, s2, b2)]
    if _build.on_cpu(xm, w1_i8, w2_i8, *vecs):
        return quant_mlp_ln_plain(xm, vecs[0], vecs[1], w1_i8, vecs[2],
                                  vecs[3], w2_i8, vecs[4], vecs[5],
                                  ln_eps).reshape(*lead, d)
    if x.dtype not in DTYPE_CODES or d % 16 or hid % 16:
        raise ValueError(f"kernel C takes f32/bf16 rows with D, H multiples "
                         f"of 16; got {x.dtype}, D={d}, H={hid}")
    m = xm.shape[0]
    dev = x.device
    w1t = w1_i8.t().contiguous()
    w2t = w2_i8.t().contiguous()
    hq = torch.empty(m, d, dtype=torch.int8, device=dev)
    sx = torch.empty(m, dtype=f32, device=dev)
    a = torch.empty(m, hid, dtype=f32, device=dev)
    aq = torch.empty(m, hid, dtype=torch.int8, device=dev)
    sa = torch.empty(m, dtype=f32, device=dev)
    out = torch.empty_like(xm)
    so = _build.lib("quant_mlp")
    fn = so.launch_quant_mlp_ln
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_float] + [ctypes.c_void_p] * 13)
    fn.restype = ctypes.c_int
    p = [t.data_ptr() for t in vecs]
    rc = fn(xm.data_ptr(), DTYPE_CODES[x.dtype], m, d, hid, p[0], p[1],
            ln_eps, w1t.data_ptr(), p[2], p[3], w2t.data_ptr(), p[4], p[5],
            hq.data_ptr(), sx.data_ptr(), a.data_ptr(), aq.data_ptr(),
            sa.data_ptr(), out.data_ptr(), _build.stream_ptr())
    quant_mlp_ln_fused.launches += 1
    _build.check(so, rc, "quant_mlp_ln (kernel C)")
    return out.reshape(*lead, d)


quant_mlp_ln_fused.launches = 0


def prequantize_tree(params, match_suffixes=MLP_SUFFIXES):
    """Walk a flax-layout param tree (nested dicts of numpy arrays or
    tensors); replace {kernel, bias} of matching module names with
    {kernel_i8, w_scale, bias} (per-out-channel symmetric int8)."""
    def walk(node, name=""):
        if isinstance(node, dict):
            if name in match_suffixes and "kernel" in node:
                w_i8, s = quantize_weight(torch.as_tensor(node["kernel"]))
                out = {"kernel_i8": w_i8, "w_scale": s}
                if "bias" in node:
                    out["bias"] = node["bias"]
                return out
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(params)
