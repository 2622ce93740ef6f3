"""The ViT's W8A8 attention sub-block: kernel D.

    out = x + proj_i8(SDPA(qkv_i8(LN1(x))))

On the card this is kernel D (csrc/attention.cu), which replaces
yolov8_vit_tpu/ops/attention.py `_attn_block_kernel_i8`; its source note
gives its bound on the H100 and its design.  The SDPA runs in the
activation dtype as the TPU kernel's does: q * hd^-0.5 rounded to the
dtype, scores and softmax in f32, probabilities rounded to the dtype, P.V
accumulated in f32 and rounded to the dtype.
"""
from __future__ import annotations

import ctypes

import torch

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.ops.quant import (DTYPE_CODES, layernorm_f32,
                                            quant_dense_pre)


def sdpa_heads_plain(qkv: torch.Tensor, heads: int,
                     t_real: int | None = None) -> torch.Tensor:
    """(B, T, 3D) packed q|k|v in the activation dtype -> (B, T, D) head
    outputs in the same dtype; products are f32 matmuls of dtype-rounded
    operands."""
    b, t, d3 = qkv.shape
    d = d3 // 3
    hd = d // heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(b, t, 3, heads, hd).unbind(2)
    q = q * torch.tensor(hd ** -0.5, dtype=dt, device=qkv.device)
    s = torch.einsum("bqhc,bkhc->bhqk", q.float(), k.float())
    if t_real is not None and t_real < t:
        s = s.masked_fill(torch.arange(t, device=qkv.device) >= t_real,
                          float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    o = torch.einsum("bhqk,bkhc->bqhc", p.float(), v.float()).to(dt)
    return o.reshape(b, t, d)


def attn_block_i8_plain(x, ln_scale, ln_bias, wqkv_i8, sqkv, bqkv, wproj_i8,
                        sproj, bproj, *, heads: int, ln_eps: float = 1e-6,
                        t_real: int | None = None) -> torch.Tensor:
    """Plain version of kernel D on x (B, T, D)."""
    b, t, d = x.shape
    dt = x.dtype
    xx = x.reshape(b * t, d).to(torch.float32)
    h = layernorm_f32(xx, ln_scale, ln_bias, ln_eps)
    qkv = quant_dense_pre(h, wqkv_i8, sqkv, bqkv).to(dt)
    o = sdpa_heads_plain(qkv.reshape(b, t, 3 * d), heads, t_real)
    y = quant_dense_pre(o.reshape(b * t, d).to(torch.float32), wproj_i8,
                        sproj, bproj)
    return (xx + y).reshape(b, t, d).to(dt)


def fused_attention_block_i8(x: torch.Tensor, ln_scale, ln_bias, wqkv_i8,
                             sqkv, bqkv, wproj_i8, sproj, bproj, *,
                             heads: int, ln_eps: float = 1e-6,
                             t_real: int | None = None) -> torch.Tensor:
    """x (B, T, D) f32 or bf16 -> x + proj(MHA(LN(x))), qkv and proj W8A8.

    wqkv (D, 3D) and wproj (D, D) int8 in the JAX (in, out) layout;
    scales, biases and LN params f32.  t_real < T masks key columns
    >= t_real.  CUDA tensors launch kernel D; CPU tensors run the plain
    version."""
    b, t, d = x.shape
    f32 = torch.float32
    xc = x.contiguous()
    vecs = [v.to(f32).contiguous()
            for v in (ln_scale, ln_bias, sqkv, bqkv, sproj, bproj)]
    if _build.on_cpu(xc, wqkv_i8, wproj_i8, *vecs):
        return attn_block_i8_plain(xc, vecs[0], vecs[1], wqkv_i8, vecs[2],
                                   vecs[3], wproj_i8, vecs[4], vecs[5],
                                   heads=heads, ln_eps=ln_eps, t_real=t_real)
    if x.dtype not in DTYPE_CODES or d % 16 or d % heads:
        raise ValueError(f"kernel D takes f32/bf16 with D a multiple of 16 "
                         f"and of heads; got {x.dtype}, D={d}")
    hd = d // heads
    smem = 4 * (t * (hd + 1) + t * hd + 8 * (hd + t))
    if smem > 232448:
        raise ValueError(f"sequence {t} x head dim {hd} exceeds kernel D's "
                         f"shared memory")
    m = b * t
    dev = x.device
    dt = x.dtype
    wqt = wqkv_i8.t().contiguous()
    wpt = wproj_i8.t().contiguous()
    hq = torch.empty(m, d, dtype=torch.int8, device=dev)
    sx = torch.empty(m, dtype=f32, device=dev)
    qkv = torch.empty(m, 3 * d, dtype=dt, device=dev)
    heads_out = torch.empty(m, d, dtype=dt, device=dev)
    oq = torch.empty(m, d, dtype=torch.int8, device=dev)
    so_ = torch.empty(m, dtype=f32, device=dev)
    out = torch.empty_like(xc)
    scale = float(torch.tensor(hd ** -0.5, dtype=dt))
    so = _build.lib("attention")
    fn = so.launch_attn_block_i8
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_float] + [ctypes.c_void_p] * 14)
    fn.restype = ctypes.c_int
    p = [v.data_ptr() for v in vecs]
    rc = fn(xc.data_ptr(), DTYPE_CODES[dt], b, t, d, heads,
            t if t_real is None else t_real, scale, p[0], p[1], ln_eps,
            wqt.data_ptr(), p[2], p[3], wpt.data_ptr(), p[4], p[5],
            hq.data_ptr(), sx.data_ptr(), qkv.data_ptr(),
            heads_out.data_ptr(), oq.data_ptr(), so_.data_ptr(),
            out.data_ptr(), _build.stream_ptr())
    fused_attention_block_i8.launches += 1
    _build.check(so, rc, "attn_block_i8 (kernel D)")
    return out


fused_attention_block_i8.launches = 0
