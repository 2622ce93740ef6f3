"""The ViT's attention: kernels D, E and F.

  D  fused_attention_block_i8   x + proj_i8(SDPA(qkv_i8(LN1(x))))
     replaces yolov8_vit_tpu/ops/attention.py `_attn_block_kernel_i8`;
  E  fused_attention_block      x + proj(SDPA(qkv(LN1(x)))), float weights,
     replaces `_attn_block_kernel`;
  F  flash_attention            softmax(q k^T / sqrt(d)) v on (B, T, H, D),
     replaces `_attn_kernel`.

On the card each is a chain around the key-tiled SDPA core of
csrc/sdpa.cuh (csrc/attention.cu; the source notes give the bounds on the
H100 and the design: at bf16 the core and E's GEMMs run on wgmma with TMA
copies; head dims above 128 run a simple CUDA-core form that streams the
features in 128-wide chunks); CPU tensors run the plain versions below.
The SDPA rounds as the TPU kernels do.  D and E (`sdpa_heads_plain`):
q * hd^-0.5 rounded to the dtype, scores and softmax in f32,
probabilities rounded to the dtype, P.V accumulated in f32 and rounded to
the dtype.  F (`flash_attention_plain`): f32 scores times the f32 scale,
probabilities rounded to v's dtype, output in q's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.ops.quant import (DTYPE_CODES, layernorm_f32,
                                            pad_cols, padded_t,
                                            quant_dense_pre, round_up16,
                                            transposed_i8)

# head dims the CUDA SDPA core's fast forms are built for; the wrappers
# zero-pad any other head dim up to the last of them to the next one, and
# a head dim above it to a multiple of 16 (`_core_head_dim`)
SDPA_HEAD_DIMS = (16, 32, 64, 128)


def _core_head_dim(hd: int) -> int:
    """The head dim the SDPA core runs for a real head dim hd >= 1: the
    least of SDPA_HEAD_DIMS >= hd, or above 128 hd rounded up to a
    multiple of 16 (the wide form takes any head dim; 16 keeps D's int8
    GEMM widths and TMA's 16-byte rows)."""
    if hd > SDPA_HEAD_DIMS[-1]:
        return round_up16(hd)
    return min(h for h in SDPA_HEAD_DIMS if h >= hd)


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, p_dtype, out_dtype):
    """s (B, H, Tq, Tk) f32 scores -> softmax rounded to p_dtype, P.V
    accumulated in f32, (B, Tq, H, C) in out_dtype."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(p_dtype)
    return torch.einsum("bhqk,bkhc->bqhc", p.float(), v.float()).to(out_dtype)


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
    return _softmax_pv(s, v, dt, dt).reshape(b, t, d)


def _padded_head_dim(dtype, d: int, heads: int, what: str) -> int:
    """The head dim the SDPA core runs for D = heads x hd
    (`_core_head_dim`; the wrapper zero-pads each head to it).  Raises
    where the kernel takes no such input: another dtype, D not a multiple
    of heads (and of 8, for TMA's 16-byte rows)."""
    if dtype not in DTYPE_CODES or d % 8 or not heads or d % heads:
        raise ValueError(f"{what} takes f32/bf16 with D a multiple of 8 and "
                         f"of heads; got {dtype}, D={d}, heads={heads}")
    return _core_head_dim(d // heads)


def _per_head(v: torch.Tensor, parts: int, heads: int,
              hdp: int) -> torch.Tensor:
    """(..., parts x heads x hd) columns (q | k | v: parts 3) -> (...,
    parts x heads x hdp): each head's columns, then zero columns."""
    lead = v.shape[:-1]
    hd = v.shape[-1] // (parts * heads)
    return pad_cols(v.reshape(*lead, parts, heads, hd), hdp).reshape(
        *lead, parts * heads * hdp)


def _per_head_rows(w: torch.Tensor, heads: int, hdp: int) -> torch.Tensor:
    """(heads x hd, n) rows (the proj weight's) -> (heads x hdp, n): each
    head's rows, then zero rows."""
    hd = w.shape[0] // heads
    return pad_cols(w.reshape(heads, hd, -1).transpose(1, 2), hdp) \
        .transpose(1, 2).reshape(heads * hdp, -1)


# ---- kernel D ----------------------------------------------------------------
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


def _head_padded_i8(wqkv_i8, sqkv, bqkv, wproj_i8, sproj, bproj, heads,
                    hdp):
    """Kernel D's operands where the head dim hd is not one the SDPA core
    takes: each head of q, k and v padded with zero columns to hdp (the
    QKV weight's columns, scales and biases), the proj weight's rows to
    match, and D to a multiple of 16.  The padded q, k and v columns are
    exactly zero, so they add nothing to q.k and give zero output columns,
    which the proj weight's zero rows drop."""
    d = wqkv_i8.shape[0]
    dp = round_up16(d)
    return (padded_t(_per_head(wqkv_i8, 3, heads, hdp)),
            _per_head(sqkv, 3, heads, hdp), _per_head(bqkv, 3, heads, hdp),
            padded_t(_per_head_rows(wproj_i8, heads, hdp)),
            pad_cols(sproj, dp), pad_cols(bproj, dp))


def fused_attention_block_i8(x: torch.Tensor, ln_scale, ln_bias, wqkv_i8,
                             sqkv, bqkv, wproj_i8, sproj, bproj, *,
                             heads: int, ln_eps: float = 1e-6,
                             t_real: int | None = None, wqkv_t=None,
                             wproj_t=None) -> torch.Tensor:
    """x (B, T, D) f32 or bf16 -> x + proj(MHA(LN(x))), qkv and proj W8A8.

    wqkv (D, 3D) and wproj (D, D) int8 in the JAX (in, out) layout
    (wqkv_t, wproj_t: their (out, in) copies, made once by a caller that
    runs many forwards; without them the wrapper transposes per call);
    scales, biases and LN params f32.  t_real < T masks key columns
    >= t_real.  Any D and head dim: a head dim the SDPA core does not run
    is zero-padded to the one it runs (`_core_head_dim`), the weights laid
    out so per call (`_head_padded_i8`).  CUDA tensors launch
    kernel D; CPU tensors run the plain version."""
    b, t, d = x.shape
    f32 = torch.float32
    xc = x.contiguous()
    vecs = [v.to(f32).contiguous()
            for v in (ln_scale, ln_bias, sqkv, bqkv, sproj, bproj)]
    if _build.on_cpu(xc, wqkv_i8, wproj_i8, *vecs):
        return attn_block_i8_plain(xc, vecs[0], vecs[1], wqkv_i8, vecs[2],
                                   vecs[3], wproj_i8, vecs[4], vecs[5],
                                   heads=heads, ln_eps=ln_eps, t_real=t_real)
    dt = x.dtype
    hd = d // heads if heads and d % heads == 0 else 0
    if dt not in DTYPE_CODES or not hd:
        raise ValueError(f"kernel D takes f32/bf16 with D a multiple of "
                         f"heads; got {dt}, D={d}, heads={heads}")
    hdp = _core_head_dim(hd)
    if hdp == hd:                           # D = heads x hdp: a multiple of 16
        wqt = transposed_i8(wqkv_i8, wqkv_t)
        wpt = transposed_i8(wproj_i8, wproj_t)
    else:
        wqt, vecs[2], vecs[3], wpt, vecs[4], vecs[5] = _head_padded_i8(
            wqkv_i8, *vecs[2:4], wproj_i8, *vecs[4:], heads, hdp)
    m = b * t
    dp, dh = round_up16(d), heads * hdp
    xp = pad_cols(xc.reshape(m, d), dp)
    dev = x.device
    hq = torch.empty(m, dp, dtype=torch.int8, device=dev)
    sx = torch.empty(m, dtype=f32, device=dev)
    qkv = torch.empty(m, 3 * dh, dtype=dt, device=dev)
    heads_out = torch.empty(m, dh, dtype=dt, device=dev)
    oq = torch.empty(m, dh, dtype=torch.int8, device=dev)
    so_ = torch.empty(m, dtype=f32, device=dev)
    out = torch.empty_like(xp)
    scale = float(torch.tensor(hd ** -0.5, dtype=dt))
    so = _build.lib("attention")
    fn = so.launch_attn_block_i8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_float] + [ctypes.c_void_p] * 14)
        fn.restype = ctypes.c_int
    p = [v.data_ptr() for v in vecs]
    rc = fn(xp.data_ptr(), DTYPE_CODES[dt], b, t, d, dp, dh, heads,
            t if t_real is None else t_real, scale, p[0], p[1], ln_eps,
            wqt.data_ptr(), p[2], p[3], wpt.data_ptr(), p[4], p[5],
            hq.data_ptr(), sx.data_ptr(), qkv.data_ptr(),
            heads_out.data_ptr(), oq.data_ptr(), so_.data_ptr(),
            out.data_ptr(), _build.stream_ptr())
    fused_attention_block_i8.launches += 1
    _build.check(so, rc, "attn_block_i8 (kernel D)")
    return out[:, :d].reshape(b, t, d)


fused_attention_block_i8.launches = 0


# ---- kernel E ----------------------------------------------------------------
def fused_attention_block_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                bproj, *, heads: int, ln_eps: float = 1e-6,
                                t_real: int | None = None) -> torch.Tensor:
    """Plain version of kernel E on x (B, T, D): LN in f32 rounded to the
    dtype, qkv = f32-accumulated h.W + b rounded to the dtype, SDPA,
    y = f32-accumulated o.Wp + bp, out = (x + y) rounded to the dtype."""
    b, t, d = x.shape
    dt = x.dtype
    f32 = torch.float32
    xx = x.reshape(b * t, d).to(f32)
    h = layernorm_f32(xx, ln_scale.to(f32), ln_bias.to(f32), ln_eps).to(dt)
    qkv = (h.to(f32) @ wqkv.to(dt).to(f32) + bqkv.to(f32)).to(dt)
    o = sdpa_heads_plain(qkv.reshape(b, t, 3 * d), heads, t_real)
    y = o.reshape(b * t, d).to(f32) @ wproj.to(dt).to(f32) + bproj.to(f32)
    return (xx + y).reshape(b, t, d).to(dt)


def _head_padded_float(wqkv, bqkv, wproj, heads: int, hdp: int):
    """Kernel E's weights where the head dim is not one the SDPA core
    takes: each head's q, k and v columns of wqkv (D, 3D) and bqkv padded
    with zero columns to hdp, wproj's rows (D, D) to match: (D, 3 H hdp),
    (3 H hdp,), (H hdp, D).  As D's (`_head_padded_i8`), the padded
    columns of q, k and v are zero, add nothing to q.k and give zero head
    outputs, which the zero rows of the proj weight drop."""
    return (_per_head(wqkv, 3, heads, hdp), _per_head(bqkv, 3, heads, hdp),
            _per_head_rows(wproj, heads, hdp).contiguous())


def fused_attention_block(x: torch.Tensor, ln_scale, ln_bias, wqkv, bqkv,
                          wproj, bproj, *, heads: int, ln_eps: float = 1e-6,
                          t_real: int | None = None) -> torch.Tensor:
    """x (B, T, D) f32 or bf16 -> x + proj(MHA(LN(x))), float weights.

    wqkv (D, 3D) and wproj (D, D) in the JAX (in, out) layout; the kernel
    reads them in x's dtype, so a caller that runs many forwards passes
    them cast once (models/vit.py caches the cast per load); at bf16 the
    kernel reads them through TMA, which needs 16-byte aligned bases (a
    view off that raises).  Biases and LN params are used in f32.  t_real
    < T masks key columns >= t_real.  Any D (a multiple of 8) and head
    dim: a head dim the SDPA core does not run is zero-padded to the one it
    runs (`_core_head_dim`), each head's QKV columns and proj rows laid out
    so per call (as D's).  CUDA tensors launch kernel E; CPU tensors run the
    plain version."""
    b, t, d = x.shape
    dt = x.dtype
    f32 = torch.float32
    xc = x.contiguous()
    wq = wqkv.to(dt).contiguous()
    wp = wproj.to(dt).contiguous()
    vecs = [v.to(f32).contiguous() for v in (ln_scale, ln_bias, bqkv, bproj)]
    if _build.on_cpu(xc, wq, wp, *vecs):
        return fused_attention_block_plain(
            xc, vecs[0], vecs[1], wq, vecs[2], wp, vecs[3], heads=heads,
            ln_eps=ln_eps, t_real=t_real)
    hdp = _padded_head_dim(dt, d, heads, "kernel E")
    hd = d // heads
    if hdp != hd:
        wq, vecs[2], wp = _head_padded_float(wq, vecs[2], wp, heads, hdp)
    m = b * t
    dev = x.device
    dh = heads * hdp
    h = torch.empty(m, d, dtype=dt, device=dev)
    qkv = torch.empty(m, 3 * dh, dtype=dt, device=dev)
    heads_out = torch.empty(m, dh, dtype=dt, device=dev)
    out = torch.empty_like(xc)
    scale = float(torch.tensor(hd ** -0.5, dtype=dt))
    so = _build.lib("attention")
    fn = so.launch_attn_block
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_float] + [ctypes.c_void_p] * 9)
    fn.restype = ctypes.c_int
    p = [v.data_ptr() for v in vecs]
    rc = fn(xc.data_ptr(), DTYPE_CODES[dt], b, t, d, dh, heads,
            t if t_real is None else t_real, scale, p[0], p[1], ln_eps,
            wq.data_ptr(), p[2], wp.data_ptr(), p[3], h.data_ptr(),
            qkv.data_ptr(), heads_out.data_ptr(), out.data_ptr(),
            _build.stream_ptr())
    fused_attention_block.launches += 1
    _build.check(so, rc, "attn_block (kernel E)")
    return out


fused_attention_block.launches = 0


# ---- kernel F ----------------------------------------------------------------
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel F: (B, T, H, D) -> (B, T, H, D) in q's
    dtype."""
    s = torch.einsum("bqhc,bkhc->bhqk", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    return _softmax_pv(s, v, v.dtype, q.dtype)


def _strided_ok(t: torch.Tensor, hd: int) -> bool:
    """A (B, T, H, hd) view the kernel reads in place: unit stride in the
    head dim, heads adjacent, rows and images apart and not overlapping,
    16-byte aligned base and strides (TMA's rules for k and v)."""
    es = t.element_size()
    _, n, heads, _ = t.shape
    return (t.stride(3) == 1 and t.stride(2) == hd
            and t.data_ptr() % 16 == 0 and (t.stride(1) * es) % 16 == 0
            and (t.stride(0) * es) % 16 == 0
            and t.stride(1) >= heads * hd and t.stride(0) >= n * t.stride(1))


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, T, H, D) inputs -> (B, T, H, D),
    the JAX signature.  q, k and v may be strided views of one packed
    (B, T, 3, H, D) qkv, read in place; a view the kernel cannot read so
    (`_strided_ok`: TMA's 16-byte rules, heads adjacent, rows apart), or
    views with different row or image strides, are copied contiguous
    first.  A head dim the SDPA core does not run is zero-padded to the one
    it runs (`_core_head_dim`): q, k and v copied into padded buffers, the
    output sliced (the scale stays the real hd^-0.5).  CUDA
    tensors launch kernel F; CPU tensors run the plain version."""
    if _build.on_cpu(q, k, v):
        return flash_attention_plain(q, k, v)
    b, t, heads, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape \
            or len({q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError("kernel F takes q, k, v of one shape and dtype")
    hdp = _padded_head_dim(q.dtype, heads * hd, heads, "kernel F")
    if hdp != hd:
        q, k, v = (pad_cols(x, hdp) for x in (q, k, v))
    q, k, v = (x if _strided_ok(x, hdp) else x.contiguous()
               for x in (q, k, v))
    if not (q.stride()[:2] == k.stride()[:2] == v.stride()[:2]):
        q, k, v = (x.contiguous() for x in (q, k, v))
    out = torch.empty(b, t, heads, hdp, dtype=q.dtype, device=q.device)
    so = _build.lib("attention")
    fn = so.launch_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), DTYPE_CODES[q.dtype],
            b, t, heads, hdp, q.stride(1), q.stride(0), hd ** -0.5,
            out.data_ptr(), _build.stream_ptr())
    flash_attention.launches += 1
    _build.check(so, rc, "flash_attention (kernel F)")
    return out if hdp == hd else out[..., :hd]


flash_attention.launches = 0
