"""The classifiers' attention: kernels D, E and F, and mt::window_attn.

  D  fused_attention_block_i8   x + proj_i8(SDPA(qkv_i8(LN1(x))))
     replaces yolov8_vit_tpu/ops/attention.py `_attn_block_kernel_i8`;
  E  fused_attention_block      x + proj(SDPA(qkv(LN1(x)))), float weights,
     replaces `_attn_block_kernel`;
  F  flash_attention            softmax(q k^T / sqrt(d)) v on (B, T, H, D),
     replaces `_attn_kernel`;
     window_attention           SwinV2's shifted-window cosine attention
     with its relative-position bias (models/swin.py), from the qkv GEMM's
     output to proj's input (csrc/window_attn.cu; no TPU kernel: the JAX
     package has no Swin).

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
import math

import torch
import torch.nn.functional as F

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.ops.quant import (DTYPE_CODES, layernorm_f32,
                                            pad_cols, padded_t,
                                            quant_dense_pre, round_up16,
                                            transposed_i8)

# head dims the CUDA SDPA core's fast forms are built for; the wrappers
# zero-pad any other head dim up to the last of them to the next one, and
# a head dim above it to a multiple of 16 (`_core_head_dim`)
SDPA_HEAD_DIMS = (16, 32, 64, 128)

# the C entry points' arguments before the stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ATTN_BLOCK_I8_ARGS = (_P,) + (_I,) * 8 + (_F, _P, _P, _F) + (_P,) * 13
_ATTN_BLOCK_ARGS = (_P,) + (_I,) * 7 + (_F, _P, _P, _F) + (_P,) * 8
_FLASH_ARGS = (_P,) * 3 + (_I,) * 6 + (ctypes.c_longlong, _F, _P)
_WINDOW_ARGS = (_P,) * 4 + (_I,) * 7


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
                        sproj, bproj, heads: int, ln_eps: float = 1e-6,
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
    f32 = torch.float32
    vecs = [v.to(f32).contiguous()
            for v in (ln_scale, ln_bias, sqkv, bqkv, sproj, bproj)]
    return torch.ops.mt.attn_block_i8(
        x.contiguous(), vecs[0], vecs[1], wqkv_i8, vecs[2], vecs[3],
        wproj_i8, vecs[4], vecs[5], heads, ln_eps, t_real, wqkv_t, wproj_t)


def attn_block_i8_kernel(xc, ln_scale, ln_bias, wqkv_i8, sqkv, bqkv,
                         wproj_i8, sproj, bproj, heads, ln_eps, t_real,
                         wqkv_t, wproj_t) -> torch.Tensor:
    """Kernel D on CUDA tensors (operator mt::attn_block_i8): xc (B, T, D)
    contiguous, the vectors f32 contiguous."""
    vecs = [ln_scale, ln_bias, sqkv, bqkv, sproj, bproj]
    _build.require_cuda(xc, wqkv_i8, wproj_i8, *vecs)
    b, t, d = xc.shape
    f32 = torch.float32
    dt = xc.dtype
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
    dev = xc.device
    hq = torch.empty(m, dp, dtype=torch.int8, device=dev)
    sx = torch.empty(m, dtype=f32, device=dev)
    qkv = torch.empty(m, 3 * dh, dtype=dt, device=dev)
    heads_out = torch.empty(m, dh, dtype=dt, device=dev)
    oq = torch.empty(m, dh, dtype=torch.int8, device=dev)
    so_ = torch.empty(m, dtype=f32, device=dev)
    out = torch.empty_like(xp)
    scale = float(torch.tensor(hd ** -0.5, dtype=dt))
    p = [v.data_ptr() for v in vecs]
    _build.launch("attention", "launch_attn_block_i8", _ATTN_BLOCK_I8_ARGS,
                  xp.data_ptr(), DTYPE_CODES[dt], b, t, d, dp, dh, heads,
                  t if t_real is None else t_real, scale, p[0], p[1], ln_eps,
                  wqt.data_ptr(), p[2], p[3], wpt.data_ptr(), p[4], p[5],
                  hq.data_ptr(), sx.data_ptr(), qkv.data_ptr(),
                  heads_out.data_ptr(), oq.data_ptr(), so_.data_ptr(),
                  out.data_ptr(), what="attn_block_i8 (kernel D)")
    return out[:, :d].reshape(b, t, d).contiguous()


# ---- kernel E ----------------------------------------------------------------
def fused_attention_block_plain(x, ln_scale, ln_bias, wqkv, bqkv, wproj,
                                bproj, heads: int, ln_eps: float = 1e-6,
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
    dt = x.dtype
    f32 = torch.float32
    vecs = [v.to(f32).contiguous() for v in (ln_scale, ln_bias, bqkv, bproj)]
    return torch.ops.mt.attn_block(
        x.contiguous(), vecs[0], vecs[1], wqkv.to(dt).contiguous(), vecs[2],
        wproj.to(dt).contiguous(), vecs[3], heads, ln_eps, t_real)


def attn_block_kernel(xc, ln_scale, ln_bias, wq, bqkv, wp, bproj, heads,
                      ln_eps, t_real) -> torch.Tensor:
    """Kernel E on CUDA tensors (operator mt::attn_block): xc (B, T, D)
    and the weights in its dtype, contiguous; vectors f32."""
    vecs = [ln_scale, ln_bias, bqkv, bproj]
    _build.require_cuda(xc, wq, wp, *vecs)
    b, t, d = xc.shape
    dt = xc.dtype
    hdp = _padded_head_dim(dt, d, heads, "kernel E")
    hd = d // heads
    if hdp != hd:
        wq, vecs[2], wp = _head_padded_float(wq, vecs[2], wp, heads, hdp)
    m = b * t
    dev = xc.device
    dh = heads * hdp
    h = torch.empty(m, d, dtype=dt, device=dev)
    qkv = torch.empty(m, 3 * dh, dtype=dt, device=dev)
    heads_out = torch.empty(m, dh, dtype=dt, device=dev)
    out = torch.empty_like(xc)
    scale = float(torch.tensor(hd ** -0.5, dtype=dt))
    p = [v.data_ptr() for v in vecs]
    _build.launch("attention", "launch_attn_block", _ATTN_BLOCK_ARGS,
                  xc.data_ptr(), DTYPE_CODES[dt], b, t, d, dh, heads,
                  t if t_real is None else t_real, scale, p[0], p[1], ln_eps,
                  wq.data_ptr(), p[2], wp.data_ptr(), p[3], h.data_ptr(),
                  qkv.data_ptr(), heads_out.data_ptr(), out.data_ptr(),
                  what="attn_block (kernel E)")
    return out


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
    return torch.ops.mt.flash_attention(q, k, v)


def flash_attention_kernel(q, k, v) -> torch.Tensor:
    """Kernel F on CUDA tensors (operator mt::flash_attention), read in
    place where `_strided_ok`."""
    _build.require_cuda(q, k, v)
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
    _build.launch("attention", "launch_flash_attention", _FLASH_ARGS,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  DTYPE_CODES[q.dtype], b, t, heads, hdp, q.stride(1),
                  q.stride(0), hd ** -0.5, out.data_ptr(),
                  what="flash_attention (kernel F)")
    return out if hdp == hd else out[..., :hd].contiguous()


# ---- mt::window_attn ----------------------------------------------------
def relative_coords(ws: int) -> torch.Tensor:
    """((2 ws - 1)^2, 2) f32: SwinV2's log-spaced relative coordinates,
    (dy, dx) / (ws - 1) * 8 mapped by sign(t) log2(|t| + 1) / log2(8), the
    input of the continuous position bias MLP.  (ws - 1 is taken as 1 at
    ws = 1, where the published code divides by zero.)"""
    r = torch.arange(-(ws - 1), ws, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1)
    t = t / max(ws - 1, 1) * 8
    t = torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8)
    return t.reshape(-1, 2)


def relative_index(ws: int) -> torch.Tensor:
    """(N, N) int64, N = ws^2: V1's relative position index of query i and
    key j of a window, (ri - rj + ws - 1)(2 ws - 1) + ci - cj + ws - 1."""
    r = torch.arange(ws * ws)
    dr = r[:, None] // ws - r[None] // ws + ws - 1
    dc = r[:, None] % ws - r[None] % ws + ws - 1
    return dr * (2 * ws - 1) + dc


def shift_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, N, N) f32: -100 between tokens of different regions of the
    (-shift)-rolled grid, 0 within one, per window in row-major order
    (timm's construction)."""
    img = torch.zeros(h, w)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3) \
        .reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def window_attention_plain(qkv: torch.Tensor, table: torch.Tensor,
                           scale: torch.Tensor, window: int, shift: int,
                           heads: int) -> torch.Tensor:
    """Plain version of mt::window_attn: qkv (B, H, W, 3C) -> (B, H, W, C)
    in qkv's dtype.  The grid rolled by -shift and cut into windows;
    q and k normalised in f32 and rounded to the dtype (the kernel's
    products read them so), scores in f32 times `scale` (heads,), plus
    `table` (heads, (2 window - 1)^2) at V1's index, plus timm's shift mask;
    softmax and P.V in f32; the partition and the roll reversed."""
    b, h, w, c3 = qkv.shape
    c, ws, dt = c3 // 3, window, qkv.dtype
    hd, n = c // heads, window * window
    nw = (h // ws) * (w // ws)
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = x.reshape(b, h // ws, ws, w // ws, ws, 3, heads, hd) \
        .permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * nw, heads, n, hd)
    q, k, v = x.float().unbind(0)
    q = F.normalize(q, dim=-1).to(dt).float()
    k = F.normalize(k, dim=-1).to(dt).float()
    s = q @ k.transpose(-1, -2) * scale.float()[:, None, None]
    s = s + table.float()[:, relative_index(ws).to(qkv.device)]
    if shift:
        mask = shift_mask(h, w, ws, shift).to(qkv.device)
        s = (s.view(b, nw, heads, n, n) + mask[None, :, None]).view(
            b * nw, heads, n, n)
    o = (torch.softmax(s, dim=-1) @ v).to(dt)
    o = o.reshape(b, h // ws, w // ws, heads, ws, ws, hd) \
        .permute(0, 1, 4, 2, 5, 3, 6).reshape(b, h, w, c)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def window_attention(qkv: torch.Tensor, table: torch.Tensor,
                     scale: torch.Tensor, *, window: int, shift: int,
                     heads: int) -> torch.Tensor:
    """SwinV2's window attention over the qkv GEMM's output (B, H, W, 3C)
    (q | k | v, heads of C / heads) -> (B, H, W, C), the input of proj:
    `window_attention_plain`'s function.  table (heads, (2 window - 1)^2)
    is 16 sigmoid(cpb(relative_coords)), scale (heads,) exp(min(logit
    scale, ln 100)), both f32.  CUDA tensors launch the kernel (bf16, head
    dim 32, window 8 or 16); CPU tensors run the plain version."""
    return torch.ops.mt.window_attn(qkv.contiguous(),
                                    table.float().contiguous(),
                                    scale.float().contiguous(), window, shift,
                                    heads)


def window_attn_kernel(qkv, table, scale, window, shift,
                       heads) -> torch.Tensor:
    """csrc/window_attn.cu on CUDA tensors (operator mt::window_attn)."""
    _build.require_cuda(qkv, table, scale)
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    if qkv.dtype != torch.bfloat16 or c != 32 * heads \
            or window not in (8, 16) or h % window or w % window \
            or not 0 <= shift < window \
            or tuple(table.shape) != (heads, (2 * window - 1) ** 2) \
            or tuple(scale.shape) != (heads,):
        raise ValueError(
            f"mt::window_attn takes bf16 qkv (B, H, W, 96 x heads), head dim "
            f"32, window 8 or 16 dividing H and W, 0 <= shift < window; got "
            f"{qkv.dtype} {tuple(qkv.shape)}, heads {heads}, window "
            f"{window}, shift {shift}, table {tuple(table.shape)}")
    out = torch.empty(b, h, w, c, dtype=qkv.dtype, device=qkv.device)
    _build.launch("window_attn", "launch_window_attn", _WINDOW_ARGS,
                  qkv.data_ptr(), table.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), b, h, w, c, heads, window, shift,
                  what="window_attn")
    return out
