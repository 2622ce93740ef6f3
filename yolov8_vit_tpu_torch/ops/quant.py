"""W8A8 dynamic quantization, the int8 dense layer and the int8 MLP
sub-blocks: kernels C, G and H.

  weights:      per-output-channel symmetric int8, scale = amax / 127,
                quantized once (`prequantize_tree`);
  activations:  per-row dynamic symmetric int8;
  products:     int8 x int8 accumulated exactly in int32, rescaled as
                y = (acc * s_x) * s_w + b.

On the card (csrc/quant_mlp.cu; its source note gives the bounds on the
H100 and the design: one int8 GEMM on wgmma with a TMA ring, and C and H
compute fc1 twice, once for each row's amax and once for its int8 codes,
instead of writing it in f32), each replacing a kernel of
yolov8_vit_tpu/ops/quant.py:

  C  quant_mlp_ln_fused  the ViT's whole pre-norm MLP sub-block,
                         replaces `_quant_mlp_ln_kernel`;
  G  quant_dense_fused   one pre-quantized dense layer, optional SiLU,
                         replaces `_quant_matmul_kernel`;
  H  quant_mlp_fused     the MLP sub-block without the LN, its input and
                         the residual given apart, replaces
                         `_quant_mlp_kernel`.

The kernels read each int8 weight transposed to (out, in), zero-padded
to multiples of 16 (`padded_t`).  A caller that runs many forwards makes
that copy once and passes it (`w_t`, `w1_t`, `w2_t`; models/vit.py derives
them per load); without it a wrapper makes it per call.  The int8 GEMM
takes widths that are multiples of 16 (TMA's 16-byte rows), so the
wrappers zero-pad every other width: the activations' columns, the
weights, scales and biases, and slice the output.  Zero columns add
nothing to an int8 product and leave every row's amax as it was, a padded
fc1 column is gelu(0) = 0, and the LayerNorm's statistics stay over the
real width: the padded forms compute what JAX's kernels compute at any
width.
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


def round_up16(v: int) -> int:
    return -(-v // 16) * 16


def pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """x (..., w) with zero columns appended up to `width` (x itself where
    w == width)."""
    w = x.shape[-1]
    if w == width:
        return x
    out = x.new_zeros(*x.shape[:-1], width)
    out[..., :w] = x
    return out


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 as an IEEE division on every device: by a
    Python scalar, torch's CUDA kernels multiply by the rounded reciprocal
    instead, which moves the scale by an ulp and with it the int8 codes of
    values at a rounding boundary."""
    return amax.clamp_min(1e-8) / torch.full((), 127.0, dtype=amax.dtype,
                                             device=amax.device)


def quantize_weight(w: torch.Tensor):
    """(in, out) f32 -> (int8 (in, out), scale (out,) f32), per out-channel."""
    w = w.to(torch.float32)
    scale = _div127(w.abs().amax(dim=0))
    w_i8 = torch.round(w / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return w_i8, scale


def quantize_act(x: torch.Tensor):
    """(..., in) f32 -> (int8, scale (..., 1)), per-row dynamic symmetric:
    round half to even, clip to +-127."""
    scale = _div127(x.abs().amax(dim=-1, keepdim=True))
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


def padded_t(w_i8: torch.Tensor) -> torch.Tensor:
    """The (out, in) contiguous copy of an int8 (in, out) weight that the
    kernels read, both widths zero-padded to multiples of 16."""
    fin, fout = w_i8.shape
    return pad_cols(pad_cols(w_i8.t(), round_up16(fin)).t(),
                    round_up16(fout)).t().contiguous()


def transposed_i8(w_i8: torch.Tensor, w_t: torch.Tensor | None = None):
    """`padded_t(w_i8)`: `w_t` where the caller made it (padded, or the
    plain transpose, padded here), else a copy made now."""
    if w_t is None:
        return padded_t(w_i8)
    fin, fout = w_i8.shape
    if not w_t.is_contiguous() or w_t.dtype != torch.int8 \
            or w_t.shape not in ((fout, fin),
                                 (round_up16(fout), round_up16(fin))):
        raise ValueError(f"transposed weight {tuple(w_t.shape)} "
                         f"{w_t.dtype} does not fit {tuple(w_i8.shape)}")
    if w_t.shape != (round_up16(fout), round_up16(fin)):
        return padded_t(w_t.t())
    return w_t


def _launch_mlp(what, xm, res, ln, w1t, s1, b1, w2t, s2, b2, ln_eps,
                out=None):
    """The launch chain of kernels C (ln = (scale, bias)) and H (ln =
    None) on (M, D) rows; w1t (Hp, Dp) and w2t (Dp, Hp) from
    `transposed_i8`.  Returns the library, the launch's return code and
    the (M, Dp) rows of the result (padded past D where D % 16).  The rows
    go into `out` where given (an (M, D) contiguous tensor of xm's dtype
    and device, with D % 16 == 0), else into a new tensor."""
    m, d = xm.shape
    hp, dp = w1t.shape
    if xm.dtype not in DTYPE_CODES or dp != round_up16(d):
        raise ValueError(f"{what} takes f32/bf16 rows and weights padded "
                         f"to multiples of 16 (transposed_i8); got "
                         f"{xm.dtype}, D={d}, weights {tuple(w1t.shape)}")
    xp = pad_cols(xm, dp)
    rp = xp if res is xm else pad_cols(res, dp)
    s1, b1 = pad_cols(s1, hp), pad_cols(b1, hp)
    s2, b2 = pad_cols(s2, dp), pad_cols(b2, dp)
    if out is None:
        out = torch.empty_like(xp)
    elif out.shape != xm.shape or out.dtype != xm.dtype or dp != d \
            or out.device != xm.device or not out.is_contiguous():
        raise ValueError(f"{what}: out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device} does not fit rows {tuple(xm.shape)} "
                         f"{xm.dtype} on {xm.device}")
    dev = xm.device
    f32 = torch.float32
    hq = torch.empty(m, dp, dtype=torch.int8, device=dev)
    sx = torch.empty(m, dtype=f32, device=dev)
    amax = torch.empty(m, dtype=torch.int32, device=dev)   # zeroed on card
    aq = torch.empty(m, hp, dtype=torch.int8, device=dev)
    sa = torch.empty(m, dtype=f32, device=dev)
    so = _build.lib("quant_mlp")
    fn = so.launch_quant_mlp
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
                       + [ctypes.c_void_p] * 13)
        fn.restype = ctypes.c_int
    ln_p = (None, None) if ln is None else (ln[0].data_ptr(),
                                            ln[1].data_ptr())
    rc = fn(xp.data_ptr(), rp.data_ptr(), DTYPE_CODES[xm.dtype], m, d, dp,
            hp, ln_p[0], ln_p[1], ln_eps, w1t.data_ptr(), s1.data_ptr(),
            b1.data_ptr(), w2t.data_ptr(), s2.data_ptr(), b2.data_ptr(),
            hq.data_ptr(), sx.data_ptr(), amax.data_ptr(), aq.data_ptr(),
            sa.data_ptr(), out.data_ptr(), _build.stream_ptr())
    return so, rc, out


def quant_mlp_ln_fused(x: torch.Tensor, ln_scale, ln_bias, w1_i8, s1, b1,
                       w2_i8, s2, b2, ln_eps: float = 1e-6, *,
                       w1_t=None, w2_t=None) -> torch.Tensor:
    """x + fc2(gelu(fc1(LN(x)))) with both matmuls W8A8.

    x (..., D) f32 or bf16; w1 (D, H) and w2 (H, D) int8 in the JAX (in,
    out) layout (w1_t, w2_t: their (out, in) copies, see the module note);
    scales, biases and LN params f32.  CUDA tensors launch kernel C; CPU
    tensors run the plain version."""
    *lead, d = x.shape
    xm = x.reshape(-1, d).contiguous()
    f32 = torch.float32
    vecs = [v.to(f32).contiguous() for v in (ln_scale, ln_bias, s1, b1, s2, b2)]
    if _build.on_cpu(xm, w1_i8, w2_i8, *vecs):
        return quant_mlp_ln_plain(xm, vecs[0], vecs[1], w1_i8, vecs[2],
                                  vecs[3], w2_i8, vecs[4], vecs[5],
                                  ln_eps).reshape(*lead, d)
    so, rc, out = _launch_mlp(
        "kernel C", xm, xm, vecs[:2], transposed_i8(w1_i8, w1_t), vecs[2],
        vecs[3], transposed_i8(w2_i8, w2_t), vecs[4], vecs[5], ln_eps)
    quant_mlp_ln_fused.launches += 1
    _build.check(so, rc, "quant_mlp_ln (kernel C)")
    return out[:, :d].reshape(*lead, d)


quant_mlp_ln_fused.launches = 0


def quant_mlp_plain(h, residual, w1_i8, s1, b1, w2_i8, s2, b2) -> torch.Tensor:
    """Plain version of kernel H on (M, D) rows."""
    a = gelu_tanh(quant_dense_pre(h.to(torch.float32), w1_i8, s1, b1))
    y = quant_dense_pre(a, w2_i8, s2, b2)
    return (residual.to(torch.float32) + y).to(h.dtype)


def quant_mlp_fused(h: torch.Tensor, residual: torch.Tensor, w1_i8, s1, b1,
                    w2_i8, s2, b2, *, w1_t=None, w2_t=None) -> torch.Tensor:
    """residual + fc2(gelu_tanh(fc1(h))) with both matmuls W8A8, in h's
    dtype.

    h, residual (..., D) f32 or bf16; w1 (D, H) and w2 (H, D) int8 in the
    JAX (in, out) layout (w1_t, w2_t: their (out, in) copies); scales and
    biases f32.  CUDA tensors launch kernel H, which takes h and residual
    in one dtype; CPU tensors run the plain version."""
    *lead, d = h.shape
    hm = h.reshape(-1, d).contiguous()
    rm = residual.reshape(-1, d).contiguous()
    f32 = torch.float32
    vecs = [v.to(f32).contiguous() for v in (s1, b1, s2, b2)]
    if _build.on_cpu(hm, rm, w1_i8, w2_i8, *vecs):
        return quant_mlp_plain(hm, rm, w1_i8, vecs[0], vecs[1], w2_i8,
                               vecs[2], vecs[3]).reshape(*lead, d)
    if rm.dtype != hm.dtype or rm.shape != hm.shape:
        raise ValueError(f"kernel H takes h and residual of one shape and "
                         f"dtype; got {tuple(hm.shape)} {hm.dtype} and "
                         f"{tuple(rm.shape)} {rm.dtype}")
    so, rc, out = _launch_mlp(
        "kernel H", hm, rm, None, transposed_i8(w1_i8, w1_t), vecs[0],
        vecs[1], transposed_i8(w2_i8, w2_t), vecs[2], vecs[3], 0.0)
    quant_mlp_fused.launches += 1
    _build.check(so, rc, "quant_mlp (kernel H)")
    return out[:, :d].reshape(*lead, d)


quant_mlp_fused.launches = 0


def quant_dense_plain(x, w_i8, w_scale, bias, silu: bool = False):
    """Plain version of kernel G on (M, K) rows: the f32 result rounded
    once to x's dtype."""
    y = quant_dense_pre(x.to(torch.float32), w_i8, w_scale, bias)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def quant_dense_fused(x: torch.Tensor, w_i8: torch.Tensor,
                      w_scale: torch.Tensor, bias: torch.Tensor,
                      silu: bool = False, *, w_t=None) -> torch.Tensor:
    """x (..., K) f32 or bf16 @ pre-quantized int8 w (K, N): per-row
    dynamic quantization, exact int8 product, (acc * s_x) * s_w + bias,
    optional SiLU in f32, one cast to x's dtype.

    w_t: the (N, K) copy of w (see the module note).  CUDA tensors launch
    kernel G; CPU tensors run the plain version."""
    *lead, k = x.shape
    n = w_i8.shape[1]
    xm = x.reshape(-1, k).contiguous()
    f32 = torch.float32
    sw, b = w_scale.to(f32).contiguous(), bias.to(f32).contiguous()
    if _build.on_cpu(xm, w_i8, sw, b):
        return quant_dense_plain(xm, w_i8, sw, b, silu).reshape(*lead, n)
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"kernel G takes f32/bf16 rows; got {x.dtype}")
    m = xm.shape[0]
    dev = x.device
    wt = transposed_i8(w_i8, w_t)
    np_, kp = wt.shape
    xm = pad_cols(xm, kp)
    sw, b = pad_cols(sw, np_), pad_cols(b, np_)
    xq = torch.empty(m, kp, dtype=torch.int8, device=dev)
    sx = torch.empty(m, dtype=f32, device=dev)
    out = torch.empty(m, np_, dtype=x.dtype, device=dev)
    so = _build.lib("quant_mlp")
    fn = so.launch_quant_dense
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    rc = fn(xm.data_ptr(), DTYPE_CODES[x.dtype], m, kp, np_, wt.data_ptr(),
            sw.data_ptr(), b.data_ptr(), int(bool(silu)), xq.data_ptr(),
            sx.data_ptr(), out.data_ptr(), _build.stream_ptr())
    quant_dense_fused.launches += 1
    _build.check(so, rc, "quant_dense (kernel G)")
    return out[:, :n].reshape(*lead, n)


quant_dense_fused.launches = 0


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
