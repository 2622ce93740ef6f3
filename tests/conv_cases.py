"""Kernel K (mt::conv_silu) against the chain it replaced, at the shapes a
detector forward calls it with: shared by tests/test_torch_kernels_gpu.py
and chip_smoke.py (torch only, no jax).

The bar, element by element: both sides sum the same exact products (a
bf16 x bf16 product is exact in f32 and in TF32) in another order, add
the same f32 bias, apply SiLU in f32 (slope at most 1.1) and round once
to bf16.  So they differ by at most one bf16 ulp of the larger result (a
half ulp each way) plus 1.1 x the difference of the two f32 sums, which
is within 2 K 2^-24 sum |x w| (each sum's rounding error is within
K 2^-24 sum |x w|, K the products a sum adds): an allowance that matters
only where the sum cancels (|y| well under sum |x w|).  A residual adds a
second rounding (one ulp of the result) and carries a one-ulp move of
the SiLU part (one ulp of its magnitude).  A fault (a wrong tap, channel,
pixel or stride) moves most outputs by far more than that; as a second
guard, the share of outputs that differ at all stays under DIFFER_SHARE
(rounding flips where the two sums straddle a bf16 boundary: 0.001-0.13%
at YOLOv8-s).
"""
import math

import torch

DIFFER_SHARE = 0.01


def signatures(model, x):
    """The distinct ConvBlock calls of one forward of `model` on x: (x
    shape, x pixel stride, weight shape, stride, residual pixel stride or
    None, out pixel stride) -> calls, recorded inside kernel K's launcher
    (the chain runs in its place meanwhile)."""
    from yolov8_vit_tpu_torch.ops import conv_block as cb
    sigs = {}
    real = cb.conv_silu_kernel

    def record(x, w, b, s, res, out):
        key = (tuple(x.shape), x.stride(2), tuple(w.shape), s,
               None if res is None else res.stride(2), out.stride(2))
        sigs[key] = sigs.get(key, 0) + 1
        out.copy_(cb.conv_silu_plain(x, w, b, s, res))

    cb.conv_silu_kernel = record
    try:
        with torch.no_grad():
            model(x)
    finally:
        cb.conv_silu_kernel = real
    return sigs


def case(sig, dev, seed=0):
    """Random operands of signature `sig`: x, out and the residual as
    channel slices of buffers as wide as the recorded pixel strides."""
    from yolov8_vit_tpu_torch.ops import conv_block as cb
    xs, ldx, ws, s, ldr, ldo = sig
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, w, cin = xs
    cout, k = ws[0], ws[1]
    bf16 = torch.bfloat16
    x = torch.randn(b, h, w, ldx, generator=g, device=dev).to(bf16)[
        ..., ldx - cin:]
    kern = torch.randn(cout, cin, k, k, generator=g, device=dev) \
        / math.sqrt(cin * k * k)
    bias = torch.randn(cout, generator=g, device=dev) * 0.1
    shape = cb.out_shape(x, cb.kernel_layout(kern), s)
    res = None
    if ldr is not None:
        res = torch.randn(*shape[:3], ldr, generator=g, device=dev).to(
            bf16)[..., :cout]
    out = torch.empty(*shape[:3], ldo, device=dev, dtype=bf16)[
        ..., ldo - cout:]
    return x, cb.kernel_layout(kern), bias, s, res, out


def _ulp(v):
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def compare(x, wk, bias, s, res, got):
    """Kernel K's output `got` against the chain on the same operands:
    {"beyond_bar": outputs off by more than the bar, "differ_share",
    "max_ulps": the largest difference in ulps of the result}."""
    from yolov8_vit_tpu_torch.ops import conv_block as cb
    ref = cb.conv_silu_plain(x, wk, bias, s, res).float()
    got = got.float()
    d = (got - ref).abs()
    k = wk.shape[1]
    terms = k * k * x.shape[-1]
    mag = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2).float().abs(), cb.chain_weight(wk).abs(),
        stride=s, padding=k // 2).permute(0, 2, 3, 1)
    one = _ulp(torch.maximum(got.abs(), ref.abs()))
    bar = one + 1.1 * 2 * terms * 2.0 ** -24 * mag
    if res is not None:
        r = res.float()
        bar = bar + _ulp(torch.maximum((got - r).abs(), (ref - r).abs()))
    return {"beyond_bar": int((d > bar).sum()),
            "differ_share": float((d > 0).float().mean()),
            "max_ulps": float((d / one).max())}


def convblock_calls(model) -> int:
    """Kernel K's calls a forward of `model`: one a ConvBlock, the head's
    two branch-entry convs of a level as one."""
    from yolov8_vit_tpu_torch.models import yolov8 as y
    blocks = sum(isinstance(m, y.ConvBlock) for m in model.modules())
    return blocks - model.detect.levels


def check_model(model, x, seed=0):
    """Every distinct ConvBlock call of a forward on x: kernel K against
    the chain.  Returns {signature string: compare's dict and calls}."""
    from yolov8_vit_tpu_torch.ops import conv_block as cb
    rows = {}
    for sig, calls in signatures(model, x).items():
        x_, wk, bias, s, res, out = case(sig, x.device, seed)
        cb.conv_silu(x_, wk, bias, s, res, out)
        torch.cuda.synchronize()
        r = compare(x_, wk, bias, s, res, out)
        r["calls"] = calls
        rows[str(sig)] = r
    return rows
