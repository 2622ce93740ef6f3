"""Kernel K (mt::conv_silu, one ConvBlock of the bf16 detector):
operations and bytes of one call, from the shapes the trace records for
its arguments (x, weight, bias, stride, residual, out):

    x (B, H, W, cin), weight (cout, k, k, cin), bias (cout,), residual
    (B, H / s, W / s, cout) or none, out (B, H / s, W / s, cout)

Operations: 2 x output elements (pixels x cout) x k^2 x cin, in bf16.
Bytes: the input read once, the output written once and the residual
read where there is one, all bf16; the weights in bf16; the bias in f32.
"""
from __future__ import annotations

from math import prod


def conv_silu(dims) -> tuple[dict, float]:
    x, w, bias, _stride, res, out = dims
    _, k, _, cin = w
    ops = {"bf16": 2.0 * prod(out) * k * k * cin}
    nbytes = (2 * prod(x) + 2 * prod(out) + (2 * prod(res) if res else 0)
              + 2 * prod(w) + 4 * prod(bias))
    return ops, float(nbytes)
