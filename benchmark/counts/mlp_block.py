"""mt::mlp_block (the float ViT's MLP sub-block: LN2, fc1 + bias + GELU,
fc2 + bias + residual): operations and bytes of one call, from the shapes
the trace records for its arguments (x, ln_scale, ln_bias, w1, b1, w2, b2,
ln_eps):

    x (..., D), w1 (D, H), w2 (H, D)

Operations: 4 x rows x D x H in bf16 (fc1 and fc2, 2 m D H each).  Bytes:
x read and the output written once in bf16 (the LN output and the hidden
tensor are the kernel's own intermediates), w1 and w2 in bf16, the biases
in bf16 (the Dense layers' derived bias_c, the expression's rounding
point), the LN scale and bias in f32.
"""
from __future__ import annotations

from math import prod


def mlp_block(dims) -> tuple[dict, float]:
    x, ln_scale, ln_bias, w1, b1, w2, b2 = dims[:7]
    d, h = w1
    rows = prod(x) // d
    ops = {"bf16": 4.0 * rows * d * h}
    nbytes = (2 * 2 * prod(x) + 2 * (prod(w1) + prod(w2))
              + 2 * (prod(b1) + prod(b2)) + 4 * (prod(ln_scale)
                                                 + prod(ln_bias)))
    return ops, float(nbytes)
