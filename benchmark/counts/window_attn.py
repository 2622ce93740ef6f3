"""mt::window_attn (SwinV2's shifted-window attention, one call a block):
operations and bytes of one call, from the shapes of its arguments (qkv,
table, scale, window, shift, heads):

    qkv (B, H, W, 3C), table (heads, (2 ws - 1)^2), scale (heads,)

A window holds N = ws^2 tokens (ws from the table's side).  Operations:
4 x rows x N x C in bf16 (Q K^T and P V, 2 N C each a query row), rows =
B H W.  Bytes: q, k and v read and the output written once in bf16, the
bias table and the scales in f32 read once (the kernel works the shift
mask out from the token coordinates: no mask table).

The classifier's forward runs on the card as a CUDA graph, whose kernels
the trace links to the graph's launch and not to the operator's range:
the kernels are found by name (`window_attn_kernel`), and the calls'
shapes come from the configuration and the crops of each classifier call.
"""
from __future__ import annotations

import math

from benchmark.counts import flops

KERNEL = "window_attn_kernel"


def window_attn(dims) -> tuple[dict, float]:
    qkv, table, scale = dims[:3]
    b, h, w, c3 = qkv
    rows, c = b * h * w, c3 // 3
    ws = (math.isqrt(table[1]) + 1) // 2
    ops = {"bf16": 4.0 * rows * ws * ws * c}
    nbytes = 2 * rows * (c3 + c) + 4 * math.prod(table) + 4 * math.prod(scale)
    return ops, float(nbytes)


def forward_calls(v: dict, crops: int) -> list:
    """The argument shapes of a SwinV2 forward's calls over `crops` crops,
    one a block (v: the configuration's "vit"; a stage whose grid is no
    larger than the window takes the grid as its window)."""
    g = v["img_size"] // v["patch_size"]
    calls = []
    for i, depth in enumerate(v["depths"]):
        c, grid, heads = v["embed_dim"] << i, g >> i, v["num_heads"][i]
        ws = min(grid, v["window_size"])
        calls += [[(crops, grid, grid, 3 * c), (heads, (2 * ws - 1) ** 2),
                   (heads,)]] * depth
    return calls


def kernel_us(trace) -> float:
    """Device time (us) of the window kernels in the trace's window."""
    return sum(d[1] for d in trace.in_window()
               if d[3] == "kernel" and KERNEL in d[2])


def roofline_pct(trace, v: dict, crops_per_call) -> float | None:
    """Share (%) of the roofline bound in the window kernels' device time,
    the bound summed over the classifier calls of the traced slice (their
    crops `crops_per_call`); None where the trace holds no such kernel."""
    us = kernel_us(trace)
    if not us or not crops_per_call:
        return None
    bound = sum(flops.bound_s(*window_attn(dims))
                for k in crops_per_call for dims in forward_calls(v, k))
    return 100.0 * bound / (us / 1e6)
