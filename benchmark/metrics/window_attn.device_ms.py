"""Device ms a fused step of mt::window_attn's kernels (every block's
window attention, the overflow ladder's calls included), found by kernel
name (counts/window_attn.py), from the traced slice.  None where the
program runs no such kernel."""
from benchmark.counts import window_attn


def read(rec):
    steps = rec["trace"].span_count("bench.det")
    us = window_attn.kernel_us(rec["trace"])
    return us / 1e3 / steps if steps and us else None
