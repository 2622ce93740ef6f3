"""Kernel D (mt::attn_block_i8): roofline bound of its calls over their
device time, from the traced slice with the operators' shapes."""
from benchmark.counts import flops


def read(rec):
    return flops.roofline_pct(rec["trace"], "mt::attn_block_i8",
                              flops.attn_block_i8)
