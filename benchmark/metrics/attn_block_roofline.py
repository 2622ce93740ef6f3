"""Kernel E (mt::attn_block): roofline bound of its calls over their
device time, from the traced slice with the operators' shapes."""
from benchmark.counts import flops


def read(rec):
    return flops.roofline_pct(rec["trace"], "mt::attn_block",
                              flops.attn_block)
