"""Kernel K (mt::conv_silu): roofline bound of its calls over their
device time, from the traced slice with the operators' shapes.  None
where the program runs its ConvBlocks without it."""
from benchmark.counts import conv, flops


def read(rec):
    return flops.roofline_pct(rec["trace"], "mt::conv_silu", conv.conv_silu)
