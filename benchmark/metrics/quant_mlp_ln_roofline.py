"""Kernel C (mt::quant_mlp_ln): roofline bound of its calls over their
device time, from the traced slice with the operators' shapes."""
from benchmark.counts import flops


def read(rec):
    return flops.roofline_pct(rec["trace"], "mt::quant_mlp_ln",
                              flops.quant_mlp_ln)
