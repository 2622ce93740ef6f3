"""mt::mlp_block (the float ViT's MLP sub-block): roofline bound of its
calls over their device time, from the traced slice with the operators'
shapes.  None where the program runs its MLP without it."""
from benchmark.counts import flops, mlp_block


def read(rec):
    return flops.roofline_pct(rec["trace"], "mt::mlp_block",
                              mlp_block.mlp_block)
