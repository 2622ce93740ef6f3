"""Device ms a fused step of the kernels launched inside mt::mlp_block
(every float ViT block's MLP sub-block, the overflow ladder's calls
included), from the traced slice.  None where the program runs its MLP
without it."""


def read(rec):
    steps = rec["trace"].span_count("bench.det")
    us = rec["trace"].kernel_us("mt::mlp_block")
    return us / 1e3 / steps if steps and us else None
