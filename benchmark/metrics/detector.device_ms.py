"""Device ms a fused step of the kernels launched inside the detector's
forward (`bench.det`), from the traced slice."""


def read(rec):
    steps = rec["trace"].span_count("bench.det")
    us = rec["trace"].kernel_us("bench.det")
    return us / 1e3 / steps if steps and us else None
