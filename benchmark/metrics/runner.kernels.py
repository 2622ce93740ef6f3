"""Device operations (kernels, copies, memsets) a fused step: those of the
traced slice over its count of `runner.enqueue` (the ladder's included)."""
from benchmark.counts import spans


def read(rec):
    return spans.device_ops_per_step(rec["trace"], "runner.enqueue")
