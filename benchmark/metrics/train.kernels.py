"""Device operations (kernels, copies, memsets) a training step: those of
the traced slice over its count of `train.step`."""
from benchmark.counts import spans


def read(rec):
    return spans.device_ops_per_step(rec["trace"], "train.step")
