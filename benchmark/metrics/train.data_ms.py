"""Host time (ms) a training step spent fetching its batch: the sum of
`train.data` over the count of `train.step` in the traced slice (the
program's own counterpart of train.data_wait_ms)."""
from benchmark.counts import spans


def read(rec):
    return spans.per_step_ms(rec["trace"], "train.data", "train.step")
