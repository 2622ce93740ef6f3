"""Mean host time (ms) of the trainer's `train.step` span in the traced
slice: the batch's upload and the launches of forward, backward and the
optimizer."""
from benchmark.counts import spans


def read(rec):
    return spans.mean_ms(rec["trace"], "train.step")
