"""Mean host time (ms) of the runner's `runner.enqueue` span in the traced
slice: the host's launch of one fused step and of its result copy."""
from benchmark.counts import spans


def read(rec):
    return spans.mean_ms(rec["trace"], "runner.enqueue")
