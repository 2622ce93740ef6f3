"""Host time (ms) a fused step of the runner's drain outside its wait on
the device: (sum of `runner.drain` - sum of `runner.wait`) over the count
of `runner.enqueue` in the traced slice (the unpack, the ladder's
dispatches and patches)."""
from benchmark.counts import spans


def read(rec):
    tr = rec["trace"]
    drain = spans.per_step_ms(tr, "runner.drain", "runner.enqueue")
    if drain is None:
        return None
    return drain - (spans.per_step_ms(tr, "runner.wait", "runner.enqueue")
                    or 0.0)
