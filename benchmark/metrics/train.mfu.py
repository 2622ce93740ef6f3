"""The training step's share (%) of the card's float32 peak over the
measured window: forward and backward operations of every sample trained
(three times a forward's, counts/flops.py), at 67 TFLOP/s, over the
window's host time."""
from benchmark.counts import flops


def read(rec):
    if not rec.get("steps"):
        return None
    vf = flops.vit_flops(rec["cfg"]["vit"], rec["cfg"]["num_classes"])
    ops = 3.0 * sum(vf.values()) * rec["steps"] * rec["batch"]
    return 100.0 * ops / flops.PEAKS["f32_flops_per_s"] / rec["window_s"]
