"""The whole fused step's share (%) of the card's peak over the measured
window: the least time the card needs for the window's work (every
frame's detector convs and every ViT crop the window ran, fused slots and
ladder chunks alike, each operation at the peak of the precision the
configuration states) over the window's host time.  The crops are counted
by a hook on the ViT's forward."""
from benchmark.counts import flops


def read(rec):
    if not rec.get("vit_rows"):
        return None
    frames = rec["steps"] * rec["mix"]["batch"]
    ideal = flops.ideal_s(rec["cfg"], frames, rec["vit_rows"])
    return 100.0 * ideal / rec["window_s"]
