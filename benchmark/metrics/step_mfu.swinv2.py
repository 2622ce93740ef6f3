"""The whole fused step's share (%) of the card's bf16 peak over the
measured window, with a SwinV2 classifier: the least time the card needs
for the window's work (every frame's detector convs and every SwinV2 crop
the window ran, fused slots and ladder chunks alike, counts/swin.py) over
the window's host time.  The crops are counted by a hook on the
classifier's forward."""
from benchmark.counts import swin


def read(rec):
    if not rec.get("vit_rows"):
        return None
    frames = rec["steps"] * rec["mix"]["batch"]
    ideal = swin.ideal_s(rec["cfg"], frames, rec["vit_rows"])
    return 100.0 * ideal / rec["window_s"]
