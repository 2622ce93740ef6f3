"""mt::window_attn (SwinV2's window attention): roofline bound of its calls
over their kernels' device time, from the traced slice with the
operators' shapes: the calls are the classifier's blocks at the crops of
each classifier call in that slice (counts/window_attn.py).  None where
the program runs no such kernel."""
from benchmark.counts import window_attn


def read(rec):
    return window_attn.roofline_pct(rec["trace"], rec["cfg"]["vit"],
                                    rec.get("slice_cls_rows"))
