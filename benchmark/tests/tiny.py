"""Tiny forms of the benchmark's cells for the CPU tests: the same files,
found by the same names, with the widths and frame sizes cut."""
from __future__ import annotations

import copy

from benchmark import harness


def tiny(workload: str, dtype: str = "float32") -> dict:
    """harness.resolve(...) of `workload`, cut to a YOLOv8-n at 64x64 and
    a 2-block ViT of width 64 on 32x32 crops, batches of 4."""
    res = harness.resolve(harness.load_manifest(), workload)
    cfg = copy.deepcopy(res["cfg"])
    cfg["detector"].update(variant="n", scale=[0.33, 0.25, 1024],
                           input_size=[64, 64])
    cfg["vit"].update(img_size=32, patch=16, dim=64, depth=2, heads=2)
    cfg["dtype"] = dtype
    mix = dict(res["mix"])
    if mix["driver"] == "bulk":
        mix.update(batch=4, pool_batches=2, height=64, width=64,
                   fit_frames=8, trace_batches=2)
    elif mix["driver"] == "retrain":
        mix.update(frames=8, objects=16, height=96, width=128, workers=2,
                   trace_seconds=0.5)
    res.update(cfg=cfg, mix=mix)
    return res
