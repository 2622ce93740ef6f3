"""Kernels A and B timed on the card, on inputs saved to a file, so that two
trees of the port can be compared in one call.  From the repository root:

    python3 nms_cost.py --save PATH
    python3 nms_cost.py --load PATH --tree OTHER_TREE

--save makes the inputs from seeds as chip_smoke.py makes them: A on the
dense tie inputs (32 x 8400 anchors x 5 classes), the same with no score
above the threshold, a 1280 x 1280 input (32 x 33,600 x 5), the crowd
whose candidates are mostly suppressed, and phase 5's decoded boxes and
scores (the run's data: YOLOv8-s at 640 x 640 with the head fitted to
cover scenes, its first 32 frames); B on the dense rows and on A's kept
rows of the run's data.  It writes them and the package's outputs to
PATH, then times.  --load times the `yolov8_vit_tpu_torch` of OTHER_TREE
(this tree's without --tree) on the saved inputs, after checking that its
outputs equal the saved ones.  Times: each wrapper with CUDA events (A 20
calls, B 50), each kernel's device time a launch with torch.profiler over
three calls.  Prints one JSON line with the card's name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

# the kernels' names in either tree: the greedy scan, or before it the
# argmax-per-pick kernels
KERNELS = {"A": r"greedy_nms_kernel<false>|nms_argmax_ml_kernel",
           "B": r"greedy_nms_kernel<true>|mask_scan_kernel"}


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, kernel: str, calls: int = 3) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(ka[0], "self_device_time_total")
            else "self_cuda_time_total")
    hits = [(getattr(e, attr), e.count) for e in ka
            if re.search(kernel, e.key) and getattr(e, attr) > 0]
    if not hits:
        raise AssertionError(f"no kernel matches {kernel}")
    return sum(us for us, _ in hits) / sum(n for _, n in hits) / 1e3


def make_inputs() -> dict:
    """The inputs, on the card, from chip_smoke.py's generators and phase
    5's fitted pipeline."""
    import numpy as np
    import chip_smoke as cs
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.ops import efficient_nms_scan
    from yolov8_vit_tpu_torch.utils.densify import make_cover_scenes
    from yolov8_vit_tpu_torch.weights import init_tree, load_pipeline_tree
    dev = torch.device("cuda")
    a = {"dense": cs._nms_inputs(torch, 32, 8400, 5, 0),
         "1280": cs._nms_inputs(torch, 32, 33600, 5, 3, side=1280),
         "crowd": cs._crowd_inputs(torch, 32, 8400, 5, 4)}
    # no score above the threshold: the cost of reading the scores alone
    a["empty"] = (a["dense"][0], a["dense"][1] * 0.2)
    a = {k: tuple(t.to(dev) for t in v) for k, v in a.items()}
    bb, ss = (t.to(dev) for t in cs._nms_inputs(torch, 32, 100, 1, 1))
    b = {"dense": (bb, ss[..., 0] + 0.3,
                   torch.rand(32, 100, generator=torch.Generator()
                              .manual_seed(5)).to(dev) > 0.1)}
    # phase 5: ViT-B/16 w8a pipeline, head fitted on 16 scenes, then its
    # first batch of 32 frames
    pipe = TwoStagePipeline(det_cfg=DetectConfig(variant="s"),
                            vit_spec=ViTSpec(patch=16, quant="w8a",
                                             attn_impl="fused"),
                            classify_budget=cs.BUDGET, dtype=torch.bfloat16,
                            device="cuda")
    rng = np.random.default_rng(0)
    tree = init_tree(pipe, 0)
    load_pipeline_tree(pipe, tree)
    cs._fit_head(pipe, tree, rng)
    imgs, _ = make_cover_scenes(rng, cs.BATCH, (640, 640), lam=1.5)
    frames = torch.from_numpy(imgs).to(dev)
    boxes, scores, _ = cs._decoded(torch, pipe, frames)
    a["run"] = (boxes, scores)
    _, ob, os_, ol = efficient_nms_scan(boxes, scores)
    b["run"] = (ob.clamp(0.0, 640.0).contiguous(), os_, ol >= 0)
    return {"A": a, "B": b}


def time_all(inputs: dict, saved: dict | None) -> dict:
    """Each wrapper and kernel on each input; the outputs, checked against
    `saved` where given."""
    import yolov8_vit_tpu_torch as pkg
    from yolov8_vit_tpu_torch import ops
    out = {"package": os.path.dirname(pkg.__file__), "A": {}, "B": {},
           "outputs": {"A": {}, "B": {}}}
    for label, (boxes, scores) in inputs["A"].items():
        def call():
            return ops.efficient_nms_scan(boxes, scores)
        try:
            got = call()
        except ValueError as e:           # the old kernel's shared memory
            out["A"][label] = {"refused": str(e)}
            continue
        out["outputs"]["A"][label] = [t.cpu() for t in got]
        out["A"][label] = {"picks": int(got[0].sum()),
                           "candidates_max_frame": int(
                               (scores > 0.25).sum(dim=(1, 2)).max()),
                           "ms": _events_ms(call, 20),
                           "kernel_ms": _device_ms(call, KERNELS["A"])}
    for label, (boxes, scores, valid) in inputs["B"].items():
        def call():
            return ops.area_sorted_nms(boxes, scores, valid)
        out["outputs"]["B"][label] = [call().cpu()]
        out["B"][label] = {"kept": int(call().sum()),
                           "ms": _events_ms(call, 50),
                           "kernel_ms": _device_ms(call, KERNELS["B"])}
    if saved is not None:
        for k in ("A", "B"):
            for label, got in out["outputs"][k].items():
                if not all(torch.equal(x, y.cpu()) for x, y in
                           zip(got, saved[k][label])):
                    raise AssertionError(f"kernel {k} on {label}: outputs "
                                         f"differ from the saved ones")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", metavar="PATH")
    mode.add_argument("--load", metavar="PATH")
    ap.add_argument("--tree", metavar="DIR",
                    help="with --load: the tree whose package is timed")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    if not torch.cuda.is_available():
        print("nms_cost: no CUDA device", file=sys.stderr)
        return 2
    if args.save:
        inputs = make_inputs()
        res = time_all(inputs, None)
        torch.save({"inputs": inputs, "outputs": res["outputs"]}, args.save)
    else:
        blob = torch.load(args.load, map_location="cuda")
        inputs = blob["inputs"]
        res = time_all(inputs, blob["outputs"])
    res.pop("outputs")
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
