"""The port's kernels timed on the card, so that two trees of the port can be
compared in one call.  From the repository root:

    python3 kernel_cost.py nms --save PATH
    python3 kernel_cost.py nms --load PATH [--tree OTHER_TREE]
    python3 kernel_cost.py region [--tree OTHER_TREE]
    python3 kernel_cost.py steps [--tree OTHER_TREE]

Both build chip_smoke.py phase 5's pipeline (YOLOv8-s at 640 x 640 and
ViT-B/16 w8a, bf16, seed-0 weights with the head fitted to cover scenes)
and its first batch of 32 cover frames, with this tree's chip_smoke.py.
--tree DIR times the `yolov8_vit_tpu_torch` of DIR instead of this tree's.

`nms`: kernels A, B and I on inputs saved to a file.  --save makes them
from seeds as chip_smoke.py makes them: A on the dense tie inputs (32 x
8400 anchors x 5 classes), the same with no score above the threshold, a
1280 x 1280 input (32 x 33,600 x 5), the crowd whose candidates are mostly
suppressed, and phase 5's decoded boxes and scores (the run's data); B on
the dense rows and on A's kept rows of the run's data; I
(`efficient_nms_scan(multi_label=False)`) on A's inputs.  It writes them
and the package's outputs to PATH, then times.  --load times on the saved
inputs, after checking that the outputs equal the saved ones.  Each
wrapper with CUDA events (A, I 20 calls, B 50), each kernel's device time
a launch with torch.profiler over three calls.

`region`: kernel J (`fused_b1b2`) on phase 11's input, the stem output
(`det.b0`) of phase 5's frames, bf16, with that detector's b1 / b2
weights, held within chip_smoke.REGION_TOL of its plain version, then
timed: the wrapper with CUDA events (10 calls), its host time a call
(perf_counter around a call that starts on an idle card, no synchronize
after: what the host spends enqueueing, including any copy that blocks
it), and every device activity of a call in launch order with
torch.profiler over three calls (kernels and copies, by name and
microseconds).  Where the tree has `prepare_region`, each is given with
the weights prepared once outside the timed calls ("prepared") and from
the params dict ("dict"), each with the share of its outputs that differ
from the plain version's.  The port's cuDNN modules on the same input
(`det.b2(det.b1(x))`) are timed beside them.

`steps`: the serving steps of chip_smoke.py phases 5-7 (this tree's
phase functions on the timed tree's package): the ViT-B/16 w8a slice's
and the float ViT-B/8 slice's fused step (`BatchRunner._fn` on 32
frames, CUDA events over 20 calls after the phase's own drive), and the
ViT-B/8 w8a, w8 and dynamic engines' steps (phase 7, 3 calls each).

Prints one JSON line, last, with the card's name and power limit (any
profile chip_smoke.profile_parts retakes is printed before it).  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

import chip_smoke as cs

# the NMS kernels' names in any tree: the greedy scan (its form a bool
# before kernel I joined it, an int after), or before it the
# argmax-per-pick kernels
NMS_KERNELS = {"A": r"greedy_nms_kernel<(false|0)>|nms_argmax_ml_kernel",
               "B": r"greedy_nms_kernel<(true|1)>|mask_scan_kernel",
               "I": r"greedy_nms_kernel<2>|nms_argmax_kernel"}


def _host_ms(fn, reps: int = 10) -> float:
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e3


def _trace(fn, calls: int = 3) -> dict:
    """Device activities of one call in launch order, each averaged over
    `calls` calls: [[name, us], ...], their sum, and the count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not dev or len(dev) % calls:
        raise AssertionError(f"{len(dev)} device activities over {calls} "
                             f"calls")
    per = len(dev) // calls
    acts = [[dev[i].name, sum(dev[c * per + i].time_range.elapsed_us()
                              for c in range(calls)) / calls]
            for i in range(per)]
    return {"activities": acts, "device_us": sum(us for _, us in acts),
            "count": per}


def _phase5():
    """chip_smoke.py phase 5's pipeline on the card, its fitted tree and its
    first batch of 32 frames (uint8, on the card)."""
    import numpy as np
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.utils.densify import make_cover_scenes
    from yolov8_vit_tpu_torch.weights import init_tree, load_pipeline_tree
    pipe = TwoStagePipeline(det_cfg=DetectConfig(variant="s"),
                            vit_spec=ViTSpec(patch=16, quant="w8a",
                                             attn_impl="fused"),
                            classify_budget=cs.BUDGET, dtype=torch.bfloat16,
                            device="cuda")
    rng = np.random.default_rng(0)
    tree = init_tree(pipe, 0)
    load_pipeline_tree(pipe, tree)
    tree = cs._fit_head(pipe, tree, rng)
    imgs, _ = make_cover_scenes(rng, cs.BATCH, (640, 640), lam=1.5)
    return pipe, tree, torch.from_numpy(imgs).cuda()


# ---- nms -------------------------------------------------------------------
def nms_inputs() -> dict:
    """The NMS inputs, on the card, from chip_smoke.py's generators and
    phase 5's fitted pipeline."""
    from yolov8_vit_tpu_torch.ops import efficient_nms_scan
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
    pipe, _, frames = _phase5()
    boxes, scores, _ = cs._decoded(torch, pipe, frames)
    a["run"] = (boxes, scores)
    _, ob, os_, ol = efficient_nms_scan(boxes, scores)
    b["run"] = (ob.clamp(0.0, 640.0).contiguous(), os_, ol >= 0)
    return {"A": a, "B": b}


def nms_times(inputs: dict, saved: dict | None) -> dict:
    """Each wrapper and kernel on each input; the outputs, checked against
    `saved` where given."""
    from yolov8_vit_tpu_torch import ops
    out = {"A": {}, "B": {}, "I": {},
           "outputs": {"A": {}, "B": {}, "I": {}}}
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
                           "ms": cs._time_ms(call, 20),
                           "kernel_ms": cs._kernel_ms(
                               torch, call, NMS_KERNELS["A"])}
    for label, (boxes, scores) in inputs["A"].items():
        def call():
            return ops.efficient_nms_scan(boxes, scores, multi_label=False)
        got = call()
        out["outputs"]["I"][label] = [t.cpu() for t in got]
        out["I"][label] = {"picks": int(got[0].sum()),
                           "ms": cs._time_ms(call, 20),
                           "kernel_ms": cs._kernel_ms(
                               torch, call, NMS_KERNELS["I"])}
    for label, (boxes, scores, valid) in inputs["B"].items():
        def call():
            return ops.area_sorted_nms(boxes, scores, valid)
        out["outputs"]["B"][label] = [call().cpu()]
        out["B"][label] = {"kept": int(call().sum()),
                           "ms": cs._time_ms(call, 50),
                           "kernel_ms": cs._kernel_ms(
                               torch, call, NMS_KERNELS["B"])}
    if saved is not None:
        for k in ("A", "B", "I"):
            for label, got in out["outputs"][k].items():
                if not all(torch.equal(x, y.cpu()) for x, y in
                           zip(got, saved[k][label])):
                    raise AssertionError(f"kernel {k} on {label}: outputs "
                                         f"differ from the saved ones")
    return out


def nms(args) -> dict:
    if args.save:
        inputs = nms_inputs()
        res = nms_times(inputs, None)
        torch.save({"inputs": inputs, "outputs": res["outputs"]}, args.save)
    else:
        blob = torch.load(args.load, map_location="cuda")
        res = nms_times(blob["inputs"], blob["outputs"])
    res.pop("outputs")
    return res


# ---- steps -----------------------------------------------------------------
def steps(args) -> dict:
    from yolov8_vit_tpu_torch import ops
    out = {}
    for name, slice_fn in (("vit_b16_w8a", cs.b16_w8a_slice),
                           ("vit_b8_float", cs.b8_float_slice)):
        rep, runner, tree = slice_fn(torch, ops, 1)
        frames = rep.pop("frames")
        out[name] = cs._time_ms(lambda: runner._fn(frames), 20)
        del runner
        torch.cuda.empty_cache()
    runs, _ = cs.b8_engine_runs(torch, ops, tree["det"],
                                tree["vit"]["params"], frames)
    out.update({k: v["fused_step_ms"] for k, v in runs.items()})
    return out


# ---- region ----------------------------------------------------------------
def region(args) -> dict:
    from yolov8_vit_tpu_torch.ops import fused_region as fr
    torch.backends.cudnn.allow_tf32 = False
    pipe, tree, frames = _phase5()
    _, _, det_in = cs._decoded(torch, pipe, frames)
    det = pipe.det
    out = {}
    with torch.no_grad():
        stem_nchw = det.b0(det_in.permute(0, 3, 1, 2))
        stem = stem_nchw.permute(0, 2, 3, 1).contiguous()
        params = fr.region_params(tree["det"]["params"])
        ref = fr.region_b1b2_plain(stem, params)
        forms = {"dict": params}
        if hasattr(fr, "prepare_region"):
            forms["prepared"] = fr.prepare_region(params, stem.device)
        for name, p in forms.items():
            def call(p=p):
                return fr.fused_b1b2(stem, p)
            out[name] = {**cs._region_err(torch, call(), ref),
                         "events_ms": cs._time_ms(call, 10),
                         "host_ms": _host_ms(call), "trace": _trace(call)}
        out["modules_ms"] = cs._time_ms(
            lambda: det.b2(det.b1(stem_nchw)), 10)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="kernels", required=True)
    p_nms = sub.add_parser("nms", help="kernels A, B and I")
    mode = p_nms.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", metavar="PATH")
    mode.add_argument("--load", metavar="PATH")
    p_region = sub.add_parser("region", help="kernel J")
    p_steps = sub.add_parser("steps", help="the serving steps of phases 5-7")
    for p in (p_nms, p_region, p_steps):
        p.add_argument("--tree", metavar="DIR",
                       help="the tree whose package is timed")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    if not torch.cuda.is_available():
        print("kernel_cost: no CUDA device", file=sys.stderr)
        return 2
    import yolov8_vit_tpu_torch as pkg
    run = {"nms": nms, "region": region, "steps": steps}[args.kernels]
    res = {"package": os.path.dirname(pkg.__file__), **run(args)}
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
