"""The port's kernels timed on the card, so that two trees of the port can be
compared in one call.  From the repository root:

    python3 kernel_cost.py nms --save PATH
    python3 kernel_cost.py nms --load PATH [--tree OTHER_TREE]
    python3 kernel_cost.py region [--tree OTHER_TREE]
    python3 kernel_cost.py steps [--tree OTHER_TREE]
    python3 kernel_cost.py serve [--tree OTHER_TREE]
    python3 kernel_cost.py window [--tree OTHER_TREE]
    python3 kernel_cost.py int8 [--tree OTHER_TREE]

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

`serve`: the served path of chip_smoke.py phases 5 and 12 from files:
phase 5's runner (`BatchRunner`, max_batch 32) on its 32 frames, the
fused step three times (CUDA events over 20 calls each); the frames
written as BMP files, `run_paths` over them three times after a warm
call (its decode_ms each); the service (`build_default_service` on
engines saved from phase 5's tree) answering `POST /` of the 32 BMP URLs
on 127.0.0.1, three requests on the fused route and two on the host
route, each after a warm request.  Each tree decodes as its runner does
(a tree without runtime/native.py through serve/imageio.py).

`window`: mt::window_attn (SwinV2's window attention) alone, as
chip_smoke.py's `check_window_attn` checks and times it: SwinV2-B/256's
block shapes for 64 crops, bf16, against the plain version; the kernel,
its plain version and torch's SDPA on the same windows beside each
shape's bound, and the sums over one forward's 24 blocks.

`int8`: kernels C, D, G and H, the callers of the int8 GEMM
(csrc/int8_common.cuh), on seeded bf16 inputs at ViT-B/16 widths: C at
64 x 197 rows (a bulk step's crops) and 512 x 197 (the crowd cell's
ladder chunk), H at 64 x 197, D at 64 and 512 crops of 197 tokens and
64 of 785, G at 64 x 197 rows on (768, 2304), (768, 768), (768, 3072)
and (3072, 768), and with SiLU at (819200, 64) x (64, 64).  Each
output's sha256 (the first 16 hex digits; C also its fc1 int8 codes and
row scales, from the scratch of a direct launch), so that two trees'
outputs compare bit for bit; the largest difference from the plain
version (C, D, H); the wrapper's time with CUDA events (20 calls); C's
and D's device time a launch of each part with torch.profiler
(chip_smoke.C_PARTS, D_PARTS).

A tree from before `utils/profiling.py` is timed with this tree's copy of
that module (chip_smoke.py's `_time_ms` and `profile_parts` call its
`device_barrier`).

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


# ---- serve -----------------------------------------------------------------
def serve(args) -> dict:
    import dataclasses
    import functools
    import http.server
    import shutil
    import threading
    from yolov8_vit_tpu_torch.serve import imageio
    from yolov8_vit_tpu_torch.serve.app import build_default_service
    from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner
    from yolov8_vit_tpu_torch.weights import save_engine
    from yolov8_vit_tpu_torch.config import DetectConfig
    pipe, tree, frames = _phase5()
    runner = BatchRunner(pipe, max_batch=cs.BATCH)
    runner.run_device_batches([frames])                       # warm
    out = {"fused_step_ms": [cs._time_ms(lambda: runner._fn(frames), 20)
                             for _ in range(3)]}
    root = os.path.join(cs.ENGINE_DIR, "kernel_cost_serve")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    servers = []

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *a):
            pass

    def start(httpd):
        servers.append(httpd)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        names = [f"cam{i:02d}.bmp" for i in range(cs.BATCH)]
        for name, img in zip(names, frames.cpu().numpy()):
            imageio.imwrite(os.path.join(root, name), imageio.bgr2rgb(img))
        paths = [os.path.join(root, n) for n in names]
        runner.run_paths(paths[:2])                           # warm
        out["decode_ms"] = []
        for _ in range(3):
            prof: dict = {}
            runner.run_paths(paths, profile=prof)
            out["decode_ms"].append(prof["decode_ms"])
        det_dir = save_engine(
            os.path.join(root, "detect"), "detect", tree["det"],
            {"detect_cfg": dataclasses.asdict(DetectConfig())})
        cls_dir = save_engine(
            os.path.join(root, "classify"), "classify", tree["vit"],
            {"vit_spec": dataclasses.asdict(pipe.vit_spec),
             "num_classes": 5})
        files = start(http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), functools.partial(Quiet, directory=root)))
        body = {"urls": [{f"img{i}": f"{files}/{n}"}
                         for i, n in enumerate(names)]}
        for route, fused, reps in (("fused", True, 3), ("host", False, 2)):
            svc = build_default_service(os.path.join(root, f"work_{route}"),
                                        det_dir, cls_dir,
                                        enable_retrain=False, fused=fused)
            base = start(svc.make_http_server("127.0.0.1", 0))
            if not cs._http_json(base + "/", body):           # warm
                raise AssertionError(f"{route} route: no detections")
            secs = []
            for _ in range(reps):
                t0 = time.perf_counter()
                cs._http_json(base + "/", body)
                secs.append(time.perf_counter() - t0)
            out[f"{route}_request_s"] = secs
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(root, ignore_errors=True)
    return out


def _profiling_shim() -> None:
    """Give a timed tree without `utils/profiling.py` this tree's copy."""
    import importlib.util
    try:
        import yolov8_vit_tpu_torch.utils.profiling  # noqa: F401
    except ImportError:
        name = "yolov8_vit_tpu_torch.utils.profiling"
        spec = importlib.util.spec_from_file_location(name, os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "yolov8_vit_tpu_torch", "utils", "profiling.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod


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


def window(args) -> dict:
    from yolov8_vit_tpu_torch import ops
    row, rep = cs.check_window_attn(torch, ops, "")
    return {"window_attn": rep["shapes"],
            "forward_64_crops": {k: row[k] for k in ("ms", "plain_ms",
                                                     "library_ms",
                                                     "bound_ms")}}


# ---- int8 ------------------------------------------------------------------
def _digest(t) -> str:
    import hashlib
    b = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(b).hexdigest()[:16]


def _max_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max())


def int8(args) -> dict:
    from yolov8_vit_tpu_torch import _build, ops
    from yolov8_vit_tpu_torch.ops import quant
    from yolov8_vit_tpu_torch.ops.attention import attn_block_i8_plain
    from yolov8_vit_tpu_torch.ops.quant import (quant_dense_plain,
                                                quant_mlp_ln_plain,
                                                quant_mlp_plain,
                                                quantize_weight)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(20)
    d, hid = 768, 3072

    def wq(fin, fout):
        q, s = quantize_weight(torch.randn(fin, fout, generator=g)
                               * fin ** -0.5)
        return q.to(dev), s.to(dev), (0.02 * torch.randn(fout, generator=g)
                                      ).to(dev)

    def ln():
        return ((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
                (0.1 * torch.randn(d, generator=g)).to(dev))

    def rows(m, width=d):
        return torch.randn(m, width, generator=g).to(dev, bf16)

    def timed(call, ref=None, parts=None):
        got = call()
        rep = {"digest": _digest(got), "ms": cs._time_ms(call, 20)}
        if ref is not None:
            rep["max_err"] = _max_err(got, ref())
        if parts is not None:
            rep["parts_ms"] = cs.profile_parts(torch, call, parts)
        return rep

    out = {}
    lns, lnb = ln()
    w1, s1, b1 = wq(d, hid)
    w2, s2, b2 = wq(hid, d)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    for crops in (64, 512):
        x = rows(crops * 197)
        args = (x, lns, lnb, w1, s1, b1, w2, s2, b2)
        rep = timed(lambda: ops.quant_mlp_ln_fused(*args, w1_t=w1t,
                                                   w2_t=w2t),
                    lambda: quant_mlp_ln_plain(*args), cs.C_PARTS)
        # fc1's codes and row scales: the chain's scratch, launched directly
        m = x.shape[0]
        hq = torch.empty(m, d, dtype=torch.int8, device=dev)
        sx = torch.empty(m, device=dev)
        amax = torch.empty(m, dtype=torch.int32, device=dev)
        aq = torch.empty(m, hid, dtype=torch.int8, device=dev)
        sa = torch.empty(m, device=dev)
        y = torch.empty_like(x)
        _build.launch("quant_mlp", "launch_quant_mlp", quant._QUANT_MLP_ARGS,
                      x.data_ptr(), x.data_ptr(), 1, m, d, d, hid,
                      lns.data_ptr(), lnb.data_ptr(), 1e-6, w1t.data_ptr(),
                      s1.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
                      s2.data_ptr(), b2.data_ptr(), hq.data_ptr(),
                      sx.data_ptr(), amax.data_ptr(), aq.data_ptr(),
                      sa.data_ptr(), y.data_ptr(), what="kernel C")
        rep.update(fc1_codes=_digest(aq), fc1_scales=_digest(sa))
        out[f"C_{crops}x197"] = rep
        del args, x, hq, aq, y
        torch.cuda.empty_cache()
    h, res = rows(64 * 197), rows(64 * 197)
    hargs = (h, res, w1, s1, b1, w2, s2, b2)
    out["H_64x197"] = timed(lambda: ops.quant_mlp_fused(*hargs, w1_t=w1t,
                                                        w2_t=w2t),
                            lambda: quant_mlp_plain(*hargs))
    del h, res, hargs
    lns, lnb = ln()
    wqkv, sq, bq = wq(d, 3 * d)
    wp, sp, bp = wq(d, d)
    wts = dict(heads=12, wqkv_t=wqkv.t().contiguous(),
               wproj_t=wp.t().contiguous())
    for crops, t in ((64, 197), (512, 197), (64, 785)):
        xa = torch.randn(crops, t, d, generator=g).to(dev, bf16)
        dargs = (xa, lns, lnb, wqkv, sq, bq, wp, sp, bp)
        out[f"D_{crops}x{t}"] = timed(
            lambda: ops.fused_attention_block_i8(*dargs, **wts),
            lambda: attn_block_i8_plain(*dargs, heads=12), cs.D_PARTS)
        del xa, dargs
        torch.cuda.empty_cache()
    for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
        x = rows(64 * 197, k)
        w, s, b = wq(k, n)
        wt = w.t().contiguous()
        out[f"G_{k}x{n}"] = timed(
            lambda: ops.quant_dense_fused(x, w, s, b, w_t=wt))
        out[f"G_{k}x{n}"]["equal_plain"] = bool(torch.equal(
            ops.quant_dense_fused(x, w, s, b, w_t=wt),
            quant_dense_plain(x, w, s, b)))
    x = rows(819200, 64)
    w, s, b = wq(64, 64)
    wt = w.t().contiguous()
    out["G_silu_64x64"] = timed(
        lambda: ops.quant_dense_fused(x, w, s, b, silu=True, w_t=wt))
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
    p_serve = sub.add_parser("serve", help="phase 5's step, decode and "
                             "POST / from files")
    p_window = sub.add_parser("window", help="SwinV2's window attention")
    p_int8 = sub.add_parser("int8", help="kernels C, D, G and H (the int8 "
                            "GEMM's callers)")
    for p in (p_nms, p_region, p_steps, p_serve, p_window, p_int8):
        p.add_argument("--tree", metavar="DIR",
                       help="the tree whose package is timed")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    if not torch.cuda.is_available():
        print("kernel_cost: no CUDA device", file=sys.stderr)
        return 2
    import yolov8_vit_tpu_torch as pkg
    _profiling_shim()
    run = {"nms": nms, "region": region, "steps": steps,
           "serve": serve, "window": window, "int8": int8}[args.kernels]
    res = {"package": os.path.dirname(pkg.__file__), **run(args)}
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
