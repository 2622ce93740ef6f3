#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the four CUDA kernels from yolov8_vit_tpu_torch/csrc (nvcc, one
     process per source, in parallel) and print the build seconds;
  3. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes: A and B (NMS) bit-exact on dense inputs with
     score ties and IoU-exactly-at-threshold pairs; C and D (W8A8 blocks)
     within the tolerance stated at KERNEL_TOL; time each (CUDA events)
     beside its bound;
  4. a small-input check: the whole pipeline on the card against the same
     pipeline on the CPU (plain versions), f32, integer outputs equal;
  5. the full-width slice: YOLOv8-s at 640x640 + ViT-B/16 w8a, bf16,
     classify budget 2, batch 32, default thresholds, weights made from a
     seed (f32 init -> prequantize -> detect head ridge-fitted to planted
     covers, utils/densify.py), driven through
     BatchRunner.run_device_batches on cover scenes (~1.5 covers/frame,
     timed) and one crowded batch (~4.4/frame) that overflows the budget;
     every kernel's launch count must be > 0, outputs finite, detections
     found and the overflow ladder taken.
The line before the last holds the kernels' JSON; the last line is the
device JSON.  Nothing of JAX is imported.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# full JSON report and profiler table
OUT_DIR = os.environ.get("CHIP_SMOKE_OUT", os.path.join(HERE, "chip_smoke_out"))
BATCHES = 8                                    # timed frame batches

# H100 SXM datasheet peaks (dense)
PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12

# C and D compare bf16 outputs of two float orders of the same arithmetic:
# LN and softmax sums and tanh/exp round differently in the last f32 bits,
# so an output can land one bf16 ulp (2^-8 relative) apart, and a value at
# a .5 quantization boundary can take the neighbouring int8 code (one code
# of one product term).  Allowed: |kernel - plain| <= atol + rtol * |plain|.
KERNEL_TOL = {"atol": 0.05, "rtol": 2.0 ** -7}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(nbytes: float, op_ms: float) -> tuple[float, str]:
    b_ms = nbytes / PEAK_BYTES_S * 1e3
    return (b_ms, "bytes") if b_ms >= op_ms else (op_ms, "operations")


def _nms_inputs(torch, b, n, c, seed):
    """Dense clustered boxes on a half-pixel grid, scores quantized to
    1/16 (many exact ties), plus planted pairs at IoU exactly .65 and .45
    (inter/union = 13/20 and 9/20) with equal scores."""
    g = torch.Generator().manual_seed(seed)
    ctr = torch.randn(b, n, 2, generator=g) * 80 + 320
    wh = torch.rand(b, n, 2, generator=g) * 140 + 20
    boxes = torch.round(torch.cat([ctr - wh / 2, ctr + wh / 2], -1) * 2) / 2
    scores = torch.rand(b, n, c, generator=g) * 0.2
    hot = torch.rand(b, n, generator=g) < 0.2
    cls = torch.randint(0, c, (b, n), generator=g)
    val = torch.round((torch.rand(b, n, generator=g) * 0.65 + 0.3) * 16) / 16
    scores.scatter_(2, cls[..., None], torch.where(hot, val, scores.gather(
        2, cls[..., None])[..., 0])[..., None])
    k = min(1, c - 1)
    for j, w2 in enumerate((6.5, 4.5)):       # 13/20 -> .65, 9/20 -> .45
        for p in range(8):
            i = 2 * (8 * j + p)
            x, y = 40.0 * p + 5, 600.0 - 30 * j
            boxes[:, i] = torch.tensor([x, y, x + 10, y + 2])
            boxes[:, i + 1] = torch.tensor([x, y, x + w2, y + 2])
            scores[:, i, k] = 0.75
            scores[:, i + 1, k] = 0.75
    return boxes, scores


def check_kernels(torch, ops, mlp_rows: int, crops: int) -> list[dict]:
    from yolov8_vit_tpu_torch.ops.attention import attn_block_i8_plain
    from yolov8_vit_tpu_torch.ops.nms import (mask_scan_plain,
                                              nms_argmax_ml_plain)
    from yolov8_vit_tpu_torch.ops.quant import (quant_mlp_ln_plain,
                                                quantize_weight)
    dev = torch.device("cuda")
    rows = []

    # ---- A: stage-1 NMS, (32, 8400, 4) + (32, 8400, 5) ----------------
    boxes, scores = (t.to(dev) for t in _nms_inputs(torch, 32, 8400, 5, 0))
    got = ops.efficient_nms_scan(boxes, scores)
    ref = nms_argmax_ml_plain(boxes, scores, 0.65, 0.25, 100)
    for name, a, r in zip(("num_dets", "boxes", "scores", "labels"), got, ref):
        if not torch.equal(a, r):
            raise AssertionError(f"kernel A != plain on {name}: "
                                 f"{int((a != r).sum())} entries differ")
    picks = int(got[0].sum())
    k_ms = _time_ms(lambda: ops.efficient_nms_scan(boxes, scores), 20)
    p_ms = _time_ms(lambda: nms_argmax_ml_plain(boxes, scores, 0.65, 0.25,
                                                100), 2)
    nbytes = (boxes.numel() + scores.numel()) * 4 + 32 * 100 * 6 * 4 + 32 * 4
    # each pick: a reduction over n*c scores + ~14 flops of IoU per anchor
    op_ms = picks * (8400 * 5 + 8400 * 14) / PEAK_F32_FLOPS * 1e3
    bound, by = _bound_ms(nbytes, op_ms)
    rows.append(dict(name="nms_argmax_ml", route="cuda",
                     source="yolov8_vit_tpu_torch/csrc/nms.cu",
                     replaces="yolov8_vit_tpu/ops/nms.py:147",
                     max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                     bound_by=by, library_ms=None, picks=picks))

    # ---- B: stage-2 area NMS, (32, 100) rows ---------------------------
    bb, ss = (t.to(dev) for t in _nms_inputs(torch, 32, 100, 1, 1))
    ss = ss[..., 0] + 0.3
    valid = torch.rand(32, 100, device=dev) > 0.1
    keep = ops.area_sorted_nms(bb, ss, valid)
    pri = torch.where(valid & (ss > 0.35), ops.box_area(bb), -1e9)
    keep_ref = mask_scan_plain(bb, pri, 0.45)
    if not torch.equal(keep, keep_ref):
        raise AssertionError(f"kernel B != plain: "
                             f"{int((keep != keep_ref).sum())} rows differ")
    k_ms = _time_ms(lambda: ops.area_sorted_nms(bb, ss, valid), 50)
    p_ms = _time_ms(lambda: mask_scan_plain(bb, pri, 0.45), 2)
    bound, by = _bound_ms(32 * 100 * (4 * 4 + 4 + 1), 0.0)
    rows.append(dict(name="mask_scan", route="cuda",
                     source="yolov8_vit_tpu_torch/csrc/nms.cu",
                     replaces="yolov8_vit_tpu/ops/nms.py:294",
                     max_abs_err=0.0, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                     bound_by=by, library_ms=None))

    # ---- C and D: ViT-B/16 widths, bf16 activations ---------------------
    g = torch.Generator().manual_seed(2)
    d, hid, t = 768, 3072, 197

    def wq(fin, fout):
        w = torch.randn(fin, fout, generator=g) * fin ** -0.5
        q, s = quantize_weight(w)
        return q.to(dev), s.to(dev), (torch.randn(fout, generator=g)
                                      * 0.02).to(dev)

    def ln():
        return ((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
                (0.1 * torch.randn(d, generator=g)).to(dev))

    def close(name, got, ref):
        err = (got.float() - ref.float()).abs()
        lim = KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * ref.float().abs()
        if not bool(torch.isfinite(got.float()).all()) or bool((err > lim)
                                                              .any()):
            raise AssertionError(f"kernel {name} != plain: max err "
                                 f"{float(err.max())}, {int((err > lim).sum())}"
                                 f" beyond {KERNEL_TOL}")
        return float(err.max())

    x = torch.randn(mlp_rows, d, generator=g).to(dev, torch.bfloat16)
    lns, lnb = ln()
    w1, s1, b1 = wq(d, hid)
    w2, s2, b2 = wq(hid, d)
    args = (x, lns, lnb, w1, s1, b1, w2, s2, b2)
    err = close("C", ops.quant_mlp_ln_fused(*args), quant_mlp_ln_plain(*args))
    k_ms = _time_ms(lambda: ops.quant_mlp_ln_fused(*args), 20)
    p_ms = _time_ms(lambda: quant_mlp_ln_plain(*args), 3)
    ops_c = 2 * 2 * mlp_rows * d * hid
    nbytes = 2 * mlp_rows * d * 2 + 2 * d * hid + 4 * (3 * d + 2 * hid)
    bound, by = _bound_ms(nbytes, ops_c / PEAK_INT8_OPS * 1e3)
    rows.append(dict(name="quant_mlp_ln", route="cuda",
                     source="yolov8_vit_tpu_torch/csrc/quant_mlp.cu",
                     replaces="yolov8_vit_tpu/ops/quant.py:240",
                     max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                     bound_by=by, library_ms=None))

    xa = torch.randn(crops, t, d, generator=g).to(dev, torch.bfloat16)
    lns, lnb = ln()
    wqkv, sq, bq = wq(d, 3 * d)
    wp, sp, bp = wq(d, d)
    args = (xa, lns, lnb, wqkv, sq, bq, wp, sp, bp)
    err = close("D", ops.fused_attention_block_i8(*args, heads=12),
                attn_block_i8_plain(*args, heads=12))
    k_ms = _time_ms(lambda: ops.fused_attention_block_i8(*args, heads=12), 20)
    p_ms = _time_ms(lambda: attn_block_i8_plain(*args, heads=12), 3)
    m = crops * t
    int8_ops = 2 * m * d * 4 * d
    bf16_ops = 2 * 2 * crops * 12 * t * t * (d // 12)
    op_ms = (int8_ops / PEAK_INT8_OPS + bf16_ops / PEAK_BF16_FLOPS) * 1e3
    nbytes = 2 * m * d * 2 + 4 * d * d + 4 * (8 * d)
    bound, by = _bound_ms(nbytes, op_ms)
    rows.append(dict(name="attn_block_i8", route="cuda",
                     source="yolov8_vit_tpu_torch/csrc/attention.cu",
                     replaces="yolov8_vit_tpu/ops/attention.py:162",
                     max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                     bound_by=by, library_ms=None))
    return rows


def small_input_check(torch) -> dict:
    """The tiny test configuration (dense thresholds, densified head), f32:
    the card's pipeline against the CPU's on the same weights and frames."""
    import numpy as np
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.utils.densify import densify_detect_head
    from yolov8_vit_tpu_torch.weights import init_tree, load_pipeline_tree
    cfg = DetectConfig(input_size=(64, 64), variant="n", nms_topk=16,
                       nms_conf=1e-6, conf_second=1e-6, nms_iou=0.995,
                       custom_nms_iou=0.999)
    spec = ViTSpec(img_size=32, patch=8, dim=64, depth=2, heads=4,
                   backbone_classes=40, quant="w8a", attn_impl="fused")
    outs = []
    tree = None
    imgs = np.random.default_rng(0).integers(0, 256, (4, 96, 128, 3),
                                             dtype=np.uint8)
    for device in ("cpu", "cuda"):
        pipe = TwoStagePipeline(det_cfg=cfg, vit_spec=spec, classify_budget=2,
                                device=device)
        if tree is None:
            tree = densify_detect_head(init_tree(pipe, 0))
        load_pipeline_tree(pipe, tree)
        o = pipe(torch.from_numpy(imgs).to(device))
        outs.append({k: v.cpu() for k, v in o.items()})
    cpu, gpu = outs
    for key in ("num_dets", "det_labels", "final_valid", "cls_labels"):
        if not torch.equal(cpu[key], gpu[key]):
            raise AssertionError(f"small input: {key} differs card vs CPU")
    errs = {k: float((cpu[k] - gpu[k]).abs().max())
            for k in ("boxes", "det_scores", "cls_scores")}
    if errs["boxes"] > 1e-2 or errs["det_scores"] > 1e-4 \
            or errs["cls_scores"] > 1e-3:
        raise AssertionError(f"small input: float outputs differ {errs}")
    return {"valid": int(cpu["final_valid"].sum()), **errs}


def full_slice(torch, ops, batches: int) -> dict:
    import numpy as np
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner
    from yolov8_vit_tpu_torch.utils.densify import (fit_detect_head,
                                                    make_cover_scenes)
    from yolov8_vit_tpu_torch.weights import init_tree, load_pipeline_tree
    batch, budget = 32, 2
    spec = ViTSpec(patch=16, quant="w8a", attn_impl="fused")
    pipe = TwoStagePipeline(det_cfg=DetectConfig(variant="s"), vit_spec=spec,
                            classify_budget=budget, dtype=torch.bfloat16,
                            device="cuda")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    tree = init_tree(pipe, 0)
    load_pipeline_tree(pipe, tree)
    # content-responsive head at production density (~1.5 covers/frame):
    # ridge-fit on 16 fit scenes; timed scenes are fresh draws
    fit_imgs, fit_covers = make_cover_scenes(rng, 16, (640, 640), lam=1.5)
    load_pipeline_tree(pipe, fit_detect_head(tree, pipe, fit_imgs,
                                             fit_covers))
    init_s = time.perf_counter() - t0
    runner = BatchRunner(pipe, max_batch=batch)
    pools, true_covers = [], 0
    for _ in range(batches):
        imgs, covers = make_cover_scenes(rng, batch, (640, 640), lam=1.5)
        true_covers += sum(len(c) for c in covers)
        pools.append(torch.from_numpy(imgs).to("cuda"))
    # a crowded batch (~4.4 covers/frame, > budget 2): the overflow ladder
    crowded, _ = make_cover_scenes(rng, batch, (640, 640), lam=5.0)
    crowded = torch.from_numpy(crowded).to("cuda")
    runner.run_device_batches(pools[:1] + [crowded])   # warm: cuDNN plans
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    prof: dict = {}
    t0 = time.perf_counter()
    recs = runner.run_device_batches(pools, profile=prof)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dense_prof: dict = {}
    recs += runner.run_device_batches([crowded], profile=dense_prof)
    launches = ops.launch_counts()

    step_ms = _time_ms(lambda: runner._fn(pools[0]), 5)
    flat = [r for rs in recs for r in rs]
    for r in flat:
        for k in ("boxes", "det_scores", "cls_scores"):
            if not np.isfinite(r[k]).all():
                raise AssertionError(f"non-finite {k}")
        v = r["final_valid"]
        if (r["cls_labels"][v] < 0).any():
            raise AssertionError("a kept detection left unclassified")
    prod = flat[:batch * batches]
    num_dets = sum(r["num_dets"] for r in flat)
    if num_dets == 0:
        raise AssertionError("no detections in the full-width slice")
    if dense_prof.get("overflow_dets", 0) == 0:
        raise AssertionError("the overflow ladder never ran")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel wrapper {name} never launched on "
                                 f"the main path")
    return {"launches": launches, "img_s": batch * batches / dt,
            "wall_ms_per_batch": dt / batches * 1e3,
            "fused_step_ms": step_ms, "init_fit_s": init_s,
            "true_covers_per_frame": true_covers / len(prod),
            "kept_per_frame": float(np.mean([r["final_valid"].sum()
                                             for r in prod])),
            "overflow_dets": prof.get("overflow_dets", 0),
            "overflow_ms": prof["overflow_ms"], "fetch_ms": prof["fetch_ms"],
            "crowded_kept_per_frame": float(np.mean(
                [r["final_valid"].sum() for r in flat[len(prod):]])),
            "crowded_overflow_dets": dense_prof["overflow_dets"],
            "crowded_overflow_ms": dense_prof["overflow_ms"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "runner": runner, "frames": pools[0]}


def profile_step(torch, runner, frames, out_dir: str) -> dict:
    """torch.profiler over two fused steps: device time by kernel, written
    to out_dir/profile_step.txt; returns the per-step device time and the
    top kernels."""
    from torch.profiler import ProfilerActivity, profile
    runner._fn(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            runner._fn(frames)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    attr = ("self_device_time_total" if hasattr(ka[0], "self_device_time_total")
            else "self_cuda_time_total")
    # device-side entries only (the kernels); host-side aten:: entries
    # repeat the same time
    rows = sorted(((e.key, getattr(e, attr), e.count) for e in ka
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and getattr(e, attr) > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    with open(os.path.join(out_dir, "profile_step.txt"), "w") as f:
        f.write(ka.table(sort_by=attr, row_limit=40))
    return {"device_us_per_step": busy_us / 2,
            "top": [(k[:60], round(us / 2, 1), n // 2) for k, us, n in rows[:12]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from yolov8_vit_tpu_torch import _build, ops
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    print(f"card: {smi}", flush=True)

    t0 = time.perf_counter()
    build_s = _build.build()
    print(f"build: {build_s:.1f} s (wall {time.perf_counter() - t0:.1f} s)",
          flush=True)

    t0 = time.perf_counter()
    rows = check_kernels(torch, ops, mlp_rows=64 * 197, crops=64)
    for r in rows:
        print(f"kernel {r['name']}: ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}) max_abs_err {r['max_abs_err']}", flush=True)
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s", flush=True)

    small = small_input_check(torch)
    print(f"small input card == CPU: {small}", flush=True)

    t0 = time.perf_counter()
    full = full_slice(torch, ops, BATCHES)
    print(f"full slice ({time.perf_counter() - t0:.1f} s): " + json.dumps(
        {k: v for k, v in full.items() if k not in ("runner", "frames")}),
        flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    prof = profile_step(torch, full.pop("runner"), full.pop("frames"),
                        OUT_DIR)
    # share of the (unprofiled) fused step the device spends in kernels
    prof["busy_share"] = prof["device_us_per_step"] / (
        full["fused_step_ms"] * 1e3)
    print(f"profile of one fused step: {json.dumps(prof)}", flush=True)

    names = {"nms_argmax_ml": "efficient_nms_scan",
             "mask_scan": "area_sorted_nms",
             "quant_mlp_ln": "quant_mlp_ln_fused",
             "attn_block_i8": "fused_attention_block_i8"}
    kernels = []
    for r in rows:
        r = dict(r, launches=full["launches"][names[r["name"]]])
        r.pop("picks", None)
        kernels.append(r)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build_s": build_s, "kernels": kernels,
                   "small_input": small, "full_slice": full,
                   "profile": prof}, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
