#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels A-J from yolov8_vit_tpu_torch/csrc (nvcc, one
     process per source, in parallel) and print the build seconds and
     ptxas's registers, shared memory and spills of each kernel of the
     quant_mlp (C, G, H), attention (D, E, F; the SDPA core at head dims
     16-128), nms (A, B, I) and fused_region (J) libraries;
  3. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes: A and B (NMS) bit-exact on dense inputs with
     score ties and IoU-exactly-at-threshold pairs, A also at a 1280 x 1280
     input (32 x 33,600 anchors x 5 classes: more candidates than a
     window, the select path) and on a crowd whose candidates are mostly
     suppressed (every window and chunk decided), B's kernel alone (its
     device time, profiler) beside its wrapper; after phase 5, A and B on
     that phase's decoded boxes (the run's data); C and D (W8A8 blocks,
     ViT-B/16) and D at ViT-B/8's 785 tokens within KERNEL_TOL; E (float
     attention block) and F (flash attention) at 785 tokens, bf16 at 64
     crops within FLOAT_BF16_TOL and f32 at 16 crops within F32_TOL; time
     each (CUDA events) beside its bound, its plain version and, for F,
     PyTorch's scaled_dot_product_attention; E beside torch.addmm at its
     two GEMM shapes, C and D beside torch._int_mm (cuBLASLt int8, s32
     out) at theirs; D, E and F at head dims 48, 80 and 128 (zero-padded
     to the SDPA core's 64 and 128, and its largest), 12 heads, 8 x 197
     tokens, bf16 and f32, within KERNEL_TOL, FLOAT_BF16_TOL and F32_TOL,
     and at head dims 192 and 256 (the SDPA core's wide form) with each
     kernel's and its plain version's time;
     print, on a line of their own and labelled as not measured, the times
     of A-J before their redesign (J's five launches as `kernel_cost.py
     region` traced them) and the SDPA core's exponential floor;
  4. small-input checks: the whole pipeline on the card against the same
     pipeline on the CPU (plain versions), f32, integer outputs equal, with
     a w8a ViT (kernels C, D) and a float one (kernel E);
  5. the ViT-B/16 w8a slice: YOLOv8-s at 640x640 + ViT-B/16 w8a, bf16,
     classify budget 2, batch 32, default thresholds, weights made from a
     seed (f32 init -> prequantize -> detect head ridge-fitted to planted
     covers, utils/densify.py), driven through
     BatchRunner.run_device_batches on cover scenes (~1.5 covers/frame,
     timed) and one crowded batch (~4.4/frame) that overflows the budget;
  6. the float ViT-B/8 slice: `make_runner(classify_budget=2)` with no
     engine dirs (YOLOv8-s + the default ViTSpec(): ViT-B/8, 785 tokens,
     float weights, fused attention; bf16, batch 32), seed-0 weights with
     the fitted head, driven as phase 5;
  7. make_runner on engine dirs written by the port's `save_engine`:
     phase 6's detector with a ViT-B/8 classify engine of each int8 mode
     (w8a: kernels C and D at 785 tokens; w8: C and E; dynamic, stored
     bf16: E and per-call int8 dense layers), one batch each;
  8. the `Engine` entry point on engine dirs written by the port's
     `save_engine`: a ViT-B/8 classify engine with attn_impl="pallas"
     (kernel F) on NCHW images in [-1, 1], held against the same model
     with F's plain version, and a two_stage engine of phase 5's weights
     on NCHW frames, equal to phase 5's pipeline;
  9. the bf16 detector's convolutions on the card: every conv of phase
     5's YOLOv8-s forward (batch 32, TF32 over bf16-valued operands) held
     against the same conv in f64 (CONV_TOL), and the card's stem against
     the same weights and frames on the CPU (STEM_DIFF_SHARE);
  10. torch.profiler over the ViT-B/16 w8a, ViT-B/8 float and ViT-B/8 w8a
     fused steps; E's device time a call split into LN, QKV GEMM, SDPA and
     proj GEMM; C's (12608 rows) and D's (T = 197 and 785, 64 crops),
     profiled a call at a time on phase 3's inputs, split into LN +
     quantize, each GEMM pass, the SDPA and the heads' quantize;
  11. kernels G-J, the public functions that no entry point of the package
     reaches, each held against its plain version and timed: G
     (`quant_dense_fused`) at 64 x 197 rows with the four ViT-B (K, N)
     pairs, bf16 and f32, bit for bit, its SiLU form at a detector 1x1
     shape within SILU_TOL, and through a `QuantDensePre` layer; H
     (`quant_mlp_fused`) on C's inputs within KERNEL_TOL; I
     (`efficient_nms_scan(multi_label=False)`) bit for bit against
     `nms_argmax_plain` on phase 5's decoded boxes and scores of 32
     frames, on A's dense tie inputs, at 1280 x 1280 (33,600 anchors) and
     2560 x 2560 (134,400, past the old kernel's cap), each timed (wrapper
     and kernel) beside its bound; J (`fused_b1b2`) on the stem output of
     phase 5's detector for its 32 frames with that detector's b1/b2
     weights, prepared once (`prepare_region`) outside the timed calls,
     within REGION_TOL of `region_b1b2_plain`, equal to the call that
     prepares them itself, timed as kernel (profiler) and wrapper (CUDA
     events) beside the port's cuDNN modules on the same input, with the
     share of its outputs that differ from the plain version's; its SiLU
     epilogue on every finite bf16 value bit for bit against `silu_bf16`
     but where its logistic flushes (`_silu_table`); J's five-launch form
     at YOLOv8-m's and -x's widths
     ((48, 96), (80, 160); 8 frames at 320 x 320, seeded weights) within
     REGION_TOL, timed beside the plain version; then one
     drive of the four on that data with the counts reset before and read
     after;
  12. the inspection service at full width (YOLOv8-s at 640x640, ViT-B/16
     w8a, bf16, the engine pair of phase 5's weights written by
     `save_engine`): a file server thread on 127.0.0.1 serves the phase's
     cover frames; `build_default_service(..., fused=True)` on the card
     behind `make_http_server` answers `POST /` requests of 32 URLs each
     (rows equal to the BatchRunner's called directly, detections found,
     A-D launched and none of E-J), then the same frames through
     fused=False (two `Engine`s under `infer.main`), one `/getImage`
     (VOC XML written, counter bumped), one `/getConfig` round trip, and
     `compare_fused_vs_host` held to count_match == images, mean IoU >
     0.85 and CLASS_AGREE_SHARE (on the frames whose kept set does not
     hinge on an f32 area tie, `_area_tie_frames`);
  13. the kept set on the card against the CPU, over phase 5's 32 fitted
     frames (weights and frames of phase 5, four calls of 8 frames on
     each side): an f32 pipeline's num_dets, stage-1 picks (the flat
     index class * n + anchor of each kept row, `_stage1_picks`),
     det_labels and final_valid equal frame for frame but where the
     frame's stage-2 NMS hinges on an f32 area tie (`_hinges_on_area_tie`),
     and its cls_labels but where a flipped row's top-two logit margin and
     the two sides' logit difference on it are both within KERNEL_TOL's
     atol, one int8 code (`_class_flips`); the main path's bf16 pipeline
     against its CPU copy, counted: each differing frame printed and
     attributed to an area tie, a classifier flip, the NMS decisions that
     differ between the two sides (a score or IoU across its threshold,
     by how much and whether within one ulp of the activation dtype; a
     swapped score or area order), or nothing found: a frame that
     nothing explains fails the run, and the card's stage-1 inputs
     (decoded boxes, sigmoid scores) must lie within STAGE1_BF16_BAR of
     the CPU copy's, a bar set by the CPU copy's own bf16 rounding noise
     against its f32 pipeline on the same frames plus the f32 legs'
     card-vs-CPU difference, which must itself lie within STAGE1_F32_CAP
     (2^-11) of the inputs' largest magnitude;
  14. the classifier's training on the card at ViT-B/8's full width, f32:
     (a) one optimizer step against the same step on the CPU
     (TRAIN_STEP_TOL), then the step at train_bs 1 timed (p50, p95,
     steps/s, max_memory_allocated); (b) the service's retrain: 32 seeded
     cover images ingested through POST /getImage fire retrain_fn (one
     epoch, 32 steps, validation), `weights/class_engine` is loaded by the
     port's Engine (F32_TOL against the trainer's logits) and served by
     make_runner on phase 6's detector (A, B and E launched; its bf16
     logits within FLOAT_BF16_TOL's elementwise bar of the trainer's),
     with the retrain's wall seconds;
  15. the detector's training on the card, YOLOv8-s at 640 x 640, f32,
     every trainer call with cuDNN's TF32 switch at PyTorch's default
     (on), so the trainer must hold f32 itself: (a) one optimizer step at
     batch 2 against the same step on the CPU (TRAIN_STEP_TOL; the
     largest differences printed); (b) the host's assembly of a batch of
     16 (mosaic, HSV, affine), then the step at batch 16 timed (p50, p95,
     steps/s, img/s, max_memory_allocated) and profiled (busy share);
     (c) `yolo_retrain` on 64 seeded .bmp street frames with VOC XML,
     resuming from phase 5's fitted detector (mAP50 and mAP50-95 before
     and after, wall seconds; kernel A launched in validation and none
     of B-J), its engine loaded by the port's Engine and served by
     make_runner with phase 5's ViT-B/16 w8a classify engine on phase 5's
     frames (A-D launched).
Each path of phases 5-8, 11, 12, 14 and 15 is driven with every launch count
set to 0 just before it and read just after: its kernels must have
launched, and the kernels of the other paths must not have.  Outputs must be finite,
detections found and the overflow ladder taken.  The line before the last
holds the kernels' JSON; the last line is the device JSON.  Nothing of JAX
is imported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
# full JSON report and profiler table
OUT_DIR = os.environ.get("CHIP_SMOKE_OUT", os.path.join(HERE, "chip_smoke_out"))
BATCHES = 4                                    # timed frame batches
# engine dirs the run writes (inside the ignored chip_smoke_out/, deleted
# after each phase)
ENGINE_DIR = os.path.join(HERE, "chip_smoke_out", "engines")

# the kernels' times before their redesign (PERF.md's kernel table;
# NVIDIA H100 80GB HBM3, 700.00 W): E and F on mma.sync, C, D, G and H on
# the mma.sync int8 GEMM (D's SDPA already on wgmma), A and B as an argmax
# over the whole pool a pick (wrapper times on the dense inputs); printed
# for reference beside this run's, never as a measurement of it
PREV_MS = {"quant_mlp_ln": 0.741, "attn_block_i8": 0.462,
           "attn_block_i8_t785": 2.066, "attn_block": 3.478,
           "flash_attention": 2.421, "quant_dense": 0.345,
           "quant_mlp": 0.737, "nms_argmax_ml": 0.744, "mask_scan": 0.173,
           "nms_argmax": 0.594, "fused_b1b2": 2.322}
# kernel J before its redesign, traced on phase 11's data by `kernel_cost.py
# region` (PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W): the device us of
# each of its five conv launches, of the ten weight copies and ten
# relayouts a call, the wrapper's CUDA-event ms and its host ms a call
PREV_J_TRACE = {"launch_us": [678.30, 230.21, 198.08, 215.20, 288.05],
                "weight_copies_us": 18.34, "weight_relayouts_us": 15.64,
                "device_us": 1643.82, "events_ms": 2.161, "host_ms": 0.619}
# special-function (ex2) lanes of an H100 SM, and its SMs
SFU_PER_SM, SMS = 16, 132

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
# E and F with bf16 activations round at the plain version's points, but
# their f32 sums run in another order, so a value at a rounding midpoint
# can go to its other bf16 neighbour: an output by one ulp (2^-7 of it),
# and one element of P (ulp 2^-8 in [0.5, 1)) moves a whole row of the
# head's output by 2^-8 |v|, its projection by 2^-8 |v . W| (|v . W| <= 2
# on these inputs): atol 2^-7.  Such flips touch few elements, so the mean
# error stays below 2^-9 of the mean |output|, and the kernel is as close
# to the same function in f32 as the plain version is (mean error at most
# 1.1x the plain version's); a systematic fault (a key tile left unmasked,
# a wrong scale) moves every element and fails both.
FLOAT_BF16_TOL = {"atol": 2.0 ** -7, "rtol": 2.0 ** -7,
                  "mean_rel": 2.0 ** -9, "f32_ratio": 1.1}
# E and F with f32 activations: the same float products, summed in another
# order (GEMM tiles, two-pass softmax sums) than cuBLAS and torch's
# reductions, on unit-size outputs: a few f32 ulps of the 768-term sums
F32_TOL = {"atol": 1e-4, "rtol": 1e-4}
# a detector conv under TF32 over bf16-valued operands against the same
# conv in f64, as a share of sum |w x|: exact products summed in f32 stay
# near 2^-24 of it; operands rounded to TF32's 10-bit mantissa after a
# transform (Winograd, FFT) would reach 2^-11 / sqrt(fan-in), >= 2^-17
CONV_TOL = 2.0 ** -17
# the card's bf16 stem (b0, b1) against the CPU's: f32 sums in another
# order and another exp in SiLU move the f32 value by a few f32 ulps, so an
# output lands on the other bf16 neighbour where that value sits within a
# few 2^-24 of a midpoint (a few 2^-16 of the outputs, more in b1, which
# inherits b0's); operands rounded to TF32 would move far more
STEM_DIFF_SHARE = 1e-3

# G with SiLU: the card's expf against torch.sigmoid, a few f32 ulps of the
# logistic, which the product with y carries over: 8 ulps at f32, and at
# bf16 the one rounding may land on the other neighbour (one ulp, 2^-7)
SILU_TOL = {"float32": {"atol": 1e-7, "rtol": 2.0 ** -20},
            "bfloat16": {"atol": 1e-7, "rtol": 2.0 ** -7}}
# J against its plain version: both round at the same five points, and
# their f32 sums run in another order (mma tiles against cuDNN), so single
# outputs land one bf16 ulp apart and a few flips pass through three
# stacked stages: |d| <= 0.05 std(plain), the JAX package's own bar for
# its kernel (tests/test_fused_region.py), plus one bf16 ulp of the output
# (2^-7 |plain|): on a detector's own data the outputs reach many times
# their std (0.024 here, outputs up to 0.4), and one ulp of such an output
# is more than 0.05 std.  And mean |d| <= 0.005 std: a tenth of the first
# bar, which a wrong tap, padding side or channel order (every output off
# by a share of std) cannot meet
REGION_TOL = {"max_std": 0.05, "ulp": 2.0 ** -7, "mean_std": 0.005}
# compare_fused_vs_host on a random ViT head: tests/test_full_lifecycle.py
# asks class_agree == detections on trained weights.  Here the classifier
# is random, so its five logits sit close together, and the two routes
# feed it crops of boxes that differ in the last float bits (bf16 against
# f32 activations upstream would move them more; both run f32 here): a
# matched pair may disagree where the top two logits are within the
# noise of the W8A8 quantization.  Held: at least this share of the
# matched pairs agree; every disagreeing pair's logit margin is printed
# beside the logits' spread.
CLASS_AGREE_SHARE = 0.8

# the wrapper of each kernel row of the kernels JSON, and the path whose
# launches it reports
ROW_WRAPPER = {"nms_argmax_ml": ("efficient_nms_scan", "vit_b16_w8a"),
               "mask_scan": ("area_sorted_nms", "vit_b16_w8a"),
               "mask_scan_alone": ("area_sorted_nms", "vit_b16_w8a"),
               "quant_mlp_ln": ("quant_mlp_ln_fused", "vit_b16_w8a"),
               "attn_block_i8": ("fused_attention_block_i8", "vit_b16_w8a"),
               "attn_block_i8_t785": ("fused_attention_block_i8",
                                      "vit_b8_w8a"),
               "attn_block": ("fused_attention_block", "vit_b8_float"),
               "flash_attention": ("flash_attention", "engine_classify"),
               "quant_dense": ("quant_dense_fused", "public_ops"),
               "quant_mlp": ("quant_mlp_fused", "public_ops"),
               "nms_argmax": ("nms_single_label", "public_ops"),
               "fused_b1b2": ("fused_b1b2", "public_ops")}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def _exp_floor_ms(scores: int) -> float:
    """The least time of the SDPA core's exponentials: two ex2 a score (one
    a pass) on the special-function lanes at the card's top SM clock."""
    return 2 * scores / (SFU_PER_SM * SMS * _max_sm_clock_hz()) * 1e3


def _ptxas_summary(log: str) -> list[str]:
    """One line a kernel from nvcc's -Xptxas -v output: its name, registers,
    stack, spills and static shared memory."""
    import re

    def short(mangled: str) -> str:
        # the length-prefixed name ending in _kernel, its integer template
        # arguments, and the activation type where the arguments name one
        for m in re.finditer(r"\d+", mangled):
            n, st = int(m.group()), m.end()
            cand = mangled[st:st + n]
            if cand.endswith("_kernel") and cand.isidentifier():
                rest = mangled[st + n:mangled.find("Ev", st + n)]
                args = re.findall(r"L[ib](\d+)E", rest)
                if "bfloat16" in rest:
                    args.insert(0, "bf16")
                elif rest.startswith("If"):
                    args.insert(0, "f32")
                elif rest.startswith("Ia"):
                    args.insert(0, "i8")
                return f"{cand}<{', '.join(args)}>" if args else cand
        return mangled

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = short(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name is not None:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return out


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


def _int_mm_ms(torch, m: int, shapes: dict, reps: int = 10) -> dict:
    """torch._int_mm (cuBLASLt int8, s32 out) timed at a kernel's GEMM
    shapes {name: (k, n)} on m rows, the weight K-major as the kernels
    read it: a yardstick the port never calls."""
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for name, (k, n) in shapes.items():
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                          generator=g)
        w_t = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                            device="cuda", generator=g)
        out[name] = _time_ms(lambda: torch._int_mm(a, w_t.t()), reps)
    return out


def _close(torch, name, got, ref, tol, f32_ref=None, stats=None) -> float:
    """max |got - ref|, and into `stats` (a dict) the mean error over the
    mean |ref| and the error ratio against f32; raises where |got - ref| > atol + rtol |ref|, where
    got is not finite, where mean |got - ref| > mean_rel mean |ref| (if tol
    has mean_rel), or where mean |got - f32_ref| > f32_ratio mean |ref -
    f32_ref| (if f32_ref, the same function in f32, is given)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    lim = tol["atol"] + tol["rtol"] * ref.abs()
    mean_rel = float(err.mean() / ref.abs().mean())
    ratio = 0.0
    if f32_ref is not None:
        ratio = float((got - f32_ref).abs().mean()
                      / (ref - f32_ref).abs().mean())
    if not bool(torch.isfinite(got).all()) or bool((err > lim).any()) \
            or mean_rel > tol.get("mean_rel", float("inf")) \
            or ratio > tol.get("f32_ratio", float("inf")):
        raise AssertionError(f"kernel {name} != plain: max err "
                             f"{float(err.max())}, {int((err > lim).sum())} "
                             f"beyond {tol}, mean err / mean |plain| "
                             f"{mean_rel}, error against f32 / plain's "
                             f"{ratio}")
    if stats is not None:
        stats[name] = {"mean_rel": mean_rel, "f32_ratio": ratio}
    return float(err.max())


def _path_launches(ops, path: str, must, must_not) -> dict:
    """The launch counts of one path, read just after it ran (the caller
    reset them just before): each kernel of `must` launched, none of
    `must_not`."""
    counts = ops.launch_counts()
    if path != "public_ops":           # G-J lie on no entry point's path
        must_not = tuple(must_not) + G_J
    for name in must:
        if counts[name] == 0:
            raise AssertionError(f"{path}: kernel wrapper {name} never "
                                 f"launched")
    for name in must_not:
        if counts[name] != 0:
            raise AssertionError(f"{path}: kernel wrapper {name} launched "
                                 f"{counts[name]} times off its path")
    return counts


A_B = ("efficient_nms_scan", "area_sorted_nms")
C_D = ("quant_mlp_ln_fused", "fused_attention_block_i8")
E_F = ("fused_attention_block", "flash_attention")
G_J = ("quant_dense_fused", "quant_mlp_fused", "nms_single_label",
       "fused_b1b2")


def _nms_inputs(torch, b, n, c, seed, side=640):
    """Dense clustered boxes on a half-pixel grid, scores quantized to
    1/16 (many exact ties), plus planted pairs at IoU exactly .65 and .45
    (inter/union = 13/20 and 9/20) with equal scores.  side 640: boxes
    about the middle of a 640 x 640 input; larger: spread over it."""
    g = torch.Generator().manual_seed(seed)
    ctr = torch.randn(b, n, 2, generator=g) * 80 + 320
    if side != 640:
        ctr = torch.rand(b, n, 2, generator=g) * (side - 80) + 40
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


def _crowd_inputs(torch, b, n, c, seed, clusters=12):
    """Tight clusters of near-equal boxes with every score above 0.25: one
    box a cluster and class is kept, so kernel A decides every one of its
    n * c candidates, window after window and chunk after chunk, before
    its pool runs out."""
    g = torch.Generator().manual_seed(seed)
    centers = torch.rand(b, clusters, 2, generator=g) * 440 + 100
    pick = torch.randint(0, clusters, (b, n), generator=g)
    ctr = torch.gather(centers, 1, pick[..., None].expand(b, n, 2)) \
        + torch.randn(b, n, 2, generator=g)
    wh = 60 + torch.randn(b, n, 2, generator=g)
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    return boxes, torch.rand(b, n, c, generator=g) * 0.74 + 0.26


def _kernel_ms(torch, fn, kernel: str) -> float:
    """The device ms a launch of `kernel` (a regex on the kernel names),
    torch.profiler over three calls of fn."""
    return profile_parts(torch, fn, {"k": kernel})["k"]


def _time_a(torch, ops, boxes, scores, label: str) -> dict:
    """Kernel A on (B, N, 4) + (B, N, C): bit for bit against its plain
    version, its wrapper timed (CUDA events), its kernel alone (profiler),
    the plain version, and the bound: the larger of the bytes the function
    must move (boxes and scores read once, the outputs written once, and
    the keys of an image's candidates past one window of shared memory
    written to the pool and read back once) and the operations this data
    needs (a compare a score; an IoU, about 14 operations, for each
    candidate, which one kept box at least must test, and for each pair of
    kept boxes of a class).  The picks of an image are dependent:
    `dependent_picks` is the longest chain, the latency floor beside the
    bound."""
    from yolov8_vit_tpu_torch.ops.nms import NMS_WINDOW, nms_argmax_ml_plain
    got = ops.efficient_nms_scan(boxes, scores)
    ref = nms_argmax_ml_plain(boxes, scores, 0.65, 0.25, 100)
    for name, x, r in zip(("num_dets", "boxes", "scores", "labels"), got,
                          ref):
        if not torch.equal(x, r):
            raise AssertionError(f"kernel A != plain on {name} ({label}): "
                                 f"{int((x != r).sum())} entries differ")
    b = scores.shape[0]
    cand = (scores > 0.25).sum(dim=(1, 2))

    def call():
        return ops.efficient_nms_scan(boxes, scores)

    spill = int((cand - NMS_WINDOW).clamp_min(0).sum())
    nbytes = (boxes.numel() + scores.numel()) * 4 + b * 100 * 6 * 4 + b * 4 \
        + spill * 8 * 2
    labels = got[3].long()
    per_class = torch.stack([(labels == k).sum(dim=1)
                             for k in range(scores.shape[2])])
    pairs = int((per_class * (per_class - 1) // 2).sum())
    op_ms = (scores.numel() + 14 * (int(cand.sum()) + pairs)) \
        / PEAK_F32_FLOPS * 1e3
    bound, by = _bound_ms(nbytes, op_ms)
    return {"picks": int(got[0].sum()),
            "dependent_picks": int(got[0].max()),
            "candidates": int(cand.sum()),
            "ms": _time_ms(call, 20),
            "kernel_ms": _kernel_ms(torch, call, r"greedy_nms_kernel<0>"),
            "plain_ms": _time_ms(lambda: nms_argmax_ml_plain(
                boxes, scores, 0.65, 0.25, 100), 2),
            "bound_ms": bound, "bound_by": by}


def _time_b(torch, ops, boxes, scores, valid, label: str) -> dict:
    """Kernel B on (B, T, 4) boxes, (B, T) scores and valid: bit for bit
    against its plain version; the wrapper (CUDA events), its kernel alone
    (profiler) and the plain version timed."""
    from yolov8_vit_tpu_torch.ops.nms import mask_priority, mask_scan_plain
    keep = ops.area_sorted_nms(boxes, scores, valid)
    pri = mask_priority(boxes, scores, valid, 0.35)
    keep_ref = mask_scan_plain(boxes, pri, 0.45)
    if not torch.equal(keep, keep_ref):
        raise AssertionError(f"kernel B != plain ({label}): "
                             f"{int((keep != keep_ref).sum())} rows differ")

    def call():
        return ops.area_sorted_nms(boxes, scores, valid)

    b, t = scores.shape
    bound, by = _bound_ms(b * t * (4 * 4 + 4 + 1 + 1), 0.0)
    return {"kept": int(keep.sum()), "ms": _time_ms(call, 50),
            "kernel_ms": _kernel_ms(torch, call, r"greedy_nms_kernel<1>"),
            "plain_ms": _time_ms(lambda: mask_scan_plain(boxes, pri, 0.45),
                                 2),
            "bound_ms": bound, "bound_by": by}


def _time_i(torch, ops, boxes, scores, label: str) -> dict:
    """Kernel I (`efficient_nms_scan(multi_label=False)`) on (B, N, 4) +
    (B, N, C): bit for bit against its plain version, its wrapper timed
    (CUDA events), its kernel alone (profiler), the plain version, and the
    bound: the larger of the bytes the function must move (boxes and
    scores read once, the outputs written once, the keys of an image's
    candidates past one window written to the pool and read back once)
    and the operations this data needs (a compare a score; a shifted IoU,
    about 22 operations, for each candidate, which one kept box at least
    must test, and for each pair of kept boxes, all classes: the bands
    keep them apart only through the IoU)."""
    from yolov8_vit_tpu_torch.ops.nms import (NMS_WINDOW, nms_argmax_plain,
                                              single_label_candidates)
    got = ops.efficient_nms_scan(boxes, scores, multi_label=False)
    cand = single_label_candidates(boxes, scores)
    ref = nms_argmax_plain(boxes, *cand, 0.65, 0.25, 100)
    for name, x, r in zip(("num_dets", "boxes", "scores", "labels"), got,
                          ref):
        _equal(torch, f"I ({label}) {name}", x, r)

    def call():
        return ops.efficient_nms_scan(boxes, scores, multi_label=False)

    b = scores.shape[0]
    n_cand = (cand[0] > 0.25).sum(dim=1)
    kept = got[0].long()
    spill = int((n_cand - NMS_WINDOW).clamp_min(0).sum())
    nbytes = (boxes.numel() + scores.numel()) * 4 + b * 100 * 6 * 4 \
        + b * 4 + spill * 8 * 2
    op_ms = (scores.numel() + 22 * (int(n_cand.sum()) + int(
        (kept * (kept - 1) // 2).sum()))) / PEAK_F32_FLOPS * 1e3
    bound, by = _bound_ms(nbytes, op_ms)
    return {"anchors": boxes.shape[1], "picks": int(kept.sum()),
            "candidates": int(n_cand.sum()),
            "ms": _time_ms(call, 20),
            "kernel_ms": _kernel_ms(torch, call, r"greedy_nms_kernel<2>"),
            "plain_ms": _time_ms(lambda: nms_argmax_plain(
                boxes, *cand, 0.65, 0.25, 100), 2),
            "bound_ms": bound, "bound_by": by}


def check_kernels(torch, ops, mlp_rows: int,
                  crops: int) -> tuple[list[dict], dict]:
    """Phase 3 at the ViT-B/16 path's shapes: A, B, C, D.  Returns the
    kernel rows and, for phase 10's profiler, a call of C and of D on
    their inputs here."""
    from yolov8_vit_tpu_torch.ops.attention import attn_block_i8_plain
    from yolov8_vit_tpu_torch.ops.quant import (quant_mlp_ln_plain,
                                                quantize_weight)
    dev = torch.device("cuda")
    rows = []

    # ---- A: stage-1 NMS, (32, 8400, 4) + (32, 8400, 5) ----------------
    by_input = {}
    for label, inp in (("dense", _nms_inputs(torch, 32, 8400, 5, 0)),
                       ("1280", _nms_inputs(torch, 32, 33600, 5, 3,
                                            side=1280)),
                       ("crowd", _crowd_inputs(torch, 32, 8400, 5, 4))):
        boxes, scores = (t.to(dev) for t in inp)
        by_input[label] = _time_a(torch, ops, boxes, scores, label)
    a = by_input["dense"]
    rows.append(dict(name="nms_argmax_ml", route="cuda",
                     source="yolov8_vit_tpu_torch/csrc/nms.cu",
                     replaces="yolov8_vit_tpu/ops/nms.py:147",
                     max_abs_err=0.0, ms=a["ms"], plain_ms=a["plain_ms"],
                     bound_ms=a["bound_ms"], bound_by=a["bound_by"],
                     library_ms=None, kernel_ms=a["kernel_ms"],
                     by_input=by_input))

    # ---- B: stage-2 area NMS, (32, 100) rows ---------------------------
    bb, ss = (t.to(dev) for t in _nms_inputs(torch, 32, 100, 1, 1))
    ss = ss[..., 0] + 0.3
    valid = torch.rand(32, 100, device=dev) > 0.1
    b_rep = _time_b(torch, ops, bb, ss, valid, "dense")
    for name, ms in (("mask_scan", b_rep["ms"]),
                     ("mask_scan_alone", b_rep["kernel_ms"])):
        rows.append(dict(name=name, route="cuda",
                         source="yolov8_vit_tpu_torch/csrc/nms.cu",
                         replaces="yolov8_vit_tpu/ops/nms.py:294",
                         max_abs_err=0.0, ms=ms, plain_ms=b_rep["plain_ms"],
                         bound_ms=b_rep["bound_ms"],
                         bound_by=b_rep["bound_by"], library_ms=None,
                         by_input={"dense": b_rep}))

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

    x = torch.randn(mlp_rows, d, generator=g).to(dev, torch.bfloat16)
    lns, lnb = ln()
    w1, s1, b1 = wq(d, hid)
    w2, s2, b2 = wq(hid, d)
    args = (x, lns, lnb, w1, s1, b1, w2, s2, b2)
    # the transposed int8 weights made once, as models/vit.py passes them
    wt = dict(w1_t=w1.t().contiguous(), w2_t=w2.t().contiguous())
    err = _close(torch, "C", ops.quant_mlp_ln_fused(*args, **wt),
                 quant_mlp_ln_plain(*args), KERNEL_TOL)
    if not torch.equal(ops.quant_mlp_ln_fused(*args, **wt),
                       ops.quant_mlp_ln_fused(*args)):
        raise AssertionError("kernel C: transposing per call and once "
                             "differ")
    k_ms = _time_ms(lambda: ops.quant_mlp_ln_fused(*args, **wt), 20)
    c_percall_ms = _time_ms(lambda: ops.quant_mlp_ln_fused(*args), 20)
    p_ms = _time_ms(lambda: quant_mlp_ln_plain(*args), 3)
    ops_c = 2 * 2 * mlp_rows * d * hid
    nbytes = 2 * mlp_rows * d * 2 + 2 * d * hid + 4 * (3 * d + 2 * hid)
    bound, by = _bound_ms(nbytes, ops_c / PEAK_INT8_OPS * 1e3)
    rows.append(dict(name="quant_mlp_ln", route="cuda",
                     source="yolov8_vit_tpu_torch/csrc/quant_mlp.cu",
                     replaces="yolov8_vit_tpu/ops/quant.py:240",
                     max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                     bound_by=by, library_ms=None,
                     int_mm_ms=_int_mm_ms(torch, mlp_rows, {
                         "fc1": (d, hid), "fc2": (hid, d)}),
                     ms_transposing_per_call=c_percall_ms))
    c_args, c_wt = args, wt

    xa = torch.randn(crops, t, d, generator=g).to(dev, torch.bfloat16)
    lns, lnb = ln()
    wqkv, sq, bq = wq(d, 3 * d)
    wp, sp, bp = wq(d, d)
    args = (xa, lns, lnb, wqkv, sq, bq, wp, sp, bp)
    wt = dict(heads=12, wqkv_t=wqkv.t().contiguous(),
              wproj_t=wp.t().contiguous())
    err = _close(torch, "D", ops.fused_attention_block_i8(*args, **wt),
                 attn_block_i8_plain(*args, heads=12), KERNEL_TOL)
    if not torch.equal(ops.fused_attention_block_i8(*args, **wt),
                       ops.fused_attention_block_i8(*args, heads=12)):
        raise AssertionError("kernel D: transposing per call and once "
                             "differ")
    k_ms = _time_ms(lambda: ops.fused_attention_block_i8(*args, **wt), 20)
    d_percall_ms = _time_ms(lambda: ops.fused_attention_block_i8(
        *args, heads=12), 20)
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
                     bound_by=by, library_ms=None,
                     int_mm_ms=_int_mm_ms(torch, m, {
                         "qkv": (d, 3 * d), "proj": (d, d)}),
                     ms_transposing_per_call=d_percall_ms))
    calls = {"quant_mlp_ln": lambda: ops.quant_mlp_ln_fused(*c_args, **c_wt),
             "attn_block_i8": lambda: ops.fused_attention_block_i8(*args,
                                                                   **wt)}
    return rows, calls


def check_attention_b8(torch, ops, crops: int, f32_crops: int):
    """D, E and F at ViT-B/8's 785 tokens and width 768: bf16 at `crops`
    (the main paths' 64 crops: batch 32 x budget 2) held within
    FLOAT_BF16_TOL (D within KERNEL_TOL: its int8 codes can flip at a .5
    boundary in any dtype) and timed; f32 at `f32_crops` held within
    F32_TOL (D within KERNEL_TOL).  Returns the kernel rows, the f32
    errors, the bf16 statistics of E and F, and a call of D at 785 tokens
    on its bf16 inputs here for phase 10's profiler."""
    from yolov8_vit_tpu_torch.ops.attention import (
        attn_block_i8_plain, flash_attention_plain,
        fused_attention_block_plain)
    from yolov8_vit_tpu_torch.ops.quant import quantize_weight
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    d, t, heads = 768, 785, 12
    hd = d // heads
    rows, f32_err, bf16_stats, calls = [], {}, {}, {}

    def ln():
        return ((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
                (0.1 * torch.randn(d, generator=g)).to(dev))

    def wq(fout):
        q, s_ = quantize_weight(torch.randn(d, fout, generator=g) * d ** -0.5)
        return q.to(dev), s_.to(dev), (0.02 * torch.randn(fout, generator=g)
                                       ).to(dev)

    def wf(fout, dt):
        return ((torch.randn(d, fout, generator=g) * d ** -0.5).to(dev, dt),
                (0.02 * torch.randn(fout, generator=g)).to(dev))

    def x_of(n, dt, scale=1.0):
        return (scale * torch.randn(n, t, d, generator=g)).to(dev, dt)

    sdpa_ops = lambda n: 4 * n * heads * t * t * hd       # noqa: E731
    m = crops * t
    bf16 = torch.bfloat16

    # ---- D at 785 tokens ------------------------------------------------
    w_d = (*ln(), *wq(3 * d), *wq(d))
    for n, dt in ((crops, bf16), (f32_crops, torch.float32)):
        args = (x_of(n, dt), *w_d)
        err = _close(torch, f"D@785 {dt}",
                     ops.fused_attention_block_i8(*args, heads=heads),
                     attn_block_i8_plain(*args, heads=heads), KERNEL_TOL)
        if dt == torch.float32:
            f32_err["attn_block_i8_t785"] = err
            continue
        k_ms = _time_ms(lambda: ops.fused_attention_block_i8(
            *args, heads=heads), 10)
        p_ms = _time_ms(lambda: attn_block_i8_plain(*args, heads=heads), 2)
        op_ms = (2 * m * d * 4 * d / PEAK_INT8_OPS
                 + sdpa_ops(crops) / PEAK_BF16_FLOPS) * 1e3
        bound, by = _bound_ms(2 * m * d * 2 + 4 * d * d + 4 * 8 * d, op_ms)
        rows.append(dict(name="attn_block_i8_t785", route="cuda",
                         source="yolov8_vit_tpu_torch/csrc/attention.cu",
                         replaces="yolov8_vit_tpu/ops/attention.py:162",
                         max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                         bound_ms=bound, bound_by=by, library_ms=None,
                         int_mm_ms=_int_mm_ms(torch, m, {
                             "qkv": (d, 3 * d), "proj": (d, d)})))
        calls["attn_block_i8_t785"] = \
            lambda a=args: ops.fused_attention_block_i8(*a, heads=heads)

    # ---- E --------------------------------------------------------------
    lns, lnb = ln()
    for n, dt in ((crops, bf16), (f32_crops, torch.float32)):
        (wqkv, bq), (wp, bp) = wf(3 * d, dt), wf(d, dt)
        # a residual stream of the size of the attention's output (~0.06),
        # so that a fault in the SDPA shows in the sum
        args = (x_of(n, dt, 0.05), lns, lnb, wqkv, bq, wp, bp)
        tol, f32_ref = F32_TOL, None
        if dt == bf16:
            tol = FLOAT_BF16_TOL
            f32_ref = fused_attention_block_plain(
                *(a.float() for a in args), heads=heads)
        err = _close(torch, f"E {dt}",
                     ops.fused_attention_block(*args, heads=heads),
                     fused_attention_block_plain(*args, heads=heads), tol,
                     f32_ref, bf16_stats)
        del f32_ref
        if dt == torch.float32:
            f32_err["attn_block"] = err
            continue
        k_ms = _time_ms(lambda: ops.fused_attention_block(*args, heads=heads),
                        10)
        p_ms = _time_ms(lambda: fused_attention_block_plain(
            *args, heads=heads), 2)
        # a yardstick for E's two GEMMs: one torch.addmm (cuBLAS) at each
        # shape, bias in bf16, no residual
        h = torch.randn(m, d, generator=torch.Generator().manual_seed(6)
                        ).to(dev, dt)
        lib_gemm = {name: _time_ms(
            lambda b16=b_.to(dt), w=w_: torch.addmm(b16, h, w), 10)
            for name, w_, b_ in (("qkv", wqkv, bq), ("proj", wp, bp))}
        del h
        op_ms = (8 * m * d * d + sdpa_ops(crops)) / PEAK_BF16_FLOPS * 1e3
        bound, by = _bound_ms(2 * m * d * 2 + 2 * 4 * d * d + 4 * 6 * d,
                              op_ms)
        rows.append(dict(name="attn_block", route="cuda",
                         source="yolov8_vit_tpu_torch/csrc/attention.cu",
                         replaces="yolov8_vit_tpu/ops/attention.py:135",
                         max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                         bound_ms=bound, bound_by=by, library_ms=None,
                         gemm_library_ms=lib_gemm,
                         exp_floor_ms=_exp_floor_ms(crops * heads * t * t)))

    # ---- F --------------------------------------------------------------
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for n, dt in ((crops, bf16), (f32_crops, torch.float32)):
        q, k, v = (torch.randn(n, t, heads, hd, generator=g).to(dev, dt)
                   for _ in range(3))
        tol, f32_ref = F32_TOL, None
        if dt == bf16:
            tol = FLOAT_BF16_TOL
            f32_ref = flash_attention_plain(q.float(), k.float(), v.float())
        err = _close(torch, f"F {dt}", ops.flash_attention(q, k, v),
                     flash_attention_plain(q, k, v), tol, f32_ref,
                     bf16_stats)
        del f32_ref
        if dt == torch.float32:
            f32_err["flash_attention"] = err
            continue
        k_ms = _time_ms(lambda: ops.flash_attention(q, k, v), 10)
        p_ms = _time_ms(lambda: flash_attention_plain(q, k, v), 2)
        qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
        lib_ms = _time_ms(lambda: sdpa(qh, kh, vh), 10)
        bound, by = _bound_ms(4 * n * t * heads * hd * 2,
                              sdpa_ops(n) / PEAK_BF16_FLOPS * 1e3)
        rows.append(dict(name="flash_attention", route="cuda",
                         source="yolov8_vit_tpu_torch/csrc/attention.cu",
                         replaces="yolov8_vit_tpu/ops/attention.py:32",
                         max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                         bound_ms=bound, bound_by=by, library_ms=lib_ms,
                         exp_floor_ms=_exp_floor_ms(n * heads * t * t)))
    return rows, f32_err, bf16_stats, calls


# head dims the SDPA core does not run (48, 80: zero-padded to 64 and 128),
# its largest fast one (128) and two of its wide form (192, 256), 12 heads
# each
PAD_HEAD_DIMS = (48, 80, 128, 192, 256)
WIDE_HEAD_DIMS = (192, 256)


def check_head_dims(torch, ops, crops: int = 8, t: int = 197) -> dict:
    """Phase 3: D, E and F at head dims 48, 80, 128, 192 and 256 (12
    heads, `crops` x `t` tokens), bf16 and f32, against their plain
    versions: D within KERNEL_TOL, E and F within FLOAT_BF16_TOL at bf16
    (with the f32 function) and F32_TOL at f32.  Returns the max errors
    and, at the wide form's head dims (WIDE_HEAD_DIMS), each kernel's and
    its plain version's time (CUDA events)."""
    from yolov8_vit_tpu_torch.ops.attention import (
        attn_block_i8_plain, flash_attention_plain,
        fused_attention_block_plain)
    from yolov8_vit_tpu_torch.ops.quant import quantize_weight
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(12)
    heads, out, wide = 12, {}, {}

    def timed(name, hd, fn, plain, lib=None):
        """At the wide form's head dims: the kernel's and the plain
        version's time, `lib`'s (the one PyTorch call that computes the
        same function, where there is one: SDPA for F), and the bound: x
        (and out) read / written once and the weights read once in the
        activation dtype (int8 for D); the QKV and proj products (8 m d^2;
        int8 for D) and the attention's (4 crops heads t^2 hd) at the
        card's peak rates."""
        if hd not in WIDE_HEAD_DIMS:
            return
        es = 2 if "bfloat16" in name else 4
        peak = PEAK_BF16_FLOPS if es == 2 else PEAK_F32_FLOPS
        d, m = heads * hd, crops * t
        op_ms = 4 * crops * heads * t * t * hd / peak * 1e3
        nbytes = 4 * m * d * es
        if name[0] in "DE":
            gemm_peak = PEAK_INT8_OPS if name[0] == "D" else peak
            op_ms += 8 * m * d * d / gemm_peak * 1e3
            nbytes = 2 * m * d * es + 4 * d * d * (1 if name[0] == "D" else es)
        b_ms, by = _bound_ms(nbytes, op_ms)
        wide[name] = {"ms": _time_ms(fn, 3), "plain_ms": _time_ms(plain, 3),
                      "library_ms": None if lib is None else _time_ms(lib, 3),
                      "bound_ms": b_ms, "bound_by": by}

    for hd in PAD_HEAD_DIMS:
        d = heads * hd
        ln = ((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
              (0.1 * torch.randn(d, generator=g)).to(dev))

        def wq(fout):
            q, s_ = quantize_weight(torch.randn(d, fout, generator=g)
                                    * d ** -0.5)
            return q.to(dev), s_.to(dev), (0.02 * torch.randn(
                fout, generator=g)).to(dev)

        w_d = (*wq(3 * d), *wq(d))
        for dt in (torch.bfloat16, torch.float32):
            name = f"hd{hd} {str(dt)[6:]}"
            f32 = dt == torch.float32
            x = torch.randn(crops, t, d, generator=g).to(dev, dt)
            args = (x, *ln, *w_d)
            out[f"D {name}"] = _close(
                torch, f"D {name}", ops.fused_attention_block_i8(
                    *args, heads=heads),
                attn_block_i8_plain(*args, heads=heads), KERNEL_TOL)
            timed(f"D {name}", hd,
                  lambda: ops.fused_attention_block_i8(*args, heads=heads),
                  lambda: attn_block_i8_plain(*args, heads=heads))
            w = [(torch.randn(d, n, generator=g) * d ** -0.5).to(dev, dt)
                 for n in (3 * d, d)]
            b = [(0.02 * torch.randn(n, generator=g)).to(dev)
                 for n in (3 * d, d)]
            args = ((0.05 * torch.randn(crops, t, d, generator=g)).to(dev, dt),
                    *ln, w[0], b[0], w[1], b[1])
            out[f"E {name}"] = _close(
                torch, f"E {name}", ops.fused_attention_block(
                    *args, heads=heads),
                fused_attention_block_plain(*args, heads=heads),
                F32_TOL if f32 else FLOAT_BF16_TOL,
                None if f32 else fused_attention_block_plain(
                    *(a.float() for a in args), heads=heads))
            timed(f"E {name}", hd,
                  lambda: ops.fused_attention_block(*args, heads=heads),
                  lambda: fused_attention_block_plain(*args, heads=heads))
            q, k, v = (torch.randn(crops, t, heads, hd, generator=g)
                       .to(dev, dt) for _ in range(3))
            out[f"F {name}"] = _close(
                torch, f"F {name}", ops.flash_attention(q, k, v),
                flash_attention_plain(q, k, v),
                F32_TOL if f32 else FLOAT_BF16_TOL,
                None if f32 else flash_attention_plain(
                    q.float(), k.float(), v.float()))
            qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
            timed(f"F {name}", hd, lambda: ops.flash_attention(q, k, v),
                  lambda: flash_attention_plain(q, k, v),
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      qh, kh, vh))
    return out, wide


def small_input_check(torch, quant: str) -> dict:
    """The tiny test configuration (dense thresholds, densified head), f32:
    the card's pipeline against the CPU's on the same weights and frames,
    with a ViT of `quant` ("w8a": kernels C and D; "none": kernel E)."""
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
                   backbone_classes=40, quant=quant, attn_impl="fused")
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


BATCH, BUDGET = 32, 2


def _fit_head(pipe, tree: dict, rng) -> dict:
    """Content-responsive head at production density (~1.5 covers/frame):
    ridge-fit on 16 fit scenes; timed scenes are fresh draws."""
    from yolov8_vit_tpu_torch.utils.densify import (fit_detect_head,
                                                    make_cover_scenes)
    from yolov8_vit_tpu_torch.weights import load_pipeline_tree
    fit_imgs, fit_covers = make_cover_scenes(rng, 16, (640, 640), lam=1.5)
    tree = fit_detect_head(tree, pipe, fit_imgs, fit_covers)
    load_pipeline_tree(pipe, tree)
    return tree


def drive(torch, ops, runner, rng, batches: int, path: str, must,
          must_not) -> dict:
    """Run `batches` cover-scene batches (timed) and one crowded batch
    through runner.run_device_batches with the launch counts reset just
    before and read just after; check the outputs."""
    import numpy as np
    from yolov8_vit_tpu_torch.utils.densify import make_cover_scenes
    batch = runner.max_batch
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
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    prof: dict = {}
    t0 = time.perf_counter()
    recs = runner.run_device_batches(pools, profile=prof)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    dense_prof: dict = {}
    recs += runner.run_device_batches([crowded], profile=dense_prof)
    torch.cuda.synchronize()
    launches = _path_launches(ops, path, must, must_not)

    step_ms = _time_ms(lambda: runner._fn(pools[0]), 5)
    flat = [r for rs in recs for r in rs]
    for r in flat:
        for k in ("boxes", "det_scores", "cls_scores"):
            if not np.isfinite(r[k]).all():
                raise AssertionError(f"{path}: non-finite {k}")
        v = r["final_valid"]
        if (r["cls_labels"][v] < 0).any():
            raise AssertionError(f"{path}: a kept detection left "
                                 f"unclassified")
    prod = flat[:batch * batches]
    if sum(r["num_dets"] for r in flat) == 0:
        raise AssertionError(f"{path}: no detections")
    if dense_prof.get("overflow_dets", 0) == 0:
        raise AssertionError(f"{path}: the overflow ladder never ran")
    return {"launches": launches, "img_s": batch * batches / dt,
            "wall_ms_per_batch": dt / batches * 1e3,
            "fused_step_ms": step_ms,
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
            "frames": pools[0]}


def b16_w8a_slice(torch, ops, batches: int) -> tuple[dict, object, dict]:
    """Phase 5.  Returns (report, runner, fitted tree)."""
    import numpy as np
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner
    from yolov8_vit_tpu_torch.weights import init_tree, load_pipeline_tree
    spec = ViTSpec(patch=16, quant="w8a", attn_impl="fused")
    pipe = TwoStagePipeline(det_cfg=DetectConfig(variant="s"), vit_spec=spec,
                            classify_budget=BUDGET, dtype=torch.bfloat16,
                            device="cuda")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    tree = init_tree(pipe, 0)
    load_pipeline_tree(pipe, tree)
    tree = _fit_head(pipe, tree, rng)
    init_s = time.perf_counter() - t0
    runner = BatchRunner(pipe, max_batch=BATCH)
    out = drive(torch, ops, runner, rng, batches, "vit_b16_w8a",
                must=A_B + C_D, must_not=E_F)
    return dict(out, init_fit_s=init_s), runner, tree


def b8_float_slice(torch, ops, batches: int) -> tuple[dict, object, dict]:
    """Phase 6: the serving default, make_runner() without engine dirs."""
    import numpy as np
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.serve.batch_runner import make_runner
    from yolov8_vit_tpu_torch.weights import init_tree
    t0 = time.perf_counter()
    runner = make_runner(classify_budget=BUDGET, device="cuda")
    runner.max_batch = BATCH
    pipe = runner.pipeline
    want = dataclasses.replace(ViTSpec(), attn_impl="fused")
    if pipe.vit_spec != want or pipe.dtype != torch.bfloat16:
        raise AssertionError(f"make_runner() serves {pipe.vit_spec} in "
                             f"{pipe.dtype}, not {want} in bf16")
    # the tree make_runner drew (rng_seed 0), with the fitted head
    tree = _fit_head(pipe, init_tree(pipe, 0), np.random.default_rng(1))
    init_s = time.perf_counter() - t0
    out = drive(torch, ops, runner, np.random.default_rng(2), batches,
                "vit_b8_float", must=A_B + ("fused_attention_block",),
                must_not=C_D + ("flash_attention",))
    return dict(out, init_fit_s=init_s, tokens=pipe.vit_spec.tokens), \
        runner, tree


def b8_engine_runs(torch, ops, det_tree: dict, vit_tree: dict,
                   frames) -> tuple[dict, object]:
    """Phase 7: make_runner on engine dirs the port's save_engine wrote:
    phase 6's fitted detector as a detect engine, and phase 6's ViT-B/8
    weights as a classify engine of each int8 mode (w8a and w8
    pre-quantized, dynamic stored bf16), one batch each.  Returns the
    report and the w8a runner (phase 10 profiles it)."""
    import numpy as np
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.ops.quant import (MLP_AND_ATTN_SUFFIXES,
                                                MLP_SUFFIXES,
                                                prequantize_tree)
    from yolov8_vit_tpu_torch.serve.batch_runner import make_runner
    from yolov8_vit_tpu_torch.weights import save_engine
    modes = {  # quant: (tree, kernels that must launch, kernels that must not)
        "w8a": (prequantize_tree(vit_tree, MLP_AND_ATTN_SUFFIXES),
                A_B + C_D, E_F),
        "w8": (prequantize_tree(vit_tree, MLP_SUFFIXES),
               A_B + ("quant_mlp_ln_fused", "fused_attention_block"),
               ("fused_attention_block_i8", "flash_attention")),
        "dynamic": (vit_tree, A_B + ("fused_attention_block",),
                    C_D + ("flash_attention",)),
    }
    root = os.path.join(ENGINE_DIR, "vit_b8")
    shutil.rmtree(root, ignore_errors=True)
    out, w8a_runner = {}, None
    try:
        det = save_engine(os.path.join(root, "detect"), "detect", det_tree,
                          {"detect_cfg": dataclasses.asdict(DetectConfig())})
        for quant, (tree, must, must_not) in modes.items():
            path = f"vit_b8_{quant}"
            cls = save_engine(
                os.path.join(root, quant), "classify", {"params": tree},
                {"vit_spec": dataclasses.asdict(ViTSpec(
                    quant=quant,
                    attn_impl="fused" if quant == "w8a" else "xla")),
                 "num_classes": 5},
                param_dtype="bfloat16" if quant == "dynamic" else None)
            runner = make_runner(det, cls, classify_budget=BUDGET,
                                 device="cuda")
            runner.max_batch = BATCH
            vs = runner.pipeline.vit_spec
            if (vs.patch, vs.quant, vs.attn_impl) != (8, quant, "fused"):
                raise AssertionError(f"{path}: make_runner serves {vs}")
            runner.run_device_batches([frames])              # warm
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            recs = runner.run_device_batches([frames])[0]
            torch.cuda.synchronize()
            launches = _path_launches(ops, path, must, must_not)
            for r in recs:
                for k in ("boxes", "det_scores", "cls_scores"):
                    if not np.isfinite(r[k]).all():
                        raise AssertionError(f"{path}: non-finite {k}")
            kept = sum(int(r["final_valid"].sum()) for r in recs)
            if kept == 0:
                raise AssertionError(f"{path}: no detection classified")
            out[path] = {"launches": launches, "kept": kept,
                         "fused_step_ms": _time_ms(
                             lambda: runner._fn(frames), 3)}
            if quant == "w8a":
                w8a_runner = runner
            del runner
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out, w8a_runner


def engine_phase(torch, ops, vit_b8_tree: dict, b16_runner, b16_tree: dict,
                 frames) -> dict:
    """Phase 8: engine dirs written by the port's save_engine, loaded and
    run by the port's Engine."""
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models import vit as vit_mod
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.ops.attention import flash_attention_plain
    from yolov8_vit_tpu_torch.runtime.engine import TWO_STAGE_OUTPUTS, Engine
    from yolov8_vit_tpu_torch.weights import save_engine
    root = os.path.join(ENGINE_DIR, "engine")
    shutil.rmtree(root, ignore_errors=True)
    out: dict = {}
    try:
        # ViT-B/8 classify engine, attn_impl="pallas", stored bf16
        spec = ViTSpec(attn_impl="pallas")
        t0 = time.perf_counter()
        path = save_engine(os.path.join(root, "classify_b8"), "classify",
                           {"params": vit_b8_tree},
                           {"vit_spec": dataclasses.asdict(spec),
                            "num_classes": 5}, param_dtype="bfloat16")
        eng = Engine(path, device="cuda", dtype=torch.bfloat16)
        out["classify_save_load_s"] = time.perf_counter() - t0
        g = torch.Generator().manual_seed(7)
        imgs = (torch.rand(BATCH * BUDGET, 3, 224, 224, generator=g) * 2
                - 1).to("cuda")                             # NCHW, [-1, 1]
        eng(imgs[:2])                                       # warm
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        logits = eng(imgs)
        torch.cuda.synchronize()
        out["classify_launches"] = _path_launches(
            ops, "engine_classify", ("flash_attention",),
            A_B + C_D + ("fused_attention_block",))
        if tuple(logits.shape) != (len(imgs), 5) \
                or not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"engine classify: logits "
                                 f"{tuple(logits.shape)} not finite")
        out["classify_ms"] = _time_ms(lambda: eng(imgs), 3)
        # the same model with kernel F's plain version: bf16 roundings
        # agree but for f32 summation order, so the logits stay within 5%
        # of their spread (the bf16 bar of tests/test_torch_vit.py)
        kernel_f = vit_mod.flash_attention
        vit_mod.flash_attention = flash_attention_plain
        try:
            ref = eng(imgs)
        finally:
            vit_mod.flash_attention = kernel_f
        lf, rf = logits.float(), ref.float()
        rel = float((lf - rf).abs().max() / (rf.max() - rf.min()))
        out["classify_vs_plain_rel_err"] = rel
        out["classify_argmax_agree"] = float(
            (lf.argmax(-1) == rf.argmax(-1)).float().mean())
        if rel > 0.05:
            raise AssertionError(f"engine classify vs plain F: {rel}")
        del eng

        # two_stage engine of phase 5's weights, NCHW uint8 frames
        b16 = b16_runner.pipeline
        path = save_engine(os.path.join(root, "two_stage_b16"), "two_stage",
                           b16_tree,
                           {"detect_cfg": dataclasses.asdict(DetectConfig()),
                            "vit_spec": dataclasses.asdict(b16.vit_spec),
                            "num_classes": 5, "classify_budget": BUDGET})
        eng = Engine(path, device="cuda", dtype=torch.bfloat16)
        nchw = frames.permute(0, 3, 1, 2)
        eng(nchw)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = dict(zip(TWO_STAGE_OUTPUTS, eng(nchw)))
        torch.cuda.synchronize()
        out["two_stage_launches"] = _path_launches(
            ops, "engine_two_stage", A_B + C_D, E_F)
        ref = b16(frames)
        for k in ("num_dets", "det_labels", "final_valid", "cls_labels"):
            if not torch.equal(got[k], ref[k]):
                raise AssertionError(f"engine two_stage: {k} differs from "
                                     f"the pipeline")
        out["two_stage_kept"] = int(got["final_valid"].sum())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def detector_convs(torch, det, frames, ref_frames: int = 8,
                   cpu_frames: int = 2) -> dict:
    """Phase 9: the bf16 YOLOv8-s of phase 5 on its batch of 32 frames.
    Every conv the forward runs (operands rounded to bf16, held in f32,
    TF32 allowed) is run again at the same shape and held against the
    same conv in f64 on the first `ref_frames` frames, its error taken as a
    share of sum |w x| (within CONV_TOL).  Then the first `cpu_frames`
    frames go through a CPU copy of the detector: the share of the stem's
    outputs (b0, b1) that differ from the card's (within STEM_DIFF_SHARE)
    and the head maps' largest difference (reported)."""
    import torch.nn.functional as F
    from yolov8_vit_tpu_torch.models.yolov8 import (YOLOv8, ConvBlock,
                                                    conv_f32)
    from yolov8_vit_tpu_torch.ops import blob, letterbox_fast
    from yolov8_vit_tpu_torch.weights import load_tree, module_tree
    bf16 = torch.bfloat16
    lb, _, _ = letterbox_fast(frames, (640, 640), dtype=bf16)
    x = blob(lb).to(bf16)
    convs, outs = [], {}

    def on_block(name):
        def hook(mod, inp):
            convs.append((name, inp[0], mod.w, mod.s))
        return hook

    def on_head(mod, inp):
        convs.extend((f"detect.entry{i}", f, getattr(mod, f"entry{i}_w"), 1)
                     for i, f in enumerate(inp[0]))

    hooks = [det.detect.register_forward_pre_hook(on_head)]
    hooks += [m.register_forward_pre_hook(on_block(n))
              for n, m in det.named_modules() if isinstance(m, ConvBlock)]
    hooks += [getattr(det, n).register_forward_hook(
        lambda _m, _i, o, n=n: outs.__setitem__(n, o)) for n in ("b0", "b1")]
    try:
        with torch.no_grad():
            heads = det(x)
    finally:
        for h in hooks:
            h.remove()
    worst, per_conv = 0.0, {}
    with torch.no_grad():
        for name, xin, w, stride in convs:
            y = conv_f32(xin.float(), w, stride, operands_in_bf16=True)
            xd, wd = xin[:ref_frames].double(), w.double()
            pad = w.shape[-1] // 2
            ref = F.conv2d(xd, wd, stride=stride, padding=pad)
            mag = F.conv2d(xd.abs(), wd.abs(), stride=stride, padding=pad)
            rel = float(((y[:ref_frames].double() - ref).abs()
                         / mag.clamp_min(1e-300)).max())
            per_conv[name] = rel
            worst = max(worst, rel)
            del y, xd, ref, mag
    if worst > CONV_TOL:
        bad = {k: v for k, v in per_conv.items() if v > CONV_TOL}
        raise AssertionError(f"detector convs under TF32 off their f64 "
                             f"value beyond {CONV_TOL}: {bad}")

    cpu = YOLOv8(det.spec, dtype=bf16)
    load_tree(cpu, module_tree(det))
    xc = x[:cpu_frames].cpu()
    cpu_outs = {}
    hooks = [getattr(cpu, n).register_forward_hook(
        lambda _m, _i, o, n=n: cpu_outs.__setitem__(n, o)) for n in ("b0", "b1")]
    try:
        with torch.no_grad():
            cpu_heads = cpu(xc)
    finally:
        for h in hooks:
            h.remove()
    stem = {n: int((outs[n][:cpu_frames].cpu() != cpu_outs[n]).sum())
            for n in ("b0", "b1")}
    stem_n = {n: cpu_outs[n].numel() for n in ("b0", "b1")}
    if any(stem[n] > STEM_DIFF_SHARE * stem_n[n] for n in stem):
        raise AssertionError(f"detector stem card vs CPU: {stem} of "
                             f"{stem_n} outputs differ")
    head_err = max(float((g[:cpu_frames].cpu() - r).abs().max())
                   for gl, rl in zip(heads, cpu_heads) for g, r in zip(gl, rl))
    return {"convs": len(convs), "max_rel_err_vs_f64": worst,
            "per_conv": per_conv, "stem_elements_differing_vs_cpu": stem,
            "stem_elements": stem_n, "head_max_abs_err_vs_cpu": head_err}


# E's launches by kernel name (csrc/gemm_float.cuh, csrc/sdpa.cuh; the
# GEMM's template argument is its epilogue): the parts of its device
# time a call
E_PARTS = {"ln": r"ln_rows_kernel", "qkv_gemm": r"gemm_wgmma_kernel<0>",
           "sdpa": r"sdpa_wgmma_kernel", "proj_gemm": r"gemm_wgmma_kernel<1>"}
# C's and D's launches by kernel name (csrc/int8_common.cuh: the row
# kernel's flag is its LayerNorm; the int8 GEMM's arguments are its output
# type and epilogue): the parts of a bf16 call's device time
_LN_Q = r"ln_quant_rows_kernel<__nv_bfloat16, true>"
C_PARTS = {"ln_quant": _LN_Q,
           "fc1_amax": r"gemm_i8_wgmma_kernel<signed char, 3>",
           "fc1_quant": r"gemm_i8_wgmma_kernel<signed char, 4>",
           "fc2": r"gemm_i8_wgmma_kernel<__nv_bfloat16, 1>"}
D_PARTS = {"ln_quant": _LN_Q,
           "qkv_gemm": r"gemm_i8_wgmma_kernel<__nv_bfloat16, 0>",
           "sdpa": r"sdpa_wgmma_kernel",
           "heads_quant": r"ln_quant_rows_kernel<__nv_bfloat16, false>",
           "proj_gemm": r"gemm_i8_wgmma_kernel<__nv_bfloat16, 1>"}


def profile_step(torch, runner, frames, path: str) -> dict:
    """torch.profiler over two fused steps: device time by kernel, written
    to `path`; returns the per-step device time, the top kernels and the
    device ms a launch of each part of E (E_PARTS) where the step runs
    E."""
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
    with open(path, "w") as f:
        f.write(ka.table(sort_by=attr, row_limit=40))
    import re
    e_split = {}
    for part, name in E_PARTS.items():
        hits = [(us, n) for k, us, n in rows if re.search(name, k)]
        if hits:
            e_split[part] = sum(us for us, _ in hits) / sum(
                n for _, n in hits) / 1e3
    return {"device_us_per_step": busy_us / 2,
            "top": [(k[:60], round(us / 2, 1), n // 2) for k, us, n in rows[:12]],
            **({"attn_block_split_ms": e_split} if e_split else {})}


def profile_parts(torch, fn, parts: dict, calls: int = 3,
                  tries: int = 6) -> dict:
    """torch.profiler over `calls` calls of one kernel wrapper: the device
    ms a launch of each part (a regex on the kernel names), and the device
    ms a call of all of them.  A session can lose records: some launches
    of a kernel (the mean a launch stands; a call counts each kernel's
    launches a call, rounded, at least one), or all of a part's (seen on
    the H100: the GEMMs of a call recorded, its row kernel not; most of
    phase 11's first sessions empty, up to three in a row), so a profile
    that misses a part is taken again, at most `tries` in all, each over
    4x the calls of the last, each retry printed; raises where a part
    never shows."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        reps = calls * 4 ** attempt
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        attr = ("self_cuda_time_total"
                if len(ka) and not hasattr(ka[0], "self_device_time_total")
                else "self_device_time_total")
        rows = [(e.key, getattr(e, attr), e.count) for e in ka
                if e.device_type == torch.autograd.DeviceType.CUDA
                and getattr(e, attr) > 0]
        missing = [name for name in parts.values()
                   if not any(re.search(name, k) for k, _, _ in rows)]
        if not missing:
            break
        print(f"profile {attempt + 1} of {tries}: no kernel matches "
              f"{missing} among {[k[:80] for k, _, _ in rows]}", flush=True)
    else:
        raise AssertionError(f"profile: no kernel matches {missing} in "
                             f"{tries} profiles")
    out = {}
    for part, name in parts.items():
        hits = [(us, n) for k, us, n in rows if re.search(name, k)]
        out[part] = sum(us for us, _ in hits) / sum(n for _, n in hits) / 1e3
    out["call"] = sum(us / n * max(1, round(n / reps))
                      for _, us, n in rows) / 1e3
    return out


def _equal(torch, name, got, ref) -> None:
    if got.dtype != ref.dtype or not torch.equal(got, ref):
        raise AssertionError(
            f"kernel {name} != plain bit for bit: "
            f"{int((got != ref).sum())} of {ref.numel()} entries differ, "
            f"max {float((got.float() - ref.float()).abs().max())}")


def _decoded(torch, pipe, frames):
    """The pipeline's stage-1 NMS inputs for uint8 frames on its device:
    the detector's boxes (B, N, 4) and class scores (B, N, C), f32, as
    runtime/detector.py decodes them, and the detector's input."""
    from yolov8_vit_tpu_torch.models.yolov8 import flatten_head_outputs
    from yolov8_vit_tpu_torch.ops import (blob, dfl_decode, letterbox_fast,
                                          make_anchors)
    cfg, f32 = pipe.det_cfg, torch.float32
    with torch.no_grad():
        lb, _, _ = letterbox_fast(frames, cfg.input_size, dtype=pipe.dtype)
        det_in = blob(lb).to(pipe.dtype)
        box_dist, cls_logits = flatten_head_outputs(pipe.det(det_in))
        anchors, stride = make_anchors(cfg.input_size, cfg.strides,
                                       device=frames.device)
        boxes = dfl_decode(box_dist.to(f32), anchors, stride,
                           cfg.reg_max).contiguous()
        scores = torch.sigmoid(cls_logits.to(f32)).contiguous()
    return boxes, scores, det_in


def nms_run_data(torch, ops, pipe, frames) -> dict:
    """Phase 3 on the run's data (after phase 5): A on phase 5's decoded
    boxes and scores of its first 32 frames, B on A's kept rows
    un-letterboxed and clipped as the pipeline hands them on; each bit for
    bit against its plain version and timed.  Returns {"A": ..., "B":
    ...}."""
    from yolov8_vit_tpu_torch.ops import letterbox_params, unletterbox_boxes
    boxes, scores, _ = _decoded(torch, pipe, frames)
    out = {"A": _time_a(torch, ops, boxes, scores, "run")}
    if out["A"]["picks"] == 0:
        raise AssertionError("kernel A kept nothing on the run's frames")
    _, ob, os_, ol = ops.efficient_nms_scan(boxes, scores)
    h, w = frames.shape[1:3]
    _, _, ratio, dw, dh, _, _ = letterbox_params((h, w),
                                                  pipe.det_cfg.input_size)
    img = torch.tensor([w, h, w, h], dtype=torch.float32,
                       device=frames.device)
    bb = torch.minimum(unletterbox_boxes(ob, ratio, (dw, dh)).clamp_min(0.0),
                       img)
    out["B"] = _time_b(torch, ops, bb.contiguous(), os_, ol >= 0, "run")
    return out


def _region_err(torch, got, ref) -> dict:
    """Kernel J's output against the plain version's: max and mean |d|,
    outputs beyond REGION_TOL's bar, the share of outputs that differ at
    all (a bf16 ulp or more); raises beyond the bar or where not finite."""
    d = (got.float() - ref.float()).abs()
    std = float(ref.float().std())
    r = {"std_plain": std, "max_abs_err": float(d.max()),
         "mean_abs_err": float(d.mean()),
         "beyond_bar": int((d > REGION_TOL["max_std"] * std
                            + REGION_TOL["ulp"] * ref.float().abs()).sum()),
         "differ_share": float((got != ref).float().mean())}
    if got.shape != ref.shape or not bool(torch.isfinite(got.float()).all()) \
            or r["beyond_bar"] or r["mean_abs_err"] > REGION_TOL["mean_std"] \
            * std:
        raise AssertionError(f"kernel J != plain beyond {REGION_TOL}: {r}")
    return r


# kernel J's fused form takes its logistic as 1 / (1 + e^-y) with __expf
# and __fdividef, which returns 0 where the divisor exceeds 2^126: for y
# at or below -126 ln 2 = -87.34, where the logistic is under 2^-126
J_FLUSH_Y = -87.34


def _region_bound(x, out) -> tuple[float, str]:
    """Kernel J's bound on x (B, H, W, c1) -> out (B, H/2, W/2, c2): the
    bytes it must move (input and output once, the five stages' bf16
    weights and f32 biases) against its bf16 operations."""
    c1, c2 = x.shape[-1], out.shape[-1]
    c = c2 // 2
    px = out.shape[0] * out.shape[1] * out.shape[2]
    w_elems = 9 * c1 * c2 + c2 * c2 + 2 * 9 * c * c + 3 * c * c2
    nbytes = (x.numel() + out.numel() + w_elems) * 2 + 4 * (3 * c2 + 2 * c)
    return _bound_ms(nbytes, 2 * px * w_elems / PEAK_BF16_FLOPS * 1e3)


def _silu_table(torch, fr, dev) -> dict:
    """Kernel J's SiLU epilogue on every finite bf16 value against the
    plain `silu_bf16` on the card, bit for bit (`fr.silu_table`): the
    five-launch form's exact logistic everywhere, the fused kernel's
    special-function logistic above J_FLUSH_Y, and below it within 2^-119
    (the plain SiLU's largest magnitude there is 89 x 2^-126).  Returns
    the counts of inputs and of differing outputs, and the differing
    inputs of the fused form; raises beyond that."""
    fast, exact = fr.silu_table(dev)
    y = torch.arange(65536, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16).to(dev)
    fin = torch.isfinite(y.float())
    plain = fr.silu_bf16(y.float().reshape(-1, 1, 1),
                         torch.zeros(65536, device=dev)).reshape(-1)
    pb = plain.view(torch.int16)
    fast_d = (fast.view(torch.int16) != pb) & fin
    exact_d = (exact.view(torch.int16) != pb) & fin
    flush = y.float() <= J_FLUSH_Y
    r = {"inputs": int(fin.sum()), "fast_differ": int(fast_d.sum()),
         "fast_differ_y": y[fast_d].float().tolist()[:16],
         "fast_differ_max_abs": float(
             (fast.float() - plain.float()).abs()[fast_d].max())
         if bool(fast_d.any()) else 0.0,
         "exact_differ": int(exact_d.sum())}
    if r["exact_differ"] or bool((fast_d & ~flush).any()) \
            or r["fast_differ_max_abs"] >= 2.0 ** -119:
        raise AssertionError(f"kernel J's SiLU epilogue differs from "
                             f"silu_bf16: {r}")
    return r


def _region_modules(torch, params: dict, c1: int, c2: int, dev):
    """The port's cuDNN modules of the b1 + b2 region (ConvBlock(c1, c2,
    3, 2) and C2f(c2, c2, 1, shortcut)) holding `params` (the region's
    HWIO tree, as `region_params` gives it), bf16 activations."""
    from yolov8_vit_tpu_torch.models.yolov8 import C2f, ConvBlock
    b1 = ConvBlock(c1, c2, 3, 2)
    b2 = C2f(c2, c2, 1, True)
    for mod, key in ((b1, "b1"), (b2.cv1, "cv1"), (b2.m0.cv1, "m0_cv1"),
                     (b2.m0.cv2, "m0_cv2"), (b2.cv2, "cv2")):
        conv = params[key]["conv"]
        mod.conv.kernel = conv["kernel"].permute(3, 2, 0, 1).float() \
            .contiguous()
        mod.conv.bias = conv["bias"].float()
    b1, b2 = b1.to(dev), b2.to(dev)
    for m in (*b1.modules(), *b2.modules()):
        if hasattr(m, "derive"):
            m.derive(torch.bfloat16)
    return b1, b2


def _region_wide(torch, ops, fr, dev, c1: int, c2: int) -> dict:
    """Kernel J's five-launch form (widths the fused kernel cannot hold) on
    8 frames of a 320 x 320 x c1 input, seeded weights, prepared once:
    held within REGION_TOL of the plain version, timed beside it, its
    bound and the port's cuDNN modules on the same input and weights."""
    g = torch.Generator(device=dev).manual_seed(c1)
    c = c2 // 2

    def conv(kh, cin, cout):
        return {"conv": {
            "kernel": torch.randn(kh, kh, cin, cout, generator=g, device=dev)
            * (2.0 / (kh * kh * cin)) ** 0.5,
            "bias": torch.randn(cout, generator=g, device=dev) * 0.1}}

    params = {"b1": conv(3, c1, c2), "cv1": conv(1, c2, c2),
              "m0_cv1": conv(3, c, c), "m0_cv2": conv(3, c, c),
              "cv2": conv(1, 3 * c, c2)}
    x = torch.randn(8, 320, 320, c1, generator=g, device=dev).to(
        torch.bfloat16)
    prep = fr.prepare_region(params, dev)
    if prep.fused:
        raise AssertionError(f"({c1}, {c2}) took the fused kernel")
    got = ops.fused_b1b2(x, prep)
    r = _region_err(torch, got, fr.region_b1b2_plain(x, params))
    r["ms"] = _time_ms(lambda: ops.fused_b1b2(x, prep), 10)
    r["plain_ms"] = _time_ms(lambda: fr.region_b1b2_plain(x, params), 3)
    b1, b2 = _region_modules(torch, params, c1, c2, dev)
    x_nchw = x.permute(0, 3, 1, 2)
    lib = b2(b1(x_nchw)).permute(0, 2, 3, 1)
    r["max_abs_diff_vs_modules"] = float((got.float() - lib.float())
                                         .abs().max())
    r["library_ms"] = _time_ms(lambda: b2(b1(x_nchw)), 10)
    r["bound_ms"], r["bound_by"] = _region_bound(x, got)
    return r


def public_ops_phase(torch, ops, pipe, tree: dict, frames,
                     mlp_rows: int) -> tuple[list[dict], dict, dict]:
    """Phase 11: kernels G-J against their plain versions, timed, then
    driven once on this run's data with the launch counts reset before and
    read after.  `pipe` and `tree` are phase 5's pipeline and fitted tree,
    `frames` its first batch of 32 uint8 frames on the card.  Returns the
    kernel rows, the launch counts of the drive, and a report."""
    from yolov8_vit_tpu_torch.models.vit import QuantDensePre
    from yolov8_vit_tpu_torch.ops import fused_region as fr
    from yolov8_vit_tpu_torch.ops.fused_region import (prepare_region,
                                                       region_b1b2_plain,
                                                       region_params)
    from yolov8_vit_tpu_torch.ops.quant import (quant_dense_plain,
                                                quant_mlp_plain,
                                                quantize_weight)
    from yolov8_vit_tpu_torch.weights import load_tree
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    rows, rep = [], {}
    g = torch.Generator().manual_seed(11)
    d, hid = 768, 3072

    def wq(fin, fout):
        q, s_ = quantize_weight(torch.randn(fin, fout, generator=g)
                                * fin ** -0.5)
        return q.to(dev), s_.to(dev), (0.02 * torch.randn(fout, generator=g)
                                       ).to(dev)

    # ---- G: the four ViT-B dense shapes at 64 x 197 rows ------------------
    by_shape = {}
    for k, n in ((d, 3 * d), (d, d), (d, hid), (hid, d)):
        w, sw, b = wq(k, n)
        wt = w.t().contiguous()
        x32 = torch.randn(mlp_rows, k, generator=g).to(dev)
        for dt in (bf16, f32):
            x = x32.to(dt)
            _equal(torch, f"G ({k}, {n}) {dt}",
                   ops.quant_dense_fused(x, w, sw, b, w_t=wt),
                   quant_dense_plain(x, w, sw, b))
        x = x32.to(bf16)
        k_ms = _time_ms(lambda: ops.quant_dense_fused(x, w, sw, b, w_t=wt),
                        20)
        p_ms = _time_ms(lambda: quant_dense_plain(x, w, sw, b), 3)
        nbytes = mlp_rows * (k + n) * 2 + k * n + 8 * n
        bound, by = _bound_ms(nbytes,
                              2 * mlp_rows * k * n / PEAK_INT8_OPS * 1e3)
        by_shape[f"{k}x{n}"] = {"ms": k_ms, "plain_ms": p_ms,
                                "bound_ms": bound, "bound_by": by}
    main = by_shape[f"{d}x{hid}"]
    # SiLU form at a detector 1x1 shape: YOLOv8-s b2.cv1, 32 frames
    m_det, c_det = 32 * 160 * 160, 64
    w, sw, b = wq(c_det, c_det)
    silu_err = {}
    for dt in (bf16, f32):
        x = torch.randn(m_det, c_det, generator=g).to(dev, dt)
        silu_err[str(dt)] = _close(
            torch, f"G silu {dt}", ops.quant_dense_fused(x, w, sw, b, True),
            quant_dense_plain(x, w, sw, b, True),
            SILU_TOL[str(dt).replace("torch.", "")])
    x = torch.randn(m_det, c_det, generator=g).to(dev, bf16)
    nbytes = m_det * 2 * c_det * 2 + c_det * c_det + 8 * c_det
    bound, by = _bound_ms(nbytes,
                          2 * m_det * c_det * c_det / PEAK_INT8_OPS * 1e3)
    by_shape["silu_819200x64x64"] = {
        "ms": _time_ms(lambda: ops.quant_dense_fused(x, w, sw, b, True), 10),
        "plain_ms": _time_ms(lambda: quant_dense_plain(x, w, sw, b, True), 3),
        "bound_ms": bound, "bound_by": by}
    # through the layer, loaded from a flax-layout tree
    w, sw, b = wq(d, 3 * d)
    layer = load_tree(QuantDensePre(d, 3 * d, dtype=bf16).to(dev),
                      {"kernel_i8": w, "w_scale": sw, "bias": b})
    x_layer = torch.randn(mlp_rows, d, generator=g).to(dev, bf16)
    _equal(torch, "G through QuantDensePre", layer(x_layer),
           quant_dense_plain(x_layer, w, sw, b))
    rows.append(dict(name="quant_dense", route="cuda",
                     source="yolov8_vit_tpu_torch/csrc/quant_mlp.cu",
                     replaces="yolov8_vit_tpu/ops/quant.py:90",
                     max_abs_err=0.0, ms=main["ms"],
                     plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                     bound_by=main["bound_by"], library_ms=None,
                     shape=f"({mlp_rows}, {d}) x ({d}, {hid}) bf16",
                     by_shape=by_shape, silu_max_abs_err=silu_err))

    # ---- H on inputs made as C's are (check_kernels) ----------------------
    xh = torch.randn(mlp_rows, d, generator=g).to(dev, bf16)
    w1, s1, b1 = wq(d, hid)
    w2, s2, b2 = wq(hid, d)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    args = (xh, xh, w1, s1, b1, w2, s2, b2)
    err = _close(torch, "H", ops.quant_mlp_fused(*args, w1_t=w1t, w2_t=w2t),
                 quant_mlp_plain(*args), KERNEL_TOL)
    _close(torch, "H f32", ops.quant_mlp_fused(
        *(a.float() if a.dtype == bf16 else a for a in args)),
        quant_mlp_plain(*(a.float() if a.dtype == bf16 else a
                          for a in args)), KERNEL_TOL)
    k_ms = _time_ms(lambda: ops.quant_mlp_fused(*args, w1_t=w1t, w2_t=w2t),
                    20)
    p_ms = _time_ms(lambda: quant_mlp_plain(*args), 3)
    nbytes = 3 * mlp_rows * d * 2 + 2 * d * hid + 4 * (2 * d + 2 * hid)
    bound, by = _bound_ms(nbytes,
                          2 * 2 * mlp_rows * d * hid / PEAK_INT8_OPS * 1e3)
    rows.append(dict(name="quant_mlp", route="cuda",
                     source="yolov8_vit_tpu_torch/csrc/quant_mlp.cu",
                     replaces="yolov8_vit_tpu/ops/quant.py:149",
                     max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                     bound_by=by, library_ms=None))

    # ---- I: phase 5's decoded boxes and scores, A's tie inputs, 1280 and
    # 2560 inputs (33,600 and 134,400 anchors: past the old kernel's cap) --
    real_boxes, real_scores, det_in = _decoded(torch, pipe, frames)
    i_rep = {}
    for label, inp in (("run", (real_boxes, real_scores)),
                       ("ties", _nms_inputs(torch, 32, 8400, 5, 0)),
                       ("1280", _nms_inputs(torch, 32, 33600, 5, 3,
                                            side=1280)),
                       ("2560", _nms_inputs(torch, 32, 134400, 5, 13,
                                            side=2560))):
        bx, sc = (t.to(dev) for t in inp)
        i_rep[label] = _time_i(torch, ops, bx, sc, label)
        del bx, sc
    if i_rep["run"]["picks"] == 0:
        raise AssertionError("kernel I kept nothing on the run's frames")
    ties = i_rep["ties"]
    rows.append(dict(name="nms_argmax", route="cuda",
                     source="yolov8_vit_tpu_torch/csrc/nms.cu",
                     replaces="yolov8_vit_tpu/ops/nms.py:74",
                     max_abs_err=0.0, ms=ties["ms"],
                     plain_ms=ties["plain_ms"], bound_ms=ties["bound_ms"],
                     bound_by=ties["bound_by"], library_ms=None,
                     kernel_ms=ties["kernel_ms"], by_input=i_rep))

    # ---- J: the detector's own stem output and b1 / b2 weights, prepared
    # once outside the timed calls ------------------------------------------
    det = pipe.det
    with torch.no_grad():
        stem_nchw = det.b0(det_in.permute(0, 3, 1, 2))
        stem = stem_nchw.permute(0, 2, 3, 1).contiguous()
        params = region_params(tree["det"]["params"])
        prep = prepare_region(params, dev)
        got = ops.fused_b1b2(stem, prep)
        ref = region_b1b2_plain(stem, params)
        lib = det.b2(det.b1(stem_nchw)).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        if tuple(got.shape) != (32, 160, 160, 64) or not prep.fused:
            raise AssertionError(f"kernel J: {tuple(got.shape)}, fused "
                                 f"{prep.fused}")
        j_rep = {"shape_in": list(stem.shape), "shape_out": list(got.shape),
                 **_region_err(torch, got, ref),
                 "max_abs_plain": float(ref.float().abs().max()),
                 "max_abs_diff_vs_modules": float(
                     (got.float() - lib.float()).abs().max())}
        if not torch.equal(got, ops.fused_b1b2(stem, params)):
            raise AssertionError("kernel J: weights prepared once and per "
                                 "call differ")
        j_rep["silu_table"] = _silu_table(torch, fr, dev)
        del ref, lib
        # the five-launch form at YOLOv8-m's and -x's widths, seeded weights
        j_rep["wide"] = {f"{c1w}x{c2w}": _region_wide(torch, ops, fr, dev,
                                                      c1w, c2w)
                         for c1w, c2w in ((48, 96), (80, 160))}

        def call():
            return ops.fused_b1b2(stem, prep)

        k_ms = _time_ms(call, 10)
        prof_j = profile_parts(torch, call, {"k": r"fused_region_kernel"})
        j_rep["kernel_ms"] = prof_j["k"]
        j_rep["device_ms_per_call"] = prof_j["call"]
        j_rep["ms_preparing_per_call"] = _time_ms(
            lambda: ops.fused_b1b2(stem, params), 10)
        p_ms = _time_ms(lambda: region_b1b2_plain(stem, params), 3)
        lib_ms = _time_ms(lambda: det.b2(det.b1(stem_nchw)), 10)
    bound, by = _region_bound(stem, got)
    rows.append(dict(name="fused_b1b2", route="cuda",
                     source="yolov8_vit_tpu_torch/csrc/fused_region.cu",
                     replaces="yolov8_vit_tpu/ops/fused_region.py:132",
                     max_abs_err=j_rep["max_abs_err"], ms=k_ms, plain_ms=p_ms,
                     bound_ms=bound, bound_by=by, library_ms=lib_ms,
                     kernel_ms=j_rep["kernel_ms"]))
    rep.update(G=by_shape, G_silu_max_abs_err=silu_err, I=i_rep, J=j_rep)

    # ---- the drive: each of the four once, on this run's data --------------
    ops.reset_launch_counts()
    with torch.no_grad():
        y = layer(x_layer)
        z = ops.quant_mlp_fused(*args, w1_t=w1t, w2_t=w2t)
        nd = ops.efficient_nms_scan(real_boxes, real_scores,
                                    multi_label=False)
        r = ops.fused_b1b2(stem, prep)
    torch.cuda.synchronize()
    launches = _path_launches(ops, "public_ops", G_J, A_B + C_D + E_F)
    for name, t in (("G", y), ("H", z), ("J", r)):
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"public ops drive: {name} not finite")
    if int(nd[0].sum()) != i_rep["run"]["picks"]:
        raise AssertionError("public ops drive: I's picks changed")
    return rows, launches, rep


def _http_json(url: str, body=None, timeout: float = 300.0):
    """GET, or POST `body` as JSON; the decoded JSON answer."""
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _hinges_on_area_tie(np, infer, boxes, scores, cfg) -> bool:
    """Whether one frame's stage-2 NMS depends on float width: the host
    route's area-sorted NMS (serve/infer.py, as the JAX package's host
    route computes it) on the frame's clipped stage-1 rows keeps another
    count with areas in f64 than in f32.  The fitted head pins every box
    to one size, so candidates' areas tie exactly in f32 (the device's
    kernel B: ties to the lowest row) and differ in their last digits in
    f64; where the greedy order then decides the kept set, an f32 result
    can rightly differ from another run whose boxes moved by an ulp."""
    keep = scores > cfg.conf_second
    wide = infer._area_nms_host(boxes[keep].astype(np.float64), scores[keep],
                                cfg.custom_nms_iou)
    narrow = infer._area_nms_host(boxes[keep].astype(np.float32),
                                  scores[keep], cfg.custom_nms_iou)
    return len(wide) != len(narrow)


def _area_tie_frames(np, infer, imageio, det_eng, paths) -> list[str]:
    """The names of the frames, read from `paths` and run through the host
    detect engine, whose stage-2 NMS hinges on an f32 area tie
    (`_hinges_on_area_tie`)."""
    out = []
    cfg = det_eng.det_cfg
    for path in paths:
        rgb = imageio.imread_rgb(path)
        x = rgb.transpose(2, 0, 1)[None].astype(np.float32) / 255.0
        num, bb, sc, _ = (infer._np(t) for t in det_eng(x))
        n = int(num.reshape(-1)[0])
        bb = bb.reshape(-1, 4)[:n].clip(0, [rgb.shape[1], rgb.shape[0]] * 2)
        if _hinges_on_area_tie(np, infer, bb, sc.reshape(-1)[:n], cfg):
            out.append(os.path.basename(path))
    return out


# Phase 13's bf16 leg holds the card's stage-1 inputs (decoded boxes and
# sigmoid scores, as efficient_nms_scan receives them) against the CPU
# copy's.  Both sides evaluate one bf16 detector and round at the same
# points; they part only where their f32 sums (cuDNN's order against the
# CPU's) put a value on the other side of a bf16 rounding midpoint, and
# from there the difference spreads through the rest of the depth as the
# rounding noise of an independent bf16 evaluation.  The size of that
# noise through the detector's whole depth is measured on this run's
# frames: the CPU copy's bf16 inputs against its f32 pipeline's (same
# weights; the bf16 side also rounds the weights, which only widens it).
# The card's bf16 inputs differ from the CPU's by the two sides' noise and
# by what the two devices' f32 arithmetic alone moves (the decode's exp,
# the f32 sums), measured as the f32 legs' card-vs-CPU difference.  Two
# evaluations whose noise has that size differ by at most the sum of their
# largest deviations (2x the largest), and on average by sqrt(2) x the
# mean deviation where the noise is independent (less where they share
# roundings); held at 2.0 x the max and 1.5 x the mean (sqrt(2) and the
# spread of 32 frames' means), each plus the f32 legs' difference, max or
# mean.  (A first form without the f32 term failed on the boxes' mean,
# PERF.md §6: the fitted head pins each box to one DFL bin, so the boxes
# carry no bf16 noise and differ only by the decode's f32 arithmetic.)
# The f32 term is the card's own reading, so a fault that shows at both
# precisions (a wrong conv, cast or decode) would widen it as much as the
# bf16 difference; so that term is itself capped, before any run, at
# STAGE1_F32_CAP of the f32 inputs' largest magnitude (boxes: pixel
# coordinates; scores: at most 1).  The cap: two orders of an f32 sum of K
# terms differ by about sqrt(K) roundings, for YOLOv8-s's largest K (the
# head's 3x3 convs over 512 channels, K = 4,608) 2^-17.9 of the sum; the
# longest chain of convs from the frame to the head is 48 (b0 .. b9, the
# neck, the head's three), and relative differences add through them:
# 48 x 2^-17.9 = 2^-12.3 on the head's outputs.  The sigmoid (slope at
# most 1/4) and the DFL decode (a convex combination of bin distances,
# plus the anchor, times the stride) add a few f32 roundings and do not
# widen a relative difference; held at 2^-11, about twice the estimate.
# A fault moves an input by a bf16 rounding (2^-9) or more, and fails
# there, whatever the bf16 term.
STAGE1_BF16_BAR = {"max": 2.0, "mean": 1.5}
STAGE1_F32_CAP = 2.0 ** -11

# the kept-set check runs each side in calls of this many frames (the
# classify budget is spread over a call's frames, so both sides batch alike)
KEPT_SET_CALL = 8


def _pair_iou(torch, bx):
    """(N, 4) boxes -> (N, N) IoU, row i as the later box, column j the
    earlier, in the kernels' operation order."""
    from yolov8_vit_tpu_torch.ops.nms import _iou_vs
    return _iou_vs(bx[None].expand(len(bx), -1, -1), bx).t()


def _flips(torch, a, b, thr, what: str, rel: float, among=None) -> list:
    """Decisions `a > thr` and `b > thr` (two sides' values, where `among`)
    that differ: "<what> crosses <thr>: <count> (|d| <= <largest
    difference>[, within one ulp])"."""
    flip = (a > thr) != (b > thr)
    if among is not None:
        flip &= among
    if not bool(flip.any()):
        return []
    d = float((a - b).abs()[flip].max())
    ulp = ", within one ulp" if d <= rel * thr else ""
    return [f"{what} crosses {thr}: {int(flip.sum())} (|d| <= {d:.3g}{ulp})"]


def _order_swaps(torch, ka, kb, overlap, what: str) -> list:
    """Pairs that interact (`overlap`) whose order by key differs between
    the two sides (ties included): "<what> order swaps: <count>"."""
    swap = (torch.sign(ka[:, None] - ka) != torch.sign(kb[:, None] - kb)) \
        & overlap
    return [f"{what} order swaps: {int(swap.sum()) // 2}"] \
        if bool(swap.any()) else []


def _stage_flips(torch, cfg, sides, rel: float) -> list:
    """The decisions of frame's two NMS stages that differ between the
    card (sides[0]) and the CPU (sides[1]); each side: its stage-1 boxes
    (N, 4) and scores (N, C), and its stage-2 rows (boxes (T, 4), scores
    (T,), labels (T,), num_dets)."""
    (b1c, s1c, r2c), (b1p, s1p, r2p) = sides
    out = _flips(torch, s1c, s1p, cfg.nms_conf, "stage-1 score", rel)
    cand = ((s1c > cfg.nms_conf) | (s1p > cfg.nms_conf)).nonzero()
    if len(cand) > 1:
        a, k = cand[:, 0], cand[:, 1]
        same = (k[:, None] == k) & ~torch.eye(len(a), dtype=torch.bool)
        ic, ip = _pair_iou(torch, b1c[a]), _pair_iou(torch, b1p[a])
        out += _flips(torch, ic, ip, cfg.nms_iou, "stage-1 IoU", rel,
                      among=same)
        over = same & ((ic > cfg.nms_iou) | (ip > cfg.nms_iou))
        out += _order_swaps(torch, s1c[a, k], s1p[a, k], over,
                            "stage-1 score")
    (bc, sc, lc, nc), (bp, sp, lp, np_) = r2c, r2p
    if nc == np_ and torch.equal(lc, lp):    # the same rows on both sides
        valid = lc[:nc] >= 0
        bc, bp, sc, sp = bc[:nc], bp[:nc], sc[:nc], sp[:nc]
        out += _flips(torch, sc, sp, cfg.conf_second, "stage-2 score", rel,
                      among=valid)
        comp = valid & ((sc > cfg.conf_second) | (sp > cfg.conf_second))
        pair = comp[:, None] & comp & ~torch.eye(nc, dtype=torch.bool)
        ic, ip = _pair_iou(torch, bc), _pair_iou(torch, bp)
        out += _flips(torch, ic, ip, cfg.custom_nms_iou, "stage-2 IoU", rel,
                      among=pair)
        area = [(x[:, 2] - x[:, 0]).clamp_min(0)
                * (x[:, 3] - x[:, 1]).clamp_min(0) for x in (bc, bp)]
        over = pair & ((ic > cfg.custom_nms_iou) | (ip > cfg.custom_nms_iou))
        out += _order_swaps(torch, *area, over, "stage-2 area")
    return out


def _stage1_picks(torch, boxes, scores, out):
    """The flat index class * n + anchor of each row that stage-1 NMS kept
    (-1 padded), (B, M) int64: the lowest (anchor, class) whose box and
    score the row carries bit for bit, as the greedy picks among equal
    entries."""
    num, ob, os_, ol = out
    n = boxes.shape[1]
    lab = ol.long().clamp_min(0)
    same = (boxes[:, None] == ob[:, :, None]).all(-1) \
        & (scores.transpose(1, 2).gather(1, lab[:, :, None].expand(-1, -1, n))
           == os_[..., None])
    anchor = torch.where(same, torch.arange(n, device=boxes.device),
                         n).amin(dim=2)
    if bool((anchor[ol >= 0] == n).any()):
        raise AssertionError("a kept stage-1 row matches no input entry")
    return torch.where(ol >= 0, lab * n + anchor, -1)


def _row_logits(torch, parts: list, logits: list, per_call: int) -> dict:
    """{(frame, row): the ViT's logits} of one run: each call's classify
    slots recomputed from its outputs as TwoStagePipeline.forward picks
    them (valid first, then score, a stable sort), matched to the logits
    the ViT returned for that call."""
    out = {}
    for ci, (o, lg) in enumerate(zip(parts, logits)):
        t = o["final_valid"].shape[1]
        valid = o["final_valid"].reshape(-1)
        sc = o["det_scores"].reshape(-1)
        pri = torch.where(valid, 1.0 + sc, sc)
        slots = torch.sort(pri, descending=True, stable=True).indices
        for s_, flat in enumerate(slots[:len(lg)].tolist()):
            out[(ci * per_call + flat // t, flat % t)] = lg[s_]
    return out


def _class_flips(torch, legs, f: int) -> str | None:
    """Where frame f's kept set is equal on both sides and only its
    cls_labels differ: "class margin ..." when every flipped row's top-two
    logit margin, and the two sides' largest logit difference on that row,
    are within KERNEL_TOL's atol (one int8 code of a W8A8 block: the ViT's
    f32 sums run in another order on each side), "classify budget ..."
    when a row was classified on one side only (scores that differ in
    their last bits reorder the budget's slots); else None."""
    card, cpu = legs
    rows = torch.nonzero(card["cls_labels"][f] != cpu["cls_labels"][f])
    why = set()
    for r in rows[:, 0].tolist():
        lc = card["row_logits"].get((f, r))
        lp = cpu["row_logits"].get((f, r))
        if lc is None or lp is None:
            why.add("classify budget: a row classified on one side")
            continue
        delta = float((lc - lp).abs().max())
        top = torch.topk(lp, 2).values
        margin = float(top[0] - top[1])
        if max(margin, delta) > KERNEL_TOL["atol"]:
            return None
        why.add(f"class margin {margin:.3g}, logit difference {delta:.3g}, "
                f"both <= {KERNEL_TOL['atol']}")
    return "; ".join(sorted(why)) if why else None


def _attribute(torch, np, infer, cfg, legs, pipes, frame, f: int,
               rel: float) -> str:
    """Why frame f's integer outputs differ between the card's and the
    CPU's run: "area tie" (`_hinges_on_area_tie` on either side's stage-2
    rows), a flip of the classifier alone (`_class_flips`), the NMS
    decisions that differ between the two sides (`_stage_flips`: a score
    or IoU on the other side of its threshold, with the largest difference
    and whether it is within one ulp, `rel` of the threshold; a pair's
    score or area order swapped; the stage-1 inputs decoded again for
    this frame alone), or "unexplained"."""
    card, cpu = legs
    if all(torch.equal(card[k][f], cpu[k][f])
           for k in ("num_dets", "picks", "det_labels", "final_valid")):
        flips = _class_flips(torch, legs, f)
        if flips is not None:
            return flips
    sides = []
    for leg, pipe in zip(legs, pipes):
        n = int(leg["num_dets"][f])
        if _hinges_on_area_tie(np, infer, leg["boxes"][f][:n].numpy(),
                               leg["det_scores"][f][:n].numpy(), cfg):
            return "area tie"
        b1, s1, _ = _decoded(torch, pipe, frame.to(pipe.device))
        sides.append((b1[0].cpu(), s1[0].cpu(),
                      (leg["boxes"][f], leg["det_scores"][f],
                       leg["det_labels"][f], n)))
    found = _stage_flips(torch, cfg, sides, rel)
    return "; ".join(found) if found else "unexplained"


def _stage1_bar(torch, card, cpu, f32_legs) -> dict:
    """STAGE1_BF16_BAR on the stage-1 inputs (boxes, scores) of phase 13's
    frames: the card's bf16 against the CPU's bf16, beside the CPU bf16
    copy's distance to its f32 pipeline (the bf16 noise) and the f32 legs'
    card-vs-CPU difference, that difference within STAGE1_F32_CAP of the
    CPU f32 inputs' largest magnitude.  Raises beyond the bar or the
    cap."""
    rep = {}
    (card_f32, cpu_f32) = f32_legs
    for k, name in enumerate(("boxes", "scores")):
        c, p = card[k].float(), cpu[k].float()
        diff = (c - p).abs()
        noise = (p - cpu_f32[k].float()).abs()
        f32d = (card_f32[k].float() - cpu_f32[k].float()).abs()
        r = {"max": float(diff.max()), "mean": float(diff.mean()),
             "bf16_noise_max": float(noise.max()),
             "bf16_noise_mean": float(noise.mean()),
             "f32_diff_max": float(f32d.max()),
             "f32_diff_mean": float(f32d.mean()),
             "f32_cap": STAGE1_F32_CAP * float(cpu_f32[k].float().abs()
                                               .max())}
        r["bar_max"] = STAGE1_BF16_BAR["max"] * r["bf16_noise_max"] \
            + r["f32_diff_max"]
        r["bar_mean"] = STAGE1_BF16_BAR["mean"] * r["bf16_noise_mean"] \
            + r["f32_diff_mean"]
        rep[name] = r
        if not bool(torch.isfinite(c).all()) or r["max"] > r["bar_max"] \
                or r["mean"] > r["bar_mean"] \
                or r["f32_diff_max"] > r["f32_cap"]:
            raise AssertionError(f"stage-1 {name}, bf16: the card's differ "
                                 f"from the CPU's beyond STAGE1_BF16_BAR "
                                 f"{STAGE1_BF16_BAR}, or at f32 beyond "
                                 f"STAGE1_F32_CAP {STAGE1_F32_CAP}: {r}")
    return rep


def kept_set_phase(torch, np, det_cfg, vit_spec, tree: dict, frames,
                   devices=("cuda", "cpu")) -> dict:
    """Phase 13: the pipeline of phase 5's weights on its fitted frames,
    the card against a CPU copy, KEPT_SET_CALL frames a call on both: at
    f32 every frame's kept set (num_dets, det_labels, final_valid) must
    be equal unless its stage-2 NMS hinges on an f32 area tie, and its
    cls_labels unless a flipped row's logit margin lies within the two
    sides' logit difference (`_class_flips`); at bf16 (the main path) the
    differing frames are counted and attributed (one ulp: 2^-23 of a
    threshold at f32, 2^-8 at bf16), none may be "unexplained", and the
    stage-1 inputs are held to STAGE1_BF16_BAR (`_stage1_bar`).  The
    kept set includes the stage-1
    picks, so a kept row of another anchor with the same class, count and
    stage-2 mask is a difference too."""
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.runtime import detector
    from yolov8_vit_tpu_torch.serve import infer
    from yolov8_vit_tpu_torch.weights import load_pipeline_tree
    keys = ("num_dets", "picks", "det_labels", "final_valid", "cls_labels")
    nms_scan = detector.efficient_nms_scan
    out = {"frames": len(frames)}
    for dtype, rel in ((torch.float32, 2.0 ** -23), (torch.bfloat16,
                                                     2.0 ** -8)):
        legs, pipes = [], []
        for device in devices:
            t0 = time.perf_counter()
            pipe = TwoStagePipeline(det_cfg=det_cfg, vit_spec=vit_spec,
                                    classify_budget=BUDGET, dtype=dtype,
                                    device=device)
            load_pipeline_tree(pipe, tree)
            parts, logits, picks, s1 = [], [], [], []
            hook = pipe.vit.register_forward_hook(
                lambda _m, _i, o, lg=logits: lg.append(o.float().cpu()))

            def scan(boxes, scores, **kw):
                out = nms_scan(boxes, scores, **kw)
                picks.append(_stage1_picks(torch, boxes, scores, out))
                s1.append((boxes.cpu(), scores.cpu()))
                return out

            detector.efficient_nms_scan = scan
            try:
                with torch.no_grad():
                    for i in range(0, len(frames), KEPT_SET_CALL):
                        o = pipe(frames[i:i + KEPT_SET_CALL].to(device))
                        if len(picks) != len(parts) + 1:
                            raise AssertionError("stage-1 NMS ran other "
                                                 "than once a call")
                        o["picks"] = picks[-1]
                        parts.append({k: v.cpu() for k, v in o.items()})
            finally:
                detector.efficient_nms_scan = nms_scan
                hook.remove()
            legs.append({k: torch.cat([p[k] for p in parts])
                         for k in parts[0]})
            legs[-1]["row_logits"] = _row_logits(torch, parts, logits,
                                                 KEPT_SET_CALL)
            legs[-1]["stage1"] = tuple(torch.cat([x[i] for x in s1])
                                       for i in range(2))
            pipes.append(pipe)
            out[f"{device}_{str(dtype)[6:]}_{len(pipes)}_s"] = \
                time.perf_counter() - t0
        card, cpu = legs
        diff = {}
        for f in range(len(frames)):
            which = [k for k in keys if not torch.equal(card[k][f],
                                                         cpu[k][f])]
            if which:
                diff[f] = {"outputs": which, "why": _attribute(
                    torch, np, infer, det_cfg, legs, pipes,
                    frames[f:f + 1], f, rel)}
        del pipes
        name = "f32" if dtype == torch.float32 else "bf16"
        out[name] = {"frames_differing": len(diff), "by_frame": diff,
                     "kept_card": int(card["final_valid"].sum()),
                     "kept_cpu": int(cpu["final_valid"].sum())}
        print(f"kept set card vs CPU, {name}: {len(diff)} of {len(frames)} "
              f"frames differ: {json.dumps(diff)}", flush=True)
        if name == "bf16":
            out[name]["stage1"] = _stage1_bar(torch, card["stage1"],
                                              cpu["stage1"], f32_stage1)
            print(f"stage-1 inputs, bf16, card vs CPU against the CPU's "
                  f"bf16 noise (STAGE1_BF16_BAR {STAGE1_BF16_BAR}): "
                  f"{json.dumps(out[name]['stage1'])}", flush=True)
            lost = {f: d for f, d in diff.items() if d["why"] == "unexplained"}
            if lost:
                raise AssertionError(f"kept set, bf16: frames whose "
                                     f"difference nothing explains: {lost}")
        else:
            f32_stage1 = (card["stage1"], cpu["stage1"])
            bad = {f: d for f, d in diff.items()
                   if d["why"] != "area tie" and not (
                       d["outputs"] == ["cls_labels"]
                       and d["why"].startswith(("class margin",
                                                "classify budget")))}
            if bad:
                raise AssertionError(
                    f"kept set, f32: the card's integer outputs or stage-1 "
                    f"picks differ from the CPU's on frames that no area "
                    f"tie (and, for cls_labels alone, no classifier margin "
                    f"within one int8 code) explains: {bad}")
    return out


def service_phase(torch, ops, tree: dict, vit_spec, smi: str,
                  requests: int = 3) -> dict:
    """Phase 12: the inspection service over HTTP on 127.0.0.1, both
    routes, on the engine pair of phase 5's weights (`tree`, `vit_spec`)."""
    import functools
    import http.server
    import threading
    import numpy as np
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.runtime.accuracy import compare_fused_vs_host
    from yolov8_vit_tpu_torch.runtime.engine import Engine
    from yolov8_vit_tpu_torch.serve import imageio, infer
    from yolov8_vit_tpu_torch.serve.app import build_default_service
    from yolov8_vit_tpu_torch.serve.batch_runner import make_runner
    from yolov8_vit_tpu_torch.utils.densify import make_cover_scenes
    from yolov8_vit_tpu_torch.weights import save_engine
    root = os.path.join(ENGINE_DIR, "service")
    shutil.rmtree(root, ignore_errors=True)
    frames_dir = os.path.join(root, "frames")
    os.makedirs(frames_dir)
    out: dict = {"card": smi}
    servers = []

    def serve(httpd):
        servers.append(httpd)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    try:
        det_dir = save_engine(
            os.path.join(root, "detect"), "detect", tree["det"],
            {"detect_cfg": dataclasses.asdict(DetectConfig())})
        cls_dir = save_engine(
            os.path.join(root, "classify"), "classify", tree["vit"],
            {"vit_spec": dataclasses.asdict(vit_spec), "num_classes": 5})
        imgs, covers = make_cover_scenes(np.random.default_rng(12), BATCH,
                                         (640, 640), lam=1.5)
        names = [f"cam{i:02d}.bmp" for i in range(BATCH)]
        for name, img in zip(names, imgs):
            imageio.imwrite(os.path.join(frames_dir, name),
                            imageio.bgr2rgb(img))
        paths = [os.path.join(frames_dir, n) for n in names]
        files = serve(http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), functools.partial(Quiet, directory=frames_dir)))
        body = {"urls": [{f"img{i}": f"{files}/{n}"}
                         for i, n in enumerate(names)]}

        # ---- fused route ---------------------------------------------------
        t0 = time.perf_counter()
        svc = build_default_service(os.path.join(root, "work_fused"),
                                    det_dir, cls_dir, enable_retrain=False,
                                    fused=True)
        base = serve(svc.make_http_server("127.0.0.1", 0))
        out["fused_build_s"] = time.perf_counter() - t0
        _http_json(base + "/", body)                          # warm
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        secs, rows = [], None
        for _ in range(requests):
            t0 = time.perf_counter()
            rows = _http_json(base + "/", body)
            secs.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        out["fused_launches"] = _path_launches(ops, "service_fused",
                                               A_B + C_D, E_F)
        br = make_runner(det_dir, cls_dir, device="cuda")
        prof: dict = {}
        want = br.flatten(paths, br.run_paths(paths, profile=prof))
        if rows != [list(r) for r in want]:
            raise AssertionError("service (fused): POST / rows differ from "
                                 "BatchRunner.flatten(run_paths) called "
                                 "directly")
        if not rows or {r[0] for r in rows} - set(names):
            raise AssertionError(f"service (fused): {len(rows)} rows")
        out.update(fused_request_s=secs, fused_rows=len(rows),
                   true_covers=sum(len(c) for c in covers),
                   direct_run_paths_profile_ms=prof)
        # what the host spends outside the fused steps, one request's worth
        t0 = time.perf_counter()
        raw = [open(p_, "rb").read() for p_ in paths]
        t1 = time.perf_counter()
        for r_ in raw:
            imageio.imdecode(r_)
        t2 = time.perf_counter()
        imageio.imwrite(os.path.join(root, "probe.bmp"),
                        imageio.imdecode(raw[0]))
        out["host_ms"] = {"read_32_files": (t1 - t0) * 1e3,
                          "decode_32_bmp": (t2 - t1) * 1e3,
                          "encode_1_bmp": (time.perf_counter() - t2) * 1e3}
        del br

        # /getImage and /getConfig round trips
        t0 = time.perf_counter()
        ans = _http_json(base + "/getImage", {
            "imageUrl": f"{files}/{names[0]}",
            "objects": [{"sort": "broke", "xmin": 10, "ymin": 20,
                         "xmax": 110, "ymax": 130}]})
        out["get_image_s"] = time.perf_counter() - t0
        xml = os.path.join(root, "work_fused", "train", "new",
                           names[0].replace(".bmp", ".xml"))
        if "url" not in ans or not os.path.exists(xml) \
                or "<sort>1</sort>" not in open(xml).read():
            raise AssertionError(f"/getImage: {ans}, xml at {xml} missing "
                                 f"or wrong")
        for _ in range(200):              # the counter bumps on a thread
            if _http_json(base + "/getConfig")["num"] == 1:
                break
        cfg = _http_json(base + "/getConfig")
        if cfg["num"] != 1:
            raise AssertionError(f"/getImage did not bump the counter: {cfg}")
        if _http_json(base + "/getConfig", {"standard": 7}) != \
                {"state": "修改成功"} \
                or _http_json(base + "/getConfig")["standard"] != 7:
            raise AssertionError("/getConfig round trip failed")
        out["config_after"] = _http_json(base + "/getConfig")

        # ---- host route ----------------------------------------------------
        t0 = time.perf_counter()
        host = build_default_service(os.path.join(root, "work_host"),
                                     det_dir, cls_dir, enable_retrain=False,
                                     fused=False)
        hbase = serve(host.make_http_server("127.0.0.1", 0))
        out["host_build_s"] = time.perf_counter() - t0
        _http_json(hbase + "/", {"urls": body["urls"][:2]})   # warm
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        host_rows = _http_json(hbase + "/", body)
        out["host_request_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        out["host_launches"] = _path_launches(
            ops, "service_host", ("efficient_nms_scan",) + C_D,
            ("area_sorted_nms",) + E_F)
        if not host_rows:
            raise AssertionError("service (host): no detections")
        out["host_rows"] = len(host_rows)

        # ---- the two routes against each other -----------------------------
        det_eng = Engine(det_dir, device="cuda")
        det_eng.set_desired(["num_dets", "bboxes", "scores", "labels"])
        ties = _area_tie_frames(np, infer, imageio, det_eng, paths)
        del det_eng
        out["area_tie_frames"] = ties
        cmp_paths = [p_ for p_ in paths if os.path.basename(p_) not in ties]
        if len(cmp_paths) < 0.75 * len(paths):
            raise AssertionError(f"fused vs host: {len(ties)} of "
                                 f"{len(paths)} frames hinge on area ties")
        disagree: list = []
        t0 = time.perf_counter()
        acc = compare_fused_vs_host(tree["det"], tree["vit"], DetectConfig(),
                                    vit_spec, cmp_paths, budget=8,
                                    disagreements=disagree)
        out["compare_s"] = time.perf_counter() - t0
        out["compare_fused_vs_host"] = acc
        print(f"compare_fused_vs_host ({len(cmp_paths)} frames; left out, "
              f"kept set hinges on an f32 area tie: {ties}): "
              f"{json.dumps(acc)}", flush=True)
        # the disagreeing pairs' logit margins, on the host route's crop
        cls_eng = Engine(cls_dir, device="cuda")
        margins = []
        for name, fbox, fcls, hcls in disagree:
            rgb = imageio.imread_rgb(os.path.join(frames_dir, name))
            crop = infer._crop_nearest_224(
                rgb, infer._inflate(np.round(fbox), rgb.shape[1],
                                    rgb.shape[0]))
            x = crop.astype(np.float32)[None] / 255.0 * 2.0 - 1.0
            lg = cls_eng(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
            lg = lg.float().cpu().numpy()[0]
            top = np.sort(lg)[::-1]
            margins.append({"frame": name, "fused": fcls, "host": hcls,
                            "margin": float(top[0] - top[1]),
                            "spread": float(top[0] - top[-1])})
        out["class_disagreements"] = margins
        print(f"class disagreements (logit margin, spread): "
              f"{json.dumps(margins)}", flush=True)
        if acc["count_match"] != acc["images"] or acc["mean_iou"] <= 0.85 \
                or acc["detections"] == 0 \
                or acc["class_agree"] < CLASS_AGREE_SHARE * acc["matched"]:
            raise AssertionError(f"fused vs host: {acc}, {margins}")
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(root, ignore_errors=True)
    return out



# phase 14: one train step of ViT-B/8 on the card against the same step on
# the CPU (the port's own CPU path; f32 on both, TF32 off).  The loss is
# a mean over the batch of sums over 768-term f32 dot products taken in
# another order: a relative 1e-4.  Each leaf's gradient within 1e-3 of
# its largest |g|: backward sums (over tokens, over the batch) of the
# same products in another order, through 12 blocks.  The stepped params
# within 1e-6: lr (1e-4) times a gradient difference, plus the weight
# decay and momentum arithmetic, which is the same on both sides.
TRAIN_STEP_TOL = {"loss_rel": 1e-4, "grad_share": 1e-3, "param_abs": 1e-6}
# phase 14 (b): the served classifier runs the trained params in bf16
# (kernel E, bf16 GEMMs), the trainer's eval in f32.  FLOAT_BF16_TOL holds
# one kernel against its plain version at the same rounding points; a
# whole bf16 network against f32 differs by its own rounding (a 2-block
# ViT at 224 pixels already by 1.6 % of its mean logit on the CPU), so the
# bar is set by that noise, measured on the same crops: the same served
# function on the CPU (plain versions, bf16) against the trainer's f32
# logits.  Allowed: |served - f32| <= FLOAT_BF16_TOL's elementwise bar +
# 2x the largest CPU bf16-vs-f32 difference, and the mean |served - f32|
# <= 1.5x the CPU copy's mean plus 2^-9 of the mean |f32| logit.
SERVED_BF16_BAR = {"max_x": 2.0, "mean_x": 1.5, "mean_rel": 2.0 ** -9}
COVER_CLASSES = ("good", "broke", "lose", "uncovered", "circle")
COVER_RGB = {"good": (200, 60, 50), "broke": (60, 200, 60),
             "lose": (210, 200, 60), "uncovered": (50, 60, 210),
             "circle": (60, 200, 210)}


def _cover_image(np, rng, cls: str):
    """A seeded 256 x 320 frame: sensor noise and one filled disk of the
    class's colour; returns (RGB uint8, its VOC object)."""
    h, w = 256, 320
    img = np.clip(rng.normal(110, 20, (h, w, 3)), 0, 255).astype(np.uint8)
    r = int(rng.integers(40, 70))
    cx, cy = (int(rng.integers(r, s - r)) for s in (w, h))
    yy, xx = np.mgrid[:h, :w]
    img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = COVER_RGB[cls]
    return img, {"sort": cls, "xmin": cx - r, "ymin": cy - r,
                 "xmax": cx + r, "ymax": cy + r}


def train_step_check(torch, np, smi: str, steps: int = 20) -> dict:
    """Phase 14 (a): ViT-B/8 (VIT_B8_224, CFG's defaults, params drawn
    from cfg.seed) one optimizer step on a batch of 2 seeded 224 x 224
    crops, on the card and on the CPU, within TRAIN_STEP_TOL; then the
    train step at CFG's train_bs (1) timed with CUDA events a step and
    profiled (device time by kernel, busy share of the p50 step), with
    max_memory_allocated (the process's, earlier phases' runners
    included), the allocation before the steps (those and this model's
    params, gradients and momentum) and the steps' own peak above it."""
    from yolov8_vit_tpu_torch.config import CFG
    from yolov8_vit_tpu_torch.models.vit import VIT_B8_224
    from yolov8_vit_tpu_torch.train.augment import eval_transform
    from yolov8_vit_tpu_torch.train.schedule import cosine_anneal_schedule
    from yolov8_vit_tpu_torch.train.vit_train import (ViTTrainer,
                                                      make_train_step)
    from yolov8_vit_tpu_torch.weights import module_tree
    cfg = CFG()
    rng = np.random.default_rng(14)
    crops = np.stack([eval_transform(rng.integers(
        0, 256, (int(h), int(w), 3), dtype=np.uint8))
        for h, w in rng.integers(120, 400, (2, 2))])
    onehot = np.eye(cfg.num_classes, dtype=np.float32)[
        rng.integers(0, cfg.num_classes, 2)]
    lr = cosine_anneal_schedule(0, cfg.epoch, cfg.lr)
    t0 = time.perf_counter()
    cpu_model, cpu_opt = ViTTrainer(cfg, VIT_B8_224, device="cpu").init()
    card_model, card_opt = ViTTrainer(cfg, VIT_B8_224, device="cuda").init(
        module_tree(cpu_model))
    out = {"card": smi, "init_s": time.perf_counter() - t0, "lr": lr,
           "params": sum(p.numel() for p in cpu_model.parameters())}
    x, y = torch.from_numpy(crops), torch.from_numpy(onehot)
    t0 = time.perf_counter()
    cpu_loss, cpu_c = make_train_step(cpu_model, cpu_opt)(x, y, lr)
    out["cpu_step_s"] = time.perf_counter() - t0
    card_step = make_train_step(card_model, card_opt)
    card_loss, card_c = card_step(x.cuda(), y.cuda(), lr)
    torch.cuda.synchronize()
    loss_rel = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    grad_share, param_abs = 0.0, 0.0
    for (name, pc), (_, pg) in zip(cpu_model.named_parameters(),
                                   card_model.named_parameters()):
        if not bool(torch.isfinite(pg.grad).all()):
            raise AssertionError(f"train step: non-finite gradient of {name}")
        gmax = float(pc.grad.abs().max())
        err = float((pg.grad.cpu() - pc.grad).abs().max())
        if err > TRAIN_STEP_TOL["grad_share"] * gmax:
            raise AssertionError(f"train step: gradient of {name} off by "
                                 f"{err} of max |g| {gmax}")
        grad_share = max(grad_share, err / gmax if gmax else 0.0)
        param_abs = max(param_abs, float((pg.detach().cpu() - pc.detach())
                                         .abs().max()))
    out.update(loss_card=float(card_loss), loss_cpu=float(cpu_loss),
               loss_rel=loss_rel, grad_share=grad_share, param_abs=param_abs,
               correct=[int(card_c), int(cpu_c)])
    if not np.isfinite(float(card_loss)) or loss_rel > TRAIN_STEP_TOL[
            "loss_rel"] or param_abs > TRAIN_STEP_TOL["param_abs"]:
        raise AssertionError(f"train step card vs CPU: {out} beyond "
                             f"{TRAIN_STEP_TOL}")
    del cpu_model, cpu_opt

    x1, y1 = x[:cfg.train_bs].cuda(), y[:cfg.train_bs].cuda()
    for _ in range(3):
        card_step(x1, y1, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    losses = []
    for a, b in ev:
        a.record()
        losses.append(card_step(x1, y1, lr)[0])
        b.record()
    torch.cuda.synchronize()
    ms = np.array([a.elapsed_time(b) for a, b in ev])
    if not all(np.isfinite(float(v)) for v in losses):
        raise AssertionError("train step: a non-finite loss")
    out.update(batch=cfg.train_bs, steps=steps,
               step_ms_p50=float(np.percentile(ms, 50)),
               step_ms_p95=float(np.percentile(ms, 95)),
               steps_per_s=float(1e3 / ms.mean()),
               max_memory_allocated_gb=torch.cuda.max_memory_allocated()
               / 1e9, allocated_before_gb=base / 1e9,
               step_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    # where the step's time goes: device time by kernel over two steps
    os.makedirs(OUT_DIR, exist_ok=True)
    prof = profile_step(torch, types.SimpleNamespace(
        _fn=lambda _: card_step(x1, y1, lr)), None,
        os.path.join(OUT_DIR, "profile_train_step.txt"))
    out["profile"] = dict(prof, busy_share=prof["device_us_per_step"]
                          / (out["step_ms_p50"] * 1e3))
    del card_model, card_opt
    torch.cuda.empty_cache()
    return out


def retrain_phase(torch, ops, np, smi: str, det_tree: dict, frames,
                  n_covers: int = 32, n_valid: int = 10) -> dict:
    """Phase 14 (b): the service's retrain on the card at ViT-B/8's full
    width.  The service (`build_default_service`, enable_retrain, on the
    card) behind `make_http_server` on 127.0.0.1 ingests `n_covers`
    seeded cover images (.bmp, five classes) with their VOC objects
    through POST /getImage after /getConfig set standard = n_covers and
    class_config.epoch = 1; the last label fires retrain_fn, which trains
    one epoch at train_bs 1 (one step an ingested cover: .bmp files stay
    in train/new, a train path) and validates on `n_valid` seeded covers
    of the workdir's train/2024/valid_xmls.  Then weights/class_engine
    must exist; the port's Engine on the card loads it and gives the
    trainer's eval logits (the training form's f32 forward on the
    exported params) within F32_TOL; make_runner serves it in bf16 on
    phase 6's detector with kernels A, B and E launched (launch counts),
    and its classifier's logits on the validation crops lie within
    SERVED_BF16_BAR of the trainer's.  An exception on the retrain thread
    fails the phase."""
    import functools
    import http.server
    import threading
    from yolov8_vit_tpu_torch.config import CFG, DetectConfig
    from yolov8_vit_tpu_torch.data.voc import generate_annotation
    from yolov8_vit_tpu_torch.models.vit import VIT_B8_224, ViTClassifier
    from yolov8_vit_tpu_torch.runtime.engine import Engine
    from yolov8_vit_tpu_torch.serve import imageio
    from yolov8_vit_tpu_torch.serve.app import build_default_service
    from yolov8_vit_tpu_torch.serve.batch_runner import make_runner
    from yolov8_vit_tpu_torch.serve.sse import HUB
    from yolov8_vit_tpu_torch.train.classify import _with_workdir
    from yolov8_vit_tpu_torch.train.dataset import build_dataloaders
    from yolov8_vit_tpu_torch.train.vit_train import ViTTrainer
    from yolov8_vit_tpu_torch.weights import (load_tree, read_engine,
                                              save_engine)
    cfg = CFG()
    root = os.path.join(ENGINE_DIR, "retrain")
    shutil.rmtree(root, ignore_errors=True)
    work, covers = os.path.join(root, "work"), os.path.join(root, "covers")
    valid_dir = os.path.join(work, "train", "2024", "valid_xmls")
    os.makedirs(covers)
    os.makedirs(valid_dir)
    rng = np.random.default_rng(41)
    labels = []
    for i in range(n_covers):
        img, obj = _cover_image(np, rng, COVER_CLASSES[i % 5])
        name = f"cover{i:02d}.bmp"
        imageio.imwrite(os.path.join(covers, name), imageio.bgr2rgb(img))
        labels.append((name, obj))
    for i in range(n_valid):
        img, obj = _cover_image(np, rng, COVER_CLASSES[i % 5])
        name = f"valid{i:02d}.bmp"
        imageio.imwrite(os.path.join(valid_dir, name), imageio.bgr2rgb(img))
        generate_annotation("", name, name, [obj], save_dir=valid_dir,
                            image_size=(img.shape[1], img.shape[0]))
    out: dict = {"card": smi, "covers": n_covers, "valid": n_valid}
    servers, errors = [], []
    old_hook = threading.excepthook

    def hook(args):
        errors.append(args)
        old_hook(args)

    def serve(httpd):
        servers.append(httpd)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    threading.excepthook = hook
    events = HUB.subscribe()
    engine_dir = os.path.join(work, "weights", "class_engine")
    try:
        files = serve(http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), functools.partial(Quiet, directory=covers)))
        svc = build_default_service(work, enable_retrain=True,
                                    device="cuda")
        base = serve(svc.make_http_server("127.0.0.1", 0))
        if _http_json(base + "/getConfig", {
                "standard": n_covers, "class_config": {"epoch": 1}}) != \
                {"state": "修改成功"}:
            raise AssertionError("/getConfig refused the retrain settings")
        for name, obj in labels:
            ans = _http_json(base + "/getImage",
                             {"imageUrl": f"{files}/{name}",
                              "objects": [obj]})
            if "url" not in ans:
                raise AssertionError(f"/getImage {name}: {ans}")
        t0 = time.perf_counter()
        while not (os.path.exists(os.path.join(engine_dir, "params.msgpack"))
                   and svc.training_epochs_left == 0):
            if errors:
                raise AssertionError(f"retrain thread raised: "
                                     f"{errors[0].exc_value!r}")
            if time.perf_counter() - t0 > 600:
                raise AssertionError("retrain: no engine after 600 s")
            time.sleep(0.05)
        out["retrain_s"] = time.perf_counter() - t0
        if errors:
            raise AssertionError(f"retrain thread raised: "
                                 f"{errors[0].exc_value!r}")
        logs = []
        while not events.empty():
            logs.append(events.get_nowait())
        log_text = " ".join(logs)
        for msg in ("Starting training", "Epoch 1:",
                    "Retraining process complete"):
            if msg not in log_text:
                raise AssertionError(f"retrain: no {msg!r} on the SSE hub")
        meta, tree = read_engine(engine_dir)
        if meta["kind"] != "classify" or meta["vit_spec"] != \
                dataclasses.asdict(VIT_B8_224):
            raise AssertionError(f"retrain: engine meta {meta}")

        _, valid = build_dataloaders(_with_workdir(cfg, work))
        imgs = np.concatenate([b[0] for b in valid.batches(cfg.valid_bs)])
        x = torch.from_numpy(imgs).cuda()
        trained, _ = ViTTrainer(cfg, VIT_B8_224, device="cuda").init(
            tree["params"])
        with torch.no_grad():
            ref = trained(x)
        del trained
        if not bool(torch.isfinite(ref).all()):
            raise AssertionError("retrain: non-finite eval logits")
        eng = Engine(engine_dir, device="cuda")
        out["engine_max_abs_err"] = _close(torch, "retrained Engine",
                                           eng(x), ref, F32_TOL)
        del eng
        det_dir = save_engine(os.path.join(root, "detect"), "detect",
                              det_tree,
                              {"detect_cfg": dataclasses.asdict(
                                  DetectConfig())})
        runner = make_runner(det_dir, engine_dir, classify_budget=BUDGET,
                             device="cuda")
        runner.max_batch = BATCH
        pipe = runner.pipeline
        if (pipe.vit_spec.attn_impl, pipe.dtype) != ("fused",
                                                     torch.bfloat16):
            raise AssertionError(f"retrained engine served as "
                                 f"{pipe.vit_spec} in {pipe.dtype}")
        runner.run_device_batches([frames])                  # warm
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        recs = runner.run_device_batches([frames])[0]
        torch.cuda.synchronize()
        out["launches"] = _path_launches(
            ops, "retrained_b8", A_B + ("fused_attention_block",),
            C_D + ("flash_attention",))
        for r in recs:
            for k in ("boxes", "det_scores", "cls_scores"):
                if not np.isfinite(r[k]).all():
                    raise AssertionError(f"retrained_b8: non-finite {k}")
        out["kept"] = sum(int(r["final_valid"].sum()) for r in recs)
        if out["kept"] == 0:
            raise AssertionError("retrained_b8: no detection classified")
        t0 = time.perf_counter()
        cpu_vit = load_tree(ViTClassifier(pipe.vit_spec, pipe.num_classes,
                                          dtype=torch.bfloat16),
                            tree["params"])
        with torch.no_grad():
            served = pipe.vit(x.to(torch.bfloat16)).float()
            cpu_bf16 = cpu_vit(x.cpu().to(torch.bfloat16)).float()
        out["cpu_bf16_s"] = time.perf_counter() - t0
        ref = ref.cpu()
        err = (served.cpu() - ref).abs()
        noise = (cpu_bf16 - ref).abs()
        lim = (FLOAT_BF16_TOL["atol"] + FLOAT_BF16_TOL["rtol"] * ref.abs()
               + SERVED_BF16_BAR["max_x"] * float(noise.max()))
        out.update(served_max_abs_err=float(err.max()),
                   served_mean_abs_err=float(err.mean()),
                   cpu_bf16_max_abs_err=float(noise.max()),
                   cpu_bf16_mean_abs_err=float(noise.mean()),
                   mean_abs_logit=float(ref.abs().mean()),
                   served_argmax_agree=int((served.cpu().argmax(-1)
                                            == ref.argmax(-1)).sum()),
                   cpu_bf16_argmax_agree=int((cpu_bf16.argmax(-1)
                                              == ref.argmax(-1)).sum()))
        if not bool(torch.isfinite(served).all()) \
                or bool((err > lim).any()) \
                or float(err.mean()) > SERVED_BF16_BAR["mean_x"] * float(
                    noise.mean()) + SERVED_BF16_BAR["mean_rel"] * float(
                    ref.abs().mean()):
            raise AssertionError(f"retrained engine served in bf16 against "
                                 f"the trainer's f32 logits beyond "
                                 f"SERVED_BF16_BAR: {out}")
        del runner, pipe
        torch.cuda.empty_cache()
    finally:
        threading.excepthook = old_hook
        HUB.unsubscribe(events)
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        shutil.rmtree(root, ignore_errors=True)
    return out


# phase 15: the detector's training, YOLOv8-s at 640 x 640 in f32 (JAX's
# train() default), run with cuDNN's TF32 switch at PyTorch's default (on):
# the trainer must hold full f32 itself, backward included.  (a) holds one
# step at batch 2 on the card against the same step on the CPU within
# TRAIN_STEP_TOL; (b) times the step at batch 16; (c) runs yolo_retrain on
# DET_RETRAIN_FRAMES street frames and serves the engine it writes.
DET_TRAIN_BATCH = 16            # ultralytics' default batch
DET_RETRAIN_FRAMES = 64


@contextlib.contextmanager
def _tf32_default(torch):
    """cuDNN's TF32 switch at PyTorch's default (True) around trainer
    calls, restored after; fails if a trainer call left it changed."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
        if torch.backends.cudnn.allow_tf32 is not True:
            raise AssertionError("a trainer call left cuDNN's TF32 switch "
                                 "changed")
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _street_workdir(np, root: str, n: int) -> str:
    """A workdir whose train/new holds `n` seeded 640 x 640 street frames
    (.bmp; planted covers, utils/densify.make_cover_scenes, about 1.5 a
    frame, some frames without one) with their VOC XML, every cover a
    "good" box."""
    from yolov8_vit_tpu_torch.data.voc import generate_annotation
    from yolov8_vit_tpu_torch.serve import imageio
    from yolov8_vit_tpu_torch.utils.densify import make_cover_scenes
    new = os.path.join(root, "train", "new")
    os.makedirs(new)
    imgs, covers = make_cover_scenes(np.random.default_rng(15), n,
                                     (640, 640), lam=1.5)
    for i, (img, cs) in enumerate(zip(imgs, covers)):
        name = f"street{i:03d}.bmp"
        imageio.imwrite(os.path.join(new, name), imageio.bgr2rgb(img))
        objs = [{"sort": "good", "xmin": max(cx - r, 0),
                 "ymin": max(cy - r, 0), "xmax": min(cx + r, 640),
                 "ymax": min(cy + r, 640)} for cx, cy, r in cs]
        generate_annotation("", name, name, objs, save_dir=new,
                            image_size=(640, 640))
    return root


def _clipped_grads(opt, named: dict) -> dict:
    """{name: gradient} as the SGD update reads it (after the clip at
    norm 10), captured by a pre-hook of the step."""
    grads: dict = {}
    opt.sgd.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.detach().clone() for n, p in named.items()}))
    return grads


def detector_train_phase(torch, ops, np, smi: str, tree: dict, vit_spec,
                         frames, steps: int = 20) -> dict:
    """Phase 15: the detector's trainer on the card, YOLOv8-s at 640 x 640,
    f32, every trainer call with cuDNN's TF32 switch at PyTorch's default.

    (a) one optimizer step of the seeded training form at batch 2 (the
    first two images of a mosaic batch of the workdir's frames) on the
    card and on the CPU: loss, each leaf's clipped gradient and the
    stepped params within TRAIN_STEP_TOL.  The optimizer is train()'s
    (lr0 = lrf = 1e-4, 100 warmup steps) at the end of its warmup, where
    every group steps at lr0, the rate TRAIN_STEP_TOL's param bar
    assumes; within warmup the bias group steps at up to 0.1, 1000x lr0,
    and so moves its params by 1000x the same gradient difference (the
    loss and the gradients do not depend on the step count); (b) the host's assembly of one batch of
    DET_TRAIN_BATCH (mosaic, HSV, affine), then the step at that batch
    timed with CUDA events (p50, p95, steps/s, img/s), its
    max_memory_allocated and a profile (device time by kernel, busy share
    of the p50 step); (c) `yolo_retrain(workdir, DetectConfig("s"),
    epochs=1, batch=DET_TRAIN_BATCH)` resuming from phase 5's fitted
    detector (weights/detect_engine), validation before and after
    launching kernel A and none of B-J; the engine it writes loaded by the
    port's Engine and served by make_runner with phase 5's ViT-B/16 w8a
    classify engine (`tree`, `vit_spec`) on phase 5's frames, A-D
    launched."""
    import random
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.data.voc import xml2txt
    from yolov8_vit_tpu_torch.runtime.engine import Engine
    from yolov8_vit_tpu_torch.serve.batch_runner import make_runner
    from yolov8_vit_tpu_torch.train import yolo_train as yt
    from yolov8_vit_tpu_torch.weights import read_engine, save_engine
    cfg = DetectConfig(variant="s")
    hw = cfg.input_size
    root = os.path.join(ENGINE_DIR, "detector_train")
    shutil.rmtree(root, ignore_errors=True)
    out: dict = {"card": smi, "frames": DET_RETRAIN_FRAMES}
    try:
        work = _street_workdir(np, os.path.join(root, "work"),
                               DET_RETRAIN_FRAMES)
        fold = os.path.join(root, "fold_a")
        xml2txt(os.path.join(work, "train", "new"), fold,
                rng=random.Random(15))
        ds = yt.YoloDataset(fold, "train", hw[0])
        t0 = time.perf_counter()
        batch = next(ds.batches(DET_TRAIN_BATCH, augment=True, seed=0))
        out["host_batch_s"] = time.perf_counter() - t0
        out["host_batch_images"] = DET_TRAIN_BATCH
        spe = max(len(ds) // DET_TRAIN_BATCH, 1)

        # ---- (a) one step, card against CPU ---------------------------
        two = [torch.from_numpy(a[:2]) for a in batch]

        def one_step(device, count: int):
            """A fresh seeded trainer's step at optimizer count `count`:
            (step fn, loss, clipped gradients, stepped params; on the
            CPU)."""
            model = yt.build_train_model(cfg, None, device)
            named = dict(model.named_parameters())
            opt = yt.make_yolo_optimizer(named, 1e-4, 1.0, 1, spe, 100)
            opt.count = count
            grads = _clipped_grads(opt, named)
            step = yt.make_yolo_train_step(model, opt, hw, cfg.reg_max,
                                           cfg.strides)
            with _tf32_default(torch):
                loss, _ = step(*(a.to(device) for a in two))
            return (step, float(loss), {n: g.cpu() for n, g in grads.items()},
                    {n: p.detach().cpu() for n, p in named.items()})

        def compare(ref, got) -> dict:
            rep = {"loss_rel": abs(got[1] - ref[1]) / abs(ref[1]),
                   "grad_share": 0.0, "param_abs": 0.0}
            for name, gc in ref[2].items():
                if not bool(torch.isfinite(got[2][name]).all()):
                    raise AssertionError(f"detector step: non-finite "
                                         f"gradient of {name}")
                gmax = float(gc.abs().max())
                share = float((got[2][name] - gc).abs().max()) / gmax \
                    if gmax else 0.0
                pa = float((got[3][name] - ref[3][name]).abs().max())
                if share > rep["grad_share"]:
                    rep["grad_share"], rep["worst_grad"] = share, name
                if pa > rep["param_abs"]:
                    rep["param_abs"], rep["worst_param"] = pa, name
            return rep

        t0 = time.perf_counter()
        cpu = one_step("cpu", 100)                  # the end of the warmup
        out["cpu_step_s"] = time.perf_counter() - t0
        card = one_step("cuda", 100)
        card_step = card[0]
        a_rep = dict(compare(cpu, card), loss_card=card[1], loss_cpu=cpu[1])
        out["step_check"] = a_rep
        # not held to a bar, printed: the same step at the warmup's start
        # (bias LR 0.1), and a trainer that leaves the backward's convs
        # to the TF32 switch (what TRAIN_STEP_TOL's gradient bar catches)
        out["warmup_start"] = compare(one_step("cpu", 0),
                                      one_step("cuda", 0))
        held = yt.f32_training
        yt.f32_training = contextlib.nullcontext
        try:
            out["tf32_not_held"] = compare(cpu, one_step("cuda", 100))
        finally:
            yt.f32_training = held
        out["params"] = sum(v.numel() for v in cpu[3].values())
        del cpu
        print(f"detector step card vs CPU (cuDNN TF32 switch on): loss "
              f"{a_rep['loss_card']:.7g} vs {a_rep['loss_cpu']:.7g} "
              f"(rel {a_rep['loss_rel']:.3g}), largest gradient difference "
              f"{a_rep['grad_share']:.3g} of its leaf's max |g| "
              f"({a_rep.get('worst_grad')}), largest param difference "
              f"{a_rep['param_abs']:.3g} ({a_rep.get('worst_param')}); at "
              f"the warmup's start (bias LR 0.1) params "
              f"{out['warmup_start']['param_abs']:.3g} "
              f"({out['warmup_start'].get('worst_param')}); a trainer "
              f"leaving the backward to the TF32 switch: gradients "
              f"{out['tf32_not_held']['grad_share']:.3g} "
              f"({out['tf32_not_held'].get('worst_grad')})", flush=True)
        if not np.isfinite(a_rep["loss_card"]) or \
                a_rep["loss_rel"] > TRAIN_STEP_TOL["loss_rel"] or \
                a_rep["grad_share"] > TRAIN_STEP_TOL["grad_share"] or \
                a_rep["param_abs"] > TRAIN_STEP_TOL["param_abs"]:
            raise AssertionError(f"detector step card vs CPU: {a_rep} "
                                 f"beyond {TRAIN_STEP_TOL}")

        # ---- (b) the step at batch DET_TRAIN_BATCH, timed -----------------
        full = [torch.from_numpy(a).cuda() for a in batch]
        with _tf32_default(torch):
            for _ in range(3):
                card_step(*full)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(steps)]
            losses = []
            for a, b in ev:
                a.record()
                losses.append(card_step(*full)[0])
                b.record()
            torch.cuda.synchronize()
        ms = np.array([a.elapsed_time(b) for a, b in ev])
        if not all(np.isfinite(float(v)) for v in losses):
            raise AssertionError("detector step: a non-finite loss")
        out.update(batch=DET_TRAIN_BATCH, steps=steps,
                   step_ms_p50=float(np.percentile(ms, 50)),
                   step_ms_p95=float(np.percentile(ms, 95)),
                   steps_per_s=float(1e3 / ms.mean()),
                   img_per_s=float(DET_TRAIN_BATCH * 1e3 / ms.mean()),
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                   / 1e9, allocated_before_gb=base / 1e9,
                   step_peak_gb=(torch.cuda.max_memory_allocated() - base)
                   / 1e9)
        os.makedirs(OUT_DIR, exist_ok=True)
        with _tf32_default(torch):
            prof = profile_step(torch, types.SimpleNamespace(
                _fn=lambda _: card_step(*full)), None,
                os.path.join(OUT_DIR, "profile_detector_train_step.txt"))
        out["profile"] = dict(prof, busy_share=prof["device_us_per_step"]
                              / (out["step_ms_p50"] * 1e3))
        del card, card_step, full
        torch.cuda.empty_cache()

        # ---- (c) the retrain end to end, then served ----------------------
        det_dir = os.path.join(work, "weights", "detect_engine")
        save_engine(det_dir, "detect", tree["det"],
                    {"detect_cfg": dataclasses.asdict(DetectConfig())})
        random.seed(15)                 # xml2txt's train / val draw
        logs: list = []
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with _tf32_default(torch):
            metrics = yt.yolo_retrain(work, cfg, epochs=1,
                                      batch=DET_TRAIN_BATCH,
                                      log_fn=logs.append, device="cuda")
            torch.cuda.synchronize()
        out["retrain_s"] = time.perf_counter() - t0
        out["retrain_launches"] = _path_launches(
            ops, "detector_retrain", ("efficient_nms_scan",),
            ("area_sorted_nms",) + C_D + E_F)
        for msg in ("resumed from", "epoch 1/1", "detect engine exported"):
            if not any(msg in line for line in logs):
                raise AssertionError(f"yolo_retrain: no {msg!r} in {logs}")
        if set(metrics) != {"preval", "final"}:
            raise AssertionError(f"yolo_retrain metrics: {metrics}")
        out.update(
            map50_before=metrics["preval"]["map50"],
            map50_95_before=metrics["preval"]["map50_95"],
            map50_after=metrics["final"]["map50"],
            map50_95_after=metrics["final"]["map50_95"],
            train_images=len(yt.YoloDataset(
                os.path.join(work, "train/yolo/fold0"), "train")),
            val_images=len(yt.YoloDataset(
                os.path.join(work, "train/yolo/fold0"), "val")),
            log=[line for line in logs if line.startswith("epoch")])
        meta, _ = read_engine(det_dir)
        want = json.loads(json.dumps(dataclasses.asdict(cfg)))
        if meta["kind"] != "detect" or meta["detect_cfg"] != want:
            raise AssertionError(f"retrained engine meta {meta}")
        eng = Engine(det_dir, device="cuda")
        x = frames[:8].permute(0, 3, 1, 2).float() / 255.0
        num, boxes, scores, labels = eng(x)
        if not (bool(torch.isfinite(boxes).all())
                and bool(torch.isfinite(scores).all())) \
                or tuple(boxes.shape) != (len(x), cfg.nms_topk, 4):
            raise AssertionError(f"retrained engine: {tuple(boxes.shape)}")
        out["engine_dets"] = int(num.sum())
        del eng
        cls_dir = save_engine(
            os.path.join(root, "classify"), "classify", tree["vit"],
            {"vit_spec": dataclasses.asdict(vit_spec), "num_classes": 5})
        runner = make_runner(det_dir, cls_dir, classify_budget=BUDGET,
                             device="cuda")
        runner.max_batch = BATCH
        if runner.pipeline.vit_spec.quant != "w8a":
            raise AssertionError(f"served {runner.pipeline.vit_spec}")
        runner.run_device_batches([frames])                  # warm
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        recs = runner.run_device_batches([frames])[0]
        torch.cuda.synchronize()
        out["served_launches"] = _path_launches(
            ops, "retrained_detect_served", A_B + C_D, E_F)
        for r in recs:
            for k in ("boxes", "det_scores", "cls_scores"):
                if not np.isfinite(r[k]).all():
                    raise AssertionError(f"retrained detector served: "
                                         f"non-finite {k}")
        out["served_dets"] = sum(int(r["num_dets"]) for r in recs)
        out["served_kept"] = sum(int(r["final_valid"].sum()) for r in recs)
        del runner
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _report(name: str, rep: dict) -> None:
    print(f"{name}: " + json.dumps(
        {k: v for k, v in rep.items() if k != "frames"}), flush=True)


def main() -> int:
    import numpy as np
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
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    build_s = _build.build()
    print(f"build: {build_s:.1f} s (wall {time.perf_counter() - t0:.1f} s)",
          flush=True)
    ptxas = {}
    for lib_name, what in (("quant_mlp", "C, G, H"), ("attention", "D, E, F"),
                           ("nms", "A, B, I"), ("fused_region", "J")):
        ptxas[lib_name] = _ptxas_summary(_build.build_log(lib_name))
        print(f"ptxas, {lib_name} library ({what}):\n  "
              + "\n  ".join(ptxas[lib_name]), flush=True)

    t0 = time.perf_counter()
    rows, part_calls = check_kernels(torch, ops, mlp_rows=64 * 197,
                                     crops=BATCH * BUDGET)
    b8_rows, f32_err, bf16_stats, b8_calls = check_attention_b8(
        torch, ops, crops=BATCH * BUDGET, f32_crops=16)
    rows += b8_rows
    part_calls.update(b8_calls)
    for r in rows:
        print(f"kernel {r['name']}: ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}) library_ms {r['library_ms']} "
              f"max_abs_err {r['max_abs_err']}"
              + (f" kernel_ms {r['kernel_ms']:.4f} by_input "
                 f"{json.dumps(r['by_input'])}" if "kernel_ms" in r else "")
              + (f" (transposing per call: "
                 f"{r['ms_transposing_per_call']:.4f} ms)"
                 if "ms_transposing_per_call" in r else "")
              + (f" gemm_library_ms {r['gemm_library_ms']}"
                 if "gemm_library_ms" in r else "")
              + (f" int_mm_ms {r['int_mm_ms']}" if "int_mm_ms" in r else ""),
              flush=True)
    # derived or copied numbers, kept out of the kernel rows
    reference = {"before_redesign_ms": PREV_MS,
                 "fused_b1b2_before_redesign_trace": PREV_J_TRACE,
                 "exp_floor_ms": {r["name"]: r.pop("exp_floor_ms")
                                  for r in rows if "exp_floor_ms" in r}}
    print("not measured in this run: A-J before their redesign (PERF.md; "
          "A, B and I: the argmax-per-pick kernels' wrapper times on the "
          "dense inputs; J: its five launches, traced by kernel_cost.py "
          "region) "
          f"and the SDPA core's exponential floor: {json.dumps(reference)}",
          flush=True)
    head_dims, wide_ms = check_head_dims(torch, ops)
    print(f"D, E, F at head dims {PAD_HEAD_DIMS} (KERNEL_TOL, "
          f"FLOAT_BF16_TOL, F32_TOL): {json.dumps(head_dims)}", flush=True)
    print(f"D, E, F at head dims {WIDE_HEAD_DIMS} (the SDPA core's wide "
          f"form; 8 x 197 tokens, 12 heads), ms on {smi}: "
          f"{json.dumps(wide_ms)}", flush=True)
    print(f"f32 checks (F32_TOL {F32_TOL}): {json.dumps(f32_err)}")
    print(f"bf16 E, F (FLOAT_BF16_TOL {FLOAT_BF16_TOL}): "
          f"{json.dumps(bf16_stats)}")
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s", flush=True)

    small = {q: small_input_check(torch, q) for q in ("w8a", "none")}
    print(f"small input card == CPU: {small}", flush=True)

    paths = {}
    t0 = time.perf_counter()
    paths["vit_b16_w8a"], b16_runner, b16_tree = b16_w8a_slice(
        torch, ops, BATCHES)
    _report(f"ViT-B/16 w8a slice ({time.perf_counter() - t0:.1f} s)",
            paths["vit_b16_w8a"])
    t0 = time.perf_counter()
    run_nms = nms_run_data(torch, ops, b16_runner.pipeline,
                           paths["vit_b16_w8a"]["frames"])
    for r in rows:
        if r["name"] in ROW_WRAPPER and "by_input" in r:
            r["by_input"]["run"] = run_nms[
                "A" if r["name"] == "nms_argmax_ml" else "B"]
    _report(f"A and B on the run's data ({time.perf_counter() - t0:.1f} s)",
            run_nms)
    t0 = time.perf_counter()
    paths["vit_b8_float"], b8_runner, b8_tree = b8_float_slice(
        torch, ops, BATCHES)
    _report(f"ViT-B/8 float slice ({time.perf_counter() - t0:.1f} s)",
            paths["vit_b8_float"])
    frames = paths["vit_b8_float"]["frames"]
    t0 = time.perf_counter()
    runs, b8_w8a_runner = b8_engine_runs(torch, ops, b8_tree["det"],
                                         b8_tree["vit"]["params"], frames)
    paths.update(runs)
    _report(f"ViT-B/8 engines through make_runner "
            f"({time.perf_counter() - t0:.1f} s)", runs)
    t0 = time.perf_counter()
    eng = engine_phase(torch, ops, b8_tree["vit"]["params"], b16_runner,
                       b16_tree, paths["vit_b16_w8a"]["frames"])
    paths["engine_classify"] = {"launches": eng["classify_launches"]}
    _report(f"Engine ({time.perf_counter() - t0:.1f} s)", eng)
    t0 = time.perf_counter()
    conv = detector_convs(torch, b16_runner.pipeline.det,
                          paths["vit_b16_w8a"]["frames"])
    _report(f"detector convs ({time.perf_counter() - t0:.1f} s)",
            {k: v for k, v in conv.items() if k != "per_conv"})
    t0 = time.perf_counter()
    b16_pipe = b16_runner.pipeline
    kept = kept_set_phase(torch, np, b16_pipe.det_cfg, b16_pipe.vit_spec,
                          b16_tree, paths["vit_b16_w8a"]["frames"])
    _report(f"kept set card vs CPU ({time.perf_counter() - t0:.1f} s)",
            {k: v for k, v in kept.items() if not isinstance(v, dict)})

    t0 = time.perf_counter()
    gj_rows, gj_launches, gj = public_ops_phase(
        torch, ops, b16_runner.pipeline, b16_tree,
        paths["vit_b16_w8a"]["frames"], mlp_rows=64 * 197)
    rows += gj_rows
    paths["public_ops"] = {"launches": gj_launches}
    for r in gj_rows:
        print(f"kernel {r['name']}: ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}) library_ms {r['library_ms']} "
              f"max_abs_err {r['max_abs_err']}", flush=True)
    _report(f"kernels G-J ({time.perf_counter() - t0:.1f} s)", gj)
    t0 = time.perf_counter()
    service = service_phase(torch, ops, b16_tree,
                            b16_runner.pipeline.vit_spec, smi)
    print(f"service on {smi}: fused POST / of {BATCH} URLs "
          f"{service['fused_request_s']} s, host route "
          f"{service['host_request_s']} s", flush=True)
    _report(f"service ({time.perf_counter() - t0:.1f} s)", service)

    t0 = time.perf_counter()
    train = {"step": train_step_check(torch, np, smi)}
    train["retrain"] = retrain_phase(torch, ops, np, smi, b8_tree["det"],
                                     paths["vit_b8_float"]["frames"])
    paths["retrained_b8"] = {"launches": train["retrain"]["launches"]}
    st, rt = train["step"], train["retrain"]
    print(f"train on {smi}: ViT-B/8 f32 step at batch {st['batch']} p50 "
          f"{st['step_ms_p50']:.2f} ms p95 {st['step_ms_p95']:.2f} ms, "
          f"{st['steps_per_s']:.2f} steps/s, max_memory_allocated "
          f"{st['max_memory_allocated_gb']:.2f} GB ({st['step_peak_gb']:.2f}"
          f" GB above the {st['allocated_before_gb']:.2f} GB held before "
          f"the steps); service retrain "
          f"({rt['covers']} steps + validation of {rt['valid']} crops, "
          f"export) {rt['retrain_s']:.1f} s wall", flush=True)
    _report("train step card vs CPU", st)
    _report(f"retrain through the service "
            f"({time.perf_counter() - t0:.1f} s)", rt)

    t0 = time.perf_counter()
    det = train["detector"] = detector_train_phase(
        torch, ops, np, smi, b16_tree, b16_runner.pipeline.vit_spec,
        paths["vit_b16_w8a"]["frames"])
    paths["detector_retrain"] = {"launches": det["retrain_launches"]}
    paths["retrained_detect_served"] = {"launches": det["served_launches"]}
    print(f"detector train on {smi}: YOLOv8-s f32 640 x 640 step at batch "
          f"{det['batch']} p50 {det['step_ms_p50']:.2f} ms p95 "
          f"{det['step_ms_p95']:.2f} ms, {det['steps_per_s']:.2f} steps/s, "
          f"{det['img_per_s']:.1f} img/s, busy share "
          f"{det['profile']['busy_share']:.2f}, max_memory_allocated "
          f"{det['max_memory_allocated_gb']:.2f} GB "
          f"({det['step_peak_gb']:.2f} GB above the "
          f"{det['allocated_before_gb']:.2f} GB held before the steps); "
          f"host batch assembly (mosaic, HSV, affine) "
          f"{det['host_batch_s']:.2f} s for {det['host_batch_images']} "
          f"images; yolo_retrain ({det['train_images']} train, "
          f"{det['val_images']} val frames, 1 epoch) "
          f"{det['retrain_s']:.1f} s wall, mAP50 {det['map50_before']:.4f} "
          f"-> {det['map50_after']:.4f}, mAP50-95 "
          f"{det['map50_95_before']:.4f} -> {det['map50_95_after']:.4f}; "
          f"kernel A launched {det['retrain_launches']['efficient_nms_scan']}"
          f" times in validation", flush=True)
    _report(f"detector training ({time.perf_counter() - t0:.1f} s)", det)

    os.makedirs(OUT_DIR, exist_ok=True)
    prof = {}
    b16_frames = paths["vit_b16_w8a"].pop("frames")
    b8_frames = paths["vit_b8_float"].pop("frames")
    for name, runner, fr in (("vit_b16_w8a", b16_runner, b16_frames),
                             ("vit_b8_float", b8_runner, b8_frames),
                             ("vit_b8_w8a", b8_w8a_runner, b8_frames)):
        p = profile_step(torch, runner, fr,
                         os.path.join(OUT_DIR, f"profile_{name}.txt"))
        # share of the (unprofiled) fused step the device spends in kernels
        p["busy_share"] = p["device_us_per_step"] / (
            paths[name]["fused_step_ms"] * 1e3)
        prof[name] = p
        print(f"profile of one {name} fused step: {json.dumps(p)}",
              flush=True)

    split = prof["vit_b8_float"].get("attn_block_split_ms", {})
    if set(split) != set(E_PARTS):
        raise AssertionError(f"profile of the ViT-B/8 float step: E's parts "
                             f"{sorted(split)}, not {sorted(E_PARTS)}")
    splits = {"attn_block": split}
    for name, parts in (("quant_mlp_ln", C_PARTS), ("attn_block_i8", D_PARTS),
                        ("attn_block_i8_t785", D_PARTS)):
        splits[name] = profile_parts(torch, part_calls[name], parts)
        print(f"profile of one {name} call, device ms: "
              f"{json.dumps(splits[name])}", flush=True)
    kernels = []
    for r in rows:
        wrapper, path = ROW_WRAPPER[r["name"]]
        r = dict(r, launches=paths[path]["launches"][wrapper])
        if r["name"] in splits:
            r["split_ms"] = splits[r["name"]]
        for extra in ("picks", "by_shape", "by_input", "shape",
                      "silu_max_abs_err", "ms_transposing_per_call"):
            r.pop(extra, None)
        kernels.append(r)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build_s": build_s, "kernels": kernels,
                   "f32_checks": f32_err, "bf16_checks": bf16_stats,
                   "head_dims": head_dims,
                   "small_input": small,
                   "paths": paths, "engine": eng, "detector_convs": conv,
                   "kept_set": kept,
                   "public_ops": gj, "service": service, "train": train,
                   "head_dims_wide_ms": wide_ms,
                   "profile": prof, "ptxas": ptxas,
                   "not_measured": reference,
                   "total_s": time.perf_counter() - t_all}, f, indent=1)
    print(f"total: {time.perf_counter() - t_all:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
