"""Bulk frames: a closed loop of device-resident frame batches through
`BatchRunner.run_device_batches`, the port's bulk entry (fused step:
letterbox, YOLOv8, DFL, stage-1 NMS, stage-2 NMS, crops, ViT; the
result fetch and the overflow ladder run inside the window).

Mix parameters: batch, budget (classify slots a frame), pool_batches
(distinct batches, cycled through the window), lam (covers a frame),
height, width, fit_frames (scenes the detect head is fitted on), box_bin
(the fitted head's box size in DFL bins: scenes.fit_head),
trace_batches (batches of the traced slice).

frames_per_s counts every frame of the window, each complete once all its
kept boxes are classified, over the whole window's time.
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from benchmark import judge as judge_mod
from benchmark import program, scenes, weights
from benchmark.reference.pipeline import Pipeline, exact_f32
from benchmark.weights import sub_seed


def setup(ctx) -> dict:
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    import yolov8_vit_tpu_torch.serve.batch_runner  # noqa: F401
    ctx.mark("import")
    if dev != "cpu":
        from yolov8_vit_tpu_torch import _build
        _build.build(["nms", "quant_mlp", "attention"])
        ctx.mark("build")
    hw = (mix["height"], mix["width"])
    tree = weights.make_tree(cfg, sub_seed(ctx.seed, 0), dev)
    fit, covers = scenes.cover_scenes(sub_seed(ctx.seed, 1),
                                      mix["fit_frames"], hw, mix["lam"], dev)
    with exact_f32():
        scenes.fit_head(tree, cfg, fit, covers, box_bin=mix["box_bin"])
    del fit
    ctx.mark("weights_fit")
    pipe, runner = program.bulk_runner(cfg, mix, tree, dev)
    pool = [scenes.cover_scenes(sub_seed(ctx.seed, 2, b), mix["batch"], hw,
                                mix["lam"], dev)[0]
            for b in range(mix["pool_batches"])]
    ctx.mark("frames")
    # every shape the window runs: the fused step and the ladder's chunks
    runner.run_device_batches(pool)
    program.warm_ladder(pipe, pool[0], runner.max_batch)
    if dev != "cpu":
        torch.cuda.synchronize()
    ctx.mark("warmup")
    state = {"tree": tree, "pipe": pipe, "runner": runner, "pool": pool,
             "hooks": None}
    if ctx.trace:
        from benchmark.trace import SpanHooks, profiled
        with profiled(dev):        # the first session of a process may
            runner.run_device_batches(pool[:1])   # come back empty
        state["hooks"] = SpanHooks({"det": pipe.det, "vit": pipe.vit})
        ctx.mark("trace_warmup")
    return state


def _stream(pool, seconds: float, count: list):
    end = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < end:
        count[0] += 1
        yield pool[i % len(pool)]
        i += 1


def window(ctx, state) -> dict:
    runner, pool, batch = state["runner"], state["pool"], ctx.mix["batch"]
    fed = [0]
    prof: dict = {}
    t0 = time.perf_counter()
    recs = runner.run_device_batches(_stream(pool, ctx.seconds, fed),
                                     profile=prof)
    dt = time.perf_counter() - t0
    done = sum(len(r) for r in recs)
    kept = sum(int(r["final_valid"].sum()) for rs in recs for r in rs)
    out = {"e2e": {"frames_per_s": done / dt}, "attempted": fed[0] * batch,
           "failed": fed[0] * batch - done, "recs": recs, "window_s": dt,
           "steps": fed[0], "notes": [
               f"window: {fed[0]} batches of {batch} in {dt:.4f} s; "
               f"kept boxes a frame {kept / max(done, 1):.4f}; "
               f"ladder detections {prof.get('overflow_dets', 0)}"]}
    hooks = state["hooks"]
    if hooks is not None:
        out["vit_rows"] = sum(hooks.calls["vit"])
        out["det_calls"] = len(hooks.calls["det"])
        hooks.reset()
    return out


def trace_slice(ctx, state, win) -> dict:
    """Two traced slices of `trace_batches` batches: the device alone
    (busy share over the slice's host time: the least overhead), then host
    and device with the operators' shapes (spans, operators, rooflines,
    breakdown)."""
    from benchmark.trace import profiled
    runner, pool = state["runner"], state["pool"]
    batches = [pool[i % len(pool)] for i in range(ctx.mix["trace_batches"])]
    traces = {}
    for host in (False, True):
        for _ in range(3):
            with profiled(ctx.device, host=host) as box:
                runner.run_device_batches(batches)
            tr = box["trace"]
            if tr.busy_s > 0 or ctx.device == "cpu":
                break
            ctx.log("traced slice holds no device operation; tracing again")
        traces[host] = tr
    return {"trace": traces[True], "device_trace": traces[False],
            "cfg": ctx.cfg, "mix": ctx.mix, "window_s": win["window_s"],
            "steps": win["steps"], "vit_rows": win.get("vit_rows", 0)}


def reference_sets(pipe_ref: Pipeline, pool) -> dict:
    """{(batch, frame): {anchors, anchors_raw}} of the reference over the
    pool: every anchor's box (clipped to the frame, and as stage 1
    compares it) and scores."""
    out = {}
    for b, frames in enumerate(pool):
        for f, det in enumerate(pipe_ref.detect(frames)):
            out[(b, f)] = {"anchors": det["anchors"],
                           "anchors_raw": det["anchors_raw"]}
    return out


def _classifier(pipe_ref: Pipeline, pool):
    def classify(requests):
        logits = np.zeros((len(requests),
                           pipe_ref.vit.p["fc2.bias"].shape[0]))
        by_batch: dict = {}
        for i, ((b, f), box) in enumerate(requests):
            by_batch.setdefault(b, []).append((i, f, box))
        for b, items in by_batch.items():
            idx = [i for i, _, _ in items]
            logits[idx] = pipe_ref.classify(
                pool[b], np.array([f for _, f, _ in items]),
                np.array([box for _, _, box in items]))
        return logits
    return classify


def served_frames(recs, pool_len: int):
    """[((batch, frame), rec)] of the window, each distinct output once."""
    seen, out = set(), []
    for i, batch in enumerate(recs):
        for f, rec in enumerate(batch):
            h = hashlib.blake2b(digest_size=16)
            for k in ("boxes", "det_scores", "det_labels", "final_valid",
                      "cls_labels", "cls_scores"):
                h.update(np.ascontiguousarray(rec[k]).tobytes())
            key = (i % pool_len, f, h.digest())
            if key not in seen:
                seen.add(key)
                out.append(((i % pool_len, f), rec))
    return out


def check(ctx, state, win) -> dict:
    """Every output of the window against the float32 reference."""
    pool = state["pool"]
    state.pop("runner")
    state.pop("pipe")
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    with exact_f32():
        ref = Pipeline(state["tree"], ctx.cfg)
        sets = reference_sets(ref, pool)
        readings = judge_mod.judge(served_frames(win["recs"], len(pool)),
                                   sets, _classifier(ref, pool),
                                   ctx.cfg["num_classes"],
                                   ctx.cfg["detector"])
    readings["frames_missing"] = win["failed"]
    return readings


def control(ctx, state) -> dict:
    """The reference one precision step below the configuration (the
    detector's convs in fp8 for bf16; the ViT's block GEMMs in int4 for
    w8a, fp8 for bf16), put in the program's place over the pool, judged
    as the program is."""
    pool = state["pool"]
    low = {"w8a": "w4a"}.get(ctx.cfg["vit"]["quant"], "fp8")
    with exact_f32():
        ref = Pipeline(state["tree"], ctx.cfg)
        lowp = Pipeline(state["tree"], ctx.cfg, det_lowp=True,
                        vit_mode=low)
        served = []
        for b, frames in enumerate(pool):
            for f, det in enumerate(lowp.detect(frames)):
                k = np.nonzero(det["keep"])[0]
                logits = lowp.classify(frames, np.full(len(k), f),
                                       det["boxes"][k])
                z = np.exp(logits - logits.max(-1, keepdims=True))
                p = z / z.sum(-1, keepdims=True)
                t = len(det["boxes"])
                lab = np.full(t, -1)
                sc = np.zeros(t)
                lab[k] = logits.argmax(-1)
                sc[k] = p.max(-1)
                served.append(((b, f), {
                    "num_dets": t, "boxes": det["boxes"], "det_scores": det["scores"],
                    "det_labels": det["labels"], "final_valid": det["keep"],
                    "cls_labels": lab, "cls_scores": sc}))
        sets = reference_sets(ref, pool)
        return judge_mod.judge(served, sets, _classifier(ref, pool),
                               ctx.cfg["num_classes"], ctx.cfg["detector"])
