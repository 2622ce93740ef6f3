"""Bulk frames with SwinV2 as the crop classifier: `bulk`'s closed loop of
device-resident frame batches through `BatchRunner.run_device_batches`,
the classifier built from a SwinV2 configuration (`"vit": {"arch":
"swinv2", ...}`, timm's SwinTransformerV2 arguments).

Set-up builds the Swin tree from the seed (`make_tree`), the pipeline
(`TwoStagePipeline` with a `SwinV2Spec`) and, for the check, the
reference pipeline with reference/swin.py in the ViT's place; the window and
the judge are bulk's, and so is the traced slice, which also records the
crops of each classifier call it traced.  The window's note adds the
runner's `cls_windows` counter: the attention windows the classifier ran.
Mix parameters as `bulk`'s.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import judge as judge_mod
from benchmark import program, scenes
from benchmark import weights as bench_weights
from benchmark.drivers import bulk
from benchmark.reference import swin as ref_swin
from benchmark.reference import yolov8 as ref_yolo
from benchmark.reference.pipeline import Pipeline, _flat, exact_f32
from benchmark.weights import sub_seed
from yolov8_vit_tpu_torch.models.swin import SwinV2Spec


def swin_spec(cfg: dict) -> SwinV2Spec:
    v = cfg["vit"]
    return SwinV2Spec(img_size=v["img_size"], patch=v["patch_size"],
                      embed_dim=v["embed_dim"], depths=tuple(v["depths"]),
                      heads=tuple(v["num_heads"]), window=v["window_size"],
                      mlp_ratio=v["mlp_ratio"], ln_eps=v["ln_eps"],
                      backbone_classes=v["backbone_classes"])


def make_tree(cfg: dict, seed: int, device) -> dict:
    """{"det": {"params"}, "vit": {"params"}} float32 on `device`, one draw
    of noise as weights.make_tree draws it: the detector's leaves first,
    then the classifier's (reference/swin.py's shapes, in timm's layout)."""
    det = ref_yolo.param_shapes(cfg["detector"])
    cls = ref_swin.param_shapes(cfg["vit"], cfg["num_classes"])
    total = sum(math.prod(s) for s, init in (*det.values(), *cls.values())
                if init == "lecun")
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(total, generator=gen, device=device)
    n_det = sum(math.prod(s) for s, init in det.values() if init == "lecun")
    fill = bench_weights._fill
    return {"det": {"params": bench_weights._nest(fill(det, noise[:n_det]))},
            "vit": {"params": bench_weights._nest(ref_swin.timm_layout(
                fill(cls, noise[n_det:])))}}


def bulk_runner(cfg: dict, mix: dict, tree: dict, device: str):
    """(pipeline, BatchRunner) at the mix's batch and classify budget."""
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner
    from yolov8_vit_tpu_torch.weights import load_pipeline_tree
    pipe = TwoStagePipeline(det_cfg=program.det_config(cfg),
                            vit_spec=swin_spec(cfg),
                            num_classes=cfg["num_classes"],
                            classify_budget=mix["budget"],
                            dtype=program.DTYPES[cfg["dtype"]], device=device)
    load_pipeline_tree(pipe, tree)
    return pipe, BatchRunner(pipe, max_batch=mix["batch"])


class SwinPipeline(Pipeline):
    """The reference pipeline with reference/swin.py as the classifier."""

    def __init__(self, tree: dict, cfg: dict, det_lowp: bool = False,
                 vit_mode: str = "f32"):
        super().__init__(tree, cfg, det_lowp=det_lowp)
        self.vit = ref_swin.SwinV2(_flat(tree["vit"]["params"]), cfg["vit"],
                                   mode=vit_mode)


def setup(ctx) -> dict:
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    import yolov8_vit_tpu_torch.serve.batch_runner  # noqa: F401
    ctx.mark("import")
    if dev != "cpu":
        from yolov8_vit_tpu_torch import _build
        _build.build(["nms", "conv_silu", "window_attn"])
        ctx.mark("build")
    hw = (mix["height"], mix["width"])
    tree = make_tree(cfg, sub_seed(ctx.seed, 0), dev)
    fit, covers = scenes.cover_scenes(sub_seed(ctx.seed, 1),
                                      mix["fit_frames"], hw, mix["lam"], dev)
    with exact_f32():
        scenes.fit_head(tree, cfg, fit, covers, box_bin=mix["box_bin"])
    del fit
    ctx.mark("weights_fit")
    pipe, runner = bulk_runner(cfg, mix, tree, dev)
    pool = [scenes.cover_scenes(sub_seed(ctx.seed, 2, b), mix["batch"], hw,
                                mix["lam"], dev)[0]
            for b in range(mix["pool_batches"])]
    ctx.mark("frames")
    runner.run_device_batches(pool)
    program.warm_ladder(pipe, pool[0], runner.max_batch)
    if dev != "cpu":
        torch.cuda.synchronize()
    ctx.mark("warmup")
    state = {"tree": tree, "pipe": pipe, "runner": runner, "pool": pool,
             "hooks": None}
    if ctx.trace:
        from benchmark.trace import SpanHooks, profiled
        with profiled(dev):
            runner.run_device_batches(pool[:1])
        state["hooks"] = SpanHooks({"det": pipe.det, "vit": pipe.vit})
        ctx.mark("trace_warmup")
    return state


def window(ctx, state) -> dict:
    """bulk's window; its note also gives the runner's cls_windows."""
    runner = state["runner"]
    seen: dict = {}
    run = runner.run_device_batches

    def recording(batches, profile=None):
        seen["profile"] = profile
        return run(batches, profile=profile)

    runner.run_device_batches = recording
    try:
        out = bulk.window(ctx, state)
    finally:
        del runner.run_device_batches
    prof = seen.get("profile") or {}
    out["notes"].append(f"classifier windows {prof.get('cls_windows', 0)} "
                        f"({out['steps']} steps)")
    return out


def trace_slice(ctx, state, win) -> dict:
    """bulk's traced slices; the record also gives the crops of each
    classifier call in the slice with the operators' shapes (the last one
    traced), `slice_cls_rows`, for the window kernel's roofline."""
    runner, hooks = state["runner"], state["hooks"]
    run = runner.run_device_batches

    def fresh(batches, profile=None):
        hooks.reset()
        return run(batches, profile=profile)

    runner.run_device_batches = fresh
    try:
        rec = bulk.trace_slice(ctx, state, win)
    finally:
        del runner.run_device_batches
    rec["slice_cls_rows"] = list(hooks.calls["vit"])
    return rec


def check(ctx, state, win) -> dict:
    """Every output of the window against the float32 reference."""
    pool = state["pool"]
    state.pop("runner")
    state.pop("pipe")
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    with exact_f32():
        ref = SwinPipeline(state["tree"], ctx.cfg)
        sets = bulk.reference_sets(ref, pool)
        readings = judge_mod.judge(bulk.served_frames(win["recs"], len(pool)),
                                   sets, bulk._classifier(ref, pool),
                                   ctx.cfg["num_classes"],
                                   ctx.cfg["detector"])
    readings["frames_missing"] = win["failed"]
    return readings


def control(ctx, state) -> dict:
    """The reference one precision step below bf16 (the detector's convs
    and the Swin's block GEMMs in fp8), put in the program's place over
    the pool, judged as the program is."""
    pool = state["pool"]
    with exact_f32():
        ref = SwinPipeline(state["tree"], ctx.cfg)
        lowp = SwinPipeline(state["tree"], ctx.cfg, det_lowp=True,
                            vit_mode="fp8")
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
                    "num_dets": t, "boxes": det["boxes"],
                    "det_scores": det["scores"], "det_labels": det["labels"],
                    "final_valid": det["keep"], "cls_labels": lab,
                    "cls_scores": sc}))
        sets = bulk.reference_sets(ref, pool)
        return judge_mod.judge(served, sets, bulk._classifier(ref, pool),
                               ctx.cfg["num_classes"], ctx.cfg["detector"])
