"""Engine build CLI: checkpoints -> engine dirs (the reference's
`export-det.py` + `build.py` step), the counterpart of the JAX package's
`runtime/export.py`.

One step converts a PyTorch checkpoint (an ultralytics `.pt` state dict
for detect, a Network_Wrapper `.pth` for classify) into an engine dir
with the NMS protocol in meta.json; without `--weights` the parameters
are drawn from seed 0.  `two-stage` merges a detect and a classify engine
into one.  The dirs equal the JAX package's export of the same
checkpoint, and either package's `Engine` loads them.

    python3 -m yolov8_vit_tpu_torch.runtime.export detect --weights best.pt \\
        --out weights/detect_engine --iou-thres 0.65 --conf-thres 0.25 --topk 100
    python3 -m yolov8_vit_tpu_torch.runtime.export classify \\
        --weights best.pth --out weights/class_engine \\
        --model vit_base_patch8_224.augreg_in21k [--quant w8a]
    python3 -m yolov8_vit_tpu_torch.runtime.export two-stage \\
        --detect-engine weights/detect_engine \\
        --classify-engine weights/class_engine --out weights/two_stage \\
        --aot 8 --compiled 8 --aot-dtype bfloat16

The conversion is host work (numpy and the CPU).  The JAX CLI's artifact
flags, with its names and defaults, write serialized graphs of the
engine (runtime/engine.py; each traces the model once, on the device
named):

  --aot BATCH...        `attach_aot`: <out>/aot/*.pt2, `torch.export`
                        programs, one per batch and activation dtype;
  --compiled BATCH...   `attach_compiled`: <out>/aot/*.aoti.pt2,
                        AOTInductor packages compiled for this machine's
                        card (else its CPU), with .host.json fingerprints;
  --aot-dtype D...      the activation dtypes of both (default bfloat16
                        and float32: an Engine opens the blobs of its own);
  --aot-platform P      "cuda" or "cpu", the device the .pt2 programs and
                        the --stablehlo package are exported on (default
                        the card where there is one; "cuda" without a card
                        raises: the port exports for the device it runs
                        on, it does not cross-export);
  --stablehlo PREFIX    (detect, classify) PREFIX.pt2: an AOTInductor
                        package of the engine's graph at batch 1, f32, the
                        weights inside, for the native driver
                        (csrc/driver/mt_infer.cc, built by
                        `_build.build_driver`).  The name is the JAX flag's;
                        the file is no StableHLO module.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch
from torch import nn


def export_detect(args) -> str:
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.yolov8 import detect_spec
    from yolov8_vit_tpu_torch.runtime.convert import (convert_yolov8,
                                                      load_torch_state_dict)
    from yolov8_vit_tpu_torch.weights import init_detect_tree, save_engine

    cfg = DetectConfig(
        variant=args.variant, num_classes=args.num_classes,
        input_size=(args.imgsz, args.imgsz), nms_iou=args.iou_thres,
        nms_conf=args.conf_thres, nms_topk=args.topk)
    if args.weights:
        params = convert_yolov8(load_torch_state_dict(
            args.weights, allow_pickle=args.allow_pickle))
    else:
        params = init_detect_tree(detect_spec(cfg),
                                  torch.Generator().manual_seed(0))
    meta = {"detect_cfg": {
        "variant": cfg.variant, "num_classes": cfg.num_classes,
        "input_size": list(cfg.input_size), "nms_iou": cfg.nms_iou,
        "nms_conf": cfg.nms_conf, "nms_topk": cfg.nms_topk}}
    path = save_engine(args.out, "detect", params, meta,
                       param_dtype=args.param_dtype)
    print(f"detect engine written to {path}")
    if args.stablehlo:
        export_stablehlo_detect(params, cfg, args.stablehlo,
                                platform=args.aot_platform)
    _attach_blobs(args, path, (args.imgsz, args.imgsz, 3))
    return path


def _attach_blobs(args, path: str, hw3: tuple) -> None:
    """The --aot and --compiled blobs of engine dir `path`, whose inputs
    are (batch, *hw3) NHWC."""
    if args.aot:
        _attach_aot_blobs(path, [(b, *hw3) for b in args.aot],
                          args.aot_dtype, args.aot_platform)
    if args.compiled:
        _attach_compiled_blobs(path, [(b, *hw3) for b in args.compiled],
                               args.aot_dtype)


def _attach_aot_blobs(path, shapes, dtype_names, platform=None) -> None:
    """`attach_aot` for every requested activation dtype: a blob matches
    only an Engine opened at the dtype it was traced with
    (engine.py::_parse_aot_name), and serving runs bf16 while parity runs
    run f32."""
    from yolov8_vit_tpu_torch.runtime.engine import attach_aot
    for dn in dtype_names:
        for p in attach_aot(path, shapes, dtype=getattr(torch, dn),
                            platform=platform):
            print(f"aot program -> {p}")


def _attach_compiled_blobs(path, shapes, dtype_names) -> None:
    """`attach_compiled` for every requested activation dtype: packages
    compiled for this machine's card (else its CPU)."""
    from yolov8_vit_tpu_torch.runtime.engine import attach_compiled
    for dn in dtype_names:
        for p in attach_compiled(path, shapes, dtype=getattr(torch, dn)):
            print(f"compiled package -> {p}")


class _Outputs(nn.Module):
    """An engine graph with its outputs as a tuple in `names`' order (the
    native driver's output[i])."""

    def __init__(self, graph: nn.Module, names):
        super().__init__()
        # (not `graph`: the exported module's own attribute of that name)
        self.engine = graph
        self.names = tuple(names)

    def forward(self, x):
        out = self.engine(x)
        return tuple(out[n] for n in self.names)


def _write_package(graph: nn.Module, names, x: torch.Tensor,
                   out_prefix: str, kind: str, input_range: str) -> str:
    """PREFIX.pt2: `graph` on `x`'s shape, dtype and device, exported and
    compiled with AOTInductor, its weights inside the package; the
    metadata tell the native driver what to feed it (`input_range`: "01"
    a [0, 1] float blob, "pm1" [-1, 1] floats, "u8" uint8 frames), what
    it returns and which mt operators it calls."""
    from yolov8_vit_tpu_torch.runtime.engine import (_dtype_name,
                                                     compile_package)
    with torch.no_grad():
        exported = torch.export.export(_Outputs(graph, names).eval(), (x,))
    mt_ops = sorted({str(n.target).split(".")[1]
                     for n in exported.graph.nodes
                     if str(n.target).startswith("mt.")})
    out = compile_package(exported, out_prefix + ".pt2", {
        "mt_kind": kind, "mt_weights": "inside",
        "mt_input_shape": "x".join(map(str, x.shape)),
        "mt_input_dtype": _dtype_name(x.dtype),
        "mt_input_range": input_range, "mt_outputs": ",".join(names),
        "mt_ops": ",".join(mt_ops)})
    print(f"native package -> {out}")
    return out


def export_stablehlo_detect(params, cfg, out_prefix: str, platform=None,
                            det_overrides=None) -> str:
    """PREFIX.pt2 for the native driver (csrc/driver/mt_infer.cc): an
    AOTInductor package of the detect engine's graph, f32, on
    `platform` ("cuda", the default where there is a card, or "cpu"),
    with the weights inside: an NHWC float blob (1, H, W, 3) in [0, 1] ->
    (num_dets, bboxes, scores, labels).  The JAX package's function of
    this name writes a StableHLO module for its PJRT driver; this one
    keeps the name.  det_overrides: explicit YOLOv8Spec fields (engine meta
    "det_spec")."""
    from yolov8_vit_tpu_torch.models.yolov8 import YOLOv8, detect_spec
    from yolov8_vit_tpu_torch.runtime.engine import (DETECT_OUTPUTS,
                                                     EngineGraph,
                                                     _blob_platform)
    from yolov8_vit_tpu_torch.weights import load_tree
    dev = torch.device(_blob_platform(platform))
    model = YOLOv8(detect_spec(cfg, det_overrides)).to(dev)
    load_tree(model, params["params"])
    h, w = cfg.input_size
    return _write_package(EngineGraph("detect", model, cfg), DETECT_OUTPUTS,
                          torch.zeros(1, h, w, 3, device=dev), out_prefix,
                          "detect", "01")


def export_stablehlo_classify(params, spec, num_classes: int,
                              out_prefix: str, batch: int = 1,
                              platform=None) -> str:
    """PREFIX.pt2 for the native driver: the classifier, f32, weights
    inside: NHWC float crops (batch, S, S, 3) in [-1, 1] (the reference's
    mean / std .5 normalization) -> (logits,)."""
    from yolov8_vit_tpu_torch.models.vit import ViTClassifier
    from yolov8_vit_tpu_torch.runtime.engine import (CLASSIFY_OUTPUTS,
                                                     EngineGraph,
                                                     _blob_platform)
    from yolov8_vit_tpu_torch.weights import load_tree
    dev = torch.device(_blob_platform(platform))
    model = ViTClassifier(spec, num_classes).to(dev)
    load_tree(model, params["params"])
    s = spec.img_size
    return _write_package(EngineGraph("classify", model), CLASSIFY_OUTPUTS,
                          torch.zeros(batch, s, s, 3, device=dev),
                          out_prefix, "classify", "pm1")


def export_stablehlo_two_stage(pipe, params, out_prefix: str,
                               batch: int = 1, image_hw=(640, 640),
                               platform=None) -> str:
    """PREFIX.pt2 for the native driver: the whole two-stage pipeline
    (letterbox -> detect -> NMS -> crop -> classify) of `pipe` (a
    TwoStagePipeline on `platform`'s device; `params`, where given, a
    {"det", "vit"} tree loaded into it first), weights inside: uint8 RGB
    frames (batch, H, W, 3) -> the seven TWO_STAGE_OUTPUTS in order."""
    from yolov8_vit_tpu_torch.runtime.engine import (TWO_STAGE_OUTPUTS,
                                                     EngineGraph,
                                                     _blob_platform)
    from yolov8_vit_tpu_torch.weights import load_pipeline_tree
    dev = torch.device(_blob_platform(platform))
    if params is not None:
        load_pipeline_tree(pipe, params)
    h, w = image_hw
    return _write_package(EngineGraph("two_stage", pipe), TWO_STAGE_OUTPUTS,
                          torch.zeros(batch, h, w, 3, dtype=torch.uint8,
                                      device=dev), out_prefix, "two_stage",
                          "u8")


def export_classify(args) -> str:
    from yolov8_vit_tpu_torch.ops.quant import (MLP_AND_ATTN_SUFFIXES,
                                                prequantize_tree)
    from yolov8_vit_tpu_torch.refapi import spec_from_timm_name
    from yolov8_vit_tpu_torch.runtime.convert import (convert_vit_wrapper,
                                                      load_torch_state_dict)
    from yolov8_vit_tpu_torch.weights import init_vit_tree, save_engine

    # the whole architecture from the timm model id (size, patch, depth,
    # dims)
    spec = spec_from_timm_name(args.model)
    if args.weights:
        params = convert_vit_wrapper(
            load_torch_state_dict(args.weights,
                                  allow_pickle=args.allow_pickle),
            depth=spec.depth)
    else:
        params = init_vit_tree(spec, args.num_classes,
                               torch.Generator().manual_seed(0))
    if args.quant:
        if args.quant == "w8a":
            params = prequantize_tree(params, MLP_AND_ATTN_SUFFIXES)
        else:
            params = prequantize_tree(params)
        spec = dataclasses.replace(
            spec, quant=args.quant,
            attn_impl="fused" if args.quant == "w8a" else spec.attn_impl)
    meta = {"vit_spec": dataclasses.asdict(spec),
            "num_classes": args.num_classes, "model_name": args.model}
    path = save_engine(args.out, "classify", params, meta,
                       param_dtype=args.param_dtype)
    print(f"classify engine written to {path}")
    if args.stablehlo:
        export_stablehlo_classify(params, spec, args.num_classes,
                                  args.stablehlo, platform=args.aot_platform)
    _attach_blobs(args, path, (spec.img_size, spec.img_size, 3))
    return path


def export_two_stage(args) -> str:
    from yolov8_vit_tpu_torch.runtime.engine import merge_two_stage_engine
    path = merge_two_stage_engine(args.out, args.detect_engine,
                                  args.classify_engine, args.budget,
                                  param_dtype=args.param_dtype)
    print(f"two-stage engine written to {path}")
    if args.aot or args.compiled:
        with open(os.path.join(path, "meta.json")) as f:
            h, w = json.load(f)["detect_cfg"].get("input_size", [640, 640])
        _attach_blobs(args, path, (h, w, 3))
    return path


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(prog="yolov8_vit_tpu_torch.runtime.export")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("detect", help="build a detect engine")
    d.add_argument("--weights", default=None,
                   help="ultralytics .pt checkpoint (omit for random init)")
    d.add_argument("--out", required=True)
    d.add_argument("--variant", default="s", choices=list("nsmlx"))
    d.add_argument("--num-classes", type=int, default=5)
    d.add_argument("--imgsz", type=int, default=640)
    d.add_argument("--iou-thres", type=float, default=0.65)
    d.add_argument("--conf-thres", type=float, default=0.25)
    d.add_argument("--topk", type=int, default=100)
    d.add_argument("--stablehlo", default=None, metavar="PREFIX",
                   help="also write PREFIX.pt2, the engine's graph as an "
                        "AOTInductor package with the weights inside, for "
                        "the native driver (csrc/driver/mt_infer.cc)")
    d.set_defaults(fn=export_detect)

    c = sub.add_parser("classify", help="build a classify engine")
    c.add_argument("--weights", default=None,
                   help="Network_Wrapper .pth checkpoint (omit for random "
                        "init)")
    c.add_argument("--out", required=True)
    c.add_argument("--model", default="vit_base_patch8_224.augreg_in21k")
    c.add_argument("--num-classes", type=int, default=5)
    c.add_argument("--quant", nargs="?", const="w8", default=None,
                   choices=["w8", "w8a"],
                   help="pre-quantize dense weights to int8: 'w8' = MLP "
                        "only, 'w8a' = MLP + attention projections (the "
                        "fast serving config; fused attention)")
    c.add_argument("--stablehlo", default=None, metavar="PREFIX",
                   help="also write PREFIX.pt2, the classifier as an "
                        "AOTInductor package with the weights inside, for "
                        "the native driver")
    c.set_defaults(fn=export_classify)

    t = sub.add_parser("two-stage",
                       help="merge detect + classify engines into one "
                            "two_stage engine")
    t.add_argument("--detect-engine", required=True)
    t.add_argument("--classify-engine", required=True)
    t.add_argument("--out", required=True)
    t.add_argument("--budget", type=int, default=4,
                   help="classify slots per image (batch-averaged)")
    t.set_defaults(fn=export_two_stage)

    for p in (d, c, t):
        p.add_argument("--aot", type=int, nargs="*", default=None,
                       metavar="BATCH",
                       help="serialize the engine's graph for these batch "
                            "sizes into <out>/aot/*.pt2 (torch.export "
                            "programs: Engine runs them without the "
                            "model's Python forward)")
        p.add_argument("--compiled", type=int, nargs="*", default=None,
                       metavar="BATCH",
                       help="compile the engine's graph for these batch "
                            "sizes into <out>/aot/*.aoti.pt2 (AOTInductor "
                            "packages: no trace and no compile at load).  "
                            "Built for this machine's card (else its CPU): "
                            "run this where the engine is served")
        p.add_argument("--aot-platform", default=None,
                       choices=["cuda", "cpu"],
                       help="the device the .pt2 programs and the "
                            "--stablehlo package are exported on (default: "
                            "the card where there is one)")
        p.add_argument("--aot-dtype", nargs="*",
                       default=["bfloat16", "float32"],
                       choices=["bfloat16", "float32"],
                       help="activation dtype(s) of the --aot and "
                            "--compiled blobs; a blob only matches an "
                            "Engine opened at its dtype, so the default "
                            "covers both the bf16 serving config and f32 "
                            "parity runs")
        p.add_argument("--param-dtype", default=None,
                       choices=["bfloat16", "float16"],
                       help="store floating param leaves at this dtype "
                            "(half the bytes of an f32 tree; int8 kernels "
                            "stay int8).  Lossy: opt-in")
        p.add_argument("--allow-pickle", action="store_true",
                       help="permit full unpickling of the checkpoint "
                            "(executes code from the file: trusted "
                            "sources only)")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
