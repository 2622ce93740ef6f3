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
        --classify-engine weights/class_engine --out weights/two_stage

The JAX CLI's compiled artifacts (`--stablehlo`, `--aot`, `--compiled`,
`--aot-platform`, `--aot-dtype`) have no counterpart here: the port runs
its models eagerly from the parameters, so the parser does not offer
them.  The conversion is host work (numpy and the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch


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
    return path


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
    return path


def export_two_stage(args) -> str:
    from yolov8_vit_tpu_torch.runtime.engine import merge_two_stage_engine
    path = merge_two_stage_engine(args.out, args.detect_engine,
                                  args.classify_engine, args.budget,
                                  param_dtype=args.param_dtype)
    print(f"two-stage engine written to {path}")
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
