"""Accuracy check: the fused pipeline against the host flow, on the card.

Given the original PyTorch checkpoints (an ultralytics `.pt` state dict
and a Network_Wrapper `.pth`) or engine dirs, it converts or loads them
once and runs every image through two independent implementations of the
two-stage flow, the fused pipeline (models/two_stage.py) and the host
route (serve/infer.py: host letterbox, Engine calls, host NMS), and
reports detection-count agreement, greedy-matched box IoU and class
agreement (runtime/accuracy.py::compare_fused_vs_host); the last line is
that dict as JSON.

    python3 -m yolov8_vit_tpu_torch.tools.accuracy_check --det best.pt \\
        --vit best.pth --images ./val_images/ [--imgsz 640]
    python3 -m yolov8_vit_tpu_torch.tools.accuracy_check \\
        --det det_engine_dir/ --vit cls_engine_dir/ --images ./val_images/

Without checkpoints, or with --selftest, it checks itself: seeded
weights at `--variant`, `--imgsz` and `--vit-patch`, the detect head
fitted to planted covers (utils/densify.py::fit_detect_head), synthetic
cover frames; it exits non-zero unless every frame's detection count
matches, leaving out the frames whose kept set hinges on an f32 area tie
(runtime/accuracy.py::area_tie_frames).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

SELFTEST_FRAMES = 8
SELFTEST_FIT_SCENES = 16


def _selftest(args, device) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.runtime.accuracy import (area_tie_frames,
                                                       compare_fused_vs_host)
    from yolov8_vit_tpu_torch.runtime.engine import Engine
    from yolov8_vit_tpu_torch.serve import imageio
    from yolov8_vit_tpu_torch.utils.densify import (fit_detect_head,
                                                    make_cover_scenes)
    from yolov8_vit_tpu_torch.weights import (init_tree, load_pipeline_tree,
                                              save_engine)

    cfg = DetectConfig(variant=args.variant,
                       input_size=(args.imgsz, args.imgsz))
    vit_spec = ViTSpec(patch=args.vit_patch)
    pipe = TwoStagePipeline(det_cfg=cfg, vit_spec=vit_spec,
                            dtype=torch.float32, device=device)
    tree = init_tree(pipe, 0)
    load_pipeline_tree(pipe, tree)
    rng = np.random.default_rng(0)
    imgs, covers = make_cover_scenes(rng, SELFTEST_FIT_SCENES,
                                     cfg.input_size, lam=1.5)
    tree = fit_detect_head(tree, pipe, imgs, covers)
    del pipe
    imgs, _ = make_cover_scenes(rng, SELFTEST_FRAMES, cfg.input_size,
                                lam=1.5)
    tmp = tempfile.mkdtemp(prefix="acc_selftest_")
    try:
        paths = []
        for i, img in enumerate(imgs):
            paths.append(os.path.join(tmp, f"scene{i:02d}.bmp"))
            imageio.imwrite(paths[-1], imageio.bgr2rgb(img))
        det = Engine(save_engine(os.path.join(tmp, "det"), "detect",
                                 tree["det"],
                                 {"detect_cfg": dataclasses.asdict(cfg)}),
                     device=device)
        ties = area_tie_frames(det, paths)
        del det
        kept = [p for p in paths if os.path.basename(p) not in ties]
        print(f"self-test: {len(paths)} frames, left out (kept set hinges "
              f"on an f32 area tie): {ties}")
        return compare_fused_vs_host(tree["det"], tree["vit"], cfg,
                                     vit_spec, kept, verbose=True,
                                     device=device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None, device="cuda") -> dict:
    """Parse `argv`, run the check on `device` and print its report;
    returns compare_fused_vs_host's dict.  The self-test exits non-zero
    unless every detection count matches."""
    ap = argparse.ArgumentParser(
        prog="yolov8_vit_tpu_torch.tools.accuracy_check")
    ap.add_argument("--det", default=None,
                    help="ultralytics .pt OR a detect engine dir")
    ap.add_argument("--vit", default=None,
                    help="Network_Wrapper .pth OR a classify engine dir")
    ap.add_argument("--images", default=None)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--variant", default="s", choices=list("nsmlx"),
                    help="yolov8 size of the .pt checkpoint")
    ap.add_argument("--vit-patch", type=int, default=8, choices=[8, 16],
                    help="ViT patch size of the .pth checkpoint")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--allow-pickle", action="store_true",
                    help="permit full unpickling (trusted sources only)")
    args = ap.parse_args(argv)

    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.vit import ViTSpec
    from yolov8_vit_tpu_torch.runtime.accuracy import compare_fused_vs_host
    from yolov8_vit_tpu_torch.serve.infer import path_to_list

    selftest = args.selftest or not (args.det and args.vit and args.images)
    if selftest:
        print("running self-test (seeded weights, synthetic scenes)")
        m = _selftest(args, device)
    else:
        num_classes = 5
        det_spec = None
        if os.path.isdir(args.det):                  # engine dirs
            from yolov8_vit_tpu_torch.config import detect_config_from_meta
            from yolov8_vit_tpu_torch.weights import read_engine
            det_meta, det_params = read_engine(args.det)
            cls_meta, vit_params = read_engine(args.vit)
            cfg = detect_config_from_meta(det_meta.get("detect_cfg", {}))
            vit_spec = ViTSpec(**cls_meta.get("vit_spec", {}))
            num_classes = cls_meta.get("num_classes", 5)
            det_spec = det_meta.get("det_spec")
        else:                                        # the checkpoints
            from yolov8_vit_tpu_torch.runtime.convert import (
                convert_vit_wrapper, convert_yolov8, load_torch_state_dict)
            det_params = convert_yolov8(load_torch_state_dict(
                args.det, allow_pickle=args.allow_pickle))
            vit_params = convert_vit_wrapper(load_torch_state_dict(
                args.vit, allow_pickle=args.allow_pickle))
            cfg = DetectConfig(variant=args.variant,
                               input_size=(args.imgsz, args.imgsz))
            vit_spec = ViTSpec(patch=args.vit_patch)
        m = compare_fused_vs_host(det_params, vit_params, cfg, vit_spec,
                                  path_to_list(args.images),
                                  num_classes=num_classes, det_spec=det_spec,
                                  verbose=True, device=device)
    print(f"\nimages: {m['images']}  detection-count agreement: "
          f"{m['count_match']}/{m['images']}")
    if m["detections"]:
        print(f"detections: {m['detections']}  mean matched IoU: "
              f"{m['mean_iou']:.4f}  class agreement: "
              f"{m['class_agree']}/{m['detections']} "
              f"({100.0 * m['class_agree'] / m['detections']:.1f}%)")
    print(json.dumps(m))
    if selftest and m["count_match"] != m["images"]:
        sys.exit(1)
    return m


if __name__ == "__main__":
    main()
