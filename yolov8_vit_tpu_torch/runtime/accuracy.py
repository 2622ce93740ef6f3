"""Accuracy-parity core: fused pipeline vs host flow, one metric dict.

Runs every image through two independent implementations of the whole
two-stage flow, the fused pipeline (models/two_stage.py) and the host
route (serve/infer.py: host letterbox, Engine calls, host NMS), and
reports detection-count agreement, greedy-matched box IoU, and class
agreement.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch


def box_iou(a, b) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
    ua = ((a[2] - a[0]) * (a[3] - a[1]) +
          (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / max(ua, 1e-9)


def match_rows(fused: dict, host_rows: list, verbose: bool = False,
               name: str = "", disagreements: list | None = None
               ) -> tuple[int, int, list[float]]:
    """One image: the fused pipeline's output dict (numpy, one image)
    against the host route's rows for it.  A fused detection pairs with a
    host row only at IoU >= 0.5 (accepting any overlap would let a barely
    overlapping wrong detection consume the match and count toward class
    agreement).  Returns (detections, class agreements, matched IoUs);
    `disagreements`, when given, collects (name, fused box, fused class,
    host class) of the matched pairs whose classes differ."""
    valid = np.nonzero(fused["final_valid"])[0]
    host = list(host_rows)
    if verbose:
        print(f"{name}: fused={len(valid)} host={len(host)} detections")
    total = agree = 0
    ious: list[float] = []
    for k in valid:
        fbox = fused["boxes"][k]
        fcls = int(fused["cls_labels"][k])
        if fcls < 0:
            fcls = int(fused["det_labels"][k])
        best_i, best = -1, 0.0
        for i, row in enumerate(host):
            v = box_iou(fbox, row[3:7])
            if v > best:
                best_i, best = i, v
        total += 1
        if best_i >= 0 and best >= 0.5:
            ious.append(best)
            agree += int(host[best_i][1] == fcls)
            if disagreements is not None and host[best_i][1] != fcls:
                disagreements.append((name, fbox.tolist(), fcls,
                                      host[best_i][1]))
            host.pop(best_i)
        if verbose:
            print(f"  box={fbox.round(1)} det={int(fused['det_labels'][k])}"
                  f"@{fused['det_scores'][k]:.3f} cls={fcls} "
                  f"match_iou={best:.3f}")
    return total, agree, ious


def compare_fused_vs_host(det_params, vit_params, cfg, vit_spec, paths,
                          num_classes: int = 5, budget: int = 8,
                          det_spec: dict | None = None,
                          verbose: bool = False, device="cuda",
                          disagreements: list | None = None) -> dict:
    """Run `paths` through the fused pipeline and the host orchestrator on
    the same weights (flax-layout trees {"params": ...}); return
    {images, count_match, detections, matched, mean_iou, class_agree}.
    Both routes run on `device` with f32 activations.
    `disagreements`: see `match_rows`."""
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    from yolov8_vit_tpu_torch.runtime.engine import Engine
    from yolov8_vit_tpu_torch.serve import imageio
    from yolov8_vit_tpu_torch.serve.infer import main as infer_main
    from yolov8_vit_tpu_torch.weights import load_pipeline_tree, save_engine

    pipe = TwoStagePipeline(
        det_cfg=cfg, vit_spec=vit_spec, num_classes=num_classes,
        classify_budget=budget,
        det_overrides=tuple(sorted((det_spec or {}).items())),
        dtype=torch.float32, device=device)
    load_pipeline_tree(pipe, {"det": det_params, "vit": vit_params})

    tmp = tempfile.mkdtemp(prefix="acc_check_")
    try:
        det_meta = {"detect_cfg": dataclasses.asdict(cfg)}
        if det_spec:
            det_meta["det_spec"] = dict(det_spec)
        det_eng = Engine(save_engine(os.path.join(tmp, "det"), "detect",
                                     det_params, det_meta),
                         device=device)
        det_eng.set_desired(["num_dets", "bboxes", "scores", "labels"])
        cls_eng = Engine(save_engine(
            os.path.join(tmp, "cls"), "classify", vit_params,
            {"vit_spec": dataclasses.asdict(vit_spec),
             "num_classes": num_classes}), device=device)
        host_rows = infer_main(det_eng, list(paths), model_list=[cls_eng],
                               crop_size=vit_spec.img_size)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    by_name: dict = {}
    for row in host_rows:
        by_name.setdefault(row[0], []).append(row)

    total = agree = count_match = 0
    ious: list[float] = []
    for path in paths:
        img = imageio.imread_rgb(path)
        with torch.no_grad():
            out = pipe(torch.from_numpy(img[None]).to(pipe.device))
        out = {k: v[0].float().cpu().numpy() if v.is_floating_point()
               else v[0].cpu().numpy() for k, v in out.items()}
        host = by_name.get(os.path.basename(path), [])
        count_match += int(int(out["final_valid"].sum()) == len(host))
        t, a, i = match_rows(out, host, verbose, os.path.basename(path),
                             disagreements)
        total += t
        agree += a
        ious += i
    return {"images": len(list(paths)), "count_match": count_match,
            "detections": total, "matched": len(ious),
            "mean_iou": float(np.mean(ious)) if ious else 0.0,
            "class_agree": agree}
