"""Detection mAP on the host, in numpy (the port's own copy of
`yolov8_vit_tpu/train/map_eval.py`, function for function).

AP per class over IoU thresholds 0.50:0.95:0.05 with COCO's 101-point
interpolation (pycocotools' accumulate(): the precision envelope sampled
at the recall thresholds by a left searchsorted); mAP50 and mAP50-95 over
the classes that have ground truth.
"""
from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 0.96, 0.05)


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-9)


def _ap_from_pr(recall: np.ndarray, precision: np.ndarray) -> float:
    """COCO 101-point interpolated AP."""
    env = np.flip(np.maximum.accumulate(np.flip(precision)))
    x = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, x, side="left")
    valid = idx < len(env)
    q = np.zeros_like(x)
    q[valid] = env[idx[valid]]
    return float(q.mean())


def evaluate_map(predictions: list[dict], ground_truths: list[dict],
                 num_classes: int = 5,
                 conf_threshold: float = 0.25) -> dict:
    """mAP over a dataset.

    predictions[i]: {"boxes": (N, 4) xyxy, "scores": (N,), "labels": (N,)}
    ground_truths[i]: {"boxes": (M, 4), "labels": (M,)}
    Returns {"map50", "map50_95", "per_class_ap50"}.  A prediction matches
    the unmatched ground-truth box of its class with the largest IoU,
    predictions taken by descending score (stable)."""
    n_thr = len(IOU_THRESHOLDS)
    aps = np.zeros((num_classes, n_thr))
    valid_class = np.zeros(num_classes, bool)

    for c in range(num_classes):
        rows = []      # (score, tp[n_thr]) per prediction of class c
        n_gt = 0
        for pred, gt in zip(predictions, ground_truths):
            gm = np.asarray(gt["labels"]) == c
            gboxes = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)[gm]
            n_gt += len(gboxes)
            pm = (np.asarray(pred["labels"]) == c) & \
                 (np.asarray(pred["scores"]) >= conf_threshold)
            pboxes = np.asarray(pred["boxes"], np.float32).reshape(-1, 4)[pm]
            pscores = np.asarray(pred["scores"])[pm]
            order = np.argsort(-pscores, kind="stable")
            pboxes, pscores = pboxes[order], pscores[order]
            if len(pboxes) == 0:
                continue
            ious = _iou(pboxes, gboxes) if len(gboxes) else \
                np.zeros((len(pboxes), 0))
            tp = np.zeros((len(pboxes), n_thr), bool)
            for ti, thr in enumerate(IOU_THRESHOLDS):
                taken = np.zeros(len(gboxes), bool)
                for pi in range(len(pboxes)):
                    if ious.shape[1] == 0:
                        break
                    j = int(np.argmax(np.where(taken, -1.0, ious[pi])))
                    if ious[pi, j] >= thr and not taken[j]:
                        taken[j] = True
                        tp[pi, ti] = True
            rows.extend(zip(pscores.tolist(), tp))
        if n_gt == 0:
            continue
        valid_class[c] = True
        if not rows:
            continue
        rows.sort(key=lambda r: -r[0])
        tps = np.stack([r[1] for r in rows])           # (P, n_thr)
        for ti in range(n_thr):
            tp_cum = np.cumsum(tps[:, ti])
            fp_cum = np.cumsum(~tps[:, ti])
            recall = tp_cum / n_gt
            precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
            aps[c, ti] = _ap_from_pr(recall, precision)

    present = valid_class.sum()
    map50 = float(aps[valid_class, 0].mean()) if present else 0.0
    map50_95 = float(aps[valid_class].mean()) if present else 0.0
    return {"map50": map50, "map50_95": map50_95,
            "per_class_ap50": aps[:, 0].tolist()}
