"""The comparison that decides `correct` for the inspection pipeline.

Per frame, the served stage-1 picks (the first num_dets rows) and kept
set (final_valid) are held against the reference's score and box of
every anchor, and each served kept box's class is judged by the
reference classifier run on that box's own crop (the served box is what
is judged, as a served token is).  Readings:

  det_anchor_gap  the widest |served score - the reference's score of
                  the same anchor| over served kept boxes (the anchor
                  whose box the served box is; 1 where no anchor's box
                  is within IoU ANCHOR_IOU)
  det_set_gap     how far the served picks and kept set lie from a greedy
                  two-stage NMS outcome of the reference's scores and
                  boxes (set_gap): 0 for one, the IoU or score by which a
                  condition fails otherwise.  Not a one-to-one match with
                  the reference's own picks: among a cover's anchors,
                  whose scores tie to the fourth digit and whose boxes
                  tie in area, rounding picks another anchor and every
                  later decision follows from it
  cls_logit_gap   the widest gap by which the reference's logit of the
                  served class lies below its best logit
  cls_prob_gap    the widest |served class score - reference softmax
                  probability of the served class|
  unclassified    served kept boxes left without a class (limit 0)
"""
from __future__ import annotations

import numpy as np

ANCHOR_IOU = 0.9


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: (np.clip(x[:, 2] - x[:, 0], 0, None)  # noqa: E731
                      * np.clip(x[:, 3] - x[:, 1], 0, None))
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-9)


def anchor_scores(pb, pl, ps, ab, asc):
    """The anchor whose box each served box is: the anchor with the
    nearest clipped box (among anchors whose clipped boxes coincide, the
    one whose reference score in the box's stage-1 class lies closest to
    the served score; any class where the label is -1, unknown).  Returns
    (that anchor's reference score (n,), the IoU of its box (n,), its
    index (n,))."""
    if len(pb) == 0:
        return np.zeros(0), np.zeros(0), np.zeros(0, np.int64)
    iou = _iou(pb, ab)
    best = iou.max(1)
    ref = np.where(pl[:, None] >= 0,
                   asc[:, np.clip(pl, 0, asc.shape[1] - 1)].T,
                   asc.max(1)[None, :])
    gap = np.where(iou >= best[:, None] - 1e-6, np.abs(ps[:, None] - ref),
                   np.inf)
    idx = gap.argmin(1)
    return ref[np.arange(len(pb)), idx], best, idx


def anchor_gap(pb, pl, ps, ab, asc) -> float:
    """The widest gap between a served box's score and the reference's
    score of its anchor (1 for a box no anchor's box lies within IoU
    ANCHOR_IOU of)."""
    if len(pb) == 0:
        return 0.0
    ref, best, _ = anchor_scores(pb, pl, ps, ab, asc)
    return float(np.where(best >= ANCHOR_IOU, np.abs(ps - ref), 1.0).max())


def _area(b: np.ndarray) -> np.ndarray:
    return (np.clip(b[:, 2] - b[:, 0], 0, None)
            * np.clip(b[:, 3] - b[:, 1], 0, None))


def _overlap_excess(boxes: np.ndarray, thr: float) -> float:
    """The largest IoU - thr between two distinct boxes (0 for fewer than
    two): how far one kept box lies inside another's suppression."""
    if len(boxes) < 2:
        return 0.0
    iou = _iou(boxes, boxes)
    np.fill_diagonal(iou, 0.0)
    return float(max(iou.max() - thr, 0.0))


def _uncovered(cand, cand_s, conf, by, by_s, thr, order) -> float:
    """The largest distance of a candidate from being accounted for: its
    score's distance above `conf` (it might have missed it), or, for its
    best suppressor among `by`, the larger of its IoU's shortfall under
    `thr` and how far the suppressor falls behind it in `order` (a
    suppressor comes first).  0 for a candidate that is itself in `by`."""
    if len(cand) == 0:
        return 0.0
    d = cand_s - conf
    if len(by):
        cover = np.maximum(thr - _iou(cand, by), order(cand, cand_s, by, by_s))
        d = np.minimum(d, np.clip(cover, 0, None).min(1))
    return float(max(d.max(), 0.0))


def _score_order(cand, cand_s, by, by_s):
    return cand_s[:, None] - by_s[None, :]


def _area_order(cand, cand_s, by, by_s):
    a = _area(cand)[:, None]
    return (a - _area(by)[None, :]) / np.maximum(a, 1e-9)


def set_gap(served: dict, anchors: dict, det: dict) -> float:
    """det_set_gap of one frame: how far the served picks and kept set lie
    from a greedy NMS outcome of the reference's scores and boxes.
    served: {"boxes" (clipped, as served), "labels", "keep", "ref_scores",
    "anchor" (the index of each pick's anchor)}; anchors: {"raw" (A, 4)
    unclipped boxes, "scores" (A, C)}; det: the detector's thresholds.

    Stage 1, per class, on the anchors' unclipped boxes (what stage 1
    compares): every pick scores over nms_conf; no two picks overlap by
    more than nms_iou; every anchor over nms_conf is a pick or overlaps
    an earlier (higher-scoring) pick by more than nms_iou (past the
    nms_topk-th pick, anchors below the last pick are free).  Stage 2,
    across classes, on the served boxes (clipped, what stage 2 compares):
    every kept box scores over conf_second; no two kept boxes overlap by
    more than custom_nms_iou; every pick over conf_second is kept or
    overlaps a kept box of no smaller area by more than custom_nms_iou.
    Each condition reads by how much it fails, in score or IoU (area as a
    share); the reading is the largest."""
    rs, lab, keep = served["ref_scores"], served["labels"], served["keep"]
    raw, asc = anchors["raw"], anchors["scores"]
    ub = raw[served["anchor"]]
    conf1, iou1 = det["nms_conf"], det["nms_iou"]
    conf2, iou2 = det["conf_second"], det["custom_nms_iou"]
    gaps = [0.0]
    if len(rs):
        gaps.append(float(conf1 - rs.min()))
    capped = len(rs) >= det["nms_topk"]
    for c in range(asc.shape[1]):
        m = lab == c
        gaps.append(_overlap_excess(ub[m], iou1))
        cand = np.nonzero(asc[:, c] > conf1)[0]
        if capped and m.any():
            cand = cand[asc[cand, c] >= rs[m].min()]
        gaps.append(_uncovered(raw[cand], asc[cand, c].astype(np.float64),
                               conf1, ub[m], rs[m], iou1, _score_order))
    sb = served["boxes"]
    if keep.any():
        gaps.append(float(conf2 - rs[keep].min()))
    gaps.append(_overlap_excess(sb[keep], iou2))
    q = ~keep & (rs > conf2)
    gaps.append(_uncovered(sb[q], rs[q], conf2, sb[keep], rs[keep], iou2,
                           _area_order))
    return max(gaps)


def served_picks(rec: dict) -> dict:
    """A served frame's stage-1 picks (the first num_dets rows, and any
    row past them that is kept), kept mask and class answers."""
    valid = np.nonzero(rec["final_valid"])[0]
    n = max(int(rec["num_dets"]), int(valid.max()) + 1 if len(valid) else 0)
    return {"boxes": np.asarray(rec["boxes"], np.float64)[:n].reshape(-1, 4),
            "labels": np.asarray(rec["det_labels"])[:n].astype(np.int64),
            "scores": np.asarray(rec["det_scores"], np.float64)[:n],
            "keep": np.asarray(rec["final_valid"])[:n].astype(bool),
            "cls_labels": np.asarray(rec["cls_labels"])[:n].astype(np.int64),
            "cls_scores": np.asarray(rec["cls_scores"], np.float64)[:n]}


def judge(served, ref_dets, classify, num_classes: int, det: dict) -> dict:
    """served: [(frame key, rec)]; ref_dets: {frame key: {"anchors": every
    anchor's (clipped boxes (A, 4), scores (A, C)), "anchors_raw": their
    unclipped boxes (A, 4)}}; classify(requests) -> reference logits
    (K, C) for requests [(frame key, box (4,))]; det: the detector's
    thresholds."""
    unclassified = 0
    anchor = set_g = 0.0
    todo, seen, served_cls = [], {}, []
    for key, rec in served:
        s = served_picks(rec)
        ref = ref_dets[key]
        s["ref_scores"], _, s["anchor"] = anchor_scores(
            s["boxes"], s["labels"], s["scores"], *ref["anchors"])
        kb = s["boxes"][s["keep"]]
        anchor = max(anchor, anchor_gap(kb, s["labels"][s["keep"]],
                                        s["scores"][s["keep"]],
                                        *ref["anchors"]))
        set_g = max(set_g, set_gap(s, {"raw": ref["anchors_raw"],
                                       "scores": ref["anchors"][1]}, det))
        for box, lab, sc in zip(kb, s["cls_labels"][s["keep"]],
                                s["cls_scores"][s["keep"]]):
            if not 0 <= lab < num_classes:
                unclassified += 1
                continue
            k = (key, tuple(np.round(box, 3)))
            if k not in seen:
                seen[k] = len(todo)
                todo.append((key, box))
            served_cls.append((seen[k], int(lab), float(sc)))
    logits = classify(todo) if todo else np.zeros((0, num_classes))
    logit_gap = prob_gap = 0.0
    if len(logits):
        z = logits - logits.max(-1, keepdims=True)
        probs = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
        for i, lab, sc in served_cls:
            logit_gap = max(logit_gap, float(logits[i].max() - logits[i, lab]))
            prob_gap = max(prob_gap, abs(sc - float(probs[i, lab])))
    return {"det_anchor_gap": anchor, "det_set_gap": set_g,
            "cls_logit_gap": logit_gap, "cls_prob_gap": prob_gap,
            "unclassified": unclassified}
