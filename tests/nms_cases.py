"""Inputs of the NMS order tests (kernels A and B and their rehearsal),
made with numpy from a seed.  numpy only: the GPU tests import this module
on a machine without jax.

A cases are (boxes (n, 4), scores (n, c)) f32 at the stage-1 thresholds
(IoU .65, conf .25); B cases are (boxes (t, 4), scores (t,), valid (t,))
at the stage-2 ones (IoU .45, conf .35).
"""
import numpy as np


def dense_scene(n, seed, n_above, ties=False):
    """tests/test_nms_scan.py's `_dense_scene`: clustered boxes with
    n_above candidates above conf 0.25; with `ties`, scores on a 1/16 grid
    and boxes on an 8-pixel grid (exact score and area ties)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(320, 80, (n, 2))
    wh = rng.uniform(20, 160, (n, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2],
                           -1).astype(np.float32)
    scores = rng.uniform(0.0, 0.2, (n, 5)).astype(np.float32)
    hot = rng.choice(n, n_above, replace=False)
    scores[hot, rng.integers(0, 5, n_above)] = \
        rng.uniform(0.3, 0.95, n_above).astype(np.float32)
    if ties:
        scores = np.round(scores * 16) / 16
        boxes = np.round(boxes / 8) * 8
    return boxes, scores


def crowded_scene(n, seed, clusters=12):
    """Tight clusters of near-equal boxes, every score above 0.25 in every
    class: most candidates are suppressed, so more than a window's worth
    are decided before 100 are kept (or the pool runs out)."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(100, 540, (clusters, 2))[rng.integers(0, clusters, n)]
    ctr = ctr + rng.normal(0, 1.0, (n, 2))
    wh = 60 + rng.normal(0, 1.0, (n, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    scores = rng.uniform(0.26, 1.0, (n, 5))
    return boxes.astype(np.float32), scores.astype(np.float32)


def a_cases():
    """name -> (boxes, scores) for kernel A and its rehearsal."""
    out = {"dense": dense_scene(2048, 0, 1500),
           "dense_ties": dense_scene(2048, 1, 1500, ties=True),
           "crowded": crowded_scene(2000, 2)}
    rng = np.random.default_rng(3)
    b, _ = dense_scene(600, 3, 10)
    out["all_above"] = (b, rng.uniform(0.3, 1.0, (600, 5)).astype(np.float32))
    out["none_above"] = (b, rng.uniform(0.0, 0.25, (600, 5))
                         .astype(np.float32))
    # scores exactly at 0.25 are never picked (strict >), one class over
    s = np.round(rng.uniform(0.0, 0.5, (600, 5)) * 8).astype(np.float32) / 8
    out["at_threshold"] = (b, s)
    # one anchor kept under two labels; zero-area boxes (IoU 0 with every
    # box, themselves included), identical ones too; pairs at IoU exactly
    # .65 (13/20, kept) and just above it (13.5/20, suppressed)
    b, s = dense_scene(600, 4, 200, ties=True)
    b[0], s[0] = [300, 300, 340, 340], 0.0
    s[0, 1], s[0, 3] = 0.9, 0.8
    for i in range(1, 5):
        s[i] = 0.0
        b[i] = [100.0 + (i > 2) * 50, 100, 100.0 + (i > 2) * 50, 140]
        s[i, 2] = 0.7
    for p, w2 in enumerate((6.5, 6.75, 6.5)):
        i = 10 + 2 * p
        b[i] = [40.0 * p, 700, 40.0 * p + 10, 702]
        b[i + 1] = [40.0 * p, 700, 40.0 * p + w2, 702]
        s[i, 2] = s[i + 1, 2] = 0.875
    out["edges"] = (b, s)
    return out


def b_case(t, seed):
    """Stage-2 rows: boxes on an integer grid with exact area ties, scores
    on a 1/8 grid (some exactly 0.35 after the grid's 0.375 - 0.025 shift:
    never kept), a pair at IoU exactly .45 (kept both), a zero-area row, and
    invalid rows."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(150, 40, (t, 2))
    wh = rng.choice([20, 40, 40, 60], (t, 2)).astype(np.float64)
    bx = np.round(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1))
    sc = np.round(rng.uniform(0, 1, t) * 8) / 8
    sc = np.where(sc == 0.375, 0.35, sc)
    valid = rng.random(t) > 0.2
    if t >= 3:
        bx[0], bx[1] = [0, 300, 10, 302], [0, 300, 4.5, 302]   # IoU .45
        bx[2] = [50, 50, 50, 90]                                # zero area
        sc[:3] = 0.875
        valid[:3] = True
    return (bx.astype(np.float32), sc.astype(np.float32), valid)


def b_grid(t, seed):
    """t stage-2 rows on a grid of boxes 10 px apart, 6 or 8 px wide and 8
    high (no two overlap; exact area ties, broken by row), cells in random
    order: every valid row above 0.35 is kept, more boxes than the
    kernel holds in shared memory (1,024)."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(t)))
    cell = rng.permutation(side * side)[:t]
    x, y = (cell % side) * 10.0, (cell // side) * 10.0
    w = rng.choice([6.0, 8.0], t)
    bx = np.stack([x, y, x + w, y + 8.0], -1).astype(np.float32)
    sc = rng.uniform(0.3, 1.0, t).astype(np.float32)
    valid = rng.random(t) > 0.05
    return bx, sc, valid


def shifted_iou(later, l_later, earlier, l_earlier, side):
    """Kernel I's pair arithmetic (the TPU kernel `_nms_argmax_kernel`'s),
    f32: IoU of later boxes (..., 4) with labels l_later against one earlier
    box with label l_earlier, both shifted by label * side, the later boxes'
    areas on the shifted coordinates and the earlier box's on its
    coordinates as given.  Not symmetric: the shifted coordinates round."""
    f = np.float32
    side = f(side)
    xo = later.astype(f) + (np.asarray(l_later, f) * side)[..., None]
    e = np.asarray(earlier, f)
    eo = e + f(l_earlier) * side
    area = (np.maximum(xo[..., 2] - xo[..., 0], f(0))
            * np.maximum(xo[..., 3] - xo[..., 1], f(0)))
    c_area = np.maximum(e[2] - e[0], f(0)) * np.maximum(e[3] - e[1], f(0))
    iw = np.maximum(np.minimum(xo[..., 2], eo[2])
                    - np.maximum(xo[..., 0], eo[0]), f(0))
    ih = np.maximum(np.minimum(xo[..., 3], eo[3])
                    - np.maximum(xo[..., 1], eo[1]), f(0))
    inter = iw * ih
    return inter / np.maximum(area + c_area - inter, f(1e-9))


def straddle_pairs(side, label, count, seed=0, thr=0.65, y0=50.0):
    """`count` pairs of boxes (a, b) whose IoU in the two directions
    straddles thr under kernel I's arithmetic at class `label` and band
    `side`: shifted_iou(b, a) > thr != shifted_iou(a, b) > thr."""
    f = np.float32
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        x, y = rng.uniform(50, 500), rng.uniform(y0, y0 + 450)
        w, h = rng.uniform(20, 60, 2)
        a = np.array([x, y, x + w, y + h], f)
        dx = rng.uniform(0, 0.25) * w
        b = np.array([x + dx, y, x + dx + w * rng.uniform(0.9, 1.1), y + h],
                     f)
        ba = shifted_iou(b[None], [label], a, label, side)[0]
        ab = shifted_iou(a[None], [label], b, label, side)[0]
        if (ba > f(thr)) != (ab > f(thr)):
            out.append((a, b))
    return out


def i_cases():
    """name -> (boxes, scores) for kernel I (single-label: each anchor's
    best class competes) and its rehearsal, at the stage-1 thresholds."""
    out = {"dense": dense_scene(2048, 0, 1500),
           "dense_ties": dense_scene(2048, 1, 1500, ties=True),
           "crowded": crowded_scene(2000, 2)}
    # a box at 1e5 makes the class band side 2 (1e5 + 1), so that label 4
    # shifts by about 8e5, where the f32 grid is 1/16: pairs of label 4
    # whose IoU straddles .65 by direction, each as (earlier, later) and
    # (later, earlier), below the dense scene
    b, s = dense_scene(600, 5, 300)
    b[0], s[0] = [1e5 - 10, 0, 1e5, 10], 0.1
    side = np.float32(2.0) * (np.float32(1e5) + np.float32(1.0))
    for p, (a, c) in enumerate(straddle_pairs(side, 4, 6, y0=1050.0)):
        for q, box in enumerate((a, c) if p % 2 else (c, a)):
            i = 10 + 2 * p + q
            b[i] = box
            s[i] = 0.0
            s[i, 4] = 0.9 - 0.05 * q
    out["straddle"] = (b, s)
    b, s = dense_scene(300, 7, 100)
    s[5, 1] = np.nan
    out["nan"] = (b, s)
    return out
