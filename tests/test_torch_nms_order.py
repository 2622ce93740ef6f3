"""The order that kernels A, B and I (yolov8_vit_tpu_torch/csrc/nms.cu)
decide in, rehearsed in numpy / torch on the CPU and held bit for bit
against the JAX package's `efficient_nms_scan` (multi-label and
single-label) and `area_sorted_nms` (Pallas kernels in interpret mode)
and against the port's plain versions.

The rehearsal follows the kernels step by step: every entry above the
threshold becomes a 64-bit key (the score's order bits inverted, above its
flat index); keys are taken a window at a time (all of them, or those
below the bound an MSD radix select finds), sorted, and decided a chunk at
a time: against the boxes kept so far, then in order with a within-chunk
over-threshold mask; windows grow from 256 keys and chunks from 64
candidates to the launch's sizes, and where a window kept under a
quarter of its keys, the keys a kept box suppresses are dropped from the
pool before the next.  Small windows and chunks make these tests cross
window and chunk boundaries at small sizes.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yolov8_vit_tpu.ops.nms import area_sorted_nms as j_area_nms
from yolov8_vit_tpu.ops.nms import efficient_nms_scan as j_nms
from nms_cases import (a_cases, b_case, crowded_scene, dense_scene, i_cases,
                        shifted_iou)
from test_nms_scan import _dense_scene

from yolov8_vit_tpu_torch.ops import nms

U64 = np.uint64
_KILLED = np.float32(-1e9)
# csrc/nms.cu kFirstWindow, kFirstChunk: windows grow from 256 keys and
# chunks from 64, 2x each time, to the launch's sizes
FIRST_WINDOW, FIRST_CHUNK = 256, 64


def _score_key(s: np.ndarray) -> np.ndarray:
    """csrc/nms.cu score_key: ascending keys are descending scores, -0
    keyed as +0."""
    u = np.where(s == 0, np.float32(0), s).astype(np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), u,
                    ~(u | np.uint32(0x80000000))).astype(U64)


def _select_cut(pool: np.ndarray, lo, cap: int):
    """csrc/nms.cu select_cut: a bound with 1..cap unprocessed keys below
    it, by 8-bit digits from the top."""
    prefix = U64(0)
    for shift in range(56, -1, -8):
        hi_mask = U64(0) if shift == 56 else ~U64(0) << U64(shift + 8)
        sel = pool[(pool >= lo) & (pool != ~U64(0))
                   & ((pool & hi_mask) == prefix)]
        hist = np.bincount(((sel >> U64(shift)) & U64(255)).astype(np.int64),
                           minlength=256)
        cum = np.cumsum(hist)
        ok = np.nonzero(cum <= cap)[0]
        best = int(ok[-1]) if len(ok) else -1
        nxt = U64(best + 1) << U64(shift)
        if best >= 0 and cum[best] > 0:
            return prefix | nxt
        prefix = prefix | nxt
    raise AssertionError("unique keys always cut at the last digit")


def _over(x: torch.Tensor, c: torch.Tensor, thr: float) -> np.ndarray:
    """iou_of(x, c) > thr for every row of x against the box c, in the
    kernels' operation order."""
    return (nms._iou_vs(x[None], c[None])[0] > thr).numpy()


def rehearse(boxes, scores, iou_t, score_t, max_out, window, chunk,
             class_aware=True, over_fn=None):
    """One image.  boxes (n, 4), scores (n, c) f32 (B: c = 1, scores the
    priorities; I: c = 1, each anchor's best score).  over_fn(later,
    earlier): whether the earlier kept flat index suppresses each of the
    later flat indices (default: IoU above iou_t, of one class where
    class_aware).  Returns the kept flat indices in decision order."""
    n, c = scores.shape
    bx = torch.from_numpy(boxes)
    if over_fn is None:
        def over_fn(later, earlier):
            same = (later // n == earlier // n) if class_aware else True
            return same & _over(bx[torch.from_numpy(later % n)],
                                bx[earlier % n], iou_t)
    flat_scores = scores.T.reshape(-1)               # flat = class * n + a
    if np.isnan(flat_scores).any():
        return []
    idx = np.nonzero(flat_scores > score_t)[0]
    # the compaction order is arbitrary: take it reversed
    pool = ((_score_key(flat_scores[idx]) << U64(32))
            | idx.astype(U64))[::-1].copy()
    kept: list[int] = []
    lo, remaining, first = U64(0), len(pool), True
    wcap, size = min(window, FIRST_WINDOW), min(chunk, FIRST_CHUNK)
    kept_before = last_window = 0
    while remaining > 0 and len(kept) < max_out:
        if not first and kept and 4 * (len(kept) - kept_before) < last_window:
            # the last window kept under a quarter of its keys: drop the
            # unprocessed keys a kept box suppresses (to ~0)
            live = np.nonzero((pool >= lo) & (pool != ~U64(0)))[0]
            f = (pool[live] & U64(0xffffffff)).astype(np.int64)
            drop = np.zeros(len(live), bool)
            for g in kept:
                drop |= over_fn(f, g)
            pool[live[drop]] = ~U64(0)
            remaining -= int(drop.sum())
            if remaining == 0:
                break
        kept_before = len(kept)
        if first and len(pool) <= wcap:
            win = pool
        else:
            live = pool[(pool >= lo) & (pool != ~U64(0))]
            if remaining > wcap:
                cut = _select_cut(pool, lo, wcap)
                win = live[live < cut]
            else:
                win = live
        first = False
        assert 1 <= len(win) <= wcap
        win = np.sort(win)
        c0 = 0
        while c0 < len(win) and len(kept) < max_out:
            flat = (win[c0:c0 + size] & U64(0xffffffff)).astype(np.int64)
            c0, size = c0 + len(flat), min(chunk, 2 * size)
            removed = np.zeros(len(flat), bool)
            for f in kept:                        # the boxes kept so far
                removed |= over_fn(flat, f)
            for i in range(len(flat)):
                if removed[i]:
                    continue
                kept.append(int(flat[i]))
                if len(kept) == max_out:
                    break
                later = np.arange(len(flat)) > i
                removed |= later & over_fn(flat, flat[i])
        remaining -= len(win)
        last_window = len(win)
        lo = win[-1] + U64(1)
        wcap = min(window, 2 * wcap)
    return kept


def rehearse_a(boxes, scores, window, chunk, iou_t=0.65, score_t=0.25,
               max_out=100):
    """Kernel A's outputs for one image, from the rehearsal."""
    n, _ = scores.shape
    kept = rehearse(boxes, scores, iou_t, score_t, max_out, window, chunk)
    ob = np.zeros((max_out, 4), np.float32)
    os_ = np.zeros(max_out, np.float32)
    ol = np.full(max_out, -1, np.int32)
    for r, f in enumerate(kept):
        ob[r], os_[r], ol[r] = boxes[f % n], scores[f % n, f // n], f // n
    return np.int32(len(kept)), ob, os_, ol


def rehearse_b(boxes, scores, valid, window, chunk, iou_t=0.45,
               score_t=0.35):
    """Kernel B's keep mask for one image, from the rehearsal."""
    pri = nms.mask_priority(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(valid), score_t).numpy()
    kept = rehearse(boxes, pri[:, None], iou_t, float(_KILLED) / 2,
                    len(pri), window, chunk, class_aware=False)
    keep = np.zeros(len(pri), bool)
    keep[kept] = True
    return keep


def _assert_a(got, ref):
    for name, g, r in zip(("num_dets", "boxes", "scores", "labels"), got,
                          ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                      err_msg=name)


# (window, chunk): the kernels' defaults, and sizes that cross both
# boundaries here (the select path from a few hundred candidates up)
_SIZES = [(nms.NMS_WINDOW, nms.NMS_CHUNK), (4096, 256), (64, 32)]


@pytest.mark.parametrize("window,chunk", _SIZES)
@pytest.mark.parametrize("seed,ties", [(0, False), (1, True)])
def test_a_order_dense_scene_vs_jax(seed, ties, window, chunk):
    """tests/test_nms_scan.py's dense scene, >1,000 candidates above 0.25,
    with and without exact ties."""
    b, s = _dense_scene(2048, seed, 1500, ties)
    np.testing.assert_array_equal(dense_scene(2048, seed, 1500, ties)[1], s)
    _assert_a(rehearse_a(b, s, window, chunk),
              j_nms(jnp.asarray(b), jnp.asarray(s)))


@pytest.mark.parametrize("case", ["crowded", "all_above", "none_above",
                                  "at_threshold", "edges"])
@pytest.mark.parametrize("window,chunk", _SIZES[1:])
def test_a_order_edge_cases_vs_jax(case, window, chunk):
    """Every entry above the threshold; none; scores exactly at 0.25; one
    anchor kept under two labels; zero-area boxes; pairs at IoU exactly .65;
    a crowd that suppresses most candidates."""
    b, s = a_cases()[case]
    got = rehearse_a(b, s, window, chunk)
    _assert_a(got, j_nms(jnp.asarray(b), jnp.asarray(s)))
    if case == "edges":
        rows = got[1].tolist()
        assert sorted(int(lab) for r, lab in zip(rows, got[3])
                      if r == [300, 300, 340, 340]) == [1, 3]
        assert sum(r == [100, 100, 100, 140] for r in rows) == 2
    if case == "none_above":
        assert int(got[0]) == 0 and (got[3] == -1).all()


def test_a_order_crowd_needs_many_chunks():
    """The crowd keeps one box a cluster and class (60 of its 10,000
    candidates), so the scan decides every candidate, window after window,
    before the pool runs out."""
    b, s = crowded_scene(2000, 2)
    assert int((s > 0.25).sum()) == 10000
    kept = rehearse(b, s, 0.65, 0.25, 100, 256, 64)
    assert len(kept) < 100
    _assert_a(rehearse_a(b, s, 256, 64),
              nms.efficient_nms_scan(torch.from_numpy(b), torch.from_numpy(s)))


def test_a_order_past_the_old_shared_memory_limit():
    """n * c = 12,000 x 5 = 60,000 > 58,095 (the old kernel's limit), 6,000
    candidates: the rehearsal at the kernels' default sizes (a select from
    the start) against the port's plain version."""
    b, s = dense_scene(12000, 5, 6000)
    b2, s2 = crowded_scene(12000, 6)
    for boxes, scores in ((b, s), (b2, s2)):
        ref = nms.efficient_nms_scan(torch.from_numpy(boxes),
                                     torch.from_numpy(scores))
        _assert_a(rehearse_a(boxes, scores, nms.NMS_WINDOW, nms.NMS_CHUNK),
                  ref)


def test_a_order_nan_score_keeps_nothing():
    """A NaN score makes the TPU kernel's first max NaN: nothing is kept."""
    b, s = dense_scene(300, 7, 100)
    s[5, 1] = np.nan
    got = rehearse_a(b, s, 64, 32)
    assert int(got[0]) == 0
    _assert_a(got, nms.efficient_nms_scan(torch.from_numpy(b),
                                          torch.from_numpy(s)))


@pytest.mark.parametrize("window,chunk", [(nms.NMS_WINDOW, nms.NMS_CHUNK),
                                          (64, 32), (32, 8)])
@pytest.mark.parametrize("t,seed", [(1, 10), (100, 11), (129, 12)])
def test_b_order_vs_jax(t, seed, window, chunk):
    """Stage-2 rows with area ties, a pair at IoU exactly .45, a zero-area
    row, scores exactly at 0.35 and invalid rows."""
    bx, sc, valid = b_case(t, seed)
    ref = j_area_nms(jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(valid))
    got = rehearse_b(bx, sc, valid, window, chunk)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(
        nms.area_sorted_nms(torch.from_numpy(bx), torch.from_numpy(sc),
                            torch.from_numpy(valid)).numpy(), got)


def test_b_order_thousand_rows_vs_plain():
    """T = 1,000 (a window of 1,024 at the defaults; four chunks of 256;
    more windows at 256) against the port's plain version."""
    bx, sc, valid = b_case(1000, 13)
    ref = nms.area_sorted_nms(torch.from_numpy(bx), torch.from_numpy(sc),
                              torch.from_numpy(valid)).numpy()
    assert ref.sum() > 100
    for window, chunk in ((nms.NMS_WINDOW, nms.NMS_CHUNK), (256, 64)):
        np.testing.assert_array_equal(
            rehearse_b(bx, sc, valid, window, chunk), ref)


def test_select_cut_bounds_a_window():
    """Every cut leaves 1..cap unprocessed keys below it, and the windows
    partition the pool in key order, also with every score tied."""
    rng = np.random.default_rng(14)
    for scores in (rng.uniform(0.3, 1, 5000).astype(np.float32),
                   np.full(5000, 0.5, np.float32)):
        pool = (_score_key(scores) << U64(32)) | np.arange(5000, dtype=U64)
        lo, seen = U64(0), []
        while len(seen) < len(pool):
            live = pool[pool >= lo]
            cut = _select_cut(pool, lo, 300) if len(live) > 300 else None
            win = np.sort(live if cut is None else live[live < cut])
            assert 1 <= len(win) <= 300
            seen.extend(win.tolist())
            lo = win[-1] + U64(1)
        assert seen == sorted(pool.tolist())


# ---- kernel I: the single-label form -----------------------------------------
def _single_label(boxes, scores):
    """`single_label_candidates` in numpy, f32: each anchor's best score,
    its label (the first maximum), the class-band side."""
    per_score = scores.max(-1)
    per_label = scores.argmax(-1).astype(np.float32)
    side = np.float32(2.0) * (np.abs(boxes).max() + np.float32(1.0))
    return per_score, per_label, side


def rehearse_i(boxes, scores, window, chunk, iou_t=0.65, score_t=0.25,
               max_out=100, direction="later, earlier"):
    """Kernel I's outputs for one image, from the rehearsal: one key an
    anchor, every pair decided by `shifted_iou` in the direction the
    kernel takes it (the later candidate against the earlier kept one);
    direction "earlier, later" swaps the two, to show a case tells them
    apart."""
    per_score, per_label, side = _single_label(boxes, scores)

    def over(later, earlier):
        if direction == "later, earlier":
            iou = shifted_iou(boxes[later], per_label[later], boxes[earlier],
                              per_label[earlier], side)
        else:
            iou = np.array([shifted_iou(boxes[earlier][None],
                                        [per_label[earlier]], boxes[j],
                                        per_label[j], side)[0]
                            for j in np.atleast_1d(later)])
        return iou > np.float32(iou_t)

    kept = rehearse(boxes, per_score[:, None], iou_t, score_t, max_out,
                    window, chunk, over_fn=over)
    ob = np.zeros((max_out, 4), np.float32)
    os_ = np.zeros(max_out, np.float32)
    ol = np.full(max_out, -1, np.int32)
    for r, a in enumerate(kept):
        ob[r], os_[r], ol[r] = boxes[a], per_score[a], per_label[a]
    return np.int32(len(kept)), ob, os_, ol


@pytest.mark.parametrize("window,chunk", _SIZES + [(32, 8)])
@pytest.mark.parametrize("case", ["dense", "dense_ties", "crowded",
                                  "straddle", "nan"])
def test_i_order_vs_jax(case, window, chunk):
    """Kernel I's ordered scan, rehearsed, against JAX's single-label
    Pallas kernel in interpret mode and the port's plain version, bit for
    bit, at the kernel's sizes and at windows and chunks small enough to
    cross every boundary."""
    b, s = i_cases()[case]
    got = rehearse_i(b, s, window, chunk)
    _assert_a(got, j_nms(jnp.asarray(b), jnp.asarray(s), multi_label=False,
                         interpret=True))
    _assert_a(got, nms.efficient_nms_scan(torch.from_numpy(b),
                                          torch.from_numpy(s),
                                          multi_label=False))
    if case == "nan":
        assert int(got[0]) == 0


def test_i_straddling_pairs_decide_by_direction():
    """The planted label-4 pairs of the "straddle" case: each pair's IoU
    is above .65 in one direction and not in the other (the later box's
    area is taken on shifted coordinates, the earlier one's as given), and
    the rehearsal in the kernel's direction matches JAX where the swapped
    direction does not."""
    b, s = i_cases()["straddle"]
    per_score, per_label, side = _single_label(b, s)
    assert side == np.float32(2 * (1e5 + 1))
    for p in range(6):
        i, j = 10 + 2 * p, 11 + 2 * p          # i scored above j
        assert per_label[i] == per_label[j] == 4 and per_score[i] > \
            per_score[j]
        later = shifted_iou(b[j][None], [4], b[i], 4, side)[0]
        swapped = shifted_iou(b[i][None], [4], b[j], 4, side)[0]
        assert (later > np.float32(0.65)) != (swapped > np.float32(0.65))
    ref = j_nms(jnp.asarray(b), jnp.asarray(s), multi_label=False,
                interpret=True)
    _assert_a(rehearse_i(b, s, 64, 32), ref)
    wrong = rehearse_i(b, s, 64, 32, direction="earlier, later")
    assert int(wrong[0]) != int(ref[0]) or not np.array_equal(
        wrong[1], np.asarray(ref[1]))


def test_i_past_the_old_anchor_cap():
    """134,400 anchors (a 2560 x 2560 input), past the old kernel's
    58,046-anchor shared-memory cap: the rehearsal at the kernel's sizes
    against the port's plain version."""
    b, s = dense_scene(134400, 8, 6000)
    ref = nms.efficient_nms_scan(torch.from_numpy(b), torch.from_numpy(s),
                                 multi_label=False)
    _assert_a(rehearse_i(b, s, nms.NMS_WINDOW, nms.NMS_CHUNK), ref)
