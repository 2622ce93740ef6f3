"""PyTorch port, single-label stage-1 NMS: the plain version of kernel I
(`efficient_nms_scan(multi_label=False)`) against the JAX Pallas kernel in
interpret mode on the same numpy inputs.  Integer outputs, boxes and scores
must be equal: coordinates sit on a half-pixel grid, so the class-band
shifts and the areas are exact in f32 and only the IoU division rounds
(identically, IEEE).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yolov8_vit_tpu.ops.nms import efficient_nms_scan as j_scan

from yolov8_vit_tpu_torch.ops import nms


def _both(boxes, scores, **kw):
    ref = j_scan(jnp.asarray(boxes), jnp.asarray(scores), multi_label=False,
                 interpret=True, **kw)
    got = nms.efficient_nms_scan(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 multi_label=False, **kw)
    return got, ref


def _assert_equal(got, ref):
    assert int(got[0]) == int(ref[0])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[3].dtype == torch.int32


def _dense(seed, n=1024, c=5):
    """Clustered boxes on a half-pixel grid, some with negative
    coordinates, scores quantized to 1/16 (many exact ties, also between
    an anchor's classes)."""
    rng = np.random.default_rng(seed)
    ctr = rng.normal(150, 120, (n, 2))
    wh = rng.uniform(20, 160, (n, 2))
    boxes = (np.round(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1) * 2)
             / 2).astype(np.float32)
    scores = rng.uniform(0.0, 0.2, (n, c)).astype(np.float32)
    for a in rng.choice(n, n // 2, replace=False):
        for k in rng.choice(c, rng.integers(1, 4), replace=False):
            scores[a, k] = np.round(rng.uniform(0.3, 0.95) * 16) / 16
    return boxes, scores


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_dense_with_ties_matches_jax(seed):
    boxes, scores = _dense(seed)
    assert (boxes < 0).any()
    got, ref = _both(boxes, scores)
    assert int(got[0]) > 20
    _assert_equal(got, ref)


@pytest.mark.parametrize("kw", [dict(iou_threshold=0.45, max_output=16),
                                dict(score_threshold=0.6),
                                dict(iou_threshold=0.9, max_output=300)])
def test_thresholds_and_budget_match_jax(kw):
    boxes, scores = _dense(21, n=600)
    _assert_equal(*_both(boxes, scores, **kw))


def test_negative_coords_no_cross_class_suppression():
    """tests/test_nms_scan.py's regression: a class-1 box near the positive
    extreme and a class-2 box deeply negative must not meet in one band."""
    boxes = np.array([[600.0, 600.0, 700.0, 700.0],
                      [-105.0, -105.0, -5.0, -5.0]], np.float32)
    scores = np.zeros((2, 5), np.float32)
    scores[0, 1] = 0.9
    scores[1, 2] = 0.8
    got, ref = _both(boxes, scores)
    assert int(got[0]) == 2
    _assert_equal(got, ref)


def test_same_box_two_classes_both_kept_and_same_class_suppressed():
    boxes = np.array([[10, 10, 110, 110], [10, 10, 110, 110],
                      [12, 12, 112, 112]], np.float32)
    scores = np.zeros((3, 5), np.float32)
    scores[0, 1] = 0.9
    scores[1, 2] = 0.8          # same box, another class: kept
    scores[2, 1] = 0.7          # overlaps row 0 in its class: suppressed
    got, ref = _both(boxes, scores)
    _assert_equal(got, ref)
    assert int(got[0]) == 2
    assert got[3][:2].tolist() == [1, 2]


def test_argmax_label_takes_first_maximum():
    """An anchor whose two best classes tie takes the lower label, as
    jnp.argmax does."""
    boxes = np.array([[0, 0, 50, 50]], np.float32)
    scores = np.array([[0.1, 0.5, 0.2, 0.5, 0.0]], np.float32)
    got, ref = _both(boxes, scores)
    _assert_equal(got, ref)
    assert int(got[3][0]) == 1


def test_empty_scene():
    boxes, scores = _dense(3, n=256)
    got, ref = _both(boxes, scores * 0.0)
    _assert_equal(got, ref)
    assert int(got[0]) == 0 and (got[3] == -1).all()
    assert float(got[1].abs().max()) == 0.0


def test_batched_equals_per_image():
    """The port batches over images (side, best class and the loop are per
    image), where JAX vmaps its single-image function."""
    bs = [_dense(s, n=300) for s in (31, 32, 33)]
    boxes = torch.from_numpy(np.stack([b for b, _ in bs]))
    scores = torch.from_numpy(np.stack([s for _, s in bs]))
    scores[1] *= 0.0                                   # an empty image
    got = nms.efficient_nms_scan(boxes, scores, multi_label=False)
    for i in range(3):
        one = nms.efficient_nms_scan(boxes[i], scores[i], multi_label=False)
        for a, b in zip(got, one):
            assert torch.equal(a[i], b)


def test_multi_label_default_unchanged():
    boxes, scores = _dense(41, n=300)
    a = nms.efficient_nms_scan(torch.from_numpy(boxes),
                               torch.from_numpy(scores))
    b = nms.efficient_nms_scan(torch.from_numpy(boxes),
                               torch.from_numpy(scores), multi_label=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    single = nms.efficient_nms_scan(torch.from_numpy(boxes),
                                    torch.from_numpy(scores),
                                    multi_label=False)
    assert int(single[0]) <= int(a[0])
