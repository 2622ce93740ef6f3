"""PyTorch port, the YOLOv8 detection loss (yolov8_vit_tpu_torch/train/
yolo_loss.py) held against the JAX package's on the same inputs, made from
a numpy seed: random head outputs with random ground truth (overlapping
boxes, padded rows, an image without boxes), and head outputs equal at
every anchor (a constant image) with gt boxes placed symmetrically about
the anchor grid, where many anchors tie exactly on the alignment metric
and the top-k order among equal values decides the foreground set.

Bars: fg_mask and assigned_gt equal; target_scores within 1e-6; the total
and each part within 1e-5 relative; d loss / d box_dist and d loss /
d cls_logits (autograd against jax.grad) within 1e-5 of each array's
largest magnitude (f32 sums over the batch in another order).
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from yolov8_vit_tpu.ops.dfl import make_anchors as j_make_anchors
from yolov8_vit_tpu.train import yolo_loss as jl

from yolov8_vit_tpu_torch.train import yolo_loss as tl

HW = (64, 96)
NC = 3
REG_MAX = 16


def _anchors_px():
    a, s = j_make_anchors(HW)
    return np.array(a * s)


def _random_case(seed: int, b: int = 3, g: int = 6):
    rng = np.random.default_rng(seed)
    n = _anchors_px().shape[0]
    box_dist = rng.normal(0, 2, (b, n, 4 * REG_MAX)).astype(np.float32)
    cls_logits = rng.normal(-1, 2, (b, n, NC)).astype(np.float32)
    xy = rng.uniform(0, 0.7, (b, g, 2)) * np.array(HW[::-1])
    wh = rng.uniform(6, 40, (b, g, 2))
    gt = np.concatenate([xy, np.minimum(xy + wh, HW[::-1])], -1)
    labels = rng.integers(0, NC, (b, g)).astype(np.int32)
    mask = rng.random((b, g)) < 0.7
    mask[-1] = False                                 # an image without gt
    labels[~mask] = rng.integers(-1, NC, int((~mask).sum()))
    return box_dist, cls_logits, gt.astype(np.float32), labels, mask


def _tie_case():
    """Every anchor's outputs equal (a constant image): symmetric ltrb
    distributions, one class logit row; gt boxes centred on anchor-grid
    symmetry points."""
    n = _anchors_px().shape[0]
    row = np.tile(np.linspace(1.0, -2.0, REG_MAX, dtype=np.float32), 4)
    box_dist = np.broadcast_to(row, (2, n, 4 * REG_MAX)).copy()
    cls_logits = np.broadcast_to(np.array([0.5, -1.0, 0.2], np.float32),
                                 (2, n, NC)).copy()
    gt = np.array([[[8, 8, 56, 56], [24, 16, 72, 48], [0, 0, 0, 0]],
                   [[16, 8, 80, 56], [40, 24, 56, 40], [32, 0, 64, 32]]],
                  np.float32)
    labels = np.array([[0, 2, 0], [1, 1, 0]], np.int32)
    mask = np.array([[True, True, False], [True, True, True]])
    return box_dist, cls_logits, gt, labels, mask


CASES = {"random0": lambda: _random_case(0),
         "random1": lambda: _random_case(1), "ties": _tie_case}


def _j_assign(scores, boxes, gt, labels, mask):
    fn = jax.vmap(lambda s, b, g, l, m: jl.task_aligned_assign(
        s, b, jnp.asarray(_anchors_px()), g, l, m))
    return [np.asarray(x) for x in fn(scores, boxes, gt, labels, mask)]


def _pred_boxes(box_dist):
    """Decoded xyxy boxes as the loss computes them (JAX, f32)."""
    a, s = j_make_anchors(HW)
    b, n, _ = box_dist.shape
    probs = jax.nn.softmax(jnp.asarray(box_dist).reshape(b, n, 4, REG_MAX))
    ltrb = probs @ jnp.arange(REG_MAX, dtype=jnp.float32)
    return np.array(jnp.concatenate(
        [a[None] - ltrb[..., :2], a[None] + ltrb[..., 2:]], -1) * s[None])


@pytest.mark.parametrize("case", sorted(CASES))
def test_assigner_matches_jax(case):
    box_dist, cls_logits, gt, labels, mask = CASES[case]()
    scores = np.array(jax.nn.sigmoid(jnp.asarray(cls_logits)))
    boxes = _pred_boxes(box_dist)
    j_fg, j_agt, j_ts = _j_assign(scores, boxes, gt, labels, mask)
    fg, agt, ts = tl.task_aligned_assign(
        torch.from_numpy(scores), torch.from_numpy(boxes),
        torch.from_numpy(_anchors_px()), torch.from_numpy(gt),
        torch.from_numpy(labels), torch.from_numpy(mask))
    assert j_fg.sum() > 0
    np.testing.assert_array_equal(fg.numpy(), j_fg)
    np.testing.assert_array_equal(agt.numpy(), j_agt)
    np.testing.assert_allclose(ts.numpy(), j_ts, rtol=0, atol=1e-6)


def test_tie_case_has_exact_ties_cut_by_top_k():
    """The tie case exercises what it is for: some gt's k-th and
    (k+1)-th largest metrics are equal, so the order among ties decides."""
    box_dist, cls_logits, gt, labels, mask = _tie_case()
    scores = torch.sigmoid(torch.from_numpy(cls_logits))
    boxes = torch.from_numpy(_pred_boxes(box_dist))
    anchors = torch.from_numpy(_anchors_px())
    ious = tl.iou_matrix(torch.from_numpy(gt), boxes).clamp_min(0)
    inside = ((anchors[None, None] > torch.from_numpy(gt)[..., None, :2])
              & (anchors[None, None] < torch.from_numpy(gt)[..., None, 2:])
              ).all(-1)
    cut = False
    for bi in range(gt.shape[0]):
        for gi in range(gt.shape[1]):
            if not mask[bi, gi]:
                continue
            s = scores[bi, :, labels[bi, gi]]
            m = torch.where(inside[bi, gi], s ** 0.5 * ious[bi, gi] ** 6, 0)
            v = torch.sort(m, descending=True).values
            cut |= bool(v[9] > 0 and v[9] == v[10])
    assert cut


def _j_loss(box_dist, cls_logits, gt, labels, mask):
    def f(bd, cl):
        return jl.yolo_detection_loss(bd, cl, gt, labels, mask, HW,
                                      reg_max=REG_MAX)
    (total, parts), (g_bd, g_cl) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(box_dist),
                                         jnp.asarray(cls_logits))
    return (float(total), {k: float(v) for k, v in parts.items()},
            np.asarray(g_bd), np.asarray(g_cl))


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    box_dist, cls_logits, gt, labels, mask = CASES[case]()
    j_total, j_parts, j_gbd, j_gcl = _j_loss(box_dist, cls_logits, gt,
                                             labels, mask)
    bd = torch.from_numpy(box_dist).requires_grad_()
    cl = torch.from_numpy(cls_logits).requires_grad_()
    total, parts = tl.yolo_detection_loss(
        bd, cl, torch.from_numpy(gt), torch.from_numpy(labels),
        torch.from_numpy(mask), HW, reg_max=REG_MAX)
    total.backward()
    assert j_parts["box"] > 0
    np.testing.assert_allclose(total.item(), j_total, rtol=1e-5)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(parts[k].item(), j_parts[k], rtol=1e-5,
                                   err_msg=k)
    for name, got, want in (("box_dist", bd.grad, j_gbd),
                            ("cls_logits", cl.grad, j_gcl)):
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (name, err)


def test_ciou_and_no_gt_loss_match_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 50, (64, 2))
    b = rng.uniform(0, 50, (64, 2))
    box1 = np.concatenate([a, a + rng.uniform(1, 30, (64, 2))], -1)
    box2 = np.concatenate([b, b + rng.uniform(1, 30, (64, 2))], -1)
    box1, box2 = box1.astype(np.float32), box2.astype(np.float32)
    np.testing.assert_allclose(
        tl.pairwise_ciou(torch.from_numpy(box1), torch.from_numpy(box2)),
        np.asarray(jl.pairwise_ciou(box1, box2)), rtol=0, atol=1e-6)
    box_dist, cls_logits, gt, labels, _ = _random_case(2)
    mask = np.zeros_like(labels, bool)
    total, parts = tl.yolo_detection_loss(
        torch.from_numpy(box_dist), torch.from_numpy(cls_logits),
        torch.from_numpy(gt), torch.from_numpy(labels),
        torch.from_numpy(mask), HW)
    j_total, j_parts, _, _ = _j_loss(box_dist, cls_logits, gt, labels, mask)
    assert float(parts["box"]) == 0.0 == j_parts["box"]
    np.testing.assert_allclose(float(total), j_total, rtol=1e-5)
