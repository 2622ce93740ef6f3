"""YOLOv8 detection loss: task-aligned assigner + CIoU + DFL + BCE
(PyTorch port of `yolov8_vit_tpu/train/yolo_loss.py`).

  * TaskAlignedAssigner(topk=10, alpha=0.5, beta=6.0): candidates are the
    anchors whose centre lies inside a gt box; alignment metric
    score^alpha * IoU^beta; the top 10 anchors of each gt; an anchor
    claimed by several gts goes to the one of highest IoU; target scores
    are metric-normalised.
  * box loss: (1 - CIoU) weighted by the assigned target score.
  * DFL loss: cross-entropy of the reg_max distribution against the two
    integer bins bracketing the fractional ltrb target, same weighting.
  * cls loss: BCE against the aligned target scores.
  * total = (7.5 box + 0.5 cls + 1.5 dfl) * batch over ONE batch-wide
    target-score sum (ultralytics' v8DetectionLoss normalisation).

The JAX module vmaps a single-image assigner; here the assigner is
written over the batch at once, (B, G, A), with the same arithmetic.
Where the two frameworks' primitives differ in what they promise, the
port picks the form that gives JAX's answer:
  - `jax.lax.top_k` returns the lower index first among equal values; the
    top k here come from a stable descending sort, so exact metric ties
    (anchors placed symmetrically about a gt box) select the same set;
  - `jnp.argmax` over a bool array returns the first True: the mask is
    cast to an integer type first (torch.argmax takes no bools) and
    torch.argmax returns the first maximal index.
The assigner runs on detached inputs under no_grad, as JAX's
stop_gradient on both sides of it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from yolov8_vit_tpu_torch.ops.dfl import make_anchors


def pairwise_ciou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """CIoU between (..., 4) xyxy boxes (elementwise over leading dims);
    the aspect-ratio weight alpha carries no gradient."""
    eps = 1e-7
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1

    inter = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)) \
        .clamp_min(0) * \
        (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp_min(0)
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 +
            (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi ** 2) * \
        (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def iou_matrix(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Plain IoU between (..., G, 4) gt and (..., A, 4) pred ->
    (..., G, A)."""
    eps = 1e-7
    lt = torch.maximum(gt[..., :, None, :2], pred[..., None, :, :2])
    rb = torch.minimum(gt[..., :, None, 2:], pred[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = ((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1]))[..., :, None]
    a2 = ((pred[..., 2] - pred[..., 0])
          * (pred[..., 3] - pred[..., 1]))[..., None, :]
    return inter / (a1 + a2 - inter + eps)


@torch.no_grad()
def task_aligned_assign(pred_scores: torch.Tensor, pred_boxes: torch.Tensor,
                        anchors_xy: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                        topk: int = 10, alpha: float = 0.5,
                        beta: float = 6.0):
    """Task-aligned assignment of a batch.

    Args:
      pred_scores: (B, A, C) sigmoid class scores.
      pred_boxes: (B, A, 4) decoded xyxy (input pixels).
      anchors_xy: (A, 2) anchor centres (input pixels).
      gt_boxes: (B, G, 4) xyxy, padded.
      gt_labels: (B, G) int, padded.
      gt_mask: (B, G) bool validity.
    Returns fg_mask (B, A) bool, assigned_gt (B, A) int64 index,
    target_scores (B, A, C).
    """
    num_anchors = pred_boxes.shape[-2]
    valid = gt_mask[..., None]                                  # (B, G, 1)

    # candidates: anchor centre strictly inside the gt box
    lt = anchors_xy[None, None] - gt_boxes[..., None, :2]
    rb = gt_boxes[..., None, 2:] - anchors_xy[None, None]
    in_gt = torch.minimum(lt.amin(-1), rb.amin(-1)) > 1e-9      # (B, G, A)

    ious = iou_matrix(gt_boxes, pred_boxes).clamp_min(0)        # (B, G, A)
    # floor the class score: sigmoid underflows to exact 0 in f32 for very
    # negative logits, which would zero the metric of every anchor and
    # empty the foreground set for good (training collapse)
    labels = gt_labels.long().clamp_min(0)
    cls_score = torch.gather(
        pred_scores, 2,
        labels[:, None, :].expand(-1, num_anchors, -1)
    ).transpose(1, 2).clamp_min(1e-9)                           # (B, G, A)
    metric = (cls_score ** alpha) * (ious ** beta)
    cand = in_gt & valid
    metric = torch.where(cand, metric, torch.zeros_like(metric))

    # top k a gt by metric, ties to the lower anchor index (lax.top_k)
    k = min(topk, num_anchors)
    vals, order = torch.sort(metric, dim=-1, descending=True, stable=True)
    topk_vals, topk_idx = vals[..., :k], order[..., :k]
    sel = torch.zeros_like(cand).scatter_(-1, topk_idx, topk_vals > 0)
    sel &= cand

    # conflicts: an anchor claimed by > 1 gt keeps the gt of largest IoU
    claimed = sel.sum(1, keepdim=True)                          # (B, 1, A)
    iou_sel = torch.where(sel, ious, torch.full_like(ious, -1.0))
    best_gt = iou_sel.argmax(1, keepdim=True)                   # (B, 1, A)
    keep = torch.zeros_like(sel).scatter_(1, best_gt, True)
    sel = torch.where(claimed > 1, sel & keep, sel)

    fg_mask = sel.any(1)                                        # (B, A)
    assigned_gt = sel.to(torch.uint8).argmax(1)                 # (B, A)

    # normalised target scores (ultralytics norm_align_metric)
    zero = torch.zeros_like(metric)
    pos_metric = torch.where(sel, metric, zero)
    pos_iou = torch.where(sel, ious, zero)
    amax = pos_metric.amax(-1, keepdim=True)                    # (B, G, 1)
    imax = pos_iou.amax(-1, keepdim=True)
    norm = pos_metric * imax / (amax + 1e-9)                    # (B, G, A)
    score_a = torch.where(sel, norm, zero).amax(1)              # (B, A)
    # jax.nn.one_hot: a label outside [0, C) gives a zero row
    classes = torch.arange(pred_scores.shape[-1], device=gt_labels.device)
    onehot = (torch.gather(gt_labels.long(), 1, assigned_gt)[..., None]
              == classes).to(pred_scores.dtype)
    target_scores = onehot * score_a[..., None] * fg_mask[..., None]
    return fg_mask, assigned_gt, target_scores


def _dfl_loss(dist_logits: torch.Tensor, target: torch.Tensor,
              reg_max: int) -> torch.Tensor:
    """Distribution focal loss per element: CE against the bracketing
    bins.  dist_logits (..., 4, reg_max), target (..., 4) in
    [0, reg_max - 1] -> (...,), the mean over the 4 sides."""
    tl = torch.floor(target).long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(dist_logits, dim=-1)
    ll = torch.gather(logp, -1, tl.clamp(0, reg_max - 1)[..., None])[..., 0]
    lr = torch.gather(logp, -1, tr.clamp(0, reg_max - 1)[..., None])[..., 0]
    return -(ll * wl + lr * wr).mean(-1)


def yolo_detection_loss(box_dist: torch.Tensor, cls_logits: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                        gt_mask: torch.Tensor, input_hw: tuple[int, int],
                        strides: tuple[int, ...] = (8, 16, 32),
                        reg_max: int = 16,
                        gains: tuple[float, float, float] = (7.5, 0.5, 1.5),
                        data_group=None):
    """Batched YOLOv8 loss.

    Args:
      box_dist: (B, A, 4*reg_max) raw DFL logits (flatten_head_outputs).
      cls_logits: (B, A, C).
      gt_boxes: (B, G, 4) xyxy input pixels (padded).
      gt_labels: (B, G) int.
      gt_mask: (B, G) bool.
      data_group: a process group over which the batch's rows are split
        (data parallelism): the target-score sum and the batch size are
        those of the whole batch, so the sum of the ranks' losses (and of
        their gradients) is the whole batch's.
    Returns (total, {box, cls, dfl}): one batch-wide target-score sum,
    the gains, then `* batch_size` (the scale the lr0 / momentum recipe
    and the gradient clip at 10 assume); the parts are the unscaled
    per-component terms."""
    b, a, _ = cls_logits.shape
    anchors, stride = make_anchors(input_hw, strides,
                                   device=cls_logits.device)
    anchors_px = anchors * stride                               # (A, 2)
    pred_scores = torch.sigmoid(cls_logits)

    dist = box_dist.reshape(b, a, 4, reg_max)
    probs = torch.softmax(dist, dim=-1)
    ltrb = probs @ torch.arange(reg_max, dtype=probs.dtype,
                                device=probs.device)            # (B, A, 4)
    pred_boxes = torch.cat([anchors[None] - ltrb[..., :2],
                            anchors[None] + ltrb[..., 2:]], -1) * stride[None]

    fg, agt, tscore = task_aligned_assign(
        pred_scores.detach(), pred_boxes.detach(), anchors_px, gt_boxes,
        gt_labels, gt_mask)
    # ONE batch-wide normaliser (ultralytics target_scores_sum); the
    # assignment is made on detached predictions, so it carries no gradient
    tsum = tscore.sum()
    batch = b
    if data_group is not None:
        torch.distributed.all_reduce(tsum, group=data_group)
        batch = b * torch.distributed.get_world_size(data_group)
    tsum = tsum.clamp_min(1.0)

    # cls: BCE with the aligned scores
    xl = cls_logits
    bce = xl.clamp_min(0) - xl * tscore + torch.log1p(torch.exp(-xl.abs()))
    cls_loss = bce.sum() / tsum

    # box + dfl on the foreground anchors
    tgt_boxes = torch.gather(gt_boxes, 1, agt[..., None].expand(-1, -1, 4))
    weight = tscore.sum(-1) * fg                                 # (B, A)

    ciou = pairwise_ciou(pred_boxes, tgt_boxes)                 # (B, A)
    box_loss = ((1.0 - ciou) * weight).sum() / tsum

    # dfl target: gt ltrb distances in feature units, clamped
    tb = tgt_boxes / stride[None]
    tgt_ltrb = torch.cat([anchors[None] - tb[..., :2],
                          tb[..., 2:] - anchors[None]], -1)
    tgt_ltrb = tgt_ltrb.clamp(0, reg_max - 1 - 0.01)
    dfl = _dfl_loss(dist, tgt_ltrb, reg_max)
    dfl_loss_v = (dfl * weight).sum() / tsum

    g_box, g_cls, g_dfl = gains
    total = (g_box * box_loss + g_cls * cls_loss + g_dfl * dfl_loss_v) * batch
    parts = {"box": g_box * box_loss, "cls": g_cls * cls_loss,
             "dfl": g_dfl * dfl_loss_v}
    return total, parts
