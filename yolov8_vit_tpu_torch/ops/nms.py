"""Greedy NMS with static output shapes: kernels A, B and I.

 1. Stage 1, `efficient_nms_scan`: EfficientNMS_TRT semantics (IoU .65,
    conf .25, top 100, class-aware), fixed-size (num_dets, boxes, scores,
    labels) outputs.  multi_label=True (the default, what the pipeline
    runs): every (anchor, class) pair a candidate; on the card kernel A
    (csrc/nms.cu `greedy_nms_kernel<0>`, `nms_argmax_ml_kernel` here),
    which replaces yolov8_vit_tpu/ops/nms.py `_nms_argmax_kernel_ml`.
    multi_label=False: one candidate per anchor, its best class, classes
    kept apart by a per-class coordinate offset; on the card kernel I
    (csrc/nms.cu `greedy_nms_kernel<2>`, `nms_single_label` here), which
    replaces `_nms_argmax_kernel`.
 2. Stage 2, `area_sorted_nms`: conf > .35, priority = box area, class-
    agnostic suppression at IoU .45, keep mask in row order.  On the card
    this is kernel B (csrc/nms.cu `greedy_nms_kernel<1>`,
    `mask_scan_kernel` here), which replaces `_mask_scan_kernel`.

The TPU kernels pick the highest live entry each iteration (ties to the
lowest flat index), so their trip count is the number of boxes kept.  The
plain versions below run that loop batched over images with torch ops; the
wrappers use them only for CPU tensors.  Kernels A, B and I compute the
same kept sets as one greedy scan of the candidates above the threshold in
(score desc, flat index asc) order, sorted in windows and decided in
chunks (the source note of csrc/nms.cu says why the two agree, and gives
the bounds on the H100).
"""
from __future__ import annotations

import ctypes

import torch

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.ops.boxes import box_area

_KILLED = -1e9
_BIG = 2 ** 30

# kernels A, B and I sort the candidates above the threshold in windows of up
# to NMS_WINDOW keys and decide them in chunks growing to NMS_CHUNK (powers
# of two, 32 to 4096 and 32 to 1024; csrc/nms.cu).  Read at each launch, so
# tests set smaller ones to cross window and chunk boundaries at small
# shapes.
NMS_WINDOW = 1024
NMS_CHUNK = 64

# the C entry points' arguments before the stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGMAX_ARGS = (_P, _P, _I, _I, _I, _F, _F, _I, _I, _I) + (_P,) * 5
_MASK_SCAN_ARGS = (_P,) * 4 + (_I, _I, _F, _F, _I, _I) + (_P,) * 3


def _window_chunk(window, chunk) -> tuple[int, int]:
    """A launch's window and chunk: as given, else NMS_WINDOW and
    NMS_CHUNK as they are now."""
    return (NMS_WINDOW if window is None else window,
            NMS_CHUNK if chunk is None else chunk)


def _iou_vs(boxes: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """IoU of every box (B, N, 4) against one selected box per image
    (B, 4), in the kernels' operation order."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx1, cy1, cx2, cy2 = (v[:, None] for v in sel.unbind(-1))
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    c_area = (cx2 - cx1).clamp_min(0.0) * (cy2 - cy1).clamp_min(0.0)
    iw = (torch.minimum(x2, cx2) - torch.maximum(x1, cx1)).clamp_min(0.0)
    ih = (torch.minimum(y2, cy2) - torch.maximum(y1, cy1)).clamp_min(0.0)
    inter = iw * ih
    return inter / (area + c_area - inter).clamp_min(1e-9)


def nms_argmax_ml_plain(boxes, scores, iou_threshold, score_threshold,
                        max_output):
    """Plain version of kernel A over a batch: boxes (B, N, 4), scores
    (B, N, C) f32 -> num_dets (B,) i32, boxes (B, M, 4), scores (B, M),
    labels (B, M) i32 (zero / -1 padded)."""
    b, n, c = scores.shape
    dev = scores.device
    scs = scores.transpose(1, 2).reshape(b, c * n).clone()   # class-major
    flat = torch.arange(c * n, device=dev)
    cols = torch.arange(n, device=dev)
    rows = torch.arange(b, device=dev)
    num = torch.zeros(b, dtype=torch.int32, device=dev)
    ob = torch.zeros(b, max_output, 4, dtype=torch.float32, device=dev)
    os_ = torch.zeros(b, max_output, dtype=torch.float32, device=dev)
    ol = torch.full((b, max_output), -1, dtype=torch.int32, device=dev)
    for it in range(max_output):
        m = scs.amax(dim=1)
        active = m > score_threshold
        if not bool(active.any()):
            break
        i_sel = torch.where(scs == m[:, None], flat, _BIG).amin(dim=1)
        i_sel = torch.where(active, i_sel, 0)    # a NaN max matches none
        k, a = i_sel // n, i_sel % n
        sel = boxes[rows, a]                                   # (B, 4)
        kill = (_iou_vs(boxes, sel) > iou_threshold) | (cols == a[:, None])
        kill &= active[:, None]
        plane = scs.view(b, c, n)[rows, k]                     # (B, N)
        scs.view(b, c, n)[rows, k] = torch.where(kill, -1.0, plane)
        ob[:, it] = torch.where(active[:, None], sel, ob[:, it])
        os_[:, it] = torch.where(active, m, os_[:, it])
        ol[:, it] = torch.where(active, k.to(torch.int32), ol[:, it])
        num += active.to(torch.int32)
    return num, ob, os_, ol


def single_label_candidates(boxes: torch.Tensor, scores: torch.Tensor):
    """What the single-label form computes ahead of its loop (the plain
    version; kernel I takes the same in its compaction), per image:
    each anchor's best score, its label as f32 (the first maximum on
    ties), and the class-band stride side = 2 (max |boxes| + 1): boxes may
    have negative coordinates, so each band covers [-side/2, side/2]."""
    per_score, per_label = scores.max(dim=-1)
    side = 2.0 * (boxes.abs().amax(dim=(1, 2)) + 1.0)
    return per_score.contiguous(), per_label.to(torch.float32), side


def nms_argmax_plain(boxes, per_score, per_label, side, iou_threshold,
                     score_threshold, max_output):
    """Plain version of kernel I over a batch: boxes (B, N, 4), per_score
    and per_label (B, N) f32, side (B,) -> the outputs of
    `nms_argmax_ml_plain`.  The IoU runs on boxes shifted by label * side
    (the selected box's area on the box as given), as the kernel does."""
    b, n = per_score.shape
    dev = per_score.device
    scs = per_score.clone()
    idx = torch.arange(n, device=dev)
    rows = torch.arange(b, device=dev)
    shifted = boxes + (per_label * side[:, None])[..., None]
    num = torch.zeros(b, dtype=torch.int32, device=dev)
    ob = torch.zeros(b, max_output, 4, dtype=torch.float32, device=dev)
    os_ = torch.zeros(b, max_output, dtype=torch.float32, device=dev)
    ol = torch.full((b, max_output), -1, dtype=torch.int32, device=dev)
    x1, y1, x2, y2 = shifted.unbind(-1)
    area = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    for it in range(max_output):
        m = scs.amax(dim=1)
        active = m > score_threshold
        if not bool(active.any()):
            break
        i_sel = torch.where(scs == m[:, None], idx, _BIG).amin(dim=1)
        i_sel = torch.where(active, i_sel, 0)
        sel = boxes[rows, i_sel]                               # (B, 4)
        clab = per_label[rows, i_sel]
        cx1, cy1, cx2, cy2 = ((v + clab * side)[:, None]
                              for v in sel.unbind(-1))
        c_area = ((sel[:, 2] - sel[:, 0]).clamp_min(0.0)
                  * (sel[:, 3] - sel[:, 1]).clamp_min(0.0))[:, None]
        iw = (torch.minimum(x2, cx2) - torch.maximum(x1, cx1)).clamp_min(0.0)
        ih = (torch.minimum(y2, cy2) - torch.maximum(y1, cy1)).clamp_min(0.0)
        inter = iw * ih
        iou = inter / (area + c_area - inter).clamp_min(1e-9)
        kill = ((iou > iou_threshold) | (idx == i_sel[:, None])) \
            & active[:, None]
        scs = torch.where(kill, -1.0, scs)
        ob[:, it] = torch.where(active[:, None], sel, ob[:, it])
        os_[:, it] = torch.where(active, m, os_[:, it])
        ol[:, it] = torch.where(active, clab.to(torch.int32), ol[:, it])
        num += active.to(torch.int32)
    return num, ob, os_, ol


def efficient_nms_scan(boxes: torch.Tensor, scores: torch.Tensor, *,
                       iou_threshold: float = 0.65,
                       score_threshold: float = 0.25,
                       max_output: int = 100, multi_label: bool = True):
    """EfficientNMS with full-candidate greedy semantics.

    boxes (N, 4) or (B, N, 4) xyxy f32; scores (N, C) or (B, N, C) f32.
    Returns (num_dets, boxes (.., max_output, 4), scores (.., max_output),
    labels (.., max_output) int32, -1 padded), in pick (score-descending)
    order.  multi_label: every (anchor, class) pair competes (kernel A);
    otherwise each anchor competes once, with its best class (kernel I).
    CUDA tensors launch the kernel; CPU tensors run its plain version."""
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    boxes = boxes.to(torch.float32).contiguous()
    scores = scores.to(torch.float32).contiguous()
    b, n, c = scores.shape
    if boxes.shape != (b, n, 4):
        raise ValueError(f"boxes {tuple(boxes.shape)} vs scores "
                         f"{tuple(scores.shape)}")
    scan = torch.ops.mt.nms_argmax_ml if multi_label \
        else torch.ops.mt.nms_argmax
    out = scan(boxes, scores, iou_threshold, score_threshold, max_output,
               NMS_WINDOW, NMS_CHUNK)
    if single:
        out = tuple(o[0] for o in out)
    return out


def nms_argmax_ml_kernel(boxes: torch.Tensor, scores: torch.Tensor,
                         iou_threshold: float, score_threshold: float,
                         max_output: int, window: int | None = None,
                         chunk: int | None = None):
    """Kernel A on CUDA tensors (operator mt::nms_argmax_ml): boxes (B, N,
    4) and scores (B, N, C) f32 contiguous -> the outputs of
    `nms_argmax_ml_plain`.  Any N * C is taken; window and chunk default to
    NMS_WINDOW and NMS_CHUNK (they do not change what it computes)."""
    _build.require_cuda(boxes, scores)
    window, chunk = _window_chunk(window, chunk)
    if score_threshold < -1.0:
        # killed entries hold -1: below it the TPU kernel picks them again
        raise ValueError(f"kernel A takes score_threshold >= -1; got "
                         f"{score_threshold}")
    b, n, c = scores.shape
    if n * c >= 2 ** 31:
        raise ValueError(f"{n} anchors x {c} classes overflow the kernel's "
                         f"32-bit flat index")
    dev = boxes.device
    num = torch.empty(b, dtype=torch.int32, device=dev)
    ob = torch.empty(b, max_output, 4, dtype=torch.float32, device=dev)
    os_ = torch.empty(b, max_output, dtype=torch.float32, device=dev)
    ol = torch.empty(b, max_output, dtype=torch.int32, device=dev)
    pool = torch.empty(b, n * c, dtype=torch.int64, device=dev)
    _build.launch("nms", "launch_nms_argmax_ml", _ARGMAX_ARGS,
                  boxes.data_ptr(), scores.data_ptr(), b, n, c,
                  iou_threshold, score_threshold, max_output, window, chunk,
                  pool.data_ptr(), num.data_ptr(), ob.data_ptr(),
                  os_.data_ptr(), ol.data_ptr(),
                  what="nms_argmax_ml_kernel (kernel A)")
    return num, ob, os_, ol


def nms_single_label(boxes, scores, iou_threshold, score_threshold,
                      max_output):
    """efficient_nms_scan(multi_label=False): kernel I or its plain
    version.  Its launches are counted under this function's name."""
    return efficient_nms_scan(boxes, scores, iou_threshold=iou_threshold,
                              score_threshold=score_threshold,
                              max_output=max_output, multi_label=False)


def nms_argmax_op_plain(boxes, scores, iou_threshold, score_threshold,
                        max_output, window, chunk):
    """Operator mt::nms_argmax on the CPU: `nms_argmax_plain` on
    `single_label_candidates(boxes, scores)`."""
    return nms_argmax_plain(boxes, *single_label_candidates(boxes, scores),
                            iou_threshold, score_threshold, max_output)


def nms_argmax_kernel(boxes, scores, iou_threshold, score_threshold,
                      max_output, window=None, chunk=None):
    """Kernel I on CUDA tensors (operator mt::nms_argmax): boxes (B, N, 4)
    and scores (B, N, C) f32 contiguous -> the outputs of
    `nms_argmax_plain` on `single_label_candidates(boxes, scores)`, which
    the kernel takes itself (each anchor's best class, the class-band
    side).  Any number of anchors is taken; window and chunk as A's."""
    _build.require_cuda(boxes, scores)
    window, chunk = _window_chunk(window, chunk)
    if score_threshold < -1.0:
        raise ValueError(f"kernel I takes score_threshold >= -1; got "
                         f"{score_threshold}")
    b, n, c = scores.shape
    dev = boxes.device
    num = torch.empty(b, dtype=torch.int32, device=dev)
    ob = torch.empty(b, max_output, 4, dtype=torch.float32, device=dev)
    os_ = torch.empty(b, max_output, dtype=torch.float32, device=dev)
    ol = torch.empty(b, max_output, dtype=torch.int32, device=dev)
    pool = torch.empty(b, n, dtype=torch.int64, device=dev)
    _build.launch("nms", "launch_nms_argmax", _ARGMAX_ARGS,
                  boxes.data_ptr(), scores.data_ptr(), b, n, c,
                  iou_threshold, score_threshold, max_output, window, chunk,
                  pool.data_ptr(), num.data_ptr(), ob.data_ptr(),
                  os_.data_ptr(), ol.data_ptr(),
                  what="nms_argmax_kernel (kernel I)")
    return num, ob, os_, ol


def mask_scan_plain(boxes: torch.Tensor, pri: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Plain version of kernel B: boxes (B, T, 4), priority (B, T) f32
    (invalid rows at -1e9) -> keep (B, T) bool."""
    b, t = pri.shape
    dev = pri.device
    pr = pri.clone()
    keep = torch.zeros(b, t, dtype=torch.bool, device=dev)
    idx = torch.arange(t, device=dev)
    rows = torch.arange(b, device=dev)
    for _ in range(t):
        m = pr.amax(dim=1)
        active = m > _KILLED / 2
        if not bool(active.any()):
            break
        i_sel = torch.where(pr == m[:, None], idx, _BIG).amin(dim=1)
        i_sel = torch.where(active, i_sel, 0)
        kill = ((_iou_vs(boxes, boxes[rows, i_sel]) > iou_threshold)
                | (idx == i_sel[:, None])) & active[:, None]
        pr = torch.where(kill, _KILLED, pr)
        keep[rows, i_sel] |= active
    return keep


def mask_priority(boxes: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor,
                  score_threshold: float) -> torch.Tensor:
    """Kernel B's priority of each row, f32: the box area (in the boxes'
    dtype, as JAX takes it) where the row is valid with score >
    score_threshold, else -1e9."""
    valid = valid & (scores > score_threshold)
    return torch.where(valid, box_area(boxes).to(torch.float32),
                       _KILLED).contiguous()


def mask_scan_op_plain(boxes, scores, valid, pri, iou_threshold,
                       score_threshold, window, chunk):
    """Operator mt::mask_scan on the CPU: `mask_scan_plain` on `pri`, or on
    `mask_priority(boxes, scores, valid, score_threshold)` where the
    caller gave scores and valid."""
    if pri is None:
        pri = mask_priority(boxes, scores, valid, score_threshold)
    return mask_scan_plain(boxes, pri, iou_threshold)


def mask_scan_kernel(boxes: torch.Tensor, scores, valid, pri,
                     iou_threshold: float, score_threshold: float,
                     window: int | None = None,
                     chunk: int | None = None) -> torch.Tensor:
    """Kernel B on CUDA tensors (operator mt::mask_scan): boxes (B, T, 4)
    f32 contiguous, and either scores (B, T) f32 and valid (B, T) bool,
    whose priorities the kernel makes as `mask_priority` does for f32
    inputs, or `pri` (B, T) f32 made by the caller (scores and valid None)
    -> keep (B, T) bool.  Any T is taken; window and chunk as A's."""
    _build.require_cuda(*(v for v in (boxes, scores, valid, pri)
                          if v is not None))
    if (pri is None) == (scores is None or valid is None):
        raise ValueError("kernel B takes scores and valid, or pri")
    window, chunk = _window_chunk(window, chunk)
    b, t = boxes.shape[:2]
    dev = boxes.device
    keep = torch.empty(b, t, dtype=torch.bool, device=dev)
    pool = torch.empty(b, t, dtype=torch.int64, device=dev)
    kept = torch.empty(b, t, 4, dtype=torch.float32, device=dev)
    ptrs = (None, None, pri.data_ptr()) if pri is not None else (
        scores.data_ptr(), valid.data_ptr(), None)
    _build.launch("nms", "launch_mask_scan", _MASK_SCAN_ARGS,
                  boxes.data_ptr(), *ptrs, b, t, iou_threshold,
                  score_threshold, window, chunk, pool.data_ptr(),
                  kept.data_ptr(), keep.data_ptr(),
                  what="mask_scan_kernel (kernel B)")
    return keep


def area_sorted_nms(boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, *,
                    iou_threshold: float = 0.45,
                    score_threshold: float = 0.35) -> torch.Tensor:
    """Second-stage NMS: keep mask over the input rows of (T, 4) or
    (B, T, 4) boxes.  Rows that are valid with score > score_threshold
    compete by area, descending, ties to the lowest row; suppression is
    class-agnostic at IoU > iou_threshold.
    CUDA tensors launch kernel B (f32 boxes and scores: the kernel makes
    the priorities; other dtypes: `mask_priority` makes them first); CPU
    tensors run the plain version."""
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    valid = valid.to(torch.bool)
    f32 = torch.float32
    if not _build.on_cpu(boxes, scores, valid) \
            and boxes.dtype == f32 and scores.dtype == f32:
        keep = torch.ops.mt.mask_scan(
            boxes.contiguous(), scores.contiguous(), valid.contiguous(),
            None, iou_threshold, score_threshold, NMS_WINDOW, NMS_CHUNK)
    else:
        keep = torch.ops.mt.mask_scan(
            boxes.to(f32).contiguous(), None, None,
            mask_priority(boxes, scores, valid, score_threshold),
            iou_threshold, score_threshold, NMS_WINDOW, NMS_CHUNK)
    return keep[0] if single else keep
