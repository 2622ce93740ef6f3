"""Plain two-stage inspection pipeline: what the deployed service computes
for a frame, written from its contract, in float32.

  letterbox: scale r = min(W_in / w, H_in / h), size round(w r) x
           round(h r), bilinear with half-pixel centres clamped at the
           edges (cv2's INTER_LINEAR), padded with 114 at offsets
           round(d - 0.1) of d = (W_in - new_w) / 2 (and the same for the
           height); boxes map back as (x - d) / r -> /255
  YOLOv8 -> DFL expectation over reg_max bins, sigmoid scores
  stage 1: EfficientNMS, multi-label: every (anchor, class) with score >
           conf is a candidate; greedy by score (ties: lowest class-major
           flat index), a pick suppresses same-class boxes of IoU > iou;
           at most top_k picks
  clip to the frame; stage 2: picks with score > conf_second compete by
           box area, descending (ties: lowest pick), and suppress any box
           of IoU > custom_nms_iou, whatever its class
  every kept box: rounded, each side moved out by (side // 10) // 2 and
           clamped, nearest-resized to the classifier's input (integer
           source index x1 + dst * w // out_w), pixels / 127.5 - 1
  ViT -> softmax; the class is the argmax

Stage 1 and 2 run per frame in numpy on the host, in float64 boxes.
Nothing here imports the program.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference.vit import ViT
from benchmark.reference.yolov8 import Detector


@contextlib.contextmanager
def exact_f32():
    """float32 products on the card: cuDNN's and cuBLAS's TF32 off for the
    block, restored after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _interp(dst: int, src: int) -> np.ndarray:
    c = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    c0 = np.floor(c)
    f = c - c0
    m = np.zeros((dst, src))
    np.add.at(m, (np.arange(dst), np.clip(c0, 0, src - 1).astype(int)), 1 - f)
    np.add.at(m, (np.arange(dst), np.clip(c0 + 1, 0, src - 1).astype(int)), f)
    return m


def letterbox(frames: torch.Tensor, out_hw):
    """uint8 (B, H, W, 3) -> (f32 (B, h, w, 3) in [0, 255], r, (dw, dh))."""
    h, w = frames.shape[1], frames.shape[2]
    oh, ow = out_hw
    r = min(ow / w, oh / h)
    nw, nh = int(round(w * r)), int(round(h * r))
    dw, dh = (ow - nw) / 2.0, (oh - nh) / 2.0
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    x = frames.to(torch.float32)
    if (nh, nw) != (h, w):
        dev = frames.device
        rh = torch.as_tensor(_interp(nh, h), dtype=torch.float32, device=dev)
        rw = torch.as_tensor(_interp(nw, w), dtype=torch.float32, device=dev)
        x = torch.einsum("nh,bhwc->bnwc", rh, x)
        x = torch.einsum("mw,bnwc->bnmc", rw, x)
    out = torch.full((frames.shape[0], oh, ow, 3), 114.0,
                     device=frames.device)
    out[:, top:top + nh, left:left + nw] = x
    return out, r, (dw, dh)


def anchors(input_hw, strides):
    pts, st = [], []
    for s in strides:
        fh, fw = input_hw[0] // s, input_hw[1] // s
        gy, gx = np.meshgrid(np.arange(fh) + 0.5, np.arange(fw) + 0.5,
                             indexing="ij")
        pts.append(np.stack([gx, gy], -1).reshape(-1, 2))
        st.append(np.full((fh * fw, 1), float(s)))
    return np.concatenate(pts), np.concatenate(st)


def iou_one(box, boxes):
    """IoU of one xyxy box against (N, 4)."""
    iw = np.clip(np.minimum(box[2], boxes[:, 2])
                 - np.maximum(box[0], boxes[:, 0]), 0, None)
    ih = np.clip(np.minimum(box[3], boxes[:, 3])
                 - np.maximum(box[1], boxes[:, 1]), 0, None)
    inter = iw * ih
    area = lambda b: (np.clip(b[..., 2] - b[..., 0], 0, None)  # noqa: E731
                      * np.clip(b[..., 3] - b[..., 1], 0, None))
    return inter / np.maximum(area(box) + area(boxes) - inter, 1e-9)


def stage1(boxes, scores, conf, iou, top_k):
    """One frame: boxes (A, 4), scores (A, C) -> picks (boxes, scores,
    labels) in pick order."""
    a, c = scores.shape
    cls_major = scores.T.reshape(-1)
    cand = np.nonzero(cls_major > conf)[0]
    order = cand[np.lexsort((cand, -cls_major[cand]))]
    alive = np.ones(len(order), bool)
    picks = []
    lab = order // a
    box = boxes[order % a]
    for j in range(len(order)):
        if not alive[j]:
            continue
        picks.append(order[j])
        if len(picks) == top_k:
            break
        same = (lab == lab[j]) & alive
        same[j] = False
        alive &= ~(same & (iou_one(box[j], box) > iou))
        alive[j] = False
    picks = np.array(picks, dtype=np.int64)
    return boxes[picks % a], cls_major[picks], (picks // a).astype(np.int64)


def stage2(boxes, scores, conf, iou):
    """Keep mask over stage-1 picks: area-sorted, class-agnostic."""
    area = (np.clip(boxes[:, 2] - boxes[:, 0], 0, None)
            * np.clip(boxes[:, 3] - boxes[:, 1], 0, None))
    cand = np.nonzero(scores > conf)[0]
    order = cand[np.lexsort((cand, -area[cand]))]
    keep = np.zeros(len(boxes), bool)
    alive = np.ones(len(boxes), bool)
    for j in order:
        if not alive[j]:
            continue
        keep[j] = True
        alive &= ~(iou_one(boxes[j], boxes) > iou)
        alive[j] = False
    return keep


def crop_boxes(boxes, w, h):
    """Kept boxes -> the classifier's integer crop boxes."""
    ib = np.round(boxes).astype(np.int64)
    ex = ((ib[:, 2] - ib[:, 0]) // 10) // 2
    ey = ((ib[:, 3] - ib[:, 1]) // 10) // 2
    return np.stack([np.maximum(0, ib[:, 0] - ex), np.maximum(0, ib[:, 1] - ey),
                     np.minimum(w, ib[:, 2] + ex), np.minimum(h, ib[:, 3] + ey)],
                    -1)


def crops(frames: torch.Tensor, frame_idx, cboxes, size: int) -> torch.Tensor:
    """Nearest-resized crops (K, size, size, 3) in [-1, 1] f32."""
    h, w = frames.shape[1], frames.shape[2]
    b = torch.as_tensor(cboxes, dtype=torch.int64, device=frames.device)
    x1, y1, x2, y2 = b.unbind(-1)
    bw = (x2 - x1).clamp_min(1)[:, None]
    bh = (y2 - y1).clamp_min(1)[:, None]
    d = torch.arange(size, device=frames.device)[None]
    sx = (x1[:, None] + torch.minimum(d * bw // size, bw - 1)).clamp(0, w - 1)
    sy = (y1[:, None] + torch.minimum(d * bh // size, bh - 1)).clamp(0, h - 1)
    fi = torch.as_tensor(frame_idx, dtype=torch.int64,
                         device=frames.device)[:, None, None]
    px = frames[fi, sy[:, :, None], sx[:, None, :]]
    return px.to(torch.float32) / 127.5 - 1.0


class Pipeline:
    """The reference two-stage pipeline over one weight tree."""

    def __init__(self, tree: dict, cfg: dict, det_lowp: bool = False,
                 vit_mode: str = "f32"):
        det = {k: v for k, v in _flat(tree["det"]["params"]).items()}
        vit = {k: v for k, v in _flat(tree["vit"]["params"]).items()}
        self.cfg = cfg
        self.det = Detector(det, cfg["detector"], lowp=det_lowp)
        self.vit = ViT(vit, cfg["vit"], mode=vit_mode)

    @torch.no_grad()
    def detect(self, frames: torch.Tensor) -> list[dict]:
        """frames (B, H, W, 3) uint8 -> per frame {boxes (T, 4), scores,
        labels, keep, anchors, anchors_raw}: stage-1 picks in order, frame
        coordinates; anchors: every anchor's (box clipped to the frame,
        scores); anchors_raw: every anchor's box as stage 1 compares it."""
        d = self.cfg["detector"]
        lb, r, (dw, dh) = letterbox(frames, d["input_size"])
        outs = self.det(lb / 255.0)
        box = torch.cat([b.reshape(b.shape[0], -1, b.shape[-1])
                         for b, _ in outs], 1)
        cls = torch.cat([c.reshape(c.shape[0], -1, c.shape[-1])
                         for _, c in outs], 1)
        reg = d["reg_max"]
        prob = torch.softmax(box.reshape(*box.shape[:2], 4, reg), -1)
        ltrb = (prob @ torch.arange(reg, dtype=torch.float32,
                                    device=prob.device)).double().cpu().numpy()
        scores = torch.sigmoid(cls).double().cpu().numpy()
        pts, st = anchors(d["input_size"], d["strides"])
        boxes = (np.concatenate([pts - ltrb[..., :2], pts + ltrb[..., 2:]],
                                -1) * st - [dw, dh, dw, dh]) / r
        h, w = frames.shape[1], frames.shape[2]
        res = []
        for f in range(frames.shape[0]):
            bx, sc, lb = stage1(boxes[f], scores[f], d["nms_conf"],
                                d["nms_iou"], d["nms_topk"])
            bx = np.minimum(np.clip(bx, 0, None), [w, h, w, h])
            keep = stage2(bx, sc, d["conf_second"], d["custom_nms_iou"])
            res.append({"boxes": bx, "scores": sc, "labels": lb,
                        "keep": keep, "anchors": (
                            np.minimum(np.clip(boxes[f], 0, None),
                                       [w, h, w, h]).astype(np.float32),
                            scores[f].astype(np.float32)),
                        "anchors_raw": boxes[f].astype(np.float32)})
        return res

    @torch.no_grad()
    def classify(self, frames: torch.Tensor, frame_idx, boxes,
                 block: int = 64) -> np.ndarray:
        """Logits (K, C) of the crops of `boxes` (K, 4) xyxy in frame
        coordinates, in blocks of `block` crops."""
        h, w = frames.shape[1], frames.shape[2]
        size = self.cfg["vit"]["img_size"]
        cb = crop_boxes(np.asarray(boxes, np.float64).reshape(-1, 4), w, h)
        out = []
        for s in range(0, len(cb), block):
            x = crops(frames, frame_idx[s:s + block], cb[s:s + block], size)
            out.append(self.vit(x).double().cpu().numpy())
        n = self.vit.p["fc2.bias"].shape[0]
        return np.concatenate(out) if out else np.zeros((0, n))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out
