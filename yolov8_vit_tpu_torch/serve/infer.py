"""Two-stage inference orchestrator on the host: the per-image flow

  imread -> letterbox -> RGB -> blob -> detect Engine -> un-letterbox ->
  conf > .35 filter -> area-sorted NMS -> per-box inflate + crop ->
  nearest resize -> classify Engine -> draw -> optional upload ->
  optional callback -> sorted (img, cls_id, conf, x1, y1, x2, y2) tuples,

with the same signature and rows as the JAX package's `serve/infer.py`.
The detector runs once per image and all crops of an image classify as
one batch.  For streams of one frame size the fused TwoStagePipeline
(serve/batch_runner.py) does everything in one device program; this host
route takes arbitrary mixed-size input.  Image work goes through
serve/imageio.py.
"""
from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch

from yolov8_vit_tpu_torch.config import CLASS_NAMES
from yolov8_vit_tpu_torch.serve import imageio

_COLORS = [(0, 200, 0), (0, 0, 220), (160, 160, 160), (0, 140, 255),
           (255, 160, 0)]


def path_to_list(imgs) -> list[str]:
    """Single path / list / directory -> sorted list of image paths."""
    if isinstance(imgs, (list, tuple)):
        return [str(p) for p in imgs]
    if os.path.isdir(imgs):
        return sorted(os.path.join(imgs, f) for f in os.listdir(imgs)
                      if f.lower().endswith(imageio.IMAGE_EXTS))
    return [str(imgs)]


def draw_image(image: np.ndarray, box: Sequence[float], cls) -> np.ndarray:
    """Draw one box + label on a BGR image, in place."""
    idx = cls if isinstance(cls, int) else (
        CLASS_NAMES.index(cls) if cls in CLASS_NAMES else 0)
    color = _COLORS[idx % len(_COLORS)]
    x1, y1, x2, y2 = (int(round(v)) for v in box)
    imageio.rectangle(image, (x1, y1), (x2, y2), color, 2)
    name = CLASS_NAMES[idx] if isinstance(cls, int) else str(cls)
    imageio.put_text(image, f"{name}:1", (x1, max(y1 - 5, 12)), color)
    return image


def _letterbox_host(im: np.ndarray, new_wh: tuple[int, int],
                    color=(114, 114, 114)):
    """Host-side letterbox: INTER_LINEAR resize (skipped for a frame
    already at size) and a constant border."""
    shape = im.shape[:2]
    r = min(new_wh[0] / shape[1], new_wh[1] / shape[0])
    new_unpad = int(round(shape[1] * r)), int(round(shape[0] * r))
    dw = (new_wh[0] - new_unpad[0]) / 2
    dh = (new_wh[1] - new_unpad[1]) / 2
    if shape[::-1] != new_unpad:
        im = imageio.resize_linear(im, new_unpad)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    im = imageio.copy_make_border(im, top, bottom, left, right, color)
    return im, r, (dw, dh)


def _crop_nearest_224(rgb: np.ndarray, box: Sequence[int],
                      size: int = 224) -> np.ndarray:
    """Integer crop + nearest resize (the ops/crop.py contract, host
    mirror)."""
    x1, y1, x2, y2 = (int(v) for v in box)
    x1 = min(max(x1, 0), rgb.shape[1] - 1)
    y1 = min(max(y1, 0), rgb.shape[0] - 1)
    x2 = min(max(x2, x1 + 1), rgb.shape[1])
    y2 = min(max(y2, y1 + 1), rgb.shape[0])
    crop = rgb[y1:y2, x1:x2]
    bh, bw = crop.shape[:2]
    sx = np.minimum(np.arange(size) * bw // size, bw - 1)
    sy = np.minimum(np.arange(size) * bh // size, bh - 1)
    return crop[sy[:, None], sx[None, :]]


def _area_nms_host(boxes: np.ndarray, scores: np.ndarray,
                   iou_threshold: float = 0.45) -> np.ndarray:
    """Area-sorted NMS, host mirror of ops.nms.area_sorted_nms.  Returns
    kept indices (input order preserved)."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    order = np.argsort(-areas, kind="stable")
    kept = []
    for i in order:
        ok = True
        for j in kept:
            bi, bj = boxes[i], boxes[j]
            ix = max(0.0, min(bi[2], bj[2]) - max(bi[0], bj[0]))
            iy = max(0.0, min(bi[3], bj[3]) - max(bi[1], bj[1]))
            inter = ix * iy
            union = areas[i] + areas[j] - inter
            if inter / max(union, 1e-9) > iou_threshold:
                ok = False
                break
        if ok:
            kept.append(i)
    return np.sort(np.asarray(kept, np.int64))


def _inflate(box, img_w, img_h):
    """Eval-time inflation: a tenth of each side, halved, per side."""
    x1, y1, x2, y2 = (int(v) for v in box)
    dis_x = (x2 - x1) // 10
    dis_y = (y2 - y1) // 10
    return (max(0, x1 - dis_x // 2), max(0, y1 - dis_y // 2),
            min(img_w, x2 + dis_x // 2), min(img_h, y2 + dis_y // 2))


def _np(out) -> np.ndarray:
    """An engine output (a tensor on any device, any float dtype) as a
    numpy array."""
    if isinstance(out, torch.Tensor):
        out = out.detach()
        if out.dtype == torch.bfloat16:
            out = out.to(torch.float32)
        return out.cpu().numpy()
    return np.asarray(out)


def main(Engine, imgs, device=None, model_list: Sequence = (),
         transform=None, aliyunoss=None, func: Callable | None = None,
         conf_threshold: float | None = None, save_draw_dir: str | None = None,
         upload_prefix: str = "FuChuang/", crop_size: int = 224):
    """Run two-stage inference over images; return flattened sorted tuples.

    Engine: detect Engine (runtime.engine.Engine, kind="detect"); it runs
      on its own device.
    model_list: classifier callables/Engines taking NCHW [-1, 1] float
      crops and returning logits; the first one is used.
    device, transform: accepted for API parity and unused; the crops always
      get the nearest resize and the mean/std .5 normalization.
    func: optional callback func(folder, filename, path, objects), e.g.
      data.voc.generate_annotation for model-assisted labeling.
    crop_size: classifier input side (224 for the deployed ViTs)."""
    del device, transform
    det_cfg = getattr(Engine, "det_cfg")
    h_in, w_in = det_cfg.input_size
    # second-stage thresholds from the engine's config, as the fused
    # pipeline reads them; an explicit conf_threshold still overrides
    area_iou = getattr(det_cfg, "custom_nms_iou", 0.45)
    if conf_threshold is None:
        conf_threshold = getattr(det_cfg, "conf_second", 0.35)
    results = []
    for path in path_to_list(imgs):
        bgr = imageio.imread(path)
        if bgr is None:
            continue
        draw = bgr.copy()
        basename = os.path.basename(path)
        lb, ratio, (dw, dh) = _letterbox_host(bgr, (w_in, h_in))
        rgb = imageio.bgr2rgb(lb)
        tensor = rgb.transpose(2, 0, 1)[None].astype(np.float32) / 255.0

        num, bboxes, scores, labels = Engine(tensor)
        n = int(_np(num).reshape(-1)[0])
        bboxes = _np(bboxes).reshape(-1, 4)[:n]
        scores = _np(scores).reshape(-1)[:n]
        labels = _np(labels).reshape(-1)[:n]

        # un-letterbox to original coords
        bboxes = (bboxes - np.array([dw, dh, dw, dh])) / ratio
        ih, iw = bgr.shape[:2]
        bboxes = bboxes.clip([0, 0, 0, 0], [iw, ih, iw, ih])

        # strictly >, like the device kernel (ops/nms.py area_sorted_nms)
        keep = scores > conf_threshold
        bboxes, scores, labels = bboxes[keep], scores[keep], labels[keep]

        kept = _area_nms_host(bboxes, scores, area_iou)
        bboxes, scores, labels = bboxes[kept], scores[kept], labels[kept]

        objects = []
        cls_ids = labels.astype(int).tolist()
        # crops exist only to feed the classifier
        if len(bboxes) and model_list:
            rgb_full = imageio.bgr2rgb(bgr)
            crops = [_crop_nearest_224(rgb_full, _inflate(np.round(b),
                                                          iw, ih), crop_size)
                     for b in bboxes]
            batch = np.stack(crops).astype(np.float32) / 255.0 * 2.0 - 1.0
            logits = _np(model_list[0](
                np.ascontiguousarray(batch.transpose(0, 3, 1, 2))))
            cls_ids = logits.argmax(-1).astype(int).tolist()

        for i, (box, score) in enumerate(zip(bboxes, scores)):
            cls_id = int(cls_ids[i])
            x1, y1, x2, y2 = (float(v) for v in box)
            draw_image(draw, (x1, y1, x2, y2), cls_id)
            objects.append({"sort": CLASS_NAMES[cls_id],
                            "xmin": int(x1), "ymin": int(y1),
                            "xmax": int(x2), "ymax": int(y2)})
            results.append((basename, cls_id, float(score),
                            int(x1), int(y1), int(x2), int(y2)))

        if save_draw_dir:
            os.makedirs(save_draw_dir, exist_ok=True)
            out_path = os.path.join(save_draw_dir, basename)
            imageio.imwrite(out_path, draw)
            if aliyunoss is not None:
                aliyunoss.put_object_from_file(upload_prefix + basename,
                                               out_path)
        if func is not None:
            func("", basename, path, objects)

    results.sort(key=lambda x: x[0])
    return results
