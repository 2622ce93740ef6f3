"""Batch inference: host decode + resolution-bucketed two-stage pipeline.

  * frames decode on host threads (serve/imageio.py);
  * frames are bucketed by resolution, and each bucket runs
    letterbox -> detect -> NMS -> crop -> classify as one enqueued forward
    (models/two_stage.py); results map back to input order;
  * outputs are packed into one f32 array per batch, so a result costs one
    device -> host copy;
  * detections the fused classify budget dropped are re-classified by the
    overflow ladder, so every kept box is classified at any density.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import defaultdict, deque
from typing import Sequence

import numpy as np
import torch

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.config import (CLASS_NAMES, DetectConfig,
                                         detect_config_from_meta)
from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
from yolov8_vit_tpu_torch.models.vit import ViTSpec
from yolov8_vit_tpu_torch.serve import imageio
from yolov8_vit_tpu_torch.weights import (init_tree, load_pipeline_tree,
                                          load_tree, read_engine)


# fused steps in flight ahead of the drain in run_device_batches
_DEPTH = 4


class _HostCopy:
    """A device -> host copy in flight: pinned buffer + completion event on
    CUDA (the copy streams behind compute); a plain copy on the CPU."""

    def __init__(self, tensors):
        self.arrays = []
        self.event = None
        for t in tensors:
            if t.is_cuda:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
            else:
                host = t.clone()
            self.arrays.append(host)
        if any(t.is_cuda for t in tensors):
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [a.numpy() for a in self.arrays]


@dataclasses.dataclass
class BatchRunner:
    pipeline: TwoStagePipeline
    max_batch: int = 8

    @property
    def device(self) -> torch.device:
        return self.pipeline.device

    def _fn(self, images: torch.Tensor) -> torch.Tensor:
        """Fused pipeline -> one packed (B, 1 + 9T) f32 array."""
        o = self.pipeline(images)
        b = images.shape[0]
        f32 = torch.float32
        return torch.cat([
            o["num_dets"].reshape(b, 1).to(f32),
            o["boxes"].reshape(b, -1),
            o["det_scores"],
            o["det_labels"].to(f32),
            o["final_valid"].to(f32),
            o["cls_labels"].to(f32),
            o["cls_scores"],
        ], dim=1)

    @torch.no_grad()
    def _cls_fn(self, images, slot_img, slot_boxes):
        """Overflow re-classify: the fused graph's own crop + classifier
        ops on explicit slots, so labels equal a larger budget's."""
        return self.pipeline.classify(images, slot_img, slot_boxes)

    def _unpack(self, arr: np.ndarray) -> list[dict]:
        t = self.pipeline.det_cfg.nms_topk
        out = []
        for row in arr:
            parts = np.split(row, np.cumsum([1, 4 * t, t, t, t, t]))
            out.append({
                "num_dets": int(parts[0][0]),
                "boxes": parts[1].reshape(t, 4).copy(),
                "det_scores": parts[2].copy(),
                "det_labels": parts[3].astype(np.int32),
                "final_valid": parts[4].astype(bool),
                "cls_labels": parts[5].astype(np.int32),
                "cls_scores": parts[6].copy(),
            })
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _decode(path: str):
        """RGB (H, W, 3) uint8, or None when the file does not decode."""
        return imageio.imread_rgb(path)

    def _enqueue(self, paths: Sequence[str],
                 profile: dict | None = None) -> dict:
        """Decode + dispatch every chunk (async on CUDA); returns the
        in-flight request state for `_finish`."""
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.perf_counter()
        with ThreadPoolExecutor(min(8, max(len(paths), 1))) as pool:
            imgs = list(pool.map(self._decode, paths))
        t1 = time.perf_counter()
        buckets: dict[tuple[int, int], list[int]] = defaultdict(list)
        for i, img in enumerate(imgs):
            if img is not None:
                buckets[img.shape[:2]].append(i)
        pending = []
        for _hw, idxs in buckets.items():
            for start in range(0, len(idxs), self.max_batch):
                chunk = idxs[start:start + self.max_batch]
                batch = np.stack([imgs[i] for i in chunk])
                if len(chunk) < self.max_batch:
                    # pad the tail chunk to the full batch: one static
                    # shape per resolution (padded rows dropped in _finish)
                    pad = self.max_batch - len(chunk)
                    batch = np.concatenate(
                        [batch, np.zeros((pad, *batch.shape[1:]),
                                         batch.dtype)])
                dev_batch = torch.from_numpy(batch).to(self.device)
                res = self._fn(dev_batch)
                pending.append((chunk, dev_batch, _HostCopy([res])))
        t2 = time.perf_counter()
        if profile is not None:
            profile["decode_ms"] = profile.get("decode_ms", 0.0) + \
                (t1 - t0) * 1e3
            profile["enqueue_ms"] = profile.get("enqueue_ms", 0.0) + \
                (t2 - t1) * 1e3
        return {"n": len(paths), "pending": pending}

    def _finish(self, state: dict,
                profile: dict | None = None) -> list[dict | None]:
        results: list[dict | None] = [None] * state["n"]
        t2 = time.perf_counter()
        t_over = 0.0
        for chunk, dev_batch, copy in state["pending"]:
            recs = self._unpack(copy.get()[0])
            to = time.perf_counter()
            self._reclassify_overflow(recs[:len(chunk)], dev_batch)
            t_over += time.perf_counter() - to
            for idx, rec in zip(chunk, recs):
                results[idx] = rec
        t3 = time.perf_counter()
        if profile is not None:
            profile["fetch_ms"] = profile.get("fetch_ms", 0.0) + \
                (t3 - t2 - t_over) * 1e3
            profile["overflow_ms"] = profile.get("overflow_ms", 0.0) + \
                t_over * 1e3
        return results

    def run_paths(self, paths: Sequence[str],
                  profile: dict | None = None) -> list[dict | None]:
        """Decode + run; one result dict per input path (None when the
        image failed to decode), in input order.  Every chunk is enqueued
        before any result is fetched.  `profile`, when given, accumulates
        decode_ms, enqueue_ms, fetch_ms and overflow_ms."""
        return self._finish(self._enqueue(paths, profile), profile)

    def run_stream(self, requests, profile: dict | None = None):
        """Generator over a stream of requests (each a path list): request
        N+1 decodes and enqueues while request N's results are in flight.
        Yields one result list per request, in order."""
        prev = None
        for paths in requests:
            state = self._enqueue(paths, profile)
            if prev is not None:
                yield self._finish(prev, profile)
            prev = state
        if prev is not None:
            yield self._finish(prev, profile)

    def run_device_batches(self, dev_batches, profile: dict | None = None
                           ) -> list[list[dict]]:
        """Bulk path for device-resident frame batches (no decode, no
        upload).  Fused steps enqueue at most 4 ahead of the drain,
        each with an async copy of its packed result into pinned memory
        (a CUDA event marks its completion), so transfers stream behind
        compute.  The bound matters for the overflow ladder: a ladder chunk
        enqueued at drain time runs behind every step enqueued so far.
        Returns one ladder-patched rec list per input batch."""
        pending: deque = deque()
        window: deque = deque()
        out = []
        stats = {"fetch": 0.0, "ladder": 0.0, "over": 0}

        def drain_one():
            dv, copy = pending.popleft()
            t0 = time.perf_counter()
            recs = self._unpack(copy.get()[0])
            t1 = time.perf_counter()
            for part, fetched in self._ladder_dispatch(recs, dv):
                stats["over"] += len(part)
                window.append((part, fetched))
                if len(window) >= 8:
                    self._ladder_patch(*window.popleft())
            stats["fetch"] += t1 - t0
            stats["ladder"] += time.perf_counter() - t1
            out.append(recs)

        for dv in dev_batches:
            pending.append((dv, _HostCopy([self._fn(dv)])))
            if len(pending) > _DEPTH:
                drain_one()
        while pending:
            drain_one()
        t2 = time.perf_counter()
        while window:
            self._ladder_patch(*window.popleft())
        stats["ladder"] += time.perf_counter() - t2
        if profile is not None:
            profile["fetch_ms"] = profile.get("fetch_ms", 0.0) + \
                stats["fetch"] * 1e3
            profile["overflow_ms"] = profile.get("overflow_ms", 0.0) + \
                stats["ladder"] * 1e3
            profile["overflow_dets"] = profile.get("overflow_dets", 0) + \
                stats["over"]
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def _host_inflate(boxes: np.ndarray, w: int, h: int) -> np.ndarray:
        """Host replica of the pipeline's crop-box arithmetic (round ->
        inflate_boxes -> round), integer-exact."""
        ib = np.round(boxes.astype(np.float64)).astype(np.int32) \
               .astype(np.float32)
        dx = ((np.floor(ib[:, 2] - ib[:, 0]).astype(np.int32) // 10) // 2) \
            .astype(np.float32)
        dy = ((np.floor(ib[:, 3] - ib[:, 1]).astype(np.int32) // 10) // 2) \
            .astype(np.float32)
        out = np.stack([np.maximum(0.0, ib[:, 0] - dx),
                        np.maximum(0.0, ib[:, 1] - dy),
                        np.minimum(float(w), ib[:, 2] + dx),
                        np.minimum(float(h), ib[:, 3] + dy)], -1)
        return np.round(out).astype(np.int32)

    @staticmethod
    def _overflow(recs: list) -> list[tuple[int, int]]:
        """(rec index, det index) of kept detections left unclassified."""
        return [(r, int(k)) for r, rec in enumerate(recs)
                for k in np.nonzero(rec["final_valid"]
                                    & (rec["cls_labels"] < 0))[0]]

    def _reclassify_overflow(self, recs: list, dev_batch) -> None:
        """Classify the detections the classify budget dropped, patching
        recs in place, with at most 8 ladder chunks in flight."""
        window: deque = deque()
        for part_dev in self._ladder_dispatch(recs, dev_batch):
            window.append(part_dev)
            if len(window) >= 8:
                self._ladder_patch(*window.popleft())
        while window:
            self._ladder_patch(*window.popleft())

    def _ladder_dispatch(self, recs: list, dev_batch):
        """Yield (part, copy in flight) ladder dispatches for the overflow
        detections of `recs`; `part` holds (rec, det index) pairs.  Two
        chunk sizes: K = max_batch * budget slots for the common few-crop
        overflow, 8K to bound the dispatches on dense scenes."""
        over = self._overflow(recs)
        h, w = int(dev_batch.shape[1]), int(dev_batch.shape[2])
        k_small = self.max_batch * self.pipeline.classify_budget
        k_large = k_small * 8
        start = 0
        while start < len(over):
            k_slots = k_large if len(over) - start > k_small else k_small
            part = over[start:start + k_slots]
            start += len(part)
            slot_img = np.zeros((k_slots,), np.int32)
            slot_boxes = np.zeros((k_slots, 4), np.int32)
            for j, (r, k) in enumerate(part):
                slot_img[j] = r
                slot_boxes[j] = self._host_inflate(
                    recs[r]["boxes"][k:k + 1], w, h)[0]
            labels, scores = self._cls_fn(
                dev_batch, torch.from_numpy(slot_img).to(self.device),
                torch.from_numpy(slot_boxes).to(self.device))
            yield [(recs[r], k) for r, k in part], _HostCopy([labels, scores])

    @staticmethod
    def _ladder_patch(part, copy: _HostCopy) -> None:
        labels, scores = copy.get()
        for j, (rec, k) in enumerate(part):
            rec["cls_labels"][k] = labels[j]
            rec["cls_scores"][k] = scores[j]

    # ------------------------------------------------------------------
    def flatten(self, paths: Sequence[str],
                results: Sequence[dict | None]) -> list[tuple]:
        """Flattened (img, cls_id, conf, x1, y1, x2, y2) tuples, sorted by
        image name; unclassified detections keep their stage-1 label."""
        rows = []
        for path, res in zip(paths, results):
            if res is None:
                continue
            name = os.path.basename(path)
            for k in np.nonzero(res["final_valid"])[0]:
                cls = int(res["cls_labels"][k])
                if cls < 0:
                    cls = int(res["det_labels"][k])
                box = res["boxes"][k]
                rows.append((name, cls, float(res["det_scores"][k]),
                             int(box[0]), int(box[1]), int(box[2]),
                             int(box[3])))
        rows.sort(key=lambda r: r[0])
        return rows

    def to_objects(self, result: dict) -> list[dict]:
        """One result dict -> VOC-style objects list."""
        objs = []
        for k in np.nonzero(result["final_valid"])[0]:
            cls = int(result["cls_labels"][k])
            if cls < 0:
                cls = int(result["det_labels"][k])
            box = result["boxes"][k]
            objs.append({"sort": CLASS_NAMES[cls],
                         "xmin": int(box[0]), "ymin": int(box[1]),
                         "xmax": int(box[2]), "ymax": int(box[3])})
        return objs


def make_runner(det_engine_path: str | None = None,
                vit_engine_path: str | None = None,
                det_cfg: DetectConfig = DetectConfig(),
                classify_budget: int = 4, dtype=torch.bfloat16,
                rng_seed: int = 0, device="cuda") -> BatchRunner:
    """Build a BatchRunner from engine dirs written by `save_engine` (the
    JAX package's or the port's; random params from `rng_seed` where
    absent).  Without a classify engine the ViT is the default ViTSpec()
    (ViT-B/8, float weights).

    det_engine_path may be a merged "two_stage" engine, whose pipeline
    config and both trees are used directly.  Every ViT spec is served
    with attn_impl="fused": kernel E, or kernel D for quant="w8a"."""
    device = _build.resolve_device(device)
    vit_spec = ViTSpec()
    det_tree = vit_tree = None
    det_overrides: tuple = ()
    if det_engine_path:
        meta, tree = read_engine(det_engine_path)
        det_cfg = detect_config_from_meta(meta.get("detect_cfg", {}))
        det_overrides = tuple(sorted(meta.get("det_spec", {}).items()))
        if meta["kind"] == "two_stage":
            spec = dataclasses.replace(ViTSpec(**meta.get("vit_spec", {})),
                                       attn_impl="fused")
            pipe = TwoStagePipeline(
                det_cfg=det_cfg, vit_spec=spec,
                num_classes=meta.get("num_classes", 5),
                classify_budget=meta.get("classify_budget", classify_budget),
                det_overrides=det_overrides, dtype=dtype, device=device)
            return BatchRunner(load_pipeline_tree(pipe, tree))
        if meta["kind"] != "detect":
            raise ValueError(f"{det_engine_path}: kind {meta['kind']!r} is "
                             f"not a detect or two_stage engine")
        det_tree = tree["params"]
    num_classes = 5
    if vit_engine_path:
        meta, tree = read_engine(vit_engine_path)
        if meta["kind"] != "classify":
            raise ValueError(f"{vit_engine_path}: kind {meta['kind']!r} is "
                             f"not a classify engine")
        vit_spec = ViTSpec(**meta.get("vit_spec", {}))
        num_classes = meta.get("num_classes", 5)
        vit_tree = tree["params"]
    # attn_impl is a runtime choice, not a weight property: serving takes
    # the fused attention path
    vit_spec = dataclasses.replace(vit_spec, attn_impl="fused")
    pipe = TwoStagePipeline(det_cfg=det_cfg, vit_spec=vit_spec,
                            num_classes=num_classes,
                            classify_budget=classify_budget, dtype=dtype,
                            det_overrides=det_overrides, device=device)
    if det_tree is None or vit_tree is None:
        tree = init_tree(pipe, rng_seed)
        det_tree = tree["det"]["params"] if det_tree is None else det_tree
        vit_tree = tree["vit"]["params"] if vit_tree is None else vit_tree
    load_tree(pipe.det, det_tree)
    load_tree(pipe.vit, vit_tree)
    return BatchRunner(pipe)
