"""Classifier dataset: VOC-XML-driven crop sampling with circle-class
balancing (PyTorch port of `yolov8_vit_tpu/train/dataset.py`):

  * `split_by_circle`: per-object records split into non-circle and
    circle lists, each shuffled;
  * a train draw takes the circle pool with probability
    len(circle) / len(all);
  * crops inflated by a random amount up to side // 10 at train, by
    (side // 10) // 2 at eval;
  * one-hot labels; the eval set is both pools concatenated.

Batches are NHWC float32 numpy arrays in [-1, 1] made by host threads;
the trainer copies them to its device.
"""
from __future__ import annotations

import os
import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from yolov8_vit_tpu_torch.config import CFG
from yolov8_vit_tpu_torch.data.voc import scan_xml_dirs
from yolov8_vit_tpu_torch.train.augment import eval_transform, \
    train_transform


def _bounded_map(pool: ThreadPoolExecutor, fn, items, window: int):
    """Order-preserving pool.map with at most `window` items in flight
    (Executor.map submits the whole iterable at once and would hold every
    decoded image of the epoch)."""
    pending = deque()
    for x in items:
        pending.append(pool.submit(fn, x))
        if len(pending) >= window:
            yield pending.popleft().result()
    while pending:
        yield pending.popleft().result()


def split_by_circle(dirs: Sequence[str], rng: random.Random | None = None,
                    skip_names: Sequence[str] = ("well5_0011.jpg",)):
    """Scan XML dirs -> (objects, objects_circle) flat per-object records;
    objects of an unknown class are dropped."""
    rng = rng or random
    objects, circle = [], []
    n_bad = 0
    for rec in scan_xml_dirs(dirs):
        if os.path.basename(rec["path"]) in skip_names:
            continue
        for obj in rec["objects"]:
            if not 0 <= obj["label"] <= 4:
                n_bad += 1
                continue
            row = {"path": rec["path"], "objects": obj, "name": rec["name"],
                   "width": rec["width"], "height": rec["height"]}
            (circle if obj["label"] == 4 else objects).append(row)
    if n_bad:
        print(f"split_by_circle: skipped {n_bad} objects with unknown "
              "class labels")
    rng.shuffle(objects)
    rng.shuffle(circle)
    return objects, circle


def crop_record(row: dict, training: bool,
                rng: np.random.Generator) -> np.ndarray:
    """Open the image, inflate the box (random at train, half-fixed at
    eval) and crop: uint8 HWC RGB."""
    from PIL import Image
    obj = row["objects"]
    with Image.open(row["path"]) as im:
        im = im.convert("RGB")
        width, height = im.size
        x1, y1, x2, y2 = obj["xmin"], obj["ymin"], obj["xmax"], obj["ymax"]
        dis_x = (x2 - x1) // 10
        dis_y = (y2 - y1) // 10
        if training:
            x2 = min(width, x2 + int(rng.integers(0, dis_x + 1)))
            x1 = max(0, x1 - int(rng.integers(0, dis_x + 1)))
            y2 = min(height, y2 + int(rng.integers(0, dis_y + 1)))
            y1 = max(0, y1 - int(rng.integers(0, dis_y + 1)))
        else:
            x2 = min(width, x2 + dis_x // 2)
            x1 = max(0, x1 - dis_x // 2)
            y2 = min(height, y2 + dis_y // 2)
            y1 = max(0, y1 - dis_y // 2)
        return np.asarray(im.crop((x1, y1, x2, y2)))


class ClassifierData:
    """Train / eval batch iterators over the two object pools."""

    def __init__(self, cfg: CFG, objects: list, objects_circle: list,
                 training: bool, seed: int | None = None,
                 workers: int = 8):
        self.cfg = cfg
        self.objects = objects
        self.circle = objects_circle
        self.training = training
        self.rate = (len(objects_circle) /
                     max(len(objects) + len(objects_circle), 1))
        self.eval_set = objects + objects_circle
        self.seed = cfg.seed if seed is None else seed
        self.workers = workers

    def __len__(self):
        return len(self.eval_set)

    def _sample_row(self, rng: np.random.Generator):
        if rng.random() > self.rate and self.objects:
            return self.objects[int(rng.integers(0, len(self.objects)))]
        pool = self.circle or self.objects
        return pool[int(rng.integers(0, len(pool)))]

    def batches(self, batch_size: int, epoch: int = 0,
                drop_last: bool = False
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield (imgs NHWC float32, onehot float32).  Item i of an epoch
        draws from its own np.random.default_rng([seed, epoch, i]), so the
        batches do not depend on thread scheduling."""
        size = self.cfg.img_size[0]
        nc = self.cfg.num_classes

        def item_rng(i):
            return np.random.default_rng([self.seed, epoch, i])

        def load_train(i):
            rng = item_rng(i)
            row = self._sample_row(rng)
            img = crop_record(row, True, rng)
            return train_transform(img, rng, size), row["objects"]["label"]

        def load_eval(args):
            i, row = args
            img = crop_record(row, False, item_rng(i))
            return eval_transform(img, size), row["objects"]["label"]

        items = (range(len(self.eval_set)) if self.training
                 else list(enumerate(self.eval_set)))
        loader = load_train if self.training else load_eval
        with ThreadPoolExecutor(self.workers) as pool:
            batch_imgs, batch_labels = [], []
            for img, label in _bounded_map(
                    pool, loader, items,
                    window=max(2 * batch_size, 2 * self.workers)):
                batch_imgs.append(img)
                batch_labels.append(label)
                if len(batch_imgs) == batch_size:
                    yield (np.stack(batch_imgs),
                           np.eye(nc, dtype=np.float32)[batch_labels])
                    batch_imgs, batch_labels = [], []
            if batch_imgs and not drop_last:
                yield (np.stack(batch_imgs),
                       np.eye(nc, dtype=np.float32)[batch_labels])


def build_dataloaders(cfg: CFG, seed: int | None = None):
    """(train ClassifierData, valid ClassifierData) from cfg's paths."""
    r = random.Random(cfg.seed if seed is None else seed)
    tr_obj, tr_cir = split_by_circle(cfg.train_path, r)
    va_obj, va_cir = split_by_circle(cfg.valid_path, r)
    return (ClassifierData(cfg, tr_obj, tr_cir, training=True, seed=seed),
            ClassifierData(cfg, va_obj, va_cir, training=False, seed=seed))
