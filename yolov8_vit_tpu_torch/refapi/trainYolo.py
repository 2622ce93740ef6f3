"""The reference's `utils/trainYolo.py` entry surface, backed by the
port's detector trainer (`train/yolo_train.py`)."""
from __future__ import annotations

from yolov8_vit_tpu_torch.data.voc import yolo2dict  # noqa: F401
from yolov8_vit_tpu_torch.train.yolo_train import train as _train
from yolov8_vit_tpu_torch.train.yolo_train import yolo_retrain


def train(epochs: int, batch: int, data, **kw):
    """`train(epochs, batch, data)`: the val-before-train mAP check, then
    the fine-tune at lr0 = lrf = 1e-4.  `data` is the dataset root (the
    fold0 directory); keyword arguments go to `yolo_train.train` (e.g.
    `device`)."""
    return _train(epochs, batch, data, **kw)


def yoloRetrain(workdir: str = ".", **kw):
    """`yoloRetrain()`: convert train/new's XMLs to the YOLO layout,
    fine-tune and write the detect engine (`yolo_train.yolo_retrain`)."""
    return yolo_retrain(workdir=workdir, **kw)
