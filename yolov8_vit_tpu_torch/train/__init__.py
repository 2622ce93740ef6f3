"""Classifier training (PyTorch port of `yolov8_vit_tpu/train/`, its
classifier half; the detector half is not ported yet)."""
from yolov8_vit_tpu_torch.train.losses import (  # noqa: F401
    focal_loss, label_smoothing_ce, combined_loss,
)
from yolov8_vit_tpu_torch.train.schedule import (  # noqa: F401
    cosine_anneal_schedule,
)
from yolov8_vit_tpu_torch.train.vit_train import (  # noqa: F401
    ViTTrainer, make_optimizer, make_train_step,
)
from yolov8_vit_tpu_torch.train.ema import EMA  # noqa: F401
