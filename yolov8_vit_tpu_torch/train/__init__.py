"""Training (PyTorch port of `yolov8_vit_tpu/train/`): the classifier's
(losses, schedule, vit_train, classify) and the detector's (yolo_loss,
yolo_train, map_eval)."""
from yolov8_vit_tpu_torch.train.losses import (  # noqa: F401
    focal_loss, label_smoothing_ce, combined_loss,
)
from yolov8_vit_tpu_torch.train.schedule import (  # noqa: F401
    cosine_anneal_schedule,
)
from yolov8_vit_tpu_torch.train.vit_train import (  # noqa: F401
    ViTTrainer, make_optimizer, make_train_step,
)
from yolov8_vit_tpu_torch.train.yolo_loss import (  # noqa: F401
    yolo_detection_loss, task_aligned_assign, pairwise_ciou,
)
from yolov8_vit_tpu_torch.train.map_eval import evaluate_map  # noqa: F401
from yolov8_vit_tpu_torch.train.ema import EMA  # noqa: F401
