"""Models of the PyTorch port: the ViT and SwinV2 classifiers, YOLOv8 and
the two-stage pipeline."""
from yolov8_vit_tpu_torch.models.swin import SwinV2Classifier, SwinV2Spec  # noqa: F401
from yolov8_vit_tpu_torch.models.vit import ViT, ViTClassifier, VIT_B8_224  # noqa: F401
from yolov8_vit_tpu_torch.models.yolov8 import YOLOv8, YOLOV8_VARIANTS  # noqa: F401


def __getattr__(name):
    # lazy: two_stage imports runtime.detector, whose package imports
    # runtime.engine, which imports two_stage
    if name == "TwoStagePipeline":
        from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
        return TwoStagePipeline
    raise AttributeError(name)
