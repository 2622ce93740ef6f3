"""The inspection service of the PyTorch port."""
from yolov8_vit_tpu_torch.serve.downloads import download_images  # noqa: F401
from yolov8_vit_tpu_torch.serve.oss import AliyunOss, LocalObjectStore, make_object_store  # noqa: F401
from yolov8_vit_tpu_torch.serve.geocode import location2lalo  # noqa: F401
from yolov8_vit_tpu_torch.serve.sse import LogHub, log  # noqa: F401
