"""Runtime of the PyTorch port: the detector's decode, engines and the
checkpoint converters."""
from yolov8_vit_tpu_torch.runtime.detector import decode_predictions  # noqa: F401
from yolov8_vit_tpu_torch.runtime.engine import Engine, save_engine  # noqa: F401
from yolov8_vit_tpu_torch.runtime.convert import (  # noqa: F401
    convert_vit_wrapper, convert_yolov8, load_torch_state_dict,
)
