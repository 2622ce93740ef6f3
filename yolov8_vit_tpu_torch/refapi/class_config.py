"""The reference's `utils/class_config.py` surface: the CFG
hyper-parameter class and the VOC -> YOLO conversion helpers."""
from __future__ import annotations

from yolov8_vit_tpu_torch.config import CFG  # noqa: F401
from yolov8_vit_tpu_torch.data.voc import (convert_box_cxcywh as convert,  # noqa: F401
                                           xml2txt, scan_xml_dirs)  # noqa: F401
