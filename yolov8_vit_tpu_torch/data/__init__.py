"""Dataset formats of the inspection service (PyTorch port)."""
from yolov8_vit_tpu_torch.data.voc import (  # noqa: F401
    generate_annotation, indent, parse_voc_xml, scan_xml_dirs,
    convert_box_cxcywh, xml2txt, deliver, yolo2dict,
)
