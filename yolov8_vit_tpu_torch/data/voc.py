"""Pascal-VOC XML annotation I/O + YOLO txt conversion + data delivery.

Parity surface:
  * `generate_annotation` / `indent`: VOC XML writer used for human label
    ingestion + model-assisted labeling
    (`utils/utils.py:133-245`).
  * `parse_voc_xml` / `scan_xml_dirs`: the XML readers duplicated across the
    reference (`utils/trainClass.py:277-323`,
    `class_config.py:89-148`, `trainYolo.py:68-112`), unified.
  * `convert_box_cxcywh` + `xml2txt`: VOC -> normalized-cxcywh YOLO txt with
    80/20 random split (`utils/class_config.py:28-148`).
  * `deliver`: move new/ image+xml pairs 80/20 into new_train/new_valid
    (`utils/trainClass.py:558-597`).
"""
from __future__ import annotations

import os
import random
import shutil
import warnings
import xml.etree.ElementTree as ET
from typing import Iterable

from yolov8_vit_tpu_torch.config import LABEL_MAPPING


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

def indent(elem: ET.Element, level: int = 0) -> None:
    """Pretty-print helper (two-space indents), reference-identical output.

    This is the stock ElementTree pretty-print recipe (the same widely
    published idiom the reference pasted at
    `utils/utils.py:229-245`); byte-identical XML output
    is the spec here — downstream consumers diff annotation files — so
    the exact text/tail placement is deliberate and pinned by
    tests/test_data_voc.py."""
    i = "\n" + level * "  "
    if len(elem):
        if not elem.text or not elem.text.strip():
            elem.text = i + "  "
        if not elem.tail or not elem.tail.strip():
            elem.tail = i
        sub = None
        for sub in elem:
            indent(sub, level + 1)
        if sub is not None and (not sub.tail or not sub.tail.strip()):
            sub.tail = i
    else:
        if level and (not elem.tail or not elem.tail.strip()):
            elem.tail = i


def generate_annotation(folder_name: str, image_filename: str,
                        image_path: str, objects_data: list[dict],
                        save_dir: str = "train/new/",
                        image_size: tuple[int, int] | None = None) -> str | None:
    """Write a VOC XML annotation; returns the output path.

    `objects_data` items: {'sort': name-or-int, 'xmin','ymin','xmax','ymax'}.
    The reference writes class labels under a <sort> tag (not <name>) and
    hardcodes size 0x0 (`utils/utils.py:160-186`); we keep the <sort> tag for
    read-compat but write real sizes when provided.
    """
    root = ET.Element("annotation")
    ET.SubElement(root, "folder").text = folder_name
    ET.SubElement(root, "filename").text = image_filename
    ET.SubElement(root, "path").text = image_path
    src = ET.SubElement(root, "source")
    ET.SubElement(src, "database").text = "Unknown"
    size = ET.SubElement(root, "size")
    w, h = image_size if image_size else (0, 0)
    ET.SubElement(size, "width").text = str(w)
    ET.SubElement(size, "height").text = str(h)
    ET.SubElement(size, "depth").text = "3"
    ET.SubElement(root, "segmented").text = "0"

    for obj in objects_data:
        node = ET.SubElement(root, "object")
        sort_value = obj["sort"]
        if isinstance(sort_value, int):
            text = str(sort_value)
        else:
            text = str(LABEL_MAPPING.get(sort_value, sort_value))
        ET.SubElement(node, "sort").text = text
        ET.SubElement(node, "pose").text = "Unspecified"
        ET.SubElement(node, "truncated").text = "0"
        ET.SubElement(node, "difficult").text = "0"
        box = ET.SubElement(node, "bndbox")
        for key in ("xmin", "ymin", "xmax", "ymax"):
            ET.SubElement(box, key).text = str(obj[key])

    indent(root)
    os.makedirs(save_dir, exist_ok=True)
    out = os.path.join(save_dir,
                       f"{os.path.splitext(image_filename)[0]}.xml")
    try:
        ET.ElementTree(root).write(out, encoding="utf-8",
                                   xml_declaration=False)
        return out
    except OSError:
        return None


# --------------------------------------------------------------------------
# readers
# --------------------------------------------------------------------------

def parse_voc_xml(path: str) -> dict:
    """One XML -> {'path', 'name', 'width', 'height', 'objects': [...]}.

    Objects carry name/label/xmin/ymin/xmax/ymax.  Accepts class names under
    <name> or <sort> (both appear in the wild — `trainClass.py:301-305`) and
    numeric labels '0'-'4'.
    """
    tree = ET.parse(path)
    root = tree.getroot()
    data_path = root.findtext("path") or ""
    if data_path:
        data_path = os.path.normpath(
            os.path.join(os.path.dirname(path), data_path))
    width = int(root.findtext("size/width") or 0)
    height = int(root.findtext("size/height") or 0)
    objects = []
    for obj in root.findall(".//object"):
        sort = obj.findtext("name") or obj.findtext("sort")
        if sort in {"0", "1", "2", "3", "4"}:
            label = int(sort)
        else:
            label = LABEL_MAPPING.get(sort, -1)
        objects.append({
            "name": sort,
            "label": label,
            "xmin": int(float(obj.findtext(".//xmin"))),
            "ymin": int(float(obj.findtext(".//ymin"))),
            "xmax": int(float(obj.findtext(".//xmax"))),
            "ymax": int(float(obj.findtext(".//ymax"))),
        })
    name = os.path.splitext(root.findtext("filename") or
                            os.path.basename(path))[0]
    return {"path": data_path, "name": name, "width": width,
            "height": height, "objects": objects}


def scan_xml_dirs(dirs: Iterable[str]) -> list[dict]:
    """Walk directories for .xml files -> list of parse_voc_xml dicts."""
    out = []
    for d in dirs:
        if not os.path.isdir(d):
            continue
        for root_dir, _dirs, files in os.walk(d):
            for f in sorted(files):
                if f.endswith(".xml"):
                    out.append(parse_voc_xml(os.path.join(root_dir, f)))
    return out


# --------------------------------------------------------------------------
# VOC -> YOLO txt conversion
# --------------------------------------------------------------------------

def convert_box_cxcywh(box: tuple[float, float, float, float],
                       dw: float, dh: float) -> tuple[float, float, float, float]:
    """xyxy -> normalized (cx, cy, w, h), reference `convert`
    (`utils/class_config.py:28-42`)."""
    x = (box[0] + box[2]) / 2.0 / dw
    y = (box[1] + box[3]) / 2.0 / dh
    w = (box[2] - box[0]) / dw
    h = (box[3] - box[1]) / dh
    return x, y, w, h


def xml2txt(src_dir: str, dst_root: str = "train/yolo/fold0",
            val_fraction: float = 0.2, rng: random.Random | None = None) -> int:
    """Convert a VOC dir to the fold0/{images,labels}/{train,val} layout.

    Returns number of images converted.  Random 80/20 split like the
    reference (`class_config.py:139-148`).  The four split dirs are
    CLEARED first: each retrain cycle redraws the random split, and stale
    files from a prior draw would put the same image in both images/train
    and images/val (training on the validation set — inflated mAP and a
    corrupted best-model gate).
    """
    rng = rng or random
    for sub in ("images/train", "images/val", "labels/train", "labels/val"):
        d = os.path.join(dst_root, sub)
        os.makedirs(d, exist_ok=True)
        for stale in os.listdir(d):
            p = os.path.join(d, stale)
            if os.path.isfile(p):
                os.remove(p)
    n = 0
    for rec in scan_xml_dirs([src_dir]):
        split = "train" if rng.random() > val_fraction else "val"
        w = rec["width"]
        h = rec["height"]
        # YoloDataset pairs image and label by STEM — both must come from
        # the same name.  The copied image keeps its path basename, so the
        # label follows it; rec["name"] (the XML <filename> tag) is only
        # used when no image file exists to copy.
        stem = rec["name"]
        if rec["path"] and os.path.exists(rec["path"]):
            stem = os.path.splitext(os.path.basename(rec["path"]))[0]
            shutil.copy(rec["path"], os.path.join(dst_root, "images", split))
            if not (w and h):
                from PIL import Image
                with Image.open(rec["path"]) as img:
                    w, h = img.size
        if not (w and h):
            continue
        with open(os.path.join(dst_root, "labels", split,
                               stem + ".txt"), "w") as f:
            for obj in rec["objects"]:
                if obj["label"] < 0:
                    # unknown class name: parse_voc_xml maps it to -1 (the
                    # reference's yolo2dict does too, trainYolo.py:84), but
                    # written to a txt it would poison training — the TAL
                    # assigner's gt_labels.clip(0) aliases -1 to class 0
                    # with an all-zero one-hot target.  The reference's own
                    # txt writer hard-KeyErrors instead
                    # (class_config.py:130); we skip the object and keep
                    # the rest of the image.  split_by_circle applies the
                    # same filter on the classifier path.
                    warnings.warn(f"xml2txt: skipping object with unknown "
                                  f"class {obj['name']!r} in {rec['name']}")
                    continue
                x, y, bw, bh = convert_box_cxcywh(
                    (obj["xmin"], obj["ymin"], obj["xmax"], obj["ymax"]), w, h)
                f.write(f"{obj['label']} {x:.5f} {y:.5f} {bw:.5f} {bh:.5f}\n")
        n += 1
    return n


def yolo2dict(xml_dir: str) -> list[tuple[str, list[dict]]]:
    """VOC dir -> sorted [(image_filename, [{'name': label_int, 'xmin'...}])]
    (reference `yolo2dict`, `utils/trainYolo.py:40-120`,
    including numeric-string label passthrough)."""
    out = []
    for rec in scan_xml_dirs([xml_dir]):
        objs = [{"name": o["label"], "xmin": o["xmin"], "ymin": o["ymin"],
                 "xmax": o["xmax"], "ymax": o["ymax"]}
                for o in rec["objects"]]
        out.append((rec["name"] + ".jpg", objs))
    out.sort(key=lambda t: t[0])
    return out


def deliver(source_dir: str = "train/new/",
            dest_train: str = "train/new_train",
            dest_val: str = "train/new_valid",
            val_fraction: float = 0.2,
            rng: random.Random | None = None) -> tuple[int, int]:
    """Move image+xml pairs 80/20 into train/valid dirs; returns counts."""
    rng = rng or random
    os.makedirs(dest_train, exist_ok=True)
    os.makedirs(dest_val, exist_ok=True)
    n_train = n_val = 0
    if not os.path.isdir(source_dir):
        return 0, 0
    files = [f for f in os.listdir(source_dir)
             if f.lower().endswith((".jpg", ".jpeg", ".png"))]
    rng_shuffle = rng.shuffle if hasattr(rng, "shuffle") else random.shuffle
    rng_shuffle(files)
    for fname in files:
        xml = os.path.splitext(fname)[0] + ".xml"
        if not os.path.exists(os.path.join(source_dir, xml)):
            continue
        dest = dest_train if rng.random() > val_fraction else dest_val
        shutil.move(os.path.join(source_dir, fname), os.path.join(dest, fname))
        shutil.move(os.path.join(source_dir, xml), os.path.join(dest, xml))
        if dest == dest_train:
            n_train += 1
        else:
            n_val += 1
    return n_train, n_val
