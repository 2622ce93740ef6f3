"""PyTorch port, `data/voc.py` (VOC XML writer and readers, YOLO txt
conversion, deliver): the same calls on the same files through the JAX
package's module and the port's copy give the same bytes, records, file
layouts and warnings.  Both draw their splits from `random.Random(seed)`."""
import os
import random
import warnings

import numpy as np
import pytest
from PIL import Image

from yolov8_vit_tpu import data as jdata
from yolov8_vit_tpu_torch import data as pdata
from yolov8_vit_tpu_torch.config import LABEL_MAPPING
from yolov8_vit_tpu.config import LABEL_MAPPING as J_LABEL_MAPPING

OBJS = [{"sort": "good", "xmin": 10, "ymin": 20, "xmax": 110, "ymax": 140},
        {"sort": 4, "xmin": 5, "ymin": 6, "xmax": 50, "ymax": 60},
        {"sort": "loss", "xmin": 1, "ymin": 2, "xmax": 30, "ymax": 40}]


def _labeled(mod, d, n, objs=OBJS[:1], tag=None):
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        Image.fromarray(np.zeros((60, 80, 3), np.uint8)).save(
            os.path.join(d, f"img{i}.jpg"))
        mod.generate_annotation("", tag or f"img{i}.jpg", f"img{i}.jpg",
                                objs, save_dir=d, image_size=(80, 60))


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for base, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_label_mapping_is_jax_s():
    assert LABEL_MAPPING == J_LABEL_MAPPING


@pytest.mark.parametrize("size", [None, (640, 480)])
def test_writer_bytes_and_reader_records_equal(tmp_path, size):
    outs = {}
    for name, mod in (("j", jdata), ("p", pdata)):
        out = mod.generate_annotation("fold", "img1.jpg", "img1.jpg", OBJS,
                                      save_dir=str(tmp_path / name),
                                      image_size=size)
        rec = mod.parse_voc_xml(out)
        rec.pop("path")                     # resolved beside the XML file
        outs[name] = (open(out, "rb").read(), rec)
    assert outs["j"][0] == outs["p"][0]
    assert outs["j"][1] == outs["p"][1]
    assert [o["label"] for o in outs["p"][1]["objects"]] == [0, 4, 2]


def test_parse_name_or_sort_tags_and_scan(tmp_path):
    xml = """<annotation><filename>a.jpg</filename>
    <size><width>100</width><height>100</height></size>
    <object><name>broke</name><bndbox><xmin>1</xmin><ymin>2</ymin>
    <xmax>3</xmax><ymax>4</ymax></bndbox></object>
    <object><sort>loss</sort><bndbox><xmin>5</xmin><ymin>6</ymin>
    <xmax>7</xmax><ymax>8</ymax></bndbox></object></annotation>"""
    (tmp_path / "a.xml").write_text(xml)
    (tmp_path / "b.xml").write_text(xml.replace("a.jpg", "b.jpg"))
    assert pdata.parse_voc_xml(str(tmp_path / "a.xml")) == \
        jdata.parse_voc_xml(str(tmp_path / "a.xml"))
    got = pdata.scan_xml_dirs([str(tmp_path), str(tmp_path / "none")])
    assert got == jdata.scan_xml_dirs([str(tmp_path),
                                       str(tmp_path / "none")])
    assert len(got) == 2
    assert pdata.convert_box_cxcywh((10, 20, 110, 220), 200, 400) == \
        jdata.convert_box_cxcywh((10, 20, 110, 220), 200, 400)


@pytest.mark.parametrize("case", ["plain", "unknown_label", "tag_differs"])
def test_xml2txt_same_layout_and_warnings(tmp_path, case):
    objs = OBJS[:1]
    tag = None
    if case == "unknown_label":
        objs = [{"sort": "Mystery", "xmin": 1, "ymin": 2, "xmax": 30,
                 "ymax": 40}] + OBJS[:1]
    if case == "tag_differs":
        tag = "frame_001.jpg"
    res = {}
    for name, mod in (("j", jdata), ("p", pdata)):
        src, dst = str(tmp_path / name / "new"), str(tmp_path / name / "f0")
        _labeled(mod, src, 1 if tag else 10, objs, tag)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            n = mod.xml2txt(src, dst, rng=random.Random(0))
            n2 = mod.xml2txt(src, dst, rng=random.Random(7))   # re-split
        res[name] = (n, n2, _tree(dst), mod.yolo2dict(src),
                     sorted(str(w.message) for w in rec))
    assert res["j"] == res["p"]
    assert res["p"][0] == (1 if tag else 10)
    if case == "unknown_label":
        assert any("Mystery" in m for m in res["p"][4])


def test_deliver_moves_the_same_pairs(tmp_path):
    res = {}
    for name, mod in (("j", jdata), ("p", pdata)):
        root = tmp_path / name
        _labeled(mod, str(root / "new"), 10)
        counts = mod.deliver(str(root / "new"), str(root / "nt"),
                             str(root / "nv"), rng=random.Random(1))
        res[name] = (counts, sorted(_tree(str(root))))
    assert res["j"] == res["p"]
    assert sum(res["p"][0]) == 10
