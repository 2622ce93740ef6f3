"""PyTorch port, the smoke example (`examples/smoke.py`) and the accuracy
check (`tools/accuracy_check.py`), run on the CPU.

- The smoke example on a tiny detect engine and a tiny classify engine
  over three small images writes the VOC XMLs that the JAX package's
  `infer.main` + `generate_annotation` write on the same engine dirs,
  byte for byte, and the same rows (integers equal, confidences within
  1e-5, tests/test_torch_runtime.py's detection-score bar).
- The accuracy check's two input forms, the checkpoints (`.pt` + `.pth`)
  and the engine dirs the port's export CLI writes from them, give equal
  compare_fused_vs_host dicts.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from yolov8_vit_tpu.data.voc import generate_annotation as j_generate
from yolov8_vit_tpu.models.yolov8 import YOLOV8_VARIANTS as J_VARIANTS
from yolov8_vit_tpu.runtime.engine import Engine as JEngine
from yolov8_vit_tpu.serve.infer import main as j_infer_main

from yolov8_vit_tpu_torch.examples import smoke
from yolov8_vit_tpu_torch.models.vit import ViTSpec
from yolov8_vit_tpu_torch.runtime import export
from yolov8_vit_tpu_torch.tools import accuracy_check
from yolov8_vit_tpu_torch.weights import init_vit_tree, save_engine

from torch_refs import NetworkWrapper, TimmViT, UYOLOv8

# the host route crops to 224 px: a ViT at 224 with 32-px patches, narrow
VIT_224 = ViTSpec(img_size=224, patch=32, dim=64, depth=2, heads=4,
                  backbone_classes=40)


@pytest.fixture(scope="module")
def det_pt(tmp_path_factory):
    torch.manual_seed(0)
    det = UYOLOv8(dataclasses.replace(J_VARIANTS["n"], num_classes=5)).eval()
    path = str(tmp_path_factory.mktemp("ckpt") / "best.pt")
    torch.save(det.state_dict(), path)
    return path


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(((64, 64), (80, 96), (72, 60))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            root / f"im{i}.png")
    return str(root)


def test_smoke_example_matches_jax(det_pt, images, tmp_path):
    det = export.main(["detect", "--weights", det_pt, "--out",
                       str(tmp_path / "det"), "--variant", "n", "--imgsz",
                       "64", "--conf-thres", "1e-6", "--topk", "16"])
    cls = save_engine(str(tmp_path / "cls"), "classify",
                      init_vit_tree(VIT_224, 5, torch.Generator()
                                    .manual_seed(0)),
                      {"vit_spec": dataclasses.asdict(VIT_224),
                       "num_classes": 5})
    port_xml, jax_xml = str(tmp_path / "port_xml"), str(tmp_path / "jax_xml")
    rows = smoke.main(["--detect-engine", det, "--classify-engine", cls,
                       "--images", images, "--out-xml", port_xml],
                      device="cpu")
    engine = JEngine(det)
    engine.set_desired(["num_dets", "bboxes", "scores", "labels"])

    def func(folder, filename, path, objects):
        j_generate(folder, filename, path, objects, save_dir=jax_xml)

    want = j_infer_main(engine, images, model_list=[JEngine(cls)],
                        func=func)
    assert len(rows) == len(want) > 0
    assert len({r[1] for r in rows}) > 1          # the classifier decided
    for a, b in zip(rows, want):
        assert a[:2] == b[:2] and a[3:] == b[3:]
        assert abs(a[2] - b[2]) <= 1e-5
    names = sorted(os.listdir(port_xml))
    assert names == sorted(os.listdir(jax_xml)) == \
        ["im0.xml", "im1.xml", "im2.xml"]
    for name in names:
        with open(os.path.join(port_xml, name), "rb") as f, \
                open(os.path.join(jax_xml, name), "rb") as g:
            assert f.read() == g.read(), name


def test_accuracy_check_input_forms_agree(det_pt, images, tmp_path):
    """`--det best.pt --vit best.pth` and `--det DIR --vit DIR` (the
    engines exported from those files): the same dict."""
    torch.manual_seed(1)
    vit = NetworkWrapper(TimmViT(img_size=224, patch=16, dim=768, depth=12,
                                 heads=12, num_classes=1000), 5)
    pth = str(tmp_path / "best.pth")
    torch.save(vit.state_dict(), pth)
    del vit
    det = export.main(["detect", "--weights", det_pt, "--out",
                       str(tmp_path / "det"), "--variant", "n", "--imgsz",
                       "64"])
    cls = export.main(["classify", "--weights", pth, "--out",
                       str(tmp_path / "cls"), "--model",
                       "vit_base_patch16_224"])
    common = ["--images", images, "--variant", "n", "--imgsz", "64",
              "--vit-patch", "16"]
    files = accuracy_check.main(["--det", det_pt, "--vit", pth] + common,
                                device="cpu")
    dirs = accuracy_check.main(["--det", det, "--vit", cls] + common,
                               device="cpu")
    assert files == dirs
    assert files["images"] == 3 and files["detections"] > 0
