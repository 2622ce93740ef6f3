"""PyTorch port, `refapi/`: the reference-API surface held against the
JAX package's `refapi` (tests/test_refapi.py's cases, run on both).

Bars: the timm-name table equal; `build_model`'s converted tree
bit-equal to JAX's and its logits within atol 5e-5, rtol 1e-4 of JAX's
model on the same `.pth` (tests/test_torch_vit.py's float bar);
`crop_image` equal for the same seed; `classExport` writing the engine
dir JAX's writes, byte for byte, and that engine served by both packages'
`buildInferModel` within the same bar.
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from yolov8_vit_tpu import refapi as jrefapi
from yolov8_vit_tpu.models.vit import ViTSpec as JViTSpec
from yolov8_vit_tpu.refapi import trainClass as jtrainClass

from yolov8_vit_tpu_torch import refapi
from yolov8_vit_tpu_torch.config import CFG
from yolov8_vit_tpu_torch.models.vit import ViTClassifier, ViTSpec
from yolov8_vit_tpu_torch.refapi import class_config, trainClass, trainYolo

from torch_refs import NetworkWrapper, TimmViT

VIT_KW = dict(img_size=32, patch=8, dim=64, depth=2, heads=4,
              backbone_classes=40)


class _CFG:
    num_classes = 5


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def assert_trees_equal(got, want):
    """Same keys in the same order, leaves of one dtype and bit-equal."""
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))


def test_surfaces_match_jax():
    for name in ["download_images", "Network_Wrapper", "build_model",
                 "AliyunOss", "make_object_store", "generate_annotation",
                 "indent", "location2lalo", "log", "spec_from_timm_name"]:
        assert callable(getattr(refapi, name)), name
        assert callable(getattr(jrefapi, name)), name
    for name in ["set_seed", "cosine_anneal_schedule", "crop_image",
                 "build_model", "build_loss", "focal_loss",
                 "label_smoothing_ce", "train", "classExport",
                 "buildInferModel", "deliver", "retrain", "Network_Wrapper"]:
        assert callable(getattr(trainClass, name)), name
    for name in ["train", "yolo2dict", "yoloRetrain"]:
        assert callable(getattr(trainYolo, name)), name
    assert class_config.CFG().num_classes == 5
    for name in ("convert", "xml2txt", "scan_xml_dirs"):
        assert callable(getattr(class_config, name)), name
    assert dataclasses.asdict(class_config.CFG()) == \
        dataclasses.asdict(jtrainClass._CFG())


@pytest.mark.parametrize("size", ["tiny", "small", "base", "large"])
@pytest.mark.parametrize("patch,img", [(8, 224), (16, 224), (32, 384)])
def test_spec_from_timm_name_matches_jax(size, patch, img):
    name = f"vit_{size}_patch{patch}_{img}.augreg_in21k"
    got = refapi.spec_from_timm_name(name)
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(jrefapi.spec_from_timm_name(name))
    assert (got.img_size, got.patch) == (img, patch)
    over = refapi.spec_from_timm_name(name, depth=2, quant="w8")
    assert dataclasses.asdict(over) == dataclasses.asdict(
        jrefapi.spec_from_timm_name(name, depth=2, quant="w8"))


def test_spec_from_timm_name_refuses():
    for mod in (refapi, jrefapi):
        with pytest.raises(ValueError, match="unrecognized timm ViT name"):
            mod.spec_from_timm_name("resnet50")


@pytest.fixture(scope="module")
def wrapper_pth(tmp_path_factory):
    torch.manual_seed(0)
    net = NetworkWrapper(TimmViT(img_size=32, patch=8, dim=64, depth=2,
                                 heads=4, num_classes=40), 5,
                         backbone_classes=40).eval()
    path = str(tmp_path_factory.mktemp("ckpt") / "wrapper.pth")
    torch.save(net.state_dict(), path)
    return path


def test_build_model_from_pth_matches_jax(wrapper_pth):
    model, params = refapi.build_model(_CFG, "vit_base_patch8_224",
                                       wrapper_pth, spec=ViTSpec(**VIT_KW),
                                       device="cpu")
    jmodel, jparams = jrefapi.build_model(_CFG, "vit_base_patch8_224",
                                          wrapper_pth,
                                          spec=JViTSpec(**VIT_KW))
    assert isinstance(model, ViTClassifier)
    assert_trees_equal(params, jax.tree.map(np.asarray, jparams))
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_build_model_fresh_init():
    """A seeded init: the same tree twice, JAX's keys and shapes."""
    spec = ViTSpec(**dict(VIT_KW, depth=1))
    model, params = refapi.build_model(_CFG, "vit_base_patch8_224", None,
                                       spec=spec, device="cpu")
    _, again = refapi.build_model(_CFG, "vit_base_patch8_224", None,
                                  spec=spec, device="cpu")
    assert_trees_equal(params, again)
    _, jparams = jrefapi.build_model(_CFG, "vit_base_patch8_224", None,
                                     spec=JViTSpec(**dict(VIT_KW, depth=1)))

    assert {p: v.shape for p, v in _leaves(params)} == \
        {p: v.shape for p, v in _leaves(jparams)}
    with torch.no_grad():
        assert tuple(model(torch.zeros(1, 32, 32, 3)).shape) == (1, 5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            refapi.build_model(_CFG, "vit_base_patch8_224", None, spec=spec)


@pytest.mark.parametrize("training", [False, True])
def test_crop_image_matches_jax(tmp_path, training):
    from PIL import Image
    img = np.random.default_rng(1).integers(0, 256, (100, 120, 3), np.uint8)
    p = str(tmp_path / "im.png")
    Image.fromarray(img).save(p)
    for box in ((20, 30, 60, 70), (0, 0, 119, 99), (50, 10, 58, 95)):
        got = trainClass.crop_image(p, *box, training=training,
                                    rng=np.random.default_rng(5))
        want = jtrainClass.crop_image(p, *box, training=training,
                                      rng=np.random.default_rng(5))
        np.testing.assert_array_equal(got, want)
    if not training:
        # eval inflation: (40 // 10) // 2 = 2 a side
        np.testing.assert_array_equal(
            trainClass.crop_image(p, 20, 30, 60, 70), img[28:72, 18:62])


def test_class_export_roundtrip_matches_jax(wrapper_pth, tmp_path):
    """classExport of a .pth with a modelName override writes JAX's engine
    dir (the meta describes the override's architecture); both packages'
    buildInferModel serve it alike; a missing dir gives None."""
    spec = ViTSpec(**VIT_KW)
    out = trainClass.classExport(CFG(), wrapper_pth, "vit_base_patch8_32",
                                 out_dir=str(tmp_path / "port"), spec=spec)
    ref = jtrainClass.classExport(jtrainClass._CFG(), wrapper_pth,
                                  "vit_base_patch8_32",
                                  out_dir=str(tmp_path / "jax"),
                                  spec=JViTSpec(**VIT_KW))
    for name in ("meta.json", "params.msgpack"):
        with open(f"{out}/{name}", "rb") as f, \
                open(f"{ref}/{name}", "rb") as g:
            assert f.read() == g.read(), name
    eng = trainClass.buildInferModel(out, device="cpu")
    jeng = jtrainClass.buildInferModel(out)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)) \
        .astype(np.float32)
    got = eng(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jeng(jnp.asarray(x))),
                               atol=5e-5, rtol=1e-4)
    assert got.shape == (2, CFG().num_classes)
    assert trainClass.buildInferModel(str(tmp_path / "missing"),
                                      device="cpu") is None


def test_class_export_fresh_init(tmp_path):
    """No checkpoint: a seeded init, exported with the spec the model
    name gives (the override repair), loadable by the port."""
    out = trainClass.classExport(CFG(), None, "vit_tiny_patch8_32",
                                 out_dir=str(tmp_path / "eng"))
    eng = trainClass.buildInferModel(out, device="cpu")
    assert eng.vit_spec == refapi.spec_from_timm_name("vit_tiny_patch8_32")
    assert tuple(eng(torch.zeros(1, 32, 32, 3)).shape) == (1, 5)


def test_train_yolo_forwards(monkeypatch):
    """trainYolo's names call yolo_train's with the reference's argument
    order and pass keyword arguments (e.g. device) through."""
    seen = {}
    monkeypatch.setattr(trainYolo, "_train",
                        lambda *a, **k: seen.setdefault("train", (a, k)))
    monkeypatch.setattr(trainYolo, "yolo_retrain",
                        lambda **k: seen.setdefault("retrain", k))
    trainYolo.train(3, 16, "root/fold0", device="cpu")
    trainYolo.yoloRetrain("work", epochs=2)
    assert seen["train"] == ((3, 16, "root/fold0"), {"device": "cpu"})
    assert seen["retrain"] == {"workdir": "work", "epochs": 2}
