"""PyTorch port, `runtime/convert.py`: the checkpoint converters held
against the JAX package's on the same state dicts, and the port's models
run from the converted trees.

- The two manifests' full key sets (ultralytics YOLOv8-s `best.pt`, timm
  ViT-B/8 in Network_Wrapper `best.pth`), seeded values: the same tree
  (keys in the same order), leaves bit-equal.
- `torch_refs` models saved with torch.save (UYOLOv8 variant n in eval
  with non-trivial BatchNorm statistics; TimmViT in NetworkWrapper): the
  same, then the port's model on the converted tree against the torch
  model (atol 2e-3, tests/test_convert_files.py) and against the JAX
  model on JAX's tree (tests/test_torch_models.py's bars: 2e-3 on head
  maps, ViT logits atol 5e-5, rtol 1e-4).
- The weights_only refusal, allow_pickle, ultralytics' {"model": module}
  form, and an extra `model.` prefix.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yolov8_vit_tpu.models.vit import ViTClassifier as JViTClassifier
from yolov8_vit_tpu.models.vit import ViTSpec as JViTSpec
from yolov8_vit_tpu.models.yolov8 import YOLOV8_VARIANTS as J_VARIANTS
from yolov8_vit_tpu.models.yolov8 import YOLOv8 as JYOLOv8
from yolov8_vit_tpu.runtime import convert as jconvert

from yolov8_vit_tpu_torch.models.vit import ViTClassifier, ViTSpec
from yolov8_vit_tpu_torch.models.yolov8 import YOLOV8_VARIANTS, YOLOv8
from yolov8_vit_tpu_torch.runtime import convert
from yolov8_vit_tpu_torch.weights import load_tree

from torch_refs import NetworkWrapper, TimmViT, UYOLOv8

MANIFESTS = os.path.join(os.path.dirname(__file__), "manifests")
VIT_KW = dict(img_size=32, patch=8, dim=64, depth=2, heads=4,
              backbone_classes=40)


def _paths(tree, prefix=()):
    """[(path, leaf)] in the tree's own key order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _paths(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def assert_trees_equal(got, want):
    """Same keys in the same order, leaves of one dtype and bit-equal."""
    g, w = _paths(got), _paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))


def _fake_sd(name):
    with open(os.path.join(MANIFESTS, name)) as f:
        manifest = json.load(f)
    rng = np.random.default_rng(0)
    out = {}
    for k, shape in manifest.items():
        v = rng.normal(size=shape).astype(np.float32)
        out[k] = np.abs(v) if "running_var" in k else v
    return out


@pytest.mark.parametrize("manifest", ["yolov8s_nc5_state_dict.json",
                                      "vit_b8_wrapper_state_dict.json"])
def test_manifest_trees_equal_jax(manifest):
    sd = _fake_sd(manifest)
    if manifest.startswith("yolo"):
        got, want = convert.convert_yolov8(sd), jconvert.convert_yolov8(sd)
    else:
        got = convert.convert_vit_wrapper(sd, depth=12)
        want = jconvert.convert_vit_wrapper(sd, depth=12)
    assert_trees_equal(got, want)


def test_extra_model_prefix():
    sd = _fake_sd("yolov8s_nc5_state_dict.json")
    wrapped = {"model." + k: v for k, v in sd.items()}
    assert_trees_equal(convert.convert_yolov8(wrapped),
                       convert.convert_yolov8(sd))


@pytest.fixture(scope="module")
def yolo_pt(tmp_path_factory):
    """UYOLOv8 variant n, eval, BatchNorm statistics drawn from a seed,
    saved as a state dict."""
    torch.manual_seed(0)
    spec = dataclasses.replace(J_VARIANTS["n"], num_classes=5)
    net = UYOLOv8(spec, num_classes=5).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(0.5 + 1.5 * torch.rand(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=g))
    path = str(tmp_path_factory.mktemp("ckpt") / "best.pt")
    torch.save(net.state_dict(), path)
    return net, path


@pytest.fixture(scope="module")
def vit_pth(tmp_path_factory):
    torch.manual_seed(0)
    net = NetworkWrapper(TimmViT(img_size=32, patch=8, dim=64, depth=2,
                                 heads=4, num_classes=40), 5,
                         backbone_classes=40).eval()
    path = str(tmp_path_factory.mktemp("ckpt") / "best.pth")
    torch.save(net.state_dict(), path)
    return net, path


def test_yolo_checkpoint(yolo_pt):
    net, path = yolo_pt
    sd = convert.load_torch_state_dict(path)
    assert all(v.dtype == np.float32 for v in sd.values())
    assert sd["model.0.bn.num_batches_tracked"].shape == ()
    tree = convert.convert_yolov8(sd)
    jtree = jconvert.convert_yolov8(jconvert.load_torch_state_dict(path))
    assert_trees_equal(tree, jtree)

    spec = dataclasses.replace(YOLOV8_VARIANTS["n"], num_classes=5)
    det = load_tree(YOLOv8(spec), tree["params"])
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        got = det(torch.from_numpy(x))
        ref = net(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    jspec = dataclasses.replace(J_VARIANTS["n"], num_classes=5)
    jref = JYOLOv8(jspec, fused=True).apply(jtree, jnp.asarray(x))
    for (gb, gc), (rb, rc), (jb, jc) in zip(got, ref, jref):
        for a, r, j in ((gb, rb, jb), (gc, rc, jc)):
            a = a.numpy()
            np.testing.assert_allclose(a, r.permute(0, 2, 3, 1).numpy(),
                                       atol=2e-3, rtol=0)
            np.testing.assert_allclose(a, np.asarray(j), atol=2e-3, rtol=0)


def test_vit_checkpoint(vit_pth):
    net, path = vit_pth
    tree = convert.convert_vit_wrapper(convert.load_torch_state_dict(path),
                                       depth=2)
    jtree = jconvert.convert_vit_wrapper(
        jconvert.load_torch_state_dict(path), depth=2)
    assert_trees_equal(tree, jtree)
    model = load_tree(ViTClassifier(ViTSpec(**VIT_KW), 5), tree["params"])
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)) \
        .astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        ref = net(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=0)
    jref = np.asarray(JViTClassifier(JViTSpec(**VIT_KW), 5).apply(
        jtree, jnp.asarray(x)))
    np.testing.assert_allclose(got, jref, atol=5e-5, rtol=1e-4)


def test_module_pickles_need_allow_pickle(tmp_path):
    """torch.save of a module (and ultralytics' {"model": module}) loads
    only with allow_pickle=True, with the JAX loader's refusal text."""
    torch.manual_seed(1)
    net = NetworkWrapper(TimmViT(img_size=32, patch=8, dim=64, depth=1,
                                 heads=4, num_classes=16), 5,
                         backbone_classes=16)
    whole, ultra = str(tmp_path / "full.pth"), str(tmp_path / "ultra.pt")
    torch.save(net, whole)
    torch.save({"model": net.half(), "epoch": 3}, ultra)
    for path in (whole, ultra):
        with pytest.raises(ValueError) as got:
            convert.load_torch_state_dict(path)
        with pytest.raises(ValueError) as want:
            jconvert.load_torch_state_dict(path)
        assert str(got.value) == str(want.value)
        assert "weights_only" in str(got.value)
        sd = convert.load_torch_state_dict(path, allow_pickle=True)
        ref = jconvert.load_torch_state_dict(path, allow_pickle=True)
        assert list(sd) == list(ref) and "fc.1.weight" in sd
        for k in sd:
            assert sd[k].dtype == np.float32
            np.testing.assert_array_equal(sd[k], ref[k])
