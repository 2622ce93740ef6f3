"""PyTorch port, the package's import surface and signatures:

  * each package's exported names (its `__init__`'s imports, assignments
    and lazy `__getattr__` names) equal the JAX package's, less the
    TPU-layout names with no counterpart, plus the port's own additions;
  * the functions added for that surface equal JAX's on the same inputs;
  * the bare `import yolov8_vit_tpu_torch` loads no torch;
  * the trainers' signatures take JAX's parameters in JAX's order, with
    the port's `device` last, so a JAX-shaped positional call binds as it
    does in JAX.
"""
import ast
import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("", "models", "runtime", "serve", "ops", "train", "data",
            "utils", "parallel")
# TPU layout and XLA plumbing, no counterpart by design (ROADMAP.md)
NO_COUNTERPART = {"letterbox_s2d", "enable_compilation_cache"}
# names only the port exports: the launch counts of the CUDA kernels,
# the kernels no JAX __init__ names (the float ViT's MLP
# sub-block among them), and the SwinV2 classifier (the JAX package has no
# Swin)
PORT_ONLY = {
    "ops": {"reset_launch_counts", "launch_counts",
            "fused_attention_block_i8", "crop_to_patches_i8", "fused_b1b2",
            "prepare_region", "region_b1b2_plain", "nms_single_label",
            "conv_silu", "window_attention", "mlp_block"},
    "models": {"SwinV2Classifier", "SwinV2Spec"},
}
# names the port binds otherwise: `ops.letterbox` stays the module (the
# JAX package rebinds it to the function, ops.letterbox.letterbox here)
BOUND_OTHERWISE = {"ops": {"letterbox"}}


def _exported(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.FunctionDef):
            if node.name == "__getattr__":
                names |= {c.value for c in ast.walk(node)
                          if isinstance(c, ast.Constant)
                          and isinstance(c.value, str)
                          and c.value[:1].isupper()}
            else:
                names.add(node.name)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def _init(pkg: str, sub: str) -> str:
    return os.path.join(REPO, pkg, *([sub] if sub else []), "__init__.py")


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "package")
def test_exported_names_equal_jax(sub):
    want = _exported(_init("yolov8_vit_tpu", sub)) - NO_COUNTERPART
    got = _exported(_init("yolov8_vit_tpu_torch", sub))
    other = BOUND_OTHERWISE.get(sub, set())
    assert got - PORT_ONLY.get(sub, set()) == want - other
    mod = __import__("yolov8_vit_tpu_torch" + (f".{sub}" if sub else ""),
                     fromlist=["_"])
    for name in want:
        assert hasattr(mod, name), name


def test_bare_import_loads_no_torch():
    code = ("import sys, yolov8_vit_tpu_torch as p; "
            "assert 'torch' not in sys.modules, 'torch loaded'; "
            "print(p.__version__, p.CFG().lr, p.DetectConfig().variant)")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert run.returncode == 0, run.stderr
    assert run.stdout.split() == ["0.1.0", "0.0001", "s"]


def test_lazy_two_stage_pipeline():
    from yolov8_vit_tpu_torch import models
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    assert models.TwoStagePipeline is TwoStagePipeline
    with pytest.raises(AttributeError):
        models.NoSuchModel


# ---- the functions added for the surface -----------------------------------------
def _boxes(rng, n, side=100.0):
    xy = rng.uniform(0, side, (n, 2))
    wh = rng.uniform(0, side / 3, (n, 2))
    b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    b[0, 2:] = b[0, :2]                  # a zero-area box
    return b


def test_box_iou_matches_jax():
    from yolov8_vit_tpu.ops.boxes import box_iou as j_box_iou
    from yolov8_vit_tpu_torch.ops import box_iou
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 9), _boxes(rng, 7)
    b[1] = a[1]                          # an identical pair: IoU 1
    got = box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(j_box_iou(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (9, 7)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_normalize_pm1_matches_jax():
    from yolov8_vit_tpu.ops.preprocess import normalize_pm1 as j_norm
    from yolov8_vit_tpu_torch.ops import normalize_pm1
    x = np.random.default_rng(1).uniform(0, 1, (2, 5, 5, 3)) \
        .astype(np.float32)
    np.testing.assert_array_equal(normalize_pm1(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_norm(jnp.asarray(x))))


CROP_BOXES = np.array([[10, 15, 70, 50], [0, 0, 96, 64], [40, 40, 41, 41],
                       [80, 50, 120, 90], [30, 30, 20, 20]], np.int32)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("name", ["crop_and_resize_nearest",
                                  "crop_and_resize_nearest_gather"])
def test_crops_match_jax(name, dtype):
    from yolov8_vit_tpu.ops import crop as jcrop
    from yolov8_vit_tpu_torch.ops import crop
    img = np.random.default_rng(2).integers(0, 256, (64, 96, 3)) \
        .astype(dtype)
    for out_hw in [(32, 32), (24, 40)]:
        got = getattr(crop, name)(torch.from_numpy(img),
                                  torch.from_numpy(CROP_BOXES), out_hw)
        want = np.asarray(getattr(jcrop, name)(
            jnp.asarray(img), jnp.asarray(CROP_BOXES), out_hw))
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_crop_to_patches_matches_jax():
    from yolov8_vit_tpu.ops.crop import crop_to_patches as j_ctp
    from yolov8_vit_tpu_torch.ops.crop import crop_to_patches
    img = np.random.default_rng(3).integers(0, 256, (64, 96, 3), np.uint8)
    got = crop_to_patches(torch.from_numpy(img),
                          torch.from_numpy(CROP_BOXES), (32, 32), 8)
    want = np.asarray(j_ctp(jnp.asarray(img), jnp.asarray(CROP_BOXES),
                            (32, 32), 8))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_vit_specs_match_jax():
    from yolov8_vit_tpu.models import vit as jvit
    from yolov8_vit_tpu_torch.models import vit
    for name in ("VIT_B8_224", "VIT_B16_224", "VIT_S16_224", "VIT_L16_224"):
        assert dataclasses.asdict(getattr(vit, name)) == \
            dataclasses.asdict(getattr(jvit, name)), name


def test_runtime_engine_save_engine():
    from yolov8_vit_tpu_torch.runtime import engine
    from yolov8_vit_tpu_torch.weights import save_engine
    assert engine.save_engine is save_engine


# ---- signatures -------------------------------------------------------------------
def _params(fn):
    return list(inspect.signature(fn).parameters)


# (dotted name, the port's extra trailing parameters, JAX's names that
# the port's parameter renames: make_yolo_train_step takes a torch
# optimizer where JAX takes an optax transformation, and builds a step on
# the model's device)
SIGNATURES = [("train.classify.train", ["device"], {}),
              ("train.classify.retrain", ["device"], {}),
              ("train.vit_train.ViTTrainer", ["device"], {}),
              ("train.yolo_train.make_yolo_train_step", [],
               {"tx": "optimizer"}),
              ("train.yolo_train.train", ["device"], {})]


def _resolve(pkg, dotted):
    mod, name = dotted.rsplit(".", 1)
    return getattr(__import__(f"{pkg}.{mod}", fromlist=["_"]), name)


@pytest.mark.parametrize("dotted,extra,renamed", SIGNATURES,
                         ids=[s[0] for s in SIGNATURES])
def test_signature_is_jax_order_then_device(dotted, extra, renamed):
    want = [renamed.get(p, p)
            for p in _params(_resolve("yolov8_vit_tpu", dotted))]
    got = _params(_resolve("yolov8_vit_tpu_torch", dotted))
    assert got == want + extra


@pytest.mark.parametrize("dotted,args", [
    ("train.classify.train", ("cfg", False, None, "wd")),
    ("train.classify.retrain", (True, "cfg", None, "wd")),
    ("train.vit_train.ViTTrainer", ("cfg", "spec", None, "log.json", "ck")),
])
def test_jax_shaped_positional_call_binds_alike(dotted, args):
    want = inspect.signature(_resolve("yolov8_vit_tpu", dotted)).bind(*args)
    got = inspect.signature(_resolve("yolov8_vit_tpu_torch", dotted)) \
        .bind(*args)
    assert dict(got.arguments) == dict(want.arguments)
