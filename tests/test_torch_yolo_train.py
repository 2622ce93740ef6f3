"""PyTorch port, the detector's training (yolov8_vit_tpu_torch/train/
yolo_train.py, models/yolov8.py's training form) held against the JAX
package's on the same inputs, made from numpy seeds, and the same params
(a JAX `save_engine` dir read by the port), at tiny sizes
(DetectConfig(input_size=(64, 64), variant="n")).

Bars:
  - the optimizer against the optax chain over 12 steps through warmup,
    with tests/test_yolo_optimizer.py's setup and bar (rtol 2e-5, atol
    2e-6); the LR schedule within 1e-6 relative (f32 both);
  - OpenCV's uint8 RGB -> HSV and HSV -> RGB equal on every input (2^24
    RGB triples, 180 x 256 x 256 HSV triples), `augment_hsv` equal to
    JAX's; the uint8 affine warp equal to cv2.warpAffine and
    `random_affine` equal to JAX's (image, boxes, labels);
  - `YoloDataset.batches` (plain and mosaic) equal to JAX's for one seed;
  - the multi-scale resize within 1e-6 of jax.image.resize at 0.75 and
    1.25 (f32 sums of 2-4 terms in another order, values in [0, 1]);
  - one train step: loss within 1e-4 relative, each leaf's gradient
    within 1e-3 of its largest |g|, params within 1e-6 (chip_smoke.py's
    TRAIN_STEP_TOL);
  - train(epochs=1, batch=2): the epoch loss within 1e-4 relative, the
    final (EMA) params within 1e-3 of each leaf's largest magnitude, the
    validation metrics equal;
  - yolo_retrain's engine loaded by JAX's Engine, head maps within 2e-3
    of the port's (tests/test_fulldim_parity.py's bar).
"""
import dataclasses
import os
import random
import threading

import cv2
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax
from PIL import Image

from yolov8_vit_tpu.config import DetectConfig as JDetectConfig
from yolov8_vit_tpu.data.voc import generate_annotation
from yolov8_vit_tpu.data.voc import xml2txt as j_xml2txt
from yolov8_vit_tpu.models.yolov8 import YOLOv8 as JYOLOv8
from yolov8_vit_tpu.models.yolov8 import detect_spec as j_detect_spec
from yolov8_vit_tpu.runtime.engine import Engine as JEngine
from yolov8_vit_tpu.runtime.engine import save_engine as j_save_engine
from yolov8_vit_tpu.train import yolo_train as jt

from yolov8_vit_tpu_torch.config import DetectConfig
from yolov8_vit_tpu_torch.models import yolov8 as ty
from yolov8_vit_tpu_torch.train import augment
from yolov8_vit_tpu_torch.train import yolo_train as tt
from yolov8_vit_tpu_torch.weights import load_tree, module_tree, read_engine

from test_yolo_optimizer import (EPOCHS, LR0, LRF, MOM, NW, SPE, WBLR, WD,
                                 WMOM, _flatten, _tiny_tree)

CFG_KW = dict(input_size=(64, 64), variant="n", num_classes=5,
              nms_pre_topk=64, nms_topk=16)
TINY_CFG = DetectConfig(**CFG_KW)
J_TINY_CFG = JDetectConfig(**CFG_KW)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


# ---- optimizer, schedule ------------------------------------------------------
def test_optimizer_matches_optax_chain():
    rng = np.random.default_rng(1)
    tree = _tiny_tree(rng)
    flat = list(_flatten(tree))
    n_steps = EPOCHS * SPE
    grads = [{p: rng.normal(size=l.shape).astype(np.float32)
              * (40.0 if i % 3 == 0 else 0.1) for p, l in flat}
             for i in range(n_steps)]

    named = {".".join(p): torch.nn.Parameter(torch.tensor(l))
             for p, l in flat}
    opt = tt.make_yolo_optimizer(named, LR0, LRF, EPOCHS, SPE, NW,
                                 weight_decay=WD, momentum=MOM,
                                 warmup_momentum=WMOM, warmup_bias_lr=WBLR)
    for ni in range(n_steps):
        for p, _ in flat:
            named[".".join(p)].grad = torch.tensor(grads[ni][p])
        opt.step()

    jparams = jax.tree.map(jnp.asarray, tree)
    tx = jt.make_yolo_optimizer(LR0, LRF, EPOCHS, SPE, NW, weight_decay=WD,
                                momentum=MOM, warmup_momentum=WMOM,
                                warmup_bias_lr=WBLR)
    state = tx.init(jparams)
    for ni in range(n_steps):
        gtree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jparams),
            [jnp.asarray(grads[ni][p]) for p, _ in flat])
        upd, state = tx.update(gtree, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
    assert opt.count == n_steps
    for p, _ in flat:
        np.testing.assert_allclose(
            named[".".join(p)].detach().numpy(),
            np.asarray(jparams[p[0]][p[1]][p[2]]), rtol=2e-5, atol=2e-6,
            err_msg=str(p))


def test_group_labels_equal_jax():
    model = JYOLOv8(j_detect_spec(J_TINY_CFG), fused=True)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    for path, leaf in _leaves(params):
        assert tt.param_group_label(path, leaf) == \
            jt.param_group_label(path, leaf), path


@pytest.mark.parametrize("lrf,warmup,cos", [(1.0, 100, False),
                                            (0.01, 0, False),
                                            (0.01, 30, True)])
def test_lr_schedule_equals_jax(lrf, warmup, cos):
    a = tt.make_lr_schedule(1e-2, lrf, 1000, warmup, cos)
    b = jt.make_lr_schedule(1e-2, lrf, 1000, warmup, cos)
    for c in (0, 1, 29, 99, 100, 200, 500, 999, 1000, 1200):
        np.testing.assert_allclose(float(a(c)), float(b(c)), rtol=1e-6,
                                   err_msg=str(c))


# ---- augmentations -------------------------------------------------------------
# rows of 256 pixels run OpenCV's 32-pixel SIMD blocks only; rows of 16
# its scalar tail only
@pytest.mark.parametrize("width", [256, 16])
def test_rgb2hsv_equals_cv2_on_every_input(width):
    v = np.arange(256, dtype=np.uint8)
    for r in range(0, 256, 32):          # 8 chunks of 2^21 triples
        rr, g, b = np.meshgrid(np.arange(r, r + 32, dtype=np.uint8), v, v,
                               indexing="ij")
        img = np.stack([rr, g, b], -1).reshape(-1, width, 3)
        np.testing.assert_array_equal(augment.rgb2hsv_u8(img),
                                      cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [256, 16])
def test_hsv2rgb_equals_cv2_on_every_input(width):
    v = np.arange(256, dtype=np.uint8)
    h, s, val = np.meshgrid(np.arange(180, dtype=np.uint8), v, v,
                            indexing="ij")
    img = np.stack([h, s, val], -1).reshape(-1, width, 3)
    np.testing.assert_array_equal(augment.hsv2rgb_u8(img),
                                  cv2.cvtColor(img, cv2.COLOR_HSV2RGB))
    with pytest.raises(ValueError, match="hue"):
        augment.hsv2rgb_u8(np.full((1, 1, 3), 180, np.uint8))


@pytest.mark.parametrize("seed", range(3))
def test_augment_hsv_equals_jax(seed):
    img = np.random.default_rng(seed).integers(0, 256, (48, 80 + seed, 3),
                                               dtype=np.uint8)
    got = tt.augment_hsv(img, np.random.default_rng(seed + 10))
    want = jt.augment_hsv(img, np.random.default_rng(seed + 10))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, img)
    np.testing.assert_array_equal(
        tt.augment_hsv(img, np.random.default_rng(0), 0, 0, 0), img)


@pytest.mark.parametrize("seed", range(6))
def test_warp_affine_u8_equals_cv2(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (int(rng.integers(40, 90)),
                                int(rng.integers(40, 90)), 3),
                       dtype=np.uint8)
    a = rng.uniform(-0.5, 0.5) if seed % 2 else 0.0
    s = rng.uniform(0.5, 1.6)
    m = np.array([[np.cos(a) * s, -np.sin(a) * s, rng.uniform(-30, 30)],
                  [np.sin(a) * s, np.cos(a) * s, rng.uniform(-30, 30)]],
                 np.float32)
    np.testing.assert_array_equal(
        augment.warp_affine_u8(img, m, 48),
        cv2.warpAffine(img, m, (48, 48), borderValue=(114, 114, 114)))


@pytest.mark.parametrize("canvas", [False, True])
@pytest.mark.parametrize("degrees", [0.0, 10.0])
def test_random_affine_equals_jax(canvas, degrees):
    rng = np.random.default_rng(3)
    s = 48
    if canvas:     # a mosaic canvas: f32 in [0, 1], truncated to uint8
        img = rng.integers(0, 256, (2 * s, 2 * s, 3)).astype(np.float32) \
            / np.float32(255.0)
    else:
        img = rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)
    xy = rng.uniform(0, 60, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 40, (6, 2))],
                           1).astype(np.float32)
    labels = np.arange(6, dtype=np.int32)
    for seed in range(4):
        got = tt.random_affine(img, boxes, labels,
                               np.random.default_rng(seed), s,
                               degrees=degrees)
        want = jt.random_affine(img, boxes, labels,
                                np.random.default_rng(seed), s,
                                degrees=degrees)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---- dataset ---------------------------------------------------------------------
def _make_voc_dir(d, n=10):
    """n street-like frames, half JPEG (PIL decodes them in both packages)
    and half BMP (numpy in the port, PIL in JAX), one or two boxes each."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        arr = rng.normal(90, 20, (72, 96, 3)).clip(0, 255).astype(np.uint8)
        objs = []
        for k in range(1 + i % 2):
            x1, y1 = int(rng.integers(2, 60)), int(rng.integers(2, 40))
            w, h = int(rng.integers(12, 34)), int(rng.integers(12, 30))
            arr[y1:y1 + h, x1:x1 + w] = rng.integers(150, 255, 3)
            objs.append({"sort": ("good", "broke", "circle")[(i + k) % 3],
                         "xmin": x1, "ymin": y1, "xmax": x1 + w,
                         "ymax": y1 + h})
        name = f"img{i}." + ("jpg" if i % 2 else "bmp")
        Image.fromarray(arr).save(os.path.join(d, name))
        generate_annotation("", name, name, objs, save_dir=d,
                            image_size=(96, 72))


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    root = tmp_path_factory.mktemp("yolo")
    _make_voc_dir(str(root / "new"))
    dst = str(root / "fold0")
    assert j_xml2txt(str(root / "new"), dst, val_fraction=0.3,
                     rng=random.Random(2)) == 10
    return dst


@pytest.mark.parametrize("augment_on,mosaic", [(False, 0.0), (True, 0.0),
                                               (True, 1.0), (True, 0.5)])
def test_batches_equal_jax(fold, augment_on, mosaic):
    port = tt.YoloDataset(fold, "train", 64, 8)
    ref = jt.YoloDataset(fold, "train", 64, 8)
    assert len(port) == len(ref) >= 4
    got = list(port.batches(3, augment=augment_on, seed=5, mosaic=mosaic))
    want = list(ref.batches(3, augment=augment_on, seed=5, mosaic=mosaic))
    assert len(got) == len(want) > 0
    for gb, wb in zip(got, want):
        for g, w in zip(gb, wb):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    val = list(tt.YoloDataset(fold, "val", 64, 8).batches(
        4, drop_last=False))
    for gb, wb in zip(val, jt.YoloDataset(fold, "val", 64, 8).batches(
            4, drop_last=False)):
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("factor", [0.75, 1.25])
def test_multiscale_resize_matches_jax(factor):
    x = np.random.default_rng(0).random((2, 64, 64, 3), np.float32)
    sz = int(64 * factor)
    got = tt.resize_bilinear_antialias(torch.from_numpy(x), sz)
    want = jax.image.resize(jnp.asarray(x), (2, sz, sz, 3), "bilinear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---- the training form -------------------------------------------------------------
def test_train_form_trains_every_leaf_in_f32():
    from yolov8_vit_tpu_torch.models.yolov8 import YOLOv8, detect_spec
    model = tt.build_train_model(TINY_CFG, None, "cpu")
    names = {n for n, _ in model.named_parameters()}
    tree = dict(_leaves(module_tree(model)))
    assert names == {".".join(p) for p in tree}
    assert not list(model.buffers())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out = model(torch.rand(1, 64, 64, 3))
    sum(o.sum() for pair in out for o in pair).backward()
    assert all(p.grad is not None and bool(p.grad.abs().sum() > 0)
               for p in model.parameters())
    with pytest.raises(ValueError, match="f32"):
        YOLOv8(detect_spec(TINY_CFG), dtype=torch.bfloat16).train_form()


def test_f32_training_holds_and_restores_the_tf32_switches():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, matmul.allow_tf32)
    seen = []
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        with ty.f32_training():
            seen.append((cudnn.allow_tf32, matmul.allow_tf32))
            # another thread's conv_f32 waits for the step
            t = threading.Thread(target=lambda: seen.append(
                ty._TF32_LOCK.acquire(timeout=0.05)))
            t.start()
            t.join(5)
        assert not t.is_alive()
        assert seen == [(False, False), False]
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def test_trainer_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tt.train(1, 2, str(tmp_path), TINY_CFG)
    with pytest.raises(RuntimeError, match="cuda"):
        tt.yolo_retrain(str(tmp_path), TINY_CFG)


# ---- train step, train, retrain against JAX --------------------------------------
@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """A detect engine written by JAX's save_engine from JAX's init."""
    model = JYOLOv8(j_detect_spec(J_TINY_CFG), fused=True)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 3)))
    path = str(tmp_path_factory.mktemp("engine") / "detect_engine")
    cfg = dataclasses.asdict(J_TINY_CFG)
    j_save_engine(path, "detect", params, {"detect_cfg": cfg})
    return path


def test_train_step_matches_jax(fold, jax_engine):
    imgs, boxes, labels, mask = next(tt.YoloDataset(fold, "train", 64, 8)
                                     .batches(2, augment=True, seed=1))
    hw = TINY_CFG.input_size
    # the JAX step
    jmodel = JYOLOv8(j_detect_spec(J_TINY_CFG), fused=True)
    jparams = JEngine(jax_engine).params
    tx = jt.make_yolo_optimizer(1e-4, 1.0, 1, 2, 100)
    state = tx.init(jparams)
    jstep = jt.make_yolo_train_step(jmodel, tx, hw, 16)

    def jloss(p):
        bd, cl = jt.flatten_head_outputs(jmodel.apply(p, jnp.asarray(imgs)))
        return jt.yolo_detection_loss(bd, cl, boxes, labels, mask, hw)[0]
    jgrads = jax.jit(jax.grad(jloss))(jparams)
    jnew, _, jl, _ = jstep(jparams, state, imgs, boxes, labels, mask)
    # the port's, from the same engine dir
    model = tt.build_train_model(TINY_CFG, jax_engine, "cpu")
    named = dict(model.named_parameters())
    opt = tt.make_yolo_optimizer(named, 1e-4, 1.0, 1, 2, 100)
    grads = {}      # the clipped gradients the SGD update reads
    opt.sgd.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.clone() for n, p in named.items()}))
    step = tt.make_yolo_train_step(model, opt, hw, 16)
    loss, _ = step(*(torch.from_numpy(a) for a in (imgs, boxes, labels,
                                                   mask)))
    assert abs(float(loss) - float(jl)) <= 1e-4 * abs(float(jl))
    clip = min(1.0, 10.0 / (float(optax.global_norm(jgrads)) + 1e-6))
    want_g = dict(_leaves(jgrads["params"]))
    want_p = dict(_leaves(jnew["params"]))
    got_p = dict(_leaves(module_tree(model)))
    for path, g in want_g.items():
        got = grads[".".join(path)]
        if path[-1] == "kernel":
            got = got.permute(2, 3, 1, 0)
        assert np.abs(got.numpy() - g * clip).max() <= \
            1e-3 * np.abs(g * clip).max(), path
        np.testing.assert_allclose(got_p[path], want_p[path], rtol=0,
                                   atol=1e-6, err_msg=str(path))


def _recording(module, record):
    make = module.make_yolo_train_step

    def wrapped(*args, **kw):
        step = make(*args, **kw)

        def run(*a):
            out = step(*a)
            loss = out[2] if len(out) == 4 else out[0]
            record.append(float(loss))
            return out
        return run
    return wrapped


def test_train_matches_jax(fold, jax_engine, monkeypatch):
    j_losses, t_losses = [], []
    monkeypatch.setattr(jt, "make_yolo_train_step", _recording(jt, j_losses))
    monkeypatch.setattr(tt, "make_yolo_train_step", _recording(tt, t_losses))
    kw = dict(weights=jax_engine, max_gt=8, log_fn=lambda *a: None)
    jparams, jmetrics = jt.train(1, 2, fold, J_TINY_CFG, **kw)
    params, metrics = tt.train(1, 2, fold, TINY_CFG, **kw, device="cpu")
    assert len(t_losses) == len(j_losses) >= 2
    assert abs(np.mean(t_losses) - np.mean(j_losses)) <= \
        1e-4 * abs(np.mean(j_losses))
    want = dict(_leaves(jparams["params"]))
    got = dict(_leaves(params["params"]))
    assert set(got) == set(want)
    for path, w in want.items():
        assert np.abs(got[path] - w).max() <= 1e-3 * np.abs(w).max(), path
    assert metrics == jmetrics


def test_yolo_retrain_engine_loads_in_jax(tmp_path):
    from test_yolo_train import _make_voc_dir as j_make_voc_dir
    j_make_voc_dir(str(tmp_path / "train/new"), 6)
    logs = []
    tt.yolo_retrain(str(tmp_path), TINY_CFG, epochs=1, batch=2,
                    log_fn=logs.append, device="cpu")
    assert "detect engine exported" in logs
    path = str(tmp_path / "weights/detect_engine")
    eng = JEngine(path)
    assert eng.kind == "detect"
    assert eng(np.zeros((1, 3, 64, 64), np.float32))[1].shape == (1, 16, 4)
    meta, tree = read_engine(path)
    assert JDetectConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in meta["detect_cfg"].items()}) \
        == J_TINY_CFG
    x = np.random.default_rng(0).random((2, 64, 64, 3), np.float32)
    jout = JYOLOv8(j_detect_spec(J_TINY_CFG), fused=True).apply(
        eng.params, jnp.asarray(x))
    from yolov8_vit_tpu_torch.models.yolov8 import YOLOv8, detect_spec
    model = load_tree(YOLOv8(detect_spec(TINY_CFG)), tree["params"])
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for (jb, jc), (b, c) in zip(jout, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=2e-3)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=2e-3)


def test_validate_matches_jax(fold, tmp_path):
    """validate on the val split, the same params in both packages: a head
    whose P3 boxes are 16 px squares about each anchor (so some match the
    gt at IoU .5 and above) and outscore the other levels, every one of
    them kept (the score floor lowered, 320 outputs an image).  The same
    mAP."""
    model = JYOLOv8(j_detect_spec(J_TINY_CFG), fused=True)
    params = jax.tree.map(np.array, model.init(jax.random.PRNGKey(1),
                                               jnp.zeros((1, 64, 64, 3))))
    box = params["params"]["detect"]["box0_2"]
    box["kernel"] = np.zeros_like(box["kernel"])
    box["bias"] = np.tile(np.eye(16, dtype=np.float32)[1] * 6.0, 4)
    cls = params["params"]["detect"]["cls0_2"]       # P3 scores near .5
    cls["bias"] = np.zeros_like(cls["bias"])
    path = j_save_engine(str(tmp_path / "engine"), "detect", params,
                         {"detect_cfg": dataclasses.asdict(J_TINY_CFG)})
    kw = dict(CFG_KW, nms_conf=1e-4, nms_topk=320)
    cfg, j_cfg = DetectConfig(**kw), JDetectConfig(**kw)
    got = tt.validate(tt.build_train_model(cfg, path, "cpu"),
                      tt.YoloDataset(fold, "val", 64, 8), cfg,
                      batch_size=2, conf=0.0)
    want = jt.validate(model, JEngine(path).params,
                       jt.YoloDataset(fold, "val", 64, 8), j_cfg,
                       batch_size=2, conf=0.0)
    assert got["map50"] > 0
    assert got == want
