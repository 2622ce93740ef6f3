"""PyTorch port, the whole slice: TwoStagePipeline and BatchRunner held
against the JAX package on the same parameters and frames.

The legs run with f32 activations at reduced dims (bench.py --smoke sizes)
with a densified detect head and the dense-scene thresholds of
tests/test_batch_runner.py, so stage-1 NMS fills its top-k, the area NMS
keeps most boxes and the classify budget overflows.  Integer outputs must
be equal; floats within the stated tolerances.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from yolov8_vit_tpu.config import DetectConfig as JDetectConfig
from yolov8_vit_tpu.models.two_stage import TwoStagePipeline as JPipe
from yolov8_vit_tpu.models.vit import ViTSpec as JViTSpec
from yolov8_vit_tpu.ops.quant import MLP_AND_ATTN_SUFFIXES
from yolov8_vit_tpu.ops.quant import prequantize_tree as j_prequantize
from yolov8_vit_tpu.serve.batch_runner import BatchRunner as JBatchRunner
from yolov8_vit_tpu.utils.densify import densify_detect_head as j_densify

from yolov8_vit_tpu_torch.config import DetectConfig
from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
from yolov8_vit_tpu_torch.models.vit import ViTSpec
from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner
from yolov8_vit_tpu_torch.utils.densify import densify_detect_head
from yolov8_vit_tpu_torch.weights import load_pipeline_tree

DENSE = dict(input_size=(64, 64), variant="n", nms_topk=16, nms_conf=1e-6,
             conf_second=1e-6, nms_iou=0.995, custom_nms_iou=0.999)
VIT_KW = dict(img_size=32, patch=8, dim=64, depth=2, heads=4,
              backbone_classes=40, quant="w8a", attn_impl="fused")
# float bars for the f32 legs: boxes are conv -> DFL outputs scaled by the
# stride (2e-3 head-map bar x stride), scores pass through a sigmoid
TOL = {"boxes": 1e-2, "det_scores": 1e-5, "cls_scores": 1e-4}


@pytest.fixture(scope="module")
def params():
    """JAX init with a float ViT, pre-quantized (w8a), densified head."""
    pipe = JPipe(det_cfg=JDetectConfig(**DENSE),
                 vit_spec=JViTSpec(**dict(VIT_KW, quant="none",
                                          attn_impl="xla")),
                 stem_mode="flat")
    p = jax.tree.map(np.asarray,
                     jax.jit(pipe.init_params)(jax.random.PRNGKey(0)))
    p["vit"] = j_prequantize(p["vit"], MLP_AND_ATTN_SUFFIXES)
    return jax.tree.map(np.asarray, j_densify(p))


def _jax_pipe(budget, **cfg):
    return JPipe(det_cfg=JDetectConfig(**dict(DENSE, **cfg)),
                 vit_spec=JViTSpec(**VIT_KW), classify_budget=budget,
                 stem_mode="flat")


def _port_pipe(params, budget, **cfg):
    pipe = TwoStagePipeline(det_cfg=DetectConfig(**dict(DENSE, **cfg)),
                            vit_spec=ViTSpec(**VIT_KW),
                            classify_budget=budget, device="cpu")
    return load_pipeline_tree(pipe, params)


def _assert_outputs_match(got: dict, ref: dict):
    for k, r in ref.items():
        g = np.asarray(got[k])
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if k in TOL:
            np.testing.assert_allclose(g, r, atol=TOL[k], rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)


@pytest.mark.parametrize("cfg", [{}, {"nms_conf": 0.25, "conf_second": 0.35,
                                      "nms_iou": 0.65,
                                      "custom_nms_iou": 0.45}],
                         ids=["dense", "default_thresholds"])
def test_pipeline_matches_jax_f32(params, cfg):
    frames = np.random.default_rng(0).integers(0, 256, (4, 96, 128, 3),
                                               np.uint8)
    ref = jax.jit(_jax_pipe(2, **cfg).__call__)(params, jnp.asarray(frames))
    got = _port_pipe(params, 2, **cfg)(torch.from_numpy(frames))
    assert set(got) == set(ref)
    _assert_outputs_match({k: v.numpy() for k, v in got.items()}, ref)
    if not cfg:
        assert int(np.asarray(ref["final_valid"]).sum()) > 8   # overflowed


def test_densify_matches_jax(params):
    """The port's densify_detect_head on the same undensified tree."""
    pipe = JPipe(det_cfg=JDetectConfig(**DENSE), stem_mode="flat")
    raw = jax.tree.map(np.asarray,
                       jax.jit(pipe.init_params)(jax.random.PRNGKey(0)))
    ref = j_densify({"det": raw["det"]})["det"]["params"]["detect"]
    got = densify_detect_head({"det": raw["det"]})["det"]["params"]["detect"]
    for i in range(3):
        for name in (f"box{i}_2", f"cls{i}_2"):
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(
                    np.asarray(got[name][leaf]), np.asarray(ref[name][leaf]))


def _write_frames(tmp_path, sizes, seed=0):
    from PIL import Image
    rng = np.random.default_rng(seed)
    paths = []
    for i, (h, w) in enumerate(sizes):
        p = str(tmp_path / f"img{i}_{h}x{w}.png")
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(p)
        paths.append(p)
    return paths


def _runner(params, budget, max_batch=4):
    return BatchRunner(_port_pipe(params, budget), max_batch=max_batch)


def _assert_recs_equal(a, b, cls_atol=1e-5):
    np.testing.assert_array_equal(a["final_valid"], b["final_valid"])
    v = a["final_valid"]
    assert (a["cls_labels"][v] >= 0).all()
    np.testing.assert_array_equal(a["cls_labels"][v], b["cls_labels"][v])
    np.testing.assert_allclose(a["cls_scores"][v], b["cls_scores"][v],
                               atol=cls_atol)
    np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-3)


def test_budget2_matches_budget8_and_jax(params, tmp_path):
    """Budget 2 overflows on the dense scene; with the ladder it must equal
    budget 8 (no overflow) and the JAX runner at budget 2."""
    paths = _write_frames(tmp_path, [(64, 64)] * 4)
    r2, r8 = _runner(params, 2), _runner(params, 8)
    prof = {}
    res2 = r2.run_paths(paths, profile=prof)
    res8 = r8.run_paths(paths)
    assert sum(int(r["final_valid"].sum()) for r in res2) > 2 * len(paths)
    assert prof["overflow_dets"] > 0 and prof["ladder_chunks"] > 0
    assert prof["overflow_ms"] > 0.0
    for a, b in zip(res2, res8):
        _assert_recs_equal(a, b)
    jr = JBatchRunner(_jax_pipe(2), params, max_batch=4)
    for a, b in zip(res2, jr.run_paths(paths)):
        _assert_recs_equal(a, b, cls_atol=TOL["cls_scores"])
        np.testing.assert_array_equal(a["det_labels"], b["det_labels"])
        assert a["num_dets"] == b["num_dets"]


def test_run_device_batches_matches_run_paths(params, tmp_path):
    """The bulk device path (async copies, depth-bounded queue, ladder
    window) equals the host path for the same pixels, budget 1."""
    paths = _write_frames(tmp_path, [(64, 64)] * 4, seed=1)
    runner = _runner(params, 1)
    res_host = runner.run_paths(paths)
    batch = torch.from_numpy(np.stack([runner._decode(p) for p in paths]))
    prof = {}
    res_dev = runner.run_device_batches([batch] * 6, profile=prof)
    assert len(res_dev) == 6
    assert prof["overflow_dets"] > 0 and prof["ladder_chunks"] > 0
    assert prof["overflow_ms"] > 0.0
    for recs in res_dev:
        for a, b in zip(res_host, recs):
            _assert_recs_equal(a, b)


@pytest.mark.parametrize("path", ["run_paths", "run_device_batches"])
def test_within_budget_dispatches_no_ladder(params, tmp_path, path):
    """Budget 8 holds every kept box of the dense scene: the ladder
    dispatches nothing and its profile keys stay zero."""
    paths = _write_frames(tmp_path, [(64, 64)] * 4)
    runner = _runner(params, 8)
    prof = {}
    if path == "run_paths":
        res = runner.run_paths(paths, profile=prof)
    else:
        batch = torch.from_numpy(np.stack([runner._decode(p)
                                           for p in paths]))
        res = runner.run_device_batches([batch] * 2, profile=prof)[0]
    assert sum(int(r["final_valid"].sum()) for r in res) > 2 * len(paths)
    assert prof["overflow_dets"] == 0 and prof["ladder_chunks"] == 0
    assert prof["overflow_ms"] == 0.0
    assert prof["wait_ms"] > 0.0 and prof["fetch_ms"] > 0.0


def test_run_paths_mixed_sizes_bad_file_stream_and_flatten(params, tmp_path):
    paths = _write_frames(tmp_path, [(48, 80), (64, 64), (48, 80), (64, 64),
                                     (64, 64)], seed=2)
    bad = str(tmp_path / "broken.jpg")
    with open(bad, "wb") as f:
        f.write(b"not an image")
    runner = _runner(params, 2)
    res = runner.run_paths(paths + [bad])
    assert res[-1] is None and all(r is not None for r in res[:-1])
    assert all(r["boxes"].shape == (16, 4) for r in res[:-1])
    streamed = list(runner.run_stream([paths[:2], paths[2:]]))
    for a, b in zip(streamed[0] + streamed[1], res):
        _assert_recs_equal(a, b)
    rows = runner.flatten(paths + [bad], res)
    assert len(rows) == sum(int(r["final_valid"].sum()) for r in res[:-1])
    names = [r[0] for r in rows]
    assert names == sorted(names)
    for name, cls_id, conf, x1, y1, x2, y2 in rows:
        assert 0 <= cls_id < 5 and 0.0 <= conf <= 1.0
        assert x2 >= x1 and y2 >= y1
    objs = runner.to_objects(res[0])
    assert len(objs) == int(res[0]["final_valid"].sum())
    assert all(set(o) == {"sort", "xmin", "ymin", "xmax", "ymax"}
               for o in objs)


def test_host_inflate_matches_device_arithmetic(params):
    """The ladder's host crop boxes equal the pipeline's device
    round -> inflate -> round on the same boxes."""
    from yolov8_vit_tpu_torch.ops import inflate_boxes
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 90, (64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 60, (64, 2))], -1) \
        .astype(np.float32)
    boxes[:8] = np.floor(boxes[:8]) + 0.5            # round-half-to-even
    w, h = 128, 96
    t = torch.from_numpy(boxes)
    dev = torch.round(inflate_boxes(
        torch.round(t).to(torch.int32).float(),
        torch.tensor([[w, h]], dtype=torch.float32))).to(torch.int32)
    np.testing.assert_array_equal(BatchRunner._host_inflate(boxes, w, h),
                                  dev.numpy())


def test_stable_compaction_ties(params):
    """Equal compaction priorities go lowest slot first (jax.lax.top_k's
    order): in a batch of identical frames every detection ties across
    frames, so earlier frames get at least as many classify slots."""
    frame = np.random.default_rng(5).integers(0, 256, (64, 64, 3), np.uint8)
    frames = np.stack([frame] * 4)
    got = _port_pipe(params, 1)(torch.from_numpy(frames))
    ref = jax.jit(_jax_pipe(1).__call__)(params, jnp.asarray(frames))
    _assert_outputs_match({k: v.numpy() for k, v in got.items()}, ref)
    per_frame = (got["cls_labels"].numpy() >= 0).sum(1)
    assert per_frame.sum() == 4 and (np.diff(per_frame) <= 0).all()


def test_make_runner_needs_w8a_and_defaults_to_cuda(params, tmp_path):
    """Formerly the refusal of every ViT but w8a: a float classify engine
    (quant "none", the default spec's mode) now serves through the fused
    float attention and equals the JAX runner on the same dirs; without
    device="cpu" the runner still asks for the card."""
    from yolov8_vit_tpu.models.vit import ViTClassifier as JViT
    from yolov8_vit_tpu.runtime.engine import save_engine
    from yolov8_vit_tpu.serve.batch_runner import make_runner as j_make
    from yolov8_vit_tpu_torch.serve.batch_runner import make_runner
    spec = JViTSpec(img_size=32, patch=8, dim=64, depth=1, heads=4,
                    backbone_classes=8)
    vit = jax.tree.map(np.asarray, jax.jit(JViT(spec, 5).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    det, eng = str(tmp_path / "det"), str(tmp_path / "cls")
    save_engine(det, "detect", params["det"], {"detect_cfg": DENSE})
    save_engine(eng, "classify", vit,
                {"vit_spec": dataclasses.asdict(spec), "num_classes": 5})
    port = make_runner(det, eng, classify_budget=2, dtype=torch.float32,
                       device="cpu")
    assert port.pipeline.vit_spec.quant == "none"
    ref = j_make(det, eng, classify_budget=2, dtype=jnp.float32)
    frames = np.random.default_rng(6).integers(0, 256, (4, 64, 64, 3),
                                               np.uint8)
    got = port._unpack(port._fn(torch.from_numpy(frames)).numpy())
    want = ref._unpack(np.asarray(ref._fn(ref.params, jnp.asarray(frames))))
    assert sum(int(r["final_valid"].sum()) for r in want) > 0
    for a, b in zip(got, want):
        for k in ("num_dets", "det_labels", "final_valid", "cls_labels"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k, tol in TOL.items():
            np.testing.assert_allclose(a[k], b[k], atol=tol, err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_runner()
    assert os.path.exists(os.path.join(eng, "meta.json"))


def test_fit_detect_head_matches_jax_and_tracks_content():
    """The port's ridge fit on the same frames and weights as JAX's
    fit_detect_head: the same fitted conv (to the float noise of the
    features), and detections only where covers are."""
    from yolov8_vit_tpu.utils.densify import fit_detect_head as j_fit
    from yolov8_vit_tpu_torch.utils.densify import (fit_detect_head,
                                                    make_cover_scenes)
    cfg = dict(input_size=(64, 64), variant="n", nms_topk=16)
    jpipe = JPipe(det_cfg=JDetectConfig(**cfg),
                  vit_spec=JViTSpec(**dict(VIT_KW, quant="none",
                                           attn_impl="xla")),
                  stem_mode="flat")
    raw = jax.tree.map(np.asarray,
                       jax.jit(jpipe.init_params)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    imgs, covers = make_cover_scenes(rng, 8, (64, 64), lam=1.5)
    ref = j_fit({"det": raw["det"]}, jpipe, imgs, covers)["det"]
    pipe = TwoStagePipeline(det_cfg=DetectConfig(**cfg),
                            vit_spec=ViTSpec(**VIT_KW), device="cpu")
    tree = {"det": raw["det"], "vit": {"params": {}}}
    from yolov8_vit_tpu_torch.weights import load_tree
    load_tree(pipe.det, tree["det"]["params"])
    got = fit_detect_head(tree, pipe, imgs, covers)["det"]
    head_g, head_r = got["params"]["detect"], ref["params"]["detect"]
    for name in ("cls0_2", "cls1_2", "cls2_2", "box0_2"):
        for leaf in ("kernel", "bias"):
            r = np.asarray(head_r[name][leaf])
            np.testing.assert_allclose(np.asarray(head_g[name][leaf]), r,
                                       rtol=0, atol=1e-3 * np.abs(r).max())
    load_tree(pipe.det, got["params"])
    ev, ev_covers = make_cover_scenes(rng, 8, (64, 64), lam=1.5)
    empty, _ = make_cover_scenes(rng, 4, (64, 64), lam=0.0)
    det = pipe(torch.from_numpy(ev))["final_valid"].sum(1).numpy()
    det0 = pipe(torch.from_numpy(empty))["final_valid"].sum(1).numpy()
    true = np.array([len(c) for c in ev_covers])
    assert det0.sum() == 0 and det.sum() >= 3
    assert np.all(true[det > 0] > 0)
