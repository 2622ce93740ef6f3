"""PyTorch port, the float ViT serving path and the `Engine` entry point:
`make_runner` on float, bf16-stored, `w8` and `dynamic` engine dirs, and
`Engine` on detect / classify / two_stage dirs, each held against the JAX
package's `make_runner` / `Engine` on the same dirs; and the port's
`save_engine` writer read back by JAX.

Bars: integer outputs (num_dets, labels, final_valid, cls_labels) equal;
floats as tests/test_torch_engine.py holds them (boxes 1e-2, detection
scores 1e-5, class scores 1e-4); classify logits at f32 within atol 5e-5,
rtol 1e-4 (tests/test_fused_attention.py:43).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.serialization

from yolov8_vit_tpu.config import DetectConfig as JDetectConfig
from yolov8_vit_tpu.models.two_stage import TwoStagePipeline as JPipe
from yolov8_vit_tpu.models.vit import ViTSpec as JViTSpec
from yolov8_vit_tpu.ops.quant import MLP_SUFFIXES
from yolov8_vit_tpu.ops.quant import prequantize_tree as j_prequantize
from yolov8_vit_tpu.runtime.engine import Engine as JEngine
from yolov8_vit_tpu.runtime.engine import save_engine as j_save_engine
from yolov8_vit_tpu.serve.batch_runner import make_runner as j_make_runner
from yolov8_vit_tpu.utils.densify import densify_detect_head as j_densify

from yolov8_vit_tpu_torch.config import DetectConfig
from yolov8_vit_tpu_torch.models.vit import ViTSpec
from yolov8_vit_tpu_torch.runtime.engine import (DETECT_OUTPUTS,
                                                 TWO_STAGE_OUTPUTS, Engine)
from yolov8_vit_tpu_torch.serve.batch_runner import make_runner
from yolov8_vit_tpu_torch.utils.densify import densify_detect_head
from yolov8_vit_tpu_torch.weights import (init_tree, load_tree, read_engine,
                                          save_engine)

DENSE = JDetectConfig(input_size=(64, 64), variant="n", nms_topk=16,
                      nms_conf=1e-6, conf_second=1e-6, nms_iou=0.995,
                      custom_nms_iou=0.999)
VIT_KW = dict(img_size=32, patch=8, dim=64, depth=2, heads=4,
              backbone_classes=40)


@pytest.fixture(scope="module")
def params():
    """JAX init with a float ViT and a densified detect head."""
    pipe = JPipe(det_cfg=DENSE, vit_spec=JViTSpec(**VIT_KW, attn_impl="xla"),
                 stem_mode="flat")
    p = jax.tree.map(np.asarray,
                     jax.jit(pipe.init_params)(jax.random.PRNGKey(3)))
    return jax.tree.map(np.asarray, j_densify(p))


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).integers(0, 256, (4, 64, 64, 3),
                                             np.uint8)


def _vit_tree(params, quant):
    return (jax.tree.map(np.asarray, j_prequantize(params["vit"],
                                                   MLP_SUFFIXES))
            if quant == "w8" else params["vit"])


def _assert_runs_equal(port_runner, jax_runner, frames):
    got = port_runner._unpack(
        port_runner._fn(torch.from_numpy(frames)).numpy())
    ref = jax_runner._unpack(np.asarray(jax_runner._fn(
        jax_runner.params, jnp.asarray(frames))))
    assert sum(int(r["final_valid"].sum()) for r in ref) > 0
    for a, b in zip(got, ref):
        assert a["num_dets"] == b["num_dets"]
        for k in ("det_labels", "final_valid", "cls_labels"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-2)
        np.testing.assert_allclose(a["det_scores"], b["det_scores"],
                                   atol=1e-5)
        np.testing.assert_allclose(a["cls_scores"], b["cls_scores"],
                                   atol=1e-4)


@pytest.mark.parametrize("quant,param_dtype", [("none", None),
                                               ("none", "bfloat16"),
                                               ("w8", None),
                                               ("dynamic", None)])
def test_make_runner_float_engines_match_jax(params, frames, tmp_path, quant,
                                             param_dtype):
    """Detect + classify engine dirs of every float ViT mode: the runner
    forces attn_impl="fused" (kernel E's plain version here) as JAX's
    does, from the stored "xla" spec."""
    det, cls = str(tmp_path / "det"), str(tmp_path / "cls")
    j_save_engine(det, "detect", params["det"],
                  {"detect_cfg": dataclasses.asdict(DENSE)})
    spec = JViTSpec(**VIT_KW, quant=quant, attn_impl="xla")
    j_save_engine(cls, "classify", _vit_tree(params, quant),
                  {"vit_spec": dataclasses.asdict(spec), "num_classes": 5},
                  param_dtype=param_dtype)
    port = make_runner(det, cls, classify_budget=2, dtype=torch.float32,
                       device="cpu")
    vs = port.pipeline.vit_spec
    assert (vs.quant, vs.attn_impl) == (quant, "fused")
    if param_dtype:
        assert port.pipeline.vit.fc1.kernel.dtype == torch.bfloat16
    ref = j_make_runner(det, cls, classify_budget=2, dtype=jnp.float32)
    _assert_runs_equal(port, ref, frames)


def test_make_runner_default_serves_vit_b8_float(tmp_path):
    """No engine dirs: the default ViTSpec() (ViT-B/8, 785 tokens, float
    weights) with fused attention, on the card unless asked otherwise.  Its
    seed-0 tree, written out by the port's save_engine, serves the same
    outputs through JAX's make_runner (the head densified and the dense
    thresholds set, so detections reach the ViT)."""
    dense = dataclasses.asdict(DENSE)
    port = make_runner(det_cfg=DetectConfig(**dense), classify_budget=1,
                       dtype=torch.float32, device="cpu")
    spec = port.pipeline.vit_spec
    assert spec == dataclasses.replace(ViTSpec(), attn_impl="fused")
    assert (spec.patch, spec.quant, spec.tokens) == (8, "none", 785)
    tree = densify_detect_head(init_tree(port.pipeline, 0))
    load_tree(port.pipeline.det, tree["det"]["params"])
    det = save_engine(str(tmp_path / "det"), "detect", tree["det"],
                      {"detect_cfg": dense})
    cls = save_engine(str(tmp_path / "cls"), "classify", tree["vit"],
                      {"vit_spec": dataclasses.asdict(ViTSpec()),
                       "num_classes": 5})
    ref = j_make_runner(det, cls, classify_budget=1, dtype=jnp.float32)
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                               np.uint8)
    _assert_runs_equal(port, ref, frames)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_runner(det_cfg=DetectConfig(**dense))


def test_engine_detect_matches_jax(params, frames, tmp_path):
    path = str(tmp_path / "det")
    j_save_engine(path, "detect", params["det"],
                  {"detect_cfg": dataclasses.asdict(DENSE)})
    # the reference's blob(): NCHW float RGB in [0, 1] at the input size
    blob = (frames[:2].transpose(0, 3, 1, 2) / 255.0).astype(np.float32)
    port, ref = Engine(path, device="cpu"), JEngine(path)
    assert port.inp_info[0].shape == ref.inp_info[0].shape == (1, 3, 64, 64)
    got = [t.numpy() for t in port(torch.from_numpy(blob))]
    want = [np.asarray(a) for a in ref(jnp.asarray(blob))]
    assert len(got) == len(want) == len(DETECT_OUTPUTS)
    order = ["labels", "num_dets", "scores"]
    port.set_desired(order)
    ref.set_desired(order)
    got = [t.numpy() for t in port(blob)]
    want = [np.asarray(a) for a in ref(blob)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert int(got[1].sum()) > 0
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)


@pytest.mark.parametrize("attn_impl,quant", [("pallas", "none"),
                                             ("xla", "dynamic"),
                                             ("fused", "w8")])
def test_engine_classify_matches_jax(params, tmp_path, attn_impl, quant):
    """The classify kind runs the stored spec as it is (kernel F's plain
    version for "pallas"), on NCHW and NHWC images in [-1, 1]."""
    path = str(tmp_path / "cls")
    spec = JViTSpec(**VIT_KW, quant=quant, attn_impl=attn_impl)
    j_save_engine(path, "classify", _vit_tree(params, quant),
                  {"vit_spec": dataclasses.asdict(spec), "num_classes": 5})
    imgs = np.random.default_rng(2).uniform(-1, 1, (3, 3, 32, 32)) \
        .astype(np.float32)
    port, ref = Engine(path, device="cpu"), JEngine(path)
    assert port.vit_spec.attn_impl == attn_impl
    got = port(torch.from_numpy(imgs)).numpy()
    want = np.asarray(ref(jnp.asarray(imgs)))
    tol = (dict(atol=5e-5, rtol=1e-4) if quant == "none"
           else dict(atol=1e-4, rtol=1e-4))
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    nhwc = port(torch.from_numpy(imgs.transpose(0, 2, 3, 1))).numpy()
    np.testing.assert_array_equal(nhwc, got)


def test_engine_two_stage_from_port_writer_matches_jax(params, frames,
                                                       tmp_path):
    """A two_stage engine written by the port's save_engine: JAX's Engine
    loads it, and the port's Engine gives JAX's outputs on NCHW frames."""
    path = str(tmp_path / "two")
    spec = JViTSpec(**VIT_KW, attn_impl="fused")
    save_engine(path, "two_stage", params,
                {"detect_cfg": dataclasses.asdict(DENSE),
                 "vit_spec": dataclasses.asdict(spec), "num_classes": 5,
                 "classify_budget": 2})
    port, ref = Engine(path, device="cpu"), JEngine(path)
    assert port.meta == ref.meta
    nchw = frames.transpose(0, 3, 1, 2)
    got = dict(zip(TWO_STAGE_OUTPUTS,
                   (t.numpy() for t in port(torch.from_numpy(nchw)))))
    want = dict(zip(TWO_STAGE_OUTPUTS,
                    (np.asarray(a) for a in ref(jnp.asarray(nchw)))))
    assert int(want["final_valid"].sum()) > 0
    for k in ("num_dets", "det_labels", "final_valid", "cls_labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, tol in (("boxes", 1e-2), ("det_scores", 1e-5),
                   ("cls_scores", 1e-4)):
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)
    port.set_desired(["cls_labels"])
    np.testing.assert_array_equal(port(frames).numpy(), got["cls_labels"])


@pytest.mark.parametrize("param_dtype", [None, "bfloat16", "float16"])
def test_save_engine_bytes_match_flax(params, tmp_path, param_dtype):
    """The port's writer emits what flax.serialization.to_bytes emits for
    the same tree (int8 leaves kept, floats stored bf16 or f16 on
    request), and meta.json as JAX's save_engine writes it."""
    tree = {"vit": _vit_tree(params, "w8"), "n": np.arange(5, dtype=np.int32),
            "empty": {}}
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    meta = {"vit_spec": dataclasses.asdict(JViTSpec(**VIT_KW)),
            "num_classes": 5}
    save_engine(a, "classify", tree, meta, param_dtype=param_dtype)
    j_save_engine(b, "classify", tree, meta, param_dtype=param_dtype)
    for name in ("params.msgpack", "meta.json"):
        with open(f"{a}/{name}", "rb") as f, open(f"{b}/{name}", "rb") as g:
            assert f.read() == g.read(), name
    meta_r, back = read_engine(a)
    assert meta_r["kind"] == "classify"
    with open(f"{b}/params.msgpack", "rb") as f:
        ref = flax.serialization.msgpack_restore(f.read())
    k = ref["vit"]["params"]["fc1"]["kernel"]
    got = back["vit"]["params"]["fc1"]["kernel"]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(k, np.float32))
