"""PyTorch port, engine directories: the port's pure-Python msgpack reader
and `make_runner` on engine dirs written by the JAX package's
`save_engine` (f32 and param_dtype="bfloat16"), held against the JAX
runner built from the same dirs."""
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
from yolov8_vit_tpu.ops.quant import MLP_AND_ATTN_SUFFIXES
from yolov8_vit_tpu.ops.quant import prequantize_tree as j_prequantize
from yolov8_vit_tpu.runtime.engine import save_engine
from yolov8_vit_tpu.serve.batch_runner import make_runner as j_make_runner
from yolov8_vit_tpu.utils.densify import densify_detect_head as j_densify

from yolov8_vit_tpu_torch.serve.batch_runner import make_runner
from yolov8_vit_tpu_torch.weights import read_engine, read_msgpack

DENSE = JDetectConfig(input_size=(64, 64), variant="n", nms_topk=16,
                      nms_conf=1e-6, conf_second=1e-6, nms_iou=0.995,
                      custom_nms_iou=0.999)
SPEC = JViTSpec(img_size=32, patch=8, dim=64, depth=2, heads=4,
                backbone_classes=40, quant="w8a", attn_impl="fused")


def test_msgpack_reader_matches_flax():
    """Every leaf kind flax writes: f32/f64/int/bf16 arrays, a 0-d array,
    numpy scalars, nested dicts, an empty dict."""
    rng = np.random.default_rng(0)
    tree = {"a": {"k": rng.normal(size=(3, 4)).astype(np.float32),
                  "i8": rng.integers(-127, 128, (5, 6)).astype(np.int8),
                  "big": rng.normal(size=(70000,)).astype(np.float32)},
            "bf": jnp.asarray(rng.normal(size=(2, 3)), jnp.bfloat16),
            "d": np.arange(4, dtype=np.float64), "i32": np.int32(-7),
            "z": np.zeros((), np.float32), "s": np.float32(2.5),
            "empty": {}, "neg": np.arange(-40, 40, dtype=np.int64)}
    data = flax.serialization.to_bytes(tree)
    got = read_msgpack(data)
    ref = flax.serialization.msgpack_restore(data)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (_, g), (_, r) in zip(flat_got, flat_ref):
        r = np.asarray(r)
        if r.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(),
                                          r.astype(np.float32))
        else:
            assert tuple(g.shape) == r.shape
            np.testing.assert_array_equal(g.numpy(), r)
    assert got["empty"] == {}


@pytest.fixture(scope="module")
def params():
    pipe = JPipe(det_cfg=DENSE, vit_spec=dataclasses.replace(
        SPEC, quant="none", attn_impl="xla"), stem_mode="flat")
    p = jax.tree.map(np.asarray,
                     jax.jit(pipe.init_params)(jax.random.PRNGKey(1)))
    p["vit"] = j_prequantize(p["vit"], MLP_AND_ATTN_SUFFIXES)
    return jax.tree.map(np.asarray, j_densify(p))


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(2).integers(0, 256, (4, 64, 64, 3),
                                             np.uint8)


def _compare(port_runner, jax_runner, frames,
             fields=("det_labels", "final_valid", "cls_labels")):
    got = port_runner._unpack(
        port_runner._fn(torch.from_numpy(frames)).numpy())
    ref = jax_runner._unpack(np.asarray(jax_runner._fn(jax_runner.params,
                                                       jnp.asarray(frames))))
    assert sum(int(r["final_valid"].sum()) for r in ref) > 0
    for a, b in zip(got, ref):
        assert a["num_dets"] == b["num_dets"]
        for k in fields:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=1e-2)
        np.testing.assert_allclose(a["det_scores"], b["det_scores"],
                                   atol=1e-5)
        if "cls_labels" in fields:
            np.testing.assert_allclose(a["cls_scores"], b["cls_scores"],
                                       atol=1e-4)


@pytest.mark.parametrize("param_dtype", [None, "bfloat16"])
def test_two_stage_engine(params, frames, tmp_path, param_dtype):
    """A merged two_stage engine: baked config, budget and both trees,
    held against the JAX engine on the same dir as stored.  With bf16
    storage both keep the bf16 leaves; the int8 patch-embed fold sums the
    bf16 kernel in f32 and rounds once to bf16, as XLA reduces it
    (models/vit.py:330)."""
    path = str(tmp_path / "two_stage")
    save_engine(path, "two_stage", params,
                {"detect_cfg": dataclasses.asdict(DENSE),
                 "vit_spec": dataclasses.asdict(SPEC), "num_classes": 5,
                 "classify_budget": 2}, param_dtype=param_dtype)
    meta, tree = read_engine(path)
    assert meta["kind"] == "two_stage"
    port = make_runner(path, dtype=torch.float32, device="cpu")
    assert port.pipeline.classify_budget == 2
    ref = j_make_runner(path, dtype=jnp.float32)
    if param_dtype is not None:
        assert tree["vit"]["params"]["fc1"]["kernel"].dtype == torch.bfloat16
        assert tree["vit"]["params"]["model"]["block0"]["mlp_fc1"][
            "kernel_i8"].dtype == torch.int8
        assert port.pipeline.vit.fc1.kernel.dtype == torch.bfloat16
    _compare(port, ref, frames)


def test_detect_and_classify_engine_pair(params, frames, tmp_path):
    det = str(tmp_path / "det")
    cls = str(tmp_path / "cls")
    save_engine(det, "detect", params["det"],
                {"detect_cfg": dataclasses.asdict(DENSE)})
    save_engine(cls, "classify", params["vit"],
                {"vit_spec": dataclasses.asdict(SPEC), "num_classes": 5})
    port = make_runner(det, cls, classify_budget=2, dtype=torch.float32,
                       device="cpu")
    assert port.pipeline.det_cfg.nms_iou == DENSE.nms_iou
    ref = j_make_runner(det, cls, classify_budget=2, dtype=jnp.float32)
    _compare(port, ref, frames)
