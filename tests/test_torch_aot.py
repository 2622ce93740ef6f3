"""PyTorch port, serialized engine artifacts (runtime/engine.py
`attach_aot`, `attach_compiled` and `Engine`'s blob registry), held
against the JAX package's `Engine` and `attach_aot` on the same engine
dirs.

- `attach_aot` on tiny detect, classify (w8a) and two_stage engines: the
  Engine runs the .pt2 program with the model's Python forward replaced by
  one that raises (tests/test_engine.py's check), and its outputs equal
  the port's eager Engine and match JAX's Engine (jit path) on the same
  numpy inputs: integer outputs equal, boxes within 1e-4, logits within
  1e-5 (scores of the softmax within 1e-5 too).
- NCHW input runs the NHWC blob; an unlisted shape runs eagerly; blobs are
  keyed by input AND activation dtype (test_engine.py's
  test_aot_dtype_keying).
- A compiled blob whose fingerprint names another host is refused at
  scan time with JAX's warning, as is one without a fingerprint
  (test_engine.py's foreign-host test, with a written blob and a
  fabricated sidecar, no compile); a compiled blob that fails to run is
  demoted on the second failure (JAX's rule).
- One engine dir holding both packages' blobs loads in both Engines with
  no warning, each registering only its own.
- One `attach_compiled` leg on the CPU (AOTInductor's C++ code generation
  with g++) on the smallest engine: `last_path == "compiled"`, preferred
  over a .pt2 of the same key.
- The export CLI's classify and two-stage subcommands with --aot (the
  detect one's flags: tests/test_torch_export.py); blobs for "cuda"
  without a card raise (no cross-export).
"""
import dataclasses
import json
import os
import shutil
import warnings

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
from yolov8_vit_tpu.runtime.engine import Engine as JEngine
from yolov8_vit_tpu.runtime.engine import attach_aot as j_attach_aot
from yolov8_vit_tpu.runtime.engine import save_engine
from yolov8_vit_tpu.utils.densify import densify_detect_head as j_densify

from yolov8_vit_tpu_torch.runtime import engine as rt
from yolov8_vit_tpu_torch.runtime.engine import (Engine, _aot_name,
                                                 _parse_aot_name, attach_aot,
                                                 attach_compiled)
from yolov8_vit_tpu_torch.utils.hostinfo import compatible, host_fingerprint

DENSE = JDetectConfig(input_size=(64, 64), variant="n", nms_topk=16,
                      nms_conf=1e-6, conf_second=1e-6, nms_iou=0.995,
                      custom_nms_iou=0.999)
SPEC = JViTSpec(img_size=32, patch=8, dim=64, depth=2, heads=4,
                backbone_classes=40, quant="w8a", attn_impl="fused")
# bars: integers equal, boxes 1e-4 (tests/test_engine.py), logits and
# scores 1e-5
BOX_TOL, LOGIT_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """detect, classify (w8a) and two_stage (budget 2) engine dirs of one
    seeded tree, written by the JAX package's save_engine."""
    root = tmp_path_factory.mktemp("engines")
    pipe = JPipe(det_cfg=DENSE, vit_spec=dataclasses.replace(
        SPEC, quant="none", attn_impl="xla"), stem_mode="flat")
    p = jax.tree.map(np.asarray,
                     jax.jit(pipe.init_params)(jax.random.PRNGKey(1)))
    p["vit"] = j_prequantize(p["vit"], MLP_AND_ATTN_SUFFIXES)
    p = jax.tree.map(np.asarray, j_densify(p))
    det_meta = {"detect_cfg": dataclasses.asdict(DENSE)}
    vit_meta = {"vit_spec": dataclasses.asdict(SPEC), "num_classes": 5}
    return {
        "detect": save_engine(str(root / "detect"), "detect", p["det"],
                              det_meta),
        "classify": save_engine(str(root / "classify"), "classify",
                                p["vit"], vit_meta),
        "two_stage": save_engine(str(root / "two_stage"), "two_stage", p,
                                 {**det_meta, **vit_meta,
                                  "classify_budget": 2})}


def _input(kind, batch=2, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "two_stage":
        return rng.integers(0, 256, (batch, 64, 64, 3), np.uint8)
    s = 64 if kind == "detect" else 32
    x = rng.random((batch, s, s, 3)).astype(np.float32)
    return x if kind == "detect" else 2 * x - 1


def _copy(dirs, kind, tmp_path):
    dst = str(tmp_path / kind)
    shutil.copytree(dirs[kind], dst)
    return dst


def _no_forward(eng):
    """Make every Python forward of the engine's model raise."""
    def boom(*_a, **_k):
        raise AssertionError("the model's Python forward ran")
    for m in eng.model.modules():
        m.forward = boom
    eng.graph.forward = boom


def _outputs(out):
    return [np.asarray(o.float() if o.dtype == torch.bfloat16 else o)
            for o in (out if isinstance(out, tuple) else (out,))]


def _hold(kind, got, want, exact=False):
    """got / want: lists of numpy outputs in the engine's output order."""
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if not np.issubdtype(w.dtype, np.floating) or exact:
            np.testing.assert_array_equal(g, w)
        else:
            tol = LOGIT_TOL if kind == "classify" else BOX_TOL
            np.testing.assert_allclose(g, w, atol=tol, rtol=0)


def _jax_ref(path, x):
    ref = JEngine(path)
    ref._aot = {}
    out = ref(x)
    assert ref.last_path == "jit"
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


@pytest.mark.parametrize("kind", ["detect", "classify", "two_stage"])
def test_aot_program_runs_without_forward(dirs, kind, tmp_path):
    path = _copy(dirs, kind, tmp_path)
    x = _input(kind)
    written = attach_aot(path, [x.shape], platform="cpu")
    assert [os.path.basename(w) for w in written] == [_aot_name(
        x.shape, torch.uint8 if kind == "two_stage" else torch.float32,
        torch.float32, "cpu")]
    ref = Engine(path, device="cpu")
    ref._aot = {}
    want = _outputs(ref(x))
    assert ref.last_path == "eager"
    eng = Engine(path, device="cpu")
    assert tuple(x.shape) in eng._aot
    _no_forward(eng)
    got = _outputs(eng(x))
    assert eng.last_path == "aot"
    _hold(kind, got, want, exact=True)
    jref = _jax_ref(path, x)
    if kind == "two_stage":      # num_dets, boxes, det_scores, ...
        assert int(jref[4].sum()) > 0
    _hold(kind, got, jref)


def test_aot_nchw_and_unlisted_shape(dirs, tmp_path):
    path = _copy(dirs, "classify", tmp_path)
    x = _input("classify")
    attach_aot(path, [x.shape], platform="cpu")
    eng = Engine(path, device="cpu")
    _no_forward(eng)
    want = _outputs(eng(x))
    got = _outputs(eng(x.transpose(0, 3, 1, 2)))
    assert eng.last_path == "aot"
    _hold("classify", got, want, exact=True)
    eng2 = Engine(path, device="cpu")
    out = eng2(_input("classify", batch=3))
    assert eng2.last_path == "eager" and tuple(out.shape) == (3, 5)


def test_aot_dtype_keying(dirs, tmp_path):
    """A blob matches only the activation dtype it was traced at: a bf16
    two_stage Engine (uint8 input, as the f32 one's) must not run an
    f32-traced blob, and an Engine finding only mismatched blobs warns."""
    path = _copy(dirs, "two_stage", tmp_path)
    shape = (1, 64, 64, 3)
    written = attach_aot(path, [shape], dtype=torch.float32, platform="cpu")
    assert "uint8-float32" in written[0]
    assert shape in Engine(path, device="cpu", dtype=torch.float32)._aot
    with pytest.warns(UserWarning, match="none match dtype bfloat16"):
        eng = Engine(path, device="cpu", dtype=torch.bfloat16)
    assert eng._aot == {}
    attach_aot(path, [shape], dtype=torch.bfloat16, platform="cpu")
    for dt, tag in ((torch.float32, "uint8-float32"),
                    (torch.bfloat16, "uint8-bfloat16")):
        assert tag in Engine(path, device="cpu", dtype=dt)._aot[shape]
    bf = Engine(path, device="cpu", dtype=torch.bfloat16)
    frames = _input("two_stage", batch=1)
    ref = Engine(path, device="cpu", dtype=torch.bfloat16)
    ref._aot = {}
    _hold("two_stage", _outputs(bf(frames)), _outputs(ref(frames)),
          exact=True)
    assert bf.last_path == "aot"


def test_aot_names_parse_as_jax_names():
    """The port's names carry JAX's fields; each package ignores the
    other's blobs."""
    from yolov8_vit_tpu.runtime.engine import _parse_aot_name as j_parse
    name = _aot_name((8, 640, 640, 3), torch.uint8, torch.bfloat16, "cuda")
    assert name == "8x640x640x3_uint8-bfloat16_cuda.pt2"
    assert _parse_aot_name(name) == ((8, 640, 640, 3), "uint8", "bfloat16",
                                     "cuda")
    comp = _aot_name((1, 64, 64, 3), torch.float32, torch.float32, "cpu",
                     rt.COMPILED_EXT)
    assert _parse_aot_name(comp) is None
    assert _parse_aot_name(comp, rt.COMPILED_EXT)[3] == "cpu"
    assert j_parse(name) is None and j_parse(comp, ".jaxcomp") is None
    assert _parse_aot_name("8x640x640x3_uint8-bfloat16_tpu.jaxexp") is None
    assert _parse_aot_name("8x640x640x3_uint8-bfloat16_tpu.jaxcomp",
                           rt.COMPILED_EXT) is None


def _fake_compiled(path, shape, fingerprint):
    """A compiled blob's file (not a package) with `fingerprint` as its
    sidecar, or no sidecar where it is None."""
    adir = os.path.join(path, "aot")
    os.makedirs(adir, exist_ok=True)
    blob = os.path.join(adir, _aot_name(shape, torch.float32, torch.float32,
                                        "cpu", rt.COMPILED_EXT))
    with open(blob, "wb") as f:
        f.write(b"not a package")
    if fingerprint is not None:
        with open(blob + ".host.json", "w") as f:
            json.dump(fingerprint, f)
    return blob


def test_compiled_blob_foreign_host_refused(dirs, tmp_path):
    shape = (2, 32, 32, 3)
    here = host_fingerprint("cpu")
    assert compatible(here, here)
    foreign = dict(here, cpu_flags=sorted(here["cpu_flags"]
                                          + ["sigill_maker_v9000"]))
    assert not compatible(foreign, here)
    assert not compatible(dict(here, torch="0.0"), here)
    for fp in (foreign, None):
        path = _copy(dirs, "classify", tmp_path / str(fp is None))
        _fake_compiled(path, shape, fp)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            eng = Engine(path, device="cpu")
        assert shape not in eng._compiled
        assert any("SIGILL" in str(w.message) for w in rec)
        out = eng(_input("classify"))
        assert eng.last_path == "eager" and tuple(out.shape) == (2, 5)


def test_compiled_blob_that_fails_is_demoted(dirs, tmp_path):
    """A blob this host accepts but cannot run: the first failure warns and
    runs the portable path; the second in a row drops the key."""
    shape = (2, 32, 32, 3)
    path = _copy(dirs, "classify", tmp_path)
    _fake_compiled(path, shape, host_fingerprint("cpu"))
    eng = Engine(path, device="cpu")
    assert shape in eng._compiled
    x = _input("classify")
    with pytest.warns(UserWarning, match="failed once"):
        first = _outputs(eng(x))
    assert eng.last_path == "eager" and shape in eng._compiled
    with pytest.warns(UserWarning, match="rejected by this platform"):
        second = _outputs(eng(x))
    assert eng.last_path == "eager" and shape not in eng._compiled
    _hold("classify", second, first, exact=True)


def test_both_packages_blobs_in_one_dir(dirs, tmp_path):
    path = _copy(dirs, "classify", tmp_path)
    x = _input("classify")
    j_written = j_attach_aot(path, [x.shape])
    p_written = attach_aot(path, [x.shape], platform="cpu")
    assert len(os.listdir(os.path.join(path, "aot"))) == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jeng = JEngine(path)
        peng = Engine(path, device="cpu")
    assert list(jeng._aot.values()) == j_written
    assert list(peng._aot.values()) == p_written
    got = _outputs(peng(x))
    want = [np.asarray(jeng(x))]
    assert peng.last_path == "aot" and jeng.last_path == "aot"
    _hold("classify", got, want)


def test_attach_compiled_cpu(dirs, tmp_path):
    """AOTInductor on the CPU (C++ code generation): the package runs with
    no Python forward, preferred over the .pt2 of the same key, its
    outputs within the bars of the eager Engine's."""
    path = _copy(dirs, "classify", tmp_path)
    x = _input("classify")
    attach_aot(path, [x.shape], platform="cpu")
    written = attach_compiled(path, [x.shape])
    assert [os.path.basename(w) for w in written] == [
        "2x32x32x3_float32-float32_cpu.aoti.pt2"]
    with open(written[0] + ".host.json") as f:
        assert compatible(json.load(f), host_fingerprint("cpu"))
    ref = Engine(path, device="cpu")
    ref._aot, ref._compiled = {}, {}
    want = _outputs(ref(x))
    eng = Engine(path, device="cpu")
    assert tuple(x.shape) in eng._compiled and tuple(x.shape) in eng._aot
    _no_forward(eng)
    got = _outputs(eng(x))
    assert eng.last_path == "compiled"
    _hold("classify", got, want)
    np.testing.assert_array_equal(_outputs(eng(x))[0], got[0])
    assert eng.last_path == "compiled"


@pytest.mark.parametrize("sub", ["classify", "two-stage"])
def test_export_cli_attaches_aot(dirs, tmp_path, sub, monkeypatch):
    """The classify and two-stage subcommands' --aot (JAX export.py:
    307-324 for two-stage): programs at the engine's input size, run by
    the written dir's Engine without its Python forward."""
    from yolov8_vit_tpu_torch.runtime import export
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / sub)
    if sub == "classify":
        argv = ["classify", "--model", "vit_tiny_patch8_32", "--quant",
                "w8a"]
        name, x = "1x32x32x3_float32-float32_cpu.pt2", _input("classify", 1)
    else:
        argv = ["two-stage", "--detect-engine", dirs["detect"],
                "--classify-engine", dirs["classify"], "--budget", "2"]
        name, x = "1x64x64x3_uint8-float32_cpu.pt2", _input("two_stage", 1)
    export.main(argv + ["--out", out, "--aot", "1", "--aot-dtype",
                        "float32"])
    assert os.listdir(os.path.join(out, "aot")) == [name]
    ref = Engine(out, device="cpu")
    ref._aot = {}
    want = _outputs(ref(x))
    eng = Engine(out, device="cpu")
    _no_forward(eng)
    got = _outputs(eng(x))
    assert eng.last_path == "aot"
    _hold(sub, got, want, exact=True)


def test_cuda_platform_without_a_card_raises(dirs, tmp_path, monkeypatch):
    """--aot-platform cuda names the device the blobs are exported on; the
    port does not cross-export, so without a card it raises as
    `_build.resolve_device` does, and writes nothing."""
    from yolov8_vit_tpu_torch.runtime import export
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _copy(dirs, "classify", tmp_path)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        attach_aot(path, [(1, 32, 32, 3)], platform="cuda")
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        export.main(["detect", "--out", str(tmp_path / "d"), "--variant",
                     "n", "--imgsz", "64", "--aot", "1", "--aot-platform",
                     "cuda"])
    assert not os.path.exists(os.path.join(path, "aot"))
    assert not os.path.exists(str(tmp_path / "d" / "aot"))
