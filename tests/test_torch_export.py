"""PyTorch port, the engine build CLI (`runtime/export.py`) and
`merge_two_stage_engine`, held against the JAX package's export CLI
(`yolov8_vit_tpu.runtime.export.main`, in-process) on the same tiny
checkpoints.

- detect, classify (float, w8, w8a), both --param-dtype values and
  two-stage: meta.json and params.msgpack byte for byte equal to JAX's.
- Each port-written engine loads in JAX's Engine and in the port's, with
  equal outputs at tests/test_torch_runtime.py's bars: integer outputs
  equal, detection scores 1e-5, boxes 1e-2, class scores 1e-4; classify
  logits atol 5e-5, rtol 1e-4 for float weights.  The int8 engines are
  12 blocks deep (the CLI's smallest ViT, ViT-Ti), and there an
  activation code at a .5 rounding boundary goes to its other neighbour
  where the two packages' f32 LayerNorm and GEMM sums differ in the last
  bit: the logits of one package move as much when its input moves by
  one ulp (INT8_ULP_FACTOR below).  Held: argmax equal, and the
  difference within INT8_ULP_FACTOR times the port engine's own change
  under a one-ulp move of its input, measured in the test.
- Random-init engines (no --weights): the same meta, keys, shapes and
  dtypes (the values differ: JAX draws from PRNGKey(0), the port from a
  torch.Generator).
- The bad merge is refused as JAX refuses it.
- The JAX CLI's artifact flags (--stablehlo, --aot, --compiled,
  --aot-platform, --aot-dtype) each write their files on the CPU, named as
  the port's `_parse_aot_name` reads them (tests/test_torch_aot.py holds
  what the files run).
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yolov8_vit_tpu.models.yolov8 import YOLOV8_VARIANTS as J_VARIANTS
from yolov8_vit_tpu.runtime import export as jexport
from yolov8_vit_tpu.runtime.engine import Engine as JEngine

from yolov8_vit_tpu_torch.runtime import export
from yolov8_vit_tpu_torch.runtime.engine import (TWO_STAGE_OUTPUTS, Engine,
                                                 merge_two_stage_engine)
from yolov8_vit_tpu_torch.weights import read_engine

from torch_refs import NetworkWrapper, TimmViT, UYOLOv8

# a tiny timm id: ViT-Ti (dim 192, depth 12, 3 heads) at 32 px, patch 8
VIT_MODEL = "vit_tiny_patch8_32"
# detect flags: YOLOv8-n at 64 px, thresholds low enough that a random
# detector keeps boxes
DET_ARGS = ["--variant", "n", "--imgsz", "64", "--conf-thres", "1e-6",
            "--iou-thres", "0.995", "--topk", "16"]
# two evaluations of an int8 ViT whose inputs differ by rounding noise
# differ by about its response to a one-ulp input move, which the test
# measures on its own inputs; a fault in the int8 path (a wrong scale, a
# transposed kernel) moves logits by the quantization error or more, and
# flips an argmax
INT8_ULP_FACTOR = 4.0


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    torch.manual_seed(0)
    det = UYOLOv8(dataclasses.replace(J_VARIANTS["n"], num_classes=5)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + 1.5 * torch.rand(n, generator=g))
    vit = NetworkWrapper(TimmViT(img_size=32, patch=8, dim=192, depth=12,
                                 heads=3, num_classes=1000), 5)
    pt, pth = str(root / "best.pt"), str(root / "best.pth")
    torch.save(det.state_dict(), pt)
    torch.save(vit.state_dict(), pth)
    return pt, pth


def _both(tmp_path, argv_tail, name):
    """Run the port's CLI and JAX's on the same arguments; the two
    output dirs."""
    a, b = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
    assert export.main(argv_tail(a)) == a
    assert jexport.main(argv_tail(b)) == b
    return a, b


def _same_files(a, b):
    for name in ("meta.json", "params.msgpack"):
        with open(f"{a}/{name}", "rb") as f, open(f"{b}/{name}", "rb") as g:
            assert f.read() == g.read(), name


def _check_detect(path):
    blob = np.random.default_rng(2).uniform(0, 1, (2, 3, 64, 64)) \
        .astype(np.float32)
    port, ref = Engine(path, device="cpu"), JEngine(path)
    got = [t.float().numpy() for t in port(torch.from_numpy(blob))]
    want = [np.asarray(a, np.float32) for a in ref(jnp.asarray(blob))]
    np.testing.assert_array_equal(got[0], want[0])          # num_dets
    assert int(got[0].sum()) > 0
    np.testing.assert_allclose(got[1], want[1], atol=1e-2)  # bboxes
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)  # scores
    np.testing.assert_array_equal(got[3], want[3])          # labels


def _check_classify(path, quant):
    imgs = np.random.default_rng(3).uniform(-1, 1, (3, 3, 32, 32)) \
        .astype(np.float32)
    port, ref = Engine(path, device="cpu"), JEngine(path)
    got = port(torch.from_numpy(imgs)).float().numpy()
    want = np.asarray(ref(jnp.asarray(imgs)), np.float32)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if quant is None:
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
        return
    moved = port(torch.from_numpy(
        np.nextafter(imgs, np.float32(2)))).float().numpy()
    bar = INT8_ULP_FACTOR * float(np.abs(moved - got).max())
    assert float(np.abs(got - want).max()) <= bar


DETECT_CASES = {"f32": [], "bf16": ["--param-dtype", "bfloat16"],
                "f16": ["--param-dtype", "float16"]}


@pytest.mark.parametrize("case", list(DETECT_CASES))
def test_detect_matches_jax(ckpts, tmp_path, case):
    a, b = _both(tmp_path, lambda out: ["detect", "--weights", ckpts[0],
                                        "--out", out] + DET_ARGS
                 + DETECT_CASES[case], case)
    _same_files(a, b)
    _check_detect(a)


CLASSIFY_CASES = {"float": ([], None), "w8": (["--quant"], "w8"),
                  "w8a": (["--quant", "w8a"], "w8a"),
                  "f16": (["--param-dtype", "float16"], None)}


@pytest.mark.parametrize("case", list(CLASSIFY_CASES))
def test_classify_matches_jax(ckpts, tmp_path, case):
    flags, quant = CLASSIFY_CASES[case]
    a, b = _both(tmp_path, lambda out: ["classify", "--weights", ckpts[1],
                                        "--out", out, "--model", VIT_MODEL]
                 + flags, case)
    _same_files(a, b)
    meta, _ = read_engine(a)
    assert meta["vit_spec"]["quant"] == (quant or "none")
    assert meta["vit_spec"]["attn_impl"] == ("fused" if quant == "w8a"
                                             else "xla")
    _check_classify(a, quant)


@pytest.mark.parametrize("quant,param_dtype", [(None, None),
                                               ("w8a", "bfloat16")])
def test_two_stage_matches_jax(ckpts, tmp_path, quant, param_dtype):
    """Each CLI merges its own detect and classify engines (equal, by the
    tests above); the merged dirs are equal and serve equally: every
    output at the bars above with the float ViT; with the w8a ViT the
    detections and class labels, and the class scores of the kept boxes
    (`_check_two_stage_scores`)."""
    dirs = {}
    for side, main in (("port", export.main), ("jax", jexport.main)):
        det, cls, two = (str(tmp_path / f"{side}_{n}")
                         for n in ("det", "cls", "two"))
        main(["detect", "--weights", ckpts[0], "--out", det] + DET_ARGS)
        main(["classify", "--weights", ckpts[1], "--out", cls, "--model",
              VIT_MODEL] + (["--quant", quant] if quant else []))
        argv = ["two-stage", "--detect-engine", det, "--classify-engine",
                cls, "--out", two, "--budget", "2"]
        main(argv + (["--param-dtype", param_dtype] if param_dtype else []))
        dirs[side] = two
    _same_files(dirs["port"], dirs["jax"])
    meta, _ = read_engine(dirs["port"])
    assert meta["classify_budget"] == 2 and meta["kind"] == "two_stage"
    frames = np.random.default_rng(4).integers(0, 256, (3, 64, 64, 3),
                                               np.uint8)
    port, ref = Engine(dirs["port"], device="cpu"), JEngine(dirs["port"])
    got = dict(zip(TWO_STAGE_OUTPUTS,
                   (t.float().numpy() for t in port(torch.from_numpy(frames)))))
    want = dict(zip(TWO_STAGE_OUTPUTS, (np.asarray(a, np.float32)
                                        for a in ref(jnp.asarray(frames)))))
    assert int(want["final_valid"].sum()) > 0
    for k in ("num_dets", "det_labels", "final_valid", "cls_labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    bars = (("boxes", 1e-2), ("det_scores", 1e-5)) + \
        ((("cls_scores", 1e-4),) if quant is None else ())
    for k, tol in bars:
        np.testing.assert_allclose(got[k], want[k], atol=tol, err_msg=k)
    if quant is not None:
        _check_two_stage_scores(port, ref, frames, got)


def _check_two_stage_scores(port, ref, frames, got):
    """The w8a engine's class scores of the kept boxes, held as
    `_check_classify` holds w8a logits: within INT8_ULP_FACTOR times the
    port's own change when its classifier's first float values (the int8
    crops' token embeddings) move by one ulp, against JAX's classifier on
    the same int8 crops.  JAX's fused pipeline is not the reference for
    them: its classifier's scores move with the batch it runs in (the
    pipeline's B x budget slots against the kept crops alone moved one
    score by 4.5e-4, an int8 code flip where XLA's f32 rounding follows
    the batch's shape), while the port's do not."""
    from yolov8_vit_tpu_torch.ops.crop import crop_to_patches_i8
    from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner
    kept = got["final_valid"] > 0
    h, w = frames.shape[1:3]
    slot_img, slot_box = np.nonzero(kept)[0], []
    for i, j in zip(*np.nonzero(kept)):
        slot_box.append(BatchRunner._host_inflate(
            got["boxes"][i][j:j + 1], w, h)[0])
    spec = port.model.vit_spec
    crops = crop_to_patches_i8(torch.from_numpy(frames),
                               torch.from_numpy(slot_img),
                               torch.from_numpy(np.stack(slot_box)),
                               (spec.img_size, spec.img_size), spec.patch)
    logits = np.asarray(ref.model.classifier.apply(
        ref.params["vit"], jnp.asarray(crops.numpy())), np.float32)
    z = np.exp(logits - logits.max(-1, keepdims=True))
    want = (z / z.sum(-1, keepdims=True)).max(-1)
    vit = port.model.vit.model
    embed = vit.embed
    vit.embed = lambda img, dtype: torch.nextafter(
        embed(img, dtype), torch.tensor(np.inf, dtype=dtype))
    try:
        moved = port(torch.from_numpy(frames))[
            TWO_STAGE_OUTPUTS.index("cls_scores")].float().numpy()
    finally:
        vit.embed = embed
    bar = INT8_ULP_FACTOR * float(np.abs(moved - got["cls_scores"])[kept]
                                  .max())
    assert float(np.abs(got["cls_scores"][kept] - want).max()) <= bar


def _structure(path):
    meta, tree = read_engine(path)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out[prefix + (k,)] = (tuple(v.shape), str(v.dtype))
    walk(tree, ())
    return meta, out


@pytest.mark.parametrize("argv", [
    ["detect"] + DET_ARGS,
    ["classify", "--model", VIT_MODEL],
    ["classify", "--model", VIT_MODEL, "--quant", "w8a"],
], ids=["detect", "classify", "classify_w8a"])
def test_random_init_matches_jax_layout(tmp_path, argv):
    a, b = _both(tmp_path, lambda out: argv + ["--out", out], "init")
    meta_a, leaves_a = _structure(a)
    meta_b, leaves_b = _structure(b)
    assert meta_a == meta_b
    assert leaves_a == leaves_b


def test_bad_merge_refused(ckpts, tmp_path):
    det = export.main(["detect", "--weights", ckpts[0], "--out",
                       str(tmp_path / "det")] + DET_ARGS)
    for pair in ((det, det), (str(tmp_path / "x"), det)):
        if pair[0] != det:
            export.main(["classify", "--out", pair[0], "--model", VIT_MODEL])
        with pytest.raises(ValueError,
                           match="merge needs a detect engine and a "
                                 "classify engine"):
            merge_two_stage_engine(str(tmp_path / "two"), *pair)
        with pytest.raises(ValueError,
                           match="merge needs a detect engine and a "
                                 "classify engine"):
            jexport.main(["two-stage", "--detect-engine", pair[0],
                          "--classify-engine", pair[1], "--out",
                          str(tmp_path / "jtwo")])


# each artifact flag of the JAX CLI, with what it needs beside it to write
# something on the CPU, and the files it must write (relative to the
# engine dir, or to tmp_path for --stablehlo's prefix)
AOT_FLAG_CASES = {
    "--stablehlo": (["--stablehlo", "{tmp}/native"], ["native.pt2"]),
    "--aot": (["--aot", "1"],
              ["aot/1x64x64x3_bfloat16-bfloat16_cpu.pt2",
               "aot/1x64x64x3_float32-float32_cpu.pt2"]),
    "--compiled": (["--compiled", "1", "--aot-dtype", "float32"],
                   ["aot/1x64x64x3_float32-float32_cpu.aoti.pt2",
                    "aot/1x64x64x3_float32-float32_cpu.aoti.pt2.host.json"]),
    "--aot-platform": (["--aot-platform", "cpu", "--aot", "2",
                        "--aot-dtype", "float32"],
                       ["aot/2x64x64x3_float32-float32_cpu.pt2"]),
    "--aot-dtype": (["--aot", "1", "--aot-dtype", "float32"],
                    ["aot/1x64x64x3_float32-float32_cpu.pt2"]),
}


@pytest.mark.parametrize("flag", list(AOT_FLAG_CASES))
def test_aot_flags_accepted(tmp_path, flag, monkeypatch):
    """The JAX CLI's artifact flags, with its names and defaults: each
    writes its files on the CPU, named as `_parse_aot_name` reads them,
    and the engine dir's Engine registers them."""
    import os
    from yolov8_vit_tpu_torch.runtime import engine as rt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv, files = AOT_FLAG_CASES[flag]
    out = str(tmp_path / "d")
    export.main(["detect", "--out", out] + DET_ARGS
                + [a.format(tmp=tmp_path) for a in argv])
    for f in files:
        path = str(tmp_path / f) if flag == "--stablehlo" \
            else os.path.join(out, f)
        assert os.path.exists(path), f
    aot_dir = os.path.join(out, "aot")
    names = sorted(os.listdir(aot_dir)) if os.path.isdir(aot_dir) else []
    assert names == sorted(os.path.basename(f) for f in files
                           if f.startswith("aot/"))
    for name in names:
        if name.endswith(".host.json"):
            continue
        ext = rt.COMPILED_EXT if name.endswith(rt.COMPILED_EXT) \
            else rt.AOT_EXT
        shape, in_dt, act_dt, platform = rt._parse_aot_name(name, ext)
        assert shape[1:] == (64, 64, 3) and platform == "cpu"
        assert in_dt == act_dt and in_dt in ("bfloat16", "float32")
        eng = Engine(out, device="cpu", dtype=getattr(torch, act_dt))
        reg = eng._compiled if ext == rt.COMPILED_EXT else eng._aot
        assert reg[shape] == os.path.join(aot_dir, name)
    if flag == "--stablehlo":
        meta = torch._inductor.aoti_load_package(
            str(tmp_path / "native.pt2")).get_metadata()
        assert meta["mt_kind"] == "detect"
        assert meta["mt_input_shape"] == "1x64x64x3"
        assert meta["mt_weights"] == "inside"
        assert meta["mt_ops"] == "conv_f32,nms_argmax_ml"
        assert rt._parse_aot_name("native.pt2") is None


def test_bf16_detect_program_calls_the_conv_operator(tmp_path, monkeypatch):
    """A bf16 detect engine's torch.export program (`attach_aot`, as the
    CLI's --aot writes it) traced on the card's path (forced here on the
    CPU, where kernel K's operator runs its plain version) holds one
    mt::conv_silu node a ConvBlock; the Engine loads it and its outputs
    are the eager engine's bit for bit."""
    from yolov8_vit_tpu_torch.models import yolov8 as y
    from yolov8_vit_tpu_torch.runtime.engine import attach_aot
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "d")
    export.main(["detect", "--out", out] + DET_ARGS)
    monkeypatch.setattr(y, "_kernel_runs",
                        lambda t: t.dtype == torch.bfloat16)
    [path] = attach_aot(out, [(2, 64, 64, 3)], dtype=torch.bfloat16,
                        platform="cpu")
    targets = [str(n.target) for n in torch.export.load(path).graph.nodes
               if n.op == "call_function"]
    assert targets.count("mt.conv_silu.default") == 54
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    eager = Engine(out, device="cpu", dtype=torch.bfloat16, _load_aot=False)
    prog = Engine(out, device="cpu", dtype=torch.bfloat16)
    want, got = eager(x), prog(x)
    assert eager.last_path == "eager" and prog.last_path == "aot"
    for g, w in zip(got, want):
        assert torch.equal(g, w)
