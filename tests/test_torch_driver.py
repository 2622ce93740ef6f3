"""PyTorch port, the native driver `mt_infer` (csrc/driver/mt_infer.cc,
built by `_build.build_driver` with the host C++ compiler against the
wheel's libtorch), mirroring tests/test_pjrt_driver.py.

- It builds here (CPU wheel: without its CUDA operators).
- Exit code 2 and a message for a missing --package, an unknown argument,
  a missing value and a bad --device; exit 1 and a message for an
  unreadable package; --list-devices with --device cpu.
- Its mt operators' schemas, printed by the C++ dispatcher, are the
  Python package's (ops/library.py SCHEMAS generates both).
- A CPU package of a small graph (a convolution through mt::conv_f32,
  which the driver implements on the CPU too, and plain PyTorch ops), run
  on a BMP frame with --dump-prefix: its outputs bit-equal to
  `aoti_load_package` of the same package on the dumped input.  A CPU
  package that calls a kernel operator (its metadata list them) is
  refused before the run with a message (the driver runs the kernels on
  the card only).
- A CPU package whose graph calls kernel K (mt::conv_silu, the bf16
  detector's ConvBlock, a mutating operator: AOTInductor keeps it as one
  call writing its output buffer) lists it in its metadata and is
  refused on the CPU likewise.
- On a card (marked cuda, skipped here): a YOLOv8-n detect package
  (`export_stablehlo_detect`) through the driver, bit-equal to the
  Python load, its stage-1 NMS inputs within the f32 bars of the eager
  f32 Engine's (boxes 1e-4, tests/test_engine.py's bar); and a bf16
  YOLOv8-n detector's package (its ConvBlocks through kernel K) through
  the driver, bit-equal to the Python load.
"""
import os
import subprocess

import numpy as np
import pytest
import torch

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.models.yolov8 import conv_f32
from yolov8_vit_tpu_torch.ops import conv_block, library
from yolov8_vit_tpu_torch.ops.nms import efficient_nms_scan
from yolov8_vit_tpu_torch.runtime.export import _write_package
from yolov8_vit_tpu_torch.serve import imageio


@pytest.fixture(scope="module")
def driver():
    return _build.build_driver()


def _run(driver, *args, timeout=120):
    return subprocess.run([driver, *args], capture_output=True, text=True,
                          timeout=timeout)


def test_driver_builds(driver):
    assert os.path.exists(driver) and os.access(driver, os.X_OK)
    with open(driver + ".log") as f:
        assert "mt_infer.cc" in f.readline()


def test_driver_requires_package(driver):
    out = _run(driver)
    assert out.returncode == 2
    assert "--package required" in out.stderr


@pytest.mark.parametrize("args, message", [
    (["--bogus"], "unknown arg --bogus"),
    (["--package"], "missing value for --package"),
    (["--device", "tpu"], "bad --device tpu"),
    (["--imgsz", "zero"], "bad --imgsz zero")],
    ids=["unknown", "missing-value", "bad-device", "bad-imgsz"])
def test_driver_refuses_bad_arguments(driver, args, message):
    out = _run(driver, *args)
    assert out.returncode == 2
    assert message in out.stderr


def test_driver_reports_bad_package(driver, tmp_path):
    bad = tmp_path / "bad.pt2"
    bad.write_bytes(b"not a package")
    for path in (str(bad), "/nonexistent.pt2"):
        out = _run(driver, "--package", path, "--device", "cpu")
        assert out.returncode == 1
        assert f"failed to load package {path}" in out.stderr
        assert "frame #" not in out.stderr      # no C++ backtrace


def test_driver_lists_cpu_device(driver):
    out = _run(driver, "--list-devices", "--device", "cpu")
    assert out.returncode == 0
    assert out.stdout.splitlines() == ["platform: cpu",
                                       "addressable devices: 1"]


@pytest.fixture(scope="module")
def driver_schemas(driver):
    out = _run(driver, "--list-ops")
    assert out.returncode == 0, out.stderr
    return {line.split("(", 1)[0]: line for line in out.stdout.splitlines()}


@pytest.mark.parametrize("name", list(library.SCHEMAS))
def test_driver_schema_is_the_python_schema(driver_schemas, name):
    assert driver_schemas[f"mt::{name}"] == library.schema_string(name)


class _Small(torch.nn.Module):
    """A [0, 1] NHWC blob -> a strided conv through mt::conv_f32 (when
    traced) with a bias and SiLU, and the blob's mean per channel."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.register_buffer("w", torch.randn(8, 3, 3, 3, generator=g))
        self.register_buffer("b", torch.randn(8, generator=g))

    def forward(self, x):
        y = conv_f32(x.permute(0, 3, 1, 2), self.w, 2, self.b)
        return {"features": torch.nn.functional.silu(y),
                "mean": x.mean(dim=(1, 2))}


class _WithNms(torch.nn.Module):
    def forward(self, x):
        boxes = torch.cat([x[:, :8, 0, :2] * 10,
                           x[:, :8, 0, :2] * 10 + 5], dim=-1)
        return {"num": efficient_nms_scan(boxes, x[:, :8, 1, :])[0]}


def _bmp(tmp_path, h=30, w=40):
    rgb = np.random.default_rng(0).integers(0, 256, (h, w, 3), np.uint8)
    path = str(tmp_path / "frame.bmp")
    assert imageio.imwrite(path, rgb[..., ::-1])
    return path


def test_driver_cpu_package_bit_equal(driver, tmp_path):
    x = torch.zeros(1, 32, 32, 3)
    pkg = _write_package(_Small().eval(), ("features", "mean"), x,
                         str(tmp_path / "small"), "detect", "01")
    assert pkg == str(tmp_path / "small.pt2")
    prefix = str(tmp_path / "dump")
    out = _run(driver, "--package", pkg, "--image", _bmp(tmp_path),
               "--dump-prefix", prefix, "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "letterbox ratio=0.8000 dw=0.0 dh=4.0"
    assert lines[1] == "package outputs: 2 (features,mean)"
    assert lines[-1] == "OK"
    blob = np.fromfile(prefix + "_input.bin", np.float32).reshape(1, 32, 32,
                                                                  3)
    assert np.isclose(blob[0, 0, 0, 0], 114 / 255)     # the letterbox pad
    runner = torch._inductor.aoti_load_package(pkg)
    want = runner(torch.from_numpy(blob))
    for i, w in enumerate(want):
        assert lines[2 + i].startswith(f"output[{i}]: {w.numel() * 4} bytes:")
        got = np.fromfile(f"{prefix}_{i}.bin", np.uint8)
        np.testing.assert_array_equal(
            got, w.contiguous().view(torch.uint8).numpy().reshape(-1))
    # the package's metadata and --imgsz
    assert runner.get_metadata()["mt_input_shape"] == "1x32x32x3"
    bad = _run(driver, "--package", pkg, "--imgsz", "64", "--device", "cpu")
    assert bad.returncode == 1 and "takes 32x32 inputs" in bad.stderr


def test_driver_refuses_kernel_operators_on_cpu(driver, tmp_path):
    pkg = _write_package(_WithNms().eval(), ("num",),
                         torch.rand(2, 16, 16, 3),
                         str(tmp_path / "nms"), "detect", "01")
    assert torch._inductor.aoti_load_package(pkg).get_metadata()[
        "mt_ops"] == "nms_argmax_ml"
    out = _run(driver, "--package", pkg, "--device", "cpu")
    assert out.returncode == 1
    assert (f"package {pkg} calls the kernel operators nms_argmax_ml, "
            f"which mt_infer runs on the card only") in out.stderr


class _WithConvBlock(torch.nn.Module):
    """A [0, 1] NHWC blob -> one bf16 ConvBlock through mt::conv_silu."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.register_buffer("w", conv_block.kernel_layout(
            torch.randn(16, 3, 3, 3, generator=g)))
        self.register_buffer("b", torch.randn(16, generator=g))

    def forward(self, x):
        return {"features": conv_block.conv_silu(x.to(torch.bfloat16),
                                                 self.w, self.b, 2)}


def test_driver_refuses_the_conv_operator_on_cpu(driver, tmp_path):
    x = torch.rand(1, 16, 16, 3)
    pkg = _write_package(_WithConvBlock().eval(), ("features",), x,
                         str(tmp_path / "conv"), "detect", "01")
    runner = torch._inductor.aoti_load_package(pkg)
    assert runner.get_metadata()["mt_ops"] == "conv_silu"
    assert torch.equal(runner(x)[0], _WithConvBlock()(x)["features"])
    out = _run(driver, "--package", pkg, "--device", "cpu")
    assert out.returncode == 1
    assert (f"package {pkg} calls the kernel operators conv_silu, which "
            f"mt_infer runs on the card only") in out.stderr


class _Bf16Detector(torch.nn.Module):
    """A [0, 1] NHWC f32 blob -> a bf16 detector's head maps."""

    def __init__(self, det):
        super().__init__()
        self.det = det

    def forward(self, x):
        outs = self.det(x.to(torch.bfloat16))
        return {f"{k}{i}": t for i, (b, c) in enumerate(outs)
                for k, t in (("box", b), ("cls", c))}


@pytest.mark.cuda
def test_driver_on_card_runs_the_bf16_detector(driver, tmp_path):
    """A bf16 YOLOv8-n detector's package (54 ConvBlocks through kernel K)
    through the driver: outputs bit-equal to the Python load of the same
    package."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the driver's kernel operators "
                    "run only on the card")
    from yolov8_vit_tpu_torch.models import yolov8 as y
    g = torch.Generator().manual_seed(2)
    det = y.YOLOv8(y.YOLOV8_VARIANTS["n"], dtype=torch.bfloat16)
    for m in det.modules():
        if isinstance(m, y.Conv):
            m.reset(g)
    det.prepare()
    graph = _Bf16Detector(det.to("cuda")).eval()
    names = tuple(f"{k}{i}" for i in range(3) for k in ("box", "cls"))
    pkg = _write_package(graph, names, torch.zeros(1, 64, 64, 3,
                                                   device="cuda"),
                         str(tmp_path / "bf16"), "detect", "01")
    assert "conv_silu" in torch._inductor.aoti_load_package(
        pkg).get_metadata()["mt_ops"].split(",")
    prefix = str(tmp_path / "dump")
    out = _run(driver, "--package", pkg, "--image", _bmp(tmp_path, 48, 64),
               "--dump-prefix", prefix, timeout=600)
    assert out.returncode == 0, out.stderr
    x = torch.from_numpy(np.fromfile(prefix + "_input.bin", np.float32)
                         .reshape(1, 64, 64, 3)).cuda()
    py = torch._inductor.aoti_load_package(pkg)(x)
    for i, w in enumerate(py):
        np.testing.assert_array_equal(
            np.fromfile(f"{prefix}_{i}.bin", np.uint8),
            w.cpu().contiguous().view(torch.uint8).numpy().reshape(-1))


@pytest.mark.cuda
def test_driver_on_card_matches_python_and_eager(driver, tmp_path,
                                                 monkeypatch):
    """A random YOLOv8-n detect package on the card through the driver:
    outputs bit-equal to the Python load of the package; the package's
    stage-1 NMS inputs (decoded boxes, sigmoid scores, recorded inside
    kernel A's launcher) within the f32 bars of the eager f32 Engine's
    (boxes 1e-4, tests/test_engine.py's bar; scores 1e-5), which an f32
    conv run in TF32 would miss, and the same num_dets.  (The kept rows
    themselves are not compared: at a 1e-6 threshold a random detector's
    scores tie within an f32 ulp.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the driver's kernel operators "
                    "run only on the card")
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.models.yolov8 import detect_spec
    from yolov8_vit_tpu_torch.ops import nms
    from yolov8_vit_tpu_torch.runtime.engine import Engine
    from yolov8_vit_tpu_torch.runtime.export import export_stablehlo_detect
    from yolov8_vit_tpu_torch.weights import init_detect_tree, save_engine
    cfg = DetectConfig(variant="n", input_size=(64, 64), nms_conf=1e-6,
                       nms_iou=0.995, nms_topk=16)
    params = init_detect_tree(detect_spec(cfg),
                              torch.Generator().manual_seed(0))
    det_dir = save_engine(str(tmp_path / "det"), "detect", params, {
        "detect_cfg": {"variant": "n", "num_classes": 5,
                       "input_size": [64, 64], "nms_iou": 0.995,
                       "nms_conf": 1e-6, "nms_topk": 16}})
    pkg = export_stablehlo_detect(params, cfg, str(tmp_path / "detect"),
                                  platform="cuda")
    prefix = str(tmp_path / "dump")
    out = _run(driver, "--package", pkg, "--image", _bmp(tmp_path, 48, 64),
               "--dump-prefix", prefix, timeout=600)
    assert out.returncode == 0, out.stderr
    x = torch.from_numpy(np.fromfile(prefix + "_input.bin", np.float32)
                         .reshape(1, 64, 64, 3)).cuda()
    kernel, stage1 = nms.nms_argmax_ml_kernel, []

    def record(boxes, scores, *args):
        stage1.append((boxes.cpu(), scores.cpu()))
        return kernel(boxes, scores, *args)

    monkeypatch.setattr(nms, "nms_argmax_ml_kernel", record)
    py = torch._inductor.aoti_load_package(pkg)(x)
    for i, w in enumerate(py):
        np.testing.assert_array_equal(
            np.fromfile(f"{prefix}_{i}.bin", np.uint8),
            w.cpu().contiguous().view(torch.uint8).numpy().reshape(-1))
    num = Engine(det_dir, device="cuda")(x)[0]
    assert len(stage1) == 2 and torch.equal(num, py[0])
    (pb, ps), (eb, es) = stage1
    torch.testing.assert_close(pb, eb, atol=1e-4, rtol=0)
    torch.testing.assert_close(ps, es, atol=1e-5, rtol=0)
