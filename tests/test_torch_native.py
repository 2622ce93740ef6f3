"""PyTorch port, the host image library (runtime/native.py, the port's
copy of the host sources in yolov8_vit_tpu_torch/csrc/host/) against the
JAX package's `runtime.native` on the same files: JPEG, PNG, BMP and PPM,
a file that does not decode and headers with absurd dimensions (the cases
of tests/test_native.py).  The JAX library is compiled here from the root
csrc/ sources with csrc/Makefile's flags into tmp_path (not by make, which
would write into csrc/build/), and JAX's module is pointed at it.

Decode and crop are integer code and equal JAX's bit for bit.  The
letterbox's bilinear resize is float arithmetic: csrc/Makefile builds with
-march=native, under which g++ contracts its multiply-adds into FMAs, and
the port builds portably without; there its pixels are held within 1 of
JAX's (tests/test_native.py:54-68's bar against cv2), and bit for bit
against the root sources built with the port's flags."""
import os
import shutil
import struct
import subprocess

import cv2
import numpy as np
import pytest

from yolov8_vit_tpu.runtime import native as jnative

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.runtime import native
from yolov8_vit_tpu_torch.serve import imageio
from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_lib(root, flags):
    out = str(root / "libmtnative.so")
    csrc = os.path.join(REPO, "csrc")
    subprocess.run([shutil.which("g++"), *flags, "-o", out,
                    os.path.join(csrc, "imgproc.cc"),
                    os.path.join(csrc, "capi.cc"), "-ljpeg", "-lpng",
                    "-lpthread"], check=True, capture_output=True)
    return out


@pytest.fixture(scope="module", params=["makefile", "port_flags"])
def jax_native(request, tmp_path_factory):
    """JAX's runtime.native bound to its library built from csrc/, with
    csrc/Makefile's flags or with the port's."""
    flags = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"] \
        if request.param == "makefile" else list(_build.HOST_FLAGS)
    out = _jax_lib(tmp_path_factory.mktemp("jaxlib"), flags)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", out)
        mp.setattr(jnative, "_lib", None)
        assert jnative.load_native(auto_build=False) is not None
        jnative.flags = request.param
        yield jnative


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    smooth = cv2.resize(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8),
                        (640, 480), interpolation=cv2.INTER_LINEAR)
    out = {"jpg": str(d / "a.jpg"), "png": str(d / "b.png"),
           "bmp": str(d / "c.bmp"), "ppm": str(d / "e.ppm"),
           "png_big": str(d / "r.png"), "bad": str(d / "bad.jpg"),
           "bomb_bmp": str(d / "bomb.bmp"), "bomb_ppm": str(d / "bomb.ppm"),
           "neg_ppm": str(d / "neg.ppm"), "missing": str(d / "none.jpg"),
           "bmp32": str(d / "bgra.bmp"), "bmp_top": str(d / "top.bmp"),
           "bmp_cut": str(d / "cut.bmp")}
    cv2.imwrite(out["jpg"], smooth, [cv2.IMWRITE_JPEG_QUALITY, 98])
    cv2.imwrite(out["png"], rng.integers(0, 256, (123, 217, 3), np.uint8))
    cv2.imwrite(out["bmp"], rng.integers(0, 256, (37, 53, 3), np.uint8))
    ppm = rng.integers(0, 256, (21, 34, 3), np.uint8)
    with open(out["ppm"], "wb") as f:
        f.write(b"P6 34 21 255\n" + ppm.tobytes())
    cv2.imwrite(out["png_big"], np.full((1277, 1280, 3), 90, np.uint8))
    with open(out["bad"], "wb") as f:
        f.write(b"\xff\xd8 not a jpeg")
    hdr = b"BM" + struct.pack("<IHHI", 54, 0, 0, 54)
    hdr += struct.pack("<IiiHHIIiiII", 40, 100000, 100000, 1, 24,
                       0, 0, 0, 0, 0, 0)
    with open(out["bomb_bmp"], "wb") as f:
        f.write(hdr)
    # by hand: 32-bit BGRA bottom-up, 24-bit top-down (negative height),
    # and a 24-bit file that ends inside its pixel rows
    for kind, bpp, top, cut in (("bmp32", 32, False, 0),
                                ("bmp_top", 24, True, 0),
                                ("bmp_cut", 24, False, 7)):
        w, h = 29, 11
        stride = (w * bpp // 8 + 3) & ~3
        rows = rng.integers(0, 256, (h, stride), np.uint8).tobytes()
        head = b"BM" + struct.pack("<IHHI", 54 + len(rows), 0, 0, 54)
        head += struct.pack("<IiiHHIIiiII", 40, w, -h if top else h, 1, bpp,
                            0, len(rows), 0, 0, 0, 0)
        with open(out[kind], "wb") as f:
            f.write(head + rows[:len(rows) - cut])
    with open(out["bomb_ppm"], "wb") as f:
        f.write(b"P6 2000000000 2000000000 255\n")
    with open(out["neg_ppm"], "wb") as f:
        f.write(b"P6 -4 4 255\n")
    return out


def test_library_built_from_the_port_sources():
    assert native.native_status().startswith("built: ")
    assert native.decoded_formats() == ["jpeg", "png", "bmp", "ppm"]
    path = _build.host_lib_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    for src in _build.HOST_SOURCES + _build.HOST_HEADERS:
        assert os.path.exists(os.path.join(_build._CSRC, src))
    assert _build._CSRC == os.path.join(REPO, "yolov8_vit_tpu_torch", "csrc")


@pytest.mark.parametrize("kind", ["jpg", "png", "bmp", "ppm", "png_big",
                                  "bad", "bomb_bmp", "bomb_ppm", "neg_ppm",
                                  "missing", "bmp32", "bmp_top", "bmp_cut"])
def test_decode_matches_jax(jax_native, files, kind):
    got = native.decode_image(files[kind])
    want = jax_native.decode_image(files[kind])
    if want is None:
        assert got is None
    else:
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    if kind in ("bad", "bomb_bmp", "bomb_ppm", "neg_ppm", "missing",
                "bmp_cut"):
        assert got is None
    elif kind.startswith("bmp"):
        np.testing.assert_array_equal(got, imageio.imread_rgb(files[kind]))


@pytest.mark.parametrize("kind", ["png", "bmp", "ppm"])
def test_decode_equals_imageio(files, kind):
    np.testing.assert_array_equal(native.decode_image(files[kind]),
                                  imageio.imread_rgb(files[kind]))


@pytest.mark.parametrize("out_hw", [(64, 64), (640, 640), (320, 480)])
def test_letterbox_batch_matches_jax(jax_native, files, out_hw):
    paths = [files[k] for k in ("jpg", "png", "bmp", "ppm", "png_big",
                                "bad")]
    got = native.load_letterbox_batch(paths, out_hw, num_threads=3)
    want = jax_native.load_letterbox_batch(paths, out_hw, num_threads=3)
    assert got[2].tolist() == want[2].tolist() == [True] * 5 + [False]
    np.testing.assert_array_equal(got[1], want[1])
    diff = np.abs(got[0].astype(int) - want[0].astype(int))
    assert diff.max() <= (1 if jax_native.flags == "makefile" else 0)
    assert (got[0][5] == 0).all()


def test_letterbox_geometry_and_pad(files):
    """letterbox_params' geometry (round half to even: 1277 * .5 = 638.5
    -> 638) and a pad of 114 around the resized frame."""
    from yolov8_vit_tpu_torch.ops.letterbox import letterbox_params
    batch, geom, ok = native.load_letterbox_batch([files["png_big"]],
                                                  (640, 640))
    nh, nw, ratio, dw, dh, top, left = letterbox_params((1277, 1280),
                                                        (640, 640))
    assert ok[0] and nh == 638
    np.testing.assert_allclose(geom[0], [ratio, dw, dh], rtol=1e-6)
    assert (batch[0, :top] == 114).all() and (batch[0, top + nh:] == 114).all()


def test_crop_resize_matches_jax(jax_native, files):
    img = imageio.imread_rgb(files["png"])
    for box in [(10, 15, 150, 100), (0, 0, 217, 123), (40, 40, 41, 41),
                (200, 100, 250, 160), (30, 30, 20, 20)]:
        for out_hw in [(224, 224), (32, 48)]:
            np.testing.assert_array_equal(
                native.crop_resize_nearest(img, box, out_hw),
                jax_native.crop_resize_nearest(img, box, out_hw),
                err_msg=str((box, out_hw)))


@pytest.mark.parametrize("kind", ["jpg", "png", "bmp", "ppm"])
def test_runner_decodes_same_pixels_without_library(files, kind,
                                                    monkeypatch):
    """BatchRunner._decode through the library and through imageio (the
    library absent): the same pixels (JPEG: libjpeg's IDCT against PIL's
    within 2, tests/test_native.py's bar)."""
    with_lib = BatchRunner._decode(files[kind])
    monkeypatch.setattr(native, "decode_image", lambda path: None)
    without = BatchRunner._decode(files[kind])
    assert with_lib.shape == without.shape
    diff = np.abs(with_lib.astype(int) - without.astype(int)).max()
    assert diff <= (2 if kind == "jpg" else 0)
    assert BatchRunner._decode(files["bad"]) is None


def test_build_without_libjpeg_libpng(tmp_path, files, monkeypatch):
    """Where libjpeg and libpng are missing the library still builds: BMP
    and PPM decode as before, JPEG and PNG come back None from the
    library, native_status says why, and the runner decodes them through
    imageio."""
    broken = {k: (m, "-lmt_absent_" + k, prog)
              for k, (m, _lib, prog) in _build.HOST_OPTIONAL.items()}
    monkeypatch.setattr(_build, "HOST_OPTIONAL", broken)
    monkeypatch.setattr(_build, "_host_features", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    status = native.native_status()
    assert status.startswith(f"built: {tmp_path}") and \
        "decodes bmp, ppm; no jpeg: " in status and "no png: " in status
    assert native.decode_image(files["jpg"]) is None
    assert native.decode_image(files["png"]) is None
    np.testing.assert_array_equal(native.decode_image(files["bmp"]),
                                  imageio.imread_rgb(files["bmp"]))
    np.testing.assert_array_equal(BatchRunner._decode(files["png"]),
                                  imageio.imread_rgb(files["png"]))
    batch, _geom, ok = native.load_letterbox_batch(
        [files["jpg"], files["ppm"]], (64, 64))
    assert ok.tolist() == [False, True]


def test_first_use_from_many_threads_builds_once(tmp_path, files,
                                                 monkeypatch):
    """The runner's decode pool makes the first calls from 8 threads at
    once: every one gets the library (a build in a fresh directory), none
    finds it half built."""
    from concurrent.futures import ThreadPoolExecutor
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(native.decode_image, [files["bmp"]] * 16))
    assert native._error is None
    want = imageio.imread_rgb(files["bmp"])
    for g in got:
        np.testing.assert_array_equal(g, want)
