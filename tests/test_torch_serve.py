"""PyTorch port, the inspection service: the same requests through the JAX
package's `InspectionService` and the port's, on tiny engine dirs that the
port's `save_engine` wrote, with `device="cpu"`; `serve/infer.py::main`
rows and `runtime/accuracy.py::compare_fused_vs_host` dicts against
JAX's; the host image helpers (`serve/imageio.py`) against OpenCV.

Everything runs in f32.  Rows carry integer boxes and class ids, which
must be equal; a row's confidence is a float held to 1e-4 (f32 sums in
another order in the two frameworks).  `imageio.resize_linear` reproduces
cv2.resize's fixed-point INTER_LINEAR exactly, so frames that need the
resize are held to the same bar as frames at the engine's size.
"""
import dataclasses
import functools
import http.server
import io
import json
import os
import threading
import urllib.request
from wsgiref.util import setup_testing_defaults

import cv2
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yolov8_vit_tpu.config import DetectConfig as JDetectConfig
from yolov8_vit_tpu.models.vit import ViTSpec as JViTSpec
from yolov8_vit_tpu.runtime import accuracy as j_accuracy
from yolov8_vit_tpu.runtime.engine import Engine as JEngine
from yolov8_vit_tpu.serve import app as j_app
from yolov8_vit_tpu.serve import infer as j_infer
from yolov8_vit_tpu.serve.batch_runner import make_runner as j_make_runner
from yolov8_vit_tpu.data.voc import generate_annotation as j_generate

from yolov8_vit_tpu_torch.config import DetectConfig, ServiceConfig
from yolov8_vit_tpu_torch.data.voc import generate_annotation
from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
from yolov8_vit_tpu_torch.models.vit import ViTSpec
from yolov8_vit_tpu_torch.runtime import accuracy
from yolov8_vit_tpu_torch.runtime.engine import Engine
from yolov8_vit_tpu_torch.serve import app, imageio, infer
from yolov8_vit_tpu_torch.serve.batch_runner import make_runner
from yolov8_vit_tpu_torch.serve.downloads import download_images
from yolov8_vit_tpu_torch.utils.densify import densify_detect_head
from yolov8_vit_tpu_torch.weights import init_tree, save_engine

DENSE = dict(input_size=(64, 64), variant="n", nms_topk=16, nms_conf=1e-6,
             conf_second=1e-6, nms_iou=0.995, custom_nms_iou=0.999)
# 224-pixel crops, as the service's host route cuts them (50 tokens)
SPEC = dict(img_size=224, patch=32, dim=64, depth=2, heads=4,
            backbone_classes=40)
BUDGET = 16


@pytest.fixture(scope="module")
def tree():
    pipe = TwoStagePipeline(det_cfg=DetectConfig(**DENSE),
                            vit_spec=ViTSpec(**SPEC), device="cpu")
    return densify_detect_head(init_tree(pipe, 0))


@pytest.fixture(scope="module")
def engines(tree, tmp_path_factory):
    """(detect dir, classify dir) written by the port's save_engine."""
    root = tmp_path_factory.mktemp("engines")
    det = save_engine(str(root / "det"), "detect", tree["det"],
                      {"detect_cfg": dataclasses.asdict(DetectConfig(**DENSE))})
    cls = save_engine(str(root / "cls"), "classify", tree["vit"],
                      {"vit_spec": dataclasses.asdict(ViTSpec(**SPEC)),
                       "num_classes": 5})
    return det, cls


@pytest.fixture(scope="module")
def file_server(tmp_path_factory):
    """Frames served over HTTP on localhost: four at the engine's size
    (.bmp, .png) and three that need the letterbox resize."""
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(3)
    names = []
    for i, (h, w, ext) in enumerate([(64, 64, "bmp"), (64, 64, "png"),
                                     (64, 64, "bmp"), (64, 64, "png"),
                                     (96, 128, "png"), (50, 37, "bmp"),
                                     (200, 120, "png")]):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        name = f"f{i}_{h}x{w}.{ext}"
        assert cv2.imwrite(str(root / name), img)
        names.append(name)
    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    handler = functools.partial(Quiet, directory=str(root))
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}/"
    yield str(root), base, names
    srv.shutdown()
    srv.server_close()


def _call(svc, method, path, body=None, query=""):
    """One WSGI request -> (status, content type, body bytes)."""
    env = {}
    setup_testing_defaults(env)
    raw = b"" if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    env.update(REQUEST_METHOD=method, PATH_INFO=path, QUERY_STRING=query,
               CONTENT_LENGTH=str(len(raw)))
    env["wsgi.input"] = io.BytesIO(raw)
    seen = {}

    def start(status, headers):
        seen["status"] = status
        seen["type"] = dict(headers).get("Content-Type")

    out = b"".join(svc.wsgi(env, start))
    return seen["status"], seen["type"], out


def _same_rows(got, ref):
    """Rows (name, cls, conf, x1, y1, x2, y2): all equal, conf to 1e-4."""
    assert len(got) == len(ref) and len(ref) > 0
    for g, r in zip(got, ref):
        g, r = list(g), list(r)
        assert g[:2] == r[:2] and g[3:] == r[3:], (g, r)
        assert abs(g[2] - r[2]) <= 1e-4, (g, r)


def _services(engines, tmp_path, fused):
    det, cls = engines
    j = j_app.build_default_service(str(tmp_path / "jax"), det, cls,
                                    enable_retrain=False, fused=fused)
    p = app.build_default_service(str(tmp_path / "port"), det, cls,
                                  enable_retrain=False, fused=fused,
                                  device="cpu")
    return j, p


# ---- POST / ----------------------------------------------------------------
@pytest.mark.parametrize("which", ["engine_size", "resized"])
def test_upload_host_route_same_json_as_jax(engines, file_server, tmp_path,
                                            which):
    _, base, names = file_server
    pick = names[:4] if which == "engine_size" else names[4:]
    j, p = _services(engines, tmp_path, fused=False)
    body = {"urls": [{f"img{i}": base + n} for i, n in enumerate(pick)]}
    sj, tj, rj = _call(j, "POST", "/", body)
    sp, tp, rp = _call(p, "POST", "/", body)
    assert sj == sp == "200 OK" and tj == tp
    _same_rows(json.loads(rp), json.loads(rj))
    assert {r[0] for r in json.loads(rp)} == set(pick)


def test_upload_fused_route_matches_jax(engines, file_server, tmp_path):
    """The fused route.  Both services are wired as build_default_service
    wires them, but with f32 activations (its make_runner runs bf16, where
    the two frameworks round at other places)."""
    det, cls = engines
    _, base, names = file_server

    def wire(mod, br, workdir):
        def runner(input_dir):
            paths = sorted(os.path.join(input_dir, f)
                           for f in os.listdir(input_dir))
            return br.flatten(paths, br.run_paths(paths))
        return mod.InspectionService(workdir=str(workdir), runner=runner)

    j = wire(j_app, j_make_runner(det, cls, classify_budget=BUDGET,
                                  dtype=jnp.float32), tmp_path / "jax")
    p = wire(app, make_runner(det, cls, classify_budget=BUDGET,
                              dtype=torch.float32, device="cpu"),
             tmp_path / "port")
    body = {"urls": [{"u": base + n} for n in names[:4]]}
    _same_rows(json.loads(_call(p, "POST", "/", body)[2]),
               json.loads(_call(j, "POST", "/", body)[2]))


def test_build_default_service_fused_on_cpu(engines, file_server, tmp_path):
    """fused=True through build_default_service (bf16, as served): its
    rows equal the BatchRunner's called directly, over real HTTP."""
    det, cls = engines
    root, base, names = file_server
    svc = app.build_default_service(str(tmp_path), det, cls,
                                    enable_retrain=False, fused=True,
                                    device="cpu")
    httpd = svc.make_http_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/",
            data=json.dumps({"urls": [{"u": base + n}
                                      for n in names]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            rows = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    br = make_runner(det, cls, device="cpu")
    paths = sorted(os.path.join(root, n) for n in names)
    want = br.flatten(paths, br.run_paths(paths))
    assert rows == [list(r) for r in want] and len(rows) > 0


def test_upload_malformed_and_missing(engines, tmp_path):
    j, p = _services(engines, tmp_path, fused=False)
    for method, path, body in [("POST", "/", {}), ("GET", "/", None),
                               ("POST", "/", b"not json"),
                               ("POST", "/", b"[1, 2]"),
                               ("POST", "/", {"urls": [3, {}, "x"]}),
                               ("GET", "/getImage", None),
                               ("POST", "/getImage", {}),
                               ("POST", "/getImage", b"{"),
                               ("GET", "/nothing", None)]:
        assert _call(p, method, path, body) == _call(j, method, path, body), \
            (method, path, body)
    assert _call(p, "GET", "/nothing")[0] == "404 Not Found"


# ---- /getImage, /getConfig, pages -----------------------------------------
def test_get_image_same_as_jax(engines, file_server, tmp_path):
    _, base, names = file_server
    j, p = _services(engines, tmp_path, fused=False)
    body = {"imageUrl": base + names[0] + "?sig=a/b",
            "objects": [{"sort": "broke", "xmin": 5, "ymin": 6, "xmax": 40,
                         "ymax": 50}, {"bad": 1}, 7],
            "lat": 39.5, "lng": 116.25}
    outs = {}
    for name, svc in (("jax", j), ("port", p)):
        status, _, raw = _call(svc, "POST", "/getImage", body)
        assert status == "200 OK"
        outs[name] = json.loads(raw)
        assert outs[name]["url"].endswith("FuChuang/" + names[0])
    xml = {n: open(tmp_path / n / "train/new" / (
        os.path.splitext(names[0])[0] + ".xml"), "rb").read()
        for n in ("jax", "port")}
    assert xml["jax"] == xml["port"] and b"<sort>1</sort>" in xml["port"]
    # the saved frame decodes to the pixels that were served
    saved = imageio.imread(str(tmp_path / "port/train/new" / names[0]))
    np.testing.assert_array_equal(
        saved, cv2.imread(str(tmp_path / "jax/train/new" / names[0])))
    for svc in (j, p):                     # counter bumped, location kept
        for _ in range(100):
            if svc.config.read()["num"] == 1:
                break
            threading.Event().wait(0.05)
        assert svc.config.read()["num"] == 1
        assert list(svc.label_locations) == [
            {"lat": 39.5, "lng": 116.25, "cls": "broke"}]
    # the drawn copy was uploaded to the local object store and decodes
    drawn = imageio.imread(str(tmp_path / "port/oss_local/FuChuang"
                               / names[0]))
    assert drawn is not None and drawn.shape == saved.shape
    assert (drawn != saved).any()


def test_config_and_pages_same_as_jax(engines, tmp_path):
    j, p = _services(engines, tmp_path, fused=False)
    upd = {"standard": 7, "class_config": {"epoch": 3}, "ignored": 1}
    for method, path, body, query in [
            ("GET", "/getConfig", None, ""),
            ("POST", "/getConfig", upd, ""),
            ("GET", "/getConfig", None, ""),
            ("GET", "/map", None, "location=%E5%8C%97%E4%BA%AC"),
            ("GET", "/map", None, ""),
            ("GET", "/heatmap", None, ""),
            ("GET", "/logs", None, ""),
            ("GET", "/logs", None, "mobile=1"),
            ("GET", "/trainNow", None, "")]:
        assert _call(p, method, path, body, query) == \
            _call(j, method, path, body, query), (method, path)
    assert p.config.read()["standard"] == 7
    assert p.config.read()["num"] == 0


def test_retrain_writes_class_engine_when_it_fires(tmp_path, monkeypatch):
    """enable_retrain wires train/classify.py::retrain: the retrain hook on
    the CPU (a tiny ViT, one epoch from the service config) delivers the
    ingested labels, trains, writes weights/class_engine, which the port's
    Engine loads, and publishes its log lines on the SSE hub."""
    from test_train_pipeline import _make_dataset
    from yolov8_vit_tpu_torch.serve.sse import HUB
    from yolov8_vit_tpu_torch.train import classify
    monkeypatch.setattr(classify, "_spec_for",
                        lambda cfg: ViTSpec(**SPEC))
    _make_dataset(str(tmp_path / "train/new"), n_per_class=3)
    svc = app.build_default_service(str(tmp_path), enable_retrain=True,
                                    device="cpu")
    assert svc.runner is None
    svc.config.update(class_config={"epoch": 1})
    q = HUB.subscribe()
    try:
        svc._call_retrain(True)
    finally:
        HUB.unsubscribe(q)
    events = []
    while not q.empty():
        events.append(q.get_nowait())
    logs = " ".join(events)
    for msg in ("Starting data delivery", "Starting training",
                "Epoch 1:", "Exporting engine", "Retraining process complete"):
        assert msg in logs, msg
    out = tmp_path / "weights/class_engine"
    eng = Engine(str(out), device="cpu")
    assert eng.kind == "classify" and eng.vit_spec == ViTSpec(**SPEC)
    logits = eng(torch.zeros(1, 224, 224, 3))
    assert logits.shape == (1, 5) and bool(torch.isfinite(logits).all())
    assert set(json.load(open(tmp_path / "train/result.json"))) == {"1"}
    assert _call(svc, "POST", "/", {"urls": [{"a": "http://127.0.0.1:9/x"}]}
                 )[0] == "200 OK"


def test_service_config_counter(tmp_path):
    cfg = ServiceConfig(str(tmp_path / "train/config.json"))
    cfg.update(standard=3)
    assert [cfg.bump_and_check() for _ in range(3)] == [
        (1, False), (2, False), (0, True)]


# ---- infer.main, accuracy ---------------------------------------------------
def test_infer_main_rows_equal_jax(engines, file_server, tmp_path):
    det, cls = engines
    root, _, names = file_server
    paths = [os.path.join(root, n) for n in names]
    seen = {"jax": [], "port": []}
    rows = {}
    for name, mod, eng in (("jax", j_infer, JEngine), ("port", infer, None)):
        if eng is None:
            d, c = Engine(det, device="cpu"), Engine(cls, device="cpu")
        else:
            d, c = eng(det), eng(cls)
        d.set_desired(["num_dets", "bboxes", "scores", "labels"])
        rows[name] = mod.main(
            d, paths, model_list=[c], crop_size=SPEC["img_size"],
            save_draw_dir=str(tmp_path / name),
            func=lambda *a, n=name: seen[n].append(a))
    _same_rows(rows["port"], rows["jax"])
    assert seen["port"] == seen["jax"]
    for n in names:                       # the drawn files exist and decode
        drawn = imageio.imread(str(tmp_path / "port" / n))
        assert drawn is not None
        assert drawn.shape == cv2.imread(os.path.join(root, n)).shape
    # a directory, and a detector alone
    d = Engine(det, device="cpu")
    alone = infer.main(d, root)
    assert [r[0] for r in alone] == [r[0] for r in rows["port"]]
    assert infer.path_to_list(root) == sorted(paths)


def test_compare_fused_vs_host_same_dict_as_jax(tree, file_server):
    root, _, names = file_server
    paths = [os.path.join(root, n) for n in names[:5]]
    as_np = lambda t: {k: as_np(v) for k, v in t.items()} \
        if isinstance(t, dict) else np.asarray(t)          # noqa: E731
    ref = j_accuracy.compare_fused_vs_host(
        as_np(tree["det"]), as_np(tree["vit"]), JDetectConfig(**DENSE),
        JViTSpec(**SPEC), paths, budget=BUDGET)
    got = accuracy.compare_fused_vs_host(
        tree["det"], tree["vit"], DetectConfig(**DENSE), ViTSpec(**SPEC),
        paths, budget=BUDGET, device="cpu")
    assert got["detections"] > 0 and got["images"] == 5
    for k in ("images", "count_match", "detections", "matched",
              "class_agree"):
        assert got[k] == ref[k], (k, got, ref)
    assert abs(got["mean_iou"] - ref["mean_iou"]) <= 1e-4
    assert accuracy.box_iou((0, 0, 2, 2), (1, 1, 3, 3)) == \
        j_accuracy.box_iou((0, 0, 2, 2), (1, 1, 3, 3))


# ---- host image helpers -------------------------------------------------------
@pytest.mark.parametrize("src,dst", [
    ((96, 128), (64, 48)), ((100, 37), (64, 173)), ((300, 500), (640, 384)),
    ((33, 47), (640, 449)), ((720, 1280), (640, 360)), ((64, 48), (480, 640)),
    ((7, 9), (640, 498)), ((1000, 30), (19, 640)), ((5, 7), (9, 3))])
def test_resize_linear_equals_cv2(src, dst):
    """dst is (w, h), as cv2.resize takes it; bit for bit, including the
    exact halving that OpenCV routes to its area path."""
    im = np.random.default_rng(src[0]).integers(0, 256, (*src, 3),
                                                dtype=np.uint8)
    np.testing.assert_array_equal(
        imageio.resize_linear(im, dst),
        cv2.resize(im, dst, interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("hw", [(64, 64), (96, 128), (50, 37), (480, 641)])
def test_letterbox_host_equals_jax(hw):
    im = np.random.default_rng(1).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got, r, dwdh = infer._letterbox_host(im, (64, 64))
    ref, rr, rdwdh = j_infer._letterbox_host(im, (64, 64))
    np.testing.assert_array_equal(got, ref)
    assert (r, dwdh) == (rr, rdwdh)


def test_bmp_codec_and_decode_against_cv2(tmp_path):
    rng = np.random.default_rng(2)
    for h, w in [(37, 53), (8, 8), (5, 3)]:        # row padding 1, 0, 3
        im = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        path = str(tmp_path / f"a{h}.bmp")
        assert imageio.imwrite(path, im)
        np.testing.assert_array_equal(cv2.imread(path), im)
        np.testing.assert_array_equal(imageio.imread(path), im)
        cv2.imwrite(path, im)
        np.testing.assert_array_equal(imageio.imread(path), im)
        np.testing.assert_array_equal(imageio.imread_rgb(path),
                                      im[..., ::-1])
    im = rng.integers(0, 256, (20, 31, 3), dtype=np.uint8)
    png = str(tmp_path / "a.png")
    assert imageio.imwrite(png, im)
    np.testing.assert_array_equal(cv2.imread(png), im)
    jpg = str(tmp_path / "a.jpg")
    assert imageio.imwrite(jpg, im)
    np.testing.assert_array_equal(imageio.imread(jpg), cv2.imread(jpg))
    assert imageio.imread(str(tmp_path / "missing.png")) is None
    (tmp_path / "junk.png").write_bytes(b"not an image")
    assert imageio.imread(str(tmp_path / "junk.png")) is None
    with pytest.raises(ValueError):
        imageio.imwrite(str(tmp_path / "a.xyz"), im)
    np.testing.assert_array_equal(
        imageio.copy_make_border(im, 1, 2, 3, 4, (114, 114, 114)),
        cv2.copyMakeBorder(im, 1, 2, 3, 4, cv2.BORDER_CONSTANT,
                           value=(114, 114, 114)))


def test_draw_image_marks_the_box():
    img = np.zeros((80, 120, 3), np.uint8)
    out = infer.draw_image(img, (20.2, 30.7, 90.1, 60.0), 1)
    assert out is img and (img[31, 20] == (0, 0, 220)).all()
    assert (img[60, 55] == (0, 0, 220)).all() and not img[45, 55].any()
    infer.draw_image(img, (-10, -10, 500, 500), "uncovered")   # clipped


def test_host_helpers_equal_jax():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (90, 70, 3), dtype=np.uint8)
    for box in [(3, 4, 60, 80), (-5, -5, 200, 200), (10, 10, 10, 10)]:
        np.testing.assert_array_equal(
            infer._crop_nearest_224(rgb, box, 32),
            j_infer._crop_nearest_224(rgb, box, 32))
        assert infer._inflate(box, 70, 90) == j_infer._inflate(box, 70, 90)
    xy = rng.uniform(0, 60, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (40, 2))], -1)
    np.testing.assert_array_equal(
        infer._area_nms_host(boxes, np.ones(40)),
        j_infer._area_nms_host(boxes, np.ones(40)))


def test_download_images_contract(file_server, tmp_path):
    root, base, names = file_server
    img = download_images(base + names[0], str(tmp_path), 0)
    np.testing.assert_array_equal(img, cv2.imread(os.path.join(root,
                                                               names[0])))
    a = download_images(base + names[1] + "?x=1/2", str(tmp_path))
    b = download_images(base + names[1], str(tmp_path))
    assert os.path.basename(a) == names[1] and a != b
    assert download_images(base + "missing.png", str(tmp_path)) is False
    assert download_images("not a url", str(tmp_path)) is False


def test_generate_annotation_same_bytes_as_jax(tmp_path):
    objs = [{"sort": "lose", "xmin": 1, "ymin": 2, "xmax": 30, "ymax": 40}]
    a = generate_annotation("", "x.jpg", "x.jpg", objs,
                            save_dir=str(tmp_path / "p"))
    b = j_generate("", "x.jpg", "x.jpg", objs, save_dir=str(tmp_path / "j"))
    assert open(a, "rb").read() == open(b, "rb").read()


def test_module_entry_point_serves_on_cpu(tmp_path):
    """`python -m yolov8_vit_tpu_torch.serve.app --device cpu` starts the
    server (no engines: the echo backend) and answers over HTTP."""
    import socket
    import subprocess
    import sys
    import time
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "yolov8_vit_tpu_torch.serve.app", "--device",
         "cpu", "--host", "127.0.0.1", "--port", str(port), "--workdir",
         str(tmp_path)], cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        base = f"http://127.0.0.1:{port}"
        cfg = None
        for _ in range(300):
            try:
                with urllib.request.urlopen(base + "/getConfig",
                                            timeout=2) as resp:
                    cfg = json.loads(resp.read())
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()
                time.sleep(0.1)
        assert cfg == ServiceConfig.DEFAULTS
        req = urllib.request.Request(
            base + "/", data=json.dumps({"urls": [{"a": base + "/x.png"}]})
            .encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read())["note"] == "no engine configured"
    finally:
        proc.terminate()
        proc.wait(timeout=30)
