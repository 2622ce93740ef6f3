"""PyTorch port, the program's spans (utils/profiling.py `span`): the
runner's and the classifier trainer's named ranges in a torch.profiler
trace on the CPU, how they nest, what they cost with no profiler running,
and the runner's `profile` dict that the same spans time.

Tiny sizes: a YOLOv8-n at 64x64 with a densified head and dense-scene
thresholds (tests/test_torch_pipeline.py's), so a classify budget of 1
overflows and the ladder runs, and a 2-block ViT."""
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from yolov8_vit_tpu_torch.config import CFG, DetectConfig
from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
from yolov8_vit_tpu_torch.models.vit import ViTSpec
from yolov8_vit_tpu_torch.serve.batch_runner import BatchRunner
from yolov8_vit_tpu_torch.train.vit_train import ViTTrainer
from yolov8_vit_tpu_torch.utils import profiling
from yolov8_vit_tpu_torch.utils.densify import densify_detect_head
from yolov8_vit_tpu_torch.weights import init_tree, load_pipeline_tree

DENSE = dict(input_size=(64, 64), variant="n", nms_topk=16, nms_conf=1e-6,
             conf_second=1e-6, nms_iou=0.995, custom_nms_iou=0.999)
VIT_KW = dict(img_size=32, patch=8, dim=64, depth=2, heads=4,
              backbone_classes=40)
RUNNER = ("runner.enqueue", "runner.drain", "runner.wait", "runner.unpack",
          "runner.ladder", "runner.patch")
TRAIN = ("train.data", "train.step", "train.forward", "train.backward",
         "train.optim")


@pytest.fixture(scope="module")
def pipe():
    p = TwoStagePipeline(det_cfg=DetectConfig(**DENSE),
                         vit_spec=ViTSpec(**VIT_KW, attn_impl="fused"),
                         classify_budget=1, device="cpu")
    return load_pipeline_tree(p, densify_detect_head(init_tree(p, 0)))


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, 64, 64, 3), np.uint8))


def _spans(log_dir, names):
    """{name: [(start, end)]} of the trace's ranges named in `names`."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    out = {n: [] for n in names}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e.get("name") in out:
            ts = float(e["ts"])
            out[e["name"]].append((ts, ts + float(e["dur"])))
    return out


def _inside(inner, outer):
    return all(any(a <= s and t <= b for a, b in outer) for s, t in inner)


def test_runner_spans_one_a_batch_nested_in_the_drain(pipe, tmp_path):
    """run_device_batches under `profiling.trace`: one enqueue and one
    drain a batch, each wait and unpack inside a drain, one ladder span a
    ladder chunk, the patch of the chunks in flight inside the last drain;
    the profile dict counts what the spans saw."""
    runner = BatchRunner(pipe, max_batch=4)
    batches = [_frames(4, s) for s in range(3)]
    prof: dict = {}
    log_dir = str(tmp_path / "runner")
    with profiling.trace(log_dir):
        out = runner.run_device_batches(batches, profile=prof)
    assert len(out) == 3
    sp = _spans(log_dir, RUNNER)
    assert len(sp["runner.enqueue"]) == len(sp["runner.drain"]) == 3
    assert len(sp["runner.wait"]) == len(sp["runner.unpack"]) == 3
    assert _inside(sp["runner.wait"] + sp["runner.unpack"],
                   sp["runner.drain"])
    assert prof["overflow_dets"] > 0 and prof["overflow_ms"] > 0.0
    assert len(sp["runner.ladder"]) == prof["ladder_chunks"] > 0
    assert _inside(sp["runner.ladder"], sp["runner.drain"])
    last = max(sp["runner.drain"])
    assert len(sp["runner.patch"]) == 1
    assert _inside(sp["runner.patch"], [last])
    for key in ("enqueue_ms", "wait_ms", "fetch_ms"):
        assert prof[key] > 0.0, key
    assert prof["decode_ms"] == 0.0


def test_run_paths_spans_and_profile(pipe, tmp_path):
    """run_paths: one decode a request, an enqueue and a drain a chunk."""
    from PIL import Image
    paths = []
    for i, frame in enumerate(_frames(6, 7).numpy()):
        paths.append(str(tmp_path / f"f{i}.png"))
        Image.fromarray(frame).save(paths[-1])
    runner = BatchRunner(pipe, max_batch=4)
    prof: dict = {}
    log_dir = str(tmp_path / "paths")
    with profiling.trace(log_dir):
        runner.run_paths(paths, profile=prof)
    sp = _spans(log_dir, RUNNER + ("runner.decode",))
    assert len(sp["runner.decode"]) == 1
    assert len(sp["runner.enqueue"]) == len(sp["runner.drain"]) == 2
    assert _inside(sp["runner.wait"] + sp["runner.unpack"]
                   + sp["runner.ladder"] + sp["runner.patch"],
                   sp["runner.drain"])
    assert len(sp["runner.ladder"]) == prof["ladder_chunks"] > 0
    assert prof["overflow_dets"] > 0 and prof["decode_ms"] > 0.0


def test_trainer_spans_one_a_step(tmp_path):
    """train_one_epoch: a data, step, forward, backward and optim span a
    step, the last three inside the step; one more data span, the fetch
    that finds the loader spent."""
    trainer = ViTTrainer(cfg=CFG(), spec=ViTSpec(**VIT_KW), device="cpu",
                         log_fn=lambda *a: None)
    model, opt = trainer.init()
    rng = np.random.default_rng(0)
    loader = [(rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
               np.eye(5, dtype=np.float32)[rng.integers(0, 5, 2)])
              for _ in range(3)]
    log_dir = str(tmp_path / "train")
    with profiling.trace(log_dir):
        trainer.train_one_epoch(model, opt, loader, 0)
    sp = _spans(log_dir, TRAIN)
    assert {n: len(v) for n, v in sp.items()} == {
        "train.data": 4, "train.step": 3, "train.forward": 3,
        "train.backward": 3, "train.optim": 3}
    assert _inside(sp["train.forward"] + sp["train.backward"]
                   + sp["train.optim"], sp["train.step"])
    assert not _inside(sp["train.data"][:1], sp["train.step"])


def test_span_off_calls_nothing_in_the_profiler(monkeypatch):
    """With no profiler running, a span (timed or not) never reaches
    record_function; the untimed one is a single shared null context."""
    def refuse(*_a, **_k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b")
    acc: dict = {}
    with profiling.span("a"), profiling.span("b", acc, "b_ms"):
        pass
    assert acc["b_ms"] >= 0.0


def test_span_on_opens_a_range_and_times_it(tmp_path):
    acc: dict = {}
    log_dir = str(tmp_path / "on")
    with profiling.trace(log_dir):
        for _ in range(2):
            with profiling.span("outer.step", acc, "step_ms"):
                with profiling.span("outer.inner"):
                    torch.ones(8).sum()
    sp = _spans(log_dir, ("outer.step", "outer.inner"))
    assert Counter({n: len(v) for n, v in sp.items()}) == Counter(
        {"outer.step": 2, "outer.inner": 2})
    assert _inside(sp["outer.inner"], sp["outer.step"])
    assert acc["step_ms"] > 0.0

