"""A whole run of each cell on the CPU (the harness's look for a card
skipped) at a tiny size, with the real limits: sound, it is correct; with
the timed path broken underneath, `correct` comes out false.  Faults,
where the cell can have them: an answer altered where it is produced
(a class, a loss), half the frames' detections left out, NMS suppression
switched off, a training step that returns its state unchanged or that
goes wrong only after the first steps of a call.  (Half a batch with the
mean over the rest is a fault of a batch of more than one sample: the
retrain's batch is one; no cell crosses chips.)"""
from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]
TRAINING = [c for c in CELLS if tiny(c)["mix"]["driver"] == "retrain"]
SERVING = [c for c in CELLS if tiny(c)["mix"]["driver"] == "bulk"]


def _run(workload):
    res = tiny(workload)
    return harness.run_cell(res, 2 ** 31 + 77, 0.6, False, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", SERVING)
def test_altered_class_is_caught(workload, monkeypatch):
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    orig = TwoStagePipeline.classify

    def classify(self, images, slot_img, slot_boxes):
        labels, scores = orig(self, images, slot_img, slot_boxes)
        return (labels + 1) % self.num_classes, scores

    monkeypatch.setattr(TwoStagePipeline, "classify", classify)
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", SERVING)
def test_detections_left_out_are_caught(workload, monkeypatch):
    from yolov8_vit_tpu_torch.models.two_stage import TwoStagePipeline
    orig = TwoStagePipeline.forward

    def forward(self, images):
        out = dict(orig(self, images))
        valid = out["final_valid"].clone()
        valid[1::2] = False          # every other frame of the batch
        out["final_valid"] = valid
        return out

    monkeypatch.setattr(TwoStagePipeline, "forward", torch.no_grad()(forward))
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", SERVING)
def test_suppression_off_is_caught(workload, monkeypatch):
    """The program's stage-1 NMS at IoU 1.0 (no pick suppresses another),
    the reference's as the configuration states.  (Stage 2 at IoU 1.0
    leaves these tiny scenes' kept sets as they are: one pick a cover
    survives stage 1; tests/test_bench_reference.py holds the reading of
    a box that stage 2 should have suppressed.)"""
    from benchmark import program
    orig = program.det_config
    monkeypatch.setattr(program, "det_config", lambda cfg: dataclasses.replace(
        orig(cfg), nms_iou=1.0))
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAINING)
def test_step_that_keeps_its_state_is_caught(workload, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step",
                        lambda self, closure=None: None)
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAINING)
def test_altered_loss_is_caught(workload, monkeypatch):
    from yolov8_vit_tpu_torch.train import vit_train
    orig = vit_train.combined_loss
    monkeypatch.setattr(vit_train, "combined_loss",
                        lambda logits, onehot: orig(logits, onehot) * 1.5)
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAINING)
def test_altered_crops_are_caught(workload, monkeypatch):
    from yolov8_vit_tpu_torch.train import dataset
    orig = dataset.eval_transform
    monkeypatch.setattr(dataset, "eval_transform",
                        lambda img, size=224: orig(img[:, ::-1], size))
    out = _run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", TRAINING)
def test_step_gone_wrong_inside_a_long_call_is_caught(workload, monkeypatch):
    """Each call of train_one_epoch steps its first batch soundly and
    keeps its state on every later one: the set-up's one-batch calls are
    sound, the window's long call is not."""
    from yolov8_vit_tpu_torch.train.vit_train import ViTTrainer
    steps = [0]
    orig_epoch = ViTTrainer.train_one_epoch
    orig_step = torch.optim.SGD.step

    def train_one_epoch(self, *args, **kwargs):
        steps[0] = 0
        return orig_epoch(self, *args, **kwargs)

    def step(self, closure=None):
        steps[0] += 1
        return orig_step(self, closure) if steps[0] == 1 else None

    monkeypatch.setattr(ViTTrainer, "train_one_epoch", train_one_epoch)
    monkeypatch.setattr(torch.optim.SGD, "step", step)
    out = _run(workload)
    assert not out["correct"], out["checks"]
    assert out["checks"]["window_gap"]["value"] > out["checks"][
        "window_gap"]["limit"]
