"""The plain reference against the port's CPU path at tiny sizes: the
seeded tree loads into the port as it is, the detector's head maps and
the ViT's logits agree in float32 (a whole run of each cell judged
correct: test_bench_faults.py)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import judge, program, scenes, weights
from benchmark.reference.pipeline import Pipeline, crop_boxes
from benchmark.tests.tiny import tiny


@pytest.fixture(scope="module", params=["b16w8a.bulk32", "b8f.bulk32"])
def built(request):
    torch.manual_seed(0)
    res = tiny(request.param)
    cfg, mix = res["cfg"], res["mix"]
    tree = weights.make_tree(cfg, 123, "cpu")
    frames, covers = scenes.cover_scenes(5, 8, (64, 64), 1.5, "cpu")
    scenes.fit_head(tree, cfg, frames, covers)
    pipe, runner = program.bulk_runner(cfg, mix, tree, "cpu")
    return res, tree, pipe, runner, frames


def test_seed_makes_the_same_tree():
    cfg = tiny("b16w8a.bulk32")["cfg"]
    a = weights.make_tree(cfg, 2 ** 31 + 11, "cpu")
    b = weights.make_tree(cfg, 2 ** 31 + 11, "cpu")
    c = weights.make_tree(cfg, 2 ** 31 + 12, "cpu")
    k = a["vit"]["params"]["model"]["block0"]["attn"]["qkv"]["kernel"]
    assert torch.equal(k, b["vit"]["params"]["model"]["block0"]["attn"]
                       ["qkv"]["kernel"])
    assert not torch.equal(k, c["vit"]["params"]["model"]["block0"]["attn"]
                           ["qkv"]["kernel"])


def test_detector_head_maps_agree(built):
    res, tree, pipe, _, frames = built
    ref = Pipeline(tree, res["cfg"])
    # the port's detector takes frames in [0, 1] (`blob`)
    with torch.no_grad():
        got = pipe.det(frames.to(torch.float32).div(255.0).to(pipe.dtype))
        want = ref.det(frames.to(torch.float32) / 255.0)
    for (gb, gc), (wb, wc) in zip(got, want):
        assert torch.allclose(gb.float(), wb, atol=2e-4, rtol=1e-4)
        assert torch.allclose(gc.float(), wc, atol=2e-4, rtol=1e-4)


def test_vit_logits_agree(built):
    res, tree, pipe, _, frames = built
    cfg = res["cfg"]
    boxes = np.array([[3, 5, 40, 44], [0, 0, 64, 64], [20, 10, 30, 60]],
                     np.float64)
    fidx = np.array([0, 1, 2])
    from yolov8_vit_tpu_torch.ops import crop_to_patches_i8
    vs = pipe.vit_spec
    cb = torch.from_numpy(crop_boxes(boxes, 64, 64)).to(torch.int32)
    patches = crop_to_patches_i8(frames, torch.from_numpy(fidx), cb,
                                 (vs.img_size, vs.img_size), vs.patch)
    with torch.no_grad():
        got = pipe.vit(patches).double().numpy()
    mode = "w8a" if cfg["vit"]["quant"] == "w8a" else "f32"
    ref = Pipeline(tree, cfg, vit_mode=mode)
    want = ref.classify(frames, fidx, boxes)
    # int8: a value at a .5 boundary may take the neighbouring code
    tol = 5e-2 if mode == "w8a" else 1e-4
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def test_lower_precision_moves_the_logits(built):
    res, tree, _, _, frames = built
    cfg = res["cfg"]
    boxes = np.array([[3, 5, 40, 44], [0, 0, 64, 64]], np.float64)
    fidx = np.array([0, 1])
    low = "w4a" if cfg["vit"]["quant"] == "w8a" else "fp8"
    a = Pipeline(tree, cfg).classify(frames, fidx, boxes)
    b = Pipeline(tree, cfg, vit_mode=low).classify(frames, fidx, boxes)
    assert np.abs(a - b).max() > 0


def test_judge_readings():
    box = np.array([[0, 0, 10, 10], [20, 20, 30, 30]], np.float64)
    lab = np.array([0, 0])
    sc = np.array([0.9, 0.8])
    anchors = np.concatenate([box, box + 40]), np.array(
        [[0.88, 0.1], [0.8, 0.3], [0.0, 0.0], [0.0, 0.0]])
    assert judge.anchor_gap(box, lab, sc, *anchors) == pytest.approx(0.02)
    # an unknown stage-1 label is judged by the anchor's best class
    assert judge.anchor_gap(box, -lab - 1, sc, *anchors) == pytest.approx(
        0.02)
    # a box at no anchor reads the whole score range
    assert judge.anchor_gap(box + 100, lab, sc, *anchors) == 1.0



DET = {"nms_conf": 0.25, "nms_iou": 0.65, "nms_topk": 100,
       "conf_second": 0.35, "custom_nms_iou": 0.45}


def _scene():
    """Four anchors of one class: a, a's neighbour (IoU 0.9 with a), b
    (apart), a low one; and their scores."""
    raw = np.array([[0, 0, 100, 100], [0, 0, 100, 90], [200, 200, 300, 300],
                    [400, 400, 450, 450]], np.float64)
    scores = np.array([[0.9], [0.85], [0.8], [0.3]])
    return raw, scores


def _served(raw, scores, picks, keep):
    picks = np.asarray(picks)
    return {"boxes": raw[picks], "labels": np.zeros(len(picks), np.int64),
            "keep": np.asarray(keep, bool), "ref_scores": scores[picks, 0],
            "anchor": picks}


def test_set_gap_readings():
    raw, scores = _scene()
    anchors = {"raw": raw, "scores": scores}
    # the greedy outcome: a (suppresses its neighbour), b, the low one
    # picked and left out of stage 2 by its score
    assert judge.set_gap(_served(raw, scores, [0, 2, 3], [1, 1, 0]),
                         anchors, DET) == 0.0
    # stage 1 skipped: the neighbour picked too, IoU 0.9 over 0.65
    assert judge.set_gap(_served(raw, scores, [0, 1, 2, 3], [1, 0, 1, 0]),
                         anchors, DET) == pytest.approx(0.25)
    # stage 2 skipped: the neighbour kept beside a, IoU 0.9 over 0.45
    assert judge.set_gap(_served(raw, scores, [0, 1, 2, 3], [1, 1, 1, 0]),
                         anchors, DET) == pytest.approx(0.45)
    # a confident cover lost at stage 1: b's score 0.8 over 0.25
    assert judge.set_gap(_served(raw, scores, [0, 3], [1, 0]),
                         anchors, DET) == pytest.approx(0.55)
    # a kept box dropped after stage 2: b's score 0.8 over 0.35
    assert judge.set_gap(_served(raw, scores, [0, 2, 3], [1, 0, 0]),
                         anchors, DET) == pytest.approx(0.45)
    # the low box kept: 0.3 under conf_second by 0.05
    assert judge.set_gap(_served(raw, scores, [0, 2, 3], [1, 1, 1]),
                         anchors, DET) == pytest.approx(0.05)
    # the neighbour picked in a's place (their scores tie under
    # rounding): the reading is the score a leads it by
    assert judge.set_gap(_served(raw, scores, [1, 2, 3], [1, 1, 0]),
                         anchors, DET) == pytest.approx(0.05)
