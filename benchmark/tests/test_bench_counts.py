"""The operation counts against the published figures."""
from __future__ import annotations

import json

import pytest

from benchmark import harness
from benchmark.counts import flops


def _cfg(name):
    man = harness.load_manifest()
    file = {c["name"]: c["file"] for c in man["configs"]}[name]
    return json.loads((harness.ROOT / file).read_text())


def test_yolov8s_at_640_is_28_6_gflop():
    g = flops.detector_flops(_cfg("yolov8s-vitb16-w8a")["detector"]) / 1e9
    assert g == pytest.approx(28.6, rel=0.03)


@pytest.mark.parametrize("name, gflop", [("yolov8s-vitb16-w8a", 35.1),
                                         ("yolov8s-vitb8-float", 156.0)])
def test_vit_per_crop(name, gflop):
    v = flops.vit_flops(_cfg(name)["vit"])
    assert sum(v.values()) / 1e9 == pytest.approx(gflop, rel=0.03)


def test_kernel_bounds_of_the_main_path_shapes():
    # kernel C at 64 crops x 197 tokens: operations bound, 0.060 ms
    ops, nbytes = flops.quant_mlp_ln([[64 * 197, 768], [768], [768],
                                      [768, 3072]])
    assert flops.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.060, rel=0.02)
    ops, nbytes = flops.attn_block_i8([[64, 197, 768]])
    assert flops.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.038, rel=0.05)
    ops, nbytes = flops.attn_block([[64, 785, 768]])
    assert flops.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.362, rel=0.02)


def test_ideal_time_grows_with_the_work():
    cfg = _cfg("yolov8s-vitb16-w8a")
    one = flops.ideal_s(cfg, 32, 64)
    assert flops.ideal_s(cfg, 64, 128) == pytest.approx(2 * one)
    assert flops.ideal_s(cfg, 32, 0) < one
