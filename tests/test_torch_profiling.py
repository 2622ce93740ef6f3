"""PyTorch port, utils/profiling.py against the JAX package's: StepTimer's
summary on the same recorded times, device_barrier's sum of the same tree
(integer-valued, so the two packages' f32 sums are exact), and the
torch.profiler trace."""
import json
import os

import numpy as np
import pytest
import jax.numpy as jnp

from yolov8_vit_tpu.utils import profiling as jprof

import torch
from yolov8_vit_tpu_torch.utils import profiling


@pytest.mark.parametrize("seed", [0, 1])
def test_step_timer_summary_matches_jax(seed):
    rng = np.random.default_rng(seed)
    times = {name: rng.uniform(1e-4, 0.5, int(rng.integers(1, 40))).tolist()
             for name in ("decode", "step", "fetch")}
    got, want = profiling.StepTimer(), jprof.StepTimer()
    for name, ts in times.items():
        for t in ts:
            got.record(name, t)
            want.record(name, t)
    g, w = got.summary(), want.summary()
    assert g == w
    assert set(g["step"]) == {"count", "mean_ms", "p50_ms", "p95_ms"}


def test_step_timer_stage_with_barrier():
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer.stage("work", barrier_tree={"x": torch.ones(4)}):
            torch.ones(16).sum()
    s = timer.summary()["work"]
    assert s["count"] == 3 and 0 <= s["p50_ms"] <= s["p95_ms"]


def test_device_barrier_matches_jax():
    rng = np.random.default_rng(2)
    leaves = {"b": rng.integers(-50, 50, (7, 3)).astype(np.float32),
              "a": [rng.integers(0, 9, (5,)).astype(np.int32),
                    (rng.integers(-3, 3, (2, 2)).astype(np.float32),)],
              "c": {"z": np.float32(4.0), "y": rng.integers(
                  0, 100, (11,)).astype(np.float32)}}
    want = jprof.device_barrier(
        {"b": jnp.asarray(leaves["b"]),
         "a": [jnp.asarray(leaves["a"][0]), (jnp.asarray(leaves["a"][1][0]),)],
         "c": {"z": jnp.asarray(leaves["c"]["z"]),
               "y": jnp.asarray(leaves["c"]["y"])}})
    got = profiling.device_barrier(
        {"b": torch.from_numpy(leaves["b"]),
         "a": [torch.from_numpy(leaves["a"][0]),
               (torch.from_numpy(leaves["a"][1][0]),)],
         "c": {"z": torch.tensor(4.0), "y": torch.from_numpy(
             leaves["c"]["y"])}})
    assert isinstance(got, float) and got == want
    assert profiling.device_barrier(()) == 0.0


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        x = torch.randn(64, 64)
        (x @ x).sum()
    with open(os.path.join(tmp_path, "tr", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
