"""mt::mlp_block's count (benchmark/counts/mlp_block.py) at b8f.bulk32's
fused step, and its two readers on hand-built traces: a traced call gives
its roofline share and device ms a step, a trace without the operator
(the program before it, or another cell) gives None."""
from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.counts import flops, mlp_block
from benchmark.trace import Trace

METRICS = harness.HERE / "metrics"
D, H, ROWS = 768, 3072, 64 * 785
# the argument shapes the profiler records for one call at the cell's
# fused step: x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps
DIMS = [[64, 785, D], [D], [D], [D, H], [H], [H, D], [D], []]


def _read(name: str, trace: Trace):
    mod = harness.load_module(METRICS / f"{name}.py", f"t_{name}")
    return mod.read({"trace": trace})


def test_a_call_at_the_cell_is_474_1_gflop():
    ops, nbytes = mlp_block.mlp_block(DIMS)
    assert ops["bf16"] / 1e9 == pytest.approx(474.1, abs=0.05)
    # bytes: x in, out and the weights in bf16 (about 0.16 GB), far below
    # the operations' 0.48 ms
    assert nbytes / 1e9 == pytest.approx(0.164, abs=0.002)
    assert flops.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.4794,
                                                             abs=1e-4)


def _trace(with_op: bool) -> Trace:
    """One fused step (a `bench.det` range) and, where `with_op`, one
    mt::mlp_block call whose three kernels take 300 + 400 + 260 us."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0.0, "dur": 10000.0, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "bench.det",
           "ts": 10.0, "dur": 50.0, "tid": 1}]
    if with_op:
        ev.append({"ph": "X", "cat": "cpu_op", "name": "mt::mlp_block",
                   "ts": 100.0, "dur": 50.0, "tid": 1,
                   "args": {"Input Dims": DIMS}})
    for i, dur in enumerate((300.0, 400.0, 260.0)):
        ev += [{"ph": "X", "cat": "kernel", "name": f"k{i}",
                "ts": 200.0 + 1000 * i, "dur": dur, "tid": 7,
                "args": {"correlation": i}},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": 110.0 + 10 * i, "dur": 5.0, "tid": 1,
                "args": {"correlation": i}}]
    return Trace(ev)


def test_readers_of_a_traced_call():
    t = _trace(True)
    assert _read("mlp_block.device_ms", t) == pytest.approx(0.96)
    bound = flops.bound_s(*mlp_block.mlp_block(DIMS))
    assert _read("mlp_block_roofline", t) == pytest.approx(
        100 * bound / 960e-6)


def test_readers_without_the_operator_read_none():
    t = _trace(False)
    assert _read("mlp_block.device_ms", t) is None
    assert _read("mlp_block_roofline", t) is None
