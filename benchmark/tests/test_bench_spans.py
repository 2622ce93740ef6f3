"""The readers of the program's spans (`runner.*`, `train.*`) on a
hand-built trace: known spans give known readings, absent spans give
None; and a traced run of each cell on the CPU at a tiny size, where the
program opens them."""
from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny
from benchmark.trace import Trace

METRICS = harness.HERE / "metrics"
SPAN_METRICS = [m["name"] for m in harness.load_manifest()["per_layer"]
                if m["source"] == "program_span"]


def _read(name: str, trace: Trace):
    mod = harness.load_module(METRICS / f"{name}.py", f"t_{name}")
    return mod.read({"trace": trace})


def _host(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def _kernel(corr, ts, dur=5.0):
    return [{"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
             "dur": dur, "tid": 7, "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": ts - 3.0, "dur": 1.0, "tid": 1,
             "args": {"correlation": corr}}]


def _bulk_trace(with_spans: bool = True) -> Trace:
    """Two steps: enqueue 100 + 140 us; drains 300 + 500 us holding waits
    of 200 + 250 us; 7 device operations (one a memcpy); a span before the
    window, which no reader counts."""
    ev = [_host("bench.window", 1000.0, 5000.0),
          _host("runner.enqueue", 10.0, 999.0)]
    if with_spans:
        ev += [_host("runner.enqueue", 1100.0, 100.0),
               _host("runner.enqueue", 1300.0, 140.0),
               _host("runner.drain", 2000.0, 300.0),
               _host("runner.wait", 2010.0, 200.0),
               _host("runner.unpack", 2220.0, 50.0),
               _host("runner.drain", 3000.0, 500.0),
               _host("runner.wait", 3010.0, 250.0),
               _host("runner.ladder", 3300.0, 100.0)]
    ev += [e for i in range(6) for e in _kernel(i, 1150.0 + 100 * i)]
    ev += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
            "ts": 1900.0, "dur": 20.0, "tid": 7,
            "args": {"correlation": 99}}]
    return Trace(ev)


def _train_trace(with_spans: bool = True) -> Trace:
    """Three steps of 2, 3 and 4 ms; four data fetches of 0.5 ms (the last
    finds the loader spent); 12 kernels."""
    ev = [_host("bench.window", 0.0, 20000.0)]
    if with_spans:
        for i, dur in enumerate((2000.0, 3000.0, 4000.0)):
            ev += [_host("train.data", 5000.0 * i, 500.0),
                   _host("train.step", 5000.0 * i + 600.0, dur),
                   _host("train.forward", 5000.0 * i + 700.0, 300.0)]
        ev.append(_host("train.data", 15000.0, 500.0))
    ev += [e for i in range(12) for e in _kernel(i, 800.0 + 1000 * i)]
    return Trace(ev)


@pytest.mark.parametrize("suffix", ["", ".vitb8"])
def test_runner_readings(suffix):
    tr = _bulk_trace()
    assert _read("runner.launch_ms" + suffix, tr) == pytest.approx(0.12)
    # (0.3 + 0.5 - 0.2 - 0.25) ms over 2 steps
    assert _read("runner.drain_ms" + suffix, tr) == pytest.approx(0.175)
    assert _read("runner.kernels" + suffix, tr) == pytest.approx(3.5)


def test_train_readings():
    tr = _train_trace()
    assert _read("train.data_ms", tr) == pytest.approx(2.0 / 3.0)
    assert _read("train.step_host_ms", tr) == pytest.approx(3.0)
    assert _read("train.kernels", tr) == pytest.approx(4.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_absent_spans_read_none(name):
    """A program without the spans (the benchmark over an older program)
    reads None, not 0, and does not raise."""
    for tr in (_bulk_trace(False), _train_trace(False)):
        assert _read(name, tr) is None


def test_every_span_metric_has_a_reader_and_a_test():
    assert len(SPAN_METRICS) == 9
    for name in SPAN_METRICS:
        assert (METRICS / f"{name}.py").exists()


@pytest.mark.parametrize("workload", [
    w["name"] for w in harness.load_manifest()["workloads"]])
def test_traced_cpu_run_reads_the_spans(workload):
    """A traced run of the tiny cell on the CPU: every span reader of the
    cell that needs no device operation reads a number."""
    res = tiny(workload)
    out = harness.run_cell(res, 2 ** 31 + 5, 0.3, True, "cpu",
                           time.perf_counter())
    got = out["metrics"]
    names = {m["name"] for m in res["per_layer"]
             if m["source"] == "program_span"}
    assert names
    for name in names:
        if "kernels" in name:
            assert name not in got          # no device operation on a CPU
        else:
            assert got[name]["value"] > 0.0, name
