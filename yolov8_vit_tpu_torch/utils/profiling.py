"""Tracing and step timing (PyTorch port of the JAX package's
`utils/profiling.py`):

  * `span(name)`: a named range of the program (the runner's and the
    classifier trainer's steps) on the profiler's clock while a profiler
    runs, and nothing otherwise;
  * `trace(log_dir)`: a torch.profiler session (CPU and, where there is a
    card, CUDA activity) written as a Chrome trace into `log_dir`, the
    spans beside the device's kernels and copies;
  * `StepTimer`: per-stage wall times with count / mean / p50 / p95;
  * `device_barrier(tree)`: wait for the CUDA devices of the tree's
    tensors and return the float sum of the tree.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np
import torch


_NULL = contextlib.nullcontext()


class _Timed:
    """A span that also adds its elapsed ms to `acc[key]`."""

    __slots__ = ("_rf", "_acc", "_key", "_t0")

    def __init__(self, rf, acc: dict, key: str):
        self._rf, self._acc, self._key = rf, acc, key

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._acc[self._key] = self._acc.get(self._key, 0.0) + \
            (time.perf_counter() - self._t0) * 1e3
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, acc: dict | None = None, key: str | None = None):
    """Context manager over one step of a layer.  While a profiler runs it
    is a `torch.profiler.record_function(name)` range, on the clock of the
    device's kernels and copies in the same trace; otherwise it calls
    nothing in torch.profiler (a shared null context), and under
    torch.compile it does nothing.  With `acc`, the block's wall time in
    ms is also added to `acc[key]` (the runner's `profile` dict)."""
    if torch.compiler.is_compiling():
        return _NULL
    rf = torch.profiler.record_function(name) \
        if torch.autograd._profiler_enabled() else None
    if acc is not None:
        return _Timed(rf, acc, key)
    return _NULL if rf is None else rf


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; writes `<log_dir>/trace.json` (Chrome trace)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _leaves(tree):
    """Leaves in the JAX package's tree order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def device_barrier(tree) -> float:
    """Block until every CUDA tensor in `tree` has finished computing (a
    synchronize of each of their devices; of the current device when the
    tree holds no CUDA tensor and CUDA is in use) and return the tree's
    sum: each leaf summed to f32, the leaves added in f32 in tree order."""
    total = torch.zeros((), dtype=torch.float32)
    devices = set()
    for leaf in _leaves(tree):
        t = torch.as_tensor(leaf)
        if t.is_cuda:
            devices.add(t.device)
        total = total + t.sum(dtype=torch.float32).cpu()
    if not devices and torch.cuda.is_initialized():
        devices.add(torch.device("cuda", torch.cuda.current_device()))
    for dev in devices:
        torch.cuda.synchronize(dev)
    return float(total)


class StepTimer:
    """Accumulate per-stage wall times; report percentiles."""

    def __init__(self):
        self._times: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, barrier_tree=None):
        t0 = time.perf_counter()
        yield
        if barrier_tree is not None:
            device_barrier(barrier_tree)
        self._times[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._times[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, ts in self._times.items():
            arr = np.asarray(ts)
            out[name] = {
                "count": int(arr.size),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
            }
        return out
