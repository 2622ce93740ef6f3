"""Spans around the program's layers and the reduction of a profiler trace.

Spans: forward hooks on a module open a `torch.profiler.record_function`
range named `bench.<layer>` for the module's forward; the traced slice
runs inside `bench.window`.  The program's `torch.library` operators
appear in the trace as `mt::<op>` ranges by themselves.

A device operation (kernel, copy, memset) is attributed to the ranges
open on the host thread when it was launched (linked through the launch's
correlation id), so a kernel renamed inside an operator still counts for
that operator.  Busy time is the union of the device operations'
intervals within the window, not their sum.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class SpanHooks:
    """record_function ranges `bench.<name>` around each module's forward,
    and the batch rows each call saw."""

    def __init__(self, modules: dict):
        import torch
        self._rf = torch.profiler.record_function
        self.calls: dict[str, list[int]] = defaultdict(list)
        self._open: dict[str, list] = defaultdict(list)
        for name, mod in modules.items():
            mod.register_forward_pre_hook(self._pre(name))
            mod.register_forward_hook(self._post(name))

    def _pre(self, name):
        def hook(_mod, args):
            rows = args[0].shape[0] if args and hasattr(args[0], "shape") \
                else 0
            self.calls[name].append(int(rows))
            rf = self._rf(f"bench.{name}")
            rf.__enter__()
            self._open[name].append(rf)
        return hook

    def _post(self, name):
        def hook(_mod, _args, _out):
            self._open[name].pop().__exit__(None, None, None)
        return hook

    def reset(self) -> None:
        self.calls.clear()


class Trace:
    """The reduced trace of one window."""

    def __init__(self, events: list, wall_s: float | None = None):
        """events: the chrome trace's; the window is the `bench.window`
        range, or, for a device-only trace, `wall_s` of host time
        around all of its device operations."""
        win = [e for e in events if e.get("name") == "bench.window"
               and e.get("cat") == "user_annotation"]
        if win:
            self.t0 = float(win[0]["ts"])
            self.t1 = self.t0 + float(win[0]["dur"])
        else:
            dev = [e for e in events if e.get("cat") in DEVICE_CATS]
            if wall_s is None or not dev:
                raise ValueError("trace holds no bench.window range")
            self.t0 = min(float(e["ts"]) for e in dev)
            self.t1 = self.t0 + wall_s * 1e6
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get(
                    "args", {}):
                launch[e["args"]["correlation"]] = (float(e["ts"]), e["tid"])
        ranges = defaultdict(list)          # tid -> [(ts, end, name, id)]
        self.op_calls = []                  # mt:: calls: (name, dims)
        for e in events:
            name = e.get("name", "")
            if e.get("ph") != "X":
                continue
            if (e.get("cat") == "user_annotation" and name.startswith("bench.")
                    and name != "bench.window") or (
                    e.get("cat") == "cpu_op" and name.startswith("mt::")):
                ts = float(e["ts"])
                rid = len(self.op_calls)
                self.op_calls.append(
                    (name, e.get("args", {}).get("Input Dims")))
                ranges[e["tid"]].append((ts, ts + float(e["dur"]), name, rid))
        self.device = []      # (ts, dur, name, cat, frozenset of range ids)
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            corr = e.get("args", {}).get("correlation")
            self.device.append([float(e["ts"]), float(e["dur"]), e["name"],
                                e["cat"], launch.get(corr)])
        self._attribute(ranges)
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") != "bench.window")

    def _attribute(self, ranges: dict) -> None:
        by_tid = defaultdict(list)
        for i, d in enumerate(self.device):
            if d[4] is not None:
                by_tid[d[4][1]].append((d[4][0], i))
        for d in self.device:
            d[4] = frozenset()
        for tid, launches in by_tid.items():
            rs = sorted(ranges.get(tid, []))
            launches.sort()
            j, active = 0, []
            for ts, i in launches:
                while j < len(rs) and rs[j][0] <= ts:
                    active.append(rs[j])
                    j += 1
                active = [r for r in active if r[1] >= ts]
                self.device[i][4] = frozenset(r[3] for r in active)

    # ---- readings ------------------------------------------------------
    def in_window(self):
        return [d for d in self.device if d[0] + d[1] > self.t0
                and d[0] < self.t1]

    def _union(self):
        iv = sorted((max(d[0], self.t0), min(d[0] + d[1], self.t1))
                    for d in self.in_window())
        merged = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._union()) / 1e6

    def kernel_us(self, span: str) -> float:
        """Device time of kernels launched inside range `span`."""
        ids = {i for i, (n, _) in enumerate(self.op_calls) if n == span}
        return sum(d[1] for d in self.in_window()
                   if d[3] == "kernel" and d[4] & ids)

    def span_count(self, span: str) -> int:
        return sum(1 for n, _ in self.op_calls if n == span)

    def op_time_by_call(self, op: str) -> list[tuple[list, float]]:
        """[(input dims, device us)] of each call of operator `op` whose
        kernels the trace holds."""
        per = defaultdict(float)
        want = {i for i, (n, _) in enumerate(self.op_calls) if n == op}
        for d in self.in_window():
            if d[3] == "kernel":
                for i in d[4] & want:
                    per[i] += d[1]
        return [(self.op_calls[i][1], us) for i, us in per.items()]

    def breakdown(self) -> dict:
        tot = defaultdict(float)
        for d in self.in_window():
            tot[d[2]] += d[1] / 1e6
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
        merged = self._union()
        gaps = [(merged[k][1], merged[k + 1][0])
                for k in range(len(merged) - 1)]
        if merged:
            gaps = [(self.t0, merged[0][0])] + gaps + [(merged[-1][1],
                                                        self.t1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[self._host_at((a + b) / 2), (b - a) / 1e6]
                              for a, b in gaps]}

    def _host_at(self, t: float) -> str:
        """The innermost host range open at time t."""
        best = None
        for a, b, name in self.host:
            if a > t:
                break
            if b >= t and (best is None or a >= best[0]):
                best = (a, name)
        return best[1][:160] if best else "host: no traced range"


@contextlib.contextmanager
def profiled(device: str, host: bool = True):
    """Profile the block inside a `bench.window` range; yields a dict whose
    "trace" is the reduced Trace after exit.  With `host`, the host's
    operators with their input shapes too (spans, operators, breakdown);
    without, the device alone, and the window is the block's host time:
    the host then runs nearly as it does untraced, so the idle share is
    read from this form."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] if host or device == "cpu" else []
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    box: dict = {}
    with profile(activities=acts, record_shapes=host) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.window"):
            yield box
            if device != "cpu":
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    box["trace"] = Trace(events, None if host else wall)
