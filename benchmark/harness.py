"""The benchmark's harness: finds a cell's configuration, traffic mix,
driver, limits and per-layer readers by the names in BENCHMARK.json, runs
one measured window, checks the outputs against the plain reference and
prints the result line.

Everything that belongs to one configuration, mix, metric or cell is a
file of its own, found by name:

  configs/<config>.json        sizes, precision, source (BENCHMARK.json
                               names the file)
  traffic/<mix>.json           the mix's parameters; "driver" names the
                               general generator that reads them
  drivers/<driver>.py          setup(ctx) -> state, window(ctx, state),
                               check(ctx, state) -> readings, trace_slice
  metrics/<metric>.py          read(rec) -> float | None (an end-to-end
                               metric `<quantity>.<qualifier>` is the
                               driver's <quantity>, in the cells it names)
  limits/<cell>.json           the limit of each reading that decides
                               `correct`
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level modules that may not be loaded in a run (compared whole: the
# port, yolov8_vit_tpu_torch, is not the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "yolov8_vit_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """Names of loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(manifest: dict, workload: str, root: Path = ROOT) -> dict:
    """Everything one cell needs, found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(root / configs[cell["config"]]["file"]) as f:
        cfg = json.load(f)
    bench = root / "benchmark"
    with open(bench / "traffic" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    driver = load_module(bench / "drivers" / f"{mix['driver']}.py",
                         f"bench_driver_{mix['driver']}")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in manifest["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"] if applies(m)
             and m["moves"] in e2e_names]
    readers = {m["name"]: load_module(bench / "metrics" / f"{m['name']}.py",
                                      f"bench_metric_{m['name']}")
               for m in layer}
    limits_path = bench / "limits" / f"{workload}.json"
    limits = None
    if limits_path.exists():
        with open(limits_path) as f:
            limits = json.load(f)
    return {"cell": cell, "cfg": cfg, "mix": mix, "driver": driver,
            "end_to_end": e2e, "per_layer": layer, "readers": readers,
            "limits": limits}


class Ctx:
    """One run's settings and its record of set-up."""

    def __init__(self, res: dict, seed: int, seconds: float, trace: bool,
                 device: str, t0: float):
        self.cell, self.cfg, self.mix = res["cell"], res["cfg"], res["mix"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.split: dict[str, float] = {}
        self._last = t0

    def mark(self, stage: str) -> None:
        """Close one stage of set-up (printed on an earlier line)."""
        now = time.perf_counter()
        self.split[stage] = self.split.get(stage, 0.0) + now - self._last
        self._last = now

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def judge(readings: dict, limits: dict | None) -> tuple[bool, dict]:
    """correct iff every reading lies within its limit; {name: {value,
    limit}} in the order of the limits file."""
    if limits is None:
        return False, {k: {"value": v, "limit": None}
                       for k, v in readings.items()}
    out = {}
    ok = set(readings) >= set(limits)
    for name, lim in limits.items():
        v = readings.get(name)
        out[name] = {"value": v, "limit": lim}
        ok &= v is not None and v <= lim
    return bool(ok), out


def device_info(device: str) -> dict:
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def smi() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(res: dict, seed: int, seconds: float, trace: bool,
             device: str, t0: float) -> dict:
    """One run of one cell: set-up, window, check, readers.  Returns the
    result object (without the import check)."""
    ctx = Ctx(res, seed, seconds, trace, device, t0)
    drv = res["driver"]
    state = drv.setup(ctx)
    try:
        return _measure(ctx, res, state, t0)
    finally:
        if hasattr(drv, "close"):
            drv.close(state)


def _measure(ctx, res: dict, state, t0: float) -> dict:
    import torch
    drv, device, seconds = res["driver"], ctx.device, ctx.seconds
    trace = ctx.trace
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_win = time.perf_counter()
    setup_s = t_win - t0
    win = drv.window(ctx, state)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    rec = None
    if trace:
        rec = drv.trace_slice(ctx, state, win)
    t_check = time.perf_counter()
    readings = drv.check(ctx, state, win)
    ctx.log(f"check: {time.perf_counter() - t_check:.2f} s")
    correct, checks = judge(readings, res["limits"])
    if trace:
        metrics = {}
        for m in res["per_layer"]:
            v = res["readers"][m["name"]].read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {}
        for m in res["end_to_end"]:
            # `<quantity>.<qualifier>`: the driver's quantity, reported by
            # a group of cells under a bound of its own
            v = setup_s if m["name"] == "setup_s" else win["e2e"].get(
                m["name"], win["e2e"].get(m["name"].split(".")[0]))
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = dict(device_info(device), memory_peak_bytes=int(peak))
    out = {"correct": correct, "attempted": int(win["attempted"]),
           "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if trace and rec is not None:
        dev["busy_s"] = rec["device_trace"].busy_s
        dev["window_s"] = rec["device_trace"].window_s
        out["breakdown"] = rec["trace"].breakdown()
    ctx.log("setup split (s): " + json.dumps(
        {k: round(v, 4) for k, v in ctx.split.items()})
        + f"; setup_s {setup_s:.4f}; run_seconds {seconds}")
    for line in win.get("notes", []):
        ctx.log(line)
    out["checks"] = checks
    return out


def write_bytes_note() -> str:
    """The bytes this process has written so far (/proc/self/io)."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
        return f"bytes written by this process: {int(io['write_bytes'])}"
    except (OSError, KeyError, ValueError):
        return "bytes written by this process: unknown"


def main(argv, t0: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_manifest()
    res = resolve(manifest, args.workload)
    import torch
    need = res["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {smi()}; peaks: {json.dumps(peaks())}", file=sys.stderr,
          flush=True)
    out = run_cell(res, args.seed, args.seconds, bool(args.trace), "cuda",
                   t0)
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(write_bytes_note(), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def peaks() -> dict:
    with open(HERE / "counts" / "peaks.json") as f:
        return json.load(f)
