#!/usr/bin/env python3
"""Readings from which a cell's limits are set: for each seed, the
program's readings over a short window at the cell's own size and load,
and the control's (the reference one precision step below the
configuration, put in the program's place over the same frames).

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 \
        [--seconds 2] [--control-seeds 3]

Prints one JSON line a seed and side, each with `correct` as the
committed limits (limits/<cell>.json) judge it, then the largest program
reading and the smallest control reading of each number.  Exits 1 if a
program reading fails its limit or a control passes them all.  Not run
by the benchmark's own runs.  Needs a CUDA device.
"""
import time

T0 = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def readings(res: dict, seeds, seconds: float, control_seeds: int,
             device: str) -> dict:
    """{"program": [readings a seed], "control": [...]}."""
    drv = res["driver"]
    out = {"program": [], "control": []}
    for i, seed in enumerate(seeds):
        ctx = harness.Ctx(res, seed, seconds, False, device,
                          time.perf_counter())
        state = drv.setup(ctx)
        win = drv.window(ctx, state)
        r = drv.check(ctx, state, win)
        ok, _ = harness.judge(r, res["limits"])
        print(json.dumps({"side": "program", "seed": seed, "correct": ok,
                          **r}), flush=True)
        out["program"].append(dict(r, correct=ok))
        if i < control_seeds:
            c = drv.control(ctx, state)
            # judged on the numbers it has (the program's own counts, such
            # as frames missing, are not the control's)
            ok, _ = harness.judge(c, {k: v for k, v in res["limits"].items()
                                      if k in c})
            print(json.dumps({"side": "control", "seed": seed,
                              "correct": ok, **c}), flush=True)
            out["control"].append(dict(c, correct=ok))
        if hasattr(drv, "close"):
            drv.close(state)
        del state
    return out


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args()
    res = harness.resolve(harness.load_manifest(), args.workload)
    print(f"card: {harness.smi()}", flush=True)
    out = readings(res, args.seeds, args.seconds, args.control_seeds, "cuda")
    keys = [k for k in out["program"][0] if k != "correct"]
    print(json.dumps({
        "program_max": {k: max(r[k] for r in out["program"]) for k in keys},
        "control_min": {k: min(r[k] for r in out["control"])
                        for k in (out["control"][0] if out["control"]
                                  else ()) if k != "correct"},
        "program_correct": [r["correct"] for r in out["program"]],
        "control_correct": [r["correct"] for r in out["control"]]}))
    sound = all(r["correct"] for r in out["program"])
    return 0 if sound and not any(r["correct"] for r in out["control"]) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
