"""As step_mfu.py, for the cells that report frames_per_s.vitb8."""
from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("step_mfu.py"),
                   "bench_metric_step_mfu").read
