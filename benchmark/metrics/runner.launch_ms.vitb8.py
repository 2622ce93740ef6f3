"""As runner.launch_ms.py, for the cells that report frames_per_s.vitb8."""
from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("runner.launch_ms.py"),
                   "bench_metric_runner.launch_ms").read
