"""As device.idle.bulk.py, for the cells that report frames_per_s.vitb8."""
from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("device.idle.bulk.py"),
                   "bench_metric_device.idle.bulk").read
