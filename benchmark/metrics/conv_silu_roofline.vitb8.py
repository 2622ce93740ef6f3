"""As conv_silu_roofline.py, for the cells that report
frames_per_s.vitb8."""
from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("conv_silu_roofline.py"),
                   "bench_metric_conv_silu_roofline").read
