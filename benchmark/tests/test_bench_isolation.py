"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from benchmark import harness

YARDSTICK = ("reference", "counts", "judge.py", "scenes.py", "weights.py")


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_loaded({"yolov8_vit_tpu_torch": 1,
                                     "yolov8_vit_tpu_torch.ops": 1,
                                     "jaxtyping": 1, "flaxen": 1}) == []
    assert harness.forbidden_loaded({"yolov8_vit_tpu.ops": 1, "jax": 1,
                                     "jaxlib.xla": 1, "flax": 1}) == [
        "flax", "jax", "jaxlib.xla", "yolov8_vit_tpu.ops"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_yardstick_sources_import_nothing_of_the_program():
    bench = harness.HERE
    files = []
    for name in YARDSTICK:
        p = bench / name
        files += sorted(p.rglob("*.py")) if p.is_dir() else [p]
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("yolov8_vit_tpu_torch", *harness.FORBIDDEN), \
                f"{f.name} imports {mod}"


def test_no_source_of_the_benchmark_imports_jax():
    for f in sorted(harness.HERE.rglob("*.py")):
        for mod in _imports(f):
            assert mod.split(".")[0] not in harness.FORBIDDEN, f


def test_reference_process_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.pipeline, benchmark.judge, "
            "benchmark.scenes, benchmark.weights, benchmark.counts.flops\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('yolov8_vit_tpu_torch', 'yolov8_vit_tpu', 'jax', 'jaxlib', "
            "'flax')]\n"
            "print(bad); sys.exit(1 if bad else 0)" % str(harness.ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_a_cpu_run_of_a_cell_loads_no_forbidden_module():
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from benchmark.tests.tiny import tiny\n"
            "from benchmark import harness\n"
            "import torch; torch.set_num_threads(2)\n"
            "res = tiny('b16w8a.bulk32')\n"
            "out = harness.run_cell(res, 7, 0.3, False, 'cpu', "
            "time.perf_counter())\n"
            "bad = harness.forbidden_loaded()\n"
            "print(bad); sys.exit(1 if bad else 0)" % str(harness.ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
