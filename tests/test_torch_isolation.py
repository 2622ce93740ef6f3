"""The PyTorch port stands alone: no module of `yolov8_vit_tpu_torch`, and
not its root scripts (chip_smoke.py, kernel_cost.py), imports jax, flax or
the JAX package, or a package the GPU machine lacks (msgpack, ml_dtypes,
cv2, requests); PIL only inside functions (host decode).  Checked
statically with `ast`, and by importing every module in a subprocess
whose sys.modules poisons those names."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "yolov8_vit_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "yolov8_vit_tpu", "msgpack",
             "ml_dtypes", "cv2", "optax", "orbax", "requests"}


ROOT_SCRIPTS = ("chip_smoke.py", "kernel_cost.py")


def _port_files():
    out = [os.path.join(REPO, f) for f in ROOT_SCRIPTS]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return out


def _imports(tree):
    """(top-level module name, at module scope?) for every import."""
    scoped = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                scoped.add(id(sub))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            yield n.split(".")[0], id(node) not in scoped


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for top, module_scope in _imports(tree):
        assert top not in FORBIDDEN, f"{path} imports {top}"
        if top == "PIL":
            assert not module_scope, f"{path} imports PIL at module scope"


def test_import_all_with_jax_poisoned():
    mods = sorted(
        "yolov8_vit_tpu_torch." + os.path.relpath(p, PKG)[:-3]
        .replace(os.sep, ".").replace(".__init__", "")
        for p in _port_files()[len(ROOT_SCRIPTS):])
    code = "\n".join([
        "import sys, importlib",
        f"for name in {sorted(FORBIDDEN)!r}:",
        "    sys.modules[name] = None",
        f"sys.path.insert(0, {REPO!r})",
        f"for m in {mods!r}:",
        "    importlib.import_module(m.removesuffix('.__init__'))",
        "import chip_smoke, kernel_cost",
        "leaked = [m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r} and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('OK', len(sys.modules))",
    ])
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert run.returncode == 0 and "OK" in run.stdout, run.stderr[-3000:]


def test_chip_smoke_alone_refuses(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script exits non-zero and prints no result line."""
    import shutil
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert run.returncode != 0
    assert '"ok": true' not in run.stdout
