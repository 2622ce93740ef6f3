"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` compiles with nvcc into its own shared library with a
plain C interface, loaded through ctypes.  Builds happen at first use (or
all at once through `build()`), never at import: this module imports on
machines without nvcc or a GPU, where every kernel wrapper runs its plain
PyTorch version on CPU tensors instead.

The build directory `_build/` beside this file is listed in .gitignore;
library names carry a hash of the sources and flags, so an edited source
never loads a stale library.  nvcc's output, with ptxas's registers,
shared memory and spills of every kernel (`-Xptxas -v`), is kept beside
each library (`build_log`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# one shared library per TPU kernel's source
SOURCES = {
    "nms": "nms.cu",                     # kernels A, B and I
    "quant_mlp": "quant_mlp.cu",         # kernels C, G and H
    "attention": "attention.cu",         # kernels D, E and F
    "fused_region": "fused_region.cu",   # kernel J
}
HEADERS = ("int8_common.cuh", "hopper.cuh", "sdpa.cuh",
           "gemm_float.cuh")

# -fmad=false: no contracted multiply-adds, so IoU and quantization
# arithmetic rounds exactly as the plain versions do (a contracted FMA
# flips threshold-boundary NMS decisions).  Never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=None) -> float:
    """Compile every missing library (one nvcc process per source, all
    started together).  Returns the wall seconds spent; raises with
    nvcc's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        out = _lib_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, SOURCES[n])]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, out, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"nvcc {SOURCES[n]} failed ({p.returncode}):\n"
                          f"{log}")
        else:
            with open(out + ".log", "w") as fh:
                fh.write(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output for library `name` (built first if needed)."""
    build([name])
    with open(_lib_path(name) + ".log") as fh:
        return fh.read()


def lib(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    if name not in _libs:
        build([name])
        so = ctypes.CDLL(_lib_path(name))
        so.kernel_error_string.argtypes = [ctypes.c_int]
        so.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = so
    return _libs[name]


def check(so: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (refused launches never
    run, and a later synchronize would not report them)."""
    if rc != 0:
        msg = so.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's `device` argument.  Asking for the
    card where there is none raises: nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cpu(*tensors) -> bool:
    """Wrapper dispatch: True -> plain version (every tensor on the CPU);
    False -> kernel (every tensor on one CUDA device); anything else
    raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")
