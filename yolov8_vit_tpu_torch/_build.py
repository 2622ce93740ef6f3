"""Build and load the port's CUDA kernels and its host image library.

Each `csrc/*.cu` compiles with nvcc into its own shared library with a
plain C interface, loaded through ctypes.  Builds happen at first use (or
all at once through `build()`), never at import: this module imports on
machines without nvcc or a GPU, where every kernel wrapper runs its plain
PyTorch version on CPU tensors instead.  The host library (`csrc/host/`:
JPEG / PNG / BMP / PPM decode and the letterbox, runtime/native.py)
compiles with the host C++ compiler, with JPEG and PNG decode where
libjpeg and libpng are found (`build_host`).  The native driver
`mt_infer` (`csrc/driver/mt_infer.cc`, the host sources beside it)
compiles with the host C++ compiler against the wheel's libtorch
(`build_driver`): on a machine with the CUDA headers with its CUDA
operators, which open the kernel libraries built here.

The build directory `_build/` beside this file is listed in .gitignore;
library names carry a hash of the sources and flags, so an edited source
never loads a stale library.  nvcc's output, with ptxas's registers,
shared memory and spills of every kernel (`-Xptxas -v`), is kept beside
each library (`build_log`).
"""
from __future__ import annotations

import collections
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
    "conv_silu": "conv_silu.cu",         # kernel K (the detector's ConvBlock)
    "window_attn": "window_attn.cu",     # SwinV2's window attention
    "mlp_block": "mlp_block.cu",         # the float ViT's MLP sub-block
}
HEADERS = ("int8_common.cuh", "hopper.cuh", "sdpa.cuh",
           "gemm_float.cuh")

# -fmad=false: no contracted multiply-adds, so IoU and quantization
# arithmetic rounds exactly as the plain versions do (a contracted FMA
# flips threshold-boundary NMS decisions).  Never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# the host image library (runtime/native.py): sources, compiler flags
HOST_SOURCES = ("host/imgproc.cc", "host/capi.cc")
HOST_HEADERS = ("host/imgproc.h",)
HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
# optional decoders: (macro, library, a program that needs both)
HOST_OPTIONAL = {
    "jpeg": ("MT_WITH_JPEG", "-ljpeg",
             "#include <cstdio>\n#include <jpeglib.h>\n"
             "int main() { jpeg_decompress_struct c; jpeg_error_mgr e;\n"
             "  c.err = jpeg_std_error(&e); jpeg_create_decompress(&c);\n"
             "  jpeg_destroy_decompress(&c); return 0; }\n"),
    "png": ("MT_WITH_PNG", "-lpng",
            "#include <png.h>\n"
            "int main() { return png_sig_cmp(nullptr, 0, 0); }\n"),
}

# the native driver: sources, and the kernel libraries it opens (macro of
# the path each is baked into)
DRIVER_SOURCES = ("driver/mt_infer.cc", "host/imgproc.cc")
DRIVER_LIB_MACROS = {"nms": "MT_LIB_NMS", "quant_mlp": "MT_LIB_QUANT_MLP",
                     "attention": "MT_LIB_ATTENTION",
                     "fused_region": "MT_LIB_FUSED_REGION",
                     "conv_silu": "MT_LIB_CONV_SILU",
                     "mlp_block": "MT_LIB_MLP_BLOCK"}

_libs: dict[str, ctypes.CDLL] = {}
# library -> entry point -> its C function, argtypes and restype set
_entries: collections.defaultdict[str, dict] = collections.defaultdict(dict)


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


def _hashed_path(name: str, flags, files) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _lib_path(name: str) -> str:
    return _hashed_path(name, NVCC_FLAGS, (SOURCES[name],) + HEADERS)


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH")
    return cxx


_host_features: dict | None = None
_openmp_cxx: list = []      # [compiler or None], found once a process


def openmp_cxx() -> str | None:
    """A host C++ compiler that compiles and links an OpenMP program (what
    AOTInductor's generated C++ needs: it adds -fopenmp), or None: $CXX,
    g++ on PATH, /usr/bin/g++, clang++, the first that does.  A compiler
    can lack OpenMP's runtime (a gcc without libgomp.spec, such as a
    toolchain wrapper ahead of the system's g++ on PATH) and still build
    the port's libraries, which use none."""
    if not _openmp_cxx:
        found = None
        seen = set()
        prog = ("#include <omp.h>\nint main() { return "
                "omp_get_max_threads() > 0 ? 0 : 1; }\n").encode()
        for c in (os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++",
                  shutil.which("clang++")):
            if not c or c in seen or not os.path.exists(c):
                continue
            seen.add(c)
            run = subprocess.run([c, "-x", "c++", "-fopenmp", "-", "-o",
                                  os.devnull], input=prog,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            if run.returncode == 0:
                found = c
                break
        _openmp_cxx.append(found)
    return _openmp_cxx[0]


def host_features() -> dict[str, str | None]:
    """{"jpeg": None | why not, "png": ...}: None where a program using
    the library compiles and links here (probed once a process)."""
    global _host_features
    if _host_features is None:
        cxx = _cxx()
        found = {}
        for name, (_macro, lib, prog) in HOST_OPTIONAL.items():
            run = subprocess.run([cxx, "-x", "c++", "-", "-o", os.devnull,
                                  lib], input=prog.encode(),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            lines = run.stdout.decode(errors="replace").strip().splitlines()
            found[name] = None if run.returncode == 0 else \
                (lines[0] if lines else f"exit {run.returncode}")
        _host_features = found
    return _host_features


def _host_flags() -> tuple[list[str], list[str]]:
    """(compiler flags, link libraries) of this machine's host build."""
    flags, libs = list(HOST_FLAGS), []
    for name, missing in host_features().items():
        if missing is None:
            macro, lib, _ = HOST_OPTIONAL[name]
            flags.append(f"-D{macro}")
            libs.append(lib)
    return flags, libs + ["-lpthread"]


def host_lib_path() -> str:
    """Where the host image library is (or will be) built: the name
    hashes the sources and this machine's flags (its optional
    decoders)."""
    flags, libs = _host_flags()
    return _hashed_path("mtnative", flags + libs,
                        HOST_SOURCES + HOST_HEADERS)


def build_host() -> str:
    """Compile the host image library if it is missing; returns its path.
    JPEG and PNG decode are compiled in where libjpeg / libpng are found
    (`host_features`).  The compiler's output is kept beside it
    (`<path>.log`); a failed build raises with that output."""
    out = host_lib_path()
    if os.path.exists(out):
        return out
    flags, libs = _host_flags()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_cxx(), *flags, "-o", tmp,
           *(os.path.join(_CSRC, f) for f in HOST_SOURCES), *libs]
    run = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
    log = run.stdout.decode(errors="replace")
    missing = {k: v for k, v in host_features().items() if v is not None}
    with open(out + ".log", "w") as fh:
        fh.write(" ".join(cmd) + "\n" + log
                 + "".join(f"without {k}: {v}\n" for k, v in missing.items()))
    if run.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                           f"({run.returncode}):\n{log}")
    os.replace(tmp, out)
    return out


def cuda_include() -> str | None:
    """The CUDA toolkit's include directory where this torch is a CUDA
    build and the headers are installed, else None."""
    inc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                       "include")
    if torch.version.cuda is None or not os.path.exists(
            os.path.join(inc, "cuda_runtime_api.h")):
        return None
    return inc


def driver_schemas_header() -> str:
    """mt_schemas.h: the mt operators' schemas (ops/library.py SCHEMAS,
    their one source) as the driver's TORCH_LIBRARY definitions."""
    from yolov8_vit_tpu_torch.ops.library import NAMESPACE, SCHEMAS
    defs = "".join(f'  m.def("{name}{schema}"); \\\n'
                   for name, schema in SCHEMAS.items())
    names = ", ".join(f'"{NAMESPACE}::{n}"' for n in SCHEMAS)
    return ("// generated by yolov8_vit_tpu_torch/_build.py from "
            "ops/library.py SCHEMAS\n#pragma once\n"
            f"#define MT_DEFINE_OPS(m) \\\n{defs}\n"
            f"static const char* const kMtOps[] = {{{names}}};\n")


def _driver_flags() -> tuple[list[str], list[str]]:
    """(compiler flags, link flags) of the driver on this machine: with
    the CUDA operators where `cuda_include()` finds the headers (the
    kernel libraries' paths baked in as macros, so they are built
    first), without them elsewhere."""
    tdir = os.path.dirname(torch.__file__)
    inc, lib_dir = os.path.join(tdir, "include"), os.path.join(tdir, "lib")
    host, host_libs = _host_flags()
    flags = ["-O2", "-std=c++17", "-fPIC", "-w",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             "-I", inc, "-I", os.path.join(inc, "torch", "csrc", "api",
                                           "include"),
             "-I", os.path.join(_CSRC, "host"), "-I", BUILD_DIR]
    flags += [f for f in host if f.startswith("-D")]
    torch_libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    cuda_inc = cuda_include()
    if cuda_inc is not None:
        build()
        flags += ["-DMT_WITH_CUDA", "-I", cuda_inc]
        flags += [f'-D{macro}="{_lib_path(name)}"'
                  for name, macro in DRIVER_LIB_MACROS.items()]
        torch_libs += ["-ltorch_cuda", "-lc10_cuda"]
    link = ["-L", lib_dir, f"-Wl,-rpath,{lib_dir}", "-Wl,--no-as-needed",
            *torch_libs, "-Wl,--as-needed", *host_libs, "-ldl"]
    return flags, link


def build_driver() -> str:
    """Compile the native driver `mt_infer` if it is missing; returns its
    path (`_build/mt_infer-<hash>`, the hash over its sources, the
    generated schema header and the flags).  On a machine with the CUDA
    headers the kernel libraries are built first and their paths baked in.
    The compiler's output is kept beside it (`<path>.log`); a failed build
    raises with that output."""
    header = driver_schemas_header()
    flags, link = _driver_flags()
    h = hashlib.sha256(" ".join(flags + link).encode() + header.encode())
    for f in DRIVER_SOURCES + HOST_HEADERS:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    out = os.path.join(BUILD_DIR, f"mt_infer-{h.hexdigest()[:16]}")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "mt_schemas.h"), "w") as fh:
        fh.write(header)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_cxx(), *flags, "-o", tmp,
           *(os.path.join(_CSRC, f) for f in DRIVER_SOURCES), *link]
    run = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
    log = run.stdout.decode(errors="replace")
    with open(out + ".log", "w") as fh:
        fh.write(" ".join(cmd) + "\n" + log)
    if run.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                           f"({run.returncode}):\n{log}")
    os.replace(tmp, out)
    return out


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


def launch(lib_name: str, entry: str, argtypes, *args, what: str) -> None:
    """Call the C entry point `entry` of library `lib_name` on `args` and
    the current stream, its last argument.  `argtypes` are the arguments'
    ctypes types without the stream's, set with the int return at the
    entry's first call.  Raises when the launch returned a CUDA error
    (refused launches never run, and a later synchronize would not report
    them)."""
    fn = _entries[lib_name].get(entry)
    if fn is None:
        fn = getattr(lib(lib_name), entry)
        fn.argtypes = (*argtypes, ctypes.c_void_p)
        fn.restype = ctypes.c_int
        _entries[lib_name][entry] = fn
    rc = fn(*args, stream_ptr())
    if rc != 0:
        msg = lib(lib_name).kernel_error_string(rc).decode()
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


def require_cuda(*tensors) -> None:
    """A kernel's launcher (an operator's CUDA implementation, which the
    dispatcher picks when any tensor is on the card): every tensor on one
    CUDA device, else ValueError."""
    kinds = {t.device.type for t in tensors}
    if kinds != {"cuda"}:
        raise ValueError(f"a kernel takes tensors on the card only; got "
                         f"{sorted(kinds)}")


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
