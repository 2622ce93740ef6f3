"""Host fingerprints for compiled engine artifacts.

A compiled blob (`attach_compiled`'s AOTInductor package, runtime/
engine.py) is machine code for the place it was built: for "cuda", kernels
generated for one card's compute capability by one PyTorch, CUDA and
Triton, and loaded through that PyTorch's C++ runtime; for "cpu", C++
compiled for the build host's vector instructions.  `attach_compiled`
records `host_fingerprint()` beside each blob (`<blob>.host.json`), and
`Engine` refuses, when it scans the directory, a blob whose fingerprint is
not `compatible` with this host's, instead of risking a failed load or an
illegal instruction at the first call.  (The JAX package's counterpart is
yolov8_vit_tpu/utils/hostinfo.py.)
"""
from __future__ import annotations

import platform

# fingerprint keys that must equal between the build host and this one
_CUDA_KEYS = ("device_name", "capability", "torch", "cuda", "triton")


def cpu_flags() -> list[str]:
    """Sorted ISA feature flags of the running host (x86 `flags` / arm64
    `Features` lines of /proc/cpuinfo); [] where unreadable, which makes
    every CPU blob compatible rather than refusing one falsely."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.split(":")[0].strip().lower() in ("flags",
                                                          "features"):
                    return sorted(set(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return []


def _triton_version() -> str | None:
    try:
        import triton
    except ImportError:
        return None
    return triton.__version__


def host_fingerprint(platform_name: str, device=None) -> dict:
    """What a compiled blob built here for `platform_name` ("cuda" or
    "cpu") depends on.  cuda: the card's name and compute capability
    (`device`, default the current one), torch's and CUDA's versions and
    Triton's where it is installed; cpu: the architecture and its ISA
    flags, and torch's version."""
    import torch
    fp: dict = {"platform": platform_name, "machine": platform.machine(),
                "torch": torch.__version__}
    if platform_name == "cpu":
        fp["cpu_flags"] = cpu_flags()
    else:
        dev = torch.device("cuda") if device is None else torch.device(device)
        fp["device_name"] = torch.cuda.get_device_name(dev)
        fp["capability"] = list(torch.cuda.get_device_capability(dev))
        fp["cuda"] = torch.version.cuda
        fp["triton"] = _triton_version()
    return fp


def compatible(blob_fp: dict, host_fp: dict) -> bool:
    """Can a blob built under `blob_fp` run under `host_fp`?  cpu: the same
    architecture and torch, and the build host's ISA flags a subset of this
    host's; cuda: the same card name, compute capability, torch, CUDA and
    Triton."""
    if blob_fp.get("platform") != host_fp.get("platform") \
            or blob_fp.get("machine") != host_fp.get("machine"):
        return False
    if blob_fp.get("platform") == "cpu":
        return blob_fp.get("torch") == host_fp.get("torch") and \
            set(blob_fp.get("cpu_flags", ())) <= \
            set(host_fp.get("cpu_flags", ()))
    return all(blob_fp.get(k) == host_fp.get(k) for k in _CUDA_KEYS)
