"""Multi-process initialization (PyTorch port of the JAX package's
`parallel/distributed.py`).

One process per device joins a torch.distributed process group; every
process contributes its rank to one global mesh, and the same sharded
functions (parallel/sharding.py, the trainers, the batch runner) run
unchanged.  The coordinator address, process count and process id come
from the arguments or from the JAX package's environment names
(JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID); without an
address, torch's own environment (MASTER_ADDR, MASTER_PORT, RANK,
WORLD_SIZE, as torchrun sets them) is read.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from yolov8_vit_tpu_torch import _build
from yolov8_vit_tpu_torch.parallel.mesh import make_mesh


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, device="cuda") -> None:
    """Join (or bootstrap) the process group: nccl on the card, gloo for
    device="cpu".  `coordinator_address` is host:port
    (a TCP rendezvous on it) or an init-method URL (tcp://, file://).  On
    the card each process takes device process_id mod the card count.
    Call once per process before building a mesh."""
    dev = _build.resolve_device(device)
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    kwargs = {}
    if addr:
        kwargs["init_method"] = addr if "://" in addr else f"tcp://{addr}"
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if dev.type == "cuda":
        torch.cuda.set_device((process_id or 0) % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            **kwargs)


def global_mesh(n_model: int = 1):
    """Mesh over every process of the group (call after init_multihost)."""
    return make_mesh(n_model=n_model)


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0, or
    the only process when there is no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0
