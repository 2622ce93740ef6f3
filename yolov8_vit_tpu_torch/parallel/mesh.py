"""Process meshes over torch.distributed (PyTorch port of the JAX
package's `parallel/mesh.py`).

PyTorch's idiom is one process per device: a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the process
group, with dimensions ("data", "model"):

  * "data": batches split by rows (inference and both trainers);
  * "model": the ViT's Megatron tensor parallelism (parallel/sharding.py).

The collectives are written out where the JAX package leaves them to XLA's
partitioner (sharding.py, the trainers, serve/batch_runner.py).  The mesh's
device type follows the group's backend: "cuda" under nccl, "cpu" under
gloo (which also carries CUDA tensors, as for two processes on one card).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from yolov8_vit_tpu_torch import _build

AXES = ("data", "model")


def ensure_group(device="cuda") -> None:
    """A process group of world size 1 when none exists (nccl for the
    card, gloo for "cpu"); an existing group is left as it is."""
    if dist.is_initialized():
        return
    dev = _build.resolve_device(device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def _mesh(grid: torch.Tensor, names) -> DeviceMesh:
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, grid, mesh_dim_names=tuple(names))


def _grid(n_data: int | None, n_model: int, devices, device) -> torch.Tensor:
    if devices is None:
        ensure_group(device)
        devices = range(dist.get_world_size())
    devices = list(devices)
    n = len(devices)
    if n_data is None:
        if n % n_model:
            raise ValueError(
                f"n_model={n_model} does not divide the {n} available "
                f"devices; pass n_data explicitly to subset deliberately")
        n_data = n // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > n:
        raise ValueError(f"mesh {n_data}x{n_model} does not fit "
                         f"{n} devices")
    ensure_group(device)
    return torch.tensor(devices[:n_data * n_model]).reshape(n_data, n_model)


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None,
              device="cuda") -> DeviceMesh:
    """A (data, model) mesh over the ranks `devices` (default: every rank
    of the group, all on the data axis; a smaller n_data subsets
    deliberately).  Raises ValueError, as the JAX package does, where
    n_model does not divide the ranks, the mesh does not fit them, or a
    dimension is below 1.  Without a process group, one of world size 1
    is made first (`ensure_group(device)`)."""
    return _mesh(_grid(n_data, n_model, devices, device), AXES)


def mesh_from_config(cfg, devices=None, device="cuda") -> DeviceMesh:
    """Mesh from a `config.MeshConfig`: its tensor-parallel degree and
    axis names (the data axis takes the remaining ranks)."""
    grid = _grid(None, cfg.model_parallel, devices, device)
    return _mesh(grid, (cfg.data_axis, cfg.model_axis))


def local_mesh(device="cuda") -> DeviceMesh:
    """The world as it stands: every rank on the data axis (a world of 1
    when no process group exists)."""
    return make_mesh(device=device)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the ranks that share every coordinate of this
    rank but `axis`'s."""
    return mesh.get_group(axis)
