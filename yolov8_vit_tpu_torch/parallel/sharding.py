"""Sharding rules: batch data parallelism and the ViT's tensor
parallelism (PyTorch port of the JAX package's `parallel/sharding.py`).

  * batches split by rows over the mesh's "data" axis (`shard_batch`);
  * the ViT's attention (qkv, proj) and MLP (fc1, fc2) weights split over
    the "model" axis, Megatron-style: qkv and fc1 column-parallel (output
    features), proj and fc2 row-parallel (input features), every other
    parameter replicated (`vit_param_sharding`).

A placement is the JAX PartitionSpec's entries as a tuple: one entry a
dimension, "model" where that dimension is split, None where it is not;
() replicates.  XLA inserts the collectives for the JAX package; here
`tensor_parallel` swaps the four dense layers of each block for forms
that hold their shard and run the collectives themselves (an all-reduce
of the row-parallel outputs forward, of the column-parallel inputs'
gradients backward).  qkv packs q | k | v along its output features, so
its shard takes the same heads from each of the three (`_PACKED`): a
plain column split would give the first rank all of q and part of k.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from yolov8_vit_tpu_torch.models.vit import Dense
from yolov8_vit_tpu_torch.parallel.mesh import (axis_group, axis_index,
                                                axis_size)


def _tree_map(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """fn(path, leaf) over dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def shard_batch(mesh, x: Any) -> Any:
    """This rank's rows of each array in `x` (leading batch dim), split
    over the data axis; a batch that does not divide raises."""
    n, r = axis_size(mesh, "data"), axis_index(mesh, "data")

    def put(_path, a):
        a = torch.as_tensor(a)
        if a.shape[0] % n:
            raise ValueError(f"batch {a.shape[0]} does not divide over the "
                             f"data axis ({n})")
        m = a.shape[0] // n
        return a[r * m:(r + 1) * m]
    return _tree_map(put, x)


def replicate(mesh, x: Any) -> Any:
    """Every array of `x` (tensors, in place) set to the mesh's first
    rank's: broadcast along the data axis, then along the model axis."""
    def put(_path, a):
        a = torch.as_tensor(a)
        for axis in mesh.mesh_dim_names:
            if axis_size(mesh, axis) > 1:
                dist.broadcast(a, group=axis_group(mesh, axis), group_src=0)
        return a
    return _tree_map(put, x)


# --- ViT tensor-parallel rules ---------------------------------------------
# path suffix -> placement of the leaf (the JAX package's _VIT_TP_RULES)
_VIT_TP_RULES: list[tuple[tuple[str, ...], tuple]] = [
    (("attn", "qkv", "kernel"), (None, "model")),
    (("attn", "qkv", "bias"), ("model",)),
    (("attn", "proj", "kernel"), ("model", None)),
    (("mlp_fc1", "kernel"), (None, "model")),
    (("mlp_fc1", "bias"), ("model",)),
    (("mlp_fc2", "kernel"), ("model", None)),
]
# layers whose split dimension packs several parts (q | k | v): each part
# is split alike, so a rank holds whole heads of each
_PACKED = {("attn", "qkv"): 3}


def _placement(path: tuple) -> tuple:
    for suffix, spec in _VIT_TP_RULES:
        if tuple(path[-len(suffix):]) == suffix:
            return spec
    return ()


def vit_param_sharding(mesh, params: Any) -> Any:
    """Placement tree for ViT params: the TP rules above, the rest
    replicated (`mesh` is taken for the JAX signature)."""
    return _tree_map(lambda path, _a: _placement(path), params)


def _split(a: torch.Tensor, dim: int, parts: int, n: int, r: int):
    """Shard r of n of `a` along `dim`, each of its `parts` split alike."""
    size = a.shape[dim]
    if size % (parts * n):
        raise ValueError(f"dimension {size} does not split into {parts} x "
                         f"{n} shards")
    shape = a.shape[:dim] + (parts, n, size // (parts * n)) + a.shape[dim + 1:]
    out = a.reshape(shape).select(dim + 1, r)
    return out.reshape(a.shape[:dim] + (size // n,) + a.shape[dim + 1:]) \
        .contiguous()


def _join(shards: list, dim: int, parts: int) -> torch.Tensor:
    """Inverse of `_split` over every rank's shard, in rank order."""
    a = shards[0]
    size = a.shape[dim]
    split = [s.reshape(a.shape[:dim] + (parts, size // parts)
                       + a.shape[dim + 1:]) for s in shards]
    out = torch.stack(split, dim + 1)
    return out.reshape(a.shape[:dim] + (size * len(shards),)
                       + a.shape[dim + 1:])


def _parts(path: tuple) -> int:
    return _PACKED.get(tuple(path[-3:-1]), 1)


def _shard_leaf(path: tuple, a: torch.Tensor, place: tuple, n: int,
                r: int) -> torch.Tensor:
    """Shard r of n of leaf `a` at `path` under placement `place`: the
    one place that decides how a leaf is split."""
    if "model" not in place:
        return a
    return _split(a, place.index("model"), _parts(path), n, r)


def _at(tree: Any, path: tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def shard_params(mesh, params: Any, shardings: Any = None) -> Any:
    """Place params: replicated (every leaf broadcast from the first rank)
    and, with `shardings` (`vit_param_sharding`), each leaf placed on
    "model" replaced by this rank's shard of it."""
    params = replicate(mesh, params)
    if shardings is None:
        return params
    n, r = axis_size(mesh, "model"), axis_index(mesh, "model")
    return _tree_map(lambda path, a: _shard_leaf(
        path, a, tuple(_at(shardings, path)), n, r), params)


# --- tensor-parallel layers ------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over the model axis
    backward (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the model axis forward (the partial sums of a
    row-parallel layer); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class ColumnParallelDense(Dense):
    """A Dense of the training form holding a shard of its output
    features (kernel (in, out / n), bias (out / n,))."""

    group = None

    def forward(self, x):
        return _CopyToModel.apply(x, self.group) @ self.kernel + self.bias


class RowParallelDense(Dense):
    """A Dense of the training form holding a shard of its input features
    (kernel (in / n, out)); the bias, replicated, is added once after the
    partial products are summed."""

    group = None

    def forward(self, x):
        return _ReduceFromModel.apply(x @ self.kernel, self.group) + \
            self.bias


_LAYERS = (("attn.qkv", ColumnParallelDense), ("attn.proj", RowParallelDense),
           ("mlp_fc1", ColumnParallelDense), ("mlp_fc2", RowParallelDense))


def tensor_parallel(model, mesh):
    """Split the training form of a `ViTClassifier` (f32 nn.Parameters,
    `train_form`) over the mesh's model axis, in place: every parameter
    is broadcast from the mesh's first rank and the four dense layers of
    each block take their shards (`shard_params` under
    `vit_param_sharding`), so each block keeps heads / n whole heads of
    qkv and proj and hidden / n of the MLP, and runs with
    `ColumnParallelDense` / `RowParallelDense`.  Returns the model;
    `tp_leaves(model)` names each split parameter.  Raises where the heads
    (or the MLP's hidden width) do not divide."""
    n = axis_size(mesh, "model")
    spec = model.model.spec
    if spec.heads % n or int(spec.dim * spec.mlp_ratio) % n:
        raise ValueError(f"{spec.heads} heads and an MLP of "
                         f"{int(spec.dim * spec.mlp_ratio)} do not split "
                         f"over a model axis of {n}")
    layers = [(i, name, cls, getattr(model.model, f"block{i}")
               .get_submodule(name))
              for i in range(spec.depth) for name, cls in _LAYERS]
    if not all(isinstance(layer.kernel, torch.nn.Parameter)
               for *_, layer in layers):
        raise ValueError("tensor_parallel takes the training form "
                         "(ViTClassifier.train_form())")
    tree: dict = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.data
    with torch.no_grad():
        local = shard_params(mesh, tree, vit_param_sharding(mesh, tree))
    local_spec = dataclasses.replace(spec, heads=spec.heads // n)
    group = axis_group(mesh, "model")
    for i in range(spec.depth):
        getattr(model.model, f"block{i}").spec = local_spec
    for i, name, cls, layer in layers:
        path = ("model", f"block{i}", *name.split("."))
        for leaf in ("kernel", "bias"):
            if "model" in _placement(path + (leaf,)):
                setattr(layer, leaf, torch.nn.Parameter(
                    _at(local, path + (leaf,))))
        layer.__class__ = cls
        layer.group = group
    return model


def tp_leaves(model) -> list[str]:
    """Names of the model's parameters split by `tensor_parallel`."""
    out = []
    for name, _p in model.named_parameters():
        layer = model.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(layer, (ColumnParallelDense, RowParallelDense)) \
                and "model" in _placement(tuple(name.split("."))):
            out.append(name)
    return out


def gather_leaf(mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole of split parameter `name` (or a tensor of its shape, a
    momentum buffer) from every rank's shard."""
    place = _placement(tuple(name.split(".")))
    n = axis_size(mesh, "model")
    shards = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(shards, t.detach().contiguous(),
                    group=axis_group(mesh, "model"))
    return _join(shards, place.index("model"), _parts(tuple(name.split("."))))


def split_leaf(mesh, name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the whole tensor `t` of split parameter
    `name`."""
    path = tuple(name.split("."))
    return _shard_leaf(path, t, _placement(path), axis_size(mesh, "model"),
                       axis_index(mesh, "model"))


def reduce_grads(params, group, divide_by: int = 1) -> None:
    """Sum the gradients of `params` over `group` in one all-reduce of
    their concatenation, then divide by `divide_by` (the group's size for
    a mean)."""
    grads = [p.grad for p in params if p.grad is not None]
    if dist.get_world_size(group) == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if divide_by != 1:
        flat /= divide_by
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
