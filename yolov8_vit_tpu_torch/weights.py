"""Parameters: flax-layout trees <-> port modules, engine dirs, init.

A parameter tree is the JAX package's layout: nested dicts keyed by flax
scope names, leaves numpy arrays or tensors (conv kernels HWIO, Dense
kernels (in, out), pre-quantized dense layers {kernel_i8, w_scale, bias}).
Port modules name their buffers after the same paths, so loading is a
walk over `named_modules()`; the only layout change is HWIO <-> OIHW for
the modules that list a leaf in `hwio_leaves`.

Engine directories (`meta.json` + `params.msgpack`, as the JAX package's
`runtime/engine.py::save_engine` writes them) are read and written with a
small codec of the msgpack subset flax emits, so the port needs neither
`msgpack` nor `ml_dtypes`: ndarray leaves are msgpack extension type 1
holding (shape, dtype name, raw bytes), and bfloat16 leaves go from and
to their uint16 bits as torch.bfloat16.

Loading keeps a floating leaf's dtype (f32 or bf16): a module loaded from
a bf16-stored engine computes from bf16 parameters, as the JAX package
does with the same engine.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np
import torch
from torch import nn

from yolov8_vit_tpu_torch.ops.quant import (MLP_AND_ATTN_SUFFIXES,
                                            MLP_SUFFIXES, prequantize_tree)


# ---- msgpack (the subset flax.serialization.to_bytes writes) -------------
class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _read_obj(r: _Reader):
    tag = r.unpack(">B")
    if tag <= 0x7F:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0x80 <= tag <= 0x8F:
        return _read_map(r, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return [_read_obj(r) for _ in range(tag & 0x0F)]
    if 0xA0 <= tag <= 0xBF:
        return bytes(r.take(tag & 0x1F)).decode()
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if tag in simple:
        return simple[tag]
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d"}
    if tag in ints:
        return r.unpack(ints[tag])
    lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
            0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
            0xDC: ">H", 0xDD: ">I",                  # array
            0xDE: ">H", 0xDF: ">I",                  # map
            0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}      # ext
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if tag in fixext:
        return _read_ext(r.unpack(">b"), bytes(r.take(fixext[tag])))
    if tag not in lens:
        raise ValueError(f"unsupported msgpack tag 0x{tag:02x}")
    n = r.unpack(lens[tag])
    if tag in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(n))
    if tag in (0xD9, 0xDA, 0xDB):
        return bytes(r.take(n)).decode()
    if tag in (0xDC, 0xDD):
        return [_read_obj(r) for _ in range(n)]
    if tag in (0xDE, 0xDF):
        return _read_map(r, n)
    code = r.unpack(">b")
    return _read_ext(code, bytes(r.take(n)))


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read_obj(r)
        out[key] = _read_obj(r)
    return out


def _read_ext(code: int, payload: bytes):
    if code not in (1, 3):          # 1 ndarray, 3 numpy scalar
        raise ValueError(f"unsupported msgpack extension type {code}")
    shape, dtype, raw = _read_obj(_Reader(payload))
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        t = torch.frombuffer(bytearray(raw), dtype=torch.int16)
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype)).copy())
    t = t.reshape(tuple(shape))
    return t if code == 1 else t[()]


def read_msgpack(data: bytes):
    """Decode flax.serialization.to_bytes output into a tree of tensors."""
    r = _Reader(data)
    tree = _read_obj(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


def read_engine(path: str):
    """An engine directory -> (meta dict, parameter tree of CPU tensors)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        tree = read_msgpack(f.read())
    return meta, tree


def _pack(obj, out: list) -> None:
    def head(fix: int, fix_max: int, tags: tuple, n: int) -> None:
        if n <= fix_max:
            out.append(struct.pack(">B", fix | n))
            return
        for tag, fmt in tags:
            if n < 1 << (8 * struct.calcsize(fmt)):
                out.append(struct.pack(">B" + fmt[1:], tag, n))
                return
        raise ValueError(f"msgpack length {n} too large")

    if isinstance(obj, dict):
        head(0x80, 15, ((0xDE, ">H"), (0xDF, ">I")), len(obj))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        head(0x90, 15, ((0xDC, ">H"), (0xDD, ">I")), len(obj))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        raw = obj.encode()
        head(0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")), len(raw))
        out.append(raw)
    elif isinstance(obj, bytes):
        head(0xC4, -1, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")), len(obj))
        out.append(obj)
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        if obj <= 0x7F:
            out.append(struct.pack(">B", obj))
        else:
            head(0, -1, ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                         (0xCF, ">Q")), obj)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        t = torch.as_tensor(obj).detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            arr = t.numpy()
            name, raw = arr.dtype.name, arr.tobytes()
        payload: list = []
        _pack([list(t.shape), name, raw], payload)
        data = b"".join(payload)
        n = len(data)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(struct.pack(">Bb", fixext[n], 1))
        else:
            head(0, -1, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")), n)
            out.append(struct.pack(">b", 1))
        out.append(data)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def write_msgpack(tree) -> bytes:
    """A tree of dicts with tensor / ndarray leaves -> the bytes
    flax.serialization.to_bytes writes for it."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def save_engine(path: str, kind: str, params: dict, meta: dict,
                param_dtype=None) -> str:
    """Write an engine directory the JAX package's `Engine` (and the
    port's) loads: meta.json with `kind`, params.msgpack.  As the JAX
    `save_engine`: param_dtype="bfloat16" stores every floating leaf in
    bf16 (integer leaves untouched) and records `param_store_dtype`."""
    os.makedirs(path, exist_ok=True)
    meta = dict(meta, kind=kind)
    if param_dtype is not None:
        if str(param_dtype).replace("torch.", "") != "bfloat16":
            raise ValueError(f"param_dtype {param_dtype!r}: only bfloat16")
        meta["param_store_dtype"] = "bfloat16"

        def walk(node):          # sorted keys, as jax.tree.map returns
            if isinstance(node, dict):
                return {k: walk(node[k]) for k in sorted(node)}
            t = as_tensor(node)
            return t.to(torch.bfloat16) if t.is_floating_point() else t

        params = walk(params)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(write_msgpack(params))
    return path


# ---- tree <-> modules ----------------------------------------------------
def as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":     # ml_dtypes arrays from JAX trees
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


_KEPT_FLOAT = (torch.float32, torch.bfloat16)


def _tree_leaves(mod: nn.Module):
    """`mod`'s own tree leaves: its parameter buffers (the derived,
    non-persistent ones are not in the tree) and, in a model's training
    form (`ViTClassifier.train_form`, `YOLOv8.train_form`), its
    nn.Parameters."""
    return list(mod.named_parameters(recurse=False)) + [
        (n, b) for n, b in mod.named_buffers(recurse=False)
        if n not in mod._non_persistent_buffers_set]


def leaves_to_parameters(module: nn.Module) -> nn.Module:
    """A model's training form, in place: every tree leaf (persistent
    buffer) becomes an f32 nn.Parameter, the derived non-persistent
    buffers are dropped, and each submodule with a `live` flag sets it, so
    its forward reads the leaves themselves and autograd reaches them."""
    for mod in module.modules():
        for name in list(mod._buffers):
            t = mod._buffers.pop(name)
            if name not in mod._non_persistent_buffers_set:
                mod.register_parameter(name,
                                       nn.Parameter(t.to(torch.float32)))
        mod._non_persistent_buffers_set.clear()
        if hasattr(mod, "live"):
            mod.live = True
    return module


def load_tree(module: nn.Module, tree: dict) -> nn.Module:
    """Copy a flax-layout tree into `module`'s buffers, on their device,
    then let the module make its derived buffers (`module.prepare()`,
    where it has one).  A floating buffer takes the leaf's dtype when that
    is f32 or bf16 (stored dtypes are kept, as JAX keeps them); other
    leaves, and every leaf loaded into an nn.Parameter, are cast to the
    buffer's or parameter's dtype.  Strict: a missing or extra
    leaf, or a shape mismatch, raises."""
    flat = {".".join(p): v for p, v in _leaves(tree)}
    used = set()
    for mod_name, mod in module.named_modules():
        hwio = getattr(mod, "hwio_leaves", ())
        for name, buf in _tree_leaves(mod):
            key = f"{mod_name}.{name}" if mod_name else name
            if key not in flat:
                raise KeyError(f"parameter tree lacks {key.replace('.', '/')}")
            t = as_tensor(flat[key])
            if name in hwio:
                t = t.permute(3, 2, 0, 1)
            if tuple(t.shape) != tuple(buf.shape):
                raise ValueError(f"{key}: tree shape {tuple(t.shape)} vs "
                                 f"module {tuple(buf.shape)}")
            if buf.is_floating_point() and t.dtype in _KEPT_FLOAT \
                    and t.dtype != buf.dtype \
                    and not isinstance(buf, nn.Parameter):
                mod._buffers[name] = t.to(buf.device, copy=True)
            else:
                with torch.no_grad():
                    buf.copy_(t.to(buf.dtype))
            used.add(key)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"parameter tree leaves the module does not have: "
                       f"{extra[:5]}")
    if hasattr(module, "prepare"):
        module.prepare()
    return module


def module_tree(module: nn.Module) -> dict:
    """`module`'s tree leaves as a flax-layout tree of CPU tensors."""
    tree: dict = {}
    for mod_name, mod in module.named_modules():
        hwio = getattr(mod, "hwio_leaves", ())
        for name, buf in _tree_leaves(mod):
            t = buf.detach().cpu().clone()
            if name in hwio:
                t = t.permute(2, 3, 1, 0).contiguous()
            node = tree
            for part in (mod_name.split(".") if mod_name else []):
                node = node.setdefault(part, {})
            node[name] = t
    return tree


def load_pipeline_tree(pipeline, tree: dict):
    """Load a two-stage tree {"det": {"params"}, "vit": {"params"}}."""
    load_tree(pipeline.det, tree["det"]["params"])
    load_tree(pipeline.vit, tree["vit"]["params"])
    return pipeline


# ---- port-native init -----------------------------------------------------
def _reset(module: nn.Module, gen: torch.Generator) -> None:
    for mod in module.modules():
        if hasattr(mod, "reset"):
            mod.reset(gen)


def init_tree(pipeline, seed: int = 0) -> dict:
    """Random two-stage parameters made on the CPU from `seed`, with flax's
    initializers (truncated lecun-normal kernels, zero biases, the detect
    head's bias priors, N(0, .02) pos-embed).  For a w8 / w8a ViT the
    weights are drawn in f32 and then pre-quantized (prequantize_tree with
    the MLP suffixes, and the attention ones for w8a), as a real engine is
    built: an int8 tree initialized directly would hold all-zero kernels.
    "none" and "dynamic" share the float layout."""
    from yolov8_vit_tpu_torch.models.vit import ViTClassifier
    from yolov8_vit_tpu_torch.models.yolov8 import YOLOv8
    gen = torch.Generator().manual_seed(seed)
    det = YOLOv8(pipeline.det.spec)
    _reset(det, gen)
    spec = pipeline.vit_spec
    vit = ViTClassifier(dataclasses.replace(spec, quant="none"),
                        pipeline.num_classes)
    _reset(vit, gen)
    vit_tree = module_tree(vit)
    if spec.quant == "w8a":
        vit_tree = prequantize_tree(vit_tree, MLP_AND_ATTN_SUFFIXES)
    elif spec.quant == "w8":
        vit_tree = prequantize_tree(vit_tree, MLP_SUFFIXES)
    return {"det": {"params": module_tree(det)}, "vit": {"params": vit_tree}}
