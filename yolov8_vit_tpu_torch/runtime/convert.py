"""Checkpoint converters: PyTorch state dicts -> parameter trees.

The counterpart of the JAX package's `runtime/convert.py`, with the same
functions and the same trees out (`{"params": ...}`, flax names, Dense
kernels (in, out), conv kernels (kh, kw, in, out)), so that
`weights.load_tree`, `load_pipeline_tree` and `save_engine` take them
unchanged and an engine written from them equals the JAX package's.

Source layouts:
  * timm `vit_*` in the reference's `Network_Wrapper` (state-dict names
    `model.*` + `fc.1` / `fc.3`) -> ViTClassifier params.
  * ultralytics YOLOv8 `model.{idx}.*` detection checkpoints -> YOLOv8
    params in the fused-BN layout, with conv + BN folded as ultralytics
    fuses them at export:
      W' = W * g / sqrt(var + eps),  b' = beta - g * mean / sqrt(var + eps)
    with eps = 1e-3 (ultralytics' BatchNorm setting), computed in numpy
    f32 in the JAX package's order of operations.

The conversion is host work in numpy; only `load_torch_state_dict` calls
torch, to read the file.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np


def load_torch_state_dict(path: str,
                          allow_pickle: bool = False) -> dict[str, np.ndarray]:
    """Load a .pt / .pth file into {name: float32 ndarray}.

    Tries the safe `weights_only=True` loader first.  Full unpickling
    (which executes code from the file, e.g. ultralytics .pt checkpoints
    that pickle whole nn.Modules) requires `allow_pickle=True`, to be set
    only for trusted sources.  Accepts a module, a module's `state_dict()`
    and ultralytics' `{"model": module}` form."""
    import torch

    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise ValueError(
                f"{path} is not loadable with weights_only=True; pass "
                "allow_pickle=True only if the checkpoint source is trusted "
                "(unpickling executes arbitrary code)")
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "model" in obj \
            and hasattr(obj["model"], "state_dict"):
        obj = obj["model"].float().state_dict()
    return {k: np.asarray(v.detach().float().numpy()) for k, v in obj.items()
            if hasattr(v, "detach")}


def _t(w: np.ndarray) -> np.ndarray:
    """torch Linear (out, in) -> Dense kernel (in, out)."""
    return np.ascontiguousarray(w.T)


def _conv(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (out, in, kh, kw) -> conv kernel (kh, kw, in, out)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


# ---- ViT (timm names inside Network_Wrapper) ----------------------------
def convert_vit_wrapper(sd: Mapping[str, np.ndarray], depth: int = 12) -> dict:
    """`Network_Wrapper(timm_vit).state_dict()` -> ViTClassifier params."""
    def g(k):
        return np.asarray(sd[k])

    model: dict = {
        "patch_embed": {"kernel": _conv(g("model.patch_embed.proj.weight")),
                        "bias": g("model.patch_embed.proj.bias")},
        "cls_token": g("model.cls_token"),
        "pos_embed": g("model.pos_embed"),
        "norm": {"scale": g("model.norm.weight"), "bias": g("model.norm.bias")},
        "head": {"kernel": _t(g("model.head.weight")),
                 "bias": g("model.head.bias")},
    }
    for i in range(depth):
        p = f"model.blocks.{i}"
        model[f"block{i}"] = {
            "norm1": {"scale": g(f"{p}.norm1.weight"),
                      "bias": g(f"{p}.norm1.bias")},
            "attn": {
                "qkv": {"kernel": _t(g(f"{p}.attn.qkv.weight")),
                        "bias": g(f"{p}.attn.qkv.bias")},
                "proj": {"kernel": _t(g(f"{p}.attn.proj.weight")),
                         "bias": g(f"{p}.attn.proj.bias")},
            },
            "norm2": {"scale": g(f"{p}.norm2.weight"),
                      "bias": g(f"{p}.norm2.bias")},
            "mlp_fc1": {"kernel": _t(g(f"{p}.mlp.fc1.weight")),
                        "bias": g(f"{p}.mlp.fc1.bias")},
            "mlp_fc2": {"kernel": _t(g(f"{p}.mlp.fc2.weight")),
                        "bias": g(f"{p}.mlp.fc2.bias")},
        }
    return {"params": {
        "model": model,
        "fc1": {"kernel": _t(g("fc.1.weight")), "bias": g("fc.1.bias")},
        "fc2": {"kernel": _t(g("fc.3.weight")), "bias": g("fc.3.bias")},
    }}


# ---- YOLOv8 (ultralytics names), conv + BN folding -----------------------
_BN_EPS = 1e-3  # ultralytics Conv BatchNorm eps


def _fold_conv_bn(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    """`{prefix}.conv` + `{prefix}.bn` -> fused conv {kernel, bias}."""
    w = np.asarray(sd[f"{prefix}.conv.weight"])
    gkey = f"{prefix}.bn.weight"
    if gkey in sd:
        gamma = np.asarray(sd[gkey])
        beta = np.asarray(sd[f"{prefix}.bn.bias"])
        mean = np.asarray(sd[f"{prefix}.bn.running_mean"])
        var = np.asarray(sd[f"{prefix}.bn.running_var"])
        scale = gamma / np.sqrt(var + _BN_EPS)
        w = w * scale[:, None, None, None]
        b = beta - mean * scale
    else:  # an already fused source (the conv has a bias)
        b = np.asarray(sd.get(f"{prefix}.conv.bias",
                              np.zeros(w.shape[0], np.float32)))
    return {"conv": {"kernel": _conv(w), "bias": b}}


def _plain_conv(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    w = np.asarray(sd[f"{prefix}.weight"])
    b = np.asarray(sd.get(f"{prefix}.bias", np.zeros(w.shape[0], np.float32)))
    return {"kernel": _conv(w), "bias": b}


def _convert_c2f(sd, src: str) -> dict:
    out = {"cv1": _fold_conv_bn(sd, f"{src}.cv1"),
           "cv2": _fold_conv_bn(sd, f"{src}.cv2")}
    j = 0
    while f"{src}.m.{j}.cv1.conv.weight" in sd:
        out[f"m{j}"] = {"cv1": _fold_conv_bn(sd, f"{src}.m.{j}.cv1"),
                        "cv2": _fold_conv_bn(sd, f"{src}.m.{j}.cv2")}
        j += 1
    return out


# ultralytics layer index -> the model's module name (yolov8 detect yaml)
_LAYER_MAP = {
    0: ("b0", "conv"), 1: ("b1", "conv"), 2: ("b2", "c2f"),
    3: ("b3", "conv"), 4: ("b4", "c2f"), 5: ("b5", "conv"),
    6: ("b6", "c2f"), 7: ("b7", "conv"), 8: ("b8", "c2f"),
    9: ("b9", "sppf"),
    12: ("n12", "c2f"), 15: ("n15", "c2f"), 16: ("n16", "conv"),
    18: ("n18", "c2f"), 19: ("n19", "conv"), 21: ("n21", "c2f"),
}


def convert_yolov8(sd: Mapping[str, np.ndarray]) -> dict:
    """ultralytics `model.{idx}.*` detect state dict -> YOLOv8 params
    (fused-BN layout).  An extra wrapping prefix (`model.model.0.`) is
    taken off."""
    if not any(re.match(r"model\.\d+\.", k) for k in sd):
        sd = {re.sub(r"^model\.", "", k): v for k, v in sd.items()}
    params: dict = {}
    for idx, (name, kind) in _LAYER_MAP.items():
        src = f"model.{idx}"
        if kind == "conv":
            params[name] = _fold_conv_bn(sd, src)
        elif kind == "c2f":
            params[name] = _convert_c2f(sd, src)
        else:
            params[name] = {"cv1": _fold_conv_bn(sd, f"{src}.cv1"),
                            "cv2": _fold_conv_bn(sd, f"{src}.cv2")}
    det = {}
    for i in range(3):
        det[f"box{i}_0"] = _fold_conv_bn(sd, f"model.22.cv2.{i}.0")
        det[f"box{i}_1"] = _fold_conv_bn(sd, f"model.22.cv2.{i}.1")
        det[f"box{i}_2"] = _plain_conv(sd, f"model.22.cv2.{i}.2")
        det[f"cls{i}_0"] = _fold_conv_bn(sd, f"model.22.cv3.{i}.0")
        det[f"cls{i}_1"] = _fold_conv_bn(sd, f"model.22.cv3.{i}.1")
        det[f"cls{i}_2"] = _plain_conv(sd, f"model.22.cv3.{i}.2")
    params["detect"] = det
    return {"params": params}
