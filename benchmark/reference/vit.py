"""Plain ViT classifier: timm's VisionTransformer (pre-norm blocks, LN eps
1e-6, cls token, learned position embedding, final LN on the cls token,
the 1000-way head) under the inspection model's head ReLU -> 1000 -> 128
-> ReLU -> 5 (the reference `utils/utils.py` classifier).  Weights are a
flat dict keyed by the flax-layout tree's paths joined with '.'.

Precision is the caller's choice of `mode`:
  "f32"   every product in float32 (TF32 off, set by the caller);
  "w8a"   the int8 deployment: qkv, proj, fc1 and fc2 with weights
          symmetric int8 per output channel (scale amax / 127) and
          activations symmetric int8 per row, products exact, GELU in
          its tanh form; everything else float32;
  "w4a"   the same at 4 bits (scale amax / 7): the control below w8a;
  "fp8"   the control below bfloat16 for a float model: both operands
          of every block GEMM cut to fp8 e4m3, one scale a tensor, exact
          GELU.
The int8 weights are derived here from the float ones, never taken from
the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.yolov8 import fake_fp8

LN_EPS = 1e-6


def param_shapes(cfg: dict, num_classes: int = 5, hidden: int = 128) -> dict:
    """{path: (shape, init)} of the classifier's float tree."""
    v = cfg
    d, p = v["dim"], v["patch"]
    tokens = (v["img_size"] // p) ** 2 + 1
    mlp = int(d * v["mlp_ratio"])
    s: dict = {"model.patch_embed.kernel": ((p, p, 3, d), "lecun"),
               "model.patch_embed.bias": ((d,), "zeros"),
               "model.cls_token": ((1, 1, d), "zeros"),
               "model.pos_embed": ((1, tokens, d), ("normal", 0.02))}

    def dense(name, fin, fout):
        s[f"{name}.kernel"] = ((fin, fout), "lecun")
        s[f"{name}.bias"] = ((fout,), "zeros")

    def norm(name):
        s[f"{name}.scale"] = ((d,), "ones")
        s[f"{name}.bias"] = ((d,), "zeros")

    for i in range(v["depth"]):
        b = f"model.block{i}"
        norm(f"{b}.norm1")
        dense(f"{b}.attn.qkv", d, 3 * d)
        dense(f"{b}.attn.proj", d, d)
        norm(f"{b}.norm2")
        dense(f"{b}.mlp_fc1", d, mlp)
        dense(f"{b}.mlp_fc2", mlp, d)
    norm("model.norm")
    dense("model.head", d, v["backbone_classes"])
    dense("fc1", v["backbone_classes"], hidden)
    dense("fc2", hidden, num_classes)
    return s


def layer_norm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def _quant(x: torch.Tensor, dim: int, levels: int):
    """Symmetric integer codes along `dim` and their scale."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / levels
    return torch.round(x / s).clamp(-levels, levels), s


def qdense(x, w, b, levels: int):
    """x (M, K) @ w (K, N) + b through integer codes: activations per row,
    weights per output column, the integer sum exact in float64."""
    qa, sa = _quant(x, -1, levels)
    qw, sw = _quant(w, 0, levels)
    acc = (qa.to(torch.float64) @ qw.to(torch.float64)).to(torch.float32)
    return acc * sa * sw + b


def gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


_LEVELS = {"w8a": 127, "w4a": 7}


class ViT:
    """__call__(images NHWC f32 in [-1, 1]) -> (K, num_classes) logits."""

    def __init__(self, params: dict, cfg: dict, mode: str = "f32"):
        if mode not in ("f32", "fp8", *_LEVELS):
            raise ValueError(f"unknown mode {mode!r}")
        self.p = {k: v.to(torch.float32) for k, v in params.items()}
        self.cfg = cfg
        self.mode = mode

    def dense(self, x, name, quantized: bool):
        w, b = self.p[f"{name}.kernel"], self.p[f"{name}.bias"]
        if quantized and self.mode == "fp8":
            return fake_fp8(x) @ fake_fp8(w) + b
        if quantized and self.mode != "f32":
            lead = x.shape[:-1]
            return qdense(x.reshape(-1, x.shape[-1]), w, b,
                          _LEVELS[self.mode]).reshape(*lead, -1)
        return x @ w + b

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        c, p = self.cfg, self.p
        pt, d, heads = c["patch"], c["dim"], c["heads"]
        k, hh, ww, _ = img.shape
        gh, gw = hh // pt, ww // pt
        patches = img.reshape(k, gh, pt, gw, pt, 3).permute(0, 1, 3, 2, 4, 5) \
            .reshape(k, gh * gw, pt * pt * 3)
        x = patches @ p["model.patch_embed.kernel"].reshape(-1, d) \
            + p["model.patch_embed.bias"]
        x = torch.cat([p["model.cls_token"].expand(k, 1, d), x], 1) \
            + p["model.pos_embed"]
        t, hd = x.shape[1], d // heads
        quant = self.mode != "f32"
        gelu = gelu_tanh if self.mode in ("w8a", "w4a") else F.gelu
        for i in range(c["depth"]):
            b = f"model.block{i}"
            h = layer_norm(x, p[f"{b}.norm1.scale"], p[f"{b}.norm1.bias"])
            qkv = self.dense(h, f"{b}.attn.qkv", quant)
            q, kk, v = qkv.reshape(k, t, 3, heads, hd).unbind(2)
            s = torch.einsum("bqhc,bkhc->bhqk", q, kk) * hd ** -0.5
            o = torch.einsum("bhqk,bkhc->bqhc", torch.softmax(s, -1), v)
            x = x + self.dense(o.reshape(k, t, d), f"{b}.attn.proj", quant)
            h = layer_norm(x, p[f"{b}.norm2.scale"], p[f"{b}.norm2.bias"])
            h = gelu(self.dense(h, f"{b}.mlp_fc1", quant))
            x = x + self.dense(h, f"{b}.mlp_fc2", quant)
        cls = layer_norm(x[:, 0], p["model.norm.scale"], p["model.norm.bias"])
        h = torch.relu(cls @ p["model.head.kernel"] + p["model.head.bias"])
        h = torch.relu(h @ p["fc1.kernel"] + p["fc1.bias"])
        return h @ p["fc2.kernel"] + p["fc2.bias"]
