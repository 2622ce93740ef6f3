"""Plain SwinV2 classifier for the CPU tests, in float32 torch ops, written
from the equations of SwinV2 (Liu et al. 2022) as timm's
`swin_transformer_v2.py` and microsoft/Swin-Transformer implement them.
It imports nothing of the port.  Weights are a flat dict keyed by timm's
state-dict names under `model.` (the service head's `fc1.kernel` ...).

  patch embed   4x4 stride-4 conv + LayerNorm (eps 1e-5)
  stage i > 0   patch merging: x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
                x[1::2, 1::2] concatenated, reduction (no bias), LayerNorm
  block         x = x + norm1(attn(x)); x = x + norm2(mlp(x))
  attn          roll by (-s, -s); windows; qkv with [q_bias, 0, v_bias];
                normalize(q) normalize(k)^T * exp(min(logit_scale, ln 100))
                + 16 sigmoid(cpb(coords table))[relative index] + mask;
                softmax; @ v; proj; windows reversed; roll by (s, s)
  head          LayerNorm, mean over the grid, fc; then the service's
                ReLU -> fc1 -> ReLU -> fc2

Departure: the coordinates table divides by max(ws - 1, 1), where timm
divides by ws - 1 (zero at a 1 x 1 window, which a published model never
reaches; the tiny test model's last stage does).

`broken` names one mechanism to get wrong, for the tests that show the
comparison would catch it: "shift" (no roll, no mask), "bias" (no
relative-position bias), "cosine" (scaled dot-product logits), "postnorm"
(V1's pre-norm residuals), "merge" (row-major 2x2 order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def stage_window(grid: int, window: int, block: int) -> tuple[int, int]:
    if grid <= window:
        return grid, 0
    return window, window // 2 if block % 2 else 0


def coords_table(ws: int) -> torch.Tensor:
    h = torch.arange(-(ws - 1), ws, dtype=torch.float32)
    t = torch.stack(torch.meshgrid([h, h], indexing="ij")).permute(1, 2, 0)
    t = t / max(ws - 1, 1)
    t = t * 8
    t = torch.sign(t) * torch.log2(torch.abs(t) + 1.0) / math.log2(8)
    return t.reshape(-1, 2)


def relative_position_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid([torch.arange(ws), torch.arange(ws)],
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(win, ws, h, w):
    c = win.shape[-1]
    x = win.view(-1, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def attn_mask(h, w, ws, shift):
    img = torch.zeros(1, h, w, 1)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, vs, :] = cnt
            cnt += 1
    mw = window_partition(img, ws).squeeze(-1)
    m = mw.unsqueeze(1) - mw.unsqueeze(2)
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


def window_attention(x, p, pre, heads, ws, shift, broken=None):
    b, h, w, c = x.shape
    shifted = shift and broken != "shift"
    if shifted:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    win = window_partition(x, ws)
    bw, n, _ = win.shape
    qkv_bias = torch.cat([p[f"{pre}.q_bias"], torch.zeros_like(
        p[f"{pre}.v_bias"]), p[f"{pre}.v_bias"]])
    qkv = F.linear(win, p[f"{pre}.qkv.weight"], qkv_bias)
    qkv = qkv.reshape(bw, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    if broken == "cosine":
        attn = (q * q.shape[-1] ** -0.5) @ k.transpose(-2, -1)
    else:
        attn = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2,
                                                                          -1)
        scale = torch.clamp(p[f"{pre}.logit_scale"],
                            max=math.log(1.0 / 0.01)).exp()
        attn = attn * scale
    if broken != "bias":
        hid = F.relu(F.linear(coords_table(ws).to(x.dtype),
                              p[f"{pre}.cpb_mlp.0.weight"],
                              p[f"{pre}.cpb_mlp.0.bias"]))
        table = F.linear(hid, p[f"{pre}.cpb_mlp.2.weight"])
        bias = table[relative_position_index(ws).view(-1)].view(n, n, -1)
        attn = attn + 16 * torch.sigmoid(bias.permute(2, 0, 1)).unsqueeze(0)
    if shifted:
        mask = attn_mask(h, w, ws, shift)
        nw = mask.shape[0]
        attn = attn.view(bw // nw, nw, heads, n, n) + mask[None, :, None]
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, dim=-1)
    o = (attn @ v).transpose(1, 2).reshape(bw, n, c)
    o = F.linear(o, p[f"{pre}.proj.weight"], p[f"{pre}.proj.bias"])
    x = window_reverse(o, ws, h, w)
    if shifted:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    return x


def mlp(x, p, pre):
    x = F.gelu(F.linear(x, p[f"{pre}.fc1.weight"], p[f"{pre}.fc1.bias"]))
    return F.linear(x, p[f"{pre}.fc2.weight"], p[f"{pre}.fc2.bias"])


def patch_merge(x, p, pre, broken=None):
    x0, x1 = x[:, 0::2, 0::2], x[:, 1::2, 0::2]
    x2, x3 = x[:, 0::2, 1::2], x[:, 1::2, 1::2]
    parts = [x0, x2, x1, x3] if broken == "merge" else [x0, x1, x2, x3]
    x = F.linear(torch.cat(parts, -1), p[f"{pre}.reduction.weight"])
    return _ln(x, p, f"{pre}.norm")


def backbone(img, p, cfg, broken=None):
    """img (K, H, W, 3) f32 in [-1, 1] -> (K, backbone_classes)."""
    x = F.conv2d(img.permute(0, 3, 1, 2), p["model.patch_embed.proj.weight"],
                 p["model.patch_embed.proj.bias"], stride=cfg["patch_size"])
    x = _ln(x.permute(0, 2, 3, 1), p, "model.patch_embed.norm")
    for i, depth in enumerate(cfg["depths"]):
        if i:
            x = patch_merge(x, p, f"model.layers.{i}.downsample", broken)
        for j in range(depth):
            pre = f"model.layers.{i}.blocks.{j}"
            ws, shift = stage_window(x.shape[1], cfg["window_size"], j)
            heads = cfg["num_heads"][i]
            if broken == "postnorm":
                x = x + window_attention(_ln(x, p, f"{pre}.norm1"), p,
                                         f"{pre}.attn", heads, ws, shift)
                x = x + mlp(_ln(x, p, f"{pre}.norm2"), p, f"{pre}.mlp")
            else:
                x = x + _ln(window_attention(x, p, f"{pre}.attn", heads, ws,
                                             shift, broken), p, f"{pre}.norm1")
                x = x + _ln(mlp(x, p, f"{pre}.mlp"), p, f"{pre}.norm2")
    x = _ln(x, p, "model.norm").mean(dim=(1, 2))
    return F.linear(x, p["model.head.fc.weight"], p["model.head.fc.bias"])


def classifier(img, p, cfg, broken=None):
    """The service's classifier over the backbone: (K, num_classes)."""
    h = torch.relu(backbone(img, p, cfg, broken))
    h = torch.relu(h @ p["fc1.kernel"] + p["fc1.bias"])
    return h @ p["fc2.kernel"] + p["fc2.bias"]
