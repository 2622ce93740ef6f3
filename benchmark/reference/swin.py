"""Plain SwinV2 classifier: timm's SwinTransformerV2 (microsoft/Swin-
Transformer configs/swinv2/swinv2_base_patch4_window16_256.yaml; timm
swinv2_base_window16_256) under the inspection model's head ReLU -> 1000
-> 128 -> ReLU -> 5.  Weights are a flat dict keyed by timm's state-dict
names under `model.` joined with '.', the head's `fc1.kernel` (in, out).

  patch embed   4x4 stride-4 conv + LayerNorm (every LayerNorm eps 1e-5)
  stage i > 0   patch merging: x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
                x[1::2, 1::2] concatenated, reduction (no bias), LayerNorm
  block         x = x + norm1(attn(x)); x = x + norm2(mlp(x)); exact GELU
  attn          roll by (-s, -s) in every second block of a stage whose
                grid exceeds the window (else window = grid, no shift);
                windows; qkv with [q_bias, 0, v_bias]; normalize(q)
                normalize(k)^T * exp(min(logit_scale, ln 100)) + 16
                sigmoid(cpb(log-spaced coords))[V1 index] + shift mask
                (-100 across regions); softmax; @ v; proj; reversed
  head          LayerNorm, mean over the grid, fc

Departure: the coordinates divide by max(ws - 1, 1) (timm divides by ws -
1, zero at a 1 x 1 window, which the published model never reaches).

Precision is the caller's `mode`: "f32", every product in float32 (TF32
off, set by the caller); "fp8", the control below bfloat16: both operands
of every block GEMM (qkv, proj, fc1, fc2) cut to fp8 e4m3, one scale a
tensor, as the ViT's "fp8".
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.yolov8 import fake_fp8

LN_EPS = 1e-5


def param_shapes(cfg: dict, num_classes: int = 5, hidden: int = 128) -> dict:
    """{path: (shape, init)} of the classifier's tree, every matrix in the
    (in, out) orientation the seeded fill draws it in (`timm_layout` turns
    it to timm's)."""
    c, p = cfg["embed_dim"], cfg["patch_size"]
    s: dict = {"model.patch_embed.proj.weight": ((p, p, 3, c), "lecun"),
               "model.patch_embed.proj.bias": ((c,), "zeros")}

    def norm(name, d):
        s[f"{name}.weight"] = ((d,), "ones")
        s[f"{name}.bias"] = ((d,), "zeros")

    def linear(name, fin, fout, bias=True):
        s[f"{name}.weight"] = ((fin, fout), "lecun")
        if bias:
            s[f"{name}.bias"] = ((fout,), "zeros")

    norm("model.patch_embed.norm", c)
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        d = c << i
        if i:
            linear(f"model.layers.{i}.downsample.reduction", 2 * d, d, False)
            norm(f"model.layers.{i}.downsample.norm", d)
        for j in range(depth):
            b = f"model.layers.{i}.blocks.{j}"
            s[f"{b}.attn.logit_scale"] = ((heads, 1, 1),
                                          ("full", math.log(10.0)))
            s[f"{b}.attn.q_bias"] = ((d,), "zeros")
            s[f"{b}.attn.v_bias"] = ((d,), "zeros")
            linear(f"{b}.attn.qkv", d, 3 * d, False)
            linear(f"{b}.attn.proj", d, d)
            linear(f"{b}.attn.cpb_mlp.0", 2, cfg["cpb_hidden"])
            linear(f"{b}.attn.cpb_mlp.2", cfg["cpb_hidden"], heads, False)
            norm(f"{b}.norm1", d)
            linear(f"{b}.mlp.fc1", d, int(d * cfg["mlp_ratio"]))
            linear(f"{b}.mlp.fc2", int(d * cfg["mlp_ratio"]), d)
            norm(f"{b}.norm2", d)
    last = c << (len(cfg["depths"]) - 1)
    norm("model.norm", last)
    linear("model.head.fc", last, cfg["backbone_classes"])
    s["fc1.kernel"] = ((cfg["backbone_classes"], hidden), "lecun")
    s["fc1.bias"] = ((hidden,), "zeros")
    s["fc2.kernel"] = ((hidden, num_classes), "lecun")
    s["fc2.bias"] = ((num_classes,), "zeros")
    return s


def timm_layout(flat: dict) -> dict:
    """The seeded (in, out) matrices of `param_shapes` in timm's layout:
    Linear weights (out, in), the patch conv OIHW."""
    out = {}
    for k, v in flat.items():
        if k == "model.patch_embed.proj.weight":
            v = v.permute(3, 2, 0, 1).contiguous()
        elif k.startswith("model.") and k.endswith(".weight") and v.dim() == 2:
            v = v.T.contiguous()
        out[k] = v
    return out


def window_grid(grid: int, window: int, block: int) -> tuple[int, int]:
    """(window, shift) of a block on a grid x grid stage."""
    if grid <= window:
        return grid, 0
    return window, window // 2 if block % 2 else 0


def coords_table(ws: int, device) -> torch.Tensor:
    h = torch.arange(-(ws - 1), ws, dtype=torch.float32, device=device)
    t = torch.stack(torch.meshgrid([h, h], indexing="ij")).permute(1, 2, 0)
    t = t / max(ws - 1, 1) * 8
    t = torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8)
    return t.reshape(-1, 2)


def relative_position_index(ws: int, device) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(
        [torch.arange(ws, device=device)] * 2, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def unpartition(win, ws, h, w):
    x = win.view(-1, h // ws, w // ws, ws, ws, win.shape[-1])
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, win.shape[-1])


def shift_mask(h, w, ws, shift, device):
    img = torch.zeros(1, h, w, 1, device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, vs, :] = cnt
            cnt += 1
    mw = partition(img, ws).squeeze(-1)
    m = mw.unsqueeze(1) - mw.unsqueeze(2)
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


class SwinV2:
    """__call__(images NHWC f32 in [-1, 1]) -> (K, num_classes) logits."""

    def __init__(self, params: dict, cfg: dict, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"unknown mode {mode!r}")
        self.p = {k: v.to(torch.float32) for k, v in params.items()}
        self.cfg = cfg
        self.mode = mode

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"],
                            self.p[f"{name}.bias"], LN_EPS)

    def _gemm(self, x, w, b=None):
        """A block GEMM, cut to fp8 in the control."""
        if self.mode == "fp8":
            y = fake_fp8(x) @ fake_fp8(w).T
            return y if b is None else y + b
        return F.linear(x, w, b)

    def _attn(self, x, pre, heads, ws, shift):
        p = self.p
        b, h, w, c = x.shape
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        win = partition(x, ws)
        bw, n, _ = win.shape
        bias = torch.cat([p[f"{pre}.q_bias"],
                          torch.zeros_like(p[f"{pre}.v_bias"]),
                          p[f"{pre}.v_bias"]])
        qkv = self._gemm(win, p[f"{pre}.qkv.weight"], bias)
        q, k, v = qkv.reshape(bw, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
        attn = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2,
                                                                          -1)
        attn = attn * torch.clamp(p[f"{pre}.logit_scale"],
                                  max=math.log(1.0 / 0.01)).exp()
        hid = F.relu(F.linear(coords_table(ws, x.device),
                              p[f"{pre}.cpb_mlp.0.weight"],
                              p[f"{pre}.cpb_mlp.0.bias"]))
        table = F.linear(hid, p[f"{pre}.cpb_mlp.2.weight"])
        rel = table[relative_position_index(ws, x.device).view(-1)]
        attn = attn + 16 * torch.sigmoid(
            rel.view(n, n, -1).permute(2, 0, 1)).unsqueeze(0)
        if shift:
            mask = shift_mask(h, w, ws, shift, x.device)
            nw = mask.shape[0]
            attn = (attn.view(bw // nw, nw, heads, n, n)
                    + mask[None, :, None]).view(-1, heads, n, n)
        o = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(bw, n,
                                                                      c)
        o = self._gemm(o, p[f"{pre}.proj.weight"], p[f"{pre}.proj.bias"])
        x = unpartition(o, ws, h, w)
        return torch.roll(x, shifts=(shift, shift), dims=(1, 2)) if shift \
            else x

    def _mlp(self, x, pre):
        p = self.p
        x = F.gelu(self._gemm(x, p[f"{pre}.fc1.weight"], p[f"{pre}.fc1.bias"]))
        return self._gemm(x, p[f"{pre}.fc2.weight"], p[f"{pre}.fc2.bias"])

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        c, p = self.cfg, self.p
        x = F.conv2d(img.permute(0, 3, 1, 2),
                     p["model.patch_embed.proj.weight"],
                     p["model.patch_embed.proj.bias"], stride=c["patch_size"])
        x = self._ln(x.permute(0, 2, 3, 1), "model.patch_embed.norm")
        for i, depth in enumerate(c["depths"]):
            if i:
                pre = f"model.layers.{i}.downsample"
                x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                               x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
                x = self._ln(F.linear(x, p[f"{pre}.reduction.weight"]),
                             f"{pre}.norm")
            for j in range(depth):
                b = f"model.layers.{i}.blocks.{j}"
                ws, shift = window_grid(x.shape[1], c["window_size"], j)
                x = x + self._ln(self._attn(x, f"{b}.attn", c["num_heads"][i],
                                            ws, shift), f"{b}.norm1")
                x = x + self._ln(self._mlp(x, f"{b}.mlp"), f"{b}.norm2")
        x = self._ln(x, "model.norm").mean(dim=(1, 2))
        h = torch.relu(F.linear(x, p["model.head.fc.weight"],
                                p["model.head.fc.bias"]))
        h = torch.relu(h @ p["fc1.kernel"] + p["fc1.bias"])
        return h @ p["fc2.kernel"] + p["fc2.bias"]
