"""Operations of one crop's SwinV2 forward, counted from the configuration
(a multiply-add is two operations; norms, GELU, softmax and adds are not
counted, as counts/flops.py leaves them out):

  patch embedding  2 T0 (p^2 3) C
  a block          24 T C^2 (qkv 3 C^2, proj C^2, fc1 and fc2 8 C^2, all
                   at 2 T), attention 4 T N C (Q K^T and P V; N the
                   block's window tokens)
  merging          2 T (4 C_prev) C before each later stage
  heads            2 C_last x classes, then the service's 1000 -> 128 -> 5

SwinV2-B at 256 (window 16): 43.6 GFLOP a crop (21.8 GMACs, as published).
"""
from __future__ import annotations

from benchmark.counts import flops


def swin_flops(v: dict, num_classes: int = 5, hidden: int = 128) -> dict:
    """{"gemm": block and merging GEMMs, "attention": Q K^T and P V,
    "other": patch embedding and the heads} of one crop."""
    g = v["img_size"] // v["patch_size"]
    gemm = attention = 0.0
    for i, depth in enumerate(v["depths"]):
        c, grid = v["embed_dim"] << i, g >> i
        t = grid * grid
        ws = min(grid, v["window_size"])
        if i:
            gemm += 2.0 * t * (2 * c) * c
        hid = int(c * v["mlp_ratio"])
        gemm += depth * 2.0 * t * (3 * c * c + c * c + 2 * c * hid)
        attention += depth * 4.0 * t * ws * ws * c
    last = v["embed_dim"] << (len(v["depths"]) - 1)
    other = (2.0 * g * g * v["patch_size"] ** 2 * 3 * v["embed_dim"]
             + 2.0 * last * v["backbone_classes"]
             + 2.0 * v["backbone_classes"] * hidden
             + 2.0 * hidden * num_classes)
    return {"gemm": gemm, "attention": attention, "other": other}


def ideal_s(cfg: dict, frames: int, crops: int) -> float:
    """The least time the card needs for `frames` detector frames and
    `crops` SwinV2 crops, every operation at the bf16 peak."""
    bf16 = flops.PEAKS["bf16_flops_per_s"]
    det = flops.detector_flops(cfg["detector"]) * frames / bf16
    return det + crops * sum(swin_flops(cfg["vit"],
                                        cfg["num_classes"]).values()) / bf16
