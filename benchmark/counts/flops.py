"""Operations of the models and of the kernels, counted from shapes.

A multiply-add is two operations.  Convolutions and GEMMs are counted;
activations, norms, softmax and elementwise adds are not (they are not
what the tensor cores do, and published GFLOP figures leave them out).
The detector's count walks the reference detector on the meta device, so
every conv is counted at its real output size.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from benchmark.reference import yolov8 as ref_yolo

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def detector_flops(det_cfg: dict, frames: int = 1) -> float:
    """Conv operations of one detector forward over `frames` frames at the
    configuration's input size."""
    shapes = ref_yolo.param_shapes(det_cfg)
    params = {k: torch.empty(s, device="meta") for k, (s, _) in shapes.items()}
    total = [0.0]

    class Counting(ref_yolo.Detector):
        def conv(self, x, name, stride=1, act=True, block=True):
            y = super().conv(x, name, stride, act, block)
            pre = f"{name}.conv" if block else name
            kh, kw, cin, cout = self.p[f"{pre}.kernel"].shape
            total[0] += 2.0 * y.numel() * cin * kh * kw
            return y

    h, w = det_cfg["input_size"]
    Counting(params, det_cfg)(torch.empty((frames, h, w, 3), device="meta"))
    return total[0]


def vit_flops(v: dict, num_classes: int = 5, hidden: int = 128) -> dict:
    """Operations of one crop's ViT forward: {"block_gemm": qkv, proj,
    fc1 and fc2 (int8 under w8a), "attention": QK^T and PV, "other":
    patch embedding and the heads}."""
    d, p = v["dim"], v["patch"]
    t = (v["img_size"] // p) ** 2 + 1
    mlp = int(d * v["mlp_ratio"])
    block_gemm = 2 * t * (d * 3 * d + d * d + 2 * d * mlp) * v["depth"]
    attention = 2 * 2 * t * t * d * v["depth"]
    other = (2 * (t - 1) * p * p * 3 * d + 2 * d * v["backbone_classes"]
             + 2 * v["backbone_classes"] * hidden + 2 * hidden * num_classes)
    return {"block_gemm": float(block_gemm), "attention": float(attention),
            "other": float(other)}


def ideal_s(cfg: dict, frames: int, crops: int) -> float:
    """The least time the card needs for `frames` detector frames and
    `crops` ViT crops, each operation at the peak of the precision the
    configuration states: bf16 convs, attention and float GEMMs; int8
    block GEMMs under w8a; float32 GEMMs at the f32 peak."""
    bf16 = PEAKS["bf16_flops_per_s"]
    act = {"bfloat16": bf16, "float32": PEAKS["f32_flops_per_s"]}[
        cfg["dtype"]]
    det = detector_flops(cfg["detector"]) * frames / act
    vf = vit_flops(cfg["vit"], cfg["num_classes"])
    gemm_peak = PEAKS["int8_ops_per_s"] if cfg["vit"]["quant"] == "w8a" \
        else act
    vit = crops * (vf["block_gemm"] / gemm_peak
                   + (vf["attention"] + vf["other"]) / act)
    return det + vit


# ---- kernels: operations by precision and bytes of one call ---------------
def _rows(dims) -> tuple[int, int]:
    """(rows, width) of the first input, (..., D)."""
    x = dims[0]
    rows = 1
    for s in x[:-1]:
        rows *= s
    return rows, x[-1]


def quant_mlp_ln(dims) -> tuple[dict, float]:
    """Kernel C: LN, fc1 (D -> H) and fc2 (H -> D) in int8, residual.
    Bytes: x read and the output written in bf16, the int8 weights read
    once, the f32 scales and biases."""
    m, d = _rows(dims)
    h = dims[3][1]
    ops = {"int8": 2.0 * m * d * h * 2}
    nbytes = 2 * m * d * 2 + 2 * d * h + 4 * (2 * h + 2 * d) + 4 * 2 * d
    return ops, float(nbytes)


def attn_block_i8(dims) -> tuple[dict, float]:
    """Kernel D: LN, qkv (D -> 3D) and proj (D -> D) in int8, SDPA in
    bf16 (QK^T and PV), residual."""
    b, t, d = dims[0]
    m = b * t
    ops = {"int8": 2.0 * m * d * 4 * d, "bf16": 2.0 * 2 * b * t * t * d}
    nbytes = 2 * m * d * 2 + 4 * d * d + 4 * (4 * d + 4 * d) + 4 * 2 * d
    return ops, float(nbytes)


def attn_block(dims) -> tuple[dict, float]:
    """Kernel E: LN, qkv and proj GEMMs and SDPA, all bf16."""
    b, t, d = dims[0]
    m = b * t
    ops = {"bf16": 2.0 * m * d * 4 * d + 2.0 * 2 * b * t * t * d}
    nbytes = 2 * m * d * 2 + 2 * 4 * d * d + 4 * (4 * d) + 4 * 2 * d
    return ops, float(nbytes)


def bound_s(ops: dict, nbytes: float) -> float:
    """Roofline bound of a call: the larger of its operations at their
    peaks and its bytes at the memory bandwidth."""
    peak = {"int8": PEAKS["int8_ops_per_s"], "bf16": PEAKS["bf16_flops_per_s"],
            "f32": PEAKS["f32_flops_per_s"]}
    t_ops = sum(v / peak[k] for k, v in ops.items())
    return max(t_ops, nbytes / PEAKS["bytes_per_s"])


def roofline_pct(trace, op: str, cost) -> float | None:
    """Share (%) of the roofline bound in the device time of operator
    `op`'s calls whose kernels the trace holds; None where it holds none."""
    calls = [(dims, us) for dims, us in trace.op_time_by_call(op)
             if dims and us > 0]
    if not calls:
        return None
    bound = sum(bound_s(*cost(dims)) for dims, _ in calls)
    return 100.0 * bound / (sum(us for _, us in calls) / 1e6)
