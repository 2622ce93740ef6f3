"""The detector's early region in one call: kernel J.

    y   = ConvBlock(c2, 3, 2)(x)              # b1: 3x3 stride-2 conv + SiLU
    out = C2f(c2, n=1, shortcut=True)(y)      # b2: 1x1, split, two 3x3 +
                                              #     residual, 1x1 over the
                                              #     3-way concat

in bf16 with f32 accumulation.  `fused_b1b2` replaces
yolov8_vit_tpu/ops/fused_region.py `fused_b1b2` (Pallas `_kern`), which
takes and returns 2x2-cell tensors (B, H/2, W/2, 4C); that layout exists to
fill the TPU's 128-lane matrix unit and is not copied: this function takes
flat NHWC (B, H, W, c1) and returns (B, H/2, W/2, c2), so that
decellify(jax(cellify(x))) == port(x) up to bf16 reassociation.  Like its
JAX counterpart it is a maintained artifact beside the detector, whose
modules do not call it.

Every stage rounds as the TPU kernel's `_silu_bf16`: f32 sum + f32 bias,
one rounding to bf16, the logistic evaluated in f32 and rounded to bf16,
their product rounded to bf16.  (The detector's ConvBlock applies SiLU in
f32 before its one rounding, so the two agree only to that class.)  The
stride-2 conv pads one pixel on every side, as the cell kernel embeds it.

On the card this is csrc/fused_region.cu (its source note gives the bound
on the H100 and the design); CPU tensors run `region_b1b2_plain`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from yolov8_vit_tpu_torch import _build

PARAM_NAMES = ("b1", "cv1", "m0_cv1", "m0_cv2", "cv2")


def region_params(det_tree: dict) -> dict:
    """A detector's flax-layout params -> this module's flat param dict
    {b1, cv1, m0_cv1, m0_cv2, cv2}, each {"conv": {"kernel" HWIO, "bias"}}
    (the C2f's m0/cv1, m0/cv2 nesting flattened to single keys)."""
    b2 = det_tree["b2"]
    return {"b1": det_tree["b1"], "cv1": b2["cv1"],
            "m0_cv1": b2["m0"]["cv1"], "m0_cv2": b2["m0"]["cv2"],
            "cv2": b2["cv2"]}


def _kb(params: dict, name: str, device):
    p = params[name]["conv"]
    return (torch.as_tensor(p["kernel"]).to(device),
            torch.as_tensor(p["bias"]).to(device, torch.float32))


def silu_bf16(acc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """f32 accumulator (NCHW) + bias -> bf16 SiLU, rounded as the kernels
    round."""
    y = (acc + bias[:, None, None]).to(torch.bfloat16)
    sig = torch.sigmoid(y.to(torch.float32)).to(torch.bfloat16)
    return y * sig


def region_b1b2_plain(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain version of kernel J: x (B, H, W, c1) -> (B, H/2, W/2, c2)
    bf16.  Each conv is an f32 convolution of bf16-valued operands (exact
    products, f32 sums)."""
    f32 = torch.float32

    def conv(t, name, stride=1):
        k, b = _kb(params, name, t.device)
        w = k.to(torch.bfloat16).to(f32).permute(3, 2, 0, 1)
        return silu_bf16(F.conv2d(t.to(f32), w, stride=stride,
                                  padding=k.shape[0] // 2), b)

    t = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    y1 = conv(conv(t, "b1", 2), "cv1")
    c = y1.shape[1] // 2
    p0, p1 = y1[:, :c], y1[:, c:]
    h = p1 + conv(conv(p1, "m0_cv1"), "m0_cv2")
    out = conv(torch.cat([p0, p1, h], dim=1), "cv2")
    return out.permute(0, 2, 3, 1).contiguous()


def _wt(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO conv kernel -> (out, taps * in) bf16, the kernel's layout."""
    return kernel.to(torch.bfloat16).permute(3, 0, 1, 2) \
        .reshape(kernel.shape[3], -1).contiguous()


def fused_b1b2(x: torch.Tensor, params: dict) -> torch.Tensor:
    """b1 + b2 of the detector on x (B, H, W, c1) bf16 NHWC ->
    (B, H/2, W/2, c2) bf16.  params: {b1, cv1, m0_cv1, m0_cv2, cv2}, each
    {"conv": {"kernel" HWIO, "bias"}} (`region_params` makes it from a
    detector's tree).  CUDA tensors launch kernel J (c1 and c2 / 2
    multiples of 16, H and W even); CPU tensors run the plain version."""
    if _build.on_cpu(x):
        return region_b1b2_plain(x, params)
    dev = x.device
    ws = [_kb(params, n, dev) for n in PARAM_NAMES]
    b, h, w, c1 = x.shape
    c2 = ws[0][0].shape[3]
    c = c2 // 2
    shapes = [(3, 3, c1, c2), (1, 1, c2, c2), (3, 3, c, c), (3, 3, c, c),
              (1, 1, 3 * c, c2)]
    got = [tuple(k.shape) for k, _ in ws]
    if x.dtype != torch.bfloat16 or c1 % 16 or c % 16 or h % 2 or w % 2 \
            or got != shapes:
        raise ValueError(f"kernel J takes bf16 (B, H, W, c1) with c1 and "
                         f"c2 / 2 multiples of 16, H and W even, and conv "
                         f"kernels {shapes}; got {x.dtype} "
                         f"{tuple(x.shape)}, kernels {got}")
    xc = x.contiguous()
    bf16 = torch.bfloat16
    ho, wo = h // 2, w // 2
    y = torch.empty(b, ho, wo, c2, dtype=bf16, device=dev)
    y1 = torch.empty_like(y)
    m1 = torch.empty(b, ho, wo, c, dtype=bf16, device=dev)
    hh = torch.empty_like(m1)
    out = torch.empty_like(y)
    wts = [_wt(k) for k, _ in ws]
    so = _build.lib("fused_region")
    fn = so.launch_fused_b1b2
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 16)
    fn.restype = ctypes.c_int
    wb = [p for wt, (_, bias) in zip(wts, ws)
          for p in (wt.data_ptr(), bias.contiguous().data_ptr())]
    rc = fn(xc.data_ptr(), b, h, w, c1, c2, *wb, y.data_ptr(),
            y1.data_ptr(), m1.data_ptr(), hh.data_ptr(), out.data_ptr(),
            _build.stream_ptr())
    fused_b1b2.launches += 1
    _build.check(so, rc, "fused_b1b2 (kernel J)")
    return out


fused_b1b2.launches = 0
