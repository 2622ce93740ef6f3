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
on the H100 and the design): one launch at FUSED_WIDTHS, five launches of
one conv kernel at any wider (c1, c2) with c1 and c2 / 2 multiples of 16,
its weights laid out once by `prepare_region`; CPU tensors run
`region_b1b2_plain`.
"""
from __future__ import annotations

import ctypes
import dataclasses

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


# (c1, c2) pairs whose five stages' weights and rows fit one CTA's shared
# memory: YOLOv8-s's and YOLOv8-n's, one launch of the fused kernel.  Other
# widths run the five-launch form.
FUSED_WIDTHS = ((32, 64), (16, 32))


def weight_blocks(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO conv kernel (kh, kw, cin, cout) -> the fused kernel's layout of
    it, flat bf16: for each tap t = u * kw + v and 8-channel input chunk j,
    cout rows of the chunk's 8 weights (16 bytes), element ((t * cin / 8 +
    j) * cout + n) * 8 + e = kernel[u, v, 8 j + e, n]: the K-major operand
    that wgmma reads without swizzle."""
    kh, kw, cin, cout = kernel.shape
    return (kernel.to(torch.bfloat16).reshape(kh * kw, cin // 8, 8, cout)
            .permute(0, 1, 3, 2).reshape(-1))


def weight_rows(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO conv kernel -> the five-launch form's layout of it, flat bf16:
    element n * kh * kw * cin + t * cin + c = kernel[u, v, c, n], t = u *
    kw + v (one row of taps x in channels an output channel)."""
    return kernel.to(torch.bfloat16).permute(3, 0, 1, 2).reshape(-1)


@dataclasses.dataclass(frozen=True)
class RegionWeights:
    """Kernel J's weights made once (`prepare_region`): `w` the five
    stages' kernels concatenated in the order of PARAM_NAMES (bf16), in
    `weight_blocks`' layout where `fused` ((c1, c2) in FUSED_WIDTHS), else
    in `weight_rows`'; `bias` their biases (f32), both on `w`'s device;
    `params` the dict they were made from (the plain version reads it)."""
    params: dict
    c1: int
    c2: int
    w: torch.Tensor
    bias: torch.Tensor

    @property
    def fused(self) -> bool:
        return (self.c1, self.c2) in FUSED_WIDTHS


def prepare_region(params: dict, device="cuda") -> RegionWeights:
    """The params dict of `fused_b1b2` -> its weights in kernel J's layout
    for their widths on `device`, made once: a caller that passes the
    result to every call does no host-to-device copy and no relayout a
    call."""
    dev = _build.resolve_device(device)
    ws = [_kb(params, n, dev) for n in PARAM_NAMES]
    c1, c2 = ws[0][0].shape[2], ws[0][0].shape[3]
    c = c2 // 2
    shapes = [(3, 3, c1, c2), (1, 1, c2, c2), (3, 3, c, c), (3, 3, c, c),
              (1, 1, 3 * c, c2)]
    got = [tuple(k.shape) for k, _ in ws]
    if got != shapes or c1 % 8 or c % 8:
        raise ValueError(f"kernel J's params: conv kernels {shapes} with c1 "
                         f"and c2 / 2 multiples of 8; got {got}")
    layout = weight_blocks if (c1, c2) in FUSED_WIDTHS else weight_rows
    return RegionWeights(
        params=params, c1=c1, c2=c2,
        w=torch.cat([layout(k) for k, _ in ws]).contiguous(),
        bias=torch.cat([b for _, b in ws]).contiguous())


def fused_b1b2(x: torch.Tensor, params) -> torch.Tensor:
    """b1 + b2 of the detector on x (B, H, W, c1) bf16 NHWC ->
    (B, H/2, W/2, c2) bf16.  params: {b1, cv1, m0_cv1, m0_cv2, cv2}, each
    {"conv": {"kernel" HWIO, "bias"}} (`region_params` makes it from a
    detector's tree), or the `RegionWeights` that `prepare_region` made of
    it once (a dict is prepared again every call).  CUDA tensors launch
    kernel J (H and W even; (c1, c2) in FUSED_WIDTHS, or c1 and c2 / 2
    multiples of 16); CPU tensors run the plain version."""
    prep = params if isinstance(params, RegionWeights) else None
    if _build.on_cpu(x):
        return region_b1b2_plain(x, params if prep is None else prep.params)
    if prep is None:
        prep = prepare_region(params, x.device)
    b, h, w, c1 = x.shape
    if x.dtype != torch.bfloat16 or c1 != prep.c1 or h % 2 or w % 2 \
            or prep.w.device != x.device \
            or not (prep.fused or (prep.c1 % 16 == 0
                                   and prep.c2 % 32 == 0)):
        raise ValueError(f"kernel J takes bf16 (B, H, W, c1) on the weights' "
                         f"device, H and W even, (c1, c2) in "
                         f"{FUSED_WIDTHS} or c1 and c2 / 2 multiples of 16; "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}, "
                         f"(c1, c2) = ({prep.c1}, {prep.c2}) on "
                         f"{prep.w.device}")
    xc = x.contiguous()
    out = torch.empty(b, h // 2, w // 2, prep.c2, dtype=torch.bfloat16,
                      device=x.device)
    # y, y1 (c2 channels each), m1 and the bottleneck's output (c2 / 2)
    scratch = None if prep.fused else torch.empty(
        b * (h // 2) * (w // 2) * 3 * prep.c2, dtype=torch.bfloat16,
        device=x.device)
    so = _build.lib("fused_region")
    fn = so.launch_fused_b1b2
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
    rc = fn(xc.data_ptr(), b, h, w, c1, prep.c2, prep.w.data_ptr(),
            prep.bias.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            _build.stream_ptr())
    fused_b1b2.launches += 1
    _build.check(so, rc, "fused_b1b2 (kernel J)")
    return out


fused_b1b2.launches = 0


def silu_table(device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel J's SiLU epilogue on every bf16 value: (fast, exact), each
    (65536,) bf16, element i the SiLU of the bf16 whose bits are i, with
    the fused kernel's special-function logistic and with the five-launch
    form's exact one.  A stage's sum is rounded to bf16 before the
    logistic, so these are all the values the epilogue can give
    (`silu_bf16` is the plain version)."""
    dev = _build.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("silu_table runs the kernel's epilogue on the card")
    fast = torch.empty(65536, dtype=torch.bfloat16, device=dev)
    exact = torch.empty_like(fast)
    so = _build.lib("fused_region")
    fn = so.launch_silu_table
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    _build.check(so, fn(fast.data_ptr(), exact.data_ptr(),
                        _build.stream_ptr()), "silu_table")
    return fast, exact
