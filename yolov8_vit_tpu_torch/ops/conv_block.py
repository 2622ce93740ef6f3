"""One ConvBlock of the bf16 detector in one launch: kernel K.

    out = bf16(silu(conv(x, w) + bias))     (+ residual: a bf16 add)

with every product of bf16 operands exact in an f32 sum, the f32 bias,
SiLU in f32 and one rounding: the JAX package's fused ConvBlock
(yolov8_vit_tpu/models/yolov8.py `ConvBlock`).  It replaces no TPU
kernel: XLA fuses the conv and its epilogue there, where the port ran a
chain of five device operations (cast to f32, cuDNN's conv in TF32, bias
add, SiLU, cast back), which stays as the plain version (`conv_silu_plain`)
and as the detector's path for f32 activations, the training form and
CPU tensors (models/yolov8.py).

Tensors are NHWC: x (B, H, W, cin), out (B, H / s, W / s, cout) and the
residual may be channel slices of wider buffers (C2f writes its branches
into one buffer, so its concat is gone).  The weights are the HWIO kernel
in bf16 (the flax tree's layout), passed as its (cout, k, k, cin) view
(`kernel_layout`, made once when the model derives its buffers).

On the card this is csrc/conv_silu.cu (its source note gives the bound
and the design): 1x1 and 3x3 convs at stride 1 and 2 with cin and cout
multiples of 8, and the stem's 3x3 stride-2 conv over 3 channels.
"""
from __future__ import annotations

import ctypes

import torch

from yolov8_vit_tpu_torch import _build

# the C entry point's arguments before the stream
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_CONV_SILU_ARGS = (_P, _I, _I, _I, _I, _LL, _P, _I, _I, _I, _P, _P, _LL, _P,
                   _LL)

def kernel_layout(kernel: torch.Tensor) -> torch.Tensor:
    """An OIHW conv kernel -> kernel K's weights: bf16 in HWIO memory,
    returned as its (cout, k, k, cin) view."""
    return (kernel.to(torch.bfloat16).permute(2, 3, 1, 0).contiguous()
            .permute(3, 0, 1, 2))


def chain_weight(weight: torch.Tensor) -> torch.Tensor:
    """Kernel K's (cout, k, k, cin) weights -> the OIHW f32 kernel (bf16
    values) that the chain convolves with."""
    return weight.permute(0, 3, 1, 2).to(torch.float32).contiguous()


def out_shape(x: torch.Tensor, weight: torch.Tensor, stride: int):
    b, h, w, _ = x.shape
    k = weight.shape[1]
    p = k // 2
    return (b, (h + 2 * p - k) // stride + 1, (w + 2 * p - k) // stride + 1,
            weight.shape[0])


def conv_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              stride: int, residual: torch.Tensor | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """One ConvBlock (operator mt::conv_silu): x (B, H, W, cin) bf16,
    weight `kernel_layout`'s (cout, k, k, cin), bias (cout,) f32, 'same'
    zero padding; the residual (B, H / s, W / s, cout) added as a bf16 add
    after the rounding.  Writes `out` (allocated where None; a channel
    slice of a wider NHWC buffer is fine) and returns it.  CUDA tensors
    launch kernel K; CPU tensors run the chain (`conv_silu_plain`)."""
    if out is None:
        out = x.new_empty(out_shape(x, weight, stride), dtype=torch.bfloat16)
    torch.ops.mt.conv_silu(x, weight, bias, stride, residual, out)
    return out


def conv_silu_plain(x, weight, bias, stride, residual=None):
    """Plain version of kernel K, the detector's chain as it ran before
    it: the conv of bf16-valued f32 operands (cuDNN's TF32 on the card,
    which is exact for them), + bias, SiLU in f32, one cast; the
    residual's bf16 add.  NHWC in, an NHWC view of channels_last memory
    out."""
    from yolov8_vit_tpu_torch.models.yolov8 import _conv_silu
    y = _conv_silu(x.permute(0, 3, 1, 2), chain_weight(weight), bias,
                   stride)
    if residual is not None:
        y = residual.permute(0, 3, 1, 2) + y
    return y.permute(0, 2, 3, 1)


def conv_silu_op_plain(x, weight, bias, stride, residual, out):
    """Operator mt::conv_silu on the CPU: the plain version into `out`."""
    out.copy_(conv_silu_plain(x, weight, bias, stride, residual))


def _pixel_dense(t: torch.Tensor) -> bool:
    """(B, H, W, C) with channels adjacent and pixels a fixed stride
    apart: a whole NHWC tensor or a channel slice of one."""
    b, h, w, _ = t.shape
    ld = t.stride(2)
    return t.stride(3) == 1 and (t.stride(1) == w * ld or h == 1) and (
        t.stride(0) == h * w * ld or b == 1)


def _rows_aligned(t: torch.Tensor) -> bool:
    """Pixel-dense with 16-byte aligned pixels (the kernel stores and
    reads 8 channels at a time)."""
    return _pixel_dense(t) and t.stride(2) % 8 == 0 \
        and t.data_ptr() % 16 == 0


def conv_silu_kernel(x, weight, bias, stride, residual, out) -> None:
    """Kernel K on CUDA tensors (operator mt::conv_silu)."""
    _build.require_cuda(x, weight, bias, out)
    if residual is not None:
        _build.require_cuda(residual)
    b, h, w, cin = x.shape
    cout, k = weight.shape[0], weight.shape[1]
    shape = out_shape(x, weight, stride)
    if (x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16
            or bias.dtype != torch.float32 or out.dtype != torch.bfloat16
            or tuple(out.shape) != shape or not _rows_aligned(out)
            or weight.stride() != (1, k * cin * cout, cin * cout, cout)
            or (residual is not None and (tuple(residual.shape) != shape
                                          or residual.dtype != out.dtype))):
        raise ValueError(
            f"kernel K takes bf16 x (B, H, W, cin), kernel_layout's bf16 "
            f"(cout, k, k, cin) weights, f32 bias and a bf16 NHWC out (and "
            f"residual) of shape {shape}, its pixels 16-byte aligned "
            f"with a stride of 8 channels; got x {x.dtype} "
            f"{tuple(x.shape)}, weight {weight.dtype} {tuple(weight.shape)} "
            f"strides {weight.stride()}, bias {bias.dtype}, out {out.dtype} "
            f"{tuple(out.shape)} strides {out.stride()}")
    if not _pixel_dense(x):
        x = x.contiguous()
    if residual is not None and not _rows_aligned(residual):
        residual = residual.contiguous()
    _build.launch("conv_silu", "launch_conv_silu", _CONV_SILU_ARGS,
                  x.data_ptr(), b, h, w, cin, x.stride(2), weight.data_ptr(),
                  k, stride, cout, bias.data_ptr(),
                  None if residual is None else residual.data_ptr(),
                  0 if residual is None else residual.stride(2),
                  out.data_ptr(), out.stride(2), what="conv_silu (kernel K)")
