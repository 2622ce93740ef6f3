"""The hand-written kernels as `torch.library` operators (namespace `mt`).

Every kernel entry point A-K, SwinV2's window attention and the float
ViT's MLP sub-block is one operator, so that `torch.export` and
AOTInductor see it as one opaque node of the graph (runtime/engine.py's
`attach_aot` and `attach_compiled`, runtime/export.py's native packages)
and the eager wrappers reach it through the dispatcher:

    op                kernel  CPU (plain version)         CUDA (launcher)
    nms_argmax_ml     A       nms.nms_argmax_ml_plain     nms.nms_argmax_ml_kernel
    mask_scan         B       nms.mask_scan_plain         nms.mask_scan_kernel
    quant_mlp_ln      C       quant.quant_mlp_ln_plain    quant.quant_mlp_ln_kernel
    attn_block_i8     D       attention.attn_block_i8_plain   ..._i8_kernel
    attn_block        E       attention.fused_attention_block_plain  ..._kernel
    flash_attention   F       attention.flash_attention_plain  ..._kernel
    quant_dense       G       quant.quant_dense_plain     quant.quant_dense_kernel
    quant_mlp         H       quant.quant_mlp_plain       quant.quant_mlp_kernel
    nms_argmax        I       nms.nms_argmax_plain        nms.nms_argmax_kernel
    fused_b1b2        J       fused_region.region_b1b2_plain  ..._kernel
    conv_silu         K       conv_block.conv_silu_op_plain  ..._kernel
    window_attn       Swin    attention.window_attn_op_plain  ..._kernel
    mlp_block         ViT MLP mlp.mlp_block_op_plain  mlp.mlp_block_kernel

plus `conv_f32`, cuDNN's convolution with its TF32 switch as an argument
(models/yolov8.py `conv_f32` calls it while a graph is traced): a traced
graph does not record the switch that eager code sets around a call, and
an artifact run elsewhere (libtorch's C++ runtime defaults it to on)
would otherwise run every f32 convolution in TF32.

The plain versions end their loops on data (`bool(active.any())`), which
cannot be traced; inside an operator's body they run as they are.  Each
operator's fake implementation gives its output shapes, dtypes and
strides.  The launch counts (`ops.launch_counts`) are kept by the CUDA
implementations, so a compiled graph that calls them counts as the eager
wrappers do.

`SCHEMAS` is the one source of the operators' signatures: the native
driver (csrc/driver/mt_infer.cc) registers the same names with schemas
generated from it (`_build.build_driver`), and implements them on the
card by calling the kernel libraries' C entry points.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch._prims_common import suggest_memory_format

NAMESPACE = "mt"

SCHEMAS = {
    "nms_argmax_ml": "(Tensor boxes, Tensor scores, float iou_threshold, "
                     "float score_threshold, int max_output, int window, "
                     "int chunk) -> (Tensor, Tensor, Tensor, Tensor)",
    "mask_scan": "(Tensor boxes, Tensor? scores, Tensor? valid, Tensor? pri, "
                 "float iou_threshold, float score_threshold, int window, "
                 "int chunk) -> Tensor",
    "quant_mlp_ln": "(Tensor x, Tensor ln_scale, Tensor ln_bias, "
                    "Tensor w1_i8, Tensor s1, Tensor b1, Tensor w2_i8, "
                    "Tensor s2, Tensor b2, float ln_eps, Tensor? w1_t, "
                    "Tensor? w2_t) -> Tensor",
    "attn_block_i8": "(Tensor x, Tensor ln_scale, Tensor ln_bias, "
                     "Tensor wqkv_i8, Tensor sqkv, Tensor bqkv, "
                     "Tensor wproj_i8, Tensor sproj, Tensor bproj, int heads, "
                     "float ln_eps, int? t_real, Tensor? wqkv_t, "
                     "Tensor? wproj_t) -> Tensor",
    "attn_block": "(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor wqkv, "
                  "Tensor bqkv, Tensor wproj, Tensor bproj, int heads, "
                  "float ln_eps, int? t_real) -> Tensor",
    "flash_attention": "(Tensor q, Tensor k, Tensor v) -> Tensor",
    "quant_dense": "(Tensor x, Tensor w_i8, Tensor w_scale, Tensor bias, "
                   "bool silu, Tensor? w_t) -> Tensor",
    "quant_mlp": "(Tensor h, Tensor residual, Tensor w1_i8, Tensor s1, "
                 "Tensor b1, Tensor w2_i8, Tensor s2, Tensor b2, "
                 "Tensor? w1_t, Tensor? w2_t) -> Tensor",
    "nms_argmax": "(Tensor boxes, Tensor scores, float iou_threshold, "
                  "float score_threshold, int max_output, int window, "
                  "int chunk) -> (Tensor, Tensor, Tensor, Tensor)",
    "fused_b1b2": "(Tensor x, Tensor w, Tensor bias, int c2) -> Tensor",
    "conv_silu": "(Tensor x, Tensor weight, Tensor bias, int stride, "
                 "Tensor? residual, Tensor(a!) out) -> ()",
    "conv_f32": "(Tensor x, Tensor weight, Tensor? bias, int stride, "
                "bool allow_tf32) -> Tensor",
    "window_attn": "(Tensor qkv, Tensor table, Tensor scale, int window, "
                   "int shift, int heads) -> Tensor",
    "mlp_block": "(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor w1, "
                 "Tensor b1, Tensor w2, Tensor b2, float ln_eps) -> Tensor",
}

_LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, _schema in SCHEMAS.items():
    _LIB.define(_name + _schema)


def op(name: str):
    """The OpOverload `mt::<name>.default`."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def schema_string(name: str) -> str:
    """The registered schema as the dispatcher prints it
    (`mt::name(...) -> ...`), what the native driver must print."""
    return str(op(name)._schema)


def _register(name: str, cpu, cuda, fake) -> None:
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


# ---- the TF32 switch of the f32 convolutions --------------------------------
# cuDNN's TF32 switch is one flag of the process, and the service runs
# requests on threads: the set, the conv launch and the restore hold this
# lock, so no conv of conv_f32 runs under another call's setting and the
# flag ends as it started.  (A conv outside conv_f32 that runs meanwhile,
# as the plain version of kernel J does, sees either setting; its operands
# hold bf16 values, exact in TF32, so its result is the same.)
TF32_LOCK = threading.RLock()


@contextlib.contextmanager
def cudnn_tf32(allow: bool):
    """cuDNN's TF32 switch for the convolutions inside the block only,
    under TF32_LOCK."""
    with TF32_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = allow
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


def conv_f32_eager(x, weight, bias, stride: int, allow_tf32: bool):
    """F.conv2d with 'same' padding under `cudnn_tf32(allow_tf32)`, its
    result in x's memory format (the operator's fake gives that layout)."""
    with cudnn_tf32(allow_tf32):
        y = F.conv2d(x, weight, bias, stride=stride,
                     padding=weight.shape[-1] // 2)
    return y.contiguous(memory_format=suggest_memory_format(x))


def _conv_fake(x, weight, bias, stride, allow_tf32):
    k = weight.shape[-1]
    p = k // 2
    h = (x.shape[2] + 2 * p - k) // stride + 1
    w = (x.shape[3] + 2 * p - k) // stride + 1
    return x.new_empty((x.shape[0], weight.shape[0], h, w)).contiguous(
        memory_format=suggest_memory_format(x))


_register("conv_f32", conv_f32_eager, conv_f32_eager, _conv_fake)


def _late(module, name: str):
    """module.name, looked up at each call: a caller that replaces the
    launcher (a recording wrapper, a test) is what the dispatcher calls."""
    def call(*args):
        return getattr(module, name)(*args)
    call.__name__ = name
    return call


def _register_kernels() -> None:
    from yolov8_vit_tpu_torch.ops import (attention, conv_block,
                                          fused_region, mlp, nms, quant)

    def nms_fake(boxes, scores, iou, score, max_output, window, chunk):
        b = boxes.shape[0]
        return (boxes.new_empty((b,), dtype=torch.int32),
                boxes.new_empty((b, max_output, 4), dtype=torch.float32),
                boxes.new_empty((b, max_output), dtype=torch.float32),
                boxes.new_empty((b, max_output), dtype=torch.int32))

    def same_as(x, *_a, **_k):
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    def flash_plain(q, k, v):
        return attention.flash_attention_plain(q, k, v).contiguous()

    for name, module, cpu, cuda, fake in (
            ("nms_argmax_ml", nms, "nms_argmax_ml_op_plain",
             "nms_argmax_ml_kernel", nms_fake),
            ("nms_argmax", nms, "nms_argmax_op_plain", "nms_argmax_kernel",
             nms_fake),
            ("mask_scan", nms, "mask_scan_op_plain", "mask_scan_op_kernel",
             lambda boxes, *a: boxes.new_empty(boxes.shape[:2],
                                               dtype=torch.bool)),
            ("quant_mlp_ln", quant, "quant_mlp_ln_op_plain",
             "quant_mlp_ln_kernel", same_as),
            ("quant_mlp", quant, "quant_mlp_op_plain", "quant_mlp_kernel",
             same_as),
            ("quant_dense", quant, "quant_dense_op_plain",
             "quant_dense_kernel",
             lambda x, w_i8, *a: x.new_empty((x.shape[0], w_i8.shape[1]))),
            ("attn_block_i8", attention, "attn_block_i8_op_plain",
             "attn_block_i8_kernel", same_as),
            ("attn_block", attention, "attn_block_op_plain",
             "attn_block_kernel", same_as),
            ("flash_attention", attention, None, "flash_attention_kernel",
             same_as),
            ("fused_b1b2", fused_region, "fused_b1b2_op_plain",
             "fused_b1b2_kernel",
             lambda x, w, bias, c2: x.new_empty(
                 (x.shape[0], x.shape[1] // 2, x.shape[2] // 2, c2),
                 dtype=torch.bfloat16)),
            ("conv_silu", conv_block, "conv_silu_op_plain",
             "conv_silu_kernel", lambda *a: None),
            ("window_attn", attention, "window_attn_op_plain",
             "window_attn_kernel",
             lambda qkv, *a: qkv.new_empty(
                 (*qkv.shape[:-1], qkv.shape[-1] // 3))),
            ("mlp_block", mlp, "mlp_block_op_plain",
             "mlp_block_kernel", same_as)):
        _register(name, flash_plain if cpu is None else _late(module, cpu),
                  _late(module, cuda), fake)


_register_kernels()
