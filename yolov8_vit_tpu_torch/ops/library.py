"""The hand-written kernels as `torch.library` operators (namespace `mt`).

Every kernel entry point A-K, SwinV2's window attention and the float
ViT's MLP sub-block is one operator, so that `torch.export` and
AOTInductor see it as one opaque node of the graph (runtime/engine.py's
`attach_aot` and `attach_compiled`, runtime/export.py's native packages)
and the eager wrappers reach it through the dispatcher.  `OPS` below is
the one place an operator is declared: its schema, the ops module that
holds its implementations, its CPU implementation (the plain version),
its CUDA implementation (the kernel's launcher), its fake and the name
its launches are counted under.  The registration, `SCHEMAS` and the
launch counts are derived from it.

The plain versions end their loops on data (`bool(active.any())`), which
cannot be traced; inside an operator's body they run as they are.  Each
operator's fake implementation gives its output shapes, dtypes and
strides.  The launch counts (`launch_counts`) are kept by the CUDA
implementations registered here, so a compiled graph that calls them
counts as the eager wrappers do.

`conv_f32` is cuDNN's convolution with its TF32 switch as an argument
(models/yolov8.py `conv_f32` calls it while a graph is traced): a traced
graph does not record the switch that eager code sets around a call, and
an artifact run elsewhere (libtorch's C++ runtime defaults it to on)
would otherwise run every f32 convolution in TF32.  It has no kernel of
its own and no count.

`SCHEMAS` is the one source of the operators' signatures: the native
driver (csrc/driver/mt_infer.cc) registers the same names with schemas
generated from it (`_build.build_driver`), and implements them on the
card by calling the kernel libraries' C entry points.
"""
from __future__ import annotations

import contextlib
import importlib
import inspect
import threading
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch._prims_common import suggest_memory_format

NAMESPACE = "mt"


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


# ---- fakes: output shapes, dtypes and strides -------------------------------
def _conv_fake(x, weight, bias, stride, allow_tf32):
    k = weight.shape[-1]
    p = k // 2
    h = (x.shape[2] + 2 * p - k) // stride + 1
    w = (x.shape[3] + 2 * p - k) // stride + 1
    return x.new_empty((x.shape[0], weight.shape[0], h, w)).contiguous(
        memory_format=suggest_memory_format(x))


def _nms_fake(boxes, scores, iou, score, max_output, window, chunk):
    b = boxes.shape[0]
    return (boxes.new_empty((b,), dtype=torch.int32),
            boxes.new_empty((b, max_output, 4), dtype=torch.float32),
            boxes.new_empty((b, max_output), dtype=torch.float32),
            boxes.new_empty((b, max_output), dtype=torch.int32))


def _same_as(x, *_a):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# ---- the table --------------------------------------------------------------
class Op(NamedTuple):
    """One operator.  `module` is the ops module holding `cpu`, the plain
    version, called with the schema's leading arguments, as many as it
    takes, and `cuda`, the kernel's launcher, called with all of them;
    both are looked up at each call, so a caller that replaces one (a
    recording wrapper, a test) is what the dispatcher calls.  `counted`
    names the launch count that a launch adds one to (None with `cuda`:
    `cpu` serves both devices)."""
    schema: str
    module: str
    cpu: str
    cuda: str | None
    fake: Callable
    counted: str | None


OPS = {
    "nms_argmax_ml": Op(  # kernel A
        "(Tensor boxes, Tensor scores, float iou_threshold, "
        "float score_threshold, int max_output, int window, "
        "int chunk) -> (Tensor, Tensor, Tensor, Tensor)",
        "nms", "nms_argmax_ml_plain", "nms_argmax_ml_kernel", _nms_fake,
        "efficient_nms_scan"),
    "mask_scan": Op(  # kernel B
        "(Tensor boxes, Tensor? scores, Tensor? valid, Tensor? pri, "
        "float iou_threshold, float score_threshold, int window, "
        "int chunk) -> Tensor",
        "nms", "mask_scan_op_plain", "mask_scan_kernel",
        lambda boxes, *a: boxes.new_empty(boxes.shape[:2], dtype=torch.bool),
        "area_sorted_nms"),
    "quant_mlp_ln": Op(  # kernel C
        "(Tensor x, Tensor ln_scale, Tensor ln_bias, "
        "Tensor w1_i8, Tensor s1, Tensor b1, Tensor w2_i8, "
        "Tensor s2, Tensor b2, float ln_eps, Tensor? w1_t, "
        "Tensor? w2_t) -> Tensor",
        "quant", "quant_mlp_ln_plain", "quant_mlp_ln_kernel", _same_as,
        "quant_mlp_ln_fused"),
    "attn_block_i8": Op(  # kernel D
        "(Tensor x, Tensor ln_scale, Tensor ln_bias, "
        "Tensor wqkv_i8, Tensor sqkv, Tensor bqkv, "
        "Tensor wproj_i8, Tensor sproj, Tensor bproj, int heads, "
        "float ln_eps, int? t_real, Tensor? wqkv_t, "
        "Tensor? wproj_t) -> Tensor",
        "attention", "attn_block_i8_plain", "attn_block_i8_kernel",
        _same_as, "fused_attention_block_i8"),
    "attn_block": Op(  # kernel E
        "(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor wqkv, "
        "Tensor bqkv, Tensor wproj, Tensor bproj, int heads, "
        "float ln_eps, int? t_real) -> Tensor",
        "attention", "fused_attention_block_plain", "attn_block_kernel",
        _same_as, "fused_attention_block"),
    "flash_attention": Op(  # kernel F
        "(Tensor q, Tensor k, Tensor v) -> Tensor",
        "attention", "flash_attention_plain", "flash_attention_kernel",
        _same_as, "flash_attention"),
    "quant_dense": Op(  # kernel G
        "(Tensor x, Tensor w_i8, Tensor w_scale, Tensor bias, "
        "bool silu, Tensor? w_t) -> Tensor",
        "quant", "quant_dense_plain", "quant_dense_kernel",
        lambda x, w_i8, *a: x.new_empty((x.shape[0], w_i8.shape[1])),
        "quant_dense_fused"),
    "quant_mlp": Op(  # kernel H
        "(Tensor h, Tensor residual, Tensor w1_i8, Tensor s1, "
        "Tensor b1, Tensor w2_i8, Tensor s2, Tensor b2, "
        "Tensor? w1_t, Tensor? w2_t) -> Tensor",
        "quant", "quant_mlp_plain", "quant_mlp_kernel", _same_as,
        "quant_mlp_fused"),
    "nms_argmax": Op(  # kernel I, efficient_nms_scan(multi_label=False)
        "(Tensor boxes, Tensor scores, float iou_threshold, "
        "float score_threshold, int max_output, int window, "
        "int chunk) -> (Tensor, Tensor, Tensor, Tensor)",
        "nms", "nms_argmax_op_plain", "nms_argmax_kernel", _nms_fake,
        "nms_single_label"),
    "fused_b1b2": Op(  # kernel J
        "(Tensor x, Tensor w, Tensor bias, int c2) -> Tensor",
        "fused_region", "fused_b1b2_op_plain", "fused_b1b2_kernel",
        lambda x, w, bias, c2: x.new_empty(
            (x.shape[0], x.shape[1] // 2, x.shape[2] // 2, c2),
            dtype=torch.bfloat16), "fused_b1b2"),
    "conv_silu": Op(  # kernel K, writing into `out`
        "(Tensor x, Tensor weight, Tensor bias, int stride, "
        "Tensor? residual, Tensor(a!) out) -> ()",
        "conv_block", "conv_silu_op_plain", "conv_silu_kernel",
        lambda *a: None, "conv_silu"),
    "conv_f32": Op(
        "(Tensor x, Tensor weight, Tensor? bias, int stride, "
        "bool allow_tf32) -> Tensor",
        "library", "conv_f32_eager", None, _conv_fake, None),
    "window_attn": Op(  # SwinV2's window attention
        "(Tensor qkv, Tensor table, Tensor scale, int window, "
        "int shift, int heads) -> Tensor",
        "attention", "window_attention_plain", "window_attn_kernel",
        lambda qkv, *a: qkv.new_empty((*qkv.shape[:-1], qkv.shape[-1] // 3)),
        "window_attention"),
    "mlp_block": Op(  # the float ViT's MLP sub-block
        "(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor w1, "
        "Tensor b1, Tensor w2, Tensor b2, float ln_eps) -> Tensor",
        "mlp", "mlp_block_plain", "mlp_block_kernel", _same_as,
        "mlp_block"),
}

SCHEMAS = {name: row.schema for name, row in OPS.items()}

# kernel launches under each row's count name, since the last reset
_LAUNCHES = {row.counted: 0 for row in OPS.values() if row.counted}


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def add_launches(counts: dict[str, int]) -> None:
    """Add `counts` (some of `launch_counts()`'s keys) to the launch
    counts: for launches the launchers did not make themselves, as a
    replayed CUDA graph's."""
    for name, n in counts.items():
        _LAUNCHES[name] += n


def op(name: str):
    """The OpOverload `mt::<name>.default`."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def schema_string(name: str) -> str:
    """The registered schema as the dispatcher prints it
    (`mt::name(...) -> ...`), what the native driver must print."""
    return str(op(name)._schema)


def _plain(module, name: str):
    """The CPU implementation: module.name on the schema's leading
    arguments, a tensor it returns made contiguous as the fakes promise
    (the NMS forms return theirs so)."""
    takes = len(inspect.signature(getattr(module, name)).parameters)

    def call(*args):
        out = getattr(module, name)(*args[:takes])
        return out.contiguous() if isinstance(out, torch.Tensor) else out
    call.__name__ = name
    return call


def _launch(module, name: str, counted: str):
    """The CUDA implementation: module.name, one launch counted under
    `counted` when it returns."""
    def call(*args):
        out = getattr(module, name)(*args)
        _LAUNCHES[counted] += 1
        return out
    call.__name__ = name
    return call


_LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, _row in OPS.items():
    _LIB.define(_name + _row.schema)
    _module = importlib.import_module(f"{__package__}.{_row.module}")
    if _row.cuda is None:
        _impl = getattr(_module, _row.cpu)
        _LIB.impl(_name, _impl, "CPU")
        _LIB.impl(_name, _impl, "CUDA")
    else:
        _LIB.impl(_name, _plain(_module, _row.cpu), "CPU")
        _LIB.impl(_name, _launch(_module, _row.cuda, _row.counted), "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _row.fake, lib=_LIB)
