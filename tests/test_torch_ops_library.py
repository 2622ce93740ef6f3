"""PyTorch port, the hand-written kernels as torch.library operators
(ops/library.py, namespace mt).

- `torch.library.opcheck` on every operator at small shapes on the CPU:
  its schema, its fake implementation (shapes, dtypes, strides) against
  the CPU implementation (the plain version), and its dispatch under
  AOTAutograd with dynamic shapes.
- Every public wrapper reaches its operator: a module calling the wrapper
  exports (torch.export) to a graph holding the operator as one node, and
  the exported program gives the wrapper's eager result bit for bit.
- Every kernel launcher (an operator's CUDA implementation) refuses CPU
  tensors: on the CPU only the plain versions run.
- mt::window_attn (SwinV2's window attention) is held the same way, on a
  shifted block's qkv, and mt::mlp_block (the float ViT's MLP sub-block)
  on bf16 rows.
- The registered schemas, implementations, fakes and launch counts all
  come from ops/library.py's one table, OPS (the native driver's schemas
  are held against SCHEMAS in test_torch_driver.py).
- Launches are counted at the seam: the registered CUDA implementation
  adds one to its row's count when its launcher returns, none when it
  raises; `_build.launch`, the one ctypes call of every launcher, types
  an entry point once, appends the stream and raises on a CUDA error.
"""
import collections
import ctypes

import numpy as np
import pytest
import torch

from yolov8_vit_tpu_torch import _build, ops
from yolov8_vit_tpu_torch.models.yolov8 import conv_f32
from yolov8_vit_tpu_torch.ops import attention, conv_block, fused_region, \
    library, mlp, nms, quant

OPS = list(library.SCHEMAS)


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def _boxes(b, n, g):
    xy = torch.rand(b, n, 2, generator=g) * 50
    wh = torch.rand(b, n, 2, generator=g) * 20 + 1
    return torch.cat([xy, xy + wh], dim=-1)


def _i8(shape, g):
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


def _vec(n, g, lo=0.5, hi=1.5):
    return torch.rand(n, generator=g) * (hi - lo) + lo


def _region(g):
    def conv(shape):
        return {"conv": {"kernel": torch.randn(shape, generator=g) * 0.2,
                         "bias": torch.randn(shape[-1], generator=g) * 0.1}}
    c1, c2, c = 8, 16, 8
    params = {"b1": conv((3, 3, c1, c2)), "cv1": conv((1, 1, c2, c2)),
              "m0_cv1": conv((3, 3, c, c)), "m0_cv2": conv((3, 3, c, c)),
              "cv2": conv((1, 1, 3 * c, c2))}
    return params, fused_region.prepare_region(params, "cpu")


def op_args(name: str):
    """Small CPU arguments of operator `name`."""
    g = _g()
    if name in ("nms_argmax_ml", "nms_argmax"):
        return (_boxes(2, 20, g), torch.rand(2, 20, 3, generator=g), 0.5,
                0.3, 5, 1024, 64)
    if name == "mask_scan":
        return (_boxes(2, 10, g), torch.rand(2, 10, generator=g),
                torch.rand(2, 10, generator=g) > 0.2, None, 0.45, 0.35,
                1024, 64)
    d, h = 32, 64
    if name == "quant_mlp_ln":
        return (torch.randn(6, d, generator=g), _vec(d, g), _vec(d, g, -.1, .1),
                _i8((d, h), g), _vec(h, g, 1e-3, 2e-3), _vec(h, g, -.1, .1),
                _i8((h, d), g), _vec(d, g, 1e-3, 2e-3), _vec(d, g, -.1, .1),
                1e-6, None, None)
    if name == "quant_mlp":
        return (torch.randn(6, d, generator=g), torch.randn(6, d, generator=g),
                _i8((d, h), g), _vec(h, g, 1e-3, 2e-3), _vec(h, g, -.1, .1),
                _i8((h, d), g), _vec(d, g, 1e-3, 2e-3), _vec(d, g, -.1, .1),
                None, None)
    if name == "quant_dense":
        return (torch.randn(6, d, generator=g), _i8((d, 48), g),
                _vec(48, g, 1e-3, 2e-3), _vec(48, g, -.1, .1), True, None)
    if name == "attn_block_i8":
        return (torch.randn(2, 5, d, generator=g), _vec(d, g),
                _vec(d, g, -.1, .1), _i8((d, 3 * d), g),
                _vec(3 * d, g, 1e-3, 2e-3), _vec(3 * d, g, -.1, .1),
                _i8((d, d), g), _vec(d, g, 1e-3, 2e-3), _vec(d, g, -.1, .1),
                4, 1e-6, None, None, None)
    if name == "attn_block":
        return (torch.randn(2, 5, d, generator=g), _vec(d, g),
                _vec(d, g, -.1, .1), torch.randn(d, 3 * d, generator=g) * .1,
                _vec(3 * d, g, -.1, .1), torch.randn(d, d, generator=g) * .1,
                _vec(d, g, -.1, .1), 4, 1e-6, 4)
    if name == "flash_attention":
        return tuple(torch.randn(2, 5, 4, 8, generator=g) for _ in range(3))
    if name == "fused_b1b2":
        _, prep = _region(g)
        x = torch.randn(1, 8, 8, 8, generator=g).to(torch.bfloat16)
        return x, prep.w, prep.bias, prep.c2
    if name == "conv_f32":
        x = torch.randn(1, 4, 6, 6, generator=g).to(
            memory_format=torch.channels_last)
        return (x, torch.randn(8, 4, 3, 3, generator=g), _vec(8, g), 2,
                False)
    if name == "conv_silu":
        # a channel slice in, a residual, a channel slice of a wider
        # buffer out
        x = torch.randn(1, 6, 6, 24, generator=g).to(torch.bfloat16)[..., 8:]
        w = conv_block.kernel_layout(torch.randn(16, 16, 3, 3, generator=g)
                                     * .2)
        res = torch.randn(1, 6, 6, 16, generator=g).to(torch.bfloat16)
        out = torch.zeros(1, 6, 6, 32, dtype=torch.bfloat16)[..., 16:]
        return x, w, _vec(16, g, -.1, .1), 1, res, out
    if name == "window_attn":
        # a 2 x 2 grid of 4 x 4 windows, shifted by 2, two heads of 32
        return (torch.randn(2, 8, 8, 192, generator=g),
                torch.rand(2, 49, generator=g) * 16,
                _vec(2, g, 5.0, 20.0), 4, 2, 2)
    if name == "mlp_block":
        # two images of 5 tokens, width 32, hidden 64, weights in bf16
        bf16 = torch.bfloat16
        return (torch.randn(2, 5, d, generator=g).to(bf16), _vec(d, g),
                _vec(d, g, -.1, .1),
                (torch.randn(d, h, generator=g) * .2).to(bf16),
                _vec(h, g, -.1, .1).to(bf16),
                (torch.randn(h, d, generator=g) * .1).to(bf16),
                _vec(d, g, -.1, .1).to(bf16), 1e-6)
    raise KeyError(name)


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    torch.library.opcheck(library.op(name), op_args(name))


# the launch counts' names, in the order chip_smoke.py and the benchmark
# read them
COUNTED = ("efficient_nms_scan", "area_sorted_nms", "quant_mlp_ln_fused",
           "fused_attention_block_i8", "fused_attention_block",
           "flash_attention", "quant_dense_fused", "quant_mlp_fused",
           "nms_single_label", "fused_b1b2", "conv_silu", "window_attention",
           "mlp_block")


def test_schemas_are_the_one_source():
    assert OPS == list(library.OPS)
    for name, row in library.OPS.items():
        assert library.SCHEMAS[name] == row.schema
        assert library.schema_string(name) == f"mt::{name}{row.schema}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                f"mt::{name}", key), (name, key)
    assert tuple(ops.launch_counts()) == COUNTED == tuple(
        row.counted for row in library.OPS.values() if row.counted)
    # an operator for each kernel's count, and conv_f32
    assert len(OPS) == len(COUNTED) + 1


def _wrapper_case(name):
    """(callable of tensors, tensors) calling the public wrapper that
    reaches operator `name`."""
    a = op_args(name)
    if name == "nms_argmax_ml":
        return (lambda b, s: nms.efficient_nms_scan(b, s)), a[:2]
    if name == "nms_argmax":
        return (lambda b, s: nms.efficient_nms_scan(
            b, s, multi_label=False)), a[:2]
    if name == "mask_scan":
        return nms.area_sorted_nms, a[:3]
    if name == "quant_mlp_ln":
        return quant.quant_mlp_ln_fused, a[:9]
    if name == "quant_mlp":
        return quant.quant_mlp_fused, a[:8]
    if name == "quant_dense":
        return (lambda *t: quant.quant_dense_fused(*t, silu=True)), a[:4]
    if name == "attn_block_i8":
        return (lambda *t: attention.fused_attention_block_i8(
            *t, heads=4)), a[:9]
    if name == "attn_block":
        return (lambda *t: attention.fused_attention_block(
            *t, heads=4, t_real=4)), a[:7]
    if name == "flash_attention":
        return attention.flash_attention, a
    if name == "fused_b1b2":
        params, _ = _region(_g())
        return (lambda x: fused_region.fused_b1b2(x, params)), a[:1]
    if name == "conv_f32":
        return (lambda x, w, b: conv_f32(x, w, 2, b)), a[:3]
    if name == "conv_silu":
        return (lambda x, w, b, r: conv_block.conv_silu(x, w, b, 1, r)), \
            a[:3] + a[4:5]
    if name == "window_attn":
        return (lambda qkv, t, s: attention.window_attention(
            qkv, t, s, window=4, shift=2, heads=2)), a[:3]
    if name == "mlp_block":
        return (lambda *t: mlp.mlp_block(*t, ln_eps=1e-6)), a[:7]
    raise KeyError(name)


class _Call(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *tensors):
        return self.fn(*tensors)


@pytest.mark.parametrize("name", OPS)
def test_wrapper_exports_as_one_operator(name):
    fn, args = _wrapper_case(name)
    want = fn(*args)
    ep = torch.export.export(_Call(fn), tuple(args))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count(f"mt.{name}.default") == 1, targets
    assert not any(t.startswith("mt.") and t != f"mt.{name}.default"
                   for t in targets)
    got = ep.module()(*args)
    for g, w in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        assert torch.equal(g, w)


LAUNCHERS = {"nms_argmax_ml": nms.nms_argmax_ml_kernel,
             "nms_argmax": nms.nms_argmax_kernel,
             "mask_scan": nms.mask_scan_kernel,
             "quant_mlp_ln": quant.quant_mlp_ln_kernel,
             "quant_mlp": quant.quant_mlp_kernel,
             "quant_dense": quant.quant_dense_kernel,
             "attn_block_i8": attention.attn_block_i8_kernel,
             "attn_block": attention.attn_block_kernel,
             "flash_attention": attention.flash_attention_kernel,
             "fused_b1b2": fused_region.fused_b1b2_kernel,
             "conv_silu": conv_block.conv_silu_kernel,
             "window_attn": attention.window_attn_kernel,
             "mlp_block": mlp.mlp_block_kernel}


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launcher_refuses_cpu_tensors(name):
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="on the card only"):
        LAUNCHERS[name](*op_args(name))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_cuda_implementation_counts_one_launch(name, monkeypatch):
    """The registered CUDA implementation, its launcher replaced by a stub
    that gives the fake's outputs, adds one to its row's count; a launcher
    that raises adds none."""
    row = library.OPS[name]
    module = LAUNCHERS[name].__module__
    cuda = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)
    monkeypatch.setattr(module + "." + row.cuda, row.fake)
    before = ops.launch_counts()
    library.op(name).redispatch(cuda, *op_args(name))
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {row.counted: 1}

    def refused(*args):
        raise RuntimeError("refused")

    monkeypatch.setattr(module + "." + row.cuda, refused)
    with pytest.raises(RuntimeError, match="refused"):
        library.op(name).redispatch(cuda, *op_args(name))
    assert ops.launch_counts() == after


class _StubEntry:
    """A C entry point: records its calls and how often its argtypes are
    set, and returns `rc`."""

    def __init__(self, rc):
        self.rc, self.calls, self.typed = rc, [], 0
        self._argtypes, self.restype = None, None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, types):
        self.typed += 1
        self._argtypes = types

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _StubLib:
    def __init__(self, rc):
        self.launch_stub = _StubEntry(rc)

    def kernel_error_string(self, rc):
        return f"stub error {rc}".encode()


@pytest.mark.parametrize("rc", [0, 700])
def test_build_launch_types_once_appends_stream_raises(rc, monkeypatch):
    so = _StubLib(rc)
    monkeypatch.setattr(_build, "lib", lambda name: so)
    monkeypatch.setattr(_build, "stream_ptr", lambda: 1234)
    monkeypatch.setattr(_build, "_entries", collections.defaultdict(dict))
    types = (ctypes.c_void_p, ctypes.c_int)
    for _ in range(2):
        if rc:
            with pytest.raises(RuntimeError, match=r"^stub op: CUDA error "
                               r"700 \(stub error 700\)$"):
                _build.launch("stub", "launch_stub", types, 5, 6,
                              what="stub op")
        else:
            _build.launch("stub", "launch_stub", types, 5, 6, what="stub op")
    entry = so.launch_stub
    assert entry.typed == 1
    assert tuple(entry.argtypes) == types + (ctypes.c_void_p,)
    assert entry.restype is ctypes.c_int
    assert entry.calls == [(5, 6, 1234)] * 2


def test_cpu_calls_count_no_launch():
    ops.reset_launch_counts()
    for name in OPS:
        fn, args = _wrapper_case(name)
        fn(*args)
    assert set(ops.launch_counts().values()) == {0}


def test_region_weights_round_trip():
    """The CPU implementation of mt::fused_b1b2 reads the prepared flat
    weights back to the params dict: both layouts (the fused widths' blocks
    and the five-launch form's rows) give the plain version's result."""
    g = _g(5)
    for c1, c2 in ((8, 16), (16, 32)):
        def conv(shape):
            return {"conv": {"kernel": torch.randn(shape, generator=g) * .2,
                             "bias": torch.randn(shape[-1], generator=g)}}
        c = c2 // 2
        params = {"b1": conv((3, 3, c1, c2)), "cv1": conv((1, 1, c2, c2)),
                  "m0_cv1": conv((3, 3, c, c)), "m0_cv2": conv((3, 3, c, c)),
                  "cv2": conv((1, 1, 3 * c, c2))}
        prep = fused_region.prepare_region(params, "cpu")
        back = fused_region.region_params_of(prep.w, prep.bias, c1, c2)
        for k in params:
            k0 = params[k]["conv"]["kernel"].to(torch.bfloat16)
            assert torch.equal(back[k]["conv"]["kernel"], k0)
            assert torch.equal(back[k]["conv"]["bias"],
                               params[k]["conv"]["bias"])
        x = torch.from_numpy(np.random.default_rng(c1).normal(
            size=(1, 8, 8, c1)).astype(np.float32)).to(torch.bfloat16)
        assert torch.equal(fused_region.fused_b1b2(x, prep),
                           fused_region.region_b1b2_plain(x, params))
