"""PyTorch port, mt::mlp_block (ops/mlp.py): the float ViT's MLP sub-block
as one operator.

- Its CPU implementation is the Block's float MLP expression bit for bit:
  a bf16 Block forced onto the operator's path (`vit._mlp_kernel_runs`,
  the card's test) gives the plain forward's output, at ViT-B/8, B/16,
  S/16 widths and with pad_tokens.
- The training form, f32 activations and the dynamic / w8 / w8a modes
  never reach the operator.
- Its fake implementation gives the shapes under torch.export (one node a
  block), and the native driver's generated schema header carries it.
- benchmark/counts/mlp_block.py counts 4 m d h operations a call: 474.1
  GFLOP at b8f.bulk32's 64 crops x 785 tokens.
"""
import dataclasses

import pytest
import torch

from yolov8_vit_tpu_torch import _build, ops
from yolov8_vit_tpu_torch.models import vit
from yolov8_vit_tpu_torch.ops import mlp

BF16 = torch.bfloat16
TINY = vit.ViTSpec(img_size=32, patch=8, dim=32, depth=2, heads=2,
                   backbone_classes=10)


@pytest.fixture
def op_calls(monkeypatch):
    """The operator's CPU calls, recorded."""
    calls = []
    plain = mlp.mlp_block_plain

    def record(x, *a):
        calls.append(tuple(x.shape))
        return plain(x, *a)

    monkeypatch.setattr(mlp, "mlp_block_plain", record)
    return calls


def _randomize(model, seed):
    """Random float leaves (LayerNorms too), then the derived buffers."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "reset"):
            m.reset(g)
        if isinstance(m, vit.LayerNorm):
            m.scale.copy_(1 + 0.1 * torch.randn(m.scale.shape, generator=g))
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
        if isinstance(m, vit.Dense):
            m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    return g


@pytest.mark.parametrize("spec", [
    vit.VIT_B8_224, vit.VIT_B16_224, vit.VIT_S16_224,
    dataclasses.replace(vit.VIT_S16_224, pad_tokens=200)],
    ids=["b8", "b16", "s16", "s16_pad_tokens"])
def test_operator_is_the_plain_mlp_bit_for_bit(spec, op_calls, monkeypatch):
    block = vit.Block(spec)
    g = _randomize(block, 0)
    for m in block.modules():
        if hasattr(m, "derive"):
            m.derive(BF16)
    x = torch.randn(1, spec.seq_len, spec.dim, generator=g).to(BF16)
    t_real = spec.tokens if spec.pad_tokens else None
    if t_real is not None:
        x[:, t_real:] = 0
    with torch.no_grad():
        want = block(x, t_real)
        assert op_calls == []                  # CPU tensors: the plain path
        monkeypatch.setattr(vit, "_mlp_kernel_runs",
                            lambda t: t.dtype == BF16)
        got = block(x, t_real)
    assert op_calls == [tuple(x.shape)]
    assert got.dtype == BF16 and torch.equal(got, want)


def _classifier(quant, dtype=BF16):
    spec = dataclasses.replace(
        TINY, quant=quant, attn_impl="fused" if quant == "w8a" else "xla")
    model = vit.ViTClassifier(spec, num_classes=3, dtype=dtype)
    _randomize(model, 1)
    model.prepare()
    return model


@pytest.mark.parametrize("form", ["train", "f32", "dynamic", "w8", "w8a"])
def test_other_forms_never_reach_the_operator(form, op_calls, monkeypatch):
    """With the card's test forced on (every tensor for the quantized modes
    and the training form, bf16 for f32 serving), only the float bf16
    serving form would reach the operator: these keep the plain path,
    output for output."""
    if form == "train":
        model = _classifier("none", torch.float32).train_form()
    elif form == "f32":
        model = _classifier("none", torch.float32)
    else:
        model = _classifier(form)
    img = torch.rand(2, 32, 32, 3,
                     generator=torch.Generator().manual_seed(2)) * 2 - 1
    with torch.no_grad():
        want = model(img)
        monkeypatch.setattr(vit, "_mlp_kernel_runs",
                            (lambda t: t.dtype == BF16) if form == "f32"
                            else (lambda t: True))
        ops.reset_launch_counts()
        got = model(img)
    assert op_calls == [] and ops.launch_counts()["mlp_block"] == 0
    assert torch.equal(got, want)


def test_bf16_classifier_exports_one_node_a_block(op_calls, monkeypatch):
    """The fake implementation traces: a bf16 classifier on the operator's
    path exports with one mt::mlp_block node a block, and the program
    gives the eager output bit for bit."""
    model = _classifier("none")
    monkeypatch.setattr(vit, "_mlp_kernel_runs", lambda t: t.dtype == BF16)
    img = torch.rand(2, 32, 32, 3,
                     generator=torch.Generator().manual_seed(3)) * 2 - 1
    with torch.no_grad():
        want = model(img)
        ep = torch.export.export(model, (img,))
        got = ep.module()(img)
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("mt.mlp_block.default") == TINY.depth
    fake = [n.meta["val"] for n in ep.graph.nodes
            if str(n.target) == "mt.mlp_block.default"]
    assert all(tuple(v.shape) == (2, TINY.tokens, TINY.dim)
               and v.dtype == BF16 for v in fake)
    assert torch.equal(got, want)


def test_driver_header_carries_the_operator():
    header = _build.driver_schemas_header()
    from yolov8_vit_tpu_torch.ops.library import SCHEMAS
    assert f'm.def("mlp_block{SCHEMAS["mlp_block"]}");' in header
    assert '"mt::mlp_block"' in header
    assert _build.SOURCES["mlp_block"] == "mlp_block.cu"
    assert "mlp_block" in _build.DRIVER_LIB_MACROS


def test_benchmark_count_at_the_cell():
    """b8f.bulk32's fused step: 64 crops of 785 tokens, ViT-B/8 widths;
    the shapes as the profiler records the operator's arguments."""
    from benchmark.counts import flops, mlp_block
    d, h, m = 768, 3072, 64 * 785
    dims = [[64, 785, d], [d], [d], [d, h], [h], [h, d], [d], []]
    op, nbytes = mlp_block.mlp_block(dims)
    assert op == {"bf16": 4.0 * m * d * h}
    assert round(op["bf16"] / 1e9, 1) == 474.1
    assert nbytes == 2 * 2 * m * d + 2 * 2 * d * h + 2 * (h + d) + 4 * 2 * d
    # operations set the bound: 0.48 ms at the bf16 peak
    assert flops.bound_s(op, nbytes) == pytest.approx(
        op["bf16"] / flops.PEAKS["bf16_flops_per_s"])
