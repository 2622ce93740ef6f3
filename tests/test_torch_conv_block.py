"""PyTorch port, kernel K's operator mt::conv_silu (ops/conv_block.py) and
the detector's ConvBlocks around it, on the CPU.

- The operator's plain route is bit-equal to the chain the detector ran
  before it (models/yolov8.py `_conv_silu` on the kernel rounded to bf16
  as f32, the bottleneck's bf16 residual add) on bf16 CPU tensors: a 1x1,
  a 3x3 at stride 1 and at stride 2, the stem's 3 input channels, a
  residual, and channel slices in and out (the rest of the output buffer
  untouched).
- A bf16 YOLOv8-s forward through the operator (the card's path, forced
  here: C2f's one buffer for its branches, the shortcut in cv2's call)
  is bit-equal to the chain's, with one call a ConvBlock: 54.
- The f32 model and the training form never call it, whatever the
  device, and the training form's gradients are those of the chain.
- The operator's cost (benchmark/counts/conv.py, which reads the shapes
  its calls record) sums to the detector's conv operations less the
  head's final 1x1 convs.
(The kernel against the chain on the card: tests/test_torch_kernels_gpu.py
and chip_smoke.py.)
"""
import json
import math

import pytest
import torch

from yolov8_vit_tpu_torch.models import yolov8 as y
from yolov8_vit_tpu_torch.ops import conv_block

BF16 = torch.bfloat16

# name: (x shape, cout, k, stride, residual, (x channels, offset),
#        (out channels, offset))
CASES = {
    "1x1": ((2, 6, 7, 32), 48, 1, 1, False, None, None),
    "3x3": ((2, 9, 10, 16), 32, 3, 1, False, None, None),
    "3x3_stride2": ((1, 10, 13, 16), 32, 3, 2, False, None, None),
    "stem": ((2, 16, 16, 3), 16, 3, 2, False, None, None),
    "residual": ((1, 8, 8, 16), 16, 3, 1, True, None, None),
    "slices": ((2, 8, 6, 16), 16, 3, 1, True, (48, 16), (64, 32)),
}


def _case(name, seed=0):
    xs, cout, k, s, has_res, xsl, osl = CASES[name]
    g = torch.Generator().manual_seed(seed)
    b, h, w, cin = xs
    if xsl is None:
        x = torch.randn(xs, generator=g).to(BF16)
    else:
        x = torch.randn(b, h, w, xsl[0], generator=g).to(BF16)[
            ..., xsl[1]:xsl[1] + cin]
    kernel = torch.randn(cout, cin, k, k, generator=g) / math.sqrt(
        cin * k * k)
    bias = torch.randn(cout, generator=g) * 0.1
    shape = (b, (h - 1) // s + 1 if k == 3 else h,
             (w - 1) // s + 1 if k == 3 else w, cout)
    res = torch.randn(shape, generator=g).to(BF16) if has_res else None
    if osl is None:
        buf, out = None, torch.empty(shape, dtype=BF16)
    else:
        buf = torch.randn(*shape[:3], osl[0], generator=g).to(BF16)
        out = buf[..., osl[1]:osl[1] + cout]
    return x, kernel, bias, s, res, buf, out


@pytest.mark.parametrize("name", list(CASES))
def test_plain_route_is_the_chain_bit_for_bit(name):
    x, kernel, bias, s, res, buf, out = _case(name)
    before = None if buf is None else buf.clone()
    torch.ops.mt.conv_silu(x, conv_block.kernel_layout(kernel), bias, s,
                           res, out)
    want = y._conv_silu(x.permute(0, 3, 1, 2), y._rounded_f32(kernel, BF16),
                        bias, s)
    if res is not None:
        want = res.permute(0, 3, 1, 2) + want
    assert torch.equal(out, want.permute(0, 2, 3, 1))
    if buf is not None:
        _, osl = CASES[name][5:]
        keep = torch.ones(buf.shape[-1], dtype=torch.bool)
        keep[osl[1]:osl[1] + out.shape[-1]] = False
        assert torch.equal(buf[..., keep], before[..., keep])


def test_kernel_layout_is_hwio_memory():
    """The weights' view is (cout, k, k, cin) over the HWIO kernel (the
    flax tree's layout, which the kernel's TMA map reads), and the chain
    reads it back exactly."""
    kernel = torch.randn(8, 16, 3, 3)
    wk = conv_block.kernel_layout(kernel)
    assert wk.shape == (8, 3, 3, 16) and wk.dtype == BF16
    assert wk.stride() == (1, 3 * 16 * 8, 16 * 8, 8)
    assert torch.equal(wk.permute(1, 2, 3, 0).contiguous().view(-1),
                       wk.permute(1, 2, 3, 0).reshape(-1))
    assert torch.equal(conv_block.chain_weight(wk),
                       y._rounded_f32(kernel, BF16))


def _model(dtype, variant="s"):
    g = torch.Generator().manual_seed(7)
    det = y.YOLOv8(y.YOLOV8_VARIANTS[variant], dtype=dtype)
    for m in det.modules():
        if isinstance(m, y.Conv):
            m.reset(g)
    det.prepare()
    return det


@pytest.fixture
def op_calls(monkeypatch):
    """The operator's CPU calls, recorded; the card's path forced on
    bf16 CPU tensors (kernel K's `_kernel_runs` test)."""
    calls = []
    plain = conv_block.conv_silu_op_plain

    def record(x, w, b, s, res, out):
        calls.append((tuple(x.shape), tuple(w.shape), s, res is not None))
        return plain(x, w, b, s, res, out)

    monkeypatch.setattr(conv_block, "conv_silu_op_plain", record)
    return calls


def test_bf16_forward_through_the_operator_is_the_chain(op_calls,
                                                        monkeypatch):
    det = _model(BF16)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(8))
    x = x.to(BF16)
    with torch.no_grad():
        want = det(x)
        assert op_calls == []                 # CPU tensors: the chain
        monkeypatch.setattr(y, "_kernel_runs",
                            lambda t: t.dtype == torch.bfloat16)
        got = det(x)
    assert len(op_calls) == 54
    assert sum(1 for c in op_calls if c[3]) == 1 + 2 + 2 + 1  # shortcuts
    assert sum(1 for c in op_calls if c[0][-1] == 3) == 1     # the stem
    for (gb, gc), (wb, wc) in zip(got, want):
        assert torch.equal(gb, wb) and torch.equal(gc, wc)


def test_f32_and_training_forms_never_call_the_operator(op_calls,
                                                        monkeypatch):
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(9))
    f32 = _model(torch.float32, "n")
    train = _model(torch.float32, "n").train_form()

    def loss_and_grads(model):
        # one thread: the CPU's threaded conv backward sums in an order
        # that changes from run to run
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            model.zero_grad()
            loss = sum(b.square().mean() + c.square().mean()
                       for b, c in model(x))
            loss.backward()
        finally:
            torch.set_num_threads(threads)
        return loss, [p.grad.clone() for p in model.parameters()]

    with torch.no_grad():
        want = f32(x)
    want_loss, want_grads = loss_and_grads(train)
    monkeypatch.setattr(y, "_kernel_runs", lambda t: True)
    with torch.no_grad():
        got = f32(x)
    got_loss, got_grads = loss_and_grads(train)
    assert op_calls == []
    for (gb, gc), (wb, wc) in zip(got, want):
        assert torch.equal(gb, wb) and torch.equal(gc, wc)
    assert torch.equal(got_loss, want_loss)
    assert all(torch.equal(a, b) for a, b in zip(got_grads, want_grads))


def test_cost_counts_the_convblocks(op_calls, monkeypatch):
    """benchmark/counts/conv.py over the 54 calls' shapes (as the
    profiler records them: one entry an argument, [] for the stride and
    an absent residual) is the detector's conv operations less the head's
    final 1x1 convs."""
    from benchmark.counts import conv, flops
    size = 64
    det = _model(BF16)
    monkeypatch.setattr(y, "_kernel_runs",
                        lambda t: t.dtype == torch.bfloat16)
    with torch.no_grad():
        outs = det(torch.zeros(1, size, size, 3, dtype=BF16))
    ops = 0.0
    for xs, ws, s, res in op_calls:
        k = ws[1]
        out = [xs[0], (xs[1] - 1) // s + 1 if k == 3 else xs[1],
               (xs[2] - 1) // s + 1 if k == 3 else xs[2], ws[0]]
        dims = [list(xs), list(ws), [ws[0]], [], out if res else [], out]
        o, nbytes = conv.conv_silu(dims)
        ops += o["bf16"]
        assert nbytes >= 2 * (math.prod(xs) + math.prod(out))
    head = sum(2.0 * b.shape[1] * b.shape[2] * (b.shape[3] * 64)
               + 2.0 * c.shape[1] * c.shape[2] * (c.shape[3] * 128)
               for b, c in outs)
    with open("benchmark/configs/yolov8s-vitb16-w8a.json") as f:
        cfg = dict(json.load(f)["detector"], input_size=[size, size])
    assert ops + head == pytest.approx(flops.detector_flops(cfg), rel=1e-9)
