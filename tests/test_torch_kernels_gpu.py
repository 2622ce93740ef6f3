"""PyTorch port, the four CUDA kernels against their plain versions on the
card, at small shapes.  Marked `cuda`: they skip where no CUDA device is
present (a CUDA kernel has no interpret mode).  On the GPU machine, which
has no jax for tests/conftest.py, run them with
`python3 -m pytest tests/test_torch_kernels_gpu.py -q --noconftest`.
chip_smoke.py repeats these checks at the main path's shapes."""
import pytest
import torch

from yolov8_vit_tpu_torch import ops
from yolov8_vit_tpu_torch.ops.attention import attn_block_i8_plain
from yolov8_vit_tpu_torch.ops.nms import mask_scan_plain, nms_argmax_ml_plain
from yolov8_vit_tpu_torch.ops.quant import quant_mlp_ln_plain, quantize_weight

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_kernel_a_matches_plain(dev):
    g = _gen(0)
    ctr = torch.randn(4, 3000, 2, generator=g) * 80 + 320
    wh = torch.rand(4, 3000, 2, generator=g) * 100 + 10
    boxes = torch.round(torch.cat([ctr - wh / 2, ctr + wh / 2], -1))
    scores = torch.round(torch.rand(4, 3000, 5, generator=g) * 16) / 16
    boxes, scores = boxes.to(dev), scores.to(dev)
    got = ops.efficient_nms_scan(boxes, scores)
    ref = nms_argmax_ml_plain(boxes, scores, 0.65, 0.25, 100)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_kernel_b_matches_plain(dev):
    g = _gen(1)
    xy = torch.round(torch.rand(8, 100, 2, generator=g) * 200)
    boxes = torch.cat([xy, xy + torch.round(torch.rand(8, 100, 2, generator=g)
                                            * 40 + 5)], -1).to(dev)
    scores = torch.rand(8, 100, generator=g).to(dev)
    valid = (torch.rand(8, 100, generator=g) > 0.2).to(dev)
    got = ops.area_sorted_nms(boxes, scores, valid)
    pri = torch.where(valid & (scores > 0.35), ops.box_area(boxes), -1e9)
    assert torch.equal(got, mask_scan_plain(boxes, pri, 0.45))


def _w(g, fin, fout, dev):
    q, s = quantize_weight(torch.randn(fin, fout, generator=g) * fin ** -0.5)
    return q.to(dev), s.to(dev), (0.02 * torch.randn(fout, generator=g)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_c_matches_plain(dev, dtype):
    g = _gen(2)
    x = torch.randn(300, 128, generator=g).to(dev, dtype)
    ln = (torch.ones(128, device=dev), torch.zeros(128, device=dev))
    args = (x, *ln, *_w(g, 128, 512, dev), *_w(g, 512, 128, dev))
    got = ops.quant_mlp_ln_fused(*args).float()
    ref = quant_mlp_ln_plain(*args).float()
    # float order of LN / tanh differs: one output ulp or one int8 code
    assert float((got - ref).abs().max()) <= 0.05 + 2 ** -7 * float(
        ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_d_matches_plain(dev, dtype):
    g = _gen(3)
    x = torch.randn(5, 33, 128, generator=g).to(dev, dtype)
    ln = (torch.ones(128, device=dev), torch.zeros(128, device=dev))
    args = (x, *ln, *_w(g, 128, 384, dev), *_w(g, 128, 128, dev))
    got = ops.fused_attention_block_i8(*args, heads=4).float()
    ref = attn_block_i8_plain(*args, heads=4).float()
    assert float((got - ref).abs().max()) <= 0.05 + 2 ** -7 * float(
        ref.abs().max())
