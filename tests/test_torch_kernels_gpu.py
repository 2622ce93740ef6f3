"""PyTorch port, the CUDA kernels A-F against their plain versions on the
card, at small shapes and at ViT-B/8's 785 tokens.  Marked `cuda`: they skip where no CUDA device is
present (a CUDA kernel has no interpret mode).  On the GPU machine, which
has no jax for tests/conftest.py, run them with
`python3 -m pytest tests/test_torch_kernels_gpu.py -q --noconftest`.
chip_smoke.py repeats these checks at the main path's shapes."""
import pytest
import torch

from yolov8_vit_tpu_torch import ops
from yolov8_vit_tpu_torch.ops.attention import (attn_block_i8_plain,
                                                flash_attention_plain,
                                                fused_attention_block_plain)
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


def _close(got, ref, dtype, int8=False, f32_ref=None):
    """int8 products (a value at a .5 quantization boundary may take the
    neighbouring code): one output ulp or one int8 code, as for C.  Float
    products in bf16 (E, F): one output ulp (2^-7 of it) plus one element
    of P at its other bf16 neighbour (2^-8 |v . W| <= 2^-7); the mean error
    below 2^-9 of the mean |output|, and the error against the same
    function in f32 (`f32_ref`) at most 1.1x the plain version's.  Float
    products in f32: the kernels' f32 sums run in another order than
    torch's (1e-4 of a unit-size output).  As chip_smoke.py's KERNEL_TOL,
    FLOAT_BF16_TOL and F32_TOL."""
    got, ref = got.float(), ref.float()
    if int8:
        tol = (0.05, 2 ** -7)
    elif dtype == torch.bfloat16:
        tol = (2 ** -7, 2 ** -7)
        mean_rel = float((got - ref).abs().mean() / ref.abs().mean())
        assert mean_rel <= 2 ** -9, mean_rel
        ratio = float((got - f32_ref).abs().mean()
                      / (ref - f32_ref).abs().mean())
        assert ratio <= 1.1, ratio
    else:
        tol = (1e-4, 1e-4)
    assert torch.isfinite(got).all()
    assert bool(((got - ref).abs() <= tol[0] + tol[1] * ref.abs()).all()), \
        float((got - ref).abs().max())


# (crops, tokens, dim, heads): small, and ViT-B/8's 785 tokens at width 768
_ATTN_SHAPES = [(5, 33, 128, 4), (2, 785, 768, 12)]


@pytest.mark.parametrize("shape", _ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_d_matches_plain(dev, dtype, shape):
    b, t, d, heads = shape
    g = _gen(3)
    x = torch.randn(b, t, d, generator=g).to(dev, dtype)
    ln = (torch.ones(d, device=dev), torch.zeros(d, device=dev))
    args = (x, *ln, *_w(g, d, 3 * d, dev), *_w(g, d, d, dev))
    _close(ops.fused_attention_block_i8(*args, heads=heads),
           attn_block_i8_plain(*args, heads=heads), dtype, int8=True)


@pytest.mark.parametrize("t_real", [None, 30])
@pytest.mark.parametrize("shape", _ATTN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_e_matches_plain(dev, dtype, shape, t_real):
    b, t, d, heads = shape
    g = _gen(4)
    # a residual stream of the size of the attention's output, so that a
    # fault in the SDPA shows in the sum
    x = (0.05 * torch.randn(b, t, d, generator=g)).to(dev, dtype)
    ln = ((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
          (0.1 * torch.randn(d, generator=g)).to(dev))
    w = [(torch.randn(d, n, generator=g) * d ** -0.5).to(dev, dtype)
         for n in (3 * d, d)]
    bias = [(0.02 * torch.randn(n, generator=g)).to(dev) for n in (3 * d, d)]
    args = (x, *ln, w[0], bias[0], w[1], bias[1])
    _close(ops.fused_attention_block(*args, heads=heads, t_real=t_real),
           fused_attention_block_plain(*args, heads=heads, t_real=t_real),
           dtype, f32_ref=fused_attention_block_plain(
               *(a.float() for a in args), heads=heads, t_real=t_real))


@pytest.mark.parametrize("shape", [(3, 130, 4, 64), (2, 785, 12, 64),
                                   (2, 47, 2, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_f_matches_plain(dev, dtype, shape):
    g = _gen(5)
    q, k, v = (torch.randn(*shape, generator=g).to(dev, dtype)
               for _ in range(3))
    _close(ops.flash_attention(q, k, v), flash_attention_plain(q, k, v),
           dtype, f32_ref=flash_attention_plain(q.float(), k.float(),
                                                v.float()))
    b, t, h, c = shape               # strided views of one packed qkv
    qkv = torch.randn(b, t, 3, h, c, generator=g).to(dev, dtype)
    got = ops.flash_attention(*qkv.unbind(2))
    _close(got, flash_attention_plain(*qkv.unbind(2)), dtype,
           f32_ref=flash_attention_plain(*qkv.float().unbind(2)))
