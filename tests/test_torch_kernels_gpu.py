"""PyTorch port, the CUDA kernels A-K, mt::window_attn and mt::mlp_block
against their plain versions on the card, at small shapes, at ViT-B/8's
785 tokens and at SwinV2-B/256's stage shapes.  Marked `cuda`: they skip where no CUDA device is
present (a CUDA kernel has no interpret mode).  On the GPU machine, which
has no jax for tests/conftest.py, run them with
`python3 -m pytest tests/test_torch_kernels_gpu.py -q --noconftest`.
chip_smoke.py repeats these checks at the main path's shapes."""
import numpy as np
import pytest
import torch

from yolov8_vit_tpu_torch import _build, ops
from yolov8_vit_tpu_torch.ops.attention import (attn_block_i8_plain,
                                                flash_attention_plain,
                                                fused_attention_block_plain)
from yolov8_vit_tpu_torch.ops.fused_region import region_b1b2_plain
from yolov8_vit_tpu_torch.ops import nms
from yolov8_vit_tpu_torch.ops.nms import (mask_scan_plain, nms_argmax_ml_plain,
                                          nms_argmax_plain,
                                          single_label_candidates)
from yolov8_vit_tpu_torch.ops import quant
from yolov8_vit_tpu_torch.ops.quant import (quant_dense_plain, quant_mlp_plain,
                                            quant_mlp_ln_plain,
                                            quantize_weight)

from nms_cases import a_cases, b_case, b_grid, crowded_scene, i_cases

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


# (window, chunk) of kernels A and B: the defaults, and sizes that cross
# window and chunk boundaries at the test shapes (the select path too)
_NMS_SIZES = [(nms.NMS_WINDOW, nms.NMS_CHUNK), (4096, 256), (64, 32)]


def _sizes(monkeypatch, window, chunk):
    monkeypatch.setattr(nms, "NMS_WINDOW", window)
    monkeypatch.setattr(nms, "NMS_CHUNK", chunk)


def _assert_a(got, ref):
    for name, a, b in zip(("num_dets", "boxes", "scores", "labels"), got,
                          ref):
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.parametrize("window,chunk", _NMS_SIZES)
@pytest.mark.parametrize("case", ["dense", "dense_ties", "crowded",
                                  "all_above", "none_above", "at_threshold",
                                  "edges"])
def test_kernel_a_cases_match_plain(dev, monkeypatch, case, window, chunk):
    """tests/test_torch_nms_order.py's cases (held there against JAX by the
    rehearsal of this kernel's order), two images a batch: the case and
    its boxes shifted by 1.5 px."""
    b, s = (torch.from_numpy(a) for a in a_cases()[case])
    boxes = torch.stack([b, b + 1.5]).to(dev)
    scores = torch.stack([s, s.flip(0)]).to(dev)
    _sizes(monkeypatch, window, chunk)
    got = nms.nms_argmax_ml_kernel(boxes, scores, 0.65, 0.25, 100)
    _assert_a(got, nms_argmax_ml_plain(boxes, scores, 0.65, 0.25, 100))


def test_kernel_a_more_candidates_than_a_chunk_before_100_kept(dev):
    """The crowd: 10,000 candidates, one kept a cluster and class, so every
    chunk and window is decided before the pool runs out."""
    b, s = crowded_scene(2000, 2)
    boxes, scores = (torch.from_numpy(a)[None].to(dev) for a in (b, s))
    got = ops.efficient_nms_scan(boxes, scores)
    assert 0 < int(got[0][0]) < 100
    _assert_a(got, nms_argmax_ml_plain(boxes, scores, 0.65, 0.25, 100))


def _scene_1280(g, b, n, c, hot):
    """Clustered boxes over a 1280 x 1280 input, a `hot` share of anchors
    with one class above the threshold (scores on a 1/16 grid)."""
    ctr = torch.rand(b, n, 2, generator=g) * 1200 + 40
    wh = torch.rand(b, n, 2, generator=g) * 140 + 20
    boxes = torch.round(torch.cat([ctr - wh / 2, ctr + wh / 2], -1) * 2) / 2
    scores = torch.rand(b, n, c, generator=g) * 0.2
    on = torch.rand(b, n, generator=g) < hot
    cls = torch.randint(0, c, (b, n), generator=g)
    val = torch.round((torch.rand(b, n, generator=g) * 0.65 + 0.3) * 16) / 16
    scores.scatter_(2, cls[..., None], torch.where(
        on, val, scores.gather(2, cls[..., None])[..., 0])[..., None])
    return boxes, scores


@pytest.mark.parametrize("hot", [0.2, 1.0])
def test_kernel_a_at_1280(dev, hot):
    """A 1280 x 1280 input: 33,600 anchors x 5 classes = 168,000 entries a
    frame, 32 frames (the old kernel's shared memory held 58,095); with
    every anchor hot, 33,600 candidates a frame, eight windows and more."""
    boxes, scores = (t.to(dev) for t in _scene_1280(_gen(17), 32, 33600, 5,
                                                    hot))
    got = ops.efficient_nms_scan(boxes, scores)
    assert int(got[0].min()) == 100
    _assert_a(got, nms_argmax_ml_plain(boxes, scores, 0.65, 0.25, 100))


def test_kernel_a_nan_score_keeps_nothing(dev):
    b, s = (torch.from_numpy(a) for a in a_cases()["dense"])
    scores = torch.stack([s, s]).to(dev)
    scores[1, 7, 2] = float("nan")
    boxes = torch.stack([b, b]).to(dev)
    got = ops.efficient_nms_scan(boxes, scores)
    assert int(got[0][0]) == 100 and int(got[0][1]) == 0
    _assert_a(got, nms_argmax_ml_plain(boxes, scores, 0.65, 0.25, 100))


@pytest.mark.parametrize("window,chunk", _NMS_SIZES)
@pytest.mark.parametrize("t", [1, 100, 129, 1000])
def test_kernel_b_rows_match_plain(dev, monkeypatch, t, window, chunk):
    """Area ties, a pair at IoU exactly .45, a zero-area row, scores
    exactly at 0.35, invalid rows; three images a batch.  The kernel makes
    the priorities from f32 boxes and scores."""
    rows = [b_case(t, 20 + i) for i in range(3)]
    boxes, scores, valid = (torch.from_numpy(np.stack(x)).to(dev)
                            for x in zip(*rows))
    _sizes(monkeypatch, window, chunk)
    got = nms.mask_scan_kernel(boxes, scores, valid, None, 0.45, 0.35)
    pri = nms.mask_priority(boxes, scores, valid, 0.35)
    assert torch.equal(got, mask_scan_plain(boxes, pri, 0.45))
    assert torch.equal(ops.area_sorted_nms(boxes, scores, valid), got)


@pytest.mark.parametrize("window,chunk", _NMS_SIZES)
def test_kernel_b_keeps_more_than_its_shared_copy(dev, monkeypatch, window,
                                                  chunk):
    """3,000 rows of which about 2,600 are kept: past the 1,024 kept boxes
    the kernel holds in shared memory, it reads the rest from its kept
    list in device memory."""
    rows = [b_grid(3000, 40 + i) for i in range(2)]
    boxes, scores, valid = (torch.from_numpy(np.stack(x)).to(dev)
                            for x in zip(*rows))
    _sizes(monkeypatch, window, chunk)
    got = nms.mask_scan_kernel(boxes, scores, valid, None, 0.45, 0.35)
    pri = nms.mask_priority(boxes, scores, valid, 0.35)
    assert int(got.sum(1).min()) > 1024
    assert torch.equal(got, mask_scan_plain(boxes, pri, 0.45))


def test_kernel_b_bf16_boxes_take_the_wrapper_priority(dev):
    """bf16 boxes: the area is taken in bf16 (as JAX takes it), by
    mask_priority, and handed to the kernel."""
    bx, sc, valid = (torch.from_numpy(x).to(dev) for x in b_case(100, 30))
    bx16 = bx.to(torch.bfloat16)
    got = ops.area_sorted_nms(bx16, sc, valid)
    pri = nms.mask_priority(bx16, sc, valid, 0.35)
    assert torch.equal(got, mask_scan_plain(bx16.float()[None], pri[None],
                                            0.45)[0])


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
        # as a product: at T = 1 both are exact (0 <= 1.1 x 0)
        err, ref_err = (float((x - f32_ref).abs().mean())
                        for x in (got, ref))
        assert err <= 1.1 * ref_err, (err, ref_err)
    else:
        tol = (1e-4, 1e-4)
    assert torch.isfinite(got).all()
    assert bool(((got - ref).abs() <= tol[0] + tol[1] * ref.abs()).all()), \
        float((got - ref).abs().max())


# (crops, tokens, dim, heads): small, and ViT-B/8's 785 tokens at width 768
_ATTN_SHAPES = [(5, 33, 128, 4), (2, 785, 768, 12)]
# E beside those: sequences about the 64-key tiles and the 64-row query
# tiles of the bf16 SDPA core (ragged tiles, a 4-stage ring that
# wraps), head dims 16, 32 and 64, several images (the image boundary of
# its 3-D tensor maps)
_E_SHAPES = _ATTN_SHAPES + [(3, 1, 64, 4), (2, 63, 128, 2), (2, 64, 64, 2),
                            (3, 65, 64, 4), (2, 127, 128, 4),
                            (2, 128, 128, 2), (3, 129, 64, 2),
                            (2, 197, 768, 12)]


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
@pytest.mark.parametrize("shape", _E_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_e_matches_plain(dev, dtype, shape, t_real):
    """t_real 30 masks keys of the longer sequences; past T it masks
    nothing."""
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


# (B, T, H, hd): the sequences of _E_SHAPES and more, head dims 16, 32, 64
_F_SHAPES = [(3, 130, 4, 64), (2, 785, 12, 64), (2, 47, 2, 32),
             (2, 1, 2, 16), (3, 63, 2, 64), (2, 64, 3, 32), (2, 65, 2, 16),
             (2, 127, 2, 64), (3, 128, 2, 32), (2, 129, 4, 16),
             (2, 197, 12, 64), (2, 785, 4, 32)]


@pytest.mark.parametrize("shape", _F_SHAPES)
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


# head dims the SDPA core does not run (48, 80: zero-padded to 64, 128),
# its largest fast one, 128, and the wide form's (136 padded to 144, 192,
# 256)
_PAD_SHAPES = [(2, 65, 96, 2), (2, 130, 160, 2), (3, 129, 256, 2),
               (2, 785, 384, 3), (2, 33, 272, 2), (2, 97, 384, 2),
               (2, 197, 512, 2)]


@pytest.mark.parametrize("shape", _PAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_d_e_f_at_head_dims_48_80_128(dev, dtype, shape):
    b, t, d, heads = shape
    g = _gen(21)
    ln = ((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
          (0.1 * torch.randn(d, generator=g)).to(dev))
    x = torch.randn(b, t, d, generator=g).to(dev, dtype)
    args = (x, *ln, *_w(g, d, 3 * d, dev), *_w(g, d, d, dev))
    _close(ops.fused_attention_block_i8(*args, heads=heads),
           attn_block_i8_plain(*args, heads=heads), dtype, int8=True)
    x = (0.05 * torch.randn(b, t, d, generator=g)).to(dev, dtype)
    w = [(torch.randn(d, n, generator=g) * d ** -0.5).to(dev, dtype)
         for n in (3 * d, d)]
    bias = [(0.02 * torch.randn(n, generator=g)).to(dev) for n in (3 * d, d)]
    args = (x, *ln, w[0], bias[0], w[1], bias[1])
    _close(ops.fused_attention_block(*args, heads=heads),
           fused_attention_block_plain(*args, heads=heads), dtype,
           f32_ref=fused_attention_block_plain(*(a.float() for a in args),
                                               heads=heads))
    q, k, v = (torch.randn(b, t, heads, d // heads, generator=g)
               .to(dev, dtype) for _ in range(3))
    got = ops.flash_attention(q, k, v)
    assert got.shape == q.shape
    _close(got, flash_attention_plain(q, k, v), dtype,
           f32_ref=flash_attention_plain(q.float(), k.float(), v.float()))


def test_head_dim_above_128_raises(dev):
    """Head dims above 128 no longer raise: F at 136 (padded to 144) runs
    the wide form and matches its plain version; fp16 still raises."""
    g = _gen(22)
    q, k, v = (torch.randn(1, 40, 2, 136, generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    _close(ops.flash_attention(q, k, v), flash_attention_plain(q, k, v),
           torch.bfloat16,
           f32_ref=flash_attention_plain(q.float(), k.float(), v.float()))
    with pytest.raises(ValueError, match="multiple of 8 and of heads"):
        ops.flash_attention(q.half(), k.half(), v.half())


# ---- G-J ---------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(300, 96, 64), (77, 768, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_g_matches_plain_bit_for_bit(dev, dtype, shape):
    """Without SiLU: exact int8 sums and three uncontracted f32 operations,
    so the kernel equals its plain version exactly, also through a
    transposed weight made ahead."""
    m, k, n = shape
    g = _gen(6)
    x = torch.randn(m, k, generator=g).to(dev, dtype)
    w, s, b = _w(g, k, n, dev)
    ref = quant_dense_plain(x, w, s, b)
    got = ops.quant_dense_fused(x, w, s, b)
    assert torch.equal(got, ref), (int((got != ref).sum()),
                                   float((got.float() - ref.float())
                                         .abs().max()))
    assert torch.equal(ops.quant_dense_fused(x, w, s, b,
                                             w_t=w.t().contiguous()), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_g_silu_matches_plain(dev, dtype):
    """With SiLU the card's expf and torch.sigmoid differ by a few f32
    ulps: 4 ulps (2^-21 relative) at f32, one output ulp at bf16."""
    g = _gen(7)
    x = torch.randn(500, 128, generator=g).to(dev, dtype)
    w, s, b = _w(g, 128, 256, dev)
    got = ops.quant_dense_fused(x, w, s, b, silu=True).float()
    ref = quant_dense_plain(x, w, s, b, silu=True).float()
    rtol = 2.0 ** -21 if dtype == torch.float32 else 2.0 ** -7
    assert bool(((got - ref).abs() <= 1e-7 + rtol * ref.abs()).all()), \
        float((got - ref).abs().max())


def test_kernel_g_takes_odd_k(dev):
    """K = 40: the wrapper pads x's columns and the weight to 48."""
    g = _gen(8)
    x = torch.randn(8, 40, generator=g).to(dev)
    w, s, b = _w(g, 40, 16, dev)
    assert torch.equal(ops.quant_dense_fused(x, w, s, b),
                       quant_dense_plain(x, w, s, b))


def test_kernel_g_takes_n_off_8(dev):
    """N = 20: the output's rows are written by TMA, which takes 16-byte
    strides, so the wrapper pads N to 32 and slices."""
    g = _gen(8)
    x = torch.randn(8, 32, generator=g).to(dev)
    w, s, b = _w(g, 32, 20, dev)
    assert torch.equal(ops.quant_dense_fused(x, w, s, b),
                       quant_dense_plain(x, w, s, b))


@pytest.mark.parametrize("m,k,n", [(77, 40, 20), (300, 100, 30), (5, 8, 3),
                                   (197, 776, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_g_odd_shapes_bit_for_bit(dev, dtype, m, k, n):
    """K and N off 16 and 8, bit for bit, with the weight's (out, in) copy
    made by the wrapper, given padded (`padded_t`, as QDense.derive makes
    it) or given as the plain transpose."""
    g = _gen(18)
    x = torch.randn(m, k, generator=g).to(dev, dtype)
    w, s, b = _w(g, k, n, dev)
    ref = quant_dense_plain(x, w, s, b)
    for w_t in (None, quant.padded_t(w), w.t().contiguous()):
        got = ops.quant_dense_fused(x, w, s, b, w_t=w_t)
        assert torch.equal(got, ref), (int((got != ref).sum()),
                                       float((got.float() - ref.float())
                                             .abs().max()))


@pytest.mark.parametrize("m,d,hid", [(300, 40, 100), (197, 200, 780),
                                     (5, 8, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_c_h_odd_widths_match_plain(dev, dtype, m, d, hid):
    """D and hidden widths off 16: rows, weights, scales and biases
    zero-padded, LN statistics over the real D."""
    g = _gen(19)
    x = torch.randn(m, d, generator=g).to(dev, dtype)
    res = torch.randn(m, d, generator=g).to(dev, dtype)
    ln = ((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
          (0.1 * torch.randn(d, generator=g)).to(dev))
    w = (*_w(g, d, hid, dev), *_w(g, hid, d, dev))
    got = ops.quant_mlp_ln_fused(x, *ln, *w)
    assert got.shape == x.shape
    _close(got, quant_mlp_ln_plain(x, *ln, *w), dtype, int8=True)
    _close(ops.quant_mlp_fused(x, res, *w), quant_mlp_plain(x, res, *w),
           dtype, int8=True)


@pytest.mark.parametrize("shape", [(3, 17, 40, 2), (2, 33, 24, 3),
                                   (2, 50, 100, 2), (2, 65, 48, 3),
                                   (4, 197, 120, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_d_odd_widths_match_plain(dev, dtype, shape):
    """D off 16 and head dims the SDPA core does not run (20, 8, 50, 60:
    each head zero-padded to 32, 16, 64, 64), and D = 48 (head dim 16)."""
    b, t, d, heads = shape
    g = _gen(20)
    x = torch.randn(b, t, d, generator=g).to(dev, dtype)
    ln = ((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
          (0.1 * torch.randn(d, generator=g)).to(dev))
    args = (x, *ln, *_w(g, d, 3 * d, dev), *_w(g, d, d, dev))
    got = ops.fused_attention_block_i8(*args, heads=heads)
    assert got.shape == x.shape
    _close(got, attn_block_i8_plain(*args, heads=heads), dtype, int8=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_h_matches_plain(dev, dtype):
    g = _gen(9)
    h = torch.randn(300, 128, generator=g).to(dev, dtype)
    res = torch.randn(300, 128, generator=g).to(dev, dtype)
    args = (h, res, *_w(g, 128, 512, dev), *_w(g, 512, 128, dev))
    _close(ops.quant_mlp_fused(*args), quant_mlp_plain(*args), dtype,
           int8=True)


def _single_label_inputs(g, b, n):
    ctr = torch.randn(b, n, 2, generator=g) * 120 + 150
    wh = torch.rand(b, n, 2, generator=g) * 100 + 10
    boxes = torch.round(torch.cat([ctr - wh / 2, ctr + wh / 2], -1) * 2) / 2
    scores = torch.round(torch.rand(b, n, 5, generator=g) * 16) / 16
    return boxes, scores


def test_kernel_i_matches_plain(dev):
    boxes, scores = (t.to(dev) for t in _single_label_inputs(_gen(10), 4,
                                                            3000))
    scores[1] = 0.0                                    # an empty image
    got = ops.efficient_nms_scan(boxes, scores, multi_label=False)
    ref = nms_argmax_plain(boxes, *single_label_candidates(boxes, scores),
                           0.65, 0.25, 100)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(got[0][1]) == 0 and int(got[0][0]) > 10


def _assert_i(boxes, scores):
    got = ops.efficient_nms_scan(boxes, scores, multi_label=False)
    _assert_a(got, nms_argmax_plain(boxes, *single_label_candidates(
        boxes, scores), 0.65, 0.25, 100))
    return got


@pytest.mark.parametrize("window,chunk", _NMS_SIZES + [(32, 32)])
@pytest.mark.parametrize("case", ["dense", "dense_ties", "crowded",
                                  "straddle", "nan"])
def test_kernel_i_cases_match_plain(dev, monkeypatch, case, window, chunk):
    """tests/test_torch_nms_order.py's single-label cases (held there
    against JAX by the rehearsal of this kernel's order: the straddle
    case's pairs decide by direction), two images a batch."""
    b, s = (torch.from_numpy(a) for a in i_cases()[case])
    boxes = torch.stack([b, b + 1.5]).to(dev)
    scores = torch.stack([s, s.flip(0)]).to(dev)
    _sizes(monkeypatch, window, chunk)
    got = _assert_i(boxes, scores)
    if case == "nan":
        assert int(got[0].max()) == 0


@pytest.mark.parametrize("n", [33600, 134400])
def test_kernel_i_at_1280_and_past_the_old_cap(dev, n):
    """33,600 anchors (1280 x 1280) and 134,400 (2560 x 2560, past the old
    kernel's 58,046-anchor cap), 8 frames; a NaN score in one frame keeps
    nothing there."""
    boxes, scores = (t.to(dev) for t in _scene_1280(_gen(22), 8, n, 5, 0.2))
    scores[3, 17, 2] = float("nan")
    got = _assert_i(boxes, scores)
    assert int(got[0][3]) == 0 and int(got[0][0]) == 100


def _j_case(dev, shape, seed=11):
    b, h, w, c1, c2 = shape
    c = c2 // 2
    g = _gen(seed)

    def conv(kh, cin, cout):
        return {"conv": {
            "kernel": (torch.randn(kh, kh, cin, cout, generator=g) * 0.08)
            .to(torch.bfloat16).to(dev),
            "bias": (torch.randn(cout, generator=g) * 0.1).to(dev)}}

    params = {"b1": conv(3, c1, c2), "cv1": conv(1, c2, c2),
              "m0_cv1": conv(3, c, c), "m0_cv2": conv(3, c, c),
              "cv2": conv(1, 3 * c, c2)}
    x = (torch.randn(b, h, w, c1, generator=g) * 0.3).to(dev, torch.bfloat16)
    return x, params


def _assert_j(got, ref, shape):
    b, h, w, _, c2 = shape
    assert got.shape == ref.shape == (b, h // 2, w // 2, c2)
    d = (got - ref).abs()
    std = float(ref.std())
    assert bool((d <= 0.05 * std + 2.0 ** -7 * ref.abs()).all()), \
        (float(d.max()), std)
    assert float(d.mean()) <= 0.005 * std, (float(d.mean()), std)


@pytest.mark.parametrize("shape", [(2, 48, 80, 16, 32), (1, 34, 30, 32, 64),
                                   (2, 100, 76, 16, 32),
                                   (1, 320, 320, 32, 64),
                                   (3, 122, 246, 32, 64),
                                   (2, 66, 90, 48, 96),
                                   (1, 64, 64, 64, 128),
                                   (1, 40, 56, 80, 160)])
def test_kernel_j_matches_plain(dev, shape):
    """bf16 reassociation class: |d| <= 0.05 std(ref) + one bf16 ulp of
    the output, mean |d| <= 0.005 std(ref) (chip_smoke.py's REGION_TOL
    states why).  Both widths of the fused kernel: outputs narrower than
    one 60-column strip (15 x 17), a ragged last strip (38, 123 columns),
    odd output rows (61), one frame at the deployed shape; YOLOv8-m's,
    -l's and -x's widths (48, 96), (64, 128), (80, 160) on the five-launch
    form; weights prepared once and from the dict, the same result."""
    x, params = _j_case(dev, shape)
    prep = ops.prepare_region(params, dev)
    assert prep.fused == (shape[3:] in ((16, 32), (32, 64)))
    got = ops.fused_b1b2(x, prep).float()
    assert torch.equal(got, ops.fused_b1b2(x, params).float())
    _assert_j(got, region_b1b2_plain(x, params).float(), shape)


def test_kernel_j_silu_table_matches_plain(dev):
    """J's SiLU epilogue on every finite bf16 value against the plain
    `silu_bf16` on the card, bit for bit: the five-launch form's exact
    logistic everywhere; the fused kernel's special-function logistic
    wherever 1 + e^-y <= 2^126 (y > -87.34), below which __fdividef
    returns 0 for a logistic under 2^-126, so that SiLU is -0 where the
    plain version is under 2^-119 in magnitude."""
    from yolov8_vit_tpu_torch.ops import fused_region as fr
    fast, exact = fr.silu_table(dev)
    y = torch.arange(65536, dtype=torch.int32).to(torch.int16) \
        .view(torch.bfloat16).to(dev)
    fin = torch.isfinite(y.float())
    plain = fr.silu_bf16(y.float().reshape(-1, 1, 1),
                         torch.zeros(65536, device=dev)).reshape(-1)
    bits = [t.view(torch.int16) for t in (fast, exact, plain)]
    assert bool((bits[1] == bits[2])[fin].all())
    flush = y.float() <= -87.34
    assert bool((bits[0] == bits[2])[fin & ~flush].all())
    d = (fast.float() - plain.float()).abs()[fin & flush]
    assert float(d.max()) < 2.0 ** -119


# ---- C, D, G, H at ViT-B widths on the int8 wgmma GEMM ------------------------
# rows of the main path: one crop, three crops (a ragged 256-row tile), the
# B/16 path's 64 crops of 197 tokens and the crowd cell's ladder chunk of
# 512 crops
_VIT_ROWS = (197, 3 * 197, 64 * 197, 512 * 197)
_VIT_D, _VIT_HID = 768, 3072


def _vit_ln(g, dev):
    return ((1 + 0.1 * torch.randn(_VIT_D, generator=g)).to(dev),
            (0.1 * torch.randn(_VIT_D, generator=g)).to(dev))


@pytest.mark.parametrize("m", _VIT_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_c_matches_plain_at_vit_b(dev, dtype, m):
    g = _gen(12)
    x = torch.randn(m, _VIT_D, generator=g).to(dev, dtype)
    args = (x, *_vit_ln(g, dev), *_w(g, _VIT_D, _VIT_HID, dev),
            *_w(g, _VIT_HID, _VIT_D, dev))
    _close(ops.quant_mlp_ln_fused(*args), quant_mlp_ln_plain(*args), dtype,
           int8=True)


@pytest.mark.parametrize("m", _VIT_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_h_matches_plain_at_vit_b(dev, dtype, m):
    g = _gen(13)
    h = torch.randn(m, _VIT_D, generator=g).to(dev, dtype)
    res = torch.randn(m, _VIT_D, generator=g).to(dev, dtype)
    args = (h, res, *_w(g, _VIT_D, _VIT_HID, dev),
            *_w(g, _VIT_HID, _VIT_D, dev))
    _close(ops.quant_mlp_fused(*args), quant_mlp_plain(*args), dtype,
           int8=True)


@pytest.mark.parametrize("crops,t", [(1, 197), (3, 197), (64, 197),
                                     (8, 785), (512, 197)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_d_matches_plain_at_vit_b(dev, dtype, crops, t):
    g = _gen(14)
    x = torch.randn(crops, t, _VIT_D, generator=g).to(dev, dtype)
    args = (x, *_vit_ln(g, dev), *_w(g, _VIT_D, 3 * _VIT_D, dev),
            *_w(g, _VIT_D, _VIT_D, dev))
    _close(ops.fused_attention_block_i8(*args, heads=12),
           attn_block_i8_plain(*args, heads=12), dtype, int8=True)


@pytest.mark.parametrize("m", [197, 64 * 197])
@pytest.mark.parametrize("k,n", [(768, 2304), (768, 768), (768, 3072),
                                 (3072, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_g_bit_for_bit_at_vit_b(dev, dtype, k, n, m):
    g = _gen(15)
    x = torch.randn(m, k, generator=g).to(dev, dtype)
    w, s, b = _w(g, k, n, dev)
    got = ops.quant_dense_fused(x, w, s, b, w_t=w.t().contiguous())
    ref = quant_dense_plain(x, w, s, b)
    assert torch.equal(got, ref), (int((got != ref).sum()),
                                   float((got.float() - ref.float())
                                         .abs().max()))


@pytest.mark.parametrize("m", [197, 3 * 197, 300])
def test_kernel_c_writes_no_row_past_m(dev, m):
    """The rows of a tile past m (a CTA's 128, a cluster's 256; at m = 300
    one CTA's rows lie wholly past m) hold zero rows of the activations,
    whose fc1 epilogue gives gelu(b1) != 0: the kernel must store none of
    them.  The output is a view whose tail (one whole cluster tile) holds a
    sentinel."""
    g = _gen(16)
    x = torch.randn(m, _VIT_D, generator=g).to(dev, torch.bfloat16)
    lns, lnb = _vit_ln(g, dev)
    w1, s1, b1 = _w(g, _VIT_D, _VIT_HID, dev)
    w2, s2, b2 = _w(g, _VIT_HID, _VIT_D, dev)
    buf = torch.full((m + 256, _VIT_D), 7.0, dtype=x.dtype, device=dev)
    out = quant._launch_mlp(
        "kernel C", x, x, (lns, lnb), w1.t().contiguous(), s1, b1,
        w2.t().contiguous(), s2, b2, 1e-6, out=buf[:m])
    torch.cuda.synchronize()
    assert bool((buf[m:] == 7.0).all())
    _close(out, quant_mlp_ln_plain(x, lns, lnb, w1, s1, b1, w2, s2, b2),
           torch.bfloat16, int8=True)


# ---- the int8 GEMM's persistent walk -----------------------------------------
# (m, n, k) against its 256 x 128 cluster tiles and the card's 66 clusters
# of two CTAs: fewer tiles than clusters, one wave (66 tiles), and several
# waves with a ragged last row tile, at fc2 / proj's n = 768 (a last wave
# part full), qkv's 2304 and the SiLU layer's 64; k of one k-tile, six and
# 24
_WALK = [(300, 256, 128), (11 * 256, 768, 768), (12608 + 77, 768, 3072),
         (12608, 2304, 768), (512 * 197, 64, 64)]


@pytest.mark.parametrize("m,n,k", _WALK)
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_gemm_walk_g_bit_for_bit(dev, dtype, silu, m, n, k):
    """Kernel G, the bias and SiLU epilogues, bit for bit against the plain
    version at every tile count of the walk."""
    g = _gen(21)
    x = torch.randn(m, k, generator=g).to(dev, dtype)
    w, s, b = _w(g, k, n, dev)
    got = ops.quant_dense_fused(x, w, s, b, silu=silu,
                                w_t=w.t().contiguous())
    ref = quant_dense_plain(x, w, s, b, silu=silu)
    assert torch.equal(got, ref), (int((got != ref).sum()),
                                   float((got.float() - ref.float())
                                         .abs().max()))


@pytest.mark.parametrize("m", [300, 11 * 256, 12608 + 77])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_gemm_walk_c_h_match_plain(dev, dtype, m):
    """The amax, quantize and residual epilogues (kernels C and H at ViT-B
    widths: fc1 24 column tiles wide, fc2 6) at the walk's row counts."""
    g = _gen(23)
    x = torch.randn(m, _VIT_D, generator=g).to(dev, dtype)
    res = torch.randn(m, _VIT_D, generator=g).to(dev, dtype)
    w = (*_w(g, _VIT_D, _VIT_HID, dev), *_w(g, _VIT_HID, _VIT_D, dev))
    lns, lnb = _vit_ln(g, dev)
    _close(ops.quant_mlp_ln_fused(x, lns, lnb, *w),
           quant_mlp_ln_plain(x, lns, lnb, *w), dtype, int8=True)
    _close(ops.quant_mlp_fused(x, res, *w), quant_mlp_plain(x, res, *w),
           dtype, int8=True)


def _fc1_weights(g, kind, dev):
    """fc1's weights: seeded ("random"); scaled so that every row's fc1 is
    below 1/2 ("small"); or each column repeated in the next ("tied"), so
    that every value of a row appears twice."""
    w1, s1, b1 = _w(g, _VIT_D, _VIT_HID, dev)
    if kind == "small":
        s1 = s1 * 1e-3
        b1 = b1 * 1e-3
    elif kind == "tied":
        w1, s1, b1 = (t[..., ::2].repeat_interleave(2, -1).contiguous()
                      for t in (w1, s1, b1))
    return w1, s1, b1


@pytest.mark.parametrize("weights", ["random", "small", "tied"])
@pytest.mark.parametrize("m", [197, 12608 + 77, 512 * 197])
def test_kernel_c_fc1_codes_are_plain_bit_for_bit(dev, m, weights):
    """C's int8 fc1 codes and row scales (the chain's scratch) equal the
    plain quantize_act(gelu(fc1)) bit for bit, fc1 the exact int8 product
    of the chain's own quantized LN rows rescaled in f32: the amax pass's atomic maxima and the quantize
    pass's codes lose nothing to the walk, on seeded weights and on rows
    of ties or of values below 1/2."""
    g = _gen(24)
    x = torch.randn(m, _VIT_D, generator=g).to(dev, torch.bfloat16)
    lns, lnb = _vit_ln(g, dev)
    w1, s1, b1 = _fc1_weights(g, weights, dev)
    w2, s2, b2 = _w(g, _VIT_HID, _VIT_D, dev)
    i8, f32 = torch.int8, torch.float32
    hq = torch.empty(m, _VIT_D, dtype=i8, device=dev)
    aq = torch.empty(m, _VIT_HID, dtype=i8, device=dev)
    sx, sa = (torch.empty(m, dtype=f32, device=dev) for _ in range(2))
    amax = torch.empty(m, dtype=torch.int32, device=dev)
    out = torch.empty_like(x)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    _build.launch("quant_mlp", "launch_quant_mlp", quant._QUANT_MLP_ARGS,
                  x.data_ptr(), x.data_ptr(), quant.DTYPE_CODES[x.dtype], m,
                  _VIT_D, _VIT_D, _VIT_HID, lns.data_ptr(), lnb.data_ptr(),
                  1e-6, w1t.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                  w2t.data_ptr(), s2.data_ptr(), b2.data_ptr(),
                  hq.data_ptr(), sx.data_ptr(), amax.data_ptr(),
                  aq.data_ptr(), sa.data_ptr(), out.data_ptr(),
                  what="kernel C")
    fc1 = (quant.int8_matmul(hq, w1) * sx[:, None] * s1[None, :]
           + b1[None, :])
    ref_q, ref_s = quant.quantize_act(quant.gelu_tanh(fc1))
    assert torch.equal(sa, ref_s[:, 0])
    assert torch.equal(aq, ref_q), int((aq != ref_q).sum())


def test_detector_train_step_card_matches_cpu(dev):
    """One optimizer step of the detector's training form (YOLOv8-n at 128
    x 128, f32, batch 2, seeded params and gt) on the card and on the CPU,
    with cuDNN's TF32 switch at PyTorch's default (on): the trainer holds
    full f32 itself, backward included, and leaves the switch as it found
    it.  Loss within 1e-4 relative, each leaf's clipped gradient within
    1e-3 of its largest |g|, params within 1e-6 (chip_smoke.py's
    TRAIN_STEP_TOL, whose param bar assumes lr0 = 1e-4: the step is taken
    past the warmup, as phase 15's)."""
    from yolov8_vit_tpu_torch.config import DetectConfig
    from yolov8_vit_tpu_torch.train import yolo_train as yt
    cfg = DetectConfig(input_size=(128, 128), variant="n")
    g = _gen(17)
    imgs = torch.rand(2, 128, 128, 3, generator=g)
    xy = torch.rand(2, 4, 2, generator=g) * 80
    boxes = torch.cat([xy, xy + 12 + torch.rand(2, 4, 2, generator=g) * 36],
                      -1)
    labels = torch.randint(0, 5, (2, 4), generator=g, dtype=torch.int32)
    mask = torch.tensor([[True, True, True, False], [True, False, False,
                                                     False]])
    out = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for device in ("cpu", dev):
            model = yt.build_train_model(cfg, None, device)
            named = dict(model.named_parameters())
            opt = yt.make_yolo_optimizer(named, 1e-4, 1.0, 1, 1, 100)
            opt.count = 100      # past the warmup: every group at lr0
            grads = {}
            opt.sgd.register_step_pre_hook(lambda *_: grads.update(
                {n: p.grad.detach().cpu().clone() for n, p in named.items()}))
            step = yt.make_yolo_train_step(model, opt, cfg.input_size)
            loss, _ = step(*(t.to(device) for t in (imgs, boxes, labels,
                                                    mask)))
            out[str(device)] = (float(loss), grads,
                                {n: p.detach().cpu() for n, p in
                                 named.items()})
            assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    (cl, cg, cp), (gl, gg, gp) = out["cpu"], out[str(dev)]
    assert abs(gl - cl) <= 1e-4 * abs(cl)
    for n in cg:
        assert float((gg[n] - cg[n]).abs().max()) <= \
            1e-3 * float(cg[n].abs().max()), n
        assert float((gp[n] - cp[n]).abs().max()) <= 1e-6, n


# ---- kernel K: the detector's ConvBlock (tests/conv_cases.py's bar) ----

def _detector(variant, dtype=torch.bfloat16, seed=3):
    from yolov8_vit_tpu_torch.models import yolov8 as y
    g = _gen(seed)
    det = y.YOLOv8(y.YOLOV8_VARIANTS[variant], dtype=dtype)
    for m in det.modules():
        if isinstance(m, y.Conv):
            m.reset(g)
    det.prepare()
    return det


@pytest.mark.parametrize("variant,batch", [("s", 32), ("n", 4), ("m", 4)])
def test_kernel_k_matches_chain_at_every_convblock(dev, variant, batch):
    """Every distinct ConvBlock call of a bf16 forward at 640 (channel
    slices, residuals and all), kernel K against the chain on random
    operands of the recorded shapes and strides: YOLOv8-s at batch 32 (the
    benchmark's), -n and -m widths at batch 4."""
    import conv_cases
    det = _detector(variant).to(dev)
    x = torch.rand(batch, 640, 640, 3, generator=_gen(4)).to(
        dev, torch.bfloat16)
    rows = conv_cases.check_model(det, x)
    assert sum(r["calls"] for r in rows.values()) == \
        conv_cases.convblock_calls(det)
    bad = {k: r for k, r in rows.items()
           if r["beyond_bar"] or r["differ_share"] > conv_cases.DIFFER_SHARE}
    assert not bad, bad


@pytest.mark.parametrize("shape", [
    # (batch, h, w, cin, cout, k, stride): odd sizes, ragged K-blocks and
    # out channels past a tile
    (2, 13, 17, 24, 40, 3, 1), (1, 13, 17, 24, 40, 3, 2),
    (3, 9, 20, 72, 136, 1, 1), (2, 21, 11, 3, 48, 3, 2),
    (1, 7, 5, 3, 16, 3, 2), (2, 30, 34, 16, 200, 3, 1)])
def test_kernel_k_odd_shapes_match_chain(dev, shape):
    import conv_cases
    b, h, w, cin, cout, k, s = shape
    sig = ((b, h, w, cin), cin + (8 if cin % 8 == 0 else 0), (cout, k, k, cin),
           s, None, cout)
    if cin == 3:
        sig = ((b, h, w, cin), 3, (cout, k, k, cin), s, None, cout)
    x, wk, bias, s, res, out = conv_cases.case(sig, dev, seed=5)
    ops.conv_silu(x, wk, bias, s, res, out)
    torch.cuda.synchronize()
    r = conv_cases.compare(x, wk, bias, s, res, out)
    assert r["beyond_bar"] == 0 and r["differ_share"] <= \
        conv_cases.DIFFER_SHARE, r


def test_kernel_k_residual_and_slices_leave_the_rest(dev):
    """A bottleneck's cv2 as C2f calls it: input, residual and output
    channel slices of wider buffers; the output buffer's other channels
    are not written."""
    import conv_cases
    sig = ((2, 40, 40, 32), 128, (32, 3, 3, 32), 1, 128, 128)
    x, wk, bias, s, res, out = conv_cases.case(sig, dev, seed=6)
    buf = out._base
    buf.fill_(0.25)
    before = buf.clone()
    ops.conv_silu(x, wk, bias, s, res, out)
    torch.cuda.synchronize()
    assert conv_cases.compare(x, wk, bias, s, res, out)["beyond_bar"] == 0
    keep = torch.ones(buf.shape[-1], dtype=torch.bool, device=dev)
    keep[96:] = False
    assert torch.equal(buf[..., keep], before[..., keep])


def test_kernel_k_launches_54_a_bf16_forward_and_none_in_f32(dev):
    det = _detector("s").to(dev)
    x = torch.rand(2, 640, 640, 3, generator=_gen(7)).to(dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        det(x.to(torch.bfloat16))
    assert ops.launch_counts()["conv_silu"] == 54
    ops.reset_launch_counts()
    with torch.no_grad():
        _detector("s", torch.float32).to(dev)(x)
    assert ops.launch_counts()["conv_silu"] == 0


# SwinV2-B/256's stage shapes (crops, grid, C, heads, window, shift): each
# stage's unshifted block, and the shifted one where the stage has it
_WIN_SHAPES = [(4, 64, 128, 4, 16, 0), (4, 64, 128, 4, 16, 8),
               (4, 32, 256, 8, 16, 0), (4, 32, 256, 8, 16, 8),
               (4, 16, 512, 16, 16, 0), (4, 8, 1024, 32, 8, 0)]


@pytest.mark.parametrize("shape", _WIN_SHAPES)
def test_window_attn_matches_plain_at_swinv2_b_stages(dev, shape):
    """mt::window_attn against its plain version, bf16 in and out, with
    random bias tables and logit scales 5 to 100.  Bar 2^-7 + 2^-7
    |output| a value, and a mean error at most 2^-9 of the mean |output|:
    both round the normalised q and k to bf16 alike, but the kernel rounds
    the unnormalised probabilities to bf16 for its P.V product (one bf16
    ulp of P, 2^-9 relative, moves an output by up to 2^-9 of the largest
    |v|) and the output once more (one ulp, 2^-8 relative); the plain
    version keeps P in f32.  A shifted block also differs from the same
    block unshifted by more than the bar (the roll and the mask act)."""
    import math
    from yolov8_vit_tpu_torch.ops.attention import window_attention_plain
    b, g, c, heads, ws, shift = shape
    gen = _gen(11)
    qkv = torch.randn(b, g, g, 3 * c, generator=gen).to(torch.bfloat16)
    table = 16 * torch.sigmoid(torch.randn(heads, (2 * ws - 1) ** 2,
                                           generator=gen))
    scale = torch.exp(torch.rand(heads, generator=gen) * math.log(20)
                      + math.log(5)).clamp(max=100.0)
    qkv, table, scale = qkv.to(dev), table.to(dev), scale.to(dev)
    ops.reset_launch_counts()
    got = ops.window_attention(qkv, table, scale, window=ws, shift=shift,
                               heads=heads)
    torch.cuda.synchronize()
    assert ops.launch_counts()["window_attention"] == 1
    ref = window_attention_plain(qkv, table, scale, ws, shift, heads)
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    bar = 2 ** -7 + 2 ** -7 * ref.abs()
    assert bool(((got - ref).abs() <= bar).all()), \
        float((got - ref).abs().max())
    mean_rel = float((got - ref).abs().mean() / ref.abs().mean())
    assert mean_rel <= 2 ** -9, mean_rel
    if shift:
        unshifted = window_attention_plain(qkv, table, scale, ws, 0,
                                           heads).float()
        assert bool(((got - unshifted).abs() > bar).any())


def test_window_attn_in_every_block_of_swinv2_b(dev):
    """The bf16 SwinV2-B/256 on the card: one mt::window_attn launch a
    block (24), finite logits; in f32 none (the plain path)."""
    from yolov8_vit_tpu_torch.models.swin import SwinV2Classifier
    from yolov8_vit_tpu_torch.weights import _reset
    model = SwinV2Classifier()
    _reset(model, _gen(12))
    crops = torch.randint(-128, 128, (2, 4096, 4, 12), dtype=torch.int8,
                          generator=_gen(13)).to(dev)
    for dtype, launches in ((torch.bfloat16, 24), (torch.float32, 0)):
        model.dtype = dtype
        model.to(dev).prepare()
        ops.reset_launch_counts()
        with torch.no_grad():
            out = model(crops)
        torch.cuda.synchronize()
        assert ops.launch_counts()["window_attention"] == launches
        assert torch.isfinite(out.float()).all()


def test_swinv2_b_replays_its_forward_as_a_graph(dev):
    """On the card the bf16 classifier's forward is one CUDA graph a crop
    shape: the shape's first call runs the forward as it is and captures
    it, later calls replay it over their own crops with the same logits as
    the forward run as it is; each call counts its 24 window launches, the
    capture none; a reload drops the graphs; f32 (the plain attention)
    captures none."""
    from yolov8_vit_tpu_torch.models.swin import SwinV2Classifier
    from yolov8_vit_tpu_torch.weights import _reset
    model = SwinV2Classifier(dtype=torch.bfloat16)
    _reset(model, _gen(14))
    model.to(dev).prepare()
    a, b = (torch.randint(-128, 128, (4, 4096, 4, 12), dtype=torch.int8,
                          generator=_gen(s)).to(dev) for s in (15, 16))
    ops.reset_launch_counts()
    with torch.no_grad():
        first = model(a)
        again = model(a)
        other = model(b)
        plain = model._forward(b)
    torch.cuda.synchronize()
    assert len(model._graphs) == 1
    assert ops.launch_counts()["window_attention"] == 4 * 24
    assert torch.equal(first, again)
    assert torch.equal(other, plain)
    assert not torch.equal(first, other)
    model.prepare()
    assert not model._graphs
    model.dtype = torch.float32
    model.prepare()
    with torch.no_grad():
        model(a)
    assert not model._graphs


# mt::mlp_block (batch, tokens, D, H): the fused step of b8f.bulk32 and
# ragged row counts (785 and 197-token crops: no multiple of the 128-row
# tile or the 256-row cluster tile), a ladder chunk of 512 crops, ViT-S/16
# widths (D 384: a partial 256-column tile in fc2) and a width below one
# k-tile with a ragged hidden tile
_MLP_SHAPES = [(64, 785, 768, 3072), (1, 785, 768, 3072),
               (3, 197, 768, 3072), (512, 785, 768, 3072),
               (2, 197, 384, 1536), (3, 33, 40, 104)]


@pytest.mark.parametrize("shape", _MLP_SHAPES)
def test_mlp_block_matches_plain(dev, shape):
    """The three launches against the Block's float MLP expression in
    bf16, held as kernel E (FLOAT_BF16_TOL: the mean error at most 2^-9
    of the mean |output|, the error against the same function in f32 at
    most 1.1x the plain version's) but for the elementwise bar 2^-7 +
    2^-7 |output|, which at most 1e-6 of the outputs may pass (as
    chip_smoke.py's MLP_BF16_TOL).  The kernel sums each row's LN
    statistics in another order than PyTorch's reductions; where that
    moves the mean or the variance by an f32 ulp, a few LN outputs land
    on their other bf16 neighbour (142 of 38.6 M at 64 x 785 rows; the
    GEMMs and epilogues downstream were bit-exact with the plain chain on
    the kernel's own LN output), and such a flip passes through three
    more rounding points (product, bias, residual), which can put an
    output two ulps off (2 of 38.6 M outputs beyond the bar, by 0.031 at
    |output| 2.5).  A fault moves whole rows, tiles or columns and fails
    the share and the mean."""
    from yolov8_vit_tpu_torch.ops.mlp import mlp_block_plain
    b, t, d, hid = shape
    g = _gen(20)
    bf16 = torch.bfloat16
    x = torch.randn(b, t, d, generator=g).to(dev, bf16)
    ln = ((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
          (0.1 * torch.randn(d, generator=g)).to(dev))
    w1 = (torch.randn(d, hid, generator=g) * d ** -0.5).to(dev, bf16)
    w2 = (torch.randn(hid, d, generator=g) * hid ** -0.5).to(dev, bf16)
    b1 = (0.05 * torch.randn(hid, generator=g)).to(dev, bf16)
    b2 = (0.05 * torch.randn(d, generator=g)).to(dev, bf16)
    args = (x, *ln, w1, b1, w2, b2)
    ops.reset_launch_counts()
    got = ops.mlp_block(*args, ln_eps=1e-6)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mlp_block"] == 1
    assert got.shape == x.shape and got.dtype == bf16
    ref = mlp_block_plain(*args, 1e-6).float()
    f32_ref = mlp_block_plain(*(a.float() for a in args), 1e-6)
    got = got.float()
    assert torch.isfinite(got).all()
    err = (got - ref).abs()
    beyond = int((err > 2 ** -7 + 2 ** -7 * ref.abs()).sum())
    assert beyond <= 1e-6 * err.numel(), (beyond, float(err.max()))
    mean_rel = float(err.mean() / ref.abs().mean())
    assert mean_rel <= 2 ** -9, mean_rel
    ratio = float((got - f32_ref).abs().mean()
                  / (ref - f32_ref).abs().mean())
    assert ratio <= 1.1, ratio


def test_mlp_block_gelu_is_torch_gelu_on_every_bf16(dev):
    """fc1's epilogue GELU (f32 erf formula, one rounding) on every bf16
    bit pattern is F.gelu's on the card, bit for bit (NaNs aside)."""
    from yolov8_vit_tpu_torch.ops.mlp import gelu_table
    got = gelu_table(dev)
    torch.cuda.synchronize()
    x = torch.arange(65536, dtype=torch.int32, device=dev).to(
        torch.int16).view(torch.bfloat16)
    nan = torch.isnan(x)
    ref = torch.nn.functional.gelu(x).view(torch.int16)
    assert torch.equal(got[~nan], ref[~nan])
    assert torch.isnan(got.view(torch.bfloat16)[nan]).all()


def test_mlp_block_in_every_block_of_the_bf16_vit(dev):
    """A bf16 ViT-B/16 on the card: one mt::mlp_block launch a block, the
    output within the bar of the plain path's; f32 launches none."""
    from yolov8_vit_tpu_torch.models import vit
    model = vit.ViTClassifier(vit.VIT_B16_224, 5, dtype=torch.bfloat16)
    g = _gen(21)
    for m in model.modules():
        if hasattr(m, "reset"):
            m.reset(g)
    img = (torch.rand(2, 224, 224, 3, generator=g) * 2 - 1).to(dev)
    for dtype, launches in ((torch.bfloat16, 12), (torch.float32, 0)):
        model.dtype = dtype
        model.to(dev).prepare()
        ops.reset_launch_counts()
        with torch.no_grad():
            out = model(img)
        torch.cuda.synchronize()
        assert ops.launch_counts()["mlp_block"] == launches
        assert torch.isfinite(out.float()).all()
