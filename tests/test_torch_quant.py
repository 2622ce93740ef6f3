"""PyTorch port, W8A8 ops: the plain versions of kernels C (int8 MLP
sub-block) and D (int8 attention sub-block) against the JAX Pallas kernels
(interpret mode on the CPU) on the same numpy inputs.

At f32 the bar is 1e-5, as tests/test_quant.py holds the JAX kernels to
their unfused composition: the int8 products are exact in both, and only
the f32 reduction order of LN / softmax and the tanh/exp implementations
differ.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from yolov8_vit_tpu.ops import attention as jatt
from yolov8_vit_tpu.ops import quant as jq

from yolov8_vit_tpu_torch.ops import attention, quant


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(rng, fin, fout):
    w = (rng.normal(size=(fin, fout)) * fin ** -0.5).astype(np.float32)
    b = (rng.normal(size=(fout,)) * 0.1).astype(np.float32)
    wq, s = jq.quantize_weight(jnp.asarray(w))
    return w, np.asarray(wq), np.asarray(s), b


def _ln(rng, d):
    return ((1 + 0.1 * rng.normal(size=d)).astype(np.float32),
            (0.1 * rng.normal(size=d)).astype(np.float32))


@pytest.mark.parametrize("shape", [(8, 64), (3, 9, 32)])
def test_quantize_weight_and_act_exact(shape):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(shape[-1], 48)).astype(np.float32)
    wq, s = quant.quantize_weight(_t(w))
    jwq, js = jq.quantize_weight(jnp.asarray(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    x = (rng.normal(size=shape) * np.logspace(-2, 2, shape[-1])) \
        .astype(np.float32)
    xq, sx = quant.quantize_act(_t(x))
    jxq, jsx = jq.quantize_act(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))


def test_gelu_tanh_matches_jax():
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    got = quant.gelu_tanh(_t(x)).numpy()
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_prequantize_tree_matches_jax():
    rng = np.random.default_rng(1)
    tree = {"block0": {"attn": {"qkv": {"kernel": rng.normal(size=(8, 24))
                                        .astype(np.float32),
                                        "bias": np.zeros(24, np.float32)}},
                       "mlp_fc1": {"kernel": rng.normal(size=(8, 32))
                                   .astype(np.float32),
                                   "bias": np.ones(32, np.float32)},
                       "norm1": {"scale": np.ones(8, np.float32)}}}
    got = quant.prequantize_tree(tree, quant.MLP_AND_ATTN_SUFFIXES)
    ref = jq.prequantize_tree(tree, jq.MLP_AND_ATTN_SUFFIXES)
    for path in (("attn", "qkv"), ("mlp_fc1",)):
        g, r = got["block0"], ref["block0"]
        for p in path:
            g, r = g[p], r[p]
        assert set(g) == set(r) == {"kernel_i8", "w_scale", "bias"}
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(r[k]))
    assert "scale" in got["block0"]["norm1"]


@pytest.mark.parametrize("m,d,hid,seed", [(48, 64, 256, 5), (300, 32, 128, 6)])
def test_kernel_c_plain_matches_jax_kernel(m, d, hid, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    lns, lnb = _ln(rng, d)
    _, w1, s1, b1 = _weights(rng, d, hid)
    _, w2, s2, b2 = _weights(rng, hid, d)
    args = (x, lns, lnb, w1, s1, b1, w2, s2, b2)
    ref = np.asarray(jq.quant_mlp_ln_fused(*map(jnp.asarray, args)))
    got = quant.quant_mlp_ln_fused(*map(_t, args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_kernel_c_plain_keeps_lead_dims_and_bf16():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 17, 64)).astype(np.float32)
    lns, lnb = _ln(rng, 64)
    _, w1, s1, b1 = _weights(rng, 64, 256)
    _, w2, s2, b2 = _weights(rng, 256, 64)
    args = [_t(a) for a in (x, lns, lnb, w1, s1, b1, w2, s2, b2)]
    got = quant.quant_mlp_ln_fused(*args)
    assert got.shape == (2, 17, 64)
    args[0] = args[0].to(torch.bfloat16)
    got16 = quant.quant_mlp_ln_fused(*args)
    assert got16.dtype == torch.bfloat16
    # bf16 input rounding moves LN's output by ~2^-8: codes may shift by one
    assert float((got16.float() - got).abs().max()) < 0.1


@pytest.mark.parametrize("b,t,d,heads,t_real", [(3, 17, 64, 4, None),
                                                (2, 24, 64, 4, 17),
                                                (4, 5, 32, 2, None)])
def test_kernel_d_plain_matches_jax_kernel(b, t, d, heads, t_real):
    rng = np.random.default_rng(b * 100 + t)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    lns, lnb = _ln(rng, d)
    _, wq, sq, bq = _weights(rng, d, 3 * d)
    _, wp, sp, bp = _weights(rng, d, d)
    args = (x, lns, lnb, wq, sq, bq, wp, sp, bp)
    ref = np.asarray(jatt.fused_attention_block_i8(
        *map(jnp.asarray, args), heads=heads, t_real=t_real))
    got = attention.fused_attention_block_i8(*map(_t, args), heads=heads,
                                             t_real=t_real)
    assert got.shape == (b, t, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_kernel_d_plain_bf16_matches_jax_kernel():
    """bf16 activations: the same rounding points (q*scale, P, head outputs
    and the block output in bf16); outputs agree to a bf16 ulp or a single
    int8 code flip."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 17, 64)).astype(np.float32)
    lns, lnb = _ln(rng, 64)
    _, wq, sq, bq = _weights(rng, 64, 192)
    _, wp, sp, bp = _weights(rng, 64, 64)
    rest = (lns, lnb, wq, sq, bq, wp, sp, bp)
    ref = np.asarray(jatt.fused_attention_block_i8(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, rest), heads=4)
        .astype(jnp.float32))
    got = attention.fused_attention_block_i8(
        _t(x).to(torch.bfloat16), *map(_t, rest), heads=4).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=0.05)


def test_scales_divide_by_a_tensor_not_a_scalar():
    """amax / 127 must be an IEEE division on the card too: torch's CUDA
    kernels turn division by a Python scalar into multiplication by its
    rounded reciprocal.  Here (CPU) the two agree; the check is that the
    result equals numpy's IEEE quotient on values where x * (1/127)
    differs from x / 127."""
    x = np.arange(1, 4001, dtype=np.float32)[:, None] * np.float32(0.37)
    want = np.maximum(np.abs(x), 1e-8).astype(np.float32) / np.float32(127.0)
    assert (x * np.float32(1 / 127.0) != want).any()
    _, s = quant.quantize_act(_t(x))
    np.testing.assert_array_equal(s.numpy(), want)


def _two_pass_mlp_ln(x, lns, lnb, w1, s1, b1, w2, s2, b2, eps=1e-6,
                     tile_m=256, tile_n=128):
    """Kernel C's order on the card, in torch: fc1 computed twice by
    128-column tiles over 256-row tiles whose rows past m are zeros (TMA's
    fill; their row scale reads as 0), once for each row's amax (the max
    of the tiles' maxima, padded rows masked) and once for the int8 codes
    at the scale of that amax; then fc2 and the residual.  Returns the
    output, the fc1 codes and their scales, and the padded rows' maxima."""
    m = x.shape[0]
    xf = x.to(torch.float32)
    hq, sx = quant.quantize_act(quant.layernorm_f32(xf, lns, lnb, eps))
    pad = -m % tile_m
    hq = torch.cat([hq, hq.new_zeros(pad, hq.shape[1])])
    sx = torch.cat([sx, sx.new_zeros(pad, 1)])

    def fc1_tile(c0):
        acc = quant.int8_matmul(hq, w1[:, c0:c0 + tile_n])
        return quant.gelu_tanh(acc * sx * s1[None, c0:c0 + tile_n]
                               + b1[None, c0:c0 + tile_n])

    cols = range(0, w1.shape[1], tile_n)
    maxima = torch.stack([fc1_tile(c0).abs().amax(dim=-1) for c0 in cols])
    amax = maxima.amax(dim=0)
    scale = quant._div127(amax[:m, None])
    codes = torch.cat([torch.round(fc1_tile(c0)[:m] / scale).clamp(-127, 127)
                       for c0 in cols], dim=-1).to(torch.int8)
    y = quant.int8_matmul(codes, w2) * scale * s2[None, :] + b2[None, :]
    return (xf + y).to(x.dtype), codes, scale, amax[m:]


@pytest.mark.parametrize("m,d,hid,seed", [(197, 64, 384, 21),
                                          (300, 32, 256, 22),
                                          (12, 48, 128, 23)])
def test_kernel_c_recompute_order_matches_plain_and_jax(m, d, hid, seed):
    """The fc1 recomputation gives the plain version's fc1 codes, scales
    and output bit for bit (m not a multiple of the 256-row tile, hidden
    widths of one to three column tiles), and meets JAX's kernel C within
    the 1e-5 of test_kernel_c_plain_matches_jax_kernel."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    lns, lnb = _ln(rng, d)
    _, w1, s1, b1 = _weights(rng, d, hid)
    _, w2, s2, b2 = _weights(rng, hid, d)
    args = (x, lns, lnb, w1, s1, b1, w2, s2, b2)
    t = list(map(_t, args))
    got, codes, scale, pad_max = _two_pass_mlp_ln(*t)
    # the padded rows' gelu(b1) is not zero: the mask is what keeps it out
    assert m % 256 and bool((pad_max > 0).all())
    h = quant.layernorm_f32(t[0], t[1], t[2], 1e-6)
    a = quant.gelu_tanh(quant.quant_dense_pre(h, t[3], t[4], t[5]))
    want_codes, want_scale = quant.quantize_act(a)
    assert torch.equal(codes, want_codes)
    assert torch.equal(scale, want_scale)
    assert torch.equal(got, quant.quant_mlp_ln_plain(*t))
    ref = np.asarray(jq.quant_mlp_ln_fused(*map(jnp.asarray, args)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_kernel_c_h_wrapper_checks_rows_and_out():
    """The launch chain refuses, before any build, weights not padded to
    the int8 GEMM's 16-byte rows (the public wrappers pad them with
    `transposed_i8`) and an `out` that does not fit the rows."""
    rng = np.random.default_rng(24)
    ln = tuple(map(_t, _ln(rng, 64)))
    _, w1, s1, b1 = map(_t, _weights(rng, 64, 256))
    _, w2, s2, b2 = map(_t, _weights(rng, 256, 64))
    x = _t(rng.normal(size=(10, 64)).astype(np.float32))
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    with pytest.raises(ValueError, match="multiples of 16"):
        quant._launch_mlp("kernel C", x[:, :40], x[:, :40], ln, w1t[:, :40],
                          s1, b1, w2t[:40], s2[:40], b2[:40], 1e-6)
    for bad in (torch.empty(9, 64), torch.empty(10, 64, dtype=torch.bfloat16),
                torch.empty(64, 10).t()):
        with pytest.raises(ValueError, match="does not fit"):
            quant._launch_mlp("kernel H", x, x, None, w1t, s1, b1, w2t, s2,
                              b2, 0.0, out=bad)


# ---- the wrappers' zero padding of widths off 16 ----------------------------
@pytest.mark.parametrize("m,k,n", [(37, 40, 20), (16, 100, 30), (5, 8, 3)])
def test_kernel_g_padding_matches_jax(m, k, n):
    """Kernel G's operands as its wrapper pads them (x's columns to 16, the
    (out, in) weight to (16, 16) multiples, scales and biases with zeros),
    through the plain arithmetic and sliced: bit for bit the plain version,
    and JAX's kernel within tests/test_torch_quant_dense.py's 1e-5."""
    rng = np.random.default_rng(k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    _, wq, s, b = _weights(rng, k, n)
    t = list(map(_t, (x, wq, s, b)))
    wt = quant.transposed_i8(t[1])
    assert wt.shape == (quant.round_up16(n), quant.round_up16(k))
    np_, kp = wt.shape
    got = quant.quant_dense_plain(quant.pad_cols(t[0], kp), wt.t(),
                                  quant.pad_cols(t[2], np_),
                                  quant.pad_cols(t[3], np_))[:, :n]
    assert torch.equal(got, quant.quant_dense_plain(*t))
    ref = np.asarray(jq.quant_dense_fused(*map(jnp.asarray, (x, wq, s, b))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _padded_mlp(x, ln, w1, s1, b1, w2, s2, b2, residual=None):
    """Kernels C (ln given) and H as their wrappers pad them: rows to
    Dp, LN statistics over the real D, fc1 to Hp (its padded columns
    gelu(0) = 0), fc2 back to Dp, sliced."""
    m, d = x.shape
    w1t, w2t = quant.transposed_i8(w1), quant.transposed_i8(w2)
    hp, dp = w1t.shape
    h = x if ln is None else quant.layernorm_f32(x, *ln, 1e-6)
    a = quant.gelu_tanh(quant.quant_dense_pre(
        quant.pad_cols(h, dp), w1t.t(), quant.pad_cols(s1, hp),
        quant.pad_cols(b1, hp)))
    assert bool((a[:, w1.shape[1]:] == 0).all())
    y = quant.quant_dense_pre(a, w2t.t(), quant.pad_cols(s2, dp),
                              quant.pad_cols(b2, dp))
    return (x if residual is None else residual) + y[:, :d]


@pytest.mark.parametrize("m,d,hid", [(30, 40, 100), (20, 24, 72)])
def test_kernel_c_h_padding_matches_jax(m, d, hid):
    rng = np.random.default_rng(d * hid)
    x = rng.normal(size=(m, d)).astype(np.float32)
    res = rng.normal(size=(m, d)).astype(np.float32)
    lns, lnb = _ln(rng, d)
    _, w1, s1, b1 = _weights(rng, d, hid)
    _, w2, s2, b2 = _weights(rng, hid, d)
    w = (w1, s1, b1, w2, s2, b2)
    tw = list(map(_t, w))
    got_c = _padded_mlp(_t(x), (_t(lns), _t(lnb)), *tw)
    assert torch.equal(got_c, quant.quant_mlp_ln_plain(_t(x), _t(lns),
                                                       _t(lnb), *tw))
    ref_c = np.asarray(jq.quant_mlp_ln_fused(*map(jnp.asarray,
                                                  (x, lns, lnb, *w))))
    np.testing.assert_allclose(got_c.numpy(), ref_c, rtol=1e-5, atol=1e-5)
    got_h = _padded_mlp(_t(x), None, *tw, residual=_t(res))
    assert torch.equal(got_h, quant.quant_mlp_plain(_t(x), _t(res), *tw))
    ref_h = np.asarray(jq.quant_mlp_fused(*map(jnp.asarray, (x, res, *w))))
    np.testing.assert_allclose(got_h.numpy(), ref_h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,t,d,heads", [(2, 9, 40, 2), (2, 7, 24, 3),
                                         (1, 5, 100, 2), (1, 5, 272, 2)])
def test_kernel_d_padding_matches_jax(b, t, d, heads):
    """Kernel D where the head dim (20, 8, 50, 136) is not one the SDPA
    core runs: each head of q, k, v zero-padded to 32, 16, 64 or 144
    columns and D to a multiple of 16 (`_head_padded_i8`), through the plain arithmetic with
    the real head dim's scale: the padded q, k, v columns are zero, and the
    result meets JAX's kernel D within its 1e-5."""
    rng = np.random.default_rng(d + heads)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    lns, lnb = _ln(rng, d)
    _, wq, sq, bq = _weights(rng, d, 3 * d)
    _, wp, sp, bp = _weights(rng, d, d)
    hd = d // heads
    hdp = attention._core_head_dim(hd)
    wqt, sqp, bqp, wpt, spp, bpp = attention._head_padded_i8(
        *map(_t, (wq, sq, bq, wp, sp, bp)), heads, hdp)
    dp, dh = wpt.shape
    assert wqt.shape == (3 * dh, dp) and dh == heads * hdp
    xx = _t(x).reshape(-1, d)
    h = quant.layernorm_f32(xx, _t(lns), _t(lnb), 1e-6)
    qkv = quant.quant_dense_pre(quant.pad_cols(h, dp), wqt.t(), sqp, bqp)
    q, k, v = qkv.reshape(b, t, 3, heads, hdp).unbind(2)
    assert bool((qkv.reshape(b, t, 3, heads, hdp)[..., hd:] == 0).all())
    s = torch.einsum("bqhc,bkhc->bhqk", q * hd ** -0.5, k)
    o = attention._softmax_pv(s, v, torch.float32, torch.float32)
    y = quant.quant_dense_pre(o.reshape(b * t, dh), wpt.t(), spp, bpp)
    got = (xx + y[:, :d]).reshape(b, t, d)
    args = (x, lns, lnb, wq, sq, bq, wp, sp, bp)
    ref = np.asarray(jatt.fused_attention_block_i8(*map(jnp.asarray, args),
                                                   heads=heads))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    plain = attention.attn_block_i8_plain(*map(_t, args), heads=heads)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_transposed_i8_pads_and_takes_plain_transposes():
    w = torch.randint(-127, 128, (40, 20), dtype=torch.int8)
    want = torch.zeros(32, 48, dtype=torch.int8)
    want[:20, :40] = w.t()
    assert torch.equal(quant.transposed_i8(w), want)
    assert torch.equal(quant.transposed_i8(w, w.t().contiguous()), want)
    assert quant.transposed_i8(w, want) is want
    with pytest.raises(ValueError, match="does not fit"):
        quant.transposed_i8(w, want[:, :40].contiguous())
