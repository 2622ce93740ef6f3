"""PyTorch port, the W8A8 dense layer and MLP sub-block: the plain
versions of kernels G (`quant_dense_fused`) and H (`quant_mlp_fused`)
against the JAX Pallas kernels (interpret mode on the CPU) on the same
numpy inputs.

At f32 the bar is 1e-5, as tests/test_quant.py holds the JAX kernels to
their unfused composition: the int8 products are exact in both, the
rescale is the same three f32 operations, and only exp / tanh differ in
their last bits.  At bf16 the f32 results agree that closely before the
one rounding, so outputs sit at most one bf16 ulp (2^-7 relative) apart,
but for one thing: bf16 inputs are coarse, so x / scale lands exactly on a
.5 boundary now and then, and XLA's simplified form of x / (amax / 127)
rounds such a quotient to the other side.  That is one int8 code of one
product term, (amax|x| / 127) * max|w| for G, and C's bar of 0.05 for H
(kernel C's tests state it: one code of the requantized hidden).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yolov8_vit_tpu.models.vit import QuantDensePre as JQuantDensePre
from yolov8_vit_tpu.ops import quant as jq

from yolov8_vit_tpu_torch.models.vit import QuantDensePre
from yolov8_vit_tpu_torch.ops import quant
from yolov8_vit_tpu_torch.weights import load_tree

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL = 2.0 ** -7


def _tol(dtype, x, wq, s):
    """F32_TOL, or for bf16 one output ulp plus one int8 code of x."""
    if dtype == "float32":
        return F32_TOL
    code = float(np.abs(x).max() / 127.0 * np.abs(wq * s[None, :]).max())
    return dict(rtol=BF16_RTOL, atol=2.0 ** -8 + code)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _weights(rng, fin, fout):
    w = (rng.normal(size=(fin, fout)) * fin ** -0.5).astype(np.float32)
    b = (rng.normal(size=(fout,)) * 0.1).astype(np.float32)
    wq, s = jq.quantize_weight(jnp.asarray(w))
    return np.asarray(wq), np.asarray(s), b


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 96, 64), (2, 37, 64, 192)])
def test_quant_dense_fused_matches_jax(shape, dtype, silu):
    *lead, k, n = shape
    rng = np.random.default_rng(7)
    x = rng.normal(size=(*lead, k)).astype(np.float32)
    wq, s, b = _weights(rng, k, n)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ref = jq.quant_dense_fused(jnp.asarray(x, jdt), jnp.asarray(wq),
                               jnp.asarray(s), jnp.asarray(b), silu=silu,
                               interpret=True)
    got = quant.quant_dense_fused(_t(x, tdt), _t(wq), _t(s), _t(b),
                                  silu=silu)
    assert got.dtype == tdt and tuple(got.shape) == (*lead, n)
    tol = _tol(dtype, x, wq, s)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_dense_fused_no_silu_equals_unfused(dtype):
    """Without SiLU the function is `quant_dense_pre` rounded once, bit for
    bit (the JAX kernel's own contract with its unfused form): exact int8
    sums and three f32 operations.  Against XLA the last bit of those
    three may differ (it contracts the multiply-add), hence 1e-5 above."""
    rng = np.random.default_rng(8)
    x = _t(rng.normal(size=(70, 128)).astype(np.float32), dtype)
    wq, s, b = (_t(a) for a in _weights(rng, 128, 48))
    got = quant.quant_dense_fused(x, wq, s, b)
    ref = quant.quant_dense_pre(x.float(), wq, s, b).to(dtype)
    assert torch.equal(got, ref)


def test_quant_dense_fused_transposed_weight_checked():
    rng = np.random.default_rng(9)
    wq, s, b = _weights(rng, 32, 16)
    w = _t(wq)
    assert quant.transposed_i8(w).shape == (16, 32)
    assert quant.transposed_i8(w, w.t().contiguous()).is_contiguous()
    with pytest.raises(ValueError):
        quant.transposed_i8(w, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_dense_pre_layer_from_flax_tree(dtype):
    """The port's QuantDensePre, loaded from the flax layer's params,
    against the flax layer."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3, 21, 64)).astype(np.float32)
    wq, s, b = _weights(rng, 64, 96)
    params = {"kernel_i8": wq, "w_scale": s, "bias": b}
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ref = JQuantDensePre(96, dtype=jdt).apply(
        {"params": {k: jnp.asarray(v) for k, v in params.items()}},
        jnp.asarray(x, jdt))
    layer = load_tree(QuantDensePre(64, 96, dtype=tdt), params)
    assert torch.equal(layer.kernel_t, _t(wq).t())
    got = layer(_t(x, tdt))
    assert got.dtype == tdt
    tol = _tol(dtype, x, wq, s)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 64, 256), (2, 19, 32, 128)])
def test_quant_mlp_fused_matches_jax(shape, dtype):
    """H.  A hidden value at a .5 quantization boundary may take the
    neighbouring int8 code where tanh differs in its last bit: none does on
    these inputs at f32, so the bar is 1e-5 there."""
    *lead, d, hid = shape
    rng = np.random.default_rng(5)
    h = rng.normal(size=(*lead, d)).astype(np.float32)
    res = rng.normal(size=(*lead, d)).astype(np.float32)
    w1, s1, b1 = _weights(rng, d, hid)
    w2, s2, b2 = _weights(rng, hid, d)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ref = jq.quant_mlp_fused(
        jnp.asarray(h, jdt), jnp.asarray(res, jdt), jnp.asarray(w1),
        jnp.asarray(s1), jnp.asarray(b1), jnp.asarray(w2), jnp.asarray(s2),
        jnp.asarray(b2), interpret=True)
    got = quant.quant_mlp_fused(_t(h, tdt), _t(res, tdt), _t(w1), _t(s1),
                                _t(b1), _t(w2), _t(s2), _t(b2))
    assert got.dtype == tdt and got.shape == tuple(h.shape)
    tol = F32_TOL if dtype == "float32" else dict(rtol=BF16_RTOL, atol=0.05)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)


def test_quant_mlp_fused_is_c_without_ln():
    """H on LN(x) and x equals C on x (identity LN params aside): the two
    share one launch chain on the card and one composition here."""
    rng = np.random.default_rng(6)
    d, hid = 32, 64
    x = _t(rng.normal(size=(40, d)).astype(np.float32))
    lns = _t((1 + 0.1 * rng.normal(size=d)).astype(np.float32))
    lnb = _t((0.1 * rng.normal(size=d)).astype(np.float32))
    w1, s1, b1 = (_t(a) for a in _weights(rng, d, hid))
    w2, s2, b2 = (_t(a) for a in _weights(rng, hid, d))
    c = quant.quant_mlp_ln_fused(x, lns, lnb, w1, s1, b1, w2, s2, b2)
    h = quant.layernorm_f32(x, lns, lnb, 1e-6)
    got = quant.quant_mlp_fused(h, x, w1, s1, b1, w2, s2, b2)
    assert torch.equal(got, c)
