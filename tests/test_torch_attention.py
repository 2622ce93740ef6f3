"""PyTorch port, float attention: the plain versions of kernel E
(`fused_attention_block`) and kernel F (`flash_attention`) against the
JAX Pallas kernels (interpret mode on the CPU) on the same numpy inputs,
and the wrappers' CPU dispatch.

Bars: E at f32 within atol 2e-5, rtol 1e-4 (tests/test_fused_attention.py
:78, the JAX kernel against numpy); F at f32 within rtol 5e-4, atol 2e-4
(tests/test_attention.py:30), bf16 within 1e-2 (flash_attention's own
statement of its bf16 agreement); E at bf16 within 1e-2 plus a bf16 ulp
of the values' size.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yolov8_vit_tpu.ops import attention as jatt

from yolov8_vit_tpu_torch import ops
from yolov8_vit_tpu_torch.ops import attention


def _t(a):
    return torch.from_numpy(np.array(a))


def _block_inputs(rng, b, t, d):
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    lns = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    lnb = (0.1 * rng.normal(size=d)).astype(np.float32)
    wq = (rng.normal(size=(d, 3 * d)) * d ** -0.5).astype(np.float32)
    bq = (rng.normal(size=3 * d) * 0.02).astype(np.float32)
    wp = (rng.normal(size=(d, d)) * d ** -0.5).astype(np.float32)
    bp = (rng.normal(size=d) * 0.02).astype(np.float32)
    return x, lns, lnb, wq, bq, wp, bp


@pytest.mark.parametrize("b,t,d,heads,t_real", [(3, 17, 64, 4, None),
                                                (2, 24, 64, 4, 17),
                                                (4, 33, 32, 2, None),
                                                (2, 40, 64, 4, 37)])
def test_kernel_e_plain_matches_jax_kernel(b, t, d, heads, t_real):
    args = _block_inputs(np.random.default_rng(b * 100 + t), b, t, d)
    ref = np.asarray(jatt.fused_attention_block(
        *map(jnp.asarray, args), heads=heads, t_real=t_real,
        interpret=True))
    got = attention.fused_attention_block(*map(_t, args), heads=heads,
                                          t_real=t_real)
    assert got.shape == (b, t, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)


def test_kernel_e_plain_bf16_matches_jax_kernel():
    """bf16 activations and weights: the same rounding points (LN output,
    qkv, q * scale, P, head outputs, block output); outputs agree to a bf16
    ulp of their size."""
    x, *rest = _block_inputs(np.random.default_rng(7), 2, 19, 64)
    ref = np.asarray(jatt.fused_attention_block(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, rest), heads=4,
        interpret=True).astype(jnp.float32))
    got = attention.fused_attention_block(
        _t(x).to(torch.bfloat16), *map(_t, rest), heads=4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-2)


def test_kernel_e_padded_rows_do_not_leak():
    """With t_real, the first t_real rows equal the unpadded block's."""
    x, *rest = _block_inputs(np.random.default_rng(3), 2, 29, 64)
    full = attention.fused_attention_block(*map(_t, [x[:, :23]] + rest),
                                           heads=4)
    junk = x.copy()
    junk[:, 23:] = 1e3
    padded = attention.fused_attention_block(*map(_t, [junk] + rest),
                                             heads=4, t_real=23)
    np.testing.assert_allclose(padded[:, :23].numpy(), full.numpy(),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("t", [17, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_f_plain_matches_jax_kernel(t, dtype):
    rng = np.random.default_rng(t)
    b, h, d = 2, 3, 64
    q, k, v = (rng.normal(size=(b, t, h, d)).astype(np.float32)
               for _ in range(3))
    jd = jnp.dtype(dtype)
    ref = np.asarray(jatt.flash_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)), interpret=True)
        .astype(jnp.float32))
    td = getattr(torch, dtype)
    got = attention.flash_attention(*(_t(a).to(td) for a in (q, k, v)))
    assert got.shape == (b, t, h, d) and got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=5e-4, atol=2e-4)
    else:
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=1e-2)


def test_kernel_f_takes_strided_views_of_packed_qkv():
    """The ViT's pallas path hands F views of one packed qkv."""
    rng = np.random.default_rng(5)
    qkv = _t(rng.normal(size=(2, 21, 3, 4, 16)).astype(np.float32))
    q, k, v = qkv.unbind(2)
    got = attention.flash_attention(q, k, v)
    ref = attention.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous())
    assert torch.equal(got, ref)


def test_kernel_f_reads_in_place_only_views_tma_can_load():
    """F's kernel loads k and v through TMA tensor maps over (feature,
    token, image): the unbound views of a packed qkv qualify; a base off
    16 bytes, images that overlap (an expanded batch) and heads that are
    not adjacent do not, and the wrapper copies those first."""
    qkv = torch.zeros(2, 21, 3, 4, 16)
    assert all(attention._strided_ok(x, 16) for x in qkv.unbind(2))
    flat = torch.zeros(2 * 21 * 4 * 16 + 1)
    assert not attention._strided_ok(flat[1:].view(2, 21, 4, 16), 16)
    assert not attention._strided_ok(
        torch.zeros(1, 21, 4, 16).expand(2, 21, 4, 16), 16)
    assert not attention._strided_ok(
        torch.zeros(2, 4, 21, 16).transpose(1, 2), 16)


def test_wrappers_registered_and_cpu_runs_plain():
    """E and F carry launch counts (ops.launch_counts); CPU tensors run
    the plain versions and launch nothing."""
    names = list(ops.launch_counts())
    assert "fused_attention_block" in names and "flash_attention" in names
    ops.reset_launch_counts()
    x, *rest = _block_inputs(np.random.default_rng(1), 1, 9, 32)
    attention.fused_attention_block(*map(_t, [x] + rest), heads=2)
    q = torch.zeros(1, 9, 2, 16)
    attention.flash_attention(q, q, q)
    assert all(n == 0 for n in ops.launch_counts().values())


def test_kernel_d_plain_takes_b8_sequence():
    """Kernel D's plain version at ViT-B/8's 785 tokens (the sequence the
    card's wrapper refused before the key-tiled SDPA) against JAX."""
    rng = np.random.default_rng(9)
    b, t, d, heads = 1, 785, 32, 2
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    lns = np.ones(d, np.float32)
    lnb = np.zeros(d, np.float32)
    from yolov8_vit_tpu.ops import quant as jq
    ws = []
    for fout in (3 * d, d):
        w = (rng.normal(size=(d, fout)) * d ** -0.5).astype(np.float32)
        wq, s = jq.quantize_weight(jnp.asarray(w))
        ws += [np.asarray(wq), np.asarray(s),
               (rng.normal(size=fout) * 0.1).astype(np.float32)]
    args = (x, lns, lnb, *ws)
    ref = np.asarray(jatt.fused_attention_block_i8(
        *map(jnp.asarray, args), heads=heads, interpret=True))
    got = attention.fused_attention_block_i8(*map(_t, args), heads=heads)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# chip_smoke.py's FLOAT_BF16_TOL: one output ulp plus one flipped element
# of P elementwise, mean error <= 2^-9 of mean |plain|, error against the
# same function in f32 <= 1.1x the plain version's
_FLOAT_BF16_TOL = {"atol": 2.0 ** -7, "rtol": 2.0 ** -7,
                   "mean_rel": 2.0 ** -9, "f32_ratio": 1.1}
_LOG2E = 1.4426950408889634


def _kernel_sdpa_arith(q, k, v, prescale, seed=0):
    """The bf16 SDPA core of csrc/sdpa.cuh, operation by operation, on
    (B, T, H, hd) bf16 inputs in torch: q * scale rounded to bf16
    (prescale, D and E) or the f32 scale folded into c (F); two passes over
    64-key tiles with e = ex2(fma(s, c, -m c)), c = scale log2(e), the sum
    rescaled as the max grows; p = e * (1 / l), one IEEE reciprocal a row;
    p rounded to bf16, P.V summed in f32 and rounded to bf16.  ex2.approx
    is 2^x within 2^-22 relative (a seeded draw); fma rounds once (f64,
    then f32)."""
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    b, t, h, hd = q.shape
    gen = torch.Generator().manual_seed(seed)
    if prescale:
        scale = torch.tensor(hd ** -0.5, dtype=bf16).to(f32)
        q = (q.float() * scale).to(bf16)
        c = torch.tensor(_LOG2E, dtype=f32)
    else:
        c = torch.tensor(hd ** -0.5, dtype=f32) * torch.tensor(_LOG2E,
                                                                dtype=f32)

    def ex2(x):
        y = torch.exp2(x.double())
        u = torch.rand(y.shape, generator=gen, dtype=f64) * 2 - 1
        return (y * (1 + u * 2.0 ** -22)).float()

    def fma(x, mc):
        return (x.double() * c.double() - mc.double()).float()

    s = torch.einsum("bqhc,bkhc->bhqk", q.float(), k.float())
    m = torch.full(s.shape[:-1], float("-inf"))
    l = torch.zeros(s.shape[:-1])
    for k0 in range(0, t, 64):
        st = s[..., k0:k0 + 64]
        mn = torch.maximum(m, st.amax(-1))
        mc = mn * c
        l = l * ex2(fma(m, mc)) + ex2(fma(st, mc[..., None])).sum(-1)
        m = mn
    p = (ex2(fma(s, (m * c)[..., None])) * (1 / l)[..., None]).to(bf16)
    return torch.einsum("bhqk,bkhc->bqhc", p.float(), v.float()).to(bf16)


def _meets_float_bf16_tol(got, ref, f32_ref):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    tol = _FLOAT_BF16_TOL
    assert bool((err <= tol["atol"] + tol["rtol"] * ref.abs()).all()), \
        float(err.max())
    assert float(err.mean() / ref.abs().mean()) <= tol["mean_rel"]
    assert float((got - f32_ref).abs().mean()) <= tol["f32_ratio"] * float(
        (ref - f32_ref).abs().mean())


@pytest.mark.parametrize("form", ["heads", "flash"])
def test_kernel_sdpa_arithmetic_meets_float_bf16_tol(form):
    """The card's exponent and reciprocal in place of expf and IEEE
    division (the bf16 core of D, E and F) at ViT-B/8's 785 tokens, 12
    heads of 64, against sdpa_heads_plain (D, E: q * scale rounded) and
    flash_attention_plain (F), bf16, within FLOAT_BF16_TOL."""
    rng = np.random.default_rng(13)
    b, t, h, hd = 1, 785, 12, 64
    qkv = torch.from_numpy(rng.normal(size=(b, t, 3, h, hd))
                           .astype(np.float32)).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    got = _kernel_sdpa_arith(q, k, v, prescale=form == "heads")
    if form == "heads":
        packed = qkv.reshape(b, t, 3 * h * hd)
        ref = attention.sdpa_heads_plain(packed, h)
        f32_ref = attention.sdpa_heads_plain(packed.float(), h)
        got = got.reshape(b, t, h * hd)
    else:
        ref = attention.flash_attention_plain(q, k, v)
        f32_ref = attention.flash_attention_plain(q.float(), k.float(),
                                                  v.float())
    assert got.dtype == ref.dtype == torch.bfloat16
    _meets_float_bf16_tol(got, ref, f32_ref)


# head dims the SDPA core does not run (8, 48, 80: zero-padded to 16, 64,
# 128; 136 above 128: to 144) and ones it runs as they are (128, 192);
# two heads each
_PAD_HEAD_DIMS = [8, 48, 80, 128, 136, 192]


@pytest.mark.parametrize("hd", _PAD_HEAD_DIMS)
def test_kernel_e_head_padding_matches_unpadded_and_jax(hd):
    """Kernel E's padded operands (`_head_padded_float`: each head's q, k,
    v columns and proj rows zero-padded to the core's head dim) through
    the plain arithmetic with the real head dim's scale give the unpadded
    plain result and JAX's `_attn_block_kernel` in interpret mode."""
    heads, b, t = 2, 2, 17
    d = heads * hd
    x, lns, lnb, wq, bq, wp, bp = _block_inputs(
        np.random.default_rng(hd), b, t, d)
    hdp = attention._padded_head_dim(torch.float32, d, heads, "E")
    assert hdp == {8: 16, 48: 64, 80: 128, 128: 128, 136: 144, 192: 192}[hd]
    wqp, bqp, wpp = attention._head_padded_float(_t(wq), _t(bq), _t(wp),
                                                 heads, hdp)
    assert wqp.shape == (d, 3 * heads * hdp) and wpp.shape == (heads * hdp,
                                                               d)
    xx = _t(x).reshape(-1, d)
    h = attention.layernorm_f32(xx, _t(lns), _t(lnb), 1e-6)
    qkv = (h @ wqp + bqp).reshape(b, t, 3, heads, hdp)
    assert bool((qkv[..., hd:] == 0).all())
    q, k, v = qkv.unbind(2)
    s = torch.einsum("bqhc,bkhc->bhqk", q * hd ** -0.5, k)
    o = attention._softmax_pv(s, v, torch.float32, torch.float32)
    got = (xx + o.reshape(b * t, heads * hdp) @ wpp + _t(bp)).reshape(b, t, d)
    plain = attention.fused_attention_block(
        *map(_t, (x, lns, lnb, wq, bq, wp, bp)), heads=heads)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6,
                               rtol=1e-6)
    ref = np.asarray(jatt.fused_attention_block(
        *map(jnp.asarray, (x, lns, lnb, wq, bq, wp, bp)), heads=heads,
        interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("hd", _PAD_HEAD_DIMS)
def test_kernel_f_head_padding_matches_unpadded_and_jax(hd):
    """Kernel F's padding (q, k and v copied into zero-padded buffers of
    the core's head dim, the output sliced) through the plain arithmetic
    with the real head dim's scale gives the unpadded plain result and
    JAX's `_attn_kernel` in interpret mode."""
    rng = np.random.default_rng(hd + 1)
    b, t, heads = 2, 17, 2
    q, k, v = (rng.normal(size=(b, t, heads, hd)).astype(np.float32)
               for _ in range(3))
    hdp = attention._padded_head_dim(torch.float32, heads * hd, heads, "F")
    qp, kp, vp = (attention.pad_cols(_t(a), hdp) for a in (q, k, v))
    s = torch.einsum("bqhc,bkhc->bhqk", qp, kp) * hd ** -0.5
    got = attention._softmax_pv(s, vp, torch.float32, torch.float32)
    assert bool((got[..., hd:] == 0).all())
    got = got[..., :hd]
    plain = attention.flash_attention(*map(_t, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6,
                               rtol=1e-6)
    ref = np.asarray(jatt.flash_attention(*map(jnp.asarray, (q, k, v)),
                                          interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-4, atol=2e-4)


def test_head_dims_above_128_refused():
    """Head dims above 128 are no longer refused: the SDPA core's wide form
    takes them, each head zero-padded to a multiple of 16.  What the
    kernels still refuse raises before any launch (checked here without a
    card): another dtype, D not a multiple of heads or of 8."""
    for hd, hdp in ((136, 144), (192, 192), (256, 256), (132, 144)):
        assert attention._padded_head_dim(torch.bfloat16, 2 * hd, 2,
                                          "kernel E") == hdp
    assert attention._padded_head_dim(torch.bfloat16, 2 * 128, 2, "F") == 128
    for dtype, d, heads in ((torch.float16, 256, 2), (torch.float32, 264, 5),
                            (torch.float32, 260, 2)):
        with pytest.raises(ValueError, match="multiple of 8 and of heads"):
            attention._padded_head_dim(dtype, d, heads, "kernel E")
