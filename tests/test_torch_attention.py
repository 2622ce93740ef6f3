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


def test_wrappers_registered_and_cpu_runs_plain():
    """E and F carry launch counts in ops.KERNEL_WRAPPERS; CPU tensors run
    the plain versions and launch nothing."""
    names = [fn.__name__ for fn in ops.KERNEL_WRAPPERS]
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
