"""PyTorch port, the detector's early region: the plain version of kernel
J (`fused_b1b2` on flat NHWC) against the JAX package's Pallas kernel
(`fused_b1b2(interpret=True)`) and its XLA reference
(`region_b1b2_reference`), both of which work on 2x2-cell tensors: the
same numpy input goes through cellify -> JAX -> decellify.

Dims and bar are tests/test_fused_region.py's: h=80, c1=8, c2=16, seeds
0-3, max |d| <= 0.05 * std(ref) (bf16 reassociation through three stacked
bf16 stages).  The mean error is held to 0.005 * std(ref): reassociation
moves single outputs by a bf16 ulp, so a tenth of the maximum bar
separates it from a systematic fault (a wrong tap, padding side or channel
order moves every output by a share of std).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yolov8_vit_tpu.ops import cellconv as cc
from yolov8_vit_tpu.ops.fused_region import (fused_b1b2 as j_fused,
                                             region_b1b2_reference)

from yolov8_vit_tpu_torch.models.yolov8 import C2f, ConvBlock
from yolov8_vit_tpu_torch.ops import fused_region as fr
from yolov8_vit_tpu_torch.weights import load_tree


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _params(rng, c1, c2):
    c = c2 // 2

    def conv(shape):
        return {"conv": {"kernel": _bf16(rng.normal(size=shape) * 0.08),
                         "bias": (rng.normal(size=shape[-1]) * 0.1)
                         .astype(np.float32)}}

    return {"b1": conv((3, 3, c1, c2)), "cv1": conv((1, 1, c2, c2)),
            "m0_cv1": conv((3, 3, c, c)), "m0_cv2": conv((3, 3, c, c)),
            "cv2": conv((1, 1, 3 * c, c2))}


def _jparams(params):
    return {n: {"conv": {"kernel": jnp.asarray(p["conv"]["kernel"],
                                               jnp.bfloat16),
                         "bias": jnp.asarray(p["conv"]["bias"])}}
            for n, p in params.items()}


def _case(seed, batch=2, h=80, c1=8, c2=16):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.normal(size=(batch, 2 * h, 2 * h, c1)) * 0.3)   # flat
    return x, _params(rng, c1, c2)


def _port(x, params):
    out = fr.fused_b1b2(torch.from_numpy(x).to(torch.bfloat16), params)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


def _bars(got, ref):
    d = np.abs(got - ref)
    std = max(ref.std(), 1e-3)
    assert d.max() <= 0.05 * std, f"max delta {d.max():.5f} vs std {std:.4f}"
    assert d.mean() <= 0.005 * std, f"mean delta {d.mean():.6f}"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_matches_jax_cell_reference(seed):
    x, params = _case(seed)
    x_cells = cc.cellify(jnp.asarray(x, jnp.bfloat16))
    ref = np.asarray(cc.decellify(region_b1b2_reference(
        x_cells, _jparams(params))).astype(jnp.float32))
    got = _port(x, params)
    assert got.shape == ref.shape == (2, 80, 80, 16)
    _bars(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_matches_jax_pallas_interpret(seed):
    x, params = _case(seed, batch=1)
    x_cells = cc.cellify(jnp.asarray(x, jnp.bfloat16))
    ref = np.asarray(cc.decellify(j_fused(
        x_cells, _jparams(params), interpret=True)).astype(jnp.float32))
    _bars(_port(x, params), ref)


def test_silu_bf16_rounds_once_before_the_logistic():
    acc = torch.tensor([[[0.3001, -1.2507, 2.0]]]).reshape(3, 1, 1)
    bias = torch.tensor([0.1, 0.0, -0.5])
    got = fr.silu_bf16(acc, bias)
    y = (acc + bias[:, None, None]).to(torch.bfloat16)
    want = y * torch.sigmoid(y.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_region_params_from_detector_tree_and_modules():
    """`region_params` picks b1 and b2 out of a detector's tree; the result
    agrees with the port's ConvBlock + C2f modules on the same weights to
    the bf16 class (they apply SiLU in f32 before their one rounding)."""
    rng = np.random.default_rng(5)
    c1, c2 = 8, 16
    p = _params(rng, c1, c2)
    tree = {"b0": {}, "b1": p["b1"],
            "b2": {"cv1": p["cv1"], "cv2": p["cv2"],
                   "m0": {"cv1": p["m0_cv1"], "cv2": p["m0_cv2"]}}}
    flat = fr.region_params(tree)
    assert set(flat) == set(fr.PARAM_NAMES)
    x = torch.from_numpy(_bf16(rng.normal(size=(1, 32, 48, c1)) * 0.3)) \
        .to(torch.bfloat16)
    got = fr.fused_b1b2(x, flat).float()
    assert tuple(got.shape) == (1, 16, 24, c2)
    b1 = load_tree(ConvBlock(c1, c2, 3, 2), tree["b1"])
    b2 = load_tree(C2f(c2, c2, 1, True), tree["b2"])
    for m in (b1, b2):
        for sub in m.modules():
            if hasattr(sub, "derive"):
                sub.derive(torch.bfloat16)
    ref = b2(b1(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1).float()
    _bars(got.numpy(), ref.numpy())


def _conv_from_blocks(t, blocks, kh, cin, cout, stride):
    """One conv of kernel J read from its prepared layout, tap by tap and
    chunk by chunk as the kernel's k-steps run: t (B, H, W, cin) f32 ->
    (B, Ho, Wo, cout) f32 sums (before the bias)."""
    blk = blocks.float().reshape(kh * kh, cin // 8, cout, 8)
    pad = kh // 2
    tp = torch.nn.functional.pad(t, (0, 0, pad, pad, pad, pad))
    ho = (t.shape[1] + 2 * pad - kh) // stride + 1
    wo = (t.shape[2] + 2 * pad - kh) // stride + 1
    acc = torch.zeros(t.shape[0], ho, wo, cout)
    for tap in range(kh * kh):
        u, v = divmod(tap, kh)
        a = tp[:, u:u + stride * (ho - 1) + 1:stride,
               v:v + stride * (wo - 1) + 1:stride]
        a = a.reshape(*a.shape[:3], cin // 8, 8)
        acc = acc + torch.einsum("bhwje,jne->bhwn", a, blk[tap])
    return acc


def _conv_from_rows(t, rows, kh, cin, cout, stride):
    """One conv of the five-launch form read from its prepared layout, tap
    by tap as its k loop runs: rows (cout, kh * kh * cin)."""
    w = rows.float().reshape(cout, kh * kh, cin)
    pad = kh // 2
    tp = torch.nn.functional.pad(t, (0, 0, pad, pad, pad, pad))
    ho = (t.shape[1] + 2 * pad - kh) // stride + 1
    wo = (t.shape[2] + 2 * pad - kh) // stride + 1
    acc = torch.zeros(t.shape[0], ho, wo, cout)
    for tap in range(kh * kh):
        u, v = divmod(tap, kh)
        a = tp[:, u:u + stride * (ho - 1) + 1:stride,
               v:v + stride * (wo - 1) + 1:stride]
        acc = acc + torch.einsum("bhwc,nc->bhwn", a, w[:, tap])
    return acc


def _region_from_prepared(x, prep):
    """A plain consumer of `prepare_region`'s layout: the five stages, each
    a sum over (tap, chunk) blocks (the fused kernel's layout) or over taps
    of per-channel rows (the five-launch form's) of the flat weight buffer
    at the offsets the kernel reads, biases from the flat bias buffer,
    rounded as `_silu_bf16`, off-image pixels of y1 and m1 zero (the convs
    pad)."""
    c1, c2 = prep.c1, prep.c2
    c = c2 // 2
    sizes = [(3, c1, c2, 2), (1, c2, c2, 1), (3, c, c, 1), (3, c, c, 1),
             (1, 3 * c, c2, 1)]
    w_off = b_off = 0
    stages = []
    for kh, cin, cout, stride in sizes:
        n = kh * kh * cin * cout
        stages.append((prep.w[w_off:w_off + n], prep.bias[b_off:b_off + cout],
                       kh, cin, cout, stride))
        w_off += n
        b_off += cout
    assert w_off == prep.w.numel() and b_off == prep.bias.numel()

    read = _conv_from_blocks if prep.fused else _conv_from_rows

    def stage(t, i):
        blocks, bias, kh, cin, cout, stride = stages[i]
        acc = read(t.float(), blocks, kh, cin, cout, stride)
        return fr.silu_bf16(acc.permute(0, 3, 1, 2), bias).permute(0, 2, 3, 1)

    y1 = stage(stage(x, 0), 1)
    p0, p1 = y1[..., :c], y1[..., c:]
    h = p1 + stage(stage(p1, 2), 3)
    return stage(torch.cat([p0, p1, h], -1), 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_prepared_layout_consumer_matches_plain_and_jax(seed):
    """`prepare_region`'s flat weight and bias buffers, read by a plain
    consumer that walks them as kernel J's k-steps do, give
    `region_b1b2_plain`'s result within one bf16 ulp (the same bf16
    operands and rounding points, the f32 sums tap by tap) and JAX's
    Pallas kernel in interpret mode within its bar; `fused_b1b2` on CPU
    tensors takes the prepared object too."""
    x, params = _case(seed, batch=1, h=16, c1=16, c2=32)
    prep = fr.prepare_region(params, "cpu")
    assert prep.w.dtype == torch.bfloat16 and prep.w.numel() == (
        9 * 16 * 32 + 32 * 32 + 2 * 9 * 16 * 16 + 3 * 16 * 32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = _region_from_prepared(xt, prep)
    ref = fr.region_b1b2_plain(xt, params)
    d = (got.float() - ref.float()).abs()
    # the sums run tap by tap here and in one conv there: a bf16 ulp at most
    assert float(d.max()) <= 2.0 ** -7 * float(ref.float().abs().max())
    assert torch.equal(fr.fused_b1b2(xt, prep), ref)
    x_cells = cc.cellify(jnp.asarray(x, jnp.bfloat16))
    jref = np.asarray(cc.decellify(j_fused(
        x_cells, _jparams(params), interpret=True)).astype(jnp.float32))
    _bars(got.float().numpy(), jref)


def test_wide_prepared_layout_consumer_matches_plain_and_jax():
    """YOLOv8-m's widths (48, 96), which the fused kernel cannot hold: the
    five-launch form's layout (`weight_rows`), read by a plain consumer,
    gives `region_b1b2_plain`'s result within one bf16 ulp and JAX's
    Pallas kernel in interpret mode within its bar."""
    x, params = _case(4, batch=1, h=8, c1=48, c2=96)
    prep = fr.prepare_region(params, "cpu")
    assert not prep.fused and prep.w.dtype == torch.bfloat16
    assert torch.equal(prep.w[:9 * 48 * 96],
                       fr.weight_rows(torch.as_tensor(
                           params["b1"]["conv"]["kernel"])))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = _region_from_prepared(xt, prep)
    ref = fr.region_b1b2_plain(xt, params)
    d = (got.float() - ref.float()).abs()
    assert float(d.max()) <= 2.0 ** -7 * float(ref.float().abs().max())
    assert torch.equal(fr.fused_b1b2(xt, prep), ref)
    x_cells = cc.cellify(jnp.asarray(x, jnp.bfloat16))
    jref = np.asarray(cc.decellify(j_fused(
        x_cells, _jparams(params), interpret=True)).astype(jnp.float32))
    _bars(got.float().numpy(), jref)


def test_weight_rows_layout():
    """Element n * 9 * cin + t * cin + c of a kernel's rows is kernel[u, v,
    c, n], t = 3 u + v; the fused widths take the blocks, others the
    rows."""
    k = torch.arange(3 * 3 * 16 * 24, dtype=torch.float32).reshape(
        3, 3, 16, 24)
    rows = fr.weight_rows(k).float()
    for u, v, ci, n in ((0, 0, 0, 0), (1, 2, 9, 5), (2, 1, 15, 23)):
        assert float(rows[n * 9 * 16 + (3 * u + v) * 16 + ci]) == float(
            k[u, v, ci, n].to(torch.bfloat16))
    assert (32, 64) in fr.FUSED_WIDTHS and (16, 32) in fr.FUSED_WIDTHS
    assert (48, 96) not in fr.FUSED_WIDTHS


def test_weight_blocks_layout():
    """Element ((t * cin / 8 + j) * cout + n) * 8 + e of a kernel's blocks
    is kernel[u, v, 8 j + e, n], t = 3 u + v."""
    k = torch.arange(3 * 3 * 16 * 24, dtype=torch.float32).reshape(
        3, 3, 16, 24)
    blk = fr.weight_blocks(k).float()
    for u, v, ci, n in ((0, 0, 0, 0), (1, 2, 9, 5), (2, 1, 15, 23)):
        t, j, e = 3 * u + v, ci // 8, ci % 8
        assert float(blk[((t * 2 + j) * 24 + n) * 8 + e]) == float(
            k[u, v, ci, n].to(torch.bfloat16))

