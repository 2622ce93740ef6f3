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
