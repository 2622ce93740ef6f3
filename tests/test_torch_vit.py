"""PyTorch port, the ViT classifier in every mode the JAX `ViTSpec`
accepts: each (quant, attn_impl) pair and pad_tokens, on int8 crops in
patch layout and on NHWC images in [-1, 1], held against the JAX
`ViTClassifier` on the same parameters (the JAX init, pre-quantized as an
engine of that mode is built).

Bars at f32: float modes atol 5e-5, rtol 1e-4 (tests/test_fused_attention
.py:43); the quantised modes, whose int8 products are exact in both, 1e-4
as tests/test_torch_models.py holds w8a, and argmax equality everywhere.
bf16 activations: argmax equality and 5% of the logit spread, as the w8a
bf16 test there.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from yolov8_vit_tpu.models.vit import ViTClassifier as JViTClassifier
from yolov8_vit_tpu.models.vit import ViTSpec as JViTSpec
from yolov8_vit_tpu.ops.crop import crop_to_patches_i8 as j_crop
from yolov8_vit_tpu.ops.quant import MLP_AND_ATTN_SUFFIXES, MLP_SUFFIXES
from yolov8_vit_tpu.ops.quant import prequantize_tree as j_prequantize

from yolov8_vit_tpu_torch.models.vit import ViTClassifier, ViTSpec
from yolov8_vit_tpu_torch.weights import load_tree

VIT_KW = dict(img_size=32, patch=8, dim=64, depth=2, heads=4,
              backbone_classes=40)
MODES = [(q, a) for q in ("none", "dynamic", "w8")
         for a in ("xla", "pallas", "fused")] + [("w8a", "fused")]


@pytest.fixture(scope="module")
def trees():
    """The JAX init (float layout) and its w8 / w8a pre-quantized forms."""
    p = ViTKW_init()
    return {"none": p, "dynamic": p,
            "w8": jax.tree.map(np.asarray, j_prequantize(p, MLP_SUFFIXES)),
            "w8a": jax.tree.map(np.asarray,
                                j_prequantize(p, MLP_AND_ATTN_SUFFIXES))}


def ViTKW_init():
    x = jnp.zeros((1, 32, 32, 3))
    p = jax.jit(JViTClassifier(JViTSpec(**VIT_KW), 5).init)(
        jax.random.PRNGKey(0), x)
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 80, 96, 3), np.uint8)
    k = 5
    x1, y1 = rng.integers(0, 50, k), rng.integers(0, 40, k)
    boxes = np.stack([x1, y1, x1 + rng.integers(6, 40, k),
                      y1 + rng.integers(6, 30, k)], -1).astype(np.int32)
    slot = rng.integers(0, 2, k).astype(np.int32)
    patches = np.array(j_crop(jnp.asarray(frames), jnp.asarray(slot),
                              jnp.asarray(boxes), (32, 32), 8))
    images = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    return {"patches": patches, "images": images}


def _run(trees, inputs, quant, attn, kind, pad=0, dt_j=jnp.float32,
         dt_t=torch.float32):
    kw = dict(VIT_KW, quant=quant, attn_impl=attn, pad_tokens=pad)
    tree = trees[quant]
    jv = JViTClassifier(JViTSpec(**kw), 5, dtype=dt_j)
    tv = ViTClassifier(ViTSpec(**kw), 5, dtype=dt_t)
    load_tree(tv, tree["params"])
    x = inputs[kind]
    ref = np.asarray(jax.jit(jv.apply)(tree, jnp.asarray(x))
                     .astype(jnp.float32))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = tv(xt if kind == "patches" else xt.to(dt_t)).float().numpy()
    return got, ref


@pytest.mark.parametrize("kind", ["patches", "images"])
@pytest.mark.parametrize("quant,attn", MODES)
def test_vit_logits_match_jax_f32(trees, inputs, quant, attn, kind):
    got, ref = _run(trees, inputs, quant, attn, kind)
    tol = (dict(atol=5e-5, rtol=1e-4) if quant == "none"
           else dict(atol=1e-4, rtol=1e-4))
    np.testing.assert_allclose(got, ref, **tol)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("quant,attn", [("none", "fused"), ("none", "xla"),
                                        ("w8", "fused"), ("w8a", "fused")])
def test_vit_pad_tokens_match_jax(trees, inputs, quant, attn):
    """pad_tokens > tokens: padded keys masked in every attention form."""
    got, ref = _run(trees, inputs, quant, attn, "patches", pad=24)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("quant,attn", [("none", "fused"), ("none", "xla"),
                                        ("none", "pallas"),
                                        ("dynamic", "fused"),
                                        ("w8", "fused")])
def test_vit_bf16_argmax_matches_jax(trees, inputs, quant, attn):
    got, ref = _run(trees, inputs, quant, attn, "patches",
                    dt_j=jnp.bfloat16, dt_t=torch.bfloat16)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    assert np.abs(got - ref).max() / (ref.max() - ref.min()) < 0.05


def test_int8_fold_sums_bf16_kernel_as_xla():
    """A bf16-stored patch-embed kernel stays bf16, and the int8 fold's
    sum(W) is XLA's: the CPU reduction of a bf16 array accumulates in f32
    and rounds once to bf16 (not a bf16 running sum), so the folded bias
    equals JAX's bit for bit (vit.py:329-330)."""
    from yolov8_vit_tpu_torch.models.vit import PatchEmbed
    rng = np.random.default_rng(11)
    k = jnp.asarray(rng.normal(size=(8, 8, 3, 64)) * 0.05, jnp.bfloat16)
    b = jnp.asarray(rng.normal(size=64) * 0.1, jnp.bfloat16)
    ref = np.asarray(b + jnp.sum(k, axis=(0, 1, 2)) / jnp.float32(255.0))
    pe = PatchEmbed(8, 64)
    load_tree(pe, {"kernel": np.asarray(k), "bias": np.asarray(b)})
    assert pe.kernel.dtype == torch.bfloat16
    w, bias = pe.int8_fold()
    np.testing.assert_array_equal(bias.numpy(), ref)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(k.reshape(-1, 64) / jnp.float32(127.5)))
