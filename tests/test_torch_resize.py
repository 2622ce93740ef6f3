"""PyTorch port, the exact-gather image ops: `resize_nearest`,
`resize_bilinear` and `letterbox` against the JAX functions on the same
numpy inputs.  Nearest resize and uint8 results are equal; float bilinear
results agree to 1e-5 of a 0-255 scale (the same four f32 products, summed
in the same order)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from yolov8_vit_tpu.ops import resize as j_resize
from yolov8_vit_tpu.ops.letterbox import letterbox as j_letterbox

from yolov8_vit_tpu_torch.ops.letterbox import letterbox
from yolov8_vit_tpu_torch.ops.resize import resize_bilinear, resize_nearest

SIZES = [((37, 53), (224, 224)), ((300, 200), (64, 96)),
         ((64, 64), (64, 64)), ((5, 9), (17, 3))]


@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_nearest_equals_jax(src, dst):
    img = np.random.default_rng(0).integers(0, 256, (2, *src, 3),
                                            dtype=np.uint8)
    got = resize_nearest(torch.from_numpy(img), dst)
    ref = j_resize.resize_nearest(jnp.asarray(img), dst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    one = resize_nearest(torch.from_numpy(img[0]), dst)      # unbatched
    np.testing.assert_array_equal(one.numpy(), np.asarray(ref)[0])


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("src,dst", SIZES)
def test_resize_bilinear_matches_jax(src, dst, dtype):
    img = np.random.default_rng(1).integers(0, 256, (2, *src, 3)) \
        .astype(dtype)
    got = resize_bilinear(torch.from_numpy(img), dst)
    ref = np.asarray(j_resize.resize_bilinear(jnp.asarray(img), dst))
    assert got.numpy().dtype == ref.dtype
    if dtype == "uint8":
        # a value within float error of .5 may round to either side
        d = np.abs(got.numpy().astype(int) - ref.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("hw", [(64, 64), (96, 128), (50, 37), (480, 641)])
def test_letterbox_matches_jax(hw):
    img = np.random.default_rng(2).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got, r, dwdh = letterbox(torch.from_numpy(img), (64, 64))
    ref, rr, rdwdh = j_letterbox(jnp.asarray(img), (64, 64))
    assert (r, dwdh) == (rr, rdwdh) and tuple(got.shape) == (64, 64, 3)
    d = np.abs(got.numpy().astype(int) - np.asarray(ref).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
    if hw == (64, 64):
        np.testing.assert_array_equal(got.numpy(), img)
