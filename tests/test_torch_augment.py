"""PyTorch port, the training augmentations (train/augment.py): the numpy
forms of OpenCV's calls against OpenCV, and each branch of
`train_transform`, forced alone, and the whole train and eval transforms
against the JAX module (which calls OpenCV) under the same seeds.

Bars: branches that do not interpolate (resize, flip, crop-pad, channel
shuffle, dropout) and the eval transform equal; the affine warp, the
grid distortion and `remap_linear` within 1e-5 (they reproduce OpenCV's
float arithmetic and agree bit for bit in practice); the elastic
transform, and a whole train transform that may take it, with 99.9 % of
values within 1e-5 and all within 0.07: its displacement maps are
blurred in another summation order than OpenCV's (the blur itself
within 1e-7 of values up to 0.01), and a sample coordinate that moves
by an f32 ulp moves its bilinear weights by as much.
"""
import cv2
import numpy as np
import pytest

from yolov8_vit_tpu.train import augment as J

from yolov8_vit_tpu_torch.train import augment as P


class _Forced:
    """A numpy Generator whose argument-less random() calls (the branch
    decisions of train_transform) return the given values in turn; every
    other call goes to a real Generator."""

    def __init__(self, seed, decisions):
        self._g = np.random.default_rng(seed)
        self._d = list(decisions)

    def random(self, *args, **kw):
        if args or kw:
            return self._g.random(*args, **kw)
        return self._d.pop(0)

    def __getattr__(self, name):
        return getattr(self._g, name)


ON, OFF = 0.0, 0.99
# decisions: flip, crop, shift-scale-rotate, shuffle, grid|elastic,
# [grid (ON) or elastic (OFF)], dropout
BRANCHES = {
    "none": [OFF] * 6,
    "flip": [ON] + [OFF] * 5,
    "crop_pad": [OFF, ON] + [OFF] * 4,
    "shift_scale_rotate": [OFF, OFF, ON] + [OFF] * 3,
    "channel_shuffle": [OFF] * 3 + [ON] + [OFF] * 2,
    "grid_distortion": [OFF] * 4 + [ON, ON, OFF],
    "elastic": [OFF] * 4 + [ON, OFF, OFF],
    "dropout": [OFF] * 5 + [ON],
}
INTERPOLATING = {"shift_scale_rotate", "grid_distortion"}


def _image(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(20, 300, 2)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _elastic_bar(got, ref):
    err = np.abs(got - ref)
    assert np.isfinite(got).all()
    assert (err <= 1e-5).mean() >= 0.999, (err <= 1e-5).mean()
    assert err.max() <= 0.07, err.max()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_branch_alone_matches_jax(branch, seed):
    img = _image(seed)
    size = 224 if seed < 2 else 32
    ref = J.train_transform(img, _Forced(seed, BRANCHES[branch]), size)
    got = P.train_transform(img, _Forced(seed, BRANCHES[branch]), size)
    assert got.shape == ref.shape == (size, size, 3)
    assert got.dtype == np.float32
    if branch == "elastic":
        _elastic_bar(got, ref)
    elif branch in INTERPOLATING:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("first", [0, 8, 16, 24])
def test_train_and_eval_transform_match_jax(first):
    """32 seeds (8 a case) of the whole transforms."""
    for seed in range(first, first + 8):
        img = _image(100 + seed)
        _elastic_bar(
            P.train_transform(img, np.random.default_rng(seed)),
            J.train_transform(img, np.random.default_rng(seed)))
        np.testing.assert_array_equal(P.eval_transform(img),
                                      J.eval_transform(img))


@pytest.mark.parametrize("shape", [(37, 53), (500, 300), (224, 224),
                                   (13, 400), (80, 100), (1, 1)])
def test_resize_nearest_equals_cv2(shape):
    img = np.random.default_rng(shape[0]).integers(
        0, 256, (*shape, 3), dtype=np.uint8)
    for size in (224, 32):
        np.testing.assert_array_equal(
            P.resize_nearest_np(img, size),
            cv2.resize(img, (size, size), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("size", [224, 32])
def test_warp_affine_and_remap_equal_cv2(size):
    rng = np.random.default_rng(size)
    img = rng.uniform(-1, 1, (size, size, 3)).astype(np.float32)
    for _ in range(4):
        angle, scale = rng.uniform(-10, 10), 1 + rng.uniform(-.05, .05)
        m = cv2.getRotationMatrix2D((size / 2, size / 2), angle, scale)
        np.testing.assert_allclose(
            P.rotation_matrix((size / 2, size / 2), angle, scale), m,
            rtol=0, atol=1e-12)
        m[:, 2] += rng.uniform(-0.0625, 0.0625, 2) * size
        np.testing.assert_allclose(
            P.warp_affine(img, m, size),
            cv2.warpAffine(img, m, (size, size),
                           borderMode=cv2.BORDER_REFLECT_101),
            atol=1e-5, rtol=0)
    gx, gy = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32))
    mx = (gx + rng.uniform(-3, 3, gx.shape)).astype(np.float32)
    my = (gy + rng.uniform(-3, 3, gy.shape)).astype(np.float32)
    for im in (img, img[..., 0].copy()):
        np.testing.assert_allclose(
            P.remap_linear(im, mx, my),
            cv2.remap(im, mx, my, cv2.INTER_LINEAR,
                      borderMode=cv2.BORDER_REFLECT_101),
            atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [224, 32])
def test_gaussian_blur_close_to_cv2(size):
    a = np.random.default_rng(7).uniform(-1, 1, (size, size)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        P._gaussian_taps(50.0),
        cv2.getGaussianKernel(401, 50.0, cv2.CV_32F).ravel())
    np.testing.assert_allclose(P.gaussian_blur(a, 50.0),
                               cv2.GaussianBlur(a, (0, 0), 50.0),
                               atol=1e-7, rtol=0)
