"""Host-side training augmentations in numpy (PyTorch port of
`yolov8_vit_tpu/train/augment.py`):

  train: Resize(224, nearest) -> HFlip(.5) -> Normalize(.5, .5)
         -> [RandomCrop(200) + PadIfNeeded](p=.25)
         -> ShiftScaleRotate(shift .0625, scale .05, rot 10 deg, p=.25)
         -> ChannelShuffle(.5)
         -> [GridDistortion(5, .05) | ElasticTransform](p=.25)
         -> CoarseDropout(5-8 holes of size // 20, p=.5)
  eval:  Resize(224, nearest) -> Normalize(.5, .5)

The JAX package calls OpenCV for the resize, the affine warp, the remaps
and the Gaussian blur; the GPU machine has no cv2, so this module carries
numpy forms of those calls, as OpenCV 5 computes them on float32 images:

  resize_nearest_np   source index min(floor(x * (1 / (dst / src))),
                      src - 1), OpenCV's resizeNN;
  warp_affine         the 2x3 matrix inverted in f64 and cast to f32;
                      source coordinates fma(m0, x, m1 y + m2) in f32;
  remap_linear        bilinear over float source coordinates, the four
                      taps reflect-101 at the border, two lerps along x
                      and one along y, each fma(a, v1 - v0, v0) in f32;
  gaussian_blur       getGaussianKernel's f32 taps (computed and
                      normalised in f64), size round(8 sigma + 1) | 1,
                      applied separably with reflect-101 borders; the
                      sums run in f64 and round once to f32, where OpenCV
                      sums in f32 in its own order (a relative 1e-6).

warp_affine and remap_linear equal OpenCV's outputs bit for bit (an f32
fma is emulated in f64, whose double rounding can differ in the last bit
about once in 2^29 operations); the blur agrees to about 1e-6 of its
values (tests/test_torch_augment.py).  Each transform draws from the
Generator in the JAX module's order and with its calls, so one seed takes
the same branches and the same parameters in both.
"""
from __future__ import annotations

import functools
import math

import numpy as np

_F32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """f32 fused multiply-add: the f64 product of two f32 values is exact,
    and the sum rounds once in f64 before the cast to f32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _reflect101(p: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's borderInterpolate(p, n, BORDER_REFLECT_101),
    gfedcb|abcdefgh|gfedcba, reflected as often as needed."""
    if n == 1:
        return np.zeros_like(p)
    p = np.asarray(p)
    while ((p < 0) | (p >= n)).any():
        p = np.where(p < 0, -p, p)
        p = np.where(p >= n, 2 * n - 2 - p, p)
    return p


def resize_nearest_np(img: np.ndarray, size: int = 224) -> np.ndarray:
    """cv2.resize(img, (size, size), interpolation=INTER_NEAREST)."""
    def index(src: int) -> np.ndarray:
        ifx = 1.0 / (size / src)
        return np.minimum(np.floor(np.arange(size) * ifx).astype(np.int64),
                          src - 1)
    return img[index(img.shape[0])][:, index(img.shape[1])]


def normalize_pm1_np(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1] (mean = std = 0.5 over [0, 1])."""
    return img.astype(np.float32) / 255.0 * 2.0 - 1.0


def remap_linear(img: np.ndarray, map_x: np.ndarray,
                 map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR,
    borderMode=BORDER_REFLECT_101) on a float32 (H, W) or (H, W, C)
    image with float32 maps."""
    h, w = img.shape[:2]
    fx, fy = np.floor(map_x), np.floor(map_y)
    a, b = (map_x - fx).astype(_F32), (map_y - fy).astype(_F32)
    sx, sy = fx.astype(np.int64), fy.astype(np.int64)
    x0, x1 = _reflect101(sx, w), _reflect101(sx + 1, w)
    y0, y1 = _reflect101(sy, h), _reflect101(sy + 1, h)
    if img.ndim == 3:
        a, b = a[..., None], b[..., None]
    p00, p01 = img[y0, x0], img[y0, x1]
    p10, p11 = img[y1, x0], img[y1, x1]
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    return _fma(b, v1 - v0, v0)


def rotation_matrix(center: tuple[float, float], angle: float,
                    scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) f64, angle in degrees
    (counter-clockwise); the centre is a Point2f."""
    cx, cy = (float(_F32(c)) for c in center)
    angle = angle * math.pi / 180
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _affine_maps(m: np.ndarray, size: int):
    """warpAffine's source coordinates of a (size, size) output: the 2x3
    matrix inverted in f64, cast to f32, fma(m0, x, m1 y + m2) in f32."""
    m = [float(v) for v in np.asarray(m, np.float64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    mf = np.asarray(m, _F32)
    x = np.arange(size, dtype=_F32)[None, :]
    y = np.arange(size, dtype=_F32)[:, None]
    ones = np.ones((size, size), _F32)
    map_x = _fma(mf[0] * ones, x * ones, (mf[1] * y + mf[2]) * ones)
    map_y = _fma(mf[3] * ones, x * ones, (mf[4] * y + mf[5]) * ones)
    return map_x, map_y


def warp_affine(img: np.ndarray, m: np.ndarray, size: int) -> np.ndarray:
    """cv2.warpAffine(img, m, (size, size),
    borderMode=BORDER_REFLECT_101): dst(x, y) = img(M^-1 (x, y))."""
    return remap_linear(img, *_affine_maps(m, size))


def warp_affine_u8(img: np.ndarray, m: np.ndarray, size: int,
                   border: int = 114) -> np.ndarray:
    """cv2.warpAffine(img, m, (size, size), borderValue=(border,) * 3) on
    a uint8 (H, W, 3) image: the source coordinates of `_affine_maps`,
    each of the four taps read as f32 (`border` where it lies off the
    image), the lerps of `remap_linear`, rounded half to even."""
    h, w = img.shape[:2]
    map_x, map_y = _affine_maps(m, size)
    fx, fy = np.floor(map_x), np.floor(map_y)
    a = (map_x - fx).astype(_F32)[..., None]
    b = (map_y - fy).astype(_F32)[..., None]
    # one pixel of border around the image: every tap off the image reads
    # it once its index is clamped to [-1, n]
    src = np.pad(img.astype(_F32), ((1, 1), (1, 1), (0, 0)),
                 constant_values=border)
    x0 = np.clip(fx, -1, w).astype(np.int64) + 1
    y0 = np.clip(fy, -1, h).astype(np.int64) + 1
    x1 = np.clip(fx + 1, -1, w).astype(np.int64) + 1
    y1 = np.clip(fy + 1, -1, h).astype(np.int64) + 1
    p00, p01 = src[y0, x0], src[y0, x1]
    p10, p11 = src[y1, x0], src[y1, x1]
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    return np.clip(np.rint(_fma(b, v1 - v0, v0)), 0, 255).astype(np.uint8)


# ---- OpenCV's uint8 colour conversions (COLOR_RGB2HSV / HSV2RGB) ----------
_HSV_SHIFT = 12


@functools.lru_cache(maxsize=1)
def _hsv_div_tables() -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's sdiv_table and hdiv_table180: round((255 << 12) / i) and
    round((180 << 12) / (6 i)), 0 at i = 0 (read-only)."""
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    sdiv.flags.writeable = hdiv.flags.writeable = False
    return sdiv, hdiv


def rgb2hsv_u8(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_RGB2HSV) on uint8 (..., 3): OpenCV's
    integer arithmetic, hue in [0, 180), saturation and value in [0, 255],
    the divisions by table with 12 fractional bits."""
    sdiv, hdiv = _hsv_div_tables()
    x = img.astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h += np.where(h < 0, 180, 0)
    return np.stack([h, s, v], -1).astype(np.uint8)


# HSV2RGB's sectors: the (b, g, r) columns of [v, p, q, t]
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1],
                         [0, 1, 3], [2, 1, 0]])
# OpenCV converts a row's pixels in blocks of 32 (its AVX2 path: 4 vectors
# of 8 f32 lanes), which truncate each channel; the row's last W mod 32
# pixels take its scalar code, which rounds half to even.
_HSV2RGB_BLOCK = 32


def hsv2rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB) on a uint8 (H, W, 3) image
    with hue in [0, 180), as OpenCV 5 computes it on x86 with AVX2: f32
    arithmetic, s and v scaled by (1 / 255f), the hue's sector and
    fraction from h * (6 / 180f), q and t as v (1 - s f) with the inner
    product fused (fma); each channel from x * 255 truncated in the
    32-pixel blocks of a row and rounded half to even in its tail (s = 0
    gives v on every channel, as OpenCV's own branch does)."""
    if hsv.size and int(hsv[..., 0].max()) >= 180:
        raise ValueError("hsv2rgb_u8: hue must lie in [0, 180)")
    one = _F32(1.0)
    h = hsv[..., 0].astype(_F32) * (_F32(6.0) / _F32(180.0))
    s = hsv[..., 1].astype(_F32) * (one / _F32(255.0))
    v = hsv[..., 2].astype(_F32) * (one / _F32(255.0))
    sector = np.floor(h)
    h = h - sector
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one),
                    v * _fma(-s, one - h, one)], -1)
    cols = _HSV_SECTORS[sector.astype(np.int64)]
    rgb = np.take_along_axis(tab, cols, -1)[..., ::-1] * _F32(255.0)
    w = hsv.shape[1]
    tail = w - w % _HSV2RGB_BLOCK
    out = np.trunc(rgb)
    out[:, tail:] = np.rint(rgb[:, tail:])
    return np.clip(out, 0, 255).astype(np.uint8)


def _gaussian_taps(sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(round(8 sigma + 1) | 1, sigma, CV_32F): the
    size GaussianBlur picks for float images."""
    n = int(round(sigma * 4 * 2 + 1)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    t = np.exp((-0.5 / (sigma * sigma)) * x * x)
    return (t * (1.0 / t.sum())).astype(_F32)


@functools.lru_cache(maxsize=8)
def _blur_matrix(n: int, sigma: float) -> np.ndarray:
    """(n, n) f64, read-only: row i holds the taps of output i summed onto
    the source indices they read under reflect-101 (cached: the elastic
    transform blurs two maps of one size at one sigma per call)."""
    taps = _gaussian_taps(sigma)
    r = len(taps) // 2
    idx = _reflect101(np.arange(n)[:, None] + np.arange(-r, r + 1), n)
    out = np.zeros((n, n))
    np.add.at(out, (np.repeat(np.arange(n), len(taps)), idx.ravel()),
              np.tile(taps.astype(np.float64), n))
    out.flags.writeable = False
    return out


def gaussian_blur(a: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(a, (0, 0), sigma) on a float32 (H, W) array."""
    rows = _blur_matrix(a.shape[0], sigma)
    cols = _blur_matrix(a.shape[1], sigma)
    return (rows @ a.astype(np.float64) @ cols.T).astype(_F32)


def train_transform(img: np.ndarray, rng: np.random.Generator,
                    size: int = 224) -> np.ndarray:
    """uint8 HWC RGB any size -> float32 (size, size, 3) in [-1, 1]."""
    img = resize_nearest_np(img, size)

    if rng.random() < 0.5:  # HorizontalFlip
        img = img[:, ::-1]

    out = normalize_pm1_np(img)

    if rng.random() < 0.25:  # RandomCrop(200) + PadIfNeeded
        ch = cw = min(200, size)
        y0 = rng.integers(0, size - ch + 1)
        x0 = rng.integers(0, size - cw + 1)
        crop = out[y0:y0 + ch, x0:x0 + cw]
        pad_y = size - ch
        pad_x = size - cw
        top = pad_y // 2
        left = pad_x // 2
        out = np.pad(crop, ((top, pad_y - top), (left, pad_x - left), (0, 0)),
                     constant_values=0.0)

    if rng.random() < 0.25:  # ShiftScaleRotate
        shift = rng.uniform(-0.0625, 0.0625, 2) * size
        scale = 1.0 + rng.uniform(-0.05, 0.05)
        angle = rng.uniform(-10, 10)
        m = rotation_matrix((size / 2, size / 2), angle, scale)
        m[:, 2] += shift
        out = warp_affine(out, m, size)

    if rng.random() < 0.5:  # ChannelShuffle
        out = out[..., rng.permutation(3)]

    if rng.random() < 0.25:  # GridDistortion | ElasticTransform
        if rng.random() < 0.5:
            out = _grid_distortion(out, rng, num_steps=5, distort=0.05)
        else:
            out = _elastic(out, rng, alpha=1.0, sigma=50.0)

    if rng.random() < 0.5:  # CoarseDropout
        holes = rng.integers(5, 9)
        hmax = max(size // 20, 1)
        for _ in range(holes):
            hh = rng.integers(1, hmax + 1)
            ww = rng.integers(1, hmax + 1)
            y0 = rng.integers(0, size - hh + 1)
            x0 = rng.integers(0, size - ww + 1)
            out[y0:y0 + hh, x0:x0 + ww] = 0.0

    return np.ascontiguousarray(out, np.float32)


def eval_transform(img: np.ndarray, size: int = 224) -> np.ndarray:
    return normalize_pm1_np(resize_nearest_np(img, size))


def _grid_distortion(img, rng, num_steps=5, distort=0.05):
    h, w = img.shape[:2]
    xs = np.linspace(0, w, num_steps + 1)
    ys = np.linspace(0, h, num_steps + 1)
    dx = 1 + rng.uniform(-distort, distort, num_steps + 1)
    dy = 1 + rng.uniform(-distort, distort, num_steps + 1)
    map_x = np.interp(np.arange(w), xs, np.cumsum(np.diff(
        xs, prepend=0) * dx))
    map_y = np.interp(np.arange(h), ys, np.cumsum(np.diff(
        ys, prepend=0) * dy))
    map_x = np.clip(map_x * (w - 1) / max(map_x[-1], 1e-6), 0, w - 1)
    map_y = np.clip(map_y * (h - 1) / max(map_y[-1], 1e-6), 0, h - 1)
    gx, gy = np.meshgrid(map_x.astype(np.float32), map_y.astype(np.float32))
    return remap_linear(img, gx, gy)


def _elastic(img, rng, alpha=1.0, sigma=50.0):
    h, w = img.shape[:2]
    dx = gaussian_blur((rng.random((h, w)).astype(np.float32) * 2 - 1),
                       sigma) * alpha
    dy = gaussian_blur((rng.random((h, w)).astype(np.float32) * 2 - 1),
                       sigma) * alpha
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    return remap_linear(img, gx + dx, gy + dy)
