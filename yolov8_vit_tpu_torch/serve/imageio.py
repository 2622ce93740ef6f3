"""Host image helpers of the service: everything the JAX package asks of
OpenCV, on numpy arrays in OpenCV's conventions (HWC uint8, BGR).

  decode / encode   `imread`, `imdecode`, `imwrite`.  Uncompressed 24-bit
                    .bmp is read and written here in numpy; every other
                    format goes through PIL, imported inside the function
                    that needs it.
  geometry          `copy_make_border` (constant), `resize_linear`
                    (cv2.resize INTER_LINEAR on uint8: its fixed-point
                    arithmetic with 11-bit weights, reproduced exactly).
  drawing           `rectangle`, `put_text`.  Drawn pixels are not
                    OpenCV's (another font, square line ends).
"""
from __future__ import annotations

import io
import os
import struct

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


# ---- BMP -----------------------------------------------------------------
def _decode_bmp(data: bytes):
    """Uncompressed 24-bit BMP bytes -> BGR (H, W, 3) uint8, or None when
    the bytes are another kind of file or BMP."""
    if len(data) < 54 or data[:2] != b"BM":
        return None
    offset = struct.unpack_from("<I", data, 10)[0]
    hdr, w, h, planes, bpp, comp = struct.unpack_from("<IiiHHI", data, 14)
    if hdr < 40 or planes != 1 or bpp != 24 or comp != 0 or w <= 0 or h == 0:
        return None
    stride = (3 * w + 3) // 4 * 4
    rows = abs(h)
    if len(data) < offset + stride * rows:
        return None
    arr = np.frombuffer(data, np.uint8, stride * rows, offset) \
        .reshape(rows, stride)[:, :3 * w].reshape(rows, w, 3)
    return np.ascontiguousarray(arr[::-1] if h > 0 else arr)


def _encode_bmp(bgr: np.ndarray) -> bytes:
    h, w = bgr.shape[:2]
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = bgr[::-1].reshape(h, 3 * w)
    head = struct.pack("<2sIHHI", b"BM", 54 + stride * h, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, stride * h,
                       2835, 2835, 0, 0)
    return head + info + rows.tobytes()


# ---- decode / encode -----------------------------------------------------
def imdecode(data: bytes):
    """Encoded image bytes -> BGR (H, W, 3) uint8, or None (cv2.imdecode
    with IMREAD_COLOR)."""
    bmp = _decode_bmp(data)
    if bmp is not None:
        return bmp
    try:
        from PIL import Image
        with Image.open(io.BytesIO(data)) as im:
            rgb = np.asarray(im.convert("RGB"))
    except (ImportError, OSError, ValueError, SyntaxError):
        return None
    return np.ascontiguousarray(rgb[..., ::-1])


def imread(path: str):
    """Image file -> BGR (H, W, 3) uint8, or None (cv2.imread)."""
    try:
        with open(path, "rb") as f:
            return imdecode(f.read())
    except OSError:
        return None


def imread_rgb(path: str):
    """Image file -> RGB (H, W, 3) uint8, or None."""
    bgr = imread(path)
    return None if bgr is None else bgr2rgb(bgr)


def imwrite(path: str, bgr: np.ndarray) -> bool:
    """Write a BGR image in the format of the path's extension (.bmp in
    numpy, others through PIL; JPEG quality 95 as OpenCV's default).
    Raises ValueError for an extension it does not know, as cv2.imwrite
    does."""
    ext = os.path.splitext(path)[1].lower()
    bgr = np.ascontiguousarray(bgr, np.uint8)
    if ext == ".bmp":
        with open(path, "wb") as f:
            f.write(_encode_bmp(bgr))
        return True
    fmt = {".jpg": "JPEG", ".jpeg": "JPEG", ".png": "PNG"}.get(ext)
    if fmt is None:
        raise ValueError(f"no image writer for extension {ext!r}")
    from PIL import Image
    kw = {"quality": 95} if fmt == "JPEG" else {}
    Image.fromarray(bgr2rgb(bgr)).save(path, fmt, **kw)
    return True


def bgr2rgb(img: np.ndarray) -> np.ndarray:
    """BGR <-> RGB (its own inverse), contiguous."""
    return np.ascontiguousarray(img[..., ::-1])


# ---- geometry ------------------------------------------------------------
def copy_make_border(im: np.ndarray, top: int, bottom: int, left: int,
                     right: int, value) -> np.ndarray:
    """cv2.copyMakeBorder with BORDER_CONSTANT."""
    h, w, c = im.shape
    out = np.empty((h + top + bottom, w + left + right, c), im.dtype)
    out[...] = np.asarray(value, im.dtype)
    out[top:top + h, left:left + w] = im
    return out


_COEF_BITS = 11                     # OpenCV's INTER_RESIZE_COEF_BITS


def _linear_taps(dst: int, src: int, horizontal: bool):
    """The two source indices and 11-bit weights of each output position,
    as cv2.resize computes them: the fraction in float from a double
    scale, weights rounded half to even.  Past either end the horizontal
    pass puts the whole weight on the edge pixel; the vertical pass keeps
    both weights and clamps only the row indices."""
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx.astype(np.float32)
    if horizontal:
        low, high = sx < 0, sx >= src - 1
        fx[low | high] = 0.0
        sx[low] = 0
        sx[high] = src - 1
    one = np.float32(1 << _COEF_BITS)
    a0 = np.rint((np.float32(1.0) - fx) * one).astype(np.int64)
    a1 = np.rint(fx * one).astype(np.int64)
    return (np.clip(sx, 0, src - 1), np.clip(sx + 1, 0, src - 1), a0, a1)


def resize_linear(im: np.ndarray, new_wh: tuple[int, int]) -> np.ndarray:
    """cv2.resize(im, new_wh, interpolation=cv2.INTER_LINEAR) for uint8
    HWC images, bit for bit: a horizontal pass with 11-bit weights into
    integers, a vertical pass that drops 4 then 16 bits per term and rounds
    the last 2; an exact halving of both sides averages 2x2 blocks (OpenCV
    takes its area path there)."""
    w2, h2 = new_wh
    h, w = im.shape[:2]
    if (h2, w2) == (h, w):
        return im.copy()
    if h == 2 * h2 and w == 2 * w2:
        s = im.astype(np.int64)
        return ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2]
                 + s[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(w2, w, True)
    y0, y1, b0, b1 = _linear_taps(h2, h, False)
    s = im.astype(np.int64)
    rows = s[:, x0] * a0[None, :, None] + s[:, x1] * a1[None, :, None]
    r0, r1 = rows[y0] >> 4, rows[y1] >> 4
    out = (((b0[:, None, None] * r0) >> 16) + ((b1[:, None, None] * r1) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


# ---- drawing ---------------------------------------------------------------
def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 2) -> None:
    """Draw an axis-aligned rectangle outline in place (clipped to the
    image)."""
    h, w = img.shape[:2]
    x1, x2 = sorted((int(pt1[0]), int(pt2[0])))
    y1, y2 = sorted((int(pt1[1]), int(pt2[1])))
    lo, hi = thickness // 2, thickness - thickness // 2

    def fill(ya, yb, xa, xb):
        ya, yb = max(ya, 0), min(yb, h)
        xa, xb = max(xa, 0), min(xb, w)
        if ya < yb and xa < xb:
            img[ya:yb, xa:xb] = np.asarray(color, img.dtype)

    fill(y1 - lo, y1 + hi, x1 - lo, x2 + hi)
    fill(y2 - lo, y2 + hi, x1 - lo, x2 + hi)
    fill(y1 - lo, y2 + hi, x1 - lo, x1 + hi)
    fill(y1 - lo, y2 + hi, x2 - lo, x2 + hi)


def put_text(img: np.ndarray, text: str, org, color) -> None:
    """Draw `text` with its baseline's left end at `org`, in place (PIL's
    default font; without PIL the label is left out)."""
    try:
        from PIL import Image, ImageDraw
    except ImportError:
        return
    pil = Image.fromarray(bgr2rgb(img))
    ImageDraw.Draw(pil).text((int(org[0]), int(org[1]) - 11), text,
                             fill=tuple(int(c) for c in color[::-1]))
    img[...] = np.asarray(pil)[..., ::-1]
