"""Numpy copies of the OpenCV 5 intensity steps of the classical layout
engines, bit-equal to cv2 5.0.0:

- :func:`adaptive_threshold_mean`: ``cv2.adaptiveThreshold`` with
  ``ADAPTIVE_THRESH_MEAN_C`` and ``THRESH_BINARY``, which the classical
  line detector binarizes with (JAX
  ``layout_engines/simple_baseline_engine.py``);
- :func:`adaptive_threshold_gaussian` (``ADAPTIVE_THRESH_GAUSSIAN_C``),
  :func:`normalize_minmax_u8` (``cv2.normalize(NORM_MINMAX, CV_8UC1)``)
  and :func:`pad_constant_u8` (``cv2.copyMakeBorder(BORDER_CONSTANT)``
  with a float value), the steps of ``REGION_SIMPLE_THRESHOLD`` (JAX
  ``layout_engines/simple_region_engine.py``).

The mean threshold:

OpenCV takes the local mean with ``boxFilter(normalize=True)`` over
``BORDER_REPLICATE | BORDER_ISOLATED`` into an 8-bit image: the exact
integer window sum divided by the window's area and rounded to nearest
(a window's area is odd, so no sum lies halfway).  A pixel is then
``max_value`` where ``src - mean > -ceil(c)``, else 0.  A region
narrower or shorter than the block is all border, which ``np.pad``'s
``edge`` mode replicates as far as the block needs.
"""

from __future__ import annotations

import math

import numpy as np


def box_mean_u8(src: np.ndarray, block_size: int) -> np.ndarray:
    """The rounded mean of each pixel's ``block_size`` square window,
    edges replicated, as int64 (``cv2.boxFilter`` on uint8)."""
    r = block_size // 2
    h, w = src.shape
    # Window sums reach 255 * block_size * (h + 2r) down the columns.
    dtype = np.int32 if 255 * block_size * (max(h, w) + 2 * r) < 2**31 else np.int64
    padded = np.pad(src.astype(dtype), r, mode="edge")
    c = np.zeros((padded.shape[0], padded.shape[1] + 1), dtype)
    np.cumsum(padded, axis=1, out=c[:, 1:])
    rows = c[:, block_size:] - c[:, :-block_size]
    c = np.zeros((rows.shape[0] + 1, rows.shape[1]), dtype)
    np.cumsum(rows, axis=0, out=c[1:])
    sums = c[block_size:] - c[:-block_size]
    return np.rint(sums / float(block_size * block_size)).astype(np.int64)


def adaptive_threshold_mean(src_u8: np.ndarray, block_size: int, c: float,
                            max_value: int = 255) -> np.ndarray:
    """``cv2.adaptiveThreshold(src_u8, max_value, ADAPTIVE_THRESH_MEAN_C,
    THRESH_BINARY, block_size, c)`` on a 2-D uint8 image."""
    src_u8 = np.asarray(src_u8)
    if src_u8.dtype != np.uint8 or src_u8.ndim != 2:
        raise ValueError(f"adaptive threshold takes a 2-D uint8 image, got "
                         f"{src_u8.shape} {src_u8.dtype}")
    if block_size % 2 != 1 or block_size <= 1:
        raise ValueError(f"block_size must be odd and greater than 1, got {block_size}")
    if src_u8.size == 0:
        return src_u8.copy()
    mean = box_mean_u8(src_u8, block_size)
    out_value = np.uint8(min(max(round(max_value), 0), 255))
    keep = src_u8.astype(np.int64) - mean > -math.ceil(c)
    return np.where(keep, out_value, np.uint8(0))


def _check_u8(src: np.ndarray, what: str) -> np.ndarray:
    src = np.asarray(src)
    if src.dtype != np.uint8 or src.ndim != 2:
        raise ValueError(f"{what} takes a 2-D uint8 image, got {src.shape} {src.dtype}")
    return src


def normalize_minmax_u8(src_u8: np.ndarray, alpha: float = 0.0, beta: float = 255.0) -> np.ndarray:
    """``cv2.normalize(src_u8, None, alpha, beta, NORM_MINMAX, CV_8UC1)``
    on a 2-D uint8 image.  OpenCV takes ``scale = (beta - alpha) * (1 /
    (max - min))`` (0 when max == min) and ``shift = alpha - min *
    scale`` in double, rounds both to float32 and stores
    ``saturate_cast<uchar>(fma(x, scale, shift))``: the product and sum
    rounded once to float32, then to nearest, halves to even.  The
    product of a uint8 and a float32 and its sum with the float32 shift
    are exact in float64, so one cast to float32 is that fma."""
    src = _check_u8(src_u8, "normalize_minmax_u8")
    if src.size == 0:
        return src.copy()
    smin, smax = float(src.min()), float(src.max())
    dmin, dmax = min(alpha, beta), max(alpha, beta)
    scale = (dmax - dmin) * (1.0 / (smax - smin) if smax - smin > np.finfo(float).eps else 0.0)
    shift = dmin - smin * scale
    scale32, shift32 = np.float64(np.float32(scale)), np.float64(np.float32(shift))
    v = (src.astype(np.float64) * scale32 + shift32).astype(np.float32)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def pad_constant_u8(src_u8: np.ndarray, top: int, bottom: int, left: int, right: int,
                    value: float) -> np.ndarray:
    """``cv2.copyMakeBorder(src_u8, top, bottom, left, right,
    BORDER_CONSTANT, value=value)`` on a 2-D uint8 image: the value
    becomes ``saturate_cast<uchar>(value)``, rounded to nearest with
    halves to even (150.5 pads 150, 151.5 pads 152)."""
    src = _check_u8(src_u8, "pad_constant_u8")
    fill = np.uint8(np.clip(np.rint(float(value)), 0, 255))
    return np.pad(src, ((top, bottom), (left, right)), mode="constant", constant_values=fill)


_SMALL_GAUSSIAN = {  # getGaussianKernel's fixed kernels for sigma <= 0
    1: (1.0,), 3: (0.25, 0.5, 0.25), 5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
    9: tuple(v / 256 for v in (4, 13, 30, 51, 60, 51, 30, 13, 4)),
}


def gaussian_kernel_f32(n: int) -> np.ndarray:
    """``cv2.getGaussianKernel(n, 0, CV_32F)`` for odd ``n``: OpenCV's
    bit-exact construction in double (sigma = 0.15 n + 0.35, the taps
    ``exp(-x^2 / (8 sigma^2))`` at x = 1 - n, 3 - n, ..., summed in
    that order, doubled, plus the centre's 1, then each scaled by the
    sum's inverse), rounded to float32."""
    if n in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[n], np.float32)
    sigma = n * 0.15 + 0.35
    scale = -0.125 / (sigma * sigma)
    half = (n - 1) // 2
    x = np.arange(1 - n, 1 - n + 2 * half, 2, dtype=np.float64)
    taps = np.exp(x * x * scale)
    total = 0.0
    for t in taps:
        total += float(t)
    inv = 1.0 / (2.0 * total + 1.0)
    return np.concatenate([taps * inv, [inv], (taps * inv)[::-1]]).astype(np.float32)


def _fma32(a: np.ndarray, b, c: np.ndarray) -> np.ndarray:
    """float32 ``fma(a, b, c)``: the float32 product is exact in float64,
    the sum rounded there and then to float32."""
    return (a.astype(np.float64) * np.float64(b) + c.astype(np.float64)).astype(np.float32)


def gaussian_blur_f32(src: np.ndarray, n: int) -> np.ndarray:
    """``cv2.GaussianBlur(src, (n, n), 0, borderType=BORDER_REPLICATE |
    BORDER_ISOLATED)`` of a 2-D float32 image, in OpenCV 5's
    arithmetic as this build dispatches it (AVX2 with FMA).  The row
    pass sums the n taps left to right, one fused multiply-add each, in
    the columns its vector loops cover (all but ``W % 4``); the last
    ones add float32 products.  The column pass starts from the centre
    tap times its row and adds the pair of rows at each distance times
    its tap, fused in the columns of its 8-lane loop (all but ``W %
    8``) and not after them.  Rows and columns off the image repeat the
    edge."""
    k = gaussian_kernel_f32(n)
    r = n // 2
    h, w = src.shape
    p = np.pad(src.astype(np.float32), r, mode="edge")
    wv = w // 4 * 4
    rows = np.empty((h + 2 * r, w), np.float32)
    acc = np.zeros((h + 2 * r, wv), np.float32)
    for j in range(n):
        acc = _fma32(p[:, j:j + wv], k[j], acc)
    rows[:, :wv] = acc
    tail = p[:, wv:w] * k[0]
    for j in range(1, n):
        tail = tail + p[:, wv + j:w + j] * k[j]
    rows[:, wv:] = tail
    wv = w // 8 * 8
    centre = rows[r:r + h]
    fused = centre[:, :wv] * k[r]
    plain = centre[:, wv:] * k[r]
    for j in range(1, r + 1):
        pair = rows[r - j:r - j + h] + rows[r + j:r + j + h]
        fused = _fma32(pair[:, :wv], k[r + j], fused)
        plain = plain + pair[:, wv:] * k[r + j]
    return np.concatenate([fused, plain], axis=1)


def adaptive_threshold_gaussian(src_u8: np.ndarray, block_size: int, c: float,
                                max_value: int = 255) -> np.ndarray:
    """``cv2.adaptiveThreshold(src_u8, max_value,
    ADAPTIVE_THRESH_GAUSSIAN_C, THRESH_BINARY, block_size, c)`` on a 2-D
    uint8 image.  OpenCV blurs the image as float32
    (:func:`gaussian_blur_f32`), rounds the mean to uint8 (nearest,
    halves to even) and keeps ``max_value`` where ``src - mean >
    -ceil(c)``."""
    src = _check_u8(src_u8, "adaptive threshold")
    if block_size % 2 != 1 or block_size <= 1:
        raise ValueError(f"block_size must be odd and greater than 1, got {block_size}")
    if src.size == 0:
        return src.copy()
    mean = np.clip(np.rint(gaussian_blur_f32(src, block_size)), 0, 255).astype(np.int64)
    out_value = np.uint8(min(max(round(max_value), 0), 255))
    keep = src.astype(np.int64) - mean > -math.ceil(c)
    return np.where(keep, out_value, np.uint8(0))
