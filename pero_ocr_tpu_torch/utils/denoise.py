"""``cv2.fastNlMeansDenoising(img, h=h)`` of a grey uint8 image (7x7
template, 21x21 search window), bit-equal to OpenCV 5: the denoising
step of ``REGION_SIMPLE_THRESHOLD``.

:func:`nl_means` runs the port's host C++ (``csrc/nlmeans.cpp``, built
with the host compiler on first use by
:mod:`pero_ocr_tpu_torch.utils.kernels`; a missing compiler or a failed
build raises, nothing falls back).  :func:`nl_means_plain` is its numpy
twin: one vectorised pass over the image for each of the 441 offsets,
fine for small images and too slow for a page.  :data:`calls` counts
the C++ calls.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np

from pero_ocr_tpu_torch.utils import kernels

calls = collections.Counter()  # C function name -> calls through this binding

TEMPLATE_HALF = 3
SEARCH_HALF = 10
_SHIFT = 6  # 49 template pixels rounded up to 64
_U8P = ctypes.POINTER(ctypes.c_uint8)


def get_library() -> ctypes.CDLL:
    lib = kernels.library("nlmeans")
    if lib.nl_means_u8.argtypes is None:
        lib.nl_means_u8.restype = ctypes.c_int32
        lib.nl_means_u8.argtypes = [_U8P, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
                                    _U8P, ctypes.c_int32]
    return lib


def _check(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2 or img.size == 0:
        raise ValueError(f"NL-means takes a non-empty 2-D uint8 image, got "
                         f"{img.shape} {img.dtype}")
    return np.ascontiguousarray(img)


def nl_means(img: np.ndarray, h: float, threads: int = 0) -> np.ndarray:
    """The C++ route; ``threads`` <= 0 takes every hardware thread (the
    result does not depend on it)."""
    src = _check(img)
    out = np.empty_like(src)
    lib = get_library()
    calls["nl_means_u8"] += 1
    if lib.nl_means_u8(src.ctypes.data_as(_U8P), src.shape[0], src.shape[1], float(h),
                       out.ctypes.data_as(_U8P), int(threads)) != 0:
        raise RuntimeError("nl_means_u8 failed")
    return out


def weight_table(h: float) -> np.ndarray:
    """OpenCV's weights by "almost average" distance ``D >> 6``:
    ``round(fpm * exp(-(a * 64/49) / (h * h)))``, halves to even, 0
    below ``0.001 * fpm``; ``fpm = INT_MAX // (441 * 255)``, ``h * h``
    in float32."""
    window = 2 * SEARCH_HALF + 1
    fpm = np.iinfo(np.int32).max // (window * window * 255)
    mult = (1 << _SHIFT) / (2 * TEMPLATE_HALF + 1) ** 2
    a = np.arange(int(255 * 255 / mult + 1), dtype=np.float64)
    hh = np.float64(np.float32(h) * np.float32(h))
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.exp(-(a * mult) / hh)
    w = np.rint(fpm * np.nan_to_num(w, nan=1.0))
    w[w < 0.001 * fpm] = 0
    return w.astype(np.int64)


def nl_means_plain(img: np.ndarray, h: float) -> np.ndarray:
    """The numpy twin of :func:`nl_means`: the image padded by 13 with
    ``BORDER_REFLECT_101`` (numpy's ``reflect``), and for each offset
    the 7x7 sums of squared differences from one integral image, the
    table's weights, and the weighted sums, all in exact integers."""
    src = _check(img)
    hgt, wid = src.shape
    t, s = TEMPLATE_HALF, SEARCH_HALF
    size = 2 * t + 1
    padded = np.pad(src, t + s, mode="reflect").astype(np.int64)
    table = weight_table(h)
    est = np.zeros((hgt, wid), np.int64)
    wsum = np.zeros((hgt, wid), np.int64)
    centre = padded[s:s + hgt + 2 * t, s:s + wid + 2 * t]
    for dy in range(-s, s + 1):
        for dx in range(-s, s + 1):
            other = padded[s + dy:s + dy + hgt + 2 * t, s + dx:s + dx + wid + 2 * t]
            c = np.pad((centre - other) ** 2, ((1, 0), (1, 0))).cumsum(0).cumsum(1)
            dist = c[size:, size:] - c[:-size, size:] - c[size:, :-size] + c[:-size, :-size]
            weight = table[dist >> _SHIFT]
            est += weight * other[t:t + hgt, t:t + wid]
            wsum += weight
    return ((est + wsum // 2) // wsum).astype(np.uint8)
