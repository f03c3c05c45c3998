"""A numpy copy of ``cv2.adaptiveThreshold`` with
``ADAPTIVE_THRESH_MEAN_C`` and ``THRESH_BINARY``, which the classical
line detector binarizes with (JAX
``layout_engines/simple_baseline_engine.py``).  Bit-equal to OpenCV 5.

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
