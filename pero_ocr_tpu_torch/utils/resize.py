"""Host copies of the OpenCV calls of the stage-by-stage path that
resample images, equal to cv2 5.0.0 bit for bit.

- :func:`resize_area` is ``cv2.resize(img, (0, 0), fx=1/s, fy=1/s,
  interpolation=cv2.INTER_AREA)``, the ParseNet input of
  ``ParseNetWrapper.get_maps``.  OpenCV has two branches: an integer
  scale averages whole s x s cells (its "area fast" path), any other
  scale sums float32 area weights over the cells' source pixels.
- :func:`resize_linear_u8` is ``cv2.resize(img, None, fx=1/s, fy=1/s)``
  (the default ``INTER_LINEAR``) of a uint8 image by an integer factor
  s, the first step of ``REGION_SIMPLE_THRESHOLD``.
- :func:`remap_linear` is ``cv2.remap(img, map_x, map_y, INTER_LINEAR,
  BORDER_CONSTANT)`` with float32 maps, the line crop of
  ``EngineLineCropper.fast_remap``.  OpenCV 5 samples in float32 with
  fused multiply-adds (OpenCV 4 used 1/32 px fixed point instead; the
  JAX package's reference is the OpenCV installed beside it, 5.0.0).
- :func:`remap_linear_f32` is the same remap of a float32 image (the
  baseline map that ``ADJUST_BASELINES`` crops), and
  :func:`warp_affine_linear` ``cv2.warpAffine(img, M, dsize)`` of a
  float32 image (``DETECT_STRAIGHT_LINES_IN_REGIONS`` turns a region's
  maps with it): OpenCV 5 maps every destination pixel through the
  inverted matrix in float32, not to 1/32 px as OpenCV 4 did.

They follow OpenCV's ``imgproc/src/resize.cpp``, ``imgwarp.cpp`` and
``warp_kernels.simd.hpp`` step by step, in the same arithmetic types and
summation order, with numpy vectorised over pixels.
"""

from __future__ import annotations

import numpy as np

_DBL_EPSILON = float(np.finfo(np.float64).eps)


def _cv_round(v: np.ndarray) -> np.ndarray:
    """cvRound: nearest integer, halves to even (lrint)."""
    return np.rint(v)


def _saturate_u8(v: np.ndarray) -> np.ndarray:
    """saturate_cast<uchar> of a float: cvRound, then clamp to [0, 255]."""
    return np.clip(_cv_round(v), 0, 255).astype(np.uint8)


def _as_hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError(f"expected a uint8 image with 1 or 3 channels, got "
                         f"{img.dtype} {img.shape}")
    return img[:, :, None] if img.ndim == 2 else img


def _area_fast(src: np.ndarray, dh: int, dw: int, sx: int, sy: int) -> np.ndarray:
    """``resizeAreaFast_Invoker``: the mean of each sy x sx cell.  A
    whole cell is ``saturate_cast(sum * (1.f / area))``; a cell cut by
    the right or bottom edge averages the pixels it holds,
    ``saturate_cast((float)sum / count)``.  At scale 2 OpenCV's own
    loop rounds a whole cell's mean half up, ``(sum + 2) >> 2``."""
    h, w, cn = src.shape
    pad_h, pad_w = dh * sy, dw * sx
    padded = np.zeros((max(pad_h, h), max(pad_w, w), cn), np.int64)
    padded[:h, :w] = src
    inside = np.zeros(padded.shape[:2], np.int64)
    inside[:h, :w] = 1
    cells = padded[:pad_h, :pad_w].reshape(dh, sy, dw, sx, cn)
    sums = cells.sum(axis=(1, 3))
    counts = inside[:pad_h, :pad_w].reshape(dh, sy, dw, sx).sum(axis=(1, 3))
    area = sx * sy
    whole = np.zeros((dh, dw), bool)
    full_rows = min(dh, h // sy)
    whole[:full_rows, : min(dw, w // sx)] = True
    scale = np.float32(1.0) / np.float32(area)
    mean_whole = sums.astype(np.float32) * scale
    if sx == 2 and sy == 2:
        out_whole = ((sums + 2) >> 2).astype(np.float32)
    else:
        out_whole = mean_whole
    with np.errstate(divide="ignore", invalid="ignore"):
        mean_part = sums.astype(np.float32) / counts[..., None].astype(np.float32)
    out = np.where(whole[..., None], out_whole, np.nan_to_num(mean_part, nan=0.0))
    return _saturate_u8(out)


def _area_tab(ssize: int, dsize: int, scale: float):
    """``computeResizeAreaTab`` for one axis: per output index, the
    source indices it covers and their float32 weights, in OpenCV's
    order, as (dsize, m) arrays (weight 0 pads the short rows)."""
    entries = [[] for _ in range(dsize)]
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            entries[dx].append((sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            entries[dx].append((sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            entries[dx].append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
    m = max(len(e) for e in entries)
    idx = np.zeros((dsize, m), np.int64)
    alpha = np.zeros((dsize, m), np.float32)
    for dx, e in enumerate(entries):
        for k, (si, a) in enumerate(e):
            idx[dx, k], alpha[dx, k] = si, a
    return idx, alpha


def _area_general(src: np.ndarray, dh: int, dw: int, scale_x: float, scale_y: float):
    """``ResizeArea_Invoker`` with float32 sums: each source row's pixels
    weighted and summed into its output columns in table order, then the
    rows weighted and summed into each output row in table order."""
    xi, xa = _area_tab(src.shape[1], dw, scale_x)
    yi, ya = _area_tab(src.shape[0], dh, scale_y)
    rows = src.astype(np.float32)
    buf = np.zeros((src.shape[0], dw, src.shape[2]), np.float32)
    for k in range(xi.shape[1]):
        buf = buf + rows[:, xi[:, k]] * xa[:, k][None, :, None]
    total = ya[:, 0][:, None, None] * buf[yi[:, 0]]
    for k in range(1, yi.shape[1]):
        total = total + ya[:, k][:, None, None] * buf[yi[:, k]]
    return _saturate_u8(total)


def resize_area(img: np.ndarray, scale: float) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=1 / scale, fy=1 / scale,
    interpolation=cv2.INTER_AREA)`` for a uint8 (H, W) or (H, W, C)
    image, C in {1, 3}, and ``scale`` >= 1.  The output size is
    ``round(W * (1 / scale))`` by ``round(H * (1 / scale))``, halves to
    even, as cv2 computes it."""
    squeeze = np.asarray(img).ndim == 2
    src = _as_hwc(img)
    inv = 1.0 / scale
    if not inv <= 1.0:
        raise ValueError(f"resize_area: scale {scale} < 1 is not an area resize")
    h, w = src.shape[:2]
    dw, dh = int(np.rint(w * inv)), int(np.rint(h * inv))
    if dw < 1 or dh < 1:
        raise ValueError(f"resize_area: {w}x{h} at 1/{scale} is empty")
    scale_x, scale_y = 1.0 / inv, 1.0 / inv
    ix, iy = int(np.rint(scale_x)), int(np.rint(scale_y))
    if abs(scale_x - ix) < _DBL_EPSILON and abs(scale_y - iy) < _DBL_EPSILON:
        out = _area_fast(src, dh, dw, ix, iy)
    else:
        out = _area_general(src, dh, dw, scale_x, scale_y)
    return out[:, :, 0] if squeeze else out


def resize_linear_u8(img: np.ndarray, downscale: int) -> np.ndarray:
    """``cv2.resize(img, None, fx=1 / downscale, fy=1 / downscale)``
    (``INTER_LINEAR``) for a uint8 (H, W) or (H, W, C) image and an
    integer ``downscale`` >= 1.  The output is ``round(W / s)`` by
    ``round(H / s)``, halves to even.

    OpenCV maps output column x to source ``(x + 0.5) s - 0.5``, clamps
    the taps to the image and blends them with weights in 1/2048.  For
    an integer s that point is a pixel (s odd: the pixel itself) or the
    midpoint of two (s even: weights 1024 each), so an even s gives
    ``(a + b + c + d + 2) >> 2`` over rows ``s i + s/2 - 1`` and
    ``s i + s/2`` (clamped to H - 1) and the same columns.  At s = 2
    OpenCV switches to ``INTER_AREA``, whose whole 2 x 2 cells round
    the same way (:func:`resize_area`).  Other factors raise."""
    if isinstance(downscale, bool) or not float(downscale).is_integer() or downscale < 1:
        raise ValueError(f"resize_linear_u8: downscale {downscale} is not an integer >= 1")
    s = int(downscale)
    squeeze = np.asarray(img).ndim == 2
    src = _as_hwc(img)
    if s == 1:
        out = src.copy()
    elif s == 2:
        out = resize_area(src, 2)
    else:
        h, w = src.shape[:2]
        dh, dw = int(np.rint(h / s)), int(np.rint(w / s))
        if dw < 1 or dh < 1:
            raise ValueError(f"resize_linear_u8: {w}x{h} at 1/{s} is empty")
        first = s // 2 - 1 if s % 2 == 0 else (s - 1) // 2
        rows = np.minimum(s * np.arange(dh) + first, h - 1)
        cols = np.minimum(s * np.arange(dw) + first, w - 1)
        if s % 2:
            out = src[rows][:, cols]
        else:
            a = src.astype(np.int32)
            r1, c1 = np.minimum(rows + 1, h - 1), np.minimum(cols + 1, w - 1)
            out = ((a[rows][:, cols] + a[rows][:, c1] + a[r1][:, cols] + a[r1][:, c1] + 2)
                   >> 2).astype(np.uint8)
    return out[:, :, 0] if squeeze else out


# ----------------------------------------------------------------------
# remap, INTER_LINEAR, BORDER_CONSTANT 0
def _lerp(p: np.ndarray, q: np.ndarray, t: np.ndarray) -> np.ndarray:
    """float32 ``p + t * (q - p)`` with one rounding of the product and
    sum, as OpenCV's vector code does it (a fused multiply-add): the
    difference rounds to float32, the rest is exact in float64."""
    d = (q - p).astype(np.float32)
    return (p.astype(np.float64) + t.astype(np.float64) * d.astype(np.float64)).astype(np.float32)


def remap_linear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_CONSTANT)`` (border value 0) for a uint8
    (H, W) or (H, W, C) image, C in {1, 3}, and float32 (h, w) maps.

    OpenCV 5 samples in float32: x0 = floor(x), a = x - x0 (and y0, b
    alike); taps off the image read 0; the row pairs blend first,
    ``v0 = p00 + a * (p01 - p00)`` and ``v1 = p10 + a * (p11 - p10)``,
    then ``v = v0 + b * (v1 - v0)``, each a fused multiply-add; the
    store is saturate_cast<uchar>: round half to even, clamp to
    [0, 255] (NaN stores 0)."""
    squeeze = np.asarray(img).ndim == 2
    src = _as_hwc(img)
    v = _bilinear_f32(src, *_maps_f32(map_x, map_y))
    with np.errstate(invalid="ignore"):
        out = np.clip(np.nan_to_num(np.rint(v), nan=0.0), 0, 255).astype(np.uint8)
    return out[:, :, 0] if squeeze else out


def _maps_f32(map_x, map_y):
    map_x = np.asarray(map_x, np.float32)
    map_y = np.asarray(map_y, np.float32)
    if map_x.shape != map_y.shape or map_x.ndim != 2:
        raise ValueError(f"remap: maps {map_x.shape} and {map_y.shape}")
    return map_x, map_y


# ----------------------------------------------------------------------
# remap and warpAffine of float32 images, INTER_LINEAR, BORDER_CONSTANT 0
def _bilinear_f32(src: np.ndarray, sx: np.ndarray, sy: np.ndarray) -> np.ndarray:
    """OpenCV 5's float32 bilinear sample of ``src`` (H, W, C, any dtype)
    at float32 coordinates: taps off the image read 0; v0 = p00 + a
    (p01 - p00), v1 = p10 + a (p11 - p10), v = v0 + b (v1 - v0), each a
    fused multiply-add; float32 (h, w, C)."""
    h, w, _ = src.shape
    with np.errstate(invalid="ignore"):
        fx, fy = np.floor(sx), np.floor(sy)
        a = (sx - fx)[..., None]
        b = (sy - fy)[..., None]
    x0 = np.nan_to_num(np.clip(fx, -2.0, w + 1.0), nan=-2.0).astype(np.int64)
    y0 = np.nan_to_num(np.clip(fy, -2.0, h + 1.0), nan=-2.0).astype(np.int64)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        t = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(np.float32)
        return np.where(inside[..., None], t, np.float32(0.0))

    with np.errstate(invalid="ignore"):
        v0 = _lerp(tap(y0, x0), tap(y0, x0 + 1), a)
        v1 = _lerp(tap(y0 + 1, x0), tap(y0 + 1, x0 + 1), a)
        return _lerp(v0, v1, b)


def remap_linear_f32(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_CONSTANT)`` for a float32 (H, W) or (H, W, C)
    image and float32 (h, w) maps: :func:`remap_linear`'s sampling
    without the rounding store.  Like cv2, a one-channel image comes
    back (h, w)."""
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim not in (2, 3):
        raise ValueError(f"expected a float32 image, got {img.dtype} {img.shape}")
    src = img[:, :, None] if img.ndim == 2 else img
    out = _bilinear_f32(src, *_maps_f32(map_x, map_y))
    return out[:, :, 0] if src.shape[2] == 1 else out


# OpenCV 5.0.0's warpAffine kernel, as dispatched for AVX2, maps a row's
# columns 16 at a time (two vectors of 8 float32 lanes) while 16 or more
# remain, and the rest one at a time.
_WARP_AFFINE_STEP = 16


def warp_affine_linear(img: np.ndarray, matrix: np.ndarray, dsize) -> np.ndarray:
    """``cv2.warpAffine(img, matrix, dsize)`` (INTER_LINEAR,
    BORDER_CONSTANT 0) for a float32 (H, W) or (H, W, C) image, ``dsize``
    (width, height).  As OpenCV 5.0.0 computes it: the 2x3 map is
    inverted in float64 and rounded to float32 (M); destination pixel
    (x, y) samples source point (sx, sy) with, in the vector columns,
    ``sx = fma(M0, x, y M1 + M2)`` (the row term rounded twice) and, in
    the columns after them, ``sx = fma(x, M0, y M1) + M2`` (sy alike),
    then :func:`remap_linear_f32`'s bilinear sample."""
    img = np.asarray(img)
    if img.dtype != np.float32 or img.ndim not in (2, 3):
        raise ValueError(f"expected a float32 image, got {img.dtype} {img.shape}")
    src = img[:, :, None] if img.ndim == 2 else img
    m = np.asarray(matrix, np.float64).reshape(-1).copy()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    m[0] = a11
    m[1] *= -det
    m[3] *= -det
    m[4] = a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    m = m.astype(np.float32).astype(np.float64)

    dw, dh = int(dsize[0]), int(dsize[1])
    x = np.arange(dw, dtype=np.float64)[None, :]
    y = np.arange(dh, dtype=np.float64)[:, None]
    f32 = np.float32
    vector = dw // _WARP_AFFINE_STEP * _WARP_AFFINE_STEP
    coords = []
    for c0, c1, c2 in ((m[0], m[1], m[2]), (m[3], m[4], m[5])):
        y_term = (y * c1).astype(f32).astype(np.float64)
        row = (y_term + c2).astype(f32).astype(np.float64)
        head = (c0 * x[:, :vector] + row).astype(f32)
        tail = ((x[:, vector:] * c0 + y_term).astype(f32).astype(np.float64) + c2).astype(f32)
        coords.append(np.concatenate([np.broadcast_to(head, (dh, head.shape[1])),
                                      np.broadcast_to(tail, (dh, tail.shape[1]))], axis=1))
    out = _bilinear_f32(src, coords[0], coords[1])
    return out[:, :, 0] if src.shape[2] == 1 else out
