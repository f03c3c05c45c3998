"""libtiff 4.7's colour conversions for ``TIFFRGBAImage``, as OpenCV 5's
``cv2.imread(path, cv2.IMREAD_COLOR)`` reaches them for a TIFF page:
YCbCr without JPEG (``tif_color.c``'s ``TIFFYCbCrToRGBInit`` integer
tables and ``TIFFYCbCrtoRGB``) and CIELab (``initCIELabConversion``'s
reference white from the WhitePoint tag, ``TIFFCIELabToRGBInit``'s
``display_sRGB`` tables, ``TIFFCIELab16ToXYZ`` and ``TIFFXYZToRGB``).

libtiff computes these in C ``float`` (and ``double`` where it adds 0.5
or calls ``pow``); the numpy code below rounds each operation to
float32 in libtiff's order, so that every 8-bit triple maps to libtiff's
byte.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

F = np.float32

# tif_color.c's display_sRGB (TIFFDisplay): the XYZ -> luminance
# matrix, the light output for reference white, the pixel values for
# reference white, the residual light for black, and the guns' gammas.
_SRGB_MATRIX = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                         [0.0556, -0.2040, 1.0570]], np.float32)
_SRGB_YC, _SRGB_VRW, _SRGB_Y0, _SRGB_GAMMA = F(100.0), 255, F(1.0), F(2.4)
_RANGE = 1500  # CIELABTORGB_TABLE_RANGE

# TIFFGetFieldDefaulted's WhitePoint: CIE D50.
_D50 = (F(96.4250), F(100.0), F(82.4680))
DEFAULT_WHITE_POINT = (_D50[0] / (_D50[0] + _D50[1] + _D50[2]),
                       _D50[1] / (_D50[0] + _D50[1] + _D50[2]))
DEFAULT_LUMA = (F(0.299), F(0.587), F(0.114))  # CCIR 601-1, TIFFGetFieldDefaulted's


def default_reference_black_white(bits: int = 8) -> Tuple[float, ...]:
    """TIFFDefaultRefBlackWhite for a YCbCr page."""
    top = F((1 << bits) - 1)
    mid = F(1 << (bits - 1))
    return (F(0), top, mid, top, mid, top)


def _fix(x: np.float32) -> int:
    """FIX(x): (int32)(x * 65536L + 0.5), the product in float."""
    return int(np.float64(F(x) * F(65536)) + 0.5)


def _clamp_f(f, lo, hi):
    return lo if f < lo else hi if f > hi else f


def _code2v(c: np.ndarray, rb: np.float32, rw: np.float32, cr: float) -> np.ndarray:
    """Code2V(c, RB, RW, CR): ((c - (int32)RB) * (float)CR) / (float)(RW - RB or 1)."""
    diff = F(rw) - F(rb)
    den = diff if diff != 0 else F(1)
    return ((c - int(np.trunc(rb))).astype(np.float32) * F(cr)) / den


def _clampw(f: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """CLAMPw(f, min, max) on float32, then the (int32_t) cast."""
    f = np.where(f < F(lo), F(lo), np.where(f > F(hi), F(hi), f))
    return np.trunc(f).astype(np.int64)


def ycbcr_tables(luma: Sequence[float] = DEFAULT_LUMA,
                 refbw: Sequence[float] = None) -> Tuple[np.ndarray, ...]:
    """TIFFYCbCrToRGBInit's tables: (Y_tab, Cr_r_tab, Cb_b_tab,
    Cr_g_tab, Cb_g_tab), each 256 int64 values."""
    if refbw is None:
        refbw = default_reference_black_white()
    lr, lg, lb = (F(v) for v in luma)
    rbw = [F(v) for v in refbw]
    f1 = F(2) - F(2) * lr
    d1 = _fix(_clamp_f(f1, F(0), F(2)))
    f2 = lr * f1 / lg
    d2 = -_fix(_clamp_f(f2, F(0), F(2)))
    f3 = F(2) - F(2) * lb
    d3 = _fix(_clamp_f(f3, F(0), F(2)))
    f4 = lb * f3 / lg
    d4 = -_fix(_clamp_f(f4, F(0), F(2)))
    x = np.arange(-128, 128, dtype=np.int64)
    cr = _clampw(_code2v(x, rbw[4] - F(128), rbw[5] - F(128), 127), -128.0 * 32, 128.0 * 32)
    cb = _clampw(_code2v(x, rbw[2] - F(128), rbw[3] - F(128), 127), -128.0 * 32, 128.0 * 32)
    half = 1 << 15
    cr_r = (d1 * cr + half) >> 16
    cb_b = (d3 * cb + half) >> 16
    cr_g = d2 * cr
    cb_g = d4 * cb + half
    y = _clampw(_code2v(x + 128, rbw[0], rbw[1], 255), -128.0 * 32, 128.0 * 32)
    return y, cr_r, cb_b, cr_g, cb_g


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, tables,
                 sh: int = 1, sv: int = 1) -> np.ndarray:
    """TIFFYCbCrtoRGB on uint8 samples: (H, W, 3) uint8 RGB.  ``cb`` and
    ``cr`` may hold one sample a sh x sv block of ``y`` (the blocks of a
    subsampled page, the last ones reaching past its edge)."""
    y_tab, cr_r, cb_b, cr_g, cb_g = (t.astype(np.int32) for t in tables)
    h, w = y.shape
    # The green term's sum stays within int32 (|D4 * Cb| and |D2 * Cr|
    # are below 2**30 each).
    terms = [cr_r[cr], (cb_g[cb] + cr_g[cr]) >> 16, cb_b[cb]]
    yv = y_tab[y]
    out = np.empty((h, w, 3), np.uint8)
    for k, term in enumerate(terms):
        if (sh, sv) != (1, 1):
            term = np.repeat(np.repeat(term, sv, axis=0), sh, axis=1)[:h, :w]
        out[:, :, k] = np.clip(yv + term, 0, 255)
    return out


# ----------------------------------------------------------------------
# CIELab
def cielab_tables(white_point: Sequence[float] = DEFAULT_WHITE_POINT):
    """initCIELabConversion: (the reference white X0, Y0, Z0, the
    Yr2r table of 1501 float32s, the step) for ``display_sRGB``."""
    wx, wy = F(white_point[0]), F(white_point[1])
    y0 = F(100.0)
    x0 = wx / wy * y0
    z0 = (F(1.0) - wx - wy) / wy * y0
    gamma = 1.0 / float(_SRGB_GAMMA)
    table = np.array([F(_SRGB_VRW) * F(math.pow(i / _RANGE, gamma)) for i in range(_RANGE + 1)],
                     np.float32)
    step = (_SRGB_YC - _SRGB_Y0) / F(_RANGE)
    return (x0, y0, z0), table, step


def cielab16_to_xyz(l: np.ndarray, a: np.ndarray, b: np.ndarray, white) -> Tuple[np.ndarray, ...]:
    """TIFFCIELab16ToXYZ: L in 0..65535, a and b 256 times a* and b*."""
    x0, y0, z0 = white
    lf = l.astype(np.float32) * F(100.0) / F(65535.0)
    low = lf < F(8.856)
    y_low = (lf * y0) / F(903.292)
    cby_low = F(7.787) * (y_low / y0) + F(16.0) / F(116.0)
    cby_high = (lf + F(16.0)) / F(116.0)
    y_high = y0 * cby_high * cby_high * cby_high
    yy = np.where(low, y_low, y_high)
    cby = np.where(low, cby_low, cby_high)

    def from_t(t, ref):
        return np.where(t < F(0.2069), ref * (t - F(0.13793)) / F(7.787), ref * t * t * t)

    t = a.astype(np.float32) / F(256.0) / F(500.0) + cby
    xx = from_t(t, x0)
    t = cby - b.astype(np.float32) / F(256.0) / F(200.0)
    zz = from_t(t, z0)
    return xx, yy, zz


def xyz_to_rgb(x: np.ndarray, y: np.ndarray, z: np.ndarray, tables) -> np.ndarray:
    """TIFFXYZToRGB for display_sRGB: (..., 3) uint8."""
    _, table, step = tables
    out = []
    for row in _SRGB_MATRIX:
        lum = row[0] * x + row[1] * y + row[2] * z
        lum = np.where(lum > _SRGB_Y0, lum, _SRGB_Y0)
        lum = np.where(lum < _SRGB_YC, lum, _SRGB_YC)
        i = np.minimum(np.trunc((lum - _SRGB_Y0) / step).astype(np.int64), _RANGE)
        v = table[i].astype(np.float64)
        rint = np.where(v > 0, v + 0.5, v - 0.5).astype(np.int64)
        out.append(np.minimum(rint, _SRGB_VRW))
    return np.stack(out, axis=-1).astype(np.uint8)


def cielab_to_rgb(l: np.ndarray, a: np.ndarray, b: np.ndarray, bits: int, tables) -> np.ndarray:
    """putcontig8bitCIELab8 / putcontig8bitCIELab16: unsigned L, signed
    a and b samples -> (..., 3) uint8 RGB.  8-bit samples go through
    TIFFCIELabToXYZ, which scales them to 16 bits (L * 257, a and b *
    256)."""
    l = l.astype(np.int64)
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    if bits == 8:
        l, a, b = l * 257, a * 256, b * 256
    x, y, z = cielab16_to_xyz(l, a, b, tables[0])
    return xyz_to_rgb(x, y, z, tables)
