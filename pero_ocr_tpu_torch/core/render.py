"""Debug rendering of a page layout into an image, the port of
pero_ocr_tpu/core/render.py: :func:`render_layout` and
:func:`draw_polyline` draw, bit for bit, what ``cv2.polylines`` and
``cv2.circle`` of OpenCV 5.0.0 draw (``LINE_8``), in numpy.

The copies follow ``modules/imgproc/src/drawing.cpp``:

- ``cv2.polylines`` (:func:`polylines`): ``PolyLine`` runs ``ThickLine``
  over each segment.  At a thickness t over 1 a segment is first cut to
  the raster grown by t pixels on each side (``clipLine``, measured:
  OpenCV 5 draws what is left), then it is a quad, the ends pushed out
  by the rounded normal, filled by ``FillConvexPoly`` in
  ``XY_SHIFT`` = 16 fixed point (its outline drawn first by ``Line2``,
  then the scan of its two edge chains, each edge's x stepped by a
  rounded slope), with a filled ``Circle`` of radius
  ``(thickness + 1) // 2`` at the first segment's start (open
  polylines) and at every segment's end.  At thickness 1 a segment is
  ``cv2.line``'s 8-connected line (``core/geometry.py``'s copy).
- ``cv2.circle`` (:func:`circle`) at a thickness over 1: ``EllipseEx``:
  ``ellipse2Poly``'s points from drawing.cpp's table of sines (one
  every 30 degrees for radii 3 to 9), rounded to fixed point, then an
  open thick polyline through them.

Each call's pixels are gathered (the vectorized Line2 of every segment,
the fill's spans, the circles' offsets) and a page's calls are put at
once, each over the ones before it, as drawing them in turn would.

``render_order=True`` (the regions' numbers in ``cv2.putText``'s Hershey
font) raises: the glyph table is compiled into OpenCV and not part of
this repository (ROADMAP.md, queue 1, item 15 part c).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from pero_ocr_tpu_torch import IMAGES, not_ported
from pero_ocr_tpu_torch.core.geometry import _clip_lines, _draw_lines

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_DBL_EPSILON = 2.220446049250313e-16


def _sin_table() -> np.ndarray:
    """drawing.cpp's SinTable: sin of 0..450 degrees as 7-decimal float
    literals."""
    return np.array([float(f"{math.sin(math.radians(k)):.7f}") for k in range(451)], np.float32)


SIN_TABLE = _sin_table()


def _c_div(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _c_round(x: float) -> int:
    """cvRound: to the nearest integer, halves to even."""
    return int(round(x))


def _pixel(img: np.ndarray, color) -> np.ndarray:
    return np.asarray(color, np.float64)[:img.shape[2] if img.ndim == 3 else 1].astype(img.dtype)


# ----------------------------------------------------------------------
# drawing.cpp's primitives; points in XY_SHIFT fixed point unless named
def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """clipLine on a w x h raster (the fixed-point size in Line2): the
    clipped ends, or None when nothing is left."""
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return None
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


class _Pixels:
    """The pixels of one call of cv2's, all of one colour: ThickLine's
    quads (FillConvexPoly's outline and scan), filled Circles, circle
    stamps and single pixels, gathered for :class:`_Canvas` (in the
    raster's pixels; what falls off it is dropped, as cv2 clips)."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w
        self.quads = []  # 4 fixed-point (x, y) vertices
        self.dots = []  # (x, y, radius): filled Circles
        self.stamps = []  # (x, y, radius, thickness): whole cv2.circle calls
        self.points = []  # (xs, ys) arrays


class _Canvas:
    """cv2's calls on one image, drawn at once: each call's pixels are a
    group, and where groups overlap the later one's colour stays, as if
    they had been drawn in turn."""

    def __init__(self, img: np.ndarray):
        self.img = img
        self.groups = []  # (colour, _Pixels)

    def group(self, color) -> _Pixels:
        px = _Pixels(*self.img.shape[:2])
        self.groups.append((_pixel(self.img, color), px))
        return px

    def flush(self) -> None:
        h, w = self.img.shape[:2]
        n = len(self.groups)
        cut = np.arange(n + 1)
        quads = [(g, q) for g, (_, px) in enumerate(self.groups) for q in px.quads]
        ex = ey = eg = sx = sy = sg = np.zeros(0, np.int64)
        if quads:
            qg = np.array([g for g, _ in quads], np.int64)
            v = np.array([q for _, q in quads], np.int64).reshape(-1, 4, 2)
            # FillConvexPoly's outline: v3 -> v0, v0 -> v1, v1 -> v2, v2 -> v3
            edges = np.concatenate([np.roll(v, 1, axis=1), v], axis=2).reshape(-1, 4)
            ex, ey, eg = _line2_pixels(w, h, edges, np.repeat(qg, 4))
            g, y, x1, x2 = _scan_quads(w, h, v, qg)
            widths = x2 - x1 + 1
            start = np.repeat(np.cumsum(widths) - widths, widths)
            sx = np.repeat(x1, widths) + np.arange(int(widths.sum())) - start
            sy, sg = np.repeat(y, widths), np.repeat(g, widths)
        e_cut = np.searchsorted(eg, cut)  # pixels come in group order
        s_cut = np.searchsorted(sg, cut)
        flat_img = self.img.reshape(h * w, -1)
        for g, (color, px) in enumerate(self.groups):
            xs = [ex[e_cut[g]:e_cut[g + 1]], sx[s_cut[g]:s_cut[g + 1]]]
            ys = [ey[e_cut[g]:e_cut[g + 1]], sy[s_cut[g]:s_cut[g + 1]]]
            for x, y, radius in px.dots:
                dy, dx = _circle_offsets(radius)
                xs.append(dx + x)
                ys.append(dy + y)
            for x, y, radius, thickness in px.stamps:
                dy, dx, _ = _stamp(radius, thickness)
                xs.append(dx + x)
                ys.append(dy + y)
            for x, y in px.points:
                xs.append(x)
                ys.append(y)
            x, y = np.concatenate(xs), np.concatenate(ys)
            keep = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            flat_img[y[keep] * w + x[keep]] = color
        self.groups = []


def _line2_pixels(w: int, h: int, seg: np.ndarray, group: np.ndarray):
    """Line2 of (n, 4) fixed-point segments (x1, y1, x2, y2) on a w x h
    raster, all at once: each clipped by clipLine, then stepped one
    pixel along its major axis from the end it walks from, and its far
    end.  Returns (xs, ys, each pixel's segment's ``group``), segment by
    segment, not yet cut to the raster."""
    a, b, visible = _clip_lines(seg[:, :2], seg[:, 2:], w << XY_SHIFT, h << XY_SHIFT)
    x1, y1, x2, y2 = a[visible, 0], a[visible, 1], b[visible, 0], b[visible, 1]
    group = group[visible]
    ax, ay = np.abs(x2 - x1), np.abs(y2 - y1)
    major_x = ax > ay
    swap = np.where(major_x, x2 < x1, y2 < y1)  # walk left to right, or top to bottom
    x1, x2 = np.where(swap, x2, x1), np.where(swap, x1, x2)
    y1, y2 = np.where(swap, y2, y1), np.where(swap, y1, y2)
    minor = np.where(major_x, y2 - y1, x2 - x1) << XY_SHIFT
    den = np.where(major_x, ax, ay) | 1
    step = np.where(minor >= 0, minor // den, -((-minor) // den))  # C's division
    count = np.where(major_x, x2 - x1, y2 - y1) >> XY_SHIFT
    half = XY_ONE >> 1
    n = count + 2  # the steps 0..count, then the far end
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    end = k == np.repeat(count + 1, n)
    x1, y1 = np.repeat(x1 + half, n), np.repeat(y1 + half, n)
    x2, y2 = np.repeat((x2 + half) >> XY_SHIFT, n), np.repeat((y2 + half) >> XY_SHIFT, n)
    step, major = np.repeat(step, n), np.repeat(major_x, n)
    xs = np.where(major, (x1 >> XY_SHIFT) + k, (x1 + k * step) >> XY_SHIFT)
    ys = np.where(major, (y1 + k * step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k)
    return np.where(end, x2, xs), np.where(end, y2, ys), np.repeat(group, n)


_CIRCLES = {}  # radius -> a filled Circle's pixel offsets


def _circle_offsets(radius: int):
    """Circle with fill: its midpoint walk's spans as (dy, dx) offsets
    from the centre.  On the raster's edge cv2 cuts each span to it,
    which is the same as dropping the offsets that fall off."""
    if radius not in _CIRCLES:
        rows = []
        err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
        while dx >= dy:
            rows += [(-dy, dx), (dy, dx), (-dx, dy), (dx, dy)]  # (row, half width)
            dy += 1
            err += plus
            plus += 2
            mask = -1 if err > 0 else 0  # (err <= 0) - 1
            err -= minus & mask
            dx += mask
            minus -= mask & 2
        cells = {(r, c) for r, half_w in rows for c in range(-half_w, half_w + 1)}
        ys, xs = np.array(sorted(cells), np.int64).reshape(-1, 2).T
        _CIRCLES[radius] = (ys, xs)
    return _CIRCLES[radius]


def _scan_quads(w: int, h: int, v: np.ndarray, group: np.ndarray):
    """FillConvexPoly's scan (LINE_8) of (K, 4, 2) fixed-point quads at
    once: from each quad's top vertex down its two edge chains (indexes
    +1 and -1), a chain moving to its next edge at the row its edge ends
    (the edge's x restarting at its upper vertex, its step
    ``((xe - xs) * 2 + rows) // (2 * rows)`` in C's division), the
    two chains sharing a budget of 4 vertices, whose exhaustion ends the
    scan before it draws that row; rows between the edge changes step
    each x by its dx.  Returns the spans on the raster, (group, y, x1,
    x2), in group order."""
    k = len(v)
    lane = np.arange(k)
    xv, yv = v[:, :, 0], v[:, :, 1]
    half = XY_ONE >> 1
    ty = (yv + half) >> XY_SHIFT
    imin = np.argmin(yv, axis=1)  # the first of equal minima, as cv2 takes it
    y = ty[lane, imin]
    ymax = (yv.max(1) + half) >> XY_SHIFT
    alive = ~(((xv.max(1) + half) >> XY_SHIFT < 0) | (ymax < 0)
              | ((xv.min(1) + half) >> XY_SHIFT >= w) | (y >= h))
    ymax = np.minimum(ymax, h - 1)
    idx = np.stack([imin, imin], 1)
    x = np.full((k, 2), -XY_ONE, np.int64)
    dx = np.zeros((k, 2), np.int64)
    ye = np.stack([y, y], 1)
    budget = np.full(k, 4, np.int64)
    spans = []
    while alive.any():
        for c, di in ((0, 1), (1, 3)):
            searching = alive & (y >= ye[:, c])
            idx0 = idx[:, c].copy()
            cur = (idx0 + di) % 4
            for _ in range(5):  # at most 4 vertices, then the failed test
                if not searching.any():
                    break
                more = budget > 0
                budget = np.where(searching, budget - 1, budget)  # edges-- either way
                searching &= more
                t = ty[lane, cur]
                hit = searching & (t > y)
                rows = np.maximum(t - y, 1)
                num = (xv[lane, cur] - xv[lane, idx0]) * 2 + (t - y)
                step = np.where(num >= 0, num // (2 * rows), -((-num) // (2 * rows)))
                ye[hit, c], dx[hit, c], x[hit, c] = t[hit], step[hit], xv[lane, idx0][hit]
                idx[hit, c] = cur[hit]
                searching &= ~hit
                idx0 = np.where(searching, cur, idx0)
                cur = np.where(searching, (cur + di) % 4, cur)
        alive &= budget >= 0
        stop = np.where(alive, np.minimum(np.minimum(ye[:, 0], ye[:, 1]), ymax + 1), y)
        first = np.maximum(y, 0)  # rows above the raster draw nothing
        count = np.maximum(stop - first, 0)
        if count.any():
            at = np.repeat(lane, count)
            r = np.repeat(first, count) + np.arange(int(count.sum())) - np.repeat(
                np.cumsum(count) - count, count)
            off = r - y[at]
            xa = x[at, 0] + off * dx[at, 0]
            xb = x[at, 1] + off * dx[at, 1]
            x1 = (np.minimum(xa, xb) + half) >> XY_SHIFT
            x2 = (np.maximum(xa, xb) + half) >> XY_SHIFT
            keep = (x2 >= 0) & (x1 < w)
            spans.append((group[at][keep], r[keep], np.maximum(x1[keep], 0),
                          np.minimum(x2[keep], w - 1)))
        x += (stop - y)[:, None] * dx
        y = stop
        alive &= y <= ymax
    if not spans:
        return (np.zeros(0, np.int64),) * 4
    g, r, x1, x2 = (np.concatenate(part) for part in zip(*spans))
    order = np.argsort(g, kind="stable")
    return g[order], r[order], x1[order], x2[order]


def _thick_line(px: _Pixels, p0, p1, thickness: int, flags: int) -> None:
    """ThickLine (LINE_8) of fixed-point ends at a thickness over 1:
    the quad, and a filled circle at p0 (``flags`` bit 0) and at p1
    (bit 1)."""
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > _DBL_EPSILON:
        r = (thick + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _c_round(dy * r), _c_round(dx * r)
        px.quads.append((p0[0] + dpx, p0[1] + dpy, p0[0] - dpx, p0[1] - dpy,
                         p1[0] - dpx, p1[1] - dpy, p1[0] + dpx, p1[1] + dpy))
    half = XY_ONE >> 1
    for i in range(2):
        if flags & (i + 1):
            px.dots.append(((p0[0] + half) >> XY_SHIFT, (p0[1] + half) >> XY_SHIFT,
                            (thick + half) >> XY_SHIFT))
        p0 = p1


def _poly_line(px: _Pixels, v, closed: bool, thickness: int, shift: int) -> None:
    """PolyLine: ThickLine over each segment (points at ``shift`` bits
    of fraction); an open polyline's first segment also puts a circle at
    its start."""
    count = len(v)
    if count <= 0:
        return
    h, w = px.h, px.w
    if thickness <= 1:  # cv2.line's 8-connected segments (shift 0 only here)
        ends = np.array([v[count - 1 if closed else 0]] + list(v), np.int64)
        starts, stops = ends[int(not closed):-1], ends[1 + int(not closed):]
        mask = np.zeros((h, w), np.uint8)
        _draw_lines(mask, starts, stops)
        ys, xs = np.nonzero(mask)
        px.points.append((xs, ys))
        return
    up = XY_SHIFT - shift
    flags = 2 + (not closed)
    p0 = v[count - 1 if closed else 0]
    t = thickness
    for i in range(int(not closed), count):
        a, b = p0, v[i]
        p0 = v[i]
        if shift == 0:
            # OpenCV 5 first clips a pixel segment to the raster grown by
            # the thickness on each side (clipLine of that Rect), and
            # draws what is left (measured: thicknesses 2 to 8).
            clipped = _clip_line(w + 2 * t, h + 2 * t, a[0] + t, a[1] + t, b[0] + t, b[1] + t)
            if clipped is None:
                flags = 2
                continue
            a, b = (clipped[0] - t, clipped[1] - t), (clipped[2] - t, clipped[3] - t)
        _thick_line(px, (a[0] << up, a[1] << up), (b[0] << up, b[1] << up), t, flags)
        flags = 2


# ----------------------------------------------------------------------
# The cv2 calls
def polylines(img: np.ndarray, pts: np.ndarray, closed: bool, color, thickness: int = 1) -> None:
    """``cv2.polylines(img, [pts], closed, color, thickness)`` (LINE_8,
    shift 0) for (N, 2) or (N, 1, 2) integer points, in place."""
    canvas = _Canvas(img)
    _polylines(canvas.group(color), pts, closed, thickness)
    canvas.flush()


def _polylines(px: _Pixels, pts, closed: bool, thickness: int) -> None:
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    _poly_line(px, [(int(x), int(y)) for x, y in pts], closed, thickness, 0)


_STAMPS = {}  # (radius, thickness) -> the circle's pixel offsets from its centre, its reach


def _stamp(radius: int, thickness: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """A circle's pixels relative to its centre, and how far they reach.
    The drawing of a circle centred on a pixel is the same wherever it
    lies, so long as nothing is clipped: every step is integer or exact
    double arithmetic on whole-pixel offsets of its fixed-point points."""
    key = (radius, thickness)
    if key not in _STAMPS:
        reach = radius + thickness + 2
        size = 2 * reach + 1
        px = _Pixels(size, size)
        _circle(px, (reach, reach), radius, thickness)
        canvas = np.zeros((size, size, 1), np.uint8)
        drawing = _Canvas(canvas)
        drawing.groups.append((np.ones(1, np.uint8), px))
        drawing.flush()
        dy, dx = np.nonzero(canvas[:, :, 0])
        _STAMPS[key] = (dy - reach, dx - reach, reach)
    return _STAMPS[key]


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> None:
    """``cv2.circle(img, center, radius, color, thickness)`` (LINE_8) for
    a thickness over 1, in place: EllipseEx's polygon as a thick open
    polyline; away from the raster's edges, its stamp."""
    canvas = _Canvas(img)
    _circle_call(canvas.group(color), center, radius, thickness)
    canvas.flush()


def _circle_call(px: _Pixels, center, radius: int, thickness: int) -> None:
    if thickness <= 1:
        raise ValueError("circle: only thicknesses over 1 (render_layout's 4) are copied")
    cx, cy = int(center[0]), int(center[1])
    reach = _stamp(int(radius), thickness)[2]
    if reach <= cx < px.w - reach and reach <= cy < px.h - reach:
        px.stamps.append((cx, cy, int(radius), thickness))
    else:
        _circle(px, (cx, cy), radius, thickness)


def _circle(px: _Pixels, center, radius: int, thickness: int) -> None:
    cx, cy, r = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT, int(radius) << XY_SHIFT
    size = (r + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if size < 3 else 30 if size < 10 else 18 if size < 15 else 5
    # ellipse2Poly at angle 0 over 0..360: cos = SinTable[450], sin = SinTable[0]
    alpha, beta = float(SIN_TABLE[450]), float(SIN_TABLE[0])
    points = []
    for angle in range(0, 360 + delta, delta):
        angle = min(angle, 360)
        x = float(r) * float(SIN_TABLE[450 - angle])
        y = float(r) * float(SIN_TABLE[angle])
        points.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    v = []
    for qx_f, qy_f in points:
        qx = _c_round(qx_f / XY_ONE) << XY_SHIFT
        qy = _c_round(qy_f / XY_ONE) << XY_SHIFT
        qx += _c_round(qx_f - qx)
        qy += _c_round(qy_f - qy)
        if not v or v[-1] != (qx, qy):
            v.append((qx, qy))
    if len(v) == 1:
        v = [(cx, cy), (cx, cy)]
    _poly_line(px, v, False, thickness, XY_SHIFT)


# ----------------------------------------------------------------------
# The JAX module's functions
def draw_polyline(image: np.ndarray, points: np.ndarray, color: Tuple[int, int, int],
                  close: bool = False, thickness: int = 2,
                  endpoint_circles: bool = False) -> None:
    """The points rounded half to even, drawn as a polyline when there
    are two or more, and with ``endpoint_circles`` a circle of radius 3,
    thickness 4 at the first and the last."""
    canvas = _Canvas(image)
    _draw_polyline(canvas, points, color, close, thickness, endpoint_circles)
    canvas.flush()


def _draw_polyline(canvas: _Canvas, points, color, close: bool, thickness: int,
                   endpoint_circles: bool) -> None:
    pts = np.round(np.asarray(points)).astype(np.int32).reshape(-1, 2)
    if len(pts) >= 2:
        _polylines(canvas.group(color), pts, close, thickness)
    if endpoint_circles and len(pts):
        _circle_call(canvas.group(color), pts[0], 3, 4)
        _circle_call(canvas.group(color), pts[-1], 3, 4)


def render_layout(layout, image: np.ndarray, thickness: int = 2, circles: bool = True,
                  render_order: bool = False) -> np.ndarray:
    """Each line's baseline (red, with end circles) and polygon (green,
    closed), then its region's polygon (blue, closed, with end circles),
    drawn into ``image`` in place, as the JAX function draws them one
    after another; returns it."""
    if render_order:
        raise not_ported("render_order (the regions' numbers in cv2.putText's Hershey font, "
                         "whose glyph table is compiled into OpenCV)", IMAGES)
    canvas = _Canvas(image)
    for region in layout.regions:
        for line in region.lines:
            if line.baseline is not None:
                _draw_polyline(canvas, line.baseline, (0, 0, 255), False, thickness, circles)
            if line.polygon is not None:
                _draw_polyline(canvas, line.polygon, (0, 255, 0), True, thickness, False)
        if region.polygon is not None:
            _draw_polyline(canvas, region.polygon, (255, 0, 0), True, thickness, circles)
    canvas.flush()
    return image
