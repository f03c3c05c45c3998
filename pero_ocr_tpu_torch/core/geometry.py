"""Host-side 2D polygon geometry (from pero_ocr_tpu/core/geometry.py).

The subset the port's two paths use: areas and point tests, the batched
boundary distance of paragraph clustering, alpha-shape outlines, the
Douglas-Peucker simplification and convex hull of region outlines, and
for the stage-by-stage layout the raster intersections of polygons and
the clipping of baselines to regions.

The JAX package runs the last three through OpenCV (``approxPolyDP``,
``convexHull``, ``fillPoly`` + ``findContours``).  This module has no
cv2: each of those calls is a numpy/Python copy of OpenCV's algorithm
with its arithmetic types, start vertex and point order, because the
points go into the Page XML as they come out.

All polygons are (N, 2) float arrays of x,y coordinates.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def polygon_area(polygon: np.ndarray) -> float:
    """Signed shoelace area (positive for counter-clockwise in y-down coords)."""
    p = np.asarray(polygon, dtype=np.float64)
    if len(p) < 3:
        return 0.0
    x, y = p[:, 0], p[:, 1]
    return 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def points_in_polygon(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Vectorized ray-casting test for many points; returns bool (N,)."""
    pts = np.asarray(points, dtype=np.float64)
    p = np.asarray(polygon, dtype=np.float64)
    x0, y0 = p[:, 0], p[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    x = pts[:, 0:1]
    y = pts[:, 1:2]
    crosses = (y0[None, :] > y) != (y1[None, :] > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_int = x0[None, :] + (y - y0[None, :]) / (y1[None, :] - y0[None, :]) * (
            x1[None, :] - x0[None, :]
        )
    hits = crosses & (x < x_int)
    return (np.count_nonzero(hits, axis=1) % 2).astype(bool)


def points_to_polygon_dist(points: np.ndarray, polygon: np.ndarray) -> np.ndarray:
    """Distance from each point to the polygon BOUNDARY (0 on an edge
    or vertex); vectorized over points x edges.  Returns (N,)."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.size == 0:
        return np.zeros((0,), np.float64)
    a0 = np.asarray(polygon, dtype=np.float64)
    a1 = np.roll(a0, -1, axis=0)
    d = a1 - a0                                   # (E, 2)
    pr = pts[:, None, :] - a0[None, :, :]         # (N, E, 2)
    denom = np.maximum((d * d).sum(-1), 1e-12)    # (E,)
    t = np.clip((pr * d[None]).sum(-1) / denom[None], 0.0, 1.0)
    closest = a0[None] + t[..., None] * d[None]
    return np.sqrt(((pts[:, None, :] - closest) ** 2).sum(-1)).min(axis=1)


def segment_polygon_intersections(p0, p1, polygon: np.ndarray) -> np.ndarray:
    """All intersection points of segment p0->p1 with the polygon boundary,
    ordered by distance from p0.  Returns (K, 2) array (possibly empty)."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    a0 = np.asarray(polygon, dtype=np.float64)
    a1 = np.roll(a0, -1, axis=0)
    d = p1 - p0  # segment direction
    e = a1 - a0  # edge directions
    denom = d[0] * e[:, 1] - d[1] * e[:, 0]
    diff = a0 - p0
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (diff[:, 0] * e[:, 1] - diff[:, 1] * e[:, 0]) / denom
        u = (diff[:, 0] * d[1] - diff[:, 1] * d[0]) / denom
    valid = (np.abs(denom) > 1e-12) & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u < 1.0)
    t = t[valid]
    pts = p0[None, :] + t[:, None] * d[None, :]
    return pts[np.argsort(t)]


def _raster_frame(*polygons: np.ndarray, pad: int = 2):
    """Common integer raster frame covering all polygons."""
    allp = np.concatenate([np.asarray(p, dtype=np.float64) for p in polygons], axis=0)
    x0 = int(np.floor(allp[:, 0].min())) - pad
    y0 = int(np.floor(allp[:, 1].min())) - pad
    x1 = int(np.ceil(allp[:, 0].max())) + pad
    y1 = int(np.ceil(allp[:, 1].max())) + pad
    w = max(x1 - x0, 1)
    h = max(y1 - y0, 1)
    return x0, y0, w, h


def _padded_stack(polys) -> np.ndarray:
    """(n, P, 2) float64: each polygon padded to the longest by repeating
    its last vertex (degenerate segments change no minimum distance)."""
    pmax = max(len(p) for p in polys)
    return np.stack([
        np.pad(np.asarray(p, np.float64), ((0, pmax - len(p)), (0, 0)), mode="edge")
        for p in polys
    ])


def polygon_min_distance_batch(polys, pairs: np.ndarray) -> np.ndarray:
    """Minimum distance between polygon BOUNDARIES for many pairs in one
    vectorized shot.

    ``polys``: list of (Pi, 2) polygons; ``pairs``: (K, 2) int indices.
    Polygons pad to the longest by repeating the last vertex (degenerate
    segments cannot change a minimum distance).  Returns (K,) floats."""
    pairs = np.asarray(pairs)
    if len(pairs) == 0:
        return np.zeros(0)
    stack = _padded_stack(polys)              # (n, P, 2)
    va = stack[pairs[:, 0]]                   # (K, P, 2)
    vb = stack[pairs[:, 1]]
    a0 = va[:, :, None]                       # (K, P, 1, 2)
    a1 = np.roll(va, -1, axis=1)[:, :, None]
    b0 = vb[:, None]                          # (K, 1, P, 2)
    b1 = np.roll(vb, -1, axis=1)[:, None]
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    A = (d1 * d1).sum(-1)
    E = (d2 * d2).sum(-1)
    B = (d1 * d2).sum(-1)
    C = (d1 * r).sum(-1)
    F = (d2 * r).sum(-1)
    denom = A * E - B * B
    s = np.where(
        denom > 1e-12,
        np.clip((B * F - C * E) / np.where(denom > 1e-12, denom, 1.0), 0, 1),
        0.0,
    )
    t = np.clip((B * s + F) / np.where(E > 1e-12, E, 1.0), 0, 1)
    s = np.clip((B * t - C) / np.where(A > 1e-12, A, 1.0), 0, 1)
    p = a0 + s[..., None] * d1
    q = b0 + t[..., None] * d2
    return np.sqrt(((p - q) ** 2).sum(-1)).min(axis=(1, 2))


def polygons_close(polys, pairs: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """Whether each pair's boundary distance is <= its threshold: the
    :func:`polygon_min_distance_batch` test, decided first by two bounds
    of that distance where they suffice.  A bounding-box gap above the
    threshold rejects (no boundary point lies outside its box); a vertex
    pair within the threshold accepts (vertices lie on the boundaries).
    Only the pairs between the bounds pay the segment-pair computation
    (``cluster_ab.py`` times this against the segment formula alone).
    Where a bound decides, the answer is exact, as the JAX package's
    native test is; the single clamped pass of the segment formula can
    overstate a distance.  Returns (K,) bool."""
    pairs = np.asarray(pairs)
    thresholds = np.asarray(thresholds, np.float64)
    close = np.zeros(len(pairs), bool)
    if len(pairs) == 0:
        return close
    lo = np.array([np.asarray(p, np.float64).min(axis=0) for p in polys])
    hi = np.array([np.asarray(p, np.float64).max(axis=0) for p in polys])
    i, j = pairs[:, 0], pairs[:, 1]
    gap = np.maximum(np.maximum(lo[i] - hi[j], lo[j] - hi[i]), 0.0)
    open_ = np.hypot(gap[:, 0], gap[:, 1]) <= thresholds
    if open_.any():
        stack = _padded_stack(polys)
        k = np.nonzero(open_)[0]
        d = stack[i[k]][:, :, None] - stack[j[k]][:, None]      # (K, P, P, 2)
        vertex = np.sqrt((d * d).sum(-1).min(axis=(1, 2))) <= thresholds[k]
        close[k[vertex]] = True
        rest = k[~vertex]
        if len(rest):
            close[rest] = polygon_min_distance_batch(polys, pairs[rest]) <= thresholds[rest]
    return close


# ----------------------------------------------------------------------
# Raster boolean operations (cv2.fillPoly + findContours in the JAX
# package; here _fill_polys and _largest_external_contour below)
# ----------------------------------------------------------------------
def bbox(polygon: np.ndarray) -> Tuple[float, float, float, float]:
    p = np.asarray(polygon)
    return float(p[:, 0].min()), float(p[:, 1].min()), float(p[:, 0].max()), float(p[:, 1].max())


def bboxes_intersect(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether the bounding boxes meet (touching counts)."""
    ax0, ay0, ax1, ay1 = bbox(a)
    bx0, by0, bx1, by1 = bbox(b)
    return not (ax1 < bx0 or bx1 < ax0 or ay1 < by0 or by1 < ay0)


def rasterize_polygon(polygon: np.ndarray, origin: Tuple[int, int],
                      shape: Tuple[int, int], window: bool = False) -> np.ndarray:
    """uint8 mask of the polygon (vertices rounded half to even) in a
    raster of ``shape`` (h, w) whose pixel (0, 0) is page point
    ``origin``: ``cv2.fillPoly`` on that raster, which clips the outline
    and the edges; with ``window`` the polygon as drawn on an unbounded
    raster, cut to this one."""
    mask = np.zeros(shape, dtype=np.uint8)
    pts = np.round(np.asarray(polygon, dtype=np.float64) - np.asarray(origin)[None, :])
    _fill_polys(mask, pts.astype(np.int32)[None], clip=not window)
    return mask


def _rasterize_scaled(polygon, x0, y0, shape, scale):
    """Rasterize with pixel-center sampling at ``scale`` subpixels per
    pixel: raster pixel (i, j) samples page point (j / scale + x0,
    i / scale + y0)."""
    mask = np.zeros(shape, dtype=np.uint8)
    pts = (np.asarray(polygon, dtype=np.float64) - [x0, y0]) * scale - 0.5
    _fill_polys(mask, np.round(pts).astype(np.int32)[None])
    return mask


def polygon_intersection_area(a: np.ndarray, b: np.ndarray, scale: int = 4) -> float:
    """Intersection area of two polygons: the count of ``scale`` x
    ``scale`` subpixel centres inside both; past 64M subpixels the scale
    halves, and past that at scale 1 the bounding boxes' overlap."""
    if not bboxes_intersect(a, b):
        return 0.0
    x0, y0, w, h = _raster_frame(a, b)
    while scale > 1 and (w * h * scale * scale) > 64_000_000:
        scale //= 2
    if w * h * scale * scale > 64_000_000:
        ax0, ay0, ax1, ay1 = bbox(a)
        bx0, by0, bx1, by1 = bbox(b)
        return max(0.0, min(ax1, bx1) - max(ax0, bx0)) * max(0.0, min(ay1, by1) - max(ay0, by0))
    shape = (h * scale, w * scale)
    ma = _rasterize_scaled(a, x0, y0, shape, scale)
    mb = _rasterize_scaled(b, x0, y0, shape, scale)
    return float(np.count_nonzero(ma & mb)) / (scale * scale)


def polygon_intersection(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """The outline of the largest connected piece of the two polygons'
    raster intersection, in page coordinates, or None if they do not
    intersect."""
    if not bboxes_intersect(a, b):
        return None
    # Both rasters hold the intersection inside the overlap of the two
    # bounding boxes: raster only that window (clipping the polygons).
    ax0, ay0, ax1, ay1 = bbox(a)
    bx0, by0, bx1, by1 = bbox(b)
    box = np.array([[max(ax0, bx0), max(ay0, by0)], [min(ax1, bx1), min(ay1, by1)]])
    x0, y0, w, h = _raster_frame(box)
    inter = (rasterize_polygon(a, (x0, y0), (h, w), window=True)
             & rasterize_polygon(b, (x0, y0), (h, w), window=True))
    if not inter.any():
        return None
    ring = _largest_external_contour(inter)
    if ring is None or len(ring) < 3:
        return None
    return ring + np.asarray([x0, y0])[None, :]


# ----------------------------------------------------------------------
# OpenCV's approxPolyDP, closed curves, float32 points
# ----------------------------------------------------------------------
def _approx_poly_dp_closed(pts: np.ndarray, eps: float) -> np.ndarray:
    """``cv2.approxPolyDP(pts, eps, closed=True)`` (OpenCV 5) on (N, 2)
    float32 points: three rounds of a farthest-point search from vertex 0
    pick the split pair, a stack-based split by the distance to each
    chord as a segment follows, then a clean-up pass drops
    near-collinear vertices.  Differences of two float32
    coordinates are float32 (as in OpenCV's ``Point2f`` arithmetic),
    products and sums of them float64.  Returns the kept points."""
    n = len(pts)
    x = pts[:, 0]
    y = pts[:, 1]
    eps2 = float(eps) * float(eps)

    # 1. Approximately the two farthest points of the contour.
    pos = 0
    right_start = 0
    le_eps = False
    for _ in range(3):
        pos = (pos + right_start) % n
        idx = (pos + np.arange(1, n)) % n
        dx = (x[idx] - x[pos]).astype(np.float64)
        dy = (y[idx] - y[pos]).astype(np.float64)
        dist = dx * dx + dy * dy
        max_dist = float(dist.max()) if n > 1 else 0.0
        if max_dist > 0.0:
            right_start = int(np.argmax(dist)) + 1
        le_eps = max_dist <= eps2

    # 2. The stack of (start, end) index slices, walked cyclically.
    kept: List[int] = []
    stack: List[Tuple[int, int]] = []
    if le_eps:
        kept.append(pos)
    else:
        far = (right_start + pos) % n
        stack.append((far, pos))
        stack.append((pos, far))

    # 3. Split until every slice's interior lies within eps of its chord.
    while stack:
        start, end = stack.pop()
        if (start + 1) % n == end:
            kept.append(start)
            continue
        dx = float(x[end] - x[start])
        dy = float(y[end] - y[start])
        count = (end - start - 1) % n
        idx = (start + 1 + np.arange(count)) % n
        # Squared distance to the chord as a SEGMENT: to the nearer end
        # where the projection falls outside it.
        ax = (x[idx] - x[start]).astype(np.float64)
        ay = (y[idx] - y[start]).astype(np.float64)
        bx = (x[idx] - x[end]).astype(np.float64)
        by = (y[idx] - y[end]).astype(np.float64)
        l2 = dx * dx + dy * dy
        dot = ax * dx + ay * dy
        cross = ay * dx - ax * dy
        with np.errstate(divide="ignore", invalid="ignore"):
            dist = np.where(
                dot <= 0.0, ax * ax + ay * ay,
                np.where(dot >= l2, bx * bx + by * by, cross * cross / l2),
            )
        max_dist = float(dist.max())
        if max_dist <= eps2:
            kept.append(start)
        else:
            split = int(idx[int(np.argmax(dist))])
            stack.append((split, end))
            stack.append((start, split))

    # 4. Clean-up in place: drop a vertex that lies (almost) on the
    # segment between its neighbours.
    dst = [pts[i] for i in kept]
    count = len(dst)
    new_count = count
    pos = count - 1
    start_pt = dst[pos]
    pos = 0 if pos + 1 >= count else pos + 1
    wpos = pos
    pt = dst[pos]
    pos = 0 if pos + 1 >= count else pos + 1
    i = 0
    while i < count and new_count > 2:
        end_pt = dst[pos]
        pos = 0 if pos + 1 >= count else pos + 1
        dx = float(end_pt[0] - start_pt[0])
        dy = float(end_pt[1] - start_pt[1])
        dist = abs(float(pt[0] - start_pt[0]) * dy - float(pt[1] - start_pt[1]) * dx)
        inner = (pt[0] - start_pt[0]) * (end_pt[0] - pt[0]) + (
            pt[1] - start_pt[1]
        ) * (end_pt[1] - pt[1])  # float32, as Point2f's products are
        if (dist * dist <= 0.5 * eps2 * (dx * dx + dy * dy) and dx != 0.0
                and dy != 0.0 and inner >= 0):
            new_count -= 1
            dst[wpos] = start_pt = end_pt
            wpos = 0 if wpos + 1 >= count else wpos + 1
            pt = dst[pos]
            pos = 0 if pos + 1 >= count else pos + 1
            i += 2
            continue
        dst[wpos] = start_pt = pt
        wpos = 0 if wpos + 1 >= count else wpos + 1
        pt = end_pt
        i += 1
    return np.asarray(dst[:new_count], dtype=np.float32).reshape(-1, 2)


def simplify_polygon(polygon: np.ndarray, tolerance: float) -> np.ndarray:
    """Douglas-Peucker simplification of a closed outline: the points
    and order of ``cv2.approxPolyDP`` on the float32-rounded vertices."""
    p = np.asarray(polygon, dtype=np.float32).reshape(-1, 2)
    if len(p) < 3:
        return np.asarray(polygon, dtype=np.float64)
    out = _approx_poly_dp_closed(p, tolerance).astype(np.float64)
    return out if len(out) >= 3 else np.asarray(polygon, dtype=np.float64)


# ----------------------------------------------------------------------
# OpenCV's convexHull (Sklansky), float32 points
# ----------------------------------------------------------------------
def _sign(v) -> int:
    return int(v > 0) - int(v < 0)


def _sklansky(px, py, start: int, end: int, nsign: int, sign2: int) -> List[int]:
    """OpenCV's ``Sklansky_<float, double>`` over x-sorted points:
    one monotone chain from ``start`` to ``end``; returns its stack."""
    incr = 1 if end > start else -1
    if start == end or (px[start] == px[end] and py[start] == py[end]):
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury = py[pcur]
        nexty = py[pnext]
        by = np.float32(nexty - cury)
        if _sign(by) != nsign:
            ax = np.float32(px[pcur] - px[pprev])
            bx = np.float32(px[pnext] - px[pcur])
            ay = np.float32(cury - py[pprev])
            convexity = float(ay) * float(bx) - float(ax) * float(by)
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev = pcur
                pcur = pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def _convex_hull_indices(pts: np.ndarray) -> List[int]:
    """Input indices of ``cv2.convexHull(pts)`` (clockwise=False) for
    (N, 2) float32 points, in OpenCV's output order."""
    total = len(pts)
    order = np.lexsort((pts[:, 1], pts[:, 0]))  # by x, then y
    px = pts[order, 0]
    py = pts[order, 1]
    miny_ind = int(np.argmin(py))  # first of the smallest y in sorted order
    maxy_ind = int(np.argmax(py))
    if px[0] == px[-1] and py[0] == py[-1]:
        return [int(order[0])]
    hull: List[int] = []
    # Upper half (clockwise=False swaps the two stacks).
    tr = _sklansky(px, py, 0, maxy_ind, -1, 1)
    tl = _sklansky(px, py, total - 1, maxy_ind, -1, -1)
    hull += [int(order[i]) for i in tl[:-1]]
    hull += [int(order[tr[i]]) for i in range(len(tr) - 1, 0, -1)]
    stop_idx = tr[1] if len(tr) > 2 else (tl[-2] if len(tl) > 2 else -1)
    # Lower half.
    bl = _sklansky(px, py, 0, miny_ind, 1, -1)
    br = _sklansky(px, py, total - 1, miny_ind, 1, 1)
    if stop_idx >= 0:
        if len(bl) > 2:
            check_idx = bl[1]
        elif len(bl) + len(br) > 2:
            check_idx = br[2 - len(bl)]
        else:
            check_idx = -1
        if check_idx == stop_idx or (
            check_idx >= 0 and px[check_idx] == px[stop_idx]
            and py[check_idx] == py[stop_idx]
        ):
            # All points on one line: the lower half mirrors the upper.
            bl = bl[:2]
            br = br[:2]
    hull += [int(order[i]) for i in bl[:-1]]
    hull += [int(order[br[i]]) for i in range(len(br) - 1, 0, -1)]

    # Cyclic shift that makes the indices an ascending or descending
    # sequence where one exists.
    nout = len(hull)
    if nout >= 3:
        min_idx = max_idx = lt = 0
        for i in range(1, nout):
            idx = hull[i]
            lt += hull[i - 1] < idx
            if 1 < lt <= i - 2:
                break
            if idx < hull[min_idx]:
                min_idx = i
            if idx > hull[max_idx]:
                max_idx = i
        mmdist = abs(max_idx - min_idx)
        if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
            ascending = (max_idx + 1) % nout == min_idx
            i0 = min_idx if ascending else max_idx
            if i0 > 0:
                shifted = hull[i0:] + hull[:i0]
                monotone = all(
                    ascending == (shifted[k] < shifted[k + 1]) for k in range(nout - 1)
                )
                if monotone:
                    hull = shifted
    return hull


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Convex hull with ``cv2.convexHull``'s points, orientation and start
    vertex, on the float32-rounded points."""
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 2)
    if len(pts) == 0:
        return np.zeros((0, 2), np.float64)
    return pts[_convex_hull_indices(pts)].astype(np.float64)


# ----------------------------------------------------------------------
# OpenCV's fillPoly + findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)
# ----------------------------------------------------------------------
_XY_SHIFT = 16


def _inside(p0: np.ndarray, p1: np.ndarray, w: int, h: int) -> np.ndarray:
    """Which segments p0[k] -> p1[k] have both ends on a w x h image."""
    return ((p0[:, 0] >= 0) & (p0[:, 0] < w) & (p0[:, 1] >= 0) & (p0[:, 1] < h)
            & (p1[:, 0] >= 0) & (p1[:, 0] < w) & (p1[:, 1] >= 0) & (p1[:, 1] < h))


def _clip_lines(p0: np.ndarray, p1: np.ndarray, w: int, h: int):
    """OpenCV's ``clipLine`` of segments p0[k] -> p1[k] to a w x h image
    (int64 arithmetic, the cut points truncated toward zero from float64,
    p0's end cut first).  Returns the clipped ends and which segments
    are left."""
    x1, y1 = p0[:, 0].astype(np.int64), p0[:, 1].astype(np.int64)
    x2, y2 = p1[:, 0].astype(np.int64), p1[:, 1].astype(np.int64)
    right, bottom = w - 1, h - 1

    def x_code(x):
        return (x < 0).astype(np.int64) + (x > right) * 2

    c1 = x_code(x1) + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = x_code(x2) + (y2 < 0) * 4 + (y2 > bottom) * 8

    def cut(num, den):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.nan_to_num(np.trunc(num.astype(np.float64) * den[0] / den[1])).astype(
                np.int64)

    go = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = go & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = np.where(m, x1 + cut(a - y1, (x2 - x1, y2 - y1)), x1)
    y1 = np.where(m, a, y1)
    c1 = np.where(m, x_code(x1), c1)
    m = go & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = np.where(m, x2 + cut(a - y2, (x2 - x1, y2 - y1)), x2)
    y2 = np.where(m, a, y2)
    c2 = np.where(m, x_code(x2), c2)
    go &= ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = go & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = np.where(m, y1 + cut(a - x1, (y2 - y1, x2 - x1)), y1)
    x1 = np.where(m, a, x1)
    c1 = np.where(m, 0, c1)
    m = go & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = np.where(m, y2 + cut(a - x2, (y2 - y1, x2 - x1)), y2)
    x2 = np.where(m, a, x2)
    c2 = np.where(m, 0, c2)
    return np.stack([x1, y1], 1), np.stack([x2, y2], 1), (c1 | c2) == 0


def _draw_lines(mask: np.ndarray, p0: np.ndarray, p1: np.ndarray, clip: bool = True) -> None:
    """8-connected segments p0[k] -> p1[k] (int coordinates) as
    ``cv2.line``/``LineIterator`` draws them (clipped to the mask, then
    left to right, Bresenham with OpenCV's error term), every point of
    every segment at once; with ``clip`` False as drawn unclipped and
    cut to the mask.  With M major and m minor steps the error starts at
    M - 2m, so after i major steps the line has taken
    ceil((2 m i - M) / (2 M)) minor ones."""
    h, w = mask.shape
    if clip and not _inside(p0, p1, w, h).all():
        p0, p1, visible = _clip_lines(p0, p1, w, h)
        p0, p1 = p0[visible], p1[visible]
    swap = p1[:, 0] < p0[:, 0]
    a = np.where(swap[:, None], p1, p0).astype(np.int64)
    b = np.where(swap[:, None], p0, p1).astype(np.int64)
    dx = b[:, 0] - a[:, 0]
    dy = b[:, 1] - a[:, 1]
    sy = np.where(dy < 0, -1, 1)
    dy = np.abs(dy)
    vert = dy > dx
    major = np.where(vert, dy, dx)
    minor = np.where(vert, dx, dy)
    # Major-axis step and minor-axis step as (x, y) unit moves.
    step_major = np.stack([np.where(vert, 0, 1), np.where(vert, sy, 0)], 1)
    step_minor = np.stack([np.where(vert, 1, 0), np.where(vert, 0, sy)], 1)
    count = major + 1
    seg = np.repeat(np.arange(len(a)), count)
    i = np.arange(int(count.sum())) - np.repeat(np.cumsum(count) - count, count)
    big, small = major[seg], minor[seg]
    taken = -((big - 2 * small * i) // np.maximum(2 * big, 1))
    pts = a[seg] + i[:, None] * step_major[seg] + taken[:, None] * step_minor[seg]
    pts = pts[(pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)]
    mask[pts[:, 1], pts[:, 0]] = 1


def _fill_polys(mask: np.ndarray, polys: np.ndarray, clip: bool = True) -> None:
    """``cv2.fillPoly(mask, list(polys), 1)`` for (K, V, 2) int polygons
    (no shift, 8-connected): every edge is drawn as a line, then the
    scanline fill pairs the edges of ALL polygons by x on each row
    (even-odd over the whole set) and fills between each pair.  An
    edge's x runs in 16-bit fixed point from its upper end; an edge with
    an end off the mask runs from its ends clipped to the mask
    (``clipLine``: their x, and their y unless the clipped segment is
    level), as OpenCV 5 draws it.  With ``clip`` False the polygons are
    drawn as on an unbounded raster and cut to the mask."""
    p0 = np.roll(polys, 1, axis=1).reshape(-1, 2).astype(np.int64)
    p1 = polys.reshape(-1, 2).astype(np.int64)
    _draw_lines(mask, p0, p1, clip)
    sloped = p0[:, 1] != p1[:, 1]
    p0, p1 = p0[sloped], p1[sloped]
    h, w = mask.shape
    off = clip & ~_inside(p0, p1, w, h)
    c0, c1 = p0, p1
    if off.any():
        c0, c1, _ = _clip_lines(p0, p1, w, h)
    # An edge off the mask takes its clipped x, and its clipped y unless
    # the clipped segment is level.
    clipped_y = off & (c0[:, 1] != c1[:, 1])
    e0 = np.stack([np.where(off, c0[:, 0], p0[:, 0]) << _XY_SHIFT,
                   np.where(clipped_y, c0[:, 1], p0[:, 1])], 1)
    e1 = np.stack([np.where(off, c1[:, 0], p1[:, 0]) << _XY_SHIFT,
                   np.where(clipped_y, c1[:, 1], p1[:, 1])], 1)
    num = e1[:, 0] - e0[:, 0]
    den = e1[:, 1] - e0[:, 1]
    slope = np.abs(num) // np.abs(den) * np.sign(num) * np.sign(den)  # C division
    down = p0[:, 1] < p1[:, 1]
    ya = np.where(down, p0[:, 1], p1[:, 1])
    yb = np.where(down, p1[:, 1], p0[:, 1])
    xa = np.where(down, e0[:, 0] + (p0[:, 1] - e0[:, 1]) * slope,
                  e1[:, 0] + (p1[:, 1] - e1[:, 1]) * slope)
    rows = yb - ya
    if rows.sum() == 0:
        return
    edge = np.repeat(np.arange(len(ya)), rows)
    k = np.arange(len(edge)) - np.repeat(np.cumsum(rows) - rows, rows)
    ys = ya[edge] + k
    xs = xa[edge] + k * slope[edge]
    order = np.lexsort((xs, ys))
    ys, xs = ys[order], xs[order]
    # Pair consecutive crossings within each row.
    y_pairs = ys.reshape(-1, 2)
    x_pairs = xs.reshape(-1, 2)
    x_pairs[:, 0] += (1 << _XY_SHIFT) - 1  # the left end rounds up
    x_pairs >>= _XY_SHIFT
    if not np.array_equal(y_pairs[:, 0], y_pairs[:, 1]):
        raise ValueError("fillPoly: an odd number of edge crossings on a row")
    # Spans clipped to the mask, as cv2.fillPoly clips.
    y, xl, xr = y_pairs[:, 0], np.maximum(x_pairs[:, 0], 0), x_pairs[:, 1]
    keep = (y >= 0) & (y < mask.shape[0]) & (xl <= xr)
    for y, xl, xr in zip(y[keep].tolist(), xl[keep].tolist(), xr[keep].tolist()):
        mask[y, xl: xr + 1] = 1


# Chain-code moves (x, y) of OpenCV's contour tracer, counter-clockwise
# from "right" in image coordinates.
_CODE_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


# Pixel values of the border follower's working image: unmarked ink,
# ink on a traced border, and ink on a traced border whose right
# neighbour (background) the trace examined (OpenCV's ``nbd`` and
# ``nbd | -128``).
_INK, _MARKED, _RIGHT_BOUND = 1, 2, 3


def _trace_border(buf, width: int, x0: int, y0: int, hole: bool = False) -> np.ndarray:
    """OpenCV's border following (``icvFetchContour`` with
    CHAIN_APPROX_SIMPLE) of the border that starts at pixel (x0, y0): an
    outer border at its first pixel, a hole border at the ink pixel left
    of the hole.  ``buf`` is the working image (zero on its frame),
    ``bytes`` to only trace or a ``bytearray`` to also mark the border
    as Suzuki's algorithm does.  Returns the chain's corner pixels,
    first the start pixel."""
    marks = isinstance(buf, bytearray)
    deltas = [dx + dy * width for dx, dy in _CODE_DELTAS] * 2
    i0 = x0 + y0 * width
    s = s_end = 0 if hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if buf[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a lone pixel
        if marks:
            buf[i0] = _RIGHT_BOUND
        return np.asarray([[x0, y0]], np.float64)
    out = []
    px, py = x0, y0
    i3 = i0
    prev_s = s ^ 4
    while True:
        s_end = s
        i4 = i3
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if buf[i4] != 0:
                break
        s &= 7
        if marks:
            if 0 < s <= s_end:
                buf[i3] = _RIGHT_BOUND
            elif buf[i3] == _INK:
                buf[i3] = _MARKED
        if s != prev_s:
            out.append((px, py))
            prev_s = s
        px += _CODE_DELTAS[s][0]
        py += _CODE_DELTAS[s][1]
        if i4 == i0 and i3 == i1:
            break
        i3 = i4
        s = (s + 4) & 7
    return np.asarray(out, np.float64)


def find_contours_tree(mask: np.ndarray) -> List[np.ndarray]:
    """The contours of ``cv2.findContours(mask, RETR_TREE,
    CHAIN_APPROX_SIMPLE)`` in cv2's order, every outer and every hole
    border of the mask's nonzero pixels, as (P, 2) float arrays of pixel
    (x, y).  Suzuki's raster scan finds them (a row scanned left to
    right; an outer border starts at an unmarked ink pixel after
    background, a hole border at the ink pixel before background unless
    a traced border marked that pixel as its right bound); cv2 5 lists
    them by a depth-first walk of their nesting tree, each node's
    children latest found first.  An outer border's parent is the hole
    its component lies in (the background left of its start pixel), a
    hole border's the outer border of the component around it (its
    start pixel's)."""
    from scipy import ndimage

    mask = np.asarray(mask)
    h, w = mask.shape
    work = np.zeros((h + 2, w + 2), np.uint8)  # cv2 pads the image by one pixel
    work[1:-1, 1:-1] = mask != 0
    ink = work != 0
    components, _ = ndimage.label(ink, structure=np.ones((3, 3), int))
    background, _ = ndimage.label(~ink)  # 4-connected
    width = w + 2
    rows, cols = np.nonzero(ink[:, 1:] != ink[:, :-1])
    buf = bytearray(work.tobytes())
    found = []  # (ring, its region's label, the surrounding region's label, hole)
    for y, x in zip(rows.tolist(), (cols + 1).tolist()):
        i = y * width + x
        prev, p = buf[i - 1], buf[i]
        if prev == 0 and p == _INK:
            found.append((_trace_border(buf, width, x, y), components[y, x],
                          background[y, x - 1], False))
        elif p == 0 and prev in (_INK, _MARKED):
            found.append((_trace_border(buf, width, x - 1, y, hole=True), background[y, x],
                          components[y, x - 1], True))
    outer_of = {own: k for k, (_, own, _, hole) in enumerate(found) if not hole}
    hole_of = {own: k for k, (_, own, _, hole) in enumerate(found) if hole}
    children: dict = {}
    for k, (_, _, around, hole) in enumerate(found):
        parent = outer_of[around] if hole else hole_of.get(around, -1)
        children.setdefault(parent, []).append(k)
    out: List[np.ndarray] = []
    stack = list(children.get(-1, []))
    while stack:
        k = stack.pop()
        out.append(found[k][0] - 1.0)
        stack.extend(children.get(k, []))
    return out


def _largest_external_contour(mask: np.ndarray) -> Optional[np.ndarray]:
    """The contour ``max(cv2.findContours(mask, RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE)[0], key=cv2.contourArea)`` picks: the outer
    border of each 8-connected component, traced from its first pixel
    in raster order; the largest shoelace area wins (later-found first
    on ties, the order findContours lists them in).  Components may touch
    the mask's edge: the set pixels' bounding box is traced inside a zero
    frame, as findContours treats what lies off the image."""
    from scipy import ndimage

    # Work on the set pixels' bounding box with a zero frame: the same
    # components, borders and raster order, fewer pixels to label.
    rows = np.flatnonzero(mask.any(axis=1))
    if rows.size == 0:
        return None
    cols = np.flatnonzero(mask.any(axis=0))
    window = np.zeros((rows[-1] - rows[0] + 3, cols[-1] - cols[0] + 3), np.uint8)
    window[1:-1, 1:-1] = mask[rows[0]: rows[-1] + 1, cols[0]: cols[-1] + 1] != 0
    labels, num = ndimage.label(window, structure=np.ones((3, 3), int))
    ys, xs = np.nonzero(labels)
    _, first = np.unique(labels[ys, xs], return_index=True)
    buf = window.tobytes()
    best, best_area = None, -1.0
    for k in sorted(first.tolist(), reverse=True):
        ring = _trace_border(buf, window.shape[1], int(xs[k]), int(ys[k]))
        area = abs(polygon_area(ring))
        if area > best_area:
            best, best_area = ring, area
    return best + np.asarray([cols[0] - 1, rows[0] - 1], np.float64)


# ----------------------------------------------------------------------
# Alpha shapes
# ----------------------------------------------------------------------
def _triangle_union_boundary_info(
    pts: np.ndarray, tris: np.ndarray
) -> Tuple[Optional[np.ndarray], int]:
    """Exact outer boundary of a union of triangles from one
    triangulation, via a directed-edge walk (no rasterization), plus the
    closed-ring count (outer rings AND holes).

    Orient every triangle CCW; a directed edge whose reverse does not
    occur is a boundary edge, and chaining boundary edges start -> end
    traces each component's outer ring CCW (holes come out CW and lose
    the signed-area comparison).  Returns the largest-area ring, or
    (None, 0) when a vertex is shared by several boundary rings (pinch)
    -- the caller falls back to the raster path for those shapes.
    ``n_rings == 1`` proves the kept union is one simply connected
    component whose outer boundary is the returned ring."""
    a, b, c = pts[tris[:, 0]], pts[tris[:, 1]], pts[tris[:, 2]]
    cross = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
        b[:, 1] - a[:, 1]
    ) * (c[:, 0] - a[:, 0])
    t = tris.copy()
    flip = cross < 0
    t[flip, 1], t[flip, 2] = tris[flip, 2], tris[flip, 1]
    edges = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    n = int(edges.max()) + 1
    code = edges[:, 0].astype(np.int64) * n + edges[:, 1]
    if len(np.unique(code)) != len(code):  # duplicate directed edge
        return None, 0
    rcode = edges[:, 1].astype(np.int64) * n + edges[:, 0]
    on_boundary = ~np.isin(code, rcode)
    boundary = edges[on_boundary]
    if len(boundary) < 3:
        return None, 0
    starts = boundary[:, 0]
    if len(np.unique(starts)) != len(starts):
        return None, 0  # pinch vertex: two rings meet -- raster fallback
    succ = dict(zip(starts.tolist(), boundary[:, 1].tolist()))

    best_poly, best_area, n_rings = None, 0.0, 0
    remaining = dict(succ)
    while remaining:
        u0, v = remaining.popitem()
        loop = [u0]
        u = v
        while u != u0:
            loop.append(u)
            nxt = remaining.pop(u, None)
            if nxt is None:     # open chain: inconsistent input
                return None, 0
            u = nxt
        n_rings += 1
        ring = pts[loop]
        x, y = ring[:, 0], ring[:, 1]
        area = 0.5 * float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
        if area > best_area:
            best_area, best_poly = area, ring
    if best_poly is None or len(best_poly) < 3:
        return None, 0
    return best_poly.astype(np.float64), n_rings


def alpha_shape_info(points: np.ndarray, alpha: float) -> Tuple[np.ndarray, bool]:
    """Concave hull via Delaunay triangulation with circumradius
    filtering (triangles with circumradius < 1/alpha are kept), plus a
    containment proof: the second element is True when the walk closed
    a SINGLE ring and every input point is a vertex of a kept triangle.

    Falls back to the convex hull when filtering disconnects everything;
    pinched unions take the raster path (fill the int-truncated kept
    triangles, keep the largest external contour)."""
    from scipy.spatial import Delaunay

    pts = np.asarray(points, dtype=np.float64)
    if len(pts) < 4:
        return convex_hull(pts), False
    try:
        tri = Delaunay(pts)
    except (RuntimeError, ValueError):  # QhullError on degenerate clouds
        return convex_hull(pts), False

    simplices = tri.simplices
    a = pts[simplices[:, 0]]
    b = pts[simplices[:, 1]]
    c = pts[simplices[:, 2]]
    # circumradius r = la*lb*lc / (4*area) < 1/alpha, in squares:
    # la2*lb2*lc2 < 4*cross^2*t^2; zero-area triangles fail it.
    ab, ac, bc = b - a, c - a, c - b
    la2 = (bc * bc).sum(1)
    lb2 = (ac * ac).sum(1)
    lc2 = (ab * ab).sum(1)
    cross = ab[:, 0] * ac[:, 1] - ab[:, 1] * ac[:, 0]
    t = 1.0 / max(alpha, 1e-9)
    keep = la2 * lb2 * lc2 < 4.0 * (cross * cross) * (t * t)
    if not keep.any():
        return convex_hull(pts), False

    kept = simplices[keep]
    poly, n_rings = _triangle_union_boundary_info(pts, kept)
    if poly is not None:
        covers_all = n_rings == 1 and len(np.unique(kept)) == len(pts)
        return poly, covers_all

    # Union of kept triangles via rasterization; boundary via contours.
    x0, y0, w, h = _raster_frame(pts)
    mask = np.zeros((h, w), dtype=np.uint8)
    tris = (pts[kept] - np.asarray([x0, y0])[None, None, :]).astype(np.int32)
    _fill_polys(mask, tris)
    ring = _largest_external_contour(mask)
    if ring is None or len(ring) < 3:
        return convex_hull(pts), False
    return ring + np.asarray([x0, y0])[None, :], False


def mask_polyline_by_polygon(polyline: np.ndarray, polygon: np.ndarray) -> Optional[np.ndarray]:
    """The part of a polyline inside a polygon: the longest run of
    inside points, with the boundary crossings added at its cut ends.
    None if no point is inside."""
    line = np.asarray(polyline, dtype=np.float64)
    inside = points_in_polygon(line, polygon)
    if not inside.any():
        return None
    if inside.all():
        return line

    # Longest run of inside points (the first of equal length).
    best_start, best_len = 0, 0
    cur_start, cur_len = None, 0
    for i, flag in enumerate(inside):
        if flag:
            if cur_start is None:
                cur_start, cur_len = i, 1
            else:
                cur_len += 1
            if cur_len > best_len:
                best_start, best_len = cur_start, cur_len
        else:
            cur_start, cur_len = None, 0
    seg = line[best_start: best_start + best_len]

    pieces: List[np.ndarray] = []
    if best_start > 0:
        entry = line[best_start]
        cuts = segment_polygon_intersections(line[best_start - 1], entry, polygon)
        # A cut at the inside end itself (on the boundary) is no crossing.
        cuts = cuts[np.hypot(*(cuts - entry[None, :]).T) > 1e-6]
        if len(cuts):
            pieces.append(cuts[-1:])
    pieces.append(seg)
    end = best_start + best_len
    if end < len(line):
        exit_pt = line[end - 1]
        cuts = segment_polygon_intersections(exit_pt, line[end], polygon)
        cuts = cuts[np.hypot(*(cuts - exit_pt[None, :]).T) > 1e-6]
        if len(cuts):
            pieces.append(cuts[:1])
    return np.concatenate(pieces, axis=0)
