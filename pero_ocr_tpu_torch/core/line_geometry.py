"""Baseline geometry helpers (from pero_ocr_tpu/core/line_geometry.py):
the per-line warp field that ``LineCropper`` samples with
:func:`pero_ocr_tpu_torch.ops.warp.warp_fields`, resampling and height
estimation.  Host numpy in float64, as in the JAX package."""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

from pero_ocr_tpu_torch.core import geometry


def chord_rotation(baseline: np.ndarray) -> Tuple[float, np.ndarray]:
    """Angle of the baseline chord and its rotation matrix R such that
    ``points @ inv(R)`` maps into chord-aligned coordinates."""
    coords = np.asarray(baseline, dtype=np.float64)
    alpha = math.atan2(coords[-1, 1] - coords[0, 1], coords[-1, 0] - coords[0, 0])
    rot = np.array([[np.cos(alpha), np.sin(alpha)], [-np.sin(alpha), np.cos(alpha)]])
    return alpha, rot


def fit_baseline(coords: np.ndarray, poly: int = 0):
    """Fit y(x) to chord-aligned baseline points: a least-squares
    polynomial of order ``poly`` (1 for two points), or for ``poly=0`` a
    cubic interpolant through the points (scipy ``interp1d``), with a
    linear fit for degenerate inputs.  Returns a callable y(x)."""
    x = coords[:, 0].astype(np.float64)
    y = coords[:, 1].astype(np.float64)
    if poly:
        order = poly if len(x) > 2 else 1
        return np.poly1d(np.polyfit(x, y, order))
    if len(x) < 3:
        return np.poly1d(np.polyfit(x, y, 1))
    from scipy import interpolate

    # Strictly increasing x is required; nudge duplicates apart.
    x = x.copy()
    x[-1] += 0.1
    if np.any(np.diff(x) <= 0):
        return np.poly1d(np.polyfit(x, y, 1))
    try:
        return interpolate.interp1d(x, y, kind="cubic", fill_value="extrapolate")
    except ValueError:
        return np.poly1d(np.polyfit(x, y, 1))


def warp_field(baseline: np.ndarray, heights: Sequence[float], target_height: int,
               poly: int = 0, scale: float = 1.0) -> np.ndarray:
    """The dense (target_height, W, 2) float32 map of page (x, y)
    coordinates that dewarps a curved line into a height-normalized
    strip: the baseline's integer points rotated to their chord, fitted
    (:func:`fit_baseline`), resampled uniformly in arc length, offset
    along the normals (forward difference, h = 0.1) over
    ``linspace(-asc, desc, target_height)`` and rotated back.  W is the
    arc length times ``target_height / (asc + desc)``."""
    asc = float(heights[0]) * scale
    desc = float(heights[1]) * scale

    coords = np.asarray(baseline, dtype=np.float64).copy().astype(int).astype(np.float64)
    _, rot = chord_rotation(coords)
    coords = coords @ np.linalg.inv(rot)

    interp = fit_baseline(coords, poly=poly)

    left = coords[:, 0].min()
    right = coords[:, 0].max()
    xs = np.arange(left, right)
    if len(xs) < 2:
        xs = np.array([left, left + 1.0])
    ys = np.asarray(interp(xs), dtype=np.float64)

    seg_len = np.hypot(np.diff(xs), np.diff(ys))
    arc = np.concatenate([[0.0], np.cumsum(seg_len)])

    px_scale = target_height / max(asc + desc, 1e-6)
    n_cols = max(int(arc[-1] * px_scale), 1)

    # Uniform arc-length positions -> source x via the inverse arc map.
    t = np.linspace(0, arc[-1], n_cols)
    out_x = np.interp(t, arc, xs)
    out_y = np.asarray(interp(out_x), dtype=np.float64)

    d_x = np.full_like(out_x, 0.1)
    d_y = out_y - np.asarray(interp(out_x + 0.1), dtype=np.float64)
    norm = np.hypot(d_x, d_y)
    norm_x = -d_y / norm
    norm_y = d_x / norm

    vertical = np.linspace(-asc, desc, target_height).reshape(-1, 1)
    map_x = norm_x[None, :] * vertical + out_x[None, :]
    map_y = norm_y[None, :] * vertical + out_y[None, :]

    field = np.stack([map_x, map_y], axis=2) @ rot
    return field.astype(np.float32)


def resample_baseline(baseline: np.ndarray, num_points: int = 10) -> np.ndarray:
    """Resample a baseline polyline to ``num_points`` points uniformly
    spaced in arc length."""
    pts = np.asarray(baseline, dtype=np.float64)
    if len(pts) < 2:
        return pts.copy()
    seg = np.hypot(*np.diff(pts, axis=0).T)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    if arc[-1] <= 0:
        return np.repeat(pts[:1], num_points, axis=0)
    t = np.linspace(0, arc[-1], num_points)
    x = np.interp(t, arc, pts[:, 0])
    y = np.interp(t, arc, pts[:, 1])
    return np.stack([x, y], axis=1)


def guess_heights_from_polygon(
    baseline: np.ndarray,
    polygon: np.ndarray,
    num_probes: int = 10,
) -> Sequence[float]:
    """Estimate [ascender, descender] heights by intersecting baseline
    normals with the line polygon (used on import when heights are absent).

    Probes several points along the baseline; falls back to a 0.8/0.2 split
    of the polygon's vertical extent when probing fails."""
    baseline = np.asarray(baseline, dtype=np.float64)
    polygon = np.asarray(polygon, dtype=np.float64)
    try:
        direction = baseline[-1] - baseline[0]
        length = np.hypot(*direction)
        if length < 1e-9:
            raise ValueError("degenerate baseline")
        normal = np.array([-direction[1], direction[0]]) / length
        span = max(polygon[:, 1].max() - polygon[:, 1].min(), 1.0) * 10.0

        probes = resample_baseline(baseline, num_probes)
        ups, downs = [], []
        for p in probes:
            cuts = geometry.segment_polygon_intersections(
                p - normal * span, p + normal * span, polygon
            )
            if len(cuts) < 2:
                continue
            ys = cuts[:, 1]
            above = cuts[ys < p[1]]
            below = cuts[ys >= p[1]]
            if len(above) == 0 or len(below) == 0:
                continue
            ups.append(np.min(np.hypot(*(above - p[None, :]).T)))
            downs.append(np.min(np.hypot(*(below - p[None, :]).T)))
        if ups:
            return [float(np.mean(ups)), float(np.mean(downs))]
    except (ValueError, IndexError):
        pass
    height = polygon[:, 1].max() - polygon[:, 1].min()
    return [float(height * 0.8), float(height * 0.2)]
