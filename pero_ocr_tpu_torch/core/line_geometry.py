"""Baseline geometry helpers (from pero_ocr_tpu/core/line_geometry.py)."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from pero_ocr_tpu_torch.core import geometry


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
