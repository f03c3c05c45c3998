"""Baseline geometry helpers (from pero_ocr_tpu/core/line_geometry.py)."""

from __future__ import annotations

import numpy as np


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
