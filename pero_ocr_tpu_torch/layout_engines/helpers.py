"""Layout geometry helpers (from pero_ocr_tpu/layout_engines/helpers.py):
textline outlines from baselines and region outlines from textlines."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from pero_ocr_tpu_torch.core import geometry


def baseline_to_textline(baseline: np.ndarray, heights) -> np.ndarray:
    """Offset the baseline along segment normals into a closed outline."""
    heights = np.asarray([max(1.0, heights[0]), max(1.0, heights[1])], dtype=np.float32)
    baseline = np.asarray(baseline, dtype=np.float32)

    dx = np.diff(baseline[:, 0])
    dx = np.concatenate([dx, dx[-1:]])
    dy = np.diff(baseline[:, 1])
    dy = np.concatenate([dy, dy[-1:]])

    normals = np.pi / 2 + np.arctan2(dy, dx)
    up = baseline - np.stack([np.cos(normals), np.sin(normals)], axis=1) * heights[0]
    down = baseline + np.stack([np.cos(normals), np.sin(normals)], axis=1) * heights[1]
    return np.concatenate([up, down[::-1]], axis=0)


def baselines_to_textlines(baseline_list, heights_list) -> List[np.ndarray]:
    """Batched :func:`baseline_to_textline`: one vectorized pass per
    distinct vertex count.  Identical outputs."""
    out: List[Optional[np.ndarray]] = [None] * len(baseline_list)
    by_len = {}
    for i, b in enumerate(baseline_list):
        by_len.setdefault(len(b), []).append(i)
    for npts, idxs in by_len.items():
        bl = np.asarray([np.asarray(baseline_list[i], np.float32) for i in idxs])  # (K, P, 2)
        hh = np.asarray(
            [[max(1.0, heights_list[i][0]), max(1.0, heights_list[i][1])] for i in idxs],
            np.float32,
        )                                             # (K, 2)
        if npts < 2:
            for i in idxs:
                out[i] = baseline_to_textline(baseline_list[i], heights_list[i])
            continue
        d = np.diff(bl, axis=1)                       # (K, P-1, 2)
        d = np.concatenate([d, d[:, -1:]], axis=1)    # (K, P, 2)
        normals = np.pi / 2 + np.arctan2(d[..., 1], d[..., 0])
        nvec = np.stack([np.cos(normals), np.sin(normals)], axis=-1)
        up = bl - nvec * hh[:, None, 0:1]
        down = bl + nvec * hh[:, None, 1:2]
        polys = np.concatenate([up, down[:, ::-1]], axis=1)
        for k, i in enumerate(idxs):
            out[i] = polys[k]
    return out


def region_from_textlines(region_textlines) -> np.ndarray:
    """Alpha-shape outline around the union of textline outlines.
    Returns a polygon array."""
    points = np.concatenate(region_textlines, axis=0)
    # Max segment length across all outlines in one pass: a diff over
    # the concatenated cloud, with the seams between consecutive
    # outlines masked out.
    if len(points) > 1:
        d = np.diff(points.astype(np.float64, copy=False), axis=0)
        seg2 = (d * d).sum(axis=1)
        seam = np.cumsum([len(t) for t in region_textlines[:-1]], dtype=np.int64) - 1
        seg2[seam] = 0.0
        max_spacing = float(np.sqrt(seg2.max())) if seg2.size else 1.0
        if max_spacing <= 0.0:
            max_spacing = 1.0
    else:
        max_spacing = 1.0

    # alpha_shape keeps triangles with circumradius < 1/alpha.
    poly, covers_all = geometry.alpha_shape_info(points, alpha=1.0 / max(max_spacing, 1e-6))
    if covers_all:
        # Single-ring union with every input point a kept-triangle
        # vertex: containment holds by construction.
        return poly

    # Ensure every textline is inside; union in the stragglers.  Boundary
    # contact counts as inside (the alpha shape's boundary passes
    # THROUGH input points).
    missing = []
    inside = geometry.points_in_polygon(points, poly)
    if not inside.all():
        exterior = ~inside
        exterior[exterior] = geometry.points_to_polygon_dist(points[exterior], poly) > 1e-6
        if exterior.any():
            off = 0
            for textline in region_textlines:
                t = np.asarray(textline, dtype=np.float64)
                if exterior[off: off + len(t)].any():
                    missing.append(t)
                off += len(t)
    if missing:
        all_pts = np.concatenate([poly] + missing, axis=0)
        poly = geometry.convex_hull(all_pts)
    return poly
