"""Layout geometry helpers (from pero_ocr_tpu/layout_engines/helpers.py):
textline outlines from baselines, region outlines from textlines, the
stage-by-stage layout's clipping of lines into regions and their
top-to-bottom order, the polynomial resampling of baselines that
``ADJUST_HEIGHTS`` samples the heights map at, and what the optional
layout stages use: ``LINE_FILTER``'s position and length tests,
``LAYOUT_POSTPROCESSING``'s region retrace, ``MERGE_LINES``, and the
deskew of ``MERGE_LINES`` and ``LINE_POSTPROCESSING`` (the mean tilt of
the longer lines, and cv2's ``getRotationMatrix2D`` and ``transform`` as
the float64 affine map of :mod:`.smart_sorter`)."""

from __future__ import annotations

import math
import random
from typing import List, Optional

import numpy as np

from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.core.layout import TextLine
from pero_ocr_tpu_torch.layout_engines.smart_sorter import rotation_matrix, transform


def check_line_position(baseline, page_size, margin=20, min_ratio=0.125) -> bool:
    """False for a line that touches a side margin of the page without
    reaching ``min_ratio`` of its width from that side (bleed-through
    from a neighbouring page)."""
    x_coords = np.asarray(baseline)[:, 0]
    if np.any(x_coords < margin) and not np.any(x_coords > page_size[1] * min_ratio):
        return False
    if np.any(x_coords > (page_size[1] - margin)) and not np.any(
            x_coords < page_size[1] * min_ratio):
        return False
    return True


def get_max_line_length(baseline_list):
    """The largest horizontal extent between a baseline's ends (0 for
    none)."""
    if not baseline_list:
        return 0
    x0 = np.asarray([b[0, 0] for b in baseline_list])
    x1 = np.asarray([b[-1, 0] for b in baseline_list])
    return np.abs(x1 - x0).max()


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


def mask_textline_by_region(baseline, textline, region):
    """Clip a line's baseline and outline to a region polygon.  Returns
    (baseline, textline) arrays, or (None, None) when less than 2 px of
    the baseline or none of the outline lies inside."""
    baseline = np.asarray(baseline, dtype=float)
    region = np.asarray(region, dtype=float)
    clipped_baseline = geometry.mask_polyline_by_polygon(baseline, region)
    if clipped_baseline is None or len(clipped_baseline) < 2:
        return None, None
    if np.hypot(*np.diff(clipped_baseline, axis=0).T).sum() <= 2:
        return None, None
    clipped_textline = geometry.polygon_intersection(np.asarray(textline, dtype=float), region)
    if clipped_textline is None:
        return None, None
    return clipped_baseline, clipped_textline


def assign_lines_to_regions(baseline_list, heights_list, textline_list, regions):
    """Clip each line into every region whose bounding box its
    baseline's overlaps, appending it to the region's lines as
    ``{region.id}-l{line index + 1:03d}``."""
    if not baseline_list or not regions:
        return regions
    min_line = np.asarray([np.min(b, axis=0) for b in baseline_list])
    max_line = np.asarray([np.max(b, axis=0) for b in baseline_list])
    min_region = np.asarray([np.min(r.polygon, axis=0) for r in regions])
    max_region = np.asarray([np.max(r.polygon, axis=0) for r in regions])
    disjoint = np.logical_and(
        np.logical_or(max_line[:, None, 1] <= min_region[None, :, 1],
                      min_line[:, None, 1] >= max_region[None, :, 1]),
        np.logical_or(max_line[:, None, 0] <= min_region[None, :, 0],
                      min_line[:, None, 0] >= max_region[None, :, 0]),
    )
    for line_id, region_id in zip(*np.logical_not(disjoint).nonzero()):
        region = regions[region_id]
        baseline_clip, textline_clip = mask_textline_by_region(
            baseline_list[line_id], textline_list[line_id], region.polygon
        )
        if baseline_clip is not None and textline_clip is not None:
            region.lines.append(TextLine(
                id=f"{region.id}-l{line_id + 1:03d}", baseline=baseline_clip,
                polygon=textline_clip, heights=heights_list[line_id],
            ))
    return regions


def order_lines_vertical(baselines, heights, textlines):
    """Sort lines top to bottom by their first point's y, each jittered
    by one draw of Python's global ``random.uniform(0.001, 0.999)`` in
    line order (so a seeded ``random`` orders equal rows alike)."""
    order = [b[0][1] + random.uniform(0.001, 0.999) for b in baselines]
    idx = sorted(range(len(order)), key=lambda i: order[i])
    return ([baselines[i] for i in idx], [heights[i] for i in idx],
            [textlines[i] for i in idx])


def resample_baselines(baselines, num_points: int = 10):
    """Each baseline fitted with a polynomial (degree 1 for two points,
    else 2) and sampled at ``num_points`` evenly spaced x between its
    ends; a baseline that runs more vertically than horizontally is fit
    with x and y swapped."""
    out = []
    for baseline in baselines:
        baseline = np.asarray(baseline, dtype=float)
        vertical = abs(baseline[0, 0] - baseline[-1, 0]) < abs(baseline[0, 1] - baseline[-1, 1])
        if vertical:
            baseline = baseline[:, ::-1]
        order = 1 if baseline.shape[0] == 2 else 2
        fit = np.poly1d(np.polyfit(baseline[:, 0], baseline[:, 1], order))
        xs = np.linspace(baseline[0, 0], baseline[-1, 0], num_points)
        resampled = np.stack([xs, fit(xs)], axis=-1)
        if vertical:
            resampled = resampled[:, ::-1]
        out.append(resampled)
    return out


def retrace_region(region) -> None:
    """The region's outline rebuilt from its lines' outlines (the alpha
    shape, simplified by 5 px); a region without lines keeps its own."""
    textlines = [line.polygon for line in region.lines]
    if not textlines:
        return
    region.polygon = geometry.simplify_polygon(region_from_textlines(textlines), 5)


def get_rotation(lines) -> float:
    """The mean tilt in degrees of the longer half of the lines (a line
    whose ends lie on one row counts as length 0, tilt 0)."""
    info = []
    for line in lines:
        first = np.asarray(line[0], dtype=np.float64)
        last = np.asarray(line[-1], dtype=np.float64)
        if last[1] != first[1]:
            rotation = math.degrees(np.arctan2(last[1] - first[1], last[0] - first[0]))
            info.append((float(np.hypot(*(last - first))), rotation))
        else:
            info.append((0.0, 0.0))
    info.sort(key=lambda x: x[0], reverse=True)
    info = info[: len(info) // 2]
    if not info:
        return 0.0
    return sum(r for _, r in info) / len(info)


def rotate_coords(coords, rotation: float, center) -> np.ndarray:
    """Points turned by ``rotation`` degrees about ``center``, as cv2's
    ``transform`` by ``getRotationMatrix2D(center, rotation, 1)``."""
    return transform(coords, rotation_matrix(center, rotation))


def merge_lines(baselines, heights):
    """Lines of one visual row merged: deskewed by the mean tilt, two
    lines pair when they overlap vertically by more than 0.7 of the
    lower one's height, neither holds the other horizontally and their
    gap is under twice that height; each group becomes one resampled
    baseline with the larger heights.  The lines are then ordered top to
    bottom by their first point's y, jittered by one draw of Python's
    global ``random.uniform(0.001, 0.999)`` a line, and turned back."""
    rotation = get_rotation(baselines)
    baselines = [rotate_coords(b, rotation, (0, 0)) for b in baselines]

    n = len(baselines)
    avg_y = np.asarray([np.average(np.asarray(b)[:, 1]) for b in baselines])
    x_min = np.asarray([np.amin(np.asarray(b)[:, 0]) for b in baselines])
    x_max = np.asarray([np.amax(np.asarray(b)[:, 0]) for b in baselines])
    h_asc = np.asarray([h[0] for h in heights], dtype=float)
    h_desc = np.asarray([h[1] for h in heights], dtype=float)

    merged = set()
    groups: List[List[int]] = []
    for i in range(n):
        group = []
        for j in range(n):
            if i == j:
                continue
            contained = (x_min[i] > x_min[j] and x_max[i] < x_max[j]) or (
                x_min[j] > x_min[i] and x_max[j] < x_max[i])
            gap = max(x_min[i] - x_max[j], x_min[j] - x_max[i])
            overlap = min(avg_y[i] + h_desc[i], avg_y[j] + h_desc[j]) - max(
                avg_y[i] - h_asc[i], avg_y[j] - h_asc[j])
            min_height = min(h_asc[i] + h_desc[i], h_asc[j] + h_desc[j])
            if overlap > 0.7 * min_height and not contained and gap < 2 * min_height:
                if i not in merged:
                    group.append(i)
                    merged.add(i)
                if j not in merged:
                    group.append(j)
                    merged.add(j)
        groups.append(group)

    baselines = [np.asarray(b) for b in baselines]
    heights = [list(h) for h in heights]
    for group in groups:
        if not group:
            continue
        pts = np.concatenate([baselines[g] for g in group], axis=0)
        pts = pts[np.argsort(pts[:, 0])]
        baselines.append(resample_baselines([pts])[0])
        heights.append([max(heights[g][0] for g in group), max(heights[g][1] for g in group)])

    keep = [i for i in range(len(baselines)) if i not in merged]
    baselines = [baselines[i] for i in keep]
    heights = [heights[i] for i in keep]

    order = [b[0][1] + random.uniform(0.001, 0.999) for b in baselines]
    baselines = [b for _, b in sorted(zip(order, baselines), key=lambda x: x[0])]
    heights = [h for _, h in sorted(zip(order, heights), key=lambda x: x[0])]
    baselines = [rotate_coords(b, -rotation, (0, 0)) for b in baselines]
    return baselines, heights


def filter_list(items_list, indices_to_remove):
    """``items_list`` without the items at ``indices_to_remove``
    (negative indices count from the end; one out of range raises
    ``ValueError``)."""

    def normalize(idx):
        n = len(items_list)
        if idx < -n or idx > n - 1:
            raise ValueError(f"Cannot remove index {idx} from {n}-long data")
        return idx if idx >= 0 else n + idx

    to_remove = {normalize(i) for i in indices_to_remove}
    return [x for i, x in enumerate(items_list) if i not in to_remove]
