"""Reading order of a page's regions by recursive XY cuts (port of
pero_ocr_tpu/layout_engines/smart_sorter.py, ``REGION_SORTER_SMART``).

The page is turned level by the mean tilt of the longer half of the
lines of its fullest region; the regions' bounding boxes are then
grouped along alternating axes (two boxes couple when their overlap
exceeds ``intersect_param`` of both extents), the groups ordered along
the cut axis and each group ordered recursively; a group that splits
along neither axis is sorted by the axis whose minima spread more.  The
page is turned back after.

The rotation is cv2's ``getRotationMatrix2D`` and ``transform`` (one
2x3 affine map in float64, cv2's sign convention: a positive angle turns
counter-clockwise in image coordinates), written in numpy.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from pero_ocr_tpu_torch.core.layout import PageLayout


def rotation_matrix(origin, angle: float) -> np.ndarray:
    """cv2's ``getRotationMatrix2D(origin, angle, 1)``: the 2x3 float64
    map turning points by ``angle`` degrees about ``origin`` (a float32
    point in cv2)."""
    cx, cy = (float(np.float32(v)) for v in origin)
    radians = angle * math.pi / 180
    alpha, beta = math.cos(radians), math.sin(radians)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def transform(points, matrix: np.ndarray) -> np.ndarray:
    """cv2's ``transform`` of (P, 2) points by a 2x3 map, in float64."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    return pts @ matrix[:, :2].T + matrix[:, 2]


def _groups_couple(bounds_a: np.ndarray, bounds_b: np.ndarray, axis: int,
                   intersect_param: float) -> bool:
    """Whether two boxes (x0, y0, x1, y1) overlap along ``axis`` by more
    than ``intersect_param`` of both extents."""
    lo_a, hi_a = bounds_a[axis], bounds_a[axis + 2]
    lo_b, hi_b = bounds_b[axis], bounds_b[axis + 2]
    if lo_a > hi_b or lo_b > hi_a:
        return False
    overlap = min(abs(lo_a - hi_b), abs(lo_b - hi_a))
    ext_a = max(hi_a - lo_a, 1e-6)
    ext_b = max(hi_b - lo_b, 1e-6)
    return overlap / ext_a > intersect_param and overlap / ext_b > intersect_param


def _group_bounds(bounds: np.ndarray, members: List[int]) -> np.ndarray:
    sel = bounds[members]
    return np.asarray([sel[:, 0].min(), sel[:, 1].min(), sel[:, 2].max(), sel[:, 3].max()])


def _order_recursive(bounds: np.ndarray, members: List[int], vertical: bool,
                     intersect_param: float, stuck: bool = False) -> List[int]:
    """``members`` in reading order; ``vertical`` groups along x
    (columns side by side), else along y (rows above each other)."""
    if len(members) <= 1:
        return members
    axis = 0 if vertical else 1

    groups: List[List[int]] = []
    group_bounds: List[np.ndarray] = []
    remaining = list(members)
    while remaining:
        group = [remaining.pop(0)]
        gb = bounds[group[0]].copy()
        changed = True
        while changed:
            changed = False
            for i, m in enumerate(remaining):
                if _groups_couple(gb, bounds[m], axis, intersect_param):
                    group.append(remaining.pop(i))
                    gb = _group_bounds(bounds, group)
                    changed = True
                    break
        groups.append(group)
        group_bounds.append(gb)

    if len(groups) == 1:
        if stuck:
            sel = bounds[members]
            x_spread = np.abs(np.diff(np.sort(sel[:, 0]))).sum()
            y_spread = np.abs(np.diff(np.sort(sel[:, 1]))).sum()
            key_axis = 0 if x_spread > y_spread else 1
            return sorted(members, key=lambda i: bounds[i][key_axis])
        return _order_recursive(bounds, members, not vertical, intersect_param, stuck=True)

    sort_key = 0 if vertical else 1
    order = sorted(range(len(groups)), key=lambda g: group_bounds[g][sort_key])
    out: List[int] = []
    for g in order:
        out.extend(_order_recursive(bounds, groups[g], not vertical, intersect_param))
    return out


class SmartRegionSorter:
    def __init__(self, config=None, config_path: str = ""):
        self.intersect_param = 0.1
        if config is not None and hasattr(config, "getfloat"):
            self.intersect_param = config.getfloat("FakeIntersectionParameter", fallback=0.1)

    def process_page(self, image, page_layout: PageLayout) -> PageLayout:
        if len(page_layout.regions) < 2:
            return page_layout
        reference_region = max(page_layout.regions, key=lambda r: len(r.lines))
        rotation = self.get_rotation(reference_region.lines)
        self.rotate_page_layout(page_layout, -rotation)
        bounds = np.asarray([[np.asarray(r.polygon)[:, 0].min(), np.asarray(r.polygon)[:, 1].min(),
                              np.asarray(r.polygon)[:, 0].max(), np.asarray(r.polygon)[:, 1].max()]
                             for r in page_layout.regions], dtype=float)
        order = _order_recursive(bounds, list(range(len(page_layout.regions))),
                                 vertical=False, intersect_param=self.intersect_param)
        page_layout.regions = [page_layout.regions[i] for i in order]
        self.rotate_page_layout(page_layout, rotation)
        return page_layout

    @staticmethod
    def rotate_page_layout(page: PageLayout, angle: float, origin=(0, 0)) -> None:
        """Turn every region, line outline and baseline by ``angle``
        degrees about ``origin`` (cv2's convention)."""
        if angle == 0:
            return
        matrix = rotation_matrix(origin, angle)
        for region in page.regions:
            region.polygon = transform(region.polygon, matrix)
            for line in region.lines:
                if line.polygon is not None:
                    line.polygon = transform(line.polygon, matrix)
                if line.baseline is not None:
                    line.baseline = transform(line.baseline, matrix)

    @staticmethod
    def get_rotation(lines) -> float:
        """The mean tilt in degrees (the degrees of the sine of each
        line's end-to-end slope) of the longer half of ``lines``."""
        if not lines:
            return 0.0
        info = []
        for line in lines:
            first = np.asarray(line.baseline[0], dtype=np.float64)
            last = np.asarray(line.baseline[-1], dtype=np.float64)
            if last[1] != first[1]:
                length = float(np.hypot(*(last - first)))
                rotation = math.degrees(math.sin((last[1] - first[1]) / max(length, 1e-9)))
                info.append((length, rotation))
            else:
                info.append((0.0, 0.0))
        info.sort(key=lambda x: x[0], reverse=True)
        info = info[: len(info) // 2]
        if not info:
            return 0.0
        return sum(r for _, r in info) / len(info)
