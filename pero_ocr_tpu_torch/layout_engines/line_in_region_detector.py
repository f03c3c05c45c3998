"""Straight lines found inside a known region from ParseNet maps (port
of pero_ocr_tpu/layout_engines/line_in_region_detector.py,
``DETECT_STRAIGHT_LINES_IN_REGIONS``).

The region's maps are cut out and masked by its polygon; the principal
axis of the baseline channel's contours (every outer and hole border)
gives the text direction; the maps are turned into that frame; peaks of
the baseline channel's row sums, refined to subpixel by a parabola, are
the lines, and each line's heights the 70th percentile of the height
channels along its row.

What the JAX module runs through cv2 has numpy copies here:
``fillPoly`` (``core.geometry._fill_polys``), ``findContours(RETR_TREE,
CHAIN_APPROX_SIMPLE)`` (``core.geometry.find_contours_tree``),
``getRotationMatrix2D`` and ``transform`` (``smart_sorter``'s float64
map; float32 points as cv2 maps them) and ``warpAffine`` of float32 maps
(``utils.resize.warp_affine_linear``).
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy import signal

from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.layout_engines import helpers
from pero_ocr_tpu_torch.layout_engines.smart_sorter import rotation_matrix, transform
from pero_ocr_tpu_torch.utils.resize import warp_affine_linear


def find_peaks(array: np.ndarray, min_distance=1, min_height=0.05):
    """Peak rows of ``array`` (``scipy.signal.find_peaks``) and their
    subpixel positions (the vertex of a parabola fitted to 5 samples)."""
    peaks, _ = signal.find_peaks(array, distance=min_distance, height=min_height)
    peaks_float = peaks.astype(float).copy()
    for i, x in enumerate(peaks):
        xs = np.clip(np.arange(x - 2, x + 3), 0, array.shape[0] - 1)
        p = np.polyfit(xs, array[xs], 2)
        if abs(p[0]) > 1e-12:
            peaks_float[i] = -p[1] / (2 * p[0])
    return peaks, peaks_float


def _transform_f32(points: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """cv2's ``transform`` of float32 points by a 2x3 map: the map
    rounded to float32, each coordinate ``fma(m0, x, m1 y) + m2`` in
    float32."""
    m = np.asarray(matrix, np.float32).astype(np.float64)
    p = np.asarray(points, np.float32).reshape(-1, 2).astype(np.float64)
    out = []
    for r in m:  # float32 products are exact in float64
        y_term = (r[1] * p[:, 1]).astype(np.float32).astype(np.float64)
        out.append(((r[0] * p[:, 0] + y_term).astype(np.float32).astype(np.float64)
                    + r[2]).astype(np.float32))
    return np.stack(out, axis=1).reshape(np.shape(points))


def detect_lines_in_region(region: np.ndarray, detection_maps: np.ndarray, downsample: float,
                           line_detection_threshold: float = 0.2):
    """(baselines, heights, textlines) of the straight lines inside
    ``region`` (page coordinates)."""
    region = np.asarray(region, dtype=float)
    region_polygon = np.stack([
        np.clip(region[:, 0] / downsample, 1, detection_maps.shape[1] - 2),
        np.clip(region[:, 1] / downsample, 1, detection_maps.shape[0] - 2),
    ], axis=1)
    bb_lt = np.round(region_polygon.min(axis=0) - 1).astype(np.int32)
    bb_rb = np.round(region_polygon.max(axis=0) + 1).astype(np.int32)
    region_maps = detection_maps[bb_lt[1]:bb_rb[1], bb_lt[0]:bb_rb[0]].copy()
    region_polygon = region_polygon - bb_lt[None, :]

    polygon_mask = np.zeros(region_maps.shape[:2], dtype=np.float32)
    geometry._fill_polys(polygon_mask, np.round(region_polygon).astype(np.int32)[None])
    region_maps = region_maps * polygon_mask[:, :, None]

    # The dominant direction: the principal axis of the contour points.
    cov = np.zeros((2, 2))
    for contour in geometry.find_contours_tree(region_maps[:, :, 2] > line_detection_threshold):
        centered = contour - contour.mean(axis=0)
        cov += centered.T @ centered
    eig_val, eig_vec = np.linalg.eig(cov)
    direction = eig_vec[:, np.argmax(eig_val)]
    if direction[0] < 0:
        direction = -direction
    rad_angle = np.arctan2(direction[1], direction[0])

    # The maps turned into the text-aligned frame.
    center = tuple(np.asarray(region_maps.shape[:2], dtype=float) * 0.5)
    T = np.concatenate([rotation_matrix(center, -rad_angle / np.pi * 180),
                        np.array([[0, 0, 1]])], axis=0)
    transformed_polygon = transform(region_polygon, T[:2, :])
    lt = transformed_polygon.min(axis=0)
    rb = transformed_polygon.max(axis=0)
    T = T @ np.array([[1, 0, -lt[0]], [0, 1, -lt[1]], [0, 0, 1]])
    output_size = tuple((rb - lt + 1).astype(int))
    if output_size[0] < 2 or output_size[1] < 2:
        return [], [], []

    region_map = warp_affine_linear(np.ascontiguousarray(region_maps[:, :, :3], np.float32),
                                    T[:2, :], output_size)
    polygon_mask = warp_affine_linear(polygon_mask, T[:2, :], output_size)

    baseline_channel = region_map[:, :, 2]
    baseline_channel[baseline_channel < line_detection_threshold] = 0
    projections = baseline_channel.sum(axis=1) / output_size[0]

    inside = polygon_mask > 0
    if not inside.any():
        return [], [], []
    mean_height = np.average((region_map[:, :, 0] + region_map[:, :, 1])[inside])
    rows, rows_float = find_peaks(projections, min_distance=max(0.7 * mean_height, 1))
    if rows.shape[0] == 0:
        return [], [], []

    x0 = np.argmax(polygon_mask, axis=1)[rows]
    x1 = (polygon_mask.shape[1] - np.argmax(polygon_mask[:, ::-1], axis=1))[rows]
    baselines = np.stack([np.stack([x0, x1], axis=1),
                          np.stack([rows_float, rows_float], axis=1)], axis=2).astype(np.float32)
    baselines = _transform_f32(baselines, np.linalg.inv(T)[:2, :])
    baselines = (baselines + bb_lt[None, :] + 1) * downsample
    b_list: List[np.ndarray] = list(baselines)

    h_list = []
    for row in rows:
        selected = region_map[row, :, 2] > line_detection_threshold
        if not selected.any():
            h_list.append([mean_height * downsample, mean_height * downsample / 3])
            continue
        asc = np.percentile(region_map[row, :, 0][selected], 70)
        desc = np.percentile(region_map[row, :, 1][selected], 70)
        h_list.append([asc * downsample, desc * downsample])

    t_list = [helpers.baseline_to_textline(b, h) for b, h in zip(b_list, h_list)]
    return b_list, h_list, t_list
