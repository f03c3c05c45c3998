"""CNN layout engine (port of pero_ocr_tpu/layout_engines/cnn_engine.py).

- :func:`postprocess_maps`: the map post-processing on the device
  (height dilation, smoothing, vertical NMS, the endpoint-weighted
  threshold), which both paths run; :func:`connect_lines` is the
  vertical connection dilation of the stage-by-stage path (the fast path
  does it on the host).
- :class:`ParagraphClusterer`: the host paragraph clustering, which
  groups the parsed lines into paragraphs by the separator map between
  them (the fast path's).  Its pair tests and penalties run the port's
  C++ (``utils/native.py``) or their numpy twins here and in
  ``core/geometry.py``.
- :class:`LayoutEngine`: its ParseNet and settings, and the
  stage-by-stage ``detect``: maps at adaptive resolution
  (``ParseNetWrapper``), ``parse`` (connected components to baselines,
  heights and outlines), the clustering, region polygons from alpha
  shapes with raster overlap resolution, and the top-to-bottom order.
- :class:`LineFilterEngine`: ``LINE_FILTER``'s ``FILTER_DIRECTIONS``,
  the OrientationNet direction field of the page and the test of each
  steep line against it.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components as graph_components

from pero_ocr_tpu_torch import resolve_device
from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.layout_engines import helpers
from pero_ocr_tpu_torch.layout_engines.parsenet_wrapper import (
    OrientationNetWrapper, ParseNetWrapper,
)
from pero_ocr_tpu_torch.ops import morphology
from pero_ocr_tpu_torch.utils import native as native_lib
from pero_ocr_tpu_torch.utils.timing import stage_timer


def postprocess_maps(
    out_map: torch.Tensor, detection_threshold: float, line_end_weight: float,
    smooth: bool = True,
):
    """Map post-processing of ``_postprocess_maps(..., connected=False)``
    over a batch.

    out_map: (..., H, W, 5) ParseNet maps.  Returns (baselines_mask
    (..., H, W) bool, heights_map (..., H, W, 2), separator (..., H, W)).
    ``smooth``: the 3x3 box smooth of the baseline channel before the
    NMS (``SMOOTH_LINE_PREDICTIONS``)."""
    heights_map = torch.stack(
        [morphology.grey_dilation(out_map[..., c], 5, 1) for c in (0, 1)], dim=-1
    )
    baselines = out_map[..., 2]
    if smooth:
        baselines = morphology.box_smooth(baselines, 3)
    baselines = morphology.vertical_nonmaxima_suppression(baselines, 5)
    baselines_mask = (
        baselines - line_end_weight * out_map[..., 3]
    ) > detection_threshold
    separator = torch.clamp_min(out_map[..., 4], 0.0)
    return baselines_mask, heights_map, separator


def connect_lines(baselines_mask: torch.Tensor, vertical_range: int) -> torch.Tensor:
    """The connection dilation of ``_postprocess_maps(connected=True)``:
    a (vertical_range, 3) max window over the mask, lax ``'SAME'``."""
    return morphology.grey_dilation(baselines_mask.float(), vertical_range, 3) > 0


def _round_half_away(v: np.ndarray) -> np.ndarray:
    """C's ``llround``: nearest integer, halves away from zero."""
    v = np.asarray(v, np.float64)
    t = np.trunc(v)
    return (t + np.where(np.abs(v - t) >= 0.5, np.sign(v), 0.0)).astype(np.int64)


def separator_penalties(bx, by, offs, q_line, q_shift, q_x1, q_x2, sep_map,
                        pool: int = 1, thickness: int = 1) -> np.ndarray:
    """Mean separator-map mass along shifted baselines, for many queries
    at once (the JAX package's ``native_separator_penalties``, whose
    semantics its pipeline runs).

    ``bx``/``by``: the lines' x-sorted points, concatenated, in map
    pixels; ``offs``: (n_lines + 1,) line offsets into them.  Query q
    samples line ``q_line[q]`` shifted by ``q_shift[q]`` rows on every
    integer column in [llround(x1), llround(x2)) that the line spans,
    taking the (2 * thickness + 1)-row band around the interpolated row
    (rounded half away from zero); the mass is divided by x2 - x1.
    Queries with no sampled column get 1.0.  ``pool`` > 1: ``sep_map``
    is the pool-pooled map; the coordinates stay full-map.  Returns
    (Q,) float64."""
    bx = np.asarray(bx, np.float64)
    by = np.asarray(by, np.float64)
    offs = np.asarray(offs, np.int64)
    q_line = np.asarray(q_line, np.int64)
    q_shift = np.asarray(q_shift, np.float64)
    q_x1 = np.asarray(q_x1, np.float64)
    q_x2 = np.asarray(q_x2, np.float64)
    sep = np.asarray(sep_map, np.float32)
    h, w = sep.shape[0] * pool, sep.shape[1] * pool
    out = np.ones(len(q_line))
    if len(q_line) == 0:
        return out

    lo, hi = offs[q_line], offs[q_line + 1]
    npts = hi - lo
    has = npts >= 1
    px0 = np.where(has, bx[np.where(has, lo, 0)], 0.0)
    pxl = np.where(has, bx[np.where(has, hi - 1, 0)], 0.0)
    x1, x2 = _round_half_away(q_x1), _round_half_away(q_x2)
    xa = np.maximum(x1, np.ceil(np.maximum(px0, 0.0)).astype(np.int64))
    xb = np.minimum(np.minimum(x2 - 1, np.floor(pxl).astype(np.int64)), w - 1)
    ok = (x2 > x1) & has & (pxl > px0) & (xa <= xb)
    counts = np.where(ok, xb - xa + 1, 0)
    total = int(counts.sum())
    if total == 0:
        return out

    # One element per sampled column, query-major and x ascending.
    q = np.repeat(np.arange(len(q_line)), counts)
    x = xa[q] + np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    xf = x.astype(np.float64)
    # Segment of each column: the first s with px[s + 1] >= x, at most
    # npts - 2 (the line's points are x-sorted).
    n_lines = len(offs) - 1
    pmax = int((offs[1:] - offs[:-1]).max())
    padded = np.full((n_lines, pmax), np.inf)
    line_of = np.repeat(np.arange(n_lines), offs[1:] - offs[:-1])
    padded[line_of, np.arange(len(bx)) - offs[line_of]] = bx
    seg = (padded[q_line[q], 1:] < xf[:, None]).sum(axis=1)
    seg = np.minimum(seg, npts[q] - 2)
    i0 = lo[q] + seg
    dx = bx[i0 + 1] - bx[i0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(dx > 0, (xf - bx[i0]) / dx, 0.0)
    y = by[i0] + t * (by[i0 + 1] - by[i0])
    y = np.where(xf <= px0[q], by[lo[q]], np.where(xf >= pxl[q], by[hi[q] - 1], y))
    yc = _round_half_away(y + q_shift[q])
    rows = np.clip(yc[:, None] + np.arange(-thickness, thickness + 1)[None], 0, h - 1)
    vals = sep[rows // pool, (x // pool)[:, None]].astype(np.float64)
    # bincount accumulates in element order: columns ascending, then
    # band rows, as the reference sums them.
    mass = np.bincount(np.repeat(q, 2 * thickness + 1), weights=vals.ravel(),
                       minlength=len(q_line))
    denom = np.maximum(q_x2 - q_x1, 1e-6)
    return np.where(counts > 0, mass / denom, out)


class ParagraphClusterer:
    """Paragraph clustering of parsed lines on a separator map: candidate
    pairs by dilated-outline proximity, an edge where the separator
    penalty between the two lines is low, connected components.
    ``native``: the pair tests and penalties in the port's C++
    (``polygons_close_f64``, ``separator_penalties_f32``), else in
    numpy; both give the same answers."""

    def __init__(self, paragraph_line_threshold: float = 0.3, native: bool = False):
        self.paragraph_line_threshold = paragraph_line_threshold
        self.native = native

    def get_penalty(self, baseline, shift, x_1, x_2, sep_map, thickness=1, pool=1):
        """Mean separator-map mass along a baseline shifted by ``shift``
        rows within [x_1, x_2) (:func:`separator_penalties`, one query)."""
        b = np.asarray(baseline, float)
        order = np.argsort(b[:, 0])
        return float(separator_penalties(
            b[order, 0], b[order, 1], [0, len(b)], [0], [shift], [x_1], [x_2],
            sep_map, pool, thickness,
        )[0])

    def get_pair_penalty(self, b1, b2, h1, h2, sep_map, ds, pool=1):
        """Separator penalty between two lines' facing edges."""
        x_overlap = max(
            0,
            min(np.amax(b1[:, 0]), np.amax(b2[:, 0]))
            - max(np.amin(b1[:, 0]), np.amin(b2[:, 0])),
        )
        if x_overlap <= 5:
            return 1.0
        x_1 = int(max(np.amin(b1[:, 0]), np.amin(b2[:, 0])))
        x_2 = int(min(np.amax(b1[:, 0]), np.amax(b2[:, 0])))
        if np.average(b1[:, 1]) > np.average(b2[:, 1]):
            p1 = self.get_penalty(b1 / ds, -h1[0] / ds, x_1 / ds, x_2 / ds, sep_map, pool=pool)
            p2 = self.get_penalty(b2 / ds, h2[1] / ds, x_1 / ds, x_2 / ds, sep_map, pool=pool)
        else:
            p1 = self.get_penalty(b1 / ds, h1[1] / ds, x_1 / ds, x_2 / ds, sep_map, pool=pool)
            p2 = self.get_penalty(b2 / ds, -h2[0] / ds, x_1 / ds, x_2 / ds, sep_map, pool=pool)
        return abs(max(p1, p2))

    def _pair_penalties_batch(self, b_list, h_list, pairs, sep_map, ds, pool=1):
        """All close pairs' separator penalties in one vectorized call
        (two queries a pair).  Returns (P,) penalties."""
        blines = [np.asarray(b, float) for b in b_list]
        bxs, bys, offs = [], [], [0]
        for b in blines:
            order = np.argsort(b[:, 0])
            bxs.append(b[order, 0] / ds)
            bys.append(b[order, 1] / ds)
            offs.append(offs[-1] + len(b))
        x_min = np.array([b[:, 0].min() for b in blines])
        x_max = np.array([b[:, 0].max() for b in blines])
        y_avg = np.array([b[:, 1].mean() for b in blines])

        penalties = np.ones(len(pairs))
        # x-overlap gate, asc/desc shift selection by average-y order,
        # int() truncation of the overlap window, as get_pair_penalty.
        pi, pj = pairs[:, 0], pairs[:, 1]
        lo = np.maximum(x_min[pi], x_min[pj])
        hi = np.minimum(x_max[pi], x_max[pj])
        sel = (hi - lo) > 5.0
        if sel.any():
            q_pair = np.nonzero(sel)[0]
            i_s, j_s = pi[sel], pj[sel]
            h_arr = np.asarray([[h[0], h[1]] for h in h_list], dtype=np.float64)
            i_below = y_avg[i_s] > y_avg[j_s]
            shift_i = np.where(i_below, -h_arr[i_s, 0] / ds, h_arr[i_s, 1] / ds)
            shift_j = np.where(i_below, h_arr[j_s, 1] / ds, -h_arr[j_s, 0] / ds)
            q_line = np.stack([i_s, j_s], axis=1).ravel()
            q_shift = np.stack([shift_i, shift_j], axis=1).ravel()
            x1 = np.repeat(np.trunc(lo[sel]).astype(np.float64) / ds, 2)
            x2 = np.repeat(np.trunc(hi[sel]).astype(np.float64) / ds, 2)
            penalties_of = (native_lib.native_separator_penalties if self.native
                            else separator_penalties)
            out = penalties_of(
                np.concatenate(bxs), np.concatenate(bys), offs,
                q_line, q_shift, x1, x2, sep_map, pool,
            )
            penalties[q_pair] = np.abs(np.maximum(out[0::2], out[1::2]))
        return penalties

    def make_clusters(self, b_list, h_list, t_list, separator_map, ds, sep_pool=1):
        """Cluster lines into paragraphs: candidate pairs by
        dilated-outline overlap, edges where the separator penalty is
        low, connected components.  Returns one paragraph id per line."""
        n = len(t_list)
        if n <= 1:
            return [0] * n

        min_pos = np.zeros((n, 2), np.float32)
        max_pos = np.zeros((n, 2), np.float32)
        dilate_d = np.zeros(n, np.float32)
        polys = [np.asarray(t, np.float64) for t in t_list]
        for i, textline in enumerate(polys):
            tot_height = abs(textline[0, 1] - textline[-1, 1])
            dilate_d[i] = 3 * tot_height / 4
            min_pos[i] = textline.min(axis=0) - tot_height
            max_pos[i] = textline.max(axis=0) + tot_height

        disjoint = np.logical_and(
            np.logical_or(
                max_pos[:, None, 1] <= min_pos[None, :, 1],
                min_pos[:, None, 1] >= max_pos[None, :, 1],
            ),
            np.logical_or(
                max_pos[:, None, 0] <= min_pos[None, :, 0],
                min_pos[:, None, 0] >= max_pos[None, :, 0],
            ),
        )
        candidates = np.triu(np.logical_not(disjoint), k=1)

        distances = np.ones((n, n))
        pairs = np.stack(candidates.nonzero(), axis=1)
        if len(pairs):
            # Minkowski identity: the outlines dilated by d_i and d_j
            # intersect iff their boundary distance is <= d_i + d_j
            # (touching counts).
            thresholds = dilate_d[pairs[:, 0]] + dilate_d[pairs[:, 1]]
            close_of = native_lib.native_polygons_close if self.native else geometry.polygons_close
            close = close_of(polys, pairs, thresholds.astype(np.float64))
            close_pairs = pairs[close]
            pen = self._pair_penalties_batch(
                b_list, h_list, close_pairs, separator_map, ds, pool=sep_pool,
            )
            distances[close_pairs[:, 0], close_pairs[:, 1]] = pen
            distances[close_pairs[:, 1], close_pairs[:, 0]] = pen

        adjacency = (distances < self.paragraph_line_threshold).astype(int)
        np.fill_diagonal(adjacency, 0)
        _, clusters = graph_components(
            csgraph=csr_matrix(adjacency > 0), directed=False, return_labels=True
        )
        return clusters


class LayoutEngine(ParagraphClusterer):
    """CNN region and line detection on one page at a time: ParseNet
    maps at adaptive resolution, lines from their connected components,
    paragraphs from the separator map, region outlines."""

    def __init__(
        self,
        model_path=None,
        downsample: int = 4,
        max_mp: float = 5,
        detection_threshold: float = 0.2,
        adaptive_downsample: bool = True,
        line_end_weight: float = 1.0,
        vertical_line_connection_range: int = 5,
        smooth_line_predictions: bool = True,
        paragraph_line_threshold: float = 0.3,
        stem: str = "conv",
        base_features: int = 32,
        depth: int = 4,
        out_upsample: int = 1,
        device=None,
    ):
        """``device``: where ParseNet and the map post-processing run;
        None means CUDA (resolved at the first page).  The labeling and
        clustering follow it (:func:`~pero_ocr_tpu_torch.utils.native.use_native`):
        the port's C++ on CUDA, numpy/scipy on the CPU; set ``native``
        to take the other."""
        super().__init__(paragraph_line_threshold, native_lib.use_native(None, device))
        self.parsenet = ParseNetWrapper(
            model_path,
            downsample=downsample,
            adaptive_downsample=adaptive_downsample,
            max_mp=max_mp,
            detection_threshold=detection_threshold,
            stem=stem,
            base_features=base_features,
            depth=depth,
            out_upsample=out_upsample,
            device=device,
        )
        self.line_end_weight = line_end_weight
        self.vertical_line_connection_range = vertical_line_connection_range
        self.smooth_line_predictions = smooth_line_predictions
        self.line_detection_threshold = detection_threshold
        self.adaptive_downsample = adaptive_downsample

    def get_heights(self, heights_map, ds, inds):
        """Heights at page points ``inds``: the 70th percentile of the
        map's (clipped at 0) ascender and descender there, times ds."""
        inds = np.asarray(inds, dtype=float) / ds
        y = np.clip(np.round(inds[:, 1]).astype(int), 0, heights_map.shape[0] - 1)
        x = np.clip(np.round(inds[:, 0]).astype(int), 0, heights_map.shape[1] - 1)
        pred = np.maximum(heights_map[y, x], 0)
        return np.asarray([np.percentile(pred[:, 0], 70), np.percentile(pred[:, 1], 70)]) * ds

    def detect(self, image: np.ndarray, rot: int = 0):
        """(region polygons, baselines, heights, textline outlines) of
        the page in page coordinates, lines top to bottom; ``rot``
        detects on ``np.rot90(image, rot)`` and maps back."""
        if rot > 0:
            image = np.rot90(image, k=rot)
        with stage_timer("parsenet_maps"):
            maps, ds = self.parsenet.get_maps_with_optimal_resolution(image)
        b_list, h_list, t_list = self.parse(maps, ds)
        if not b_list:
            return [], [], [], []
        with stage_timer("paragraph_clustering"):
            clusters = self.make_clusters(b_list, h_list, t_list, maps[:, :, 4], ds)
        with stage_timer("region_polygons"):
            p_list = self.clustered_lines_to_polygons(t_list, clusters)
        b_list, h_list, t_list = helpers.order_lines_vertical(b_list, h_list, t_list)
        p_list, b_list, t_list = self.rotate_layout(p_list, b_list, t_list, rot, image.shape)
        return p_list, b_list, h_list, t_list

    def parse(self, out_map: np.ndarray, downsample: float):
        """Maps -> (baselines, heights, outlines) in page coordinates,
        left to right: each connected component of the connected mask
        with more than 5 mask pixels gives one line through its first
        row at each column (at most 10 points, decimated, ends moved out
        by 2 map px) and the median heights under it."""
        with stage_timer("map_postprocess"):
            device = resolve_device(self.parsenet.device)
            with torch.inference_mode():
                maps = torch.from_numpy(np.ascontiguousarray(out_map, np.float32)).to(device)
                mask, heights_map, _ = postprocess_maps(
                    maps, self.line_detection_threshold, self.line_end_weight,
                    smooth=self.smooth_line_predictions,
                )
                connected = connect_lines(mask, self.vertical_line_connection_range)
                mask, connected, heights_map = (t.cpu().numpy()
                                                for t in (mask, connected, heights_map))

        labels_img, num = morphology.connected_components(connected, self.native)
        labels_img = labels_img * mask

        b_list: List[np.ndarray] = []
        h_list: List[List[float]] = []
        ys, xs = np.nonzero(labels_img > 0)
        labels = labels_img[ys, xs]
        order = np.argsort(labels, kind="stable")
        ys, xs, labels = ys[order], xs[order], labels[order]
        boundaries = np.searchsorted(labels, np.arange(1, num + 2))
        for comp in range(num):
            lo, hi = boundaries[comp], boundaries[comp + 1]
            if hi - lo <= 5:
                continue
            comp_x = xs[lo:hi]
            comp_y = ys[lo:hi]
            # One point per unique x, ordered left to right.
            ux, first_idx = np.unique(comp_x, return_index=True)
            pos = np.stack([ux, comp_y[first_idx]], axis=1).astype(float)
            target_points = max(min(10, pos.shape[0] // 10), 2)
            pos = pos[np.linspace(0, pos.shape[0] - 1, target_points).astype(int)]
            pos[0, 0] -= 2   # compensate the endpoint detector's shrinkage
            pos[-1, 0] += 2
            hp = np.maximum(heights_map[comp_y, comp_x], 0)
            heights = [float(np.percentile(hp[:, 0], 50)), float(np.percentile(hp[:, 1], 50))]
            b_list.append(downsample * pos)
            h_list.append([downsample * heights[0], downsample * heights[1]])

        # Left to right (jittered for stability).
        rng = np.random.default_rng(0)
        keys = [b[:, 0].min() + 1e-4 * rng.random() for b in b_list]
        order = sorted(range(len(b_list)), key=lambda i: keys[i])
        b_list = [b_list[i] for i in order]
        h_list = [h_list[i] for i in order]
        t_list = [helpers.baseline_to_textline(b, h) for b, h in zip(b_list, h_list)]
        return b_list, h_list, t_list

    def rotate_layout(self, p_list, b_list, t_list, rot, shape):
        """Map coordinates detected on ``np.rot90(image, rot)`` back to
        the page (pixel-exact: ``dim - 1 - x``)."""
        if rot == 0:
            return p_list, b_list, t_list

        def tf(points):
            points = np.asarray(points, dtype=float)
            if rot == 1:
                out = np.flip(points, axis=1).copy()
                out[:, 0] = shape[0] - 1 - out[:, 0]
            elif rot == 2:
                out = np.asarray(shape[:2][::-1]) - 1 - points
            else:  # rot == 3
                out = np.flip(points, axis=1).copy()
                out[:, 1] = shape[1] - 1 - out[:, 1]
            return out

        return [tf(p) for p in p_list], [tf(b) for b in b_list], [tf(t) for t in t_list]

    def filter_polygons(self, polygons, region_textlines):
        """Resolve region overlaps: a region 98% inside another goes; of
        two that overlap in part, the one with less textline area in the
        overlap loses the overlap (its largest remaining piece stays)."""
        keep = [True] * len(polygons)
        polygons = [np.asarray(p, dtype=float) for p in polygons]
        for i in range(len(polygons)):
            for j in range(i + 1, len(polygons)):
                if not (keep[i] and keep[j]):
                    continue
                inter = geometry.polygon_intersection_area(polygons[i], polygons[j])
                if inter < 1.0:
                    continue
                area_i = abs(geometry.polygon_area(polygons[i]))
                area_j = abs(geometry.polygon_area(polygons[j]))
                if inter >= 0.98 * area_j:
                    keep[j] = False
                    continue
                if inter >= 0.98 * area_i:
                    keep[i] = False
                    continue
                inter_poly = geometry.polygon_intersection(polygons[i], polygons[j])
                if inter_poly is None:
                    continue
                score_i = sum(geometry.polygon_intersection_area(np.asarray(t), inter_poly)
                              for t in region_textlines[i])
                score_j = sum(geometry.polygon_intersection_area(np.asarray(t), inter_poly)
                              for t in region_textlines[j])
                loser = j if score_i > score_j else i
                shrunk = _subtract_polygon(polygons[loser], inter_poly)
                if shrunk is None:
                    keep[loser] = False
                else:
                    polygons[loser] = shrunk
        return [p for p, k in zip(polygons, keep) if k]

    def clustered_lines_to_polygons(self, t_list, clusters):
        """One alpha-shape outline per cluster, overlap-filtered and
        simplified (tolerance 5 px)."""
        regions_textlines = []
        polygons = []
        for c in range(int(np.amax(clusters)) + 1):
            cluster_lines = [t for t, cl in zip(t_list, clusters) if cl == c]
            polygons.append(helpers.region_from_textlines(cluster_lines))
            regions_textlines.append(cluster_lines)
        polygons = self.filter_polygons(polygons, regions_textlines)
        return [geometry.simplify_polygon(p, 5) for p in polygons if len(p) >= 3]


def _subtract_polygon(poly: np.ndarray, sub: np.ndarray) -> Optional[np.ndarray]:
    """``poly`` minus ``sub`` on a raster: the outline of the largest
    remaining piece, or None."""
    x0, y0, w, h = geometry._raster_frame(poly, sub)
    mask = geometry.rasterize_polygon(poly, (x0, y0), (h, w))
    mask_sub = geometry.rasterize_polygon(sub, (x0, y0), (h, w))
    remaining = (mask & ~mask_sub).astype(np.uint8)
    if not remaining.any():
        return None
    ring = geometry._largest_external_contour(remaining)
    if ring is None:
        return None
    out = ring + [x0, y0]
    return out if len(out) >= 3 else None


class LineFilterEngine:
    """Drops lines whose baseline direction disagrees with the
    OrientationNet direction field by pi/4 or more; lines within pi/4 of
    horizontal always pass (JAX cnn_engine.py:556)."""

    def __init__(self, model_path=None, device=None, downsample=4, max_mp=5):
        """``device``: where OrientationNet runs; None means CUDA
        (resolved at the first page)."""
        self.tiltnet = OrientationNetWrapper(model_path, max_mp=max_mp, device=device)
        self.downsample = downsample
        self.predictions: Optional[np.ndarray] = None

    @staticmethod
    def get_angle_diff(angle_1, angle_2):
        smaller = np.minimum(angle_1, angle_2)
        larger = np.maximum(angle_1, angle_2)
        return np.minimum(np.abs(larger - smaller), np.abs(larger - (smaller + 2 * np.pi)))

    def predict_directions(self, image) -> None:
        self.predictions = self.tiltnet.get_maps(image, self.downsample)

    def check_line_rotation(self, polygon, baseline) -> bool:
        """Whether the line stays: horizontal within pi/4, or its
        direction within pi/4 of the median predicted direction over its
        outline's pixels (a line whose outline covers none stays)."""
        target_angle = np.arctan2(baseline[0, 1] - baseline[-1, 1],
                                  baseline[-1, 0] - baseline[0, 0])
        if -np.pi / 4 < target_angle < np.pi / 4:
            return True
        mask = geometry.rasterize_polygon(np.asarray(polygon, dtype=float) / self.downsample,
                                          (0, 0), self.predictions.shape[:2])
        inside = mask > 0
        if not inside.any():
            return True
        predicted_x = np.median(self.predictions[:, :, 0][inside])
        predicted_y = np.median(self.predictions[:, :, 1][inside])
        predicted_angle = np.arctan2(predicted_y, predicted_x)
        return self.get_angle_diff(predicted_angle, target_angle) < np.pi / 4
