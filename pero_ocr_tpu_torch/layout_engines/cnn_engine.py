"""CNN layout engine (port of pero_ocr_tpu/layout_engines/cnn_engine.py).

Ported: the device-side map post-processing (:func:`postprocess_maps`),
the host paragraph clustering (:class:`ParagraphClusterer`), which
groups the parsed lines into paragraphs by the separator map between
them, and :class:`LayoutEngine`'s construction (its ParseNet and the
settings the fast path reads).  Its per-page ``detect`` and ``parse``
are the stage-by-stage path, ROADMAP item 8.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components as graph_components

from pero_ocr_tpu_torch import STAGE_BY_STAGE, not_ported
from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.layout_engines.parsenet_wrapper import ParseNetWrapper
from pero_ocr_tpu_torch.ops import morphology


def postprocess_maps(
    out_map: torch.Tensor, detection_threshold: float, line_end_weight: float
):
    """Map post-processing of ``_postprocess_maps(..., connected=False)``
    over a batch.

    out_map: (..., H, W, 5) ParseNet maps.  Returns (baselines_mask
    (..., H, W) bool, heights_map (..., H, W, 2), separator (..., H, W)).
    The (5, 3) connection dilation of the mask is left to the host."""
    heights_map = torch.stack(
        [morphology.grey_dilation(out_map[..., c], 5, 1) for c in (0, 1)], dim=-1
    )
    baselines = morphology.box_smooth(out_map[..., 2], 3)
    baselines = morphology.vertical_nonmaxima_suppression(baselines, 5)
    baselines_mask = (
        baselines - line_end_weight * out_map[..., 3]
    ) > detection_threshold
    separator = torch.clamp_min(out_map[..., 4], 0.0)
    return baselines_mask, heights_map, separator


class LayoutEngine:
    """The CNN layout engine's model and settings (the JAX
    ``LayoutEngine.__init__``)."""

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
    ):
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
        )
        self.line_end_weight = line_end_weight
        self.vertical_line_connection_range = vertical_line_connection_range
        self.smooth_line_predictions = smooth_line_predictions
        self.line_detection_threshold = detection_threshold
        self.adaptive_downsample = adaptive_downsample
        self.paragraph_line_threshold = paragraph_line_threshold

    def detect(self, image, rot: int = 0):
        raise not_ported("LayoutEngine.detect", STAGE_BY_STAGE)

    def parse(self, out_map, downsample):
        raise not_ported("LayoutEngine.parse", STAGE_BY_STAGE)


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
    penalty between the two lines is low, connected components."""

    def __init__(self, paragraph_line_threshold: float = 0.3):
        self.paragraph_line_threshold = paragraph_line_threshold

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
            out = separator_penalties(
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
            close = geometry.polygons_close(polys, pairs, thresholds)
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
