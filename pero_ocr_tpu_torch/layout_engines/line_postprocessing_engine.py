"""A region's lines post-processed (port of
pero_ocr_tpu/layout_engines/line_postprocessing_engine.py,
``LINE_POSTPROCESSING``): baselines stretched by a number of pixels or
out to the region's outline, resampled, or the region's dominant line
given the region's height; each changed line's outline is rebuilt from
its baseline and heights."""

from __future__ import annotations

from typing import List

import numpy as np

from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.layout_engines import helpers


class PostprocessingEngine:
    def __init__(self, stretch_lines, resample_lines: bool, heights_from_regions: bool):
        self.stretch_lines = stretch_lines  # 'max' | int px
        self.resample_lines = resample_lines
        self.heights_from_regions = heights_from_regions

    def postprocess(self, region):
        if not region.lines:
            return region
        redo_textlines = False
        if self.stretch_lines == "max" or (
                isinstance(self.stretch_lines, int) and self.stretch_lines > 0):
            self.stretch_baselines(region)
            redo_textlines = True
        if self.resample_lines:
            self.resample_baselines(region)
            redo_textlines = True
        if self.heights_from_regions:
            self.get_heights_from_regions(region)
            redo_textlines = True
        if redo_textlines:
            for line in region.lines:
                line.polygon = helpers.baseline_to_textline(line.baseline, line.heights)
        return region

    def stretch_baselines(self, region) -> None:
        """Each baseline extended, in the deskewed frame, by
        ``stretch_lines`` px at both ends, or with 'max' to where its
        straight fit crosses the region's outline (10 px beyond the
        outline's extent; a line that does not cross it twice stays)."""
        baselines = [line.baseline for line in region.lines]
        rotation = helpers.get_rotation(baselines)
        baselines = [helpers.rotate_coords(b, rotation, (0, 0)) for b in baselines]

        stretched: List[np.ndarray] = []
        if self.stretch_lines == "max":
            region_poly = helpers.rotate_coords(np.asarray(region.polygon, dtype=float),
                                                rotation, (0, 0))
            x_lo = region_poly[:, 0].min() - 10
            x_hi = region_poly[:, 0].max() + 10
            for baseline in baselines:
                fit = np.poly1d(np.polyfit(baseline[:, 0], baseline[:, 1], 1))
                cuts = geometry.segment_polygon_intersections(
                    [x_lo, fit(x_lo)], [x_hi, fit(x_hi)], region_poly)
                if len(cuts) >= 2:
                    left = cuts[np.argmin(cuts[:, 0])]
                    right = cuts[np.argmax(cuts[:, 0])]
                    stretched.append(np.concatenate([left[None, :], baseline, right[None, :]],
                                                    axis=0))
                else:
                    stretched.append(baseline)
        else:
            for baseline in baselines:
                first = baseline[:1].copy()
                first[0, 0] -= self.stretch_lines
                last = baseline[-1:].copy()
                last[0, 0] += self.stretch_lines
                stretched.append(np.concatenate([first, baseline, last], axis=0))

        stretched = [helpers.rotate_coords(b, -rotation, (0, 0)) for b in stretched]
        for line, baseline in zip(region.lines, stretched):
            line.baseline = baseline

    def resample_baselines(self, region) -> None:
        resampled = helpers.resample_baselines([line.baseline for line in region.lines])
        for line, baseline in zip(region.lines, resampled):
            line.baseline = baseline

    def get_heights_from_regions(self, region) -> None:
        """Only the dominant line (longest baseline plus ascender) stays,
        its heights the region's extent above and below its baseline."""
        polygon = np.asarray(region.polygon)
        scores = []
        height_pairs = []
        for line in region.lines:
            baseline = np.asarray(line.baseline)
            asc = int(round(baseline[:, 1].min() - polygon[:, 1].min()))
            desc = int(round(polygon[:, 1].max() - baseline[:, 1].max()))
            height_pairs.append((asc, desc))
            scores.append(baseline[:, 0].max() - baseline[:, 0].min() + asc)
        best = int(np.argmax(np.asarray(scores)))
        region.lines = [region.lines[best]]
        region.lines[0].heights = list(height_pairs[best])
