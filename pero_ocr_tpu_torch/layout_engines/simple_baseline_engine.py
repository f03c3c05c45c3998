"""Classical line detection inside a known region (port of
pero_ocr_tpu/layout_engines/simple_baseline_engine.py, config 1's
``LINES_SIMPLE_THRESHOLD``): adaptive-threshold binarization, the row
projection's autocorrelation for the line period, baselines at the
projection's drops, connected-component probing for the line heights,
baselines clipped to the region polygon.

Host code, as in the JAX package.  ``cv2.adaptiveThreshold`` is
:func:`~pero_ocr_tpu_torch.utils.threshold.adaptive_threshold_mean`,
bit-equal to it; ``ndimage.label`` keeps scipy's default
4-connectivity (the port's ``cc_label_u8`` is 8-connected).
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy import ndimage, signal

from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.layout_engines import helpers
from pero_ocr_tpu_torch.utils.threshold import adaptive_threshold_mean


class EngineLineDetectorSimple:
    def __init__(
        self,
        adaptive_threshold: int = 91,
        block_size: int = 21,
        minimum_length: int = 6,
        ignored_border_pixels: int = 10,
    ):
        self.adaptive_threshold = adaptive_threshold
        self.block_size = block_size
        self.minimum_length = minimum_length
        self.ignored_border_pixels = ignored_border_pixels

    def detect_lines(self, img: np.ndarray, region: np.ndarray):
        """Detect lines inside one region polygon of a BGR uint8 page;
        returns (baselines, heights, textlines)."""
        region = np.asarray(region)
        x1 = int(np.clip(region[:, 0].min(), 0, img.shape[1]))
        x2 = int(np.clip(region[:, 0].max(), 0, img.shape[1]))
        y1 = int(np.clip(region[:, 1].min(), 0, img.shape[0]))
        y2 = int(np.clip(region[:, 1].max(), 0, img.shape[0]))
        if x1 == x2 or y1 == y2:
            return [], [], []

        column_width = x2 - x1
        column_height = y2 - y1

        # Region mask, eroded horizontally to ignore border pixels.
        mask = geometry.rasterize_polygon(
            region.astype(float), (x1, y1), (y2 - y1, x2 - x1)
        ).astype(bool)
        k = 2 * self.ignored_border_pixels + 1
        mask = ndimage.binary_erosion(mask, structure=np.ones((1, k)))

        crop = img[y1:y2, x1:x2].mean(axis=2).astype(np.uint8)
        binary = adaptive_threshold_mean(crop, self.block_size, self.adaptive_threshold) == 0
        binary = binary * mask

        labeled, _ = ndimage.label(binary)

        # Row projection -> autocorrelation -> line period.
        proj = binary.sum(axis=1).astype(float)
        corr = np.correlate(proj, proj, mode="full")[proj.shape[0]:]
        peaks = signal.find_peaks(corr, prominence=0, distance=1)[0]
        line_period = float(peaks[0]) if len(peaks) else 1.0

        # Baselines sit where the projection drops (bottom edges of rows).
        drop = -np.diff(proj)
        drop[drop < 0] = 0
        baseline_rows = signal.find_peaks(
            drop, distance=int(round(0.85 * line_period)) or 1
        )[0]

        baselines: List[np.ndarray] = []
        heights: List[List[int]] = []
        used_components: set = set()

        for row in baseline_rows[::-1]:
            probe_row = max(row - 10, 0)
            components = np.unique(labeled[probe_row, :])
            components = components[components > 0]
            if len(components) == 0:
                continue

            valid = not any(c in used_components for c in components)
            used_components.update(components.tolist())

            comp_set = set(components.tolist())
            yb1 = row
            for y in range(row, 0, -3):
                if not comp_set.intersection(labeled[y, :]):
                    yb1 = y
                    break
                yb1 = y
            yb2 = row
            for y in range(row, column_height, 3):
                if not comp_set.intersection(labeled[y, :]):
                    yb2 = y
                    break
                yb2 = y

            if column_width < self.minimum_length:
                valid = False
            if not valid:
                continue

            segment = geometry.mask_polyline_by_polygon(
                np.asarray([[x1, y1 + row], [x2, y1 + row]], dtype=float),
                region.astype(float),
            )
            if segment is None or len(segment) < 2:
                continue
            baselines.append(np.round(segment).astype(np.int16))
            heights.append([row - yb1, yb2 - row])

        textlines = [
            helpers.baseline_to_textline(b, h)
            for b, h in zip(baselines, heights)
        ]
        return baselines, heights, textlines
