"""A baseline refined on the baseline-probability map (port of
pero_ocr_tpu/layout_engines/baseline_refiner.py, ``ADJUST_BASELINES``).

The map's baseline channel is cropped along the current baseline (the
float32 remap of :class:`~pero_ocr_tpu_torch.core.crop_engine.EngineLineCropper`),
a cubic polynomial is fitted to the probability mass, weighted towards
the current baseline's row, and the fitted curve is mapped back to page
coordinates through the crop's forward field.  A line that cannot be
refined keeps its baseline.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)


def refine_baseline(baseline: np.ndarray, heights, detection_maps: np.ndarray,
                    downsample: float, crop_engine,
                    detection_threshold: float = 0.3) -> np.ndarray:
    try:
        baseline_ds = np.asarray(baseline, dtype=float) / downsample
        tolerance = (heights[0] + heights[1]) / (2 * downsample)

        line_crop, field = crop_engine.crop(detection_maps[:, :, 2:3], baseline_ds,
                                            [tolerance, tolerance], return_forward_mapping=True)
        line_crop = np.asarray(line_crop, dtype=float)
        if line_crop.ndim == 3:
            line_crop = line_crop[:, :, 0]
        line_crop[line_crop < detection_threshold] = 0
        ys, xs = np.nonzero(line_crop)
        if len(xs) < 4:
            return np.asarray(baseline, dtype=float)

        bs_row = int(round(line_crop.shape[0] * heights[0] / (heights[0] + heights[1])))
        bs_row = np.clip(bs_row, 1, line_crop.shape[0] - 1)
        weights_profile = np.concatenate([np.linspace(0, 1.0, bs_row),
                                          np.linspace(1.0, 0, line_crop.shape[0] - bs_row)])
        weights = line_crop[ys, xs] * weights_profile[ys]
        fit = np.poly1d(np.polyfit(xs, ys, 3, w=weights))

        # Columns where the fitted curve rides probability mass.
        col_x = np.arange(line_crop.shape[1])
        col_y = np.round(np.clip(fit(col_x), 0, line_crop.shape[0] - 1)).astype(int)
        col_x = col_x[line_crop[col_y, col_x] >= detection_threshold]
        if len(col_x) == 0:
            return np.asarray(baseline, dtype=float)

        min_x = max(col_x.min() - 10, 0)
        max_x = min(col_x.max() + 10, line_crop.shape[1] - 1)
        length = (field[bs_row, np.clip(max_x, 0, field.shape[1] - 1), 0]
                  - field[bs_row, np.clip(min_x, 0, field.shape[1] - 1), 0])
        num_steps = min(10, int(round(max(2, length / (tolerance * 2)))))

        new_x = np.linspace(min_x, max_x, num_steps)
        new_y = np.clip(np.round(fit(new_x)).astype(int), 0, field.shape[0] - 1)
        new_x = np.clip(np.round(new_x).astype(int), 0, field.shape[1] - 1)
        refined = np.stack([field[new_y, new_x, 0], field[new_y, new_x, 1]], axis=1)
        return refined * downsample
    except Exception:  # noqa: BLE001  (any failure keeps the line, as in the JAX package)
        logger.warning("Baseline refinement failed for baseline %s", baseline)
        return np.asarray(baseline, dtype=float)
