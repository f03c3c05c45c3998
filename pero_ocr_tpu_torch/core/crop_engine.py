"""Line crop engine (port of pero_ocr_tpu/core/crop_engine.py): dewarp a
curved line into a height-normalized strip on the host.

``get_crop_inputs`` builds the line's dense warp field
(:func:`pero_ocr_tpu_torch.core.line_geometry.warp_field`); ``crop``
samples it with :func:`pero_ocr_tpu_torch.utils.resize.remap_linear`,
the numpy copy of ``cv2.remap(INTER_LINEAR, BORDER_CONSTANT)``, which
the stage-by-stage ``LineCropper`` uses for pages of fewer than four
lines (``remap_linear_f32`` for a float32 image: ``ADJUST_BASELINES``
crops the baseline map, and takes the field back with
``return_forward_mapping``).  Pages with more go through the card in one field warp over all
their width buckets (:func:`pero_ocr_tpu_torch.ops.warp.warp_fields`).
"""

from __future__ import annotations

import logging

import numpy as np

from pero_ocr_tpu_torch.core import line_geometry
from pero_ocr_tpu_torch.utils.resize import remap_linear, remap_linear_f32

logger = logging.getLogger(__name__)


class EngineLineCropper:
    def __init__(self, line_height: int = 32, poly: int = 0, scale: float = 1):
        self.line_height = line_height
        self.poly = poly
        self.scale = scale

    def get_crop_inputs(self, baseline, line_heights, target_height) -> np.ndarray:
        """Dense (target_height, W, 2) source-coordinate field."""
        return line_geometry.warp_field(
            baseline, line_heights, target_height, poly=self.poly, scale=self.scale
        )

    def crop(self, img: np.ndarray, baseline, heights, return_forward_mapping: bool = False):
        """The (line_height, W, C) crop of one line (a float32 image with
        one channel gives (line_height, W), as cv2 does); a line whose
        field cannot be built gives a (line_height, 32, C) uint8 zero
        crop.  With ``return_forward_mapping``, (crop, field), the field
        None for a failed line.  (The JAX engine's
        ``reverse_xy_mapping`` and ``blend_in`` have no caller on its
        paths and are not ported; ROADMAP item 9.)"""
        try:
            field = self.get_crop_inputs(baseline, heights, self.line_height)
            line_crop = self.fast_remap(img, field)
        except (ValueError, IndexError, np.linalg.LinAlgError):
            logger.error("line crop failed. %s %s", heights, baseline)
            line_crop = np.zeros([self.line_height, 32, img.shape[2]], dtype=np.uint8)
            field = None
        if return_forward_mapping:
            return line_crop, field
        return line_crop

    def fast_remap(self, img: np.ndarray, field: np.ndarray) -> np.ndarray:
        """Bilinear remap of ``img`` at ``field``, on the field's
        bounding box of the page when it lies inside the page."""
        x_min = int(np.floor(field[:, :, 0].min()))
        x_max = int(np.ceil(field[:, :, 0].max()))
        y_min = int(np.floor(field[:, :, 1].min()))
        y_max = int(np.ceil(field[:, :, 1].max()))
        remap = remap_linear_f32 if img.dtype == np.float32 else remap_linear
        if x_min < 0 or y_min < 0 or x_max > img.shape[1] - 1 or y_max > img.shape[0] - 1:
            return remap(img, field[:, :, 0], field[:, :, 1])
        crop = img[y_min: y_max + 1, x_min: x_max + 1]
        return remap(crop, field[:, :, 0] - x_min, field[:, :, 1] - y_min)
