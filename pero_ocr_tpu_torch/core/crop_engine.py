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

``crop(..., return_mapping=True)`` also gives the inverse (page to
crop) mapping of ``reverse_xy_mapping``, with which ``blend_in``
composites a processed crop back into the page under a soft border:
the JAX engine's cv2 calls there are :mod:`~pero_ocr_tpu_torch.utils.resize`'s
``resize_linear_up_f32`` and ``remap_linear_transparent``, equal to
cv2 5.0.0 bit for bit.
"""

from __future__ import annotations

import logging

from typing import Tuple

import numpy as np
from scipy import ndimage

from pero_ocr_tpu_torch.core import line_geometry
from pero_ocr_tpu_torch.utils.resize import (
    remap_linear,
    remap_linear_f32,
    remap_linear_transparent,
    resize_linear_up_f32,
)

logger = logging.getLogger(__name__)


class EngineLineCropper:
    def __init__(self, line_height: int = 32, poly: int = 0, scale: float = 1,
                 blend_border: int = 4, correct_slant: bool = False):
        self.line_height = line_height
        self.poly = poly
        self.scale = scale
        self.blend_border = blend_border
        self.correct_slant = correct_slant  # kept, unused, as in the JAX engine

    def get_crop_inputs(self, baseline, line_heights, target_height) -> np.ndarray:
        """Dense (target_height, W, 2) source-coordinate field."""
        return line_geometry.warp_field(
            baseline, line_heights, target_height, poly=self.poly, scale=self.scale
        )

    def crop(self, img: np.ndarray, baseline, heights, return_mapping: bool = False,
             return_forward_mapping: bool = False):
        """The (line_height, W, C) crop of one line (a float32 image with
        one channel gives (line_height, W), as cv2 does); a line whose
        field cannot be built gives a (line_height, 32, C) uint8 zero
        crop.  With ``return_mapping``, (crop, mapping, offset) of
        :meth:`reverse_xy_mapping`; else with ``return_forward_mapping``,
        (crop, field), the field None for a failed line."""
        try:
            field = self.get_crop_inputs(baseline, heights, self.line_height)
            line_crop = self.fast_remap(img, field)
        except (ValueError, IndexError, np.linalg.LinAlgError):
            logger.error("line crop failed. %s %s", heights, baseline)
            line_crop = np.zeros([self.line_height, 32, img.shape[2]], dtype=np.uint8)
            field = None
        if return_mapping:
            mapping, offset = self.reverse_xy_mapping(field, img.shape)
            return line_crop, mapping, offset
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

    def reverse_xy_mapping(self, field: np.ndarray, shape) -> Tuple[np.ndarray, Tuple[int, int]]:
        """The inverse (page to crop) mapping of a line's ``field`` over
        its bounding box of the page of ``shape``: a float32 (h, w, 2)
        of crop (x, y) a page pixel, -1 where no crop pixel lands, and
        the box's (y, x) offset.  The field and the crop's coordinates
        are upsampled 4x and scattered to the nearest page pixel."""
        up = 4
        y_map = np.clip(resize_linear_up_f32(field[:, :, 1], up), 0, shape[0] - 1)
        x_map = np.clip(resize_linear_up_f32(field[:, :, 0], up), 0, shape[1] - 1)
        y_idx = np.round(y_map).astype(int)
        x_idx = np.round(x_map).astype(int)
        y_start, y_stop = y_idx.min(), y_idx.max() + 1
        x_start, x_stop = x_idx.min(), x_idx.max() + 1

        rows, cols = field.shape[:2]
        src_y = resize_linear_up_f32(
            np.tile(np.arange(rows, dtype=np.float32)[:, None], (1, cols)), up)
        src_x = resize_linear_up_f32(
            np.tile(np.arange(cols, dtype=np.float32)[None, :], (rows, 1)), up)

        reverse = np.full((y_stop - y_start, x_stop - x_start, 2), -1, dtype=np.float32)
        reverse[y_idx - y_start, x_idx - x_start, 0] = src_x
        reverse[y_idx - y_start, x_idx - x_start, 1] = src_y
        return reverse, (int(y_start), int(x_start))

    def get_blend_mask(self, mapping: np.ndarray) -> np.ndarray:
        """(h, w, 1) blend weights: 1 inside the mapped area, falling to
        0 over ``blend_border`` pixels at its edge."""
        mask = mapping[:, :, 0] > -1
        b = self.blend_border
        mask = np.pad(mask, ((b, b), (b, b)))
        mask = ndimage.uniform_filter(mask.astype(float), size=2 * b + 1)
        mask = mask[b:-b, b:-b]
        mask = 2 * np.clip(mask - 0.5, 0, 1)
        return mask[:, :, np.newaxis]

    def blend_in(self, img: np.ndarray, line_crop: np.ndarray, mapping: np.ndarray,
                 offset) -> np.ndarray:
        """Composite a (possibly modified) uint8 crop back into the page
        ``img`` (in place, and returned) through ``mapping`` at
        ``offset``, with a soft border."""
        y0, x0 = offset
        y1 = y0 + mapping.shape[0]
        x1 = x0 + mapping.shape[1]

        blended = img[y0:y1, x0:x1].copy()
        mask = self.get_blend_mask(mapping)
        remap_linear_transparent(line_crop, mapping[:, :, 0], mapping[:, :, 1], blended)
        blended = np.round((1 - mask) * img[y0:y1, x0:x1] + mask * blended).astype(np.uint8)
        img[y0:y1, x0:x1] = blended
        return img
