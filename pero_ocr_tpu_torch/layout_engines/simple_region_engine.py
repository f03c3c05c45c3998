"""Classical region detection by thresholding and morphology (port of
pero_ocr_tpu/layout_engines/simple_region_engine.py, the layout method
``REGION_SIMPLE_THRESHOLD``), on the host.

The JAX engine chains eleven OpenCV calls; each has a copy here that is
bit-equal to cv2 5.0.0, so the regions' ids and outlines are the JAX
engine's:

- ``cvtColor(BGR2GRAY)``: OpenCV's fixed-point formula
  (``TorchPagePipeline._gray``);
- ``resize`` (``INTER_LINEAR``): :func:`~pero_ocr_tpu_torch.utils.resize.resize_linear_u8`;
- ``normalize(NORM_MINMAX)``, ``copyMakeBorder(BORDER_CONSTANT)`` with
  the border's median and the Gaussian ``adaptiveThreshold``:
  :mod:`pero_ocr_tpu_torch.utils.threshold`;
- ``fastNlMeansDenoising``: :mod:`pero_ocr_tpu_torch.utils.denoise`,
  the port's host C++ (``csrc/nlmeans.cpp``) or its numpy twin, by
  :func:`~pero_ocr_tpu_torch.utils.native.use_native` (the C++ on CUDA);
- ``morphologyEx(MORPH_CLOSE)``, ``distanceTransform`` and
  ``connectedComponents``: :mod:`pero_ocr_tpu_torch.utils.imgproc`;
- ``findContours`` and ``contourArea``: ``geometry._largest_external_contour``;
  ``approxPolyDP`` and ``convexHull``: ``geometry.simplify_polygon`` and
  ``geometry.convex_hull``.

The stage times each step under ``simple_regions/...``.
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy import ndimage

from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.utils import denoise, imgproc, native, threshold
from pero_ocr_tpu_torch.utils.resize import resize_linear_u8
from pero_ocr_tpu_torch.utils.timing import stage_timer


class SimpleThresholdRegion:
    """``[LAYOUT_PARSER_n] METHOD = REGION_SIMPLE_THRESHOLD``.  Like the
    JAX stage it reads no key of its section.  ``native``: the
    denoiser's route (None follows ``device``: the C++ on CUDA, the
    numpy twin on the CPU)."""

    def __init__(self, config=None, device=None, config_path: str = ""):
        self.device = device
        self.native = None

    def process_page(self, img: np.ndarray, page_layout: PageLayout) -> PageLayout:
        polygons = self._compute_layout(img, native=native.use_native(self.native, self.device))
        page_layout.regions = [RegionLayout(f"r-{idx}", polygon)
                               for idx, polygon in enumerate(polygons)]
        return page_layout

    @staticmethod
    def _compute_layout(
        img: np.ndarray,
        downscale: int = 4,
        open_kernel_size: int = 28,
        poly_simplify_tolerance: int = 20,
        denoising_strength: int = 20,
        border_dist: int = 45,
        threshold_block_size: int = 100,
        threshold_mean_subtract: int = 80,
        precise_envelope: bool = True,
        min_point_per_component: int = 100,
        native: bool = True,
    ) -> List[np.ndarray]:
        """Region polygons as int32 (N, 2) x, y arrays in the page's
        coordinates, in the order of their components' labels."""
        with stage_timer("simple_regions/prepare"):
            img = TorchPagePipeline._gray(np.asarray(img))
            img = resize_linear_u8(img, downscale)
            img = threshold.normalize_minmax_u8(img)
            # Pad with the (document-background) border median.
            border_vals = np.concatenate([img[0, :], img[-1, :], img[:, 0], img[:, -1]])
            median_val = float(max(np.median(border_vals), 100))
            h, w = img.shape
            pad_y, pad_x = h // 10, w // 10
            img = threshold.pad_constant_u8(img, pad_y, pad_y, pad_x, pad_x, median_val)

        with stage_timer("simple_regions/denoise"):
            strength = denoising_strength // downscale
            img = denoise.nl_means(img, strength) if native else denoise.nl_means_plain(
                img, strength)

        with stage_timer("simple_regions/threshold"):
            block = threshold_block_size // downscale
            if block % 2 == 0:
                block += 1
            img = 255 - threshold.adaptive_threshold_gaussian(img, block, threshold_mean_subtract)
            k = max(open_kernel_size // downscale, 1)
            closed = imgproc.close_u8(img, k)
            mask = imgproc.near_ink_mask(closed, border_dist // downscale)

        with stage_timer("simple_regions/components"):
            num, labels = imgproc.connected_components_cv(mask)
            sizes = np.bincount(labels.ravel(), minlength=num)
            boxes = ndimage.find_objects(labels)

        regions: List[np.ndarray] = []
        min_points = min_point_per_component // downscale
        with stage_timer("simple_regions/polygons"):
            for label in range(1, num):
                if sizes[label] < min_points:
                    continue
                box = boxes[label - 1]
                component = labels[box] == label
                points = geometry._largest_external_contour(component)
                if points is None or len(points) < 3:
                    continue
                points = points + np.asarray([box[1].start, box[0].start], np.float64)
                if precise_envelope:
                    poly = geometry.simplify_polygon(points, poly_simplify_tolerance // downscale)
                else:
                    poly = geometry.convex_hull(points)
                # Undo padding and downscale.
                poly = (poly - np.asarray([pad_x, pad_y])) * downscale
                regions.append(poly.astype(np.int32))
        return regions
