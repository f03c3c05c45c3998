"""CNN layout engine (port of pero_ocr_tpu/layout_engines/cnn_engine.py).

Only the device-side map post-processing is ported so far; the
paragraph clusterer and the region polygons are host code that the
next slice ports.
"""

from __future__ import annotations

import torch

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
