"""Region-windowed page quality score (port of
pero_ocr_tpu/core/quality.py).

Aggregates per-letter margin confidences inside an optional bounding box
with a power mean (default power 6, emphasising bad letters).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pero_ocr_tpu_torch.core import line_geometry
from pero_ocr_tpu_torch.core.confidence_estimation import get_line_confidence
from pero_ocr_tpu_torch.core.force_alignment import align_text

_FIELD_HEIGHT = 16


def page_quality(
    layout,
    x: Optional[int] = None,
    y: Optional[int] = None,
    width: Optional[int] = None,
    height: Optional[int] = None,
    power: int = 6,
    native: Optional[bool] = None,
) -> float:
    """The power mean of the letters' confidences, of the letters whose
    top-left warp-field point lies in the window when one is given; -1
    when no letter counts.  Sets each aligned line's
    ``transcription_confidence`` to its median letter confidence.
    ``native``: the forced alignment's route (the C++ for None or True,
    numpy for False)."""
    bbox_confidences = []
    for line in layout.lines_iterator():
        if not line.transcription:
            continue
        labels = line.get_labels()
        logits = line.get_dense_logits()[line.logit_coords[0]: line.logit_coords[1]]
        logprobs = line.get_full_logprobs()[line.logit_coords[0]: line.logit_coords[1]]
        blank_idx = line.logits.shape[1] - 1
        try:
            aligned = align_text(-logprobs, labels, blank_idx, native=native)
        except (ValueError, IndexError):
            continue

        field = line_geometry.warp_field(line.baseline, line.heights, _FIELD_HEIGHT, poly=2)
        frames_to_cols = field.shape[1] / max(logits.shape[0], 1)
        space_idxs = {pos for pos, c in enumerate(line.transcription) if c == " "}

        confidences = get_line_confidence(line, labels, aligned, logprobs)
        line.transcription_confidence = float(np.quantile(confidences, 0.50))

        for i, frame in enumerate(aligned):
            if i in space_idxs:
                continue
            if x is not None and y is not None and width is not None and height is not None:
                lo = max(0, int((frame - 2) * frames_to_cols))
                hi = max(lo + 1, int((frame + 2) * frames_to_cols))
                xs = field[:, lo:hi, 0]
                ys = field[:, lo:hi, 1]
                if xs.size == 0 or ys.size == 0:
                    continue
                hpos = int(np.min(xs))
                vpos = int(np.min(ys))
                if not (y <= vpos <= y + height and x <= hpos <= x + width):
                    continue
            bbox_confidences.append(confidences[i])

    if not bbox_confidences:
        return -1
    arr = np.asarray(bbox_confidences)
    return float((np.power(arr, power).sum() / len(arr)) ** (1.0 / power))
