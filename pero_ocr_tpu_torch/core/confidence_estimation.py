"""Character confidences of a line from its aligned CTC logits (port of
``get_line_confidence`` in pero_ocr_tpu/core/confidence_estimation.py).

The margin confidence of a character is its aligned label's probability
less the best competing symbol's in a window around its frame.  The
transformer form (one output frame per label) waits for the
transformer recognizers, ROADMAP item 11.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pero_ocr_tpu_torch import TRANSFORMERS, not_ported
from pero_ocr_tpu_torch.core.force_alignment import align_text


def get_line_confidence(
    line,
    labels: np.ndarray,
    aligned_letters: Optional[np.ndarray] = None,
    log_probs: Optional[np.ndarray] = None,
    native: Optional[bool] = None,
) -> np.ndarray:
    """Per-character margin confidence of a CTC line.  ``native``: the
    forced alignment's route when ``aligned_letters`` is not given
    (:func:`~pero_ocr_tpu_torch.core.force_alignment.force_align`)."""
    if line.logits.shape[0] == len(labels):
        # One output frame per label: an autoregressive model's logits.
        raise not_ported("the confidence of transformer logits", TRANSFORMERS)

    if log_probs is None:
        log_probs = line.get_full_logprobs()
    if aligned_letters is None:
        aligned_letters = align_text(-log_probs, labels, log_probs.shape[1] - 1, native=native)

    alignment = np.concatenate([aligned_letters, [1000]])
    probs = np.exp(log_probs)

    confidences = np.zeros(len(labels))
    last_border = 0
    for i, label in enumerate(labels):
        label_prob = probs[alignment[i], label]
        next_border = (alignment[i] + 1 + alignment[i + 1]) // 2
        window = np.copy(probs[last_border:next_border])
        window[:, label] = 0
        if i > 0:
            window[:, labels[i - 1]] = 0
        if i + 1 < len(labels):
            window[:, labels[i + 1]] = 0
        other_prob = window[:, :-1].max() if window.size else 0.0
        confidences[i] = max(0.0, label_prob - other_prob)
        last_border = next_border
    return confidences
