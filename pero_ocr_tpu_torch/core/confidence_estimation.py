"""Character confidences of a line from its logits (port of
``get_line_confidence`` in pero_ocr_tpu/core/confidence_estimation.py).

CTC logits: the margin confidence of a character is its aligned label's
probability less the best competing symbol's in a window around its
frame.  A transformer's logits (one output frame per label) give each
character its label's probability at its own frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pero_ocr_tpu_torch.core.force_alignment import align_text


def get_line_confidence(
    line,
    labels: np.ndarray,
    aligned_letters: Optional[np.ndarray] = None,
    log_probs: Optional[np.ndarray] = None,
    native: Optional[bool] = None,
) -> np.ndarray:
    """Per-character confidence of a line: the margin confidence of CTC
    logits, the label probability of a transformer's.  ``native``: the
    forced alignment's route when ``aligned_letters`` is not given
    (:func:`~pero_ocr_tpu_torch.core.force_alignment.force_align`)."""
    if line.logits.shape[0] == len(labels):
        # One output frame per label: an autoregressive model's logits.
        return get_line_confidence_transformer(line, labels)

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


def get_line_confidence_transformer(line, labels: np.ndarray) -> np.ndarray:
    """Each label's probability at its own frame."""
    probs = np.exp(line.get_full_logprobs())
    return probs[np.arange(len(labels)), labels]
