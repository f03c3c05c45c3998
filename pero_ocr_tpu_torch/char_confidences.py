"""Greedy CTC collapse with per-character mean max-probabilities (port
of pero_ocr_tpu/char_confidences.py)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def greedy_filtration(line_probs: np.ndarray, chars) -> Tuple[str, List[float]]:
    """Collapse (T, C) per-frame probabilities, blank the last class,
    into (text, each character's mean max-probability)."""
    blank = line_probs.shape[1] - 1
    best = np.argmax(line_probs, axis=1)
    best_prob = np.max(line_probs, axis=1)

    text = ""
    probs: List[List[float]] = []
    last_char = None
    for sym, prob in zip(best, best_prob):
        if sym != blank:
            if last_char != chars[sym]:
                text += chars[sym]
                probs.append([prob])
                last_char = chars[sym]
            elif probs:
                probs[-1].append(prob)
        else:
            last_char = None

    return text, [float(np.mean(p)) for p in probs]
