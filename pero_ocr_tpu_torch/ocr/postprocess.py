"""CTC label narrowing: collapse repeated-label runs down to the single
frame with the highest logit, blanking the rest (copy of
pero_ocr_tpu/ocr/postprocess.py).

Used to tighten per-frame label sequences (e.g. alignment outputs)
before computing per-character statistics."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def find_optimal(logit: np.ndarray, positions: Sequence[int], idx: int) -> int:
    """Frame among `positions` with the highest logit for class `idx`."""
    positions = np.asarray(positions)
    return int(positions[np.argmax(np.asarray(logit)[positions, idx])])


def narrow_label(
    label: List[int],
    logit: np.ndarray,
    idx_of_last: int,
    on_one_liberal: bool = False,
) -> List[int]:
    """Replace each run of a repeated non-blank label with blanks except at
    the run's best-logit frame.

    ``idx_of_last`` is the blank id; with ``on_one_liberal`` the vacated
    frames get ``blank - 1`` instead (the liberal mode)."""
    label = list(label)
    fill = idx_of_last - 1 if on_one_liberal else idx_of_last

    run: List[int] = []
    run_char = None

    def flush():
        if not run:
            return
        best = find_optimal(logit, run, run_char)
        for frame in run:
            label[frame] = fill
        label[best] = run_char

    for i, current in enumerate(label):
        if current != run_char:
            flush()
            run.clear()
            run_char = current if current != idx_of_last else None
        if run_char is not None and current == run_char:
            run.append(i)
    flush()
    return label
