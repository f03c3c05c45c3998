"""Edit distance of two symbol sequences (the part of
pero_ocr_tpu/sequence_alignment.py that the line OCR's chunk merge
needs: ``levenshtein_distance`` with unit costs).

The symbols, of any hashable kind, map to int32 ids in order of first
appearance; the distance is then the port's C++ (``levenshtein_i32``)
or its numpy twin, one vectorized DP row a source symbol with the
insertions propagated by a running minimum (the JAX package's Python
path).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from pero_ocr_tpu_torch.utils import native as native_lib


def symbols_to_ids(source: Sequence, target: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Both sequences as int32 ids of one table, numbered in order of
    first appearance."""
    table: dict = {}
    src = [table.setdefault(s, len(table)) for s in source]
    tgt = [table.setdefault(s, len(table)) for s in target]
    return np.asarray(src, np.int32), np.asarray(tgt, np.int32)


def levenshtein_ids(source: np.ndarray, target: np.ndarray) -> int:
    """The numpy twin of ``levenshtein_i32``: unit-cost edit distance of
    two id sequences."""
    dist = np.arange(len(target) + 1, dtype=np.int64)
    j = np.arange(len(target) + 1)
    for s in source:
        new = dist + 1
        new[1:] = np.minimum(new[1:], dist[:-1] + (target != s))
        # Insertions: new[j] = min over k <= j of new[k] + (j - k).
        dist = np.minimum.accumulate(new - j) + j
    return int(dist[-1])


def levenshtein_distance(source: Sequence, target: Sequence, native: bool = False) -> int:
    """Unit-cost edit distance of two symbol sequences; ``native``: the
    C++ route (else numpy)."""
    src, tgt = symbols_to_ids(source, target)
    if native:
        return native_lib.native_levenshtein(src, tgt)
    return levenshtein_ids(src, tgt)
