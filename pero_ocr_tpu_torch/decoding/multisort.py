"""Top-k over a flattened score matrix (copy of
pero_ocr_tpu/decoding/multisort.py)."""

import numpy as np


def top_k(a: np.ndarray, k: int, reverse: bool = False):
    """Indices (unraveled) of the k smallest (or largest, with reverse)
    entries.  When the array has <= k entries, returns all of them."""
    flat = a.ravel()
    if len(flat) <= k:
        # All entries qualify; return them unraveled (the reference returns
        # a bare arange here, which is only correct for 1-D inputs).
        return np.unravel_index(np.arange(len(flat)), a.shape)
    if reverse:
        idx = np.argpartition(flat, len(flat) - k)[-k:]
    else:
        idx = np.argpartition(flat, k)[:k]
    return np.unravel_index(idx, a.shape)
