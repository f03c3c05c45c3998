"""Greedy CTC decoding on the device (port of pero_ocr_tpu/ops/ctc.py:26-106).

Blank is the last class.  Labels come back left-packed and -1 padded,
so the host only maps short label rows to strings.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def _argmax_runs(logits: torch.Tensor, valid_frames: torch.Tensor):
    b, t, _ = logits.shape
    best = logits.argmax(dim=-1)  # first maximum, as jnp.argmax
    prev = torch.cat([best.new_full((b, 1), -1), best[:, :-1]], dim=1)
    valid = torch.arange(t, device=logits.device)[None, :] < valid_frames[:, None]
    return best, prev, valid


def greedy_ctc_labels(logits: torch.Tensor, valid_frames: torch.Tensor):
    """logits (B, T, C), valid_frames (B,) -> (labels (B, T) int32
    left-packed and -1 padded, lengths (B,) int32).  A frame emits its
    argmax when it is valid, not blank and differs from the previous
    frame's argmax."""
    b, t, c = logits.shape
    best, prev, valid = _argmax_runs(logits, valid_frames)
    emit = (best != c - 1) & (best != prev) & valid
    # Stable left-pack: emitted labels keep their order; every other
    # frame writes to a spare column t that is dropped.
    slot = torch.where(emit, torch.cumsum(emit, dim=1) - 1, t)
    packed = best.new_full((b, t + 1), -1)
    packed.scatter_(1, slot, torch.where(emit, best, -1))
    return packed[:, :t].int(), emit.sum(dim=1).int()


def greedy_worst_run_confidence(
    logits: torch.Tensor, valid_frames: torch.Tensor
) -> torch.Tensor:
    """(B,) float32 line confidences: the runs of equal argmax ids
    (blank runs included) each score their best valid frame's
    probability; the line scores the worst run.  A line with no valid
    frame scores 1.0."""
    b, t, _ = logits.shape
    best_lp = torch.log_softmax(logits.float(), dim=-1).max(dim=-1).values
    best, prev, valid = _argmax_runs(logits, valid_frames)
    run_id = torch.cumsum(best != prev, dim=1) - 1
    neg_inf = torch.full((b, t), float("-inf"), device=logits.device)
    seg_max = neg_inf.scatter_reduce(
        1, run_id, torch.where(valid, best_lp, float("-inf")), "amax"
    )
    seg_seen = torch.zeros((b, t), dtype=torch.int32, device=logits.device)
    seg_seen = seg_seen.scatter_reduce(1, run_id, valid.int(), "amax") > 0
    worst = torch.where(seg_seen, seg_max, float("inf")).min(dim=1).values
    return torch.where(torch.isfinite(worst), torch.exp(worst), 1.0).float()


def labels_to_strings(
    packed: np.ndarray, lengths: np.ndarray, characters: List[str]
) -> List[str]:
    """Host-side: map packed label rows to strings."""
    chars = np.asarray(characters, dtype=object)
    return ["".join(chars[row[: int(n)]]) for row, n in zip(packed, lengths)]
