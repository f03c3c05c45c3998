"""Greedy CTC decoding and batched forced alignment on the device (port
of pero_ocr_tpu/ops/ctc.py).

Blank is the last class.  Labels come back left-packed and -1 padded,
so the host only maps short label rows to strings.  The batched Viterbi
alignment is the JAX package's ``lax.scan`` as a loop of torch ops over
the frames, carrying a (B, S) cost plane for every line of a batch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from pero_ocr_tpu_torch import resolve_device

NEG_INF = -1e30


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


def viterbi_align_batch(
    logprobs: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    frame_lengths: torch.Tensor,
):
    """Batched CTC Viterbi alignment on ``logprobs``' device.

    logprobs (B, T, C) log-probabilities, blank = C-1; labels (B, L)
    padded label ids; label_lengths and frame_lengths (B,).  Returns
    (state_path (B, T) indices into the blank-interleaved chain of 2L+1
    states, whose frames past frame_lengths hold the final state;
    char_path (B, T), the label index a frame or -1 for a blank; valid
    (B,) bool, False where no alignment exists).  Ties go as in the JAX
    package: a step takes the first best of (stay, advance, skip), the
    final state the last blank on equal cost."""
    logprobs = logprobs.float()
    dev = logprobs.device
    b, t, c = logprobs.shape
    labels = labels.to(dev, torch.int64)
    label_lengths = label_lengths.to(dev, torch.int64)
    frame_lengths = frame_lengths.to(dev, torch.int64)
    l = labels.shape[1]
    s = 2 * l + 1
    blank = c - 1

    state_ids = torch.arange(s, device=dev)
    is_label_state = (state_ids % 2) == 1
    label_idx = ((state_ids - 1) // 2).clamp(0, max(l - 1, 0))
    if l > 0:
        gathered = torch.gather(labels, 1, label_idx[None, :].expand(b, s))
    else:
        gathered = labels.new_full((b, s), blank)
    state_symbols = torch.where(is_label_state[None, :], gathered, blank)  # (B, S)
    prev_sym = torch.roll(state_symbols, 2, dims=1)
    skip_ok = is_label_state[None, :] & (state_ids[None, :] >= 3) & (state_symbols != prev_sym)
    n_states = 2 * label_lengths + 1
    state_valid = state_ids[None, :] < n_states[:, None]

    emissions = torch.gather(logprobs, 2, state_symbols[:, None, :].expand(b, t, s))  # (B, T, S)

    neg = torch.full((b, s), NEG_INF, device=dev)
    cost = neg.clone()
    cost[:, 0] = emissions[:, 0, 0]
    if l > 0:
        cost[:, 1] = emissions[:, 0, 1]
    cost = torch.where(state_valid, cost, neg)

    neg2 = torch.full((b, 2), NEG_INF, device=dev)
    deltas = torch.zeros((t, b, s), dtype=torch.int8, device=dev)
    active_all = torch.arange(t, device=dev)[:, None] < frame_lengths[None, :]  # (T, B)
    for ti in range(1, t):
        advance = torch.cat([neg2[:, :1], cost[:, :-1]], dim=1)
        skip = torch.where(skip_ok, torch.cat([neg2, cost[:, :-2]], dim=1), neg)
        # argmax over (stay, advance, skip), the first maximum winning.
        delta = (advance > cost).long()
        best = torch.maximum(cost, advance)
        delta = torch.where(skip > best, 2, delta)
        best = torch.maximum(best, skip)
        new_cost = torch.where(state_valid, best + emissions[:, ti], neg)
        active = active_all[ti][:, None]
        cost = torch.where(active, new_cost, cost)
        deltas[ti] = torch.where(active, delta, 0).to(torch.int8)

    last_blank = n_states - 1
    last_label = (n_states - 2).clamp(min=0)
    cost_blank = torch.gather(cost, 1, last_blank[:, None])[:, 0]
    cost_label = torch.gather(cost, 1, last_label[:, None])[:, 0]
    state = torch.where(cost_blank >= cost_label, last_blank, last_label)
    valid = torch.maximum(cost_blank, cost_label) > NEG_INF / 2

    # Backtrack: frames past frame_lengths keep the final state.
    states = torch.empty((t, b), dtype=torch.int64, device=dev)
    for ti in range(t - 1, -1, -1):
        states[ti] = state
        d = torch.gather(deltas[ti], 1, state[:, None])[:, 0].long()
        state = torch.where(active_all[ti], state - d, state)
    state_path = states.T.contiguous()
    char_path = torch.where(state_path % 2 == 1, (state_path - 1) // 2, -1)
    return state_path, char_path, valid


def align_text_batch(
    logprobs,
    labels,
    label_lengths,
    frame_lengths,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batched counterpart of ``core.force_alignment.align_text``: the
    best frame a character (the highest overall log-prob among its
    Viterbi frames, the first on a tie), on ``device`` (CUDA unless the
    caller passes "cpu").

    Returns (char_positions (B, L) int32 padded with -1, valid (B,)
    bool) as numpy arrays."""
    dev = resolve_device(device)
    lp = torch.as_tensor(np.asarray(logprobs, dtype=np.float32)).to(dev)
    labels = torch.as_tensor(np.asarray(labels, dtype=np.int64)).to(dev)
    label_lengths = torch.as_tensor(np.asarray(label_lengths, dtype=np.int64)).to(dev)
    frame_lengths = torch.as_tensor(np.asarray(frame_lengths, dtype=np.int64)).to(dev)
    _, char_path, valid = viterbi_align_batch(lp, labels, label_lengths, frame_lengths)
    b, t, _ = lp.shape
    l = labels.shape[1]
    max_probs = lp.max(dim=-1).values  # (B, T)
    frames = torch.arange(t, device=dev)
    counted = ((frames[None, :] < frame_lengths[:, None]) & (char_path >= 0)
               & valid[:, None])
    # Column l is a spare that takes the frames of no character.
    slot = torch.where(counted, char_path, l)
    best = torch.full((b, l + 1), float("-inf"), device=dev).scatter_reduce(
        1, slot, max_probs, "amax")
    hit = counted & (max_probs == torch.gather(best, 1, slot))
    first = torch.full((b, l + 1), t, dtype=torch.int64, device=dev).scatter_reduce(
        1, slot, torch.where(hit, frames[None, :].expand(b, t), t), "amin")[:, :l]
    in_label = torch.arange(l, device=dev)[None, :] < label_lengths[:, None]
    out = torch.where((first < t) & in_label, first, -1)
    return out.int().cpu().numpy(), valid.cpu().numpy()
