"""CTC forced alignment on the host (port of
pero_ocr_tpu/core/force_alignment.py): Viterbi decoding of a
transcription against CTC log-probabilities over the blank-interleaved
state chain ``[b, s1, b, s2, ..., sL, b]``, whose only transitions are
stay, advance by one and advance by two.

Two routes: :func:`viterbi_ctc` in numpy, whose path costs are float64
sums, and the port's C++ ``viterbi_ctc_f32`` (``utils/native.py``),
whose sums are float32.  ``native`` picks one: None follows the default
device, as the host geometry does (the C++ on CUDA, so None means the
C++); False is the numpy twin.  Nothing falls back from one to the
other.  Both break exact ties alike (stay before advance before skip,
the last label before the last blank), so their paths are equal
unless two paths' costs lie within float32 rounding of each other,
where the float32 sums may settle the near-tie the other way.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from pero_ocr_tpu_torch.utils import native as native_lib

INF = np.inf


def complete_state_seq(
    non_blanks: Sequence[int], blank_symbol: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Interleave labels with blanks: returns (state_symbols,
    state_char_index), where state_char_index is -1 for blank states."""
    non_blanks = np.asarray(non_blanks)
    if np.any(non_blanks == blank_symbol):
        raise ValueError(
            f"The blank symbol {blank_symbol} is present in the non blank seq "
            f"{list(non_blanks)}"
        )
    n_states = 2 * len(non_blanks) + 1
    states = np.full(n_states, blank_symbol, dtype=int)
    states[1::2] = non_blanks
    char_index = np.full(n_states, -1, dtype=int)
    char_index[1::2] = np.arange(len(non_blanks))
    return states, char_index


def _skip_allowed(states: np.ndarray) -> np.ndarray:
    """Bool mask over states: True where the advance by two into the
    state is legal (a label state whose previous label differs)."""
    n_states = len(states)
    allowed = np.zeros(n_states, dtype=bool)
    odd = np.arange(3, n_states, 2)
    allowed[odd] = states[odd] != states[odd - 2]
    return allowed


def viterbi_ctc(neg_logprobs_states: np.ndarray, skip_ok: np.ndarray) -> np.ndarray:
    """Viterbi over the CTC chain, in numpy.

    Args:
        neg_logprobs_states: (T, S) negative log-probs gathered per state.
        skip_ok: (S,) mask of legal advance-by-2 targets.

    Returns:
        (T,) state indices of the best path.

    Raises:
        ValueError: when no path has a finite cost (T too short for the
        labels).
    """
    n_frames, n_states = neg_logprobs_states.shape
    if n_states < 2:
        raise ValueError("Need at least 2 states (one label) to align")

    cost = np.full(n_states, INF)
    cost[0] = neg_logprobs_states[0, 0]
    cost[1] = neg_logprobs_states[0, 1]

    # Backpointers store the chosen delta (0=stay, 1=advance, 2=skip).
    deltas = np.zeros((n_frames, n_states), dtype=np.int8)

    skip_penalty = np.where(skip_ok, 0.0, INF)
    for t in range(1, n_frames):
        stay = cost
        advance = np.concatenate([[INF], cost[:-1]])
        skip = np.concatenate([[INF, INF], cost[:-2]]) + skip_penalty
        stacked = np.stack([stay, advance, skip])
        choice = np.argmin(stacked, axis=0)
        cost = stacked[choice, np.arange(n_states)] + neg_logprobs_states[t]
        deltas[t] = choice

    final = cost.copy()
    final[: n_states - 2] = INF  # must end in the last blank or the last label
    if not np.isfinite(final.min()):
        raise ValueError(
            "It was not possible to align the states with the logits, "
            "best path has cost of np.inf"
        )

    state = int(np.argmin(final))
    path = np.empty(n_frames, dtype=int)
    path[-1] = state
    for t in range(n_frames - 1, 0, -1):
        state -= deltas[t, state]
        path[t - 1] = state
    return path


def force_align(
    neg_logprobs: np.ndarray,
    symbols_seq: Sequence[int],
    blank_symbol: int,
    return_seq_positions: bool = False,
    native: Optional[bool] = None,
) -> List[int]:
    """Force-align ``symbols_seq`` to CTC ``neg_logprobs`` of shape (T, C).

    Returns the best path's symbol per frame (blanks included), or each
    frame's character index (-1 for a blank) when
    ``return_seq_positions``.  ``native``: the C++ route (True, or None)
    or numpy (False)."""
    symbols_seq = list(symbols_seq)
    if len(symbols_seq) < 1:
        raise ValueError("Cannot construct a CTC 'HMM' from an empty string")
    states, char_index = complete_state_seq(symbols_seq, blank_symbol)
    skip_ok = _skip_allowed(states)
    gathered = np.asarray(neg_logprobs)[:, states]
    if native_lib.use_native(native, None):
        path = native_lib.native_viterbi_ctc(gathered, skip_ok)
    else:
        path = viterbi_ctc(gathered, skip_ok)
    if return_seq_positions:
        return [int(char_index[s]) for s in path]
    return [int(states[s]) for s in path]


def align_text(
    neg_logprobs: np.ndarray, transcription: np.ndarray, blank_symbol: int,
    native: Optional[bool] = None,
) -> np.ndarray:
    """Best frame per character: among the frames Viterbi assigns to
    each character, the one with the highest overall log-prob."""
    char_per_frame = np.asarray(force_align(
        neg_logprobs, transcription, blank_symbol, return_seq_positions=True, native=native))
    max_probs = (-np.asarray(neg_logprobs)).max(axis=-1)

    text_length = len(transcription)
    char_positions = np.zeros(text_length, dtype=np.int32)
    for i in range(text_length):
        frames = np.nonzero(char_per_frame == i)[0]
        char_positions[i] = frames[np.argmax(max_probs[frames])]
    return char_positions
