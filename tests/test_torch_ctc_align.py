"""Parity of the port's batched CTC forced alignment
(``ops/ctc.py`` ``viterbi_align_batch`` and ``align_text_batch``) with
the JAX package's on the CPU.

- The three cases of the JAX package's ``TestBatchedViterbi``: the path
  cost equals the host Viterbi's within 1e-3 (its own tolerance), an
  impossible alignment is flagged, and the toy line's positions.
- A numpy-seeded batch with ``frame_lengths < T`` and repeated labels:
  state paths, char paths and ``valid`` equal to the JAX function's
  where the JAX path's cost has no rival within 1e-5; a line whose paths
  differ must be such a tie, and ties are counted apart (none are
  expected: both sides add the same float32 numbers).
- Integer log-probabilities, where ties are everywhere: both tie rules
  (first of stay, advance, skip; the last blank on equal final cost)
  give equal paths.
- ``align_text_batch``: positions and ``valid`` equal.
"""

import numpy as np
import pytest
import torch

from pero_ocr_tpu.core.force_alignment import force_align
from pero_ocr_tpu.ops import ctc as jax_ctc
from pero_ocr_tpu_torch.ops import ctc

COST_TOL = 1e-3  # the JAX test's own
TIE_TOL = 1e-5


def _port_paths(logprobs, labels, label_lengths, frame_lengths):
    out = ctc.viterbi_align_batch(torch.as_tensor(logprobs), torch.as_tensor(labels),
                                  torch.as_tensor(label_lengths),
                                  torch.as_tensor(frame_lengths))
    return [o.numpy() for o in out]


def _jax_paths(logprobs, labels, label_lengths, frame_lengths):
    out = jax_ctc.viterbi_align_batch(logprobs, labels, label_lengths, frame_lengths)
    return [np.asarray(o) for o in out]


def _random_batch(seed, b=7, t=40, c=6, lmax=8, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        logprobs = -rng.integers(0, 3, size=(b, t, c)).astype(np.float32)
    else:
        logprobs = np.log(rng.dirichlet(np.ones(c), size=(b, t))).astype(np.float32)
    labels = np.zeros((b, lmax), np.int32)
    label_lengths = rng.integers(1, lmax + 1, size=b).astype(np.int32)
    frame_lengths = rng.integers(2 * lmax + 2, t, size=b).astype(np.int32)
    for i in range(b):
        n = int(label_lengths[i])
        labels[i, :n] = rng.integers(0, 2, size=n)  # two symbols: many repeats
    return logprobs, labels, label_lengths, frame_lengths


def _path_cost(logprobs, labels, n_labels, n_frames, state_path):
    states = np.full(2 * n_labels + 1, logprobs.shape[-1] - 1)
    states[1::2] = labels[:n_labels]
    syms = states[state_path[:n_frames]]
    return float(logprobs[np.arange(n_frames), syms].astype(np.float64).sum())


def test_matches_host_viterbi():
    rng = np.random.default_rng(7)
    b, t, c, lmax = 5, 30, 8, 6
    blank = c - 1
    logprobs = np.log(rng.dirichlet(np.ones(c), size=(b, t)).astype(np.float64)
                      ).astype(np.float32)
    labels = np.zeros((b, lmax), dtype=np.int32)
    label_lengths = rng.integers(1, lmax + 1, size=b)
    frame_lengths = rng.integers(15, t + 1, size=b)
    for i in range(b):
        labels[i, :label_lengths[i]] = rng.integers(0, blank, size=label_lengths[i])
    state_path, _, valid = _port_paths(logprobs, labels, label_lengths, frame_lengths)
    jax_state, _, jax_valid = _jax_paths(logprobs, labels, label_lengths, frame_lengths)
    assert valid.tolist() == jax_valid.tolist()
    for i in range(b):
        assert valid[i]
        n, f = int(label_lengths[i]), int(frame_lengths[i])
        host_path = force_align(-logprobs[i, :f], labels[i, :n].tolist(), blank)
        host_cost = float(logprobs[i, np.arange(f), host_path].sum())
        cost = _path_cost(logprobs[i], labels[i], n, f, state_path[i])
        assert cost == pytest.approx(host_cost, abs=COST_TOL)
        assert (state_path[i] == jax_state[i]).all()


def test_impossible_alignment_flagged():
    logprobs = np.full((1, 2, 3), -1.0, np.float32)
    labels = np.array([[0, 0]], dtype=np.int32)  # 'aa' needs 3 frames
    args = (logprobs, labels, np.array([2]), np.array([2]))
    assert not _port_paths(*args)[2][0]
    assert not _jax_paths(*args)[2][0]
    pos, valid = ctc.align_text_batch(*args, device="cpu")
    assert pos.tolist() == [[-1, -1]] and not valid[0]


def test_align_text_batch_toy_line():
    lp = np.log(np.array([[[0.9, 0.05, 0.05], [0.05, 0.9, 0.05], [0.05, 0.05, 0.9]]])
                ).astype(np.float32)
    args = (lp, np.array([[0, 1]], dtype=np.int32), np.array([2]), np.array([3]))
    pos, valid = ctc.align_text_batch(*args, device="cpu")
    jax_pos, jax_valid = jax_ctc.align_text_batch(*args)
    assert valid[0] and jax_valid[0]
    assert pos[0].tolist() == [0, 1] == jax_pos[0].tolist()
    assert pos.dtype == np.int32


def _second_best_gap(logprobs, labels, n, f, state_path):
    """Smallest cost gap between the JAX path and any path that leaves
    it at one frame (a proxy for a tie in the DP): the path's frames
    are recomputed with a single state changed where that stays legal."""
    best = _path_cost(logprobs, labels, n, f, state_path)
    gap = np.inf
    for ti in range(f):
        for d in (-1, 1):
            alt = state_path.copy()
            alt[ti] += d
            ok = alt[0] in (0, 1) and alt[f - 1] in (2 * n, 2 * n - 1)
            ok &= all(0 <= alt[k + 1] - alt[k] <= 2 for k in range(f - 1))
            ok &= 0 <= alt[ti] <= 2 * n
            if ok:
                gap = min(gap, best - _path_cost(logprobs, labels, n, f, alt))
    return gap


@pytest.mark.parametrize("integer", [False, True], ids=["dirichlet", "integer_ties"])
def test_random_batch_equals_jax(integer):
    logprobs, labels, label_lengths, frame_lengths = _random_batch(3, integer=integer)
    state_path, char_path, valid = _port_paths(logprobs, labels, label_lengths,
                                               frame_lengths)
    jax_state, jax_char, jax_valid = _jax_paths(logprobs, labels, label_lengths,
                                                frame_lengths)
    assert valid.tolist() == jax_valid.tolist()
    assert state_path.dtype == np.int64 and state_path.shape == jax_state.shape
    ties = 0
    for i in range(len(labels)):
        if (state_path[i] == jax_state[i]).all():
            assert (char_path[i] == jax_char[i]).all()
            # Frames past the line's length hold the final state.
            f = int(frame_lengths[i])
            assert (state_path[i, f:] == state_path[i, f - 1]).all()
            continue
        n, f = int(label_lengths[i]), int(frame_lengths[i])
        assert _second_best_gap(logprobs[i], labels[i], n, f, jax_state[i]) <= TIE_TOL
        ties += 1
    assert ties == 0, f"{ties} lines differ at a tie"
    pos, pvalid = ctc.align_text_batch(logprobs, labels, label_lengths, frame_lengths,
                                       device="cpu")
    jax_pos, jax_pvalid = jax_ctc.align_text_batch(logprobs, labels, label_lengths,
                                                   frame_lengths)
    assert pvalid.tolist() == jax_pvalid.tolist()
    assert pos.tolist() == jax_pos.tolist()


def test_align_text_batch_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ctc.align_text_batch(np.zeros((1, 3, 3), np.float32), np.zeros((1, 1), np.int32),
                             np.array([1]), np.array([3]))
