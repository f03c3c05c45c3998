"""Levenshtein distances, alignments and alignment paths (port of
pero_ocr_tpu/sequence_alignment.py, same functions, costs, tie-breaking
and ``empty_symbol``).

The DP runs one vectorized row a source symbol, the insertions
propagated by a running minimum (``np.minimum.accumulate`` over
``dist[j] - j * ins_cost``), which reaches the same fixpoint as a
cell-by-cell loop.  Direction codes in paths:

    0  = diagonal (substitution or match)
    1  = source-only step (deletion of a source symbol)
    -1 = target-only step (insertion)

Unit-cost distances of symbol sequences map the symbols to int32 ids
(one table, numbered in order of first appearance) and take the port's
C++ (``levenshtein_i32``; ``levenshtein_batch_i32`` for many pairs in
one call) or its numpy twin.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def levenshtein_ids_batch(seqs_a: Sequence[np.ndarray], seqs_b: Sequence[np.ndarray]
                          ) -> np.ndarray:
    """The numpy twin of ``levenshtein_batch_i32``: (N,) int32 distances
    of N pairs of id sequences."""
    return np.asarray([levenshtein_ids(np.asarray(a), np.asarray(b))
                       for a, b in zip(seqs_a, seqs_b)], np.int32).reshape(-1)


def levenshtein_batch(pairs: Sequence[Tuple[Sequence, Sequence]], native: bool = True
                      ) -> np.ndarray:
    """Unit-cost edit distances of (source, target) symbol-sequence
    pairs, in one call: (N,) int32.  The symbols of all pairs map to ids
    of one table; ``native``: the C++ ``levenshtein_batch_i32`` (else
    the numpy twin)."""
    table: dict = {}
    seqs_a = [np.asarray([table.setdefault(s, len(table)) for s in a], np.int32)
              for a, _ in pairs]
    seqs_b = [np.asarray([table.setdefault(s, len(table)) for s in b], np.int32)
              for _, b in pairs]
    if native:
        return native_lib.native_levenshtein_batch(seqs_a, seqs_b)
    return levenshtein_ids_batch(seqs_a, seqs_b)


def _row_update(dist, backtrack_row, s, target, sub_cost, ins_cost, del_cost):
    """One DP row: mutates ``backtrack_row``, returns the new row."""
    cand_sub = dist[:-1] + (target != s) * sub_cost
    new = dist + del_cost
    where_sub = cand_sub < new[1:]
    new[1:] = np.where(where_sub, cand_sub, new[1:])
    backtrack_row[1:][where_sub] = 0

    # Insertions, propagated to the fixpoint.
    j = np.arange(len(new))
    run_min = np.minimum.accumulate(new - j * ins_cost)
    improved = run_min + j * ins_cost < new
    new = np.minimum(new, run_min + j * ins_cost)
    backtrack_row[improved] = -1
    return new


def _dp(source, target, sub_cost, ins_cost, del_cost):
    target = np.array(target)
    backtrack = np.ones((len(source) + 1, len(target) + 1), dtype=np.int8)
    backtrack[0] = -1
    dist = np.arange(len(target) + 1, dtype=np.float64) * ins_cost
    for i, s in enumerate(source):
        dist = _row_update(dist, backtrack[i + 1], s, target, sub_cost, ins_cost, del_cost)
    return dist, backtrack


def levenshtein_distance(source: Sequence, target: Sequence, sub_cost=1, ins_cost=1,
                         del_cost=1, native: bool = False):
    """Edit distance of two symbol sequences.  Unit costs: an int, by
    ids (``native``: the C++ route, else numpy); other costs: the DP's
    float."""
    if sub_cost == 1 and ins_cost == 1 and del_cost == 1:
        src, tgt = symbols_to_ids(source, target)
        if native:
            return native_lib.native_levenshtein(src, tgt)
        return levenshtein_ids(src, tgt)
    dist, _ = _dp(source, target, sub_cost, ins_cost, del_cost)
    return dist[-1]


def _walk(backtrack: np.ndarray) -> List[int]:
    """The direction sequence, traced back from the bottom-right corner."""
    src_pos = backtrack.shape[0] - 1
    tar_pos = backtrack.shape[1] - 1
    path = []
    while tar_pos > 0 or src_pos > 0:
        where = int(backtrack[src_pos, tar_pos])
        if where >= 0:
            src_pos -= 1
        if where <= 0:
            tar_pos -= 1
        path.append(where)
    return list(reversed(path))


def levenshtein_alignment_path(source, target, sub_cost=1, ins_cost=1, del_cost=1,
                               empty_symbol=None):
    _, backtrack = _dp(source, target, sub_cost, ins_cost, del_cost)
    return _walk(backtrack)


def _path_to_pairs(path, source, target, empty_symbol):
    pairs = []
    si = ti = 0
    for where in path:
        s_sym = source[si] if where >= 0 else empty_symbol
        t_sym = target[ti] if where <= 0 else empty_symbol
        if where >= 0:
            si += 1
        if where <= 0:
            ti += 1
        pairs.append((s_sym, t_sym))
    return pairs


def levenshtein_alignment(source, target, sub_cost=1, ins_cost=1, del_cost=1,
                          empty_symbol=None):
    path = levenshtein_alignment_path(source, target, sub_cost, ins_cost, del_cost)
    return _path_to_pairs(path, source, target, empty_symbol)


def edit_stats_for_alignment(alig, empty_symbol=None):
    """(nphn, ncor, nins, ndel, nsub) of an alignment's pair list."""
    if len(alig) == 0:
        return 0, 0, 0, 0, 0
    alig = np.array(alig, dtype=object)
    ncor = int(np.sum(alig[:, 0] == alig[:, 1]))
    ndel = int(np.sum(alig[:, 0] == np.array(empty_symbol)))
    nphn = int(np.sum(alig[:, 1] != np.array(empty_symbol)))
    nins = len(alig) - nphn
    nsub = nphn - ncor - ndel
    return nphn, ncor, nins, ndel, nsub


# Substring variants: the shorter sequence may match anywhere inside the
# longer one; the longer one's leading and trailing symbols are free.
def _substring_dp(source, target, sub_cost, ins_cost, del_cost):
    """The DP with a free-suffix sink column; ``target`` is the shorter
    sequence."""
    target = np.array(target)
    n_cols = len(target) + 2  # +1 leading, +1 sink
    backtrack = np.ones((len(source) + 1, n_cols), dtype=np.int8)
    backtrack[0] = -1
    dist = np.full(n_cols, np.inf)
    dist[0] = 0.0  # free leading deletions of source

    for i, s in enumerate(source):
        cand_sub = dist[:-2] + (target != s) * sub_cost
        new = dist.copy()
        new[1:-1] += del_cost
        where_sub = cand_sub < new[1:-1]
        new[1:-1] = np.where(where_sub, cand_sub, new[1:-1])
        backtrack[i + 1, 1:-1][where_sub] = 0

        j = np.arange(n_cols - 1)
        run_min = np.minimum.accumulate(new[:-1] - j * ins_cost)
        improved = run_min + j * ins_cost < new[:-1]
        new[:-1] = np.minimum(new[:-1], run_min + j * ins_cost)
        backtrack[i + 1, :-1][improved] = -1

        # The sink: free deletions once the match is complete.
        if new[-1] == new[-2]:
            backtrack[i + 1, -1] = 0
        elif new[-1] > new[-2]:
            new[-1] = new[-2]
            backtrack[i + 1, -1] = -1
        dist = new
    return dist, backtrack


def levenshtein_distance_substring(source, target, sub_cost=1, ins_cost=1, del_cost=1):
    if len(target) > len(source):
        source, target = target, source
    dist, _ = _substring_dp(source, target, sub_cost, ins_cost, del_cost)
    return dist[-1]


def levenshtein_alignment_substring(source, target, sub_cost=1, ins_cost=1, del_cost=1,
                                    empty_symbol=None):
    swapped = False
    if len(target) > len(source):
        source, target = target, source
        swapped = True

    _, backtrack = _substring_dp(source, target, sub_cost, ins_cost, del_cost)

    # Where the free suffix starts: after the last row whose sink entry
    # was not a pure pass-down.
    suffix_beginning = backtrack.shape[0]
    if np.any(backtrack[:, -1] > 0):
        below = np.where(backtrack[:, -1] < 1)[0]
        suffix_beginning = (below[-1] + 1) if len(below) else backtrack.shape[0]

    trimmed = backtrack[:suffix_beginning, :-1]
    path = _walk(trimmed)
    pairs = _path_to_pairs(path, source, target, empty_symbol)
    for ch in source[suffix_beginning - 1:]:
        pairs.append((ch, empty_symbol))

    if swapped:
        pairs = [(b, a) for a, b in pairs]
    return pairs
