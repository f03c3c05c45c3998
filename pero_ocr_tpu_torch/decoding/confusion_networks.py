"""Confusion networks ("sausages") from a bag of hypotheses (copy of
pero_ocr_tpu/decoding/confusion_networks.py).

Hypotheses are folded in one at a time by Levenshtein alignment against
the running pivot (the per-slot best symbols); slot weights accumulate
exp(total score).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from pero_ocr_tpu_torch.sequence_alignment import levenshtein_alignment_path


def get_pivot(cn: List[Dict]) -> List:
    return [max(slot, key=slot.get) for slot in cn]


def add_hypothese(cn: List[Dict], transcript, score: float) -> List[Dict]:
    if not cn:
        return [{symbol: score} for symbol in transcript]

    pivot = get_pivot(cn)
    path = levenshtein_alignment_path(list(transcript), pivot)
    mean_weight = sum(sum(slot.values()) for slot in cn) / len(cn)

    cn_ptr = 0
    tr_ptr = 0
    for direction in path:
        if direction == -1:  # pivot-only: epsilon in this hypothesis
            slot = cn[cn_ptr]
            slot[None] = slot.get(None, 0.0) + score
            cn_ptr += 1
        elif direction == 0:  # aligned
            sym = transcript[tr_ptr]
            slot = cn[cn_ptr]
            slot[sym] = slot.get(sym, 0.0) + score
            tr_ptr += 1
            cn_ptr += 1
        elif direction == 1:  # hypothesis-only: new slot
            sym = transcript[tr_ptr]
            new_slot = {None: mean_weight, sym: score}
            if cn_ptr == len(cn):
                cn.append(new_slot)
            else:
                cn = cn[:cn_ptr] + [new_slot] + cn[cn_ptr:]
                cn_ptr += 1
            tr_ptr += 1
        else:
            raise RuntimeError(f"Got unexpected direction {direction}")
    return cn


def normalize_cn(cn: List[Dict]) -> List[Dict]:
    for slot in cn:
        total = sum(slot.values())
        for symbol in slot:
            slot[symbol] /= total
    return cn


def produce_cn_from_boh(boh, visual_weight=1.0, lm_weight=1.0, normalize=True):
    cn: List[Dict] = []
    for hyp in boh:
        log_prob = visual_weight * hyp.vis_sc + (
            lm_weight * hyp.lm_sc if hyp.lm_sc is not None else 0.0
        )
        cn = add_hypothese(cn, hyp.transcript, math.exp(log_prob))
    if normalize:
        cn = normalize_cn(cn)
    return cn


def best_cn_path(cn: List[Dict]):
    best = [max(slot, key=slot.get) for slot in cn]
    best = [s for s in best if s is not None]
    if all(isinstance(s, str) for s in best):
        return "".join(best)
    return best


def sorted_cn_paths(cn: List[Dict]):
    """Exhaustively enumerate all paths through the sausage, sorted by
    probability (descending)."""
    if not cn:
        return []

    paths = [("", 1.0)]
    for slot in cn:
        # Per-slot symbols in descending-probability order: the final
        # sort is stable, so this fixes the tie order of equal-probability
        # paths (the JAX package's order).
        slot_items = sorted(slot.items(), key=lambda x: x[1], reverse=True)
        new_paths = []
        for prefix, prob in paths:
            for sym, p in slot_items:
                new_paths.append(
                    (prefix + sym if sym is not None else prefix, prob * p)
                )
        paths = new_paths
    return sorted(paths, key=lambda x: x[1], reverse=True)
