"""Scored hypothesis container (copy of
pero_ocr_tpu/decoding/bag_of_hypotheses.py).

Total score of a hypothesis = visual score + lm_weight * LM score; the
posterior of each hypothesis normalizes over the bag.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

from scipy.special import logsumexp


@dataclasses.dataclass
class Hypothese:
    transcript: str
    vis_sc: float
    lm_sc: Optional[float] = None


class BagOfHypotheses:
    def __init__(self, lm_weight: float = 1.0):
        self._hyps: List[Hypothese] = []
        self.lm_weight = lm_weight

    def add(self, transcript, visual_sc, lm_sc=None):
        self._hyps.append(Hypothese(transcript, visual_sc, lm_sc))

    def sort(self):
        self._hyps.sort(key=lambda hyp: hyp.vis_sc, reverse=True)

    def __iter__(self):
        return iter(self._hyps)

    def __len__(self):
        return len(self._hyps)

    def __str__(self):
        longest = max(len(h.transcript) for h in self._hyps)
        lines = []
        for i, hyp in enumerate(self._hyps):
            lm = hyp.lm_sc if hyp.lm_sc is not None else float("nan")
            lines.append(
                f"{i} {('%r' % hyp.transcript):{longest + 2}} "
                f"{hyp.vis_sc:5.1f} {lm:5.1f} "
            )
        return "\n".join(lines) + "\n"

    def total_scores(self) -> List[float]:
        if any(h.lm_sc is None for h in self._hyps):
            return [h.vis_sc for h in self._hyps]
        return [h.vis_sc + self.lm_weight * h.lm_sc for h in self._hyps]

    def posteriors(self) -> List[float]:
        totals = self.total_scores()
        norm = logsumexp(totals)
        return [s - norm for s in totals]

    def confidence(self) -> float:
        return math.exp(max(self.posteriors()))

    def transcript_confidence(self, transcript: str) -> float:
        posteriors = self.posteriors()
        for i, hyp in enumerate(self._hyps):
            if hyp.transcript == transcript:
                return math.exp(posteriors[i])
        return 0.0

    def best_hyp(self) -> str:
        return max(
            self._hyps,
            key=lambda h: h.vis_sc + (h.lm_sc if h.lm_sc is not None else 0),
        ).transcript
