"""CTC decoders: greedy and prefix beam search with optional char-LM
fusion (a host numpy copy of pero_ocr_tpu/decoding/decoders.py).

The same log-space Pb/Pnb recurrences, per-frame relevant-character
pruning (logit > -10), prefix joining mass-merge, LM fusion with
``lm_scale`` and ``insertion_bonus``, optional EOS scoring and
cross-line hidden-state carry.  Prefixes are tuples indexed by a dict,
so prefix joining is O(K) per frame, and the beam state lives in one
dataclass.

This host decoder is the semantic reference for the batched beam search
on the device in :mod:`pero_ocr_tpu_torch.decoding.tpu_decoder`.
"""

from __future__ import annotations

import dataclasses
from typing import Final, List, Optional, Tuple

import numpy as np

from pero_ocr_tpu_torch.decoding.bag_of_hypotheses import BagOfHypotheses
from pero_ocr_tpu_torch.decoding.multisort import top_k

BLANK_SYMBOL: Final = "<BLANK>"

NEG_INF = -np.inf


def assert_letters_valid(letters, blank_symbol):
    seen = set()
    duplicates = [x for x in letters if x in seen or seen.add(x)]
    if duplicates:
        raise ValueError(f"Letters contain these duplicit elements: {duplicates}")
    blank_ind = letters.index(blank_symbol)
    if blank_ind != len(letters) - 1:
        raise ValueError(
            f"Expected {BLANK_SYMBOL} as the last of letters, it's instead "
            f"at position {blank_ind}"
        )


def assert_beam_size_valid(k):
    if not isinstance(k, int):
        raise TypeError(
            f"Beam size 'k' has to be int, got {type(k)} instead (value: {k})."
        )
    if k < 1:
        raise ValueError(f"Beam size 'k' has to be positive, got {k} instead.")


def logprobs_max_deviation(log_probs: np.ndarray) -> float:
    sums = np.exp(log_probs).sum(axis=1)
    return float(np.abs(sums - 1).max())


def select_relevant_logits(logits: np.ndarray):
    """Default per-frame pruning: characters with logit > -10."""
    return np.nonzero(logits > -10)


class GreedyDecoder:
    """Argmax + collapse + blank-strip."""

    def __init__(self, letters, symbol_separator=""):
        assert_letters_valid(letters, BLANK_SYMBOL)
        self._letters = letters
        self._blank_ind = letters.index(BLANK_SYMBOL)
        self.symbol_separator = symbol_separator

    def __call__(self, logits, max_unnormalization=1e-5) -> BagOfHypotheses:
        if logprobs_max_deviation(logits) > max_unnormalization:
            raise ValueError("Expected properly normalized logits")

        best = logits.argmax(axis=1)
        keep = np.concatenate([[True], best[1:] != best[:-1]])
        collapsed = best[keep]
        decoded = self.symbol_separator.join(
            self._letters[i] for i in collapsed if i != self._blank_ind
        )

        from scipy.special import logsumexp

        bag = BagOfHypotheses()
        bag.add(decoded, logsumexp(logits.max(axis=1)))
        return bag


@dataclasses.dataclass
class _Beam:
    """State of the beam between frames: K parallel prefixes."""

    prefixes: List[Tuple[int, ...]]
    p_blank: np.ndarray       # (K,) log P(prefix, ending in blank)
    p_nonblank: np.ndarray    # (K,) log P(prefix, ending in its last char)
    p_lm: Optional[np.ndarray]  # (K,) LM log-score of the prefix
    lm_state: Optional[object]  # batched LM hidden state, one row per prefix
    lm_preds: Optional[np.ndarray]  # (K, V) next-char LM log-probs

    @property
    def last_chars(self) -> np.ndarray:
        return np.asarray(
            [p[-1] if p else 0 for p in self.prefixes], dtype=np.int32
        )


class CTCPrefixLogRawNumpyDecoder:
    """Vectorized-numpy CTC prefix beam search (host path)."""

    def __init__(
        self,
        letters,
        k,
        lm=None,
        lm_scale: float = 1.0,
        insertion_bonus: float = 0.0,
        relevant_logits_selector=select_relevant_logits,
        symbol_separator: str = "",
    ):
        assert_letters_valid(letters, BLANK_SYMBOL)
        assert_beam_size_valid(k)
        self._letters = letters
        self._k = k
        self._blank_ind = letters.index(BLANK_SYMBOL)
        self._lm = lm
        self._lm_scale = lm_scale
        self._insertion_bonus = insertion_bonus
        self.select_relevant_logits = relevant_logits_selector
        self.symbol_separator = symbol_separator

    # ------------------------------------------------------------------
    def _initial_beam(self, init_h) -> _Beam:
        if self._lm:
            h = self._lm.initial_h(1) if init_h is None else init_h
            lm_preds = self._lm.log_probs(h)
            p_lm = np.asarray([0.0])
        else:
            h, lm_preds, p_lm = None, None, None
        return _Beam(
            prefixes=[()],
            p_blank=np.asarray([0.0]),
            p_nonblank=np.asarray([NEG_INF]),
            p_lm=p_lm,
            lm_state=h,
            lm_preds=lm_preds,
        )

    def _blank_only_step(self, beam: _Beam, p_blank_frame: float) -> None:
        """No relevant characters this frame: fold all mass into blank."""
        beam.p_blank = np.logaddexp(beam.p_blank, beam.p_nonblank) + p_blank_frame
        beam.p_nonblank = np.full_like(beam.p_nonblank, NEG_INF)

    def _extension_scores(
        self, beam: _Beam, frame: np.ndarray, sel: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Build the (K, n_sel + 1) score tables.

        Columns 0..n_sel-1 extend each prefix with the selected character;
        the final column keeps the prefix unchanged.  Returns
        (pnb_table, pb_stay): the non-blank mass table and the blank mass of
        the unchanged prefixes."""
        k = len(beam.prefixes)
        n_sel = len(sel)
        pc_sel = frame[sel]  # (n_sel,)
        p_blank_frame = frame[-1]

        last = beam.last_chars
        # Position of each prefix's last char within `sel`, -1 if unselected.
        sel_pos = np.full(len(self._letters), -1, dtype=np.int64)
        sel_pos[sel] = np.arange(n_sel)
        last_sel = sel_pos[last]

        # New-prefix mass: extend from blank (always), or from non-blank
        # (only when the extension differs from the prefix's last char).
        from_blank = beam.p_blank[:, None] + pc_sel[None, :]
        switching = beam.p_nonblank[:, None] + pc_sel[None, :]
        rows = np.arange(k)
        has_last = last_sel >= 0
        switching[rows[has_last], last_sel[has_last]] = NEG_INF
        # Prefixes that are empty can't "switch" (no last char) - but their
        # p_nonblank is -inf anyway, so no masking needed beyond the above.
        extend = np.logaddexp(from_blank, switching)

        # Unchanged-prefix non-blank mass: the last char repeats.  When the
        # last char wasn't selected this frame its repeat mass vanishes.
        with np.errstate(invalid="ignore"):
            continued = np.where(
                has_last,
                beam.p_nonblank + pc_sel[np.clip(last_sel, 0, None)],
                NEG_INF,
            )

        pnb_table = np.concatenate([extend, continued[:, None]], axis=1)

        # Unchanged-prefix blank mass.
        pb_stay = np.logaddexp(beam.p_blank, beam.p_nonblank) + p_blank_frame
        return pnb_table, pb_stay

    def _join_prefixes(
        self, beam: _Beam, pnb_table: np.ndarray, sel: np.ndarray
    ) -> None:
        """Merge duplicate outcomes: prefix p staying (repeating its last
        char) produces the same string as parent p[:-1] extending by that
        char.  Mass is summed into p's stay column; the parent's extension
        cell is voided."""
        index = {p: i for i, p in enumerate(beam.prefixes)}
        sel_pos = {c: j for j, c in enumerate(sel)}
        for i, prefix in enumerate(beam.prefixes):
            if not prefix:
                continue
            parent = index.get(prefix[:-1])
            if parent is None:
                continue
            col = sel_pos.get(prefix[-1])
            if col is None:
                continue
            merged = np.logaddexp(pnb_table[i, -1], pnb_table[parent, col])
            pnb_table[i, -1] = merged
            pnb_table[parent, col] = NEG_INF

    def _lm_table(self, beam: _Beam, sel: np.ndarray) -> np.ndarray:
        """(K, n_sel + 1) LM scores matching the extension table."""
        ext = (
            beam.p_lm[:, None]
            + beam.lm_preds[:, sel]
            + self._insertion_bonus
        )
        return np.concatenate([ext, beam.p_lm[:, None]], axis=1)

    def _advance_lm(
        self, beam: _Beam, rows: np.ndarray, cols: np.ndarray, sel: np.ndarray
    ) -> Tuple[object, np.ndarray]:
        """Gather LM state for the surviving beam; advance it for entries
        that extended their prefix."""
        new_state = beam.lm_state[rows]
        new_preds = beam.lm_preds[rows].copy()
        extended = cols < len(sel)
        if extended.any():
            idx = np.nonzero(extended)[0]
            chars = sel[cols[idx]]
            advanced = self._lm.advance_h0(chars, beam.lm_state[rows[idx]])
            new_preds[idx] = self._lm.log_probs(advanced)
            new_state[idx] = advanced
        return new_state, new_preds

    def _step(self, beam: _Beam, frame: np.ndarray) -> _Beam:
        sel = self.select_relevant_logits(frame[:-1])[0]
        if sel.shape[0] == 0:
            self._blank_only_step(beam, frame[-1])
            return beam

        pnb_table, pb_stay = self._extension_scores(beam, frame, sel)
        self._join_prefixes(beam, pnb_table, sel)

        visual = pnb_table.copy()
        visual[:, -1] = np.logaddexp(visual[:, -1], pb_stay)

        if self._lm:
            lm_table = self._lm_table(beam, sel)
            total = visual + lm_table * self._lm_scale
        else:
            lm_table = None
            total = visual

        k_eff = int(min(self._k, np.sum(np.isfinite(total))))
        if k_eff < 1:
            k_eff = 1
        rows, cols = top_k(total, k=k_eff, reverse=True)

        stay_col = total.shape[1] - 1
        new_prefixes = []
        for r, c in zip(rows, cols):
            if c == stay_col:
                new_prefixes.append(beam.prefixes[r])
            else:
                new_prefixes.append(beam.prefixes[r] + (int(sel[c]),))

        new_pb = np.where(cols == stay_col, pb_stay[rows], NEG_INF)
        new_pnb = pnb_table[rows, cols]

        if self._lm:
            new_plm = lm_table[rows, cols]
            new_state, new_preds = self._advance_lm(beam, rows, cols, sel)
        else:
            new_plm, new_state, new_preds = None, None, None

        return _Beam(
            prefixes=new_prefixes,
            p_blank=new_pb,
            p_nonblank=new_pnb,
            p_lm=new_plm,
            lm_state=new_state,
            lm_preds=new_preds,
        )

    # ------------------------------------------------------------------
    def __call__(
        self,
        logits: np.ndarray,
        model_eos: bool = False,
        max_unnormalization: float = 1e-5,
        return_h: bool = False,
        init_h=None,
    ):
        if logprobs_max_deviation(logits) > max_unnormalization:
            raise ValueError("Expected properly normalized logits")

        beam = self._initial_beam(init_h)
        for frame in logits:
            beam = self._step(beam, frame)

        p_lm = beam.p_lm
        if model_eos:
            p_lm = p_lm + self._lm.eos_scores(beam.lm_state)

        p_total = np.logaddexp(beam.p_blank, beam.p_nonblank)

        bag = BagOfHypotheses(lm_weight=self._lm_scale)
        for i, prefix in enumerate(beam.prefixes):
            transcript = self.symbol_separator.join(
                self._letters[c] for c in prefix
            )
            bag.add(transcript, p_total[i], p_lm[i] if p_lm is not None else 0)
        bag.sort()

        if return_h:
            best = int(np.argmax(
                p_total + (p_lm * self._lm_scale if p_lm is not None else 0)
            ))
            return bag, beam.lm_state[[best]]
        return bag
