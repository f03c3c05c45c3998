"""Arabic text shaping and bidirectional helpers (port of
pero_ocr_tpu/core/arabic.py, pure Python): the ALTO writer turns an
Arabic line's OCR label order back into its logical string with
:class:`ArabicHelper`.

The letter -> (isolated, initial, medial, final) presentation-form
tables are derived from the Unicode character database (``unicodedata``
names of the Arabic Presentation Forms blocks), and contextual shaping
implements the Arabic joining algorithm with mandatory lam-alef
ligatures.

Terminology:
- *string*: logical order, base Arabic letters (what's stored in XML).
- *visual form*: right-to-left visual order with presentation forms
  (what a line image shows left-to-right).
- *label form*: logical-order characters but with Arabic segments
  reversed — the order an OCR net reading left-to-right emits.
"""

from __future__ import annotations

import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Tuple

ISOLATED, INITIAL, MEDIAL, FINAL = 0, 1, 2, 3

_FORM_NAMES = {"ISOLATED": ISOLATED, "INITIAL": INITIAL, "MEDIAL": MEDIAL, "FINAL": FINAL}

# Combining marks transparent to joining (harakat, shadda, sukun, etc.).
_TRANSPARENT_RANGES = (
    (0x0610, 0x061A),
    (0x064B, 0x065F),
    (0x0670, 0x0670),
    (0x06D6, 0x06DC),
    (0x06DF, 0x06E4),
    (0x06E7, 0x06E8),
    (0x06EA, 0x06ED),
)

_TATWEEL = "ـ"


def _is_transparent(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _TRANSPARENT_RANGES)


@lru_cache(maxsize=1)
def _build_tables() -> Tuple[Dict[str, List[str]], Dict[str, str], Dict[str, List[str]]]:
    """Scan the Arabic Presentation Forms blocks and build:

    - forms: base letter -> [isolated, initial, medial, final] ('' if absent)
    - backward: presentation form char -> base letter
    - ligature_forms: (lam+alef string) -> [isolated, '', '', final]
    """
    forms: Dict[str, List[str]] = {}
    backward: Dict[str, str] = {}
    ligature_forms: Dict[str, List[str]] = {}

    letter_re = re.compile(r"ARABIC LETTER (.+) (ISOLATED|INITIAL|MEDIAL|FINAL) FORM$")
    ligature_re = re.compile(r"ARABIC LIGATURE (.+) (ISOLATED|FINAL) FORM$")

    for block in (range(0xFB50, 0xFC00), range(0xFE70, 0xFF00)):
        for cp in block:
            ch = chr(cp)
            try:
                name = unicodedata.name(ch)
            except ValueError:
                continue
            m = letter_re.match(name)
            if m:
                try:
                    base = unicodedata.lookup(f"ARABIC LETTER {m.group(1)}")
                except KeyError:
                    continue
                slot = _FORM_NAMES[m.group(2)]
                forms.setdefault(base, ["", "", "", ""])[slot] = ch
                backward[ch] = base
                continue
            m = ligature_re.match(name)
            if m and " WITH " in m.group(1):
                parts = m.group(1).split(" WITH ")
                try:
                    base_seq = "".join(
                        unicodedata.lookup(f"ARABIC LETTER {p}") for p in parts
                    )
                except KeyError:
                    continue
                slot = _FORM_NAMES[m.group(2)]
                entry = ligature_forms.setdefault(base_seq, ["", "", "", ""])
                entry[slot] = ch
                backward[ch] = base_seq
    return forms, backward, ligature_forms


class ArabicHelper:
    """Converts between logical strings, OCR label order and visual
    presentation forms."""

    _arabic_pattern = re.compile(
        "^([؀-ۿ]|[ݐ-ݿ]|[ﭐ-﯁]|[ﯓ-﴿]"
        "|[ﵐ-ﶏ]|[ﶒ-ﷇ]|[ﹰ-ﻼ]|[ﷰ-﷽])+$"
    )

    def __init__(self):
        forms, backward, ligature_forms = _build_tables()
        self.forward_mapping = forms
        self._backward_mapping = backward
        self._ligature_forms = ligature_forms
        # Mandatory lam-alef ligatures only.
        self._lam_alef = {
            seq: f for seq, f in ligature_forms.items()
            if seq.startswith("ل") and len(seq) == 2
            and seq[1] in "آأإا"
        }
        self.arabic_delimiters = ["،", "ً", "ّ", "»"]
        self.delimiters = [" ", ",", "-", ".", '"', ":"]

    # ------------------------------------------------------------------
    # Joining classification
    # ------------------------------------------------------------------
    def _dual_joining(self, ch: str) -> bool:
        f = self.forward_mapping.get(ch)
        return bool(f and f[INITIAL])

    def _right_joining(self, ch: str) -> bool:
        f = self.forward_mapping.get(ch)
        return bool(f and f[FINAL])

    def _joins_prev(self, prev: str) -> bool:
        """Whether a letter after `prev` connects backwards."""
        return prev == _TATWEEL or self._dual_joining(prev)

    # ------------------------------------------------------------------
    # Reshaping (logical string -> presentation forms, logical order)
    # ------------------------------------------------------------------
    def reshape(self, text: str) -> str:
        # Strip transparent marks for context computation but keep them in
        # the output attached after their base letter.
        out: List[str] = []
        chars = list(text)
        n = len(chars)

        def prev_base(i: int) -> str:
            j = i - 1
            while j >= 0 and _is_transparent(chars[j]):
                j -= 1
            return chars[j] if j >= 0 else ""

        def next_base(i: int) -> str:
            j = i + 1
            while j < n and _is_transparent(chars[j]):
                j += 1
            return chars[j] if j < n else ""

        i = 0
        while i < n:
            ch = chars[i]
            nb = next_base(i)
            # Mandatory lam-alef ligature.
            if ch == "ل" and nb and (ch + nb) in self._lam_alef:
                lig = self._lam_alef[ch + nb]
                connected_prev = self._joins_prev(prev_base(i))
                form = lig[FINAL] if connected_prev and lig[FINAL] else lig[ISOLATED]
                out.append(form or ch + nb)
                # Skip over transparent marks plus the alef.
                j = i + 1
                while chars[j] != nb:
                    out.append(chars[j])
                    j += 1
                i = j + 1
                continue
            f = self.forward_mapping.get(ch)
            if not f:
                out.append(ch)
                i += 1
                continue
            connects_prev = self._joins_prev(prev_base(i)) and self._right_joining(ch)
            connects_next = self._dual_joining(ch) and self._right_joining(nb)
            if connects_prev and connects_next and f[MEDIAL]:
                out.append(f[MEDIAL])
            elif connects_prev and f[FINAL]:
                out.append(f[FINAL])
            elif connects_next and f[INITIAL]:
                out.append(f[INITIAL])
            else:
                out.append(f[ISOLATED] or ch)
            i += 1
        return "".join(out)

    # ------------------------------------------------------------------
    # Public conversions
    # ------------------------------------------------------------------
    def string_to_label_form(self, text: str) -> str:
        return self._reverse(text)

    def label_form_to_string(self, text: str) -> str:
        return self._reverse(text)

    def visual_form_to_string(self, text: str) -> str:
        return self._reverse(self._map_backward(text))

    def string_to_visual_form(self, text: str) -> str:
        return self._reverse(self.reshape(text))

    def label_form_to_visual_form(self, text: str) -> str:
        return self.string_to_visual_form(self.label_form_to_string(text))

    def visual_form_to_label_form(self, text: str) -> str:
        return self.string_to_label_form(self.visual_form_to_string(text))

    # ------------------------------------------------------------------
    def is_arabic_word(self, word: str) -> bool:
        return bool(self._arabic_pattern.match(word))

    def is_arabic_line(self, text: str) -> bool:
        return any(self.is_arabic_word(w) for w in text.split())

    def ligatures_mapping(self, text: str) -> List[List[int]]:
        """For each char of `text`, the list of output indices it expands to
        after backward mapping (ligatures expand to several)."""
        result = []
        counter = 0
        for ch in text:
            expansion = self._backward_mapping.get(ch, ch)
            indices = list(range(counter, counter + len(expansion)))
            counter += len(expansion)
            result.append(indices)
        return result

    def _map_backward(self, text: str) -> str:
        out = []
        for ch in text:
            mapped = self._backward_mapping.get(ch)
            if mapped is not None and len(mapped) > 1:
                # Multi-letter ligature: components come out reversed in the
                # visual stream.
                out.append(mapped[::-1])
            else:
                out.append(mapped or ch)
        return "".join(out)

    # ------------------------------------------------------------------
    # Segment-reversal "bidi"
    # ------------------------------------------------------------------
    def _is_arabic_char(self, ch: str) -> bool:
        return (
            ch in self.forward_mapping
            or ch in self._backward_mapping
            or ch in self.arabic_delimiters
        )

    def _reverse(self, text: str) -> str:
        """Reverse Arabic runs and the run order, keeping embedded
        non-Arabic (e.g. Latin, digits) segments left-to-right.

        Neutral delimiters attach to the current run, except a trailing
        group of delimiters before an Arabic run which starts the new run.
        """
        runs: List[Tuple[List[str], bool]] = []  # (chars, is_arabic)
        cur: List[str] = []
        cur_arabic = True

        def flush_with_tail_split():
            """Close a non-Arabic run, moving its trailing delimiters into
            the following Arabic run."""
            nonlocal cur, cur_arabic
            tail: List[str] = []
            while cur and cur[-1] in self.delimiters:
                tail.insert(0, cur.pop())
            if cur:
                runs.append((cur, cur_arabic))
            cur = tail
            cur_arabic = True

        for ch in text:
            if self._is_arabic_char(ch):
                if not cur_arabic:
                    flush_with_tail_split()
                cur.append(ch)
            elif ch in self.delimiters:
                cur.append(ch)
            else:
                if cur_arabic:
                    if cur:
                        runs.append((cur, True))
                    cur = []
                    cur_arabic = False
                cur.append(ch)

        if cur_arabic:
            if cur:
                runs.append((cur, True))
        else:
            flush_with_tail_split()
            if cur:
                runs.append((cur, True))

        pieces = []
        for chars, is_arabic in reversed(runs):
            pieces.append("".join(reversed(chars)) if is_arabic else "".join(chars))
        return "".join(pieces)
