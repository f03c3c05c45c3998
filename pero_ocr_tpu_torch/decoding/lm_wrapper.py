"""Bridge between the host beam-search decoder and the character LM
(port of pero_ocr_tpu/decoding/lm_wrapper.py).

``LMWrapper`` has the contract of the JAX ``JAXLMWrapper``:

- ``initial_h(batch)`` — the state after consuming ``</s>``;
- ``advance_h0(chars, h)`` — one batched LM step over decoder char ids;
- ``log_probs(h)`` — (B, V_decoder) next-char log-probs;
- ``eos_scores(h)``, ``add_line_end(h)``, ``initial_h_from_line(line)``,
  ``translate(symbols)``.

States cross this boundary as :class:`HiddenState`: the CharLM's state
tuple with numpy leaves, indexed, assigned and concatenated numpy-style.
The LM runs on the wrapper's device; no batch padding is needed (the
JAX wrapper pads to powers of two only to avoid recompiles).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pero_ocr_tpu_torch.models.charlm import CharLM, CharLMSpec, state_leaves, state_map


class HiddenState:
    """A CharLM state with numpy leaves and gather/scatter/concat
    semantics."""

    def __init__(self, tree):
        self._tree = tree

    @property
    def tree(self):
        return self._tree

    def batch_size(self) -> int:
        return state_leaves(self._tree)[0].shape[0]

    def __getitem__(self, indices):
        idx = np.asarray(indices)
        return HiddenState(state_map(lambda x: np.asarray(x)[idx], self._tree))

    def __setitem__(self, indices, other: "HiddenState"):
        idx = np.asarray(indices)

        def assign(dst, src):
            dst = np.asarray(dst)
            dst[idx] = np.asarray(src)
            return dst

        self._tree = state_map(assign, self._tree, other._tree)

    def __add__(self, other: "HiddenState") -> "HiddenState":
        if self.batch_size() == 0:
            return HiddenState(other._tree)
        if other.batch_size() == 0:
            return HiddenState(self._tree)
        return HiddenState(state_map(
            lambda a, b: np.concatenate([np.asarray(a), np.asarray(b)], axis=0),
            self._tree, other._tree))


class LMWrapper:
    """Drives a :class:`CharLM` for beam-search rescoring.

    ``decoder_symbols`` are the OCR charset entries WITHOUT the blank; the
    LM vocabulary covers them plus a trailing ``</s>``.  ``vocab_map``
    (optional) maps decoder symbol -> LM token id for LMs trained on a
    different vocabulary ordering."""

    def __init__(self, model: CharLM, decoder_symbols: Sequence[str], vocab_map=None):
        self.model = model.eval()
        self.spec: CharLMSpec = model.spec
        self._eos = self.spec.eos_id
        if vocab_map is None:
            self._map = np.arange(len(decoder_symbols), dtype=np.int32)
        else:
            self._map = np.asarray([vocab_map[s] for s in decoder_symbols], dtype=np.int32)
        self._char_index = {c: i for i, c in enumerate(decoder_symbols)}

    @property
    def vocab_map(self) -> np.ndarray:
        """(V,) LM token id of each decoder char id."""
        return self._map

    def _device_state(self, h: HiddenState):
        device = self.model.device
        return state_map(lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device), h.tree)

    def _advance_raw(self, lm_tokens: np.ndarray, h: HiddenState) -> HiddenState:
        tokens = torch.from_numpy(np.asarray(lm_tokens, np.int64)).to(self.model.device)
        with torch.inference_mode():
            state = self.model.advance(tokens, self._device_state(h))
        return HiddenState(state_map(lambda x: x.cpu().numpy(), state))

    def _log_probs_full(self, h: HiddenState) -> np.ndarray:
        with torch.inference_mode():
            return self.model.log_probs(self._device_state(h)).cpu().numpy()

    def advance_h0(self, x: np.ndarray, h0: HiddenState) -> HiddenState:
        """Advance states by decoder char ids ``x``."""
        return self._advance_raw(self._map[np.asarray(x, dtype=np.int32)], h0)

    def log_probs(self, h: HiddenState) -> np.ndarray:
        return self._log_probs_full(h)[:, self._map]

    def eos_scores(self, h: HiddenState) -> np.ndarray:
        return self._log_probs_full(h)[:, self._eos]

    def initial_h(self, batch_size: int) -> HiddenState:
        """State after ``</s>`` (line-start context)."""
        with torch.inference_mode():
            zero = self.model.initial_state(batch_size)
        h = HiddenState(state_map(lambda x: x.cpu().numpy(), zero))
        return self._advance_raw(np.full(batch_size, self._eos), h)

    def add_line_end(self, h: HiddenState) -> HiddenState:
        return self._advance_raw(np.full(h.batch_size(), self._eos), h)

    def initial_h_from_line(self, line: str) -> HiddenState:
        """Seed the state with the text of a previous line followed by
        ``</s>``."""
        h = self.initial_h(1)
        for ch in line:
            dec_id = self._char_index.get(ch)
            if dec_id is None:
                continue
            h = self._advance_raw(self._map[[dec_id]], h)
        return self._advance_raw(np.asarray([self._eos]), h)

    def translate(self, symbols: np.ndarray) -> np.ndarray:
        return self._map[np.asarray(symbols, dtype=np.int32)]
