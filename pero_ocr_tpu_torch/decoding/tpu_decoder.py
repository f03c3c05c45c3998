"""Batched CTC prefix beam search with the character LM stepped inside the
frame loop (port of pero_ocr_tpu/decoding/tpu_decoder.py).

The JAX package runs the whole beam search of a batch of lines as one
``lax.scan`` over frames.  Here the frame loop is a Python loop over
torch ops on the decoder's device, with no host synchronisation inside
it:

- the beam is a fixed K of prefixes, kept as per-entry arrays (length,
  rolling prefix hash, parent hash, last char, blank / non-blank / LM
  log-scores, LM state and next-char LM log-probs); prefix strings are
  not carried: each frame records (row, col) backpointers, (T, B, K)
  uint8 on the device, copied to the host once after the loop and
  walked back there;
- prefix joining (entry i staying on its last char merges with entry j
  extending by that char) is resolved with the rolling hashes, as in
  the JAX scan;
- the LM advances every non-stay entry every frame;
- lines of different lengths share a batch: frames past a line's length
  leave its state untouched.

On CUDA a batch is padded to a power of two lines (the padding lines
have no frames), and each (lines, frames) shape is captured once as a
``torch.cuda.CUDAGraph`` (initial beam, frame loop, final scores) and
replayed; at most GRAPH_CACHE graphs are kept, the least recently used
dropped first.  A step that cannot be captured raises.  On the CPU the
same ops run eagerly on the batch as given.

Where XLA and torch differ, the port keeps XLA's answer:

- ``jax.lax.top_k`` puts the lower index first among equal values, and
  the totals tie (padding frames, small charsets, the -1e30 cells);
  ``torch.topk`` promises no order, so the K best come from a stable
  descending sort;
- the hash ``h * 1000003 + col + 1`` wraps in uint32; it is carried in
  int64 and masked to 32 bits after each update (the product stays
  below 2**52);
- ``argmax`` over the boolean match takes the first True: the mask is
  cast to an integer first;
- NEG_INF is -1e30, not -inf, so ``logaddexp`` of two voided cells is
  finite and no NaN appears.

Numerically this matches the host decoder
(:class:`~pero_ocr_tpu_torch.decoding.decoders.CTCPrefixLogRawNumpyDecoder`)
configured without relevant-logit pruning.
"""

from __future__ import annotations

import copy
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pero_ocr_tpu_torch import resolve_device
from pero_ocr_tpu_torch.decoding.bag_of_hypotheses import BagOfHypotheses
from pero_ocr_tpu_torch.models.charlm import CharLM, state_leaves, state_map
from pero_ocr_tpu_torch.utils.graphs import capture

NEG_INF = -1e30
HASH_MULT = 1000003
HASH_MASK = 0xFFFFFFFF
GRAPH_CACHE = 16  # captured decode shapes kept on the card


class BeamArrays(NamedTuple):
    """Per-line beam state between frames; leaves (B, K, ...)."""

    lengths: torch.Tensor      # (B, K) int64
    hash: torch.Tensor         # (B, K) int64 holding a uint32
    parent_hash: torch.Tensor  # (B, K) int64 holding a uint32
    last_char: torch.Tensor    # (B, K) int64
    p_blank: torch.Tensor      # (B, K) f32
    p_nonblank: torch.Tensor   # (B, K) f32
    p_lm: torch.Tensor         # (B, K) f32
    lm_state: object           # CharLM state, leaves (B, K, H); None without LM
    lm_preds: torch.Tensor     # (B, K, V) f32


class DecodeOutput(NamedTuple):
    """What one decode leaves on the device."""

    bp_rows: torch.Tensor      # (T, B, K) uint8: the parent entry
    bp_cols: torch.Tensor      # (T, B, K): the char, V for a stay
    p_total: torch.Tensor      # (B, K) f32
    p_lm: torch.Tensor         # (B, K) f32
    best_states: object        # CharLM state (B, H) leaves, or None
    margins: Optional[torch.Tensor]  # (T, B) f32 or None


def _take(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x[b, rows[b, k], ...] for leaves (B, K, ...)."""
    index = rows.reshape(rows.shape + (1,) * (x.dim() - 2)).expand(rows.shape + x.shape[2:])
    return torch.gather(x, 1, index)


def _where_b(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` where ``mask`` (a leading-dims mask) holds, else ``old``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())), new, old)


class TorchBeamSearchDecoder:
    """Batched beam search over (B, T, C) log-probs.

    Args:
        letters: charset INCLUDING the trailing blank.
        k: beam width (at most 256: the row backpointers are uint8).
        lm: optional :class:`CharLM`; its vocabulary covers the
            non-blank letters (+ trailing ``</s>``), in order unless
            ``vocab_map`` says otherwise.
        vocab_map: optional (V,) int array, decoder char id -> LM token
            id; applied in the loop (LM inputs translate through it, LM
            outputs gather back into decoder order).
        lm_scale, insertion_bonus: fusion parameters.
        transport_dtype: the dtype the log-probs are uploaded in (numpy
            float32 or float16); the decode runs in float32.
        device: where the decode runs; None means CUDA, where a batch
            is padded to a power of two lines and each decode shape is a
            CUDA graph (``run(graph=False)`` runs the eager loop there,
            on the same padded batch).

    A hypothesis is bounded only by the frame count: the JAX decoder's
    ``max_len`` has no counterpart.
    """

    def __init__(
        self,
        letters: List[str],
        k: int = 8,
        lm: Optional[CharLM] = None,
        lm_scale: float = 1.0,
        insertion_bonus: float = 0.0,
        vocab_map: Optional[np.ndarray] = None,
        transport_dtype=np.float32,
        device=None,
    ):
        if not 1 <= k <= 256:
            raise ValueError(f"beam width {k} outside [1, 256]")
        self.letters = list(letters)
        self.k = k
        self.lm_scale = lm_scale
        self.insertion_bonus = insertion_bonus
        self.vocab = len(letters) - 1  # non-blank chars
        self.transport_dtype = np.dtype(transport_dtype).type
        self.device = resolve_device(device)
        # Its own copy on ``device``: the caller's module stays where it is.
        self.lm = None if lm is None else copy.deepcopy(lm).to(self.device).eval() \
            .requires_grad_(False)
        if vocab_map is not None and np.array_equal(np.asarray(vocab_map), np.arange(self.vocab)):
            vocab_map = None  # identity: the slice path
        self._lm_map = (None if vocab_map is None else
                        torch.as_tensor(np.asarray(vocab_map), dtype=torch.int64,
                                        device=self.device))
        v = self.vocab
        self._cols_dtype = torch.uint8 if v + 1 <= 256 else (
            torch.int16 if v + 1 <= 32767 else torch.int32)
        self._graphs = {}
        self.graph_capture_seconds = 0.0

    # ------------------------------------------------------------------
    # The LM inside the loop
    def _dec_preds(self, preds_full: torch.Tensor) -> torch.Tensor:
        """(..., V_lm) LM log-probs -> (..., V) in decoder char order."""
        if self._lm_map is None:
            return preds_full[..., : self.vocab]
        return preds_full[..., self._lm_map]

    def _lm_tokens(self, chars: torch.Tensor) -> torch.Tensor:
        return chars if self._lm_map is None else self._lm_map[chars]

    def _lm_flat(self, state, b: int, k: int):
        return state_map(lambda x: x.reshape((b * k,) + x.shape[2:]), state)

    def _lm_beam(self, state, b: int, k: int):
        return state_map(lambda x: x.reshape((b, k) + x.shape[1:]), state)

    # ------------------------------------------------------------------
    def _init_beam(self, b: int, init_states) -> BeamArrays:
        """The beam at t = 0: entry 0 the empty prefix, the others void;
        the LM state of each line (B, ...) broadcast over its beam."""
        k, v, dev = self.k, self.vocab, self.device
        if self.lm is None:
            lm_state, lm_preds = None, torch.zeros(b, k, v, device=dev)
        else:
            lm_state = state_map(lambda x: x[:, None].expand((b, k) + x.shape[1:]).contiguous(),
                                 init_states)
            lm_preds = self._dec_preds(self.lm.log_probs(self._lm_flat(lm_state, b, k)))
            lm_preds = lm_preds.reshape(b, k, v)
        p_blank = torch.full((b, k), NEG_INF, device=dev)
        p_blank[:, 0] = 0.0
        zeros = torch.zeros(b, k, dtype=torch.int64, device=dev)
        return BeamArrays(
            lengths=zeros, hash=zeros, parent_hash=zeros, last_char=zeros,
            p_blank=p_blank, p_nonblank=torch.full((b, k), NEG_INF, device=dev),
            p_lm=torch.zeros(b, k, device=dev), lm_state=lm_state, lm_preds=lm_preds,
        )

    def _step(self, beam: BeamArrays, frame: torch.Tensor, active: torch.Tensor,
              bp_rows: torch.Tensor, bp_cols: torch.Tensor, margin: Optional[torch.Tensor],
              off_diagonal: torch.Tensor, own_stay: torch.Tensor) -> BeamArrays:
        """One frame: frame (B, C), active (B,) bool.  Writes the frame's
        backpointers into ``bp_rows``/``bp_cols`` (B, K) and, where
        given, the smallest gap between consecutive totals among the
        K + 1 best (the K kept, their order and the cut) into ``margin``
        (B,).  ``off_diagonal``: ~eye(K); ``own_stay``: the
        flat index of each entry's own stay cell, arange(K) * (V + 1) + V."""
        b, k = beam.lengths.shape
        v = self.vocab
        chars = frame[:, :v]                           # (B, V)
        blank = frame[:, v]                            # (B,)
        finite = (beam.p_blank > NEG_INF / 2) | (beam.p_nonblank > NEG_INF / 2)
        has_last = beam.lengths > 0

        # --- extension scores ----------------------------------------
        from_blank = beam.p_blank[:, :, None] + chars[:, None, :]
        switching = beam.p_nonblank[:, :, None] + chars[:, None, :]
        last_cell = torch.zeros(b, k, v, dtype=torch.bool, device=frame.device)
        last_cell.scatter_(2, beam.last_char[:, :, None], has_last[:, :, None])
        switching = switching.masked_fill(last_cell, NEG_INF)
        extend = torch.logaddexp(from_blank, switching)        # (B, K, V)

        last_char_lp = torch.gather(chars, 1, beam.last_char)
        continued = torch.where(has_last, beam.p_nonblank + last_char_lp, NEG_INF)
        pb_stay = torch.logaddexp(beam.p_blank, beam.p_nonblank) + blank[:, None]

        # --- prefix joining via hashes -------------------------------
        # match[b, i, j]: entry i (staying) merges with entry j extending
        # by i's last char.
        match = ((beam.parent_hash[:, :, None] == beam.hash[:, None, :])
                 & (has_last & finite)[:, :, None] & finite[:, None, :] & off_diagonal)
        any_match = match.any(dim=2)
        j_star = match.to(torch.uint8).argmax(dim=2)          # the first True
        # extend[b, j*, last_char] of each staying entry, and the parent
        # cells it voids: one flat (B, K * V) index.
        parent_flat = j_star * v + beam.last_char
        join_lp = torch.gather(extend.reshape(b, k * v), 1, parent_flat)
        continued = torch.where(any_match, torch.logaddexp(continued, join_lp), continued)
        parent_cell = torch.zeros(b, k * v, dtype=torch.int32, device=frame.device)
        parent_cell.scatter_add_(1, parent_flat, any_match.to(torch.int32))
        extend = extend.masked_fill(parent_cell.reshape(b, k, v) > 0, NEG_INF)

        # --- totals + top-k ------------------------------------------
        visual = torch.cat([extend, torch.logaddexp(continued, pb_stay)[:, :, None]], dim=2)
        lm_ext = beam.p_lm[:, :, None] + beam.lm_preds + self.insertion_bonus
        lm_table = torch.cat([lm_ext, beam.p_lm[:, :, None]], dim=2)
        total = visual + self.lm_scale * lm_table
        # The K best of K * (V + 1), the lower flat index first on a tie
        # (lax.top_k's order).
        ranked, order = torch.sort(total.reshape(b, k * (v + 1)), dim=1, descending=True,
                                   stable=True)
        if margin is not None:
            margin.copy_((ranked[:, :k] - ranked[:, 1:k + 1]).amin(dim=1))
        # A line past its length takes each entry's own stay: that keeps
        # its integers, LM score, LM state and next-char log-probs as they
        # were (gathers of the same values), and its backpointers the
        # identity and a stay; only its blank and non-blank scores are put
        # back below.  The JAX scan keeps every array of the line instead:
        # the same beam.
        flat_idx = torch.where(active[:, None], order[:, :k], own_stay)
        rows = flat_idx // (v + 1)                               # (B, K)
        cols = flat_idx % (v + 1)
        stay = cols == v

        # --- gather the new beam -------------------------------------
        g_len = torch.gather(beam.lengths, 1, rows)
        g_hash = torch.gather(beam.hash, 1, rows)
        ext_hash = (g_hash * HASH_MULT + cols + 1) & HASH_MASK
        pnb_cell = torch.gather(
            torch.cat([extend, continued[:, :, None]], dim=2).reshape(b, k * (v + 1)), 1,
            flat_idx)
        new = BeamArrays(
            lengths=torch.where(stay, g_len, g_len + 1),
            hash=torch.where(stay, g_hash, ext_hash),
            parent_hash=torch.where(stay, torch.gather(beam.parent_hash, 1, rows), g_hash),
            last_char=torch.where(stay, torch.gather(beam.last_char, 1, rows), cols),
            p_blank=torch.where(active[:, None],
                                torch.where(stay, torch.gather(pb_stay, 1, rows), NEG_INF),
                                beam.p_blank),
            p_nonblank=torch.where(active[:, None], pnb_cell, beam.p_nonblank),
            p_lm=torch.gather(lm_table.reshape(b, k * (v + 1)), 1, flat_idx),
            lm_state=None,
            lm_preds=beam.lm_preds,
        )

        # --- LM state update -----------------------------------------
        if self.lm is not None:
            g_state = state_map(lambda x: _take(x, rows), beam.lm_state)
            g_preds = _take(beam.lm_preds, rows)
            adv_chars = torch.where(stay, 0, cols).reshape(b * k)
            adv_state = self.lm.advance(self._lm_tokens(adv_chars), self._lm_flat(g_state, b, k))
            adv_preds = self._dec_preds(self.lm.log_probs(adv_state)).reshape(b, k, v)
            adv_state = self._lm_beam(adv_state, b, k)
            new = new._replace(
                lm_state=state_map(lambda old, adv: _where_b(stay, old, adv), g_state, adv_state),
                lm_preds=_where_b(stay, g_preds, adv_preds),
            )

        bp_rows.copy_(rows)
        bp_cols.copy_(cols)
        return new

    def _decode_device(self, logprobs: torch.Tensor, frame_lengths: torch.Tensor,
                       init_states, model_eos: bool, margins: bool) -> DecodeOutput:
        """The decode on the device: (B, T, C) log-probs in the
        transport dtype, (B,) int64 frame counts, the LM's (B, ...)
        line-start states (None without an LM)."""
        logprobs = logprobs.float()
        b, t, _ = logprobs.shape
        k = self.k
        beam = self._init_beam(b, init_states)
        active = torch.arange(t, device=self.device)[:, None] < frame_lengths[None, :]
        bp_rows = torch.empty((t, b, k), dtype=torch.uint8, device=self.device)
        bp_cols = torch.empty((t, b, k), dtype=self._cols_dtype, device=self.device)
        margin = torch.empty((t, b), device=self.device) if margins else None
        off_diagonal = ~torch.eye(k, dtype=torch.bool, device=self.device)
        own_stay = torch.arange(k, device=self.device) * (self.vocab + 1) + self.vocab
        for i in range(t):
            beam = self._step(beam, logprobs[:, i], active[i], bp_rows[i], bp_cols[i],
                              None if margin is None else margin[i], off_diagonal, own_stay)

        p_total = torch.logaddexp(beam.p_blank, beam.p_nonblank)
        p_lm = beam.p_lm
        best_states = None
        if self.lm is not None:
            if model_eos:
                eos = self.lm.log_probs(self._lm_flat(beam.lm_state, b, k))[:, self.lm.spec.eos_id]
                p_lm = p_lm + eos.reshape(b, k)
            # The final LM state of each line's best hypothesis (the
            # CARRY_H_OVER state).
            best = torch.argmax(p_total + self.lm_scale * p_lm, dim=1)
            best_states = state_map(lambda x: _take(x, best[:, None])[:, 0], beam.lm_state)
        return DecodeOutput(bp_rows, bp_cols, p_total, p_lm, best_states, margin)

    # ------------------------------------------------------------------
    def run(self, logprobs: np.ndarray, frame_lengths: Optional[np.ndarray] = None,
            model_eos: bool = False, init_lm_states=None, margins: bool = False,
            graph: Optional[bool] = None) -> DecodeOutput:
        """One decode of (B, T, C) normalized log-probs on the device.
        ``init_lm_states``: (B, ...)-leaf LM states seeding each line's
        beam (CARRY_H_OVER), fresh line-start states where None.
        ``margins``: also record each frame's smallest gap between
        consecutive totals among the K + 1 best (how near a tie could
        change the frame's backpointers).  ``graph``: replay a CUDA graph (None: on
        CUDA).  Returns the device outputs, which a graph's next replay
        overwrites."""
        b, t, _ = logprobs.shape
        if frame_lengths is None:
            frame_lengths = np.full(b, t, np.int64)
        if graph and self.device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        n = b if self.device.type != "cuda" else 1 << (b - 1).bit_length()
        host = np.zeros((n, t, logprobs.shape[2]), self.transport_dtype)
        host[:b] = logprobs
        host = torch.from_numpy(host)
        lengths = torch.zeros(n, dtype=torch.int64)
        lengths[:b] = torch.as_tensor(np.asarray(frame_lengths), dtype=torch.int64)
        with torch.inference_mode():
            if self.lm is not None:
                if init_lm_states is None:
                    init_lm_states = self.line_start_states(n)
                elif n > b:
                    init_lm_states = state_map(lambda x, y: torch.cat([x, y]), init_lm_states,
                                               self.line_start_states(n - b))
            if self.device.type == "cuda" and graph is not False:
                key = (n, t, model_eos, margins)
                runner = self._graphs.pop(key, None)
                if runner is None:
                    if len(self._graphs) >= GRAPH_CACHE:
                        del self._graphs[next(iter(self._graphs))]
                    runner = _GraphedDecode(self, host, lengths, init_lm_states, model_eos,
                                            margins)
                self._graphs[key] = runner  # the most recently used last
                out = runner(host, lengths, init_lm_states)
            else:
                out = self._decode_device(host.to(self.device), lengths.to(self.device),
                                          init_lm_states, model_eos, margins)
        if n == b:
            return out
        return DecodeOutput(
            out.bp_rows[:, :b], out.bp_cols[:, :b], out.p_total[:b], out.p_lm[:b],
            None if out.best_states is None else state_map(lambda x: x[:b], out.best_states),
            None if out.margins is None else out.margins[:, :b])

    def hypotheses(self, out: DecodeOutput) -> List[BagOfHypotheses]:
        """The bags of one decode: the backpointers copied to the host
        once and walked back from the final beam entries."""
        bp_rows = out.bp_rows.cpu().numpy().astype(np.int64)   # (T, B, K)
        bp_cols = out.bp_cols.cpu().numpy().astype(np.int64)
        p_total = out.p_total.cpu().numpy()
        p_lm = out.p_lm.cpu().numpy()
        t_total, b, k = bp_rows.shape
        # The emitted char id of each (t, beam), recorded in one array;
        # strings materialize once per beam afterwards.
        cursor = np.tile(np.arange(k)[None, :], (b, 1))
        batch_idx = np.arange(b)[:, None]
        emitted = np.empty((t_total, b, k), np.int64)
        for t in range(t_total - 1, -1, -1):
            emitted[t] = bp_cols[t][batch_idx, cursor]
            cursor = bp_rows[t][batch_idx, cursor]
        bags = []
        for i in range(b):
            bag = BagOfHypotheses(lm_weight=self.lm_scale)
            seen = set()
            for j in range(k):
                if p_total[i, j] <= NEG_INF / 2:
                    continue
                text = "".join(self.letters[c] for c in emitted[:, i, j] if c < self.vocab)
                if text in seen:
                    continue
                seen.add(text)
                bag.add(text, float(p_total[i, j]),
                        float(p_lm[i, j]) if self.lm is not None else 0)
            bag.sort()
            bags.append(bag)
        return bags

    def decode_batch(self, logprobs: np.ndarray, frame_lengths: Optional[np.ndarray] = None,
                     model_eos: bool = False, init_lm_states=None,
                     return_lm_states: bool = False):
        """(B, T, C) normalized log-probs -> one BagOfHypotheses per line
        (and the best hypotheses' final LM states, (B, ...) leaves on
        the device, with ``return_lm_states``)."""
        out = self.run(logprobs, frame_lengths, model_eos, init_lm_states)
        bags = self.hypotheses(out)
        if return_lm_states:
            best = None if out.best_states is None else state_map(torch.clone, out.best_states)
            return bags, best
        return bags

    # ------------------------------------------------------------------
    # CARRY_H_OVER state helpers (the host LMWrapper contract, driven by
    # PageDecoder across consecutive lines).  States are CharLM tuples
    # with (B, ...) leaves on the device.
    @property
    def supports_carry(self) -> bool:
        return self.lm is not None

    def _eos(self, b: int) -> torch.Tensor:
        return torch.full((b,), self.lm.spec.eos_id, dtype=torch.int64, device=self.device)

    def line_start_states(self, b: int = 1):
        """Fresh per-line LM states: the zero state after ``</s>``."""
        with torch.inference_mode():
            return self.lm.advance(self._eos(b), self.lm.initial_state(b))

    def add_line_end(self, states):
        """Advance states by ``</s>`` (the boundary between lines)."""
        with torch.inference_mode():
            return self.lm.advance(self._eos(state_leaves(states)[0].shape[0]), states)

    def states_from_line(self, text: str):
        """A (1, ...) state seeded with a previous line's text and
        ``</s>`` (after a confident line skipped decoding)."""
        char_index = {c: i for i, c in enumerate(self.letters[:-1])}
        state = self.line_start_states(1)
        with torch.inference_mode():
            for ch in text:
                dec_id = char_index.get(ch)
                if dec_id is None:
                    continue
                tok = self._lm_tokens(torch.tensor([dec_id], dtype=torch.int64,
                                                   device=self.device))
                state = self.lm.advance(tok, state)
        return self.add_line_end(state)


class _GraphedDecode:
    """One decode shape captured as a CUDA graph: static input buffers
    (the log-probs in the transport dtype, the frame counts, the
    line-start LM states), the captured outputs, replayed per call."""

    def __init__(self, decoder: TorchBeamSearchDecoder, logprobs: torch.Tensor,
                 lengths: torch.Tensor, init_states, model_eos: bool, margins: bool):
        device = decoder.device
        t0 = time.perf_counter()
        self.logprobs = torch.empty(logprobs.shape, dtype=logprobs.dtype, device=device)
        self.lengths = torch.empty(lengths.shape, dtype=torch.int64, device=device)
        self.init = None if init_states is None else state_map(
            lambda x: torch.empty_like(x, device=device), init_states)
        self._load(logprobs, lengths, init_states)

        self.graph, self.out = capture(
            lambda: decoder._decode_device(self.logprobs, self.lengths, self.init, model_eos,
                                           margins), device, "the beam step")
        decoder.graph_capture_seconds += time.perf_counter() - t0

    def _load(self, logprobs, lengths, init_states) -> None:
        self.logprobs.copy_(logprobs, non_blocking=True)
        self.lengths.copy_(lengths, non_blocking=True)
        if self.init is not None:
            state_map(lambda dst, src: dst.copy_(src), self.init, init_states)

    def __call__(self, logprobs, lengths, init_states) -> DecodeOutput:
        self._load(logprobs, lengths, init_states)
        self.graph.replay()
        return self.out
