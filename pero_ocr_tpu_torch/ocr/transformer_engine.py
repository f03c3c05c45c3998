"""Autoregressive transformer line-OCR engine (port of
pero_ocr_tpu/ocr/transformer_engine.py).

Two models, as in the JAX engine:

- an OCR JSON with ``net_name`` names a reference-style model
  (:mod:`~pero_ocr_tpu_torch.models.transformer_ref`) whose ``checkpoint``
  is a torch ``.pt`` state dict, loaded unconverted; the charset gains
  the two specials (U+200B and ''), the boundary id starts and ends a
  line, and ``beam_size`` > 1 falls back to greedy with a warning;
- otherwise the native pre-LN model
  (:mod:`~pero_ocr_tpu_torch.models.transformer`) from the JAX package's
  flax msgpack checkpoint; ``beam_size`` > 1 in the JSON decodes with
  the beam search; its per-step logits come from re-running the
  decoder teacher-forced on the decoded tokens, as the JAX engine does.

``run_ocr`` decodes one padded batch: the encoder, then ``max_len`` =
max(8, min(width // 4, the model's cap)) decode steps (the JAX engine's
runaway cap), the text of each line's tokens before its end (the
specials dropped), and its logits ``[:length, :len(characters) + 1]``.

On CUDA each (lines, width, max_len) decode after the encoder is
captured once as a CUDA graph (its eager warm-up under
``torch.cuda.set_sync_debug_mode("error")``) and replayed; at most
GRAPH_CACHE graphs are kept, the least recently used dropped.  A
decode that cannot be captured raises.  ``decode(..., graph=False)``
runs the same loop eagerly on the card.  On the CPU the loop runs
eagerly.  The encoder's and the decoder's times go to the ``ocr/encode``
and ``ocr/decode`` stage timers (``--timing-report``).
"""

from __future__ import annotations

import collections
import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from pero_ocr_tpu_torch import resolve_device
from pero_ocr_tpu_torch.models import transformer as native_model
from pero_ocr_tpu_torch.models import transformer_ref as ref_model
from pero_ocr_tpu_torch.ocr.line_ocr_engine import BaseEngineLineOCR
from pero_ocr_tpu_torch.utils.checkpoint import load_or_init
from pero_ocr_tpu_torch.utils.convert import transformer_params_from_flax
from pero_ocr_tpu_torch.utils.graphs import capture
from pero_ocr_tpu_torch.utils.timing import stage_timer

logger = logging.getLogger(__name__)

GRAPH_CACHE = 16  # captured decode shapes kept on the card
REF_SPECIALS = ("\u200b", "")


class TransformerEngineLineOCR(BaseEngineLineOCR):
    def __init__(self, json_def: str, device=None, batch_size: int = 16):
        """``device``: where ``run_ocr`` runs; None means CUDA (resolved
        at the first batch)."""
        super().__init__(json_def, device=device, batch_size=batch_size,
                         model_type="transformer")
        self.beam_size = int(self.config.get("beam_size", 1))
        self.ref_mode = "net_name" in self.config
        if self.ref_mode:
            if self.beam_size > 1:
                logger.warning(
                    "beam_size > 1 is supported for the native transformer only; converted "
                    "reference checkpoints decode greedily (like the reference engine).")
                self.beam_size = 1
            self.characters = tuple(self.characters) + REF_SPECIALS
            self.spec = ref_model.RefTransformerSpec.from_net_config(
                self.config["net_name"], num_symbols=len(self.characters),
                in_height=self.line_px_height)
            self.net_subsampling = self.spec.subsampling[1]
            self.model = ref_model.RefTransformerOCR(self.spec)
            self.model.load_state_dict(torch.load(self.checkpoint, map_location="cpu"))
        else:
            self.spec = native_model.TransformerSpec.from_json_dict(
                self.config, num_classes=len(self.characters))
            self.net_subsampling = self.spec.subsampling

            def init() -> native_model.TransformerOCR:
                return native_model.TransformerOCR(
                    self.spec, generator=torch.Generator().manual_seed(0))

            def restore(tree) -> native_model.TransformerOCR:
                model = native_model.TransformerOCR(self.spec)
                model.load_state_dict(transformer_params_from_flax(tree))
                return model

            self.model = load_or_init(self.checkpoint, init, name="transformer OCR",
                                      restore=restore)
        self.model.eval()
        self._graphs: "collections.OrderedDict[tuple, _GraphedDecode]" = collections.OrderedDict()
        self.graph_capture_seconds = 0.0

    def decode_length(self, width: int) -> int:
        """The decode steps of a batch ``width`` pixels wide: a quarter
        of it, within the model's position table, at least 8."""
        cap = self.spec.max_seq_len - 1 if self.ref_mode else self.spec.max_decode_len
        return max(int(min(width // 4, cap)), 8)

    def decode_from_memory(self, memory: torch.Tensor, max_len: int):
        """(tokens (N, max_len), lengths (N,), logits (N, max_len, V)) of
        the encoder's ``memory``: the fixed-length decode loop, and for
        the native model the teacher-forced logits of its tokens."""
        if self.ref_mode:
            return ref_model.greedy_ref_from_memory(self.model, memory, max_len)
        sp = self.spec
        if self.beam_size > 1:
            tokens, lengths, _ = native_model.beam_from_memory(self.model, memory, max_len,
                                                               self.beam_size)
        else:
            tokens, lengths = native_model.greedy_from_memory(self.model, memory, max_len)[:2]
        bos = torch.full((tokens.shape[0], 1), sp.bos_id, dtype=tokens.dtype,
                         device=tokens.device)
        logits = self.model.decode_train(memory, torch.cat([bos, tokens[:, :-1]], dim=1))
        return tokens, lengths, logits

    def decode(self, batch: torch.Tensor, max_len: int, graph: Optional[bool] = None):
        """One padded batch (N, H, W, 3) uint8 on the engine's device ->
        (tokens, lengths, logits) on the device.  ``graph``: replay a CUDA
        graph (None: on CUDA).  A graph's outputs are overwritten by its
        next replay."""
        device = batch.device
        if graph and device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.model.to(device)
        with torch.inference_mode():
            with stage_timer("ocr/encode"):
                # A true division (a CUDA scalar divisor becomes a
                # multiply by the reciprocal).
                memory = self.model.encode(batch.float() / torch.tensor(255.0, device=device))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            with stage_timer("ocr/decode"):
                if device.type == "cuda" and graph is not False:
                    key = (tuple(batch.shape), max_len)
                    runner = self._graphs.pop(key, None)
                    if runner is None:
                        if len(self._graphs) >= GRAPH_CACHE:
                            del self._graphs[next(iter(self._graphs))]
                        runner = _GraphedDecode(self, memory, max_len)
                    self._graphs[key] = runner  # the most recently used last
                    out = runner(memory)
                else:
                    out = self.decode_from_memory(memory, max_len)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        return out

    def run_ocr(self, batch_data: np.ndarray, widths: np.ndarray
                ) -> Tuple[List[str], List[np.ndarray]]:
        device = resolve_device(self.device)
        batch = torch.from_numpy(np.ascontiguousarray(batch_data)).to(device)
        tokens, lengths, logits = (t.cpu().numpy() for t in self.decode(
            batch, self.decode_length(batch_data.shape[2])))
        n_emit = len(self.characters) - len(REF_SPECIALS) if self.ref_mode \
            else len(self.characters)
        transcriptions, out_logits = [], []
        for i in range(len(batch_data)):
            n = int(lengths[i])
            transcriptions.append("".join(self.characters[t] for t in tokens[i, :n] if t < n_emit))
            out_logits.append(logits[i, :n, : len(self.characters) + 1])
        return transcriptions, out_logits


class _GraphedDecode:
    """One decode shape captured as a CUDA graph: a static memory buffer
    in, the loop's outputs, replayed per call."""

    def __init__(self, engine: TransformerEngineLineOCR, memory: torch.Tensor, max_len: int):
        t0 = time.perf_counter()
        self.memory = memory.clone()
        self.graph, self.out = capture(
            lambda: engine.decode_from_memory(self.memory, max_len), memory.device,
            "the transformer decode")
        engine.graph_capture_seconds += time.perf_counter() - t0

    def __call__(self, memory: torch.Tensor):
        self.memory.copy_(memory)
        self.graph.replay()
        return self.out
