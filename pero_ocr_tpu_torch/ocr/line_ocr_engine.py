"""Base line-OCR engine: the OCR engine JSON and bucketed batching (port
of pero_ocr_tpu/ocr/line_ocr_engine.py).

The JSON schema is the JAX package's: ``characters``,
``line_px_height``, ``line_vertical_scale``, ``checkpoint`` (relative to
the JSON file), ``embed_num``, ``embed_id``, ``max_line_width`` and
``net_spec`` (the architecture dict).

``process_lines`` recognizes one page's line crops, as the
stage-by-stage ``PageOCR`` calls it: each crop is padded by
``LINE_PADDING_PX`` on both sides into the smallest width bucket that
holds it, batches of ``batch_size`` are padded to a power of two, and
the logits come back per line with their frame span, sparse (softmax
below ``SPARSE_PROB_THRESHOLD`` dropped).  For a transformer
(``model_type``), a line wider than ``max_line_width`` is cut into
chunks that overlap by a quarter, recognized apart, and stitched where
the edit distance of the overlap is least (``find_best_overlap``, the
C++ ``levenshtein_i32`` on the card's route); its logits are one frame
a character, spanning ``[0, len(transcription)]``.  The fast path
recognizes inside
:class:`~pero_ocr_tpu_torch.parallel.pipeline.TorchPagePipeline`.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy import sparse

from pero_ocr_tpu_torch.sequence_alignment import levenshtein_distance
from pero_ocr_tpu_torch.utils import native as native_lib

logger = logging.getLogger(__name__)

LINE_PADDING_PX = 32
WIDTH_BUCKETS = (192, 384, 768, 1280, 1792, 2304, 3072, 4096)
BATCH_SIZE = 32
SPARSE_PROB_THRESHOLD = 1e-4


def softmax(x: np.ndarray, axis: int) -> np.ndarray:
    """Numerically stable softmax along ``axis``, in float64."""
    x = np.asarray(x, dtype=np.float64)
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


class BaseEngineLineOCR:
    def __init__(self, json_def: str, device=None, batch_size: int = BATCH_SIZE,
                 model_type: str = "ctc"):
        """``device``: where the subclass's ``run_ocr`` runs (None means
        CUDA); the host route of the chunk merge follows it."""
        with open(json_def, "r", encoding="utf8") as f:
            self.config = json.load(f)

        self.line_px_height = self.config["line_px_height"]
        self.line_vertical_scale = self.config.get("line_vertical_scale", 1)

        checkpoint = self.config.get("checkpoint")
        if checkpoint and not os.path.isabs(checkpoint):
            checkpoint = os.path.realpath(
                os.path.join(os.path.dirname(json_def), checkpoint)
            )
        self.checkpoint = checkpoint

        self.characters = tuple(self.config["characters"])
        self.net_spec = self.config.get("net_spec", {})

        self.embed_num = (
            int(self.config["embed_num"]) if "embed_num" in self.config else None
        )
        embed_id = self.config.get("embed_id")
        if embed_id is not None and embed_id != "mean":
            embed_id = int(embed_id)
        self.embed_id = embed_id

        self.max_line_width = int(self.config.get("max_line_width", 1e9))
        self.device = device
        self.batch_size = batch_size
        self.model_type = model_type
        self.line_padding_px = LINE_PADDING_PX
        self.width_buckets = WIDTH_BUCKETS
        # Subclasses set this (horizontal frame stride of the net).
        self.net_subsampling = 4

    def _bucket_for_width(self, width: int) -> int:
        padded = width + 2 * self.line_padding_px
        for b in self.width_buckets:
            if padded <= b:
                return b
        return self.width_buckets[-1]

    @staticmethod
    def _pad_batch_count(n: int, cap: int) -> int:
        p = 1
        while p < n:
            p *= 2
        return min(p, cap)

    def _chunk_line(self, image: np.ndarray) -> List[np.ndarray]:
        """An over-wide line as chunks of ``max_line_width`` that overlap
        by a quarter of it (the last one ends where the line does)."""
        if image.shape[1] <= self.max_line_width:
            return [image]
        overlap = self.max_line_width // 4
        stride = self.max_line_width - overlap
        parts = []
        start = 0
        while start + self.max_line_width < image.shape[1]:
            parts.append(image[:, start: start + self.max_line_width])
            start += stride
        parts.append(image[:, start: start + self.max_line_width])
        return parts

    def process_lines(self, lines: Sequence[np.ndarray], no_logits: bool = False
                      ) -> Tuple[List[str], List, List]:
        """Recognize (H, W, 3) uint8 line crops.  Returns
        (transcriptions, sparse CSC logits, logit_coords) in input
        order; a CTC line's coords are the [start, stop) frames of its
        unpadded width, a transformer line's [0, its length].
        ``no_logits``: the logits and coords are None a line (the
        transcriptions only, as select_embed_id asks)."""
        for line in lines:
            if line.shape[0] != self.line_px_height:
                raise ValueError(
                    f"Line height needs to be {self.line_px_height} for this "
                    f"ocr network and is {line.shape[0]} instead."
                )
            if line.shape[2] != 3:
                raise ValueError(f"Line crops need three color channels, got {line.shape[2]}.")

        # Over-wide transformer lines go as chunks ("units").
        units, spans = [], []
        for image in lines:
            parts = self._chunk_line(image) if self.model_type == "transformer" else [image]
            units.extend(parts)
            spans.append(len(parts))

        groups: Dict[int, List[int]] = {}
        for u, img in enumerate(units):
            groups.setdefault(self._bucket_for_width(img.shape[1]), []).append(u)

        unit_transcriptions: List = [None] * len(units)
        unit_logits: List = [None] * len(units)
        pad = self.line_padding_px
        for bucket_width, ids in sorted(groups.items()):
            for start in range(0, len(ids), self.batch_size):
                chunk = ids[start: start + self.batch_size]
                padded_n = self._pad_batch_count(len(chunk), self.batch_size)
                batch = np.zeros((padded_n, self.line_px_height, bucket_width, 3), np.uint8)
                widths = np.zeros(padded_n, np.int32)
                for j, u in enumerate(chunk):
                    w = min(units[u].shape[1], bucket_width - 2 * pad)
                    if w < units[u].shape[1]:
                        logger.warning("Line too long for OCR engine. Cropping from %d px "
                                       "down to %d.", units[u].shape[1], w)
                    batch[j, :, pad: pad + w] = units[u][:, :w]
                    widths[j] = w
                out_transcriptions, out_logits = self.run_ocr(batch, widths)
                for j, u in enumerate(chunk):
                    unit_transcriptions[u] = out_transcriptions[j]
                    unit_logits[u] = out_logits[j]

        transcriptions: List = []
        all_logits: List = []
        all_logit_coords: List = []
        native = native_lib.use_native(None, self.device)
        u = 0
        for line, span in zip(lines, spans):
            if span == 1:
                transcription, line_logits = unit_transcriptions[u], unit_logits[u]
            else:
                transcription, line_logits = merge_transcriptions_and_logits(
                    unit_transcriptions[u: u + span], unit_logits[u: u + span], native)
            u += span
            transcriptions.append(transcription)
            if no_logits:
                all_logits.append(None)
                all_logit_coords.append(None)
                continue
            if self.model_type == "ctc":
                all_logit_coords.append([pad // self.net_subsampling,
                                         (pad + line.shape[1]) // self.net_subsampling])
            else:  # one frame a character
                all_logit_coords.append([0, len(transcription)])
            probs = softmax(line_logits, axis=1)
            all_logits.append(sparse.csc_matrix(
                np.where(probs < SPARSE_PROB_THRESHOLD, 0.0, line_logits)))
        return transcriptions, all_logits, all_logit_coords

    # Subclass contract: (batch uint8 (B, H, W, 3), widths (B,)) ->
    # (list of B transcriptions, list of B (T, C) logits arrays).
    def run_ocr(self, batch_data: np.ndarray, widths: np.ndarray):
        raise NotImplementedError


def merge_transcriptions_and_logits(transcription_parts, logits_parts, native: bool = False):
    """Stitch the chunks of one line: each chunk's logits cut to its
    text, then each next chunk joined at its best overlap with the text
    so far, ceil(overlap / 2) characters dropped from the left and
    floor(overlap / 2) from the right.  At an overlap of 0 the left text
    is kept whole (the reference's ``[:-0 // 2]`` empties it; the JAX
    package keeps it, and so does the port)."""
    shrunk = [logits[: len(t)] for t, logits in zip(transcription_parts, logits_parts)]
    result_transcription = transcription_parts[0]
    result_logits = shrunk[0]
    for transcription, logits in zip(transcription_parts[1:], shrunk[1:]):
        overlap = find_best_overlap(result_transcription, transcription, native)
        keep = len(result_transcription) - (overlap - overlap // 2)
        result_transcription = result_transcription[:keep] + transcription[overlap // 2:]
        result_logits = np.concatenate([result_logits[:keep], logits[overlap // 2:]], axis=0)
    return result_transcription, result_logits


def find_best_overlap(text1: str, text2: str, native: bool = False) -> int:
    """The overlap length whose text1 suffix and text2 prefix have the
    least character error rate (the first such length, 0 when none is
    below 1)."""
    best_cer = 1.0
    best_overlap = 0
    for i in range(1, min(len(text1), len(text2)) + 1):
        s1 = text1[-i:]
        cer = levenshtein_distance(list(s1), list(text2[:i]), native=native) / len(s1)
        if cer < best_cer:
            best_cer = cer
            best_overlap = i
    return best_overlap
