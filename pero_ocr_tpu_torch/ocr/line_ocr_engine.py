"""Base line-OCR engine: the OCR engine JSON and bucketed batching (port
of pero_ocr_tpu/ocr/line_ocr_engine.py).

The JSON schema is the JAX package's: ``characters``,
``line_px_height``, ``line_vertical_scale``, ``checkpoint`` (relative to
the JSON file), ``embed_num``, ``embed_id``, ``max_line_width`` and
``net_spec`` (the architecture dict).

``process_lines`` recognizes one page's line crops, as the
stage-by-stage ``PageOCR`` calls it: each crop is padded by
``LINE_PADDING_PX`` on both sides into the smallest width bucket that
holds it, batches of ``BATCH_SIZE`` are padded to a power of two, and
the logits come back per line with their frame span, sparse (softmax
below ``SPARSE_PROB_THRESHOLD`` dropped).  Long-line chunking belongs
to the transformer engines (ROADMAP item 11).  The fast path recognizes
inside :class:`~pero_ocr_tpu_torch.parallel.pipeline.TorchPagePipeline`.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy import sparse

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
    def __init__(self, json_def: str):
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
        self.batch_size = BATCH_SIZE
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

    def process_lines(self, lines: Sequence[np.ndarray]) -> Tuple[List[str], List, List]:
        """Recognize (H, W, 3) uint8 line crops.  Returns
        (transcriptions, sparse CSC logits, logit_coords) in input
        order; a line's coords are the [start, stop) frames of its
        unpadded width."""
        for line in lines:
            if line.shape[0] != self.line_px_height:
                raise ValueError(
                    f"Line height needs to be {self.line_px_height} for this "
                    f"ocr network and is {line.shape[0]} instead."
                )
            if line.shape[2] != 3:
                raise ValueError(f"Line crops need three color channels, got {line.shape[2]}.")

        groups: Dict[int, List[int]] = {}
        for i, img in enumerate(lines):
            groups.setdefault(self._bucket_for_width(img.shape[1]), []).append(i)

        transcriptions: List = [None] * len(lines)
        all_logits: List = [None] * len(lines)
        all_logit_coords: List = [None] * len(lines)
        pad = self.line_padding_px
        for bucket_width, ids in sorted(groups.items()):
            for start in range(0, len(ids), self.batch_size):
                chunk = ids[start: start + self.batch_size]
                padded_n = self._pad_batch_count(len(chunk), self.batch_size)
                batch = np.zeros((padded_n, self.line_px_height, bucket_width, 3), np.uint8)
                widths = np.zeros(padded_n, np.int32)
                for j, i in enumerate(chunk):
                    w = min(lines[i].shape[1], bucket_width - 2 * pad)
                    if w < lines[i].shape[1]:
                        logger.warning("Line too long for OCR engine. Cropping from %d px "
                                       "down to %d.", lines[i].shape[1], w)
                    batch[j, :, pad: pad + w] = lines[i][:, :w]
                    widths[j] = w
                out_transcriptions, out_logits = self.run_ocr(batch, widths)
                for j, i in enumerate(chunk):
                    transcriptions[i] = out_transcriptions[j]
                    all_logits[i] = out_logits[j]

        for i, line_logits in enumerate(all_logits):
            all_logit_coords[i] = [pad // self.net_subsampling,
                                   (pad + lines[i].shape[1]) // self.net_subsampling]
            probs = softmax(line_logits, axis=1)
            all_logits[i] = sparse.csc_matrix(
                np.where(probs < SPARSE_PROB_THRESHOLD, 0.0, line_logits))
        return transcriptions, all_logits, all_logit_coords

    # Subclass contract: (batch uint8 (B, H, W, 3), widths (B,)) ->
    # (list of B transcriptions, list of B (T, C) logits arrays).
    def run_ocr(self, batch_data: np.ndarray, widths: np.ndarray):
        raise NotImplementedError
