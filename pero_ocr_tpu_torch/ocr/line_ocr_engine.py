"""Base line-OCR engine: the OCR engine JSON (port of the config half of
pero_ocr_tpu/ocr/line_ocr_engine.py).

The JSON schema is the JAX package's: ``characters``,
``line_px_height``, ``line_vertical_scale``, ``checkpoint`` (relative to
the JSON file), ``embed_num``, ``embed_id``, ``max_line_width`` and
``net_spec`` (the architecture dict).  Recognizing line crops one page
at a time (``process_lines``, the stage-by-stage path) is ROADMAP item 8;
the fast path recognizes inside
:class:`~pero_ocr_tpu_torch.parallel.pipeline.TorchPagePipeline`.
"""

from __future__ import annotations

import json
import os

from pero_ocr_tpu_torch import STAGE_BY_STAGE, not_ported


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
        # Subclasses set this (horizontal frame stride of the net).
        self.net_subsampling = 4

    def process_lines(self, lines, sparse_logits=True, tight_crop_logits=False,
                      no_logits=False):
        raise not_ported("BaseEngineLineOCR.process_lines", STAGE_BY_STAGE)
