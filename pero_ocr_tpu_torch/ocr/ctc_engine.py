"""CTC line-OCR engine (port of pero_ocr_tpu/ocr/ctc_engine.py).

Appends the U+200B blank to the charset, builds
:class:`~pero_ocr_tpu_torch.models.recognizer.CTCRecognizer` from the
JSON's ``net_spec`` and loads the JAX package's flax checkpoint into it.
``run_ocr`` recognizes one padded batch of line crops on the engine's
device (CUDA unless ``device="cpu"``): u8 in, divided by 255 in float32,
the recognizer, then greedy CTC labels over every frame of the bucket
(as the JAX engine decodes: labels depend on the bucket width).  The
fast path runs the model inside
:class:`~pero_ocr_tpu_torch.parallel.pipeline.TorchPagePipeline`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from pero_ocr_tpu_torch import TORCHSCRIPT, not_ported, resolve_device
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.ocr.line_ocr_engine import BaseEngineLineOCR
from pero_ocr_tpu_torch.ops import ctc
from pero_ocr_tpu_torch.utils.checkpoint import is_torchscript_file, load_or_init
from pero_ocr_tpu_torch.utils.convert import recognizer_params_from_flax

BLANK_CHAR = "\u200b"


class CTCEngineLineOCR(BaseEngineLineOCR):
    def __init__(self, json_def: str, device=None):
        """``device``: where ``run_ocr`` runs; None means CUDA (resolved
        at the first batch, so that a config can be read without a
        card)."""
        super().__init__(json_def, device=device)
        self.characters = tuple(self.characters) + (BLANK_CHAR,)
        if self.checkpoint and is_torchscript_file(self.checkpoint):
            raise not_ported(f"TorchScript recognizer {self.checkpoint}", TORCHSCRIPT)
        self.spec = RecognizerSpec.from_json_dict(self.config, num_classes=len(self.characters))
        self.net_subsampling = self.spec.subsampling

        def init() -> CTCRecognizer:
            return CTCRecognizer(self.spec, generator=torch.Generator().manual_seed(0))

        def restore(tree) -> CTCRecognizer:
            model = init()
            model.load_state_dict(recognizer_params_from_flax(tree))
            return model

        self.model = load_or_init(self.checkpoint, init, name="CTC OCR", restore=restore)

    def current_embed_id(self) -> int:
        """The writer-embedding id in use (``embed_num`` is the mean)."""
        if not self.spec.embed_num:
            return 0
        if self.embed_id == "mean" or self.embed_id is None:
            return self.spec.embed_num
        return int(self.embed_id)

    def run_ocr(self, batch_data: np.ndarray, widths: np.ndarray
                ) -> Tuple[List[str], List[np.ndarray]]:
        device = resolve_device(self.device)
        model = self.model.to(device).eval()
        with torch.inference_mode():
            batch = torch.from_numpy(np.ascontiguousarray(batch_data)).to(device)
            # A true division (a CUDA scalar divisor becomes a multiply by
            # the reciprocal).
            images = batch.float() / torch.tensor(255.0, device=device)
            embed_ids = None
            if self.spec.embed_num:
                embed_ids = torch.full((batch.shape[0],), self.current_embed_id(),
                                       dtype=torch.long, device=device)
            logits = model(images, embed_ids)
            valid = torch.full((batch.shape[0],), logits.shape[1], dtype=torch.int32,
                               device=device)
            labels, lengths = ctc.greedy_ctc_labels(logits, valid)
            logits, labels, lengths = (t.cpu().numpy() for t in (logits, labels, lengths))
        transcriptions = ctc.labels_to_strings(labels, lengths, list(self.characters))
        return transcriptions, [logits[i] for i in range(len(batch_data))]
