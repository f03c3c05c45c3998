"""CTC line-OCR engine construction (port of pero_ocr_tpu/ocr/ctc_engine.py).

Appends the U+200B blank to the charset, builds
:class:`~pero_ocr_tpu_torch.models.recognizer.CTCRecognizer` from the
JSON's ``net_spec`` and loads the JAX package's flax checkpoint into it.
The fast path runs the model inside
:class:`~pero_ocr_tpu_torch.parallel.pipeline.TorchPagePipeline`; batches
of line crops (``run_ocr``) are the stage-by-stage path, ROADMAP item 8.
"""

from __future__ import annotations

import torch

from pero_ocr_tpu_torch import STAGE_BY_STAGE, TORCHSCRIPT, not_ported
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.ocr.line_ocr_engine import BaseEngineLineOCR
from pero_ocr_tpu_torch.utils.checkpoint import is_torchscript_file, load_or_init
from pero_ocr_tpu_torch.utils.convert import recognizer_params_from_flax

BLANK_CHAR = "\u200b"


class CTCEngineLineOCR(BaseEngineLineOCR):
    def __init__(self, json_def: str):
        super().__init__(json_def)
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

    def run_ocr(self, batch_data, widths):
        raise not_ported("CTCEngineLineOCR.run_ocr", STAGE_BY_STAGE)
