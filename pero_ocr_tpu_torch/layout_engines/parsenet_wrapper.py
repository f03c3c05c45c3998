"""ParseNet wrapper construction (port of
pero_ocr_tpu/layout_engines/parsenet_wrapper.py).

Builds :class:`~pero_ocr_tpu_torch.models.parsenet.ParseNet` from the
layout config's architecture keys and loads the JAX package's flax
checkpoint into it; the fast path runs the model inside
:class:`~pero_ocr_tpu_torch.parallel.pipeline.TorchPagePipeline`.  The
per-page map inference (``get_maps*``, with the adaptive two-pass
resolution) is the stage-by-stage path, ROADMAP item 8: it needs cv2's
fractional ``INTER_AREA`` resize.
"""

from __future__ import annotations

from typing import Optional

import torch

from pero_ocr_tpu_torch import STAGE_BY_STAGE, TORCHSCRIPT, not_ported
from pero_ocr_tpu_torch.models.parsenet import ParseNet
from pero_ocr_tpu_torch.utils.checkpoint import is_torchscript_file, load_or_init
from pero_ocr_tpu_torch.utils.convert import parsenet_params_from_flax


class ParseNetWrapper:
    """Layout-map model with its adaptive-resolution settings."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        downsample: int = 4,
        max_mp: float = 5,
        detection_threshold: float = 0.2,
        adaptive_downsample: bool = True,
        base_features: int = 32,
        depth: int = 4,
        stem: str = "conv",
        out_upsample: int = 1,
    ):
        self.detection_threshold = detection_threshold
        self.adaptive_downsample = adaptive_downsample
        self.init_downsample = downsample
        self.last_downsample = downsample
        self.max_megapixels = max_mp
        if model_path and is_torchscript_file(model_path):
            raise not_ported(f"TorchScript ParseNet {model_path}", TORCHSCRIPT)

        def init() -> ParseNet:
            return ParseNet(
                base_features=base_features, depth=depth, stem=stem,
                out_upsample=out_upsample, generator=torch.Generator().manual_seed(0),
            )

        def restore(tree) -> ParseNet:
            model = init()
            model.load_state_dict(parsenet_params_from_flax(tree))
            return model

        self.model = load_or_init(model_path, init, name="ParseNet", restore=restore)

    def get_maps(self, img, downsample):
        raise not_ported("ParseNetWrapper.get_maps", STAGE_BY_STAGE)

    def get_maps_with_optimal_resolution(self, img):
        raise not_ported("ParseNetWrapper.get_maps_with_optimal_resolution",
                         STAGE_BY_STAGE)
