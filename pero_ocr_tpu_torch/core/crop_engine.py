"""Line crop engine settings (port of the fields of
pero_ocr_tpu/core/crop_engine.py).

The fast path warps every line on the card
(:mod:`pero_ocr_tpu_torch.ops.warp`) with these settings; cropping one
line at a time on the host (``crop``) is the stage-by-stage path,
ROADMAP item 8.
"""

from __future__ import annotations

from pero_ocr_tpu_torch import STAGE_BY_STAGE, not_ported


class EngineLineCropper:
    def __init__(self, line_height: int = 32, poly: int = 0, scale: float = 1):
        self.line_height = line_height
        self.poly = poly
        self.scale = scale

    def crop(self, img, baseline, heights, return_mapping=False,
             return_forward_mapping=False):
        raise not_ported("EngineLineCropper.crop", STAGE_BY_STAGE)
