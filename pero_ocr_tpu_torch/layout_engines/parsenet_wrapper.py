"""ParseNet wrapper (port of pero_ocr_tpu/layout_engines/parsenet_wrapper.py).

Builds :class:`~pero_ocr_tpu_torch.models.parsenet.ParseNet` from the
layout config's architecture keys and loads the JAX package's flax
checkpoint into it.  The fast path runs the model inside
:class:`~pero_ocr_tpu_torch.parallel.pipeline.TorchPagePipeline`; the
stage-by-stage path calls ``get_maps_with_optimal_resolution`` once a
page: the colour page, area-resized on the host
(:func:`~pero_ocr_tpu_torch.utils.resize.resize_area`, cv2's
``INTER_AREA``) to the downsample that brings the median line height to
about 12 map pixels, capped by ``MAX_MEGAPIXELS``, padded to a multiple
of 64, divided by 255 and run through ParseNet on the wrapper's device.
The downsample a page settles on is where the next page starts
(``last_downsample``), so results depend on page order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pero_ocr_tpu_torch import TORCHSCRIPT, not_ported, resolve_device
from pero_ocr_tpu_torch.models.parsenet import ParseNet
from pero_ocr_tpu_torch.utils.checkpoint import is_torchscript_file, load_or_init
from pero_ocr_tpu_torch.utils.convert import parsenet_params_from_flax
from pero_ocr_tpu_torch.utils.resize import resize_area


def _pad_to_canvas(img: np.ndarray, multiple: int = 64) -> Tuple[np.ndarray, int, int]:
    h, w = img.shape[:2]
    ch = int(np.ceil(h / multiple) * multiple)
    cw = int(np.ceil(w / multiple) * multiple)
    canvas = np.zeros((ch, cw, 3), dtype=img.dtype)
    canvas[:h, :w] = img
    return canvas, h, w


class ParseNetWrapper:
    """Layout-map model with its adaptive-resolution settings."""

    DOWNSAMPLE_ADAPT_PIXEL_THRESHOLD = 100
    MIN_LINE_HEIGHT = 9
    MAX_LINE_HEIGHT = 15
    OPTIMAL_LINE_HEIGHT = 12
    MIN_DOWNSAMPLE = 1
    MAX_DOWNSAMPLE = 8

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
        device=None,
    ):
        """``device``: where ``get_maps`` runs ParseNet; None means CUDA
        (resolved at the first page)."""
        self.detection_threshold = detection_threshold
        self.adaptive_downsample = adaptive_downsample
        self.init_downsample = downsample
        self.last_downsample = downsample
        self.max_megapixels = max_mp
        self.device = device
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

    def get_maps(self, img: np.ndarray, downsample: float) -> np.ndarray:
        """One ParseNet pass at 1/``downsample`` map scale: (h, w, 5)
        float32 maps.  A super-resolving model (``out_upsample`` U > 1)
        reads a 1/(downsample * U) canvas and returns maps at the same
        1/downsample scale."""
        up = int(self.model.out_upsample)
        input_scale = downsample * up
        if input_scale != 1:
            img = resize_area(img, input_scale)
        canvas, h, w = _pad_to_canvas(img)
        device = resolve_device(self.device)
        model = self.model.to(device).eval()
        with torch.inference_mode():
            batch = torch.from_numpy(canvas[None]).to(device)
            # A true division (a CUDA scalar divisor becomes a multiply by
            # the reciprocal).
            out = model(batch.float() / torch.tensor(255.0, device=device))[0]
            return out[: h * up, : w * up].cpu().numpy()

    def get_maps_with_optimal_resolution(self, img: np.ndarray) -> Tuple[np.ndarray, float]:
        """Maps at the page's start downsample (the last page's, at least
        the megapixel cap); when more than 100 pixels pass the threshold
        and their median height lies outside [9, 15] map pixels, a second
        pass at the downsample that brings it to 12 (clipped to [1, 8]),
        which the next page starts from, unless it is within 20% of the
        first."""
        mp_cap = np.sqrt((img.shape[0] * img.shape[1]) / (self.max_megapixels * 1e6))
        first_downsample = max(self.last_downsample, mp_cap)
        net_downsample = first_downsample
        out_map = self.get_maps(img, net_downsample)
        if not self.adaptive_downsample:
            return out_map, net_downsample

        detected = (out_map[:, :, 2] > self.detection_threshold).sum()
        if detected > self.DOWNSAMPLE_ADAPT_PIXEL_THRESHOLD:
            med_height = self.get_med_height(out_map)
            if med_height > self.MAX_LINE_HEIGHT or med_height < self.MIN_LINE_HEIGHT:
                second = first_downsample * (med_height / self.OPTIMAL_LINE_HEIGHT)
                second = float(np.clip(second, self.MIN_DOWNSAMPLE, self.MAX_DOWNSAMPLE))
                self.last_downsample = second
                second = max(second, mp_cap)
                ratio = second / first_downsample
                if ratio < 0.8 or ratio > 1.2:
                    net_downsample = second
                    out_map = self.get_maps(img, net_downsample)
        return out_map, net_downsample

    def get_med_height(self, out_map: np.ndarray) -> float:
        heights = (out_map[:, :, 2] > self.detection_threshold).astype(float) * out_map[:, :, 0]
        positive = heights[heights > 0]
        return float(np.median(positive)) if positive.size else 0.0
