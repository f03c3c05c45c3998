"""PageParser from a config (port of the construction half of
pero_ocr_tpu/document/page_parser.py).

The factories read the same ``[PAGE_PARSER]``, ``[LAYOUT_PARSER_n]``,
``[LINE_CROPPER]`` and ``[OCR]`` keys with the same fallbacks as the JAX
package, and build the engines whose models and settings
:meth:`~pero_ocr_tpu_torch.document.fast_pipeline.FastPagePipeline.from_page_parser`
hands to the device pipeline.  What the port lacks raises ``ValueError``
naming its ROADMAP item when the config asks for it: layout methods
other than ``LAYOUT_CNN`` and every ``process_page`` (item 8, the
stage-by-stage path), ``RUN_DECODER`` (item 10) and transformer OCR
(item 11).
"""

from __future__ import annotations

from pero_ocr_tpu_torch import BEAM_LM, STAGE_BY_STAGE, TRANSFORMERS, not_ported
from pero_ocr_tpu_torch.core import crop_engine as cropper
from pero_ocr_tpu_torch.layout_engines.cnn_engine import LayoutEngine
from pero_ocr_tpu_torch.ocr.ctc_engine import CTCEngineLineOCR
from pero_ocr_tpu_torch.utils.paths import compose_path

# The JAX package's other layout stages (page_parser.py:51-68).
OTHER_LAYOUT_METHODS = (
    "REGION_WHOLE_PAGE", "REGION_SIMPLE_THRESHOLD", "LINES_SIMPLE_THRESHOLD",
    "LINE_FILTER", "LINE_POSTPROCESSING", "LAYOUT_POSTPROCESSING",
    "REGION_SORTER_NAIVE", "REGION_SORTER_SMART",
)


def layout_parser_factory(config, device=None, config_path="", order=1):
    section = config[f"LAYOUT_PARSER_{order}"]
    method = section["METHOD"]
    if method == "LAYOUT_CNN":
        return LayoutExtractor(section, device, config_path=config_path)
    if method in OTHER_LAYOUT_METHODS:
        raise not_ported(f"[LAYOUT_PARSER_{order}] METHOD = {method}", STAGE_BY_STAGE)
    raise ValueError(f"Unknown layout parser method: {method}")


def line_cropper_factory(config, config_path=""):
    return LineCropper(config["LINE_CROPPER"], config_path=config_path)


def ocr_factory(config, device=None, config_path=""):
    return PageOCR(config["OCR"], device, config_path=config_path)


class LayoutExtractor:
    """CNN region and line detection: the config keys (JAX
    page_parser.py:184-238)."""

    def __init__(self, config, device=None, config_path=""):
        self.detect_regions = config.getboolean("DETECT_REGIONS", fallback=True)
        self.detect_lines = config.getboolean("DETECT_LINES", fallback=True)
        self.detect_straight_lines_in_regions = config.getboolean(
            "DETECT_STRAIGHT_LINES_IN_REGIONS", fallback=False
        )
        self.merge_lines = config.getboolean("MERGE_LINES", fallback=False)
        self.adjust_heights = config.getboolean("ADJUST_HEIGHTS", fallback=False)
        self.multi_orientation = config.getboolean("MULTI_ORIENTATION", fallback=False)
        self.adjust_baselines = config.getboolean("ADJUST_BASELINES", fallback=False)

        model_path = config.get("MODEL_PATH", fallback=None)
        self.engine = LayoutEngine(
            model_path=compose_path(model_path, config_path) if model_path else None,
            downsample=config.getint("DOWNSAMPLE", fallback=4),
            adaptive_downsample=config.getboolean("ADAPTIVE_DOWNSAMPLE", fallback=True),
            detection_threshold=config.getfloat("DETECTION_THRESHOLD", fallback=0.2),
            max_mp=config.getfloat("MAX_MEGAPIXELS", fallback=5),
            line_end_weight=config.getfloat("LINE_END_WEIGHT", fallback=1.0),
            vertical_line_connection_range=config.getint(
                "VERTICAL_LINE_CONNECTION_RANGE", fallback=5
            ),
            smooth_line_predictions=config.getboolean(
                "SMOOTH_LINE_PREDICTIONS", fallback=True
            ),
            paragraph_line_threshold=config.getfloat(
                "PARAGRAPH_LINE_THRESHOLD", fallback=0.3
            ),
            stem="s2d" if config.getboolean("FAST_STEM", fallback=False) else "conv",
            base_features=config.getint("BASE_FEATURES", fallback=32),
            depth=config.getint("DEPTH", fallback=4),
            out_upsample=config.getint("OUT_UPSAMPLE", fallback=1),
        )

    def process_page(self, img, page_layout):
        raise not_ported("LayoutExtractor.process_page", STAGE_BY_STAGE)


class LineCropper:
    """Line crop settings: the config keys (JAX page_parser.py:421-437)."""

    def __init__(self, config, config_path=""):
        poly = config.getint("INTERP", fallback=2)
        line_scale = config.getfloat("LINE_SCALE", fallback=1.25)
        line_height = config.getint("LINE_HEIGHT", fallback=32)
        self.device_batched = config.getboolean("DEVICE_BATCHED", fallback=True)
        self.crop_engine = cropper.EngineLineCropper(
            line_height=line_height, poly=poly, scale=line_scale
        )

    def process_page(self, img, page_layout):
        raise not_ported("LineCropper.process_page", STAGE_BY_STAGE)


class PageOCR:
    """The OCR engine named by ``[OCR]`` (JAX page_parser.py:508-520)."""

    def __init__(self, config, device=None, config_path=""):
        json_file = compose_path(config["OCR_JSON"], config_path)
        method = config.get("METHOD", fallback="")
        if method in ("pytorch_ocr-transformer", "transformer"):
            raise not_ported(f"[OCR] METHOD = {method}", TRANSFORMERS)
        self.ocr_engine = CTCEngineLineOCR(json_file)

    def process_page(self, img, page_layout):
        raise not_ported("PageOCR.process_page", STAGE_BY_STAGE)

    @property
    def provides_ctc_logits(self) -> bool:
        return isinstance(self.ocr_engine, CTCEngineLineOCR)


class PageParser:
    """Top-level pipeline construction (JAX page_parser.py:712-760).
    ``device`` is where the fast pipeline built from it runs: None
    means CUDA, "cpu" the plain PyTorch path."""

    def __init__(self, config, device=None, config_path=""):
        pp = config["PAGE_PARSER"]
        self.run_layout_parser = pp.getboolean("RUN_LAYOUT_PARSER", fallback=False)
        self.run_line_cropper = pp.getboolean("RUN_LINE_CROPPER", fallback=False)
        self.run_ocr = pp.getboolean("RUN_OCR", fallback=False)
        self.run_decoder = pp.getboolean("RUN_DECODER", fallback=False)
        self.filter_confident_lines_threshold = pp.getfloat(
            "FILTER_CONFIDENT_LINES_THRESHOLD", fallback=-1
        )

        self.layout_parsers = []
        self.line_cropper = None
        self.ocr = None
        self.decoder = None
        self.device = device

        if self.run_layout_parser:
            for i in range(1, 10):
                if config.has_section(f"LAYOUT_PARSER_{i}"):
                    self.layout_parsers.append(
                        layout_parser_factory(config, device, config_path=config_path, order=i)
                    )
        if self.run_line_cropper:
            self.line_cropper = line_cropper_factory(config, config_path=config_path)
        if self.run_ocr:
            self.ocr = ocr_factory(config, device, config_path=config_path)
        if self.run_decoder:
            raise not_ported("[PAGE_PARSER] RUN_DECODER", BEAM_LM)

    @property
    def provides_ctc_logits(self) -> bool:
        if not self.ocr:
            return False
        return self.ocr.provides_ctc_logits

    def process_page(self, image, page_layout):
        raise not_ported("PageParser.process_page", STAGE_BY_STAGE)
