"""PageParser from a config, and its stage-by-stage path (port of
pero_ocr_tpu/document/page_parser.py).

The factories read the same ``[PAGE_PARSER]``, ``[LAYOUT_PARSER_n]``,
``[LINE_CROPPER]`` and ``[OCR]`` keys with the same fallbacks as the JAX
package.  ``PageParser(config, device).process_page(image, layout)``
runs configs 1 and 2 one page at a time, each stage on ``device`` (None
means CUDA, "cpu" the plain PyTorch path):

- layout: ``LayoutExtractor`` (config 2: CNN regions and lines,
  ``LayoutEngine.detect``, the lines clipped into their regions), or
  ``WholePageRegion`` and ``TextlineExtractorSimple`` (config 1: one
  region over the page, the classical line detector on the host);
- ``LineCropper``: every line's warp field on the host, then, for pages
  of four lines or more, one upload of the page and of all its width
  buckets' fields in one buffer, one
  :func:`~pero_ocr_tpu_torch.ops.warp.warp_fields` launch over that
  buffer (the hand-written CUDA kernel on the card) and one copy of the
  crops back;
  fewer lines are remapped on the host;
- ``PageOCR``: the lines' crops in width-bucketed batches through the
  CTC recognizer, sparse logits kept on each line (the logits files and
  the ALTO output read them);
- line confidences from the logits, and the confident-line filter.

:meth:`~pero_ocr_tpu_torch.document.fast_pipeline.FastPagePipeline.from_page_parser`
builds the device pipeline of ``--fast-pipeline`` from the same engines.
What the port lacks raises ``ValueError`` naming its ROADMAP item: the
other layout methods and the ``LAYOUT_CNN`` options ``MULTI_ORIENTATION``,
``MERGE_LINES``, ``ADJUST_HEIGHTS``, ``ADJUST_BASELINES`` and
``DETECT_STRAIGHT_LINES_IN_REGIONS`` (items 8c, 8d), ``RUN_DECODER``
(item 10) and transformer OCR (item 11).
"""

from __future__ import annotations

import logging
from typing import List

import numpy as np
import torch

from pero_ocr_tpu_torch import (
    BEAM_LM, STAGE_BY_STAGE, TRANSFORMERS, not_ported, resolve_device,
)
from pero_ocr_tpu_torch.core import crop_engine as cropper
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from pero_ocr_tpu_torch.layout_engines import helpers
from pero_ocr_tpu_torch.layout_engines.cnn_engine import LayoutEngine
from pero_ocr_tpu_torch.layout_engines.simple_baseline_engine import EngineLineDetectorSimple
from pero_ocr_tpu_torch.ocr.ctc_engine import CTCEngineLineOCR
from pero_ocr_tpu_torch.ops import warp
from pero_ocr_tpu_torch.utils.paths import compose_path
from pero_ocr_tpu_torch.utils.timing import stage_timer

logger = logging.getLogger(__name__)

# The JAX package's other layout stages (page_parser.py:51-68).
OTHER_LAYOUT_METHODS = (
    "REGION_SIMPLE_THRESHOLD", "LINE_FILTER", "LINE_POSTPROCESSING",
    "LAYOUT_POSTPROCESSING", "REGION_SORTER_NAIVE", "REGION_SORTER_SMART",
)


def layout_parser_factory(config, device=None, config_path="", order=1):
    section = config[f"LAYOUT_PARSER_{order}"]
    method = section["METHOD"]
    if method == "REGION_WHOLE_PAGE":
        return WholePageRegion(section, config_path=config_path)
    if method == "LAYOUT_CNN":
        return LayoutExtractor(section, device, config_path=config_path)
    if method == "LINES_SIMPLE_THRESHOLD":
        return TextlineExtractorSimple(section, config_path=config_path)
    if method in OTHER_LAYOUT_METHODS:
        raise not_ported(f"[LAYOUT_PARSER_{order}] METHOD = {method}", STAGE_BY_STAGE)
    raise ValueError(f"Unknown layout parser method: {method}")


def line_cropper_factory(config, device=None, config_path=""):
    return LineCropper(config["LINE_CROPPER"], device, config_path=config_path)


def ocr_factory(config, device=None, config_path=""):
    return PageOCR(config["OCR"], device, config_path=config_path)


def get_prob(best_ids: np.ndarray, best_probs: np.ndarray) -> float:
    """The worst of the greedy runs' best probabilities (a run: frames
    of one best id)."""
    last_id = -1
    last_prob = 1.0
    worst_prob = 1.0
    for sym, prob in zip(best_ids, best_probs):
        if sym != last_id:
            worst_prob = min(worst_prob, last_prob)
            last_prob = prob
            last_id = sym
        else:
            last_prob = max(prob, last_prob)
    return min(worst_prob, last_prob)


class WholePageRegion:
    """One region covering the whole page (JAX page_parser.py:139-150)."""

    def __init__(self, config=None, config_path=""):
        pass

    def process_page(self, img, page_layout: PageLayout) -> PageLayout:
        h, w = page_layout.page_size
        corners = np.asarray([[0, 0], [w, 0], [w, h], [0, h]])
        page_layout.regions = [RegionLayout("r1", corners)]
        return page_layout


class TextlineExtractorSimple:
    """Classical line detection in the page's regions (JAX
    page_parser.py:153-181), on the host."""

    def __init__(self, config, config_path=""):
        self.engine = EngineLineDetectorSimple(
            adaptive_threshold=config.getint("ADAPTIVE_THRESHOLD", fallback=91),
            block_size=config.getint("BLOCK_SIZE", fallback=21),
            minimum_length=config.getint("MINIMUM_LENGTH", fallback=6),
            ignored_border_pixels=config.getint("IGNORED_BORDER_PIXELS", fallback=10),
        )

    def process_page(self, img, page_layout: PageLayout) -> PageLayout:
        for region in page_layout.regions:
            b_list, h_list, t_list = self.engine.detect_lines(img, region.polygon)
            for i, (baseline, heights, textline) in enumerate(zip(b_list, h_list, t_list)):
                region.lines.append(TextLine(
                    id=f"{region.id}-l{i + 1:03d}", baseline=baseline, polygon=textline,
                    heights=heights,
                ))
        return page_layout


class LayoutExtractor:
    """CNN region and line detection (JAX page_parser.py:184-323)."""

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
            device=device,
        )

    def unported_options(self) -> List[str]:
        """The LAYOUT_CNN options set in the config that the
        stage-by-stage path does not run yet (ROADMAP items 8c, 8d)."""
        return [name for flag, name in (
            (self.multi_orientation, "MULTI_ORIENTATION"),
            (self.merge_lines, "MERGE_LINES"),
            (self.adjust_heights, "ADJUST_HEIGHTS"),
            (self.adjust_baselines, "ADJUST_BASELINES"),
            (self.detect_straight_lines_in_regions, "DETECT_STRAIGHT_LINES_IN_REGIONS"),
        ) if flag]

    def process_page(self, img, page_layout: PageLayout) -> PageLayout:
        unported = self.unported_options()
        if unported:
            raise not_ported(f"[LAYOUT_PARSER] {', '.join(unported)}", STAGE_BY_STAGE)
        if not (self.detect_regions or self.detect_lines):
            return page_layout
        if self.detect_regions:
            page_layout.regions = []
        if self.detect_lines:
            for region in page_layout.regions:
                region.lines = []
        p_list, b_list, h_list, t_list = self.engine.detect(img)
        regions = []
        if self.detect_regions:
            regions = [RegionLayout(f"r{rid:03d}", polygon) for rid, polygon in enumerate(p_list)]
        if self.detect_lines:
            if not self.detect_regions:
                regions = page_layout.regions
            regions = helpers.assign_lines_to_regions(b_list, h_list, t_list, regions)
        if self.detect_regions:
            page_layout.regions += regions
        return page_layout


class LineCropper:
    """Crop every line to a height-normalized strip (JAX
    page_parser.py:421-505): pages of ``DEVICE_BATCH_MIN`` lines or more
    in one field warp on the device over all their width buckets, fewer
    on the host."""

    DEVICE_BATCH_MIN = 4
    BUCKETS = (256, 512, 1024, 2048, 4096)

    def __init__(self, config, device=None, config_path=""):
        """``device``: where the field warp runs; None means CUDA
        (resolved at the first page)."""
        poly = config.getint("INTERP", fallback=2)
        line_scale = config.getfloat("LINE_SCALE", fallback=1.25)
        line_height = config.getint("LINE_HEIGHT", fallback=32)
        self.device_batched = config.getboolean("DEVICE_BATCHED", fallback=True)
        self.device = device
        self.crop_engine = cropper.EngineLineCropper(
            line_height=line_height, poly=poly, scale=line_scale
        )

    def process_page(self, img, page_layout: PageLayout) -> PageLayout:
        lines = list(page_layout.lines_iterator())
        with stage_timer("line_crop"):
            if self.device_batched and len(lines) >= self.DEVICE_BATCH_MIN:
                self._crop_batched(img, lines, page_layout.id)
            else:
                self.crop_lines(img, lines, page_id=page_layout.id)
        return page_layout

    def pack_fields(self, fields: List[np.ndarray]):
        """A page's line fields (None where one failed), padded to their
        width buckets, in one float32 buffer (``warp.field_buffer``).
        Returns (buffer, the non-empty buckets' (N, Hc, Wb) shapes, their
        line indices, the widths kept)."""
        widths = [f.shape[1] if f is not None else 0 for f in fields]
        groups = [(bucket, [g for g in group if fields[g] is not None]) for bucket, group in
                  zip(self.BUCKETS, warp.width_buckets(widths, self.BUCKETS))]
        groups = [(bucket, group) for bucket, group in groups if group]
        shapes = [(len(group), self.crop_engine.line_height, bucket) for bucket, group in groups]
        buffer = warp.field_buffer(shapes)
        kept = [warp.pad_fields([fields[g] for g in group], bucket, out=view)[1]
                for (bucket, group), view in zip(groups, warp.split_fields(buffer, shapes))]
        return buffer, shapes, [group for _, group in groups], kept

    def _crop_batched(self, img: np.ndarray, lines: List[TextLine], page_id) -> None:
        fields = []
        for line in lines:
            try:
                fields.append(self.crop_engine.get_crop_inputs(
                    line.baseline, line.heights, self.crop_engine.line_height))
            except (ValueError, IndexError, np.linalg.LinAlgError):
                fields.append(None)
        buffer, shapes, groups, kept = self.pack_fields(fields)

        device = resolve_device(self.device)
        if shapes:  # one upload of the fields, one launch, one copy back
            page = torch.from_numpy(np.ascontiguousarray(img)).to(device)
            packed = torch.from_numpy(buffer).to(device).view(1, 1, -1, 2)
            host = warp.warp_fields(page, packed, "u8").cpu().numpy().reshape(-1)
            for group, widths, crop in zip(groups, kept,
                                           warp.split_fields(host, shapes, page.shape[2])):
                for j, g in enumerate(group):
                    lines[g].crop = crop[j, :, : widths[j]]

        for line, field in zip(lines, fields):
            if field is None or line.crop is None or line.crop.shape[1] == 0:
                line.crop = np.zeros((self.crop_engine.line_height, 32, 3), dtype=np.uint8)
                logger.warning("Failed to crop line %s in page %s.", line.id, page_id)

    def crop_lines(self, img, lines: list, page_id=None) -> None:
        for line in lines:
            line.crop = self.crop_engine.crop(img, line.baseline, line.heights)


class PageOCR:
    """The OCR engine named by ``[OCR]`` (JAX page_parser.py:508-545)."""

    def __init__(self, config, device=None, config_path=""):
        json_file = compose_path(config["OCR_JSON"], config_path)
        method = config.get("METHOD", fallback="")
        if method in ("pytorch_ocr-transformer", "transformer"):
            raise not_ported(f"[OCR] METHOD = {method}", TRANSFORMERS)
        self.ocr_engine = CTCEngineLineOCR(json_file, device=device)

    def process_page(self, img, page_layout: PageLayout) -> PageLayout:
        lines = list(page_layout.lines_iterator())
        for line in lines:
            if line.crop is None:
                raise ValueError(f"Missing crop in line {line.id}.")
        with stage_timer("ocr"):
            transcriptions, logits, logit_coords = self.ocr_engine.process_lines(
                [line.crop for line in lines]
            )
        for line, transcription, line_logits, coords in zip(
            lines, transcriptions, logits, logit_coords
        ):
            line.transcription = transcription
            line.logits = line_logits
            line.characters = list(self.ocr_engine.characters)
            line.logit_coords = coords
        return page_layout

    @property
    def provides_ctc_logits(self) -> bool:
        return isinstance(self.ocr_engine, CTCEngineLineOCR)


class PageParser:
    """Top-level pipeline (JAX page_parser.py:712-794).  ``device`` is
    where its engines, and the fast pipeline built from it, run: None
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
            self.line_cropper = line_cropper_factory(config, device, config_path=config_path)
        if self.run_ocr:
            self.ocr = ocr_factory(config, device, config_path=config_path)
        if self.run_decoder:
            raise not_ported("[PAGE_PARSER] RUN_DECODER", BEAM_LM)

    @staticmethod
    def compute_line_confidence(line: TextLine) -> float:
        """The worst greedy run's best probability from the line's dense
        logits."""
        logits = line.get_dense_logits()
        log_probs = logits - np.logaddexp.reduce(logits, axis=1)[:, np.newaxis]
        best_ids = np.argmax(log_probs, axis=-1)
        best_probs = np.exp(np.max(log_probs, axis=-1))
        return get_prob(best_ids, best_probs)

    @property
    def provides_ctc_logits(self) -> bool:
        if not self.ocr:
            return False
        return self.ocr.provides_ctc_logits

    def update_confidences(self, page_layout: PageLayout) -> None:
        for line in page_layout.lines_iterator():
            if line.logits is not None:
                line.transcription_confidence = self.compute_line_confidence(line)

    def filter_confident_lines(self, page_layout: PageLayout) -> PageLayout:
        for region in page_layout.regions:
            region.lines = [
                line for line in region.lines
                if line.transcription_confidence > self.filter_confident_lines_threshold
            ]
        return page_layout

    def process_page(self, image, page_layout: PageLayout) -> PageLayout:
        """Run the configured stages on one BGR uint8 page."""
        if self.run_layout_parser:
            with stage_timer("layout"):
                for layout_parser in self.layout_parsers:
                    page_layout = layout_parser.process_page(image, page_layout)
        if self.run_line_cropper:
            page_layout = self.line_cropper.process_page(image, page_layout)
        if self.run_ocr:
            page_layout = self.ocr.process_page(image, page_layout)
        self.update_confidences(page_layout)
        if self.filter_confident_lines_threshold > 0:
            page_layout = self.filter_confident_lines(page_layout)
        return page_layout
