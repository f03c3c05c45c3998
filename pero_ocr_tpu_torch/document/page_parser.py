"""PageParser from a config, and its stage-by-stage path (port of
pero_ocr_tpu/document/page_parser.py).

The factories read the same ``[PAGE_PARSER]``, ``[LAYOUT_PARSER_n]``,
``[LINE_CROPPER]`` and ``[OCR]`` keys with the same fallbacks as the JAX
package.  ``PageParser(config, device).process_page(image, layout)``
runs configs 1 to 4 one page at a time, each stage on ``device`` (None
means CUDA, "cpu" the plain PyTorch path):

- layout: ``LayoutExtractor`` (configs 2-4: CNN regions and lines,
  ``LayoutEngine.detect``, the lines clipped into their regions; with
  ``MULTI_ORIENTATION`` the detection again on the page turned by one
  and three quarter turns; ``MERGE_LINES`` merges the lines of a row;
  ``DETECT_STRAIGHT_LINES_IN_REGIONS``, ``ADJUST_HEIGHTS`` and
  ``ADJUST_BASELINES`` read the maps of a second ParseNet pass), or
  ``WholePageRegion`` and ``TextlineExtractorSimple`` (config 1: one
  region over the page, the classical line detector on the host), or
  ``SimpleThresholdRegion`` (``REGION_SIMPLE_THRESHOLD``: regions from a
  denoised, thresholded and closed copy of the page, on the host);
  ``LINE_FILTER`` (OrientationNet directions, page position and
  length), ``LINE_POSTPROCESSING``, ``LAYOUT_POSTPROCESSING`` (region
  retrace), ``REGION_SORTER_NAIVE`` and ``REGION_SORTER_SMART`` (recursive
  XY cuts on the levelled page, config 4) after it;
- ``LineCropper``: every line's warp field on the host, then, for pages
  of four lines or more, one upload of the page and of all its width
  buckets' fields in one buffer, one
  :func:`~pero_ocr_tpu_torch.ops.warp.warp_fields` launch over that
  buffer (the hand-written CUDA kernel on the card) and one copy of the
  crops back;
  fewer lines are remapped on the host;
- ``PageOCR``: the lines' crops in width-bucketed batches through the
  CTC recognizer or, with ``METHOD = transformer`` (config 4), the
  transformer engine (a KV-cached greedy decode, one CUDA graph a
  decode shape on the card); logits kept on each line, sparse (the
  logits files and the ALTO output read CTC logits);
- ``PageDecoder`` (config 3, ``RUN_DECODER``): the lines' log-probs
  through the ``[DECODER]``'s decoder; ``TPU-BEAM`` is the batched beam
  search with the character LM on ``device``
  (:mod:`pero_ocr_tpu_torch.decoding.tpu_decoder`), one decode a line
  with ``CARRY_H_OVER`` (the LM state carried from line to line), one a
  128-frame bucket of lines without;
- line confidences from the logits, and the confident-line filter.

:meth:`~pero_ocr_tpu_torch.document.fast_pipeline.FastPagePipeline.from_page_parser`
builds the device pipeline of ``--fast-pipeline`` from the same engines.
Every layout method of the JAX package is ported.
"""

from __future__ import annotations

import logging
import math
import time
from typing import List

import numpy as np
import torch

from pero_ocr_tpu_torch import resolve_device
from pero_ocr_tpu_torch.core import crop_engine as cropper
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from pero_ocr_tpu_torch.layout_engines import helpers
from pero_ocr_tpu_torch.layout_engines.baseline_refiner import refine_baseline
from pero_ocr_tpu_torch.layout_engines.cnn_engine import LayoutEngine, LineFilterEngine
from pero_ocr_tpu_torch.layout_engines.line_in_region_detector import detect_lines_in_region
from pero_ocr_tpu_torch.layout_engines.line_postprocessing_engine import PostprocessingEngine
from pero_ocr_tpu_torch.layout_engines.naive_sorter import NaiveRegionSorter
from pero_ocr_tpu_torch.layout_engines.simple_baseline_engine import EngineLineDetectorSimple
from pero_ocr_tpu_torch.layout_engines.simple_region_engine import SimpleThresholdRegion
from pero_ocr_tpu_torch.layout_engines.smart_sorter import SmartRegionSorter
from pero_ocr_tpu_torch.ocr.ctc_engine import CTCEngineLineOCR
from pero_ocr_tpu_torch.ocr.transformer_engine import TransformerEngineLineOCR
from pero_ocr_tpu_torch.ops import warp
from pero_ocr_tpu_torch.utils.paths import compose_path
from pero_ocr_tpu_torch.utils.timing import stage_timer

logger = logging.getLogger(__name__)


def layout_parser_factory(config, device=None, config_path="", order=1):
    section = config[f"LAYOUT_PARSER_{order}"]
    method = section["METHOD"]
    if method == "REGION_WHOLE_PAGE":
        return WholePageRegion(section, config_path=config_path)
    if method == "REGION_SIMPLE_THRESHOLD":
        return SimpleThresholdRegion(section, device, config_path=config_path)
    if method == "LAYOUT_CNN":
        return LayoutExtractor(section, device, config_path=config_path)
    if method == "LINES_SIMPLE_THRESHOLD":
        return TextlineExtractorSimple(section, config_path=config_path)
    if method == "LINE_FILTER":
        return LineFilter(section, device, config_path=config_path)
    if method == "LINE_POSTPROCESSING":
        return LinePostprocessor(section, config_path=config_path)
    if method == "LAYOUT_POSTPROCESSING":
        return LayoutPostprocessor(section, config_path=config_path)
    if method == "REGION_SORTER_NAIVE":
        return NaiveRegionSorter(section, config_path=config_path)
    if method == "REGION_SORTER_SMART":
        return SmartRegionSorter(section, config_path=config_path)
    raise ValueError(f"Unknown layout parser method: {method}")


def line_cropper_factory(config, device=None, config_path=""):
    return LineCropper(config["LINE_CROPPER"], device, config_path=config_path)


def ocr_factory(config, device=None, config_path=""):
    return PageOCR(config["OCR"], device, config_path=config_path)


def page_decoder_factory(config, device=None, config_path=""):
    from pero_ocr_tpu_torch.decoding import itf

    ocr_chars = itf.get_ocr_charset(compose_path(config["OCR"]["OCR_JSON"], config_path))
    decoder = itf.decoder_factory(config["DECODER"], ocr_chars, device, config_path=config_path)
    return PageDecoder(
        decoder,
        line_confidence_threshold=config["DECODER"].getfloat("CONFIDENCE_THRESHOLD",
                                                             fallback=math.inf),
        carry_h_over=config["DECODER"].getboolean("CARRY_H_OVER", fallback=False),
    )


class MissingLogits(Exception):
    pass


def line_confident_enough(logits: np.ndarray, confidence_threshold: float) -> bool:
    log_probs = logits - np.logaddexp.reduce(logits, axis=1)[:, np.newaxis]
    worst_best_prob = np.exp(np.min(np.max(log_probs, axis=-1)))
    return worst_best_prob > confidence_threshold


def prepare_dense_logits(line: TextLine) -> np.ndarray:
    if line.logits is None:
        raise MissingLogits(f"Line {line.id} has {line.logits} in place of logits")
    return line.get_full_logprobs()


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
    """CNN region and line detection with the optional passes after it
    (JAX page_parser.py:184-323)."""

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

    def process_page(self, img, page_layout: PageLayout) -> PageLayout:
        if self.detect_regions or self.detect_lines:
            self._detect(img, page_layout)
        if self.merge_lines:
            for region in page_layout.regions:
                self._merge_lines(region)
        needs_maps = (self.detect_straight_lines_in_regions or self.adjust_heights
                      or self.adjust_baselines)
        if needs_maps:
            # The maps once more at the page's adaptive resolution (a
            # second ParseNet pass, as the JAX package makes).
            maps, ds = self.engine.parsenet.get_maps_with_optimal_resolution(img)
        if self.detect_straight_lines_in_regions:
            with stage_timer("straight_lines"):
                for region in page_layout.regions:
                    b_list, h_list, t_list = detect_lines_in_region(region.polygon, maps, ds)
                    region.lines = []
                    helpers.assign_lines_to_regions(b_list, h_list, t_list, [region])
        if self.adjust_heights:
            with stage_timer("adjust_heights"):
                self._adjust_heights(page_layout, maps, ds)
        if self.adjust_baselines:
            with stage_timer("adjust_baselines"):
                crop = cropper.EngineLineCropper(line_height=32, poly=0, scale=1)
                for line in page_layout.lines_iterator():
                    line.baseline = refine_baseline(line.baseline, line.heights, maps, ds, crop)
                    line.polygon = helpers.baseline_to_textline(line.baseline, line.heights)
        return page_layout

    def _detect(self, img, page_layout: PageLayout) -> None:
        """Regions and lines at rotation 0, and with MULTI_ORIENTATION at
        1 and 3 quarter turns too (their regions ``r{rid:03d}_{rot}``)."""
        if self.detect_regions:
            page_layout.regions = []
        if self.detect_lines:
            for region in page_layout.regions:
                region.lines = []
        for rot in ([0, 1, 3] if self.multi_orientation else [0]):
            p_list, b_list, h_list, t_list = self.engine.detect(img, rot=rot)
            regions = []
            if self.detect_regions:
                regions = [RegionLayout(f"r{rid:03d}_{rot}" if rot > 0 else f"r{rid:03d}",
                                        polygon) for rid, polygon in enumerate(p_list)]
            if self.detect_lines:
                if not self.detect_regions:
                    regions = page_layout.regions
                regions = helpers.assign_lines_to_regions(b_list, h_list, t_list, regions)
            if self.detect_regions:
                page_layout.regions += regions

    @staticmethod
    def _merge_lines(region) -> None:
        """MERGE_LINES: the region's lines merged row by row and clipped
        into the region again, until a pass merges none."""
        while True:
            original_count = len(region.lines)
            b_list, h_list = helpers.merge_lines([line.baseline for line in region.lines],
                                                 [line.heights for line in region.lines])
            t_list = [helpers.baseline_to_textline(b, h) for b, h in zip(b_list, h_list)]
            region.lines = []
            helpers.assign_lines_to_regions(b_list, h_list, t_list, [region])
            if len(region.lines) == original_count:
                break

    def _adjust_heights(self, page_layout: PageLayout, maps, ds) -> None:
        """ADJUST_HEIGHTS: each line's heights from the maps at 40 points
        of its resampled baseline, and its outline from those heights."""
        for line in page_layout.lines_iterator():
            sample_points = helpers.resample_baselines([line.baseline], num_points=40)[0]
            line.heights = self.engine.get_heights(maps, ds, sample_points)
            line.polygon = helpers.baseline_to_textline(line.baseline, line.heights)


class LineFilter:
    """Line filtering by direction, page position and page completeness
    (JAX page_parser.py:326)."""

    def __init__(self, config, device=None, config_path=""):
        self.filter_directions = config.getboolean("FILTER_DIRECTIONS", fallback=False)
        self.filter_incomplete_pages = config.getboolean("FILTER_INCOMPLETE_PAGES",
                                                         fallback=False)
        self.filter_pages_with_short_lines = config.getboolean("FILTER_PAGES_WITH_SHORT_LINES",
                                                               fallback=False)
        self.length_threshold = config.getint("LENGTH_THRESHOLD", fallback=0)
        if self.filter_directions:
            model_path = config.get("MODEL_PATH", fallback=None)
            self.engine = LineFilterEngine(
                model_path=compose_path(model_path, config_path) if model_path else None,
                device=device)

    def process_page(self, img, page_layout: PageLayout) -> PageLayout:
        if self.filter_directions:
            self.engine.predict_directions(img)
            for region in page_layout.regions:
                region.lines = [line for line in region.lines
                                if self.engine.check_line_rotation(line.polygon, line.baseline)]
        if self.filter_incomplete_pages:
            for region in page_layout.regions:
                region.lines = [line for line in region.lines
                                if helpers.check_line_position(line.baseline,
                                                               page_layout.page_size)]
        if self.filter_pages_with_short_lines:
            b_list = [line.baseline for line in page_layout.lines_iterator()]
            if helpers.get_max_line_length(b_list) < self.length_threshold:
                page_layout.regions = []
        page_layout.regions = [r for r in page_layout.regions if r.lines]
        return page_layout


class LinePostprocessor:
    """``LINE_POSTPROCESSING`` in every region (JAX page_parser.py:371)."""

    def __init__(self, config, config_path=""):
        stretch_lines = config["STRETCH_LINES"]
        if stretch_lines != "max":
            stretch_lines = int(stretch_lines)
        self.engine = PostprocessingEngine(
            stretch_lines=stretch_lines,
            resample_lines=config.getboolean("RESAMPLE_LINES", fallback=False),
            heights_from_regions=config.getboolean("HEIGHTS_FROM_REGIONS", fallback=False),
        )

    def process_page(self, img, page_layout: PageLayout) -> PageLayout:
        if not page_layout.regions:
            logger.warning("Skipping line post processing for page %s. No text region.",
                           page_layout.id)
            return page_layout
        for region in page_layout.regions:
            self.engine.postprocess(region)
        return page_layout


class LayoutPostprocessor:
    """``LAYOUT_POSTPROCESSING``: with ``RETRACE_REGIONS`` each region's
    outline rebuilt from its lines (JAX page_parser.py:394)."""

    def __init__(self, config, config_path=""):
        self.retrace_regions = config.getboolean("RETRACE_REGIONS", fallback=False)

    def process_page(self, img, page_layout: PageLayout) -> PageLayout:
        if not page_layout.regions:
            logger.warning("Skipping layout post processing for page %s. No text region.",
                           page_layout.id)
            return page_layout
        if self.retrace_regions:
            for region in page_layout.regions:
                helpers.retrace_region(region)
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
            self.ocr_engine = TransformerEngineLineOCR(json_file, device=device)
        else:
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


DECODE_BUCKET = 128  # frames; lines pad to a multiple (at least one)


def _bucket(n_frames: int) -> int:
    return max(DECODE_BUCKET, int(math.ceil(n_frames / DECODE_BUCKET) * DECODE_BUCKET))


def _padded(items, bucket: int):
    """Lines' (T, C) log-probs in one (N, bucket, C) float32 batch; the
    padding frames stay normalized: the blank sure (0), the rest -30.
    Returns (batch, frame counts)."""
    c = items[0].shape[1]
    batch = np.zeros((len(items), bucket, c), np.float32)
    lengths = np.zeros(len(items), np.int32)
    for i, logits in enumerate(items):
        t = min(logits.shape[0], bucket)
        batch[i, :t] = logits[:t]
        batch[i, t:, :] = -30.0
        batch[i, t:, -1] = 0.0
        lengths[i] = t
    return batch, lengths


class PageDecoder:
    """The LM beam-search decode stage (JAX page_parser.py:548-709).

    With a decoder that has ``decode_batch`` (``TPU-BEAM``) the page's
    lines go through it: one decode a line, in page order, carrying the
    best hypothesis's LM state over with ``CARRY_H_OVER`` (and an LM),
    else one decode a 128-frame bucket of lines.  Other decoders take a
    line at a time on the host (``decode_line``)."""

    def __init__(self, decoder, line_confidence_threshold=None, carry_h_over=False):
        self.decoder = decoder
        self.line_confidence_threshold = line_confidence_threshold
        self.lines_examined = 0
        self.lines_decoded = 0
        self.seconds_decoding = 0.0
        self.continue_lines = carry_h_over
        self.last_h = None
        self.last_line = None

    def process_page(self, page_layout: PageLayout) -> PageLayout:
        self.last_h = None
        if hasattr(self.decoder, "decode_batch"):
            if self.continue_lines and getattr(self.decoder, "supports_carry", False):
                return self._process_page_carry(page_layout)
            # No LM -> nothing to carry; the batched path is exact.
            return self._process_page_batched(page_layout)
        for line in page_layout.lines_iterator():
            try:
                line.transcription = self.decode_line(line)
            except Exception:  # a line that fails keeps its OCR text
                logger.error("Failed to process line %s of page %s.", line.id,
                             page_layout.id, exc_info=True)
        return page_layout

    def _lines_to_decode(self, page_layout: PageLayout):
        """(line, log-probs) of the lines that need decoding."""
        out = []
        for line in page_layout.lines_iterator():
            self.lines_examined += 1
            try:
                logits = prepare_dense_logits(line)
            except MissingLogits:
                continue
            if self.line_confidence_threshold is not None and \
                    line_confident_enough(logits, self.line_confidence_threshold):
                continue
            out.append((line, logits))
        return out

    def _process_page_batched(self, page_layout: PageLayout) -> PageLayout:
        """All the page's lines, one ``decode_batch`` a 128-frame bucket."""
        to_decode = self._lines_to_decode(page_layout)
        if not to_decode:
            return page_layout
        t0 = time.time()
        buckets: dict = {}
        for line, logits in to_decode:
            buckets.setdefault(_bucket(logits.shape[0]), []).append((line, logits))
        for bucket, items in buckets.items():
            batch, lengths = _padded([logits for _, logits in items], bucket)
            bags = self.decoder.decode_batch(batch, lengths)
            for (line, _), bag in zip(items, bags):
                line.transcription = bag.best_hyp()
        self.seconds_decoding += time.time() - t0
        self.lines_decoded += len(to_decode)
        return page_layout

    def _process_page_carry(self, page_layout: PageLayout) -> PageLayout:
        """CARRY_H_OVER: the lines one after another, each one decode
        seeded with the previous line's final LM state (after ``</s>``).
        A confident line keeps its OCR text and reseeds the LM from that
        text at the next decoded line."""
        state = None        # (1, ...) LM state on the decoder's device
        last_line = None
        for line in page_layout.lines_iterator():
            self.lines_examined += 1
            try:
                logits = prepare_dense_logits(line)
            except MissingLogits:
                continue
            if self.line_confidence_threshold is not None and \
                    line_confident_enough(logits, self.line_confidence_threshold):
                state = None
                last_line = line.transcription
                continue
            if state is None and last_line:
                state = self.decoder.states_from_line(last_line)
            t0 = time.time()
            batch, lengths = _padded([logits], _bucket(logits.shape[0]))
            bags, final_states = self.decoder.decode_batch(
                batch, lengths, init_lm_states=state, return_lm_states=True)
            line.transcription = bags[0].best_hyp()
            state = self.decoder.add_line_end(final_states)
            last_line = line.transcription
            self.seconds_decoding += time.time() - t0
            self.lines_decoded += 1
        return page_layout

    def decode_line(self, line: TextLine) -> str:
        """One line through a host decoder (``FAST-LOG-RAW``, ``GREEDY``)."""
        self.lines_examined += 1
        logits = prepare_dense_logits(line)
        if self.line_confidence_threshold is not None:
            if line_confident_enough(logits, self.line_confidence_threshold):
                self.last_h = None
                self.last_line = line.transcription
                return line.transcription

        t0 = time.time()
        if self.continue_lines:
            if not self.last_h and self.last_line:
                self.last_h = self.decoder._lm.initial_h_from_line(self.last_line)
            hypotheses, last_h = self.decoder(logits, return_h=True, init_h=self.last_h)
            self.last_h = self.decoder._lm.add_line_end(last_h)
        else:
            hypotheses = self.decoder(logits)
        self.seconds_decoding += time.time() - t0
        self.lines_decoded += 1

        transcription = hypotheses.best_hyp()
        self.last_line = transcription
        return transcription

    def decoding_summary(self) -> str:
        if self.lines_examined == 0:
            return "This PageDecoder has not processed a single line yet"
        if self.lines_decoded == 0:
            return (f"Processed {self.lines_examined} lines, but none required "
                    f"actual decoding")
        decoded_pct = 100.0 * self.lines_decoded / self.lines_examined
        ms_per_line = 1000.0 * self.seconds_decoding / self.lines_decoded
        return (f"Ran on {self.lines_examined}, decoded {self.lines_decoded} "
                f"lines ({decoded_pct:.1f} %) in {self.seconds_decoding:.2f}s "
                f"({ms_per_line:.1f}ms per line)")


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
            self.decoder = page_decoder_factory(config, device, config_path=config_path)

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
        if self.run_decoder:
            with stage_timer("decoder"):
                page_layout = self.decoder.process_page(page_layout)
        self.update_confidences(page_layout)
        if self.filter_confident_lines_threshold > 0:
            page_layout = self.filter_confident_lines(page_layout)
        return page_layout
