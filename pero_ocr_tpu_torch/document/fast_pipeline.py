"""Fast-path adapter (from pero_ocr_tpu/document/fast_pipeline.py): drive
:class:`~pero_ocr_tpu_torch.parallel.pipeline.TorchPagePipeline` and emit
``PageLayout`` results, which serialize to Page XML.

Lines group into one region per paragraph cluster, each with an
alpha-shape outline simplified by Douglas-Peucker (tolerance 5), as the
layout engine draws them; a page without clusters (clustering off)
becomes one whole-page region.

:meth:`FastPagePipeline.from_page_parser` builds the device pipeline
from a config's ``PageParser``, with the JAX command line's settings, on
either transport, with a CTC recognizer (native, or a TorchScript
archive with a TorchScript ParseNet) or a transformer.  With
``want_logits`` each line also gets sparse (T, C) logits rebuilt from
stage B's top-k download, its charset and its ``logit_coords``, which
the logits files and the ALTO writer read; with ``want_crops`` its crop
(the crop transport's host warp, three channels).  ``reocr`` builds the
recognize-only pipeline for :meth:`FastPagePipeline.process_existing_layouts`:
no ParseNet, the crop transport, the line crops the only upload.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Sequence

import numpy as np
from scipy import sparse

from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from pero_ocr_tpu_torch.document.page_parser import LayoutExtractor
from pero_ocr_tpu_torch.layout_engines import helpers
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.utils.timing import stage_timer


def assemble_page_layout(result, page_id, page_size, characters, n_emit=None,
                         line_hook=None) -> PageLayout:
    """Build the full PageLayout for one :class:`PageResult`: TextLines
    (outline polygons, transcriptions, confidences) grouped into one
    region per paragraph cluster with alpha-shape region outlines.
    ``characters``: the recognizer's charset; labels from ``n_emit``
    (default: its length) on are dropped.  ``line_hook(line, i)`` runs
    after each line's own fields are set."""
    h, w = page_size
    layout = PageLayout(id=page_id, page_size=page_size)
    n_emit = len(characters) if n_emit is None else n_emit

    # The clustering already built the outlines; reuse them.
    textlines = result.textlines
    if textlines is None and result.baselines:
        textlines = helpers.baselines_to_textlines(result.baselines, result.heights)

    lines = []
    for i, (baseline, heights) in enumerate(zip(result.baselines, result.heights)):
        line = TextLine(
            index=i,
            baseline=np.asarray(baseline),
            heights=list(heights),
            polygon=textlines[i],
        )
        if result.labels is not None and i < result.labels.shape[0]:
            n = int(result.label_lengths[i])
            lab = result.labels[i, :n]
            lab = lab[(lab >= 0) & (lab < n_emit)]
            line.transcription = "".join(map(characters.__getitem__, lab.tolist()))
            if result.confidences is not None:
                line.transcription_confidence = float(result.confidences[i])
        else:
            line.transcription = ""
        if line_hook is not None:
            line_hook(line, i)
        lines.append(line)

    # One region per paragraph cluster; whole-page region when
    # clustering is off.
    clusters = result.clusters
    if clusters is None:
        clusters = [0] * len(lines)
    n_regions = (max(clusters) + 1) if clusters else 1
    for r in range(n_regions):
        members = [ln for ln, c in zip(lines, clusters) if c == r]
        if not members and n_regions > 1:
            continue
        if members:
            try:
                poly = helpers.region_from_textlines([ln.polygon for ln in members])
                poly = geometry.simplify_polygon(poly, 5)
                if len(poly) < 3:
                    raise ValueError("degenerate region")
            except (ValueError, IndexError):
                # A degenerate outline: the members' bounding box.
                pts = np.concatenate([ln.polygon for ln in members])
                x0, y0 = pts.min(axis=0)
                x1, y1 = pts.max(axis=0)
                poly = np.asarray([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
        else:
            poly = np.asarray([[0, 0], [w, 0], [w, h], [0, h]])
        region = RegionLayout(f"r{r + 1}", poly)
        for j, ln in enumerate(members):
            ln.id = f"r{r + 1}-l{j + 1:03d}"
            region.lines.append(ln)
        layout.regions.append(region)
    return layout


class FastPagePipeline:
    """Page images -> ``PageLayout``s over a built
    :class:`~pero_ocr_tpu_torch.parallel.pipeline.TorchPagePipeline`."""

    def __init__(self, pipeline, characters: Sequence[str], page_batch: int = 4,
                 want_crops: bool = False, reocr: bool = False):
        """``pipeline``: a TorchPagePipeline; its ``want_logits`` decides
        whether the lines get logits.  ``characters``: the recognizer's
        charset (CTC blank last; a reference transformer's ends in its
        two specials, which never reach the text).  ``want_crops``: each
        line also gets its crop.  ``reocr``: the pipeline recognizes
        given lines only (the crop transport; see
        :meth:`process_existing_layouts`)."""
        if reocr and pipeline.transport != "crops":
            raise ValueError("re-OCR runs on the crop transport")
        self.pipeline = pipeline
        self.characters = list(characters)
        self.page_batch = page_batch
        self.want_crops = want_crops
        self.reocr = reocr
        self._n_emit = len(self.characters) - (2 if pipeline.is_ref_transformer else 0)
        # A frame's width in crop pixels, for the lines' logit_coords
        # (CTC only: transformers give no logits).
        sub = pipeline.recognizer.spec.subsampling
        self.net_subsampling = sub if isinstance(sub, int) else sub[1]

    @staticmethod
    def unsupported_features(page_parser) -> List[str]:
        """Config features the fast path would silently change the
        meaning of (the JAX package's list).  Both command lines fall
        back to the stage-by-stage path when this is non-empty.  Like
        the JAX fast path, the pipeline
        reads four LAYOUT_CNN keys (DOWNSAMPLE, DETECTION_THRESHOLD,
        LINE_END_WEIGHT, ADAPTIVE_DOWNSAMPLE) and ignores
        MAX_MEGAPIXELS, PARAGRAPH_LINE_THRESHOLD,
        VERTICAL_LINE_CONNECTION_RANGE and SMOOTH_LINE_PREDICTIONS."""
        reasons = []
        extractor = None
        for lp in page_parser.layout_parsers:
            if isinstance(lp, LayoutExtractor) and extractor is None:
                extractor = lp
            elif not isinstance(lp, LayoutExtractor):
                reasons.append(f"extra layout stage {type(lp).__name__}")
        if extractor is not None:
            for flag, name in (
                (extractor.multi_orientation, "MULTI_ORIENTATION"),
                (extractor.merge_lines, "MERGE_LINES"),
                (extractor.adjust_heights, "ADJUST_HEIGHTS"),
                (extractor.adjust_baselines, "ADJUST_BASELINES"),
                (extractor.detect_straight_lines_in_regions,
                 "DETECT_STRAIGHT_LINES_IN_REGIONS"),
            ):
                if flag:
                    reasons.append(name)
            if not extractor.detect_regions or not extractor.detect_lines:
                reasons.append("DETECT_REGIONS/DETECT_LINES disabled")
        if page_parser.decoder is not None:
            reasons.append("RUN_DECODER (beam/LM decoding stage)")
        if page_parser.filter_confident_lines_threshold > 0:
            reasons.append("FILTER_CONFIDENT_LINES_THRESHOLD")
        return reasons

    # The JAX command line's line slot and crop bucket on one device.
    LINE_SLOT = 32
    CROP_BUCKET = 2048

    @classmethod
    def from_page_parser(cls, page_parser, page_batch: int = 4, transport_bits: int = 4,
                         want_logits: bool = False, logits_topk: int = 8,
                         transport: str = "page", canvas_bits=None, want_crops: bool = False,
                         reocr: bool = False) -> "FastPagePipeline":
        """The JAX ``FastPagePipeline(page_parser, ...)``: the config's
        ParseNet and recognizer with its LAYOUT_CNN, line cropper and OCR
        settings and the JAX defaults (LINE_SLOT, CROP_BUCKET, 4-bit
        transport, page batch 4), on ``page_parser.device``.
        ``want_logits``: stage B also copies each frame's
        ``logits_topk`` largest logits.  ``reocr``: the recognize-only
        pipeline for a config without layout stages (no ParseNet, the
        crop transport, no paragraph clustering)."""
        extractor = next(
            (lp for lp in page_parser.layout_parsers if isinstance(lp, LayoutExtractor)), None
        )
        if reocr:
            if page_parser.layout_parsers:
                raise ValueError(
                    "re-OCR fast mode takes the layout from the input "
                    "XML; remove layout stages from the config (the "
                    "stage-by-stage path honors them)"
                )
            transport = "crops"
        elif extractor is None:
            raise ValueError("--fast-pipeline needs a LAYOUT_CNN stage in the config")
        if page_parser.ocr is None:
            raise ValueError("--fast-pipeline needs an [OCR] engine in the config")
        if page_parser.line_cropper is None:
            raise ValueError("--fast-pipeline needs a [LINE_CROPPER] in the config")
        ocr_engine = page_parser.ocr.ocr_engine
        cropper = page_parser.line_cropper.crop_engine
        common = dict(
            crop_height=cropper.line_height, crop_bucket=cls.CROP_BUCKET,
            line_slot=cls.LINE_SLOT, height_scale=cropper.scale,
            transport_bits=transport_bits, transport=transport, canvas_bits=canvas_bits,
            want_logits=want_logits, logits_topk=logits_topk, device=page_parser.device,
        )
        if reocr:
            pipeline = TorchPagePipeline(None, ocr_engine.model, cluster_paragraphs=False,
                                         **common)
        else:
            parsenet_wrapper = extractor.engine.parsenet
            pipeline = TorchPagePipeline(
                parsenet_wrapper.model,
                ocr_engine.model,
                downsample=int(parsenet_wrapper.init_downsample),
                detection_threshold=extractor.engine.line_detection_threshold,
                line_end_weight=extractor.engine.line_end_weight,
                adaptive_downsample=bool(parsenet_wrapper.adaptive_downsample),
                **common,
            )
        return cls(pipeline, ocr_engine.characters, page_batch=page_batch,
                   want_crops=want_crops, reocr=reocr)

    def prime(self, first_pages) -> None:
        """Start the first batch's host prep in the background (the crop
        transport); :meth:`process_pages` must then get a page list that
        starts with these same arrays."""
        self.pipeline.prime(first_pages, self.page_batch)

    def process_existing_layouts(self, pages: Iterable[np.ndarray],
                                 layouts: Iterable[PageLayout]) -> Iterator[PageLayout]:
        """Re-OCR: recognize every line of the given layouts (input Page
        XML) and yield the same layouts, their lines' transcriptions and
        confidences (and logits or crops when asked) set in place; the
        regions, their order and the line ids stay.  Pages may differ in
        size on the recognize-only pipeline."""
        pages = list(pages)
        layouts = list(layouts)
        if len(pages) != len(layouts):
            raise ValueError("pages and layouts must align")
        line_objs = [list(lay.lines_iterator()) for lay in layouts]
        seq = [([np.asarray(ln.baseline, float) for ln in lines],
                [list(ln.heights) for ln in lines]) for lines in line_objs]
        for result in self.pipeline.run(pages, lines_override=seq, page_batch=self.page_batch,
                                        skip_stage_a=self.reocr):
            lines = line_objs[result.page_index]
            gray = (self.pipeline._gray(pages[result.page_index])
                    if self.want_crops and lines else None)
            for i, line in enumerate(lines):
                self._attach_line_result(line, result, i, gray)
            yield layouts[result.page_index]

    def _attach_line_result(self, line, result, i, gray) -> None:
        """One recognized line's outputs on its TextLine: the crop (from
        ``gray``, when given), the text, logits and confidence."""
        if gray is not None:
            self._attach_crop(line, gray)
        if result.labels is not None and i < result.labels.shape[0]:
            n = int(result.label_lengths[i])
            line.transcription = "".join(
                self.characters[c] for c in result.labels[i, :n] if 0 <= c < self._n_emit)
            if result.logits_vals is not None:
                self._attach_logits(line, result, i)
            if result.confidences is not None:
                line.transcription_confidence = float(result.confidences[i])
        else:
            line.transcription = ""

    def _attach_crop(self, line, gray: np.ndarray) -> None:
        """The line's crop as the crop transport warps it, three
        channels, as the line-crop writers read it."""
        crop = self.pipeline._host_crop_line(gray, np.asarray(line.baseline, float),
                                             line.heights)
        line.crop = np.repeat(crop[:, :, None], 3, axis=2)

    def _attach_logits(self, line, result, i) -> None:
        """The line's sparse logits from stage B's top-k: a (T, C)
        float32 csc_matrix, the charset, and ``logit_coords`` from the
        crop width (the crops sit at column 0: [0, width //
        net_subsampling])."""
        vals = result.logits_vals[i].astype(np.float32)  # (T, K)
        idx = result.logits_idx[i].astype(np.int64)
        t, k = vals.shape
        rows = np.repeat(np.arange(t), k)
        line.logits = sparse.coo_matrix(
            (vals.ravel(), (rows, idx.ravel())), shape=(t, len(self.characters))
        ).tocsc()
        line.characters = list(self.characters)
        w = int(result.crops_width[i]) if result.crops_width is not None else 0
        line.logit_coords = [0, min(t, w // self.net_subsampling)]

    def _consume_result(self, result, pages, page_ids) -> PageLayout:
        page = pages[result.page_index]
        gray = self.pipeline._gray(page) if self.want_crops else None

        def line_hook(line, i):
            if gray is not None:
                self._attach_crop(line, gray)
            if (result.logits_vals is not None and result.labels is not None
                    and i < result.labels.shape[0]):
                self._attach_logits(line, result, i)

        with stage_timer("document/assemble"):
            return assemble_page_layout(
                result, page_ids[result.page_index], (page.shape[0], page.shape[1]),
                self.characters, n_emit=self._n_emit, line_hook=line_hook,
            )

    def process_pages(self, pages: Iterable[np.ndarray], page_ids: List[str]
                      ) -> Iterator[PageLayout]:
        """Stream assembled PageLayouts in page order.

        Assembly and outline geometry run in ONE worker thread,
        overlapped with the pipeline's device waits; a bounded pending
        window keeps the stream lazy (memory stays O(page_batch))."""
        pages = list(pages)
        window = max(2 * self.page_batch, 4)
        pending: deque = deque()
        with ThreadPoolExecutor(max_workers=1) as pool:
            for result in self.pipeline.run(pages, page_batch=self.page_batch):
                pending.append(pool.submit(self._consume_result, result, pages, page_ids))
                while len(pending) > window:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
