"""Fast-path adapter (from pero_ocr_tpu/document/fast_pipeline.py): drive
:class:`~pero_ocr_tpu_torch.parallel.pipeline.TorchPagePipeline` and emit
``PageLayout`` results, which serialize to Page XML.

Lines group into one region per paragraph cluster, each with an
alpha-shape outline simplified by Douglas-Peucker (tolerance 5), as the
layout engine draws them; a page without clusters (clustering off)
becomes one whole-page region.

:meth:`FastPagePipeline.from_page_parser` builds the device pipeline
from a config's ``PageParser``, with the JAX command line's settings.
With ``want_logits`` each line also gets sparse (T, C) logits rebuilt
from stage B's top-k download, its charset and its ``logit_coords``,
which the logits files and the ALTO writer read.

Not ported yet (each raises ``ValueError`` naming its ROADMAP item): line
crops, re-OCR of existing layouts, the crop transport and ``prime``.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Sequence

import numpy as np
from scipy import sparse

from pero_ocr_tpu_torch import CROP_TRANSPORT, not_ported
from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from pero_ocr_tpu_torch.document.page_parser import LayoutExtractor
from pero_ocr_tpu_torch.layout_engines import helpers
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.utils.timing import stage_timer


def assemble_page_layout(result, page_id, page_size, characters,
                         line_hook=None) -> PageLayout:
    """Build the full PageLayout for one :class:`PageResult`: TextLines
    (outline polygons, transcriptions, confidences) grouped into one
    region per paragraph cluster with alpha-shape region outlines.
    ``characters``: the CTC charset; labels outside it are dropped.
    ``line_hook(line, i)`` runs after each line's own fields are set."""
    h, w = page_size
    layout = PageLayout(id=page_id, page_size=page_size)
    n_emit = len(characters)

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
        charset (CTC blank last), which maps labels to text."""
        if want_crops:
            raise not_ported("want_crops", CROP_TRANSPORT)
        if reocr:
            raise not_ported("reocr", CROP_TRANSPORT)
        self.pipeline = pipeline
        self.characters = list(characters)
        self.page_batch = page_batch
        # A frame's width in crop pixels, for the lines' logit_coords.
        self.net_subsampling = pipeline.recognizer.spec.subsampling

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
                         want_logits: bool = False, logits_topk: int = 8
                         ) -> "FastPagePipeline":
        """The JAX ``FastPagePipeline(page_parser, ...)``, page transport:
        the config's ParseNet and recognizer with its LAYOUT_CNN, line
        cropper and OCR settings and the JAX defaults (LINE_SLOT,
        CROP_BUCKET, 4-bit transport, page batch 4), on
        ``page_parser.device``.  ``want_logits``: stage B also copies
        each frame's ``logits_topk`` largest logits."""
        extractor = next(
            (lp for lp in page_parser.layout_parsers if isinstance(lp, LayoutExtractor)), None
        )
        if extractor is None:
            raise ValueError("--fast-pipeline needs a LAYOUT_CNN stage in the config")
        if page_parser.ocr is None:
            raise ValueError("--fast-pipeline needs an [OCR] engine in the config")
        if page_parser.line_cropper is None:
            raise ValueError("--fast-pipeline needs a [LINE_CROPPER] in the config")
        ocr_engine = page_parser.ocr.ocr_engine
        cropper = page_parser.line_cropper.crop_engine
        parsenet_wrapper = extractor.engine.parsenet
        pipeline = TorchPagePipeline(
            parsenet_wrapper.model,
            ocr_engine.model,
            downsample=int(parsenet_wrapper.init_downsample),
            detection_threshold=extractor.engine.line_detection_threshold,
            line_end_weight=extractor.engine.line_end_weight,
            crop_height=cropper.line_height,
            crop_bucket=cls.CROP_BUCKET,
            line_slot=cls.LINE_SLOT,
            height_scale=cropper.scale,
            transport_bits=transport_bits,
            adaptive_downsample=bool(parsenet_wrapper.adaptive_downsample),
            want_logits=want_logits,
            logits_topk=logits_topk,
            device=page_parser.device,
        )
        return cls(pipeline, ocr_engine.characters, page_batch=page_batch)

    def prime(self, first_pages) -> None:
        raise not_ported("prime()", CROP_TRANSPORT)

    def process_existing_layouts(self, pages, layouts):
        raise not_ported("process_existing_layouts", CROP_TRANSPORT)

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

        def line_hook(line, i):
            if (result.logits_vals is not None and result.labels is not None
                    and i < result.labels.shape[0]):
                self._attach_logits(line, result, i)

        with stage_timer("document/assemble"):
            return assemble_page_layout(
                result, page_ids[result.page_index], (page.shape[0], page.shape[1]),
                self.characters, line_hook=line_hook,
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
