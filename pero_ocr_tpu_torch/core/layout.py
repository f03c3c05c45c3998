"""Document layout data model (from pero_ocr_tpu/core/layout.py):
``TextLine``, ``RegionLayout`` and ``PageLayout`` with Page XML
(de)serialization, which lives in :mod:`pero_ocr_tpu_torch.core.pagexml`.

``TextLine`` densifies the sparse CTC logits that the stage-by-stage
OCR stores (``get_dense_logits``, ``get_full_logprobs``); the logits
files, ALTO, rendering and quality methods are ROADMAP item 9 and later.
"""

from __future__ import annotations

from enum import Enum
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse

Num = Union[int, float]

# Dense value of the entries that sparse logits pruned (the JAX
# package's ZERO_LOGIT_VALUE).
ZERO_LOGIT_VALUE = -80


def log_softmax_np(logits: np.ndarray) -> np.ndarray:
    """Numerically stable log-softmax over the last axis."""
    return logits - np.logaddexp.reduce(logits, axis=-1, keepdims=True)


class PAGEVersion(Enum):
    PAGE_2019_07_15 = 1
    PAGE_2013_07_15 = 2


class TextLine:
    """A single text line: geometry, transcription and recognition outputs.

    - ``baseline``: (N, 2) polyline of x,y page coordinates.
    - ``polygon``: (M, 2) closed outline of the line.
    - ``heights``: ``[ascender_px, descender_px]`` above/below the baseline.
    - ``logits``: sparse (T, C) CTC logit matrix (scipy CSC) or dense array.
    - ``characters``: the recognizer charset (last entry = CTC blank).
    - ``logit_coords``: ``[start, stop)`` frame span of the unpadded line.
    """

    __slots__ = (
        "id",
        "index",
        "baseline",
        "polygon",
        "heights",
        "transcription",
        "logits",
        "crop",
        "characters",
        "logit_coords",
        "transcription_confidence",
        "category",
    )

    def __init__(
        self,
        id: Optional[str] = None,
        baseline: Optional[np.ndarray] = None,
        polygon: Optional[np.ndarray] = None,
        heights: Optional[Sequence[Num]] = None,
        transcription: Optional[str] = None,
        logits=None,
        crop: Optional[np.ndarray] = None,
        characters: Optional[List[str]] = None,
        logit_coords: Optional[Sequence[Optional[int]]] = None,
        transcription_confidence: Optional[Num] = None,
        index: Optional[int] = None,
        category: Optional[str] = None,
    ):
        self.id = id
        self.index = index
        self.baseline = baseline
        self.polygon = polygon
        self.heights = heights
        self.transcription = transcription
        self.logits = logits
        self.crop = crop
        self.characters = characters
        self.logit_coords = logit_coords
        self.transcription_confidence = transcription_confidence
        self.category = category

    def get_dense_logits(self, zero_logit_value: int = ZERO_LOGIT_VALUE) -> np.ndarray:
        """Densify sparse logits, filling pruned (zero) entries with a
        large negative value."""
        if scipy.sparse.issparse(self.logits):
            dense = np.asarray(self.logits.todense())
        else:
            dense = np.array(self.logits)
        dense[dense == 0] = zero_logit_value
        return dense

    def get_full_logprobs(self, zero_logit_value: int = ZERO_LOGIT_VALUE) -> np.ndarray:
        """Dense per-frame log-probabilities."""
        return log_softmax_np(self.get_dense_logits(zero_logit_value))


class RegionLayout:
    """A page region (paragraph/block) with an outline polygon and its lines."""

    __slots__ = ("id", "polygon", "region_type", "lines", "transcription")

    def __init__(self, id: str, polygon: np.ndarray, region_type: Optional[str] = None):
        self.id = id
        self.polygon = polygon
        self.region_type = region_type
        self.lines: List[TextLine] = []
        self.transcription: Optional[str] = None


class PageLayout:
    """Page container: regions, reading order and Page XML."""

    def __init__(
        self,
        id: Optional[str] = None,
        page_size: Tuple[int, int] = (0, 0),
        file: Optional[str] = None,
    ):
        self.id = id
        self.page_size = page_size  # (height, width)
        self.regions: List[RegionLayout] = []
        self.reading_order = None

        if file is not None:
            self.from_pagexml(file)
        if self.reading_order is not None and len(self.regions) > 0:
            self.sort_regions_by_reading_order()

    def lines_iterator(self) -> Iterator[TextLine]:
        for region in self.regions:
            yield from region.lines

    def sort_regions_by_reading_order(self) -> None:
        order = self.reading_order or {}
        self.regions.sort(key=lambda r: order.get(r.id, float("inf")))

    def from_pagexml_string(self, pagexml_string: str) -> None:
        from pero_ocr_tpu_torch.core import pagexml

        pagexml.read_pagexml_string(self, pagexml_string)

    def from_pagexml(self, file) -> None:
        from pero_ocr_tpu_torch.core import pagexml

        pagexml.read_pagexml(self, file)

    def to_pagexml_string(
        self,
        creator: str = "pero_ocr_tpu",
        validate_id: bool = False,
        version: PAGEVersion = PAGEVersion.PAGE_2019_07_15,
    ) -> str:
        from pero_ocr_tpu_torch.core import pagexml

        return pagexml.write_pagexml_string(
            self, creator=creator, validate_id=validate_id, version=version
        )

    def to_pagexml(
        self,
        file_name: str,
        creator: str = "pero_ocr_tpu",
        validate_id: bool = False,
        version: PAGEVersion = PAGEVersion.PAGE_2019_07_15,
    ) -> None:
        xml_string = self.to_pagexml_string(
            creator=creator, validate_id=validate_id, version=version
        )
        with open(file_name, "w", encoding="utf-8") as f:
            f.write(xml_string)
