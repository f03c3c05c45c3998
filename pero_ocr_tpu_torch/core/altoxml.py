"""The ALTO XML writer with word geometry (port of
pero_ocr_tpu/core/altoxml.py), without lxml: its bytes equal the JAX
writer's ``lxml.etree.tostring(root, pretty_print=True,
encoding="utf-8", xml_declaration=True)`` on the same layout and logits.

ALTO v2: page margins and PrintSpace from the regions' bounding boxes;
per line, ``String`` elements whose boxes come from the CTC forced
alignment projected through the line's warp field, ``WC`` word
confidences and ``SP`` spaces; Arabic lines turned from label order
back to logical order.  A line that cannot be aligned gets equal-width
word boxes with confidence 0 (a warning is logged).

The tree is the Page XML writer's ``_Element``
(:mod:`pero_ocr_tpu_torch.core.pagexml`), which serializes as lxml's
pretty printer does.  The ALTO reader (JAX ``read_altoxml``) is not
ported yet (ROADMAP item 9).
"""

from __future__ import annotations

import logging
import re
from datetime import datetime, timezone
from typing import Optional, Tuple

import numpy as np

from pero_ocr_tpu_torch.core import line_geometry
from pero_ocr_tpu_torch.core.arabic import ArabicHelper
from pero_ocr_tpu_torch.core.confidence_estimation import get_line_confidence
from pero_ocr_tpu_torch.core.force_alignment import align_text
from pero_ocr_tpu_torch.core.layout import TextLine
from pero_ocr_tpu_torch.core.pagexml import _Element

logger = logging.getLogger(__name__)

_ALTO_NS = "http://www.loc.gov/standards/alto/ns-v2#"
# lxml writes the root's nsmap declarations before its attributes.
_NSMAP = (
    ("xmlns:xlink", "http://www.w3.org/1999/xlink"),
    ("xmlns:xsi", "http://www.w3.org/2001/XMLSchema-instance"),
)

# Rows of the warp field that projects aligned CTC frames back to page
# coordinates for the word boxes.
_WORD_GEOMETRY_FIELD_HEIGHT = 16


def polygon_hwvh(polygon) -> Tuple[float, float, float, float]:
    """(height, width, vpos, hpos) of a polygon's bounding box."""
    poly = np.asarray(polygon)
    h = poly[:, 1].max() - poly[:, 1].min()
    w = poly[:, 0].max() - poly[:, 0].min()
    return h, w, poly[:, 1].min(), poly[:, 0].min()


def create_ocr_processing_element(
    id: str = "IdOcr",
    software_creator_str: str = "pero_ocr_tpu project",
    software_name_str: str = "pero_ocr_tpu",
    software_version_str: str = "0.1.0",
    processing_datetime: Optional[str] = None,
) -> _Element:
    ocr_processing = _Element("OCRProcessing")
    ocr_processing.set("ID", id)
    step = ocr_processing.sub("ocrProcessingStep")
    step.sub("processingDateTime",
             processing_datetime or datetime.now(timezone.utc).isoformat())
    software = step.sub("processingSoftware")
    software.sub("softwareCreator", software_creator_str)
    software.sub("softwareName", software_name_str)
    software.sub("softwareVersion", software_version_str)
    return ocr_processing


def _align_line_words(line: TextLine, native: Optional[bool] = None):
    """Viterbi-align the line's transcription to its logits.  Returns
    (aligned letter frames, logits, logprobs, labels); raises what the
    caller answers with the uniform fallback."""
    labels = line.get_labels()
    logits = line.get_dense_logits()[line.logit_coords[0]: line.logit_coords[1]]
    logprobs = line.get_full_logprobs()[line.logit_coords[0]: line.logit_coords[1]]
    blank_idx = line.logits.shape[1] - 1
    aligned = align_text(-logprobs, labels, blank_idx, native=native)
    return aligned, logits, logprobs, labels


def _uniform_word_fallback(text_line_el: _Element, line: TextLine, line_box) -> None:
    """Equal-width word boxes with confidence 0, for a line that could
    not be aligned."""
    height, width, vpos, hpos = line_box
    line.transcription_confidence = 0
    words = line.transcription.split()
    avg_width = (hpos + width) / max(len(words), 1)
    for w, word in enumerate(words):
        string = text_line_el.sub("String")
        string.set("CONTENT", word)
        string.set("HEIGHT", str(int(height)))
        string.set("WIDTH", str(int(avg_width)))
        string.set("VPOS", str(int(vpos)))
        string.set("HPOS", str(int(hpos + w * avg_width)))


def _word_spans(transcription: str, aligned: np.ndarray):
    """Split the aligned letter frames into per-word [start_frame,
    end_frame] spans at the transcription's spaces."""
    space_idxs = [pos for pos, char in enumerate(transcription) if char == " "]
    bounds = [-1] + space_idxs + [len(aligned)]
    words = []
    for i in range(len(bounds) - 1):
        if bounds[i] != bounds[i + 1] - 1:
            words.append([aligned[bounds[i] + 1], aligned[bounds[i + 1] - 1]])
    return words


def _word_box(field: np.ndarray, span, frames_to_cols: float, line: TextLine):
    """A word's frame span projected through the warp field to page
    coordinates, the sampling window widened until it is not empty."""
    extension = 2
    all_x = all_y = np.empty(0)
    while field.size > 0 and extension < 40:
        lo = max(0, int((span[0] - extension) * frames_to_cols))
        hi = int((span[1] + extension) * frames_to_cols)
        all_x = field[:, lo:hi, 0]
        all_y = field[:, lo:hi, 1]
        if all_x.size and all_y.size:
            break
        extension += 1
    if field.size == 0 or all_x.size == 0 or all_y.size == 0:
        baseline = np.asarray(line.baseline)
        all_x = baseline[:, 0]
        all_y = np.concatenate(
            [baseline[:, 1] - line.heights[0], baseline[:, 1] + line.heights[1]]
        )
    return all_x, all_y


def _write_line_words(text_line_el: _Element, line: TextLine, arabic_helper,
                      native: Optional[bool] = None) -> None:
    aligned, logits, logprobs, labels = _align_line_words(line, native)

    field = line_geometry.warp_field(
        line.baseline, line.heights, _WORD_GEOMETRY_FIELD_HEIGHT, poly=2
    )
    words = _word_spans(line.transcription, aligned)
    split_transcription = line.transcription.split()
    frames_to_cols = field.shape[1] / logits.shape[0]

    confidences = get_line_confidence(line, labels, aligned, logprobs)
    line.transcription_confidence = float(np.quantile(confidences, 0.50))

    arabic_line = arabic_helper.is_arabic_line(line.transcription)

    letter_counter = 0
    for w, span in enumerate(words):
        all_x, all_y = _word_box(field, span, frames_to_cols, line)

        if line.transcription_confidence == 1:
            word_confidence = 1.0
        elif confidences.size:
            word_confidence = float(np.quantile(
                confidences[letter_counter: letter_counter + len(split_transcription[w])],
                0.50,
            ))
        else:
            word_confidence = None

        string = text_line_el.sub("String")
        content = split_transcription[w]
        if arabic_line:
            content = arabic_helper.label_form_to_string(content)
        string.set("CONTENT", content)
        string.set("HEIGHT", str(int(np.max(all_y) - np.min(all_y))))
        string.set("WIDTH", str(int(np.max(all_x) - np.min(all_x))))
        string.set("VPOS", str(int(np.min(all_y))))
        string.set("HPOS", str(int(np.min(all_x))))
        if word_confidence is not None:
            string.set("WC", str(round(word_confidence, 2)))

        if w != len(split_transcription) - 1:
            space = text_line_el.sub("SP")
            space.set("WIDTH", str(4))
            space.set("VPOS", str(int(np.min(all_y))))
            space.set("HPOS", str(int(np.max(all_x))))
        letter_counter += len(split_transcription[w]) + 1


def write_altoxml_string(
    layout,
    ocr_processing_element: Optional[_Element] = None,
    page_uuid: Optional[str] = None,
    min_line_confidence: float = 0,
    native: Optional[bool] = None,
) -> str:
    """The layout as ALTO XML.  ``native``: the forced alignment's route
    (:func:`~pero_ocr_tpu_torch.core.force_alignment.force_align`)."""
    arabic_helper = ArabicHelper()
    root = _Element("alto", list(_NSMAP))
    root.set("xmlns", _ALTO_NS)

    description = root.sub("Description")
    description.sub("MeasurementUnit", "pixel")
    source_info = description.sub("sourceImageInformation")
    source_info.sub("fileName", layout.id)
    description.children.append(
        ocr_processing_element
        if ocr_processing_element is not None
        else create_ocr_processing_element()
    )

    alto_layout = root.sub("Layout")
    page = alto_layout.sub("Page")
    if page_uuid is not None:
        page.set("ID", "id_" + page_uuid)
    else:
        page.set(
            "ID",
            "id_" + re.sub('[!"#$%&\'()*+,/:;<=>?@[\\]^`{|}~ ]', "_", str(layout.id)),
        )
    page.set("PHYSICAL_IMG_NR", "1")
    page.set("HEIGHT", str(layout.page_size[0]))
    page.set("WIDTH", str(layout.page_size[1]))

    top_margin = page.sub("TopMargin")
    left_margin = page.sub("LeftMargin")
    right_margin = page.sub("RightMargin")
    bottom_margin = page.sub("BottomMargin")
    print_space = page.sub("PrintSpace")

    ps_height, ps_width = 0, 0
    ps_vpos, ps_hpos = layout.page_size[0], layout.page_size[1]

    for region in layout.regions:
        text_block = print_space.sub("TextBlock")
        text_block.set("ID", f"block_{region.id}")

        blk_h, blk_w, blk_v, blk_hp = polygon_hwvh(region.polygon)
        text_block.set("HEIGHT", str(int(blk_h)))
        text_block.set("WIDTH", str(int(blk_w)))
        text_block.set("VPOS", str(int(blk_v)))
        text_block.set("HPOS", str(int(blk_hp)))

        ps_height = max(ps_vpos + ps_height, blk_v + blk_h)
        ps_width = max(ps_hpos + ps_width, blk_hp + blk_w)
        ps_vpos = min(ps_vpos, blk_v)
        ps_hpos = min(ps_hpos, blk_hp)
        ps_height -= ps_vpos
        ps_width -= ps_hpos

        for line in region.lines:
            if not line.transcription or line.transcription.strip() == "":
                continue
            text_line = text_block.sub("TextLine")
            baseline_y = int(np.average(np.asarray(line.baseline)[:, 1]))
            text_line.set("BASELINE", str(baseline_y))

            line_box = polygon_hwvh(line.polygon)
            ln_h, ln_w, ln_v, ln_hp = line_box
            text_line.set("VPOS", str(int(ln_v)))
            text_line.set("HPOS", str(int(ln_hp)))
            text_line.set("HEIGHT", str(int(ln_h)))
            text_line.set("WIDTH", str(int(ln_w)))

            try:
                _write_line_words(text_line, line, arabic_helper, native)
            except (ValueError, IndexError, TypeError, AttributeError) as e:
                logger.warning(
                    "ALTO export: unable to align line %s (%s); "
                    "falling back to uniform word boxes.", line.id, e,
                )
                _uniform_word_fallback(text_line, line, line_box)

            if (
                line.transcription_confidence is not None
                and line.transcription_confidence < min_line_confidence
            ):
                text_block.children.remove(text_line)

    top_margin.set("HEIGHT", str(int(ps_vpos)))
    top_margin.set("WIDTH", str(int(layout.page_size[1])))
    top_margin.set("VPOS", "0")
    top_margin.set("HPOS", "0")

    left_margin.set("HEIGHT", str(int(layout.page_size[0])))
    left_margin.set("WIDTH", str(int(ps_hpos)))
    left_margin.set("VPOS", "0")
    left_margin.set("HPOS", "0")

    right_margin.set("HEIGHT", str(int(layout.page_size[0])))
    right_margin.set("WIDTH", str(int(layout.page_size[1] - (ps_hpos + ps_width))))
    right_margin.set("VPOS", "0")
    right_margin.set("HPOS", str(int(ps_hpos + ps_width)))

    bottom_margin.set("HEIGHT", str(int(layout.page_size[0] - (ps_vpos + ps_height))))
    bottom_margin.set("WIDTH", str(int(layout.page_size[1])))
    bottom_margin.set("VPOS", str(int(ps_vpos + ps_height)))
    bottom_margin.set("HPOS", "0")

    print_space.set("HEIGHT", str(int(ps_height)))
    print_space.set("WIDTH", str(int(ps_width)))
    print_space.set("VPOS", str(int(ps_vpos)))
    print_space.set("HPOS", str(int(ps_hpos)))

    out = ["<?xml version='1.0' encoding='utf-8'?>\n"]
    root.write(out, 0)
    return "".join(out)
