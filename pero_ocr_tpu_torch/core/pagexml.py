"""PAGE XML (de)serialization (from pero_ocr_tpu/core/pagexml.py), on the
standard library instead of lxml.

The writer is a small serializer whose bytes equal lxml's
``tostring(pretty_print=True, encoding="utf-8", xml_declaration=True)``
for the JAX writer's tree: single-quoted declaration, 2-space indent,
``<Tag attrs/>`` for empty elements, lxml's escapes, UTF-8 text kept as
is.  The reader uses ``xml.etree.ElementTree``.

Format: PRImA PAGE 2019-07-15 (and 2013-07-15), line heights in the
``custom`` attribute as ``heights_v2:[asc,desc]`` (legacy ``heights``
forms are read too), per-line ``index``, ``TextEquiv``/``Unicode``
transcripts, ``conf`` confidences, ``ReadingOrder``.
"""

from __future__ import annotations

import json
import logging
import re
import xml.etree.ElementTree as ET
from datetime import datetime, timezone
from io import BytesIO
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from pero_ocr_tpu_torch.core import line_geometry
from pero_ocr_tpu_torch.core.layout import PAGEVersion, RegionLayout, TextLine

logger = logging.getLogger(__name__)

_NS_2019 = "http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15"
_NS_2013 = "http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15"
_XSI = "http://www.w3.org/2001/XMLSchema-instance"


def element_schema(elem) -> str:
    """Extract the ``{namespace}`` prefix of an element tag."""
    tag = elem.tag
    if tag.startswith("{"):
        return tag[: tag.index("}") + 1]
    return "{None}"


def points_to_string(points: np.ndarray) -> str:
    pts = np.rint(np.asarray(points, dtype=np.float64)).astype(np.int64)
    return " ".join(f"{x},{y}" for x, y in pts.tolist())


def points_string_to_array(text: str) -> np.ndarray:
    pairs = [t.split(",") for t in text.split(" ") if t]
    return np.asarray([[int(round(float(x))), int(round(float(y)))] for x, y in pairs])


def export_id(id_: str, validate_change_id: bool) -> str:
    return "id_" + id_ if validate_change_id else id_


# ----------------------------------------------------------------------
# Reader
# ----------------------------------------------------------------------
def _read_coords(coords_element, schema) -> np.ndarray:
    if "points" in coords_element.attrib:
        return points_string_to_array(coords_element.attrib["points"])
    pts = [
        [float(pt.attrib["x"]), float(pt.attrib["y"])]
        for pt in coords_element.findall(schema + "Point")
    ]
    return np.asarray(pts)


def _parse_custom_heights(custom_str: str):
    """Heights out of a TextLine ``custom`` attribute: the current
    ``heights_v2:[asc,desc]`` form and the legacy numeric forms."""
    if "heights_v2" in custom_str:
        for word in custom_str.split():
            if "heights_v2" in word:
                return json.loads(word.split(":")[1])
        return None
    if re.findall("heights", custom_str):
        values = np.asarray([float(x) for x in re.findall(r"\d+", custom_str)])
        if values.shape[0] == 4:
            return [float(values[0]), float(values[2])]
        if values.shape[0] == 3:
            return [float(values[1]), float(values[2] - values[0])]
        return values.tolist()
    return None


def _read_reading_order(page_element, schema) -> Dict[str, int]:
    reading_order: Dict[str, int] = {}
    for ro in page_element.iter(schema + "ReadingOrder"):
        for group in ro.iter(schema + "OrderedGroup"):
            for ref in group.iter(schema + "RegionRefIndexed"):
                reading_order[ref.attrib["regionRef"]] = int(ref.attrib["index"])
    return reading_order


def read_pagexml_string(layout, pagexml_string: str) -> None:
    read_pagexml(layout, BytesIO(pagexml_string.encode("utf-8")))


def read_pagexml(layout, file: Union[str, BytesIO]) -> None:
    """Populate ``layout`` (a PageLayout) from a PAGE XML file/stream."""
    tree = ET.parse(file)
    root = tree.getroot()
    schema = element_schema(root)

    page = tree.findall(schema + "Page")[0]
    layout.id = page.attrib["imageFilename"]
    layout.page_size = (int(page.attrib["imageHeight"]), int(page.attrib["imageWidth"]))
    layout.reading_order = _read_reading_order(page, schema)

    for region_element in tree.iter(schema + "TextRegion"):
        coords_element = region_element.find(schema + "Coords")
        polygon = _read_coords(coords_element, schema)
        region_type = region_element.attrib.get("type")
        region = RegionLayout(region_element.attrib["id"], polygon, region_type)

        transcription_el = region_element.find(schema + "TextEquiv")
        if transcription_el is not None:
            region.transcription = transcription_el.find(schema + "Unicode").text or ""

        for line_index, line_element in enumerate(region_element.iter(schema + "TextLine")):
            line = TextLine(id=line_element.attrib["id"])

            custom = line_element.attrib.get("custom")
            if custom:
                line.heights = _parse_custom_heights(custom)

            index_attr = line_element.attrib.get("index")
            if index_attr is not None:
                try:
                    line.index = int(index_attr)
                except ValueError:
                    pass
            if line.index is None:
                line.index = line_index

            baseline_el = line_element.find(schema + "Baseline")
            if baseline_el is None:
                logger.warning(
                    "Baseline missing in TextLine; skipping line %s of page %s",
                    line.id, layout.id,
                )
                continue
            line.baseline = _read_coords(baseline_el, schema)

            coords_el = line_element.find(schema + "Coords")
            if coords_el is not None:
                line.polygon = _read_coords(coords_el, schema)

            if not line.heights and line.polygon is not None:
                line.heights = line_geometry.guess_heights_from_polygon(
                    line.baseline, line.polygon
                )

            transcription_el = line_element.find(schema + "TextEquiv")
            if transcription_el is not None:
                line.transcription = transcription_el.find(schema + "Unicode").text or ""
                conf = transcription_el.get("conf")
                line.transcription_confidence = float(conf) if conf is not None else None
            region.lines.append(line)

        layout.regions.append(region)


# ----------------------------------------------------------------------
# Writer
# ----------------------------------------------------------------------
# XML 1.0 Char: what lxml accepts in text and attribute values.
_NOT_XML_CHAR = re.compile("[^\t\n\r\x20-\ud7ff\ue000-\ufffd\U00010000-\U0010ffff]")
_TEXT_ESCAPES = {"&": "&amp;", "<": "&lt;", ">": "&gt;", "\r": "&#13;"}
_ATTR_ESCAPES = dict(_TEXT_ESCAPES, **{'"': "&quot;", "\n": "&#10;", "\t": "&#9;"})
_TEXT_RE = re.compile("[&<>\r]")
_ATTR_RE = re.compile('[&<>\r"\n\t]')


def _xml_str(value: str) -> str:
    if _NOT_XML_CHAR.search(value):
        raise ValueError(
            "All strings must be XML compatible: Unicode or ASCII, no NULL "
            "bytes or control characters"
        )
    return value


class _Element:
    """A node of the writer's tree: tag, ordered attributes, text and
    children (no tail text: Page XML has no mixed content)."""

    __slots__ = ("tag", "attrs", "text", "children")

    def __init__(self, tag: str, attrs: Optional[List[Tuple[str, str]]] = None):
        self.tag = tag
        self.attrs: List[Tuple[str, str]] = list(attrs or [])
        self.text: Optional[str] = None
        self.children: List["_Element"] = []

    def sub(self, tag: str, text: Optional[str] = None) -> "_Element":
        child = _Element(tag)
        if text is not None:
            child.text = _xml_str(text)
        self.children.append(child)
        return child

    def set(self, name: str, value: str) -> None:
        self.attrs.append((name, _xml_str(value)))

    def write(self, out: List[str], depth: int) -> None:
        indent = "  " * depth
        attrs = "".join(
            f' {k}="{_ATTR_RE.sub(lambda m: _ATTR_ESCAPES[m.group()], v)}"'
            for k, v in self.attrs
        )
        if self.children:
            out.append(f"{indent}<{self.tag}{attrs}>\n")
            for child in self.children:
                child.write(out, depth + 1)
            out.append(f"{indent}</{self.tag}>\n")
        elif self.text is None:
            out.append(f"{indent}<{self.tag}{attrs}/>\n")
        else:
            text = _TEXT_RE.sub(lambda m: _TEXT_ESCAPES[m.group()], self.text)
            out.append(f"{indent}<{self.tag}{attrs}>{text}</{self.tag}>\n")


def _make_root(creator: str, version: PAGEVersion) -> _Element:
    if version == PAGEVersion.PAGE_2019_07_15:
        root = _Element("PcGts", [
            ("xmlns", _NS_2019),
            ("xmlns:xsi", _XSI),
            ("xsi:schemaLocation", _NS_2019 + "/pagecontent.xsd"),
        ])
        metadata = root.sub("Metadata")
        metadata.sub("Creator", creator)
        now = datetime.now(timezone.utc).isoformat()
        metadata.sub("Created", now)
        metadata.sub("LastChange", now)
        return root
    if version == PAGEVersion.PAGE_2013_07_15:
        return _Element("PcGts", [("xmlns", _NS_2013)])
    raise ValueError(f"Unknown PAGE Version: '{version}'")


def _write_region(page_element: _Element, region: RegionLayout, validate_id: bool):
    region_element = page_element.sub("TextRegion")
    region_element.set("id", export_id(region.id, validate_id))
    if region.region_type is not None:
        region_element.set("type", region.region_type)
    region_element.sub("Coords").set("points", points_to_string(region.polygon))
    if region.transcription is not None:
        region_element.sub("TextEquiv").sub("Unicode", region.transcription)
    return region_element


def _write_line(region_element: _Element, line: TextLine, fallback_index: int,
                validate_id: bool) -> None:
    line_element = region_element.sub("TextLine")
    line_element.set("id", export_id(line.id, validate_id))
    index = line.index if line.index is not None else fallback_index
    line_element.set("index", f"{index:d}")
    if line.heights is not None:
        line_element.set("custom", f"heights_v2:[{line.heights[0]:.1f},{line.heights[1]:.1f}]")
    coords = line_element.sub("Coords")
    if line.polygon is not None:
        coords.set("points", points_to_string(line.polygon))
    if line.baseline is not None:
        line_element.sub("Baseline").set("points", points_to_string(line.baseline))
    if line.transcription is not None:
        text_el = line_element.sub("TextEquiv")
        if line.transcription_confidence is not None:
            text_el.set("conf", f"{line.transcription_confidence:.3f}")
        text_el.sub("Unicode", line.transcription)


def _write_reading_order(layout, page_element: _Element) -> None:
    group = page_element.sub("ReadingOrder").sub("OrderedGroup")
    group.set("id", "reading_order")
    for region_id, region_index in layout.reading_order.items():
        ref = group.sub("RegionRefIndexed")
        ref.set("regionRef", region_id)
        ref.set("index", str(region_index))


def write_pagexml_string(
    layout,
    creator: str = "pero_ocr_tpu",
    validate_id: bool = False,
    version: PAGEVersion = PAGEVersion.PAGE_2019_07_15,
) -> str:
    root = _make_root(creator, version)

    page = root.sub("Page")
    page.set("imageFilename", layout.id)
    page.set("imageWidth", str(layout.page_size[1]))
    page.set("imageHeight", str(layout.page_size[0]))

    if layout.reading_order is not None:
        layout.sort_regions_by_reading_order()
        _write_reading_order(layout, page)

    for region in layout.regions:
        region_element = _write_region(page, region, validate_id)
        for i, line in enumerate(region.lines):
            _write_line(region_element, line, i, validate_id)

    out = ["<?xml version='1.0' encoding='utf-8'?>\n"]
    root.write(out, 0)
    return "".join(out)
