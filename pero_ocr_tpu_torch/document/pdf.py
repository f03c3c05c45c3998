"""Two-layer searchable PDF (port of pero_ocr_tpu/document/pdf.py, the
same objects byte for byte but the font program): a JPEG image layer (a
DCTDecode XObject, the port's own encoder at quality 80, equal to
cv2.imencode) under an invisible Unicode text layer (render mode 3),
written in one pass.

The text layer embeds a TrueType font (DejaVu Sans by default,
:func:`find_unicode_font`) as a Type0/Identity-H CID font with a
ToUnicode CMap, so that non-ASCII transcriptions stay searchable.  The
font program is the port's own subset
(:meth:`pero_ocr_tpu_torch.utils.truetype.TrueTypeFont.subset`: every
glyph id kept, the used glyphs' outlines, the others empty).  Each
line's text is scaled horizontally (Tz) to span its baseline.  Page XML
is read with the port's reader and ALTO with ``xml.etree``.
"""

from __future__ import annotations

import io
import logging
import os
import xml.etree.ElementTree as ET
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from pero_ocr_tpu_torch import UnreadableImage
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.core.pagexml import element_schema
from pero_ocr_tpu_torch.utils.image_io import imread
from pero_ocr_tpu_torch.utils.jpeg import encode_jpeg
from pero_ocr_tpu_torch.utils.truetype import TrueTypeFont

logger = logging.getLogger(__name__)

_FONT_SEARCH_PATHS = (
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype",
    "/usr/share/fonts",
)


def find_unicode_font() -> Optional[str]:
    for path in _FONT_SEARCH_PATHS:
        if os.path.isfile(path):
            return path
        if os.path.isdir(path):
            for root, _, files in os.walk(path):
                for f in files:
                    if f == "DejaVuSans.ttf":
                        return os.path.join(root, f)
    try:
        import matplotlib

        candidate = os.path.join(
            matplotlib.get_data_path(), "fonts", "ttf", "DejaVuSans.ttf"
        )
        if os.path.isfile(candidate):
            return candidate
    except Exception:
        pass
    return None


class _EmbeddedFont:
    """A TrueType font prepared for Type0/Identity-H embedding: glyph ids
    (the best character map's; a code mapped past the glyph count
    draws glyph 0), widths in 1000-unit space, and a subset font
    program."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.font = TrueTypeFont(f.read())
        self.cmap = self.font.best_cmap()  # code point -> glyph id
        self.upm = self.font.units_per_em
        self._widths: Dict[int, int] = {}
        for gid in set(self.cmap.values()):
            if gid < self.font.num_glyphs:
                self._widths[gid] = int(round(self.font.advance(gid) * 1000.0 / self.upm))
        self.used_codepoints: set = set()

    def _glyph(self, code: int) -> int:
        gid = self.cmap.get(code, 0)
        return gid if gid < self.font.num_glyphs else 0

    def gid(self, ch: str) -> int:
        if ord(ch) not in self.cmap:
            return 0
        self.used_codepoints.add(ord(ch))
        return self._glyph(ord(ch))

    def encode(self, text: str) -> bytes:
        """Identity-H: 2-byte glyph ids."""
        out = bytearray()
        for ch in text:
            out += self.gid(ch).to_bytes(2, "big")
        return bytes(out)

    def text_width_units(self, text: str) -> float:
        """Width of text at size 1 (in 1000-unit text space)."""
        return sum(self._widths.get(self._glyph(ord(ch)), 500) for ch in text) / 1000.0

    def subset_bytes(self) -> bytes:
        """The font program with every glyph id kept and the outlines of
        the used code points' glyphs (the space's when none is used)."""
        codes = sorted(self.used_codepoints) or [32]
        return self.font.subset(self.cmap[c] for c in codes if c in self.cmap)

    def w_array(self) -> str:
        """PDF /W widths array for the used glyphs."""
        entries = []
        for code in sorted(self.used_codepoints):
            gid = self._glyph(code)
            entries.append(f"{gid} [{self._widths.get(gid, 500)}]")
        return "[" + " ".join(entries) + "]"

    def to_unicode_cmap(self) -> bytes:
        """ToUnicode CMap mapping glyph ids back to codepoints."""
        lines = [
            "/CIDInit /ProcSet findresource begin",
            "12 dict begin",
            "begincmap",
            "/CIDSystemInfo << /Registry (Adobe) /Ordering (UCS) /Supplement 0 >> def",
            "/CMapName /Adobe-Identity-UCS def",
            "/CMapType 2 def",
            "1 begincodespacerange",
            "<0000> <FFFF>",
            "endcodespacerange",
        ]
        mappings = []
        for code in sorted(self.used_codepoints):
            gid = self._glyph(code)
            if code <= 0xFFFF:
                mappings.append(f"<{gid:04X}> <{code:04X}>")
        for start in range(0, len(mappings), 100):
            chunk = mappings[start : start + 100]
            lines.append(f"{len(chunk)} beginbfchar")
            lines.extend(chunk)
            lines.append("endbfchar")
        lines += ["endcmap", "CMapName currentdict /CMap defineresource pop",
                  "end", "end"]
        return "\n".join(lines).encode("ascii")


class PDFBuilder:
    """Minimal PDF object writer (objects, streams, xref)."""

    def __init__(self):
        self._objects: List[Optional[bytes]] = [None]  # 1-indexed

    def reserve(self) -> int:
        self._objects.append(None)
        return len(self._objects) - 1

    def set_object(self, num: int, body: bytes) -> None:
        self._objects[num] = body

    def add(self, body: bytes) -> int:
        self._objects.append(body)
        return len(self._objects) - 1

    def stream(self, dict_entries: str, data: bytes, compress: bool = False) -> int:
        if compress:
            data = zlib.compress(data)
            dict_entries += " /Filter /FlateDecode"
        body = (
            f"<< {dict_entries} /Length {len(data)} >>\nstream\n".encode("latin-1")
            + data
            + b"\nendstream"
        )
        return self.add(body)

    def tobytes(self, root_obj: int) -> bytes:
        out = io.BytesIO()
        out.write(b"%PDF-1.5\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0] * len(self._objects)
        for i, body in enumerate(self._objects):
            if i == 0:
                continue
            offsets[i] = out.tell()
            out.write(f"{i} 0 obj\n".encode("ascii"))
            out.write(body if body is not None else b"null")
            out.write(b"\nendobj\n")
        xref_pos = out.tell()
        out.write(f"xref\n0 {len(self._objects)}\n".encode("ascii"))
        out.write(b"0000000000 65535 f \n")
        for off in offsets[1:]:
            out.write(f"{off:010d} 00000 n \n".encode("ascii"))
        out.write(
            (
                f"trailer\n<< /Size {len(self._objects)} /Root {root_obj} 0 R >>\n"
                f"startxref\n{xref_pos}\n%%EOF\n"
            ).encode("ascii")
        )
        return out.getvalue()


class TextLinePlacement:
    __slots__ = ("x", "baseline_y", "width", "height", "text")

    def __init__(self, x, baseline_y, width, height, text):
        self.x = x
        self.baseline_y = baseline_y
        self.width = width
        self.height = height
        self.text = text


def _escape(value: float) -> str:
    return f"{value:.2f}"


class SearchablePDFWriter:
    """Accumulates pages (image + text lines) and writes the document."""

    def __init__(self, font_path: Optional[str] = None):
        font_path = font_path or find_unicode_font()
        if font_path is None:
            raise RuntimeError(
                "No TrueType font found for the PDF text layer."
            )
        self.font = _EmbeddedFont(font_path)
        self.pages: List[Tuple[bytes, int, int, List[TextLinePlacement]]] = []

    def add_page(
        self,
        image_bgr: np.ndarray,
        lines: Iterable[TextLinePlacement],
        jpeg_quality: int = 80,
    ) -> None:
        h, w = image_bgr.shape[:2]
        self.pages.append((encode_jpeg(image_bgr, jpeg_quality), w, h, list(lines)))

    # ------------------------------------------------------------------
    def _page_content(self, w: int, h: int, lines: List[TextLinePlacement]) -> bytes:
        """Content stream: draw the image full-page, then invisible text.
        PDF y-axis points up; page coordinates point down."""
        ops = [f"q {w} 0 0 {h} 0 0 cm /Im0 Do Q"]
        ops.append("BT 3 Tr")  # invisible text
        for line in lines:
            if not line.text:
                continue
            size = max(line.height, 1.0)
            natural = self.font.text_width_units(line.text) * size
            tz = 100.0 * line.width / natural if natural > 0 else 100.0
            tz = float(np.clip(tz, 10.0, 500.0))
            y = h - line.baseline_y
            encoded = self.font.encode(line.text)
            hex_str = encoded.hex().upper()
            ops.append(
                f"/F1 {_escape(size)} Tf {_escape(tz)} Tz "
                f"1 0 0 1 {_escape(line.x)} {_escape(y)} Tm <{hex_str}> Tj"
            )
        ops.append("ET")
        return "\n".join(ops).encode("latin-1")

    def tobytes(self) -> bytes:
        builder = PDFBuilder()

        catalog = builder.reserve()
        pages_obj = builder.reserve()

        # Font objects (shared by all pages).
        font_file = builder.stream(
            "/Subtype /TrueType", b"", compress=False
        )  # placeholder; replaced below
        type0 = builder.reserve()
        cid_font = builder.reserve()
        descriptor = builder.reserve()
        to_unicode = builder.reserve()

        page_objs = []
        for data, w, h, lines in self.pages:
            image = builder.stream(
                "/Type /XObject /Subtype /Image "
                f"/Width {w} /Height {h} /ColorSpace /DeviceRGB "
                "/BitsPerComponent 8 /Filter /DCTDecode",
                data,
            )
            content = builder.stream(
                "", self._page_content(w, h, lines), compress=True
            )
            page = builder.add(
                (
                    f"<< /Type /Page /Parent {pages_obj} 0 R "
                    f"/MediaBox [0 0 {w} {h}] "
                    f"/Resources << /XObject << /Im0 {image} 0 R >> "
                    f"/Font << /F1 {type0} 0 R >> >> "
                    f"/Contents {content} 0 R >>"
                ).encode("ascii")
            )
            page_objs.append(page)

        # Now the real font program (subset over everything used).
        subset_data = self.font.subset_bytes()
        compressed = zlib.compress(subset_data)
        builder.set_object(
            font_file,
            (
                f"<< /Length {len(compressed)} /Length1 {len(subset_data)} "
                "/Filter /FlateDecode >>\nstream\n"
            ).encode("ascii")
            + compressed
            + b"\nendstream",
        )
        builder.set_object(
            descriptor,
            (
                "<< /Type /FontDescriptor /FontName /DejaVuSans /Flags 32 "
                "/FontBBox [-1021 -463 1793 1232] /ItalicAngle 0 /Ascent 928 "
                "/Descent -236 /CapHeight 729 /StemV 80 "
                f"/FontFile2 {font_file} 0 R >>"
            ).encode("ascii"),
        )
        builder.set_object(
            cid_font,
            (
                "<< /Type /Font /Subtype /CIDFontType2 /BaseFont /DejaVuSans "
                "/CIDSystemInfo << /Registry (Adobe) /Ordering (Identity) "
                "/Supplement 0 >> "
                f"/FontDescriptor {descriptor} 0 R /DW 500 /W {self.font.w_array()} "
                "/CIDToGIDMap /Identity >>"
            ).encode("ascii"),
        )
        cmap_data = zlib.compress(self.font.to_unicode_cmap())
        builder.set_object(
            to_unicode,
            (
                f"<< /Length {len(cmap_data)} /Filter /FlateDecode >>\nstream\n"
            ).encode("ascii")
            + cmap_data
            + b"\nendstream",
        )
        builder.set_object(
            type0,
            (
                "<< /Type /Font /Subtype /Type0 /BaseFont /DejaVuSans "
                "/Encoding /Identity-H "
                f"/DescendantFonts [{cid_font} 0 R] /ToUnicode {to_unicode} 0 R >>"
            ).encode("ascii"),
        )

        kids = " ".join(f"{p} 0 R" for p in page_objs)
        builder.set_object(
            pages_obj,
            (
                f"<< /Type /Pages /Kids [{kids}] /Count {len(page_objs)} >>"
            ).encode("ascii"),
        )
        builder.set_object(
            catalog, f"<< /Type /Catalog /Pages {pages_obj} 0 R >>".encode("ascii")
        )
        return builder.tobytes(catalog)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.tobytes())


# ----------------------------------------------------------------------
class Merger:
    """One page: its Page XML or ALTO file and its image into a PDF."""

    def __init__(self, font_path: Optional[str] = None):
        self.font_path = font_path

    def merge(self, xml_path: str, img_path: str, out_path: str) -> None:
        schema = element_schema(ET.parse(xml_path).getroot())
        if "alto" in schema.lower():
            lines = _lines_from_alto(xml_path)
        elif "page" in schema.lower():
            lines = _lines_from_pagexml(xml_path)
        else:
            raise ValueError(f"Unsupported XML type {schema}")

        try:
            image = imread(img_path)
        except (UnreadableImage, OSError):  # where cv2.imread returns None
            raise ValueError(f"Unable to read image {img_path}") from None

        writer = SearchablePDFWriter(self.font_path)
        writer.add_page(image, lines)
        writer.save(out_path)


def _lines_from_pagexml(xml_path: str) -> List[TextLinePlacement]:
    layout = PageLayout(file=xml_path)
    out = []
    for line in layout.lines_iterator():
        if not line.transcription:
            continue
        left = float(line.baseline[0][0])
        right = float(line.baseline[-1][0])
        bottom = float(line.baseline[0][1])
        height = float(line.heights[0]) if line.heights is not None else 20.0
        out.append(
            TextLinePlacement(
                left, bottom, max(right - left, 1.0), height, line.transcription
            )
        )
    return out


def _lines_from_alto(xml_path: str) -> List[TextLinePlacement]:
    tree = ET.parse(xml_path)
    schema = element_schema(tree.getroot())
    root = tree.getroot()
    page = root.findall(schema + "Layout")[0].findall(schema + "Page")[0]
    print_space = page.findall(schema + "PrintSpace")[0]
    out = []
    for block in print_space.iter(schema + "TextBlock"):
        for line in block.iter(schema + "TextLine"):
            words = " ".join(
                w.get("CONTENT") for w in line.iter(schema + "String")
            )
            if not words:
                continue
            out.append(
                TextLinePlacement(
                    float(line.attrib["HPOS"]),
                    float(line.attrib["BASELINE"]),
                    max(float(line.attrib["WIDTH"]), 1.0),
                    float(line.attrib["HEIGHT"]),
                    words,
                )
            )
    return out
