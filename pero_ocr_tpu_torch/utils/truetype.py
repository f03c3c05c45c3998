"""A TrueType reader and glyph-id-keeping subsetter, for the searchable
PDF's embedded font (:mod:`pero_ocr_tpu_torch.document.pdf`), in place
of fontTools.

It reads the tables the PDF writer needs: the best character map
(fontTools' ``getBestCmap`` order of subtables; formats 4 and 12), as
code point -> glyph id (the writer needs no glyph names),
``head.unitsPerEm``, the advances of ``hmtx`` (``hhea``'s count of long
metrics), ``maxp.numGlyphs`` and the glyphs through ``loca``/``glyf``.
:meth:`TrueTypeFont.subset` keeps every glyph id (the PDF
addresses glyphs by id, Identity-H): the glyphs asked for, their
composite glyphs' components and ``.notdef`` keep their outlines, every
other glyph is emptied; the tables a PDF viewer does not read (layout,
kerning, math, bitmaps, signatures) are dropped and ``post`` loses its
glyph names; the checksums and ``head.checkSumAdjustment`` are computed
anew.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, List

# fontTools' getBestCmap preference: (platform, encoding) in order.
CMAP_PREFERENCES = ((3, 10), (0, 6), (0, 4), (3, 1), (0, 3), (0, 2), (0, 1), (0, 0))
# The tables a subset keeps; the rest (GSUB, GPOS, GDEF, kern, MATH, ...)
# serve text layout, which a PDF's positioned glyphs do not need.
SUBSET_TABLES = ("OS/2", "cmap", "cvt ", "fpgm", "gasp", "glyf", "head", "hhea", "hmtx",
                 "loca", "maxp", "name", "post", "prep")
# Composite glyph component flags.
_ARGS_ARE_WORDS, _HAVE_SCALE, _MORE_COMPONENTS = 0x0001, 0x0008, 0x0020
_HAVE_XY_SCALE, _HAVE_TWO_BY_TWO = 0x0040, 0x0080


def table_checksum(data: bytes) -> int:
    """The OpenType table checksum: the sum of big-endian uint32 words,
    zero-padded, modulo 2**32."""
    padded = data + b"\0" * (-len(data) % 4)
    return sum(struct.unpack(f">{len(padded) // 4}I", padded)) & 0xFFFFFFFF


class TrueTypeFont:
    """The tables of one TrueType (``glyf``-outline) font file."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        version, n_tables = struct.unpack_from(">IH", self.data, 0)
        if version not in (0x00010000, 0x74727565):
            raise ValueError(f"not a TrueType font (sfnt version {version:#010x})")
        self.tables: Dict[str, bytes] = {}
        for i in range(n_tables):
            tag, _, offset, length = struct.unpack_from(">4sIII", self.data, 12 + 16 * i)
            self.tables[tag.decode("latin-1")] = self.data[offset: offset + length]
        for tag in ("head", "maxp", "hhea", "hmtx", "loca", "glyf", "cmap"):
            if tag not in self.tables:
                raise ValueError(f"TrueType font without a '{tag}' table")
        head = self.tables["head"]
        self.units_per_em = struct.unpack_from(">H", head, 18)[0]
        self.index_to_loc_format = struct.unpack_from(">h", head, 50)[0]
        self.num_glyphs = struct.unpack_from(">H", self.tables["maxp"], 4)[0]
        self.num_hmetrics = struct.unpack_from(">H", self.tables["hhea"], 34)[0]
        loca = self.tables["loca"]
        if self.index_to_loc_format == 0:
            self.loca = [2 * v for v in struct.unpack_from(f">{self.num_glyphs + 1}H", loca)]
        else:
            self.loca = list(struct.unpack_from(f">{self.num_glyphs + 1}I", loca))

    # ------------------------------------------------------------------
    def advance(self, gid: int) -> int:
        """The glyph's advance width in font units (``hmtx``)."""
        i = min(gid, self.num_hmetrics - 1)
        return struct.unpack_from(">H", self.tables["hmtx"], 4 * i)[0]

    def glyph(self, gid: int) -> bytes:
        """The glyph's ``glyf`` record as stored (b"" for an empty glyph)."""
        return self.tables["glyf"][self.loca[gid]: self.loca[gid + 1]]

    def components(self, gid: int) -> List[int]:
        """The glyph ids a composite glyph draws (empty for a simple one)."""
        data = self.glyph(gid)
        if len(data) < 10 or struct.unpack_from(">h", data, 0)[0] >= 0:
            return []
        out, pos, flags = [], 10, _MORE_COMPONENTS
        while flags & _MORE_COMPONENTS:
            flags, component = struct.unpack_from(">HH", data, pos)
            out.append(component)
            pos += 4 + (4 if flags & _ARGS_ARE_WORDS else 2)
            if flags & _HAVE_SCALE:
                pos += 2
            elif flags & _HAVE_XY_SCALE:
                pos += 4
            elif flags & _HAVE_TWO_BY_TWO:
                pos += 8
        return out

    def best_cmap(self) -> Dict[int, int]:
        """Code point -> glyph id from the first subtable of the
        preferred (platform, encoding), as fontTools' ``getBestCmap``
        (a code mapped to glyph 0 included)."""
        cmap = self.tables["cmap"]
        n = struct.unpack_from(">H", cmap, 2)[0]
        records = [struct.unpack_from(">HHI", cmap, 4 + 8 * i) for i in range(n)]
        for platform, encoding in CMAP_PREFERENCES:
            for p, e, offset in records:
                if (p, e) == (platform, encoding):
                    return self._cmap_subtable(cmap, offset)
        return {}

    @staticmethod
    def _cmap_subtable(cmap: bytes, offset: int) -> Dict[int, int]:
        fmt = struct.unpack_from(">H", cmap, offset)[0]
        out: Dict[int, int] = {}
        if fmt == 4:
            seg_x2 = struct.unpack_from(">H", cmap, offset + 6)[0]
            n_seg = seg_x2 // 2
            ends = struct.unpack_from(f">{n_seg}H", cmap, offset + 14)
            starts = struct.unpack_from(f">{n_seg}H", cmap, offset + 16 + seg_x2)
            deltas = struct.unpack_from(f">{n_seg}h", cmap, offset + 16 + 2 * seg_x2)
            range_at = offset + 16 + 3 * seg_x2
            range_offsets = struct.unpack_from(f">{n_seg}H", cmap, range_at)
            # The last segment closes the table (0xFFFF), as fontTools reads it.
            for i in range(n_seg - 1):
                for code in range(starts[i], ends[i] + 1):
                    if range_offsets[i] == 0:
                        gid = (code + deltas[i]) & 0xFFFF
                    else:
                        at = range_at + 2 * i + range_offsets[i] + 2 * (code - starts[i])
                        gid = struct.unpack_from(">H", cmap, at)[0]
                        gid = (gid + deltas[i]) & 0xFFFF if gid else 0
                    out[code] = gid
        elif fmt == 12:
            n_groups = struct.unpack_from(">I", cmap, offset + 12)[0]
            for i in range(n_groups):
                start, end, gid = struct.unpack_from(">III", cmap, offset + 16 + 12 * i)
                for code in range(start, end + 1):
                    out[code] = gid + code - start
        else:
            raise ValueError(f"cmap subtable format {fmt} is not read (formats 4 and 12 are)")
        return out

    # ------------------------------------------------------------------
    def closure(self, gids: Iterable[int]) -> set:
        """``gids``, ``.notdef`` and every component they draw."""
        keep, todo = set(), [0, *gids]
        while todo:
            gid = todo.pop()
            if 0 <= gid < self.num_glyphs and gid not in keep:
                keep.add(gid)
                todo.extend(self.components(gid))
        return keep

    def subset(self, gids: Iterable[int]) -> bytes:
        """The font with every glyph id kept: the outlines of ``gids``,
        their components and ``.notdef``, the other glyphs empty; the
        tables of ``SUBSET_TABLES`` that the font has, ``post`` as
        format 3."""
        keep = self.closure(gids)
        glyf, offsets = bytearray(), []
        for gid in range(self.num_glyphs):
            offsets.append(len(glyf))
            if gid in keep:
                data = self.glyph(gid)
                glyf += data + b"\0" * (-len(data) % 4)
        offsets.append(len(glyf))
        tables = {tag: data for tag, data in self.tables.items() if tag in SUBSET_TABLES}
        tables["glyf"] = bytes(glyf)
        loc_format = 0 if offsets[-1] // 2 <= 0xFFFF else 1
        tables["loca"] = (struct.pack(f">{len(offsets)}H", *[o // 2 for o in offsets])
                          if loc_format == 0 else struct.pack(f">{len(offsets)}I", *offsets))
        if "post" in tables:  # format 3: no glyph names (fontTools' subsetter default)
            tables["post"] = struct.pack(">I", 0x00030000) + tables["post"][4:32]
        head = bytearray(tables["head"])
        struct.pack_into(">I", head, 8, 0)  # checkSumAdjustment, set below
        struct.pack_into(">h", head, 50, loc_format)
        tables["head"] = bytes(head)
        font = bytearray(build_sfnt(tables))
        adjustment = (0xB1B0AFBA - table_checksum(bytes(font))) & 0xFFFFFFFF
        entry = 12 + 16 * sorted(tables).index("head")  # the head table's directory entry
        head_offset = struct.unpack_from(">I", font, entry + 8)[0]
        struct.pack_into(">I", font, head_offset + 8, adjustment)
        return bytes(font)


def build_sfnt(tables: Dict[str, bytes]) -> bytes:
    """A TrueType file of ``tables``: the directory sorted by tag, each
    table 4-byte aligned with its checksum."""
    tags = sorted(tables)
    n = len(tags)
    entry_selector = n.bit_length() - 1
    search_range = 16 << entry_selector
    out = bytearray(struct.pack(">IHHHH", 0x00010000, n, search_range, entry_selector,
                                16 * n - search_range))
    offset = 12 + 16 * n
    body = bytearray()
    for tag in tags:
        data = tables[tag]
        out += struct.pack(">4sIII", tag.encode("latin-1"), table_checksum(data),
                           offset + len(body), len(data))
        body += data + b"\0" * (-len(data) % 4)
    return bytes(out + body)
