"""TIFF pages as ``cv2.imread(path, cv2.IMREAD_COLOR)`` reads them in
OpenCV 5 (libtiff 4.7), bit for bit: :func:`decode_tiff` (through
:func:`pero_ocr_tpu_torch.utils.image_io.imread`, which turns the page).

The container (:class:`Directory`): little- and big-endian, classic TIFF
and BigTIFF, the first image file directory only (a multi-page file
gives its first page), strips and tiles, PlanarConfiguration 1 and 2.

OpenCV reads an 8-bit page strip by strip (``TIFFReadRGBAStrip``) or
tile by tile (``TIFFReadRGBATile``), so its rules are libtiff's:

- **What it returns None for** ("Unable to read image" here): libtiff's
  reading of the directory (:meth:`Directory._check`: a core tag of the
  wrong type, count or value, missing strip offsets; other tags of the
  wrong type or count are dropped; missing or bad byte counts are
  estimated as ``EstimateStripByteCounts`` does); OpenCV's header check
  (PhotometricInterpretation present; SampleFormat 1 or 2, or 3 at 32
  and 64 bits; 1, 4 (palette only), 8, 10, 12, 14, 16, 32 or 64 bits,
  where more than 8 bits count as 8 for other photometrics than gray
  and RGB or other than 1, 3 or 4 samples; at most 4 samples); past it,
  OpenCV's image size limits (2^20 a side, 2^30 pixels), where it
  raises instead ("OpenCV 5 raises"); then its strip or tile limits
  (2^24 a side, a 1 GiB RGBA buffer) and libtiff's
  ``TIFFRGBAImageOK`` and ``TIFFRGBAImageBegin`` (1, 2, 4, 8 or 16
  bits; compressions that OpenCV's libtiff does not configure: old-style
  JPEG, JBIG, PixarLog, LZMA, ZSTD, WebP, LERC; photometrics it has no
  conversion for; a codec's setup that refuses the page, such as
  Predictor 3 or CCITT at more than 1 bit); and a strip or tile that
  libtiff cannot load (a byte count of 0, data past the end of the
  file, a JPEG header that does not parse).
- **Each strip or tile** is decompressed whole (:func:`_decode_chunk`):
  none, PackBits (32773), LZW (5, new and old style), Deflate (8,
  32946; Python's ``zlib`` where it fills the strip without an error),
  ThunderScan (32809), SGILog (34676, 34677) and CCITT (2, 32771, 3, 4)
  in the host C++ of ``csrc/tiff.cpp``; new-style JPEG (7) by
  ``csrc/jpeg.cpp``'s decoder (YCbCr converted to RGB, every other
  photometric's components, CMYK among them, unconverted, as libtiff
  asks libjpeg for them), the JPEGTables tag read before each
  abbreviated stream.  A compression libtiff does not know decodes to nothing.  Data
  cut short or corrupt keeps what the decoder wrote, the rest of the
  strip zero, as libtiff leaves it (then no predictor and no byte swap
  is applied).  FillOrder 2 reverses the bits of each byte before the
  decompressor (not for JPEG); Predictor 2 undoes the horizontal
  differences at 8 and 16 bits (LZW and Deflate only: libtiff ignores
  the tag elsewhere).
- **The pixels** are ``tif_getimage.c``'s (:func:`_put`), then the
  alpha is dropped: gray (MINISBLACK, MINISWHITE) at 1, 4, 8 and 16
  bits through libtiff's BWmap (16 bits: the high byte); palette at 1, 4
  and 8 bits (the colormap's high bytes when any entry is 256 or more);
  RGB at 8 bits as it is, at 16 bits ``(x + 128) // 257``, with
  unassociated alpha premultiplied ``(c * a + 127) // 255``; CMYK
  (separated, InkSet 1, 8 bits) as ``(255 - k) * (255 - c) // 255``;
  YCbCr without JPEG (subsampling 1, 2 or 4 across and down as
  libtiff's put functions take them) and CIELab at 8 and 16 bits by
  :mod:`pero_ocr_tpu_torch.utils.tiff_color`.  SampleFormat 2 samples
  are read as unsigned.  The gray and palette put functions at 8 and 16
  bits step over the hidden part of an edge tile by its pixel count,
  not its bytes, and so read an edge tile's rows skewed; that is copied.

The Orientation tag, as measured with OpenCV 5.0.0 on strips and tiles:
for 2, 3, 6 and 7 libtiff flips each strip or tile left-right in its
place (``TIFFRGBAImage``'s setorientation), then OpenCV turns the page
as its ``ApplyExifOrientation`` turns a JPEG for the value ``_THEN``
maps the tag to (so 2 mirrors each tile in its place, 3 does that and
turns the page upside down, 4 only the latter; 5-8 transpose).  A
transpose of a page that is not square makes OpenCV 5's ``imread`` fail
(its result is no longer the buffer it allocated) and return None.

SGILog pages (34676 LogL and LogLuv, 34677 LogLuv) are decoded as
``TIFFRGBAImage`` asks libtiff for them, to 8-bit gray or RGB
(``tif_luv.c``'s L16toGry and XYZtoRGB24, in ``csrc/tiff.cpp``).
"""

from __future__ import annotations

import collections
import ctypes
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from pero_ocr_tpu_torch import UnreadableImage, unreadable
from pero_ocr_tpu_torch.utils import kernels, tiff_color
from pero_ocr_tpu_torch.utils.jpeg import decode_jpeg, decode_jpeg_components, jpeg_header

# C function name (and "zlib", Python's, for Deflate strips it fills
# without an error) -> calls through these bindings
calls = collections.Counter()

TIFF_MAGICS = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_CODEC = (_I32, [_U8P, _I64, _U8P, _I64])
_SIGNATURES = {  # name: (restype, argtypes), as in csrc/tiff.cpp
    "tiff_lzw": _CODEC,
    "tiff_packbits": _CODEC,
    "tiff_deflate": _CODEC,
    "tiff_thunder": (_I32, [_U8P, _I64, _U8P, _I64, _I64, _I64]),
    "tiff_sgilog": (_I32, [_U8P, _I64, _U8P, _I64, _I64, _I64, _I32]),
    "tiff_fax_runs": (_I32, [_I32, _I32]),
    "tiff_fax": (_I32, [_U8P, _I64, _U8P, _I32, _I32, _I64, _I32, _I32, _U32P,
                        ctypes.POINTER(_I32), _I32]),
}

# Tags
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_BYTES = 273, 274, 277, 278, 279
PLANAR, T4_OPTIONS, PREDICTOR, WHITE_POINT, COLORMAP = 284, 292, 317, 318, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTES = 322, 323, 324, 325
INK_SET, EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES = 332, 338, 339, 347
YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING, REFERENCE_BLACK_WHITE = 529, 530, 532

# Compressions decoded here (none, CCITT MH, T.4, T.6, LZW, JPEG,
# Deflate twice, PackBits, CCITT RLE/W, ThunderScan; SGILog apart); those
# for which cv2 returns None: OpenCV's libtiff registers them without
# their codec (TIFFRGBAImageOK: "not configured"), or NeXT, whose codec
# takes 2-bit samples only, which OpenCV's header check refuses.  Every
# other number decodes to nothing (libtiff's "not implemented" decoder)
# and gives the page of zero samples.
_DECODED = {1, 2, 3, 4, 5, 7, 8, 32946, 32773, 32771, 32809}
_NONE = {6: "old-style JPEG", 34661: "JBIG", 32909: "PixarLog", 34925: "LZMA",
         50000: "ZSTD", 50001: "WebP", 34887: "LERC", 32766: "NeXT"}
_SGILOG = (34676, 34677)
_FAX = (2, 3, 4, 32771)
_PHOTOMETRICS = {0: "MINISWHITE", 1: "MINISBLACK", 2: "RGB", 3: "palette",
                 4: "transparency mask", 5: "separated", 6: "YCbCr", 8: "CIELab",
                 9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}

# The field types libtiff reads as integers (BYTE, SHORT, LONG, SBYTE,
# SSHORT, SLONG, IFD, LONG8, SLONG8, IFD8).
_INT_TYPES = {1, 3, 4, 6, 8, 9, 13, 16, 17, 18}
_CHUNK_TAGS = (273, 279, 324, 325)  # StripOffsets, StripByteCounts, TileOffsets, TileByteCounts

# Field types: (struct code, size); RATIONAL and SRATIONAL as two codes.
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}

_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)

# OpenCV's CV_IO_MAX_IMAGE_WIDTH / _HEIGHT and CV_IO_MAX_IMAGE_PIXELS.
MAX_IMAGE_SIDE, MAX_IMAGE_PIXELS = 1 << 20, 1 << 30

# The Orientation tag (see the module's docstring): the values libtiff
# mirrors each strip or tile for, and the EXIF turn OpenCV applies then.
_MIRRORED = (2, 3, 6, 7)
_THEN = {1: 1, 2: 1, 3: 4, 4: 4, 5: 5, 6: 7, 7: 6, 8: 8}


def is_tiff(data: bytes) -> bool:
    return data[:4] in TIFF_MAGICS


def get_library() -> ctypes.CDLL:
    """The decompressors' library, built on first use, its functions
    declared."""
    lib = kernels.library("tiff")
    if lib.tiff_lzw.argtypes is None:
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    return lib


class Directory:
    """The first image file directory of a TIFF file: ``tags`` maps a
    tag to its values (a tuple of numbers, or bytes for BYTE, ASCII and
    UNDEFINED fields; a RATIONAL as its float32 quotient).  A file whose
    header or directory libtiff cannot read raises "Unable to read
    image"."""

    def __init__(self, data: bytes, path: str = "<tiff>"):
        self.path = path
        if not is_tiff(data):
            raise ValueError(f"{path}: not a TIFF file")
        self.order = "<" if data[:2] == b"II" else ">"
        self.big = data[2:4] in (b"+\x00", b"\x00+")
        if self.big:
            if len(data) < 16:
                raise unreadable(path, "a truncated TIFF file")
            offset_size, zero, first = struct.unpack(self.order + "HHQ", data[4:16])
            if offset_size != 8 or zero != 0:
                raise unreadable(path, "a BigTIFF file with a bad header")
        else:
            if len(data) < 8:
                raise unreadable(path, "a truncated TIFF file")
            (first,) = struct.unpack(self.order + "I", data[4:8])
        self.tags: Dict[int, object] = {}  # tag -> values, or None where unreadable
        self.kinds: Dict[int, int] = {}  # tag -> field type
        self.counts: Dict[int, int] = {}  # tag -> the count its entry gives
        self.fields: Dict[int, bytes] = {}  # strip and tile tags -> their entries' fields
        self.index: Dict[int, int] = {}  # tag -> its entry's place in the directory
        count_fmt, entry_size, inline = ("Q", 20, 8) if self.big else ("H", 12, 4)
        count_size = struct.calcsize(count_fmt)
        if first + count_size > len(data) or first == 0:
            raise unreadable(path, "a TIFF file whose first directory lies past its end")
        (count,) = struct.unpack(self.order + count_fmt, data[first:first + count_size])
        base = first + count_size
        if base + count * entry_size > len(data):
            raise unreadable(path, "a TIFF file whose first directory is truncated")
        # the header, the directory and its values out of line, which
        # EstimateStripByteCounts takes from the file's size (None: an
        # entry of a type whose size libtiff does not know)
        self.space = (16 + 8 + 8 if self.big else 8 + 2 + 4) + count * entry_size
        for k in range(count):
            entry = data[base + k * entry_size: base + (k + 1) * entry_size]
            if self.big:
                tag, kind, n = struct.unpack(self.order + "HHQ", entry[:12])
                field = entry[12:20]
            else:
                tag, kind, n = struct.unpack(self.order + "HHI", entry[:8])
                field = entry[8:12]
            if kind not in _TYPES:
                self.space = None
            elif self.space is not None and n * _TYPES[kind][1] > inline:
                self.space += n * _TYPES[kind][1]
            if tag in self.kinds:
                continue  # libtiff reads a repeated tag's first entry only
            self.kinds[tag], self.counts[tag], self.index[tag] = kind, n, k
            if kind not in _TYPES:
                self.tags[tag] = None  # a type libtiff cannot read
                continue
            code, size = _TYPES[kind]
            nbytes = n * size
            if tag in _CHUNK_TAGS:  # read by chunk_arrays, with libtiff's limit
                self.fields[tag] = field
            if nbytes <= inline:
                raw = field[:nbytes]
            else:
                (offset,) = struct.unpack(self.order + ("Q" if self.big else "I"), field)
                if offset + nbytes > len(data):
                    self.tags[tag] = None if tag not in _CHUNK_TAGS else ()
                    continue  # data past the end of the file
                raw = data[offset:offset + nbytes]
            if kind in (1, 2, 7):
                self.tags[tag] = bytes(raw)
            else:
                values = struct.unpack(f"{self.order}{n * len(code)}{code[0]}", raw)
                if kind in (5, 10):  # num / den in float, 0 for a zero denominator
                    values = tuple(np.float32(a) / np.float32(b) if b else np.float32(0)
                                   for a, b in zip(values[::2], values[1::2]))
                self.tags[tag] = values

        self._check(path)

    def _check(self, path: str) -> None:
        """TIFFReadDirectory's reading of the tags: a core tag of the
        wrong type, count or value makes it fail (OpenCV returns None);
        another tag of the wrong type or count is dropped, as libtiff
        drops it (its default then holds)."""
        for tag in (WIDTH, LENGTH, TILE_WIDTH, TILE_LENGTH, ROWS_PER_STRIP, PLANAR, SAMPLES,
                    EXTRA_SAMPLES, COMPRESSION, BITS, SAMPLE_FORMAT, 280, 281):
            if tag in self.tags and self.tags[tag] is None:
                raise unreadable(path, f"a TIFF file whose tag {tag} libtiff cannot read")
        for tag in [t for t, v in self.tags.items() if v is None and t not in _CHUNK_TAGS]:
            del self.tags[tag]  # read with recovery: dropped
        spp = self._int(SAMPLES, 0xFFFF, absent=1)
        if not spp:
            raise unreadable(path, "a TIFF file whose SamplesPerPixel libtiff cannot read")
        for tag, top in ((WIDTH, 0xFFFFFFFF), (LENGTH, 0xFFFFFFFF), (TILE_WIDTH, 0xFFFFFFFF),
                         (TILE_LENGTH, 0xFFFFFFFF), (ROWS_PER_STRIP, 0xFFFFFFFF),
                         (PLANAR, 0xFFFF)):
            if tag in self.kinds and self._int(tag, top) is None:
                raise unreadable(path, f"a TIFF file whose tag {tag} libtiff cannot read")
        if self.get(ROWS_PER_STRIP) == 0 or self.get(PLANAR, 1) not in (1, 2):
            raise unreadable(path, "a TIFF file with RowsPerStrip 0 or a bad PlanarConfiguration")
        extras = self.tags.get(EXTRA_SAMPLES)
        if extras is not None and (self.kinds[EXTRA_SAMPLES] not in _INT_TYPES
                                   or len(extras) > spp
                                   or any(not 0 <= v <= 2 and v != 999 for v in extras)):
            raise unreadable(path, "a TIFF file with ExtraSamples libtiff rejects")
        if extras is not None:
            self.tags[EXTRA_SAMPLES] = tuple(2 if v == 999 else v for v in extras)
        for tag in (COMPRESSION, BITS, SAMPLE_FORMAT, 280, 281):  # Min/MaxSampleValue
            values = self.tags.get(tag)
            if values is None:
                continue
            if (self.kinds[tag] not in _INT_TYPES or not (len(values) == 1 or len(values) >= spp)
                    or len(set(values[:spp])) != 1 or not 0 <= values[0] <= 0xFFFF):
                raise unreadable(path, f"a TIFF file whose tag {tag} libtiff cannot read "
                                       f"(its type, count or values per sample)")
            self.tags[tag] = (values[0],) * max(len(values), 1)
        for tag in (340, 341):  # SMinSampleValue, SMaxSampleValue: a value a sample
            if tag in self.tags and (len(self.tags[tag]) != spp or self.kinds[tag] in (2, 7)):
                raise unreadable(path, f"a TIFF file whose tag {tag} libtiff cannot read")
        if self.get(SAMPLE_FORMAT, 1) not in range(1, 7):
            raise unreadable(path, f"a TIFF file with SampleFormat {self.get(SAMPLE_FORMAT)}")
        for tag, top in ((PHOTOMETRIC, 0xFFFF), (ORIENTATION, 0xFFFF), (FILL_ORDER, 0xFFFF),
                         (PREDICTOR, 0xFFFF), (INK_SET, 0xFFFF), (T4_OPTIONS, 0xFFFFFFFF)):
            if tag in self.tags and self._int(tag, top) is None:
                del self.tags[tag]
        for tag, count in ((YCBCR_SUBSAMPLING, 2), (REFERENCE_BLACK_WHITE, 6), (WHITE_POINT, 2),
                           (YCBCR_COEFFICIENTS, 3)):
            if tag in self.tags and (len(self.tags[tag]) != count or self.kinds[tag] in (2, 7)):
                del self.tags[tag]
        bps = self.get(BITS, 1)
        cmap = self.tags.get(COLORMAP)
        if cmap is not None and (self.kinds[COLORMAP] not in _INT_TYPES or bps > 24
                                 or len(cmap) != 3 << bps):
            del self.tags[COLORMAP]
        if self.get(PHOTOMETRIC) == 3 and COLORMAP not in self.tags:
            # libtiff reads a palette page without its colormap as gray at
            # 8 bits and more (probed: OpenCV returns None for it at three
            # samples, which libtiff turns into RGB)
            if bps < 8 or spp == 3:
                raise unreadable(path, "a palette TIFF file without a whole colormap")
            self.tags[PHOTOMETRIC] = (1,)

    def chunk_arrays(self, data: bytes, n: int, path: str) -> Tuple[tuple, tuple]:
        """The ``n`` strip or tile offsets and byte counts as
        TIFFFetchStripThing reads them: at most ``n`` values, in the
        entry where the count it gives would fit there, else from its
        offset (data past the end of the file fails the directory); fewer
        values than ``n`` padded with 0, up to 1,000,000 strips.  Byte
        counts that are missing come back as None."""
        out = []
        # libtiff keeps the strips' and the tiles' arrays in one place:
        # of a strip and a tile tag, the later entry holds
        offsets_tag, counts_tag = (
            max((t for t in pair if t in self.kinds), key=self.index.get, default=pair[0])
            for pair in ((STRIP_OFFSETS, TILE_OFFSETS), (STRIP_BYTES, TILE_BYTES)))
        if offsets_tag not in self.kinds:
            raise unreadable(path, "a TIFF file without its strip or tile offsets")
        for tag in (offsets_tag, counts_tag):
            if tag not in self.kinds:
                out.append(None)  # the byte counts: estimated, or None
                continue
            kind, count = self.kinds[tag], self.counts[tag]
            if kind not in _INT_TYPES or (count < n and n > 1_000_000):
                raise unreadable(path, f"a TIFF file whose tag {tag} libtiff cannot read")
            code, size = _TYPES[kind]
            m, inline = min(count, n), 8 if self.big else 4
            field = self.fields[tag]
            if min(count, 10) * size <= inline:
                raw = field[:m * size]
            else:
                (offset,) = struct.unpack(self.order + ("Q" if self.big else "I"), field)
                if offset + m * size > len(data):
                    raise unreadable(path, f"a TIFF file whose tag {tag} lies past its end")
                raw = data[offset:offset + m * size]
            values = struct.unpack(f"{self.order}{m}{code[0]}", raw)
            out.append(values + (0,) * (n - m))
        return out[0], out[1]

    def _int(self, tag: int, top: int, absent: int = 0) -> Optional[int]:
        """TIFFReadDirEntryShort / Long: the tag's one integer value, or
        None where its type, count or range is wrong (``absent`` where
        there is no such tag)."""
        if tag not in self.kinds:
            return absent
        values = self.tags[tag]
        if self.kinds[tag] not in _INT_TYPES or len(values) != 1 or not 0 <= values[0] <= top:
            return None
        return values[0]

    def get(self, tag: int, default=None):
        """The tag's first value, or ``default``."""
        value = self.tags.get(tag)
        return value[0] if value else default

    def values(self, tag: int) -> tuple:
        """All of the tag's values (empty when it is missing)."""
        return tuple(self.tags.get(tag, ()))


class _Page:
    """What the decoder needs to know of the page, checked as OpenCV and
    libtiff check it before the first strip."""

    def __init__(self, d: Directory, data: bytes, path: str):
        self.d, self.path = d, path
        self.width, self.height = d.get(WIDTH), d.get(LENGTH)
        if not self.width or not self.height:
            raise unreadable(path, "a TIFF file without a width or a length")
        # the strips or tiles, as TIFFReadDirectory sets them up
        self.tiled = TILE_WIDTH in d.tags or TILE_LENGTH in d.tags
        if self.tiled:
            self.cw, self.ch = d.get(TILE_WIDTH, 0), d.get(TILE_LENGTH, 0)
            if self.cw <= 0 or self.ch <= 0:
                raise unreadable(path, "a tiled TIFF file without a tile size")
        else:
            self.cw = self.width
            rows = d.get(ROWS_PER_STRIP, 2 ** 32 - 1)
            self.ch = self.height if rows == 2 ** 32 - 1 else min(rows, self.height)
        self.across, self.down = -(-self.width // self.cw), -(-self.height // self.ch)
        self.planes = d.get(SAMPLES, 1) if d.get(PLANAR, 1) == 2 else 1
        self.offsets, self.counts = d.chunk_arrays(
            data, self.across * self.down * self.planes, path)
        if self.counts is None and (len(self.offsets) != (
                d.get(SAMPLES, 1) if d.get(PLANAR, 1) == 2 else 1) or d.space is None):
            raise unreadable(path, "a TIFF file without its StripByteCounts")
        self.photometric = d.get(PHOTOMETRIC)
        compression = self.compression = d.get(COMPRESSION, 1)
        self.spp = spp = d.get(SAMPLES, 1)
        self.planar = 1 if spp == 1 else d.get(PLANAR, 1)
        self.jpeg_rgb = compression == 7 and self.photometric == 6 and self.planar == 1
        self.subsampling = (1, 1)
        if self.photometric == 6 and not self.jpeg_rgb:
            self.subsampling = tuple(d.values(YCBCR_SUBSAMPLING)[:2]) or (2, 2)
        self._repair_counts(d, len(data))
        if self.photometric is None:
            raise unreadable(path, "a TIFF file without a PhotometricInterpretation tag")
        bits = d.values(BITS) or (1,)
        if len(set(bits)) != 1:
            raise unreadable(path, f"a TIFF file with samples of {sorted(set(bits))} bits")
        self.bps = bps = bits[0]
        fmt = d.values(SAMPLE_FORMAT) or (1,)
        if len(set(fmt)) != 1:  # libtiff reads no such directory
            raise unreadable(path, f"a TIFF file with SampleFormat {fmt}")
        photometric = self.photometric
        # OpenCV's header check (which a three-sample LogLuv page skips,
        # as OpenCV's HDR reader): more than 8 bits count as 8 for other
        # photometrics than gray and RGB, or samples other than 1, 3, 4;
        # SampleFormat 1 or 2 (3 too at 32 and 64 bits); at most 4 samples.
        if not (photometric == 32845 and spp == 3):
            header_bits = 8 if bps > 8 and (photometric > 2 or spp not in (1, 3, 4)) else bps
            if fmt[0] not in (1, 2) and not (fmt[0] == 3 and header_bits in (32, 64)):
                raise unreadable(path, f"a TIFF file with SampleFormat {fmt[0]} at {bps} bits")
            if header_bits not in (1, 4, 8, 10, 12, 14, 16, 32, 64) or (
                    header_bits == 4 and photometric != 3):
                raise unreadable(path, f"a TIFF file with {bps}-bit samples "
                                       f"(PhotometricInterpretation {photometric})")
            if spp > 4:
                raise unreadable(path, f"a TIFF file with {spp} samples a pixel")
        # imread's validateInputImageSize, between the header and the
        # data: past it OpenCV raises rather than return None.
        width, height = self.width, self.height
        if width > MAX_IMAGE_SIDE or height > MAX_IMAGE_SIDE or width * height > MAX_IMAGE_PIXELS:
            raise ValueError(f"{path}: OpenCV 5 raises an error for a {width}x{height} image "
                             f"(its image size limits)")
        # OpenCV's readData: the strip or tile it reads at a time
        # (RowsPerStrip as the tag gives it) and the samples
        rows = d.get(ROWS_PER_STRIP, 2 ** 32 - 1)
        tile = (self.cw, self.ch) if self.tiled else (width, height if rows == 2 ** 32 - 1 else rows)
        if spp > 4 or bps > 64 or not all(0 < v <= 1 << 24 for v in tile) or (
                tile[0] * tile[1] * spp * max(1, bps // 8) >= 1 << 30
                or 4 * tile[0] * tile[1] >= 1 << 30):  # the RGBA buffer
            raise unreadable(path, f"a TIFF file of {spp} samples of {bps} bits in strips or "
                                   f"tiles of {tile[0]}x{tile[1]}")
        # TIFFRGBAImageOK and TIFFRGBAImageBegin
        if compression in _NONE:
            raise unreadable(path, f"{_NONE[compression]} compression")
        if bps not in (1, 2, 4, 8, 16) or fmt[0] == 3:
            raise unreadable(path, f"a TIFF file with {bps}-bit samples of format {fmt[0]}")
        self.sgilog = None
        if photometric in (32844, 32845) or compression in _SGILOG:
            self._check_sgilog(d, path)
            photometric, bps = self.photometric, self.bps
        self.extras = d.values(EXTRA_SAMPLES)
        colour = spp - len(self.extras)
        what = _PHOTOMETRICS.get(photometric, f"PhotometricInterpretation {photometric}")
        if photometric in (0, 1, 3):
            if self.planar == 1 and spp != 1 and bps < 8:
                raise unreadable(path, f"a {what} TIFF file with {spp} contiguous samples "
                                       f"of {bps} bits")
        elif photometric == 2:
            if colour < 3:
                raise unreadable(path, "an RGB TIFF file with fewer than three colour samples")
        elif photometric == 5:
            if d.get(INK_SET, 1) != 1 or spp < 4:
                raise unreadable(path, "a separated TIFF file that is not CMYK")
        elif photometric == 8:
            if spp != 3 or colour != 3 or bps not in (8, 16):
                raise unreadable(path, f"a CIELab TIFF file with {spp} samples of {bps} bits")
        elif photometric != 6:
            raise unreadable(path, f"a {what} TIFF file")
        self.alpha = _alpha_kind(self.extras, spp)
        self.kind = self._pick()
        if self.kind is None:
            raise unreadable(path, f"a {what} TIFF file of {spp} samples of {bps} bits "
                                   f"(planar {self.planar}): libtiff cannot handle its format")
        # libtiff knows the Predictor tag only for the codecs that take it
        # (here LZW and Deflate); for the others it is an unknown tag.
        self.predictor = d.get(PREDICTOR, 1) if compression in (5, 8, 32946) else 1
        if self.predictor not in (1, 2) or (self.predictor == 2 and bps not in (8, 16)):
            raise unreadable(path, f"a TIFF file with Predictor {self.predictor} at {bps} bits")
        if compression in _FAX and bps != 1:
            raise unreadable(path, f"a CCITT TIFF file with {bps}-bit samples")
        if compression == 32809 and bps != 4:
            raise unreadable(path, f"a ThunderScan TIFF file with {bps}-bit samples")

    def _check_sgilog(self, d: Directory, path: str) -> None:
        """LogL and LogLuv pages: TIFFRGBAImageBegin has SGILog decode
        them to 8-bit gray or RGB (SGILOGDATAFMT_8BIT), which the page
        then reads as MINISBLACK or RGB at 8 bits; other photometrics
        with SGILog compression fail the codec's setup."""
        photometric, compression, spp = self.photometric, self.compression, self.spp
        colour = spp - len(d.values(EXTRA_SAMPLES))
        if photometric == 32844 and compression == 34676 and spp == 1:
            self.sgilog, self.photometric = 0, 1
        elif (photometric == 32845 and compression in _SGILOG and d.get(PLANAR, 1) == 1
              and spp == 3 and colour == 3):
            self.sgilog, self.photometric = (1 if compression == 34676 else 2), 2
        else:
            what = _PHOTOMETRICS.get(photometric, f"PhotometricInterpretation {photometric}")
            raise unreadable(path, f"a {what} TIFF file with compression {compression}")
        self.bps = 8

    def _repair_counts(self, d: Directory, file_size: int) -> None:
        """TIFFReadDirectory's repairs of the byte counts: missing ones
        (one strip, or one a plane), a single strip's that looks bad (0,
        or, uncompressed, past the end of the file or short of the image),
        or uncompressed counts that differ between the first two of three
        or more contiguous strips or tiles, get EstimateStripByteCounts'
        estimate.  (OpenCV's libtiff chops no single strip into smaller
        ones: a RowsPerStrip past OpenCV's limit stays there.)"""
        offsets, counts = list(self.offsets), self.counts
        nstrips = len(offsets)
        compressed = self.compression != 1
        sh, sv = self.subsampling
        subsampled = self.photometric == 6 and (sh, sv) != (1, 1) and self.planar == 1
        nsamp = self.spp if self.planar == 1 else 1
        bits = d.get(BITS, 1)  # the file's, before an SGILog page reads at 8
        if subsampled:
            block_row = -(-self.width // sh) * (sh * sv + 2) * bits // 8
            scanline = block_row // sv
        else:
            scanline = -(-self.width * nsamp * bits // 8)

        def estimate() -> list:
            if compressed:  # the file less its header, directory and values
                space = file_size - d.space if file_size >= d.space else file_size
                out = [space // self.spp if self.planar == 2 else space] * nstrips
                if offsets[-1] + out[-1] > file_size:
                    out[-1] = max(0, file_size - offsets[-1])
                return out
            if self.tiled:
                return [-(-self.cw * nsamp * bits // 8) * self.ch] * nstrips
            return [scanline * (self.height // (nstrips // self.planes))] * nstrips

        if counts is None:
            counts = estimate()
        counts = list(counts)
        if nstrips == 1 and not self.tiled and offsets[0] and (counts[0] == 0 or not compressed and (
                offsets[0] <= file_size and counts[0] > file_size - offsets[0]
                or counts[0] < scanline * self.height)):
            counts = estimate()
        elif (not compressed and self.planar == 1 and nstrips > 2 and counts[0] != counts[1]
              and counts[0] and counts[1]):
            counts = estimate()
        self.offsets, self.counts = tuple(offsets), tuple(counts)

    def _pick(self) -> Optional[str]:
        """PickContigCase / PickSeparateCase: the put function's kind, or
        None where libtiff has none."""
        p, bps, spp = self.photometric, self.bps, self.spp
        if self.jpeg_rgb:
            p = 2
        if self.planar == 2:
            if p in (0, 1, 2) and bps in (8, 16):
                return "separate"
            if p == 5 and bps == 8 and spp == 4:
                return "cmyk"
            if p == 6 and bps == 8 and spp == 3 and self.subsampling == (1, 1):
                return "ycbcr"
            return None
        if p in (0, 1):
            return "gray"
        if p == 2 and bps in (8, 16):
            return "rgb"
        if p == 3 and bps != 16:
            return "palette"
        if p == 5 and bps == 8:
            return "cmyk"
        if p == 6 and bps == 8 and spp == 3 and self.subsampling in (
                (4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)):
            return "ycbcr"
        if p == 8:
            return "cielab"
        return None


def decode_tiff(data: bytes, path: str = "<tiff>") -> Tuple[np.ndarray, int]:
    """A TIFF file's bytes -> (BGR uint8 (H, W, 3), the EXIF orientation
    that turns it into what ``cv2.imread(path, cv2.IMREAD_COLOR)``
    returns: :func:`pero_ocr_tpu_torch.utils.image_io.apply_orientation`'s
    argument).  Raises "Unable to read image" (naming ``path``) where
    OpenCV returns None."""
    d = Directory(data, path)
    page = _Page(d, data, path)
    orientation = d.get(ORIENTATION, 1)
    if not 1 <= orientation <= 8:
        orientation = 1  # libtiff drops a bad value and takes the default
    if orientation >= 5 and page.width != page.height:
        raise unreadable(path, f"a {page.width}x{page.height} TIFF page whose Orientation "
                               f"tag ({orientation}) transposes it")
    return _read(page, data, mirror=orientation in _MIRRORED), _THEN[orientation]


def _read(page: _Page, data: bytes, mirror: bool) -> np.ndarray:
    """The page's BGR, (H, W, 3) uint8: each strip or tile (all its
    planes) decoded and put as libtiff puts it."""
    out = np.empty((page.height, page.width, 3), np.uint8)
    runs = _fax_runs(page) if page.compression in _FAX else None
    per_plane = page.across * page.down
    tables = _tables(page)
    for row in range(page.down):
        for col in range(page.across):
            index = row * page.across + col
            y0, x0 = row * page.ch, col * page.cw
            rows = page.ch if page.tiled else min(page.ch, page.height - y0)
            h = min(page.ch, page.height - y0)
            w = min(page.cw, page.width - x0)
            planes = [_decode_chunk(page, data, index + k * per_plane, rows, runs, first=k == 0)
                      for k in range(page.planes)]
            part = _put(page, planes, rows, w, h, tables)
            if mirror:
                part = part[:, ::-1]
            # gray: three equal channels; RGB: reversed
            if part.ndim == 3:
                out[y0:y0 + h, x0:x0 + w] = part[:, :, ::-1]
            elif w == page.width:  # whole rows: one contiguous run of bytes
                out[y0:y0 + h].reshape(-1)[:] = np.repeat(part.reshape(-1), 3)
            else:
                out[y0:y0 + h, x0:x0 + w] = part[:, :, None]
    return out


# ----------------------------------------------------------------------
# Decompression
def _chunk_geometry(page: _Page, rows: int) -> Tuple[int, int, int]:
    """(bytes a row, rows, the bytes libtiff decodes) of a strip or tile
    of ``rows`` rows as libtiff sizes it.  Subsampled YCbCr counts rows of
    sampling blocks, and a strip reads its rows times TIFFScanlineSize,
    a block row's size divided by the vertical subsampling, rounded
    down: the last bytes of each strip are then never decoded."""
    nsamp = page.spp if page.planar == 1 else 1
    sh, sv = page.subsampling
    if page.kind == "ycbcr" and page.planar == 1 and (sh, sv) != (1, 1):
        row_bytes = -(-page.cw // sh) * (sh * sv + 2) * page.bps // 8
        block_rows = -(-rows // sv)
        read = block_rows * row_bytes if page.tiled else block_rows * sv * (row_bytes // sv)
        return row_bytes, block_rows, read
    row_bytes = -(-page.cw * nsamp * page.bps // 8)
    return row_bytes, rows, row_bytes * rows


def _decode_chunk(page: _Page, data: bytes, index: int, rows: int, runs,
                  first: bool = True) -> Tuple[np.ndarray, bool]:
    """One strip or tile -> (its decoded bytes, whether the decoder
    succeeded): what libtiff leaves in the zeroed buffer that
    ``_TIFFReadEncodedStripAndAllocBuffer`` allocates for the first plane
    (a strip it cannot load raises "Unable to read image") and the later
    planes share (``TIFFReadEncodedStrip``, whose failures
    ``gtStripSeparate`` ignores)."""
    path = page.path
    start, n = page.offsets[index], page.counts[index]
    row_bytes, block_rows, size = _chunk_geometry(page, rows)
    out = np.zeros(row_bytes * block_rows, np.uint8)
    # an uncompressed tile must hold its size to the byte
    if n == 0 or start + n > len(data) or (
            page.tiled and page.compression == 1 and n != out.size):
        if first:
            raise unreadable(path, "a TIFF file whose strip or tile has no bytes or lies "
                                   "past its end")
        return (np.zeros((rows, page.cw, 1), np.uint8) if page.compression == 7 else out), False
    raw = data[start:start + n]
    compression = page.compression
    if compression == 7:
        last = not page.tiled and index % (page.across * page.down) == page.down - 1
        try:
            return _decode_jpeg(page, raw, rows, last), True
        except UnreadableImage:
            if first:
                raise
            return np.zeros((rows, page.cw, 1), np.uint8), False
    if page.d.get(FILL_ORDER, 1) == 2:
        raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
    if compression == 1:
        ok = len(raw) >= size
        if ok:
            out[:size] = np.frombuffer(raw, np.uint8, size)
    elif compression in _DECODED or page.sgilog is not None:
        ok = _native(page, raw, out[:size], rows, row_bytes, runs, start)
    else:  # a compression libtiff does not know
        ok = False
    return out, ok


def _native(page: _Page, raw: bytes, out: np.ndarray, rows: int, row_bytes: int, runs,
            start: int) -> bool:
    lib = get_library()
    src = ctypes.cast(ctypes.c_char_p(raw), _U8P)
    dst = out.ctypes.data_as(_U8P)
    compression = page.compression
    if compression in _FAX:
        calls["tiff_fax"] += 1
        two_d = page.d.get(T4_OPTIONS, 0) & 1 if compression == 3 else 0
        runs, mode = runs
        rc = lib.tiff_fax(src, len(raw), dst, page.cw, rows, row_bytes, compression, two_d,
                          runs.ctypes.data_as(_U32P), mode.ctypes.data_as(ctypes.POINTER(_I32)),
                          start & 1)
    elif page.sgilog is not None:
        calls["tiff_sgilog"] += 1
        rc = lib.tiff_sgilog(src, len(raw), dst, page.cw, rows, row_bytes, page.sgilog)
    elif compression == 32809:
        calls["tiff_thunder"] += 1
        rc = lib.tiff_thunder(src, len(raw), dst, page.width, rows, row_bytes)
    elif compression in (8, 32946) and _inflate(raw, out):
        return True
    else:
        name = {5: "tiff_lzw", 32773: "tiff_packbits", 8: "tiff_deflate",
                32946: "tiff_deflate"}[compression]
        calls[name] += 1
        rc = getattr(lib, name)(src, len(raw), dst, out.size)
    if rc < 0:
        raise MemoryError(f"{page.path}: out of memory decoding a TIFF strip")
    return rc == 1


def _inflate(raw: bytes, out: np.ndarray) -> bool:
    """A Deflate strip through Python's zlib, where zlib fills the strip
    without an error: the same bytes, and the same success, as libtiff's
    single inflate call (which, the strip full, parses on until a symbol
    needs room, as zlib does here at ``max_length``).  False otherwise:
    ``tiff_deflate`` then decodes it as libtiff leaves data cut short or
    corrupt, which Python's zlib, dropping a failed call's output, cannot
    show."""
    calls["zlib"] += 1
    try:
        buf = zlib.decompressobj().decompress(raw, out.size)
    except zlib.error:
        return False
    if len(buf) != out.size:
        return False
    out[:] = np.frombuffer(buf, np.uint8)
    return True


def _fax_runs(page: _Page) -> Tuple[np.ndarray, np.ndarray]:
    """The CCITT decoders' run arrays and mode, zeroed once for the page
    as libtiff sets them up once for the directory."""
    two_d = page.compression == 4 or (page.compression == 3 and page.d.get(T4_OPTIONS, 0) & 1)
    n = get_library().tiff_fax_runs(page.cw, 1 if two_d else 0)
    return np.zeros(2 * n + 1, np.uint32), np.zeros(1, np.int32)


def _decode_jpeg(page: _Page, raw: bytes, rows: int, last: bool) -> np.ndarray:
    """A JPEG strip or tile as tif_jpeg.c decodes it: the components
    (RGB from YCbCr with JPEGCOLORMODE_RGB, else as they are) in a
    (rows, width, components) array, what the stream lacks zero.  A
    stream whose header libtiff refuses raises "Unable to read image"
    (the page's last strip may be taller than its rows)."""
    path = page.path
    tables = page.d.tags.get(JPEG_TABLES)
    if tables and raw[:2] == b"\xff\xd8":
        raw = _jpeg_tables(tables, path) + raw[2:]
    nsamp = page.spp if page.planar == 1 else 1
    height, width, comps, _ = jpeg_header(raw, path)
    want = (1, 1)
    if page.photometric == 6 and page.planar == 1:
        want = tuple(page.d.values(YCBCR_SUBSAMPLING)[:2]) or (2, 2)
    sampling = _jpeg_sampling(raw)
    if comps != nsamp or not sampling or sampling[0] != want or any(
            s != (1, 1) for s in sampling[1:]):
        raise unreadable(path, f"a JPEG TIFF strip of {comps} components sampled {sampling} "
                               f"(libtiff wants {nsamp}, {want})")
    if width > page.cw or (height > rows and not (width == page.cw and last)):
        raise unreadable(path, f"a {width}x{height} JPEG TIFF strip in a {page.cw}x{rows} one")
    # libtiff has libjpeg convert YCbCr to RGB (JPEGCOLORMODE_RGB) and
    # hands every other photometric's components through (JCS_UNKNOWN).
    comps = decode_jpeg(raw, path)[:, :, ::-1] if page.jpeg_rgb else decode_jpeg_components(
        raw, path)
    out = np.zeros((rows, page.cw, nsamp), np.uint8)
    h, w = min(rows, height), width
    out[:h, :w] = comps[:h]
    return out


def _jpeg_tables(tables: bytes, path: str) -> bytes:
    """The bytes libjpeg reads of the JPEGTables stream before its EOI,
    as libtiff has it read them on their own (jpeg_read_header(FALSE)):
    markers found past garbage and fill bytes, a segment that runs past
    the end read on into the fake EOI markers libtiff's source inserts
    there.  Each strip's stream follows them without its SOI.  A stream
    that does not start with SOI, or that reaches a scan, makes libtiff
    call the tag bogus."""
    if tables[:2] != b"\xff\xd8":
        raise unreadable(path, "a JPEG TIFF file whose JPEGTables do not start with SOI")
    fake = b"\xff\xd9"
    pos, n = 2, len(tables)
    while True:
        while pos < n and tables[pos] != 0xFF:
            pos += 1
        while pos < n and tables[pos] == 0xFF:
            pos += 1
        if pos >= n:  # the fake EOI ends the tables
            return tables
        marker = tables[pos]
        pos += 1
        if marker == 0xD9:
            return tables[:pos - 2]
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC) or marker == 0xDA:
            raise unreadable(path, "a JPEG TIFF file whose JPEGTables hold a frame or a scan")
        head = (tables + fake * 2)[pos:pos + 2]
        length = (head[0] << 8) | head[1]
        if pos + length > n:
            padded = tables + fake * ((pos + length - n) // 2 + 1)
            return padded[:pos + length]
        pos += length


def _jpeg_sampling(stream: bytes) -> list:
    """The (h, v) sampling factors of a JPEG stream's frame components
    (empty without a frame header), its markers found as libjpeg's
    next_marker finds them: bytes before an FF and FF fill bytes
    skipped."""
    pos, n = 2, len(stream)
    while pos < n:
        while pos < n and stream[pos] != 0xFF:
            pos += 1
        while pos < n and stream[pos] == 0xFF:
            pos += 1
        if pos >= n:
            return []
        marker = stream[pos]
        pos += 1
        if marker in (0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        if marker in (0xD9, 0xDA) or pos + 2 > n:
            return []
        (length,) = struct.unpack(">H", stream[pos:pos + 2])
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            count = stream[pos + 7] if pos + 7 < n else 0
            body = stream[pos + 8:pos + 8 + 3 * count]
            return [(body[3 * k + 1] >> 4, body[3 * k + 1] & 15) for k in range(len(body) // 3)]
        pos += length


# ----------------------------------------------------------------------
# The pixels
def _alpha_kind(extras: tuple, spp: int) -> int:
    """libtiff's ``img->alpha``: 1 associated, 2 unassociated, 0 none.
    An unspecified extra sample counts as associated alpha beyond three
    samples."""
    if not extras:
        return 0
    if extras[0] == 0:
        return 1 if spp > 3 else 0
    return extras[0] if extras[0] in (1, 2) else 0


def _tables(page: _Page):
    d = page.d
    if page.kind == "ycbcr":
        luma = d.values(YCBCR_COEFFICIENTS)[:3]
        refbw = d.values(REFERENCE_BLACK_WHITE)[:6]
        luma = tuple(np.float32(v) for v in luma) if len(luma) == 3 else tiff_color.DEFAULT_LUMA
        if len(refbw) != 6:
            refbw = tiff_color.default_reference_black_white(page.bps)
        if not np.isfinite(luma).all() or luma[1] == 0:
            raise unreadable(page.path, "a YCbCr TIFF file with bad YCbCrCoefficients")
        refbw = tuple(np.float32(v) for v in refbw)
        if not all(np.float32(-0x7FFFFFFF + 128) < v < np.float32(0x7FFFFFFF) for v in refbw):
            raise unreadable(page.path, "a YCbCr TIFF file with bad ReferenceBlackWhite")
        return tiff_color.ycbcr_tables(luma, refbw)
    if page.kind == "cielab":
        white = d.values(WHITE_POINT)[:2]
        white = tuple(np.float32(v) for v in white) if len(white) == 2 else \
            tiff_color.DEFAULT_WHITE_POINT
        if white[1] == 0:
            raise unreadable(page.path, "a CIELab TIFF file with a bad WhitePoint")
        return tiff_color.cielab_tables(white)
    if page.kind == "palette":
        cmap = np.asarray(d.values(COLORMAP), np.uint16).reshape(3, 1 << page.bps)
        cmap = (cmap >> 8) if (cmap >= 256).any() else (cmap & 0xFF)
        return np.ascontiguousarray(cmap.T.astype(np.uint8))
    return None


def _samples(page: _Page, buf: np.ndarray, ok: bool, w: int, h: int, nsamp: int) -> np.ndarray:
    """The (h, w, nsamp) samples a put function reads from a decoded
    strip or tile: uint8, or uint16 at 16 bits (in the file's byte order
    where the decoder succeeded, little-endian where it failed and
    libtiff swapped nothing); sub-byte samples unpacked.  The gray and
    palette put functions step over an edge tile's hidden part by its
    pixel count (libtiff's fromskew), which this reproduces."""
    bps, cw = page.bps, page.cw
    row_bytes = -(-cw * nsamp * bps // 8)
    if bps < 8:
        per_byte = 8 // bps
        used = -(-w * nsamp // per_byte)
        step = used + (cw - w) // per_byte
    else:
        used = w * nsamp * bps // 8
        skewed = page.kind in ("gray", "palette") and (nsamp > 1 or bps == 16)
        step = used + (cw - w) if skewed else row_bytes
    if step == row_bytes:
        part = buf[:h * row_bytes].reshape(h, row_bytes)[:, :used]
    else:
        part = buf[np.arange(h)[:, None] * step + np.arange(used)[None, :]]
    if bps == 16:
        samples = part.view((page.d.order if ok else "<") + "u2").astype(np.uint16)
    elif bps == 8:
        samples = part
    elif bps == 1:
        samples = np.unpackbits(part, axis=1, count=w * nsamp)
    else:
        shifts = np.arange(8 - bps, -1, -bps, dtype=np.uint8)
        samples = ((part[:, :, None] >> shifts) & ((1 << bps) - 1)).reshape(h, -1)[:, :w * nsamp]
    return samples.reshape(h, w, nsamp)


def _predicted(page: _Page, buf: np.ndarray, ok: bool, rows: int) -> np.ndarray:
    """Predictor 2 undone on a decoded strip or tile that decoded whole
    (libtiff applies it after a successful decode only)."""
    if page.predictor != 2 or not ok:
        return buf
    nsamp = page.spp if page.planar == 1 else 1
    if page.bps == 8:
        a = buf.reshape(rows, page.cw, nsamp)
        return np.cumsum(a, axis=1, dtype=np.uint8).reshape(-1)
    order = page.d.order + "u2"
    a = buf.view(order).reshape(rows, page.cw, nsamp)
    return np.cumsum(a, axis=1, dtype=np.uint16).astype(order).view(np.uint8).reshape(-1)


def _put(page: _Page, planes, rows: int, w: int, h: int, tables) -> np.ndarray:
    """``tif_getimage.c``'s put function for one strip or tile: its
    (h, w, 3) RGB, or (h, w) where r = g = b (gray)."""
    kind, bps = page.kind, page.bps
    if page.compression == 7:
        s = np.concatenate([buf[:h, :w] for buf, _ in planes], axis=2)
    elif kind == "ycbcr" and page.planar == 1 and page.subsampling != (1, 1):
        return _put_ycbcr_subsampled(page, planes[0][0], w, h, tables)
    else:
        nsamp = page.spp if page.planar == 1 else 1
        parts = [_samples(page, _predicted(page, buf, ok, rows), ok, w, h, nsamp)
                 for buf, ok in planes]
        s = np.concatenate(parts, axis=2) if len(parts) > 1 else parts[0]
    p = 2 if page.jpeg_rgb else page.photometric
    if kind == "gray":
        gray = s[:, :, 0]
        if bps == 16:
            gray, top = (gray >> 8).astype(np.uint8), 255
        else:
            top = (1 << bps) - 1
        x = np.arange(top + 1)
        table = (((top - x) if p == 0 else x) * 255 // top).astype(np.uint8)
        return table[gray]
    if kind == "palette":
        return tables[s[:, :, 0]]
    if kind in ("rgb", "separate"):
        colour = 3 if p == 2 else 1
        colors = s[:, :, :3] if colour == 3 else np.repeat(s[:, :, :1], 3, 2)
        a = s[:, :, colour] if page.alpha and s.shape[2] > colour else None
        if bps == 16:
            colors = _to8(colors)
            a = _to8(a) if a is not None else None
        colors = colors.astype(np.uint8)
        if page.alpha == 2 and a is not None:
            return _premultiply(colors, a.astype(np.uint32))
        return np.ascontiguousarray(colors)
    if kind == "cmyk":
        k = 255 - s[:, :, 3].astype(np.uint32)
        return (k[:, :, None] * (255 - s[:, :, :3].astype(np.uint32)) // 255).astype(np.uint8)
    if kind == "ycbcr":
        return tiff_color.ycbcr_to_rgb(s[:, :, 0], s[:, :, 1], s[:, :, 2], tables)
    signed = np.int8 if bps == 8 else np.int16
    return tiff_color.cielab_to_rgb(s[:, :, 0], s[:, :, 1].view(signed), s[:, :, 2].view(signed),
                                    bps, tables)


def _put_ycbcr_subsampled(page: _Page, buf: np.ndarray, w: int, h: int, tables) -> np.ndarray:
    """putcontig8bitYCbCr{44,42,41,22,21,12}tile: each block of sh x sv
    luma samples, then Cb and Cr; a pixel takes the luma sample at its
    place in its block and the block's chroma."""
    sh, sv = page.subsampling
    nb = sh * sv + 2
    used = -(-w // sh) * nb
    # the hidden part of an edge tile, skipped as whole blocks; the 4x4
    # put function counts 10 bytes a block there, not 18
    skip = (page.cw - w) // sh * (10 if (sh, sv) == (4, 4) else nb)
    brows = -(-h // sv)
    blocks = -(-w // sh)
    b = buf[np.arange(brows)[:, None] * (used + skip) + np.arange(used)[None, :]]
    b = b.reshape(brows, blocks, nb)
    luma = b[:, :, :sh * sv].reshape(brows, blocks, sv, sh).transpose(0, 2, 1, 3)
    luma = luma.reshape(brows * sv, blocks * sh)[:h, :w]
    return tiff_color.ycbcr_to_rgb(luma, b[:, :, sh * sv], b[:, :, sh * sv + 1], tables, sh, sv)


def _premultiply(colors: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """libtiff's UaToAa table: (c * a + 127) // 255."""
    return ((colors.astype(np.uint32) * alpha[..., None] + 127) // 255).astype(np.uint8)


def _to8(x: np.ndarray) -> np.ndarray:
    """libtiff's Bitdepth16To8 table: (x + 128) // 257."""
    return ((x.astype(np.uint32) + 128) // 257).astype(np.uint8)
