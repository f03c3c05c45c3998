"""TIFF pages as ``cv2.imread(path, cv2.IMREAD_COLOR)`` reads them in
OpenCV 5 (libtiff 4.7), bit for bit: :func:`decode_tiff` (through
:func:`pero_ocr_tpu_torch.utils.image_io.imread`, which turns the page).

The container (:class:`Directory`): little- and big-endian, classic TIFF
and BigTIFF, the first image file directory only (a multi-page file
gives its first page), strips and tiles, PlanarConfiguration 1 and 2.

Each strip or tile is decompressed whole: none, PackBits (32773), LZW
(5) and CCITT Modified Huffman (2), T.4 (3, 1D and 2D) and T.6 (4) in
the host C++ of ``csrc/tiff.cpp``; Deflate (8, 32946) in ``zlib``; new-style
JPEG (7) by ``csrc/jpeg.cpp``'s decoder, with the JPEGTables tag
merged before each abbreviated stream.  FillOrder 2 reverses the bits
of each byte before the decompressor (not for JPEG), as libtiff does;
Predictor 2 undoes the horizontal differences at 8 and 16 bits (LZW and
Deflate only: libtiff ignores the tag elsewhere).

OpenCV reads a page that it returns as 8-bit through libtiff's
``TIFFReadRGBAStrip``/``TIFFReadRGBATile``, so the pixel rules are
``tif_getimage.c``'s (:func:`to_rgb`), then the alpha is dropped:

- gray (MINISBLACK, MINISWHITE) at 1 and 8 bits maps sample x to
  ``x * 255 // (2**b - 1)`` (MINISWHITE: ``(2**b - 1 - x) * 255 //
  (2**b - 1)``); at 16 bits it keeps the high byte (MINISWHITE: 255
  minus it); a gray alpha is dropped as it is (OpenCV's header check
  takes no 2-bit samples and 4-bit ones only as palette indexes: it
  returns None);
- palette at 1, 4 and 8 bits: the colormap's high bytes when any entry
  is 256 or more, else its low bytes;
- RGB at 8 bits as it is, at 16 bits ``(x + 128) // 257``; with
  unassociated alpha (ExtraSamples 2) each colour becomes
  ``(c * a + 127) // 255``, with associated or unspecified alpha it is
  kept;
- planar (PlanarConfiguration 2) gray with an alpha sample goes the RGB
  way: no MINISWHITE inversion, 16 bits as ``(x + 128) // 257``;
- YCbCr only with JPEG, which decodes it to RGB.

The Orientation tag, as measured with OpenCV 5.0.0 on strips and tiles:
for 2, 3, 6 and 7 libtiff flips each strip or tile left-right in its
place (``TIFFRGBAImage``'s setorientation), then OpenCV turns the page
as its ``ApplyExifOrientation`` turns a JPEG for the value ``_THEN``
maps the tag to (so 2 mirrors each tile in its place, 3 does that and
turns the page upside down, 4 only the latter; 5-8 transpose).  A transpose of a page that is not square
makes OpenCV 5's ``imread`` fail (its result is no longer the buffer it
allocated) and return None; :func:`decode_tiff` then raises "Unable to
read image", the error the JAX command line raises for None.

Refused with a ``ValueError`` naming the file and the ROADMAP item (a
page is read whole or not at all): old-style JPEG (6), LZMA, ZSTD,
WebP, JBIG, JPEG 2000 and every other compression; SampleFormat 2 and
3; bit depths other than 1, 2, 4, 8 and 16 (and 16-bit palette, sub-byte
RGB, sub-byte gray with more than one sample); more than 4 samples;
CMYK (separated), CIELab, YCbCr without JPEG and every other
photometric; Predictor 3, or 2 below 8 bits, with LZW or Deflate;
old-style LZW; and
truncated or corrupt data, where libtiff would warn and OpenCV return
what the strip held.
"""

from __future__ import annotations

import collections
import ctypes
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from pero_ocr_tpu_torch import not_read as refused, unreadable
from pero_ocr_tpu_torch.utils import kernels
from pero_ocr_tpu_torch.utils.jpeg import decode_jpeg

calls = collections.Counter()  # C function name -> calls through these bindings

TIFF_MAGICS = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

_ERR = 512
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {  # name: (restype, argtypes), as in csrc/tiff.cpp
    "tiff_lzw": (_I64, [_U8P, _I64, _U8P, _I64, ctypes.c_char_p, _I32]),
    "tiff_packbits": (_I64, [_U8P, _I64, _U8P, _I64, ctypes.c_char_p, _I32]),
    "tiff_fax": (_I64, [_U8P, _I64, _U8P, _I32, _I32, _I32, _I32, ctypes.c_char_p, _I32]),
}

# Tags
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_BYTES = 273, 274, 277, 278, 279
PLANAR, T4_OPTIONS, PREDICTOR, COLORMAP = 284, 292, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTES = 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES = 338, 339, 347

# Compressions read here, and those refused by name.
_READ = {1: "none", 2: "CCITT Modified Huffman", 3: "CCITT T.4", 4: "CCITT T.6", 5: "LZW",
         7: "JPEG", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
_NAMED = {6: "old-style JPEG", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP", 34661: "JBIG",
          34712: "JPEG 2000", 33003: "JPEG 2000", 33005: "JPEG 2000", 34676: "SGILog",
          34677: "SGILog24", 32771: "CCITT RLEW", 32809: "ThunderScan"}
_PHOTOMETRICS = {0: "MINISWHITE", 1: "MINISBLACK", 2: "RGB", 3: "palette",
                 4: "transparency mask", 5: "CMYK (separated)", 6: "YCbCr", 8: "CIELab",
                 9: "ICCLab", 10: "ITULab", 32844: "LogL", 32845: "LogLuv"}

# Field types: (struct code, size); RATIONAL and SRATIONAL as two codes.
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}

_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


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
    UNDEFINED fields)."""

    def __init__(self, data: bytes, path: str = "<tiff>"):
        self.path = path
        if not is_tiff(data):
            raise ValueError(f"{path}: not a TIFF file")
        self.order = "<" if data[:2] == b"II" else ">"
        self.big = data[2:4] in (b"+\x00", b"\x00+")
        if self.big:
            if len(data) < 16:
                raise refused(path, "a truncated TIFF file")
            offset_size, zero, first = struct.unpack(self.order + "HHQ", data[4:16])
            if offset_size != 8 or zero != 0:
                raise refused(path, "a BigTIFF file with a bad header")
        else:
            if len(data) < 8:
                raise refused(path, "a truncated TIFF file")
            (first,) = struct.unpack(self.order + "I", data[4:8])
        self.tags: Dict[int, object] = {}
        count_fmt, entry_size, inline = ("Q", 20, 8) if self.big else ("H", 12, 4)
        count_size = struct.calcsize(count_fmt)
        if first + count_size > len(data) or first == 0:
            raise refused(path, "a TIFF file whose first directory lies past its end")
        (count,) = struct.unpack(self.order + count_fmt, data[first:first + count_size])
        base = first + count_size
        if base + count * entry_size > len(data):
            raise refused(path, "a TIFF file whose first directory is truncated")
        for k in range(count):
            entry = data[base + k * entry_size: base + (k + 1) * entry_size]
            if self.big:
                tag, kind, n = struct.unpack(self.order + "HHQ", entry[:12])
                field = entry[12:20]
            else:
                tag, kind, n = struct.unpack(self.order + "HHI", entry[:8])
                field = entry[8:12]
            if kind not in _TYPES or tag in self.tags:
                continue  # libtiff skips unknown types and repeated tags too
            code, size = _TYPES[kind]
            nbytes = n * size
            if nbytes <= inline:
                raw = field[:nbytes]
            else:
                (offset,) = struct.unpack(self.order + ("Q" if self.big else "I"), field)
                if offset + nbytes > len(data):
                    raise refused(path, f"a TIFF file whose tag {tag} lies past its end")
                raw = data[offset:offset + nbytes]
            if kind in (1, 2, 7):
                self.tags[tag] = bytes(raw)
            else:
                self.tags[tag] = struct.unpack(f"{self.order}{n * len(code)}{code[0]}", raw)

    def get(self, tag: int, default=None):
        """The tag's first value, or ``default``."""
        value = self.tags.get(tag)
        return value[0] if value else default

    def values(self, tag: int) -> tuple:
        """All of the tag's values (empty when it is missing)."""
        return tuple(self.tags.get(tag, ()))


def decode_tiff(data: bytes, path: str = "<tiff>") -> Tuple[np.ndarray, int]:
    """A TIFF file's bytes -> (BGR uint8 (H, W, 3), the EXIF orientation
    that turns it into what ``cv2.imread(path, cv2.IMREAD_COLOR)``
    returns: :func:`pero_ocr_tpu_torch.utils.image_io.apply_orientation`'s
    argument).  Raises ``ValueError`` naming ``path``: the ROADMAP item
    for what is not read, "Unable to read image" where OpenCV returns
    None."""
    d = Directory(data, path)
    width, height = d.get(WIDTH), d.get(LENGTH)
    if not width or not height:
        raise refused(path, "a TIFF file without a width or a length")
    compression = d.get(COMPRESSION, 1)
    if compression not in _READ:
        what = _NAMED.get(compression, f"compression {compression}")
        raise refused(path, f"a TIFF file with {what} compression")
    photometric = d.get(PHOTOMETRIC)
    if photometric is None:
        raise refused(path, "a TIFF file without a PhotometricInterpretation tag")
    spp = d.get(SAMPLES, 1)
    bits = d.values(BITS) or (1,)
    if len(set(bits)) != 1:
        raise refused(path, f"a TIFF file with samples of {sorted(set(bits))} bits")
    bps = bits[0]
    if d.get(SAMPLE_FORMAT, 1) != 1:
        raise refused(path, f"a TIFF file with SampleFormat {d.get(SAMPLE_FORMAT)} "
                            "(signed or floating-point samples)")
    if bps == 2 or (bps == 4 and photometric != 3):
        raise unreadable(path, f"a TIFF file with {bps}-bit samples"
                               + ("" if bps == 2 else " that are not palette indexes"))
    if bps not in (1, 4, 8, 16):
        raise refused(path, f"a TIFF file with {bps}-bit samples")
    if not 1 <= spp <= 4:
        raise refused(path, f"a TIFF file with {spp} samples a pixel")
    planar = d.get(PLANAR, 1)
    if planar not in (1, 2):
        raise refused(path, f"a TIFF file with PlanarConfiguration {planar}")
    if spp == 1:
        planar = 1  # libtiff reads one sample a pixel as contiguous
    extras = d.values(EXTRA_SAMPLES)
    if photometric not in (0, 1, 2, 3, 6):
        what = _PHOTOMETRICS.get(photometric, f"PhotometricInterpretation {photometric}")
        raise refused(path, f"a {what} TIFF file")
    if photometric == 6 and compression != 7:
        raise refused(path, "a YCbCr TIFF file without JPEG compression")
    if compression == 7:
        if bps != 8 or planar != 1 or spp not in (1, 3) or (spp == 3) != (photometric in (2, 6)):
            raise refused(path, f"a JPEG TIFF file with {spp} samples of {bps} bits "
                                f"(PhotometricInterpretation {photometric}, planar {planar})")
    orientation = d.get(ORIENTATION, 1)
    if not 1 <= orientation <= 8:
        orientation = 1  # libtiff drops a bad value and takes the default
    if orientation >= 5 and width != height:
        raise unreadable(path, f"a {width}x{height} TIFF page whose Orientation tag "
                               f"({orientation}) transposes it")
    samples = _samples(d, data, width, height, bps, spp, planar, compression, path,
                       mirror=orientation in _MIRRORED)
    rgb = to_rgb(samples, d, photometric, bps, spp, planar, extras, path)
    if rgb.ndim == 2:  # gray: three equal channels
        bgr = np.empty((height, width, 3), np.uint8)
        bgr[:] = rgb[:, :, None]
    else:
        bgr = np.ascontiguousarray(rgb[:, :, ::-1])
    return bgr, _THEN[orientation]


def _samples(d: Directory, data: bytes, width: int, height: int, bps: int, spp: int,
             planar: int, compression: int, path: str, mirror: bool = False) -> np.ndarray:
    """The page's samples, (H, W, spp): uint8 up to 8 bits (sub-byte
    samples unpacked), native uint16 at 16; for JPEG the decoded
    components (gray, or RGB from YCbCr).  With ``mirror`` each strip or
    tile is flipped left-right in its place."""
    tiled = TILE_WIDTH in d.tags or TILE_OFFSETS in d.tags
    if tiled:
        cw, ch = d.get(TILE_WIDTH, 0), d.get(TILE_LENGTH, 0)
        offsets, counts = d.values(TILE_OFFSETS), d.values(TILE_BYTES)
        if cw <= 0 or ch <= 0:
            raise refused(path, "a tiled TIFF file without a tile size")
    else:
        cw, ch = width, min(d.get(ROWS_PER_STRIP, 2 ** 32 - 1) or height, height)
        offsets, counts = d.values(STRIP_OFFSETS), d.values(STRIP_BYTES)
    across, down = -(-width // cw), -(-height // ch)
    planes = spp if planar == 2 else 1
    per_plane = spp if planar == 1 else 1
    if len(offsets) < across * down * planes or len(counts) < across * down * planes:
        raise refused(path, "a TIFF file with fewer strips or tiles than its size needs")
    # libtiff knows the Predictor tag only for the codecs that take it
    # (here LZW and Deflate); for the others it is an unknown tag.
    predictor = d.get(PREDICTOR, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2) or (predictor == 2 and bps < 8):
        raise refused(path, f"a TIFF file with Predictor {predictor} at {bps} bits")
    if compression == 7:
        per_plane = spp
    out = np.zeros((height, width, spp), np.uint16 if bps == 16 else np.uint8)
    reverse = d.get(FILL_ORDER, 1) == 2 and compression != 7
    tables = d.tags.get(JPEG_TABLES) if compression == 7 else None
    rgb_jpeg = compression == 7 and d.get(PHOTOMETRIC) == 2
    two_d = d.get(T4_OPTIONS, 0) & 1
    if compression == 3 and d.get(T4_OPTIONS, 0) & 2:
        raise refused(path, "a T.4 TIFF file with uncompressed mode")
    index = 0
    for plane in range(planes):
        for row in range(down):
            for col in range(across):
                start, n = offsets[index], counts[index]
                index += 1
                if start + n > len(data):
                    raise refused(path, "a truncated TIFF file (a strip or tile lies past "
                                        "its end)")
                rows = ch if tiled else min(ch, height - row * ch)
                chunk = _decode_chunk(data[start:start + n], compression, cw, rows, bps,
                                      per_plane, reverse, tables, two_d, d.order, path,
                                      rgb_jpeg)
                if predictor == 2:  # running sums of each row's differences, wrapping
                    chunk = np.cumsum(chunk, axis=1, dtype=chunk.dtype)
                y0, x0 = row * ch, col * cw
                y1, x1 = min(y0 + rows, height), min(x0 + cw, width)
                part = chunk[:y1 - y0, :x1 - x0]
                if mirror:
                    part = part[:, ::-1]
                if planar == 2:
                    out[y0:y1, x0:x1, plane] = part[:, :, 0]
                else:
                    out[y0:y1, x0:x1] = part
    return out


def _decode_chunk(raw: bytes, compression: int, cw: int, rows: int, bps: int, nsamp: int,
                  reverse: bool, tables: Optional[bytes], two_d: int, order: str,
                  path: str, rgb_jpeg: bool = False) -> np.ndarray:
    """One strip or tile -> (rows, cw, nsamp) samples."""
    if compression == 7:
        if tables and raw[:2] == b"\xff\xd8" and tables[-2:] == b"\xff\xd9":
            raw = tables[:-2] + raw[2:]
        if rgb_jpeg:
            # libtiff hands an RGB photometric's components through
            # unconverted (JCS_UNKNOWN): an Adobe marker with transform 0
            # tells the decoder the same.
            if any(s != (1, 1) for s in _jpeg_sampling(raw)):
                raise refused(path, "a JPEG TIFF file of subsampled RGB components")
            raw = raw[:2] + _ADOBE_RGB + raw[2:]
        try:
            bgr = decode_jpeg(raw, path, strict=True)
        except ValueError as e:
            raise refused(path, f"a JPEG TIFF file whose strip or tile does not decode "
                                f"({e})") from None
        if bgr.shape[1] != cw or bgr.shape[0] < rows:
            raise refused(path, "a JPEG TIFF file whose strip or tile is not its size")
        bgr = bgr[:rows]
        return bgr[:, :, :1] if nsamp == 1 else bgr[:, :, ::-1]
    row_bytes = -(-cw * nsamp * bps // 8)
    size = rows * row_bytes
    if reverse:
        raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
    if compression == 1:
        buf = raw[:size]
        if len(buf) < size:
            raise refused(path, "a truncated TIFF file (an uncompressed strip or tile is "
                                "short)")
    elif compression in (8, 32946):
        try:
            inflater = zlib.decompressobj()
            buf = inflater.decompress(raw, size)
        except zlib.error as e:
            raise refused(path, f"a TIFF file whose Deflate data is corrupt ({e})") from None
        if len(buf) < size:
            raise refused(path, "a TIFF file whose Deflate data ends before the strip is "
                                "full")
    else:
        buf = _native(raw, compression, cw * nsamp if bps == 1 else 0, rows, size, two_d, path)
    flat = np.frombuffer(buf, np.uint8, size).reshape(rows, row_bytes)
    if bps == 16:
        samples = flat.view(order + "u2").astype(np.uint16)
    elif bps == 8:
        samples = flat
    elif bps == 1:
        samples = np.unpackbits(flat, axis=1, count=cw * nsamp)
    else:
        per_byte = 8 // bps
        shifts = np.arange(8 - bps, -1, -bps, dtype=np.uint8)
        samples = (flat[:, :, None] >> shifts) & ((1 << bps) - 1)
        samples = samples.reshape(rows, row_bytes * per_byte)[:, :cw * nsamp]
    return samples.reshape(rows, cw, nsamp)


_ADOBE_RGB = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"


def _jpeg_sampling(stream: bytes) -> List[tuple]:
    """The (h, v) sampling factors of a JPEG stream's frame components
    (empty without a frame header)."""
    pos = 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF:
        marker = stream[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        (length,) = struct.unpack(">H", stream[pos + 2:pos + 4])
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            n = stream[pos + 9] if pos + 9 < len(stream) else 0
            body = stream[pos + 10:pos + 10 + 3 * n]
            return [(body[3 * k + 1] >> 4, body[3 * k + 1] & 15) for k in range(len(body) // 3)]
        pos += 2 + length
    return []


def _native(raw: bytes, compression: int, fax_width: int, rows: int, size: int, two_d: int,
            path: str) -> bytes:
    lib = get_library()
    out = np.empty(size, np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    src = ctypes.cast(ctypes.c_char_p(raw), _U8P)
    dst = out.ctypes.data_as(_U8P)
    if compression == 5:
        calls["tiff_lzw"] += 1
        n = lib.tiff_lzw(src, len(raw), dst, size, err, _ERR)
    elif compression == 32773:
        calls["tiff_packbits"] += 1
        n = lib.tiff_packbits(src, len(raw), dst, size, err, _ERR)
    else:
        if not fax_width:
            raise refused(path, "a CCITT TIFF file with other than one 1-bit sample")
        calls["tiff_fax"] += 1
        n = lib.tiff_fax(src, len(raw), dst, fax_width, rows, compression, two_d, err, _ERR)
    if n < 0:
        raise refused(path, f"a TIFF file whose {_READ[compression]} data is truncated or "
                            f"corrupt ({err.value.decode()})")
    return out.tobytes()


def _alpha_kind(extras: tuple, spp: int) -> int:
    """libtiff's ``img->alpha``: 1 associated, 2 unassociated, 0 none.
    An unspecified extra sample counts as associated alpha beyond three
    samples."""
    if not extras:
        return 0
    if extras[0] == 0:
        return 1 if spp > 3 else 0
    return extras[0] if extras[0] in (1, 2) else 0


def _premultiply(colors: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """libtiff's UaToAa table: (c * a + 127) // 255."""
    return ((colors.astype(np.uint32) * alpha[..., None] + 127) // 255).astype(np.uint8)


def _to8(x: np.ndarray) -> np.ndarray:
    """libtiff's Bitdepth16To8 table: (x + 128) // 257."""
    return ((x.astype(np.uint32) + 128) // 257).astype(np.uint8)


def to_rgb(samples: np.ndarray, d: Directory, photometric: int, bps: int, spp: int,
           planar: int, extras: tuple, path: str) -> np.ndarray:
    """``TIFFRGBAImage``'s pixels without their alpha: (H, W, 3) uint8
    RGB from the page's samples, or (H, W) for gray (r = g = b)."""
    alpha = _alpha_kind(extras, spp)
    n_extra = len(extras)
    if photometric in (2, 6):
        if spp - n_extra < 3 and photometric == 2:
            raise refused(path, "an RGB TIFF file with fewer than three colour samples")
        if bps not in (8, 16):
            raise refused(path, f"an RGB TIFF file with {bps}-bit samples")
        colors, a = samples[:, :, :3], samples[:, :, 3] if spp > 3 else None
        return _rgb_alpha(colors, a, alpha, bps)
    if photometric == 3:
        if bps == 16:
            raise refused(path, "a 16-bit palette TIFF file")
        if spp != 1:
            raise refused(path, f"a palette TIFF file with {spp} samples a pixel")
        cmap = np.asarray(d.values(COLORMAP), np.uint16)
        entries = 1 << bps
        if cmap.size != 3 * entries:
            raise refused(path, "a palette TIFF file without a whole colormap")
        cmap = cmap.reshape(3, entries)
        cmap = (cmap >> 8) if (cmap >= 256).any() else (cmap & 0xFF)
        return np.ascontiguousarray(cmap.T.astype(np.uint8)[samples[:, :, 0]])
    # Gray
    if planar == 2:  # gtStripSeparate: the gray sample as r, g and b
        gray = samples[:, :, :1]
        a = samples[:, :, 1] if spp > 1 else None
        return _rgb_alpha(gray, a, alpha, bps)[:, :, 0]
    if bps < 8 and spp != 1:
        raise refused(path, f"a gray TIFF file with {spp} contiguous samples of {bps} bits")
    gray = samples[:, :, 0]
    if bps == 16:
        gray = (gray >> 8).astype(np.uint8)
        top = 255
    else:
        top = (1 << bps) - 1
    if photometric == 0:
        table = ((top - np.arange(top + 1)) * 255 // top).astype(np.uint8)
    else:
        table = (np.arange(top + 1) * 255 // top).astype(np.uint8)
    return table[gray]


def _rgb_alpha(colors: np.ndarray, a: Optional[np.ndarray], alpha: int, bps: int) -> np.ndarray:
    if bps == 16:
        colors = _to8(colors)
        a = _to8(a) if a is not None else None
    colors = colors.astype(np.uint8)
    if alpha == 2 and a is not None:
        return _premultiply(colors, a.astype(np.uint32))
    return np.ascontiguousarray(colors)
