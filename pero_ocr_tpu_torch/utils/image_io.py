"""Page images in and line crops out without cv2 or PIL: the port's
``cv2.imread(path, cv2.IMREAD_COLOR)`` and, for JPEG,
``cv2.imencode``/``cv2.imwrite``.

:func:`imread` returns a BGR uint8 (H, W, 3) array, bit for bit what
OpenCV 5 returns for the formats it reads here:

- **JPEG** (the C++ codec of ``csrc/jpeg.cpp``, bound in
  :mod:`pero_ocr_tpu_torch.utils.jpeg`): every JPEG file OpenCV reads.
  Sequential and progressive, Huffman or arithmetic coded, 8-bit, gray,
  three components at any sampling or four (CMYK or YCCK, turned into
  BGR as OpenCV turns them), restart intervals; lossless (Huffman,
  predictors 1-7, 2 to 8 bits, RGB or CMYK); libjpeg-turbo's integer
  IDCT, block smoothing of progressive files cut short, fancy upsampling
  and YCbCr tables; files cut short or corrupt read as libjpeg reads
  them (grey past the cut of a one-scan file).
- **PNG** (numpy and ``zlib``): every colour type and bit depth (1, 2,
  4, 8 and 16), interlaced (Adam7) or not, all five row filters.  As
  libpng expands them for OpenCV, 16-bit samples keep their high byte,
  gray of 1, 2 and 4 bits is scaled to 8 (``x * 255 // (2**b - 1)``),
  gray expands to three equal channels, palette indices map through
  PLTE, and alpha is dropped without compositing.  Chunk CRCs are
  checked.
- **PNM** (P1-P6, OpenCV's PxM decoder, :func:`decode_pnm`): bitmaps
  map 1 to black; binary samples are not rescaled to maxval, ASCII ones
  are (``v * 255 // maxval``, clamped to maxval first); 2-byte samples
  (maxval over 255) keep their high byte.
- **PAM** (P7, OpenCV's PAM decoder, :func:`decode_pam`): the five
  tuple types at 8 and 16 bits, and MAXVAL 1 as packed bits.
- **BMP** (:mod:`pero_ocr_tpu_torch.utils.bmp`, OpenCV's BMP decoder):
  OS/2 and Windows headers to V5, 1-, 4- and 8-bit palettes, 16, 24
  and 32 bits, RLE4 and RLE8, rows either way up.
- **TIFF** (:mod:`pero_ocr_tpu_torch.utils.tiff`, the host C++ of
  ``csrc/tiff.cpp``, :mod:`~pero_ocr_tpu_torch.utils.tiff_color`):
  strips and tiles, classic and BigTIFF, both byte orders, planar or
  not; none, LZW, Deflate, PackBits, CCITT (Modified Huffman, RLE/W,
  T.4, T.6), ThunderScan and JPEG compression, Predictor 2, FillOrder 2;
  gray, palette, RGB, CMYK, YCbCr and CIELab, alpha, signed samples and
  16 bits by libtiff's TIFFRGBAImage rules; strips cut short or corrupt
  as libtiff's decoders leave them, and the all-zero page of a
  compression libtiff does not know.
- **JPEG 2000** (:mod:`pero_ocr_tpu_torch.utils.jpeg2000`, the host C++
  of ``csrc/jpeg2000.cpp``): JP2 files and raw codestreams, 5/3 and 9/7
  wavelets, every progression order, tiles, tile-parts, precincts,
  layers, the code-block styles, SOP/EPH, POC and RGN; gray, RGB, RGBA,
  sYCC, palettes and ``cdef`` channel orders, 8 to 16 bits, turned into
  BGR as OpenCV turns OpenJPEG's components.
- **WebP** (:mod:`pero_ocr_tpu_torch.utils.webp`, the host C++ of
  ``csrc/webp.cpp``): lossless (VP8L) and lossy (VP8) still images,
  with or without alpha (dropped without compositing), and the first
  frame of an animation on its canvas, as libwebp decodes them for
  OpenCV (the "fancy" upsampler, 14-bit YUV to BGR).

JPEG (an APP1 ``Exif\\0\\0`` segment), PNG (an ``eXIf`` chunk) and WebP (an
``EXIF`` chunk of a file with the ``VP8X`` EXIF flag) pages are
turned by their EXIF orientation tag, all 8 values, as OpenCV's
``ApplyExifOrientation`` turns them under ``IMREAD_COLOR``
(:func:`exif_orientation`, :func:`apply_orientation`); a missing or
unreadable tag turns nothing, as in OpenCV.  TIFF pages are turned by
their Orientation tag as OpenCV 5 turns them (see
:mod:`~pero_ocr_tpu_torch.utils.tiff`).

What OpenCV reads and this module does not (SGILog TIFF; JPEG 2000 with
packed packet headers (PPM/PPT), HTJ2K or Part 2 extensions; GIF, AVIF,
Radiance HDR, PFM and Sun raster, told by the signatures OpenCV's
decoders check) raises a plain ``ValueError`` naming the file and the
ROADMAP item; what OpenCV returns None for (hierarchical, 12-bit,
arithmetic lossless, gray or YCbCr lossless JPEG and JPEG with broken
headers; TIFF that OpenCV's header check or libtiff refuses, or whose
strip libtiff cannot load; a non-square TIFF page turned by Orientation
5-8, a BMP or PAM header OpenCV rejects, a gray JPEG 2000 codestream
without a JP2 colour box, a CMYK, offset, subsampled or truncated JPEG
2000 file, a WebP file cut short or corrupt, a file whose first bytes no
decoder knows, ...) raises :class:`pero_ocr_tpu_torch.UnreadableImage`
saying "Unable to read image", as the JAX command line does.  Nothing is
skipped.

:func:`encode_jpeg` and :func:`imwrite_jpeg` write what
``cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])`` and
``cv2.imwrite`` write, byte for byte: (h, w, 3) BGR as 4:2:0 YCbCr,
(h, w) gray as one component.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Optional

import numpy as np

from pero_ocr_tpu_torch import not_read, unreadable
from pero_ocr_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg, jpeg_header
from pero_ocr_tpu_torch.utils import bmp, jpeg2000, tiff, webp

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels per PNG colour type: gray, RGB, palette, gray+alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_COLOR)`` for JPEG, JPEG 2000, PNG,
    PNM, PAM, TIFF, BMP and WebP, told apart by their first bytes as OpenCV
    tells them: a BGR uint8 (H, W, 3) array, turned by its EXIF or TIFF
    orientation.  Raises ``UnreadableImage`` ("Unable to read image")
    where cv2 returns None, a plain ``ValueError`` naming item 15's title
    for what cv2 reads and the port does not."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return apply_orientation(decode_png(data, path), exif_orientation(png_exif(data, path)))
    if data[:2] == b"\xff\xd8":
        if data[2:3] != b"\xff":  # OpenCV's JPEG signature is FF D8 FF
            raise unreadable(path, "a file that starts FF D8 without an FF after it")
        exif = jpeg_header(data, path)[3]
        return apply_orientation(decode_jpeg(data, path), exif_orientation(exif))
    if data[:1] == b"P" and data[1:2] in b"123456" and len(data) > 2:
        return decode_pnm(data, path)
    if data[:2] == b"P7" and data[2:3] in b" \t\n\v\f\r" and len(data) > 2:
        return decode_pam(data, path)
    if tiff.is_tiff(data):
        return decode_tiff(data, path)
    if bmp.is_bmp(data):
        return bmp.decode_bmp(data, path)
    if jpeg2000.is_jpeg2000(data):
        return jpeg2000.decode_jpeg2000(data, path)
    if webp.is_webp(data):
        return decode_webp(data, path)
    unported = _unported_format(data)
    if unported:
        raise not_read(path, f"a {unported} file")
    raise unreadable(path, "a file whose first bytes no decoder of its build knows")


def _unported_format(data: bytes) -> Optional[str]:
    """The name of a format that OpenCV 5's build reads and this reader
    does not, told by the signature its decoder checks, or None (cv2
    returns None for a file no decoder claims)."""
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data.startswith((b"#?RGBE", b"#?RADIANCE")):
        return "Radiance HDR"
    if len(data) >= 3 and data[:1] == b"P" and data[1:2] in b"fF" and data[2:3].isspace():
        return "PFM"
    if data[:4] == b"\x59\xa6\x6a\x95":
        return "Sun raster"
    if data[4:8] == b"ftyp" and len(data) >= 12:
        size = int.from_bytes(data[:4], "big")
        brands = [data[k:k + 4] for k in range(8, min(size, len(data)), 4) if k != 12]
        if b"avif" in brands or b"avis" in brands:
            return "AVIF"
    return None


def decode_webp(data: bytes, path: str = "<webp>") -> np.ndarray:
    """A WebP file's bytes -> what ``cv2.imread`` returns for it: the
    image of :func:`pero_ocr_tpu_torch.utils.webp.decode_webp`, turned by
    its EXIF orientation."""
    img, exif = webp.decode_webp(data, path)
    return apply_orientation(img, exif_orientation(exif))


def decode_tiff(data: bytes, path: str = "<tiff>") -> np.ndarray:
    """A TIFF file's bytes -> what ``cv2.imread`` returns for it: the
    page of :func:`pero_ocr_tpu_torch.utils.tiff.decode_tiff`, turned."""
    return apply_orientation(*tiff.decode_tiff(data, path))


def imwrite_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """``cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, quality])`` for
    a ``.jpg`` path: the bytes of :func:`encode_jpeg`."""
    data = encode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)


# ----------------------------------------------------------------------
# EXIF orientation, as OpenCV's ExifReader reads it and
# ApplyExifOrientation applies it
_EXIF_ORIENTATION = 0x0112
_EXIF_STRINGS = {0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298}
_EXIF_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3, 0x0214: 6}


class _ExifError(Exception):
    pass


def exif_orientation(tiff: Optional[bytes]) -> int:
    """The orientation tag (0x0112) of an EXIF TIFF block, read as
    OpenCV's ExifReader reads it: the IFD0 entries in order, each tag
    OpenCV knows parsed as it parses it; the first orientation entry's
    16 bits at its value field, whatever its type; a read past the
    block ends the walk, keeping an orientation already read.  1 (no
    turn) when there is none."""
    if not tiff:
        return 1
    intel = len(tiff) > 1 and tiff[0] == tiff[1] == ord("I")

    def u16(off: int) -> int:
        if off + 1 >= len(tiff):
            raise _ExifError
        return int.from_bytes(tiff[off:off + 2], "little" if intel else "big")

    def u32(off: int) -> int:
        if off + 3 >= len(tiff):
            raise _ExifError
        return int.from_bytes(tiff[off:off + 4], "little" if intel else "big")

    orientation = 1
    try:
        if u16(2) != 0x2A:
            return 1
        offset = u32(4)
        count = u16(offset)
        offset += 2
        found = False
        for _ in range(count):
            tag = u16(offset)
            if tag == _EXIF_ORIENTATION:
                value = u16(offset + 8)
                if not found:
                    orientation, found = value, True
            elif tag in _EXIF_STRINGS:
                size = u32(offset + 4)
                start = u32(offset + 8) if size > 4 else 8
                if start > len(tiff) or start + size > len(tiff):
                    raise _ExifError
            elif tag in _EXIF_RATIONALS:
                start = u32(offset + 8)
                for k in range(_EXIF_RATIONALS[tag]):
                    u32(start + 8 * k)
                    u32(start + 8 * k + 4)
            elif tag in (0x0128, 0x0213):  # resolution unit, YCbCr positioning
                u16(offset + 8)
            offset += 12
    except _ExifError:
        pass
    return orientation


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """The page as OpenCV's ApplyExifOrientation turns it: 2 flips it
    left-right, 3 turns it half round, 4 flips it top-bottom, 5-8
    transpose it and then flip it not at all, left-right, both ways and
    top-bottom.  Other values leave it."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flips:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


# ----------------------------------------------------------------------
# PNG
def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: PNG chunk {ctype!r} is truncated")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends without IEND")


def png_exif(data: bytes, path: str = "<png>") -> Optional[bytes]:
    """The first ``eXIf`` chunk's data (an EXIF TIFF block), before or
    after the image data, or None; libpng drops a chunk that does not
    start with ``II`` or ``MM``."""
    for ctype, body in _chunks(data, path):
        if ctype == b"eXIf":
            return body if body[:2] in (b"II", b"MM") else None
    return None


# Adam7's passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def decode_png(data: bytes, path: str = "<png>") -> np.ndarray:
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, ctype, compression, filter_method, interlace = header
    if (ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or compression or filter_method
            or interlace > 1):
        raise ValueError(f"{path}: invalid PNG header (colour type {ctype}, depth {depth})")
    if width == 0 or height == 0:
        raise ValueError(f"{path}: empty PNG")
    channels = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: PNG data does not inflate: {e}") from None
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.empty((height, width, channels), np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue  # an empty pass has no rows, not even filter bytes
        row_bytes = -(-w * channels * depth // 8)
        if len(raw) < pos + h * (row_bytes + 1):
            raise ValueError(f"{path}: PNG data is truncated")
        rows = np.frombuffer(raw, np.uint8, h * (row_bytes + 1), pos).reshape(h, row_bytes + 1)
        pos += h * (row_bytes + 1)
        filters = rows[:, 0]
        if filters.max() > 4:
            raise ValueError(f"{path}: PNG row filter {int(filters.max())} does not exist")
        # The filters' byte distance: a pixel's bytes, at least one.
        pixels = unfilter(rows[:, 1:], filters, max(1, channels * depth // 8))
        samples[y0::dy, x0::dx] = _unpack(pixels, w, channels, depth)
    return _to_bgr(samples, depth, ctype, palette, path)


def unfilter(filtered: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's row filters: (H, row_bytes) filtered bytes and the
    (H,) filter types -> the raw bytes.

    None, Sub and Up rows are a copy, a running sum along each of the
    ``bpp`` byte lanes, and a sum with the row above.  Avg and Paeth
    bytes depend on their left neighbour through a non-linear step, so
    when any row uses them every row is decoded by anti-diagonals of
    (row, pixel): byte (r, x) needs only (r, x - bpp), (r - 1, x) and
    (r - 1, x - bpp), so all bytes with the same r + x // bpp are
    independent, and the image takes H + W - 1 vector steps."""
    h, row_bytes = filtered.shape
    if not np.isin(filters, (3, 4)).any():
        out = np.empty_like(filtered)
        prev = np.zeros(row_bytes, np.uint8)
        for r in range(h):
            f, row = filters[r], filtered[r]
            if f == 0:
                out[r] = row
            elif f == 2:
                out[r] = row + prev
            else:  # Sub: a running sum per lane, wrapping at 256
                lanes = row.reshape(row_bytes // bpp, bpp)
                out[r] = np.cumsum(lanes, axis=0, dtype=np.uint8).ravel()
            prev = out[r]
        return out
    return _unfilter_wavefront(filtered, filters, bpp)


def _unfilter_wavefront(filtered: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    h, row_bytes = filtered.shape
    cols = row_bytes // bpp
    raw = filtered.reshape(h, cols, bpp)
    diags = h + cols - 1
    # Skewed layout, so that each anti-diagonal d = r + c is one
    # contiguous run: pixel (r, c) sits at xs[d, r] and out[d + 2, r + 1];
    # its left neighbour at out[d + 1, r + 1], the one above at
    # out[d + 1, r], the one above-left at out[d, r].  Cells that no
    # pixel maps to stay zero: the neighbours outside the image.
    xs = np.zeros((diags, h, bpp), np.uint8)
    for r in range(h):
        xs[r:r + cols, r] = raw[r]
    out = np.zeros((diags + 2, h + 1, bpp), np.int16)
    kinds = filters.astype(np.intp)[:, None]
    zero = np.zeros((h, bpp), np.int16)
    signed_a, signed_b, summed = (np.empty((h, bpp), np.int16) for _ in range(3))
    mask_a, mask_b = np.empty((h, bpp), bool), np.empty((h, bpp), bool)
    for d in range(diags):
        lo, hi = max(0, d - cols + 1), min(h, d + 1)
        n = hi - lo
        a, b, ul = out[d + 1, lo + 1:hi + 1], out[d + 1, lo:hi], out[d, lo:hi]
        # Paeth: whichever of a, b, ul is nearest to a + b - ul.
        pa = np.subtract(b, ul, out=signed_a[:n])
        pb = np.subtract(a, ul, out=signed_b[:n])
        pc = np.abs(np.add(pa, pb, out=summed[:n]), out=summed[:n])
        np.abs(pa, out=pa)
        np.abs(pb, out=pb)
        take_a = np.less_equal(pa, pb, out=mask_a[:n])
        take_a &= np.less_equal(pa, pc, out=mask_b[:n])
        paeth = np.where(take_a, a, np.where(np.less_equal(pb, pc, out=mask_b[:n]), b, ul))
        avg = np.add(a, b, out=signed_a[:n])  # Avg: floor((a + b) / 2)
        avg >>= 1
        pred = np.choose(kinds[lo:hi], (zero[:n], a, b, avg, paeth))
        pred += xs[d, lo:hi]
        pred &= 0xFF
        out[d + 2, lo + 1:hi + 1] = pred
    pixels = np.empty((h, cols, bpp), np.uint8)
    for r in range(h):
        pixels[r] = out[r + 2:r + 2 + cols, r + 1]
    return pixels.reshape(h, row_bytes)


def _unpack(pixels: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> (h, width, channels) 8-bit samples: 16-bit
    samples keep their high byte; 1, 2 and 4-bit samples are unpacked
    from the most significant bits, unscaled."""
    h = pixels.shape[0]
    if depth == 16:
        samples = pixels.reshape(h, width * channels, 2)[:, :, 0]
    elif depth == 8:
        samples = pixels
    else:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = ((pixels[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)
        samples = samples[:, :width * channels]
    return samples.reshape(h, width, channels)


def _to_bgr(samples, depth, ctype, palette, path) -> np.ndarray:
    """libpng's expansion for cv2: palette indexes through PLTE, gray of
    1, 2 and 4 bits scaled to 8 (0x11 steps and the like), gray to three
    equal channels, alpha dropped without compositing, BGR order."""
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        index = samples[:, :, 0]
        if index.max() >= len(palette):
            raise ValueError(f"{path}: PNG palette index out of range")
        rgb = palette[index]
    elif ctype in (0, 4):
        gray = samples[:, :, :1]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        rgb = np.repeat(gray, 3, axis=2)
    else:
        rgb = samples[:, :, :3]
    return np.ascontiguousarray(rgb[:, :, ::-1])


# ----------------------------------------------------------------------
# PNM (PxMDecoder)
_SPACE = frozenset(b" \t\n\v\f\r")


class _PxmStream:
    """OpenCV's ReadNumber over a PNM file: whitespace and ``#``
    comments (to a line end) skipped, then digits; the byte after the
    digits is consumed with them unless ``max_digits`` stopped first."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path, self.pos = data, path, 2

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError(f"{self.path}: PNM data is truncated")
        self.pos += 1
        return self.data[self.pos - 1]

    def number(self, max_digits: int = 0) -> int:
        code = self.byte()
        while not 48 <= code <= 57:
            if code == 35:  # '#'
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in _SPACE:
                while code in _SPACE:
                    code = self.byte()
            else:
                raise ValueError(f"{self.path}: unexpected byte {code:#x} in a PNM file")
        value = digits = 0
        while True:
            value = value * 10 + code - 48
            digits += 1
            if value > 2**31 - 1:
                raise ValueError(f"{self.path}: a PNM number is too large")
            if max_digits and digits >= max_digits:
                return value
            if self.pos >= len(self.data):
                return value
            code = self.byte()
            if not 48 <= code <= 57:
                return value


def _ascii_body(body: bytes, path: str) -> bytes:
    """An ASCII PNM body without its comments; anything but digits and
    whitespace (a comment right after a number among it) raises, as
    ReadNumber does."""
    body = re.sub(rb"(^|[ \t\n\v\f\r])#[^\n\r]*", rb"\1", body)
    if re.search(rb"[^0-9 \t\n\v\f\r]", body):
        raise ValueError(f"{path}: unexpected bytes in an ASCII PNM file")
    return body


def decode_pnm(data: bytes, path: str = "<pnm>") -> np.ndarray:
    """P1-P6 as OpenCV's PxM decoder reads them: ``P`` and a digit then
    whitespace; width, height and (but for P1 and P4) maxval as
    ReadNumber reads them.  Bitmaps (P1 ASCII digits, P4 packed bits) map
    1 to black and 0 to white; 2-byte samples (maxval over 255) keep
    their high byte; 1-byte binary samples are not rescaled to maxval,
    while ASCII ones are clamped to it and scaled, ``v * 255 // maxval``.  Binary data starts after
    the one byte that ends the header's last number."""
    if len(data) < 3 or data[0] != 80 or not 49 <= data[1] <= 54 or data[2] not in _SPACE:
        raise ValueError(f"{path}: invalid PNM header")
    kind = data[1] - 48
    stream = _PxmStream(data, path)
    width, height = stream.number(), stream.number()
    maxval = 1 if kind in (1, 4) else stream.number()
    if not (0 < maxval < 65536 and width > 0 and height > 0):
        raise ValueError(f"{path}: invalid PNM header")
    channels = 3 if kind in (3, 6) else 1
    n = width * height * channels
    if kind == 4:
        row_bytes = -(-width // 8)
        body = data[stream.pos:stream.pos + row_bytes * height]
        if len(body) != row_bytes * height:
            raise ValueError(f"{path}: PNM data is truncated")
        bits = np.unpackbits(np.frombuffer(body, np.uint8).reshape(height, row_bytes), axis=1,
                             count=width)
        samples = ((1 - bits) * 255).astype(np.uint8)[:, :, None]
    elif kind == 1:  # one digit a pixel, adjacent or not
        digits = np.frombuffer(_ascii_body(data[stream.pos:], path), np.uint8)
        digits = digits[(digits >= 48) & (digits <= 57)][:n]
        if len(digits) != n:
            raise ValueError(f"{path}: PNM data is truncated")
        samples = np.where(digits == 48, 255, 0).astype(np.uint8).reshape(height, width, 1)
    elif kind in (2, 3):
        body = _ascii_body(data[stream.pos:], path)
        tokens = body.split()
        # ReadNumber reads the byte after a number's digits: the last
        # sample needs one.
        if len(tokens) < n or (len(tokens) == n and body[-1:].isdigit()):
            raise ValueError(f"{path}: PNM data is truncated")
        tokens = tokens[:n]
        values = np.minimum(np.array([int(t) for t in tokens], np.int64), maxval)
        samples = (values >> 8 if maxval > 255 else values * 255 // maxval).astype(np.uint8)
        samples = samples.reshape(height, width, channels)
    else:
        size = 2 if maxval > 255 else 1
        body = data[stream.pos:stream.pos + n * size]
        if len(body) != n * size:
            raise ValueError(f"{path}: PNM data is truncated")
        samples = np.frombuffer(body, np.uint8)
        if size == 2:
            samples = samples[0::2]  # big-endian: the high byte
        samples = samples.reshape(height, width, channels)
    if channels == 1:
        return np.repeat(samples, 3, axis=2)
    return np.ascontiguousarray(samples[:, :, ::-1])


# ----------------------------------------------------------------------
# PAM (P7, OpenCV's PAMDecoder)
# TUPLTYPE -> DEPTH it must come with
_PAM_TUPLES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3,
               b"RGB_ALPHA": 4}
_PAM_FIELDS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE")


def decode_pam(data: bytes, path: str = "<pam>") -> np.ndarray:
    """P7 as OpenCV 5's PAM decoder reads it under ``IMREAD_COLOR``.

    The header: ``P7`` and a line end (LF or CR, one byte), then lines of
    an identifier and a value, blank lines and ``#`` comment lines, to
    ``ENDHDR``; the data starts after that line's one end byte.
    Identifiers and tuple types are matched case for case; numbers are
    digits only; WIDTH, HEIGHT, DEPTH and MAXVAL (up to 65535) are
    needed, each once.  A TUPLTYPE (BLACKANDWHITE, GRAYSCALE,
    GRAYSCALE_ALPHA, RGB, RGB_ALPHA) needs its own DEPTH; without one,
    DEPTH 1 or 3 with MAXVAL under 256 is gray or RGB.  Samples are not
    scaled to MAXVAL; 2-byte samples (MAXVAL over 255) keep their high
    byte.  MAXVAL 1 reads each row's first bytes as packed bits, the
    most significant first, 1 white (whatever the tuple type and depth;
    a row still takes WIDTH * DEPTH bytes).  RGB samples land in the
    blue, green, red order unswapped, as OpenCV stores them; gray ones
    in all three channels; RGB_ALPHA's are swapped, and the alphas are
    dropped.  OpenCV 5.0.0 converts only the first ceil(WIDTH / DEPTH)
    pixels of a GRAYSCALE_ALPHA or RGB_ALPHA row and leaves the rest of
    its output row unwritten (whatever memory held); here every pixel of
    the row is converted alike.  Where OpenCV returns None (or raises)
    this raises ``ValueError`` saying "Unable to read image"."""
    if len(data) < 3 or data[:2] != b"P7" or data[2] not in b"\n\r":
        raise tiff.unreadable(path, "this PAM header")
    fields, pos = {}, 3
    while True:
        end = min((i for i in (data.find(b"\n", pos), data.find(b"\r", pos)) if i >= 0),
                  default=-1)
        if end < 0:
            raise tiff.unreadable(path, "a PAM header without ENDHDR")
        line, pos = data[pos:end].strip(b" \t\v\f"), end + 1
        if not line or line.startswith(b"#"):
            continue
        ident, value = (line.split(None, 1) + [b""])[:2]
        if ident == b"ENDHDR":
            break
        if ident not in _PAM_FIELDS or ident in fields or (
                ident != b"TUPLTYPE" and not re.fullmatch(rb"[0-9]+", value)):
            raise tiff.unreadable(path, f"the PAM header line {line!r}")
        fields[ident] = value if ident == b"TUPLTYPE" else int(value)
    if not all(k in fields for k in _PAM_FIELDS[:4]):
        raise tiff.unreadable(path, "a PAM header without WIDTH, HEIGHT, DEPTH or MAXVAL")
    width, height, depth, maxval = (fields[k] for k in _PAM_FIELDS[:4])
    tuple_type = fields.get(b"TUPLTYPE")
    if tuple_type is None:
        if maxval < 256 and depth in (1, 3):
            tuple_type = b"GRAYSCALE" if depth == 1 else b"RGB"
    elif _PAM_TUPLES.get(tuple_type) != depth:
        tuple_type = None
    if (tuple_type is None or maxval > 65535 or not 0 < width < 2**31
            or not 0 < height < 2**31 or width * height * 3 >= 1 << 30):
        raise tiff.unreadable(path, "this PAM header's sizes or tuple type")
    size = 2 if maxval > 255 else 1
    row_bytes = width * depth * size
    body = data[pos:pos + row_bytes * height]
    if len(body) != row_bytes * height:
        raise tiff.unreadable(path, "a PAM file that ends early")
    rows = np.frombuffer(body, np.uint8).reshape(height, row_bytes)
    if maxval == 1:  # packed bits at the start of each row
        bits = np.unpackbits(rows[:, :-(-width // 8)], axis=1, count=width)
        return np.repeat((bits * 255).astype(np.uint8)[:, :, None], 3, axis=2)
    samples = rows[:, ::size].reshape(height, width, depth)  # 2-byte: the high byte
    if depth == 3:
        return np.ascontiguousarray(samples)
    if depth == 4:
        return np.ascontiguousarray(samples[:, :, 2::-1])
    return np.ascontiguousarray(np.repeat(samples[:, :, :1], 3, axis=2))
