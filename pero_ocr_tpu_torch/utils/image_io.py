"""Page images in and line crops out without cv2 or PIL: the port's
``cv2.imread(path, cv2.IMREAD_COLOR)`` and, for JPEG,
``cv2.imencode``/``cv2.imwrite``.

:func:`imread` returns a BGR uint8 (H, W, 3) array, bit for bit what
OpenCV 5 returns for the formats it reads here:

- **JPEG** (the C++ codec of ``csrc/jpeg.cpp``, bound in
  :mod:`pero_ocr_tpu_torch.utils.jpeg`): baseline sequential Huffman,
  8-bit, gray or three components at any sampling, restart intervals;
  libjpeg-turbo's integer IDCT, fancy upsampling and YCbCr tables.
- **PNG** (numpy and ``zlib``): bit depths 8 and 16; gray, gray+alpha,
  RGB, RGBA and palette images; all five row filters.  As in OpenCV,
  16-bit samples keep their high byte, gray expands to three equal
  channels, palette indices map through PLTE, and alpha is dropped
  without compositing.  Chunk CRCs are checked.
- **Binary PNM** (P5 gray, P6 RGB): as in OpenCV, samples are not
  rescaled to maxval; 2-byte samples (maxval over 255) keep their high
  byte.

JPEG (an APP1 ``Exif\\0\\0`` segment) and PNG (an ``eXIf`` chunk) pages are
turned by their EXIF orientation tag, all 8 values, as OpenCV's
``ApplyExifOrientation`` turns them under ``IMREAD_COLOR``
(:func:`exif_orientation`, :func:`apply_orientation`); a missing or
unreadable tag turns nothing, as in OpenCV.

Anything else (progressive, lossless, arithmetic, 12-bit or CMYK JPEG,
truncated or corrupt JPEG data, PNG at bit depths 1, 2 and 4,
interlaced PNG, TIFF, ASCII PNM, ...) raises ``ValueError`` naming the
file and the ROADMAP item; nothing is skipped.

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

from pero_ocr_tpu_torch import IMAGES
from pero_ocr_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg, jpeg_header

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels per PNG colour type: gray, RGB, palette, gray+alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _refuse(path: str, what: str) -> ValueError:
    return ValueError(
        f"{path}: {what} cannot be read by pero_ocr_tpu_torch yet "
        f"(ROADMAP.md, queue 1: '{IMAGES}'); convert it to PNG"
    )


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_COLOR)`` for JPEG, PNG and binary
    PNM: a BGR uint8 (H, W, 3) array, turned by its EXIF orientation.
    Raises ``ValueError`` for other or broken files (where cv2 returns
    None, or for JPEG data it would fill with grey)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return apply_orientation(decode_png(data, path), exif_orientation(png_exif(data, path)))
    if data[:2] == b"\xff\xd8":
        exif = jpeg_header(data, path)[3]
        return apply_orientation(decode_jpeg(data, path), exif_orientation(exif))
    if data[:2] in (b"P5", b"P6"):
        return decode_pnm(data, path)
    kind = {b"II": "a TIFF file", b"MM": "a TIFF file"}.get(
        data[:2], "a file that is neither JPEG, PNG nor binary PNM"
    )
    raise _refuse(path, kind)


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
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or compression or filter_method:
        raise ValueError(f"{path}: invalid PNG header (colour type {ctype}, depth {depth})")
    if interlace:
        raise _refuse(path, "an interlaced (Adam7) PNG")
    if depth < 8:
        raise _refuse(path, f"a PNG of bit depth {depth}")
    if width == 0 or height == 0:
        raise ValueError(f"{path}: empty PNG")
    channels = _CHANNELS[ctype]
    row_bytes = width * channels * depth // 8
    bpp = channels * depth // 8  # the filters' byte distance
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: PNG data does not inflate: {e}") from e
    if len(raw) < height * (row_bytes + 1):
        raise ValueError(f"{path}: PNG data is truncated")
    rows = np.frombuffer(raw, np.uint8, height * (row_bytes + 1)).reshape(height, row_bytes + 1)
    filters = rows[:, 0]
    if filters.max() > 4:
        raise ValueError(f"{path}: PNG row filter {int(filters.max())} does not exist")
    pixels = unfilter(rows[:, 1:], filters, bpp)
    return _to_bgr(pixels, width, height, channels, depth, ctype, palette, path)


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


def _to_bgr(pixels, width, height, channels, depth, ctype, palette, path) -> np.ndarray:
    if depth == 16:
        samples = pixels.reshape(height, width * channels, 2)[:, :, 0]  # the high byte
    else:
        samples = pixels
    samples = samples.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        index = samples[:, :, 0]
        if index.max() >= len(palette):
            raise ValueError(f"{path}: PNG palette index out of range")
        rgb = palette[index]
    elif ctype in (0, 4):
        rgb = np.repeat(samples[:, :, :1], 3, axis=2)
    else:
        rgb = samples[:, :, :3]
    return np.ascontiguousarray(rgb[:, :, ::-1])


# ----------------------------------------------------------------------
# Binary PNM
_PNM_HEADER = re.compile(
    rb"(P[56])(?:\s|#[^\n]*\n)+(\d+)(?:\s|#[^\n]*\n)+(\d+)(?:\s|#[^\n]*\n)+(\d+)\s"
)


def decode_pnm(data: bytes, path: str = "<pnm>") -> np.ndarray:
    m = _PNM_HEADER.match(data)
    if m is None:
        raise ValueError(f"{path}: invalid PNM header")
    magic, width, height, maxval = m.group(1), *(int(g) for g in m.groups()[1:])
    if not (0 < maxval < 65536 and width > 0 and height > 0):
        raise ValueError(f"{path}: invalid PNM header")
    channels = 3 if magic == b"P6" else 1
    size = 2 if maxval > 255 else 1
    n = width * height * channels
    body = data[m.end():m.end() + n * size]
    if len(body) != n * size:
        raise ValueError(f"{path}: PNM data is truncated")
    samples = np.frombuffer(body, np.uint8)
    if size == 2:
        samples = samples[0::2]  # big-endian: the high byte
    samples = samples.reshape(height, width, channels)
    if channels == 1:
        return np.repeat(samples, 3, axis=2)
    return np.ascontiguousarray(samples[:, :, ::-1])
