"""BMP pages as OpenCV 5's BmpDecoder reads them under
``cv2.IMREAD_COLOR``, in numpy: :func:`decode_bmp` returns what
``cv2.imread(path, cv2.IMREAD_COLOR)`` returns, bit for bit.

Headers: the 12-byte OS/2 header (1, 4, 8, 24 and 32 bits, palettes of
three bytes an entry) and BITMAPINFOHEADER and its V4 and V5 successors
(any size of 36 bytes or more; OpenCV reads the first 36 and skips the
rest).  Pixel formats:

- 1-, 4- and 8-bit palettes (``biClrUsed`` entries, or all when 0;
  entries past them are black), BI_RGB;
- 16 bits, BI_RGB (as 5-5-5) or BI_BITFIELDS with the 5-5-5 or 5-6-5
  masks, which OpenCV reads from the 12 bytes after the header (where a
  BITMAPINFOHEADER keeps them; a V4 or V5 header's own mask fields are
  not read).  Samples are shifted to 8 bits, not rescaled;
- 24 bits; 32 bits BI_RGB or BI_BITFIELDS, whose first three bytes are
  taken as blue, green and red whatever the masks say;
- RLE8 and RLE4 with their escapes as OpenCV follows them: end of line
  and delta fill the pixels they pass with palette entry 0; in RLE8 the
  end of the bitmap fills the rest of the image, and an end of line
  right after a run that ended its row is skipped; in RLE4 the end of
  the bitmap acts as an end of line, and a delta moves only along the
  row.

Rows run bottom-up, or top-down for a negative height.  Where OpenCV
returns None (another compression, other masks or depths, a run past
its row, data or a palette past the end of the file) this raises
``ValueError`` saying "Unable to read image".
"""

from __future__ import annotations

import struct

import numpy as np

from pero_ocr_tpu_torch.utils.tiff import unreadable

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
_MASKS_555 = (0x7C00, 0x3E0, 0x1F)  # red, green, blue
_MASKS_565 = (0xF800, 0x7E0, 0x1F)


def is_bmp(data: bytes) -> bool:
    return data[:2] == b"BM"


class _Short(Exception):
    """A read past the end of the file: OpenCV's stream throws."""


def _take(data: bytes, pos: int, n: int) -> bytes:
    if n < 0 or pos < 0 or pos + n > len(data):
        raise _Short
    return data[pos:pos + n]


def _header(data: bytes):
    """(width, height, bpp, compression, palette (256, 3) BGR uint8 or
    None, data offset), bpp 15 for 5-5-5; None where OpenCV's
    readHeader fails."""
    offset, size = struct.unpack("<Ii", _take(data, 10, 8))
    palette = np.zeros((256, 3), np.uint8)
    if size >= 36:
        width, height, planes_bpp, compression = struct.unpack("<iiIi", _take(data, 18, 16))
        bpp = planes_bpp >> 16
        clrused = struct.unpack("<i", _take(data, 46, 4))[0]
        if not 0 <= compression <= BI_BITFIELDS:
            return None
        accepted = ((bpp in (1, 4, 8, 16, 24, 32) and compression == BI_RGB)
                    or (bpp in (16, 32) and compression == BI_BITFIELDS)
                    or (bpp == 4 and compression == BI_RLE4)
                    or (bpp == 8 and compression == BI_RLE8))
        if width <= 0 or height == 0 or not accepted:
            return None
        after = 14 + size
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                return None
            n = clrused or 1 << bpp
            entries = np.frombuffer(_take(data, after, 4 * n), np.uint8).reshape(n, 4)
            palette[:n] = entries[:, :3]
        elif bpp == 16 and compression == BI_BITFIELDS:
            masks = struct.unpack("<III", _take(data, after, 12))
            if masks == _MASKS_555:
                bpp = 15
            elif masks != _MASKS_565:
                return None
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        width, height, planes_bpp = struct.unpack("<HHI", _take(data, 18, 8))
        bpp, compression = planes_bpp >> 16, BI_RGB
        if width <= 0 or height == 0 or bpp not in (1, 4, 8, 24, 32):
            return None
        if bpp <= 8:
            n = 1 << bpp
            palette[:n] = np.frombuffer(_take(data, 26, 3 * n), np.uint8).reshape(n, 3)
    else:
        return None
    if abs(height) * width * 3 >= 1 << 30:
        return None
    return width, height, bpp, compression, palette, offset


def _unpack(rows: np.ndarray, width: int, bits: int) -> np.ndarray:
    """Palette indices of (h, pitch) rows of 1-, 4- or 8-bit pixels,
    the most significant bits first."""
    if bits == 8:
        return rows[:, :width]
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(rows.shape[0], -1)[:, :width]


def _rle(data: bytes, pos: int, width: int, height: int, palette: np.ndarray, four: bool):
    """BmpDecoder's RLE4 and RLE8 loops over a (height, width) index
    image in file row order, pixels as palette indices (OpenCV writes
    colours, the same thing); None where it gives up."""
    out = np.zeros(height * width, np.int32)
    d, line_end, y = 0, width, 0
    line_end_flag = 0

    def fill(count, index):
        # FillUniColor: count pixels of one index, wrapping to the next
        # row at each row end.
        nonlocal d, line_end, y
        while True:
            end = min(d + count, line_end)
            count -= end - d
            out[d:end] = index
            d = end
            if d >= line_end:
                line_end += width
                d = line_end - width
                y += 1
                if y >= height:
                    break
            if count <= 0:
                break

    def absolute(n, size):
        raw = np.frombuffer(_take(data, pos, size), np.uint8)[None]
        out[d:d + n] = _unpack(raw, n, 4 if four else 8)[0]

    while True:
        length, code = _take(data, pos, 2)
        pos += 2
        if length:  # encoded mode
            if d + length > line_end:
                return None
            if four:
                run = np.resize(np.array([code >> 4, code & 15]), length)
                out[d:d + length] = run
                d += length
                # OpenCV's loop steps past a run that ends its row
                # without wrapping: the next code sees the row full.
            else:
                prev = y
                fill(length, code)
                line_end_flag = y - prev
                if y >= height:
                    break
        elif code > 2:  # absolute mode
            if d + code > line_end:
                return None
            size = (((code + 1) >> 1) + 1) & ~1 if four else (code + 1) & ~1
            absolute(code, size)
            pos += size
            d += code
            line_end_flag = 0
        elif four:
            shift = line_end - d
            if code == 2:
                shift = _take(data, pos, 2)[0]
                pos += 2
            fill(shift, 0)
            if y >= height:
                break
        else:
            shift, y_shift = line_end - d, height - y
            if code or not line_end_flag or shift < width:
                if code == 2:
                    shift, y_shift = _take(data, pos, 2)
                    pos += 2
                if code:
                    shift += y_shift * width
                if y >= height:
                    break
                fill(shift, 0)
                if y >= height:
                    break
            line_end_flag = 0
            if y >= height:
                break
    return out.reshape(height, width)


def decode_bmp(data: bytes, path: str = "<bmp>") -> np.ndarray:
    """A BMP file's bytes -> BGR uint8 (H, W, 3), as ``cv2.imread(path,
    cv2.IMREAD_COLOR)`` returns it."""
    try:
        header = _header(data)
        if header is None:
            raise unreadable(path, "this BMP header")
        width, height, bpp, compression, palette, offset = header
        top_down, height = height < 0, abs(height)
        if compression in (BI_RLE4, BI_RLE8):
            index = _rle(data, offset, width, height, palette, compression == BI_RLE4)
            if index is None:
                raise unreadable(path, "an RLE run past its row")
            img = palette[index]
        else:
            pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
            rows = np.frombuffer(_take(data, offset, pitch * height), np.uint8).reshape(height,
                                                                                      pitch)
            if bpp <= 8:
                img = palette[_unpack(rows, width, bpp)]
            elif bpp in (15, 16):
                t = rows[:, :2 * width].copy().view("<u2").astype(np.int32)
                if bpp == 15:  # icvCvt_BGR5552BGR_8u_C2C3R
                    img = np.dstack([t << 3, (t >> 2) & ~7, (t >> 7) & ~7])
                else:  # icvCvt_BGR5652BGR_8u_C2C3R
                    img = np.dstack([t << 3, (t >> 3) & ~3, (t >> 8) & ~7])
                img = (img & 0xFF).astype(np.uint8)
            else:
                n = bpp // 8
                img = rows[:, :n * width].reshape(height, width, n)[:, :, :3]
    except _Short:
        raise unreadable(path, "a BMP file that ends early") from None
    if not top_down:
        img = img[::-1]
    return np.ascontiguousarray(img)
