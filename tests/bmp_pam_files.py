"""BMP and PAM files written with ``struct`` for the tests of the port's
readers (tests/test_torch_bmp_pam.py) and for the committed fixtures
(tests/data/bmp/make_fixtures.py)."""

import struct

import numpy as np

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
MASKS_555 = (0x7C00, 0x3E0, 0x1F)
MASKS_565 = (0xF800, 0x7E0, 0x1F)


def bmp_file(width, height, bpp, pixels: bytes, *, compression=BI_RGB, palette=None,
             header=40, clrused=0, masks=None, top_down=False) -> bytes:
    """A BMP file: the 14-byte file header, an info header of ``header``
    bytes (12: OS/2; 40: BITMAPINFOHEADER; 108, 124: V4, V5 with their
    mask fields zero), ``masks`` (red, green, blue) after it, the
    palette ((n, 3) BGR; 4 bytes an entry, 3 in an OS/2 file) and the
    pixel data as given."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1, bpp,
                           compression, len(pixels), 2835, 2835, clrused, 0)
        info += b"\0" * (header - 40)
    extra = struct.pack("<III", *masks) if masks else b""
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        if header != 12:
            palette = np.concatenate([palette, np.zeros((len(palette), 1), np.uint8)], axis=1)
        extra += palette.tobytes()
    offset = 14 + len(info) + len(extra)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + extra
            + pixels)


def bmp_rows(samples: np.ndarray, bpp: int) -> bytes:
    """(h, w) indices or 16-bit values, or (h, w, 3|4) bytes, as BMP rows
    in the order given, each padded to 4 bytes."""
    h, w = samples.shape[:2]
    if bpp < 8:
        per = 8 // bpp
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = samples
        shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
        rows = (padded.reshape(h, -1, per) << shifts).sum(axis=2).astype(np.uint8)
    elif bpp == 16:
        rows = samples.astype("<u2").view(np.uint8).reshape(h, 2 * w)
    else:
        rows = samples.astype(np.uint8).reshape(h, -1)
    pitch = (rows.shape[1] + 3) & ~3
    out = np.zeros((h, pitch), np.uint8)
    out[:, :rows.shape[1]] = rows
    return out.tobytes()


def rle_stream(ops) -> bytes:
    """RLE codes: ("run", count, byte), ("abs", [bytes of pixels], count)
    (padded to a word), ("eol",), ("eob",), ("delta", dx, dy)."""
    out = bytearray()
    for op in ops:
        if op[0] == "run":
            out += bytes([op[1], op[2]])
        elif op[0] == "abs":
            raw = bytes(op[1])
            out += bytes([0, op[2]]) + raw + b"\0" * (len(raw) % 2)
        elif op[0] == "eol":
            out += b"\0\0"
        elif op[0] == "eob":
            out += b"\0\1"
        else:
            out += bytes([0, 2, op[1], op[2]])
    return bytes(out)


def rle_rows(index: np.ndarray, rng, bpp: int) -> bytes:
    """An RLE8 (``bpp`` 8) or RLE4 (``bpp`` 4) stream of an (h, w) index
    image, rows in file order: one-pixel runs and absolute spans (packed
    nibbles at 4 bits) by turns, an end of line a row, an end of
    bitmap."""
    ops = []
    for row in index:
        x = 0
        while x < len(row):
            seg = row[x:x + int(rng.integers(1, 12))]
            if len(seg) >= 3 and rng.random() < 0.5:
                if bpp == 4:
                    packed = np.zeros(-(-len(seg) // 2) * 2, np.uint8)
                    packed[:len(seg)] = seg
                    ops.append(("abs", (packed[0::2] << 4 | packed[1::2]).tolist(), len(seg)))
                else:
                    ops.append(("abs", seg.tolist(), len(seg)))
            else:
                ops += [("run", 1, int(v) << (8 - bpp)) for v in seg]
            x += len(seg)
        ops.append(("eol",))
    ops[-1] = ("eob",)
    return rle_stream(ops)


def pam_file(width, height, depth, maxval, body: bytes, tuple_type=None, *, comment=False,
             newline=b"\n") -> bytes:
    """A P7 file: its header lines (a comment line first if asked), then
    ``body`` as given."""
    lines = [b"P7"] + ([b"# written by the tests"] if comment else []) + [
        b"WIDTH %d" % width, b"HEIGHT %d" % height, b"DEPTH %d" % depth, b"MAXVAL %d" % maxval]
    if tuple_type:
        lines.append(b"TUPLTYPE " + tuple_type.encode())
    lines.append(b"ENDHDR")
    return newline.join(lines) + newline + body


def pam_body(samples: np.ndarray, maxval: int) -> bytes:
    """(h, w, depth) samples as PAM data: one byte each, or two big-endian
    bytes over maxval 255."""
    return samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()
