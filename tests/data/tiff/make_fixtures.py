"""Write the TIFF fixtures of this folder and their digests.

    python3 tests/data/tiff/make_fixtures.py

Needs cv2 (OpenCV 5, libtiff 4.7) and PIL with libtiff, and runs where
the tests run, never on the card's machine.  PIL's libtiff writes the
pages of each compression it offers (none, LZW and Deflate with and
without Predictor 2, PackBits, CCITT Modified Huffman, T.4 1D and 2D,
T.6 and JPEG), 16-bit gray, gray+alpha, RGBA, palette and a two-page
file.  :func:`write_tiff`, a writer of the container from strips or
tiles already compressed, makes what PIL does not write: tiles,
PlanarConfiguration 2, big-endian files, BigTIFF, 16-bit RGB(A),
sub-byte gray and palette, FillOrder 2, YCbCr JPEG with shared
JPEGTables, other alpha kinds and the Orientation tag; signed samples,
CMYK, YCbCr without JPEG at each subsampling, CIELab, ThunderScan and
word-aligned Modified Huffman (32771); the compressions and formats cv2
returns None or an all-zero page for; and strips cut short or corrupt.
Its compressed chunks come from zlib, a PackBits coder here, and PIL
(LZW, CCITT) or cv2 (JPEG) on a chunk-sized image.  ``a4_g4_text.tif``
is an A4 300-dpi page of text as a bilevel T.6 (Group 4) file.

``fixtures.json``: for each file the sha256 and shape of
``cv2.imread(path, 1)``'s array, and under ``none`` the files for which
it returns None; under ``mutations`` the seeded byte mutations of the
``mut_*`` bases (``tests/tiff_files.py``'s ``mutate``), under ``cuts``
the same bases with one strip or tile's byte count cut short
(``tiff_files.cut``) and under ``entries`` with one byte of a directory
entry changed (``tiff_files.mutate_entry``), each with cv2's digest,
None, or "raises" (OpenCV's image size limits); under ``pages``
the digest of ``tests/data/page/two_columns_2560x1792_ycbcr22.tif``, a
2560x1792 YCbCr page subsampled 2x2 in Deflate strips, made from the
pixels of the committed progressive JPEG page.
tests/test_torch_tiff.py holds the port's reader to the JSON and to cv2
on the CPU, ``chip_smoke.check_tiff_fixtures`` on the card's machine.
"""

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from pero_ocr_tpu_torch.utils.tiff import Directory  # noqa: E402
from tests import tiff_files  # noqa: E402

MUTATION_SEED, MUTATIONS_PER_BASE, CUT_STEP, ENTRY_MUTATIONS_PER_BASE = 26, 30, 29, 30
PAGE = os.path.join("page", "two_columns_2560x1792_ycbcr22.tif")
PAGE_SOURCE = os.path.join("page", "two_columns_progressive_2560x1792_q85.jpg")

H, W = 23, 37  # odd sizes: partial last strips and edge tiles
TILE = 16


# ----------------------------------------------------------------------
# The container
def write_tiff(tags: dict, chunks, order: str = "<", big: bool = False, tiled: bool = False,
               pages: int = 1) -> bytes:
    """A TIFF file: ``tags`` {tag: (type, values or bytes)} plus the
    chunks' offsets and byte counts (strips, or tiles with ``tiled``), in
    ``order`` ("<" II, ">" MM), classic or BigTIFF.  ``pages`` > 1
    chains copies of the directory (a multi-page file)."""
    head = 16 if big else 8
    blob = bytearray(head)
    offsets = []
    for chunk in chunks:
        offsets.append(len(blob))
        blob += chunk
        if len(blob) % 2:
            blob += b"\0"
    long_type = 16 if big else 4
    tags = dict(tags)
    tags[324 if tiled else 273] = (long_type, offsets)
    tags[325 if tiled else 279] = (long_type, [len(c) for c in chunks])
    inline = 8 if big else 4
    ifd_offsets = []
    for page in range(pages):
        entries = []
        for tag in sorted(tags):
            kind, values = tags[tag]
            if isinstance(values, (bytes, bytearray)):
                raw, count = bytes(values), len(values)
            else:
                code = {3: "H", 4: "I", 16: "Q", 5: "I", 1: "B"}[kind]
                raw = struct.pack(f"{order}{len(values)}{code}", *values)
                count = len(values) // (2 if kind == 5 else 1)
            if len(raw) <= inline:
                field = raw.ljust(inline, b"\0")
            else:
                field = struct.pack(order + ("Q" if big else "I"), len(blob))
                blob += raw
                if len(blob) % 2:
                    blob += b"\0"
            entries.append(struct.pack(order + ("HHQ" if big else "HHI"), tag, kind, count)
                           + field)
        ifd_offsets.append(len(blob))
        blob += struct.pack(order + ("Q" if big else "H"), len(entries)) + b"".join(entries)
        blob += b"\0" * (8 if big else 4)  # next IFD, patched below
    for page, at in enumerate(ifd_offsets):
        nxt = ifd_offsets[page + 1] if page + 1 < len(ifd_offsets) else 0
        end = at + (8 if big else 2) + len(tags) * (20 if big else 12)
        blob[end:end + (8 if big else 4)] = struct.pack(order + ("Q" if big else "I"), nxt)
    if big:
        blob[:16] = (b"II" if order == "<" else b"MM") + struct.pack(order + "HHHQ", 43, 8, 0,
                                                                    ifd_offsets[0])[:14]
    else:
        blob[:8] = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42,
                                                                    ifd_offsets[0])
    return bytes(blob)


def base_tags(h, w, bps, spp, photometric, compression, rows=None, tile=None, planar=1,
              big=False, **more):
    """The usual tags; ``more`` adds tag numbers given as ``t<number>``
    = (type, values)."""
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if tile:
        tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        tags[278] = (4, [rows or h])
    for key, value in more.items():
        tags[int(key[1:])] = value
    return tags


def pack_rows(samples: np.ndarray, bps: int, order: str) -> np.ndarray:
    """(h, w, n) samples -> (h, row_bytes) bytes as TIFF stores them."""
    h, w, n = samples.shape
    if bps == 16:
        return samples.astype(order + "u2").reshape(h, w * n).view(np.uint8)
    if bps == 8:
        return samples.astype(np.uint8).reshape(h, w * n)
    flat = samples.reshape(h, w * n).astype(np.uint8)
    bits = (flat[:, :, None] >> np.arange(bps - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def differences(samples: np.ndarray) -> np.ndarray:
    """Predictor 2's horizontal differences, wrapping."""
    out = samples.copy()
    out[:, 1:] = samples[:, 1:] - samples[:, :-1]
    return out


def chunks_of(samples, bps, compress, order="<", rows=None, tile=None, planar=1,
              predictor=False):
    """The page's strips (``rows`` a strip) or tiles, each
    ``compress(raw bytes, (h, w, n) samples)``'d; with PlanarConfiguration
    2 all of the first sample's chunks, then the second's, ...."""
    h, w, n = samples.shape
    planes = [samples[:, :, k:k + 1] for k in range(n)] if planar == 2 else [samples]
    out = []
    for plane in planes:
        if tile:
            tw, th = tile
            padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw, plane.shape[2]), plane.dtype)
            padded[:h, :w] = plane
            parts = [padded[y:y + th, x:x + tw] for y in range(0, h, th)
                     for x in range(0, w, tw)]
        else:
            r = rows or h
            parts = [plane[y:y + r] for y in range(0, h, r)]
        for part in parts:
            if predictor:
                part = differences(part)
            out.append(compress(pack_rows(part, bps, order).tobytes(), part))
    return out


def packbits(raw: bytes) -> bytes:
    """A PackBits coder: runs of 3 or more equal bytes as repeats, the
    rest as literals of at most 128."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        j = i
        while j < n and j - i < 128 and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            out += bytes([(1 - (j - i)) & 0xFF, raw[i]])
            i = j
            continue
        start = i
        while i < n and i - start < 128 and not (i + 2 < n and raw[i] == raw[i + 1] == raw[i + 2]):
            i += 1
        out += bytes([i - start - 1]) + raw[start:i]
    return bytes(out)


def pil_strip(image, compression: str, **kw):
    """The one strip (and JPEGTables) of a PIL-written TIFF of
    ``image``."""
    buf = io.BytesIO()
    image.save(buf, format="TIFF", compression=compression, strip_size=1 << 30, **kw)
    data = buf.getvalue()
    d = Directory(data)
    (offset,), (count,) = d.values(273), d.values(279)
    return data[offset:offset + count], d.tags.get(347)


def lzw(raw: bytes, _=None) -> bytes:
    """libtiff's LZW of a byte string (PIL, as a one-row gray image)."""
    from PIL import Image

    return pil_strip(Image.frombytes("L", (len(raw), 1), raw), "tiff_lzw")[0]


def ccitt(compression: str, t4=None):
    """A chunk coder: libtiff's CCITT coding of the chunk's 1-bit
    samples (PIL, with T4Options ``t4``)."""
    from PIL import Image, TiffImagePlugin

    def code(_raw, part):
        info = TiffImagePlugin.ImageFileDirectory_v2()
        if t4 is not None:
            info[292] = t4
        bits = part[:, :, 0].astype(bool)
        return pil_strip(Image.fromarray(bits), compression, tiffinfo=info)[0]
    return code


def split_jpeg(data: bytes):
    """A JPEG interchange stream -> (tables-only stream: SOI, DQT, DHT,
    EOI; the abbreviated image stream without them)."""
    tables, image, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xDA:
            image += data[pos:]
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        segment = data[pos:pos + 2 + length]
        (tables if marker in (0xDB, 0xC4) else image).extend(segment)
        pos += 2 + length
    return bytes(tables + b"\xff\xd9"), bytes(image)


def jpeg_chunks(samples, tile=None, rows=None, quality=90):
    """YCbCr (three samples, cv2's 4:2:0) or gray JPEG chunks sharing
    their tables: (chunks, JPEGTables)."""
    import cv2

    tables = None
    out = []
    for raw in chunks_of(samples, 8, lambda raw, part: part, rows=rows, tile=tile):
        img = raw[:, :, ::-1] if raw.shape[2] == 3 else raw[:, :, 0]
        ok, data = cv2.imencode(".jpg", np.ascontiguousarray(img),
                                [cv2.IMWRITE_JPEG_QUALITY, quality])
        t, image = split_jpeg(data.tobytes())
        assert tables in (None, t)
        tables = t
        out.append(image)
    return out, tables


# ----------------------------------------------------------------------
# Pages
def smooth(h, w, n, top=255, seed=0):
    """Gradients plus noise, different in each sample."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 7 + y * 5)[:, :, None] * (top // 255 or 1) + np.arange(n) * (top // 5)
    noise = rng.integers(0, max(top // 16, 2), (h, w, n))
    return ((base + noise) % (top + 1)).astype(np.uint16 if top > 255 else np.uint8)


def blobs(h, w, seed=0):
    """A bilevel page: random rectangles and noise, 1 = black."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.uint8)
    for _ in range(12):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + rng.integers(1, 8), x:x + rng.integers(1, 20)] = 1
    img ^= (rng.random((h, w)) < 0.05).astype(np.uint8)
    return img[:, :, None]


def text_page(h=3508, w=2480, seed=0):
    """An A4 page at 300 dpi: rows of random words in cv2's Hershey
    font, 1 = black."""
    import cv2

    rng = np.random.default_rng(seed)
    page = np.full((h, w), 255, np.uint8)
    letters = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    for y in range(260, h - 250, 70):
        x = 200
        while x < w - 400:
            word = "".join(rng.choice(list(letters), rng.integers(2, 10)))
            cv2.putText(page, word, (int(x), int(y)), cv2.FONT_HERSHEY_SIMPLEX, 1.4, 0, 3)
            x += 40 * len(word) + 40
    return (page < 128).astype(np.uint8)[:, :, None]


def pil_page(image, compression, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, format="TIFF", compression=compression, **kw)
    return buf.getvalue()


def ycbcr_chunks(ycc: np.ndarray, sh: int, sv: int, compress, rows=None, tile=None):
    """YCbCr chunks subsampled sh x sv as TIFF stores them: for each block
    its sh * sv luma samples, then Cb and Cr (the block's first pixel's),
    blocks padded at the right and bottom edges."""
    h, w, _ = ycc.shape
    if tile:
        tw, th = tile
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw, 3), np.uint8)
        pad[:h, :w] = ycc
        parts = [pad[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        parts = [ycc[y:y + rows] for y in range(0, h, rows)]
    out = []
    for part in parts:
        ph, pw, _ = part.shape
        bh, bw = -(-ph // sv), -(-pw // sh)
        pad = np.zeros((bh * sv, bw * sh, 3), np.uint8)
        pad[:ph, :pw] = part
        blocks = pad.reshape(bh, sv, bw, sh, 3).transpose(0, 2, 1, 3, 4)
        luma = blocks[..., 0].reshape(bh, bw, sv * sh)
        chroma = blocks[:, :, 0, 0, 1:3]
        raw = np.concatenate([luma, chroma], axis=2).astype(np.uint8).tobytes()
        out.append(compress(raw, None))
    return out


def thunder(raw: bytes, _=None, width: int = 0) -> bytes:
    """ThunderScan codes of 4-bit rows (two pixels a byte): a run code
    where a pixel repeats, a 2-bit delta code for three steps of -1, 0
    or +1, else a raw pixel."""
    px = np.unpackbits(np.frombuffer(raw, np.uint8)[:, None], axis=1).reshape(-1, 2, 4)
    px = (px[:, :, 0] * 8 + px[:, :, 1] * 4 + px[:, :, 2] * 2 + px[:, :, 3]).reshape(-1)
    rows = px.reshape(-1, -(-width // 2) * 2)[:, :width]
    out = bytearray()
    deltas = {0: 0, 1: 1, -1: 3}
    for row in rows:
        last, x = None, 0
        while x < width:
            v = int(row[x])
            if last is not None and v == last:
                n = 1
                while x + n < width and int(row[x + n]) == last and n < 63:
                    n += 1
                out.append(n)
                x += n
                continue
            three = [int(c) for c in row[x:x + 3]]
            if last is not None and len(three) == 3:
                steps = [three[0] - last, three[1] - three[0], three[2] - three[1]]
                if all(d in deltas for d in steps) and len(set(three)) > 1:
                    out.append(0x40 | deltas[steps[0]] << 4 | deltas[steps[1]] << 2
                               | deltas[steps[2]])
                    last, x = three[2], x + 3
                    continue
            out.append(0xC0 | v)
            last, x = v, x + 1
    return bytes(out)


def sgilog_rle(words: np.ndarray, nbytes: int) -> bytes:
    """SGILog's run-length coding of rows of 16-bit (LogL, nbytes 2) or
    32-bit (LogLuv, nbytes 4) words: each row's byte planes, the most
    significant first, as runs of 2 to 129 equal bytes (128 + n - 2,
    the byte) and literals of up to 127 (n, the bytes)."""
    out = bytearray()
    for row in words:
        for k in range(nbytes - 1, -1, -1):
            plane = [(int(v) >> (8 * k)) & 255 for v in row]
            i = 0
            while i < len(plane):
                j = i
                while j < len(plane) and j - i < 129 and plane[j] == plane[i]:
                    j += 1
                if j - i >= 3:
                    out += bytes([128 + j - i - 2, plane[i]])
                    i = j
                    continue
                j = i
                while j < len(plane) and j - i < 127 and not (
                        j + 2 < len(plane) and plane[j] == plane[j + 1] == plane[j + 2]):
                    j += 1
                out += bytes([j - i]) + bytes(plane[i:j])
                i = j
    return bytes(out)


def rlew(part: np.ndarray) -> bytes:
    """CCITT RLE/W (32771): each row Modified Huffman coded (libtiff,
    through PIL, one row at a time), padded to a 16-bit word."""
    from PIL import Image

    out = bytearray()
    for row in part[:, :, 0]:
        code = pil_strip(Image.fromarray(row[None, :].astype(bool)), "tiff_ccitt")[0]
        out += code + b"\0" * (len(code) % 2)
    return bytes(out)


def damaged() -> dict:
    """name -> file bytes: the compressions and formats cv2 returns None
    or a zero page for, and strips cut short or corrupt."""
    out = {}
    rgb = smooth(9, 11, 3, seed=3)
    raw = rgb.tobytes()
    for code in (6, 34661, 32909, 34925, 50000, 50001, 34887, 34712, 33003, 33005, 9, 10,
                 32908, 12345, 32766):
        out[f"compression_{code}_rgb"] = write_tiff(base_tags(9, 11, 8, 3, 2, code), [raw])
    gray = smooth(9, 11, 1, seed=4)
    for photometric, more in ((0, {}), (1, {}), (3, {"t320": (3, [40000] * 256 + [0] * 512)})):
        out[f"compression_12345_photometric{photometric}"] = write_tiff(
            base_tags(9, 11, 8, 1, photometric, 12345, **more), [gray.tobytes()])
    out["compression_34712_orientation3"] = write_tiff(
        base_tags(9, 11, 8, 3, 2, 34712, t274=(3, [3])), [raw])
    for photometric in (4, 9, 10, 32844, 32845):
        out[f"photometric_{photometric}"] = write_tiff(base_tags(9, 11, 8, 3, photometric, 1),
                                                       [raw])
    tags = base_tags(9, 11, 8, 3, 2, 1)
    del tags[262]
    out["no_photometric"] = write_tiff(tags, [raw])
    for fmt in ((3,), (4,), (1, 2, 1)):
        out[f"sampleformat_{'_'.join(map(str, fmt))}"] = write_tiff(
            base_tags(9, 11, 8, 3, 2, 1, t339=(3, list(fmt) * (3 // len(fmt)))), [raw])
    out["float32_gray"] = write_tiff(base_tags(9, 11, 32, 1, 1, 1, t339=(3, [3])),
                                     [np.linspace(0, 1, 99, dtype="<f4").tobytes()])
    for bits in (2, 3, 5, 12, 32):
        n = -(-11 * 3 * bits // 8) * 9
        out[f"rgb_{bits}bit"] = write_tiff(base_tags(9, 11, bits, 3, 2, 1), [b"\x5a" * n])
    for bits in (3, 12):
        n = -(-11 * bits // 8) * 9
        out[f"gray_{bits}bit"] = write_tiff(base_tags(9, 11, bits, 1, 1, 1), [b"\xa5" * n])
    out["rgb_1bit"] = write_tiff(base_tags(9, 11, 1, 3, 2, 1), [b"\x5a" * 45])
    out["cmyk16"] = write_tiff(base_tags(9, 11, 16, 4, 5, 1), [b"\x33" * 792])
    out["cmyk_inkset2"] = write_tiff(base_tags(9, 11, 8, 4, 5, 1, t332=(3, [2])), [raw + raw[:99]])
    out["ycbcr_1x4"] = write_tiff(base_tags(8, 12, 8, 3, 6, 1, t530=(3, [1, 4])), [b"\x80" * 288])
    out["cielab_12bit"] = write_tiff(base_tags(9, 11, 12, 3, 8, 1), [b"\x11" * 149 * 9])
    out["predictor_3"] = write_tiff(base_tags(9, 11, 8, 3, 2, 8, t317=(3, [3])), [zlib.compress(raw)])
    out["predictor_2_1bit"] = write_tiff(base_tags(9, 11, 1, 1, 0, 5, t317=(3, [2])),
                                         [lzw(b"\x55" * 18)])
    out["g4_8bit"] = write_tiff(base_tags(9, 11, 8, 1, 0, 4), [b"\0" * 20])
    # strips that libtiff cannot load: no bytes, or past the end of the file
    out["strip_count_0"] = write_tiff(base_tags(9, 11, 8, 3, 2, 5, rows=5),
                                      [lzw(raw[:165]), b""])
    two = write_tiff(base_tags(9, 11, 8, 3, 2, 1, rows=5), [raw[:165], raw[165:]])
    out["strip_past_the_end"] = two[:12 + 165]
    # cut short: what decoded stays, the rest of the strip zero
    big = smooth(23, 37, 3, seed=5)
    for name, comp, coder in (("lzw", 5, lzw), ("deflate", 8, lambda r, _: zlib.compress(r)),
                              ("packbits", 32773, lambda r, _: packbits(r))):
        chunks = chunks_of(big, 8, coder, rows=8)
        chunks[1] = chunks[1][:len(chunks[1]) * 2 // 3]
        out[f"cut_{name}"] = write_tiff(base_tags(23, 37, 8, 3, 2, comp, rows=8), chunks)
        chunks = chunks_of(big, 8, coder, rows=8, predictor=True)
        chunks[0] = chunks[0][:len(chunks[0]) // 2]
        out[f"cut_{name}_predictor"] = write_tiff(
            base_tags(23, 37, 8, 3, 2, comp, rows=8, t317=(3, [2])), chunks)
    deep = smooth(23, 37, 1, 65535, seed=6)
    chunks = chunks_of(deep, 16, lzw, order=">", rows=8)
    chunks[2] = chunks[2][:len(chunks[2]) // 2]
    out["cut_lzw_gray16_be"] = write_tiff(base_tags(23, 37, 16, 1, 1, 5, rows=8), chunks,
                                          order=">")
    out["lzw_old_style"] = write_tiff(base_tags(9, 11, 8, 3, 2, 5), [b"\x00\x01" + raw])
    out["lzw_without_clear"] = write_tiff(base_tags(9, 11, 8, 3, 2, 5), [lzw(raw)[2:]])
    bw = blobs(30, 40, seed=4)
    g4 = chunks_of(bw, 1, ccitt("group4"))[0]
    out["cut_g4"] = write_tiff(base_tags(30, 40, 1, 1, 0, 4), [g4[:len(g4) // 2]])
    out["corrupt_g4"] = write_tiff(base_tags(30, 40, 1, 1, 0, 4), [b"\x00" * 20])
    out["t4_uncompressed_mode_g4_data"] = write_tiff(
        base_tags(30, 40, 1, 1, 0, 3, t292=(4, [2])), [g4])
    mh = chunks_of(bw, 1, ccitt("tiff_ccitt"))[0]
    out["t4_without_eols"] = write_tiff(base_tags(30, 40, 1, 1, 0, 3), [mh])
    g3 = chunks_of(bw, 1, ccitt("group3", 1), rows=10)
    g3[1] = g3[1][:len(g3[1]) // 2]
    out["cut_g3_2d"] = write_tiff(base_tags(30, 40, 1, 1, 0, 3, rows=10, t292=(4, [1])), g3)
    out["cut_mh"] = write_tiff(base_tags(30, 40, 1, 1, 0, 2), [mh[:len(mh) // 3]])
    # uncompressed byte counts libtiff repairs: a single strip's looks bad
    # (estimated from the image size), counts that differ among three or
    # more strips are all estimated from height // strips, and a single
    # strip is chopped into ~8 KiB strips
    tall = smooth(60, 100, 3, seed=7)
    one = tall.tobytes()
    for name, count in (("zero", 0), ("short", len(one) // 2), ("long", len(one) * 2)):
        data = write_tiff(base_tags(60, 100, 8, 3, 2, 1), [one])
        out[f"single_strip_count_{name}"] = tiff_files.cut(data, 0, count)
    strips = [tall[y:y + 7].tobytes() for y in range(0, 60, 7)]
    strips[1] = strips[1][:1000]
    out["strip_counts_differ"] = write_tiff(base_tags(60, 100, 8, 3, 2, 1, rows=7), strips)
    strips = [rgb[y:y + 5].tobytes() for y in range(0, 9, 5)]
    strips[1] = strips[1][:50]
    out["two_strips_one_short"] = write_tiff(base_tags(9, 11, 8, 3, 2, 1, rows=5), strips)
    chunks, tables = jpeg_chunks(big, rows=8)
    chunks[1] = chunks[1][:len(chunks[1]) // 2]
    out["cut_jpeg_ycbcr"] = write_tiff(
        base_tags(23, 37, 8, 3, 6, 7, 8, t347=(7, tables), t530=(3, [2, 2])), chunks)
    chunks, tables = jpeg_chunks(big, rows=8)
    out["jpeg_rgb_photometric_subsampled"] = write_tiff(
        base_tags(23, 37, 8, 3, 2, 7, 8, t347=(7, tables)), chunks)
    chunks[0] = b"\xff\xd8\xff\xd9"
    out["jpeg_without_image"] = write_tiff(
        base_tags(23, 37, 8, 3, 6, 7, 8, t347=(7, tables), t530=(3, [2, 2])), chunks)
    return {"damaged_" + k: v for k, v in out.items()}


def mutation_bases() -> dict:
    """name -> file bytes: one small file a compression, whose data
    ``tiff_files.mutate`` damages and whose byte counts it cuts."""
    rgb = smooth(23, 37, 3, seed=20)
    bw = blobs(40, 64, seed=21)
    deflate = lambda raw, _: zlib.compress(raw, 6)  # noqa: E731
    out = {}

    def page(samples, bps, photometric, compression, coder, rows=None, tile=None, planar=1,
             predictor=False, order="<", **more):
        h, w, n = samples.shape
        tags = base_tags(h, w, bps, n, photometric, compression, rows, tile, planar, **more)
        if predictor:
            tags[317] = (3, [2])
        return write_tiff(tags, chunks_of(samples, bps, coder, order, rows, tile, planar,
                                          predictor), order, tiled=tile is not None)
    out["mut_lzw_rgb_predictor"] = page(rgb, 8, 2, 5, lzw, rows=8, predictor=True)
    out["mut_deflate_gray16_be"] = page(smooth(23, 37, 1, 65535, seed=22), 16, 1, 8, deflate,
                                        rows=8, order=">")
    out["mut_packbits_palette_tiles"] = page(
        (rgb[:, :, :1] >> 2), 8, 3, 32773, lambda raw, _: packbits(raw), tile=(16, 16),
        t320=(3, [int(v) for v in np.random.default_rng(23).integers(0, 65536, 768)]))
    out["mut_g4"] = page(bw, 1, 0, 4, ccitt("group4"), rows=20)
    out["mut_g3_2d"] = page(bw, 1, 0, 3, ccitt("group3", 1), rows=20, t292=(4, [1]))
    out["mut_mh"] = page(bw, 1, 0, 2, ccitt("tiff_ccitt"), rows=20)
    out["mut_rlew"] = write_tiff(base_tags(40, 64, 1, 1, 0, 32771, 20),
                                 [rlew(bw[y:y + 20]) for y in (0, 20)])
    chunks, tables = jpeg_chunks(rgb, rows=8)
    out["mut_jpeg_ycbcr"] = write_tiff(
        base_tags(23, 37, 8, 3, 6, 7, 8, t347=(7, tables), t530=(3, [2, 2])), chunks)
    out["mut_none_cmyk_planar"] = page(smooth(23, 37, 4, seed=24), 8, 5, 1, lambda r, _: r,
                                       rows=8, planar=2)
    levels = (rgb[:, :, :1] >> 4).astype(np.uint8)
    out["mut_thunder"] = write_tiff(
        base_tags(23, 37, 4, 1, 3, 32809, 8, t320=(3, list(range(0, 65536, 1366))[:48])),
        chunks_of(levels, 4, lambda raw, part: thunder(raw, width=37), rows=8))
    luv = smooth(23, 37, 3, seed=25).astype(np.int64)
    words = (0x7000 + 16 * luv[:, :, 0]) << 16 | (60 + luv[:, :, 1] // 4) << 8 | (150 + luv[:, :, 2] // 5)
    out["mut_sgilog_logluv32"] = write_tiff(
        base_tags(23, 37, 16, 3, 32845, 34676, 8, t339=(3, [2, 2, 2])),
        [sgilog_rle(words[y:y + 8], 4) for y in range(0, 23, 8)])
    out["mut_ycbcr22_deflate"] = write_tiff(base_tags(23, 37, 8, 3, 6, 8, 8, t530=(3, [2, 2])),
                                            ycbcr_chunks(rgb, 2, 2, deflate, rows=8))
    return out


def fixtures() -> dict:
    """name -> file bytes."""
    from PIL import Image, TiffImagePlugin

    rgb = smooth(H, W, 3, seed=1)
    gray = smooth(H, W, 1, seed=2)
    bw = blobs(H, W, seed=3)
    out = {}
    pred = TiffImagePlugin.ImageFileDirectory_v2()
    pred[317] = 2
    # PIL's libtiff, one compression at a time
    for name, comp in (("none", "raw"), ("lzw", "tiff_lzw"), ("deflate", "tiff_deflate"),
                       ("adobe_deflate", "tiff_adobe_deflate"), ("packbits", "packbits"),
                       ("jpeg", "jpeg")):
        out[f"pil_rgb_{name}"] = pil_page(Image.fromarray(rgb), comp)
        out[f"pil_gray_{name}"] = pil_page(Image.fromarray(gray[:, :, 0]), comp)
    out["pil_rgb_lzw_predictor"] = pil_page(Image.fromarray(rgb), "tiff_lzw", tiffinfo=pred)
    out["pil_gray_deflate_predictor"] = pil_page(Image.fromarray(gray[:, :, 0]),
                                                 "tiff_adobe_deflate", tiffinfo=pred)
    bits = Image.fromarray(bw[:, :, 0].astype(bool))
    for name, comp, t4 in (("none", "raw", None), ("mh", "tiff_ccitt", None),
                           ("g3_1d", "group3", None), ("g3_2d", "group3", 1),
                           ("g3_2d_fill", "group3", 5), ("g3_1d_fill", "group3", 4),
                           ("g4", "group4", None), ("lzw", "tiff_lzw", None),
                           ("packbits", "packbits", None)):
        info = TiffImagePlugin.ImageFileDirectory_v2()
        if t4 is not None:
            info[292] = t4
        out[f"pil_bilevel_{name}"] = pil_page(bits, comp, tiffinfo=info)
    out["pil_gray16"] = pil_page(Image.fromarray(smooth(H, W, 1, 65535, 4)[:, :, 0]), "raw")
    out["pil_gray_alpha"] = pil_page(Image.fromarray(smooth(H, W, 2, seed=5), "LA"), "raw")
    out["pil_rgba_unassociated"] = pil_page(Image.fromarray(smooth(H, W, 4, seed=6), "RGBA"),
                                            "tiff_lzw")
    out["pil_palette"] = pil_page(Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE),
                                  "tiff_lzw")
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="TIFF", save_all=True,
                              append_images=[Image.fromarray(255 - rgb)])
    out["pil_two_pages"] = buf.getvalue()

    # The hand writer
    def page(samples, bps, photometric, compression, coder, order="<", big=False, rows=None,
             tile=None, planar=1, predictor=False, **more):
        h, w, n = samples.shape
        tags = base_tags(h, w, bps, n, photometric, compression, rows, tile, planar, **more)
        if predictor:
            tags[317] = (3, [2])
        return write_tiff(tags, chunks_of(samples, bps, coder, order, rows, tile, planar,
                                          predictor), order, big, tiled=tile is not None)

    none = lambda raw, _: raw  # noqa: E731
    deflate = lambda raw, _: zlib.compress(raw, 6)  # noqa: E731
    pb = lambda raw, _: packbits(raw)  # noqa: E731
    tile = (TILE, TILE)
    out["tiles_rgb_lzw"] = page(rgb, 8, 2, 5, lzw, tile=tile)
    out["tiles_gray_deflate_predictor"] = page(gray, 8, 1, 8, deflate, tile=tile, predictor=True)
    out["tiles_bilevel_g4_miniswhite"] = page(bw, 1, 0, 4, ccitt("group4"), tile=tile)
    out["tiles_bilevel_g3_2d"] = page(bw, 1, 0, 3, ccitt("group3", 1), tile=tile,
                                      t292=(4, [1]))
    out["strips_bilevel_g4_miniswhite"] = page(bw, 1, 0, 4, ccitt("group4"), rows=8)
    out["strips_bilevel_mh_miniswhite"] = page(bw, 1, 0, 2, ccitt("tiff_ccitt"), rows=5)
    out["strips_rgb_packbits"] = page(rgb, 8, 2, 32773, pb, rows=4)
    out["strips_gray_none"] = page(gray, 8, 1, 1, none, rows=7)
    chunks, tables = jpeg_chunks(rgb, rows=8)
    out["strips_jpeg_ycbcr"] = write_tiff(
        base_tags(H, W, 8, 3, 6, 7, 8, t347=(7, tables), t530=(3, [2, 2])), chunks)
    chunks, tables = jpeg_chunks(rgb, tile=tile)
    out["tiles_jpeg_ycbcr"] = write_tiff(
        base_tags(H, W, 8, 3, 6, 7, tile=tile, t347=(7, tables), t530=(3, [2, 2])), chunks,
        tiled=True)
    chunks, tables = jpeg_chunks(gray, rows=16)
    out["strips_jpeg_gray_miniswhite"] = write_tiff(
        base_tags(H, W, 8, 1, 0, 7, 16, t347=(7, tables)), chunks)
    out["planar_rgb_packbits"] = page(rgb, 8, 2, 32773, pb, rows=8, planar=2)
    rgba16 = smooth(H, W, 4, 65535, seed=7)
    out["planar_rgba16_unassociated_deflate"] = page(rgba16, 16, 2, 8, deflate, planar=2,
                                                     rows=8, t338=(3, [2]))
    gray_alpha = smooth(H, W, 2, seed=8)
    out["planar_gray_alpha_miniswhite"] = page(gray_alpha, 8, 0, 1, none, planar=2,
                                               t338=(3, [2]))
    out["planar_gray16_alpha_associated"] = page(smooth(H, W, 2, 65535, seed=9), 16, 1, 1, none,
                                                 planar=2, t338=(3, [1]))
    for order, tag in (("<", "le"), (">", "be")):
        out[f"rgb16_lzw_predictor_{tag}"] = page(smooth(H, W, 3, 65535, seed=10), 16, 2, 5, lzw,
                                                 order=order, rows=9, predictor=True)
        out[f"gray16_miniswhite_{tag}"] = page(smooth(H, W, 1, 65535, seed=11), 16, 0, 1, none,
                                               order=order, rows=9)
        out[f"bigtiff_rgb_deflate_{tag}"] = page(rgb, 8, 2, 32946, deflate, order=order,
                                                 big=True, rows=10, tile=None)
        out[f"bigtiff_tiles_gray_lzw_{tag}"] = page(gray, 8, 1, 5, lzw, order=order, big=True,
                                                    tile=tile)
    out["big_endian_bilevel_g4"] = page(bw, 1, 0, 4, ccitt("group4"), order=">", rows=12)
    out["rgba16_unassociated"] = page(rgba16, 16, 2, 1, none, t338=(3, [2]))
    out["rgba16_associated"] = page(rgba16, 16, 2, 1, none, t338=(3, [1]))
    rgba = smooth(H, W, 4, seed=12)
    out["rgba_associated"] = page(rgba, 8, 2, 5, lzw, t338=(3, [1]))
    out["rgba_unspecified"] = page(rgba, 8, 2, 5, lzw, t338=(3, [0]))
    out["rgb_extra_without_extrasamples"] = page(rgba, 8, 2, 1, none)
    out["gray_alpha_unspecified"] = page(gray_alpha, 8, 1, 1, none, t338=(3, [0]))
    out["gray16_alpha_unassociated"] = page(smooth(H, W, 2, 65535, seed=13), 16, 1, 8, deflate,
                                            t338=(3, [2]))
    rng = np.random.default_rng(14)
    for bps in (1, 2, 4):
        top = (1 << bps) - 1
        levels = rng.integers(0, top + 1, (H, W, 1)).astype(np.uint8)
        out[f"gray{bps}_minisblack"] = page(levels, bps, 1, 1, none, rows=6)
        out[f"gray{bps}_miniswhite_packbits"] = page(levels, bps, 0, 32773, pb)
        cmap8 = rng.integers(0, 256, 3 * (top + 1))
        out[f"palette{bps}_8bit_colormap"] = page(levels, bps, 3, 5, lzw, t320=(3, list(cmap8)))
        cmap16 = rng.integers(0, 65536, 3 * (top + 1))
        out[f"palette{bps}_16bit_colormap"] = page(levels, bps, 3, 1, none,
                                                   t320=(3, list(cmap16)))
    idx = rng.integers(0, 256, (H, W, 1)).astype(np.uint8)
    out["palette8_16bit_colormap_tiles"] = page(idx, 8, 3, 8, deflate, tile=tile,
                                                t320=(3, list(rng.integers(0, 65536, 768))))
    for name, samples, bps, photometric, comp, coder in (
            ("bilevel_g4", bw, 1, 0, 4, ccitt("group4")),
            ("bilevel_g3_2d", bw, 1, 0, 3, ccitt("group3", 1)),
            ("bilevel_none", bw, 1, 0, 1, none), ("gray_lzw", gray, 8, 1, 5, lzw),
            ("gray_deflate", gray, 8, 1, 8, deflate),
            ("gray_packbits", gray, 8, 1, 32773, pb)):
        more = {"t292": (4, [1])} if comp == 3 else {}
        out[f"fillorder2_{name}"] = page(
            samples, bps, photometric, comp,
            lambda raw, part, c=coder: bytes(_REVERSE[np.frombuffer(c(raw, part), np.uint8)]),
            rows=9, t266=(3, [2]), **more)
    square = smooth(24, 24, 3, seed=15)
    for value in range(0, 10):
        out[f"orientation{value}"] = page(rgb, 8, 2, 1, none, t274=(3, [value]))
        out[f"orientation{value}_square"] = page(square, 8, 2, 1, none, t274=(3, [value]))
    for value in (2, 3, 4):
        out[f"orientation{value}_strips"] = page(rgb, 8, 2, 8, deflate, rows=5,
                                                 t274=(3, [value]))
        out[f"orientation{value}_tiles"] = page(rgb, 8, 2, 8, deflate, tile=tile,
                                                t274=(3, [value]))
    for value in (6, 7):
        out[f"orientation{value}_square_tiles"] = page(smooth(40, 40, 3, seed=16), 8, 2, 8,
                                                       deflate, tile=tile, t274=(3, [value]))
    # SampleFormat 2: the bytes read as unsigned
    signed = rng.integers(-128, 128, (H, W, 3)).astype(np.int8).view(np.uint8)
    out["sampleformat2_int8_rgb"] = page(signed, 8, 2, 5, lzw, rows=8, t339=(3, [2, 2, 2]))
    signed16 = rng.integers(-32768, 32768, (H, W, 1)).astype(np.int16).view(np.uint16)
    out["sampleformat2_int16_gray_tiles"] = page(signed16, 16, 1, 1, none, tile=tile,
                                                 t339=(3, [2]))
    # CMYK (separated, InkSet 1): (255 - k) * (255 - c) // 255
    cmyk = smooth(H, W, 4, seed=30)
    out["cmyk_lzw"] = page(cmyk, 8, 5, 5, lzw, rows=8)
    out["cmyk_planar_deflate_tiles"] = page(cmyk, 8, 5, 8, deflate, tile=tile, planar=2)
    out["cmyk_extra_sample_packbits"] = page(cmyk, 8, 5, 32773, pb, t332=(3, [1]))
    # YCbCr without JPEG: each subsampling libtiff puts, strips and tiles
    ycc = smooth(H, W, 3, seed=31)
    for sh, sv in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)):
        out[f"ycbcr{sh}{sv}_strips"] = write_tiff(
            base_tags(H, W, 8, 3, 6, 1, 4 * sv, t530=(3, [sh, sv])),
            ycbcr_chunks(ycc, sh, sv, lambda r, _: r, rows=4 * sv))
        out[f"ycbcr{sh}{sv}_tiles_lzw"] = write_tiff(
            base_tags(H, W, 8, 3, 6, 5, tile=tile, t530=(3, [sh, sv])),
            ycbcr_chunks(ycc, sh, sv, lzw, tile=tile), tiled=True)
    out["ycbcr22_default_subsampling_deflate"] = write_tiff(
        base_tags(H, W, 8, 3, 6, 8, 8), ycbcr_chunks(ycc, 2, 2, deflate, rows=8))
    out["ycbcr11_refbw_coefficients"] = write_tiff(
        base_tags(H, W, 8, 3, 6, 1, t530=(3, [1, 1]),
                  t532=(5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]),
                  t529=(5, [2126, 10000, 7152, 10000, 722, 10000])),
        ycbcr_chunks(ycc, 1, 1, lambda r, _: r, rows=H))
    out["ycbcr11_planar"] = page(ycc, 8, 6, 32773, pb, rows=8, planar=2, t530=(3, [1, 1]))
    # CIELab at 8 and 16 bits, the D50 default white and a WhitePoint tag
    lab = smooth(H, W, 3, seed=32)
    out["cielab8_strips"] = page(lab, 8, 8, 1, none, rows=8)
    out["cielab8_white_point"] = page(lab, 8, 8, 8, deflate, t318=(5, [3127, 10000, 3290, 10000]))
    out["cielab16_tiles"] = page(smooth(H, W, 3, 65535, seed=33), 16, 8, 5, lzw, tile=tile)
    # the gray and palette put functions' edge-tile skew
    out["gray_alpha_tiles"] = page(smooth(H, W, 2, seed=34), 8, 1, 1, none, tile=tile,
                                   t338=(3, [2]))
    out["gray16_tiles"] = page(smooth(H, W, 1, 65535, seed=35), 16, 1, 8, deflate, tile=tile)
    out["palette8_two_samples_tiles"] = page(
        smooth(H, W, 2, seed=36), 8, 3, 1, none, tile=tile,
        t320=(3, [int(v) for v in rng.integers(0, 256, 768)]))
    # ThunderScan (4-bit palette) and word-aligned Modified Huffman
    levels4 = (smooth(H, W, 1, seed=37) >> 4).astype(np.uint8)
    out["thunder_palette4"] = write_tiff(
        base_tags(H, W, 4, 1, 3, 32809, 6, t320=(3, [int(v) for v in rng.integers(0, 65536, 48)])),
        chunks_of(levels4, 4, lambda raw, part: thunder(raw, width=W), rows=6))
    out["rlew_bilevel"] = write_tiff(base_tags(H, W, 1, 1, 0, 32771, 12),
                                     [rlew(bw[y:y + 12]) for y in (0, 12)])
    # SGILog: LogL (16-bit words), LogLuv (32-bit, 24-bit), as libtiff
    # hands them to TIFFRGBAImage in 8 bits
    logl = (rng.integers(0x6000, 0x8000, (H, W)) & ~15).astype(np.int64)
    logl[::4, :20] = 0x7000
    out["sgilog_logl16"] = write_tiff(base_tags(H, W, 16, 1, 32844, 34676, 8, t339=(3, [2])),
                                      [sgilog_rle(logl[y:y + 8], 2) for y in range(0, H, 8)])
    luv = (rng.integers(0x6800, 0x8000, (H, W)) << 16 | rng.integers(60, 120, (H, W)) << 8
           | rng.integers(150, 200, (H, W)))
    luv[1::3, 5:] = luv[1, 5]
    out["sgilog_logluv32"] = write_tiff(
        base_tags(H, W, 16, 3, 32845, 34676, 8, t339=(3, [2, 2, 2])),
        [sgilog_rle(luv[y:y + 8], 4) for y in range(0, H, 8)])
    p24 = rng.integers(640, 900, (H, W)) << 14 | rng.integers(0, 16400, (H, W))
    raw24 = np.stack([p24 >> 16, (p24 >> 8) & 255, p24 & 255], axis=2).astype(np.uint8)
    out["sgilog_logluv24"] = write_tiff(
        base_tags(H, W, 16, 3, 32845, 34677, 8, t339=(3, [2, 2, 2])),
        [raw24[y:y + 8].tobytes() for y in range(0, H, 8)])
    chunks = [sgilog_rle(luv[y:y + 8], 4) for y in range(0, H, 8)]
    chunks[1] = chunks[1][:len(chunks[1]) // 2]
    out["sgilog_logluv32_cut"] = write_tiff(
        base_tags(H, W, 16, 3, 32845, 34676, 8, t339=(3, [2, 2, 2])), chunks)
    out["sgilog_logl_in_sgilog24"] = write_tiff(
        base_tags(H, W, 16, 1, 32844, 34677, 8), [sgilog_rle(logl[y:y + 8], 2)
                                                  for y in range(0, H, 8)])
    out["sgilog_rgb"] = write_tiff(base_tags(H, W, 16, 3, 2, 34676, 8),
                                   [sgilog_rle(luv[y:y + 8], 4) for y in range(0, H, 8)])
    # JPEG strips libtiff hands through unconverted (JCS_UNKNOWN): CMYK
    # (PIL's Adobe CMYK JPEG) and an RGB photometric over cv2's JFIF 4:4:4
    # streams (their YCbCr planes read as R, G and B)
    from PIL import Image

    def pil_cmyk(raw, part):
        buf = io.BytesIO()
        Image.fromarray(part, "CMYK").save(buf, "JPEG", quality=90)
        return buf.getvalue()

    out["jpeg_cmyk_strips"] = page(smooth(H, W, 4, seed=38), 8, 5, 7, pil_cmyk, rows=8)

    def cv2_444(raw, part):
        import cv2

        return cv2.imencode(".jpg", np.ascontiguousarray(part[:, :, ::-1]),
                            [cv2.IMWRITE_JPEG_QUALITY, 90,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111])[1].tobytes()

    out["jpeg_rgb_photometric_jfif"] = page(rgb, 8, 2, 7, cv2_444, rows=8)
    out.update(damaged())
    out.update(mutation_bases())
    a4 = text_page()
    out["a4_g4_text"] = page(a4, 1, 0, 4, ccitt("group4"),
                             rows=max(1, 8192 * 8 // a4.shape[1]))
    return out


_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def cv2_read(path: str):
    """cv2.imread(path, 1)'s digest {"sha256", "shape"}, None, or
    "raises"."""
    import cv2

    try:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
    except cv2.error:
        return "raises"
    if img is None:
        return None
    return {"sha256": hashlib.sha256(img.tobytes()).hexdigest(), "shape": list(img.shape)}


def ycbcr_page() -> bytes:
    """The 2560x1792 page: the committed progressive JPEG page's pixels
    as YCbCr (cv2's BGR2YCrCb), Cb and Cr averaged over each 2x2 block,
    in Deflate strips of 64 rows."""
    import cv2

    bgr = cv2.imread(os.path.join(os.path.dirname(HERE), PAGE_SOURCE), cv2.IMREAD_COLOR)
    ycrcb = cv2.cvtColor(bgr, cv2.COLOR_BGR2YCrCb)
    h, w, _ = ycrcb.shape
    chroma = cv2.resize(ycrcb, (w // 2, h // 2), interpolation=cv2.INTER_AREA)
    ycc = np.empty_like(ycrcb)
    ycc[:, :, 0] = ycrcb[:, :, 0]
    full = np.repeat(np.repeat(chroma, 2, axis=0), 2, axis=1)
    ycc[:, :, 1], ycc[:, :, 2] = full[:, :, 2], full[:, :, 1]  # Cb, Cr
    return write_tiff(base_tags(h, w, 8, 3, 6, 8, 64, t530=(3, [2, 2])),
                      ycbcr_chunks(ycc, 2, 2, lambda raw, _: zlib.compress(raw, 6), rows=64))


def main() -> None:
    import cv2
    import PIL

    names = fixtures()
    for old in os.listdir(HERE):
        if old.endswith(".tif"):
            os.remove(os.path.join(HERE, old))
    spec = {"made_with": f"OpenCV {cv2.__version__}, PIL {PIL.__version__}",
            "decode": {}, "none": [], "mutations": {}, "cuts": {}, "entries": {}, "pages": {},
            "mutation_seed": MUTATION_SEED, "cut_step": CUT_STEP}
    for name, data in sorted(names.items()):
        path = os.path.join(HERE, name + ".tif")
        with open(path, "wb") as f:
            f.write(data)
        got = cv2_read(path)
        if got is None:
            spec["none"].append(name + ".tif")
        else:
            spec["decode"][name + ".tif"] = got
    tmp = os.path.join(HERE, "mutation.tmp")
    for name, base in sorted(names.items()):
        if not name.startswith("mut_"):
            continue
        rng = tiff_files.mutation_rng(MUTATION_SEED, name + ".tif")
        results = []
        for _ in range(MUTATIONS_PER_BASE):
            with open(tmp, "wb") as f:
                f.write(tiff_files.mutate(base, rng))
            results.append(cv2_read(tmp))
        spec["mutations"][name + ".tif"] = results
        results = []
        for index, length in tiff_files.cuts(base, CUT_STEP):
            with open(tmp, "wb") as f:
                f.write(tiff_files.cut(base, index, length))
            results.append(cv2_read(tmp))
        spec["cuts"][name + ".tif"] = results
        rng = tiff_files.mutation_rng(MUTATION_SEED, "entries " + name + ".tif")
        results = []
        for _ in range(ENTRY_MUTATIONS_PER_BASE):
            with open(tmp, "wb") as f:
                f.write(tiff_files.mutate_entry(base, rng))
            results.append(cv2_read(tmp))
        spec["entries"][name + ".tif"] = results
    os.remove(tmp)
    page = os.path.join(os.path.dirname(HERE), PAGE)
    with open(page, "wb") as f:
        f.write(ycbcr_page())
    spec["pages"][PAGE] = cv2_read(page)
    with open(os.path.join(HERE, "fixtures.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(len(d) for d in names.values())
    n_mut = sum(map(len, spec["mutations"].values()))
    n_cut = sum(map(len, spec["cuts"].values()))
    n_entry = sum(map(len, spec["entries"].values()))
    print(f"{len(names)} files, {total} bytes; {len(spec['decode'])} decode, "
          f"{len(spec['none'])} None; {n_mut} mutations "
          f"({sum(v is None for r in spec['mutations'].values() for v in r)} None), {n_cut} cuts "
          f"({sum(v is None for r in spec['cuts'].values() for v in r)} None), {n_entry} "
          f"directory entries ({sum(v is None for r in spec['entries'].values() for v in r)} "
          f"None, {sum(v == 'raises' for r in spec['entries'].values() for v in r)} raise); "
          f"the page "
          f"{os.path.getsize(page)} bytes")


if __name__ == "__main__":
    main()
