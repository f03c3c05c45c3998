"""The port's image reader (pero_ocr_tpu_torch.utils.image_io.imread)
against cv2.imread(path, cv2.IMREAD_COLOR): bit for bit on every case.

PNGs come from cv2.imwrite at every compression level, and from a
test-local encoder that forces each row filter (and mixtures), colour
type and bit depth (1, 2, 4, 8 and 16), interlaced (Adam7) or not; PNM
(P1-P6) from cv2.imwrite and by hand.  PNG (an eXIf chunk) and JPEG (an
APP1 Exif segment) pages carry each of the 8 EXIF orientations and
malformed tags, turned as cv2 turns them.  Formats the reader does not
take (GIF, an LZMA TIFF among them) raise ValueError naming the file
and the ROADMAP item.  (The JPEG codec itself: tests/test_torch_jpeg.py;
TIFF: tests/test_torch_tiff.py; BMP and PAM: tests/test_torch_bmp_pam.py;
WebP: tests/test_torch_webp.py.)
"""

import struct
import time
import zlib

import cv2
import numpy as np
import pytest

from pero_ocr_tpu_torch import IMAGES as NOT_READ_ITEM
from pero_ocr_tpu_torch import UnreadableImage
from pero_ocr_tpu_torch.utils.image_io import imread
from tests.data.tiff.make_fixtures import base_tags, write_tiff

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _image(h, w, c, dtype=np.uint8, seed=0):
    """Smooth gradients plus noise and a few flat blocks, so that the
    encoder's filter choice varies from row to row."""
    rng = np.random.default_rng(seed)
    top = np.iinfo(dtype).max
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 7 + y * 3)[:, :, None] + np.arange(c) * 50
    img = (base + rng.integers(0, 40, (h, w, c))) % (top + 1)
    img[h // 3: h // 2, w // 4: w // 2] = top // 3
    return img.astype(dtype)


@pytest.mark.parametrize("level", range(10))
@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "gray16", "bgr16"])
def test_cv2_written_png(tmp_path, level, kind):
    c = {"gray": 1, "bgr": 3, "bgra": 4, "gray16": 1, "bgr16": 3}[kind]
    img = _image(37, 53, c, np.uint16 if kind.endswith("16") else np.uint8, seed=level)
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, img[:, :, 0] if c == 1 else img,
                       [cv2.IMWRITE_PNG_COMPRESSION, level])
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    got = imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# A test-local PNG encoder that forces the row filters.
def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_rows(raw, bpp, filters):
    """Apply PNG filter ``filters[r]`` to byte row r (the spec's
    definitions, one row at a time)."""
    h, n = raw.shape
    out = np.zeros((h, n + 1), np.uint8)
    cur_all = raw.astype(np.int16)
    for r in range(h):
        cur = cur_all[r]
        up = cur_all[r - 1] if r else np.zeros(n, np.int16)
        left = np.concatenate([np.zeros(bpp, np.int16), cur[:-bpp]])[:n]
        up_left = np.concatenate([np.zeros(bpp, np.int16), up[:-bpp]])[:n]
        f = filters[r]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            pa, pb, pc = abs(up - up_left), abs(left - up_left), abs(left + up - 2 * up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        out[r, 0] = f
        out[r, 1:] = (cur - pred) & 0xFF
    return out


def _raw_rows(samples, depth):
    """(h, w, c) samples -> (h, row_bytes) bytes as PNG stores them."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * c).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    # pack sub-byte samples, most significant first
    bits = ((samples.reshape(h, w * c, 1) >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _encode(samples, ctype, depth, filters, palette=None, interlace=0, chunks=()):
    """samples: (H, W, channels) integers < 2**depth -> PNG bytes; with
    ``interlace`` the seven Adam7 passes, each row of each pass with the
    filter of ``filters`` at its image row."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        parts = []
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                parts.append(_filter_rows(_raw_rows(sub, depth), bpp,
                                          np.asarray(filters)[y0::dy]).tobytes())
        body = np.frombuffer(b"".join(parts), np.uint8)
    else:
        body = _filter_rows(_raw_rows(samples, depth), bpp, filters)
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                              0, 0, interlace))
    for kind, chunk_body in chunks:
        data += _chunk(kind, chunk_body)
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    half = len(body.tobytes()) // 2  # two IDAT chunks
    z = zlib.compress(body.tobytes(), 6)
    return data + _chunk(b"IDAT", z[:half]) + _chunk(b"IDAT", z[half:]) + _chunk(b"IEND", b"")


def _check(tmp_path, data, name="x.png"):
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert want is not None
    got = imread(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


FILTER_CASES = ["none", "sub", "up", "avg", "paeth", "mixed"]


def _filters(case, h, seed=0):
    if case == "mixed":
        return np.random.default_rng(seed).integers(0, 5, h)
    return [FILTER_CASES.index(case)] * h


@pytest.mark.parametrize("filters", FILTER_CASES)
@pytest.mark.parametrize("ctype,depth", [(0, 8), (2, 8), (4, 8), (6, 8), (0, 16), (2, 16),
                                         (4, 16), (6, 16), (3, 8)])
def test_forced_filters(tmp_path, filters, ctype, depth):
    h, w, c = 23, 19, CHANNELS[ctype]
    rng = np.random.default_rng(ctype * 100 + depth)
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (200, 3))
        samples = rng.integers(0, 200, (h, w, 1))
    else:
        samples = _image(h, w, c, np.uint16 if depth == 16 else np.uint8, seed=ctype)
    _check(tmp_path, _encode(samples, ctype, depth, _filters(filters, h), palette))


@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 4)])
def test_sub_byte_depths(tmp_path, ctype, depth):
    """Gray and palette PNGs of 1, 2 and 4 bits: gray scaled to 8 bits,
    palette indexes through PLTE, as libpng expands them for cv2; rows
    whose width leaves part of a byte unused."""
    h, w = 9, 13
    rng = np.random.default_rng(depth)
    samples = rng.integers(0, 1 << depth, (h, w, 1))
    palette = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
    _check(tmp_path, _encode(samples, ctype, depth, _filters("mixed", h, depth), palette))


@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8),
                                         (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8),
                                         (4, 16), (6, 8), (6, 16)])
def test_interlaced(tmp_path, ctype, depth):
    """Adam7 PNGs at every colour type and depth, mixed filters, on
    sizes whose first passes are empty (1x1, 3x2) or partial."""
    rng = np.random.default_rng(ctype * 100 + depth)
    for h, w in ((1, 1), (3, 2), (9, 13), (17, 6)):
        samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype]))
        palette = rng.integers(0, 256, (1 << min(depth, 8), 3)) if ctype == 3 else None
        _check(tmp_path, _encode(samples, ctype, depth, _filters("mixed", h, w), palette,
                                 interlace=1))


@pytest.mark.parametrize("shape", [(1, 17), (17, 1), (1, 1)])
@pytest.mark.parametrize("filters", FILTER_CASES)
def test_one_row_and_one_column(tmp_path, shape, filters):
    samples = _image(*shape, 3)
    _check(tmp_path, _encode(samples, 2, 8, _filters(filters, shape[0])))


def test_palette_transparency_and_ancillary_chunks(tmp_path):
    """tRNS (palette alpha) is dropped like any alpha; ancillary chunks
    are skipped."""
    rng = np.random.default_rng(5)
    palette = rng.integers(0, 256, (16, 3))
    samples = rng.integers(0, 16, (11, 7, 1))
    chunks = [(b"tRNS", bytes(range(0, 160, 10))), (b"tEXt", b"Comment\x00test")]
    _check(tmp_path, _encode(samples, 3, 8, _filters("mixed", 11), palette, chunks=chunks))


def test_pnm(tmp_path):
    rng = np.random.default_rng(0)
    for name, img in (("g.pgm", _image(21, 17, 1)[:, :, 0]), ("c.ppm", _image(21, 17, 3)),
                      ("g16.pgm", _image(21, 17, 1, np.uint16)[:, :, 0]),
                      ("c16.ppm", _image(21, 17, 3, np.uint16))):
        path = str(tmp_path / name)
        assert cv2.imwrite(path, img)
        np.testing.assert_array_equal(imread(path), cv2.imread(path, cv2.IMREAD_COLOR))
    # By hand: comments, other maxvals (cv2 does not rescale), P6 order.
    gray = rng.integers(0, 101, (4, 6), dtype=np.uint8)
    deep = rng.integers(0, 1001, (4, 6, 3)).astype(">u2")
    for name, data in (
        ("m100.pgm", b"P5\n# a comment\n6 4\n100\n" + gray.tobytes()),
        ("m1000.ppm", b"P6 6\n4 # another\n1000\n" + deep.tobytes()),
        ("tabs.pgm", b"P5\t6\t4\t255\t" + gray.tobytes()),
    ):
        _check(tmp_path, data, name)
    if data[1:2] in b"23":  # the last number at the end of the file: cv2 reads past it
        path = tmp_path / ("cut_" + name)
        path.write_bytes(data.rstrip())
        assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
        with pytest.raises(ValueError, match="truncated"):
            imread(str(path))


def test_unread_formats_raise(tmp_path):
    """What cv2 reads and the port does not: a GIF page (a progressive
    JPEG, then a WebP page, until the port read those) raises naming the
    file and the ROADMAP item; an LZMA TIFF, which cv2 returns None for
    (its libtiff does not configure LZMA), raises "Unable to read image";
    broken PNG data raises."""
    img = _image(16, 16, 3)
    path = str(tmp_path / "page.gif")
    assert cv2.imwrite(path, img)
    assert cv2.imread(path, cv2.IMREAD_COLOR) is not None
    with pytest.raises(ValueError, match=NOT_READ_ITEM) as e:
        imread(path)
    assert "page.gif" in str(e.value) and not isinstance(e.value, UnreadableImage)
    lzma = tmp_path / "page.tif"
    lzma.write_bytes(write_tiff(base_tags(16, 16, 8, 3, 2, 34925), [b"\0" * 64]))
    assert cv2.imread(str(lzma), cv2.IMREAD_COLOR) is None
    with pytest.raises(UnreadableImage, match="Unable to read image.*LZMA compression") as e:
        imread(str(lzma))
    assert "page.tif" in str(e.value)
    broken = bytearray(_encode(img, 2, 8, [0] * 16))
    broken[40] ^= 0xFF  # inside IDAT: its CRC fails
    (tmp_path / "broken.png").write_bytes(bytes(broken))
    with pytest.raises(ValueError, match="CRC"):
        imread(str(tmp_path / "broken.png"))
    (tmp_path / "short.png").write_bytes(_encode(img, 2, 8, [0] * 16)[:60])
    with pytest.raises(ValueError):
        imread(str(tmp_path / "short.png"))


def test_formats_read_since_tiff_equal_cv2(tmp_path):
    """Formats the port refused before it read TIFF: cv2.imwrite's TIFF
    (LZW), an interlaced PNG and ASCII PNM, each equal to cv2."""
    img = _image(16, 16, 3)
    path = str(tmp_path / "page.tif")
    assert cv2.imwrite(path, img)
    np.testing.assert_array_equal(imread(path), cv2.imread(path, cv2.IMREAD_COLOR))
    _check(tmp_path, _encode(img, 2, 8, [0] * 16, interlace=1), "adam7.png")
    _check(tmp_path, b"P2\n2 1\n255\n0 255\n", "ascii.pgm")


@pytest.mark.parametrize("name,data", [
    ("p1.pbm", b"P1\n# bits\n5 2\n1 0 1 1 0\n0 0 1 1 1\n"),
    ("p1_adjacent.pbm", b"P1 5 2 1011000111"),
    ("p4.pbm", b"P4\n11 2\n\xa5\x40\x0f\xe0"),
    ("p2_scaled.pgm", b"P2\n4 2\n100\n0 13 56 99\n100 120 7 1\n"),
    ("p2_16bit.pgm", b"P2\n3 1 # deep\n1000\n0 513 999\n"),
    ("p3.ppm", b"P3\n2 2\n255\n1 2 3 4 5 6\n7 8 9 250 251 300\n"),
    ("p3_16bit.ppm", b"P3 1 2 65535 65535 256 0 1 2 3 "),
    ("p5_over_maxval.pgm", b"P5\n3 1\n7\n\x01\x08\xff"),
])
def test_pnm_ascii_and_bitmaps(tmp_path, name, data):
    """P1-P4 as cv2's PxM decoder reads them: ASCII samples clamped to
    maxval and scaled to 8 bits, 2-byte ones by their high byte; bitmaps
    1 = black; binary 1-byte samples unscaled."""
    _check(tmp_path, data, name)


def test_full_page_with_mixed_filters_decodes_fast(tmp_path):
    """A 2560x1792 RGB page whose rows use all five filters decodes in
    well under a second on one core (bound set at 3 s here, so that a
    loop per pixel, some 30 s, cannot pass)."""
    page = _image(2560, 1792, 3)
    path = tmp_path / "page.png"
    path.write_bytes(_encode(page, 2, 8, _filters("mixed", 2560)))
    t0 = time.perf_counter()
    got = imread(str(path))
    seconds = time.perf_counter() - t0
    np.testing.assert_array_equal(got, page[:, :, ::-1])
    assert seconds < 3.0, seconds


# ----------------------------------------------------------------------
# EXIF orientation: cv2.imread(path, IMREAD_COLOR) turns PNG and JPEG
# pages by their orientation tag (0x0112).
def _ifd(entries, endian="<"):
    """A TIFF block with one IFD: entries [(tag, type, count, 4 value
    bytes)]."""
    body = (b"II" if endian == "<" else b"MM") + struct.pack(endian + "HI", 42, 8)
    body += struct.pack(endian + "H", len(entries))
    for tag, kind, count, value in entries:
        body += struct.pack(endian + "HHI", tag, kind, count) + value
    return body + struct.pack(endian + "I", 0)


def _orientation(value, endian="<"):
    return (0x0112, 3, 1, struct.pack(endian + "HH", value, 0))


EXIF_CASES = {  # name: TIFF block
    **{f"o{v}": _ifd([_orientation(v)]) for v in range(1, 9)},
    "o6_big_endian": _ifd([_orientation(6, ">")], ">"),
    "o6_as_long": _ifd([(0x0112, 4, 1, struct.pack("<I", 6))]),  # read as 16 bits
    "o6_long_big_endian": _ifd([(0x0112, 4, 1, struct.pack(">I", 6))], ">"),  # reads 0
    "o9_out_of_range": _ifd([_orientation(9)]),
    "o3_twice_first_wins": _ifd([_orientation(3), _orientation(6)]),
    "o5_after_sub_ifd_pointer": _ifd([(0x8769, 4, 1, struct.pack("<I", 5000)),
                                      _orientation(5)]),
    "o7_then_bad_count": _ifd([_orientation(7)])[:-4] + b"\x00" * 2,
    "cut_in_value": _ifd([_orientation(6)])[:19],
    "string_past_end_first": _ifd([(0x010E, 2, 100, struct.pack("<I", 5000)),
                                   _orientation(6)]),
    "rational_past_end_first": _ifd([(0x011A, 5, 1, struct.pack("<I", 5000)),
                                     _orientation(8)]),
    "bad_tag_mark": _ifd([_orientation(6)]).replace(b"*\x00", b"+\x00", 1),
    "ifd_past_end": _ifd([_orientation(6)])[:4] + struct.pack("<I", 900)
    + _ifd([_orientation(6)])[8:],
    "mixed_byte_order": b"IM" + _ifd([_orientation(6)])[2:],
}


def _png_with_exif(img, tiff, after_idat):
    data = cv2.imencode(".png", img)[1].tobytes()
    at = data.index(b"IEND" if after_idat else b"IDAT") - 4
    return data[:at] + _chunk(b"eXIf", tiff) + data[at:]


def _jpeg_with_exif(img, tiff, header=b"Exif\x00\x00", before=b""):
    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
    app1 = before + header + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


@pytest.mark.parametrize("case", sorted(EXIF_CASES))
@pytest.mark.parametrize("fmt", ["png", "png_after_idat", "jpeg"])
def test_exif_orientation_equals_cv2(tmp_path, fmt, case):
    img = _image(5, 7, 3, seed=len(case))
    tiff = EXIF_CASES[case]
    if fmt == "jpeg":
        data = _jpeg_with_exif(img, tiff)
    else:
        data = _png_with_exif(img, tiff, fmt == "png_after_idat")
    path = tmp_path / ("page.jpg" if fmt == "jpeg" else "page.png")
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    got = imread(str(path))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["xmp_before_exif", "no_exif_header", "exif_header_only",
                                  "two_exif_first_wins", "png_exif_with_jpeg_header",
                                  "png_two_chunks"])
def test_exif_segment_choice_equals_cv2(tmp_path, case):
    """Which block cv2 reads: the first APP1 that starts with Exif\\0\\0
    (an XMP APP1 before it is passed over), the first eXIf chunk that
    starts with II or MM."""
    img = _image(6, 4, 3, seed=2)
    six, three = _ifd([_orientation(6)]), _ifd([_orientation(3)])
    if case == "xmp_before_exif":
        xmp = b"http://ns.adobe.com/xap/1.0/\x00<x/>"
        data = _jpeg_with_exif(img, six)
        data = data[:2] + b"\xff\xe1" + struct.pack(">H", len(xmp) + 2) + xmp + data[2:]
    elif case == "no_exif_header":
        data = _jpeg_with_exif(img, six, header=b"Exif\x00\xff")
    elif case == "exif_header_only":
        data = _jpeg_with_exif(img, b"")
    elif case == "two_exif_first_wins":  # 6, then 3
        data = _jpeg_with_exif(img, three)
        second = b"Exif\x00\x00" + six
        data = data[:2] + b"\xff\xe1" + struct.pack(">H", len(second) + 2) + second + data[2:]
    elif case == "png_exif_with_jpeg_header":
        data = _png_with_exif(img, b"Exif\x00\x00" + six, False)
    else:
        data = _png_with_exif(img, six, False)
        at = data.index(b"IEND") - 4
        data = data[:at] + _chunk(b"eXIf", three) + data[at:]
    path = tmp_path / ("page.png" if case.startswith("png") else "page.jpg")
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(imread(str(path)), want)
