"""The port's BMP reader (``pero_ocr_tpu_torch/utils/bmp.py``) and PAM
reader (``utils/image_io.decode_pam``) against OpenCV 5's, through
``image_io.imread``: each variant, written here with ``struct``
(tests/bmp_pam_files.py), decodes to what ``cv2.imread(path,
cv2.IMREAD_COLOR)`` returns, shape and bytes; what cv2 returns None for
(or raises on) raises ``ValueError`` saying "Unable to read image".

BMP: the OS/2, BITMAPINFOHEADER, V4 and V5 headers; 1-, 4- and 8-bit
palettes (short ones too), 16-bit BI_RGB and BI_BITFIELDS 5-5-5 and
5-6-5, 24 bits, 32 bits BI_RGB and BI_BITFIELDS; RLE8 and RLE4 with end
of line, delta and end of bitmap escapes; bottom-up and top-down rows.
PAM: BLACKANDWHITE, GRAYSCALE, GRAYSCALE_ALPHA, RGB and RGB_ALPHA, MAXVAL
from 1 to 65535, with and without TUPLTYPE, comments, CR line ends.
The committed fixtures of ``tests/data/bmp`` (the card's check,
``chip_smoke.check_jpeg_fixtures``) reproduce their digests.
"""

import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from pero_ocr_tpu_torch.utils.image_io import imread
from tests.bmp_pam_files import (
    BI_BITFIELDS, BI_RLE4, BI_RLE8, MASKS_555, MASKS_565, bmp_file, bmp_rows, pam_body, pam_file,
    rle_rows, rle_stream,
)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "bmp")
SIZES = [(1, 1), (3, 5), (7, 9), (13, 31), (24, 17)]  # (h, w): row padding of every kind


def cv2_and_port(tmp_path, data: bytes, name="page"):
    """(cv2.imread's array or None, the port's array or its error)."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    try:
        want = cv2.imread(path, cv2.IMREAD_COLOR)
    except cv2.error:
        want = None
    try:
        return want, imread(path)
    except ValueError as e:
        return want, e


def assert_like_cv2(tmp_path, data: bytes, columns=None):
    """The port reads ``data`` as cv2 does (on the first ``columns``
    columns of each row where given), or both fail; returns the port's
    array or None."""
    want, got = cv2_and_port(tmp_path, data)
    if want is None:
        assert isinstance(got, ValueError) and "Unable to read image" in str(got), got
        return None
    assert not isinstance(got, Exception), got
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, :columns], want[:, :columns])
    return got


# ----------------------------------------------------------------------
# BMP
@pytest.mark.parametrize("header", [12, 40, 108, 124])
@pytest.mark.parametrize("bpp", [1, 4, 8])
def test_bmp_palettes(tmp_path, bpp, header):
    rng = np.random.default_rng(bpp * 1000 + header)
    n = 1 << bpp
    for (h, w), top_down in zip(SIZES, (False, True) * 3):
        index = rng.integers(0, n, (h, w))
        palette = rng.integers(0, 256, (n, 3))
        got = assert_like_cv2(tmp_path, bmp_file(w, h, bpp, bmp_rows(index, bpp), palette=palette,
                                                 header=header,
                                                 top_down=top_down and header != 12))
        order = slice(None) if top_down and header != 12 else slice(None, None, -1)
        np.testing.assert_array_equal(got, palette[index][order])
    if header != 12:  # a short palette: the entries past biClrUsed are black
        used = max(1, n // 3)
        got = assert_like_cv2(tmp_path, bmp_file(w, h, bpp, bmp_rows(index, bpp),
                                                 palette=palette[:used], header=header,
                                                 clrused=used))
        assert (got[index[::-1] >= used] == 0).all()


@pytest.mark.parametrize("kind", ["16_rgb", "16_555", "16_565", "24", "24_os2", "32_rgb",
                                  "32_bitfields", "16_565_v5"])
def test_bmp_direct_colour(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    for (h, w), top_down in zip(SIZES, (False, True) * 3):
        if kind.startswith("16"):
            masks = {"16_rgb": None, "16_555": MASKS_555}.get(kind, MASKS_565)
            data = bmp_file(w, h, 16, bmp_rows(rng.integers(0, 65536, (h, w)), 16),
                            compression=BI_BITFIELDS if masks else 0, masks=masks,
                            header=124 if kind.endswith("v5") else 40, top_down=top_down)
        elif kind.startswith("24"):
            data = bmp_file(w, h, 24, bmp_rows(rng.integers(0, 256, (h, w, 3)), 24),
                            header=12 if kind.endswith("os2") else 40,
                            top_down=top_down and not kind.endswith("os2"))
        else:
            data = bmp_file(w, h, 32, bmp_rows(rng.integers(0, 256, (h, w, 4)), 32),
                            compression=BI_BITFIELDS if kind.endswith("bitfields") else 0,
                            masks=(0xFF0000, 0xFF00, 0xFF) if kind.endswith("bitfields") else None,
                            top_down=top_down)
        assert assert_like_cv2(tmp_path, data) is not None


@pytest.mark.parametrize("bpp", [8, 4])
def test_bmp_rle(tmp_path, bpp):
    """Runs and absolute spans with an end of line a row and an end of
    bitmap; then streams of random codes (deltas, early ends of line and
    of bitmap, runs past their row), which cv2 reads or refuses."""
    rng = np.random.default_rng(bpp)
    compression = BI_RLE8 if bpp == 8 else BI_RLE4
    for (h, w), top_down in zip(SIZES, (False, True) * 3):
        index = rng.integers(0, 1 << bpp, (h, w)) // int(rng.integers(1, 9))
        palette = rng.integers(0, 256, (1 << bpp, 3))
        got = assert_like_cv2(tmp_path, bmp_file(w, h, bpp, rle_rows(index, rng, bpp),
                                                 compression=compression, palette=palette,
                                                 top_down=top_down))
        np.testing.assert_array_equal(got, palette[index] if top_down else palette[index][::-1])
    read = refused = 0
    for _ in range(60):
        h, w = (int(x) for x in rng.integers(1, 12, 2))
        ops = []
        for _ in range(int(rng.integers(1, 30))):
            r = rng.random()
            if r < 0.4:
                ops.append(("run", int(rng.integers(1, w + 1)), int(rng.integers(0, 256))))
            elif r < 0.6:
                n = int(rng.integers(3, w + 4))
                ops.append(("abs", rng.integers(0, 256, -(-n // (8 // bpp))).tolist(), n))
            elif r < 0.8:
                ops.append(("eol",))
            elif r < 0.9:
                ops.append(("delta", int(rng.integers(0, 4)), int(rng.integers(0, 3))))
            else:
                ops.append(("eob",))
        data = bmp_file(w, h, bpp, rle_stream(ops + [("eob",)]) + b"\0\0" * 24,
                        compression=compression, palette=rng.integers(0, 256, (1 << bpp, 3)))
        if assert_like_cv2(tmp_path, data) is None:
            refused += 1
        else:
            read += 1
    assert read >= 5 and refused >= 5


def test_bmp_none_cases(tmp_path):
    """What cv2 returns None for: other 16-bit masks, a V5 header whose
    masks sit only in the header, compressions past BI_BITFIELDS, RLE8 at
    4 bits, a zero width, data, palette or header past the file's end."""
    rng = np.random.default_rng(7)
    rows16 = bmp_rows(rng.integers(0, 65536, (5, 6)), 16)
    rows24 = bmp_rows(rng.integers(0, 256, (5, 6, 3)), 24)
    full = bmp_file(6, 5, 24, rows24)
    v5 = bmp_file(6, 5, 16, rows16, compression=BI_BITFIELDS, header=124)
    v5 = v5[:54] + np.array(MASKS_565 + (0,), "<u4").tobytes() + v5[70:]
    pal = bmp_file(6, 5, 8, bmp_rows(rng.integers(0, 256, (5, 6)), 8),
                   palette=rng.integers(0, 256, (256, 3)))
    cases = [bmp_file(6, 5, 16, rows16, compression=BI_BITFIELDS, masks=(0xF00, 0xF0, 0xF)), v5,
             bmp_file(6, 5, 24, rows24, compression=4), bmp_file(6, 5, 4, rows24, compression=1),
             bmp_file(0, 5, 24, rows24), full[:-3], full[:40], pal[:300], full[:20]]
    for data in cases:
        want, got = cv2_and_port(tmp_path, data)
        assert want is None and isinstance(got, ValueError), got
        assert "Unable to read image" in str(got)


# ----------------------------------------------------------------------
# PAM
@pytest.mark.parametrize("maxval", [1, 100, 255, 1000, 65535])
@pytest.mark.parametrize("tuple_type,depth", [
    ("BLACKANDWHITE", 1), ("GRAYSCALE", 1), ("GRAYSCALE_ALPHA", 2), ("RGB", 3), ("RGB_ALPHA", 4),
    (None, 1), (None, 3)])
def test_pam_tuple_types(tmp_path, tuple_type, depth, maxval):
    """Each tuple type at each sample size, as cv2 reads it.  cv2 5.0.0
    writes only the first ceil(W / DEPTH) pixels of a GRAYSCALE_ALPHA or
    RGB_ALPHA row (the rest of its output is whatever memory held), so
    those rows are held to cv2 there and to the same conversion past it."""
    rng = np.random.default_rng(depth * 70000 + maxval)
    for i, (h, w) in enumerate(SIZES):
        samples = rng.integers(0, maxval + 1, (h, w, depth))
        data = pam_file(w, h, depth, maxval, pam_body(samples, maxval), tuple_type,
                        comment=i % 2 == 1, newline=b"\r" if i == 2 else b"\n")
        alpha = depth in (2, 4) and maxval != 1
        got = assert_like_cv2(tmp_path, data, -(-w // depth) if alpha else None)
        if tuple_type is None and maxval > 255:
            assert got is None  # no tuple type: cv2 cannot tell 2-byte gray or RGB
            continue
        if maxval == 1:
            continue
        eight = samples >> 8 if maxval > 255 else samples
        want = {1: np.repeat(eight[:, :, :1], 3, axis=2), 2: np.repeat(eight[:, :, :1], 3, axis=2),
                3: eight, 4: eight[:, :, 2::-1]}[depth]
        np.testing.assert_array_equal(got, want)


def test_pam_header_forms(tmp_path):
    """Header lines as cv2 takes them (blank and comment lines, leading
    whitespace, tabs, trailing text after ENDHDR, leading zeros) and
    refuses them (lower case, signs, hex, a missing field, a field twice,
    a DEPTH its TUPLTYPE does not have, MAXVAL over 65535, short data)."""
    body = b"\x10\x20\x30\x40\x50\x60"

    def header(*lines):
        return b"P7\n" + b"\n".join(lines) + b"\n" + body

    std = [b"WIDTH 3", b"HEIGHT 2", b"DEPTH 1", b"MAXVAL 255"]
    taken = [header(b"", b"# c", b" WIDTH 3", b"HEIGHT\t2", *std[2:], b"ENDHDR x"),
             header(b"WIDTH 03", b"HEIGHT 2 ", *std[2:], b"TUPLTYPE GRAYSCALE", b"ENDHDR")]
    refused = [header(b"width 3", *std[1:], b"ENDHDR"), header(b"WIDTH +3", *std[1:], b"ENDHDR"),
               header(b"WIDTH 0x3", *std[1:], b"ENDHDR"), header(*std[1:], b"ENDHDR"),
               header(*std, b"HEIGHT 2", b"ENDHDR"), header(*std, b"TUPLTYPE RGB", b"ENDHDR"),
               header(*std, b"TUPLTYPE grayscale", b"ENDHDR"), header(*std),
               header(*std[:3], b"MAXVAL 65536", b"ENDHDR"), header(b"WIDTH 4", *std[1:], b"ENDHDR"),
               b"P7 " + header(*std, b"ENDHDR")[3:], header(b"WIDTH 3 # c", *std[1:], b"ENDHDR")]
    for data in taken:
        got = assert_like_cv2(tmp_path, data)
        np.testing.assert_array_equal(got[:, :, 0].ravel(), np.frombuffer(body, np.uint8))
    for data in refused:
        assert assert_like_cv2(tmp_path, data) is None


def test_signatures_pick_the_reader(tmp_path):
    """``BM`` and ``P7`` reach their readers; other bytes are still
    refused naming item 15."""
    bmp = bmp_file(2, 1, 24, bmp_rows(np.full((1, 2, 3), 9), 24))
    pam = pam_file(2, 1, 1, 255, b"\x01\x02")
    for data in (bmp, pam):
        assert assert_like_cv2(tmp_path, data).shape == (1, 2, 3)
    path = tmp_path / "page.gif"
    path.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="JPEG/TIFF decoding on the card's machine"):
        imread(str(path))


# ----------------------------------------------------------------------
# The committed fixtures (tests/data/bmp, written by make_fixtures.py
# with struct, digests of cv2.imread): what chip_smoke.check_jpeg_fixtures
# holds the card machine's reader to.
def _fixtures():
    with open(os.path.join(FIXTURES, "fixtures.json"), encoding="utf-8") as f:
        return json.load(f)


def test_fixture_digests_reproduce():
    spec = _fixtures()
    for name, digest in spec["decode"].items():
        got = imread(os.path.join(FIXTURES, name))
        assert hashlib.sha256(got.tobytes()).hexdigest() == digest["sha256"], name
        assert list(got.shape) == digest["shape"], name
    for name in spec["none"]:
        with pytest.raises(ValueError, match="Unable to read image"):
            imread(os.path.join(FIXTURES, name))
    assert len(spec["decode"]) >= 20 and len(spec["none"]) >= 3


def test_fixtures_equal_cv2_here():
    spec = _fixtures()
    for name, digest in spec["decode"].items():
        want = cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_COLOR)
        assert hashlib.sha256(want.tobytes()).hexdigest() == digest["sha256"], name
    for name in spec["none"]:
        assert cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_COLOR) is None, name
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    assert total < 100_000, total
