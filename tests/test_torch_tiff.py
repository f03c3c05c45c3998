"""The port's TIFF reader (pero_ocr_tpu_torch.utils.tiff, through
image_io.imread) against cv2.imread(path, cv2.IMREAD_COLOR): bit for bit
on every committed fixture (tests/data/tiff, written by
make_fixtures.py: each compression, photometric and bit depth cv2
reads, strips and tiles, planar 1 and 2, both byte orders, BigTIFF,
Predictor 2, FillOrder 2, the Orientation tag), and on the digests in
fixtures.json; the files cv2 returns None for raise "Unable to read
image"; what the port does not read raises ValueError naming the file
and the ROADMAP item.
"""

import hashlib
import json
import os
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from pero_ocr_tpu_torch import IMAGES as NOT_READ_ITEM
from pero_ocr_tpu_torch.utils import tiff
from pero_ocr_tpu_torch.utils.image_io import imread
from tests.data.tiff.make_fixtures import (
    base_tags, blobs, ccitt, chunks_of, lzw, packbits, smooth, write_tiff,
)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "tiff")
with open(os.path.join(FIXTURES, "fixtures.json"), encoding="utf-8") as _f:
    SPEC = json.load(_f)


@pytest.mark.parametrize("name", sorted(SPEC["decode"]))
def test_fixture_equals_cv2_and_digest(name):
    path = os.path.join(FIXTURES, name)
    got = imread(path)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    digest = SPEC["decode"][name]
    assert list(got.shape) == digest["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == digest["sha256"]


@pytest.mark.parametrize("name", sorted(SPEC["none"]))
def test_fixture_cv2_none_is_unable_to_read(name):
    """2-bit and 4-bit gray (cv2's TIFF header check), and a non-square
    page with Orientation 5-8 (imread's buffer check): cv2 returns None,
    the port raises the JAX command line's error."""
    path = os.path.join(FIXTURES, name)
    assert cv2.imread(path, cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="Unable to read image") as e:
        imread(path)
    assert name in str(e.value)


def test_fixtures_cover_the_item():
    """Every compression, photometric and layout the reader claims is
    among the fixtures cv2 reads."""
    seen = set()
    for name in SPEC["decode"]:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            d = tiff.Directory(f.read())
        seen |= {("compression", d.get(tiff.COMPRESSION, 1)), ("photometric", d.get(262)),
                 ("bits", d.get(tiff.BITS, 1)), ("planar", d.get(tiff.PLANAR, 1)),
                 ("tiled", tiff.TILE_WIDTH in d.tags), ("order", d.order), ("big", d.big),
                 ("predictor", d.get(tiff.PREDICTOR, 1)), ("fill", d.get(tiff.FILL_ORDER, 1)),
                 ("orientation", d.get(tiff.ORIENTATION, 1))}
    for kind, values in (("compression", (1, 2, 3, 4, 5, 7, 8, 32946, 32773)),
                         ("photometric", (0, 1, 2, 3, 6)), ("bits", (1, 4, 8, 16)),
                         ("planar", (1, 2)), ("tiled", (False, True)), ("order", "<>"),
                         ("big", (False, True)), ("predictor", (1, 2)), ("fill", (1, 2)),
                         ("orientation", range(1, 9))):
        for value in values:
            assert (kind, value) in seen, (kind, value)


def _pil_tiff(tmp_path, name, image, compression, **info):
    tags = TiffImagePlugin.ImageFileDirectory_v2()
    for tag, value in info.items():
        tags[int(tag[1:])] = value
    path = tmp_path / name
    image.save(path, compression=compression, tiffinfo=tags)
    return path


def _equal(path):
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert want is not None
    np.testing.assert_array_equal(imread(str(path)), want)


@pytest.mark.parametrize("compression,t292", [("tiff_ccitt", None), ("group3", None),
                                              ("group3", 1), ("group3", 5), ("group4", None)])
def test_ccitt_long_runs(tmp_path, compression, t292):
    """Rows of 5000 pixels with runs of every length up to past 2560
    (the extended make-up codes) and single pixels, coded by libtiff."""
    rng = np.random.default_rng(1)
    h, w = 40, 5000
    img = np.zeros((h, w), bool)
    for y in range(h):
        x = 0
        while x < w:
            run = int(rng.choice([1, 2, 63, 64, 65, 1727, 1728, 1729, 2560, 2561, 3000])
                      if rng.random() < 0.3 else rng.integers(1, 200))
            img[y, x:x + run] = (y + x) % 3 == 0 or rng.random() < 0.5
            x += run
    info = {} if t292 is None else {"t292": t292}
    _equal(_pil_tiff(tmp_path, "long.tif", Image.fromarray(img), compression, **info))


def test_a4_group4_page_counts_its_calls():
    """The committed A4 300-dpi Group 4 page: one tiff_fax call a strip."""
    path = os.path.join(FIXTURES, "a4_g4_text.tif")
    with open(path, "rb") as f:
        strips = len(tiff.Directory(f.read()).values(tiff.STRIP_OFFSETS))
    before = tiff.calls["tiff_fax"]
    page = imread(path)
    assert page.shape == (3508, 2480, 3) and tiff.calls["tiff_fax"] - before == strips
    assert 0.02 < (page == 0).mean() < 0.2  # black text on white


RGB = smooth(9, 11, 3, seed=3)
RAW = RGB.tobytes()


def _refusals():
    """(id, file bytes, the refusal's words)."""
    out = []
    for code, name in ((6, "old-style JPEG"), (34925, "LZMA"), (50000, "ZSTD"),
                       (50001, "WebP"), (34661, "JBIG"), (34712, "JPEG 2000"),
                       (32809, "ThunderScan"), (9, "compression 9")):
        out.append((f"compression_{code}", write_tiff(base_tags(9, 11, 8, 3, 2, code), [RAW]),
                    name))
    for fmt in (2, 3):
        out.append((f"sampleformat_{fmt}",
                    write_tiff(base_tags(9, 11, 8, 3, 2, 1, t339=(3, [fmt] * 3)), [RAW]),
                    f"SampleFormat {fmt}"))
    for bits in (12, 32):
        n = 9 * 11 * 3 * bits // 8
        out.append((f"bits_{bits}", write_tiff(base_tags(9, 11, bits, 3, 2, 1), [b"\0" * n]),
                    f"{bits}-bit samples"))
    out.append(("cmyk", write_tiff(base_tags(9, 11, 8, 4, 5, 1), [RGB.tobytes() * 2]),
                "CMYK"))
    out.append(("cielab", write_tiff(base_tags(9, 11, 8, 3, 8, 1), [RAW]), "CIELab"))
    out.append(("ycbcr_without_jpeg", write_tiff(base_tags(9, 11, 8, 3, 6, 1), [RAW]),
                "YCbCr TIFF file without JPEG"))
    out.append(("palette_16", write_tiff(base_tags(9, 11, 16, 1, 3, 1, t320=(3, [0] * 3 * 65536)),
                                    [b"\0" * 198]), "16-bit palette"))
    out.append(("five_samples", write_tiff(base_tags(9, 11, 8, 5, 2, 1), [b"\0" * 495]),
                "5 samples"))
    out.append(("predictor_3", write_tiff(base_tags(9, 11, 8, 3, 2, 8, t317=(3, [3])),
                                          [zlib.compress(RAW)]), "Predictor 3"))
    out.append(("truncated_strip", write_tiff(base_tags(9, 11, 8, 3, 2, 1), [RAW])[:150],
                "truncated"))
    short = zlib.compress(RAW)[:40]
    out.append(("truncated_deflate", write_tiff(base_tags(9, 11, 8, 3, 2, 8), [short]),
                "Deflate data"))
    out.append(("truncated_lzw", write_tiff(base_tags(9, 11, 8, 3, 2, 5), [lzw(RAW)[:50]]),
                "LZW data is truncated or corrupt"))
    out.append(("old_style_lzw", write_tiff(base_tags(9, 11, 8, 3, 2, 5), [b"\x00\x01" + RAW]),
                "old-style"))
    out.append(("truncated_packbits", write_tiff(base_tags(9, 11, 8, 3, 2, 32773),
                                            [packbits(RAW)[:60]]), "PackBits data"))
    bw = blobs(30, 40, seed=4)
    g4 = chunks_of(bw, 1, ccitt("group4"))[0]
    out.append(("truncated_g4", write_tiff(base_tags(30, 40, 1, 1, 0, 4), [g4[:len(g4) // 2]]),
                "CCITT T.6 data is truncated or corrupt"))
    out.append(("corrupt_g4", write_tiff(base_tags(30, 40, 1, 1, 0, 4), [b"\x00" * 20]),
                "CCITT T.6 data is truncated or corrupt"))
    out.append(("t4_uncompressed_mode", write_tiff(base_tags(30, 40, 1, 1, 0, 3, t292=(4, [2])),
                                              [g4]), "uncompressed mode"))
    out.append(("bad_jpeg_strip", write_tiff(base_tags(9, 11, 8, 1, 1, 7), [b"\xff\xd8\xff\xd9"]),
                "does not decode"))
    return out


@pytest.mark.parametrize("name,data,words", _refusals(), ids=[r[0] for r in _refusals()])
def test_refusals_name_the_file_and_item(tmp_path, name, data, words):
    path = tmp_path / f"{name}.tif"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=NOT_READ_ITEM) as e:
        imread(str(path))
    assert f"{name}.tif" in str(e.value) and words in str(e.value), str(e.value)


def test_multi_page_and_bigtiff_read_the_first_page(tmp_path):
    """A BigTIFF file of three chained directories gives its first."""
    data = write_tiff(base_tags(9, 11, 8, 3, 2, 1), [RAW], big=True, pages=3)
    path = tmp_path / "pages.tif"
    path.write_bytes(data)
    _equal(path)
    np.testing.assert_array_equal(imread(str(path)), RGB[:, :, ::-1])


@pytest.mark.parametrize("compression", [1, 32773, 8])
def test_predictor_only_with_lzw_and_deflate(tmp_path, compression):
    """Predictor 2 on uncompressed and PackBits strips is an unknown tag
    to libtiff, which reads the samples as they are; on Deflate it
    applies."""
    coder = {1: bytes, 32773: packbits, 8: zlib.compress}[compression]
    path = tmp_path / "predictor.tif"
    path.write_bytes(write_tiff(base_tags(9, 11, 8, 3, 2, compression, t317=(3, [2])),
                                [coder(RAW)]))
    _equal(path)


def test_rows_per_strip_past_the_page(tmp_path):
    """RowsPerStrip larger than the page (and the 2**32 - 1 default)."""
    for rows in (50, 2**32 - 1):
        tags = base_tags(9, 11, 8, 3, 2, 5, rows=rows)
        path = tmp_path / f"rows{rows}.tif"
        path.write_bytes(write_tiff(tags, [lzw(RAW)]))
        _equal(path)
