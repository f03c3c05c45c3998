"""The port's TIFF reader (pero_ocr_tpu_torch.utils.tiff, through
image_io.imread) against cv2.imread(path, cv2.IMREAD_COLOR): bit for bit
on every committed fixture (tests/data/tiff, written by
make_fixtures.py: each compression, photometric and bit depth cv2
reads, strips and tiles, planar 1 and 2, both byte orders, BigTIFF,
Predictor 2, FillOrder 2, the Orientation tag, signed samples, CMYK,
YCbCr without JPEG at each subsampling, CIELab, ThunderScan, CCITT
RLE/W; the compressions cv2 gives an all-zero page for; strips cut short
or corrupt), on the digests in fixtures.json (the seeded mutations and
cut byte counts of one base a compression, the 2560x1792 YCbCr page),
and on every 8-bit YCbCr and CIELab triple; the files cv2 returns None
for raise "Unable to read image" (``UnreadableImage``).
"""

import hashlib
import json
import os
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from pero_ocr_tpu_torch import UnreadableImage
from pero_ocr_tpu_torch.utils import tiff
from pero_ocr_tpu_torch.utils.image_io import decode_tiff, imread
from tests import tiff_files
from tests.data.tiff.uv_table import sgilog24_page
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
    """OpenCV's header check (2-bit, 12-bit and non-palette 4-bit
    samples, SampleFormat 3 and 4, no PhotometricInterpretation),
    libtiff's (compressions OpenCV's libtiff does not configure,
    photometrics without a conversion, CMYK at 16 bits), strips libtiff
    cannot load, and a non-square page with Orientation 5-8 (imread's
    buffer check): cv2 returns None, the port raises the JAX command
    line's error."""
    path = os.path.join(FIXTURES, name)
    assert cv2.imread(path, cv2.IMREAD_COLOR) is None
    with pytest.raises(UnreadableImage, match="Unable to read image") as e:
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
    for kind, values in (("compression", (1, 2, 3, 4, 5, 7, 8, 32946, 32773, 32771, 32809,
                                          34676, 34677, 34712, 33003, 33005, 9, 10, 32908,
                                          12345)),
                         ("photometric", (0, 1, 2, 3, 5, 6, 8, 32844, 32845)),
                         ("bits", (1, 4, 8, 16)),
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
    """(id, file bytes, the words the port's refusal used before it read
    these files): the cases it refused by item 15's title until it
    followed cv2 on each."""
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


def _cv2_outcome(path):
    """cv2.imread(path, 1), or None."""
    return cv2.imread(str(path), cv2.IMREAD_COLOR)


@pytest.mark.parametrize("name,data,words", _refusals(), ids=[r[0] for r in _refusals()])
def test_former_refusals_read_as_cv2_reads_them(tmp_path, name, data, words):
    """Each file the port once refused as not ported gives cv2's outcome:
    the same array (signed samples read unsigned, CMYK, CIELab, YCbCr
    without JPEG, what a strip cut short or corrupt decoded before the
    damage, an all-zero page for JPEG 2000 and T.85 compression), or
    "Unable to read image" where cv2 returns None (unconfigured
    compressions, float samples, 12- and 32-bit samples, a 16-bit
    palette, five samples, Predictor 3, a strip past the end of the
    file, a JPEG strip without an image)."""
    path = tmp_path / f"{name}.tif"
    path.write_bytes(data)
    want = _cv2_outcome(path)
    if want is None:
        with pytest.raises(UnreadableImage, match="Unable to read image") as e:
            imread(str(path))
        assert f"{name}.tif" in str(e.value)
    else:
        np.testing.assert_array_equal(imread(str(path)), want)


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


def _read(data: bytes):
    """The port's digest of a TIFF file's bytes, None for "Unable to
    read image", or "raises" where it raises as OpenCV raises."""
    try:
        img = decode_tiff(data)
    except UnreadableImage:
        return None
    except ValueError as e:
        if "OpenCV 5 raises" not in str(e):
            raise
        return "raises"
    return {"sha256": hashlib.sha256(img.tobytes()).hexdigest(), "shape": list(img.shape)}


def test_fixture_counts():
    """The JSON holds every kind of case: decodes, None, the seeded
    mutations and cut byte counts of one base a compression (both
    outcomes among them), and the page."""
    assert len(SPEC["decode"]) >= 160 and len(SPEC["none"]) >= 45
    assert len(SPEC["mutations"]) >= 10 and sum(map(len, SPEC["mutations"].values())) >= 300
    assert sum(map(len, SPEC["cuts"].values())) >= 400
    assert "raises" in [r for rs in SPEC["entries"].values() for r in rs]
    for kind in ("mutations", "cuts", "entries"):
        results = [r for rs in SPEC[kind].values() for r in rs]
        assert any(r is None for r in results) and any(r is not None for r in results)
    assert list(SPEC["pages"]) == [os.path.join("page", "two_columns_2560x1792_ycbcr22.tif")]


@pytest.mark.parametrize("name", sorted(SPEC["mutations"]))
def test_mutations_read_as_cv2_reads_them(name):
    """Each seeded byte mutation of the base's strip and tile data (and
    of the tag values stored among them) reads to cv2's digest or raises
    "Unable to read image" where cv2 returns None."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        base = f.read()
    rng = tiff_files.mutation_rng(SPEC["mutation_seed"], name)
    got = [_read(tiff_files.mutate(base, rng)) for _ in SPEC["mutations"][name]]
    assert [k for k, (g, w) in enumerate(zip(got, SPEC["mutations"][name])) if g != w] == []


@pytest.mark.parametrize("name", sorted(SPEC["entries"]))
def test_directory_entry_mutations_read_as_cv2_reads_them(name):
    """Each seeded change of one byte of one directory entry (a tag's
    number, type, count or value): libtiff's reading of the directory
    (a core tag it cannot read fails it, another is dropped, byte counts
    repaired), OpenCV's header check and size limits (it raises past
    them), then the page."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        base = f.read()
    rng = tiff_files.mutation_rng(SPEC["mutation_seed"], "entries " + name)
    got = [_read(tiff_files.mutate_entry(base, rng)) for _ in SPEC["entries"][name]]
    assert [k for k, (g, w) in enumerate(zip(got, SPEC["entries"][name])) if g != w] == []


@pytest.mark.parametrize("name", sorted(SPEC["cuts"]))
def test_cut_byte_counts_read_as_cv2_reads_them(name):
    """Each strip or tile of the base with its byte count cut to 1, 1 +
    step, ... bytes: libtiff's partial decode, or None."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        base = f.read()
    cases = tiff_files.cuts(base, SPEC["cut_step"])
    assert len(cases) == len(SPEC["cuts"][name])
    got = [_read(tiff_files.cut(base, index, length)) for index, length in cases]
    assert [c for c, g, w in zip(cases, got, SPEC["cuts"][name]) if g != w] == []


def test_ycbcr_page_equals_cv2_and_digest():
    """The committed 2560x1792 YCbCr 2x2 Deflate page: cv2's array and
    the digest the card's run holds it to; its whole strips inflate in
    Python's zlib, one call a strip."""
    rel = os.path.join("page", "two_columns_2560x1792_ycbcr22.tif")
    path = os.path.join(os.path.dirname(FIXTURES), rel)
    with open(path, "rb") as f:
        data = f.read()
    strips = len(tiff.Directory(data).values(tiff.STRIP_OFFSETS))
    before = tiff.calls["zlib"]
    assert _read(data) == SPEC["pages"][rel]
    assert tiff.calls["zlib"] - before == strips
    np.testing.assert_array_equal(imread(path), cv2.imread(path, cv2.IMREAD_COLOR))


def test_every_8bit_ycbcr_and_cielab_triple(tmp_path):
    """All 2**24 8-bit (Y, Cb, Cr) and (L, a, b) triples in one 4096x4096
    uncompressed page each: the port's libtiff tables give cv2's page."""
    n = np.arange(1 << 24, dtype=np.uint32)
    triples = np.stack([n >> 16, (n >> 8) & 255, n & 255], axis=1).astype(np.uint8)
    raw = triples.tobytes()
    strips = [raw[k:k + 256 * 4096 * 3] for k in range(0, len(raw), 256 * 4096 * 3)]
    for name, photometric, more in (("ycbcr11", 6, {"t530": (3, [1, 1])}), ("cielab8", 8, {})):
        path = tmp_path / f"{name}.tif"
        path.write_bytes(write_tiff(base_tags(4096, 4096, 8, 3, photometric, 1, 256, **more),
                                    strips))
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)
        got = imread(str(path))
        assert want is not None and got.shape == want.shape
        assert np.array_equal(got, want), name
        path.unlink()


def test_every_sgilog24_chroma_code(tmp_path):
    """Each of the 2**14 chroma codes of an SGILog24 pixel (inside and
    past libtiff's uv table) at luminances from none to full: the port's
    table (tests/data/tiff/uv_table.py) and XYZtoRGB24 give cv2's page."""
    path = tmp_path / "uv.tif"
    codes = np.arange(1 << 14)
    for l10 in (0, 1, 500, 700, 768, 820, 1023):
        path.write_bytes(sgilog24_page(codes, l10))
        np.testing.assert_array_equal(imread(str(path)), cv2.imread(str(path), cv2.IMREAD_COLOR))
