"""The port's WebP reader (``pero_ocr_tpu_torch/csrc/webp.cpp``, bound in
``pero_ocr_tpu_torch/utils/webp.py``) against OpenCV 5's libwebp, bit
for bit, on the CPU.

Every file of ``tests/data/webp/fixtures.json`` reads through
``image_io.imread`` to the digest of ``cv2.imread(path, 1)``: cv2's and
Pillow's files (lossy across qualities and methods, lossless across
qualities and methods, alpha, ICC, XMP, EXIF Orientation 1-8, palettes,
odd sizes), files rewritten here at the chunk level (animations, VP8X
flags, RIFF sizes, padding, unknown chunks, ALPH with each filter, raw
and lossless) and by tests/webp_files.py's VP8 rewriter (the simple
loop filter, sharpness, filter level 0, deltas, 2, 4 and 8 token
partitions, segments without a map), and the two committed pages.  Each
of cv2's None cases raises "Unable to read image", and so does every
seeded byte mutation of a few bases, and every cut of a few files, that
cv2 reads as None; the other mutations read to cv2's digest.  Where this machine has cv2, the JSON is held to
cv2's own reads (a stale fixture shows) and the alpha planes to
``cv2.imread(path, -1)``'s.

Skipped only where there is no host C++ compiler.
"""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest

from pero_ocr_tpu_torch.utils import webp
from pero_ocr_tpu_torch.utils.image_io import decode_webp as webp_decode
from pero_ocr_tpu_torch.utils.image_io import imread

from tests import webp_files as wf

try:
    import cv2
except ImportError:  # the card's machine
    cv2 = None

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = os.path.join(DATA, "webp")
try:
    with open(os.path.join(FIXTURES, "fixtures.json"), encoding="utf-8") as _f:
        SPEC = json.load(_f)
except FileNotFoundError:  # make_fixtures.py's first run; test_fixture_count fails
    SPEC = {"decode": {}, "none": [], "raises": [], "pages": {}, "mutations": {}, "cuts": {},
            "mutation_seed": 0, "cut_step": 1}


@pytest.fixture(autouse=True)
def _compiler():
    if shutil.which(os.environ.get("CXX") or "c++") is None:
        pytest.skip("no host C++ compiler")


def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(img.tobytes()).hexdigest(), "shape": list(img.shape)}


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def mutations(name: str):
    """[(the bytes, cv2's digest or None)] of ``name``'s seeded mutations."""
    rng = wf.mutation_rng(SPEC["mutation_seed"], name)
    data = _fixture(name)
    return [(wf.mutate(data, rng), want) for want in SPEC["mutations"][name]]


def cuts(name: str):
    """[(the bytes, cv2's digest or None)] of ``name`` cut at every
    ``cut_step``-th length, its RIFF size fixed."""
    data = _fixture(name)
    return [(wf.cut(data, length), want)
            for length, want in zip(range(12, len(data), SPEC["cut_step"]), SPEC["cuts"][name])]


def port_read(data: bytes):
    """The port's read as the JSON records cv2's: a digest, None or
    "raises"."""
    try:
        return digest(webp_decode(data))
    except ValueError as e:
        return (None if "Unable to read image" in str(e) else "raises" if "OpenCV 5 raises" in str(e)
                else str(e))


def read_bytes(tmp_path, data: bytes, name: str = "page.webp"):
    path = tmp_path / name
    path.write_bytes(data)
    return imread(str(path))


def test_fixture_count():
    assert len(SPEC["decode"]) >= 120 and len(SPEC["none"]) >= 15 and len(SPEC["raises"]) >= 1
    assert len(SPEC["pages"]) == 2 and sum(map(len, SPEC["mutations"].values())) >= 300
    assert sum(map(len, SPEC["cuts"].values())) >= 400


@pytest.mark.parametrize("name", sorted(SPEC["decode"]))
def test_fixture_reads_to_cv2_digest(name):
    img = imread(os.path.join(FIXTURES, name))
    assert img.dtype == np.uint8
    assert digest(img) == SPEC["decode"][name]


@pytest.mark.parametrize("name", sorted(SPEC["none"]))
def test_cv2_none_case_is_unreadable(name):
    with pytest.raises(ValueError, match="Unable to read image"):
        imread(os.path.join(FIXTURES, name))


@pytest.mark.parametrize("name", sorted(SPEC["raises"]))
def test_cv2_raise_case_raises(name):
    """A canvas past OpenCV's image size limits: cv2.imread raises (its
    size check), and so does the port, before decoding anything."""
    with pytest.raises(ValueError, match="OpenCV 5 raises an error"):
        imread(os.path.join(FIXTURES, name))


@pytest.mark.parametrize("page", sorted(SPEC["pages"]))
def test_committed_page_reads_to_cv2_digest(page):
    assert digest(imread(os.path.join(DATA, page))) == SPEC["pages"][page]


@pytest.mark.parametrize("name", sorted(SPEC["mutations"]))
def test_mutations_read_as_cv2_reads_them(name):
    """Each seeded mutation reads to cv2's digest or raises "Unable to
    read image" exactly where cv2 returns None (no partial image), and
    raises where cv2 raises (a canvas past its size limits)."""
    assert [k for k, (data, want) in enumerate(mutations(name)) if port_read(data) != want] == []


@pytest.mark.parametrize("name", sorted(SPEC["cuts"]))
def test_cut_files_read_as_cv2_reads_them(name):
    """Each file cut short (its RIFF size made to fit) reads as cv2 reads
    it: "Unable to read image", never a partial image."""
    assert [k for k, (data, want) in enumerate(cuts(name)) if port_read(data) != want] == []


def test_fixtures_cover_every_feature():
    """The decoder's feature bits met over the still fixtures: the four
    VP8L transforms, pixel bundling at 2, 4 and 8 pixels a byte, the
    colour cache, meta prefix codes, LZ77 and simple codes; ALPH raw and
    lossless with each filter and pre-processing; the simple, normal and
    no loop filter, 2, 4 and 8 partitions, segment maps and segments
    without a map, skip probabilities, deltas, sharpness and both intra
    mode kinds."""
    seen = 0
    for name in SPEC["decode"]:
        data = _fixture(name)
        if not webp.parse_headers(data[:webp.HEADER_SIZE], False, False)[1].has_animation:
            seen |= webp.decode_still(data, name).features
    assert [name for name, bit in webp.FEATURES.items() if not seen & bit] == []
    names = set(SPEC["decode"])
    assert {f"p_exif_o{o}_37x29.webp" for o in range(1, 9)} <= names
    assert any(n.startswith("r_anim_offset") for n in names)
    assert any(n.startswith("n_") and "cut" in n for n in SPEC["none"])


@pytest.mark.skipif(cv2 is None, reason="no cv2 on this machine")
def test_fixtures_json_is_cv2s(tmp_path):
    """The JSON holds what this machine's cv2 reads (a stale fixture or
    another OpenCV shows here), mutations and cuts included."""
    for name, want in SPEC["decode"].items():
        assert digest(cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_COLOR)) == want, name
    for name in SPEC["none"]:
        assert cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_COLOR) is None, name
    for name in SPEC["raises"]:
        with pytest.raises(cv2.error):
            cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_COLOR)
    for page, want in SPEC["pages"].items():
        assert digest(cv2.imread(os.path.join(DATA, page), cv2.IMREAD_COLOR)) == want
    path = str(tmp_path / "m.webp")
    cases = [(n, *case) for n in SPEC["mutations"] for case in mutations(n)]
    cases += [(n, *case) for n in SPEC["cuts"] for case in cuts(n)]
    for name, data, want in cases:
        with open(path, "wb") as f:
            f.write(data)
        try:
            img = cv2.imread(path, cv2.IMREAD_COLOR)
            got = None if img is None else digest(img)
        except cv2.error:
            got = "raises"
        assert got == want, name


@pytest.mark.skipif(cv2 is None, reason="no cv2 on this machine")
def test_alpha_planes_are_cv2s():
    """The alpha the port decodes (and drops) is cv2.imread(path, -1)'s:
    ALPH raw and lossless, each filter, VP8L alpha."""
    checked = 0
    for name in sorted(SPEC["decode"]):
        data = _fixture(name)
        headers = webp.parse_headers(data, True, True)[1]
        if headers is None or headers.has_animation:
            continue
        alpha = webp.decode_still(data, name, want_alpha=True).alpha
        want = cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_UNCHANGED)
        if alpha is None or want.ndim != 3 or want.shape[2] != 4:
            continue
        if name.startswith("p_exif") or name.startswith("r_exif"):
            continue  # IMREAD_UNCHANGED turns the page; the plane is compared unturned above
        np.testing.assert_array_equal(alpha, want[:, :, 3], err_msg=name)
        checked += 1
    assert checked >= 15


@pytest.mark.skipif(cv2 is None, reason="no cv2 on this machine")
@pytest.mark.parametrize("changes", [
    {}, {"simple": 1}, {"sharpness": 4}, {"partitions": 3}, {"level": 0},
    {"use_lf_delta": 1, "ref_lf_delta0": -5, "mode_lf_delta0": 9},
    {"segments_without_map": ([30, 0, 0, 0], [10, 0, 0, 0], True)},
], ids=["unchanged", "simple", "sharpness", "partitions8", "level0", "deltas", "segments"])
def test_vp8_rewriter_writes_what_cv2_reads(tmp_path, changes):
    """The rewriter's own check: cv2 reads each rewritten file, and with
    no change (or only the partitions changed) to the original pixels;
    the port reads it to cv2's pixels."""
    base = _fixture("v_base_53x131.webp")
    data = wf.rewrite(base, **changes)
    path = tmp_path / "r.webp"
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert want is not None
    if set(changes) <= {"partitions"}:
        np.testing.assert_array_equal(want, cv2.imread(os.path.join(FIXTURES, "v_base_53x131.webp"), 1))
    np.testing.assert_array_equal(imread(str(path)), want)


def test_vp8_rewriter_round_trip():
    """parse_vp8 of write_vp8 gives the frame back (no cv2 needed)."""
    frame = wf.parse_vp8(wf.payload(_fixture("v_partitions4_53x131.webp"), b"VP8 "))
    again = wf.parse_vp8(wf.write_vp8(frame))
    assert again.header == frame.header and again.mbs == frame.mbs and again.blocks == frame.blocks


def test_first_32_bytes_decide_what_is_webp(tmp_path):
    """OpenCV's signature test reads 32 bytes: a shorter RIFF/WEBP file
    is not read, and neither is one whose first chunk libwebp rejects."""
    lossless = _fixture("c_lossless_1x1.webp")
    assert len(lossless) >= 32
    assert read_bytes(tmp_path, lossless).shape == (1, 1, 3)
    with pytest.raises(ValueError, match="Unable to read image.*32"):
        read_bytes(tmp_path, lossless[:31])
    with pytest.raises(ValueError, match="Unable to read image.*first 32 bytes"):
        read_bytes(tmp_path, lossless[:12] + b"ABCD" + lossless[16:])


def test_calls_are_counted():
    before = dict(webp.calls)
    imread(os.path.join(FIXTURES, "c_lossy_q75_37x29.webp"))
    imread(os.path.join(FIXTURES, "c_lossless_37x29.webp"))
    assert webp.calls["webp_decode_vp8"] == before.get("webp_decode_vp8", 0) + 1
    assert webp.calls["webp_decode_vp8l"] == before.get("webp_decode_vp8l", 0) + 1


def test_not_a_webp_file():
    with pytest.raises(ValueError, match="not a WebP file"):
        webp.decode_webp(b"\xff\xd8\xff\xe0", "x.jpg")
