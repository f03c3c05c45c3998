"""The port's JPEG 2000 reader (``pero_ocr_tpu_torch/csrc/jpeg2000.cpp``,
bound in ``pero_ocr_tpu_torch/utils/jpeg2000.py``) against OpenCV 5's
OpenJPEG 2.5.3, bit for bit, on the CPU.

Every file of ``tests/data/jpeg2000/fixtures.json`` reads through
``image_io.imread`` to the digest of ``cv2.imread(path, 1)``: Pillow's
files (5/3 and 9/7, gray, RGB, RGBA, LA and 16-bit, layers, 1 to 6
resolutions, code-blocks of 4x4 to 64x64, precincts, the five
progression orders with 100-px tiles, PLT, COM, raw codestreams and
``mct=0``), libopenjp2's (the six code-block styles, SOP/EPH,
tile-parts, POC, RGN), JP2 boxes built here around their codestreams
(``colr`` sYCC, ICC and absent; ``pclr``/``cmap`` palettes; ``cdef``
orders; gray over three components) and codestreams rewritten here
(tile-parts interleaved across tiles, ``Psot = 0``, TLM, PLM, CRG,
COC and QCC, 9- and 12-bit samples; a one-code-block codestream written
here); and the committed 2560x1792 page.  Each of cv2's None cases
raises "Unable to read image", among them segment lengths past the
tile's end (2^31 and 2^32 - 1 in 32 bits) and boxes too short for
their fields.  Where this machine has cv2, the JSON is held to cv2's
own reads (a stale fixture shows).

The box writer and the codestream rewriters are here;
``tests/data/jpeg2000/make_fixtures.py`` uses them to write the files.
Skipped only where there is no host C++ compiler.
"""

import hashlib
import json
import os
import shutil
import struct

import numpy as np
import pytest

from pero_ocr_tpu_torch import IMAGES
from pero_ocr_tpu_torch.utils import jpeg2000
from pero_ocr_tpu_torch.utils.image_io import imread

try:
    import cv2
except ImportError:  # the card's machine
    cv2 = None

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = os.path.join(DATA, "jpeg2000")
try:
    with open(os.path.join(FIXTURES, "fixtures.json"), encoding="utf-8") as _f:
        SPEC = json.load(_f)
except FileNotFoundError:  # make_fixtures.py's first run; test_fixture_count fails
    SPEC = {"decode": {}, "none": [], "pages": {}}


@pytest.fixture(autouse=True)
def _compiler():
    if shutil.which(os.environ.get("CXX") or "c++") is None:
        pytest.skip("no host C++ compiler")


# ----------------------------------------------------------------------
# The JP2 box writer
def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


SIGNATURE = box(b"jP  ", b"\r\n\x87\n")
FTYP = box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")


def ihdr(height: int, width: int, ncomp: int, bpc: int) -> bytes:
    return box(b"ihdr", struct.pack(">IIHBBBB", height, width, ncomp, bpc, 7, 0, 0))


def colr(enumcs: int) -> bytes:
    return box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))


def colr_icc(profile: bytes) -> bytes:
    """A restricted ICC colour box (METH 2)."""
    return box(b"colr", struct.pack(">BBB", 2, 0, 0) + profile)


def pclr(entries: np.ndarray, bits: int) -> bytes:
    """A palette of ``entries`` (n, channels) unsigned values of ``bits``."""
    n, channels = entries.shape
    nbytes = (bits + 7) // 8
    body = struct.pack(">HB", n, channels) + bytes([bits - 1] * channels)
    body += b"".join(int(v).to_bytes(nbytes, "big") for v in entries.reshape(-1))
    return box(b"pclr", body)


def cmap(items) -> bytes:
    """(component, mapping type, palette column) for each channel."""
    return box(b"cmap", b"".join(struct.pack(">HBB", *item) for item in items))


def cdef(items) -> bytes:
    """(channel, type, association) for each channel."""
    return box(b"cdef", struct.pack(">H", len(items))
               + b"".join(struct.pack(">HHH", *item) for item in items))


def jp2(codestream: bytes, height: int, width: int, ncomp: int, inner=(), bpc: int = 7) -> bytes:
    """A JP2 file: signature, ftyp, a jp2h of ihdr and ``inner`` boxes,
    and the codestream."""
    return (SIGNATURE + FTYP + box(b"jp2h", ihdr(height, width, ncomp, bpc) + b"".join(inner))
            + box(b"jp2c", codestream))


def codestream_of(data: bytes) -> bytes:
    """The jp2c payload of a JP2 file (or the codestream itself)."""
    if data[:4] == b"\xff\x4f\xff\x51":
        return data
    pos = 0
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"jp2c":
            return data[pos + 8:pos + length if length else len(data)]
        pos += length
    raise ValueError("no jp2c box")


# ----------------------------------------------------------------------
# Codestream rewriters
def split(codestream: bytes):
    """(main header up to the first SOT, [(tile index, tile-part bytes)],
    what follows the last tile-part)."""
    pos = codestream.index(b"\xff\x90")
    main, parts = codestream[:pos], []
    while codestream[pos:pos + 2] == b"\xff\x90":
        isot, psot = struct.unpack(">HI", codestream[pos + 4:pos + 10])
        parts.append((isot, codestream[pos:pos + psot]))
        pos += psot
    return main, parts, codestream[pos:]


def interleave_tile_parts(codestream: bytes) -> bytes:
    """Tile-parts taken round-robin across tiles (T0P0, T1P0, ..., T0P1,
    ...), each tile's own order kept."""
    main, parts, tail = split(codestream)
    queues = {}
    for isot, part in parts:
        queues.setdefault(isot, []).append(part)
    out = []
    while any(queues.values()):
        for isot in sorted(queues):
            if queues[isot]:
                out.append(queues[isot].pop(0))
    return main + b"".join(out) + tail


def last_psot_zero(codestream: bytes) -> bytes:
    """The last tile-part's Psot set to 0 (it runs to EOC)."""
    main, parts, tail = split(codestream)
    last = parts[-1][1]
    parts[-1] = (parts[-1][0], last[:6] + b"\0\0\0\0" + last[10:])
    return main + b"".join(p for _, p in parts) + tail


def without_tile(codestream: bytes, tile: int) -> bytes:
    main, parts, tail = split(codestream)
    return main + b"".join(p for i, p in parts if i != tile) + tail


def with_main_segment(codestream: bytes, marker: int, body: bytes) -> bytes:
    """A marker segment added at the end of the main header."""
    main, parts, tail = split(codestream)
    segment = struct.pack(">HH", marker, len(body) + 2) + body
    return main + segment + b"".join(p for _, p in parts) + tail


def with_tlm(codestream: bytes) -> bytes:
    """A TLM segment (16-bit tile indexes, 32-bit lengths) listing every
    tile-part."""
    _, parts, _ = split(codestream)
    body = struct.pack(">BB", 0, 0x60) + b"".join(struct.pack(">HI", i, len(p)) for i, p in parts)
    return with_main_segment(codestream, 0xFF55, body)


def with_crg(codestream: bytes, ncomp: int) -> bytes:
    return with_main_segment(codestream, 0xFF63, struct.pack(">HH", 0, 0) * ncomp)


def with_coc_qcc(codestream: bytes, component: int) -> bytes:
    """COC and QCC segments for one component that repeat the main
    header's COD and QCD (the coding does not change)."""
    main, _, _ = split(codestream)
    cod = main.index(b"\xff\x52")
    lcod = struct.unpack(">H", main[cod + 2:cod + 4])[0]
    scod, spcod = main[cod + 4], main[cod + 9:cod + 2 + lcod]
    qcd = main.index(b"\xff\x5c")
    lqcd = struct.unpack(">H", main[qcd + 2:qcd + 4])[0]
    out = with_main_segment(codestream, 0xFF53, bytes([component, scod & 1]) + spcod)
    return with_main_segment(out, 0xFF5D, bytes([component]) + main[qcd + 4:qcd + 2 + lqcd])


def with_plm(codestream: bytes) -> bytes:
    """A PLM segment that lists no packet lengths."""
    return with_main_segment(codestream, 0xFF57, b"\0")


def with_ppt(codestream: bytes) -> bytes:
    """An (empty) PPT segment in the first tile-part header."""
    main, parts, tail = split(codestream)
    first = parts[0][1]
    segment = struct.pack(">HHB", 0xFF61, 3, 0)
    psot = struct.unpack(">I", first[6:10])[0] + len(segment)
    first = first[:6] + struct.pack(">I", psot) + first[10:12] + segment + first[12:]
    return main + first + b"".join(p for _, p in parts[1:]) + tail


def with_precision(codestream: bytes, component: int, bits: int, signed: bool = False) -> bytes:
    """SIZ's Ssiz of one component rewritten (the DC shift and the clamp
    change, the coded data does not)."""
    at = 42 + 3 * component
    return codestream[:at] + bytes([(bits - 1) | (0x80 if signed else 0)]) + codestream[at + 1:]


def with_subsampling(codestream: bytes, component: int, dx: int) -> bytes:
    at = 42 + 3 * component + 1
    return codestream[:at] + bytes([dx]) + codestream[at + 1:]


def with_rsiz(codestream: bytes, rsiz: int) -> bytes:
    return codestream[:6] + struct.pack(">H", rsiz) + codestream[8:]


def packet_header(bits) -> bytes:
    """Packet-header bits as bytes: 7 bits in a byte after 0xFF, the last
    byte padded with zeros (and a zero byte after a last 0xFF)."""
    out, cur, n, cap = bytearray(), 0, 0, 8
    for b in bits:
        cur, n = (cur << 1) | b, n + 1
        if n == cap:
            out.append(cur)
            cur, n, cap = 0, 0, 7 if cur == 0xFF else 8
    if n:
        out.append(cur << (cap - n))
    if out and out[-1] == 0xFF:
        out.append(0)
    return bytes(out)


def one_block_codestream(length: int, length_bits: int, size: int = 8) -> bytes:
    """A gray 8-bit ``size`` x ``size`` codestream of one tile, no
    decomposition, one layer and one code-block, written here: its one
    packet includes the block with one coding pass whose segment length
    is ``length`` in ``length_bits`` bits (3 to 32), and the tile holds
    no code-block data after the header."""
    siz = struct.pack(">HIIIIIIIIHBBB", 0, size, size, 0, 0, size, size, 0, 0, 1, 7, 1, 1)
    cod = struct.pack(">BBHBBBBBB", 0, 0, 1, 0, 0, 4, 4, 0, 1)  # LRCP, 1 layer; 0 levels, 5/3
    qcd = struct.pack(">BB", 2 << 5, 8 << 3)  # no quantisation, 2 guard bits, exponent 8
    header = packet_header(
        [1, 1, 1, 0]  # present; included in layer 0; no zero bit-plane; one pass
        + [1] * (length_bits - 3) + [0]  # Lblock grows from 3 to length_bits
        + [(length >> i) & 1 for i in range(length_bits - 1, -1, -1)])
    tile = struct.pack(">HHHIBB", 0xFF90, 10, 0, 14 + len(header), 0, 1) + b"\xff\x93" + header
    return (b"\xff\x4f" + struct.pack(">HH", 0xFF51, 2 + len(siz)) + siz
            + struct.pack(">HH", 0xFF52, 2 + len(cod)) + cod
            + struct.pack(">HH", 0xFF5C, 2 + len(qcd)) + qcd + tile + b"\xff\xd9")


# ----------------------------------------------------------------------
def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(img.tobytes()).hexdigest(), "shape": list(img.shape)}


def test_fixture_count():
    assert len(SPEC["decode"]) >= 40 and len(SPEC["none"]) >= 10 and len(SPEC["pages"]) == 1


@pytest.mark.parametrize("name", sorted(SPEC["decode"]))
def test_fixture_reads_to_cv2_digest(name):
    img = imread(os.path.join(FIXTURES, name))
    assert img.dtype == np.uint8
    assert digest(img) == SPEC["decode"][name]


@pytest.mark.parametrize("name", sorted(SPEC["none"]))
def test_cv2_none_case_is_unreadable(name):
    with pytest.raises(ValueError, match="Unable to read image"):
        imread(os.path.join(FIXTURES, name))


def test_committed_page_reads_to_cv2_digest():
    (page, want), = SPEC["pages"].items()
    assert digest(imread(os.path.join(DATA, page))) == want


def test_fixtures_cover_every_feature():
    """The decoder's feature bits met over the fixtures: every code-block
    style, SOP, EPH, POC, RGN, tile-parts, TLM, PLM, PLT, COC, QCC,
    precincts, layers, the 9/7 wavelet, the component transform, tiles,
    Psot = 0, COM and CRG."""
    seen = 0
    for name in SPEC["decode"]:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            seen |= jpeg2000.decode_codestream(codestream_of(f.read()), name)[2]
    assert [name for name, bit in jpeg2000.FEATURES.items() if not seen & bit] == []


@pytest.mark.skipif(cv2 is None, reason="no cv2 on this machine")
def test_fixtures_json_is_cv2s():
    """The JSON holds what this machine's cv2 reads (a stale fixture or
    another OpenCV shows here)."""
    for name, want in SPEC["decode"].items():
        assert digest(cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_COLOR)) == want, name
    for name in SPEC["none"]:
        assert cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_COLOR) is None, name
    for page, want in SPEC["pages"].items():
        assert digest(cv2.imread(os.path.join(DATA, page), cv2.IMREAD_COLOR)) == want


@pytest.mark.skipif(cv2 is None, reason="no cv2 on this machine")
def test_yuv_to_bgr_is_cvtcolor():
    """OpenCV's sYCC turn, on every (Y, U, V) with U and V in steps of 3."""
    y, u, v = np.meshgrid(np.arange(256), np.arange(0, 256, 3), np.arange(0, 256, 3),
                          indexing="ij")
    yuv = np.stack([y, u, v], -1).reshape(256, -1, 3).astype(np.uint8)
    want = cv2.cvtColor(yuv, cv2.COLOR_YUV2BGR)
    np.testing.assert_array_equal(jpeg2000.yuv_to_bgr(yuv[..., 0], yuv[..., 1], yuv[..., 2]), want)


def _fixture(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("rewrite, what", [
    (with_ppt, "packed packet headers"),
    (lambda cs: with_rsiz(cs, 0x4000), "HTJ2K"),
])
def test_unread_features_are_refused_by_name(tmp_path, rewrite, what):
    data = rewrite(codestream_of(_fixture("p_rgb_53_37x29.j2k")))
    path = tmp_path / "page.j2k"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=what) as e:
        imread(str(path))
    assert IMAGES in str(e.value)


@pytest.mark.parametrize("length, bits", [(2 ** 31, 32), (2 ** 32 - 1, 32), (2 ** 31 - 1, 31)])
def test_segment_length_past_the_tile_is_corrupt(length, bits):
    """A segment length that does not fit a signed 32-bit int is read
    whole and refused as OpenJPEG refuses it, not wrapped."""
    with pytest.raises(ValueError, match="Unable to read image.*runs past its tile"):
        jpeg2000.decode_codestream(one_block_codestream(length, bits), "cs.j2k")


def test_calls_are_counted():
    before = jpeg2000.calls["j2k_decode"]
    imread(os.path.join(FIXTURES, "p_rgb_53_37x29.j2k"))
    assert jpeg2000.calls["j2k_decode"] == before + 1


def test_not_a_jpeg2000_file():
    with pytest.raises(ValueError, match="not a JPEG 2000 file"):
        jpeg2000.decode_jpeg2000(b"\xff\xd8\xff\xe0", "x.jpg")
