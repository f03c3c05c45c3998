"""The port's JPEG codec (``pero_ocr_tpu_torch/csrc/jpeg.cpp``, bound in
``pero_ocr_tpu_torch/utils/jpeg.py``) against OpenCV 5's libjpeg-turbo,
bit for bit, on the CPU.

Decoder: ``imread`` (and ``decode_jpeg``) of files that cv2 wrote at
every sampling it writes (gray, 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1),
sizes 1-40 and a 2560x1792 page, qualities 1-100, restart intervals,
baseline and progressive (cv2's scan script: spectral selection,
successive approximation, EOB runs); progressive files cut short of
some scans, which libjpeg's block smoothing fills in; and files rebuilt
here from cv2's coefficients (a pure-Python entropy codec,
:func:`read_coefficients`, :func:`assemble` for baseline files and
:func:`assemble_progressive` for progressive ones): one scan a
component, other component ids, JFIF and Adobe markers for the
colour-space guess, and four components (CMYK, YCCK, with and without
an Adobe marker).  Each equals ``cv2.imread(path, 1)``.

Encoder: ``encode_jpeg`` equals ``cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, q])`` byte for byte on random, flat and
gray-repeated (h, w, 3) images and on 2-D gray, sizes 1-40.

What the codec does not read (lossless, hierarchical and arithmetic
coding, 12-bit samples, truncated or corrupt entropy data) raises
``ValueError`` naming the file, the feature and the ROADMAP item.  The
committed fixtures of ``tests/data/jpeg`` (the card's check,
``chip_smoke.check_jpeg_fixtures``) reproduce their digests.

Skipped only where there is no host C++ compiler.
"""

import hashlib
import json
import os
import shutil
import struct

import cv2
import numpy as np
import pytest

from pero_ocr_tpu_torch import IMAGES
from pero_ocr_tpu_torch.utils import jpeg
from pero_ocr_tpu_torch.utils.image_io import encode_jpeg, imread, imwrite_jpeg
from tests.jpeg_files import (
    JFIF, adobe, arithmetic_file, huffman_file, lossless_file, progressive_script,
    quant_bodies, read_coefficients, huffman_tables as _huffman, segment as _segment,
)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
SAMPLING = {  # cv2's IMWRITE_JPEG_SAMPLING_FACTOR values
    "444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111, "411": 0x411111,
}
QUALITIES = (1, 50, 70, 90, 95, 98, 100)


@pytest.fixture(autouse=True)
def _compiler():
    if shutil.which(os.environ.get("CXX") or "c++") is None:
        pytest.skip("no host C++ compiler")


def sizes():
    """(h, w) pairs: every width and every height 1-40, each beside
    another size of the range."""
    return sorted({(h, (h * 7) % 40 + 1) for h in range(1, 41)}
                  | {((w * 3) % 40 + 1, w) for w in range(1, 41)})


def sample_image(h, w, c=3, seed=0):
    """Gradients, noise and a flat block: every coefficient band."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 9 + y * 5)[:, :, None] + np.arange(c) * 60
    img = (base + rng.integers(0, 60, (h, w, c))) % 256
    img[h // 3: h // 2 + 1, w // 4: w // 2 + 1] = 200
    return img.astype(np.uint8)


def cv2_jpeg(img, quality=95, sampling=None, restart=None, progressive=False) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if restart is not None:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def assert_reads_like_cv2(tmp_path, data: bytes, name="page.jpg"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert want is not None
    got = imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


# ----------------------------------------------------------------------
# A baseline entropy codec in Python, for files cv2 does not write (the
# reader of cv2's coefficients is tests/jpeg_files.py's).
def _encode_scan(blocks, dc, ac) -> bytes:
    """Blocks in order -> entropy-coded bytes, stuffed and padded."""
    out, pred = [], 0

    def put(length, code):
        out.append(format(code, f"0{length}b") if length else "")

    def coded(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    for blk in blocks:
        s, bits = coded(int(blk[0]) - pred)
        pred = int(blk[0])
        put(*dc[s])
        put(s, bits)
        run = 0
        for k in range(1, 64):
            if blk[k] == 0:
                run += 1
                continue
            while run > 15:
                put(*ac[0xF0])
                run -= 16
            s, bits = coded(int(blk[k]))
            put(*ac[(run << 4) | s])
            put(s, bits)
            run = 0
        if run:
            put(*ac[0])
    stream = "".join(out)
    stream += "1" * (-len(stream) % 8)
    raw = bytes(int(stream[i:i + 8], 2) for i in range(0, len(stream), 8))
    return raw.replace(b"\xff", b"\xff\x00")


def assemble(frame, height, width, coefs, tables, quant_bodies, *, apps=(), ids=None):
    """A baseline file of ``coefs``: the APPn segments ``apps``
    ([(marker, body)]), the DQT bodies, the frame with component ids
    ``ids`` (default the frame's), every DHT, then one scan a component
    (each over the component's own blocks)."""
    ids = ids or [c[0] for c in frame]
    out = b"\xff\xd8" + b"".join(_segment(m, b) for m, b in apps)
    out += b"".join(_segment(0xDB, b) for b in quant_bodies)
    sof = struct.pack(">BHHB", 8, height, width, len(frame)) + b"".join(
        bytes([ids[i], (h << 4) | v, tq]) for i, (_, h, v, tq) in enumerate(frame))
    out += _segment(0xC0, sof)
    out += b"".join(_segment(0xC4, t[2]) for t in tables.values())
    maxh, maxv = max(c[1] for c in frame), max(c[2] for c in frame)
    table_ids = [(0, 0) if i == 0 else (1, 1) for i in range(len(frame))]
    code = {key: t[1] for key, t in tables.items()}
    for i, (_, h, v, _) in enumerate(frame):
        bw = -(-(-(-width * h // maxh)) // 8)
        bh = -(-(-(-height * v // maxv)) // 8)
        blocks = coefs[i][:bh, :bw].reshape(-1, 64)
        td, ta = table_ids[i]
        out += _segment(0xDA, bytes([1, ids[i], (td << 4) | ta, 0, 63, 0]))
        out += _encode_scan(blocks, code[(0, td)], code[(1, ta)])
    return out + b"\xff\xd9"


def rebuilt(img, sampling="420", quality=90, **kwargs) -> bytes:
    """cv2's file of ``img``, its coefficients rebuilt by :func:`assemble`."""
    data = cv2_jpeg(img, quality, sampling)
    frame, h, w, coefs, segs, tables = read_coefficients(data)
    quant = [body for marker, body in segs if marker == 0xDB]
    return assemble(frame, h, w, coefs, tables, quant, **kwargs)


def split_scans(data: bytes):
    """A cv2 progressive file -> (the bytes to the end of its frame
    header, [each scan: the table segments before its SOS, the SOS and
    its entropy-coded data], the rest to EOI)."""
    pos, segs = 2, []
    while data[pos + 1] != 0xD9:
        marker = data[pos + 1]
        end = pos + 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:  # the data runs to the next marker that is no RSTn
            while data[end] != 0xFF or data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
                end += 1 if data[end] != 0xFF else 2
        segs.append((pos, end, marker))
        pos = end
    sof = next(i for i, (_, _, m) in enumerate(segs) if m == 0xC2)
    scans, pending = [], b""
    for start, end, marker in segs[sof + 1:]:
        pending += data[start:end]
        if marker == 0xDA:
            scans.append(pending)
            pending = b""
    return data[:segs[sof][1]], scans, pending + data[pos:]


def cut_scans(data: bytes, keep) -> bytes:
    """A progressive file with only the scans numbered in ``keep``."""
    head, scans, tail = split_scans(data)
    return head + b"".join(scans[i] for i in keep) + tail


# Huffman tables for assemble_progressive: every DC category (0-11) in 4
# bits, and every AC symbol a scan may need (run/size, ZRL, EOB0-EOB14)
# in 8 bits.
_PROG_DC = bytes([0x00]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12))
_AC_SYMBOLS = bytes([0x00, 0xF0] + [r << 4 for r in range(1, 15)]
                    + [(r << 4) | s for r in range(16) for s in range(1, 11)])
_PROG_AC = bytes([0x10]) + bytes([0] * 7 + [len(_AC_SYMBOLS)] + [0] * 8) + _AC_SYMBOLS


def _bits(v):
    """JPEG's magnitude category and value bits of a coefficient."""
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def assemble_progressive(frame, height, width, coefs, quant_bodies, *, apps=(), ids=None):
    """A progressive file (SOF2) of ``coefs``: the DC in an interleaved
    first scan at Al 1 and an interleaved refining scan, then for each
    component its AC in two spectral bands (1-5, 6-63) at Al 0 with EOB
    runs.  Frame, tables and ``apps`` as :func:`assemble`."""
    ids = ids or [c[0] for c in frame]
    out = b"\xff\xd8" + b"".join(_segment(m, b) for m, b in apps)
    out += b"".join(_segment(0xDB, b) for b in quant_bodies)
    out += _segment(0xC2, struct.pack(">BHHB", 8, height, width, len(frame)) + b"".join(
        bytes([ids[i], (h << 4) | v, tq]) for i, (_, h, v, tq) in enumerate(frame)))
    tables = _huffman(_PROG_DC + _PROG_AC)
    dc, ac = tables[(0, 0)][1], tables[(1, 0)][1]
    out += _segment(0xC4, _PROG_DC + _PROG_AC)
    maxh, maxv = max(c[1] for c in frame), max(c[2] for c in frame)
    mcux, mcuy = -(-width // (8 * maxh)), -(-height // (8 * maxv))
    n = len(frame)

    def sos(comps, ss, se, ah, al):
        return _segment(0xDA, bytes([len(comps)]) + b"".join(bytes([ids[i], 0]) for i in comps)
                        + bytes([ss, se, (ah << 4) | al]))

    def pack(bits: str) -> bytes:
        bits += "1" * (-len(bits) % 8)
        return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8)).replace(
            b"\xff", b"\xff\x00")

    interleaved = [(i, my * v + by, mx * h + bx) for my in range(mcuy) for mx in range(mcux)
                   for i, (_, h, v, _) in enumerate(frame) for by in range(v) for bx in range(h)]
    first, pred = [], [0] * n
    for i, r, c in interleaved:  # DC first, Al 1: the arithmetic shift
        s, bits = _bits((int(coefs[i][r, c, 0]) >> 1) - pred[i])
        pred[i] = int(coefs[i][r, c, 0]) >> 1
        first.append(format(dc[s][1], f"0{dc[s][0]}b") + (format(bits, f"0{s}b") if s else ""))
    out += sos(range(n), 0, 0, 0, 1) + pack("".join(first))
    out += sos(range(n), 0, 0, 1, 0) + pack("".join(
        str(int(coefs[i][r, c, 0]) & 1) for i, r, c in interleaved))
    for i, (_, h, v, _) in enumerate(frame):
        bw = -(-(-(-width * h // maxh)) // 8)
        bh = -(-(-(-height * v // maxv)) // 8)
        for ss, se in ((1, 5), (6, 63)):
            stream, eobrun = [], 0

            def flush():
                nonlocal eobrun
                if eobrun:
                    r = eobrun.bit_length() - 1
                    stream.append(format(ac[r << 4][1], f"0{ac[r << 4][0]}b")
                                  + (format(eobrun, "b")[-r:] if r else ""))
                    eobrun = 0

            for blk in coefs[i][:bh, :bw].reshape(-1, 64):
                band = [int(x) for x in blk[ss:se + 1]]
                if not any(band):
                    eobrun += 1
                    if eobrun == 0x7FFF:
                        flush()
                    continue
                flush()
                run = 0
                for x in band:
                    if x == 0:
                        run += 1
                        continue
                    while run > 15:
                        stream.append(format(ac[0xF0][1], f"0{ac[0xF0][0]}b"))
                        run -= 16
                    s, bits = _bits(x)
                    sym = (run << 4) | s
                    stream.append(format(ac[sym][1], f"0{ac[sym][0]}b") + format(bits, f"0{s}b"))
                    run = 0
                if run:
                    eobrun = 1
            flush()
            out += sos([i], ss, se, 0, 0) + pack("".join(stream))
    return out + b"\xff\xd9"


def four_components(h, w, sampling="444", seed=1):
    """(frame, height, width, coefficients, quantization bodies) of a
    four-component image: the three of cv2's file of one picture and the
    luma of another as the fourth, sampled like the first."""
    frame, height, width, coefs, segs, _ = read_coefficients(
        cv2_jpeg(sample_image(h, w, seed=seed), 90, sampling))
    _, _, _, other, _, _ = read_coefficients(
        cv2_jpeg(sample_image(h, w, seed=seed + 1), 80, sampling))
    frame = frame + [(4, frame[0][1], frame[0][2], 0)]
    quant = [body for marker, body in segs if marker == 0xDB]
    return frame, height, width, {**coefs, 3: other[0]}, quant


def four_component_file(h, w, sampling, apps, progressive=False, seed=1) -> bytes:
    frame, height, width, coefs, quant = four_components(h, w, sampling, seed)
    if progressive:
        return assemble_progressive(frame, height, width, coefs, quant, apps=apps)
    tables = read_coefficients(cv2_jpeg(sample_image(h, w, seed=seed), 90, sampling))[5]
    return assemble(frame, height, width, coefs, tables, quant, apps=apps)


# ----------------------------------------------------------------------
# Decoder
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("sampling", ["gray", *SAMPLING])
def test_decode_equals_cv2(tmp_path, sampling, quality):
    for h, w in sizes():
        img = sample_image(h, w, 1 if sampling == "gray" else 3, seed=h * 41 + w)
        data = cv2_jpeg(img[:, :, 0] if sampling == "gray" else img, quality,
                        None if sampling == "gray" else sampling)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        got = jpeg.decode_jpeg(data)
        assert got.shape == want.shape == (h, w, 3), (h, w)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")
    assert_reads_like_cv2(tmp_path, data)  # through imread and a file too


@pytest.mark.parametrize("restart", [1, 2, 3, 7])
@pytest.mark.parametrize("sampling", ["gray", "444", "420", "422"])
def test_decode_restart_intervals(tmp_path, sampling, restart):
    for h, w in [(8, 8), (17, 33), (40, 9), (64, 97)]:
        img = sample_image(h, w, seed=restart)
        data = cv2_jpeg(img[:, :, 0] if sampling == "gray" else img, 90,
                        None if sampling == "gray" else sampling, restart=restart)
        assert b"\xff\xdd" in data  # a DRI segment
        assert_reads_like_cv2(tmp_path, data)


@pytest.mark.parametrize("sampling", ["420", "gray"])
def test_decode_full_page(tmp_path, sampling):
    """A 2560x1792 scan-like page (smooth ink on paper, noise) at
    quality 90: equal to cv2."""
    rng = np.random.default_rng(5)
    page = rng.normal(235, 8, (1792, 2560)).clip(0, 255)
    for row in range(100, 1700, 40):
        page[row:row + 18, 200:2300:3] = rng.integers(20, 80)
    page = cv2.GaussianBlur(page.astype(np.uint8), (0, 0), 1.2)
    img = page if sampling == "gray" else np.dstack([page, page - 3, page - 6]).astype(np.uint8)
    assert_reads_like_cv2(tmp_path, cv2_jpeg(img, 90, None if sampling == "gray" else sampling))


@pytest.mark.parametrize("sampling", ["420", "444", "422", "440", "411"])
def test_decode_one_scan_a_component(tmp_path, sampling):
    """cv2's coefficients in three non-interleaved scans (each over its
    component's own blocks): equal to cv2 on that file, and to the
    one-scan file's pixels."""
    for h, w in [(5, 7), (16, 16), (23, 41), (40, 33)]:
        img = sample_image(h, w, seed=w)
        data = rebuilt(img, sampling, apps=[JFIF])
        got = assert_reads_like_cv2(tmp_path, data)
        one_scan = cv2.imdecode(np.frombuffer(cv2_jpeg(img, 90, sampling), np.uint8), 1)
        np.testing.assert_array_equal(got, one_scan)


@pytest.mark.parametrize("case", ["adobe_rgb", "adobe_ycc", "adobe_unknown", "rgb_ids",
                                  "ids_123", "other_ids", "jfif_and_adobe_rgb", "no_markers"])
def test_decode_colour_space_guess(tmp_path, case):
    """libjpeg's default_decompress_parms: JFIF means YCbCr; else Adobe's
    transform 0 means RGB and any other YCbCr; else component ids 'R',
    'G', 'B' mean RGB and anything else YCbCr."""
    apps, ids = {
        "adobe_rgb": ([adobe(0)], None), "adobe_ycc": ([adobe(1)], None),
        "adobe_unknown": ([adobe(2)], None), "rgb_ids": ([], [82, 71, 66]),
        "ids_123": ([], None), "other_ids": ([], [7, 8, 9]),
        "jfif_and_adobe_rgb": ([JFIF, adobe(0)], [82, 71, 66]), "no_markers": ([], [1, 2, 3]),
    }[case]
    img = sample_image(21, 30, seed=3)
    got = assert_reads_like_cv2(tmp_path, rebuilt(img, "444", apps=apps, ids=ids))
    ycc = cv2.imdecode(np.frombuffer(cv2_jpeg(img, 90, "444"), np.uint8), 1)
    rgb = case in ("adobe_rgb", "rgb_ids")
    assert np.array_equal(got, ycc) != rgb


def test_decode_skips_other_segments_and_fill_bytes(tmp_path):
    """COM and APPn segments, fill bytes before markers and bytes
    before a marker that are no marker (libjpeg skips them with a
    warning) leave the pixels."""
    img = sample_image(19, 27, seed=9)
    data = cv2_jpeg(img, 90, "420", restart=2)
    want = jpeg.decode_jpeg(data)
    extra = (_segment(0xFE, b"a comment") + _segment(0xE2, b"ICC_PROFILE\x00xx")
             + _segment(0xED, b"Photoshop"))
    padded = data[:2] + extra + data[2:].replace(b"\xff\xd0", b"\xff\xff\xff\xd0")
    padded = padded.replace(b"\xff\xd9", b"\xff\xff\xd9")
    got = assert_reads_like_cv2(tmp_path, padded)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [1, 50, 90, 100])
@pytest.mark.parametrize("sampling", ["gray", *SAMPLING])
def test_decode_progressive_equals_cv2(tmp_path, sampling, quality):
    """cv2's progressive files (10 scans for colour, 6 for gray) at
    every size 1-40, with and without a restart interval."""
    for h, w in sizes()[quality % 3::3]:
        img = sample_image(h, w, seed=h * 37 + w)
        for restart in (None, 3):
            data = cv2_jpeg(img[:, :, 0] if sampling == "gray" else img, quality,
                            None if sampling == "gray" else sampling, restart=restart,
                            progressive=True)
            want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
            got = jpeg.decode_jpeg(data)
            assert got.shape == want.shape == (h, w, 3), (h, w)
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} restart {restart}")
    assert b"\xff\xc2" in data and b"\xff\xdd" in data
    assert_reads_like_cv2(tmp_path, data)


@pytest.mark.parametrize("sampling", ["gray", *SAMPLING])
def test_decode_progressive_cut_short(tmp_path, sampling):
    """Progressive files with only the first scans, or without one of
    the scans that nothing after it refines: where the DC or the first
    nine AC coefficients are left short of full precision, libjpeg
    smooths each block from the 5x5 blocks' DC values around it (from
    the DC alone when no AC scan came).  Sizes where the last iMCU row
    has fewer block rows than a component's v, and blocks past the
    image, are among them."""
    for h, w in [(8, 8), (16, 16), (17, 3), (3, 29), (33, 45), (49, 23), (70, 90)]:
        img = sample_image(h, w, seed=h * 7 + w)
        for quality, restart in ((30, None), (90, 2)):
            data = cv2_jpeg(img[:, :, 0] if sampling == "gray" else img, quality,
                            None if sampling == "gray" else sampling, restart=restart,
                            progressive=True)
            n = len(split_scans(data)[1])
            # each prefix, and the last scan of each component left out
            keeps = [range(k) for k in range(1, n)]
            keeps += [[i for i in range(n) if i != j] for j in range(n - (1 if n == 6 else 3), n)]
            for keep in keeps:
                cut = cut_scans(data, keep)
                want = cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR)
                np.testing.assert_array_equal(jpeg.decode_jpeg(cut), want,
                                              err_msg=f"{h}x{w} q{quality} scans {list(keep)}")
    # The full file differs from its smoothed cuts (the rule is at work).
    assert not np.array_equal(jpeg.decode_jpeg(cut_scans(data, range(n - 1))),
                              jpeg.decode_jpeg(data))
    assert_reads_like_cv2(tmp_path, cut_scans(data, [0]))


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("case", ["cmyk_adobe0", "ycck_adobe2", "ycck_adobe1", "cmyk_no_marker",
                                  "cmyk_jfif"])
def test_decode_four_components(tmp_path, case, progressive):
    """Four components: CMYK where an Adobe marker says transform 0 or
    there is no Adobe marker (JFIF or not), YCCK for any other
    transform; libjpeg's CMYK, then OpenCV's own CMYK to BGR.  At 4:4:4
    and with the first and fourth components at 2x2 (as Adobe writes
    YCCK), baseline (a scan a component) and progressive."""
    apps = {"cmyk_adobe0": [adobe(0)], "ycck_adobe2": [adobe(2)], "ycck_adobe1": [adobe(1)],
            "cmyk_no_marker": [], "cmyk_jfif": [JFIF]}[case]
    for sampling, (h, w) in (("444", (16, 24)), ("444", (5, 7)), ("420", (17, 33)),
                             ("420", (40, 9))):
        data = four_component_file(h, w, sampling, apps, progressive)
        assert data[data.index(b"\xff\xc2" if progressive else b"\xff\xc0") + 9] == 4
        got = assert_reads_like_cv2(tmp_path, data)
    ycck = four_component_file(h, w, sampling, [adobe(2)], progressive)
    cmyk = four_component_file(h, w, sampling, [adobe(0)], progressive)
    assert not np.array_equal(jpeg.decode_jpeg(ycck), jpeg.decode_jpeg(cmyk))
    assert got.shape == (h, w, 3)


def test_progressive_assembler_equals_baseline():
    """assemble_progressive's file of cv2's coefficients reads as cv2's
    own baseline file does (the port and cv2 alike)."""
    for sampling, (h, w) in (("420", (23, 41)), ("444", (9, 9)), ("411", (16, 40))):
        data = cv2_jpeg(sample_image(h, w, seed=4), 90, sampling)
        frame, height, width, coefs, segs, _ = read_coefficients(data)
        quant = [body for marker, body in segs if marker == 0xDB]
        prog = assemble_progressive(frame, height, width, coefs, quant, apps=[JFIF])
        want = cv2.imdecode(np.frombuffer(data, np.uint8), 1)
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(prog, np.uint8), 1), want)
        np.testing.assert_array_equal(jpeg.decode_jpeg(prog), want)


# ----------------------------------------------------------------------
# Encoder
@pytest.mark.parametrize("quality", [70, 95, 98, 100])
@pytest.mark.parametrize("kind", ["random", "flat", "gray_repeated", "gray_2d", "smooth"])
def test_encode_equals_cv2(tmp_path, kind, quality):
    rng = np.random.default_rng(quality)
    for h, w in sizes():
        if kind == "random":
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        elif kind == "flat":
            img = np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
        elif kind == "gray_repeated":  # the fast path's crops
            img = np.repeat(rng.integers(0, 256, (h, w, 1), dtype=np.uint8), 3, axis=2)
        elif kind == "gray_2d":
            img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        else:
            img = sample_image(h, w, seed=h + w)
        got = encode_jpeg(img, quality)
        assert got == cv2_jpeg(img, quality), (h, w)
    path = tmp_path / "crop.jpg"
    imwrite_jpeg(str(path), img, quality)
    assert cv2.imwrite(str(tmp_path / "cv2.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert path.read_bytes() == (tmp_path / "cv2.jpg").read_bytes()


def test_encode_line_crops_at_quality_98():
    """The command lines' crops: 32 rows, widths to 2048, three equal
    channels (fast path) or BGR from the field warp (stage by stage),
    and non-contiguous views of a wider buffer."""
    rng = np.random.default_rng(98)
    wide = rng.integers(0, 256, (32, 2048, 3), dtype=np.uint8)
    for w in (1, 31, 517, 1024, 2048):
        view = wide[:, :w]
        assert encode_jpeg(view, 98) == cv2_jpeg(np.ascontiguousarray(view), 98)
        gray = np.repeat(wide[:, :w, :1], 3, axis=2)
        assert encode_jpeg(gray, 98) == cv2_jpeg(gray, 98)


def test_encode_rejects_other_arrays():
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4,), np.uint8)):
        with pytest.raises(ValueError, match="encode_jpeg"):
            encode_jpeg(bad, 95)


def test_round_trip_through_the_port():
    img = sample_image(33, 47)
    data = encode_jpeg(img, 95)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data),
                                  cv2.imdecode(np.frombuffer(data, np.uint8), 1))


# ----------------------------------------------------------------------
# What cv2 returns None for, and files cut short or corrupt: each file
# gives ``cv2.imread(path, 1)``'s bytes, or "Unable to read image"
# where that is None; no JPEG error names item 15.
def assert_like_cv2(tmp_path, data: bytes, name="scan.jpg"):
    """imread of ``data`` equals cv2.imread, page or None; returns the
    page or None."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if want is None:
        with pytest.raises(ValueError, match="Unable to read image") as e:
            imread(str(path))
        assert str(path) in str(e.value) and IMAGES not in str(e.value)
        return None
    got = imread(str(path))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def test_progressive_relabelled_codings_equal_cv2(tmp_path):
    """A progressive Huffman file (SOF2) reads as cv2 reads it; marked
    differential (SOF6, hierarchical) it is cv2's None, marked
    arithmetic (SOF10) its Huffman bytes decode as arithmetic data to
    cv2's very page."""
    data = cv2_jpeg(sample_image(24, 24), 90, progressive=True)
    assert b"\xff\xc2" in data
    assert_reads_like_cv2(tmp_path, data)
    sof = data.index(b"\xff\xc2")
    results = [assert_like_cv2(tmp_path, data[:sof + 1] + bytes([marker]) + data[sof + 2:])
               for marker in (0xC6, 0xCA)]
    assert results[0] is None and results[1] is not None


def test_refuses_four_components(tmp_path):
    """A CMYK file (Adobe transform 0, four 1x1 components) reads as cv2
    reads it; two components, which cv2 does not read, give "Unable to
    read image"."""
    data = cv2_jpeg(sample_image(16, 24), 90, "444")
    frame, h, w, coefs, segs, tables = read_coefficients(data)
    quant = [body for marker, body in segs if marker == 0xDB]
    cmyk = assemble(frame + [(4, 1, 1, 1)], h, w, {**coefs, 3: coefs[0]}, tables, quant,
                    apps=[adobe(0)])
    assert_reads_like_cv2(tmp_path, cmyk)
    two = assemble(frame[:2], h, w, coefs, tables, quant)
    assert cv2.imdecode(np.frombuffer(two, np.uint8), 1) is None
    assert assert_like_cv2(tmp_path, two) is None


def test_12_bit_and_other_codings_equal_cv2(tmp_path):
    """A baseline file marked 12-bit, lossless (SOF3, SOF7, SOF11),
    arithmetic (SOF9) or hierarchical (SOF5, SOF6): each is what cv2
    gives (None but for SOF9, whose Huffman bytes cv2 decodes as
    arithmetic data)."""
    data = bytearray(cv2_jpeg(sample_image(16, 16), 90))
    sof = data.index(b"\xff\xc0")
    data[sof + 4] = 12
    assert assert_like_cv2(tmp_path, bytes(data)) is None
    read = []
    for marker in (0xC3, 0xC7, 0xC9, 0xCB, 0xC5, 0xC6):
        data[sof + 1], data[sof + 4] = marker, 8
        if assert_like_cv2(tmp_path, bytes(data)) is not None:
            read.append(marker)
    assert read == [0xC9]


def test_truncated_and_corrupt_data_equal_cv2(tmp_path):
    """Cut at half its length the page reads as cv2 reads it, grey (128)
    from the cut on; cut after the scan header, all grey; cut inside
    the headers, None; a wrong restart marker, a run of ones (a code not
    in the tables) and an empty file of SOI and EOI as cv2 gives them."""
    data = cv2_jpeg(sample_image(64, 64), 95, "420")
    sos = data.index(b"\xff\xda")
    half = assert_like_cv2(tmp_path, data[:sos + (len(data) - sos) // 2])
    full = cv2.imdecode(np.frombuffer(data, np.uint8), 1)
    assert (half[56:] == 128).all() and np.array_equal(half[:24], full[:24])
    empty = assert_like_cv2(tmp_path, data[:sos + 14])  # the first MCU from zero bits
    assert (empty[16:] == 128).all() and (empty[:, 16:] == 128).all()
    assert assert_like_cv2(tmp_path, data[:sos + 8]) is None
    assert assert_like_cv2(tmp_path, data[:100]) is None
    restarts = cv2_jpeg(sample_image(64, 64), 95, "420", restart=1)
    assert_like_cv2(tmp_path, restarts.replace(b"\xff\xd1", b"\xff\xd5", 1))
    broken = data[:sos + 40] + b"\xff\x00" * 12 + data[sos + 64:]
    assert assert_like_cv2(tmp_path, broken) is not None
    assert assert_like_cv2(tmp_path, b"\xff\xd8\xff\xd9") is None
    with pytest.raises(ValueError, match="Unable to read image"):
        jpeg.decode_jpeg(b"\xff\xd8\xff\xd9")


CUT_SOURCES = ["baseline", "baseline_rst2", "progressive", "arithmetic", "arithmetic_prog",
               "lossless"]


def cut_source(kind: str) -> bytes:
    img = sample_image(27, 35, seed=31)
    if kind.startswith("baseline"):
        return cv2_jpeg(img, 90, "420", restart=2 if kind.endswith("rst2") else None)
    if kind == "progressive":
        return cv2_jpeg(img, 90, "420", restart=1, progressive=True)
    if kind == "lossless":
        return lossless_file([img[:, :, 2], img[:, :, 1], img[:, :, 0]], psv=4, pt=1,
                             restart_rows=3)
    frame, h, w, coefs, segs, _ = read_coefficients(cv2_jpeg(img, 90, "420"))
    return arithmetic_file(frame, h, w, coefs, quant_bodies(segs), restart=2,
                           script=progressive_script(3) if kind == "arithmetic_prog" else None)


@pytest.mark.parametrize("kind", CUT_SOURCES)
def test_cut_short_equals_cv2(tmp_path, kind):
    """A file cut at seeded offsets: inside the headers, inside the scan
    header, every few bytes of the scans, just before EOI.  libjpeg
    reads the fake EOI of its stdio source past the end: a one-scan
    Huffman file grey from the MCU after the cut, a progressive one
    smoothed with the previous scan's precision past the last iMCU row
    the cut scan reached, arithmetic data decoded from zeros."""
    data = cut_source(kind)
    rng = np.random.default_rng(len(data))
    sos = data.index(b"\xff\xda")
    cuts = sorted({2, 3, sos - 5, sos + 3, sos + 9, len(data) - 1, len(data) - 2}
                  | set(rng.integers(sos, len(data), 40).tolist()))
    read = 0
    for cut in cuts:
        read += assert_like_cv2(tmp_path, data[:cut]) is not None
    assert read >= 30


CORRUPTIONS = ["flipped_bits", "extraneous_bytes", "rst_ahead", "rst_behind", "rst_missing",
               "bytes_lost"]


@pytest.mark.parametrize("how", CORRUPTIONS)
@pytest.mark.parametrize("kind", ["baseline_rst2", "progressive", "arithmetic_prog", "lossless"])
def test_corrupt_data_equals_cv2(tmp_path, kind, how):
    """Seeded corruptions of the entropy-coded data: a bit flipped
    (codes not in the tables among them), bytes inserted before a
    marker (skipped by next_marker), an RSTn replaced by one ahead or
    behind, or dropped (jpeg_resync_to_restart), bytes lost."""
    data = cut_source(kind)
    rng = np.random.default_rng(sum(map(ord, how)))
    sos = data.index(b"\xff\xda") + 14
    markers = [i for i in range(sos, len(data) - 1)
               if data[i] == 0xFF and data[i + 1] not in (0x00, 0xFF)]
    rsts = [i for i in markers if 0xD0 <= data[i + 1] <= 0xD7]
    for _ in range(6):
        b = bytearray(data)
        if how == "flipped_bits":
            at = int(rng.integers(sos, len(b) - 2))
            b[at] ^= 1 << int(rng.integers(8))
        elif how == "extraneous_bytes":
            at = markers[int(rng.integers(len(markers)))]
            b[at:at] = rng.integers(0, 255, int(rng.integers(1, 6)), dtype=np.uint8).tobytes()
        elif how == "bytes_lost":
            at = int(rng.integers(sos, len(b) - 2))
            del b[at:at + int(rng.integers(1, 20))]
        else:
            at = rsts[int(rng.integers(len(rsts)))]
            n = b[at + 1] - 0xD0
            if how == "rst_missing":
                del b[at:at + 2]
            else:
                b[at + 1] = 0xD0 + (n + (1 if how == "rst_ahead" else -2)) % 8
        assert_like_cv2(tmp_path, bytes(b))


def test_components_decode_reads_what_libjpeg_warns_of(tmp_path):
    """``decode_jpeg_components`` (a TIFF strip's unconverted components,
    libtiff's JCS_UNKNOWN) reads data cut short as the BGR decode reads
    it: a gray file's one component is cv2.imread's channel, whole or cut;
    an RGB file's (an Adobe marker with transform 0, no JFIF marker) are
    the BGR decode's channels reversed; a YCbCr file's are its Y, Cb and
    Cr planes, which the BGR decode converts."""
    gray = cv2.imencode(".jpg", sample_image(32, 48)[:, :, 0], [cv2.IMWRITE_JPEG_QUALITY, 90])[1]
    gray = gray.tobytes()
    for data in (gray, gray[:len(gray) * 2 // 3]):
        got = jpeg.decode_jpeg_components(data)
        assert got.shape == (32, 48, 1)
        np.testing.assert_array_equal(got[:, :, 0], assert_like_cv2(tmp_path, data)[:, :, 0])
    ycc = cv2_jpeg(sample_image(32, 32), 90, "444")
    assert ycc[2:4] == b"\xff\xe0"  # JFIF, which would make the components YCbCr
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    rgb = ycc[:2] + adobe + ycc[4 + int.from_bytes(ycc[4:6], "big"):]
    np.testing.assert_array_equal(jpeg.decode_jpeg_components(rgb),
                                  jpeg.decode_jpeg(rgb)[:, :, ::-1])
    planes = jpeg.decode_jpeg_components(ycc)
    assert planes.shape == (32, 32, 3) and not np.array_equal(planes, jpeg.decode_jpeg(ycc)[:, :, ::-1])


# ----------------------------------------------------------------------
# Arithmetic coding (SOF9, SOF10)
ARITH_SIZES = [(1, 1), (1, 40), (40, 1), (17, 3), (23, 41)]


@pytest.mark.parametrize("restart", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("sampling", ["gray", *SAMPLING])
def test_decode_arithmetic_equals_cv2(tmp_path, sampling, progressive, restart):
    """cv2's coefficients re-coded arithmetic (one interleaved scan, or
    libjpeg's 10- or 6-scan progression) at sizes 1x1 to 23x41: cv2
    reads each to the pixels of the Huffman file they came from (the
    writer is right), and the port reads each as cv2 does."""
    for h, w in ARITH_SIZES:
        img = sample_image(h, w, seed=h * 13 + w)
        data = cv2_jpeg(img[:, :, 0] if sampling == "gray" else img, 90,
                        None if sampling == "gray" else sampling)
        frame, height, width, coefs, segs, _ = read_coefficients(data)
        arith = arithmetic_file(frame, height, width, coefs, quant_bodies(segs), restart=restart,
                                script=progressive_script(len(frame)) if progressive else None)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), 1)
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(arith, np.uint8), 1), want)
        np.testing.assert_array_equal(jpeg.decode_jpeg(arith), want, err_msg=f"{h}x{w}")
    assert (b"\xff\xca" if progressive else b"\xff\xc9") in arith
    assert_reads_like_cv2(tmp_path, arith)


@pytest.mark.parametrize("case", ["dc_bounds", "ac_kx", "tables", "redefined"])
def test_decode_arithmetic_conditioning(tmp_path, case):
    """DAC segments (DC L and U, AC Kx) other than the defaults,
    conditioning table numbers up to 15, and a DAC between scans."""
    img = sample_image(33, 45, seed=32)
    data = cv2_jpeg(img, 95, "420")
    frame, height, width, coefs, segs, _ = read_coefficients(data)
    kwargs = {"dc_bounds": {"dac": {("dc", 0): (3, 7), ("dc", 1): (0, 0)}},
              "ac_kx": {"dac": {("ac", 0): 1, ("ac", 1): 63}},
              "tables": {"tables": [(2, 3), (7, 9), (15, 15)],
                         "dac": {("dc", 15): (1, 2), ("ac", 9): 20}},
              "redefined": {"dac": {("ac", 0): 30}, "scan_dac": {4: {("ac", 0): 2}}}}[case]
    want = cv2.imdecode(np.frombuffer(data, np.uint8), 1)
    for script in (None, progressive_script(3)):
        arith = arithmetic_file(frame, height, width, coefs, quant_bodies(segs), script=script,
                                restart=3, **kwargs)
        assert b"\xff\xcc" in arith
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(arith, np.uint8), 1), want)
        np.testing.assert_array_equal(assert_reads_like_cv2(tmp_path, arith), want)


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("case", ["cmyk_adobe0", "ycck_adobe2", "cmyk_no_marker"])
def test_decode_arithmetic_four_components(tmp_path, case, progressive):
    apps = {"cmyk_adobe0": [adobe(0)], "ycck_adobe2": [adobe(2)], "cmyk_no_marker": []}[case]
    for sampling, (h, w) in (("444", (16, 24)), ("420", (17, 33))):
        frame, height, width, coefs, quant = four_components(h, w, sampling, seed=3)
        arith = arithmetic_file(frame, height, width, coefs, quant, apps=apps,
                                script=progressive_script(4) if progressive else None)
        huff = four_component_file(h, w, sampling, apps, False, seed=3)
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(arith, np.uint8), 1),
                                      cv2.imdecode(np.frombuffer(huff, np.uint8), 1))
        assert_reads_like_cv2(tmp_path, arith)


@pytest.mark.parametrize("sampling", ["gray", "420", "444"])
def test_decode_arithmetic_progressive_cut_short(tmp_path, sampling):
    """Arithmetic progressive files of the first scans only (block
    smoothing), and cut inside a scan at seeded offsets."""
    img = sample_image(41, 49, seed=33)
    data = cv2_jpeg(img[:, :, 0] if sampling == "gray" else img, 80,
                    None if sampling == "gray" else sampling)
    frame, height, width, coefs, segs, _ = read_coefficients(data)
    script = progressive_script(len(frame))
    full = cv2.imdecode(np.frombuffer(arithmetic_file(
        frame, height, width, coefs, quant_bodies(segs), script=script), np.uint8), 1)
    smoothed = 0
    for n in range(1, len(script)):
        part = arithmetic_file(frame, height, width, coefs, quant_bodies(segs),
                               script=script[:n], restart=2)
        got = assert_reads_like_cv2(tmp_path, part)
        smoothed += not np.array_equal(got, full)
        rng = np.random.default_rng(n)
        for cut in rng.integers(part.rindex(b"\xff\xda"), len(part), 3):
            assert_like_cv2(tmp_path, part[:cut])
    assert smoothed == len(script) - 1


# ----------------------------------------------------------------------
# Lossless (SOF3)
@pytest.mark.parametrize("one_scan", [True, False], ids=["one_scan", "scan_a_component"])
@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("psv", range(1, 8))
def test_decode_lossless_equals_cv2(tmp_path, psv, pt, one_scan):
    """Lossless RGB files (no JFIF marker: libjpeg takes them as RGB) of
    every predictor, point transforms 0 and 2, one interleaved scan or
    a scan a component, with and without restarts: cv2 reads each to
    its samples shifted back up by Pt, and so does the port."""
    img = sample_image(19, 26, seed=psv)
    planes = [img[:, :, 2], img[:, :, 1], img[:, :, 0]]
    for restart_rows in (0, 1, 4):
        data = lossless_file(planes, psv=psv, pt=pt, restart_rows=restart_rows,
                             one_scan=one_scan)
        got = assert_reads_like_cv2(tmp_path, data)
        np.testing.assert_array_equal(got, (img >> pt) << pt)


@pytest.mark.parametrize("case", ["precision_2", "precision_5", "precision_8_adobe0",
                                  "rgb_ids", "cmyk", "cmyk_adobe0", "other_ids"])
def test_decode_lossless_kinds_equal_cv2(tmp_path, case):
    img = sample_image(15, 21, seed=7)
    planes = [img[:, :, 2], img[:, :, 1], img[:, :, 0]]
    kwargs = {}
    if case.startswith("precision"):
        bits = int(case.split("_")[1])
        planes = [p >> (8 - bits) for p in planes]
        kwargs = {"precision": bits, "pt": 1 if bits > 2 else 0,
                  "apps": [adobe(0)] if "adobe0" in case else ()}
    elif case == "rgb_ids":
        kwargs = {"ids": [82, 71, 66]}
    elif case == "other_ids":
        kwargs = {"ids": [7, 8, 9]}
    elif case.startswith("cmyk"):
        planes = planes + [img[:, :, 0] // 3]
        kwargs = {"apps": [adobe(0)] if case.endswith("adobe0") else ()}
    data = lossless_file(planes, psv=6, restart_rows=2, **kwargs)
    assert assert_like_cv2(tmp_path, data) is not None


@pytest.mark.parametrize("case", [
    "sof5", "sof6", "sof7", "sof13", "sof14", "sof15", "sof11_arithmetic_lossless",
    "12bit_huffman", "12bit_arithmetic", "12bit_arithmetic_progressive", "lossless_gray",
    "lossless_ycc_jfif", "lossless_ycc_adobe1", "lossless_ycck", "lossless_9bit",
    "lossless_16bit", "lossless_restart_part_row", "lossless_component_without_scan",
    "height_0", "two_components", "second_soi", "unknown_marker", "no_sos",
    "progressive_without_ac_table", "signature_ff_d8_00"])
def test_cv2_none_cases(tmp_path, case):
    """What libjpeg-turbo or OpenCV gives up on, written properly where a
    writer exists (tests/jpeg_files.py: 12-bit Huffman and arithmetic
    files, lossless files): "Unable to read image", never item 15.
    Hierarchical files (SOF5-7, SOF13-15) fail at their frame marker and
    arithmetic lossless (SOF11) as soon as decoding starts, before any
    data is read, so a relabelled frame header stands for them."""
    img = sample_image(16, 16, seed=8)
    base = cv2_jpeg(img, 90, "420")
    frame, height, width, coefs, segs, _ = read_coefficients(base)
    quant = quant_bodies(segs)
    planes = [img[:, :, 2], img[:, :, 1], img[:, :, 0]]
    sof = base.index(b"\xff\xc0")

    def relabel(data, marker):
        at = next(i for i in range(len(data) - 1)
                  if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC3))
        return data[:at + 1] + bytes([marker]) + data[at + 2:]

    if case.startswith("sof") and case[3:5].isdigit() and "_" not in case:
        data = relabel(base, 0xC0 + int(case[3:]))
    elif case == "sof11_arithmetic_lossless":
        data = relabel(lossless_file(planes, psv=1), 0xCB)
    elif case == "12bit_huffman":
        data = huffman_file(frame, height, width, coefs, quant, precision=12)
    elif case.startswith("12bit_arithmetic"):
        data = arithmetic_file(frame, height, width, coefs, quant, precision=12,
                               script=progressive_script(3) if "progressive" in case else None)
    elif case == "lossless_gray":
        data = lossless_file(planes[:1], psv=2)
    elif case == "lossless_ycc_jfif":
        data = lossless_file(planes, psv=2, apps=[JFIF])
    elif case == "lossless_ycc_adobe1":
        data = lossless_file(planes, psv=2, apps=[adobe(1)])
    elif case == "lossless_ycck":
        data = lossless_file(planes + planes[:1], psv=2, apps=[adobe(2)])
    elif case in ("lossless_9bit", "lossless_16bit"):
        shift = int(case[9:-3]) - 8
        data = lossless_file([p.astype(np.int64) << shift for p in planes], psv=2,
                             precision=8 + shift)
    elif case == "lossless_restart_part_row":
        data = lossless_file(planes, psv=2, restart_rows=1).replace(
            b"\xff\xdd\x00\x04\x00\x10", b"\xff\xdd\x00\x04\x00\x11")
    elif case == "lossless_component_without_scan":
        data = lossless_file(planes, psv=2, one_scan=False)
        data = data[:data.rindex(b"\xff\xc4")] + b"\xff\xd9"
    elif case == "height_0":
        data = base[:sof + 5] + b"\x00\x00" + base[sof + 7:]
    elif case == "two_components":
        data = huffman_file(frame[:2], height, width, coefs, quant)
    elif case == "second_soi":
        data = base[:2] + b"\xff\xd8" + base[2:]
    elif case == "unknown_marker":
        data = base[:2] + b"\xff\x02\x00\x04ab" + base[2:]
    elif case == "no_sos":
        data = base[:base.index(b"\xff\xda")] + b"\xff\xd9"
    elif case == "progressive_without_ac_table":
        prog = cv2_jpeg(img, 90, "420", progressive=True)
        second = prog.index(b"\xff\xc4", prog.index(b"\xff\xda"))
        length = struct.unpack(">H", prog[second + 2:second + 4])[0]
        data = prog[:second] + prog[second + 2 + length:]
    else:
        data = b"\xff\xd8\x00" + base[3:]
    path = tmp_path / "none.jpg"
    path.write_bytes(data)
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="Unable to read image") as e:
        imread(str(path))
    assert IMAGES not in str(e.value)


def test_after_a_one_scan_file_nothing_is_read(tmp_path):
    """Past the scan of a one-scan file cv2 has its page: a second SOS,
    SOF or SOI, an unknown marker, garbage or a DNL segment change
    nothing."""
    base = cv2_jpeg(sample_image(24, 32, seed=9), 90, "420")
    want = cv2.imdecode(np.frombuffer(base, np.uint8), 1)
    body, sof = base[:-2], base.index(b"\xff\xc0")
    for tail in (base[base.index(b"\xff\xda"):], b"\xff\x02\x00\x04ab\xff\xd9",
                 b"\xff\xd8\xff\xd9", base[sof:sof + 19] + b"\xff\xd9", b"abc\xff\xd9",
                 b"\xff\xdc\x00\x04\x00\x18\xff\xd9"):
        np.testing.assert_array_equal(assert_like_cv2(tmp_path, body + tail), want)


def test_colour_space_is_fixed_at_the_first_scan(tmp_path):
    """An Adobe RGB marker between the scans of a progressive YCbCr file
    changes nothing: libjpeg guesses the colour space before the first
    scan."""
    data = cv2_jpeg(sample_image(24, 32, seed=11), 90, "444", progressive=True)
    assert data[2:4] == b"\xff\xe0"
    data = data[:2] + data[4 + struct.unpack(">H", data[4:6])[0]:]  # no JFIF marker
    want = cv2.imdecode(np.frombuffer(data, np.uint8), 1)
    head, scans, tail = split_scans(data)
    for i in (1, len(scans) - 1):
        moved = head + b"".join(scans[:i]) + _segment(*adobe(0)) + b"".join(scans[i:]) + tail
        np.testing.assert_array_equal(assert_like_cv2(tmp_path, moved), want)


def test_standard_tables_stand_in_for_missing_ones(tmp_path):
    """A sequential Huffman file without DHT segments (Motion JPEG) is
    read with the standard tables, as libjpeg's jinit_huff_decoder
    fills them in; a Se other than 63 only draws a warning."""
    base = cv2_jpeg(sample_image(24, 32, seed=10), 90, "420")
    want = cv2.imdecode(np.frombuffer(base, np.uint8), 1)
    out, pos = base[:2], 2
    while True:
        marker = base[pos + 1]
        length = struct.unpack(">H", base[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            out += base[pos:]
            break
        if marker != 0xC4:
            out += base[pos:pos + 2 + length]
        pos += 2 + length
    np.testing.assert_array_equal(assert_like_cv2(tmp_path, out), want)
    sos = out.index(b"\xff\xda")
    odd = out[:sos + 12] + b"\x05\x12" + out[sos + 14:]
    np.testing.assert_array_equal(assert_like_cv2(tmp_path, odd), want)


# ----------------------------------------------------------------------
# The committed fixtures (tests/data/jpeg, written by make_fixtures.py
# with cv2): what chip_smoke.check_jpeg_fixtures holds the card
# machine's build to.
def _fixtures():
    with open(os.path.join(FIXTURES, "fixtures.json"), encoding="utf-8") as f:
        return json.load(f)


def _decoded_files(spec):
    """(path, digest) of every decoded fixture: tests/data/jpeg's files
    and the full-size pages (their paths from tests/data)."""
    return ([(os.path.join(FIXTURES, name), d) for name, d in spec["decode"].items()]
            + [(os.path.join(os.path.dirname(FIXTURES), name), d)
               for name, d in spec["pages"].items()])


def test_fixture_digests_reproduce():
    spec = _fixtures()
    for path, digest in _decoded_files(spec):
        got = imread(path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == digest["sha256"], path
        assert list(got.shape) == digest["shape"], path
    for name in spec["none"]:
        with pytest.raises(ValueError, match="Unable to read image") as e:
            imread(os.path.join(FIXTURES, name))
        assert IMAGES not in str(e.value), name
    for name, cases in spec["encode"].items():
        crop = np.load(os.path.join(FIXTURES, name))
        for quality, digest in cases.items():
            assert hashlib.sha256(encode_jpeg(crop, int(quality))).hexdigest() == digest, name
    assert len(spec["decode"]) >= 20 and len(spec["encode"]) >= 3
    names = " ".join(spec["decode"])
    for kind in ("prog_s444", "prog_s411", "prog_gray", "prog_cut", "cmyk", "ycck", "arith_s",
                 "arith_prog", "arith_dac", "lossless_rgb", "lossless_cmyk", "cut_", "corrupt_"):
        assert kind in names, kind
    assert len(spec["none"]) >= 10
    assert [d["shape"] for d in spec["pages"].values()] == [[2560, 1792, 3]] * 2


def test_no_jpeg_error_names_item_15():
    """Every JPEG fixture, and each cut at three points, is read or gives
    "Unable to read image": no JPEG file draws item 15's refusal."""
    spec = _fixtures()
    names = [n for n in list(spec["decode"]) + spec["none"] if n.endswith(".jpg")]
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        for end in (len(data), len(data) // 3, len(data) // 2, len(data) - 2):
            try:
                jpeg.decode_jpeg(data[:end], name)
            except ValueError as e:
                assert "Unable to read image" in str(e) and IMAGES not in str(e), (name, end)


def test_fixtures_equal_cv2_here():
    """The JSON's digests are cv2's (the generator's), its None cases are
    cv2's None, and the files are small; the full-size pages are under
    1 MB each, one progressive Huffman (SOF2), one its coefficients
    re-coded arithmetic progressive (SOF10), both cv2's same pixels."""
    spec = _fixtures()
    for path, digest in _decoded_files(spec):
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        assert hashlib.sha256(want.tobytes()).hexdigest() == digest["sha256"], path
    for name in spec["none"]:
        assert cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_COLOR) is None, name
    markers = {"progressive": b"\xff\xc2", "arith": b"\xff\xca"}
    for name in spec["pages"]:
        with open(os.path.join(os.path.dirname(FIXTURES), name), "rb") as f:
            page = f.read()
        kind = next(k for k in markers if f"_{k}_" in name)
        assert len(page) < 1_000_000 and markers[kind] in page, name
        assert all(m not in page for k, m in markers.items() if k != kind), name
    assert len({d["sha256"] for d in spec["pages"].values()}) == 1
    for name, cases in spec["encode"].items():
        crop = np.load(os.path.join(FIXTURES, name))
        for quality, digest in cases.items():
            assert hashlib.sha256(cv2_jpeg(crop, int(quality))).hexdigest() == digest
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    assert total < 300_000, total
