"""The port's JPEG codec (``pero_ocr_tpu_torch/csrc/jpeg.cpp``, bound in
``pero_ocr_tpu_torch/utils/jpeg.py``) against OpenCV 5's libjpeg-turbo,
bit for bit, on the CPU.

Decoder: ``imread`` (and ``decode_jpeg``) of files that cv2 wrote at
every sampling it writes (gray, 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1),
sizes 1-40 and a 2560x1792 page, qualities 1-100, restart intervals;
and of files rebuilt here from cv2's coefficients (a pure-Python
baseline entropy codec, :func:`read_coefficients` and :func:`assemble`):
one scan a component, other component ids, JFIF and Adobe markers for
the colour-space guess.  Each equals ``cv2.imread(path, 1)``.

Encoder: ``encode_jpeg`` equals ``cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, q])`` byte for byte on random, flat and
gray-repeated (h, w, 3) images and on 2-D gray, sizes 1-40.

What the codec does not read (progressive, four components, 12-bit
samples, truncated or corrupt entropy data) raises ``ValueError`` naming
the file, the feature and the ROADMAP item.  The committed fixtures of
``tests/data/jpeg`` (the card's check, ``chip_smoke.check_jpeg_fixtures``)
reproduce their digests.

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
# A baseline entropy codec in Python, for files cv2 does not write.
def segments(data: bytes):
    """The marker segments of a JPEG file up to its first SOS: [(marker,
    body)], and the entropy-coded data after that SOS up to EOI."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((marker, data[pos + 4:pos + 2 + length]))
        pos += 2 + length
        if marker == 0xDA:
            return out, data[pos:data.rindex(b"\xff\xd9")]


def _huffman(body: bytes):
    """A DHT body -> {(class, id): (codes {(length, code): symbol},
    sizes {symbol: (length, code)})}."""
    tables, pos = {}, 0
    while pos < len(body):
        tc, counts = body[pos], body[pos + 1:pos + 17]
        vals = body[pos + 17:pos + 17 + sum(counts)]
        pos += 17 + sum(counts)
        codes, code, k = {}, 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                codes[(length, code)] = vals[k]
                code, k = code + 1, k + 1
            code <<= 1
        tables[(tc >> 4, tc & 15)] = (codes, {s: lc for lc, s in codes.items()},
                                     bytes([tc]) + counts + vals)
    return tables


def read_coefficients(data: bytes):
    """A one-scan baseline file without restarts (cv2's output) ->
    (frame: [(id, h, v, tq)], height, width, {component index: (bh, bw,
    64) int zigzag coefficients}, the segments)."""
    segs, entropy = segments(data)
    tables = {}
    for marker, body in segs:
        if marker == 0xC4:
            tables.update(_huffman(body))
        if marker == 0xC0:
            height, width, n = struct.unpack(">HHB", body[1:6])
            frame = [tuple(body[6 + 3 * i:9 + 3 * i]) for i in range(n)]
            frame = [(i, hv >> 4, hv & 15, tq) for i, hv, tq in frame]
        if marker == 0xDA:
            scan = [(body[1 + 2 * i], body[2 + 2 * i]) for i in range(body[0])]
    bits = "".join(f"{b:08b}" for b in entropy.replace(b"\xff\x00", b"\xff"))
    pos = 0

    def symbol(codes):
        nonlocal pos
        for length in range(1, 17):
            key = (length, int(bits[pos:pos + length], 2))
            if key in codes:
                pos += length
                return codes[key]
        raise ValueError("bad code")

    def value(s):
        nonlocal pos
        if s == 0:
            return 0
        v = int(bits[pos:pos + s], 2)
        pos += s
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1

    maxh, maxv = max(c[1] for c in frame), max(c[2] for c in frame)
    mcux, mcuy = -(-width // (8 * maxh)), -(-height // (8 * maxv))
    coefs = {i: np.zeros((mcuy * c[2], mcux * c[1], 64), int) for i, c in enumerate(frame)}
    pred = [0] * len(frame)
    index = {c[0]: i for i, c in enumerate(frame)}
    for my in range(mcuy):
        for mx in range(mcux):
            for cid, t in scan:
                i = index[cid]
                _, h, v, _ = frame[i]
                for by in range(v):
                    for bx in range(h):
                        blk = coefs[i][my * v + by, mx * h + bx]
                        pred[i] += value(symbol(tables[(0, t >> 4)][0]))
                        blk[0] = pred[i]
                        k = 1
                        while k < 64:
                            rs = symbol(tables[(1, t & 15)][0])
                            if rs & 15:
                                k += rs >> 4
                                blk[k] = value(rs & 15)
                            elif rs != 0xF0:
                                break
                            else:
                                k += 15
                            k += 1
    return frame, height, width, coefs, segs, tables


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


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


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


JFIF = (0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform):
    return (0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


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
# Refusals
def _refused(tmp_path, data, what):
    path = tmp_path / "scan.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=what) as e:
        imread(str(path))
    assert str(path) in str(e.value) and IMAGES in str(e.value)


def test_refuses_progressive(tmp_path):
    data = cv2_jpeg(sample_image(24, 24), 90, progressive=True)
    assert b"\xff\xc2" in data and cv2.imdecode(np.frombuffer(data, np.uint8), 1) is not None
    _refused(tmp_path, data, "progressive")


def test_refuses_four_components(tmp_path):
    """A CMYK file (Adobe transform 0, four 1x1 components) that cv2
    reads."""
    data = cv2_jpeg(sample_image(16, 24), 90, "444")
    frame, h, w, coefs, segs, tables = read_coefficients(data)
    frame = frame + [(4, 1, 1, 1)]
    coefs = {**coefs, 3: coefs[0]}
    quant = [body for marker, body in segs if marker == 0xDB]
    cmyk = assemble(frame, h, w, coefs, tables, quant, apps=[adobe(0)])
    assert cv2.imdecode(np.frombuffer(cmyk, np.uint8), 1) is not None
    _refused(tmp_path, cmyk, "four components")


def test_refuses_12_bit_and_other_codings(tmp_path):
    data = bytearray(cv2_jpeg(sample_image(16, 16), 90))
    sof = data.index(b"\xff\xc0")
    data[sof + 4] = 12
    _refused(tmp_path, bytes(data), "12-bit")
    for marker, what in ((0xC3, "lossless"), (0xC9, "arithmetic"), (0xC5, "hierarchical")):
        data[sof + 1], data[sof + 4] = marker, 8
        _refused(tmp_path, bytes(data), what)


def test_refuses_truncated_and_corrupt_data(tmp_path):
    data = cv2_jpeg(sample_image(64, 64), 95, "420")
    sos = data.index(b"\xff\xda")
    _refused(tmp_path, data[:sos + (len(data) - sos) // 2], "truncated")
    _refused(tmp_path, data[:sos + 8], "truncated")
    _refused(tmp_path, data[:100], "truncated")
    restarts = cv2_jpeg(sample_image(64, 64), 95, "420", restart=1)
    _refused(tmp_path, restarts.replace(b"\xff\xd1", b"\xff\xd5", 1), "restart marker")
    # A run of ones in the data: a 16-bit code the tables do not hold.
    broken = data[:sos + 40] + b"\xff\x00" * 12 + data[sos + 64:]
    _refused(tmp_path, broken, "corrupt|truncated")
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(b"\xff\xd8\xff\xd9")


# ----------------------------------------------------------------------
# The committed fixtures (tests/data/jpeg, written by make_fixtures.py
# with cv2): what chip_smoke.check_jpeg_fixtures holds the card
# machine's build to.
def _fixtures():
    with open(os.path.join(FIXTURES, "fixtures.json"), encoding="utf-8") as f:
        return json.load(f)


def test_fixture_digests_reproduce():
    spec = _fixtures()
    for name, digest in spec["decode"].items():
        got = imread(os.path.join(FIXTURES, name))
        assert hashlib.sha256(got.tobytes()).hexdigest() == digest["sha256"], name
        assert list(got.shape) == digest["shape"], name
    for name, cases in spec["encode"].items():
        crop = np.load(os.path.join(FIXTURES, name))
        for quality, digest in cases.items():
            assert hashlib.sha256(encode_jpeg(crop, int(quality))).hexdigest() == digest, name
    assert len(spec["decode"]) >= 20 and len(spec["encode"]) >= 3


def test_fixtures_equal_cv2_here():
    """The JSON's digests are cv2's (the generator's) and the files are
    small."""
    spec = _fixtures()
    for name, digest in spec["decode"].items():
        want = cv2.imread(os.path.join(FIXTURES, name), cv2.IMREAD_COLOR)
        assert hashlib.sha256(want.tobytes()).hexdigest() == digest["sha256"], name
    for name, cases in spec["encode"].items():
        crop = np.load(os.path.join(FIXTURES, name))
        for quality, digest in cases.items():
            assert hashlib.sha256(cv2_jpeg(crop, int(quality))).hexdigest() == digest
    total = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    assert total < 300_000, total
