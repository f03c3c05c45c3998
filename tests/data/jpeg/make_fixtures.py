"""Write the JPEG fixtures of this folder and their digests.

    python3 tests/data/jpeg/make_fixtures.py

Needs cv2 (OpenCV 5, libjpeg-turbo 3.1) and runs where the tests run,
never on the card's machine.  It writes small JPEG (and two PNG) files
made with cv2: every sampling cv2 writes, gray, restart intervals, odd
sizes, the 8 EXIF orientations, in baseline and progressive form;
progressive files cut short of some scans (libjpeg's block smoothing
fills them in); a file of one scan a component, an Adobe RGB file and
four-component files (CMYK and YCCK, with and without an Adobe marker,
baseline and progressive), rebuilt from cv2's coefficients by
tests/test_torch_jpeg.py's entropy codec; arithmetic-coded (sequential
and progressive, restarts, DAC conditioning, four components) and
lossless files written by tests/jpeg_files.py, files cut short or
corrupt, and files cv2 returns None for (hierarchical, 12-bit,
arithmetic lossless, gray or YCbCr lossless, broken headers); raw crops
(``.npy``) for the encoder; one full-size 2560x1792 two-column page in
``tests/data/page`` (chip_smoke.py's synthetic page, tinted apart in its
three channels), progressive, and its coefficients re-coded arithmetic
progressive with the same 10 scans (a few minutes of pure Python); and
``fixtures.json``: the sha256 of ``cv2.imread(path, 1)``'s array for
each file read (the pages' under "pages", their paths from
``tests/data``), the names of those cv2 returns None for under "none",
and the sha256 of ``cv2.imencode(".jpg", crop, [IMWRITE_JPEG_QUALITY,
q])``'s bytes for each crop and quality.
tests/test_torch_jpeg.py holds the port's codec to the JSON on the CPU,
``chip_smoke.check_jpeg_fixtures`` on the card's machine.
"""

import hashlib
import json
import os
import struct
import sys
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

import cv2  # noqa: E402
import numpy as np  # noqa: E402

from tests.jpeg_files import (  # noqa: E402
    JFIF, adobe, arithmetic_file, huffman_file, lossless_file, progressive_script,
    quant_bodies, read_coefficients, scan_script,
)
from tests.test_torch_jpeg import (  # noqa: E402
    cut_scans, cv2_jpeg, four_components, four_component_file, rebuilt, sample_image,
)

PAGE = "page/two_columns_progressive_2560x1792_q85.jpg"  # from tests/data
ARITH_PAGE = "page/two_columns_arith_2560x1792_q85.jpg"
PAGE_QUALITY = 85  # under 1 MB; quality 90 takes 1.24 MB

QUALITIES = (70, 95, 98, 100)


def exif(orientation: int) -> bytes:
    """A little-endian TIFF block whose one IFD entry is the orientation."""
    return (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))


def with_app1(data: bytes, block: bytes) -> bytes:
    app1 = b"Exif\x00\x00" + block
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


def png_with_exif(img, block: bytes) -> bytes:
    data = cv2.imencode(".png", img)[1].tobytes()
    at = data.index(b"IDAT") - 4
    chunk = (struct.pack(">I", len(block)) + b"eXIf" + block
             + struct.pack(">I", zlib.crc32(b"eXIf" + block)))
    return data[:at] + chunk + data[at:]


def files():
    """name -> bytes."""
    out = {}
    for sampling in ("444", "422", "420", "440", "411"):
        out[f"s{sampling}_37x29_q90.jpg"] = cv2_jpeg(sample_image(37, 29, seed=1), 90, sampling)
    out["gray_29x37_q95.jpg"] = cv2_jpeg(sample_image(29, 37, 1, seed=2)[:, :, 0], 95)
    out["s420_rst2_33x45_q90.jpg"] = cv2_jpeg(sample_image(33, 45, seed=3), 90, "420", restart=2)
    out["gray_rst1_20x30_q70.jpg"] = cv2_jpeg(sample_image(20, 30, 1, seed=4)[:, :, 0], 70,
                                              restart=1)
    for h, w, q in ((1, 1, 98), (1, 40, 100), (40, 1, 50), (17, 3, 1), (3, 18, 95)):
        out[f"s420_{h}x{w}_q{q}.jpg"] = cv2_jpeg(sample_image(h, w, seed=h + w), q, "420")
    base = cv2_jpeg(sample_image(12, 20, seed=5), 95, "420")
    for orientation in range(1, 9):
        out[f"exif{orientation}_12x20.jpg"] = with_app1(base, exif(orientation))
    for orientation in (6, 8):
        out[f"exif{orientation}_12x20.png"] = png_with_exif(sample_image(12, 20, seed=6),
                                                           exif(orientation))
    out["scan_a_component_23x41.jpg"] = rebuilt(sample_image(23, 41, seed=7), "420",
                                                 apps=[JFIF])
    out["adobe_rgb_21x30.jpg"] = rebuilt(sample_image(21, 30, seed=8), "444", apps=[adobe(0)])
    rng = np.random.default_rng(9)
    page = cv2.GaussianBlur(rng.integers(0, 256, (192, 256, 3), dtype=np.uint8), (0, 0), 2)
    out["s420_192x256_q90.jpg"] = cv2_jpeg(page, 90, "420")
    # progressive (cv2's scan script), every sampling, gray, restarts,
    # qualities, odd sizes
    for sampling in ("444", "422", "420", "440", "411"):
        out[f"prog_s{sampling}_37x29_q90.jpg"] = cv2_jpeg(sample_image(37, 29, seed=11), 90,
                                                          sampling, progressive=True)
    out["prog_gray_29x37_q95.jpg"] = cv2_jpeg(sample_image(29, 37, 1, seed=12)[:, :, 0], 95,
                                              progressive=True)
    out["prog_s420_rst2_33x45_q90.jpg"] = cv2_jpeg(sample_image(33, 45, seed=13), 90, "420",
                                                   restart=2, progressive=True)
    out["prog_gray_rst1_20x30_q70.jpg"] = cv2_jpeg(sample_image(20, 30, 1, seed=14)[:, :, 0], 70,
                                                   restart=1, progressive=True)
    for h, w, q in ((1, 1, 1), (1, 40, 100), (40, 1, 50), (17, 3, 10), (3, 18, 75)):
        out[f"prog_s420_{h}x{w}_q{q}.jpg"] = cv2_jpeg(sample_image(h, w, seed=h * w + 1), q, "420",
                                                      progressive=True)
    # cut short: block smoothing (the DC alone; the first AC band; all
    # but luma's last refinement; gray without its last scan)
    full = cv2_jpeg(sample_image(41, 49, seed=15), 80, "420", progressive=True)
    for keep, tag in ((range(1), "dc_only"), (range(2), "dc_and_y_ac_1_5"),
                      (range(9), "without_last_scan")):
        out[f"prog_cut_{tag}_41x49_q80.jpg"] = cut_scans(full, keep)
    gray = cv2_jpeg(sample_image(25, 38, 1, seed=16)[:, :, 0], 60, progressive=True)
    out["prog_cut_gray_without_last_scan_25x38_q60.jpg"] = cut_scans(gray, range(5))
    # four components, rebuilt from cv2's coefficients
    for progressive in (False, True):
        form = "prog" if progressive else "base"
        for tag, apps in (("cmyk_adobe0", [adobe(0)]), ("ycck_adobe2", [adobe(2)]),
                          ("cmyk_no_marker", [])):
            out[f"{form}_{tag}_444_18x26.jpg"] = four_component_file(18, 26, "444", apps,
                                                                     progressive, seed=17)
        out[f"{form}_ycck_adobe2_420_21x35.jpg"] = four_component_file(21, 35, "420", [adobe(2)],
                                                                       progressive, seed=18)
    return out


def page_pixels() -> np.ndarray:
    """chip_smoke.py's two-column 2560x1792 synthetic page (seed 22),
    tinted apart in its three channels."""
    import chip_smoke

    gray = chip_smoke.synthetic_pages(np.random.default_rng(22), 1, chip_smoke.TWO_COLUMNS)[0][0]
    gray = gray[:, :, 0].astype(np.int16)
    return np.dstack([gray, gray - 12, gray + 9]).clip(0, 255).astype(np.uint8)


def coefficients(img, quality, sampling=None):
    """(frame, height, width, coefficients, DQT bodies) of cv2's
    baseline file of ``img`` (2-D: gray)."""
    frame, height, width, coefs, segs, _ = read_coefficients(
        cv2_jpeg(img, quality, None if img.ndim == 2 else sampling))
    return frame, height, width, coefs, quant_bodies(segs)


def relabel(data: bytes, marker: int, precision=None) -> bytes:
    """``data`` with its frame header's marker (and precision) changed."""
    at = next(i for i in range(len(data) - 1)
              if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA))
    out = bytearray(data)
    out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


def codings():
    """(name -> bytes that cv2 reads, name -> bytes that cv2 returns None
    for): arithmetic-coded files (tests/jpeg_files.py, from cv2's
    coefficients), lossless files, files cut short or corrupt, and the
    codings and headers libjpeg or OpenCV gives up on."""
    out, none = {}, {}
    img = sample_image(37, 29, seed=21)
    for sampling in ("444", "422", "420", "440", "411"):
        c = coefficients(img, 90, sampling)
        out[f"arith_s{sampling}_37x29_q90.jpg"] = arithmetic_file(*c)
        out[f"arith_prog_s{sampling}_37x29_q90.jpg"] = arithmetic_file(
            *c, script=progressive_script(3))
    gray = coefficients(sample_image(20, 30, seed=22)[:, :, 0], 70)
    out["arith_gray_rst1_20x30_q70.jpg"] = arithmetic_file(*gray, restart=1)
    out["arith_prog_gray_rst2_20x30_q70.jpg"] = arithmetic_file(
        *gray, restart=2, script=progressive_script(1))
    for h, w, q in ((1, 1, 1), (1, 40, 100), (40, 1, 50), (17, 3, 10)):
        c = coefficients(sample_image(h, w, seed=h + w), q, "420")
        out[f"arith_s420_{h}x{w}_q{q}.jpg"] = arithmetic_file(*c, restart=2)
        out[f"arith_prog_s420_{h}x{w}_q{q}.jpg"] = arithmetic_file(
            *c, script=progressive_script(3), restart=1)
    dac = {("dc", 0): (2, 6), ("ac", 0): 2, ("dc", 1): (0, 0), ("ac", 1): 40}
    c = coefficients(sample_image(33, 45, seed=23), 90, "420")
    out["arith_dac_rst3_33x45_q90.jpg"] = arithmetic_file(*c, dac=dac, restart=3)
    out["arith_prog_dac_tables_33x45_q90.jpg"] = arithmetic_file(
        *c, script=progressive_script(3), dac=dac, tables=[(0, 0), (1, 9), (15, 15)],
        scan_dac={4: {("ac", 0): 12}})
    for progressive in (False, True):
        form = "prog_" if progressive else ""
        for tag, apps in (("cmyk_adobe0", [adobe(0)]), ("ycck_adobe2", [adobe(2)])):
            c = four_components(18, 26, "444", seed=24)
            out[f"arith_{form}{tag}_444_18x26.jpg"] = arithmetic_file(
                *c, apps=apps, script=progressive_script(4) if progressive else None)
    rgb = sample_image(17, 23, seed=25)
    planes = [rgb[:, :, 2], rgb[:, :, 1], rgb[:, :, 0]]
    for psv in range(1, 8):
        out[f"lossless_rgb_psv{psv}_17x23.jpg"] = lossless_file(planes, psv=psv)
    out["lossless_rgb_pt2_rst2_17x23.jpg"] = lossless_file(planes, psv=4, pt=2, restart_rows=2)
    out["lossless_rgb_scan_a_component_rst3_17x23.jpg"] = lossless_file(
        planes, psv=6, restart_rows=3, one_scan=False)
    out["lossless_rgb_6bit_adobe0_17x23.jpg"] = lossless_file(
        [p >> 2 for p in planes], psv=7, precision=6, apps=[adobe(0)])
    out["lossless_cmyk_17x23.jpg"] = lossless_file(planes + [rgb[:, :, 0] // 2], psv=5)
    # cut short and corrupt
    base = cv2_jpeg(sample_image(37, 29, seed=26), 90, "420")
    sos = base.index(b"\xff\xda")
    out["cut_half_s420_37x29_q90.jpg"] = base[:sos + (len(base) - sos) // 2]
    out["cut_after_sos_s420_37x29_q90.jpg"] = base[:sos + 14]
    out["cut_before_eoi_s420_37x29_q90.jpg"] = base[:-2]
    prog = cv2_jpeg(sample_image(37, 29, seed=26), 90, "420", progressive=True)
    out["cut_prog_mid_scan_s420_37x29_q90.jpg"] = prog[:len(prog) * 3 // 5]
    arith = out["arith_prog_s420_37x29_q90.jpg"]
    out["cut_arith_prog_s420_37x29_q90.jpg"] = arith[:len(arith) * 2 // 3]
    lossless = out["lossless_rgb_pt2_rst2_17x23.jpg"]
    out["cut_lossless_17x23.jpg"] = lossless[:len(lossless) // 2]
    flipped = bytearray(base)
    flipped[sos + 300] ^= 0x10
    out["corrupt_flipped_bit_s420_37x29_q90.jpg"] = bytes(flipped)
    eoi = len(base) - 2
    out["corrupt_extraneous_bytes_s420_37x29_q90.jpg"] = base[:eoi] + b"\x12\x34\x56" + base[eoi:]
    rst = cv2_jpeg(sample_image(33, 45, seed=27), 90, "420", restart=1)
    marks = [i for i in range(len(rst) - 1) if rst[i] == 0xFF and 0xD0 <= rst[i + 1] <= 0xD7]
    for tag, i, value in (("rst_ahead", marks[2], 0xD4), ("rst_behind", marks[5], 0xD3)):
        b = bytearray(rst)
        b[i + 1] = value
        out[f"corrupt_{tag}_s420_33x45_q90.jpg"] = bytes(b)
    out["corrupt_rst_missing_s420_33x45_q90.jpg"] = rst[:marks[3]] + rst[marks[3] + 2:]
    # cv2's None
    small = cv2_jpeg(sample_image(16, 16, seed=28), 90, "420")
    for marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        none[f"none_sof{marker - 0xC0}_16x16.jpg"] = relabel(small, marker)
    c = coefficients(sample_image(16, 16, seed=28), 90, "420")
    none["none_12bit_sof1_16x16.jpg"] = huffman_file(*c, precision=12)
    none["none_12bit_arith_16x16.jpg"] = arithmetic_file(*c, precision=12)
    small_rgb = sample_image(9, 11, seed=29)
    small_planes = [small_rgb[:, :, 2], small_rgb[:, :, 1], small_rgb[:, :, 0]]
    none["none_lossless_gray_9x11.jpg"] = lossless_file(small_planes[:1], psv=1)
    none["none_lossless_ycc_jfif_9x11.jpg"] = lossless_file(small_planes, psv=1, apps=[JFIF])
    none["none_lossless_12bit_9x11.jpg"] = lossless_file(
        [p.astype(np.int64) << 4 for p in small_planes], psv=1, precision=12)
    none["none_lossless_restart_part_row_9x11.jpg"] = lossless_file(
        small_planes, psv=1, restart_rows=1).replace(b"\xff\xdd\x00\x04\x00\x0b",
                                                     b"\xff\xdd\x00\x04\x00\x0c")
    none["none_sof11_9x11.jpg"] = relabel(lossless_file(small_planes, psv=1), 0xCB)
    height0 = bytearray(small)
    at = height0.index(b"\xff\xc0")
    height0[at + 5:at + 7] = b"\x00\x00"
    none["none_height0_dnl_16x16.jpg"] = bytes(height0)
    none["none_cut_in_header_16x16.jpg"] = small[:small.index(b"\xff\xda") - 20]
    return out, none


def full_page() -> bytes:
    """The page, progressive 4:2:0 at PAGE_QUALITY (cv2's 10 scans)."""
    return cv2_jpeg(page_pixels(), PAGE_QUALITY, "420", progressive=True)


def arithmetic_page(progressive: bytes) -> bytes:
    """The progressive page's coefficients (those of cv2's baseline file
    of the same pixels: libjpeg quantizes alike for both) re-coded
    arithmetic progressive (SOF10) with the progressive file's own 10
    scans."""
    frame, height, width, coefs, segs, _ = read_coefficients(
        cv2_jpeg(page_pixels(), PAGE_QUALITY, "420"))
    script = scan_script(progressive, [c[0] for c in frame])
    return arithmetic_file(frame, height, width, coefs, quant_bodies(segs), script=script)


def crops():
    """name -> uint8 array: the command lines' crops (three equal
    channels, BGR) and a 2-D gray one."""
    rng = np.random.default_rng(10)
    ink = cv2.GaussianBlur(rng.integers(0, 256, (32, 300), dtype=np.uint8), (0, 0), 1.5)
    bgr = cv2.GaussianBlur(rng.integers(0, 256, (32, 257, 3), dtype=np.uint8), (0, 0), 1.0)
    return {"crop_gray3_32x300.npy": np.repeat(ink[:, :, None], 3, axis=2),
            "crop_bgr_32x257.npy": bgr,
            "crop_gray_32x100.npy": rng.integers(0, 256, (32, 100), dtype=np.uint8)}


def digest(path: str) -> dict:
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def main():
    spec = {"made_with": f"OpenCV {cv2.__version__}", "decode": {}, "encode": {}, "pages": {},
            "none": []}
    for name in os.listdir(HERE):
        if name.endswith((".jpg", ".png", ".npy")):
            os.remove(os.path.join(HERE, name))
    read, none = codings()
    for name, data in {**files(), **read, **none}.items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        if name in none:
            assert cv2.imread(path, cv2.IMREAD_COLOR) is None, name
            spec["none"].append(name)
        else:
            spec["decode"][name] = digest(path)
    page = full_page()
    for name, data in ((PAGE, page), (ARITH_PAGE, arithmetic_page(page))):
        path = os.path.join(os.path.dirname(HERE), name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        spec["pages"][name] = digest(path)
    assert spec["pages"][PAGE] == spec["pages"][ARITH_PAGE]
    for name, crop in crops().items():
        np.save(os.path.join(HERE, name), crop)
        spec["encode"][name] = {
            str(q): hashlib.sha256(cv2_jpeg(crop, q)).hexdigest() for q in QUALITIES}
    with open(os.path.join(HERE, "fixtures.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
