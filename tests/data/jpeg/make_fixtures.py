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
tests/test_torch_jpeg.py's entropy codec; raw crops (``.npy``) for the
encoder; one full-size 2560x1792 two-column page, progressive, in
``tests/data/page`` (chip_smoke.py's synthetic page, tinted apart in its
three channels); and ``fixtures.json``: the sha256 of
``cv2.imread(path, 1)``'s array for each file (the page's under
"pages", its path from ``tests/data``) and of ``cv2.imencode(".jpg",
crop, [IMWRITE_JPEG_QUALITY, q])``'s bytes for each crop and quality.
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

from tests.test_torch_jpeg import (  # noqa: E402
    JFIF, adobe, cut_scans, cv2_jpeg, four_component_file, rebuilt, sample_image,
)

PAGE = "page/two_columns_progressive_2560x1792_q85.jpg"  # from tests/data
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


def full_page() -> bytes:
    """chip_smoke.py's two-column 2560x1792 synthetic page (seed 22),
    tinted apart in its three channels, progressive 4:2:0."""
    import chip_smoke

    gray = chip_smoke.synthetic_pages(np.random.default_rng(22), 1, chip_smoke.TWO_COLUMNS)[0][0]
    gray = gray[:, :, 0].astype(np.int16)
    page = np.dstack([gray, gray - 12, gray + 9]).clip(0, 255).astype(np.uint8)
    return cv2_jpeg(page, PAGE_QUALITY, "420", progressive=True)


def crops():
    """name -> uint8 array: the command lines' crops (three equal
    channels, BGR) and a 2-D gray one."""
    rng = np.random.default_rng(10)
    ink = cv2.GaussianBlur(rng.integers(0, 256, (32, 300), dtype=np.uint8), (0, 0), 1.5)
    bgr = cv2.GaussianBlur(rng.integers(0, 256, (32, 257, 3), dtype=np.uint8), (0, 0), 1.0)
    return {"crop_gray3_32x300.npy": np.repeat(ink[:, :, None], 3, axis=2),
            "crop_bgr_32x257.npy": bgr,
            "crop_gray_32x100.npy": rng.integers(0, 256, (32, 100), dtype=np.uint8)}


def main():
    spec = {"made_with": f"OpenCV {cv2.__version__}", "decode": {}, "encode": {}, "pages": {}}
    for name in os.listdir(HERE):
        if name.endswith((".jpg", ".png", ".npy")):
            os.remove(os.path.join(HERE, name))
    for name, data in files().items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        spec["decode"][name] = {"shape": list(img.shape),
                                "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    path = os.path.join(os.path.dirname(HERE), PAGE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(full_page())
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    spec["pages"][PAGE] = {"shape": list(img.shape),
                           "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    for name, crop in crops().items():
        np.save(os.path.join(HERE, name), crop)
        spec["encode"][name] = {
            str(q): hashlib.sha256(cv2_jpeg(crop, q)).hexdigest() for q in QUALITIES}
    with open(os.path.join(HERE, "fixtures.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
