"""Write the JPEG fixtures of this folder and their digests.

    python3 tests/data/jpeg/make_fixtures.py

Needs cv2 (OpenCV 5, libjpeg-turbo 3.1) and runs where the tests run,
never on the card's machine.  It writes small JPEG (and two PNG) files
made with cv2: every sampling cv2 writes, gray, restart intervals, odd
sizes, the 8 EXIF orientations, a file of one scan a component and an
Adobe RGB file (rebuilt from cv2's coefficients by
tests/test_torch_jpeg.py's entropy codec); raw crops (``.npy``) for the
encoder; and ``fixtures.json``: the sha256 of ``cv2.imread(path, 1)``'s
array for each file and of ``cv2.imencode(".jpg", crop,
[IMWRITE_JPEG_QUALITY, q])``'s bytes for each crop and quality.
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

from tests.test_torch_jpeg import JFIF, adobe, cv2_jpeg, rebuilt, sample_image  # noqa: E402

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
    return out


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
    spec = {"made_with": f"OpenCV {cv2.__version__}", "decode": {}, "encode": {}}
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
    for name, crop in crops().items():
        np.save(os.path.join(HERE, name), crop)
        spec["encode"][name] = {
            str(q): hashlib.sha256(cv2_jpeg(crop, q)).hexdigest() for q in QUALITIES}
    with open(os.path.join(HERE, "fixtures.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
