"""Write the BMP and PAM fixtures of this folder and their digests.

    python3 tests/data/bmp/make_fixtures.py

Needs cv2 (OpenCV 5) and runs where the tests run, never on the card's
machine.  The files are written with ``struct`` (tests/bmp_pam_files.py):
BMP with every header (OS/2, BITMAPINFOHEADER, V4, V5) and pixel format
(1-, 4- and 8-bit palettes, 16-bit 5-5-5 and 5-6-5, 24 and 32 bits, RLE8
and RLE4 with their escapes, top-down rows), PAM of every tuple type at
8 and 16 bits and as packed bits; ``fixtures.json`` holds the sha256 of
``cv2.imread(path, cv2.IMREAD_COLOR)``'s array for each file that cv2
reads, and lists those it returns None for.  The alpha PAM types are
left out: cv2 5.0.0 leaves most of their output rows unwritten.
tests/test_torch_bmp_pam.py holds the port's readers to the JSON on the
CPU, ``chip_smoke.check_jpeg_fixtures`` on the card's machine.
"""

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

import cv2  # noqa: E402
import numpy as np  # noqa: E402

from tests.bmp_pam_files import (  # noqa: E402
    BI_BITFIELDS, BI_RLE4, BI_RLE8, MASKS_555, MASKS_565, bmp_file, bmp_rows, pam_body, pam_file,
    rle_rows, rle_stream,
)


def picture(h, w, c, seed):
    """Gradients and noise in each channel."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 11 + y * 7)[:, :, None] + np.arange(c) * 50
    return ((base + rng.integers(0, 40, (h, w, c))) % 256).astype(np.int64)


def files():
    """name -> bytes."""
    out = {}
    rng = np.random.default_rng(22)
    for bpp in (1, 4, 8):
        n = 1 << bpp
        index = picture(19, 23, 1, bpp)[:, :, 0] % n
        palette = rng.integers(0, 256, (n, 3))
        for header in (12, 40, 108, 124):
            out[f"pal{bpp}_h{header}_23x19.bmp"] = bmp_file(23, 19, bpp, bmp_rows(index, bpp),
                                                            palette=palette, header=header)
        out[f"pal{bpp}_topdown_23x19.bmp"] = bmp_file(23, 19, bpp, bmp_rows(index, bpp),
                                                      palette=palette, top_down=True)
    out["pal8_short_palette_23x19.bmp"] = bmp_file(
        23, 19, 8, bmp_rows(picture(19, 23, 1, 3)[:, :, 0], 8), palette=palette[:40], clrused=40)
    words = picture(17, 21, 2, 4)
    words = words[:, :, 0] | (words[:, :, 1] << 8)
    out["rgb16_21x17.bmp"] = bmp_file(21, 17, 16, bmp_rows(words, 16))
    out["bitfields555_21x17.bmp"] = bmp_file(21, 17, 16, bmp_rows(words, 16),
                                             compression=BI_BITFIELDS, masks=MASKS_555)
    out["bitfields565_21x17.bmp"] = bmp_file(21, 17, 16, bmp_rows(words, 16),
                                             compression=BI_BITFIELDS, masks=MASKS_565,
                                             top_down=True)
    bgr = picture(15, 22, 3, 5)
    out["bgr24_22x15.bmp"] = bmp_file(22, 15, 24, bmp_rows(bgr, 24))
    out["bgr24_os2_22x15.bmp"] = bmp_file(22, 15, 24, bmp_rows(bgr, 24), header=12)
    out["bgr24_v5_topdown_22x15.bmp"] = bmp_file(22, 15, 24, bmp_rows(bgr, 24), header=124,
                                                 top_down=True)
    bgra = picture(15, 22, 4, 6)
    out["bgra32_22x15.bmp"] = bmp_file(22, 15, 32, bmp_rows(bgra, 32))
    out["bitfields32_22x15.bmp"] = bmp_file(22, 15, 32, bmp_rows(bgra, 32),
                                            compression=BI_BITFIELDS,
                                            masks=(0xFF0000, 0xFF00, 0xFF))
    index8 = picture(18, 25, 1, 7)[:, :, 0] // 40
    out["rle8_25x18.bmp"] = bmp_file(25, 18, 8, rle_rows(index8, rng, 8), compression=BI_RLE8,
                                     palette=rng.integers(0, 256, (256, 3)))
    index4 = picture(18, 25, 1, 8)[:, :, 0] // 64
    out["rle4_25x18.bmp"] = bmp_file(25, 18, 4, rle_rows(index4, rng, 4), compression=BI_RLE4,
                                     palette=rng.integers(0, 256, (16, 3)))
    escapes = rle_stream([("run", 5, 3), ("delta", 2, 1), ("run", 4, 7), ("eol",), ("eol",),
                          ("abs", [1, 2, 3, 4, 5], 5), ("run", 7, 9), ("eob",)])
    out["rle8_escapes_12x6.bmp"] = bmp_file(12, 6, 8, escapes, compression=BI_RLE8,
                                            palette=rng.integers(0, 256, (256, 3)))
    escapes4 = rle_stream([("run", 5, 0x3A), ("delta", 2, 1), ("run", 4, 0x71), ("eol",),
                           ("abs", [0x12, 0x34, 0x50], 5), ("eob",), ("run", 12, 0x22)]
                          + [("eol",)] * 6)
    out["rle4_escapes_12x6.bmp"] = bmp_file(12, 6, 4, escapes4, compression=BI_RLE4,
                                            palette=rng.integers(0, 256, (16, 3)))
    for tuple_type, depth in (("BLACKANDWHITE", 1), ("GRAYSCALE", 1), ("RGB", 3), (None, 3)):
        for maxval in ((1,) if tuple_type == "BLACKANDWHITE" else (255, 4095) if tuple_type
                       else (200,)):
            samples = picture(13, 18, depth, depth + maxval) * (maxval + 1) // 256
            name = f"{(tuple_type or 'notuple').lower()}_{maxval}_18x13.pam"
            out[name] = pam_file(18, 13, depth, maxval, pam_body(samples, maxval), tuple_type,
                                 comment=maxval == 255)
    return out


def none_files():
    """name -> bytes of files cv2 returns None for."""
    rows = bmp_rows(picture(5, 6, 2, 9)[:, :, 0], 16)
    full = bmp_file(6, 5, 24, bmp_rows(picture(5, 6, 3, 10), 24))
    return {"bitfields_other_masks.bmp": bmp_file(6, 5, 16, rows, compression=BI_BITFIELDS,
                                                  masks=(0xF00, 0xF0, 0xF)),
            "truncated.bmp": full[:-4],
            "rle8_run_past_row.bmp": bmp_file(4, 2, 8, rle_stream([("run", 5, 1), ("eob",)]),
                                              compression=BI_RLE8,
                                              palette=np.zeros((256, 3))),
            "pam_16bit_notuple.pam": pam_file(3, 2, 3, 1000, bytes(36)),
            "pam_depth_not_tuple.pam": pam_file(3, 2, 1, 255, bytes(6), "RGB")}


def main():
    spec = {"made_with": f"OpenCV {cv2.__version__}", "decode": {}, "none": []}
    for name in os.listdir(HERE):
        if name.endswith((".bmp", ".pam")):
            os.remove(os.path.join(HERE, name))
    for name, data in files().items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        spec["decode"][name] = {"shape": list(img.shape),
                                "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    for name, data in none_files().items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        assert cv2.imread(path, cv2.IMREAD_COLOR) is None, name
        spec["none"].append(name)
    with open(os.path.join(HERE, "fixtures.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
