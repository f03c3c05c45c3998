"""Recover libtiff's LogLuv (u', v') code table (tif_luv.c's ``uv_row``:
163 rows of ``{ustart, nus, ncum}``) from OpenCV's output, and print it
as the C array of ``pero_ocr_tpu_torch/csrc/tiff.cpp``.

    python3 tests/data/tiff/uv_table.py

Needs cv2.  Every 14-bit chroma code Ce goes into one SGILog24 page
(compression 34677, photometric LogLuv) at the luminance code 768 (Y
near 1); ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` decodes it through
libtiff to float XYZ and turns that into BGR with OpenCV's XYZ2BGR
matrix, which this inverts.  Each code's (u', v') = (4X, 9Y) / (X + 15Y
+ 3Z) gives its row, v' = UV_VSTART + (row + 0.5) * UV_SQSIZ, and its
row's ustart = u' - (ui + 0.5) * UV_SQSIZ, ui its place in the row; the
ustart of each row, averaged over its codes, is rounded to the six
decimals of the table's literals.  Codes from UV_NDIVS up decode to the
neutral point and end the table.  tests/test_torch_tiff.py holds the
port to cv2 on every code.
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from tests.data.tiff.make_fixtures import base_tags, write_tiff  # noqa: E402

UV_SQSIZ, UV_VSTART = float(np.float32(0.0035)), float(np.float32(0.01694))
# OpenCV's XYZ -> sRGB (D65) matrix, as cvtColor's XYZ2BGR applies it
# (rows R, G, B).
XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535], [-0.969256, 1.875991, 0.041556],
                    [0.055648, -0.204043, 1.057311]], np.float32).astype(np.float64)


def sgilog24_page(codes: np.ndarray, l10: int = 768) -> bytes:
    """A one-row SGILog24 page of the chroma codes at luminance l10."""
    p = (l10 << 14) | codes.astype(np.uint32)
    raw = np.stack([p >> 16, (p >> 8) & 255, p & 255], axis=1).astype(np.uint8).tobytes()
    return write_tiff(base_tags(1, len(codes), 16, 3, 32845, 34677, t339=(3, [2, 2, 2])), [raw])


def recover(tmp: str):
    import cv2

    codes = np.arange(1 << 14)
    with open(tmp, "wb") as f:
        f.write(sgilog24_page(codes))
    bgr = cv2.imread(tmp, cv2.IMREAD_UNCHANGED)[0].astype(np.float64)
    os.remove(tmp)
    xyz = np.linalg.solve(XYZ2RGB, bgr[:, ::-1].T).T
    den = xyz[:, 0] + 15 * xyz[:, 1] + 3 * xyz[:, 2]
    u, v = 4 * xyz[:, 0] / den, 9 * xyz[:, 1] / den
    row = np.rint((v - UV_VSTART) / UV_SQSIZ - 0.5).astype(int)
    neutral = np.abs(u - 4 / 19) + np.abs(v - 9 / 19) < 1e-5  # U_NEU, V_NEU
    ndivs = int(np.argmax(neutral & (codes > 1000)))
    table, ncum = [], 0
    for vi in range(row[:ndivs].max() + 1):
        members = np.nonzero(row[:ndivs] == vi)[0]
        assert members[0] == ncum and np.all(np.diff(members) == 1), vi
        ui = members - ncum
        ustart = float(np.round(np.mean(u[members] - (ui + 0.5) * UV_SQSIZ), 6))
        table.append((ustart, len(members), ncum))
        ncum += len(members)
    assert ncum == ndivs
    return table


def main():
    table = recover(os.path.join(HERE, "uv_table.tmp"))
    print(f"// {len(table)} rows, {table[-1][2] + table[-1][1]} codes")
    line = ""
    for ustart, nus, ncum in table:
        item = f"{{{ustart:.6f}f, {nus}, {ncum}}}, "
        if len(line) + len(item) > 92:
            print(line.rstrip())
            line = ""
        line += item
    print(line.rstrip())


if __name__ == "__main__":
    main()
