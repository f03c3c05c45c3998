"""ctypes bindings of the port's JPEG codec (``csrc/jpeg.cpp``), in the
manner of :mod:`pero_ocr_tpu_torch.utils.native`: the library is built
with the host compiler on first use
(:mod:`pero_ocr_tpu_torch.utils.kernels`), and a missing compiler or a
failed build raises.  Nothing falls back to Python or to another
library.

:func:`decode_jpeg` is ``cv2.imread(path, cv2.IMREAD_COLOR)`` of a JPEG
file before the EXIF orientation (which
:mod:`pero_ocr_tpu_torch.utils.image_io` applies for JPEG and PNG
alike), bit for bit what OpenCV 5's libjpeg-turbo gives, for every JPEG
file OpenCV reads: sequential and progressive, Huffman or arithmetic
coded, and lossless (Huffman, 2 to 8 bits, RGB or CMYK); one, three or
four components (CMYK or YCCK, turned into BGR as OpenCV turns them);
progressive files that stop short of full precision smoothed as libjpeg
smooths them; files cut short or corrupt read as libjpeg reads them
(grey past the cut of a one-scan file, bytes before a marker skipped,
lost restart markers resynchronized).  Where cv2 returns None
(hierarchical or arithmetic lossless coding, other sample precisions,
gray or YCbCr lossless files, two components, broken headers, a file of
several scans broken before its EOI) it raises
:func:`pero_ocr_tpu_torch.unreadable`'s "Unable to read image"
``ValueError``.  :func:`encode_jpeg` is ``cv2.imencode(".jpg", img,
[cv2.IMWRITE_JPEG_QUALITY, quality])``.  :data:`calls` counts each C
function's calls.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import numpy as np

from pero_ocr_tpu_torch import unreadable
from pero_ocr_tpu_torch.utils import kernels

calls = collections.Counter()  # C function name -> calls through these bindings

_ERR = 512
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {  # name: (restype, argtypes), as in csrc/jpeg.cpp
    "jpeg_header": (_I32, [_U8P, _I64, ctypes.POINTER(_I64), ctypes.c_char_p, _I32]),
    "jpeg_decode_bgr": (_I32, [_U8P, _I64, _U8P, _I32, _I32, ctypes.c_char_p, _I32]),
    "jpeg_decode_components": (_I32, [_U8P, _I64, _U8P, _I32, _I32, _I32, ctypes.c_char_p, _I32]),
    "jpeg_encode": (_I64, [_U8P, _I32, _I32, _I32, _I32, _U8P, _I64, ctypes.c_char_p, _I32]),
}


def get_library() -> ctypes.CDLL:
    """The codec's library, built on first use, its functions declared."""
    lib = kernels.library("jpeg")
    if lib.jpeg_header.argtypes is None:
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def _buffer(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), _U8P)


def jpeg_header(data: bytes, path: str = "<jpeg>") -> Tuple[int, int, int, Optional[bytes]]:
    """(height, width, components, the EXIF TIFF block or None) of a JPEG
    file: the block is the data of the first APP1 segment before the
    first scan that starts with ``Exif\\0\\0``, after those 6 bytes."""
    lib = get_library()
    calls["jpeg_header"] += 1
    out = (_I64 * 5)()
    err = ctypes.create_string_buffer(_ERR)
    if lib.jpeg_header(_buffer(data), len(data), out, err, _ERR) != 0:
        raise unreadable(path, f"this JPEG file ({err.value.decode()})")
    exif = data[out[3]:out[3] + out[4]] if out[3] >= 0 else None
    return int(out[0]), int(out[1]), int(out[2]), exif


def decode_jpeg(data: bytes, path: str = "<jpeg>") -> np.ndarray:
    """A JPEG file's bytes -> BGR uint8 (H, W, 3), EXIF orientation not
    applied.  Raises "Unable to read image" where cv2 returns None."""
    height, width, _, _ = jpeg_header(data, path)
    lib = get_library()
    calls["jpeg_decode_bgr"] += 1
    out = np.empty((height, width, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    rc = lib.jpeg_decode_bgr(_buffer(data), len(data), out.ctypes.data_as(_U8P), height, width,
                             err, _ERR)
    if rc < 0:
        raise unreadable(path, f"this JPEG file ({err.value.decode()})")
    return out


def decode_jpeg_components(data: bytes, path: str = "<jpeg>") -> np.ndarray:
    """A JPEG stream's components as libjpeg outputs them without colour
    conversion (libtiff's JCS_UNKNOWN): uint8 (H, W, components).  Data
    cut short or corrupt reads as libjpeg reads it; raises "Unable to
    read image" where libjpeg fails."""
    height, width, comps, _ = jpeg_header(data, path)
    lib = get_library()
    calls["jpeg_decode_components"] += 1
    out = np.empty((height, width, comps), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if lib.jpeg_decode_components(_buffer(data), len(data), out.ctypes.data_as(_U8P), height,
                                  width, comps, err, _ERR) < 0:
        raise unreadable(path, f"this JPEG stream ({err.value.decode()})")
    return out


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """``cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])``
    for an (h, w, 3) BGR or (h, w) gray uint8 image: 4:2:0 YCbCr or one
    component, libjpeg's standard tables scaled to ``quality`` (1-100)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (1, 3))):
        raise ValueError(f"encode_jpeg: a (h, w, 3) or (h, w) uint8 image, not {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    # At most ~410 bytes a block of 64 samples (every coefficient
    # coded, every byte stuffed) over the MCU-padded planes.
    cap = 8 * (h + 16) * (w + 16) * c + 4096
    out = np.empty(cap, np.uint8)
    lib = get_library()
    calls["jpeg_encode"] += 1
    err = ctypes.create_string_buffer(_ERR)
    n = lib.jpeg_encode(img.ctypes.data_as(_U8P), h, w, c, int(quality),
                        out.ctypes.data_as(_U8P), cap, err, _ERR)
    if n < 0:
        raise ValueError(f"encode_jpeg: {err.value.decode()}")
    return out[:n].tobytes()
