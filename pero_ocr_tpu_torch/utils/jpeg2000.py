"""JPEG 2000 pages as ``cv2.imread(path, cv2.IMREAD_COLOR)`` reads them in
OpenCV 5 (OpenJPEG 2.5), bit for bit: :func:`decode_jpeg2000` (through
:func:`pero_ocr_tpu_torch.utils.image_io.imread`).

JP2 files (the 12-byte signature box) and raw codestreams (``FF 4F FF
51``) are told apart by their first bytes, as OpenCV tells them apart.
The codestream is decoded by the host C++ of ``csrc/jpeg2000.cpp``
(5/3 and 9/7 wavelets, every progression order, tiles and tile-parts,
precincts, layers, the code-block styles, SOP/EPH, POC and RGN; see
there); this module reads the JP2 boxes and turns the components into
BGR as OpenJPEG's ``jp2.c`` and OpenCV's
``grfmt_jpeg2000_openjpeg.cpp`` turn them:

- the colour space is the first ``colr`` box's: EnumCS 16 sRGB, 17 gray,
  18 sYCC, 12 CMYK, 24 e-sYCC; any other EnumCS, an ICC profile, no
  ``colr`` box and a raw codestream are "unknown", which OpenCV reads
  as sRGB;
- a ``pclr`` palette with its ``cmap`` maps the index component through
  the palette (indexes clamped to the palette), then ``cdef`` reorders
  the channels and marks alpha as ``opj_jp2_apply_cdef`` does;
- samples of more than 8 bits are shifted down by the largest
  codestream precision less 8, and every sample is then cast to 8 bits
  (its low byte);
- sRGB takes components 2, 1, 0 as B, G, R (a fourth, alpha, is
  dropped); gray repeats component 0; sYCC takes components 0, 1, 2 as
  Y, U, V through ``cv2.cvtColor(..., COLOR_YUV2BGR)``'s integer rule.

Where OpenCV returns None, :func:`decode_jpeg2000` raises
:func:`~pero_ocr_tpu_torch.utils.tiff.unreadable` ("Unable to read
image"): one or two components in an sRGB or unknown colour space (a
gray codestream without a JP2 ``colr`` box), CMYK and e-sYCC, more
than 4 components, signed samples, a precision under 8 bits, a nonzero
image offset or subsampled components (OpenCV: "tiles are not
supported"), and a truncated or corrupt file (a page is read whole or
not at all).  What the decoder does not read (packed packet headers
PPM/PPT, HTJ2K, Part 2) raises ``not_read``.  :data:`calls` counts the
C functions' calls.
"""

from __future__ import annotations

import collections
import ctypes
import struct
from typing import List, Optional, Tuple

import numpy as np

from pero_ocr_tpu_torch import not_read
from pero_ocr_tpu_torch.utils import kernels
from pero_ocr_tpu_torch.utils.tiff import unreadable

calls = collections.Counter()  # C function name -> calls through these bindings

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"

_ERR = 512
_MAX_COMPONENTS = 16384
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {  # name: (restype, argtypes), as in csrc/jpeg2000.cpp
    "j2k_header": (_I32, [_U8P, _I64, ctypes.POINTER(_I64), _I64, ctypes.c_char_p, _I32]),
    "j2k_decode": (_I32, [_U8P, _I64, ctypes.POINTER(_I32), _I64, ctypes.POINTER(_I64),
                          ctypes.c_char_p, _I32]),
}

# The decoder's feature bits (csrc/jpeg2000.cpp's Feature), by name
FEATURES = {name: 1 << i for i, name in enumerate((
    "BYPASS", "RESET", "TERMALL", "VSC", "PTERM", "SEGSYM", "SOP", "EPH", "POC", "RGN",
    "tile-parts", "TLM", "PLM", "PLT", "COC", "QCC", "precincts", "layers", "9/7 wavelet",
    "component transform", "tiles", "Psot 0", "COM", "CRG"))}

# Colour spaces (opj_jp2_decode's EnumCS mapping)
SRGB, GRAY, SYCC, EYCC, CMYK, UNKNOWN = "sRGB", "gray", "sYCC", "e-sYCC", "CMYK", "unknown"
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}


def is_jpeg2000(data: bytes) -> bool:
    return data[:12] == JP2_SIGNATURE or data[:4] == J2K_SIGNATURE


def get_library() -> ctypes.CDLL:
    """The decoder's library, built on first use, its functions declared."""
    lib = kernels.library("jpeg2000")
    if lib.j2k_header.argtypes is None:
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def _buffer(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), _U8P)


def _failed(rc: int, err, path: str) -> ValueError:
    what = err.value.decode(errors="replace")
    if rc == 2:
        return not_read(path, f"a JPEG 2000 file with {what}")
    return unreadable(path, f"JPEG 2000 data OpenJPEG rejects ({what})")


class Header:
    """The SIZ facts of a codestream: the image area on the reference
    grid and each component's (dx, dy, precision, signed)."""

    def __init__(self, codestream: bytes, path: str):
        lib = get_library()
        calls["j2k_header"] += 1
        n = 8 + 4 * _MAX_COMPONENTS
        out = (_I64 * n)()
        err = ctypes.create_string_buffer(_ERR)
        rc = lib.j2k_header(_buffer(codestream), len(codestream), out, n, err, _ERR)
        if rc != 0:
            raise _failed(rc, err, path)
        self.x0, self.y0, self.x1, self.y1, ncomp = (int(v) for v in out[:5])
        self.comps = [tuple(int(v) for v in out[8 + 4 * c:12 + 4 * c]) for c in range(ncomp)]

    def size(self, c: int) -> Tuple[int, int]:
        """(height, width) of component ``c``."""
        dx, dy = self.comps[c][:2]
        return (-(-self.y1 // dy) - -(-self.y0 // dy), -(-self.x1 // dx) - -(-self.x0 // dx))


def decode_codestream(codestream: bytes, path: str = "<j2k>",
                      header: Optional[Header] = None) -> Tuple[Header, List[np.ndarray], int]:
    """A codestream -> (its header, one int32 (h, w) plane per component
    as OpenJPEG gives them, the bits of the features met).  ``header``,
    where the caller has read it already, is not read again."""
    if header is None:
        header = Header(codestream, path)
    sizes = [header.size(c) for c in range(len(header.comps))]
    total = sum(h * w for h, w in sizes)
    out = np.empty(total, np.int32)
    features = (_I64 * 1)()
    err = ctypes.create_string_buffer(_ERR)
    lib = get_library()
    calls["j2k_decode"] += 1
    rc = lib.j2k_decode(_buffer(codestream), len(codestream), out.ctypes.data_as(ctypes.POINTER(_I32)),
                        total, features, err, _ERR)
    if rc != 0:
        raise _failed(rc, err, path)
    planes, offset = [], 0
    for h, w in sizes:
        planes.append(out[offset:offset + h * w].reshape(h, w))
        offset += h * w
    return header, planes, int(features[0])


# ----------------------------------------------------------------------
# JP2 boxes
class Boxes:
    """What OpenJPEG's jp2.c reads of a JP2 file: the first ``colr``
    box's colour space, ``pclr``, ``cmap`` and ``cdef``, and the
    ``jp2c`` codestream."""

    def __init__(self, data: bytes, path: str):
        self.colour: str = UNKNOWN
        self.palette: Optional[np.ndarray] = None  # (entries, channels)
        self.cmap: Optional[List[Tuple[int, int, int]]] = None  # (cmp, mtyp, pcol)
        self.cdef: Optional[List[Tuple[int, int, int]]] = None  # (cn, typ, asoc)
        self.codestream: Optional[bytes] = None
        has_colr = has_header = False
        boxes = list(_boxes(data, 0, len(data), path))
        if len(boxes) < 2 or boxes[0][0] != b"jP  " or boxes[1][0] != b"ftyp":
            raise unreadable(path, "a JP2 file without its signature and ftyp boxes")
        for kind, start, end in boxes[2:]:
            if kind == b"jp2h":
                has_ihdr = False
                for sub, s, e in _boxes(data, start, end, path):
                    if sub == b"ihdr":
                        has_ihdr = True
                    elif sub == b"colr" and not has_colr:
                        has_colr = True
                        if e - s < 3:
                            raise unreadable(path, "a short colr box")
                        meth = data[s]
                        if meth == 1:
                            if e - s < 7:
                                raise unreadable(path, "a short colr box")
                            (enumcs,) = struct.unpack(">I", data[s + 3:s + 7])
                            self.colour = _ENUMCS.get(enumcs, UNKNOWN)
                        elif meth > 2:
                            has_colr = False  # ignored entirely (OpenJPEG)
                    elif sub == b"pclr":
                        self.palette = _pclr(data[s:e], path)
                    elif sub == b"cmap":
                        if self.palette is None:
                            raise unreadable(path, "a cmap box before its pclr box")
                        n = self.palette.shape[1]
                        if e - s < 4 * n:
                            raise unreadable(path, "a cmap box shorter than its palette")
                        self.cmap = [list(struct.unpack(">HBB", data[s + 4 * i:s + 4 * i + 4]))
                                     for i in range(n)]
                    elif sub == b"cdef":
                        if e - s < 2:
                            raise unreadable(path, "a short cdef box")
                        (n,) = struct.unpack(">H", data[s:s + 2])
                        if e - s != 2 + 6 * n:
                            raise unreadable(path, "a cdef box of the wrong length")
                        self.cdef = [struct.unpack(">HHH", data[s + 2 + 6 * i:s + 8 + 6 * i]) for i in range(n)]
                if not has_ihdr:
                    raise unreadable(path, "a jp2h box without ihdr")
                has_header = True
            elif kind == b"jp2c":
                if not has_header:
                    raise unreadable(path, "a jp2c box before the jp2h box")
                self.codestream = data[start:end]
                break
        if self.codestream is None:
            raise unreadable(path, "a JP2 file without a codestream")


def _boxes(data: bytes, start: int, end: int, path: str):
    """(type, payload start, payload end) of the boxes in data[start:end];
    the last box may run past the end of a cut file."""
    pos = start
    while pos + 8 <= end:
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if length == 1:
            if pos + 16 > end:
                raise unreadable(path, "a cut JP2 box header")
            (length,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif length == 0:
            length = end - pos
        if length < head:
            raise unreadable(path, "a JP2 box shorter than its header")
        yield kind, pos + head, min(pos + length, end)
        pos += length


def _pclr(payload: bytes, path: str):
    if len(payload) < 3:
        raise unreadable(path, "a short pclr box")
    entries, channels = struct.unpack(">HB", payload[:3])
    if entries == 0 or entries > 1024 or channels == 0:
        raise unreadable(path, "a pclr box out of range")
    sizes = [(b & 0x7F) + 1 for b in payload[3:3 + channels]]
    if len(sizes) < channels or max(sizes) > 38:
        raise unreadable(path, "a short pclr box")
    table = np.zeros((entries, channels), np.int64)
    pos = 3 + channels
    for j in range(entries):
        for i, size in enumerate(sizes):
            nbytes = (size + 7) // 8
            if pos + nbytes > len(payload):
                raise unreadable(path, "a short pclr box")
            table[j, i] = int.from_bytes(payload[pos:pos + nbytes], "big")
            pos += nbytes
    return table


def _check_colour(boxes: Boxes, ncomp: int, path: str) -> None:
    """opj_jp2_check_color: a cdef or cmap that does not fit the
    components fails the decode (a one-component cmap that maps no
    palette column is repaired to map each, as OpenJPEG repairs it)."""
    mapped = boxes.palette is not None and boxes.cmap is not None
    channels = boxes.palette.shape[1] if mapped else ncomp
    if boxes.cdef is not None:
        for cn, _, asoc in boxes.cdef:
            if cn >= channels or (asoc not in (0, 65535) and asoc - 1 >= channels):
                raise unreadable(path, "a cdef box naming a channel that does not exist")
        if set(range(channels)) - {cn for cn, _, _ in boxes.cdef}:
            raise unreadable(path, "a cdef box without every channel")
    if not mapped:
        return
    used = [False] * channels
    for i, (cmp, mtyp, pcol) in enumerate(boxes.cmap):
        if (cmp >= ncomp or mtyp > 1 or pcol >= channels or (used[pcol] and mtyp == 1)
                or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i)):
            raise unreadable(path, "a cmap entry OpenJPEG rejects")
        used[pcol] = True
    if any(not used[i] and mtyp != 0 for i, (_, mtyp, _) in enumerate(boxes.cmap)):
        raise unreadable(path, "a palette column without a mapping")
    if ncomp == 1 and not all(used):
        for i, entry in enumerate(boxes.cmap):
            entry[1:] = [1, i]


def _apply_palette(planes: List[np.ndarray], boxes: Boxes) -> List[np.ndarray]:
    """opj_jp2_apply_pclr (only with a cmap box; a pclr alone is dropped)."""
    if boxes.palette is None or boxes.cmap is None:
        return planes
    table = boxes.palette
    out = []
    for i, (cmp, mtyp, pcol) in enumerate(boxes.cmap):
        src = planes[cmp]
        if mtyp == 0:
            out.append(src.copy())
        else:
            k = np.clip(src, 0, table.shape[0] - 1)
            out.append(table[k, pcol].astype(np.int64))
    return out


def _apply_cdef(planes: List[np.ndarray], cdef: List[Tuple[int, int, int]]) -> List[np.ndarray]:
    """opj_jp2_apply_cdef: colour channels are swapped into their
    association's place, in the box's order."""
    planes = list(planes)
    info = [list(i) for i in cdef]
    for i, (cn, typ, asoc) in enumerate(info):
        if cn >= len(planes) or asoc in (0, 65535):
            continue
        acn = asoc - 1
        if acn >= len(planes):
            continue
        if cn != acn and typ == 0:
            planes[cn], planes[acn] = planes[acn], planes[cn]
            for later in info[i + 1:]:
                if later[0] == cn:
                    later[0] = acn
                elif later[0] == acn:
                    later[0] = cn
    return planes


def yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(np.dstack([y, u, v]), cv2.COLOR_YUV2BGR)`` for uint8
    planes: OpenCV's 14-bit integer coefficients, rounded and saturated."""
    y = y.astype(np.int32)
    u = u.astype(np.int32) - 128
    v = v.astype(np.int32) - 128
    b = y + ((u * 33292 + 8192) >> 14)
    g = y + ((u * -6472 + v * -9519 + 8192) >> 14)
    r = y + ((v * 18678 + 8192) >> 14)
    return np.clip(np.dstack([b, g, r]), 0, 255).astype(np.uint8)


def decode_jpeg2000(data: bytes, path: str = "<jpeg2000>") -> np.ndarray:
    """A JP2 file's or raw codestream's bytes -> BGR uint8 (H, W, 3), as
    ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns it."""
    if data[:12] == JP2_SIGNATURE:
        boxes = Boxes(data, path)
    elif data[:4] == J2K_SIGNATURE:
        boxes = None
    else:
        raise ValueError(f"{path}: not a JPEG 2000 file")
    codestream = boxes.codestream if boxes else data
    # OpenCV's readHeader, on the codestream's components
    header = Header(codestream, path)
    ncomp = len(header.comps)
    if ncomp > 4:
        raise unreadable(path, f"a JPEG 2000 file of {ncomp} components")
    if any(sgnd for _, _, _, sgnd in header.comps):
        raise unreadable(path, "signed JPEG 2000 samples")
    maxprec = max(prec for _, _, prec, _ in header.comps)
    if maxprec < 8:
        raise unreadable(path, f"JPEG 2000 samples of {maxprec} bits")
    _, planes, _ = decode_codestream(codestream, path, header)
    colour = boxes.colour if boxes else UNKNOWN
    if boxes:
        _check_colour(boxes, ncomp, path)
        planes = _apply_palette(planes, boxes)
        if boxes.cdef is not None:
            planes = _apply_cdef(planes, boxes.cdef)
    # OpenCV's readData
    if colour in (CMYK, EYCC):
        raise unreadable(path, f"the {colour} colour space")
    if colour in (SRGB, UNKNOWN, SYCC) and len(planes) < 3:
        raise unreadable(path, f"{len(planes)} components in the {colour} colour space")
    if header.x0 or header.y0:
        raise unreadable(path, "a JPEG 2000 image offset (OpenCV: tiles are not supported)")
    for c in range(ncomp):
        if header.comps[c][:2] != (1, 1):
            raise unreadable(path, "subsampled JPEG 2000 components (OpenCV: tiles are not supported)")
    shift = max(maxprec - 8, 0)

    def eight(plane: np.ndarray) -> np.ndarray:
        return ((plane.astype(np.int64) >> shift) & 0xFF).astype(np.uint8)

    if colour == GRAY:
        g = eight(planes[0])
        out = np.dstack([g, g, g])
    elif colour == SYCC:
        out = yuv_to_bgr(eight(planes[0]), eight(planes[1]), eight(planes[2]))
    else:
        out = np.dstack([eight(planes[2]), eight(planes[1]), eight(planes[0])])
    return out
