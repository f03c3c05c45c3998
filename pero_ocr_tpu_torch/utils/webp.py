"""WebP pages as ``cv2.imread(path, cv2.IMREAD_COLOR)`` reads them in
OpenCV 5 (libwebp), bit for bit: :func:`decode_webp` (through
:func:`pero_ocr_tpu_torch.utils.image_io.imread`).

The bitstreams are decoded by the host C++ of ``csrc/webp.cpp``: VP8L
(lossless), VP8 (lossy key frames) with its ALPH chunk, and the "fancy"
4:2:0 upsampling into BGR.  This module reads the RIFF container as
libwebp and OpenCV read it:

- OpenCV's signature test is ``WebPGetFeatures`` on the first 32 bytes
  (a shorter file is not WebP to it, and reads as None), and it reads no
  file over 64 MiB;
- a still image (no animation flag in ``VP8X``) is decoded as
  ``WebPDecode`` decodes the whole file (:func:`parse_headers` with all
  the data): the RIFF size must not pass the end of the file (bytes
  after it are ignored), ``VP8X`` must be 10 bytes and its canvas the
  bitstream's size, the chunks before the bitstream (``ICCP``, unknown
  ones, ``ALPH``: the last one is the alpha) must fit the RIFF size, and
  a VP8L or VP8 bitstream may read on to the end of the file;
- an animation (the ``VP8X`` animation flag) is read as
  ``WebPAnimDecoder`` reads its first frame: the whole file must pass
  libwebp's demuxer (:class:`Demux`), the canvas starts as zeros, its
  ``ANIM`` background colour is ignored, and the first frame is decoded
  from its own chunks and put at twice its ``ANMF`` offset (blending
  and disposal do not touch a first frame); the alpha is dropped;
- the orientation is the first ``EXIF`` chunk's, where the file passes
  the demuxer and ``VP8X`` has its EXIF flag (an ``Exif\\0\\0`` prefix
  is not read), as OpenCV 5 reads it.

Where OpenCV returns None, :func:`decode_webp` raises
:func:`~pero_ocr_tpu_torch.utils.tiff.unreadable` ("Unable to read
image"): a page is read whole or not at all.  :data:`calls` counts the C
functions' calls.
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from pero_ocr_tpu_torch.utils import kernels
from pero_ocr_tpu_torch.utils.tiff import unreadable

calls = collections.Counter()  # C function name -> calls through these bindings

HEADER_SIZE = 32  # OpenCV's WEBP_HEADER_SIZE: the bytes its signature test reads
MAX_FILE_SIZE = 64 * 1024 * 1024  # OpenCV's OPENCV_IMGCODECS_WEBP_MAX_FILE_SIZE
MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
MAX_IMAGE_SIDE, MAX_IMAGE_PIXELS = 1 << 20, 1 << 30  # OpenCV's CV_IO_MAX_IMAGE_WIDTH/HEIGHT/PIXELS
ANIMATION_FLAG, EXIF_FLAG = 0x02, 0x08
ALL_VALID_FLAGS = 0x3E  # alpha, animation, EXIF, XMP and ICC profile

_ERR = 256
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {  # name: (restype, argtypes), as in csrc/webp.cpp
    "webp_decode_vp8l": (_I32, [_U8P, _I64, _I32, _I32, _U8P, _U8P, _U64P, ctypes.c_char_p, _I32]),
    "webp_decode_vp8": (_I32, [_U8P, _I64, _U8P, _I64, _I32, _I32, _U8P, _U8P, _U64P, ctypes.c_char_p, _I32]),
}

# The decoder's feature bits (csrc/webp.cpp's Feature), by name
FEATURES = {name: 1 << i for i, name in enumerate((
    "predictor", "cross-colour", "subtract-green", "colour indexing", "2 pixels a byte",
    "4 pixels a byte", "8 pixels a byte", "colour cache", "meta prefix codes", "LZ77",
    "simple prefix code", "raw ALPH", "lossless ALPH", "horizontal alpha filter",
    "vertical alpha filter", "gradient alpha filter", "alpha pre-processing", "simple loop filter",
    "normal loop filter", "no loop filter", "2 partitions", "4 partitions", "8 partitions",
    "segment map", "segments without a map", "skip probability", "loop filter deltas", "sharpness",
    "4x4 intra modes", "16x16 intra modes"))}

# libwebp's status codes, as far as they matter here
OK, NOT_ENOUGH_DATA, BITSTREAM_ERROR, UNSUPPORTED_FEATURE = "ok", "not enough data", "bitstream error", \
    "unsupported feature"


def is_webp(data: bytes) -> bool:
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP"


def get_library() -> ctypes.CDLL:
    """The decoder's library, built on first use, its functions declared."""
    lib = kernels.library("webp")
    if lib.webp_decode_vp8l.argtypes is None:
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def _le24(data: bytes, pos: int) -> int:
    return int.from_bytes(data[pos:pos + 3], "little")


def _le32(data: bytes, pos: int) -> int:
    return int.from_bytes(data[pos:pos + 4], "little")


# ----------------------------------------------------------------------
# The bitstreams' headers (VP8GetInfo, VP8LGetInfo)
def vp8_info(data: bytes, pos: int, size: int, chunk_size: int) -> Optional[Tuple[int, int]]:
    """(width, height) of a VP8 key frame at data[pos:pos + size], or
    None where libwebp's VP8GetInfo fails."""
    if size < 10 or data[pos + 3:pos + 6] != b"\x9d\x01\x2a":
        return None
    bits = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
    w = (data[pos + 6] | (data[pos + 7] << 8)) & 0x3FFF
    h = (data[pos + 8] | (data[pos + 9] << 8)) & 0x3FFF
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size:
        return None
    if w == 0 or h == 0:
        return None
    return w, h


def vp8l_signature(data: bytes, pos: int, size: int) -> bool:
    return size >= 5 and data[pos] == 0x2F and (data[pos + 4] >> 5) == 0


def vp8l_info(data: bytes, pos: int, size: int) -> Optional[Tuple[int, int]]:
    """(width, height) of a VP8L bitstream, or None."""
    if not vp8l_signature(data, pos, size):
        return None
    bits = _le32(data, pos + 1)
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


# ----------------------------------------------------------------------
# WebPGetFeatures and WebPDecode's header parse (ParseHeadersInternal)
class Headers(NamedTuple):
    width: int
    height: int
    has_animation: bool
    lossless: bool
    offset: int  # of the VP8/VP8L bitstream
    alpha: Optional[Tuple[int, int]]  # (offset, size) of the (last) ALPH payload


def parse_headers(data: bytes, have_all_data: bool, full: bool) -> Tuple[str, Optional[Headers]]:
    """libwebp's ParseHeadersInternal: ``(status, headers)``.  Without
    ``full`` it is WebPGetFeatures (an animation's VP8X is enough, and
    data ending after a VP8X is not an error); with ``full`` it is the
    parse WebPDecode makes before decoding."""
    if len(data) < 12:
        return NOT_ENOUGH_DATA, None
    pos, riff_size = 0, 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            return BITSTREAM_ERROR, None
        size = _le32(data, 4)
        if size < 12 or size > MAX_CHUNK_PAYLOAD:
            return BITSTREAM_ERROR, None
        if have_all_data and size > len(data) - 8:
            return NOT_ENOUGH_DATA, None
        riff_size, pos = size, 12
    found_riff = riff_size > 0
    if len(data) - pos < 8:
        return NOT_ENOUGH_DATA, None
    found_vp8x, flags, width, height = False, 0, 0, 0
    if data[pos:pos + 4] == b"VP8X":
        if _le32(data, pos + 4) != 10:
            return BITSTREAM_ERROR, None
        if len(data) - pos < 18:
            return NOT_ENOUGH_DATA, None
        flags = _le32(data, pos + 8)
        width, height = 1 + _le24(data, pos + 12), 1 + _le24(data, pos + 15)
        if width * height >= MAX_IMAGE_AREA:
            return BITSTREAM_ERROR, None
        pos += 18
        found_vp8x = True
    animation = bool(flags & ANIMATION_FLAG)
    if not found_riff and found_vp8x:
        return BITSTREAM_ERROR, None

    def give(status, alpha=None, lossless=False, offset=0):
        if status == OK or (status == NOT_ENOUGH_DATA and found_vp8x and not full):
            return OK, Headers(width, height, animation, lossless, offset, alpha)
        return status, None

    if found_vp8x and animation and not full:
        return give(OK)
    if len(data) - pos < 4:
        return give(NOT_ENOUGH_DATA)
    alpha = None
    if (found_riff and found_vp8x) or (not found_riff and not found_vp8x and data[pos:pos + 4] == b"ALPH"):
        # ParseOptionalChunks: every chunk up to VP8/VP8L must fit the RIFF size
        total = 4 + 8 + 10
        while True:
            if len(data) - pos < 8:
                return give(NOT_ENOUGH_DATA, alpha)
            size = _le32(data, pos + 4)
            if size > MAX_CHUNK_PAYLOAD:
                return BITSTREAM_ERROR, None
            disk = (8 + size + 1) & ~1
            total += disk
            if riff_size > 0 and total > riff_size:
                return BITSTREAM_ERROR, None
            if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if len(data) - pos < disk:
                return give(NOT_ENOUGH_DATA, alpha)
            if data[pos:pos + 4] == b"ALPH":
                alpha = (pos + 8, size)
            pos += disk
    # ParseVP8Header
    if len(data) - pos < 8:
        return give(NOT_ENOUGH_DATA, alpha)
    tag = data[pos:pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        size = _le32(data, pos + 4)
        if riff_size >= 12 and size > riff_size - 12:
            return BITSTREAM_ERROR, None
        if have_all_data and size > len(data) - pos - 8:
            return give(NOT_ENOUGH_DATA, alpha)
        compressed, lossless = size, tag == b"VP8L"
        pos += 8
    else:  # a raw bitstream
        lossless = vp8l_signature(data, pos, len(data) - pos)
        compressed = len(data) - pos
    if compressed > MAX_CHUNK_PAYLOAD:
        return BITSTREAM_ERROR, None
    remaining = len(data) - pos
    if not lossless:
        if remaining < 10:
            return give(NOT_ENOUGH_DATA, alpha)
        info = vp8_info(data, pos, remaining, compressed)
    else:
        if remaining < 5:
            return give(NOT_ENOUGH_DATA, alpha)
        info = vp8l_info(data, pos, remaining)
    if info is None:
        return BITSTREAM_ERROR, None
    if found_vp8x and (width, height) != info:
        return BITSTREAM_ERROR, None
    width, height = info
    return give(OK, alpha, lossless, pos)


# ----------------------------------------------------------------------
# The bitstream decoders
class Decoded(NamedTuple):
    bgr: np.ndarray  # uint8 (height, width, 3)
    alpha: Optional[np.ndarray]  # uint8 (height, width), where asked for and there is one
    features: int  # the bits of FEATURES met


def decode_bitstream(data: bytes, offset: int, end: int, lossless: bool, width: int, height: int,
                     alpha: Optional[Tuple[int, int]], path: str, want_alpha: bool = False) -> Decoded:
    """The VP8L or VP8 bitstream at data[offset:end] (libwebp may read
    to ``end``) and, for VP8, its ALPH payload ``alpha`` (offset, size)."""
    if not 0 <= offset <= end <= len(data) or (alpha and alpha[0] + alpha[1] > len(data)):
        raise unreadable(path, "WebP chunks past the end of the file")
    lib = get_library()
    bgr = np.empty((height, width, 3), np.uint8)
    plane = np.empty((height, width), np.uint8) if want_alpha and (lossless or alpha) else None
    plane_p = plane.ctypes.data_as(_U8P) if plane is not None else None
    features = (ctypes.c_uint64 * 1)()
    err = ctypes.create_string_buffer(_ERR)
    base = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value  # data outlives the call

    def at(pos: int):
        return ctypes.cast(base + pos, _U8P)

    if lossless:
        calls["webp_decode_vp8l"] += 1
        rc = lib.webp_decode_vp8l(at(offset), end - offset, width, height, bgr.ctypes.data_as(_U8P), plane_p,
                                  features, err, _ERR)
    else:
        calls["webp_decode_vp8"] += 1
        rc = lib.webp_decode_vp8(at(offset), end - offset, at(alpha[0]) if alpha else None,
                                 alpha[1] if alpha else 0, width, height, bgr.ctypes.data_as(_U8P), plane_p,
                                 features, err, _ERR)
    if rc != 0:
        raise unreadable(path, f"WebP data libwebp rejects ({err.value.decode(errors='replace')})")
    return Decoded(bgr, plane, int(features[0]))


# ----------------------------------------------------------------------
# libwebp's demuxer (demux.c), for an animation and for EXIF
class Frame:
    def __init__(self):
        self.x_offset = self.y_offset = self.width = self.height = 0
        self.frame_num = 0
        self.complete = False
        self.image = (0, 0)  # (chunk offset, chunk size) as the demuxer stores them
        self.alpha = (0, 0)


class _Invalid(Exception):
    """WebPDemux returns NULL: a parse error, or data missing from a file
    that is complete (the demuxer's "need more data")."""


class Demux:
    """What ``WebPDemux`` makes of a whole file, or ``valid`` False where
    it returns NULL: the canvas, the flags, the frames and the first
    stored EXIF chunk's payload."""

    def __init__(self, data: bytes):
        self.data = data
        self.frames: List[Frame] = []
        self.canvas = (0, 0)
        self.flags = 0
        self.exif: Optional[bytes] = None
        self.is_ext = False
        try:
            self._parse()
            self.valid = self._check()
        except _Invalid:
            self.valid = False

    # MemBuffer: the file cut to its RIFF size
    def _need(self, size: int) -> None:
        """The chunk of ``size`` bytes at the read position must fit the
        RIFF size (past it: a parse error; else it is all there)."""
        if size > self.riff_end - self.pos:
            raise _Invalid

    def _header(self):
        """The chunk header at the read position: (start, fourcc, size,
        padded size), the position moved past it."""
        start = self.pos
        fourcc, size = self.data[start:start + 4], _le32(self.data, start + 4)
        self.pos += 8
        if size > MAX_CHUNK_PAYLOAD:
            raise _Invalid
        padded = size + (size & 1)
        self._need(padded)
        return start, fourcc, size, padded

    def _more_chunks(self) -> bool:
        """After a chunk: the RIFF's end, or room for another header."""
        if self.pos == self.riff_end:
            return False
        self._need(8)
        return True

    def _parse(self):
        data = self.data
        if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
            raise _Invalid
        riff_size = _le32(data, 4)
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD or riff_size + 8 > len(data):
            raise _Invalid  # the last: a partial file
        self.riff_end, self.pos = riff_size + 8, 12
        tag = data[12:16]
        if tag in (b"VP8 ", b"VP8L"):
            self._single_image()
        elif tag == b"VP8X":
            self._vp8x()
        else:
            raise _Invalid

    def _single_image(self):
        if self.frames:
            raise _Invalid
        self._need(8)
        frame = Frame()
        self._store_frame(1, 0, frame)
        if not self.is_ext and frame.width > 0 and frame.height > 0:
            self.canvas = (frame.width, frame.height)
        self._add(frame)

    def _add(self, frame: Frame):
        if self.frames and not self.frames[-1].complete:
            raise _Invalid
        self.frames.append(frame)

    def _store_frame(self, frame_num: int, min_size: int, frame: Frame):
        """StoreFrame: an ALPH chunk and a VP8/VP8L chunk, up to the first
        other chunk (left for the caller)."""
        self._need(max(8, min_size))
        alpha_chunks = image_chunks = 0
        while True:
            start, fourcc, _, padded = self._header()
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks += 1
                frame.alpha = (start, 8 + padded)
            elif fourcc in (b"VP8L", b"VP8 ") and image_chunks == 0:
                if fourcc == b"VP8L" and alpha_chunks > 0:
                    raise _Invalid  # VP8L has its own alpha
                size = _chunk_size(self.data[start:start + 8 + padded])
                if size is None:
                    raise _Invalid
                image_chunks += 1
                frame.image = (start, 8 + padded)
                frame.width, frame.height = size
                frame.complete = True
            elif fourcc == b"VP8L" and alpha_chunks > 0:
                raise _Invalid
            else:
                self.pos -= 8  # up one level
                return
            frame.frame_num = frame_num
            self.pos += padded
            if not self._more_chunks():
                return

    def _vp8x(self):
        data = self.data
        self._need(8)
        self.is_ext = True
        size = _le32(data, self.pos + 4)
        self.pos += 8
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            raise _Invalid
        size += size & 1
        self._need(size)
        self.flags = data[self.pos]
        self.canvas = (1 + _le24(data, self.pos + 4), 1 + _le24(data, self.pos + 7))
        if self.canvas[0] * self.canvas[1] >= MAX_IMAGE_AREA:
            raise _Invalid
        self.pos += size
        self._need(8)
        is_animation = bool(self.flags & ANIMATION_FLAG)
        anim_chunks = 0
        while True:
            start, fourcc, size, padded = self._header()
            if fourcc == b"VP8X":
                raise _Invalid
            elif fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or is_animation:
                    raise _Invalid
                self.pos -= 8
                self._single_image()
            elif fourcc == b"ANIM" and anim_chunks == 0:
                if padded < 6:
                    raise _Invalid
                anim_chunks += 1
                self.pos += padded
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    raise _Invalid  # ANIM precedes frames
                self._animation_frame(padded)
            else:  # skipped (a second ANIM too); EXIF kept where the flag says so
                if fourcc == b"ANIM" and padded < 6:
                    raise _Invalid
                if fourcc == b"EXIF" and self.flags & EXIF_FLAG and self.exif is None:
                    self.exif = data[start + 8:start + 8 + size]
                self.pos += padded
            if not self._more_chunks():
                return

    def _animation_frame(self, frame_chunk_size: int):
        data = self.data
        self._need(16)
        if frame_chunk_size < 16:
            raise _Invalid
        frame = Frame()
        p = self.pos
        frame.x_offset, frame.y_offset = 2 * _le24(data, p), 2 * _le24(data, p + 3)
        if (1 + _le24(data, p + 6)) * (1 + _le24(data, p + 9)) >= MAX_IMAGE_AREA:
            raise _Invalid
        self.pos += 16
        start = self.pos
        self._store_frame(len(self.frames) + 1, frame_chunk_size - 16, frame)
        if self.pos - start > frame_chunk_size - 16:
            raise _Invalid
        if self.flags & ANIMATION_FLAG and frame.frame_num > 0:
            self._add(frame)

    def _check(self) -> bool:
        """IsValidSimpleFormat / IsValidExtendedFormat, the parse done.
        (A frame's size is its bitstream's: the ANMF fields are not kept.)"""
        w, h = self.canvas
        if not self.is_ext:
            return w > 0 and h > 0 and bool(self.frames)
        is_animation = bool(self.flags & ANIMATION_FLAG)
        if not self.frames or self.flags & ~ALL_VALID_FLAGS:
            return False
        for f in self.frames:
            if not f.complete or (not is_animation and f.frame_num > 1):
                return False  # a partial frame, or a second still image
            if not is_animation:
                if f.x_offset or f.y_offset or (f.width, f.height) != (w, h):
                    return False
            elif f.x_offset + f.width > w or f.y_offset + f.height > h:
                return False
        return True


def _chunk_size(chunk: bytes) -> Optional[Tuple[int, int]]:
    """WebPGetFeatures on a lone VP8/VP8L chunk, as the demuxer calls it
    on a complete chunk: (width, height) or None."""
    status, headers = parse_headers(chunk, have_all_data=False, full=False)
    return (headers.width, headers.height) if status == OK else None


# ----------------------------------------------------------------------
def decode_still(data: bytes, path: str = "<webp>", want_alpha: bool = False) -> Decoded:
    """A still WebP file decoded as WebPDecode decodes it."""
    status, headers = parse_headers(data, have_all_data=True, full=True)
    if status == OK and headers.has_animation:
        status = UNSUPPORTED_FEATURE
    if status != OK:
        raise unreadable(path, f"a WebP file whose headers libwebp rejects ({status})")
    return decode_bitstream(data, headers.offset, len(data), headers.lossless, headers.width,
                            headers.height, headers.alpha, path, want_alpha)


def first_frame(data: bytes, path: str = "<webp>", demux: Optional[Demux] = None) -> np.ndarray:
    """An animation's first frame on its zeroed canvas, BGR."""
    demux = demux or Demux(data)
    if not demux.valid:
        raise unreadable(path, "an animated WebP file libwebp's demuxer rejects")
    frame = next(f for f in demux.frames if f.frame_num == 1)
    start, size = frame.image
    if frame.alpha[1]:
        start = frame.alpha[0]
        size += frame.image[0] - frame.alpha[0]
    fragment = data[start:start + size]
    status, headers = parse_headers(fragment, have_all_data=False, full=False)
    if status == OK:
        status, headers = parse_headers(fragment, have_all_data=True, full=True)
    if status != OK:
        raise unreadable(path, f"an animation frame libwebp rejects ({status})")
    bgr = decode_bitstream(fragment, headers.offset, len(fragment), headers.lossless, headers.width,
                           headers.height, headers.alpha, path).bgr
    w, h = demux.canvas
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[frame.y_offset:frame.y_offset + headers.height, frame.x_offset:frame.x_offset + headers.width] = bgr
    return canvas


def decode_webp(data: bytes, path: str = "<webp>") -> Tuple[np.ndarray, Optional[bytes]]:
    """A WebP file's bytes -> (BGR uint8 (H, W, 3) as
    ``cv2.imread(path, cv2.IMREAD_COLOR)`` has it before its EXIF turn,
    the EXIF block OpenCV reads the orientation from, or None)."""
    if not is_webp(data):
        raise ValueError(f"{path}: not a WebP file")
    if len(data) < HEADER_SIZE:
        raise unreadable(path, f"a WebP file of {len(data)} bytes (OpenCV's signature test reads 32)")
    if len(data) > MAX_FILE_SIZE:
        raise unreadable(path, "a WebP file over OpenCV's 64 MiB limit")
    status, features = parse_headers(data[:HEADER_SIZE], have_all_data=False, full=False)
    if status != OK:
        raise unreadable(path, f"a WebP file whose first 32 bytes libwebp rejects ({status})")
    demux = Demux(data)
    if features.has_animation and not demux.valid:
        raise unreadable(path, "an animated WebP file libwebp's demuxer rejects")
    # OpenCV checks the size its header gives (the canvas) before it decodes
    w, h = demux.canvas if features.has_animation else (features.width, features.height)
    if w > MAX_IMAGE_SIDE or h > MAX_IMAGE_SIDE or w * h > MAX_IMAGE_PIXELS:
        raise ValueError(f"{path}: OpenCV 5 raises an error for a {w}x{h} image (its image size limits)")
    img = first_frame(data, path, demux) if features.has_animation else decode_still(data, path).bgr
    return img, demux.exif if demux.valid else None
