"""ctypes bindings of the port's host C++ (``csrc/perotpu.cpp``), the
counterpart of the JAX package's ``pero_ocr_tpu/utils/native.py`` for
the six functions config 2's paths run, the forced alignment of
config 5's ALTO output (``viterbi_ctc_f32``) and the edit distance that
stitches config 4's over-wide transformer lines (``levenshtein_i32``).

The arguments and return values are the JAX bindings'.  Where those
return None for a missing library, these raise: the library is built
with the host compiler on first use (:mod:`pero_ocr_tpu_torch.utils.kernels`),
and a missing compiler or a failed build raises.  The one None left is
the C++'s own: ``native_cc_lines_packed`` past ``max_comps`` components.

The page transport and the stage-by-stage layout run the labeling, the
component lines, the penalties and the pair tests, as the JAX page
transport and layout engine do.  The crop transport parses the packed
mask (``native_cc_lines_packed``) and warps its straight lines on the
host (``native_warp_affine_lines``), as the JAX crop transport does;
the page transport, like the JAX one, labels the unpacked mask.

Which route a caller takes: :func:`use_native`.  :data:`calls` counts
each C++ function's calls.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from pero_ocr_tpu_torch.utils import kernels

calls = collections.Counter()  # C++ function name -> calls through these bindings

_I32, _I64, _U8 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint8
_F32, _F64 = ctypes.c_float, ctypes.c_double
_SIGNATURES = {  # name: (restype, argtypes), as in csrc/perotpu.cpp
    "cc_label_u8": (_I32, [ctypes.POINTER(_U8), _I32, _I32, ctypes.POINTER(_I32)]),
    "cc_baselines_f32": (None, [
        ctypes.POINTER(_I32), _I32, _I32, _I32, ctypes.POINTER(_F32), _I32,
        ctypes.POINTER(_F64), ctypes.POINTER(_I32), ctypes.POINTER(_F64),
        ctypes.POINTER(_U8),
    ]),
    "cc_lines_packed": (_I32, [
        ctypes.POINTER(_U8), _I32, _I32, ctypes.POINTER(_U8), _I32, _I32, _I32, _I32,
        ctypes.POINTER(_F64), ctypes.POINTER(_I32), ctypes.POINTER(_F64),
        ctypes.POINTER(_I64), ctypes.POINTER(_I64),
    ]),
    "separator_penalties_f32": (None, [
        ctypes.POINTER(_F64), ctypes.POINTER(_F64), ctypes.POINTER(_I32),
        ctypes.POINTER(_I32), ctypes.POINTER(_F64), ctypes.POINTER(_F64),
        ctypes.POINTER(_F64), _I32, ctypes.POINTER(_F32), _I32, _I32, _I32,
        ctypes.POINTER(_F64),
    ]),
    "polygons_close_f64": (None, [
        ctypes.POINTER(_F64), ctypes.POINTER(_I32), _I32, ctypes.POINTER(_I32), _I32,
        ctypes.POINTER(_F64), ctypes.POINTER(_U8),
    ]),
    "viterbi_ctc_f32": (_I32, [
        ctypes.POINTER(_F32), _I32, _I32, ctypes.POINTER(_U8), ctypes.POINTER(_I32),
    ]),
    "levenshtein_i32": (_I32, [ctypes.POINTER(_I32), _I32, ctypes.POINTER(_I32), _I32]),
    "warp_affine_avx2": (_I32, []),
}
_WARP_AFFINE_ARGS = [
    ctypes.POINTER(_U8), _I32, _I32, ctypes.POINTER(_F64), ctypes.POINTER(_I32), _I32, _I32,
    ctypes.POINTER(_U8), ctypes.POINTER(_I64), _I64, _I64,
]
_SIGNATURES["warp_affine_lines_u8"] = (None, _WARP_AFFINE_ARGS)
_SIGNATURES["warp_affine_lines_u8_scalar"] = (None, _WARP_AFFINE_ARGS)


def use_native(native: Optional[bool], device) -> bool:
    """Whether the host geometry runs the C++ library.  ``native`` None
    follows the device, as the kernels do: the C++ on CUDA (None means
    CUDA), the numpy twins on the CPU; True or False picks one whatever
    the device."""
    if native is None:
        return torch.device("cuda" if device is None else device).type == "cuda"
    return bool(native)


def get_library() -> ctypes.CDLL:
    """The port's host library, built on first use, its functions
    declared."""
    lib = kernels.library("perotpu")
    if lib.cc_label_u8.argtypes is None:
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_label(mask: np.ndarray):
    """8-connected components: (labels (h, w) int32, count), numbered
    as ``scipy.ndimage.label`` numbers them (first pixel in raster
    order)."""
    lib = get_library()
    calls["cc_label_u8"] += 1
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = mask.shape
    labels = np.empty((h, w), dtype=np.int32)
    count = lib.cc_label_u8(_ptr(mask, _U8), h, w, _ptr(labels, _I32))
    return labels, int(count)


def native_cc_baselines(labels: np.ndarray, heights: np.ndarray, num: int, max_pts: int = 10):
    """Per-component decimated baselines and median heights in one
    pass (``cc_baselines_f32``).  Returns (pts (num, max_pts, 2), npts,
    heights (num, 2), valid) for labels 1..num."""
    lib = get_library()
    calls["cc_baselines_f32"] += 1
    labels = np.ascontiguousarray(labels, np.int32)
    heights = np.ascontiguousarray(heights, np.float32)
    h, w = labels.shape
    if heights.shape != (h, w, 2) or max_pts < 2:
        raise ValueError(f"cc_baselines: heights {heights.shape} for labels {labels.shape}, "
                         f"max_pts {max_pts}")
    out_pts = np.zeros((num, max_pts, 2), np.float64)
    out_npts = np.zeros(num, np.int32)
    out_heights = np.zeros((num, 2), np.float64)
    out_valid = np.zeros(num, np.uint8)
    lib.cc_baselines_f32(
        _ptr(labels, _I32), h, w, num, _ptr(heights, _F32), max_pts,
        _ptr(out_pts, _F64), _ptr(out_npts, _I32), _ptr(out_heights, _F64),
        _ptr(out_valid, _U8),
    )
    return out_pts, out_npts, out_heights, out_valid


def native_cc_lines_packed(packed: np.ndarray, heights_q: np.ndarray, hf: int,
                           max_comps: int = 4096, max_pts: int = 10):
    """Packed 1-bit baseline mask (H, W/8) and quarter-pixel pooled
    heights (H/hf, W/hf, 2) uint8 -> component baselines and the
    adaptation statistics in one pass (``cc_lines_packed``).  Returns
    (pts, npts, heights, n_emitted, n_px, hist0): hist0 is the 256-bin
    histogram of channel-0 ``heights_q`` under the set bits.  None when
    the page has more than ``max_comps`` valid components."""
    lib = get_library()
    calls["cc_lines_packed"] += 1
    packed = np.ascontiguousarray(packed, np.uint8)
    heights_q = np.ascontiguousarray(heights_q, np.uint8)
    h, wb = packed.shape
    hf = int(hf)
    if (hf < 1 or heights_q.ndim != 3 or heights_q.shape[2] != 2 or max_pts < 2
            or heights_q.shape[0] * hf < h or heights_q.shape[1] * hf < wb * 8):
        raise ValueError(f"cc_lines_packed: heights_q {heights_q.shape} with pool {hf} "
                         f"does not cover the mask {packed.shape}, or max_pts {max_pts}")
    out_pts = np.zeros((max_comps, max_pts, 2), np.float64)
    out_npts = np.zeros(max_comps, np.int32)
    out_heights = np.zeros((max_comps, 2), np.float64)
    out_npx = np.zeros(1, np.int64)
    hist0 = np.zeros(256, np.int64)
    n = lib.cc_lines_packed(
        _ptr(packed, _U8), h, wb, _ptr(heights_q, _U8), heights_q.shape[1], hf,
        max_comps, max_pts, _ptr(out_pts, _F64), _ptr(out_npts, _I32),
        _ptr(out_heights, _F64), _ptr(out_npx, _I64), _ptr(hist0, _I64),
    )
    if n < 0:
        return None
    return out_pts[:n], out_npts[:n], out_heights[:n], int(n), int(out_npx[0]), hist0


def native_separator_penalties(bx, by, offs, q_line, q_shift, q_x1, q_x2, sep_map,
                               pool: int = 1) -> np.ndarray:
    """The (Q,) separator penalties of
    :func:`~pero_ocr_tpu_torch.layout_engines.cnn_engine.separator_penalties`
    (thickness 1) in one call.  ``pool`` > 1: ``sep_map`` is the pooled
    map, the coordinates full-map."""
    lib = get_library()
    calls["separator_penalties_f32"] += 1
    bx = np.ascontiguousarray(bx, np.float64)
    by = np.ascontiguousarray(by, np.float64)
    offs = np.ascontiguousarray(offs, np.int32)
    q_line = np.ascontiguousarray(q_line, np.int32)
    q_shift = np.ascontiguousarray(q_shift, np.float64)
    q_x1 = np.ascontiguousarray(q_x1, np.float64)
    q_x2 = np.ascontiguousarray(q_x2, np.float64)
    sep_map = np.ascontiguousarray(sep_map, np.float32)
    n_q = len(q_line)
    if not (len(q_shift) == len(q_x1) == len(q_x2) == n_q and len(bx) == len(by)):
        raise ValueError("separator penalties: query or point arrays differ in length")
    if n_q and (q_line.min() < 0 or q_line.max() + 1 >= len(offs)
                or offs[0] < 0 or offs[-1] > len(bx)):
        raise ValueError("separator penalties: a query's line or offsets out of range")
    out = np.empty(n_q, np.float64)
    h, w = sep_map.shape
    lib.separator_penalties_f32(
        _ptr(bx, _F64), _ptr(by, _F64), _ptr(offs, _I32), _ptr(q_line, _I32),
        _ptr(q_shift, _F64), _ptr(q_x1, _F64), _ptr(q_x2, _F64), n_q,
        _ptr(sep_map, _F32), h * int(pool), w * int(pool), int(pool), _ptr(out, _F64),
    )
    return out


def native_polygons_close(polys: Sequence[np.ndarray], pairs: np.ndarray,
                          thresholds: np.ndarray) -> np.ndarray:
    """(K,) bool: whether each pair's polygon boundaries come within
    ``thresholds[k]`` (``<=``), early-exiting per pair."""
    lib = get_library()
    calls["polygons_close_f64"] += 1
    pairs = np.ascontiguousarray(pairs, dtype=np.int32).reshape(-1, 2)
    k = len(pairs)
    out = np.empty(k, dtype=np.uint8)
    if k == 0:
        return out.astype(bool)
    if pairs.min() < 0 or pairs.max() >= len(polys):
        raise ValueError("polygons_close: a pair's index is out of range")
    npts = np.asarray([len(p) for p in polys], dtype=np.int32)
    pmax = int(npts.max())
    verts = np.zeros((len(polys), pmax, 2), dtype=np.float64)
    for i, p in enumerate(polys):
        verts[i, : len(p)] = p
    thresholds = np.ascontiguousarray(thresholds, dtype=np.float64)
    if len(thresholds) != k:
        raise ValueError("polygons_close: one threshold a pair")
    lib.polygons_close_f64(
        _ptr(verts, _F64), _ptr(npts, _I32), pmax, _ptr(pairs, _I32), k,
        _ptr(thresholds, _F64), _ptr(out, _U8),
    )
    return out.astype(bool)


def native_viterbi_ctc(neg_logprobs_states: np.ndarray, skip_ok: np.ndarray) -> np.ndarray:
    """The Viterbi path over (T, S) gathered CTC costs, in float32
    (``viterbi_ctc_f32``): (T,) int32 states.  Raises ValueError when no
    path has a finite cost."""
    lib = get_library()
    calls["viterbi_ctc_f32"] += 1
    costs = np.ascontiguousarray(neg_logprobs_states, dtype=np.float32)
    costs = np.minimum(costs, 1e30)  # +inf to the C++'s finite sentinel
    skip = np.ascontiguousarray(skip_ok, dtype=np.uint8)
    if costs.ndim != 2 or skip.shape != (costs.shape[1],) or costs.shape[0] < 1:
        raise ValueError(f"viterbi: costs {costs.shape} with skip mask {skip.shape}")
    t, s = costs.shape
    path = np.empty(t, dtype=np.int32)
    rc = lib.viterbi_ctc_f32(_ptr(costs, _F32), t, s, _ptr(skip, _U8), _ptr(path, _I32))
    if rc != 0:
        raise ValueError(
            "It was not possible to align the states with the logits, "
            "best path has cost of np.inf"
        )
    return path


def native_warp_affine_lines(gray: np.ndarray, mats: np.ndarray, widths: np.ndarray,
                             crop_h: int, out: np.ndarray, offsets: np.ndarray,
                             stride_col: int, stride_row: int, scalar: bool = False) -> bool:
    """Straight lines of one (h, w) uint8 gray page warped by their (N, 2,
    3) inverse-affine matrices into ``out`` (``warp_affine_lines_u8``):
    line n's pixel (row y, column x < widths[n]) lands at
    ``out.flat[offsets[n] + x * stride_col + y * stride_row]``.  Returns
    True, as the JAX binding does when its library is there.  The C++
    runs its AVX2 body where the host has one (:func:`warp_affine_avx2`);
    ``scalar`` forces the scalar body, which the numpy twin
    (:func:`~pero_ocr_tpu_torch.parallel.crop_transport.warp_affine_lines`)
    equals."""
    lib = get_library()
    calls["warp_affine_lines_u8"] += 1
    gray = np.ascontiguousarray(gray, dtype=np.uint8)
    mats = np.ascontiguousarray(mats, dtype=np.float64).reshape(-1, 2, 3)
    widths = np.ascontiguousarray(widths, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"] or gray.ndim != 2:
        raise ValueError("warp_affine_lines: a 2-d gray page and a C-contiguous uint8 out")
    n = len(widths)
    if len(mats) != n or len(offsets) != n:
        raise ValueError("warp_affine_lines: one matrix, width and offset a line")
    if n and (widths.min() < 0 or offsets.min() < 0 or (offsets + (widths - 1).clip(0) * stride_col
                                                        + (crop_h - 1) * stride_row).max()
                                                       >= out.size):
        raise ValueError("warp_affine_lines: a line's pixels fall outside out")
    h, w = gray.shape
    fn = lib.warp_affine_lines_u8_scalar if scalar else lib.warp_affine_lines_u8
    fn(_ptr(gray, _U8), h, w, _ptr(mats, _F64), _ptr(widths, _I32), n, crop_h,
       _ptr(out, _U8), _ptr(offsets, _I64), stride_col, stride_row)
    return True


def warp_affine_avx2() -> bool:
    """Whether ``warp_affine_lines_u8`` runs its AVX2 body on this host."""
    return bool(get_library().warp_affine_avx2())


def native_levenshtein(a: Sequence[int], b: Sequence[int]) -> int:
    """Unit-cost edit distance of two int32 id sequences
    (``levenshtein_i32``)."""
    lib = get_library()
    calls["levenshtein_i32"] += 1
    a = np.ascontiguousarray(a, dtype=np.int32).reshape(-1)
    b = np.ascontiguousarray(b, dtype=np.int32).reshape(-1)
    return int(lib.levenshtein_i32(_ptr(a, _I32), len(a), _ptr(b, _I32), len(b)))
