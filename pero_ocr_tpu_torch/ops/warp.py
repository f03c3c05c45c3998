"""Batched line-crop warp (port of pero_ocr_tpu/ops/warp.py).

``warp_lines(pages, baselines, heights, crop_h, bucket, out_dtype,
normalize)`` turns each text line of a batch of u8 grayscale pages into
a (crop_h, bucket) crop: output column j sits at arc position j / scale
along the line's baseline (scale = crop_h / (ascender + descender)), row
r at ``linspace(-ascender, descender, crop_h)[r]`` along the baseline's
normal, and the page is sampled bilinearly there.  Neighbours outside
the page read 0 (``cv2.remap`` with ``BORDER_CONSTANT``), and columns
beyond the baseline's arc length are 0.  Each sampled float32 value v
is stored as ``out_dtype(v)``, or with ``normalize=True`` as
``out_dtype(v / 255)``: one true float32 division, then one rounding to
nearest even into ``out_dtype`` (float32 or bfloat16).  That is the
``crops / 255.0`` and the cast the recognizer's input takes, fused into
the store.

- On CUDA tensors it launches the hand-written kernel
  ``csrc/warp_lines.cu``, which replaces the Pallas TPU kernel
  ``_warp_kernel``/``warp_lines_pallas`` (pero_ocr_tpu/ops/warp.py:188,
  :223).  It builds the warp field inside the kernel and reads u8 pages
  from global memory, so there is no page-size cap and no dense field.
  Its bound is memory: :func:`warp_lines_bytes` (the page pixels the
  taps touch, the geometry, and the crops at ``out_dtype``) over the
  card's memory rate, 3.35 TB/s on an H100 SXM.  There is no fallback: a
  launch error raises.
- On CPU tensors it runs :func:`warp_lines_plain`, a direct
  transcription of ``build_fields_device`` (:126-182) followed by
  ``_bilinear_gather`` (:32-62), operation for operation, except that
  the chord rotation and the lengths use only correctly rounded
  arithmetic (cos(atan2(dy, dx)) = dx / |chord|, hypot as a square
  root), so that the kernel and the plain version round alike.

Both paths take the same arguments and refuse the same ones: at most
``MAX_POINTS`` baseline points and ``MAX_CROP_H`` rows (the kernel's
shared tables), pages of fewer than 2**31 pixels (its 32-bit offsets),
float32 or bfloat16 out.

``warp_fields(page, fields, store)`` is the Pallas kernel's own
contract: an (H, W, C) page, uint8 or float32 with C in {1, 3}, sampled
bilinearly at a precomputed (N, Hc, Wb, 2) field of (x, y) page
coordinates.  The kernel indexes samples flat, so the stage-by-stage
``LineCropper`` runs all of a page's width buckets (:func:`width_buckets`)
in one call: their fields lie back to back in one buffer
(:func:`field_layout`, :func:`field_buffer`, :func:`split_fields`,
:func:`pad_fields`), passed as one (1, 1, total, 2) field, and
:func:`split_fields` cuts the crops out of the flat output the same
way.  CUDA tensors launch ``csrc/warp_fields.cu``; CPU tensors run
:func:`warp_fields_plain`.  Its bound is memory as well, and there the
field dominates: 8 bytes a pixel against the 1 to 12 of the page taps
and the crop (:func:`warp_fields_bytes`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

# jnp.interp treats an arc step |dx| <= np.spacing(float32 eps) as zero.
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))
OFF_PAGE = -1e6  # field coordinate of a column beyond the arc
MAX_POINTS = 64   # kMaxPoints in csrc/warp_lines.cu
MAX_CROP_H = 64   # kMaxCropH in csrc/warp_lines.cu
OUT_DTYPES = (torch.float32, torch.bfloat16)


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(a*a + b*b): correctly rounded steps only, as in the kernel
    (library trig and hypot differ between builds in the last ulp)."""
    return torch.sqrt(a * a + b * b)


def _interp(t: torch.Tensor, arc: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Row-wise ``jnp.interp(t, arc, fp)``: t (L, M), arc/fp (L, P)."""
    p = arc.shape[1]
    i = torch.searchsorted(arc, t, right=True).clamp(1, p - 1)
    f_lo, f_hi = fp.gather(1, i - 1), fp.gather(1, i)
    a_lo, a_hi = arc.gather(1, i - 1), arc.gather(1, i)
    df = f_hi - f_lo
    dx = a_hi - a_lo
    delta = t - a_lo
    dx0 = dx.abs() <= _INTERP_EPS
    f = torch.where(dx0, f_lo, f_lo + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(t < arc[:, :1], fp[:, :1], f)
    return torch.where(t > arc[:, -1:], fp[:, -1:], f)


def _gradient(f: torch.Tensor) -> torch.Tensor:
    """Row-wise ``jnp.gradient``: one-sided at the ends, central inside."""
    return torch.cat(
        [f[:, 1:2] - f[:, :1], (f[:, 2:] - f[:, :-2]) * 0.5, f[:, -1:] - f[:, -2:-1]],
        dim=1,
    )


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """Row-wise ``jnp.linspace(start, stop, num)`` with its formula:
    start * (1 - k/div) + stop * k/div, and stop exactly at the end."""
    if num == 1:
        return start[:, None]
    k = torch.arange(num - 1, dtype=torch.float32, device=start.device)
    step = k / torch.full_like(k, num - 1)  # true division, not k * (1/div)
    out = start[:, None] * (1.0 - step) + stop[:, None] * step
    return torch.cat([out, stop[:, None]], dim=1)


def build_fields(
    baselines: torch.Tensor, heights: torch.Tensor, crop_h: int, bucket: int
) -> torch.Tensor:
    """(L, P, 2) baselines and (L, 2) [ascender, descender] heights ->
    (L, crop_h, bucket, 2) page-frame (x, y) sampling coordinates;
    columns beyond each line's arc carry ``OFF_PAGE``.  Transcribes
    ``build_fields_device`` (pero_ocr_tpu/ops/warp.py:126-182)."""
    bl = baselines.float()
    h = heights.float()
    # Chord rotation: cos and sin of atan2(dy, dx) are dx and dy over the
    # chord length (atan2(0, 0) = 0 for a zero chord).
    cx, cy = bl[:, -1, 0] - bl[:, 0, 0], bl[:, -1, 1] - bl[:, 0, 1]
    chord = _hypot(cx, cy)
    cos = torch.where(chord > 0, cx / chord, 1.0)[:, None]
    sin = torch.where(chord > 0, cy / chord, 0.0)[:, None]
    x = bl[..., 0] * cos + bl[..., 1] * sin      # chord frame
    y = bl[..., 0] * (-sin) + bl[..., 1] * cos
    seg = _hypot(x[:, 1:] - x[:, :-1], y[:, 1:] - y[:, :-1])
    arcs = [torch.zeros_like(seg[:, 0])]
    for k in range(seg.shape[1]):  # sequential prefix sum, as the kernel
        arcs.append(arcs[-1] + seg[:, k])
    arc = torch.stack(arcs, dim=1)

    # A true division: `crop_h / tensor` would be reciprocal() * crop_h.
    band = torch.clamp_min(h[:, 0] + h[:, 1], 1e-6)
    scale = torch.full_like(band, float(crop_h)) / band
    t = torch.arange(bucket, dtype=torch.float32, device=bl.device)[None] / scale[:, None]
    valid = t <= arc[:, -1:]
    xs = _interp(t, arc, x)
    ys = _interp(t, arc, y)
    dx, dy = _gradient(xs), _gradient(ys)
    norm = torch.clamp_min(_hypot(dx, dy), 1e-6)
    nx, ny = -dy / norm, dx / norm

    vert = _linspace(-h[:, 0], h[:, 1], crop_h)[:, :, None]        # (L, Hc, 1)
    map_x = nx[:, None, :] * vert + xs[:, None, :]
    map_y = ny[:, None, :] * vert + ys[:, None, :]
    cos, sin = cos[:, :, None], sin[:, :, None]
    field = torch.stack(
        [map_x * cos + map_y * (-sin), map_x * sin + map_y * cos], dim=-1
    )
    return torch.where(valid[:, None, :, None], field, OFF_PAGE)


def bilinear_gather(page: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``page`` (H, W) at ``coords`` (..., 2) of
    (x, y); neighbours outside the page read 0.  Transcribes
    ``_bilinear_gather`` (pero_ocr_tpu/ops/warp.py:32-62)."""
    h, w = page.shape
    flat = page.float().reshape(-1)
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = flat[yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return torch.where(valid, vals, 0.0)

    top = tap(y0i, x0i) * (1.0 - fx) + tap(y0i, x0i + 1) * fx
    bottom = tap(y0i + 1, x0i) * (1.0 - fx) + tap(y0i + 1, x0i + 1) * fx
    return top * (1.0 - fy) + bottom * fy


def _store(crops: torch.Tensor, out_dtype: torch.dtype, normalize: bool) -> torch.Tensor:
    """The kernel's store: v, or v / 255 by a true division (a tensor of
    255s: on CUDA, ``crops / 255.0`` may multiply by the reciprocal,
    and one float32 ulp flips bf16 roundings), rounded once to
    ``out_dtype``."""
    if normalize:
        crops = crops / torch.full_like(crops, 255.0)
    return crops.to(out_dtype)


def warp_lines_plain(
    pages: torch.Tensor, baselines: torch.Tensor, heights: torch.Tensor,
    crop_h: int, bucket: int, out_dtype: torch.dtype = torch.float32,
    normalize: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: :func:`build_fields` then
    :func:`bilinear_gather`, page by page, then the kernel's store."""
    pb, n, p, _ = baselines.shape
    fields = build_fields(
        baselines.reshape(pb * n, p, 2), heights.reshape(pb * n, 2), crop_h, bucket
    ).reshape(pb, n, crop_h, bucket, 2)
    crops = torch.cat([bilinear_gather(pages[i], fields[i]) for i in range(pb)])
    return _store(crops, out_dtype, normalize)


def warp_lines_bytes(
    pages: torch.Tensor, baselines: torch.Tensor, heights: torch.Tensor,
    crop_h: int, bucket: int, out_dtype: torch.dtype = torch.float32,
    fields: torch.Tensor = None,
) -> int:
    """Least bytes the warp moves on these inputs: the distinct page
    pixels that the valid columns' four bilinear taps touch (found by
    scattering the taps into a page-sized mask), the geometry, and the
    crops written once at ``out_dtype``.  ``fields``: the
    (PB * N, crop_h, bucket, 2) output of :func:`build_fields`, computed
    here when not given."""
    pb, h, w = pages.shape
    n, p = baselines.shape[1], baselines.shape[2]
    if fields is None:
        fields = build_fields(
            baselines.reshape(pb * n, p, 2), heights.reshape(pb * n, 2), crop_h, bucket
        )
    fields = fields.reshape(pb, -1, 2)
    x0, y0 = torch.floor(fields[..., 0]).long(), torch.floor(fields[..., 1]).long()
    valid = fields[..., 0] > OFF_PAGE / 2
    page = torch.arange(pb, device=fields.device)[:, None] * (h * w)
    touched = torch.zeros(pb * h * w, dtype=torch.bool, device=fields.device)
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            inside = valid & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            touched[(page + yi * w + xi)[inside]] = True
    geometry = sum(t.numel() * t.element_size() for t in (baselines, heights))
    out = pb * n * crop_h * bucket * out_dtype.itemsize
    return int(touched.sum()) * pages.element_size() + geometry + out


def _check_args(pages, baselines, heights, crop_h, bucket, out_dtype, normalize):
    pb, h, w = pages.shape
    if (baselines.ndim != 4 or baselines.shape[0] != pb or baselines.shape[3] != 2
            or tuple(heights.shape) != (pb, baselines.shape[1], 2)):
        raise ValueError(
            f"warp_lines: shapes pages {tuple(pages.shape)}, baselines "
            f"{tuple(baselines.shape)}, heights {tuple(heights.shape)} disagree"
        )
    for name, t, dtype in (("pages", pages, torch.uint8),
                           ("baselines", baselines, torch.float32),
                           ("heights", heights, torch.float32)):
        if t.dtype != dtype or t.device != pages.device or not t.is_contiguous():
            raise ValueError(
                f"warp_lines: {name} must be a contiguous {dtype} tensor on "
                f"{pages.device}, got {t.dtype} on {t.device}"
            )
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"warp_lines: out_dtype must be one of {OUT_DTYPES}, got {out_dtype}")
    if not isinstance(normalize, bool):
        raise ValueError(f"warp_lines: normalize must be a bool, got {normalize!r}")
    if not (1 <= crop_h <= MAX_CROP_H and bucket >= 2 and 2 <= baselines.shape[2] <= MAX_POINTS
            and 1 <= h < 2**22 and 1 <= w < 2**22 and h * w < 2**31):
        raise ValueError(
            f"warp_lines: needs 1 <= crop_h <= {MAX_CROP_H}, bucket >= 2, "
            f"2..{MAX_POINTS} baseline points and pages of fewer than 2**31 pixels, "
            f"got crop_h {crop_h}, bucket {bucket}, {baselines.shape[2]} points, "
            f"pages {h}x{w}"
        )


def warp_lines(
    pages: torch.Tensor, baselines: torch.Tensor, heights: torch.Tensor,
    crop_h: int, bucket: int, out_dtype: torch.dtype = torch.float32,
    normalize: bool = False,
) -> torch.Tensor:
    """pages (PB, H, W) uint8; baselines (PB, N, P, 2) float32; heights
    (PB, N, 2) float32 -> (PB * N, crop_h, bucket) crops in
    ``out_dtype``, divided by 255 when ``normalize``.

    CUDA tensors launch the kernel (and count the launch in
    ``warp_lines.launches``); CPU tensors run :func:`warp_lines_plain`.
    Both raise ValueError on arguments the kernel does not take."""
    if pages.device.type not in ("cpu", "cuda"):
        raise ValueError(f"warp_lines: unsupported device {pages.device}")
    _check_args(pages, baselines, heights, crop_h, bucket, out_dtype, normalize)
    if pages.device.type == "cpu":
        return warp_lines_plain(pages, baselines, heights, crop_h, bucket, out_dtype, normalize)
    pb, h, w = pages.shape
    n, p = baselines.shape[1], baselines.shape[2]
    out = torch.empty((pb * n, crop_h, bucket), dtype=out_dtype, device=pages.device)
    lib = _kernel_library()
    rc = lib.warp_lines_u8(
        pages.data_ptr(), baselines.data_ptr(), heights.data_ptr(), out.data_ptr(),
        pb, h, w, n, p, crop_h, bucket, int(out_dtype == torch.bfloat16), int(normalize),
        torch.cuda.current_stream(pages.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"warp_lines kernel launch failed: cudaError_t {rc}")
    warp_lines.launches += 1
    return out


warp_lines.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel_library():
    from pero_ocr_tpu_torch.utils import kernels

    lib = kernels.library("warp_lines")
    lib.warp_lines_u8.restype = ctypes.c_int
    lib.warp_lines_u8.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    return lib


# ----------------------------------------------------------------------
# The Pallas kernel's own contract: sample a page at precomputed fields.
FIELD_STORES = ("f32", "u8")


def width_buckets(widths: Sequence[int], buckets: Sequence[int]) -> List[List[int]]:
    """Group line indices by the smallest bucket that fits their width;
    lines wider than the largest bucket land in the largest (and are cut
    there)."""
    buckets = sorted(buckets)
    groups: List[List[int]] = [[] for _ in buckets]
    for idx, w in enumerate(widths):
        for bi, b in enumerate(buckets):
            if w <= b:
                groups[bi].append(idx)
                break
        else:
            groups[-1].append(idx)
    return groups


def pad_fields(fields: Sequence[np.ndarray], width_bucket: int,
               pad_coord: float = OFF_PAGE,
               out: np.ndarray = None) -> Tuple[np.ndarray, np.ndarray]:
    """Stack (Hc, W_i, 2) warp fields into one (N, Hc, width_bucket, 2)
    float32 array, or into ``out`` (a view of a :func:`field_buffer`);
    padded columns carry ``pad_coord`` (they sample 0).  Returns
    (stacked, widths kept)."""
    n = len(fields)
    hc = fields[0].shape[0]
    if out is None:
        out = np.empty((n, hc, width_bucket, 2), dtype=np.float32)
    widths = np.zeros(n, dtype=np.int32)
    for i, f in enumerate(fields):
        wi = min(f.shape[1], width_bucket)
        out[i, :, :wi] = f[:, :wi]
        out[i, :, wi:] = pad_coord
        widths[i] = wi
    return out, widths


Shape3 = Tuple[int, int, int]


def field_layout(shapes: Sequence[Shape3]) -> Tuple[List[int], int]:
    """Where buckets of (N, Hc, Wb) samples lie in one packed buffer, back
    to back, in samples.  Returns (offsets, total)."""
    offsets, total = [], 0
    for n, hc, wb in shapes:
        offsets.append(total)
        total += n * hc * wb
    return offsets, total


def field_buffer(shapes: Sequence[Shape3]) -> np.ndarray:
    """An empty flat float32 buffer for the fields of ``shapes`` laid out
    by :func:`field_layout` (:func:`split_fields` gives its buckets)."""
    return np.empty(2 * field_layout(shapes)[1], dtype=np.float32)


def split_fields(buffer, shapes: Sequence[Shape3], channels: int = 2) -> list:
    """The (N, Hc, Wb, channels) views of a flat buffer (numpy or torch)
    laid out by :func:`field_layout`: the fields (2 channels), or the
    crops that one :func:`warp_fields` call over the whole buffer gives
    for them (C channels)."""
    offsets, _ = field_layout(shapes)
    return [buffer[channels * o: channels * (o + n * hc * wb)].reshape(n, hc, wb, channels)
            for o, (n, hc, wb) in zip(offsets, shapes)]


def warp_fields_plain(page: torch.Tensor, fields: torch.Tensor, store: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of the field warp: ``_bilinear_gather``
    (pero_ocr_tpu/ops/warp.py:32-62) of an (H, W, C) page at (N, Hc, Wb,
    2) fields, in its order of operations, widened to C channels.  A
    sample whose x or y is not finite reads 0; the floor of a coordinate
    is clamped to [-2, W + 1] (rows: [-2, H + 1]) before it becomes an
    integer, which changes no tap (each one off the page reads 0 either
    way).  ``store``: "f32" gives (N, Hc, Wb, C) float32; "u8" rounds
    half to even and clamps to [0, 255] into uint8, as ``LineCropper``
    does after the warp."""
    h, w, c = page.shape
    flat = page.float().reshape(h * w, c)
    x, y = fields[..., 0], fields[..., 1]
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(finite, x, OFF_PAGE)
    y = torch.where(finite, y, OFF_PAGE)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i = x0.clamp(-2.0, w + 1.0).long()
    y0i = y0.clamp(-2.0, h + 1.0).long()

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = flat[yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], vals, 0.0)

    top = tap(y0i, x0i) * (1.0 - fx) + tap(y0i, x0i + 1) * fx
    bottom = tap(y0i + 1, x0i) * (1.0 - fx) + tap(y0i + 1, x0i + 1) * fx
    out = top * (1.0 - fy) + bottom * fy
    if store == "u8":
        return torch.round(out).clamp(0.0, 255.0).to(torch.uint8)
    return out


def warp_fields_bytes(page: torch.Tensor, fields: torch.Tensor, store: str = "f32") -> int:
    """Least bytes the field warp moves on these inputs: the distinct
    page pixels that the finite samples' four taps touch on the page (C
    channels each), the whole field (8 bytes a sample) and the crops
    written once at the store's width."""
    h, w, c = page.shape
    x, y = fields[..., 0].reshape(-1), fields[..., 1].reshape(-1)
    finite = torch.isfinite(x) & torch.isfinite(y)
    x0 = torch.floor(torch.where(finite, x, OFF_PAGE)).clamp(-2.0, w + 1.0).long()
    y0 = torch.floor(torch.where(finite, y, OFF_PAGE)).clamp(-2.0, h + 1.0).long()
    touched = torch.zeros(h * w, dtype=torch.bool, device=fields.device)
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            touched[(yi * w + xi)[inside]] = True
    out = x.numel() * c * (1 if store == "u8" else 4)
    return int(touched.sum()) * c * page.element_size() + fields.numel() * 4 + out


def _check_field_args(page, fields, store):
    if page.ndim != 3 or page.shape[2] not in (1, 3) or page.dtype not in (torch.uint8,
                                                                             torch.float32):
        raise ValueError(f"warp_fields: page must be (H, W, 1 or 3) uint8 or float32, got "
                         f"{page.dtype} {tuple(page.shape)}")
    if fields.ndim != 4 or fields.shape[3] != 2 or fields.dtype != torch.float32:
        raise ValueError(f"warp_fields: fields must be (N, Hc, Wb, 2) float32, got "
                         f"{fields.dtype} {tuple(fields.shape)}")
    if fields.device != page.device or not (page.is_contiguous() and fields.is_contiguous()):
        raise ValueError(f"warp_fields: page and fields must be contiguous on one device, got "
                         f"{page.device} and {fields.device}")
    if store not in FIELD_STORES:
        raise ValueError(f"warp_fields: store must be one of {FIELD_STORES}, got {store!r}")
    h, w = page.shape[:2]
    if not (1 <= h < 2**22 and 1 <= w < 2**22):
        raise ValueError(f"warp_fields: needs 1 <= H, W < 2**22, got {h}x{w}")


def warp_fields(page: torch.Tensor, fields: torch.Tensor, store: str = "f32") -> torch.Tensor:
    """page (H, W, C) uint8 or float32, C in {1, 3}; fields (N, Hc, Wb,
    2) float32 -> (N, Hc, Wb, C) crops, float32 (``store="f32"``) or
    uint8 rounded half to even and clamped (``store="u8"``).

    CUDA tensors launch ``csrc/warp_fields.cu`` (and count the launch in
    ``warp_fields.launches``); CPU tensors run
    :func:`warp_fields_plain`.  Both raise ValueError on arguments the
    kernel does not take; a failed build or launch raises."""
    if page.device.type not in ("cpu", "cuda"):
        raise ValueError(f"warp_fields: unsupported device {page.device}")
    _check_field_args(page, fields, store)
    if page.device.type == "cpu":
        return warp_fields_plain(page, fields, store)
    h, w, c = page.shape
    out_dtype = torch.uint8 if store == "u8" else torch.float32
    out = torch.empty(tuple(fields.shape[:3]) + (c,), dtype=out_dtype, device=page.device)
    if out.numel() == 0:
        return out
    if fields.data_ptr() % 8:
        raise ValueError("warp_fields: fields must be 8-byte aligned (one float2 a sample)")
    rc = _fields_library().warp_fields(
        page.data_ptr(), fields.data_ptr(), out.data_ptr(), h, w, c,
        fields.shape[0] * fields.shape[1] * fields.shape[2],
        int(page.dtype == torch.float32), int(store == "u8"),
        torch.cuda.current_stream(page.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"warp_fields kernel launch failed: cudaError_t {rc}")
    warp_fields.launches += 1
    return out


warp_fields.launches = 0


@functools.lru_cache(maxsize=None)
def _fields_library():
    from pero_ocr_tpu_torch.utils import kernels

    lib = kernels.library("warp_fields")
    lib.warp_fields.restype = ctypes.c_int
    lib.warp_fields.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    return lib
