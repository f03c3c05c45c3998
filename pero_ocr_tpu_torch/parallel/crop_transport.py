"""The crop transport of the page pipeline (port of the ``transport="crops"``
half of pero_ocr_tpu/parallel/pipeline.py).

Full pages never reach the device.  Per batch of pages:

- **Host prep** (worker thread): grayscale, the 1/(ds * map_upsample)
  layout canvas (:func:`~pero_ocr_tpu_torch.utils.resize.resize_area`,
  cv2's ``INTER_AREA``) padded to multiples of 64 and packed at
  ``canvas_bits``.
- **Stage A** (device): the canvas is unpacked and goes through the same
  ParseNet and map post-processing as on the page transport; its packed
  artifacts come back to the host.
- **Host geometry and warp** (a second worker thread): the packed
  baseline mask is parsed straight into lines (``cc_lines_packed``,
  numbered by each component's first mask pixel), the paragraphs are
  clustered, and every line is warped on the host: a straight line by one
  inverse-affine map (the port's C++ ``warp_affine_lines_u8`` or its
  numpy twin :func:`warp_affine_lines`), a curved one by its measured
  warp field (:func:`~pero_ocr_tpu_torch.utils.resize.remap_linear`,
  cv2's ``remap``).  The crops travel width-trimmed (``trim_crops``: one
  width-major strip of every line's valid columns, packed along the
  height at ``transport_bits``, with per-line offsets and widths) or as
  the dense (lines, Hc, crop_bucket) buffer.
- **Stage B** (device): the crops are unpacked (the strip rebuilt into
  the bucketed crop tensor by one index gather, masked past each width),
  recognized over each line's valid frames, and the labels cast to
  uint8 when every label id fits.

Recognition trails stage A by ``crop_lag`` batches (the JAX loop's lag,
whose flush dispatches become recognize-only calls here), so a batch's
host warp runs while the next batch's stage A is on the device.  With a
``lines_override`` (classical layouts, re-OCR of existing Page XML)
:meth:`CropTransport._run_crops_override` runs instead: stage A still
runs unless ``skip_stage_a`` but is never read, each batch's crops go
with it, and label copies trail by ``override_inflight`` batches.  The
order and contents of the results equal the JAX loops'.

Under a device mesh each dp shard's canvases go to its device for stage
A; for stage B the strip (whose columns hold lines of every page) goes
to every shard's device with that shard's line offsets and widths, and
each device rebuilds only its shard's lines (the dense buffer splits by
page), as the JAX loops shard them.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from pero_ocr_tpu_torch.core import line_geometry
from pero_ocr_tpu_torch.ops.morphology import connected_components
from pero_ocr_tpu_torch.parallel.mesh import indexed_device
from pero_ocr_tpu_torch.utils import native as native_lib
from pero_ocr_tpu_torch.utils.resize import remap_linear, resize_area
from pero_ocr_tpu_torch.utils.timing import stage_timer

# Components a page that the packed parse emits before it gives up
# (``cc_lines_packed``'s max_comps); past it the page is labeled unpacked.
MAX_PACKED_COMPONENTS = 4096


def warp_affine_lines(gray: np.ndarray, mats: np.ndarray, widths: np.ndarray, crop_h: int,
                      out: np.ndarray, offsets: np.ndarray, stride_col: int,
                      stride_row: int) -> None:
    """Numpy twin of ``warp_affine_lines_u8``'s scalar body: line n's
    pixel (row y, column x) samples ``gray`` bilinearly at
    ``sx = m[0] x + m[1] y + m[2]``, ``sy = m[3] x + m[4] y + m[5]``,
    the coordinates accumulated along the row in float64, the blend in
    float32, rounded half up; taps off the page read 0, and a sample
    with no tap on the page is 0.  It lands at ``out.flat[offsets[n] +
    x * stride_col + y * stride_row]``."""
    h, w = gray.shape
    flat = out.reshape(-1)
    rows = np.arange(crop_h)
    for m, width, off in zip(np.asarray(mats, np.float64).reshape(-1, 6), widths, offsets):
        width = int(width)
        if width <= 0:
            continue
        coords = []
        for step, row_step, origin in ((m[0], m[1], m[2]), (m[3], m[4], m[5])):
            acc = np.empty((crop_h, width))
            acc[:, 0] = row_step * rows + origin
            acc[:, 1:] = step
            coords.append(np.cumsum(acc, axis=1))  # sequential, as sx += m[0]
        sx, sy = coords
        fx0, fy0 = np.floor(sx), np.floor(sy)
        fx = (sx - fx0).astype(np.float32)
        fy = (sy - fy0).astype(np.float32)
        x0 = np.clip(fx0, -2, w + 1).astype(np.int64)
        y0 = np.clip(fy0, -2, h + 1).astype(np.int64)

        def tap(yy, xx):
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            return np.where(inside, gray[yy.clip(0, h - 1), xx.clip(0, w - 1)],
                            0).astype(np.float32)

        p00, p01 = tap(y0, x0), tap(y0, x0 + 1)
        p10, p11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
        top = p00 + fx * (p01 - p00)
        bot = p10 + fx * (p11 - p10)
        v = top + fy * (bot - top)
        near = (x0 >= -1) & (x0 < w) & (y0 >= -1) & (y0 < h)
        values = np.where(near, np.clip(v + np.float32(0.5), 0, 255), 0).astype(np.uint8)
        cols = np.arange(width)
        flat[off + cols[None, :] * stride_col + rows[:, None] * stride_row] = values


def unpack_bits(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., W * bits / 8) uint8 -> (..., W) uint8: two 4-bit pixels a
    byte (high nibble first, q * 17) or four 2-bit pixels (lowest bits
    first, q * 85); 8 bits pass through."""
    if bits == 8:
        return packed
    if bits == 4:
        parts = [(packed >> 4) * 17, (packed & 0xF) * 17]
    elif bits == 2:
        parts = [((packed >> (2 * i)) & 0x3) * 85 for i in range(4)]
    else:
        raise ValueError(f"unpack_bits: {bits} bits")
    return torch.stack(parts, dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * len(parts))


class StageAArtifacts:
    """One batch's stage-A artifacts on the host (packed 1-bit masks,
    quarter-pixel heights, 4-bit separator), unpacked only on demand:
    the crop transport parses the packed mask directly."""

    __slots__ = ("packed", "heights_q", "sep_q", "_pipe", "_unpacked")

    def __init__(self, packed, heights_q, sep_q, pipe):
        self.packed = packed
        self.heights_q = heights_q
        self.sep_q = sep_q
        self._pipe = pipe
        self._unpacked = None

    @property
    def unpacked(self):
        """``_unpack_stage_a``'s (masks, dilated masks, heights, pooled
        separator)."""
        if self._unpacked is None:
            self._unpacked = self._pipe._unpack_stage_a(self.packed, self.heights_q, self.sep_q)
        return self._unpacked

    @property
    def sep_pooled(self):
        """(separator at its pooled resolution as floats, pool factor)."""
        sep = np.stack([self.sep_q >> 4, self.sep_q & 0xF], axis=-1).reshape(
            self.sep_q.shape[0], self.sep_q.shape[1], self.sep_q.shape[2] * 2)
        return sep.astype(np.float32) / 15.0, self.packed.shape[1] // sep.shape[1]


class CropTransport:
    """The crop transport's host code, device programs and loops, mixed
    into :class:`~pero_ocr_tpu_torch.parallel.pipeline.TorchPagePipeline`
    (which holds the models, the stage-A programs and the layout parse)."""

    # Zero-mean 2x2 Bayer offsets (gray levels) for the 2-bit quantizer.
    _BAYER2 = np.array([[-32, 11], [32, -11]], np.int16)
    # A line whose interior points lie within this many px of its chord
    # is straight and takes the affine warp.
    STRAIGHT_TOL_PX = 0.75
    # Floor, in columns, of the strip's power-of-two width ladder.
    STRIP_MIN_COLS = 1024

    # ------------------------------------------------------------------
    # Packing
    @classmethod
    def _pack2(cls, grays: np.ndarray, dither: bool = False) -> np.ndarray:
        """(N, H, W) uint8 -> (N, H, W/4) 2-bit quads, W a multiple of 4,
        decoded as q * 85; ``dither`` adds the Bayer offsets first."""
        offs = 0
        if dither:
            h, w = grays.shape[1], grays.shape[2]
            offs = cls._BAYER2[np.ix_(np.arange(h) & 1, np.arange(w) & 1)]
        q = np.clip((grays.astype(np.int16) + 42 + offs) // 85, 0, 3).astype(np.uint8)
        return q[:, :, 0::4] | (q[:, :, 1::4] << 2) | (q[:, :, 2::4] << 4) | (q[:, :, 3::4] << 6)

    def _pack_canvas(self, small: np.ndarray) -> np.ndarray:
        """The layout canvas at ``canvas_bits`` (plain rounding at 2)."""
        if self.canvas_bits == 4:
            return self._pack4(small)
        if self.canvas_bits == 2:
            return self._pack2(small)
        return small

    def _unpack_canvas_dev(self, small_dev: torch.Tensor) -> torch.Tensor:
        return unpack_bits(small_dev, self.canvas_bits)

    def _pack_strip(self, strip: np.ndarray) -> np.ndarray:
        """The (W, Hc) strip packed along the height, so a column's
        offset does not depend on ``transport_bits``."""
        if self.transport_bits == 4:
            return self._pack4(strip[None])[0]
        if self.transport_bits == 2:
            return self._pack2(strip[None], self.dither_2bit)[0]
        return strip

    def _pack_crops(self, flat: np.ndarray) -> np.ndarray:
        if self.transport_bits == 4:
            return self._pack4(flat)
        if self.transport_bits == 2:
            return self._pack2(flat, self.dither_2bit)
        return flat

    # ------------------------------------------------------------------
    # Host prep
    def _canvas(self, page: np.ndarray, ds: Optional[int] = None) -> np.ndarray:
        """The 1/(ds * map_upsample) layout canvas for map scale ``ds``,
        zero-padded to multiples of 64."""
        ds = self.downsample if ds is None else ds
        small = resize_area(page, ds * self.map_upsample)
        h = -(-small.shape[0] // 64) * 64
        w = -(-small.shape[1] // 64) * 64
        canvas = np.zeros((h, w), np.uint8)
        canvas[: small.shape[0], : small.shape[1]] = small
        return canvas

    def _prep_canvas_batch(self, pages, ids, page_batch: int, ds0: Optional[int] = None):
        """Grayscale pages (the last repeated to ``page_batch``) and
        their packed canvases at ``ds0`` (None: the sticky scale now)."""
        padded = ids + [ids[-1]] * (page_batch - len(ids))
        grays = self._stack_grays(self._gray(pages[i]) for i in padded)
        ds0 = self._first_pass_ds() if ds0 is None else ds0
        small = np.stack([self._canvas(g, ds0) for g in grays])
        return grays, self._pack_canvas(small), ds0

    def prime(self, pages, page_batch: int = 8) -> None:
        """Start the first batch's host prep on a background thread
        before :meth:`run` is called with the same leading pages (the
        same objects) and batch size; :meth:`run` then takes it up.
        Only the crop transport's detection loop uses it."""
        if self.transport != "crops":
            return
        first = list(pages[: min(page_batch, len(pages))])
        if not first:
            return
        pool = ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(self._prep_canvas_batch, first, list(range(len(first))), page_batch)
        pool.shutdown(wait=False)
        self._primed = (first, page_batch, fut)

    def _take_primed(self, pages, page_batch: int):
        """The primed prep if it was made for these leading pages and
        batch size, else None; the primed state is used up either way."""
        primed = getattr(self, "_primed", None)
        if primed is None:
            return None
        self._primed = None
        first, pb, fut = primed
        n = min(page_batch, len(pages))
        if pb != page_batch or len(first) != n:
            return None
        if any(a is not b for a, b in zip(first, pages[:n])):
            return None
        return fut

    # ------------------------------------------------------------------
    # Host line warp
    def _line_affine(self, bl, hh):
        """(2x3 inverse map, width) of a straight baseline, or None for
        a curved one: output column j at arc position j / scale along the
        chord, row r at linspace(-asc, desc) along the normal."""
        bl = np.asarray(bl, float)
        asc, desc = np.asarray(hh, float) * self.height_scale
        chord = bl[-1] - bl[0]
        clen = float(np.hypot(chord[0], chord[1]))
        hc = self.crop_height
        scale = hc / max(asc + desc, 1e-6)
        dev = 0.0
        if len(bl) > 2 and clen > 1e-6:
            u = chord / clen
            rel = bl - bl[0]
            dev = float(np.abs(rel[:, 0] * u[1] - rel[:, 1] * u[0]).max())
        if dev > self.STRAIGHT_TOL_PX or clen <= 1e-6:
            return None
        w = max(min(int(clen * scale), self.crop_bucket), 1)
        u = chord / clen
        nvec = np.array([-u[1], u[0]])
        dv = (asc + desc) / max(hc - 1, 1)
        p0 = bl[0] + nvec * (-asc)
        m = np.array([[u[0] / scale, nvec[0] * dv, p0[0]],
                      [u[1] / scale, nvec[1] * dv, p0[1]]])
        return m, w

    def _curved_crop(self, gray: np.ndarray, bl, hh) -> np.ndarray:
        """A curved line through its measured warp field (the staged
        cropper's) and cv2's bilinear remap."""
        field = line_geometry.warp_field(
            np.asarray(bl, float), np.asarray(hh, float) * self.height_scale, self.crop_height)
        w = min(field.shape[1], self.crop_bucket)
        return remap_linear(gray, field[:, :w, 0], field[:, :w, 1])

    def _warp_straight_batch(self, gray, entries, out, offsets_elem, stride_col, stride_row):
        """One page's straight lines, ``entries`` (matrix, width), into
        ``out`` at element offsets ``offsets_elem``: one C++ call on the
        native route, the numpy twin otherwise."""
        if not entries:
            return
        mats = np.stack([m for m, _ in entries])
        widths = np.asarray([w for _, w in entries], np.int32)
        warp = native_lib.native_warp_affine_lines if self.native else warp_affine_lines
        warp(gray, mats, widths, self.crop_height, out, np.asarray(offsets_elem, np.int64),
             stride_col, stride_row)

    def _host_crop_line(self, gray: np.ndarray, bl, hh) -> np.ndarray:
        """One line's (crop_height, w) uint8 crop, as the crop transport
        warps it."""
        aff = self._line_affine(bl, hh)
        if aff is None:
            return self._curved_crop(gray, bl, hh)
        m, w = aff
        out = np.zeros((self.crop_height, w), np.uint8)
        self._warp_straight_batch(gray, [aff], out, [0], 1, w)
        return out

    def _host_crops(self, gray: np.ndarray, b_list, h_list, n_slot: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """The dense buffer of one page: (n_slot, Hc, crop_bucket) crops,
        zero-padded, and their widths."""
        hc, bucket = self.crop_height, self.crop_bucket
        crops = np.zeros((n_slot, hc, bucket), np.uint8)
        widths = np.zeros(n_slot, np.int32)
        straight, offs = [], []
        for i, (bl, hh) in enumerate(zip(b_list, h_list)):
            aff = self._line_affine(bl, hh)
            if aff is None:
                crop = self._curved_crop(gray, bl, hh)
                w = crop.shape[1]
                crops[i, :, :w] = crop
            else:
                w = aff[1]
                straight.append(aff)
                offs.append(i * hc * bucket)
            widths[i] = w
        self._warp_straight_batch(gray, straight, crops, offs, stride_col=1, stride_row=bucket)
        return crops, widths

    # ------------------------------------------------------------------
    # The width-trimmed strip
    def _rebuild_step(self) -> int:
        """The rebuild widths' quantum: a quarter of crop_bucket, at
        least 256."""
        return max(256, self.crop_bucket // 4)

    def _rebuild_width(self, widths) -> int:
        """The smallest rebuild width on the ladder that holds the
        batch's widest crop."""
        step = self._rebuild_step()
        mx = int(widths.max()) if getattr(widths, "size", 0) else 0
        return int(min(self.crop_bucket, max(step, -(-mx // step) * step)))

    def _strip_cols(self, total: int) -> int:
        floor = max(self.STRIP_MIN_COLS, 2 * self.crop_bucket)
        return max(floor, 1 << int(np.ceil(np.log2(max(total, 1)))))

    def _build_strip(self, grays, page_lines, n_slot: int, page_batch: int):
        """Every line's valid columns, one after another, in one
        width-major (W, Hc) strip (W on the power-of-two ladder, packed
        along Hc) with per-line offsets and widths over page_batch *
        n_slot slots.  Straight lines warp straight into the strip, one
        call a page.  Returns ((strip, offsets, widths) or None, each
        page's widths or None)."""
        hc = self.crop_height
        n_total = page_batch * n_slot
        offsets = np.zeros(n_total, np.int32)
        widths = np.zeros(n_total, np.int32)
        straight = {}    # slot -> ([(m, w)], [flat index])
        curved = []      # (flat index, (Hc, w) crop)
        total = 0
        widths_all = []
        for slot, (b_list, h_list, *_) in enumerate(page_lines):
            if not b_list:
                widths_all.append(None)
                continue
            for i, (bl, hh) in enumerate(zip(b_list, h_list)):
                j = slot * n_slot + i
                aff = self._line_affine(bl, hh)
                if aff is None:
                    crop = self._curved_crop(grays[slot], bl, hh)
                    w = crop.shape[1]
                    curved.append((j, crop))
                else:
                    w = aff[1]
                    entries, idxs = straight.setdefault(slot, ([], []))
                    entries.append(aff)
                    idxs.append(j)
                offsets[j] = total
                widths[j] = w
                total += w
            widths_all.append(widths[slot * n_slot: slot * n_slot + len(b_list)].copy())
        if total == 0:
            return None, widths_all
        strip = np.zeros((self._strip_cols(total), hc), np.uint8)
        for slot, (entries, idxs) in straight.items():
            self._warp_straight_batch(grays[slot], entries, strip,
                                      [offsets[j] * hc for j in idxs], stride_col=hc,
                                      stride_row=1)
        for j, crop in curved:
            strip[offsets[j]: offsets[j] + widths[j]] = crop.T
        return (self._pack_strip(strip), offsets, widths), widths_all

    def _crop_payload(self, grays, page_lines, max_n: int, n_slot: int, page_batch: int):
        """One batch's crops as they travel: the strip (``trim_crops``)
        or the packed dense buffer and its widths; None without lines.
        Also returns each page's widths."""
        if self.trim_crops:
            return self._build_strip(grays, page_lines, n_slot, page_batch)
        if max_n == 0:
            return None, [None] * len(page_lines)
        crop_stack = np.zeros((page_batch, n_slot, self.crop_height, self.crop_bucket), np.uint8)
        widths_flat = np.zeros(page_batch * n_slot, np.int32)
        widths_all = []
        for slot, (b_list, h_list, *_) in enumerate(page_lines):
            if not b_list:
                widths_all.append(None)
                continue
            crop_stack[slot], w = self._host_crops(grays[slot], b_list, h_list, n_slot)
            widths_all.append(w[: len(b_list)])
            widths_flat[slot * n_slot: slot * n_slot + len(b_list)] = w[: len(b_list)]
        flat = crop_stack.reshape(page_batch * n_slot, self.crop_height, self.crop_bucket)
        with stage_timer("pipeline/pack_crops"):
            flat = self._pack_crops(flat)
        return (flat, widths_flat), widths_all

    # ------------------------------------------------------------------
    # The layout parse of the packed mask
    def _lines_from_packed(self, packed_page, heights_q_page, ds=None):
        """One page's (baselines, heights) from its packed mask, the
        components in the order of their first mask pixel; None past
        MAX_PACKED_COMPONENTS components (the caller labels the unpacked
        mask instead).  ``cc_lines_packed`` on the native route, its
        numpy twin otherwise."""
        ds = self.downsample if ds is None else ds
        hf = packed_page.shape[0] // heights_q_page.shape[0]
        if not self.native:
            return self._packed_lines_numpy(packed_page, heights_q_page, ds)
        out = native_lib.native_cc_lines_packed(packed_page, heights_q_page, hf,
                                                max_comps=MAX_PACKED_COMPONENTS)
        if out is None:
            return None
        pts, npts, hts, n = out[:4]
        return ([ds * pts[c, : npts[c]].copy() for c in range(n)],
                [[ds * float(hts[c, 0]), ds * float(hts[c, 1])] for c in range(n)])

    def _packed_lines_numpy(self, packed_page, heights_q_page, ds):
        """Numpy twin of ``cc_lines_packed``'s lines: unpack, dilate,
        label, renumber the components by their first mask pixel in
        raster order, then the component lines."""
        masks, connecteds, heights_maps, _ = self._unpack_stage_a(
            packed_page[None], heights_q_page[None], np.zeros((1, 1, 1), np.uint8))
        labels_img, _ = connected_components(connecteds[0], False)
        labels = (labels_img * masks[0]).ravel()
        present, first = np.unique(labels[labels > 0], return_index=True)
        order = present[np.argsort(first)]
        renumber = np.zeros(labels_img.max() + 1, np.int32)
        renumber[order] = np.arange(1, len(order) + 1)
        relabelled = renumber[labels].reshape(labels_img.shape)
        sizes = np.bincount(relabelled.ravel(), minlength=len(order) + 1)[1:]
        if int((sizes > 5).sum()) > MAX_PACKED_COMPONENTS:
            return None
        return self._component_lines(relabelled, len(order), heights_maps[0], ds)

    def _adapt_artifacts(self, arts: StageAArtifacts, ds_used: int) -> Optional[int]:
        """The adaptive decision from the packed artifacts:
        ``cc_lines_packed``'s set-bit counts and channel-0 histograms on
        the native route (the batch median exactly), the unpacked maps
        otherwise or past the component budget."""
        if not self.native:
            return self._adapt_target_ds(arts.unpacked, ds_used)
        total, hist = 0, np.zeros(256, np.int64)
        for slot in range(arts.packed.shape[0]):
            out = native_lib.native_cc_lines_packed(
                arts.packed[slot], arts.heights_q[slot],
                arts.packed.shape[1] // arts.heights_q.shape[1], max_comps=MAX_PACKED_COMPONENTS)
            if out is None:
                return self._adapt_target_ds(arts.unpacked, ds_used)
            total += out[4]
            hist += out[5]
        return self._adapt_from_stats(total, hist, ds_used)

    def _adapt_from_stats(self, total_px: int, hist0, ds_used: int) -> Optional[int]:
        """``_adapt_target_ds``'s decision from the set-bit count and the
        histogram of channel-0 quarter pixels under the set bits."""
        if total_px <= self.ADAPT_PIXEL_THRESHOLD:
            return None
        cum = np.cumsum(hist0)
        n = int(cum[-1])
        mid_hi = int(np.searchsorted(cum, n // 2 + 1))
        if n % 2 == 1:
            med_q = float(mid_hi)
        else:
            med_q = 0.5 * (int(np.searchsorted(cum, n // 2)) + mid_hi)
        return self._adapt_decide(med_q / 4.0, ds_used)

    # ------------------------------------------------------------------
    # Device programs
    def _normalize(self, crops_u8: torch.Tensor) -> torch.Tensor:
        """uint8 crops -> v / 255 (a true division) in float32, then the
        recognizer's input dtype."""
        return (crops_u8.float() / self._255s[indexed_device(crops_u8.device)]).to(
            self.crop_dtype)

    @torch.no_grad()
    def stage_a_canvas(self, small_u8: torch.Tensor):
        """Stage A on a packed canvas already on the device."""
        return self.maps_and_pack(self._unpack_canvas_dev(small_u8).float())

    @torch.no_grad()
    def stage_b_crops(self, crops_u8: torch.Tensor, widths: torch.Tensor, pb: int):
        """The dense buffer: (PB * N, Hc, Wb * bits / 8) packed crops and
        their (PB * N,) widths -> stage B's outputs."""
        crops = unpack_bits(crops_u8, self.transport_bits)
        return self.stage_b_recognize(self._normalize(crops), pb, widths)

    @torch.no_grad()
    def rebuild_strip(self, strip_u8: torch.Tensor, offsets: torch.Tensor,
                      widths: torch.Tensor, rw: int) -> torch.Tensor:
        """The (Ws, Hc * bits / 8) packed strip -> (PB * N, Hc, rw) uint8
        crops: line j's columns offsets[j] .. offsets[j] + rw (the
        strip padded with rw zero columns), zero from widths[j] on."""
        strip = unpack_bits(strip_u8, self.transport_bits)
        strip = torch.cat([strip, strip.new_zeros((rw, strip.shape[1]))])
        cols = torch.arange(rw, device=strip.device)
        gathered = strip[offsets.long()[:, None] + cols[None, :]]  # (N, rw, Hc)
        gathered = torch.where(cols[None, :, None] < widths[:, None, None], gathered, 0)
        return gathered.transpose(1, 2)

    @torch.no_grad()
    def stage_b_strip(self, strip_u8, offsets, widths, pb: int, rw: int):
        """The width-trimmed strip -> stage B's outputs, recognized at
        the rebuild width ``rw``."""
        crops = self.rebuild_strip(strip_u8, offsets, widths, rw)
        return self.stage_b_recognize(self._normalize(crops), pb, widths)

    def _label_bytes(self, outs):
        """Stage B's outputs with the labels cast to uint8 when every
        label id (and the -1 pad, as 255) fits a byte."""
        labels, *rest = outs
        if self.recognizer_max_label <= 254:
            labels = labels.to(torch.uint8)
        return (labels, *rest)

    def _recognize_payload(self, payload, page_batch: int):
        """Upload one batch's crop payload and recognize it; None for a
        batch without lines, else each shard's outputs on its device.
        Under a mesh each shard gets its pages' slots of the dense buffer,
        or the whole strip with its slots' offsets and widths (the strip
        holds lines of every page, so it goes to every device)."""
        if payload is None:
            return None
        n = payload[-1].shape[0] // page_batch  # line slots a page
        outs = []
        with stage_timer("pipeline/stage_b"):
            for dev, slots in self._shards(page_batch):
                lines = slice(slots.start * n, slots.stop * n)
                pb = slots.stop - slots.start
                if self.trim_crops:
                    strip, offsets, widths = payload
                    dev_args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                for a in (strip, offsets[lines], widths[lines])]
                    out = self.stage_b_strip(*dev_args, pb, self._rebuild_width(widths))
                else:
                    dev_args = [torch.from_numpy(np.ascontiguousarray(a[lines])).to(dev)
                                for a in payload]
                    out = self.stage_b_crops(*dev_args, pb)
                outs.append(self._label_bytes(out))
        return outs

    def _stage_a_shards(self, small: np.ndarray):
        """Upload a packed canvas batch, each shard's pages to its device,
        and run stage A on each: the shards' outputs on their devices."""
        return [self.stage_a_canvas(torch.from_numpy(small[slots]).to(dev))
                for dev, slots in self._shards(small.shape[0])]

    def _stage_a_artifacts(self, small: np.ndarray) -> StageAArtifacts:
        """Stage A on a packed canvas batch, its artifacts copied back to
        the host in page order."""
        with stage_timer("pipeline/stage_a_sync"):
            return StageAArtifacts(*self._host(self._stage_a_shards(small)), self)

    # ------------------------------------------------------------------
    # Loops
    def _run_crops(self, pages, page_batch: int):
        """CNN detection on the crop transport: stage A of batch i, then
        the host parse and warp of batch i on a worker thread while the
        device recognizes batch i - crop_lag; the last crop_lag batches
        are recognized after the loop.  Labels are copied one batch
        behind."""
        n = len(pages)
        batches = [list(range(s, min(s + page_batch, n))) for s in range(0, n, page_batch)]
        n_batches = len(batches)
        lag = min(self.crop_lag, 2 if n_batches > 1 else 1)

        def geometry_and_warp(bi, grays, arts, ds_used):
            ids = batches[bi]
            with stage_timer("pipeline/host_geometry"):
                page_lines, max_n, n_slot = self._batch_lines(pages, ids, None, arts, ds_used)
            with stage_timer("pipeline/host_warp"):
                payload, widths_all = self._crop_payload(grays, page_lines, max_n, n_slot,
                                                         page_batch)
            geoms = [(b, h, w, c, t) for (b, h, c, t), w in zip(page_lines, widths_all)]
            return ids, geoms, payload

        inflight: deque = deque()
        with ThreadPoolExecutor(max_workers=1) as uploader, \
                ThreadPoolExecutor(max_workers=1) as warper:
            prep_f = self._take_primed(pages, page_batch)
            if prep_f is None:
                prep_f = uploader.submit(self._prep_canvas_batch, pages, batches[0], page_batch,
                                         self._first_pass_ds())
            warp_futures = {}
            for bi in range(n_batches + lag):
                if bi < n_batches:
                    with stage_timer("pipeline/prep"):
                        grays, small, ds_used = prep_f.result()
                    if bi + 1 < n_batches:
                        prep_f = uploader.submit(self._prep_canvas_batch, pages, batches[bi + 1],
                                                 page_batch, self._first_pass_ds())
                    arts = self._stage_a_artifacts(small)
                    if self.adaptive_downsample:
                        ds2 = self._adapt_artifacts(arts, ds_used)
                        if ds2 is not None:
                            # The corrected canvas from the host's pages,
                            # packed as a first pass would ship it.
                            with stage_timer("pipeline/stage_a_second_pass"):
                                small2 = np.stack([self._canvas(g, ds2) for g in grays])
                                arts = self._stage_a_artifacts(self._pack_canvas(small2))
                            ds_used = ds2
                    warp_futures[bi] = warper.submit(geometry_and_warp, bi, grays, arts, ds_used)
                if bi >= lag:
                    with stage_timer("pipeline/warp_wait"):
                        ids, geoms, payload = warp_futures.pop(bi - lag).result()
                    inflight.append((ids, geoms, self._recognize_payload(payload, page_batch)))
                while len(inflight) > 1:
                    yield from self._drain(*inflight.popleft())
        while inflight:
            yield from self._drain(*inflight.popleft())

    def _run_crops_override(self, pages, lines_override, page_batch: int,
                            skip_stage_a: bool = False):
        """The crop transport with given lines: host prep, geometry and
        warp on one worker thread two batches ahead; each batch's crops
        are recognized with it; stage A runs (unless ``skip_stage_a``)
        and is never read; label copies trail by ``override_inflight``
        batches.  ``skip_stage_a`` never stacks the pages, so a stream
        may mix page sizes."""
        n = len(pages)
        batches = [list(range(s, min(s + page_batch, n))) for s in range(0, n, page_batch)]
        n_batches = len(batches)

        def prep_and_warp(bi):
            ids = batches[bi]
            padded = ids + [ids[-1]] * (page_batch - len(ids))
            grays = [self._gray(pages[i]) for i in padded]
            ds0 = self._first_pass_ds()
            small = None
            if not skip_stage_a:
                grays = self._stack_grays(grays)
                small = self._pack_canvas(np.stack([self._canvas(g, ds0) for g in grays]))
            with stage_timer("pipeline/host_geometry"):
                page_lines, max_n, n_slot = self._batch_lines(pages, ids, lines_override, None,
                                                              ds0)
            with stage_timer("pipeline/host_warp"):
                payload, widths_all = self._crop_payload(grays, page_lines, max_n, n_slot,
                                                         page_batch)
            geoms = [(b, h, w, c, t) for (b, h, c, t), w in zip(page_lines, widths_all)]
            return ids, geoms, small, payload

        inflight: deque = deque()
        with ThreadPoolExecutor(max_workers=1) as worker:
            futs = {bi: worker.submit(prep_and_warp, bi) for bi in range(min(2, n_batches))}
            for bi in range(n_batches):
                with stage_timer("pipeline/prep"):
                    ids, geoms, small, payload = futs.pop(bi).result()
                if bi + 2 < n_batches:
                    futs[bi + 2] = worker.submit(prep_and_warp, bi + 2)
                if payload is not None:
                    if skip_stage_a and not self.trim_crops:
                        raise ValueError("skip_stage_a currently requires trim_crops "
                                         "(the strip payload)")
                    if not skip_stage_a:
                        self._stage_a_shards(small)
                inflight.append((ids, geoms, self._recognize_payload(payload, page_batch)))
                while len(inflight) > self.override_inflight:
                    yield from self._drain(*inflight.popleft())
        while inflight:
            yield from self._drain(*inflight.popleft())
