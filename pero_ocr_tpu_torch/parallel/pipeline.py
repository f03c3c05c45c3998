"""Device page pipeline (port of pero_ocr_tpu/parallel/pipeline.py).

Two transports, as in the JAX package.  The page transport
(``transport="page"``), per batch of pages, one grayscale upload
(optionally two 4-bit pixels per byte, ``transport_bits=4``) feeds
everything:

- **Stage A** (device): area-downsample -> ParseNet maps -> map
  post-processing -> bit-packed baseline mask, quarter-pixel heights and
  4-bit separator (``maps_and_pack``).  Only these small artifacts are
  copied to the host.
- **Host**: the (5, 3) connection dilation, 8-connected components and
  per-component baselines and median heights (``_lines_from_masks``);
  the adaptive downsample may re-run stage A at a corrected scale on the
  pages already on the device; textline outlines and paragraph
  clustering on the pooled separator map (``_cluster_lines``).  The
  labeling, the component lines and the clustering's pair tests and
  penalties run the port's C++ (``utils/native.py``) on CUDA, as the
  JAX page transport runs its own, and their numpy twins on the CPU.
- **Stage B** (device): the line-crop warp (the hand-written CUDA
  kernel of :mod:`pero_ocr_tpu_torch.ops.warp`, which stores the crops
  divided by 255 in the recognizer's input dtype) -> the recognizer.  A
  ``CTCRecognizer`` gives greedy CTC labels and worst-run confidences;
  with ``want_logits``, also each frame's ``logits_topk`` largest
  logits (float16) and their class indices, from which the document
  layer rebuilds the sparse logits of the logits files and the ALTO
  output.  A transformer (the native pre-LN ``TransformerOCR`` or the
  reference's post-LN ``RefTransformerOCR``) decodes greedily with its
  KV cache, each decode shape one CUDA graph on the card; its labels are
  the tokens and its confidence the least chosen-token probability.
  Copies to the host trail their dispatch by one batch.

The next batch's host prep, upload and stage A run on a worker thread
while this thread parses and recognizes the current batch.  Page
transport decodes all T frames of every crop (no width mask), as the
JAX page transport does.

The crop transport (``transport="crops"``: the page never reaches the
device, the host warps the line crops) is
:class:`~pero_ocr_tpu_torch.parallel.crop_transport.CropTransport`.  The
device mesh is not ported (``ValueError`` naming its ROADMAP item).
:mod:`pero_ocr_tpu_torch.document.fast_pipeline` turns the
:class:`PageResult` stream into Page XML.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from pero_ocr_tpu_torch import SCALE_OUT, not_ported, resolve_device
from pero_ocr_tpu_torch.core import line_geometry
from pero_ocr_tpu_torch.layout_engines import helpers
from pero_ocr_tpu_torch.layout_engines.cnn_engine import ParagraphClusterer, postprocess_maps
from pero_ocr_tpu_torch.models import transformer as native_transformer
from pero_ocr_tpu_torch.models import transformer_ref
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer
from pero_ocr_tpu_torch.ops import ctc as ctc_ops
from pero_ocr_tpu_torch.ops.morphology import connected_components
from pero_ocr_tpu_torch.ops.warp import warp_lines
from pero_ocr_tpu_torch.parallel.crop_transport import CropTransport, StageAArtifacts, unpack_bits
from pero_ocr_tpu_torch.utils import native as native_lib
from pero_ocr_tpu_torch.utils.graphs import capture
from pero_ocr_tpu_torch.utils.timing import stage_timer

GRAPH_CACHE = 16  # stage B's transformer decode shapes kept as CUDA graphs


@dataclasses.dataclass
class PageResult:
    page_index: int
    baselines: List[np.ndarray]
    heights: List[List[float]]
    labels: Optional[np.ndarray]      # (N, T) packed label ids, -1 padded
    label_lengths: Optional[np.ndarray]
    crops_width: Optional[np.ndarray]
    clusters: Optional[List[int]] = None   # paragraph id per line
    confidences: Optional[np.ndarray] = None  # (N,) worst-run prob per line
    # want_logits: each frame's top-k logits, (N, T, K) float16, and
    # their class indices, (N, T, K) uint16.
    logits_vals: Optional[np.ndarray] = None
    logits_idx: Optional[np.ndarray] = None
    # Textline outline polygons (one per line), built for the clustering
    # and reused by the layout assembly.  None when clustering is off
    # or the lines came from an override.
    textlines: Optional[List[np.ndarray]] = None


class TorchPagePipeline(CropTransport):
    """Two-stage page pipeline over one device, page or crop transport."""

    BASELINE_POINTS = 16
    VERTICAL_CONNECTION_RANGE = 5
    # Adaptive downsample (the reference's two-pass resolution): the
    # median detected ascender height is steered into [9, 15] map px,
    # quantized to an integer ladder, and the corrected scale sticks.
    ADAPT_MIN_H = 9.0
    ADAPT_MAX_H = 15.0
    ADAPT_OPT_H = 12.0
    ADAPT_PIXEL_THRESHOLD = 100
    ADAPT_DS_LADDER = (1, 2, 3, 4, 6, 8)

    def __init__(
        self,
        parsenet,
        recognizer,
        downsample: int = 4,
        detection_threshold: float = 0.2,
        line_end_weight: float = 1.0,
        crop_height: int = 32,
        crop_bucket: int = 1024,
        line_slot: int = 32,
        max_lines: Optional[int] = None,
        height_scale: float = 1.0,
        transport_bits: int = 8,
        transport: str = "page",
        adaptive_downsample: bool = False,
        cluster_paragraphs: bool = True,
        paragraph_line_threshold: float = 0.3,
        want_logits: bool = False,
        logits_topk: int = 8,
        trim_crops: bool = True,
        dither_2bit: bool = False,
        override_inflight: int = 2,
        canvas_bits: Optional[int] = None,
        mesh=None,
        device=None,
        native: Optional[bool] = None,
    ):
        """``parsenet``: a :class:`ParseNet`, or None for a recognize-only
        pipeline (``run(..., skip_stage_a=True)``); ``recognizer``: a
        :class:`CTCRecognizer`, :class:`TransformerOCR` or
        :class:`RefTransformerOCR`; both moved to ``device`` in place.
        ``device``: None means CUDA (raises when absent); pass "cpu" for
        the plain-PyTorch CPU path.  ``native``: the host geometry and
        the crop transport's line warp in the port's C++ (True) or in
        numpy/scipy (False); None follows ``device``
        (:func:`~pero_ocr_tpu_torch.utils.native.use_native`).  The
        other arguments mean what they mean for ``TPUPagePipeline``,
        with its checks and messages."""
        if transport not in ("page", "crops"):
            raise ValueError("transport must be 'page' or 'crops'")
        if transport_bits not in ((2, 4, 8) if transport == "crops" else (4, 8)):
            raise ValueError(
                f"transport_bits={transport_bits} invalid for "
                f"transport='{transport}' (2-bit is crops-only)"
            )
        if canvas_bits is not None:
            if transport != "crops":
                raise ValueError("canvas_bits requires transport='crops'")
            if canvas_bits not in (8, 4, 2):
                raise ValueError(f"canvas_bits={canvas_bits} invalid")
        if mesh is not None:
            raise not_ported("mesh", SCALE_OUT)
        self.is_ref_transformer = isinstance(recognizer, transformer_ref.RefTransformerOCR)
        self.is_transformer = self.is_ref_transformer or isinstance(
            recognizer, native_transformer.TransformerOCR)
        if not self.is_transformer and not isinstance(recognizer, CTCRecognizer):
            raise ValueError(f"recognizer {type(recognizer).__name__} is neither a "
                             "CTCRecognizer nor a transformer")
        if want_logits and self.is_transformer:
            raise ValueError(
                "want_logits requires a CTC recognizer (AR transformer "
                "outputs are incompatible with CTC logits, reference: "
                "user_scripts/parse_folder.py:274-280)"
            )
        spec = recognizer.spec
        if self.is_ref_transformer:
            # Padded steps emit the boundary id; the argmax reaches the
            # ignore id at most.
            self.recognizer_max_label = spec.num_symbols - 1
        elif self.is_transformer:
            self.recognizer_max_label = spec.num_classes + 1  # the EOS pad
        else:
            self.recognizer_max_label = spec.num_classes - 1
        # Crops reach the recognizer as v / 255: in its dtype for CTC,
        # float32 for the transformers (their encoders cast).
        self.crop_dtype = torch.float32 if self.is_transformer else spec.dtype
        self.transport = transport
        self.transport_bits = transport_bits
        self.canvas_bits = (canvas_bits if canvas_bits is not None
                            else (4 if transport_bits in (2, 4) else 8))
        self.trim_crops = trim_crops and transport == "crops"
        self.dither_2bit = dither_2bit
        self.device = resolve_device(device)
        self.native = native_lib.use_native(native, self.device)
        self.parsenet = None if parsenet is None else parsenet.to(self.device).eval()
        self.recognizer = recognizer.to(self.device).eval()
        self.map_upsample = 1 if parsenet is None else parsenet.out_upsample
        self.height_scale = height_scale
        self.downsample = downsample
        self.adaptive_downsample = adaptive_downsample
        self._last_ds = downsample
        self.detection_threshold = detection_threshold
        self.line_end_weight = line_end_weight
        self.crop_height = crop_height
        self.crop_bucket = crop_bucket
        self.max_lines = max_lines
        self.line_slot = line_slot if max_lines is None else min(line_slot, max_lines)
        # Label copies of the lines-override crop loop trail their
        # dispatch by this many batches; the detection loop recognizes a
        # batch crop_lag batches after its stage A.
        self.override_inflight = max(1, int(override_inflight))
        self.crop_lag = 2
        self.cluster_paragraphs = cluster_paragraphs
        self.want_logits = want_logits
        self.logits_topk = logits_topk
        self._clusterer = ParagraphClusterer(paragraph_line_threshold, self.native)
        self._255 = torch.tensor(255.0, device=self.device)
        # Stage B's transformer decodes as CUDA graphs, (memory shape,
        # steps) -> (static memory, graph, outputs), least recently used
        # first.  A capture holds the device lock, which the page
        # transport's upload worker takes around its device work.
        self._graphs: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
        self.graph_capture_seconds = 0.0
        self._device_lock = threading.Lock()

    # ------------------------------------------------------------------
    # Device stages
    @torch.no_grad()
    def maps_and_pack(self, small: torch.Tensor):
        """small: (PB, h64, w64) float gray in [0, 255] at 1/ds.
        Returns (packed (PB, H, W/8) u8 baseline mask bits, heights_q
        (PB, H/hf, W/hf, 2) u8 quarter pixels, sep_q (PB, H/sf, W/(2 sf))
        u8 nibble pairs) at map resolution H, W; the pool factors double
        on canvases over 640 map rows."""
        images = (small / 255.0)[..., None].expand(-1, -1, -1, 3)
        maps = self.parsenet(images)
        mask, heights_map, separator = postprocess_maps(
            maps, self.detection_threshold, self.line_end_weight
        )
        pb, hh, ww = mask.shape
        bits = mask.to(torch.int32).reshape(pb, hh, ww // 8, 8)
        shifts = torch.arange(8, dtype=torch.int32, device=mask.device)
        packed = (bits << shifts).sum(dim=-1).to(torch.uint8)
        hf = 8 if hh > 640 else 4
        sf = hf // 2
        # reduce_window max with init 0: VALID max pool, floored at 0.
        heights_qp = F.max_pool2d(heights_map.permute(0, 3, 1, 2), hf).clamp_min(0.0)
        heights_q = torch.round(heights_qp * 4.0).clamp(0, 255).to(torch.uint8)
        sep_pool = F.max_pool2d(separator[:, None], sf)[:, 0].clamp_min(0.0)
        sep_nib = torch.round(sep_pool * 15.0).clamp(0, 15).to(torch.uint8)
        sep_q = (sep_nib[:, :, 0::2] << 4) | sep_nib[:, :, 1::2]
        return packed, heights_q.permute(0, 2, 3, 1), sep_q

    @torch.no_grad()
    def stage_a(self, pages_u8: torch.Tensor, ds_run: int):
        """pages_u8: (PB, H, W) uint8 grayscale pages on the device.
        ``ds_run`` is the MAP scale; the canvas area-downsamples by
        ds_run * map_upsample and pads to multiples of 64."""
        dc = ds_run * self.map_upsample
        pb, h, w = pages_u8.shape
        hs, ws = h // dc, w // dc
        x = pages_u8[:, : hs * dc, : ws * dc].float()
        # Integer sums are exact in float32, so this equals lax's
        # reduce_window sum whatever the summation order.
        small = x.reshape(pb, hs, dc, ws, dc).sum(dim=(2, 4)) / (dc * dc)
        h64, w64 = -(-hs // 64) * 64, -(-ws // 64) * 64
        return self.maps_and_pack(F.pad(small, (0, w64 - ws, 0, h64 - hs)))

    @torch.no_grad()
    def stage_b(self, pages_u8, baselines, heights):
        """pages_u8 (PB, H, W) u8; baselines (PB, N, P, 2); heights
        (PB, N, 2) -> (labels (PB, N, T), lengths (PB, N), confidences
        (PB, N), top-k logits (PB, N, T, K) float16 and their indices
        (PB, N, T, K) int32, or None and None without ``want_logits``).
        The warp stores the crops divided by 255 in ``crop_dtype``."""
        crops = warp_lines(
            pages_u8, baselines, heights, self.crop_height, self.crop_bucket,
            out_dtype=self.crop_dtype, normalize=True,
        )
        return self.stage_b_recognize(crops, baselines.shape[0])

    @torch.no_grad()
    def stage_b_recognize(self, crops: torch.Tensor, pb: int, widths=None):
        """crops: (PB * N, crop_h, W) line images already in [0, 1] and
        in ``crop_dtype``, so the recognizer's cast is a no-op.
        ``widths`` ((PB * N,) crop widths in pixels, the crop transport's):
        CTC decodes each line's valid frames only, ceil(width /
        subsampling) of them; None decodes every frame."""
        images = crops[..., None].expand(-1, -1, -1, 3)
        if self.is_transformer:
            return self._transformer_recognize(images, pb)
        logits = self.recognizer(images)
        t = logits.shape[1]
        if widths is None:
            valid = torch.full((crops.shape[0],), t, dtype=torch.int32, device=crops.device)
        else:
            sub = max(1, crops.shape[2] // t)
            valid = ((widths + sub - 1) // sub).clamp(0, t).to(torch.int32)
        labels, lengths = ctc_ops.greedy_ctc_labels(logits, valid)
        confs = ctc_ops.greedy_worst_run_confidence(logits, valid)
        n = crops.shape[0] // pb
        vals = idx = None
        if self.want_logits:
            # The K largest logits a frame (JAX: lax.top_k in XLA) stand
            # in for the staged path's p < 1e-4 pruning; float16 values
            # and int32 indices (uint16 on the host) cut the copy.
            k = min(self.logits_topk, logits.shape[-1])
            vals, idx = torch.topk(logits, k, dim=-1)
            t = logits.shape[1]
            vals = vals.to(torch.float16).reshape(pb, n, t, k)
            idx = idx.to(torch.int32).reshape(pb, n, t, k)
        return (labels.reshape(pb, n, -1), lengths.reshape(pb, n), confs.reshape(pb, n),
                vals, idx)

    def _transformer_recognize(self, images: torch.Tensor, pb: int):
        """The transformer branch of stage B: the encoder, then
        ``dec_len`` = max(8, min(crop_bucket // 4, the model's cap))
        greedy KV-cached steps (the reference model: tokens to its first
        boundary, confidence the least softmax probability of a chosen
        token over those steps; the native model: ``greedy_decode``'s
        tokens, lengths and confidences).  On CUDA each (memory shape,
        steps) decode is one CUDA graph, at most GRAPH_CACHE kept."""
        spec = self.recognizer.spec
        cap = spec.max_seq_len - 1 if self.is_ref_transformer else spec.max_decode_len
        dec_len = max(8, min(self.crop_bucket // 4, cap))
        memory = self.recognizer.encode(images)
        if memory.device.type == "cuda":
            tokens, lengths, confs = (t.clone() for t in self._graphed_decode(memory, dec_len))
        else:
            tokens, lengths, confs = self._decode_from_memory(memory, dec_len)
        n = images.shape[0] // pb
        return (tokens.reshape(pb, n, -1), lengths.reshape(pb, n), confs.reshape(pb, n),
                None, None)

    def _decode_from_memory(self, memory: torch.Tensor, dec_len: int):
        """(tokens int32, lengths int32, confidences float32) a line."""
        if self.is_ref_transformer:
            tokens, lengths, logits = transformer_ref.greedy_ref_from_memory(
                self.recognizer, memory, dec_len)
            chosen = torch.gather(torch.softmax(logits, dim=-1), 2, tokens[..., None])[..., 0]
            emitted = torch.arange(dec_len, device=memory.device)[None, :] < lengths[:, None]
            confs = torch.where(emitted, chosen, 1.0).amin(dim=1)
        else:
            tokens, lengths, confs = native_transformer.greedy_from_memory(
                self.recognizer, memory, dec_len)[:3]
        return tokens.to(torch.int32), lengths.to(torch.int32), confs.float()

    def _graphed_decode(self, memory: torch.Tensor, dec_len: int):
        """``_decode_from_memory`` replayed from a CUDA graph of its
        shape; the outputs are the graph's, overwritten by its next
        replay."""
        key = (tuple(memory.shape), memory.dtype, dec_len)
        entry = self._graphs.pop(key, None)
        if entry is None:
            if len(self._graphs) >= GRAPH_CACHE:
                del self._graphs[next(iter(self._graphs))]
            t0 = time.perf_counter()
            static = memory.clone()
            with self._device_lock:
                graph, out = capture(lambda: self._decode_from_memory(static, dec_len),
                                     memory.device, "stage B's transformer decode")
            self.graph_capture_seconds += time.perf_counter() - t0
            entry = (static, graph, out)
        self._graphs[key] = entry  # the most recently used last
        static, graph, out = entry
        static.copy_(memory)
        graph.replay()
        return out

    @staticmethod
    def unpack4(packed_u8: torch.Tensor) -> torch.Tensor:
        """(..., W/2) nibble pairs -> (..., W) uint8; q*17 maps 0..15
        back onto 0..255 exactly at the endpoints."""
        return unpack_bits(packed_u8, 4)


    # ------------------------------------------------------------------
    # Host helpers
    @staticmethod
    def _pack4(grays: np.ndarray) -> np.ndarray:
        """(PB, H, W) uint8 -> (PB, H, W/2) rounded 4-bit pairs; odd
        widths get one replicated edge column first."""
        if grays.shape[2] % 2:
            grays = np.concatenate([grays, grays[:, :, -1:]], axis=2)
        q = ((grays.astype(np.uint16) + 8) // 17).astype(np.uint8)
        return (q[:, :, 0::2] << 4) | q[:, :, 1::2]

    @staticmethod
    def _gray(page: np.ndarray) -> np.ndarray:
        """Single-channel uint8 view of a page: BGR -> gray with OpenCV
        5's fixed-point formula for 8-bit images (``cv2.COLOR_BGR2GRAY``:
        0.114, 0.587, 0.299 scaled by 2**15, rounded)."""
        if page.ndim == 2:
            return page
        if page.ndim != 3 or page.shape[2] != 3 or page.dtype != np.uint8:
            raise ValueError(
                f"pages must be (H, W) or (H, W, 3) uint8, got {page.shape} {page.dtype}"
            )
        # In torch's threaded int32 ops: ~8x faster than numpy on a page.
        b, g, r = torch.from_numpy(page).unbind(-1)
        out = b.to(torch.int32) * 3735
        out += g.to(torch.int32) * 19235
        out += r.to(torch.int32) * 9798
        out += 1 << 14
        return (out >> 15).to(torch.uint8).numpy()

    @staticmethod
    def _stack_grays(grays) -> np.ndarray:
        """Stack per-page grayscale images, zero-padding each to the
        batch's max dims rounded up to 64 when their shapes differ."""
        grays = list(grays)
        if len({g.shape for g in grays}) == 1:
            return np.stack(grays)
        h = int(np.ceil(max(g.shape[0] for g in grays) / 64) * 64)
        w = int(np.ceil(max(g.shape[1] for g in grays) / 64) * 64)
        out = np.zeros((len(grays), h, w), np.uint8)
        for i, g in enumerate(grays):
            out[i, : g.shape[0], : g.shape[1]] = g
        return out

    def _unpack_stage_a(self, packed, heights_q, sep_q):
        """Host side of the stage-A artifacts: mask bits -> mask, the
        (5, 3) connection dilation (a max filter with zero border),
        pooled heights repeated back to map resolution.  The separator
        stays at its pooled resolution (the clustering indexes it with
        its pool factor, the mask's rows over its rows)."""
        from scipy import ndimage

        baselines_masks = np.stack(
            [(packed >> i) & 1 for i in range(8)], axis=-1
        ).reshape(packed.shape[0], packed.shape[1], packed.shape[2] * 8)
        connecteds = np.stack([
            ndimage.maximum_filter(
                m, size=(self.VERTICAL_CONNECTION_RANGE, 3), mode="constant"
            )
            for m in baselines_masks
        ])
        hf = packed.shape[1] // heights_q.shape[1]
        heights_maps = (
            heights_q.astype(np.float32) / 4.0
        ).repeat(hf, axis=1).repeat(hf, axis=2)
        sep_nib = np.stack([sep_q >> 4, sep_q & 0xF], axis=-1).reshape(
            sep_q.shape[0], sep_q.shape[1], sep_q.shape[2] * 2
        )
        return baselines_masks, connecteds, heights_maps, sep_nib.astype(np.float32) / 15.0

    def _adapt_target_ds(self, masks, ds_used: int) -> Optional[int]:
        """Corrected sticky downsample for a batch, or None to keep the
        current scale (median over the whole batch)."""
        baselines_masks, _, heights_maps, _ = masks
        sel = baselines_masks > 0
        if sel.sum() <= self.ADAPT_PIXEL_THRESHOLD:
            return None
        med = float(np.median(heights_maps[sel][:, 0]))
        return self._adapt_decide(med, ds_used)

    def _adapt_decide(self, med: float, ds_used: int) -> Optional[int]:
        if self.ADAPT_MIN_H <= med <= self.ADAPT_MAX_H:
            return None
        target = ds_used * med / self.ADAPT_OPT_H
        ladder = np.asarray(self.ADAPT_DS_LADDER, float)
        corrected = int(ladder[np.argmin(np.abs(ladder - np.clip(target, 1, 8)))])
        self._last_ds = corrected
        ratio = corrected / ds_used
        if 0.8 < ratio < 1.2:
            return None  # close enough; keep this batch's first pass
        return corrected

    def _lines_from_masks(self, baselines_mask, connected, heights_map, ds=None):
        """Host layout parse of one page: components of the connected
        mask restricted to the baseline mask -> decimated baselines and
        median heights, scaled by ``ds`` to page pixels."""
        labels_img, num = connected_components(connected, self.native)
        return self._component_lines(labels_img * baselines_mask, num, heights_map, ds)

    def _component_lines(self, labels_img, num, heights_map, ds=None):
        """Each component 1..num of ``labels_img`` with more than 5
        pixels: its first row at each column (at most 10 points,
        decimated, ends moved out by 2 px) and the median of its
        heights, scaled by ``ds``.  ``cc_baselines_f32`` on the native
        route."""
        ds = self.downsample if ds is None else ds
        b_list, h_list = [], []
        if self.native:
            if num == 0:
                return b_list, h_list
            pts, npts, hts, valid = native_lib.native_cc_baselines(labels_img, heights_map, num)
            for c in np.nonzero(valid)[0]:
                b_list.append(ds * pts[c, : npts[c]])
                h_list.append([ds * float(hts[c, 0]), ds * float(hts[c, 1])])
            return b_list, h_list
        ys, xs = np.nonzero(labels_img > 0)
        comp = labels_img[ys, xs]
        order = np.argsort(comp, kind="stable")
        ys, xs, comp = ys[order], xs[order], comp[order]
        bounds = np.searchsorted(comp, np.arange(1, num + 2))
        for c in range(num):
            lo, hi = bounds[c], bounds[c + 1]
            if hi - lo <= 5:
                continue
            cx, cy = xs[lo:hi], ys[lo:hi]
            ux, first = np.unique(cx, return_index=True)
            pos = np.stack([ux, cy[first]], 1).astype(float)
            target = max(min(10, pos.shape[0] // 10), 2)
            sel = np.linspace(0, pos.shape[0] - 1, target).astype(int)
            pos = pos[sel]
            pos[0, 0] -= 2
            pos[-1, 0] += 2
            hp = np.maximum(heights_map[cy, cx].astype(np.float32), 0)
            b_list.append(ds * pos)
            h_list.append(
                [ds * float(np.percentile(hp[:, 0], 50)),
                 ds * float(np.percentile(hp[:, 1], 50))]
            )
        return b_list, h_list

    def _geometry(self, b_list, h_list, n_slot: int):
        """Resample baselines to BASELINE_POINTS and pad the line axis to
        the batch's slot count: (n_slot, P, 2), (n_slot, 2), widths."""
        n = len(b_list)
        if n == 0:
            return None, None, None
        baselines = np.zeros((n_slot, self.BASELINE_POINTS, 2), np.float32)
        heights = np.ones((n_slot, 2), np.float32)
        widths = np.zeros(n_slot, np.int32)
        for i in range(n):
            resampled = line_geometry.resample_baseline(
                np.asarray(b_list[i], float), self.BASELINE_POINTS
            )
            baselines[i] = resampled
            heights[i] = np.asarray(h_list[i]) * self.height_scale
            arc = np.hypot(*np.diff(resampled, axis=0).T).sum()
            scale = self.crop_height / max(h_list[i][0] + h_list[i][1], 1e-6)
            widths[i] = min(int(arc * scale), self.crop_bucket)
        return baselines, heights, widths[:n]

    def _batch_lines(self, pages, ids, lines_override, masks, ds=None):
        """Per-page (baselines, heights, clusters, textlines) for one
        batch and the padded slot count: the densest page rounded up to a
        line_slot multiple.  ``masks``: ``_unpack_stage_a``'s maps, or
        the crop transport's :class:`StageAArtifacts`, whose packed mask
        is parsed directly (a page past the component budget, and the
        rest of the batch, from the unpacked maps).  Paragraph clustering
        belongs to the CNN layout parse: override lines get (None,
        None)."""
        arts = masks if isinstance(masks, StageAArtifacts) else None
        if arts is not None:
            sep_pooled, sep_pool = arts.sep_pooled
        elif masks is not None:
            baselines_masks, connecteds, heights_maps, sep_pooled = masks
            sep_pool = baselines_masks.shape[1] // sep_pooled.shape[1]
        page_lines = []
        for slot, i in enumerate(ids):
            if lines_override is None:
                with stage_timer("pipeline/cc_parse"):
                    got = None if arts is None else self._lines_from_packed(
                        arts.packed[slot], arts.heights_q[slot], ds)
                    if arts is not None and got is None:
                        baselines_masks, connecteds, heights_maps, sep_pooled = arts.unpacked
                        sep_pool = baselines_masks.shape[1] // sep_pooled.shape[1]
                        arts = None
                    b_list, h_list = got if got is not None else self._lines_from_masks(
                        baselines_masks[slot], connecteds[slot], heights_maps[slot], ds
                    )
            elif callable(lines_override):
                b_list, h_list = lines_override(pages[i])
            else:
                b_list, h_list = lines_override[i]
            if self.max_lines is not None:
                b_list = b_list[: self.max_lines]
                h_list = h_list[: self.max_lines]
            clusters, t_list = (
                self._cluster_lines(b_list, h_list, sep_pooled[slot], ds, sep_pool)
                if lines_override is None else (None, None)
            )
            page_lines.append((b_list, h_list, clusters, t_list))
        max_n = max(len(b) for b, _, _, _ in page_lines)
        n_slot = max(self.line_slot, -(-max_n // self.line_slot) * self.line_slot)
        return page_lines, max_n, n_slot

    def _cluster_lines(self, b_list, h_list, sep_map, ds=None, sep_pool=1):
        """Paragraph ids by the separator-penalty clustering on one
        page's pooled separator map, and the textline outlines it builds
        (they ride on PageResult, so the layout assembly reuses them).
        (None, None) when clustering is off or the page has no lines."""
        if not self.cluster_paragraphs or len(b_list) == 0:
            return None, None
        with stage_timer("pipeline/textlines"):
            t_list = helpers.baselines_to_textlines(b_list, h_list)
        with stage_timer("pipeline/make_clusters"):
            clusters = self._clusterer.make_clusters(
                [np.asarray(b) for b in b_list], h_list, t_list, sep_map,
                self.downsample if ds is None else ds, sep_pool=sep_pool,
            )
        return list(np.asarray(clusters).tolist()), t_list

    # ------------------------------------------------------------------
    def run(
        self,
        pages: Iterable[np.ndarray],
        lines_override=None,
        page_batch: int = 4,
        skip_stage_a: bool = False,
    ) -> Iterator[PageResult]:
        """Process pages ``page_batch`` at a time; yields one
        :class:`PageResult` per page, in page order.

        ``lines_override`` replaces the CNN line detection: a callable
        ``page -> (baselines, heights)`` or a sequence of such pairs
        aligned with ``pages``.  Stage A still runs, unless
        ``skip_stage_a`` (crop transport with an override only: the
        re-OCR of given lines, where the crops are the only upload)."""
        pages = list(pages)
        if not pages:
            return
        if lines_override is not None and not callable(lines_override):
            lines_override = list(lines_override)
            if len(lines_override) != len(pages):
                raise ValueError(
                    f"lines_override sequence length {len(lines_override)} != "
                    f"number of pages {len(pages)}"
                )
        if skip_stage_a and (self.transport != "crops" or lines_override is None):
            raise ValueError(
                "skip_stage_a requires transport='crops' and a "
                "lines_override (there is no other line source)"
            )
        if self.transport == "crops" and lines_override is not None:
            yield from self._run_crops_override(pages, lines_override, page_batch, skip_stage_a)
        elif self.transport == "crops":
            yield from self._run_crops(pages, page_batch)
        else:
            yield from self._run_page(pages, lines_override, page_batch)

    def _upload(self, grays: np.ndarray) -> torch.Tensor:
        if self.transport_bits == 4:
            return self.unpack4(torch.from_numpy(self._pack4(grays)).to(self.device))
        return torch.from_numpy(grays).to(self.device)

    def _first_pass_ds(self) -> int:
        return self._last_ds if self.adaptive_downsample else self.downsample

    def _run_page(self, pages, lines_override, page_batch):
        n = len(pages)
        batches = [list(range(s, min(s + page_batch, n))) for s in range(0, n, page_batch)]
        zeros_b = np.zeros((1, self.BASELINE_POINTS, 2), np.float32)

        def dispatch_a(batch_idx, ds0):
            ids = batches[batch_idx]
            # Pad the last batch by repeating its last page.
            padded = ids + [ids[-1]] * (page_batch - len(ids))
            grays = self._stack_grays(self._gray(pages[i]) for i in padded)
            with self._device_lock:
                stack = self._upload(grays)
                return stack, self.stage_a(stack, ds0), ds0

        # The next batch's prep, upload and stage A run on a worker
        # thread while this thread syncs and parses the current batch.
        with ThreadPoolExecutor(max_workers=1) as uploader:
            pending = uploader.submit(dispatch_a, 0, self._first_pass_ds())
            inflight = None  # (ids, geoms, stage-B outputs on the device)
            for batch_idx, ids in enumerate(batches):
                with stage_timer("pipeline/upload+dispatch_a"):
                    stack, outs_a, ds_used = pending.result()
                if batch_idx + 1 < len(batches):
                    pending = uploader.submit(
                        dispatch_a, batch_idx + 1, self._first_pass_ds()
                    )
                with stage_timer("pipeline/stage_a_sync"):
                    masks = self._unpack_stage_a(*(t.cpu().numpy() for t in outs_a))
                if self.adaptive_downsample and lines_override is None:
                    ds2 = self._adapt_target_ds(masks, ds_used)
                    if ds2 is not None:
                        # Second pass on the pages already on the device.
                        with stage_timer("pipeline/stage_a_second_pass"):
                            masks = self._unpack_stage_a(
                                *(t.cpu().numpy() for t in self.stage_a(stack, ds2))
                            )
                        ds_used = ds2
                with stage_timer("pipeline/host_geometry"):
                    page_lines, max_n, n_slot = self._batch_lines(
                        pages, ids, lines_override, masks, ds_used
                    )

                outs_b = None
                if max_n == 0:
                    geoms = [(b, h, None, c, t) for b, h, c, t in page_lines]
                else:
                    geom3 = [self._geometry(b, h, n_slot) for b, h, _, _ in page_lines]
                    with stage_timer("pipeline/stage_b"):
                        pad_b = np.repeat(zeros_b, n_slot, axis=0)
                        pad_h = np.ones((n_slot, 2), np.float32)
                        bl = np.stack(
                            [g[0] if g[0] is not None else pad_b for g in geom3]
                            + [pad_b] * (page_batch - len(ids))
                        )
                        hh = np.stack(
                            [g[1] if g[1] is not None else pad_h for g in geom3]
                            + [pad_h] * (page_batch - len(ids))
                        )
                        outs_b = self.stage_b(
                            stack,
                            torch.from_numpy(bl).to(self.device),
                            torch.from_numpy(hh).to(self.device),
                        )
                    geoms = [(b, h, g[2], c, t) for (b, h, c, t), g in zip(page_lines, geom3)]

                if inflight is not None:
                    yield from self._drain(*inflight)
                inflight = (ids, geoms, outs_b)
            if inflight is not None:
                yield from self._drain(*inflight)

    def _drain(self, ids, geoms, outs_b):
        labels = lengths = confs = lvals = lidx = None
        if outs_b is not None:
            with stage_timer("pipeline/labels_sync"):
                labels, lengths, confs, lvals, lidx = (
                    None if t is None else t.cpu().numpy() for t in outs_b)
            if lidx is not None:
                lidx = lidx.astype(np.uint16)
        for slot, (i, (b_list, h_list, widths, clusters, tlines)) in enumerate(zip(ids, geoms)):
            if widths is None or labels is None:
                yield PageResult(i, b_list, h_list, None, None, None, clusters,
                                 textlines=tlines)
            else:
                yield PageResult(
                    i, b_list, h_list, labels[slot], lengths[slot], widths, clusters,
                    confs[slot],
                    lvals[slot] if lvals is not None else None,
                    lidx[slot] if lidx is not None else None,
                    textlines=tlines,
                )
