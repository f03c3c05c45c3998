"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero):

1. Environment: the card's name and power limit (nvidia-smi).
2. Build: every ``pero_ocr_tpu_torch/csrc/*.cu`` with nvcc and every
   ``csrc/*.cpp`` with the host compiler, in parallel.  Then the JPEG
   codec (``csrc/jpeg.cpp``, ``check_jpeg_fixtures``): this machine's
   build reproduces every digest of ``tests/data/jpeg/fixtures.json``
   (cv2's decodes and encodes of the committed fixtures), and its host
   times: the decode of a 2560x1792 colour 4:2:0 page, the encode of a
   32x1024 line crop (``{"jpeg": ...}``).
3. Kernel check: each kernel against its plain PyTorch version on the
   card on random pages with mixed lines (straight, curved, tilted,
   off-page, padded), and its time beside the plain version's, one
   PyTorch library call's and the memory/compute bound.
4. Reference check: a small float32 pipeline on the card against the
   same pipeline on the CPU (labels equal, confidences close, the same
   Page XML).
5. Page transport: ``TorchPagePipeline`` at the bench widths with seeded
   random weights on 2560x1792 pages, with a lines override and with
   CNN detection; kernel launch counts are read around it, the crops
   that reach the recognizer are checked (bfloat16 in [0, 1]), and stage
   B's device time is taken with CUDA events.
6. Main path (config 2, page image to Page XML bytes):
   ``FastPagePipeline.process_pages`` on 16 two-column pages of 80 lines
   with CNN detection and paragraph clustering; every page's Page XML is
   serialized inside the timed window, parsed back with ``xml.etree``
   and checked (two regions or more, every line in one region); kernel
   launch counts are read around it.  Then each kernel is held against
   its plain version, and timed, again on the last batch's inputs at
   the main path's shapes; the ``kernels`` line reports these numbers
   (the mixed-line ones under ``mixed_lines_*``).
7. Command line (run before that last kernel check): the config-2 pages
   as colour JPEG files (the port's encoder) and the bench modules as
   flax msgpack checkpoints, with an OCR JSON and a config, through
   ``python -m pero_ocr_tpu_torch.scripts.parse_folder`` in a
   subprocess, without and with ``--output-line-path``; its Page XML
   files must equal an in-process ``FastPagePipeline`` with the command
   line's settings on the same modules and the same files decoded by
   ``image_io.imread``, and its line files the in-process crops' JPEG
   bytes; the warp's launches are counted in both (the command line
   prints its count with ``--timing-report``).  Then the
   kernel is held against its plain version, and timed, on the in-process
   run's last batch, at the command line's shapes (page batch 4, line
   slot 32, crop bucket 2048); the ``kernels`` line reports these under
   ``cli_*``.
8. Stage by stage (``run_staged``): 8 pages as gray JPEG files through
   ``PageParser(config, device="cuda").process_page`` and its command
   line with ``--output-line-path`` on 4 of them (the line files held to
   the in-process crops: ``staged_line_files``); the field warp checked
   and timed on the last page.
9. Config 1 (``run_config1``): 6 synthetic printed A4 pages at 300 dpi
   (40 rows) through ``PageParser(config 1, device="cuda")`` (whole-page
   region, the classical line detector, the field warp, the recognizer
   at bench widths) to Page XML, its layout equal to a CPU run's layout
   stages, the field warp bit-equal on every page's own fields, and the
   command line on 3 pages; the field warp timed on the last page
   (``config1_*``).  Then REGION_SIMPLE_THRESHOLD (``run_simple_regions``):
   config 1's ini with classical regions (``csrc/nlmeans.cpp``'s
   NL-means among their steps) in place of the whole page, float32 with
   TF32 off, on 4 A4 pages whose text runs to 24 px of the sides and 4
   two-column 2560x1792 pages (two regions or more a page, ids in
   order): layouts and crops equal to a CPU run's byte for byte, texts
   equal or near-ties, the field warp bit-equal on every page, the C++
   NL-means equal to its numpy twin on a crop and timed against it;
   and ``--process-count`` (``run_process_count``): config 2's staged
   command line on 4 gray JPEG pages in one process and with 2 spawned
   workers on the card, each page's Page XML equal, pages/s of both
   (``{"simple_regions": ...}``, ``{"process_count": ...}``,
   ``simple_regions_*`` keys).  These two phases draw from their own
   generator and log the seconds they add.
10. Config 5's outputs (``run_config5``): the page transport with
    ``want_logits`` on 16 pages and stage by stage on 4, each with and without the logits
    pickle and ALTO (A B B A), the card's top-k against ``torch.topk``
    on the CPU, and the command line with --output-logit-path and
    --output-alto-path on both paths, every file loaded back against
    the in-process run's; warp_lines timed on its last batch
    (``config5_*``).  Then the user scripts (``run_user_scripts``):
    select_embed_id (--n-lines 64 --n-clusters 4, the KMeans route) on
    the staged run's first pages with a bench-width float32 recognizer
    of 16 writer embeddings, --device cuda against --device cpu (TF32
    off: the same ids, CER lines and selected id, lines apart only at
    near-ties; warp_fields one launch a page it reads), ms a line;
    produce_2layer_pdf on config 5's staged Page XML and ALTO with the
    committed Latin font (tests/data/pdf; the card's machine has no
    system font): every xref offset resolves, the text layer decodes
    through the ToUnicode map to the file's lines, the image stream is
    ``encode_jpeg(page, 80)``, ms a page; compare_page_xml_texts on the
    staged CPU check's Page XML (the differing characters it counts are
    that check's, 0); levenshtein_batch_i32 against a call a line and
    its numpy twin (``{"user_scripts": ...}``).
11. Config 3 (``run_config3``): 4 two-column pages through
    ``PageParser(config 3, device="cuda")``: the staged layout, the field
    warp, CTC OCR at line height 40, then the batched beam search (K = 8,
    float16 transport) with a CharLM at the spec defaults stepped inside
    its frame loop, one decode a line carrying the LM state
    (CARRY_H_OVER), each decode shape a CUDA graph; 16 of the last page's
    decodes held against the CPU port's and the eager loop's (equal
    backpointers, near-ties counted apart), a GRU LM and the batched
    route (lines padded to a power of two a 128-frame bucket) on one
    page each, held against both the same way (the GRU's first 8 lines,
    every decode of the batched page), the command line on 1 page;
    warp_fields held against its plain version on the last page's
    buckets (``config3_*``).  Then torch.profiler splits one config-2
    stage-B call and one config-3 line decode.
12. Config 4 (``run_config4``): 3 two-column pages whose lines tilt by
    1.5 degrees through ``PageParser(config 4, device="cuda")``: ParseNet
    at the adaptive resolution, the CNN layout, ADJUST_HEIGHTS (a second
    ParseNet pass), REGION_SORTER_SMART (its rotation must be the tilt),
    the field warp at line height 48, the reference transformer at full
    width (512 wide, 2048 feed-forward, 8 heads, 4 + 4 layers, a seeded
    torch .pt) with its KV-cached greedy decode replayed as one CUDA
    graph a decode shape; the last batches (16 lines or more) held
    against the CPU port's decode (equal tokens, near-ties of float32
    rounding counted apart) and the eager loop (bit-equal); one batch's
    decode step timed as a graph and eagerly, its kernels counted under
    torch.profiler, against its bound; the command line on 2 pages
    equal to the in-process run; warp_fields held against its plain
    version on the last page's buckets (``config4_*``).
13. Host C++ (``csrc/perotpu.cpp``, built with the kernels): config 2's
    fast path and the staged run go on the C++ host route (the card's
    default), the numpy route (``native=False``), the numpy route and
    the C++ route again (A B B A); every run's Page XML must equal the
    first's.  Then ``check_host_native`` holds each C++ function against
    its numpy twin on the runs' own inputs (0 differences; the forced
    alignment's on config 5's lines) and times both.
14. The crop transport (``run_crops``, after config 4): the main path's
    modules on 16 two-column pages, CNN detection at transport bits 8,
    4 and 2 with the width-trimmed strip and the dense buffer, and the
    lines found as an override with and without ``skip_stage_a``, beside
    the page transport; the rebuilt strip byte-equal to the dense buffer,
    skip_stage_a's labels equal to stage A's, one batch's strip
    recognized alike on card and CPU, the host C++ warp and packed parse
    equal to their numpy twins; pages/s a transport, the strip rebuild's
    device ms against its bound, the host warp's ms a page
    (``{"crops": ...}``).
15. Re-OCR (``run_reocr``): Page XML from the page transport re-read with
    ``parse_folder -x`` and an OCR-only config on the card from JPEG
    pages with --output-line-path, with and without --fast-pipeline,
    each equal to the same command on the CPU (line files byte for byte);
    the full-width reference transformer through the fast re-OCR, its
    graph equal to its eager loop and its tokens to the CPU's
    (``{"reocr": ...}``).
16. TorchScript and item 8d (``run_torchscript``, after re-OCR): the
    detector (the edge detector at base 32, depth 4, conv stem) and the
    bench recognizer in float32, each traced on the CPU into a ``.pt``
    archive as the reference ships its models, named by MODEL_PATH and
    the OCR JSON's checkpoint and loaded for the card (their Device
    constants rewritten, the LSTM weights flattened).  The fast path on
    16 two-column pages (page transport): labels equal to the native
    float32 modules' on the same pages and lines (near-ties counted
    apart), one batch three times bit-equal, stage A's masks within
    TS_MASK_FLIPS.  Stage by stage on 2 pages under ini (a)
    (MULTI_ORIENTATION, MERGE_LINES, ADJUST_BASELINES, LINE_FILTER with a
    seeded OrientationNet, LINE_POSTPROCESSING, LAYOUT_POSTPROCESSING,
    REGION_SORTER_NAIVE) and ini (b) (DETECT_STRAIGHT_LINES_IN_REGIONS),
    pages cut to 1,280 rows: the CPU from the card's maps gives the same
    layouts and line crops on 1 of them; the command line on 1 page
    with ini (a) writes the in-process run's files.  warp_lines (float32 store) is held and
    timed on the fast path's last batch, warp_fields on ini (a)'s last
    page (``torchscript_*`` keys).
17. Training (``run_train``): the five trainers of
    ``parallel/train.py`` at full width (the bench recognizer on 64
    crops of 32x768, float32; the detector on 4 of its pages a step at
    map ds 4 and 2 with bench.py's painted targets and third phase;
    OrientationNet on 8 tiles of 256x256; the native transformer at
    TransformerSpec's defaults on 16 lines; the CharLM at its spec's
    defaults, LSTM and GRU, on 64 x 128 tokens): each one's first step
    held against the CPU's (float32, TF32 off: loss, gradients, global
    norm, weights after the step) with a float64 witness on both (the
    card's float64 step equals the CPU's; its float32 gradients are as
    close to float64 as the CPU's), a learning run whose loss must fall
    (the recognizer: bench.py's curriculum, whose loss must leave the
    blank plateau, then the full lines; its held-out greedy CER is
    printed), the recognizer, detector and LMs
    exported as flax msgpack and read back through the serving loaders
    (equal outputs), ms a step, peak memory, the recognizer step's
    FLOPs and split.  Every warning of
    the phases is recorded; the BiLSTM's "not part of single contiguous
    chunk of memory" fails the run.

Kernel times are taken warm (inputs in L2 from the run before) and
cold (a 128 MB scratch write before each timed run), since stage B finds
its pages after the next batch's upload.

The last lines are the JPEG codec's (``{"jpeg": ...}``), the command
lines' numbers (``{"cli": ...}``,
``{"staged": ...}``), config 1's, REGION_SIMPLE_THRESHOLD's,
--process-count's, config 5's, config 3's and config 4's
(``{"config1": ...}``, ``{"simple_regions": ...}``,
``{"process_count": ...}``, ``{"config5": ...}``, ``{"user_scripts": ...}``,
``{"config3": ...}``,
``{"config4": ...}``), the crop transport's, re-OCR's and TorchScript's, the
host library's (``{"host_native": ...}``), training's (``{"train": ...}``),
the card's nvidia-smi line, one JSON object with the kernels' numbers,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import configparser
import contextlib
import copy
import dataclasses
import difflib
import hashlib
import io
import json
import os
import pickle
import random
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import xml.etree.ElementTree as ET
import zlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.core.force_alignment import viterbi_ctc
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.core.line_geometry import resample_baseline
from pero_ocr_tpu_torch.document import pdf
from pero_ocr_tpu_torch.document.fast_pipeline import FastPagePipeline, assemble_page_layout
from pero_ocr_tpu_torch.document.page_parser import LayoutExtractor, PageParser
from pero_ocr_tpu_torch.layout_engines.cnn_engine import separator_penalties
from pero_ocr_tpu_torch.layout_engines.smart_sorter import SmartRegionSorter
from pero_ocr_tpu_torch.decoding.tpu_decoder import NEG_INF, TorchBeamSearchDecoder
from pero_ocr_tpu_torch.decoding import itf
from pero_ocr_tpu_torch.models.charlm import CharLM, CharLMSpec, sequence_logprobs, state_map
from pero_ocr_tpu_torch.models.parsenet import OrientationNet, ParseNet
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.models.transformer import TransformerOCR, TransformerSpec
from pero_ocr_tpu_torch.models import transformer_ref
from pero_ocr_tpu_torch.models.transformer_ref import RefTransformerOCR, RefTransformerSpec
from pero_ocr_tpu_torch.ocr.transformer_engine import TransformerEngineLineOCR
from pero_ocr_tpu_torch.ops import ctc as pipeline_ctc_ops
from pero_ocr_tpu_torch.ops import morphology
from pero_ocr_tpu_torch.ops import warp as warp_ops
from pero_ocr_tpu_torch.parallel.crop_transport import unpack_bits, warp_affine_lines
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.parallel import train
from pero_ocr_tpu_torch.sequence_alignment import levenshtein_ids_batch
from pero_ocr_tpu_torch.scripts import compare_page_xml_texts, produce_2layer_pdf, select_embed_id
from pero_ocr_tpu_torch.scripts.parse_folder import LINE_QUALITY
from pero_ocr_tpu_torch.scripts.parse_folder import PAGE_BATCH as CLI_PAGE_BATCH
from pero_ocr_tpu_torch.utils import checkpoint, convert, denoise, image_io, kernels, native, timing
from pero_ocr_tpu_torch.utils import ts_adapters
from pero_ocr_tpu_torch.utils.jpeg import decode_jpeg
from pero_ocr_tpu_torch.utils.ts_adapters import TSParseNetModel, TSRecognizerModel

REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

PAGE_H, PAGE_W = 2560, 1792
PAGE_BATCH = 8
LINES_PER_PAGE = 40
CROP_H, BUCKET, POINTS = 32, 1024, 16
# Kernel vs plain version on the card: both do the same correctly
# rounded float32 steps in the same order, then the same store, so they
# must agree bit for bit in the output type.  A validity-boundary column
# (t <= arc length decided one ulp apart) may differ whole, at most one
# per line.
WARP_MODES = {  # (out_dtype, normalize)
    "f32": (torch.float32, False),            # the raw float32 crops
    "bf16_normalized": (torch.bfloat16, True),  # the main path's
}
# Operations per output pixel of the warp (normal offset 4, rotation 6,
# floor and fractions 4, bilinear blend 12, +1 for the division by 255)
# and per valid column (arc interpolation of x and y, gradient, normal,
# and the row offsets shared by the block).
WARP_OPS_PER_PIXEL = 26
WARP_OPS_PER_COLUMN = 45
COLD_SCRATCH_BYTES = 128 * 2**20
SLEEP_CYCLES = 50_000_000  # ~25 ms at the H100's clock
# The hand-set edge detector finds at least this share of the synthetic
# lines on the CPU at this page size (measured: see line_recall).
MIN_LINE_RECALL = 0.9
# Text columns (x0 range, x1 - x0 range) of the page-transport pages
# and of the config-2 pages: two columns with 158 px or more between
# their ink (glyphs run up to 21 px past x1), as the bench's two-column
# layout.
ONE_COLUMN = (((60, 200), (600, 1500)),)
TWO_COLUMNS = (((60, 120), (500, 700)), ((1000, 1040), (500, 700)))
# The bench recognizer's 80 classes as text, CTC blank (U+200B) last.
BENCH_CHARS = [chr(0x21 + i) for i in range(79)] + ["\u200b"]
PAGE_NS = "{http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15}"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 25, warmup: int = 3, cold: bool = False,
            ahead: bool = True) -> float:
    """Median device time of one call of ``fn``: CUDA events around each
    of ``reps`` calls after ``warmup`` calls.  ``ahead``: a busy-wait
    kernel is queued first and every call behind it, so that the device
    never waits for the host and Python's launch overhead is not timed;
    the wait doubles until it outlasts the host's queueing.  A ``fn``
    that waits for the device itself (an allocation that synchronizes)
    needs ``ahead=False``, and its time then holds the host's share.
    ``cold``: before each timed call, outside its events, write a
    scratch tensor of COLD_SCRATCH_BYTES (more than the 50 MB L2), so
    that the call finds its inputs in device memory, as stage B does
    after the next batch's upload."""
    scratch = torch.empty(COLD_SCRATCH_BYTES // 4, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES if ahead else 0
    while True:
        wait = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  for _ in range(reps)]
        wait[0].record()
        if ahead:
            torch.cuda._sleep(cycles)
        wait[1].record()
        t0 = time.perf_counter()
        for i, (start, end) in enumerate(events):
            if cold:
                scratch.fill_(float(i))
            start.record()
            fn()
            end.record()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        if not ahead or host_ms < wait[0].elapsed_time(wait[1]):
            return float(np.median([s.elapsed_time(e) for s, e in events]))
        cycles *= 2  # the device caught up with the host: wait longer
        if cycles > 256 * SLEEP_CYCLES:
            raise AssertionError(f"queueing {reps} calls took {host_ms:.1f} ms")


# ----------------------------------------------------------------------
# Synthetic inputs (numpy, seeded)
def line_mix(rng, n: int, h: int, w: int):
    """n baselines (P points) and heights: straight, curved (sine),
    tilted +-10 degrees, partly off the page, and padded slots."""
    bls = np.zeros((n, POINTS, 2), np.float32)
    hs = np.ones((n, 2), np.float32)
    kinds = ("straight", "curved", "tilt+", "tilt-", "off", "pad")
    for i in range(n):
        kind = kinds[i % len(kinds)]
        if kind == "pad":
            continue
        x0 = rng.uniform(40, w / 3)
        x = np.linspace(x0, x0 + rng.uniform(300, w - x0 - 40), 12)
        y0 = rng.uniform(60, h - 60)
        y = np.full_like(x, y0)
        if kind == "curved":
            y = y0 + rng.uniform(4, 12) * np.sin((x - x0) / rng.uniform(60, 200))
        elif kind in ("tilt+", "tilt-"):
            y = y0 + (1 if kind == "tilt+" else -1) * np.tan(np.radians(10)) * (x - x0)
        elif kind == "off":
            x = x + w * 0.6
            y = y + h * 0.2 * rng.choice([-1, 1])
        bls[i] = resample_baseline(np.stack([x, y], 1), POINTS)
        hs[i] = (rng.uniform(14, 30), rng.uniform(4, 10))
    return bls, hs


def synthetic_pages(rng, n: int, columns=ONE_COLUMN, tilt_deg: float = 0.0):
    """n BGR text-like pages and their text-line geometries: 40 lines in
    each of ``columns``, each line's glyphs stepping down by
    tan(``tilt_deg``) a pixel to the right."""
    pages, lines = [], []
    ys = np.linspace(90, PAGE_H - 70, LINES_PER_PAGE)
    slope = float(np.tan(np.radians(tilt_deg)))
    for _ in range(n):
        gray = rng.normal(238, 6, (PAGE_H, PAGE_W)).clip(0, 255).astype(np.uint8)
        b_list, h_list = [], []
        for (x0_lo, x0_hi), (len_lo, len_hi) in columns:
            for y in ys.astype(int):
                x0 = int(rng.integers(x0_lo, x0_hi))
                x1 = int(x0 + rng.integers(len_lo, len_hi))
                x = x0
                while x < x1:
                    gw = int(rng.integers(6, 22))
                    dy = int(round(slope * (x - x0)))
                    top = y + dy - int(rng.integers(12, 24))
                    bottom = y + dy + (int(rng.integers(3, 8)) if rng.random() < 0.2 else 0)
                    gray[top:bottom, x:x + gw] = rng.integers(20, 90)
                    x += gw + int(rng.integers(3, 12))
                b_list.append(np.array([[x0, y], [x1, y + slope * (x1 - x0)]], float))
                h_list.append([24.0, 8.0])
        pages.append(np.repeat(gray[:, :, None], 3, axis=2))
        lines.append((b_list, h_list))
    return pages, lines


def printed_pages(rng, n: int, h: int, w: int, rows: int, side: Optional[int] = None):
    """n BGR printed-like pages of ``rows`` text rows: glyph-like ink
    outlines (strokes about an eighth of the x-height) on grey paper,
    words and line ends of random length, ``side`` px of margin left and
    right (default: a twentieth of the page's longer side, as above and
    below).  Returns the pages and each page's row baselines (y)."""
    pages, baselines = [], []
    margin = max(h, w) // 20
    side = margin if side is None else side
    pitch = (h - 2 * margin) / rows
    xh = max(int(pitch * 0.32), 6)
    stroke = max(xh // 8, 2)
    for _ in range(n):
        gray = rng.normal(240, 5, (h, w)).clip(0, 255).astype(np.uint8)
        ys = []
        for r in range(rows):
            y = int(margin + (r + 0.8) * pitch)
            x = side + int(rng.integers(0, 3 * xh))
            x_end = w - side - int(rng.integers(0, 6 * xh))
            while x < x_end:
                gw = int(rng.integers(xh // 2, xh + 1))
                top = y - xh - (xh // 2 if rng.random() < 0.3 else 0)
                bottom = y + (int(xh * 0.4) if rng.random() < 0.15 else 0)
                ink = int(rng.integers(10, 60))
                glyph = gray[top:bottom, x:x + gw]
                glyph[:, :stroke] = ink
                glyph[:, -stroke:] = ink
                if rng.random() < 0.6:
                    glyph[:stroke] = ink
                if rng.random() < 0.6:
                    glyph[-stroke:] = ink
                x += gw + int(rng.integers(stroke, 2 * stroke + 2))
                if rng.random() < 0.18:
                    x += xh  # a word gap
            ys.append(y)
        pages.append(np.repeat(gray[:, :, None], 3, axis=2))
        baselines.append(ys)
    return pages, baselines


# ----------------------------------------------------------------------
def recognizer_input(crops: torch.Tensor) -> torch.Tensor:
    """What ``CTCRecognizer.forward`` hands its encoder, from stage B's
    crops: the 3-channel broadcast, NCHW, in bfloat16 (a view when the
    crops are already bfloat16, a copy otherwise)."""
    return crops[..., None].expand(-1, -1, -1, 3).permute(0, 3, 1, 2).to(torch.bfloat16)


def mixed_line_args(rng):
    """The warp's arguments on 8 random pages with LINES_PER_PAGE mixed
    lines each (line_mix), 40 slots a page as in the override run."""
    dev = torch.device("cuda")
    pages = torch.from_numpy(
        rng.integers(0, 256, (PAGE_BATCH, PAGE_H, PAGE_W), dtype=np.uint8)
    ).to(dev)
    geo = [line_mix(rng, LINES_PER_PAGE, PAGE_H, PAGE_W) for _ in range(PAGE_BATCH)]
    bl = torch.from_numpy(np.stack([g[0] for g in geo])).to(dev)
    hh = torch.from_numpy(np.stack([g[1] for g in geo])).to(dev)
    return pages, bl, hh, CROP_H, BUCKET


def check_warp(args, label: str):
    """The warp kernel on ``args`` (pages, baselines, heights, crop_h,
    bucket): each of WARP_MODES against its plain version, bit for bit
    (one validity-boundary column a line excepted); then its time, warm
    and cold, beside the plain version's, one library call's
    (``F.grid_sample`` on the precomputed fields) and its bound."""
    pages, bl, hh, crop_h, bucket = args
    pb, n_slot, n_points = bl.shape[:3]
    page_h, page_w = pages.shape[1:]
    max_abs = 0.0
    for mode, (dtype, normalize) in WARP_MODES.items():
        got = warp_ops.warp_lines(*args, dtype, normalize)
        want = warp_ops.warp_lines_plain(*args, dtype, normalize)
        torch.cuda.synchronize()
        if got.dtype != dtype or got.shape != want.shape:
            raise AssertionError(f"warp_lines {label} {mode}: {got.dtype} {tuple(got.shape)}")
        # In gray levels whatever the store.
        diff = (got.float() - want.float()).abs() * (255.0 if normalize else 1.0)
        int_t = torch.int16 if dtype == torch.bfloat16 else torch.int32
        bad = got.view(int_t) != want.view(int_t)
        bad_cols = bad.any(dim=1).sum(dim=1)  # per line
        max_abs = max(max_abs, float(diff.max()))
        log(f"warp_lines {label} {mode}, {pb} pages x {n_slot} slots: max |kernel - plain| = "
            f"{float(diff.max()):.6g} gray levels, {int(bad.sum())} values not bit-equal, in "
            f"{int((bad_cols > 0).sum())} lines (at most 1 column each allowed)")
        if int(bad_cols.max()) > 1:
            raise AssertionError(f"warp kernel {label} {mode} disagrees with its plain version")
        del got, want, diff, bad

    fields = warp_ops.build_fields(
        bl.reshape(-1, n_points, 2), hh.reshape(-1, 2), crop_h, bucket
    )
    valid_cols = int((fields[:, 0, :, 0] > warp_ops.OFF_PAGE / 2).sum())
    scale = torch.tensor([2.0 / (page_w - 1), 2.0 / (page_h - 1)], device=pages.device)
    grid = (fields * scale - 1.0).reshape(pb, n_slot * crop_h, bucket, 2)
    page_f = pages[:, None].float()

    def library():
        return F.grid_sample(page_f, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    def bound(dtype, normalize):
        nbytes = warp_ops.warp_lines_bytes(*args, dtype, fields)
        ops = valid_cols * (crop_h * (WARP_OPS_PER_PIXEL + normalize) + WARP_OPS_PER_COLUMN)
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_FLOP_PER_S
        log(f"warp_lines {label} {dtype}: bound {bytes_ms:.4f} ms by {nbytes} bytes, "
            f"{ops_ms:.4f} ms by {ops} ops")
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes

    def f32():
        return warp_ops.warp_lines(*args)

    def bf16():
        return warp_ops.warp_lines(*args, torch.bfloat16, True)

    # Stage B up to the recognizer's input: the unfused chain (f32
    # crops, then / 255.0, then the bf16 3-channel copy) and the fused
    # store.
    def chain_old():
        return recognizer_input(f32() / 255.0)

    def chain_new():
        return recognizer_input(bf16())

    t = {}
    for name, fn in (("f32", f32), ("bf16", bf16), ("library", library),
                     ("chain_old", chain_old), ("chain_new", chain_new)):
        t[name] = (cuda_ms(fn), cuda_ms(fn, cold=True))
        log(f"{label} {name}: {t[name][0]:.4f} ms warm, {t[name][1]:.4f} ms cold")
    plain_ms = cuda_ms(lambda: warp_ops.warp_lines_plain(*args, torch.bfloat16, True),
                       reps=5, warmup=1, ahead=False)
    bound_f32, _, _ = bound(torch.float32, False)
    bound_bf16, bound_by, nbytes = bound(torch.bfloat16, True)
    page_bytes = nbytes - 4 * (bl.numel() + hh.numel()) - 2 * fields[..., 0].numel()
    log(f"warp_lines {label}: the taps touch {page_bytes} of {pages.numel()} page bytes "
        f"({page_bytes / pages.numel():.4f}), {valid_cols} valid columns")
    log(f"warp_lines {label}: bf16 normalized {t['bf16'][0]:.4f} ms warm "
        f"({bound_bf16 / t['bf16'][0]:.3f} of its bound), {t['bf16'][1]:.4f} ms cold; "
        f"f32 {t['f32'][0]:.4f} ms warm ({bound_f32 / t['f32'][0]:.3f} of its bound), "
        f"{t['f32'][1]:.4f} ms cold; plain {plain_ms:.4f} ms; F.grid_sample on "
        f"precomputed fields {t['library'][0]:.4f} ms warm, {t['library'][1]:.4f} ms cold")
    return {
        "max_abs_err": max_abs,
        "ms": t["bf16"][0], "plain_ms": plain_ms,
        "bound_ms": bound_bf16, "bound_by": bound_by,
        "library_ms": t["library"][0],
        "pages": pb, "slots": n_slot, "crop_h": crop_h, "bucket": bucket,
        "valid_columns": valid_cols,
        "ms_warm": t["bf16"][0], "ms_cold": t["bf16"][1],
        "library_ms_cold": t["library"][1],
        "f32_ms_warm": t["f32"][0], "f32_ms_cold": t["f32"][1], "f32_bound_ms": bound_f32,
        "chain_old_ms_warm": t["chain_old"][0], "chain_old_ms_cold": t["chain_old"][1],
        "chain_new_ms_warm": t["chain_new"][0], "chain_new_ms_cold": t["chain_new"][1],
        "touched_page_bytes": page_bytes,
    }


def check_against_cpu(rng):
    """A small float32 pipeline on the card (the kernel) against the
    same weights on the CPU (the plain versions)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = RecognizerSpec(
        num_classes=12, line_height=32, conv_features=(8, 16), subsampling=4,
        lstm_layers=1, lstm_features=16, dtype=torch.float32, stem="s2d", norm="group",
    )
    results = {}
    pages = [rng.integers(0, 256, (384, 512, 3), dtype=np.uint8) for _ in range(2)]
    override = [line_mix(rng, 6, 384, 512) for _ in pages]
    override = [([b for b in bl], [list(h) for h in hs]) for bl, hs in override]
    for device in ("cpu", "cuda"):
        pn = ParseNet(base_features=8, depth=2, dtype=torch.float32,
                      generator=torch.Generator().manual_seed(0))
        rec = CTCRecognizer(spec, generator=torch.Generator().manual_seed(1))
        pipe = TorchPagePipeline(pn, rec, crop_height=32, crop_bucket=256,
                                 line_slot=8, device=device)
        results[device] = list(pipe.run(pages, lines_override=override, page_batch=2))
    torch.backends.cudnn.allow_tf32 = True
    chars = BENCH_CHARS[:11] + BENCH_CHARS[-1:]  # 12 classes, blank last
    for a, b in zip(results["cpu"], results["cuda"]):
        if not (np.array_equal(a.labels, b.labels)
                and np.array_equal(a.label_lengths, b.label_lengths)):
            raise AssertionError(f"page {a.page_index}: card labels differ from CPU")
        err = float(np.abs(a.confidences - b.confidences).max())
        if err > 1e-3:
            raise AssertionError(f"page {a.page_index}: confidences differ by {err}")
        xml_cpu, xml_card = (
            assemble_page_layout(r, f"p{r.page_index}", (384, 512), chars).to_pagexml_string()
            for r in (a, b)
        )
        # Equal apart from the timestamps; a conf="0.xxx" attribute may
        # round the (<= 1e-3 apart) confidences to neighbouring values.
        conf_re = re.compile(r'conf="([0-9.]+)"')
        confs = [[float(c) for c in conf_re.findall(x)] for x in (xml_cpu, xml_card)]
        if (mask_pagexml(conf_re.sub("conf", xml_cpu)) != mask_pagexml(conf_re.sub("conf", xml_card))
                or np.abs(np.subtract(*confs)).max(initial=0) > 0.0015):
            raise AssertionError(f"page {a.page_index}: card Page XML differs from CPU")
    log("reference check: card pipeline labels and Page XML equal the CPU pipeline's (f32)")


def mask_pagexml(xml: str) -> str:
    """Page XML with its Created and LastChange timestamps blanked."""
    return re.sub(r"<(Created|LastChange)>[^<]*</\1>", r"<\1/>", xml)


def edge_detector_(pn: ParseNet) -> None:
    """Set the bench-width ParseNet's weights by hand to a bottom-of-ink
    detector, so that CNN detection finds the synthetic pages' lines
    (random weights answer with a constant map).  Every layer still
    runs at full width; all weights are zero except one channel along
    the norm-free path: s2d stem -> first down block -> skip -> last up
    block -> thin heads -> output conv.  The first conv computes ink
    (1 - gray), the second its bottom edge (the cell and half the cell
    above minus 1.5x the cell below, over 3 columns); the heads copy it
    up to map resolution, where it drives the baseline logit.  Heights
    are constant ~12 map px (inside the adaptive band); endpoints and
    separators are off."""
    with torch.no_grad():
        for p in pn.parameters():
            p.zero_()
        for m in pn.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.fill_(1.0)
        first = pn.down_blocks[0]
        first.conv0.weight[0, :, 1, 1] = -1.0 / first.conv0.weight.shape[1]
        first.conv0.bias[0] = 1.0
        first.conv1.weight[0, 0, 0, :] = 0.5 / 3
        first.conv1.weight[0, 0, 1, :] = 1.0 / 3
        first.conv1.weight[0, 0, 2, :] = -1.5 / 3
        last = pn.up_blocks[-1]
        skip0 = last.conv0.weight.shape[1] // 2  # input: [upsampled, skip]
        last.conv0.weight[0, skip0, 1, 1] = 1.0
        last.conv1.weight[0, 0, 1, 1] = 1.0
        for up, conv in zip(pn.head_ups, pn.head_convs):
            up.weight[0, 0] = 1.0
            conv.weight[0, 0, 1, 1] = 1.0
        pn.out.weight[2, 0] = 12.0
        pn.out.bias.copy_(torch.tensor([12.0, 4.0, -4.0, -6.0, -6.0]))


def line_recall(detected, lines, tol_px: float = 16.0) -> float:
    """Share of the synthetic lines that a detected baseline matches:
    mean y within ``tol_px`` and x spans overlapping.  ``detected``: the
    detected baselines of each page."""
    found = total = 0
    for baselines, (true_b, _) in zip(detected, lines):
        det = [(float(b[:, 1].mean()), b[0, 0], b[-1, 0]) for b in baselines]
        for tb in true_b:
            total += 1
            found += any(abs(y - tb[0, 1]) <= tol_px and x0 < tb[1, 0] and x1 > tb[0, 0]
                         for y, x0, x1 in det)
    return found / total


def bench_pipeline(native=None) -> TorchPagePipeline:
    """The page pipeline at bench widths on the card: ParseNet with the
    hand-set edge detector, the recognizer with seeded random weights.
    ``native``: TorchPagePipeline's host route (None: the C++ on the
    card)."""
    pn = ParseNet(base_features=32, depth=4, stem="s2d", out_upsample=2)
    edge_detector_(pn)
    rec = CTCRecognizer(RecognizerSpec(
        num_classes=80, line_height=32, conv_features=(48, 96, 192, 384),
        subsampling=4, lstm_layers=2, lstm_features=256, stem="s2d", norm="group",
    ), generator=torch.Generator().manual_seed(1))
    return TorchPagePipeline(
        pn, rec, downsample=4, crop_bucket=BUCKET, crop_height=CROP_H,
        line_slot=LINES_PER_PAGE, adaptive_downsample=True, device="cuda",
        native=native,
    )


def run_main_path(rng):
    pipe = bench_pipeline()
    n_pages = 2 * PAGE_BATCH
    pages, lines = synthetic_pages(rng, n_pages)

    def drive(override, n):
        t0 = time.perf_counter()
        out = list(pipe.run(pages[:n], lines_override=override, page_batch=PAGE_BATCH))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # Instrument stage B on this instance: CUDA events around each call
    # (the span from its first to its last device op, which also holds
    # whatever the worker thread queued in between), and the crops that
    # reach the recognizer.
    spans, slots, crops_seen, last_b = [], [], [], []
    stage_b, stage_b_recognize = pipe.stage_b, pipe.stage_b_recognize

    def timed_stage_b(*b_args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = stage_b(*b_args)
        end.record()
        spans.append((start, end))
        slots.append(b_args[1].shape[1])
        last_b[:] = [b_args]
        return out

    def seen_stage_b_recognize(crops, pb):
        crops_seen.append((crops.dtype, torch.stack([crops.min(), crops.max()]).float()))
        return stage_b_recognize(crops, pb)

    pipe.stage_b, pipe.stage_b_recognize = timed_stage_b, seen_stage_b_recognize

    # Warm-up (cuDNN plans, allocator, the adaptive scale) on one batch.
    drive(lines[:PAGE_BATCH], PAGE_BATCH)
    drive(None, PAGE_BATCH)
    timing.reset_timing()
    spans.clear()
    slots.clear()
    crops_seen.clear()

    warp_ops.warp_lines.launches = 0
    runs = {}
    for name, override in (("override", lines), ("cnn", None)):
        runs[name] = drive(override, n_pages)
    launches = warp_ops.warp_lines.launches

    stage_b_batches = 0
    for name, (results, seconds) in runs.items():
        if [r.page_index for r in results] != list(range(n_pages)):
            raise AssertionError(f"{name}: results out of page order")
        with_labels = [r for r in results if r.labels is not None]
        stage_b_batches += len({r.page_index // PAGE_BATCH for r in with_labels})
        for r in with_labels:
            if r.labels.min() < -1 or r.labels.max() > 79:
                raise AssertionError(f"{name}: label out of [-1, 79]")
            if not np.isfinite(r.confidences).all() or r.confidences.min() < 0 \
                    or r.confidences.max() > 1:
                raise AssertionError(f"{name}: confidence out of [0, 1]")
        n_lines = sum(len(r.baselines) for r in results)
        log(f"main path ({name}): {n_pages} pages, {n_lines} lines, "
            f"{n_pages / seconds:.3f} pages/s ({seconds:.3f} s)")
    log(f"adaptive downsample settled at ds {pipe._last_ds}")
    recall = line_recall([r.baselines for r in runs["cnn"][0]], lines)
    log(f"cnn detection: {recall:.3f} of the synthetic lines found")
    if recall < MIN_LINE_RECALL:
        raise AssertionError(f"cnn detection found {recall:.3f} < {MIN_LINE_RECALL} of the lines")
    if runs["override"][0][0].labels is None:
        raise AssertionError("override run produced no labels")
    log(f"warp_lines launches in the main path: {launches}, "
        f"stage-B batches: {stage_b_batches}")
    if launches != stage_b_batches or launches == 0:
        raise AssertionError("warp kernel launches != stage-B batches")
    for dtype, (lo, hi) in ((d, m.tolist()) for d, m in crops_seen):
        if dtype != torch.bfloat16 or not 0.0 <= lo <= hi <= 1.0:
            raise AssertionError(f"stage-B crops {dtype} in [{lo}, {hi}], want bf16 in [0, 1]")
    if len(crops_seen) != stage_b_batches:
        raise AssertionError("stage-B crops seen != stage-B batches")
    log(f"stage-B crops: bfloat16 in [0, 1] in all {len(crops_seen)} batches")
    span_ms = [s.elapsed_time(e) for s, e in spans]
    run_slots = list(slots)  # the runs' batches, before the timing below adds calls
    # One stage-B batch alone, on the last batch's inputs, with the host
    # queued ahead of the device (cuda_ms): the device time of warp +
    # recognizer + CTC, which the host stage timer cannot see.
    # One call behind each wait: several in flight make the allocator wait.
    device = float(np.median([cuda_ms(lambda: pipe.stage_b(*last_b[0]), reps=1, warmup=1)
                              for _ in range(5)]))
    log(f"stage B per batch: device span on the main path {np.median(span_ms):.4f} ms "
        f"(median of {len(span_ms)}: {', '.join(f'{m:.3f}' for m in span_ms)}; line slots "
        f"a page: {run_slots}); device time alone {device:.4f} ms on the last batch "
        f"({last_b[0][1].shape[1]} slots a page)")
    log("stage times (both page-transport runs):\n" + timing.timing_report())
    pipe.stage_b, pipe.stage_b_recognize = stage_b, stage_b_recognize
    return pipe, launches, {"stage_b_span_ms": float(np.median(span_ms)),
                            "stage_b_device_ms": device,
                            "stage_b_slots": [int(n) for n in run_slots]}


def run_config2(pipe, rng, smi: str):
    """Config 2's semantics on the card: page images -> CNN detection ->
    CC parse -> paragraph clustering -> warp + recognition -> PageLayout
    with alpha-shape regions -> Page XML bytes, through
    ``FastPagePipeline.process_pages`` (assembly on its consumer thread,
    the XML serialized as each page arrives, inside the timed window).
    Then the host-route A/B: the same pages through a pipeline on the
    numpy route (``native=False``) twice and this one again, each run's
    Page XML equal to the first's.  Returns the warp's launches, the
    run's numbers, the last stage-B batch's warp arguments (the main
    path's shapes) and the host record for check_host_native (the last
    batch's stage-A transport, scale and lines, the host calls, the
    A/B)."""
    n_pages = 2 * PAGE_BATCH
    pages, lines = synthetic_pages(rng, n_pages, TWO_COLUMNS)
    ids = [f"p{i:04d}" for i in range(n_pages)]
    fast = FastPagePipeline(pipe, BENCH_CHARS, page_batch=PAGE_BATCH)
    last_b, slots, last_batch, last_unpack = [], [], [], []
    stage_b, batch_lines, unpack = pipe.stage_b, pipe._batch_lines, pipe._unpack_stage_a

    def kept_stage_b(*b_args):
        last_b[:] = [b_args]
        slots.append(b_args[1].shape[1])
        return stage_b(*b_args)

    def kept_unpack(*transport):
        last_unpack[:] = [transport]
        return unpack(*transport)

    def kept_batch_lines(pages_, ids_, override, masks, ds=None):
        out = batch_lines(pages_, ids_, override, masks, ds)
        last_batch[:] = [(last_unpack[0], ds, out[0])]
        return out

    pipe.stage_b, pipe._batch_lines, pipe._unpack_stage_a = (
        kept_stage_b, kept_batch_lines, kept_unpack)

    def drive(fast, n):
        out = []
        t0 = time.perf_counter()
        for layout in fast.process_pages(pages[:n], ids[:n]):
            with timing.stage_timer("document/pagexml"):
                out.append((layout, layout.to_pagexml_string()))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    drive(fast, PAGE_BATCH)  # warm-up at the two-column shapes
    timing.reset_timing()
    slots.clear()
    warp_ops.warp_lines.launches = 0
    native.calls.clear()
    out, seconds = drive(fast, n_pages)
    launches = warp_ops.warp_lines.launches
    host_calls = dict(native.calls)
    native_stats = timing.timing_stats()

    if [layout.id for layout, _ in out] != ids:
        raise AssertionError("config 2: layouts out of page order")
    n_lines = n_regions = n_bytes = 0
    batches_with_lines = set()
    for i, (layout, xml) in enumerate(out):
        root = ET.fromstring(xml.encode("utf-8"))
        regions = root.findall(f"{PAGE_NS}Page/{PAGE_NS}TextRegion")
        in_xml = sum(len(r.findall(f"{PAGE_NS}TextLine")) for r in regions)
        indices = sorted(line.index for line in layout.lines_iterator())
        if len(regions) < 2:
            raise AssertionError(f"config 2: page {i} has {len(regions)} regions, want >= 2")
        if indices != list(range(len(indices))) or in_xml != len(indices):
            raise AssertionError(f"config 2: page {i}: a line is in no region or in two")
        n_lines += len(indices)
        n_regions += len(regions)
        n_bytes += len(xml.encode("utf-8"))
        if indices:
            batches_with_lines.add(i // PAGE_BATCH)
    recall = line_recall(
        [[line.baseline for line in layout.lines_iterator()] for layout, _ in out], lines
    )
    log(f"config 2 (Page XML): {n_pages} pages, {n_lines} lines, {n_regions} regions, "
        f"{n_bytes} XML bytes; line recall {recall:.3f}; "
        f"{n_pages / seconds:.3f} pages/s to Page XML ({seconds:.3f} s) on {smi}")
    if recall < MIN_LINE_RECALL:
        raise AssertionError(f"config 2: found {recall:.3f} < {MIN_LINE_RECALL} of the lines")
    log(f"warp_lines launches in config 2: {launches}, stage-B batches: "
        f"{len(batches_with_lines)}, line slots a page: {slots}")
    if launches != len(batches_with_lines) or launches == 0:
        raise AssertionError("config 2: warp kernel launches != stage-B batches")
    log("stage times (config 2 run):\n" + timing.timing_report())
    pipe.stage_b, pipe._batch_lines, pipe._unpack_stage_a = stage_b, batch_lines, unpack
    stage_a, ds, page_lines = last_batch[0]

    # The A/B: the same pages on the numpy route (the same weights)
    # twice, then on the C++ route again: A B B A.
    numpy_pipe = bench_pipeline(native=False)
    numpy_fast = FastPagePipeline(numpy_pipe, BENCH_CHARS, page_batch=PAGE_BATCH)
    drive(numpy_fast, PAGE_BATCH)
    runs = [("native", out, seconds, native_stats)]
    for route, fast_ in (("numpy", numpy_fast), ("numpy", numpy_fast), ("native", fast)):
        timing.reset_timing()
        run_out, run_seconds = drive(fast_, n_pages)
        runs.append((route, run_out, run_seconds, timing.timing_stats()))
        log(f"stage times (config 2 run, {route} route, A/B run {len(runs)}):\n"
            + timing.timing_report())
    ab = route_ab(runs, FAST_STAGES, smi, "config 2", host_calls)
    host = {"pipe": pipe, "numpy_pipe": numpy_pipe, "stage_a": stage_a, "ds": ds,
            "page_lines": page_lines, "ab": ab}
    # Stage B's device time alone on the last batch.
    device = float(np.median([cuda_ms(lambda: pipe.stage_b(*last_b[0]), reps=1, warmup=1)
                              for _ in range(5)]))
    log(f"config 2: stage B device time alone {device:.4f} ms per batch of {PAGE_BATCH} "
        f"pages at {last_b[0][1].shape[1]} line slots a page")
    return launches, {"config2_pages_per_s": n_pages / seconds, "config2_lines": n_lines,
                      "config2_regions": n_regions, "config2_stage_b_device_ms": device,
                      "config2_stage_b_slots": [int(n) for n in slots]}, (
        *last_b[0], pipe.crop_height, pipe.crop_bucket), host


# ----------------------------------------------------------------------
# The JPEG codec (csrc/jpeg.cpp): the committed fixtures of tests/data/jpeg
# (cv2's digests, written where cv2 runs) reproduced by this machine's
# build, and the codec's host times.
JPEG_FIXTURES = os.path.join(REPO, "tests", "data", "jpeg")
JPEG_CROP = (32, 1024)  # the encode timing's crop: one line at the recognizer's height


def check_jpeg_fixtures(smi: str) -> dict:
    """Every decode and encode of ``tests/data/jpeg/fixtures.json``
    reproduced digest for digest by this machine's build of
    ``csrc/jpeg.cpp`` (built by kernels.build with the host compiler);
    then host times, median of HOST_REPEATS after a warm-up: the decode
    of a 2560x1792 colour 4:2:0 page at JPEG_PAGE_QUALITY (a synthetic
    page tinted apart in its three channels, encoded by the port) and the
    encode of a 32x1024 crop at LINE_QUALITY (three equal channels, as
    the fast path's crops)."""
    with open(os.path.join(JPEG_FIXTURES, "fixtures.json"), encoding="utf-8") as f:
        spec = json.load(f)
    differ, n_encodes = [], 0
    for name, digest in spec["decode"].items():
        img = image_io.imread(os.path.join(JPEG_FIXTURES, name))
        if (hashlib.sha256(img.tobytes()).hexdigest() != digest["sha256"]
                or list(img.shape) != digest["shape"]):
            differ.append(name)
    for name, cases in spec["encode"].items():
        crop = np.load(os.path.join(JPEG_FIXTURES, name))
        for quality, digest in cases.items():
            n_encodes += 1
            if hashlib.sha256(image_io.encode_jpeg(crop, int(quality))).hexdigest() != digest:
                differ.append(f"{name} at quality {quality}")
    log(f"JPEG fixtures ({spec['made_with']}): {len(spec['decode'])} decodes and {n_encodes} "
        f"encodes, {len(spec['decode']) + n_encodes - len(differ)} reproduced; differ: {differ}")
    if differ:
        raise AssertionError(f"the JPEG codec's build differs from the fixtures on {differ}")
    rng = np.random.default_rng(16)
    gray = synthetic_pages(rng, 1, TWO_COLUMNS)[0][0][:, :, 0].astype(np.int16)
    page = np.dstack([gray, gray - 12, gray + 9]).clip(0, 255).astype(np.uint8)
    data = image_io.encode_jpeg(page, JPEG_PAGE_QUALITY)
    decode_ms = host_ms(lambda: decode_jpeg(data))
    crop = np.ascontiguousarray(np.repeat(page[:JPEG_CROP[0], :JPEG_CROP[1], :1], 3, axis=2))
    encode_ms = host_ms(lambda: image_io.encode_jpeg(crop, LINE_QUALITY), repeats=25)
    numbers = {"fixtures_decoded": len(spec["decode"]), "fixtures_encoded": n_encodes,
               "fixtures_made_with": spec["made_with"],
               "decode_ms_page_2560x1792_420_q90": decode_ms, "page_bytes": len(data),
               "encode_ms_crop_32x1024_q98": encode_ms,
               "crop_bytes": len(image_io.encode_jpeg(crop, LINE_QUALITY)),
               "host": "the card machine's CPU, one thread", "card": smi}
    log(f"JPEG codec, host times on the card's machine (one thread): decode "
        f"{decode_ms:.2f} ms a 2560x1792 colour 4:2:0 page at quality {JPEG_PAGE_QUALITY} "
        f"({len(data)} B), encode {encode_ms:.3f} ms a 32x1024 crop at quality "
        f"{LINE_QUALITY}; beside {smi}")
    return numbers


# ----------------------------------------------------------------------
# PNG pages (the flax msgpack checkpoints are utils/checkpoint.save_variables
# of utils/convert.py's *_params_to_flax).
def png_bytes(page: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of a BGR uint8 page, every row with filter 0."""
    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    h, w = page.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = page[:, :, ::-1].reshape(h, 3 * w)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


CLI_INI = """[PAGE_PARSER]
RUN_LAYOUT_PARSER = yes
RUN_LINE_CROPPER = yes
RUN_OCR = yes

[LAYOUT_PARSER_1]
METHOD = LAYOUT_CNN
MODEL_PATH = ./parsenet.msgpack
DOWNSAMPLE = 4
DETECTION_THRESHOLD = 0.2
MAX_MEGAPIXELS = 5
ADAPTIVE_DOWNSAMPLE = yes
FAST_STEM = yes
OUT_UPSAMPLE = 2
BASE_FEATURES = 32
DEPTH = 4

[LINE_CROPPER]
INTERP = 2
LINE_SCALE = 1.0
LINE_HEIGHT = 32

[OCR]
OCR_JSON = ./ocr.json
"""


def write_bundle(tmp: str, pn: ParseNet, rec: CTCRecognizer, pages: dict, jpeg=None):
    """The command line's inputs in ``tmp``: ``pages`` (id -> BGR page)
    as image files under images/ (see :func:`write_pages`), the modules
    as flax msgpack checkpoints, the OCR JSON and CLI_INI.  Returns (ini
    path, images dir)."""
    images = write_pages(tmp, pages, jpeg)
    checkpoint.save_variables(convert.parsenet_params_to_flax(pn), os.path.join(tmp, "parsenet.msgpack"))
    write_recognizer(tmp, rec)
    ini = os.path.join(tmp, "config.ini")
    with open(ini, "w", encoding="utf-8") as f:
        f.write(CLI_INI)
    return ini, images


JPEG_PAGE_QUALITY = 90  # the JPEG pages the command lines read


def write_pages(tmp: str, pages: dict, jpeg=None) -> str:
    """``pages`` (id -> BGR page) as PNG files under ``tmp``/images/; with
    ``jpeg`` "color" as JPEG files at JPEG_PAGE_QUALITY written by the
    port's encoder (YCbCr 4:2:0), with "gray" as one-component JPEG of
    the first channel."""
    images = os.path.join(tmp, "images")
    os.makedirs(images)
    for page_id, page in pages.items():
        if jpeg is None:
            name, data = page_id + ".png", png_bytes(page)
        else:
            img = page[:, :, 0] if jpeg == "gray" else page
            name, data = page_id + ".jpg", image_io.encode_jpeg(img, JPEG_PAGE_QUALITY)
        with open(os.path.join(images, name), "wb") as f:
            f.write(data)
    return images


def read_pages(images: str, ids) -> list:
    """The pages of ``images`` as the command line decodes them."""
    names = {os.path.splitext(n)[0]: n for n in os.listdir(images)}
    return [image_io.imread(os.path.join(images, names[pid])) for pid in ids]


def timer_row(stdout: str, name: str):
    """(total s, calls) of a ``--timing-report`` row, or None."""
    m = re.search(rf"^{re.escape(name)}\s+([0-9.]+)\s+(\d+)\s", stdout, re.M)
    return (float(m.group(1)), int(m.group(2))) if m else None


def line_files(folder: str) -> dict:
    """name -> bytes of the files of a line-crop folder."""
    out = {}
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name), "rb") as f:
            out[name] = f.read()
    return out


def crop_bytes(layout) -> dict:
    """The line files a layout's crops make: name -> the port's JPEG at
    the command line's quality, as its PageOutputs writes them."""
    return {f"{layout.id}-{line.id}.jpg": image_io.encode_jpeg(
        np.asarray(line.crop).astype(np.uint8), LINE_QUALITY) for line in layout.lines_iterator()}


def write_recognizer(folder: str, rec: CTCRecognizer, dtype: str = "bfloat16") -> None:
    """The recognizer as a flax msgpack checkpoint beside its OCR JSON
    (``ocr.json``, BENCH_CHARS, ``dtype``) in ``folder``; its LSTM input
    biases are folded first, so that the module equals what loads."""
    convert.fold_lstm_input_bias_(rec)
    checkpoint.save_variables(convert.recognizer_params_to_flax(rec),
                          os.path.join(folder, "recognizer.msgpack"))
    spec = rec.spec
    with open(os.path.join(folder, "ocr.json"), "w", encoding="utf-8") as f:
        json.dump({"characters": BENCH_CHARS[:-1], "line_px_height": spec.line_height,
                   "checkpoint": "recognizer.msgpack", "net_spec": {
                       "conv_features": list(spec.conv_features),
                       "subsampling": spec.subsampling, "lstm_layers": spec.lstm_layers,
                       "lstm_features": spec.lstm_features, "stem": spec.stem,
                       "norm": spec.norm, "dtype": dtype}}, f)


def run_cli(pipe: TorchPagePipeline, rng, smi: str):
    """Config 2 through the port's command line: 16 two-column pages as
    colour JPEG files (the port's encoder, 4:2:0, JPEG_PAGE_QUALITY), the
    bench modules as flax msgpack checkpoints with an OCR JSON and a
    config, ``python -m pero_ocr_tpu_torch.scripts.parse_folder`` in a
    subprocess, without and then with --output-line-path; then each Page
    XML file against an in-process FastPagePipeline with the command
    line's settings, on the same modules (not reloaded) and the same
    files decoded in process by ``image_io.imread``, and each line file
    against the in-process crop's JPEG bytes.  The warp must launch once
    per stage-B batch in every run.  Returns the warp's launches in the
    in-process run, the phase's numbers and the last stage-B batch's
    warp arguments (the command line's shapes)."""
    n_pages = 2 * PAGE_BATCH
    pages, lines = synthetic_pages(rng, n_pages, TWO_COLUMNS)
    ids = [f"p{i:04d}" for i in range(n_pages)]
    pn, rec = pipe.parsenet, pipe.recognizer
    runs = {}
    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        ini, images = write_bundle(tmp, pn, rec, dict(zip(ids, pages)), jpeg="color")
        pages = read_pages(images, ids)
        for export in (False, True):
            out_dir = os.path.join(tmp, f"page_xml_{int(export)}")
            line_dir = os.path.join(tmp, "lines")
            proc, wall = run_parse_folder(
                ["-c", ini, "-i", images, "--output-xml-path", out_dir, "--fast-pipeline",
                 "--timing-report"] + (["--output-line-path", line_dir] if export else []),
                "command line" + (" with line export" if export else ""))
            files = sorted(os.listdir(out_dir))
            if files != [page_id + ".xml" for page_id in ids]:
                raise AssertionError(f"the command line wrote {files}")
            xml = {}
            for name in files:
                with open(os.path.join(out_dir, name), encoding="utf-8") as f:
                    xml[name[:-4]] = f.read()
                ET.fromstring(xml[name[:-4]].encode("utf-8"))
            timed = timer_row(proc.stdout, "cli/pages")
            decode = timer_row(proc.stdout, "cli/decode")
            counted = re.search(r"^warp_lines kernel launches: (\d+)$", proc.stdout, re.M)
            if timed is None or counted is None or decode is None or decode[1] != n_pages:
                raise AssertionError("the command line's timing report lacks cli/pages, "
                                     "cli/decode a page or the launches")
            written = timer_row(proc.stdout, "cli/write_lines")
            if export and (written is None or written[1] != n_pages):
                raise AssertionError("the command line's timing report lacks cli/write_lines")
            runs[export] = {"xml": xml, "wall": wall, "pages_per_s": n_pages / timed[0],
                            "launches": int(counted.group(1)), "decode_ms": 1e3 * decode[0] / n_pages,
                            "write_lines_ms": 1e3 * written[0] / n_pages if export else None,
                            "lines": line_files(line_dir) if export else None}

    same = TorchPagePipeline(
        pn, rec, downsample=4, detection_threshold=0.2, line_end_weight=1.0,
        crop_height=CROP_H, crop_bucket=FastPagePipeline.CROP_BUCKET,
        line_slot=FastPagePipeline.LINE_SLOT, height_scale=1.0, transport_bits=4,
        adaptive_downsample=True, device="cuda",
    )
    fast = FastPagePipeline(same, BENCH_CHARS, page_batch=CLI_PAGE_BATCH, want_crops=True)
    last_b, slots = [], []
    stage_b = same.stage_b

    def kept_stage_b(*b_args):
        last_b[:] = [b_args]
        slots.append(b_args[1].shape[1])
        return stage_b(*b_args)

    same.stage_b = kept_stage_b
    warp_ops.warp_lines.launches = 0
    t0 = time.perf_counter()
    out = [(layout, layout.to_pagexml_string()) for layout in fast.process_pages(pages, ids)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = warp_ops.warp_lines.launches
    batches = len({i // CLI_PAGE_BATCH for i, (layout, _) in enumerate(out)
                   if any(True for _ in layout.lines_iterator())})
    differ = {export: [layout.id for layout, xml in out
                       if mask_pagexml(xml) != mask_pagexml(run["xml"][layout.id])]
              for export, run in runs.items()}
    want_lines = {}
    for layout, _ in out:
        want_lines.update(crop_bytes(layout))
    got_lines = runs[True]["lines"]
    line_differ = sorted(n for n in set(want_lines) | set(got_lines)
                         if want_lines.get(n) != got_lines.get(n))
    n_lines = sum(len(list(layout.lines_iterator())) for layout, _ in out)
    recall = line_recall(
        [[line.baseline for line in layout.lines_iterator()] for layout, _ in out], lines
    )
    plain, export = runs[False], runs[True]
    log(f"command line vs in-process (JPEG pages): {n_pages - len(differ[False])} / "
        f"{n_pages - len(differ[True])} of {n_pages} Page XML files equal without / with line "
        f"export (timestamps masked), {n_lines} lines, line recall {recall:.3f}; line files "
        f"{len(got_lines)}, {len(want_lines) - len(line_differ)} of {len(want_lines)} equal to "
        f"the in-process crops' JPEG; warp_lines launches in-process {launches}, in the command "
        f"line {plain['launches']} / {export['launches']}, stage-B batches {batches}, line slots "
        f"a page {slots}; command line {plain['pages_per_s']:.3f} pages/s without line export, "
        f"{export['pages_per_s']:.3f} with it, by its own timer ({plain['wall']:.3f} / "
        f"{export['wall']:.3f} s wall); cli/decode {plain['decode_ms']:.2f} / "
        f"{export['decode_ms']:.2f} ms a page, cli/write_lines {export['write_lines_ms']:.2f} ms "
        f"a page (host times); in-process {n_pages / seconds:.3f} pages/s with crops, on {smi}")
    if differ[False] or differ[True]:
        raise AssertionError(f"the command line's Page XML differs on pages {differ}")
    if line_differ or not got_lines:
        raise AssertionError(f"the command line's line files differ: {line_differ[:10]}")
    if not (launches == plain["launches"] == export["launches"] == batches
            == n_pages // CLI_PAGE_BATCH):
        raise AssertionError("command line settings: warp kernel launches != stage-B batches")
    if recall < MIN_LINE_RECALL:
        raise AssertionError(f"command line: found {recall:.3f} < {MIN_LINE_RECALL} of the lines")
    same.stage_b = stage_b
    return launches, {"pages": n_pages, "page_format": "jpeg 4:2:0 q90",
                      "cli_wall_s": plain["wall"], "cli_pages_per_s": plain["pages_per_s"],
                      "cli_export_wall_s": export["wall"],
                      "cli_export_pages_per_s": export["pages_per_s"],
                      "cli_decode_ms_a_page": plain["decode_ms"],
                      "cli_export_decode_ms_a_page": export["decode_ms"],
                      "cli_write_lines_ms_a_page": export["write_lines_ms"],
                      "line_files": len(got_lines),
                      "in_process_pages_per_s": n_pages / seconds, "lines": n_lines,
                      "warp_launches": launches, "cli_warp_launches": plain["launches"],
                      "cli_export_warp_launches": export["launches"],
                      "stage_b_batches": batches, "stage_b_slots": [int(n) for n in slots],
                      "card": smi}, (*last_b[0], same.crop_height, same.crop_bucket)

# ----------------------------------------------------------------------
# Config 2 stage by stage: PageParser.process_page and the field warp
STAGE_TIMERS = ("layout", "parsenet_maps", "map_postprocess", "paragraph_clustering",
                "region_polygons", "line_crop", "ocr")
# Operations per output pixel of the field warp: floor 2, fractions 2,
# 1 - f 2, then per channel 6 multiplies and 3 adds.
FIELD_OPS_PER_PIXEL, FIELD_OPS_PER_CHANNEL = 6, 9


def staged_parser(ini: str, device: str, native=None) -> PageParser:
    """The config's PageParser; ``native``, where given, sets its
    layout's host route (else it follows ``device``)."""
    config = configparser.ConfigParser()
    config.read(ini)
    parser = PageParser(config, device=device, config_path=os.path.dirname(ini))
    if native is not None:
        for lp in parser.layout_parsers:
            if isinstance(lp, LayoutExtractor):
                lp.engine.native = native
    return parser


def random_fields(rng, n: int, hc: int, wb: int, h: int, w: int) -> np.ndarray:
    """(n, hc, wb, 2) fields over and around an h x w page: uniform
    coordinates, padded columns (-1e6), NaN and infinite entries,
    coordinates past int32, integer ones."""
    f = np.stack([rng.uniform(-20, w + 20, (n, hc, wb)),
                  rng.uniform(-20, h + 20, (n, hc, wb))], axis=-1).astype(np.float32)
    flat = f.reshape(-1, 2)
    for value, share in ((-1e6, 0.1), (np.nan, 0.02), (np.inf, 0.01), (-np.inf, 0.01),
                         (3e9, 0.01), (-5e9, 0.01)):
        idx = rng.choice(len(flat), int(share * len(flat)), replace=False)
        flat[idx, rng.integers(0, 2, len(idx))] = value
    idx = rng.choice(len(flat), len(flat) // 10, replace=False)
    flat[idx] = np.round(flat[idx])
    return f


def fields_equal(page: torch.Tensor, fields: torch.Tensor, label: str) -> float:
    """warp_fields against warp_fields_plain in both stores: bit for bit.
    Returns the largest |kernel - plain|."""
    max_abs = 0.0
    for store in warp_ops.FIELD_STORES:
        got = warp_ops.warp_fields(page, fields, store)
        want = warp_ops.warp_fields_plain(page, fields, store)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"warp_fields {label} {store}: {got.dtype} {tuple(got.shape)}")
        bad = int((got.view(torch.int32) != want.view(torch.int32)).sum()) if store == "f32" \
            else int((got != want).sum())
        max_abs = max(max_abs, float((got.float() - want.float()).abs().max()))
        log(f"warp_fields {label} {store}: {bad} of {got.numel()} values not bit-equal")
        if bad:
            raise AssertionError(f"warp_fields {label} {store} disagrees with its plain version")
    return max_abs


def warp_packed(page: torch.Tensor, buffer: torch.Tensor, shapes, store: str):
    """One warp_fields call over a packed field buffer (flat float32, on
    the card) of buckets of (N, Hc, Wb) samples, as LineCropper makes it:
    the crops, split back into one (N, Hc, Wb, C) view a bucket."""
    out = warp_ops.warp_fields(page, buffer.view(1, 1, -1, 2), store)
    return warp_ops.split_fields(out.view(-1), shapes, page.shape[2])


def packed_equal(page: torch.Tensor, buffer: torch.Tensor, shapes, label: str) -> float:
    """warp_packed against warp_fields_plain bucket by bucket, in both
    stores, bit for bit, one launch a call.  Returns the largest
    |kernel - plain|."""
    max_abs = 0.0
    for store in warp_ops.FIELD_STORES:
        before = warp_ops.warp_fields.launches
        crops = warp_packed(page, buffer, shapes, store)
        launches = warp_ops.warp_fields.launches - before
        bad = n = 0
        for got, f in zip(crops, warp_ops.split_fields(buffer, shapes)):
            want = warp_ops.warp_fields_plain(page, f, store)
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"warp_fields packed {label} {store}: {got.dtype} "
                                     f"{tuple(got.shape)}")
            bits = torch.int32 if store == "f32" else torch.uint8
            bad += int((got.view(bits) != want.view(bits)).sum())
            n += got.numel()
            max_abs = max(max_abs, float((got.float() - want.float()).abs().max()))
        torch.cuda.synchronize()
        log(f"warp_fields packed {label} {store}: {bad} of {n} values not bit-equal, "
            f"{launches} launch(es)")
        if bad or launches != 1:
            raise AssertionError(f"warp_fields packed {label} {store} disagrees with its plain "
                                 f"version or took {launches} launches")
    return max_abs


# Random buckets for the packed call: odd sizes (Wb 1023, odd Hc) and an
# odd total, which leaves the kernel's last warp partly filled.
RAGGED_SHAPES = [(5, 9, 1023), (16, 40, 1024), (2, 7, 517)]


def random_packed_fields(rng, shapes, h: int, w: int) -> torch.Tensor:
    """One field_buffer of ``shapes`` holding random_fields, on the card."""
    buffer = warp_ops.field_buffer(shapes)
    for view, (n, hc, wb) in zip(warp_ops.split_fields(buffer, shapes), shapes):
        view[...] = random_fields(rng, n, hc, wb, h, w)
    return torch.from_numpy(buffer).cuda()


def check_warp_fields(page: torch.Tensor, buffer: torch.Tensor, shapes, rng, label: str):
    """The field warp on one page's width buckets (``buffer``: their
    fields packed as LineCropper uploads them, of (N, Hc, Wb) ``shapes``;
    u8 store): one call over the packed buffer (one launch) and one call
    on each bucket bit-equal to the plain version in both stores, here
    and on random fields (off-page, NaN, infinite and padded coordinates;
    C = 1 and 3; uint8 and float32 pages; a partly filled last warp);
    then the packed call's time, warm and cold, beside the calls a
    bucket (one launch each), the plain version's, ``F.grid_sample``'s on
    the same fields and its bound."""
    buckets = warp_ops.split_fields(buffer, shapes)
    max_abs = max(fields_equal(page, f, f"{label} bucket {tuple(f.shape)}") for f in buckets)
    max_abs = max(max_abs, packed_equal(page, buffer, shapes, f"{label}, {len(shapes)} buckets"))
    h, w = page.shape[:2]
    for c in (1, 3):
        test_page = page[:, :, :c].contiguous()
        f = torch.from_numpy(random_fields(rng, 16, 40, 1024, h, w)).cuda()
        fields_equal(test_page, f, f"random fields, C={c}")
        fields_equal(test_page.float(), f, f"random fields, float32 page, C={c}")
        ragged = random_packed_fields(rng, RAGGED_SHAPES, h, w)
        packed_equal(test_page, ragged, RAGGED_SHAPES, f"random buckets {RAGGED_SHAPES}, C={c}")
        packed_equal(test_page.float(), ragged, RAGGED_SHAPES,
                     f"random buckets {RAGGED_SHAPES}, float32 page, C={c}")

    def run():
        return warp_packed(page, buffer, shapes, "u8")

    def per_bucket():
        return [warp_ops.warp_fields(page, f, "u8") for f in buckets]

    page_f = page.permute(2, 0, 1)[None].float()
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=page.device)
    grids = [(f * scale - 1.0).reshape(1, -1, f.shape[2], 2) for f in buckets]

    def library():
        return [F.grid_sample(page_f, g, mode="bilinear", padding_mode="zeros",
                              align_corners=True) for g in grids]

    warm, cold = cuda_ms(run), cuda_ms(run, cold=True)
    split_warm, split_cold = cuda_ms(per_bucket), cuda_ms(per_bucket, cold=True)
    lib_warm, lib_cold = cuda_ms(library), cuda_ms(library, cold=True)
    plain_ms = cuda_ms(lambda: [warp_ops.warp_fields_plain(page, f, "u8") for f in buckets],
                       reps=5, warmup=1, ahead=False)
    nbytes = sum(warp_ops.warp_fields_bytes(page, f, "u8") for f in buckets)
    samples = sum(f[..., 0].numel() for f in buckets)
    ops = samples * (FIELD_OPS_PER_PIXEL + FIELD_OPS_PER_CHANNEL * page.shape[2])
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_FLOP_PER_S
    bound = max(bytes_ms, ops_ms)
    log(f"warp_fields {label}: {len(buckets)} buckets {[tuple(f.shape) for f in buckets]}, "
        f"{samples} samples; packed (1 launch) {warm:.4f} ms warm ({bound / warm:.3f} of its "
        f"bound), {cold:.4f} ms cold; a launch a bucket {split_warm:.4f} ms warm, "
        f"{split_cold:.4f} ms cold; bound {bytes_ms:.4f} ms by {nbytes} bytes, {ops_ms:.4f} ms "
        f"by {ops} ops; plain {plain_ms:.4f} ms; F.grid_sample {lib_warm:.4f} ms warm, "
        f"{lib_cold:.4f} ms cold")
    return {"max_abs_err": max_abs, "ms": warm, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_warm, "ms_warm": warm, "ms_cold": cold,
            "bound_share": bound / warm, "per_bucket_ms_warm": split_warm,
            "per_bucket_ms_cold": split_cold, "library_ms_cold": lib_cold, "bytes": nbytes,
            "samples": samples, "buckets": [list(f.shape) for f in buckets]}


def page_buckets(parser: PageParser, layout, page: np.ndarray):
    """The field warp's inputs for one page as LineCropper builds them:
    the page on the card, the non-empty width buckets' fields packed in
    one buffer on the card and the buckets' (N, Hc, Wb) shapes."""
    cropper = parser.line_cropper
    fields = [cropper.crop_engine.get_crop_inputs(ln.baseline, ln.heights,
                                                  cropper.crop_engine.line_height)
              for ln in layout.lines_iterator()]
    buffer, shapes, _, _ = cropper.pack_fields(fields)
    return (torch.from_numpy(np.ascontiguousarray(page)).cuda(),
            torch.from_numpy(buffer).cuda(), shapes)


def rotate_ring(points: str) -> str:
    """A Page XML points list started at its least (x, y) vertex: an
    alpha-shape region outline starts where the triangulation's boundary
    walk does, which float32 noise between two processes' ParseNet maps
    (cuDNN may choose other algorithms) can move along the same ring."""
    pts = points.split()
    start = min(range(len(pts)), key=lambda k: tuple(map(int, pts[k].split(","))))
    return " ".join(pts[start:] + pts[:start])


def staged_regions(xml: str):
    """A stage-by-stage Page XML as [(region id, outline, sorted lines)],
    a line as (outline, baseline, text, conf).  Lines that share a row
    (a row the detector split, or the two columns) take their order and
    numbers from ``random``'s jitter (order_lines_vertical), which each
    process draws anew, so they are compared as a set."""
    root = ET.fromstring(xml.encode("utf-8"))
    out = []
    for region in root.findall(f"{PAGE_NS}Page/{PAGE_NS}TextRegion"):
        lines = []
        for line in region.findall(f"{PAGE_NS}TextLine"):
            equiv = line.find(f"{PAGE_NS}TextEquiv")
            lines.append((line.find(f"{PAGE_NS}Coords").get("points"),
                          line.find(f"{PAGE_NS}Baseline").get("points"),
                          equiv.find(f"{PAGE_NS}Unicode").text or "",
                          float(equiv.get("conf"))))
        out.append((region.get("id"), rotate_ring(region.find(f"{PAGE_NS}Coords").get("points")),
                    sorted(lines)))
    return out


def same_staged_page(a: str, b: str, tol: float = 0.0015) -> bool:
    """Equal regions and lines (see staged_regions), conf within ``tol``."""
    ra, rb = staged_regions(a), staged_regions(b)
    if [r[:2] for r in ra] != [r[:2] for r in rb]:
        return False
    for (_, _, la), (_, _, lb) in zip(ra, rb):
        if [x[:3] for x in la] != [x[:3] for x in lb]:
            return False
        if any(abs(x[3] - y[3]) > tol for x, y in zip(la, lb)):
            return False
    return True


def confs_close(a: str, b: str, tol: float = 0.0015) -> bool:
    ca, cb = (np.asarray(re.findall(r'conf="([0-9.]+)"', x), float) for x in (a, b))
    return ca.shape == cb.shape and bool(np.abs(ca - cb).max(initial=0) <= tol)


# The staged path's ParseNet maps on the card against the CPU's, float32
# with TF32 off: cuDNN sums in another order (measured: see the log line
# of check_staged_against_cpu).
STAGED_MAPS_ATOL = 1e-3


def check_staged_against_cpu(rng) -> dict:
    """A small float32 stage-by-stage run (TF32 off) on the card against
    the same PageParser on the CPU.  Each page's ParseNet maps must agree
    within STAGED_MAPS_ATOL; the CPU run then continues from the card's
    maps, and the two Page XMLs must be equal (conf within 0.0015).  The
    rest of the staged layout turns float heights into integer outlines
    (alpha shapes, the 5 px simplification, raster clipping), so maps
    1e-6 apart can move a vertex: equal maps isolate what follows them,
    the field warp kernel and the recognizer on the card.  Returns the
    two runs' Page XML ({"cuda": [...], "cpu": [...]}), which
    run_user_scripts compares again with compare_page_xml_texts."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    pn = ParseNet(base_features=8, depth=2, stem="s2d", out_upsample=2, dtype=torch.float32)
    edge_detector_(pn)
    rec = CTCRecognizer(RecognizerSpec(
        num_classes=80, line_height=CROP_H, conv_features=(8, 16), subsampling=4,
        lstm_layers=1, lstm_features=16, dtype=torch.float32, stem="s2d", norm="group",
    ), generator=torch.Generator().manual_seed(1))
    pages, _ = synthetic_pages(rng, 2, TWO_COLUMNS)
    pages = [p[:1280] for p in pages]
    xml, card_maps, maps_err = {}, [], []
    with tempfile.TemporaryDirectory(prefix="staged_cpu_") as tmp:
        ini = os.path.join(tmp, "config.ini")
        with open(ini, "w", encoding="utf-8") as f:
            f.write(CLI_INI.replace("BASE_FEATURES = 32", "BASE_FEATURES = 8")
                    .replace("DEPTH = 4", "DEPTH = 2"))
        with open(os.path.join(tmp, "ocr.json"), "w", encoding="utf-8") as f:
            json.dump({"characters": BENCH_CHARS[:-1], "line_px_height": CROP_H, "net_spec": {
                "conv_features": [8, 16], "subsampling": 4, "lstm_layers": 1,
                "lstm_features": 16, "stem": "s2d", "norm": "group", "dtype": "float32"}}, f)
        for device in ("cuda", "cpu"):
            parser = staged_parser(ini, device)
            wrapper = parser.layout_parsers[0].engine.parsenet
            wrapper.model = copy.deepcopy(pn)
            parser.ocr.ocr_engine.model = copy.deepcopy(rec)
            own_maps, replay = wrapper.get_maps, iter(card_maps)

            def recorded(img, ds, own_maps=own_maps):
                card_maps.append(own_maps(img, ds))
                return card_maps[-1]

            def replayed(img, ds, own_maps=own_maps, replay=replay):
                card = next(replay)
                maps_err.append(float(np.abs(own_maps(img, ds) - card).max()))
                return card

            wrapper.get_maps = recorded if device == "cuda" else replayed
            random.seed(0)
            xml[device] = [parser.process_page(p, PageLayout(id=f"c{i}", page_size=p.shape[:2]))
                           .to_pagexml_string() for i, p in enumerate(pages)]
    torch.backends.cudnn.allow_tf32 = True
    n_lines = sum(x.count("<TextLine ") for x in xml["cpu"])
    log(f"staged reference check: ParseNet maps card vs CPU max |diff| "
        f"{max(maps_err):.3g} over {len(maps_err)} passes (f32, TF32 off)")
    if max(maps_err) > STAGED_MAPS_ATOL:
        raise AssertionError(f"staged: card ParseNet maps differ from CPU by {max(maps_err)}")
    for i, (a, b) in enumerate(zip(xml["cpu"], xml["cuda"])):
        a_text, b_text = (mask_pagexml(re.sub(r'conf="[0-9.]+"', "", x)) for x in (a, b))
        if a_text != b_text or not confs_close(a, b):
            diff = difflib.unified_diff(a_text.splitlines(), b_text.splitlines(), "cpu", "card",
                                        lineterm="")
            log("\n".join(list(diff)[:60]))
            raise AssertionError(f"staged page {i}: card Page XML differs from CPU")
    if n_lines < 20:
        raise AssertionError(f"staged reference check found only {n_lines} lines")
    log(f"staged reference check: from the same maps, card Page XML equals the CPU's on 2 "
        f"pages, {n_lines} lines")
    return xml


# Line crops of the staged command line against the in-process run's:
# the two processes' ParseNet maps differ by float32 noise (cuDNN may pick
# other algorithms), which moves a baseline by a fraction of a pixel and
# the field warp's samples by a gray level, while the Page XML's rounded
# numbers stay (same_staged_page).  Held to: files named as the command
# line's lines, crops of the same shape, and a mean absolute difference
# of their decoded pixels of at most STAGED_CROP_MEAN_ABS gray levels
# (another line, or a crop shifted by a pixel, is tens of levels away).
# The re-OCR command lines (-x, run_reocr) take their geometry from the
# file, and their line files equal the CPU's byte for byte.
STAGED_CROP_MEAN_ABS = 2.0


def staged_line_files(line_dir: str, xml_dir: str, out, smi: str) -> dict:
    """The layout run's line files against ``out``'s crops (see
    STAGED_CROP_MEAN_ABS).  Line ids come from random's jitter, drawn
    anew in each process, so a line may carry another id, or sit under
    another region id, in the command line's files (same_staged_page
    compares the lines as a set): a page's files must be named as the
    lines of the command line's own Page XML, as many as the in-process
    page has, and each must match its namesake or another crop of its
    page; raises where one matches none."""
    got = line_files(line_dir)
    decoded = {}
    same = permuted = 0
    worst, bad = 0.0, []
    for layout, _ in out:
        want = crop_bytes(layout)
        with open(os.path.join(xml_dir, layout.id + ".xml"), encoding="utf-8") as f:
            ids = re.findall(r'<TextLine id="([^"]+)"', f.read())
        names = sorted(f"{layout.id}-{line_id}.jpg" for line_id in ids)
        mine = sorted(n for n in got if n.startswith(layout.id + "-"))
        if mine != names or len(mine) != len(want):
            raise AssertionError(f"the stage-by-stage line files of {layout.id} are not named "
                                 f"as the lines of its Page XML or differ in number")
        values = set(want.values())
        for name in mine:
            data = got[name]
            if data == want.get(name):
                same += 1
                continue
            if data in values:
                permuted += 1
                continue
            if layout.id not in decoded:
                decoded[layout.id] = [decode_jpeg(b).astype(np.int16) for b in want.values()]
            a = decode_jpeg(data).astype(np.int16)
            best = min((float(np.abs(a - b).mean()) for b in decoded[layout.id]
                        if b.shape == a.shape), default=float("inf"))
            worst = max(worst, best)
            if best > STAGED_CROP_MEAN_ABS:
                bad.append(name)
    log(f"stage-by-stage line files: {len(got)}, named as the lines of the command line's Page "
        f"XML, as many as in process; {same} equal byte for byte to their namesake, {permuted} "
        f"to another line of the page (numbered otherwise), the rest within a mean of "
        f"{worst:.3f} gray levels of an in-process crop's decoded JPEG (bound "
        f"{STAGED_CROP_MEAN_ABS}); beyond it: {bad[:10]}")
    if bad:
        raise AssertionError(f"the stage-by-stage line files differ: {bad[:10]}")
    return {"line_files": len(got), "same_bytes": same, "permuted": permuted,
            "max_mean_abs_diff": worst}


def run_staged(pipe: TorchPagePipeline, rng, smi: str):
    """Config 2 stage by stage on the card: each of 8 two-column
    2560x1792 pages, written as one-component (gray) JPEG files by the
    port's encoder and read back by ``image_io.imread``, through
    ``PageParser(config, device="cuda").process_page`` and into Page XML,
    with the bench modules loaded from flax msgpack checkpoints; then the
    command line without --fast-pipeline on the first 4 of the files
    with --output-line-path, whose Page XML must equal the in-process
    run's and whose line files the in-process crops (staged_line_files).
    Between the two, the host-route A/B: the same pages through a
    PageParser on the numpy route twice and this one again (A B B A),
    each run's Page XML equal to the first's.  Returns the field warp's
    launches, the phase's numbers, the last page's warp inputs, the
    host record for check_host_native (the last page's host inputs, the
    A/B) and the first SCRIPT_PAGES pages' JPEG files and Page XML
    (id -> (bytes, xml), for run_user_scripts)."""
    pages, lines = synthetic_pages(rng, PAGE_BATCH, TWO_COLUMNS)
    ids = [f"s{i:04d}" for i in range(len(pages))]
    n_cli = 4
    with tempfile.TemporaryDirectory(prefix="staged_") as tmp:
        ini, images = write_bundle(tmp, pipe.parsenet, pipe.recognizer,
                                   dict(zip(ids, pages)), jpeg="gray")
        pages = read_pages(images, ids)
        cli_images = os.path.join(tmp, "cli_images")
        os.makedirs(cli_images)
        for pid in ids[:n_cli]:
            shutil.copy(os.path.join(images, pid + ".jpg"), cli_images)
        parser = staged_parser(ini, "cuda")
        engine = parser.layout_parsers[0].engine
        detected, detect = [], engine.detect

        def counted_detect(image, rot=0):
            out = detect(image, rot)
            detected.append(len(out[1]))
            return out

        engine.detect = counted_detect
        warm = pages[-1]  # cuDNN plans, the kernel's first load
        parser.process_page(warm, PageLayout(id="warm", page_size=warm.shape[:2]))
        engine.parsenet.last_downsample = engine.parsenet.init_downsample
        detected.clear()
        timing.reset_timing()
        warp_ops.warp_fields.launches = warp_ops.warp_lines.launches = 0
        native.calls.clear()
        with HostInputs() as host_inputs:  # the host geometry's inputs, a page at a time
            out, seconds = staged_pages(parser, ids, pages)
        launches, fused = warp_ops.warp_fields.launches, warp_ops.warp_lines.launches
        host_calls = dict(native.calls)
        stats = timing.timing_stats()
        log("stage times (staged run):\n" + timing.timing_report())

        # The A/B: the same pages through a PageParser on the numpy
        # route twice, then through this one again: A B B A.
        engine.detect = detect
        numpy_parser = staged_parser(ini, "cuda", native=False)
        numpy_parser.process_page(warm, PageLayout(id="warm", page_size=warm.shape[:2]))
        runs = [("native", out, seconds, stats)]
        for route, parser_ in (("numpy", numpy_parser), ("numpy", numpy_parser),
                               ("native", parser)):
            wrapper = parser_.layout_parsers[0].engine.parsenet
            wrapper.last_downsample = wrapper.init_downsample
            timing.reset_timing()
            run_out, run_seconds = staged_pages(parser_, ids, pages)
            runs.append((route, run_out, run_seconds, timing.timing_stats()))
            log(f"stage times (staged run, {route} route, A/B run {len(runs)}):\n"
                + timing.timing_report())
        ab = route_ab(runs, STAGED_HOST_STAGES, smi, "staged", host_calls)

        batched = []  # 1 for a page of DEVICE_BATCH_MIN lines or more: one launch
        n_lines = n_regions = 0
        for i, (layout, xml) in enumerate(out):
            root = ET.fromstring(xml.encode("utf-8"))
            regions = root.findall(f"{PAGE_NS}Page/{PAGE_NS}TextRegion")
            numbers = [int(e.get("id").rsplit("-l", 1)[1]) for r in regions
                       for e in r.findall(f"{PAGE_NS}TextLine")]
            if len(regions) < 2:
                raise AssertionError(f"staged: page {i} has {len(regions)} regions, want >= 2")
            if sorted(numbers) != list(range(1, detected[i] + 1)):
                raise AssertionError(f"staged: page {i}: a line is in no region or in two")
            batched.append(int(len(list(layout.lines_iterator()))
                               >= parser.line_cropper.DEVICE_BATCH_MIN))
            n_lines += len(numbers)
            n_regions += len(regions)
        recall = line_recall(
            [[ln.baseline for ln in layout.lines_iterator()] for layout, _ in out], lines)
        log(f"staged (PageParser.process_page): {len(pages)} pages, {n_lines} lines, {n_regions} "
            f"regions; line recall {recall:.3f}; {len(pages) / seconds:.3f} pages/s to Page XML "
            f"({seconds:.3f} s) on {smi}; ds {engine.parsenet.last_downsample}")
        log(f"warp_fields launches in the staged run: {launches}, pages of "
            f"{parser.line_cropper.DEVICE_BATCH_MIN} lines or more: {sum(batched)} of "
            f"{len(batched)}; warp_lines launches: {fused}")
        if recall < MIN_LINE_RECALL:
            raise AssertionError(f"staged: found {recall:.3f} < {MIN_LINE_RECALL} of the lines")
        if launches != sum(batched) or launches == 0 or fused != 0:
            raise AssertionError("staged: warp_fields launches != pages of "
                                 f"{parser.line_cropper.DEVICE_BATCH_MIN} lines or more")

        # The command line without --fast-pipeline on the first pages,
        # with the line crops.
        out_dir = os.path.join(tmp, "page_xml")
        line_dir = os.path.join(tmp, "lines")
        proc, cli_seconds = run_parse_folder(
            ["-c", ini, "-i", cli_images, "--output-xml-path", out_dir, "--output-line-path",
             line_dir, "--timing-report"], "command line (stage by stage, line export)")
        counted = re.search(r"^warp_fields kernel launches: (\d+)$", proc.stdout, re.M)
        timed = timer_row(proc.stdout, "cli/pages")
        decode = timer_row(proc.stdout, "cli/decode")
        written = timer_row(proc.stdout, "cli/write_lines")
        differ = []
        for pid, (layout, xml) in zip(ids[:n_cli], out):
            with open(os.path.join(out_dir, pid + ".xml"), encoding="utf-8") as f:
                cli_xml = f.read()
            if not same_staged_page(cli_xml, xml):
                differ.append(pid)
        if differ or None in (counted, timed, decode, written) or written[1] != n_cli:
            raise AssertionError(f"the stage-by-stage command line's files differ: {differ}, "
                                 "or its timing report lacks a row")
        cli_numbers = staged_line_files(line_dir, out_dir, out[:n_cli], smi)
        # Line export adds only cli/write_lines here (LineCropper's crops
        # exist either way): the pages/s without it from the same run.
        cli_numbers.update(
            pages_per_s=n_cli / timed[0], pages_per_s_without_write_lines=n_cli / (
                timed[0] - written[0]), wall=cli_seconds, launches=int(counted.group(1)),
            decode_ms=1e3 * decode[0] / decode[1], write_lines_ms=1e3 * written[0] / n_cli)
        log(f"stage-by-stage command line vs in-process: {n_cli} of {n_cli} files equal (lines "
            f"of a row as a set; conf within 0.0015); its warp_fields launches "
            f"{cli_numbers['launches']}; {cli_numbers['pages_per_s']:.3f} pages/s by its timer "
            f"with line export, {cli_numbers['pages_per_s_without_write_lines']:.3f} without "
            f"cli/write_lines; cli/decode {cli_numbers['decode_ms']:.2f} ms a page (gray JPEG, "
            f"on the decoding thread), cli/write_lines {cli_numbers['write_lines_ms']:.2f} ms a "
            f"page (host times), on {smi}")
        if cli_numbers["launches"] != sum(batched[:n_cli]):
            raise AssertionError("the stage-by-stage command line: warp_fields launches != "
                                 f"pages of {parser.line_cropper.DEVICE_BATCH_MIN} lines or more")
        last_page = page_buckets(parser, out[-1][0], pages[-1])
        script_pages = {}
        for pid, (_, xml) in zip(ids[:SCRIPT_PAGES], out):
            with open(os.path.join(images, pid + ".jpg"), "rb") as f:
                script_pages[pid] = (f.read(), xml)

    numbers = {"pages": len(pages), "pages_per_s": len(pages) / seconds, "lines": n_lines,
               "regions": n_regions, "line_recall": recall,
               "stage_ms": {k: 1e3 * stats[k][0] / stats[k][1] for k in STAGE_TIMERS
                            if k in stats},
               "stage_calls": {k: stats[k][1] for k in STAGE_TIMERS if k in stats},
               "warp_fields_launches": launches, "pages_of_4_lines_or_more": sum(batched),
               "page_format": "jpeg gray q90",
               "cli_pages_per_s": cli_numbers["pages_per_s"], "cli_wall_s": cli_numbers["wall"],
               "cli_pages_per_s_without_write_lines": cli_numbers[
                   "pages_per_s_without_write_lines"],
               "cli_decode_ms_a_page": cli_numbers["decode_ms"],
               "cli_write_lines_ms_a_page": cli_numbers["write_lines_ms"],
               "cli_line_files": cli_numbers["line_files"],
               "cli_line_files_same_bytes": cli_numbers["same_bytes"],
               "cli_line_files_renumbered": cli_numbers["permuted"],
               "cli_line_files_max_mean_abs_diff": cli_numbers["max_mean_abs_diff"],
               "cli_warp_fields_launches": cli_numbers["launches"], "card": smi}
    return (launches, numbers, last_page, {"inputs": host_inputs.pages[-1], "ab": ab},
            script_pages)


# ----------------------------------------------------------------------
# Config 1: one whole-page region, the classical line detector, greedy
# CTC, stage by stage (configs/config1_printed_greedy.ini)
A4_H, A4_W, A4_ROWS = 3508, 2480, 40  # an A4 page at 300 dpi, 40 text rows
CONFIG1_PAGES, CONFIG1_CLI_PAGES = 6, 3
CONFIG1_STAGES = ("layout", "line_crop", "ocr", "document/pagexml")
TEXT_EQUIV = re.compile(r"\s*<TextEquiv[^>]*>.*?</TextEquiv>", re.S)


def config1_recognizer(seed: int = 3) -> CTCRecognizer:
    """The bench recognizer's widths (bench.py) at config 1's line height,
    seeded random weights."""
    with open(os.path.join(REPO, "configs", "config1_printed_greedy.ini"), encoding="utf-8") as f:
        line_h = int(re.search(r"^LINE_HEIGHT = (\d+)$", f.read(), re.M).group(1))
    return bench_recognizer(line_h, seed)


def bench_recognizer(line_h: int, seed: int = 3) -> CTCRecognizer:
    """The bench recognizer's widths (bench.py) at line height ``line_h``,
    seeded random weights."""
    return CTCRecognizer(RecognizerSpec(
        num_classes=80, line_height=line_h, conv_features=(48, 96, 192, 384), subsampling=4,
        lstm_layers=2, lstm_features=256, stem="s2d", norm="group",
    ), generator=torch.Generator().manual_seed(seed))


def write_config1_bundle(tmp: str, rec: CTCRecognizer, pages: dict):
    """Config 1's ini as the repository has it, its recognizer under
    ocr_engine/ (flax msgpack and OCR JSON) and ``pages`` as PNG files.
    Returns (ini path, images dir)."""
    images = write_pages(tmp, pages)
    os.makedirs(os.path.join(tmp, "ocr_engine"))
    write_recognizer(os.path.join(tmp, "ocr_engine"), rec)
    ini = os.path.join(tmp, "config.ini")
    with open(os.path.join(REPO, "configs", "config1_printed_greedy.ini"), encoding="utf-8") as f:
        text = f.read()
    with open(ini, "w", encoding="utf-8") as f:
        f.write(text)
    return ini, images


def layout_xml(xml: str) -> str:
    """Page XML without its transcriptions and timestamps: the layout."""
    return mask_pagexml(TEXT_EQUIV.sub("", xml))


def rows_found(layout, rows, tol_px: float = 16.0) -> float:
    """Share of a printed page's text rows that a detected baseline
    lies within ``tol_px`` of."""
    ys = [float(np.mean(np.asarray(ln.baseline)[:, 1])) for ln in layout.lines_iterator()]
    return float(np.mean([any(abs(y - r) <= tol_px for y in ys) for r in rows]))


def run_config1(rng, smi: str):
    """Config 1 on the card: CONFIG1_PAGES synthetic printed A4 pages at
    300 dpi (A4_ROWS rows of glyph outlines) through
    ``PageParser(config 1, device="cuda").process_page`` into Page XML,
    the recognizer at the bench widths with random weights, loaded from
    flax msgpack.  Checks: every row found and every page of 4 lines or
    more, one warp_fields launch a page; the layout part of each Page XML
    equal to a CPU PageParser's layout stages on the same page (host
    code both); warp_fields bit-equal to its plain version on every
    page's own fields; the command line on CONFIG1_CLI_PAGES pages,
    whose files must equal the in-process run's.  Returns the field
    warp's launches, the phase's numbers and the last page's warp
    inputs."""
    pages, rows = printed_pages(rng, CONFIG1_PAGES, A4_H, A4_W, A4_ROWS)
    ids = [f"c{i:04d}" for i in range(len(pages))]
    with tempfile.TemporaryDirectory(prefix="config1_") as tmp:
        ini, images = write_config1_bundle(
            tmp, config1_recognizer(), dict(zip(ids[:CONFIG1_CLI_PAGES], pages)))
        parser = staged_parser(ini, "cuda")
        parser.process_page(pages[-1], PageLayout(id="warm", page_size=pages[-1].shape[:2]))
        timing.reset_timing()
        warp_ops.warp_fields.launches = warp_ops.warp_lines.launches = 0
        out, seconds = staged_pages(parser, ids, pages)
        launches, fused = warp_ops.warp_fields.launches, warp_ops.warp_lines.launches
        stats = timing.timing_stats()
        log("stage times (config 1 run):\n" + timing.timing_report())

        n_lines = [len(list(layout.lines_iterator())) for layout, _ in out]
        found = [rows_found(layout, r) for (layout, _), r in zip(out, rows)]
        log(f"config 1 (PageParser.process_page): {len(pages)} A4 pages ({A4_W}x{A4_H}), lines "
            f"a page {n_lines}, rows found {found}; {len(pages) / seconds:.3f} pages/s to Page "
            f"XML ({seconds:.3f} s) on {smi}; warp_fields launches {launches}, warp_lines {fused}")
        if min(found) < 1.0 or min(n_lines) < parser.line_cropper.DEVICE_BATCH_MIN:
            raise AssertionError(f"config 1: rows found {found}, lines {n_lines}")
        if launches != len(pages) or fused != 0:
            raise AssertionError(f"config 1: warp_fields launches {launches} != {len(pages)} pages")

        # The layout is host code: a CPU PageParser's layout stages give
        # the same regions and lines.
        cpu = staged_parser(ini, "cpu")
        for (layout, xml), pid, page in zip(out, ids, pages):
            ref = PageLayout(id=pid, page_size=page.shape[:2])
            for stage in cpu.layout_parsers:
                ref = stage.process_page(page, ref)
            if layout_xml(ref.to_pagexml_string()) != layout_xml(xml):
                raise AssertionError(f"config 1 page {pid}: the card's layout differs from "
                                     "the CPU's")
        log(f"config 1: the layout of all {len(pages)} pages equals a CPU run's layout stages")

        # The field warp on every page's own fields: bit-equal.
        max_abs = 0.0
        for (layout, _), page in zip(out, pages):
            args = page_buckets(parser, layout, page)
            max_abs = max(max_abs, packed_equal(*args, f"config 1 page {layout.id}"))
        last_page = page_buckets(parser, out[-1][0], pages[-1])

        # The command line on the first pages.
        out_dir = os.path.join(tmp, "page_xml")
        proc, cli_seconds = run_parse_folder(
            ["-c", ini, "-i", images, "--output-xml-path", out_dir, "--timing-report"],
            "config 1 command line")
        counted = re.search(r"^warp_fields kernel launches: (\d+)$", proc.stdout, re.M)
        timed = re.search(r"^cli/pages\s+([0-9.]+)\s+1\s", proc.stdout, re.M)
        differ = [layout.id for layout, xml in out[:CONFIG1_CLI_PAGES]
                  if not same_staged_page(read_text(out_dir, layout.id + ".xml"), xml)]
        log(f"config 1 command line vs in-process: {CONFIG1_CLI_PAGES - len(differ)} of "
            f"{CONFIG1_CLI_PAGES} files equal; its warp_fields launches "
            f"{counted.group(1) if counted else None}")
        if differ or counted is None or timed is None \
                or int(counted.group(1)) != CONFIG1_CLI_PAGES:
            raise AssertionError(f"config 1 command line: files differ {differ} or launches")

    numbers = {"pages": len(pages), "page_size": [A4_H, A4_W], "rows": A4_ROWS,
               "pages_per_s": len(pages) / seconds, "lines": sum(n_lines),
               "stage_ms": {k: 1e3 * stats[k][0] / stats[k][1] for k in CONFIG1_STAGES
                            if k in stats},
               "stage_calls": {k: stats[k][1] for k in CONFIG1_STAGES if k in stats},
               "warp_fields_launches": launches, "warp_fields_max_abs_err": max_abs,
               "cli_pages_per_s": CONFIG1_CLI_PAGES / float(timed.group(1)),
               "cli_wall_s": cli_seconds, "card": smi}
    return launches, numbers, last_page


# ----------------------------------------------------------------------
# REGION_SIMPLE_THRESHOLD: config 1 with classical regions in place of
# the whole page; and the staged command line's --process-count
SIMPLE_A4_PAGES, SIMPLE_COLUMN_PAGES = 4, 4
# Side margin of the A4 pages: the classical line detector keeps a line
# only where the region reaches past both sides of the page (it clips a
# baseline across the region's bounding box to its outline, as the JAX
# one does), so the text runs to within this many px of the sides.
SIMPLE_SIDE = 24
SIMPLE_STAGES = ("layout", "simple_regions/prepare", "simple_regions/denoise",
                 "simple_regions/threshold", "simple_regions/components",
                 "simple_regions/polygons", "line_crop", "ocr", "document/pagexml")
NL_CROP = (160, 160)  # the numpy twin's timed crop of the denoiser's input
PROCESS_COUNT = 2
PROCESS_COUNT_PAGES = 4  # 8 before the user scripts' phase needed the time


def write_simple_bundle(tmp: str, rec: CTCRecognizer) -> str:
    """Config 1's ini with ``[LAYOUT_PARSER_1] METHOD =
    REGION_SIMPLE_THRESHOLD`` and its recognizer (float32) under
    ocr_engine/.  Returns the ini's path."""
    os.makedirs(os.path.join(tmp, "ocr_engine"))
    write_recognizer(os.path.join(tmp, "ocr_engine"), rec, dtype="float32")
    with open(os.path.join(REPO, "configs", "config1_printed_greedy.ini"), encoding="utf-8") as f:
        text = f.read()
    if "METHOD = REGION_WHOLE_PAGE" not in text:
        raise AssertionError("config 1's ini has no REGION_WHOLE_PAGE stage to replace")
    ini = os.path.join(tmp, "config.ini")
    with open(ini, "w", encoding="utf-8") as f:
        f.write(text.replace("METHOD = REGION_WHOLE_PAGE", "METHOD = REGION_SIMPLE_THRESHOLD"))
    return ini


def run_simple_regions(rng, smi: str):
    """REGION_SIMPLE_THRESHOLD on the card: SIMPLE_A4_PAGES printed A4
    pages at 300 dpi (A4_ROWS rows, SIMPLE_SIDE px side margins) and
    SIMPLE_COLUMN_PAGES two-column 2560x1792 pages through
    ``PageParser(config 1 with the method, device="cuda")``: the regions
    (the NL-means in csrc/nlmeans.cpp), the classical line detector, the
    field warp and the bench recognizer in float32 (TF32 off) to Page
    XML.  Checks: two regions or more on each two-column page, ids r-0,
    r-1, ... in order; lines on every A4 page and one warp_fields launch
    a page of DEVICE_BATCH_MIN lines or more; the same pages through a
    CPU PageParser (the same host C++ denoiser) give the same layout
    byte for byte and the same line crops, and each text equal (conf
    within 0.0015) or apart only at near-ties; the field warp bit-equal
    to its plain version on every page's own fields; the C++ denoiser
    equal to its numpy twin on an NL_CROP crop of a page's input.
    Returns the field warp's launches, the phase's numbers and the last
    A4 page's warp inputs."""
    a4, _ = printed_pages(rng, SIMPLE_A4_PAGES, A4_H, A4_W, A4_ROWS, side=SIMPLE_SIDE)
    columns, _ = synthetic_pages(rng, SIMPLE_COLUMN_PAGES, TWO_COLUMNS)
    pages = a4 + columns
    ids = [f"r{i:04d}" for i in range(len(pages))]
    inputs = []
    nl_means = denoise.nl_means

    def kept_nl_means(img, h, threads=0):
        inputs.append((img, h))
        return nl_means(img, h, threads)

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    denoise.nl_means = kept_nl_means
    try:
        with tempfile.TemporaryDirectory(prefix="simple_regions_") as tmp:
            ini = write_simple_bundle(tmp, config1_recognizer())
            parser = staged_parser(ini, "cuda")
            parser.process_page(a4[-1], PageLayout(id="warm", page_size=a4[-1].shape[:2]))
            timing.reset_timing()
            warp_ops.warp_fields.launches = warp_ops.warp_lines.launches = 0
            denoise.calls.clear()
            inputs.clear()
            out, seconds = staged_pages(parser, ids, pages)
            launches, fused = warp_ops.warp_fields.launches, warp_ops.warp_lines.launches
            cpp_calls = denoise.calls["nl_means_u8"]
            stats = timing.timing_stats()
            log("stage times (REGION_SIMPLE_THRESHOLD run):\n" + timing.timing_report())
            cpu = staged_parser(ini, "cpu")
            cpu.layout_parsers[0].native = True  # the host C++ the card's run took
            t0 = time.perf_counter()
            cpu_out, _ = staged_pages(cpu, ids, pages)
            cpu_seconds = time.perf_counter() - t0
    finally:
        denoise.nl_means = nl_means
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    n_lines = [len(list(layout.lines_iterator())) for layout, _ in out]
    n_regions = [len(layout.regions) for layout, _ in out]
    batched = sum(n >= parser.line_cropper.DEVICE_BATCH_MIN for n in n_lines)
    log(f"REGION_SIMPLE_THRESHOLD (PageParser.process_page): {len(a4)} A4 pages ({A4_W}x{A4_H}, "
        f"side margins {SIMPLE_SIDE} px) and {len(columns)} two-column pages; regions a page "
        f"{n_regions}, lines a page {n_lines}; {len(pages) / seconds:.3f} pages/s to Page XML "
        f"({seconds:.3f} s) on {smi}; warp_fields launches {launches} (pages of "
        f"{parser.line_cropper.DEVICE_BATCH_MIN} lines or more: {batched}), warp_lines {fused}; "
        f"NL-means C++ calls {cpp_calls}")
    for i, layout in enumerate(layout for layout, _ in out):
        if [r.id for r in layout.regions] != [f"r-{k}" for k in range(len(layout.regions))]:
            raise AssertionError(f"simple regions: page {i}'s region ids are out of order")
    if min(n_lines[:len(a4)]) == 0 or min(n_regions[len(a4):]) < 2:
        raise AssertionError(f"simple regions: lines {n_lines}, regions {n_regions}")
    if launches != batched or launches == 0 or fused != 0 or cpp_calls != len(pages):
        raise AssertionError(f"simple regions: warp_fields launches {launches} != {batched} "
                             f"pages, or NL-means calls {cpp_calls} != {len(pages)}")

    # The layout is host code: the CPU's is the same to the byte, the
    # crops too; the texts equal or near-ties of float32 rounding.
    no_text = re.compile(r"\s*<TextEquiv[^>]*>.*?</TextEquiv>", re.S)
    n_compared = n_equal = n_ties = 0
    conf_err = 0.0
    for (layout, xml), (cpu_layout, cpu_xml) in zip(out, cpu_out):
        if mask_pagexml(no_text.sub("", xml)) != mask_pagexml(no_text.sub("", cpu_xml)):
            raise AssertionError(f"simple regions: page {layout.id}'s layout differs from the "
                                 "CPU's")
        logits = {}
        for a, b in zip(layout.lines_iterator(), cpu_layout.lines_iterator()):
            if not np.array_equal(a.crop, b.crop):
                raise AssertionError(f"simple regions: line {a.id}'s crop differs")
            logits[a.id] = (a.logits, b.logits)
        for (line_id, text, conf), (_, cpu_text, cpu_conf) in zip(page_lines(xml),
                                                                   page_lines(cpu_xml)):
            n_compared += 1
            if text == cpu_text:
                n_equal += 1
                conf_err = max(conf_err, abs(conf - cpu_conf))
            elif sparse_near_tie(*logits[line_id]):
                n_ties += 1
                log(f"simple regions: line {line_id} reads {text!r} on the card, {cpu_text!r} "
                    "on the CPU: a near-tie")
            else:
                raise AssertionError(f"simple regions: line {line_id}'s text {text!r} differs "
                                     f"from the CPU's {cpu_text!r}")
    if conf_err > 0.0015:
        raise AssertionError(f"simple regions: confidences {conf_err} apart")

    max_abs = 0.0
    for (layout, _), page in zip(out, pages):
        if len(list(layout.lines_iterator())) >= parser.line_cropper.DEVICE_BATCH_MIN:
            max_abs = max(max_abs, packed_equal(*page_buckets(parser, layout, page),
                                                f"simple regions page {layout.id}"))
    last = max(i for i, n in enumerate(n_lines) if n >= parser.line_cropper.DEVICE_BATCH_MIN)
    last_page = page_buckets(parser, out[last][0], pages[last])

    # The denoiser: the C++ on a whole A4 page's input, and against its
    # numpy twin on a crop of it.
    img, strength = inputs[len(a4) - 1]
    crop = np.ascontiguousarray(img[:NL_CROP[0], :NL_CROP[1]])
    if not np.array_equal(denoise.nl_means(crop, strength), denoise.nl_means_plain(crop, strength)):
        raise AssertionError("NL-means: the C++ differs from its numpy twin")
    nl = {"page_input": list(img.shape), "cpp_ms_a_page": host_ms(
              lambda: denoise.nl_means(img, strength), 5),
          "crop": list(crop.shape),
          "cpp_ms_crop": host_ms(lambda: denoise.nl_means(crop, strength)),
          "plain_ms_crop": host_ms(lambda: denoise.nl_means_plain(crop, strength), 3),
          "threads": os.cpu_count()}
    log(f"simple regions vs the CPU: {len(pages)} pages' layouts and crops equal, texts equal on "
        f"{n_equal} of {n_compared} lines, {n_ties} near-ties, confidences within "
        f"{conf_err:.3g} (CPU run {cpu_seconds:.1f} s); warp_fields max abs err {max_abs}; "
        f"NL-means {json.dumps(nl)} (host, on {smi})")
    numbers = {"pages": len(pages), "a4_pages": len(a4), "column_pages": len(columns),
               "pages_per_s": len(pages) / seconds, "regions": n_regions, "lines": n_lines,
               "stage_ms": {k: 1e3 * stats[k][0] / stats[k][1] for k in SIMPLE_STAGES
                            if k in stats},
               "stage_calls": {k: stats[k][1] for k in SIMPLE_STAGES if k in stats},
               "cpu_lines_compared": n_compared, "cpu_texts_equal": n_equal,
               "cpu_near_ties": n_ties, "cpu_conf_max_diff": conf_err,
               "warp_fields_launches": launches, "warp_fields_max_abs_err": max_abs,
               "nl_means": nl, "card": smi}
    return launches, numbers, last_page


def run_process_count(pipe: TorchPagePipeline, rng, smi: str) -> dict:
    """``--process-count``: 4 two-column pages as gray JPEG files through
    the staged command line (config 2, the bench modules from flax
    msgpack) in one process, then with PROCESS_COUNT spawned workers on
    the same card.  Each page's Page XML of the workers' run must equal
    the one-process run's (same_staged_page: two processes draw their
    own row jitter), no page may fail, and the workers' warp_fields
    launches (summed into the report) must equal the one-process run's.
    Returns pages/s of both by their cli/pages timers, and wall s."""
    pages, _ = synthetic_pages(rng, PROCESS_COUNT_PAGES, TWO_COLUMNS)
    ids = [f"p{i:04d}" for i in range(len(pages))]
    runs = {}
    with tempfile.TemporaryDirectory(prefix="process_count_") as tmp:
        ini, images = write_bundle(tmp, pipe.parsenet, pipe.recognizer, dict(zip(ids, pages)),
                                   jpeg="gray")
        for count in (1, PROCESS_COUNT):
            out_dir = os.path.join(tmp, f"xml_{count}")
            proc, wall = run_parse_folder(
                ["-c", ini, "-i", images, "--output-xml-path", out_dir, "--timing-report",
                 "--process-count", str(count)], f"command line, --process-count {count}")
            timed = timer_row(proc.stdout, "cli/pages")
            counted = re.search(r"^warp_fields kernel launches: (\d+)$", proc.stdout, re.M)
            done = len(re.findall(r"^DONE \d+/", proc.stdout, re.M))
            if timed is None or counted is None or done != len(ids):
                raise AssertionError(f"--process-count {count}: {done} pages done, or its "
                                     "timing report lacks a row")
            runs[count] = {"xml": {pid: read_text(out_dir, pid + ".xml") for pid in ids},
                           "pages_per_s": len(ids) / timed[0], "wall_s": wall,
                           "launches": int(counted.group(1))}
    differ = [pid for pid in ids if not same_staged_page(runs[PROCESS_COUNT]["xml"][pid],
                                                         runs[1]["xml"][pid])]
    one, many = runs[1], runs[PROCESS_COUNT]
    log(f"--process-count {PROCESS_COUNT} vs 1: {len(ids) - len(differ)} of {len(ids)} pages' "
        f"Page XML equal; {many['pages_per_s']:.3f} against {one['pages_per_s']:.3f} pages/s by "
        f"cli/pages (wall {many['wall_s']:.1f} / {one['wall_s']:.1f} s), warp_fields launches "
        f"{many['launches']} / {one['launches']}, on {smi}")
    if differ or many["launches"] != one["launches"] or one["launches"] == 0:
        raise AssertionError(f"--process-count {PROCESS_COUNT}: pages differ {differ}, or "
                             "launches")
    return {"pages": len(ids), "process_count": PROCESS_COUNT,
            "pages_per_s": many["pages_per_s"], "pages_per_s_one_process": one["pages_per_s"],
            "wall_s": many["wall_s"], "wall_s_one_process": one["wall_s"],
            "warp_fields_launches": many["launches"], "page_format": "jpeg gray q90",
            "card": smi}


def run_parse_folder(args, label: str, program=None):
    """The port's command line in a subprocess from the repository root
    (``python -m``, or ``python -c program`` where given); raises when it
    fails.  Returns (the completed process, wall s)."""
    command = [sys.executable, *(("-c", program) if program else
                                 ("-m", "pero_ocr_tpu_torch.scripts.parse_folder")), *args]
    t0 = time.perf_counter()
    proc = subprocess.run(command, cwd=REPO, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    log(f"{label}: exit {proc.returncode} in {seconds:.3f} s\n{proc.stdout.strip()[-3000:]}\n"
        f"{proc.stderr.strip()[-3000:]}")
    if proc.returncode != 0 or "ERROR" in proc.stdout:
        raise AssertionError(f"{label} failed ({proc.returncode})")
    return proc, seconds


def read_text(folder: str, name: str) -> str:
    with open(os.path.join(folder, name), encoding="utf-8") as f:
        return f.read()


# ----------------------------------------------------------------------
# Config 5's outputs: top-k logits, logits files, forced alignment, ALTO
# 16 pages on the fast path (two stage-B batches with the logits) and 4
# through its command line (one page batch; 8 before the user scripts'
# phase needed the time).
CONFIG5_PAGES = 2 * PAGE_BATCH
CONFIG5_CLI_FAST, CONFIG5_STAGED_PAGES = 4, 4  # the staged command line runs as many
ALTO_DATETIME = re.compile(r"<processingDateTime>[^<]*</processingDateTime>")
ALTO_NS = "{http://www.loc.gov/standards/alto/ns-v2#}"
# A logits file of the command line against the in-process run's: the
# same lines, charsets and coordinates; values present in both within
# one bfloat16 step of the logit (LOGITS_REL), and the kept classes the
# same in all but LOGITS_PATTERN_SHARE of the frames (the two processes
# may batch lines in another order and pick other cuDNN algorithms).
# Its ALTO file must equal what the writer here makes of its logits.
LOGITS_REL, LOGITS_PATTERN_SHARE = 2.0 ** -7, 0.01


def outputs_of(layout):
    """A page's three outputs as the command line on the card writes
    them: Page XML, the logits pickle's bytes and ALTO (C++ alignment)."""
    with timing.stage_timer("document/pagexml"):
        xml = layout.to_pagexml_string()
    with timing.stage_timer("document/logits"):
        logits = layout.save_logits_bytes()
    with timing.stage_timer("document/alto"):
        alto = layout.to_altoxml_string(native=True)
    return xml, logits, alto


def topk_check(pipe: TorchPagePipeline, b_args) -> dict:
    """Stage B once on ``b_args`` with the recognizer's logits kept: the
    card's top-k values and indices against ``torch.topk`` of the same
    logits on the CPU.  Values (float16) must be equal frame by frame as
    sorted lists; index sets equal wherever the k-th logit is larger
    than the (k+1)-th (on a tie at the boundary either class is a top-k
    class, and each index must still point at its value)."""
    rec = pipe.recognizer
    kept = []

    def keeping(images):
        kept.append(rec(images))
        return kept[-1]

    keeping.spec = rec.spec
    pipe.recognizer = keeping
    try:
        *_, vals, idx = pipe.stage_b(*b_args)
    finally:
        pipe.recognizer = rec
    logits = kept[0].float().cpu()
    k = vals.shape[-1]
    vals, idx = vals.cpu().reshape(logits.shape[0], logits.shape[1], k), idx.cpu().long()
    idx = idx.reshape(vals.shape)
    ref_vals, ref_idx = torch.topk(logits, k + 1, dim=-1)
    if not torch.equal(vals.float().sort(dim=-1, descending=True).values,
                       ref_vals[..., :k].half().float()):
        raise AssertionError("top-k: the card's values differ from torch.topk on the CPU")
    if not torch.equal(torch.gather(logits, -1, idx).half(), vals):
        raise AssertionError("top-k: an index does not point at its value")
    clear = ref_vals[..., k - 1] > ref_vals[..., k]
    same = (idx.sort(dim=-1).values == ref_idx[..., :k].sort(dim=-1).values).all(dim=-1)
    bad = int((clear & ~same).sum())
    frames = int(clear.numel())
    log(f"top-k (k={k}) on the card vs torch.topk on the CPU: {frames} frames, values equal; "
        f"index sets equal on all {int(clear.sum())} frames without a tie at the k-th logit "
        f"({bad} differ); {frames - int(clear.sum())} frames tie there")
    if bad:
        raise AssertionError(f"top-k: {bad} frames select other classes than torch.topk")
    return {"frames": frames, "boundary_ties": frames - int(clear.sum()), "k": k}


def baseline_ids(xml: str) -> dict:
    """A Page XML's line ids by their baselines' points."""
    root = ET.fromstring(xml.encode("utf-8"))
    return {line.find(f"{PAGE_NS}Baseline").get("points"): line.get("id")
            for line in root.iter(f"{PAGE_NS}TextLine")}


def same_lines(cli_xml: str, own_xml: str, label: str) -> dict:
    """The command line's line ids -> the in-process run's, matched by
    baseline: stage by stage, lines that share a row take their numbers
    from ``random``, which each process draws anew."""
    cli, own = baseline_ids(cli_xml), baseline_ids(own_xml)
    if sorted(cli) != sorted(own):
        raise AssertionError(f"{label}: the command line found other lines")
    return {cli[points]: own[points] for points in cli}


def logits_close(blob: bytes, layout, rename=None) -> dict:
    """A command-line logits file against the in-process layout's lines
    (see LOGITS_REL), its line ids mapped by ``rename`` where given: the
    file's numbers; raises when they differ."""
    got = pickle.loads(blob)
    if rename is not None:
        got = {"line_characters": {rename[k]: v for k, v in got["line_characters"].items()},
               "logit_coords": {rename[k]: v for k, v in got["logit_coords"].items()},
               **{rename[k]: v for k, v in got.items()
                  if k not in ("line_characters", "logit_coords")}}
    lines = {ln.id: ln for ln in layout.lines_iterator()}
    if sorted(k for k in got if k not in ("line_characters", "logit_coords")) != sorted(lines):
        raise AssertionError(f"logits {layout.id}: other line ids")
    frames = pattern = exact = 0
    worst = 0.0
    for key, line in lines.items():
        a, b = got[key].toarray(), line.logits.toarray()
        if (got["line_characters"][key] != line.characters
                or list(got["logit_coords"][key]) != list(line.logit_coords) or a.shape != b.shape):
            raise AssertionError(f"logits {layout.id} {key}: charset, coordinates or shape")
        both = (a != 0) & (b != 0)
        frames += a.shape[0]
        pattern += int(((a != 0) != (b != 0)).any(axis=1).sum())
        exact += int(np.array_equal(a, b))
        rel = np.abs(a - b)[both] / np.maximum(np.abs(b[both]), 1.0)
        worst = max(worst, float(rel.max(initial=0.0)))
    if worst > LOGITS_REL or pattern > LOGITS_PATTERN_SHARE * frames:
        raise AssertionError(f"logits {layout.id}: values {worst} apart, {pattern} frames keep "
                             "other classes")
    return {"lines": len(lines), "lines_equal": exact, "frames": frames,
            "frames_other_classes": pattern, "max_rel": worst}


def alto_words(xml: str):
    """An ALTO file's words, (CONTENT, HPOS, VPOS, WIDTH, HEIGHT), in
    lines ordered by their position within each block."""
    root = ET.fromstring(xml.encode("utf-8"))
    out = []
    for block in root.iter(ALTO_NS + "TextBlock"):
        lines = sorted(block.iter(ALTO_NS + "TextLine"), key=lambda e: tuple(
            int(e.get(k)) for k in ("VPOS", "HPOS", "BASELINE")))
        out += [[(s.get("CONTENT"), *(int(s.get(k)) for k in ("HPOS", "VPOS", "WIDTH", "HEIGHT")))
                 for s in line.iter(ALTO_NS + "String")] for line in lines]
    return out


def alto_same(cli: str, own: str, label: str) -> bool:
    """The command line's ALTO file against the in-process writer's on
    the same logits: equal apart from the processing time (True), or
    equal lines taken in position order within each block (False:
    stage by stage, lines that share a row take their order from
    ``random``); raises otherwise."""
    if ALTO_DATETIME.sub("", cli) == ALTO_DATETIME.sub("", own):
        return True
    if alto_words(cli) != alto_words(own):
        raise AssertionError(f"ALTO {label}: the command line's words or boxes differ")
    return False


def load_logits_renamed(layout, blob: bytes, rename: dict) -> None:
    """A command-line logits file's logits onto the in-process layout's
    lines, its line ids mapped by ``rename``."""
    got = pickle.loads(blob)
    by_own = {own: key for key, own in rename.items()}
    for line in layout.lines_iterator():
        key = by_own[line.id]
        line.logits = got[key]
        line.characters = got["line_characters"][key]
        line.logit_coords = got["logit_coords"][key]


class ViterbiInputs:
    """Keeps the arguments of every ``native_viterbi_ctc`` call (the
    forced alignment's gathered costs and skip masks)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._fn = native.native_viterbi_ctc

        def kept(costs, skip):
            self.calls.append((np.array(costs, np.float32), np.array(skip, bool)))
            return self._fn(costs, skip)

        native.native_viterbi_ctc = kept
        return self

    def __exit__(self, *exc):
        native.native_viterbi_ctc = self._fn
        return False


def run_config5(pipe: TorchPagePipeline, rng, smi: str):
    """Config 5's outputs on the card, on both paths, with the bench
    modules (config 2's pages, detector and recognizer; the outputs are
    what config 5 adds):

    - the page transport with ``want_logits`` (stage B's top-k download)
      through FastPagePipeline to Page XML, the logits pickle and ALTO
      (the forced alignment in the port's C++), against the same pages
      without logits: A B B A, pages/s of each; top-k held against
      ``torch.topk`` on the CPU on the last batch's logits;
    - stage by stage (PageParser) with and without the outputs;
    - the command line with --output-logit-path and --output-alto-path
      on both paths: every logits file loaded back against the
      in-process layout's lines, every ALTO file against the in-process
      writer's.

    Returns the kernels' launches on each path, the phase's numbers, the
    last batch's warp arguments, the forced alignment's inputs (for
    check_host_native) and the staged run's pages with their Page XML and
    ALTO (id -> (page, xml, alto), for run_user_scripts)."""
    n_pages = CONFIG5_PAGES
    pages, _ = synthetic_pages(rng, n_pages, TWO_COLUMNS)
    ids = [f"a{i:04d}" for i in range(n_pages)]
    common = dict(downsample=4, crop_bucket=BUCKET, crop_height=CROP_H,
                  line_slot=LINES_PER_PAGE, adaptive_downsample=True, device="cuda")
    plain = FastPagePipeline(TorchPagePipeline(pipe.parsenet, pipe.recognizer, **common),
                             BENCH_CHARS, page_batch=PAGE_BATCH)
    logits_pipe = TorchPagePipeline(pipe.parsenet, pipe.recognizer, want_logits=True, **common)
    with_logits = FastPagePipeline(logits_pipe, BENCH_CHARS, page_batch=PAGE_BATCH)
    last_b = []
    stage_b = logits_pipe.stage_b

    def kept_stage_b(*b_args):
        last_b[:] = [b_args]
        return stage_b(*b_args)

    logits_pipe.stage_b = kept_stage_b

    def drive(fast, outputs: bool):
        out = []
        t0 = time.perf_counter()
        for layout in fast.process_pages(pages, ids):
            out.append((layout, *(outputs_of(layout) if outputs else
                                  (layout.to_pagexml_string(), None, None))))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    drive(plain, False)  # warm-up: the adaptive scale, cuDNN plans
    drive(with_logits, True)
    runs, launches = [], None
    for name, fast, outputs in (("page xml", plain, False), ("outputs", with_logits, True),
                                ("outputs", with_logits, True), ("page xml", plain, False)):
        timing.reset_timing()
        warp_ops.warp_lines.launches = warp_ops.warp_fields.launches = 0
        native.calls.clear()
        out, seconds = drive(fast, outputs)
        if outputs and launches is None:
            launches, host_calls = warp_ops.warp_lines.launches, dict(native.calls)
            fast_out, stats, report = out, timing.timing_stats(), timing.timing_report()
            if warp_ops.warp_fields.launches:
                raise AssertionError("config 5 fast path launched warp_fields")
        runs.append({"run": name, "pages_per_s": n_pages / seconds, "seconds": seconds})
        log(f"config 5 fast path ({name}): {n_pages} pages, {n_pages / seconds:.3f} pages/s on "
            f"{smi}")
    logits_pipe.stage_b = stage_b
    batches = len({i // PAGE_BATCH for i, (layout, *_) in enumerate(fast_out)
                   if any(True for _ in layout.lines_iterator())})
    n_lines = sum(len(list(layout.lines_iterator())) for layout, *_ in fast_out)
    log("stage times (config 5 fast path, first run with outputs):\n" + report)
    log(f"config 5 fast path: warp_lines launches {launches}, stage-B batches {batches}, "
        f"{n_lines} lines; host calls {host_calls}")
    if launches != batches or launches == 0 or host_calls.get("viterbi_ctc_f32", 0) == 0:
        raise AssertionError("config 5: warp_lines launches != stage-B batches, or no C++ "
                             "forced alignment")
    for layout, xml, blob, alto in fast_out:
        if any(ln.logits is None for ln in layout.lines_iterator() if ln.transcription):
            raise AssertionError(f"config 5: a line of {layout.id} has no logits")
        logits_close(blob, layout)  # the pickle round trip
        ET.fromstring(alto.encode("utf-8"))
    topk = topk_check(logits_pipe, last_b[0])

    # Stage by stage, with and without the outputs.
    with tempfile.TemporaryDirectory(prefix="config5_") as tmp:
        ini, images = write_bundle(tmp, pipe.parsenet, pipe.recognizer,
                                   dict(zip(ids[:CONFIG5_CLI_FAST], pages)))
        parser = staged_parser(ini, "cuda")
        parser.process_page(pages[0], PageLayout(id="warm", page_size=pages[0].shape[:2]))
        staged_runs = []
        for outputs in (False, True, True, False):
            wrapper = parser.layout_parsers[0].engine.parsenet
            wrapper.last_downsample = wrapper.init_downsample
            timing.reset_timing()
            warp_ops.warp_fields.launches = warp_ops.warp_lines.launches = 0
            random.seed(0)
            t0 = time.perf_counter()
            out = []
            for pid, page in zip(ids[:CONFIG5_STAGED_PAGES], pages):
                layout = parser.process_page(page, PageLayout(id=pid, page_size=page.shape[:2]))
                out.append((layout, *(outputs_of(layout) if outputs else
                                      (layout.to_pagexml_string(), None, None))))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if outputs and not any(r["outputs"] for r in staged_runs):
                staged_out, staged_launches = out, warp_ops.warp_fields.launches
                staged_stats = timing.timing_stats()
                log("stage times (config 5 stage by stage, first run with outputs):\n"
                    + timing.timing_report())
            staged_runs.append({"outputs": outputs, "seconds": seconds,
                                "pages_per_s": CONFIG5_STAGED_PAGES / seconds})
            log(f"config 5 stage by stage ({'outputs' if outputs else 'page xml'}): "
                f"{CONFIG5_STAGED_PAGES} pages, {CONFIG5_STAGED_PAGES / seconds:.3f} pages/s")
        batched = sum(len(list(layout.lines_iterator())) >= parser.line_cropper.DEVICE_BATCH_MIN
                      for layout, *_ in staged_out)
        if staged_launches != batched or staged_launches == 0:
            raise AssertionError("config 5 staged: warp_fields launches != pages of 4 lines+")

        # The forced alignment's inputs, on the runs' own lines (three
        # pages: the numpy twin takes ms a line in check_host_native).
        with ViterbiInputs() as viterbi:
            for layout, *_ in fast_out[-2:] + staged_out[:1]:
                layout.to_altoxml_string(native=True)

        # The command line on both paths, with the outputs.
        files = {}
        for path, flags, n in (("fast", ["--fast-pipeline"], CONFIG5_CLI_FAST),
                               ("staged", [], CONFIG5_STAGED_PAGES)):
            folder = os.path.join(tmp, path)
            sub_images = os.path.join(folder, "images")
            os.makedirs(sub_images)
            for pid in ids[:n]:
                shutil.copyfile(os.path.join(images, pid + ".png"),
                                os.path.join(sub_images, pid + ".png"))
            proc, wall = run_parse_folder(
                ["-c", ini, "-i", sub_images, "--output-xml-path", os.path.join(folder, "xml"),
                 "--output-logit-path", os.path.join(folder, "logits"), "--output-alto-path",
                 os.path.join(folder, "alto"), "--timing-report", *flags],
                f"config 5 command line ({path})")
            timed = re.search(r"^cli/pages\s+([0-9.]+)\s+1\s", proc.stdout, re.M)
            files[path] = {"wall_s": wall, "pages_per_s": n / float(timed.group(1)),
                           "logits": {}, "alto": {}, "xml": {}}
            for pid in ids[:n]:
                with open(os.path.join(folder, "logits", pid + ".logits"), "rb") as f:
                    files[path]["logits"][pid] = f.read()
                files[path]["alto"][pid] = read_text(os.path.join(folder, "alto"), pid + ".xml")
                files[path]["xml"][pid] = read_text(os.path.join(folder, "xml"), pid + ".xml")

    # The in-process layouts with the command line's settings: the fast
    # path's (page batch 4, line slot 32, crop bucket 2048) anew, the
    # staged run's as they are.
    same = TorchPagePipeline(
        pipe.parsenet, pipe.recognizer, downsample=4, crop_height=CROP_H,
        crop_bucket=FastPagePipeline.CROP_BUCKET, line_slot=FastPagePipeline.LINE_SLOT,
        transport_bits=4, adaptive_downsample=True, want_logits=True, device="cuda")
    fast_own = FastPagePipeline(same, BENCH_CHARS, page_batch=CLI_PAGE_BATCH)
    own = {"fast": [(layout, layout.to_pagexml_string()) for layout in fast_own.process_pages(
               pages[:CONFIG5_CLI_FAST], ids[:CONFIG5_CLI_FAST])],
           "staged": [(layout, xml) for layout, xml, *_ in staged_out]}
    cli = {}
    for path, layouts in own.items():
        checked, alto_equal = [], 0
        for layout, xml in layouts:
            cli_xml, blob = files[path]["xml"][layout.id], files[path]["logits"][layout.id]
            if not (same_staged_page(cli_xml, xml) if path == "staged"
                    else mask_pagexml(cli_xml) == mask_pagexml(xml)):
                raise AssertionError(f"config 5 command line ({path}): Page XML of {layout.id}")
            rename = same_lines(cli_xml, xml, layout.id)
            checked.append(logits_close(blob, layout, rename))
            # The ALTO writer on the command line's own logits, here.
            load_logits_renamed(layout, blob, rename)
            alto_equal += alto_same(files[path]["alto"][layout.id],
                                    layout.to_altoxml_string(native=True), layout.id)
        cli[path] = {"pages": len(layouts), "pages_per_s": files[path]["pages_per_s"],
                     "wall_s": files[path]["wall_s"], "alto_files_equal": alto_equal,
                     "logits_lines": sum(c["lines"] for c in checked),
                     "logits_lines_equal": sum(c["lines_equal"] for c in checked),
                     "logits_frames_other_classes": sum(c["frames_other_classes"]
                                                        for c in checked),
                     "logits_max_rel": max(c["max_rel"] for c in checked)}
        log(f"config 5 command line ({path}) vs in-process: {cli[path]}")

    numbers = {"pages": n_pages, "lines": n_lines, "fast_runs": runs, "staged_runs": staged_runs,
               "fast_stage_ms": {k: 1e3 * v[0] / v[1] for k, v in stats.items()
                                 if k.startswith("document/")},
               "staged_stage_ms": {k: 1e3 * v[0] / v[1] for k, v in staged_stats.items()
                                   if k in STAGED_HOST_STAGES or k.startswith("document/")},
               "warp_lines_launches": launches, "warp_fields_launches": staged_launches,
               "host_calls": host_calls, "topk": topk, "cli": cli, "card": smi}
    staged_files = {layout.id: (page, xml, alto)
                    for page, (layout, xml, _, alto) in zip(pages, staged_out)}
    return {"warp_lines": launches, "warp_fields": staged_launches}, numbers, (
        *last_b[0], logits_pipe.crop_height, logits_pipe.crop_bucket), viterbi.calls, staged_files


# ----------------------------------------------------------------------
# The user scripts of item 18 on the card's outputs: select_embed_id
# (the field warp on a new entry point), produce_2layer_pdf on config 5's
# files, compare_page_xml_texts and the batched edit distance
SCRIPT_PAGES = 2  # config 2's staged pages (and Page XML) that select_embed_id reads
EMBED_NUM, EMBED_LINES, EMBED_CLUSTERS = 16, 64, 4
LATIN_FONT = os.path.join(REPO, "tests", "data", "pdf", "DejaVuSans-Latin.ttf")
# select_embed_id's config: CLI_INI's line cropper and OCR, no layout.
EMBED_INI = """[PAGE_PARSER]
RUN_LINE_CROPPER = yes
RUN_OCR = yes

[LINE_CROPPER]
INTERP = 2
LINE_SCALE = 1.0
LINE_HEIGHT = 32

[OCR]
OCR_JSON = ./ocr.json
"""
CER_LINE = re.compile(r"^(\d+) (?:[0-9.]+|N/A) % CER \[ (\d+) / (\d+) \] Time: ([0-9.]+)$", re.M)


def write_embed_bundle(folder: str, rec: CTCRecognizer, pages: dict) -> None:
    """An OCR-only ini (the line cropper and the recognizer), ``rec`` as a
    float32 flax checkpoint with an OCR JSON of ``embed_num`` writers,
    and ``pages`` (id -> (JPEG bytes, Page XML)) under images/ and xml/."""
    os.makedirs(os.path.join(folder, "images"))
    os.makedirs(os.path.join(folder, "xml"))
    write_recognizer(folder, copy.deepcopy(rec), dtype="float32")
    with open(os.path.join(folder, "ocr.json"), encoding="utf-8") as f:
        ocr = json.load(f)
    ocr["embed_num"] = rec.spec.embed_num
    ocr["net_spec"]["embed_dim"] = rec.spec.embed_dim
    with open(os.path.join(folder, "ocr.json"), "w", encoding="utf-8") as f:
        json.dump(ocr, f)
    with open(os.path.join(folder, "config.ini"), "w", encoding="utf-8") as f:
        f.write(EMBED_INI)
    for pid, (jpeg, xml) in pages.items():
        with open(os.path.join(folder, "images", pid + ".jpg"), "wb") as f:
            f.write(jpeg)
        with open(os.path.join(folder, "xml", pid + ".xml"), "w", encoding="utf-8") as f:
            f.write(xml)


def run_script(main, args) -> tuple:
    """A script's ``main(args)`` in this process, numpy's global generator
    seeded with 0 first, strict checkpoint loading restored after:
    (stdout, wall seconds)."""
    strict = checkpoint.strict_loading_enabled()
    out = io.StringIO()
    np.random.seed(0)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            main(args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        checkpoint.set_strict_loading(strict)
    return out.getvalue(), time.perf_counter() - t0


def embed_runs(stdout: str) -> dict:
    """select_embed_id's printed ids, CER counts a representative (id ->
    (distance, characters)), recognition seconds a representative and
    the selected id."""
    ids = re.search(r"^REPRESENTATIVE EMBEDDING IDS: ([0-9,]+)$", stdout, re.M).group(1)
    rows = CER_LINE.findall(stdout)
    return {"ids": [int(x) for x in ids.split(",")],
            "cer": {int(i): (int(d), int(n)) for i, d, n, _ in rows},
            "seconds": {int(i): float(t) for i, _, _, t in rows},
            "selected": int(re.search(r"^SELECTED EMBED ID WITH MIN CER: (\d+)$", stdout,
                                      re.M).group(1))}


def embed_near_ties(runs: dict, differing: dict) -> int:
    """Of the lines whose texts differ between the card and the CPU
    (embed id -> line numbers): how many are near-ties (``near_ties``)
    in the padded batch the card's engine put the line in (cuDNN picks
    its algorithms by batch shape, so a line alone rounds otherwise),
    through each run's recognizer with the id applied.  ``runs``: role
    -> (engine, crops), as each select_embed_id run kept them.  Raises
    on a line that is not a near-tie."""
    if not differing:
        return 0
    (card, crops), (cpu, _) = runs["card"], runs["cpu"]
    batches = []

    def kept_batch(batch, widths):
        batches.append(batch)
        return type(card).run_ocr(card, batch, widths)

    card.run_ocr = kept_batch  # the engine's batches, as the script's run made them
    try:
        card.process_lines(crops, no_logits=True)
    finally:
        del card.run_ocr
    pad, ties = card.line_padding_px, 0
    for embed_id, lines in differing.items():
        judged = {}  # batch index -> near_ties of its rows under this id
        for i in lines:
            crop, rows = crops[i], []
            for b, batch in enumerate(batches):  # the line's batch and row
                w = min(crop.shape[1], batch.shape[2] - 2 * pad)
                if batch.shape[2] == card._bucket_for_width(crop.shape[1]):
                    rows += [(b, row) for row in np.flatnonzero(
                        (batch[:, :, pad: pad + w] == crop[:, :w]).all(axis=(1, 2, 3)))]
            b, row = rows[0]
            if b not in judged:
                images = torch.from_numpy(batches[b]).float() / torch.tensor(255.0)
                ids = torch.full((len(images),), embed_id)

                def on(engine, device):
                    return lambda x: engine.model(x.to(device), ids.to(device))

                judged[b] = near_ties(on(card, "cuda"), on(cpu, "cpu"), images)
            if not judged[b][row]:
                raise AssertionError(f"select_embed_id: embed id {embed_id}, line {i} differs "
                                     "between the card and the CPU beyond a near-tie")
            ties += 1
    return ties


def select_embed_id_on_card(tmp: str, pages: dict, smi: str):
    """select_embed_id --n-lines 64 --n-clusters 4 (the KMeans route) on
    config 2's staged pages with a bench-width float32 recognizer of 16
    writer embeddings (seeded), with --device cuda and --device cpu, TF32
    off: the same representative ids, CER counts (lines apart only at
    near-ties) and selected id (apart only if near-tie lines moved the
    counts).  Returns (warp_fields launches of the card run, numbers,
    the card run's (GT, text) pairs)."""
    rec = CTCRecognizer(RecognizerSpec(
        num_classes=80, line_height=CROP_H, conv_features=(48, 96, 192, 384), subsampling=4,
        lstm_layers=2, lstm_features=256, stem="s2d", norm="group", embed_num=EMBED_NUM,
        dtype=torch.float32), generator=torch.Generator().manual_seed(18))
    folders = {role: os.path.join(tmp, f"embed_{role}") for role in ("card", "cpu")}
    for folder in folders.values():
        write_embed_bundle(folder, rec, pages)
    # The pages the crops come from: each of 4 lines or more is one launch.
    expected, lines = 0, 0
    for pid in sorted(pages):
        if lines >= EMBED_LINES:
            break
        expected += 1
        layout = PageLayout()
        layout.from_pagexml_string(pages[pid][1])
        lines += sum(1 for ln in layout.lines_iterator() if ln.transcription)
    runs, seconds, launches, kept = {}, {}, {}, {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    crops_from = select_embed_id.crops_from_images_and_xmls
    try:
        for role, folder in folders.items():
            device = "cuda" if role == "card" else "cpu"

            def kept_crops(parser, *args):  # each run's engine and crops, for the near-ties
                crops, gts = crops_from(parser, *args)
                kept[role] = parser.ocr.ocr_engine, crops
                return crops, gts

            select_embed_id.crops_from_images_and_xmls = kept_crops
            warp_ops.warp_fields.launches = 0
            stdout, seconds[role] = run_script(select_embed_id.main, [
                "-c", os.path.join(folder, "config.ini"), "-i", os.path.join(folder, "images"),
                "-x", os.path.join(folder, "xml"), "--n-lines", str(EMBED_LINES), "--n-clusters",
                str(EMBED_CLUSTERS), "--out", os.path.join(folder, "out"), "--device", device])
            launches[role] = warp_ops.warp_fields.launches
            runs[role] = embed_runs(stdout)
            log(f"select_embed_id --device {device} ({seconds[role]:.2f} s):\n{stdout.strip()}")
        card, cpu = runs["card"], runs["cpu"]
        differing = {}
        for embed_id in card["ids"]:
            texts = {}
            for role, folder in folders.items():
                with open(os.path.join(folder, "out", f"{embed_id}.trans"),
                          encoding="utf-8") as f:
                    texts[role] = f.read().split("\n")
            lines_apart = [i for i, (a, b) in enumerate(zip(texts["card"], texts["cpu"]))
                           if a != b]
            if lines_apart:
                differing[embed_id] = lines_apart
        ties = embed_near_ties(kept, differing)
    finally:  # as the later phases expect them
        select_embed_id.crops_from_images_and_xmls = crops_from
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    if card["ids"] != cpu["ids"] or len(card["ids"]) != EMBED_CLUSTERS:
        raise AssertionError(f"select_embed_id: representative ids {card['ids']} on the card, "
                             f"{cpu['ids']} on the CPU")
    if not differing and card["cer"] != cpu["cer"]:
        raise AssertionError("select_embed_id: CER lines differ with the same texts")
    # The selected id may differ only where near-tie lines moved the CER
    # counts, and is each run's fewest differing characters (every id
    # reads the same lines; the first at a tie).
    for run in (card, cpu):
        if run["selected"] != run["ids"][int(np.argmin([run["cer"][i][0]
                                                         for i in run["ids"]]))]:
            raise AssertionError("select_embed_id: the selected id is not the lowest CER")
    if card["cer"] == cpu["cer"] and card["selected"] != cpu["selected"]:
        raise AssertionError("select_embed_id: the selected id differs with the same CER lines")
    if launches["card"] != expected or launches["cpu"]:
        raise AssertionError(f"select_embed_id: warp_fields launches {launches}, want "
                             f"{expected} on the card (one a page) and 0 on the CPU")
    with open(os.path.join(folders["card"], "out", f"{card['selected']}.gt"),
              encoding="utf-8") as f:
        gts = f.read().split("\n")[:-1]
    with open(os.path.join(folders["card"], "out", f"{card['selected']}.trans"),
              encoding="utf-8") as f:
        texts = f.read().split("\n")[:-1]
    n_lines = len(gts)
    numbers = {"ids": card["ids"], "cer": {str(k): list(v) for k, v in card["cer"].items()},
               "selected": card["selected"], "selected_cpu": cpu["selected"],
               "lines": n_lines, "pages": expected, "warp_fields_launches": launches["card"],
               "near_tie_lines": ties, "lines_apart": sum(len(v) for v in differing.values()),
               "ms_a_line": 1e3 * seconds["card"] / n_lines,
               "cpu_ms_a_line": 1e3 * seconds["cpu"] / n_lines,
               "recognize_ms_a_line_a_id": 1e3 * float(np.mean(list(card["seconds"].values())))
               / n_lines, "card": smi}
    log(f"select_embed_id on the card: ids {card['ids']}, selected {card['selected']} (CPU "
        f"{cpu['selected']}), {n_lines} lines from {expected} pages, warp_fields launches "
        f"{launches['card']}, lines apart {numbers['lines_apart']} (near-ties {ties}); "
        f"{numbers['ms_a_line']:.3f} ms a line on the card (the whole script), "
        f"{numbers['cpu_ms_a_line']:.3f} on the CPU, on {smi}")
    return launches["card"], numbers, list(zip(gts, texts))


def pdf_pages(data: bytes) -> list:
    """A PDF of the port's writer read back: every xref offset must start
    its object; per page (in /Kids order) the text layer decoded through
    the ToUnicode map (a string a Tj) and the image stream's bytes."""
    xref = int(data[data.rindex(b"startxref") + 10: data.rindex(b"%%EOF")])
    rows = data[xref:].split(b"\n")
    if rows[0] != b"xref":
        raise AssertionError("pdf: startxref does not point at the xref table")
    count = int(rows[1].split()[1])
    offsets = {i: int(r[:10]) for i, r in enumerate(rows[2: 2 + count]) if r.endswith(b" n ")}
    ends = sorted(offsets.values()) + [xref]
    objects = {}
    for number, offset in offsets.items():
        if not data.startswith(f"{number} 0 obj\n".encode(), offset):
            raise AssertionError(f"pdf: xref offset of object {number} does not resolve")
        objects[number] = data[offset: ends[ends.index(offset) + 1]]

    def stream(body: bytes) -> bytes:
        start = body.index(b"stream\n") + 7
        raw = body[start: body.rindex(b"\nendstream")]
        return zlib.decompress(raw) if b"/FlateDecode" in body[:start] else raw

    (pages_obj,) = [b for b in objects.values() if b"/Type /Pages " in b]
    kids = [int(k) for k in re.findall(rb"(\d+) 0 R", re.search(rb"/Kids \[([^\]]*)\]",
                                                                  pages_obj).group(1))]
    to_unicode = int(re.search(rb"/ToUnicode (\d+) 0 R", data).group(1))
    glyphs = {int(g, 16): chr(int(c, 16)) for g, c in re.findall(
        rb"<([0-9A-F]{4})> <([0-9A-F]{4})>", stream(objects[to_unicode]))}
    out = []
    for kid in kids:
        page = objects[kid]
        content = stream(objects[int(re.search(rb"/Contents (\d+) 0 R", page).group(1))])
        texts = ["".join(glyphs[int(h[i: i + 4], 16)] for i in range(0, len(h), 4))
                 for h in re.findall(rb"<([0-9A-F]*)> Tj", content)]
        image = stream(objects[int(re.search(rb"/Im0 (\d+) 0 R", page).group(1))])
        out.append((texts, image))
    return out


def alto_texts(alto: str) -> list:
    """Each ALTO TextLine's words joined by spaces, as the PDF writer reads
    them (lines without words left out)."""
    root = ET.fromstring(alto.encode("utf-8"))
    ns = root.tag[: root.tag.index("}") + 1]
    texts = [" ".join(w.get("CONTENT") for w in line.iter(ns + "String"))
             for line in root.iter(ns + "TextLine")]
    return [t for t in texts if t]


def pdf_on_card_outputs(tmp: str, files: dict, smi: str) -> dict:
    """produce_2layer_pdf on config 5's staged pages (PNG) with their Page
    XML and, apart, their ALTO, with the committed Latin font: every
    PDF's xref resolves, its text layer is the file's lines in order and
    its image stream the port's encode_jpeg of the page at quality 80."""
    folder = os.path.join(tmp, "pdf")
    for sub in ("images", "xml", "alto"):
        os.makedirs(os.path.join(folder, sub))
    for pid, (page, xml, alto) in files.items():
        with open(os.path.join(folder, "images", pid + ".png"), "wb") as f:
            f.write(png_bytes(page))
        for sub, text in (("xml", xml), ("alto", alto)):
            with open(os.path.join(folder, sub, pid + ".xml"), "w", encoding="utf-8") as f:
                f.write(text)
    log(f"find_unicode_font() on this machine: {pdf.find_unicode_font()}; the PDF check "
        f"passes {os.path.relpath(LATIN_FONT, REPO)}")
    numbers = {"pages": len(files), "font_bytes": os.path.getsize(LATIN_FONT)}
    for kind in ("xml", "alto"):
        out_dir = os.path.join(folder, "pdf_" + kind)
        _, seconds = run_script(produce_2layer_pdf.main, [
            os.path.join(folder, kind), os.path.join(folder, "images"), out_dir,
            "--font", LATIN_FONT])
        sizes = []
        for pid, (page, xml, alto) in files.items():
            with open(os.path.join(out_dir, pid + ".pdf"), "rb") as f:
                data = f.read()
            sizes.append(len(data))
            ((texts, image),) = pdf_pages(data)
            if kind == "xml":
                layout = PageLayout()
                layout.from_pagexml_string(xml)
                want = [ln.transcription for ln in layout.lines_iterator() if ln.transcription]
            else:
                want = alto_texts(alto)
            if texts != want or not want:
                raise AssertionError(f"produce_2layer_pdf ({kind}): the text layer of {pid} is "
                                     "not its file's lines")
            if image != image_io.encode_jpeg(page, 80):
                raise AssertionError(f"produce_2layer_pdf ({kind}): the image of {pid} is not "
                                     "encode_jpeg(page, 80)")
        numbers[kind] = {"ms_a_page": 1e3 * seconds / len(files),
                         "bytes_a_page": float(np.mean(sizes))}
    numbers["card"] = smi
    log(f"produce_2layer_pdf on config 5's card outputs: {len(files)} pages, Page XML "
        f"{numbers['xml']['ms_a_page']:.1f} ms a page, ALTO {numbers['alto']['ms_a_page']:.1f} "
        f"ms a page (host), xref, text layer and image stream checked, on {smi}")
    return numbers


def compare_card_and_cpu_xml(tmp: str, staged_xml: dict) -> dict:
    """compare_page_xml_texts with the card's Page XML of the staged CPU
    check as hypothesis and the CPU's as reference: it must count the
    differing characters that check counted (0: it holds the texts equal)
    over all the reference's characters."""
    folders = {}
    for device, xmls in staged_xml.items():
        folders[device] = os.path.join(tmp, "compare_" + device)
        os.makedirs(folders[device])
        for i, xml in enumerate(xmls):
            with open(os.path.join(folders[device], f"c{i}.xml"), "w", encoding="utf-8") as f:
                f.write(xml)
    stdout, seconds = run_script(compare_page_xml_texts.main, [
        "--hyp", folders["cuda"], "--ref", folders["cpu"], "--print-all"])
    distance, chars = (int(x) for x in re.search(
        r"^summary .* CER \[ (\d+) / (\d+) \]$", stdout, re.M).groups())
    ref_chars = 0
    for xml in staged_xml["cpu"]:
        layout = PageLayout()
        layout.from_pagexml_string(xml)
        ref_chars += sum(len((ln.transcription or "").strip()) for ln in layout.lines_iterator())
    log(f"compare_page_xml_texts, card vs CPU Page XML of the staged check:\n{stdout.strip()}")
    if distance != 0 or chars != ref_chars:
        raise AssertionError(f"compare_page_xml_texts counts [ {distance} / {chars} ], the "
                             f"staged check [ 0 / {ref_chars} ]")
    return {"pages": len(staged_xml["cpu"]), "distance": distance, "chars": chars,
            "ms": 1e3 * seconds}


def levenshtein_batch_times(pairs, smi: str) -> dict:
    """The batched edit distance (one levenshtein_batch_i32 call) against
    levenshtein_i32 a line and the numpy twin on ``pairs`` of texts:
    equal distances, host medians."""
    table: dict = {}
    seqs_a = [np.asarray([table.setdefault(c, len(table)) for c in a], np.int32) for a, _ in pairs]
    seqs_b = [np.asarray([table.setdefault(c, len(table)) for c in b], np.int32) for _, b in pairs]
    batch = native.native_levenshtein_batch(seqs_a, seqs_b)
    lines = [native.native_levenshtein(a, b) for a, b in zip(seqs_a, seqs_b)]
    twin = levenshtein_ids_batch(seqs_a, seqs_b)
    if list(batch) != lines or list(twin) != lines:
        raise AssertionError("levenshtein_batch_i32 differs from levenshtein_i32 or its twin")
    numbers = {"pairs": len(pairs), "chars": sum(len(a) + len(b) for a, b in pairs),
               "distance": int(batch.sum()),
               "batch_ms": host_ms(lambda: native.native_levenshtein_batch(seqs_a, seqs_b)),
               "per_line_ms": host_ms(lambda: [native.native_levenshtein(a, b)
                                               for a, b in zip(seqs_a, seqs_b)]),
               "numpy_ms": host_ms(lambda: levenshtein_ids_batch(seqs_a, seqs_b), repeats=3),
               "card": smi}
    log(f"levenshtein_batch_i32 on {len(pairs)} lines: {numbers['batch_ms']:.4f} ms in one call, "
        f"levenshtein_i32 a line {numbers['per_line_ms']:.4f} ms, numpy twin "
        f"{numbers['numpy_ms']:.2f} ms (host medians, on {smi}'s host)")
    return numbers


def run_user_scripts(script_pages: dict, config5_files: dict, staged_xml: dict, smi: str):
    """The phase of item 18's user scripts, on what earlier phases made:
    select_embed_id on config 2's staged pages (select_embed_id_on_card),
    produce_2layer_pdf on config 5's staged outputs (pdf_on_card_outputs),
    compare_page_xml_texts on the staged CPU check's Page XML and the
    batched edit distance on select_embed_id's lines.  Returns the
    warp_fields launches of select_embed_id's card run and the phase's
    numbers."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="user_scripts_") as tmp:
        launches, embed, pairs = select_embed_id_on_card(tmp, script_pages, smi)
        pdf_numbers = pdf_on_card_outputs(tmp, config5_files, smi)
        compared = compare_card_and_cpu_xml(tmp, staged_xml)
    numbers = {"select_embed_id": embed, "produce_2layer_pdf": pdf_numbers,
               "compare_page_xml_texts": compared,
               "levenshtein_batch": levenshtein_batch_times(pairs, smi),
               "seconds": time.perf_counter() - t0}
    log(f"the user scripts add {numbers['seconds']:.1f} s")
    return launches, numbers


# ----------------------------------------------------------------------
# Config 3: the staged path, then the beam search with a character LM
# stepped inside its frame loop (configs/config3_beam_lm.ini)
# One page through the command line (it took 2 until the phases of
# REGION_SIMPLE_THRESHOLD and --process-count needed the time).
CONFIG3_PAGES, CONFIG3_CLI_PAGES, CONFIG3_CHECK_LINES = 4, 1, 16
CONFIG3_STAGES = ("layout", "line_crop", "ocr", "decoder", "document/pagexml")
# The LM at the spec defaults over the bench charset without the blank,
# plus </s>.
CONFIG3_LM = CharLMSpec(vocab_size=len(BENCH_CHARS), embed_dim=64, hidden_dim=512, num_layers=2)
# The bench ParseNet's architecture keys, which the checkpoint needs
# beside config 3's own.
PARSENET_KEYS = {"FAST_STEM": "yes", "OUT_UPSAMPLE": "2", "BASE_FEATURES": "32", "DEPTH": "4"}
# A small program run as the command line: ``random`` seeded first, so
# that the rows' line order (order_lines_vertical's jitter), and with it
# the LM state carried from line to line, is the in-process run's.
SEEDED_CLI = ("import random, sys; random.seed(0); "
              "from pero_ocr_tpu_torch.scripts.parse_folder import main; main(sys.argv[1:])")


def write_config3_bundle(tmp: str, pn: ParseNet, rec: CTCRecognizer, pages: dict):
    """Config 3's ini as the repository has it (with the bench ParseNet's
    architecture keys), its ParseNet, recognizer and a seeded random
    CharLM (LSTM; a GRU twin beside it) at the paths the ini names, and
    ``pages`` as PNG files.  Returns ({"lstm", "gru", "batched"}: ini
    path, images dir): the GRU LM, and CARRY_H_OVER = no."""
    images = write_pages(tmp, pages)
    for folder in ("layout_engine", "ocr_engine", "lm"):
        os.makedirs(os.path.join(tmp, folder))
    checkpoint.save_variables(convert.parsenet_params_to_flax(pn),
                          os.path.join(tmp, "layout_engine", "parsenet.ckpt"))
    write_recognizer(os.path.join(tmp, "ocr_engine"), rec)
    for cell, seed in (("lstm", 5), ("gru", 6)):
        lm = CharLM(dataclasses.replace(CONFIG3_LM, cell_type=cell),
                    generator=torch.Generator().manual_seed(seed))
        train.export_lm_checkpoint(lm, os.path.join(tmp, "lm", f"charlm_{cell}.lm"))
    inis = {}
    for name, cell, carry in (("lstm", "lstm", "yes"), ("gru", "gru", "yes"),
                              ("batched", "lstm", "no")):
        config = configparser.ConfigParser()
        config.read(os.path.join(REPO, "configs", "config3_beam_lm.ini"))
        config["LAYOUT_PARSER_1"].update(PARSENET_KEYS)
        config["DECODER"]["LM"] = f"./lm/charlm_{cell}.lm"
        config["DECODER"]["CARRY_H_OVER"] = carry
        inis[name] = os.path.join(tmp, f"config3_{name}.ini")
        with open(inis[name], "w", encoding="utf-8") as f:
            config.write(f)
    return inis, images


class DecodeRecorder:
    """Wraps a TorchBeamSearchDecoder's ``run``: counts its decodes and
    frames, and keeps the inputs and backpointers of the first ``keep``
    decodes of the last page on the host (for the checks against the CPU
    and the eager loop).  With CARRY_H_OVER (``carry``) a page's first
    decode is the one without a carried state; without it every decode
    is kept until ``keep``."""

    def __init__(self, decoder, keep: int = 0, carry: bool = True):
        self.decoder, self.keep, self.carry = decoder, keep, carry
        self.calls, self.decodes, self.frames, self.padded_frames = [], 0, 0, 0
        self._run = decoder.run

        def run(logprobs, frame_lengths=None, model_eos=False, init_lm_states=None, **kw):
            out = self._run(logprobs, frame_lengths, model_eos, init_lm_states, **kw)
            self.decodes += 1
            self.frames += int(np.sum(frame_lengths))
            self.padded_frames += logprobs.shape[0] * logprobs.shape[1]
            if init_lm_states is None and self.carry:  # a new page
                self.calls = []
            if len(self.calls) < self.keep:
                init = None if init_lm_states is None else state_map(
                    lambda x: x.cpu().clone(), init_lm_states)
                self.calls.append((np.array(logprobs), np.array(frame_lengths), init,
                                   out.bp_rows.cpu().numpy(), out.bp_cols.cpu().numpy()))
            return out

        decoder.run = run

    def close(self):
        self.decoder.run = self._run


def decode_differs(got, want, margins, totals, lengths):
    """Per line of one decode: None where the backpointers of ``got``
    and ``want`` ((T, B, K) pairs) are equal on the line's frames, else
    (first frame that differs, whether ``want``'s smallest gap between
    consecutive totals among the K + 1 best there (``margins``, (T, B))
    is within float32 rounding of the totals accumulated so far:
    (t + 1) * 2**-23 * the magnitude of the line's finite final totals,
    that gap, that rounding, and whether the frame kept the same set of
    (row, col) cells in another order)."""
    out = []
    for i, n in enumerate(lengths):
        same = [np.array_equal(g[:n, i], w[:n, i]) for g, w in zip(got, want)]
        if all(same):
            out.append(None)
            continue
        bad = np.flatnonzero(np.any(np.stack(
            [(g[:n, i] != w[:n, i]).any(axis=1) for g, w in zip(got, want)]), axis=0))
        t0 = int(bad[0])
        finite = totals[i][totals[i] > NEG_INF / 2]
        tol = (t0 + 1) * 2.0 ** -23 * max(1.0, float(np.abs(finite).max(initial=0.0)))
        cells = [sorted(zip(*(bp[t0, i].tolist() for bp in pair))) for pair in (got, want)]
        out.append((t0, bool(margins[t0, i] <= tol), float(margins[t0, i]), tol,
                    cells[0] == cells[1]))
    return out


def check_decodes(decoder, calls, label: str) -> dict:
    """The recorded decodes of a card decoder's page run (graph replays)
    against the CPU port's decode of the same log-probs and carried
    states, and against the eager loop on the card: per line, the same
    backpointers (and the same best text), or a first difference where
    the CPU's smallest gap between consecutive totals among the K + 1
    best is within float32 rounding (a near-tie, counted and logged).  Raises on any other
    difference.  Returns the counts, equal / near-tie / differ, and the
    eager loop's and the graph's time a line on the card."""
    cpu = TorchBeamSearchDecoder(
        decoder.letters, k=decoder.k, lm=decoder.lm, lm_scale=decoder.lm_scale,
        insertion_bonus=decoder.insertion_bonus, transport_dtype=decoder.transport_dtype,
        vocab_map=None if decoder._lm_map is None else decoder._lm_map.cpu().numpy(),
        device="cpu")
    counts = {"cpu": [0, 0, 0], "eager": [0, 0, 0]}  # equal, near-tie, differ
    eager_s = graph_s = 0.0
    lines, differ = 0, []
    for logprobs, lengths, init, bp_rows, bp_cols in calls:
        lines += len(lengths)
        ref = cpu.run(logprobs, lengths, init_lm_states=init, margins=True)
        totals = (ref.p_total + cpu.lm_scale * ref.p_lm).numpy()
        card_init = None if init is None else state_map(lambda x: x.cuda(), init)
        t0 = time.perf_counter()
        eager = decoder.run(logprobs, lengths, init_lm_states=card_init, graph=False)
        eager_bags = decoder.hypotheses(eager)
        eager_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        graph_bags = decoder.hypotheses(decoder.run(logprobs, lengths,
                                                    init_lm_states=card_init))
        graph_s += time.perf_counter() - t0
        # The page run's (graph) backpointers against the CPU's and the
        # eager loop's; near-ties judged by the CPU's cuts.
        for name, want, bags in (
                ("cpu", (ref.bp_rows.numpy(), ref.bp_cols.numpy()), cpu.hypotheses(ref)),
                ("eager", (eager.bp_rows.cpu().numpy(), eager.bp_cols.cpu().numpy()),
                 eager_bags)):
            verdicts = decode_differs((bp_rows, bp_cols), want, ref.margins.numpy(), totals,
                                      lengths)
            for i, verdict in enumerate(verdicts):
                if verdict is None:
                    if bags[i].best_hyp() != graph_bags[i].best_hyp():
                        raise AssertionError(f"{label}: same backpointers as {name}, other "
                                             "best text")
                    counts[name][0] += 1
                elif verdict[1]:
                    counts[name][1] += 1
                    log(f"{label}: the {name} decode takes the other branch at a near-tie, "
                        f"line {i} of {len(lengths)}, frame {verdict[0]}: smallest gap "
                        f"{verdict[2]:.3g} against {verdict[3]:.3g}, same cells "
                        f"{verdict[4]}")
                else:
                    counts[name][2] += 1
                    log(f"{label}: the {name} decode differs on line {i} of {len(lengths)} "
                        f"({lengths[i]} frames) from frame {verdict[0]}: smallest gap "
                        f"{verdict[2]:.3g} against {verdict[3]:.3g}, same cells "
                        f"{verdict[4]}")
                    differ.append((logprobs, lengths, init, bp_rows, bp_cols, i))
    log(f"{label} decode check on {lines} lines in {len(calls)} decodes: card vs CPU "
        f"equal/near-tie/differ {counts['cpu']}, graph vs eager {counts['eager']}; eager "
        f"{1e3 * eager_s / lines:.2f} ms a line, graph {1e3 * graph_s / lines:.2f}")
    if counts["cpu"][2] or counts["eager"][2]:
        # The decodes at fault, kept for a rerun off the card.
        path = os.path.join(REPO, "build", re.sub(r"\W+", "_", label).strip("_") + ".npz")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        logprobs, lengths, init, bp_rows, bp_cols, line = differ[0]
        np.savez_compressed(path, logprobs=logprobs, lengths=lengths, bp_rows=bp_rows,
                            bp_cols=bp_cols, line=line, init_carried=init is not None)
        raise AssertionError(f"{label}: decodes differ {counts}; the first in {path}")
    return {"check_lines": lines, "check_decodes": len(calls),
            "eager_ms_a_line": 1e3 * eager_s / lines, "graph_ms_a_line": 1e3 * graph_s / lines,
            "card_vs_cpu_equal_near_tie_differ": counts["cpu"],
            "graph_vs_eager_equal_near_tie_differ": counts["eager"]}


def l2_bytes_per_s(n_bytes: int, n: int = 200) -> dict:
    """The rate at which torch's own kernels move data that stays in the
    card's L2 cache (50 MB): warm passes over a float32 tensor of
    ``n_bytes``, each timed as ``n`` launches queued behind a busy wait
    between two events: a sum by rows of 1024 (reads ``n_bytes``), a
    copy into a second tensor and a negation in place (each reads and
    writes ``n_bytes``).  The fastest rate is a lower bound of what the
    L2 serves."""
    buf = torch.randn(n_bytes // 4 // 1024 * 1024, device="cuda")
    out = torch.empty_like(buf)
    moves = {"sum_rows": (lambda: buf.view(-1, 1024).sum(dim=1), 1),
             "copy": (lambda: out.copy_(buf), 2), "neg_in_place": (lambda: out.neg_(), 2)}
    rates = {}
    for name, (fn, passes) in moves.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        rates[name] = passes * 4 * buf.numel() / (start.elapsed_time(end) / n * 1e-3)
    return {"bytes_per_s": max(rates.values()), "by_pass": rates}


def beam_step_bound_ms(lm: CharLM, k: int, v: int, l2_rate: Optional[float] = None) -> dict:
    """The least time of one frame's beam step on the card for a line
    (B = 1): bytes are the LM's float32 weights read once (of the
    embedding only the K rows gathered), the K entries' LM states and
    next-char log-probs read and written once, the frame read and the
    backpointers written; operations are the LM's matmuls over the K
    beams (2 flops a multiply-add).  Each over the card's peak.  The
    weights are read again every frame and fit in the L2 cache: with
    ``l2_rate`` (bytes/s) ``l2_bound_ms`` takes them at that rate, the
    rest of the bytes at the HBM rate."""
    sp = lm.spec
    weights = sum(p.numel() for name, p in lm.named_parameters() if not name.startswith("embed"))
    macs = k * sum(p.numel() for name, p in lm.named_parameters()
                   if "weight" in name and not name.startswith("embed"))
    leaves = sp.num_layers * (2 if sp.cell_type == "lstm" else 1)
    n_bytes = (4 * (weights + k * sp.embed_dim) + 2 * 4 * k * (leaves * sp.hidden_dim + v)
               + 4 * (v + 1) + 2 * k)
    flops = 2 * macs
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    out = {"bytes": n_bytes, "weight_bytes": 4 * weights, "flops": flops,
           "bound_ms": max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
    if l2_rate is not None:
        by_l2 = (4 * weights / l2_rate + (n_bytes - 4 * weights) / HBM_BYTES_PER_S) * 1e3
        out.update(l2_bytes_per_s=l2_rate, l2_bound_ms=max(by_l2, by_ops),
                   l2_bound_by="bytes" if by_l2 >= by_ops else "operations")
    return out


def _patched(ranges):
    """Wrap each (object, attribute) of ``ranges`` (label -> pair) in a
    torch.profiler record_function of its label; returns the undo."""
    from torch.profiler import record_function

    undo = []
    for label, (obj, attr) in ranges.items():
        orig, own = getattr(obj, attr), attr in vars(obj)

        def wrapped(*a, _orig=orig, _label=label, **kw):
            with record_function(_label):
                return _orig(*a, **kw)

        setattr(obj, attr, wrapped)
        undo.append((obj, attr, orig, own))

    def restore():
        for obj, attr, orig, own in undo:
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
    return restore


def _kernel_ms(evt) -> float:
    """Device ms of the kernels an op and its children launched."""
    own = sum(getattr(k, "duration", 0) for k in getattr(evt, "kernels", []))
    return own / 1e3 + sum(_kernel_ms(c) for c in getattr(evt, "cpu_children", []))


def device_split(fn, ranges: dict, groups=()) -> dict:
    """One call of ``fn`` (after one unprofiled call) under
    torch.profiler: the span from the first kernel's start to the last
    one's end, the kernels' busy time and the idle rest, the kernels'
    ms under each record_function label of ``ranges``, and the ms of
    the kernels whose names match each (label, regex) of ``groups``;
    the count of kernels and the ten longest by name.  Raises when the
    trace holds no device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    restore = _patched(ranges)
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        restore()
    events = prof.events()
    # Device events, without the record_function ranges' own GPU-side
    # annotation rows.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in ranges
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        raise AssertionError("torch.profiler saw no device kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -np.inf
    for s, e in spans:  # the union of the kernels' intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    span = max(e for _, e in spans) - spans[0][0]
    by_range = {label: sum(_kernel_ms(e) for e in events
                           if e.name == label and e.device_type == DeviceType.CPU)
                for label in ranges}
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    by_group = {label: sum(ms for name, ms in by_name.items() if re.search(pattern, name, re.I))
                for label, pattern in groups}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3, "idle_ms": (span - busy) / 1e3,
            "idle_share": (span - busy) / span if span else 0.0, "kernels": len(kernels),
            "ranges_ms": by_range, "groups_ms": by_group,
            "top_kernels_ms": [[name[:80], ms] for name, ms in top]}


def _median_ms(fn, n: int = 5) -> float:
    """Median device ms of ``fn`` alone, one call behind each wait
    (several in flight make the allocator wait)."""
    return float(np.median([cuda_ms(fn, reps=1, warmup=1) for _ in range(n)]))


def _profiled(fn, ranges: dict, groups=()) -> dict:
    """device_split, or {"not_measured": why} where the profiler sees no
    device kernel."""
    try:
        return device_split(fn, ranges, groups)
    except AssertionError as e:
        return {"not_measured": str(e)}


@torch.no_grad()
def profile_stage_b(pipe: TorchPagePipeline, b_args) -> dict:
    """Where one config-2 fast-path stage-B call's device time goes, on
    its last batch: each part alone with CUDA events (the warp, the
    convolutions of the VGG encoder, the BiLSTM, the Dense layer, CTC's
    labels and confidences, and the whole call), and one call under
    torch.profiler: the same parts as record_function ranges, the warp
    kernel and the weight copies by kernel name, the idle share."""
    rec = pipe.recognizer
    pages, baselines, heights = b_args

    def warp():
        return warp_ops.warp_lines(pages, baselines, heights, pipe.crop_height,
                                   pipe.crop_bucket, out_dtype=rec.spec.dtype, normalize=True)

    crops = warp()
    images = crops[..., None].expand(-1, -1, -1, 3).permute(0, 3, 1, 2).to(rec.spec.dtype)
    features = rec.encoder(images)
    sequence = rec.blstm(features)
    logits = rec.dense(sequence.float())
    valid = torch.full((logits.shape[0],), logits.shape[1], dtype=torch.int32,
                       device=logits.device)
    parts = {
        "stage_b": _median_ms(lambda: pipe.stage_b(*b_args)),
        "warp": _median_ms(warp),
        "convolutions": _median_ms(lambda: rec.encoder(images)),
        "bilstm": _median_ms(lambda: rec.blstm(features)),
        "dense": _median_ms(lambda: rec.dense(sequence.float())),
        "ctc": _median_ms(lambda: (pipeline_ctc_ops.greedy_ctc_labels(logits, valid),
                                   pipeline_ctc_ops.greedy_worst_run_confidence(logits, valid))),
    }
    split = {"parts_ms": parts, "lines": int(logits.shape[0]), "frames": int(logits.shape[1]),
             "profile": _profiled(lambda: pipe.stage_b(*b_args), {
                 "convolutions": (rec.encoder, "forward"), "bilstm": (rec.blstm, "forward"),
                 "dense": (rec.dense, "forward"),
                 "ctc_labels": (pipeline_ctc_ops, "greedy_ctc_labels"),
                 "ctc_confidence": (pipeline_ctc_ops, "greedy_worst_run_confidence"),
             }, groups=(("warp_lines", r"warp_lines"), ("copies", r"copy|cat")))}
    log(f"stage-B split (config 2, its last batch): {json.dumps(split)}")
    return split


def profile_beam_line(decoder, call) -> dict:
    """Where one config-3 line decode's device time goes, in the eager
    loop under torch.profiler (kernels a frame, the LM's advance and
    head as record_function ranges; sorts, gathers and matmuls by kernel
    name; the idle share), and the LM step alone with CUDA events (one
    advance and head over the K beams)."""
    logprobs, lengths, init = call[:3]
    init = None if init is None else state_map(lambda x: x.to(decoder.device), init)
    frames = logprobs.shape[1]
    split = _profiled(
        lambda: decoder.run(logprobs, lengths, init_lm_states=init, graph=False),
        {"lm_advance": (decoder.lm, "advance"), "lm_log_probs": (decoder.lm, "log_probs")},
        groups=(("sort", r"sort|radix|cub"), ("gather_scatter", r"gather|scatter|index"),
                ("gemm", r"gemm|gemv|xmma|cutlass|matmul")))
    split["frames"] = frames
    if "kernels" in split:
        split["kernels_a_frame"] = split["kernels"] / frames
    state = decoder.line_start_states(decoder.k)
    tokens = torch.zeros(decoder.k, dtype=torch.int64, device=decoder.device)
    with torch.inference_mode():
        split["lm_step_ms"] = _median_ms(
            lambda: decoder.lm.log_probs(decoder.lm.advance(tokens, state)))
    log(f"beam decode split (config 3, one line, eager): {json.dumps(split)}")
    return split


def run_config3(pipe: TorchPagePipeline, rng, smi: str):
    """Config 3 on the card: CONFIG3_PAGES two-column pages (~90 lines a
    page) through ``PageParser(config 3, device="cuda").process_page``:
    the staged layout, the field warp, CTC OCR at line height 40, then
    ``PageDecoder`` with CARRY_H_OVER: one beam search (K = 8, float16
    transport) a line with a CharLM at the spec defaults stepped inside
    the frame loop, each (1, bucket) shape a CUDA graph.  Checks: every
    page's XML parses, each line decoded once and in the charset, one
    warp_fields launch a page; the first CONFIG3_CHECK_LINES decodes of
    the last page held against the CPU port's decode of the same
    log-probs and carried states, and against
    the eager loop on the card (``check_decodes``); a GRU LM and the
    batched route (CARRY_H_OVER = no) on one page each, their decodes
    held the same way; the command line on CONFIG3_CLI_PAGES pages equal
    to the in-process run.  Returns the field warp's launches, the
    phase's numbers, the field warp's inputs on the last page and a
    recorded call (for the profile)."""
    pages, lines = synthetic_pages(rng, CONFIG3_PAGES, TWO_COLUMNS)
    ids = [f"b{i:04d}" for i in range(len(pages))]
    with tempfile.TemporaryDirectory(prefix="config3_") as tmp:
        inis, images = write_config3_bundle(tmp, pipe.parsenet, bench_recognizer(40),
                                            dict(zip(ids[:CONFIG3_CLI_PAGES], pages)))
        parser = staged_parser(inis["lstm"], "cuda")
        page_decoder, decoder = parser.decoder, parser.decoder.decoder
        if not (page_decoder.continue_lines and decoder.k == 8
                and decoder.transport_dtype is np.float16):
            raise AssertionError("config 3: not the decoder its ini asks for")
        warm = pages[-1]
        parser.process_page(warm, PageLayout(id="warm", page_size=warm.shape[:2]))
        wrapper = parser.layout_parsers[0].engine.parsenet
        wrapper.last_downsample = wrapper.init_downsample
        capture_warm = decoder.graph_capture_seconds
        timing.reset_timing()
        warp_ops.warp_fields.launches = warp_ops.warp_lines.launches = 0
        decoded_before = page_decoder.lines_decoded
        counter = DecodeRecorder(decoder, keep=CONFIG3_CHECK_LINES)
        try:
            out, seconds = staged_pages(parser, ids, pages)
        finally:
            counter.close()
        launches, fused = warp_ops.warp_fields.launches, warp_ops.warp_lines.launches
        stats = timing.timing_stats()
        capture_run = decoder.graph_capture_seconds - capture_warm
        log("stage times (config 3 run):\n" + timing.timing_report())

        n_lines = [len(list(layout.lines_iterator())) for layout, _ in out]
        decoded = page_decoder.lines_decoded - decoded_before
        charset = set(BENCH_CHARS[:-1])
        for (layout, xml), pid in zip(out, ids):
            root = ET.fromstring(xml.encode("utf-8"))
            texts = [e.text or "" for e in root.iter(f"{PAGE_NS}Unicode")]
            if len(texts) != len(list(layout.lines_iterator())) \
                    or any(set(t) - charset for t in texts):
                raise AssertionError(f"config 3 page {pid}: lines or their text off")
        if decoded != sum(n_lines) or counter.decodes != decoded or min(n_lines) < 4:
            raise AssertionError(f"config 3: {decoded} lines decoded in {counter.decodes} "
                                 f"decodes, lines a page {n_lines}")
        if launches != len(pages) or fused != 0:
            raise AssertionError(f"config 3: warp_fields launches {launches} != {len(pages)}")
        decoder_s = stats["decoder"][0]
        log(f"config 3 (PageParser.process_page): {len(pages)} pages, lines a page {n_lines}, "
            f"{len(pages) / seconds:.3f} pages/s to Page XML ({seconds:.3f} s) on {smi}; decoder "
            f"{1e3 * decoder_s / len(pages):.1f} ms a page, {1e3 * decoder_s / decoded:.2f} ms a "
            f"line, {counter.frames / decoder_s:.0f} frames/s ({counter.padded_frames} padded); "
            f"graph capture {capture_warm:.3f} s at the warm-up, {capture_run:.3f} s in the run "
            f"({len(decoder._graphs)} shapes); warp_fields launches {launches}")

        # The last page's first decodes: card against the CPU port, and
        # the graph against the eager loop.
        calls = counter.calls
        if len(calls) < CONFIG3_CHECK_LINES:
            raise AssertionError(f"config 3: {len(calls)} decodes recorded")
        check = check_decodes(decoder, calls, "config 3 (lstm)")
        last_page = page_buckets(parser, out[-1][0], pages[-1])

        # One line's graph replay alone (device time), against the bound.
        logprobs, lengths, init = calls[0][:3]
        decoder.run(logprobs, lengths, init_lm_states=None if init is None else state_map(
            lambda x: x.cuda(), init))
        runner = decoder._graphs[(1, logprobs.shape[1], False, False)]
        replay_ms = cuda_ms(runner.graph.replay, reps=5, warmup=1)
        bound = beam_step_bound_ms(decoder.lm, decoder.k, decoder.vocab)
        l2 = l2_bytes_per_s(bound["weight_bytes"])
        bound = beam_step_bound_ms(decoder.lm, decoder.k, decoder.vocab, l2["bytes_per_s"])
        bound["l2_rate_by_pass"] = l2["by_pass"]
        frame_ms = replay_ms / logprobs.shape[1]
        log(f"beam step: graph replay {replay_ms:.3f} ms for {logprobs.shape[1]} frames = "
            f"{1e3 * frame_ms:.2f} us a frame against a {1e3 * bound['bound_ms']:.2f} us bound "
            f"by {bound['bound_by']} ({bound['bytes']} B, {bound['flops']} flops); with the "
            f"weights read from L2 at the measured {bound['l2_bytes_per_s'] / 1e12:.2f} TB/s "
            f"({l2['by_pass']}), "
            f"{1e3 * bound['l2_bound_ms']:.2f} us by {bound['l2_bound_by']}")

        # A GRU LM, and the batched route, on one page each, their
        # decodes (the GRU's first lines, every bucket of the batched
        # page) held against the CPU and the eager loop.
        others = {}
        for name in ("gru", "batched"):
            torch.cuda.synchronize()
            reserved = torch.cuda.memory_reserved()
            other = staged_parser(inis[name], "cuda")
            recorder = DecodeRecorder(other.decoder.decoder, carry=name == "gru",
                                      keep=CONFIG3_CHECK_LINES // 2 if name == "gru" else 64)
            random.seed(0)
            try:
                layout = other.process_page(pages[0], PageLayout(id=ids[0],
                                                                 page_size=pages[0].shape[:2]))
            finally:
                recorder.close()
            n = len(list(layout.lines_iterator()))
            want_carry = name == "gru"
            if other.decoder.continue_lines != want_carry or other.decoder.lines_decoded != n \
                    or n < 4 or any(set(line.transcription) - charset
                                    for line in layout.lines_iterator()):
                raise AssertionError(f"config 3 ({name}): {other.decoder.lines_decoded} of {n} "
                                     "lines decoded, or text off")
            others[name] = {"lines": n, "decoded": other.decoder.lines_decoded,
                            "graph_shapes": len(other.decoder.decoder._graphs),
                            "decode_batches": [len(c[1]) for c in recorder.calls],
                            "summary": other.decoder.decoding_summary(),
                            **check_decodes(other.decoder.decoder, recorder.calls,
                                            f"config 3 ({name})")}
            if name == "batched":
                # The route over the other pages (other line counts): how
                # often its padded shapes repeat, what capturing costs a
                # page, and the card memory held since the parser was built.
                dec, per_page = other.decoder.decoder, []
                for pid, page in zip(ids, pages):
                    page_capture_s = dec.graph_capture_seconds
                    page_decoder_s = other.decoder.seconds_decoding
                    if pid != ids[0]:
                        other.process_page(page, PageLayout(id=pid, page_size=page.shape[:2]))
                        page_capture_s = dec.graph_capture_seconds - page_capture_s
                        page_decoder_s = other.decoder.seconds_decoding - page_decoder_s
                    torch.cuda.synchronize()
                    per_page.append({
                        "page": pid, "graph_shapes": sorted(key[:2] for key in dec._graphs),
                        "capture_s": page_capture_s, "decoder_s": page_decoder_s,
                        "memory_mb": (torch.cuda.memory_reserved() - reserved) / 2**20})
                others[name]["pages"] = per_page
            log(f"config 3 ({name}): {others[name]}")

        # The command line on the first pages, ``random`` seeded as the
        # in-process run was.
        out_dir = os.path.join(tmp, "page_xml")
        proc, cli_seconds = run_parse_folder(
            ["-c", inis["lstm"], "-i", images, "--output-xml-path", out_dir, "--timing-report"],
            "config 3 command line", program=SEEDED_CLI)
        counted = re.search(r"^warp_fields kernel launches: (\d+)$", proc.stdout, re.M)
        timed = re.search(r"^cli/pages\s+([0-9.]+)\s+1\s", proc.stdout, re.M)
        decoder_timed = re.search(r"^decoder\s+([0-9.]+)\s+(\d+)\s", proc.stdout, re.M)
        differ = [layout.id for layout, xml in out[:CONFIG3_CLI_PAGES]
                  if not same_staged_page(read_text(out_dir, layout.id + ".xml"), xml)]
        log(f"config 3 command line vs in-process: {CONFIG3_CLI_PAGES - len(differ)} of "
            f"{CONFIG3_CLI_PAGES} files equal; its warp_fields launches "
            f"{counted.group(1) if counted else None}")
        if differ or counted is None or timed is None or decoder_timed is None \
                or int(counted.group(1)) != CONFIG3_CLI_PAGES:
            raise AssertionError(f"config 3 command line: files differ {differ} or launches")

    numbers = {
        "pages": len(pages), "pages_per_s": len(pages) / seconds, "lines": sum(n_lines),
        "stage_ms": {k: 1e3 * stats[k][0] / stats[k][1] for k in CONFIG3_STAGES if k in stats},
        "decoder_ms_a_page": 1e3 * decoder_s / len(pages),
        "decoder_ms_a_line": 1e3 * decoder_s / decoded,
        "frames_per_s": counter.frames / decoder_s,
        "padded_frames_per_s": counter.padded_frames / decoder_s,
        "graph_shapes": len(decoder._graphs), "graph_capture_s_warm_up": capture_warm,
        "graph_capture_s_in_run": capture_run,
        **check,
        "beam_step": {"frames": logprobs.shape[1], "graph_replay_ms": replay_ms,
                      "ms_a_frame": frame_ms, **bound},
        "gru": others["gru"], "batched": others["batched"],
        "warp_fields_launches": launches,
        "cli_pages_per_s": CONFIG3_CLI_PAGES / float(timed.group(1)),
        "cli_decoder_s": float(decoder_timed.group(1)), "cli_wall_s": cli_seconds,
        "card": smi,
    }
    return launches, numbers, last_page, (decoder, calls[0])


# ----------------------------------------------------------------------
# Config 4: ADJUST_HEIGHTS, the smart sorter, the transformer recognizer
CONFIG4_PAGES, CONFIG4_CLI_PAGES, CONFIG4_CHECK_LINES = 3, 2, 16
CONFIG4_TILT_DEG = 1.5
CONFIG4_STAGES = ("layout", "parsenet_maps", "adjust_heights", "line_crop", "ocr",
                  "ocr/encode", "ocr/decode", "document/pagexml")
# The reference transformer at RefTransformerSpec's defaults (the
# ``net_name`` of a reference OCR JSON) over 80 characters (+ U+200B and
# '' in the engine).
CONFIG4_NET = {"dim_model": 512, "dim_ff": 2048, "heads": 8, "encoder_layers": 4,
               "decoder_layers": 4, "conv_subsampling": [8, 4], "max_seq_len": 500}
CONFIG4_CHARS = [chr(0x21 + i) for i in range(80)]


def write_ref_transformer(folder: str, chars, line_height: int, net: dict, seed: int) -> str:
    """A seeded reference-style transformer (``net``, the OCR JSON's
    ``net_name``) as a torch state dict ``transformer.pt`` and its OCR
    JSON ``transformer.json`` in ``folder``; the ignore id's bias is
    lowered so that random weights emit characters.  Returns the JSON's
    path."""
    spec = RefTransformerSpec.from_net_config(net, num_symbols=len(chars) + 2,
                                              in_height=line_height)
    model = RefTransformerOCR(spec, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.dec_out_proj.bias[spec.ignore_id] -= 3.0
    os.makedirs(folder, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(folder, "transformer.pt"))
    path = os.path.join(folder, "transformer.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"characters": list(chars), "line_px_height": line_height,
                   "checkpoint": "transformer.pt", "net_name": json.dumps(net)}, f)
    return path


def write_config4_bundle(tmp: str, pn: ParseNet, pages: dict):
    """Config 4's ini as the repository has it (with the bench ParseNet's
    architecture keys), its ParseNet and the reference transformer at
    the paths the ini names, and ``pages`` as PNG files.  Returns (ini,
    OCR JSON, images dir)."""
    images = write_pages(tmp, pages)
    os.makedirs(os.path.join(tmp, "layout_engine"))
    checkpoint.save_variables(convert.parsenet_params_to_flax(pn),
                          os.path.join(tmp, "layout_engine", "parsenet.ckpt"))
    config = configparser.ConfigParser()
    config.read(os.path.join(REPO, "configs", "config4_handwritten.ini"))
    config["LAYOUT_PARSER_1"].update(PARSENET_KEYS)
    ocr_json = write_ref_transformer(os.path.join(tmp, "ocr_engine"), CONFIG4_CHARS,
                                     config["LINE_CROPPER"].getint("LINE_HEIGHT"), CONFIG4_NET, 7)
    ini = os.path.join(tmp, "config4.ini")
    with open(ini, "w", encoding="utf-8") as f:
        config.write(f)
    return ini, ocr_json, images


class OCRRecorder:
    """Wraps a transformer engine's ``run_ocr``: counts its batches, real
    and padded lines and decode steps, and keeps every batch's input on
    the host (for the checks against the CPU and the eager loop)."""

    def __init__(self, engine):
        self.engine, self.calls = engine, []
        self.batches = self.lines = self.padded = self.steps = 0
        self._run = engine.run_ocr

        def run(batch_data, widths):
            self.batches += 1
            self.lines += int((widths > 0).sum())
            self.padded += len(widths)
            self.steps += engine.decode_length(batch_data.shape[2])
            self.calls.append((np.array(batch_data), np.array(widths)))
            return self._run(batch_data, widths)

        engine.run_ocr = run

    def close(self):
        self.engine.run_ocr = self._run


def decode_step_bound_ms(model, n: int, frames: int, max_len: int) -> dict:
    """The least time of one decode step of the reference transformer on
    the card, averaged over a ``max_len``-step decode of ``n`` lines whose
    memory has ``frames`` positions.  Bytes: the float32 weights a step
    uses, read once (each decoder layer's self-attention, the query and
    output projections of its cross-attention (the memory's keys and
    values are projected once a batch), its feed-forward and norms; the
    output projection; n embedding rows), the cross-attention's keys and
    values read once a layer, the self-attention cache read up to the
    step ((max_len + 1) / 2 entries on average), its new entries and the
    logits written.  Operations: 2 flops a multiply-add of the same
    matmuls and of the attention.  Each over the card's peak (float32
    outside the tensor cores)."""
    d = model.spec.dim_model
    per_layer = 0
    for name, p in model.decoder_layers[0].named_parameters():
        per_layer += p.numel() // 3 if name.startswith("multihead_attn.in_proj") else p.numel()
    layers = len(model.decoder_layers)
    weights = layers * per_layer + sum(p.numel() for p in model.dec_out_proj.parameters())
    attended = (max_len + 1) / 2
    cache_read = layers * 2 * n * attended * d
    cross_read = layers * 2 * n * frames * d
    n_bytes = 4 * (weights + n * d + cache_read + cross_read + layers * 2 * n * d
                   + n * model.spec.num_symbols)
    flops = 2 * (n * weights + layers * n * 2 * (attended + frames) * d)
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return {"bytes": int(n_bytes), "weight_bytes": 4 * weights,
            "cross_kv_bytes": int(4 * cross_read), "cache_bytes": int(4 * cache_read),
            "flops": int(flops), "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def tokens_differ(got, want, want_logits, lines: int, terms: int):
    """Per real line (the first ``lines``): None where the tokens
    (N, max_len) are equal, else (the first step that differs, whether
    ``want``'s two best logits there lie within float32 rounding: a
    near-tie, that gap, that rounding: ``terms`` roundings of 2**-23 of
    the row's largest magnitude)."""
    out = []
    for i in range(lines):
        if np.array_equal(got[i], want[i]):
            out.append(None)
            continue
        t = int(np.flatnonzero(got[i] != want[i])[0])
        row = want_logits[i, t]
        best2 = np.sort(row)[-2:]
        tol = terms * 2.0 ** -23 * max(1.0, float(np.abs(row).max()))
        out.append((t, bool(best2[1] - best2[0] <= tol), float(best2[1] - best2[0]), tol))
    return out


def check_transformer_decodes(engine, ocr_json: str, calls, label: str) -> dict:
    """The recorded batches decoded on the card (graph replay, then the
    eager loop) and by the port on the CPU, in float32 on both (TF32 off
    for the check): the graph equals the eager loop bit for bit (tokens,
    lengths, logits); the card's tokens equal the CPU's on every line,
    or their first difference is a near-tie of the CPU's logits (counted
    and logged).  Raises on any other difference."""
    cpu = TransformerEngineLineOCR(ocr_json, device="cpu")
    counts = {"cpu": [0, 0, 0], "eager": [0, 0]}  # equal, near-tie, differ; equal, differ
    lines = 0
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    try:
        for batch_data, widths in calls:
            real = int((widths > 0).sum())
            lines += real
            max_len = engine.decode_length(batch_data.shape[2])
            batch = torch.from_numpy(batch_data).cuda()
            graph = [t.cpu().numpy() for t in engine.decode(batch, max_len)]
            eager = [t.cpu().numpy() for t in engine.decode(batch, max_len, graph=False)]
            same = all(np.array_equal(g, e) for g, e in zip(graph, eager))
            counts["eager"][0 if same else 1] += real
            ref = [t.numpy() for t in cpu.decode(torch.from_numpy(batch_data), max_len)]
            for i, verdict in enumerate(tokens_differ(graph[0], ref[0], ref[2], real,
                                                      engine.spec.dim_ff)):
                if verdict is None:
                    counts["cpu"][0] += 1
                    if graph[1][i] != ref[1][i]:
                        raise AssertionError(f"{label}: equal tokens, other length")
                    continue
                counts["cpu"][1 if verdict[1] else 2] += 1
                log(f"{label}: line {i} of a batch of {real} differs from the CPU's from step "
                    f"{verdict[0]}: its two best logits {verdict[2]:.3g} apart against a "
                    f"rounding of {verdict[3]:.3g} ({'a near-tie' if verdict[1] else 'DIFFERS'})")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    log(f"{label} decode check on {lines} lines in {len(calls)} batches ({time.perf_counter() - t0:.1f} "
        f"s): card vs CPU equal/near-tie/differ {counts['cpu']}, graph vs eager equal/differ "
        f"{counts['eager']}")
    if counts["cpu"][2] or counts["eager"][1]:
        raise AssertionError(f"{label}: decodes differ {counts}")
    return {"check_lines": lines, "check_batches": len(calls),
            "card_vs_cpu_equal_near_tie_differ": counts["cpu"],
            "graph_vs_eager_equal_differ": counts["eager"]}


def profile_decode_step(engine, batch_data: np.ndarray) -> dict:
    """One recorded batch's decode on the card: the graph replay's and
    the eager loop's ms a step (CUDA events; the eager loop's time holds
    its host share), the eager loop under torch.profiler (kernels a step,
    matmuls, softmax and copies by kernel name, the idle share), against
    the step's bound."""
    max_len = engine.decode_length(batch_data.shape[2])
    batch = torch.from_numpy(batch_data).cuda()
    engine.decode(batch, max_len)  # the shape's graph
    runner = engine._graphs[(tuple(batch.shape), max_len)]
    with torch.inference_mode():
        memory = engine.model.encode(batch.float() / torch.tensor(255.0, device=batch.device))
        runner.memory.copy_(memory)
        graph_ms = cuda_ms(runner.graph.replay, reps=5, warmup=1)
        eager_ms = cuda_ms(lambda: engine.decode_from_memory(memory, max_len), reps=3, warmup=1,
                           ahead=False)
        split = _profiled(lambda: engine.decode_from_memory(memory, max_len),
                          {"decode_step": (engine.model, "decode_step")},
                          groups=(("gemm", r"gemm|gemv|xmma|cutlass|matmul|sm90"),
                                  ("softmax", r"softmax"), ("layer_norm", r"layer_norm|norm"),
                                  ("copies", r"copy|cat|stack")))
    bound = decode_step_bound_ms(engine.model, batch.shape[0], memory.shape[1], max_len)
    out = {"lines": int(batch.shape[0]), "width": int(batch.shape[2]), "steps": max_len,
           "memory_frames": int(memory.shape[1]), "graph_ms": graph_ms, "eager_ms": eager_ms,
           "graph_ms_a_step": graph_ms / max_len, "eager_ms_a_step": eager_ms / max_len,
           **bound, "profile": split}
    if "kernels" in split:
        out["kernels_a_step"] = split["kernels"] / max_len
    log(f"decode step (config 4, a batch of {out['lines']} lines x {out['width']} px, "
        f"{max_len} steps): graph {1e3 * out['graph_ms_a_step']:.1f} us a step, eager "
        f"{1e3 * out['eager_ms_a_step']:.1f} us, against a {1e3 * bound['bound_ms']:.2f} us bound "
        f"by {bound['bound_by']} ({bound['bytes']} B, {bound['flops']} flops); "
        f"{out.get('kernels_a_step')} kernels a step eager; {json.dumps(split)}")
    return out


def run_config4(pipe: TorchPagePipeline, rng, smi: str):
    """Config 4 on the card: CONFIG4_PAGES two-column pages whose lines
    tilt by CONFIG4_TILT_DEG (after a warm-up page) through
    ``PageParser(config 4, device="cuda").process_page``: ParseNet at the
    adaptive resolution, the CNN layout, ADJUST_HEIGHTS (a second
    ParseNet pass), REGION_SORTER_SMART, the field warp at LINE_HEIGHT
    48, the reference transformer at full width (random weights from a
    seed, a torch .pt), one CUDA graph a decode shape.  Checks: every
    page's XML parses, two regions or more a page, the lines' text in
    the charset, one warp_fields launch a page, the sorter's rotation is
    the tilt; the last batches (CONFIG4_CHECK_LINES lines or more) held
    against the CPU port's decode and the eager loop
    (``check_transformer_decodes``); one batch's step timed, graph and
    eager; the command line on CONFIG4_CLI_PAGES pages equal to the
    in-process run.  Returns the field warp's launches, the phase's
    numbers and the field warp's inputs on the last page."""
    pages, _ = synthetic_pages(rng, CONFIG4_PAGES + 1, TWO_COLUMNS, tilt_deg=CONFIG4_TILT_DEG)
    warm, pages = pages[0], pages[1:]
    ids = [f"h{i:04d}" for i in range(len(pages))]
    with tempfile.TemporaryDirectory(prefix="config4_") as tmp:
        ini, ocr_json, images = write_config4_bundle(
            tmp, pipe.parsenet, dict(zip(ids[:CONFIG4_CLI_PAGES], pages)))
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        parser = staged_parser(ini, "cuda")
        engine = parser.ocr.ocr_engine
        sorter = parser.layout_parsers[1]
        if not (isinstance(engine, TransformerEngineLineOCR) and engine.ref_mode
                and isinstance(sorter, SmartRegionSorter)
                and parser.layout_parsers[0].adjust_heights
                and parser.line_cropper.crop_engine.line_height == 48):
            raise AssertionError("config 4: not the stages its ini asks for")
        t0 = time.perf_counter()
        parser.process_page(warm, PageLayout(id="warm", page_size=warm.shape[:2]))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        wrapper = parser.layout_parsers[0].engine.parsenet
        wrapper.last_downsample = wrapper.init_downsample
        capture_warm = engine.graph_capture_seconds
        timing.reset_timing()
        warp_ops.warp_fields.launches = warp_ops.warp_lines.launches = 0
        recorder = OCRRecorder(engine)
        try:
            out, seconds = staged_pages(parser, ids, pages)
        finally:
            recorder.close()
        launches, fused = warp_ops.warp_fields.launches, warp_ops.warp_lines.launches
        stats = timing.timing_stats()
        capture_run = engine.graph_capture_seconds - capture_warm
        torch.cuda.synchronize()
        memory_mb = (torch.cuda.memory_reserved() - reserved) / 2**20
        log("stage times (config 4 run):\n" + timing.timing_report())

        charset = set(CONFIG4_CHARS)
        n_lines, n_regions, chars = [], [], 0
        for (layout, xml), pid in zip(out, ids):
            root = ET.fromstring(xml.encode("utf-8"))
            texts = [e.text or "" for e in root.iter(f"{PAGE_NS}Unicode")]
            n_lines.append(len(list(layout.lines_iterator())))
            n_regions.append(len(layout.regions))
            chars += sum(len(t) for t in texts)
            if len(texts) != n_lines[-1] or any(set(t) - charset for t in texts):
                raise AssertionError(f"config 4 page {pid}: lines or their text off")
        rotation = sorter.get_rotation(max(out[-1][0].regions, key=lambda r: len(r.lines)).lines)
        if min(n_regions) < 2 or min(n_lines) < 4 or recorder.lines != sum(n_lines) \
                or abs(rotation - CONFIG4_TILT_DEG) > 0.5:
            raise AssertionError(f"config 4: regions {n_regions}, lines {n_lines}, recognized "
                                 f"{recorder.lines}, rotation {rotation:.3f} degrees")
        if launches != len(pages) or fused != 0 or stats["adjust_heights"][1] != len(pages):
            raise AssertionError(f"config 4: warp_fields launches {launches} != {len(pages)}")
        ocr_s, encode_s, decode_s = (stats[k][0] for k in ("ocr", "ocr/encode", "ocr/decode"))
        log(f"config 4 (PageParser.process_page): {len(pages)} pages, lines a page {n_lines}, "
            f"regions a page {n_regions}, {len(pages) / seconds:.3f} pages/s to Page XML "
            f"({seconds:.3f} s) on {smi}; ocr {1e3 * ocr_s / len(pages):.1f} ms a page: encode "
            f"{1e3 * encode_s / recorder.batches:.2f} ms and decode {1e3 * decode_s / recorder.batches:.2f} "
            f"ms a batch, {recorder.batches} batches ({recorder.lines} lines padded to "
            f"{recorder.padded}), {recorder.steps} decode steps; graph capture {capture_warm:.3f} "
            f"s at the warm-up ({warm_s:.1f} s in all), {capture_run:.3f} s in the run "
            f"({len(engine._graphs)} shapes); card memory since the parser was built "
            f"{memory_mb:.0f} MB; the sorter's rotation {rotation:.3f} degrees; warp_fields "
            f"launches {launches}")

        # The last batches: card against the CPU port, graph against eager.
        calls, kept = [], 0
        for call in reversed(recorder.calls):
            if kept >= CONFIG4_CHECK_LINES:
                break
            calls.append(call)
            kept += int((call[1] > 0).sum())
        check = check_transformer_decodes(engine, ocr_json, calls[::-1], "config 4")
        widest = max(recorder.calls, key=lambda c: (c[0].shape[0], c[0].shape[2]))
        step = profile_decode_step(engine, widest[0])
        last_page = page_buckets(parser, out[-1][0], pages[-1])

        # The command line on the first pages, ``random`` seeded as the
        # in-process run was.
        out_dir = os.path.join(tmp, "page_xml")
        proc, cli_seconds = run_parse_folder(
            ["-c", ini, "-i", images, "--output-xml-path", out_dir, "--timing-report"],
            "config 4 command line", program=SEEDED_CLI)
        counted = re.search(r"^warp_fields kernel launches: (\d+)$", proc.stdout, re.M)
        timed = re.search(r"^cli/pages\s+([0-9.]+)\s+1\s", proc.stdout, re.M)
        decode_timed = re.search(r"^ocr/decode\s+([0-9.]+)\s+(\d+)\s", proc.stdout, re.M)
        differ = [layout.id for layout, xml in out[:CONFIG4_CLI_PAGES]
                  if not same_staged_page(read_text(out_dir, layout.id + ".xml"), xml)]
        log(f"config 4 command line vs in-process: {CONFIG4_CLI_PAGES - len(differ)} of "
            f"{CONFIG4_CLI_PAGES} files equal; its warp_fields launches "
            f"{counted.group(1) if counted else None}")
        if differ or counted is None or timed is None or decode_timed is None \
                or int(counted.group(1)) != CONFIG4_CLI_PAGES:
            raise AssertionError(f"config 4 command line: files differ {differ} or launches")

    numbers = {
        "pages": len(pages), "pages_per_s": len(pages) / seconds, "lines": sum(n_lines),
        "regions": n_regions, "characters": chars, "rotation_deg": rotation,
        "stage_ms_a_page": {k: 1e3 * stats[k][0] / len(pages) for k in CONFIG4_STAGES
                            if k in stats},
        "encode_ms_a_batch": 1e3 * encode_s / recorder.batches,
        "decode_ms_a_batch": 1e3 * decode_s / recorder.batches,
        "decode_share_of_page": decode_s / seconds, "batches": recorder.batches,
        "padded_lines": recorder.padded, "decode_steps": recorder.steps,
        "graph_shapes": sorted(list(k[0]) + [k[1]] for k in engine._graphs),
        "graph_capture_s_warm_up": capture_warm, "graph_capture_s_in_run": capture_run,
        "memory_mb_since_parser": memory_mb,
        "weights_mb": sum(p.numel() * p.element_size() for p in engine.model.parameters()) / 2**20,
        **check, "decode_step": step,
        "warp_fields_launches": launches,
        "cli_pages_per_s": CONFIG4_CLI_PAGES / float(timed.group(1)),
        "cli_decode_s": float(decode_timed.group(1)), "cli_wall_s": cli_seconds, "card": smi,
    }
    return launches, numbers, last_page


# ----------------------------------------------------------------------
# The crop transport and the re-OCR of existing layouts
CROP_RUNS = 3  # timed runs a transport and depth (median)
CROP_DEPTHS = (8, 4, 2)
REOCR_PAGES = 2
REOCR_TF_LINES = 16
OCR_ONLY_INI = """[PAGE_PARSER]
RUN_LAYOUT_PARSER = no
RUN_LINE_CROPPER = yes
RUN_OCR = yes

[LINE_CROPPER]
INTERP = 2
LINE_SCALE = 1.0
LINE_HEIGHT = 32

[OCR]
OCR_JSON = ./ocr.json
"""
# The command line as a program with TF32 off, for the card-CPU check.
NO_TF32_CLI = ("import sys, torch; torch.backends.cudnn.allow_tf32 = False; "
               "from pero_ocr_tpu_torch.scripts.parse_folder import main; main(sys.argv[1:])")


def crop_pipeline(pipe: TorchPagePipeline, **kwargs) -> TorchPagePipeline:
    """The crop transport over ``pipe``'s modules and settings, from its
    sticky scale."""
    crops = TorchPagePipeline(
        pipe.parsenet, pipe.recognizer, downsample=pipe.downsample,
        crop_bucket=pipe.crop_bucket, crop_height=pipe.crop_height, line_slot=pipe.line_slot,
        adaptive_downsample=pipe.adaptive_downsample, device="cuda", transport="crops",
        **kwargs)
    crops._last_ds = pipe._last_ds
    return crops


def label_agreement(got, want) -> dict:
    """Two runs on the same lines: the real lines whose labels are equal,
    and the labels' summed edit distance over ``want``'s summed count."""
    equal = total = edits = count = 0
    for g, w in zip(got, want):
        for i in range(len(w.baselines)):
            a = g.labels[i, : g.label_lengths[i]].astype(np.int32)
            b = w.labels[i, : w.label_lengths[i]].astype(np.int32)
            equal += int(np.array_equal(a, b))
            total += 1
            edits += native.native_levenshtein(a, b)
            count += len(b)
    return {"lines": total, "equal_share": equal / max(total, 1),
            "edit_share": edits / max(count, 1)}


class CropRecorder:
    """Keeps a crop-transport pipeline's last batch: its crop payload,
    stage-A artifacts and the host warp's inputs."""

    def __init__(self, pipe: TorchPagePipeline):
        self.pipe, self.last = pipe, {}
        recognize, stage_a, crop_payload = (pipe._recognize_payload, pipe._stage_a_artifacts,
                                            pipe._crop_payload)

        def kept_recognize(payload, page_batch):
            self.last["payload"] = payload
            return recognize(payload, page_batch)

        def kept_stage_a(small):
            self.last["artifacts"] = stage_a(small)
            return self.last["artifacts"]

        def kept_payload(grays, page_lines, max_n, n_slot, page_batch):
            self.last["host"] = (grays, page_lines, n_slot)
            return crop_payload(grays, page_lines, max_n, n_slot, page_batch)

        pipe._recognize_payload, pipe._stage_a_artifacts, pipe._crop_payload = (
            kept_recognize, kept_stage_a, kept_payload)


def host_crop_checks(pipe: TorchPagePipeline, last: dict) -> dict:
    """The C++ host warp (AVX2 body where the host has one, and the
    scalar body) and packed parse against their numpy twins on a run's
    last batch (``CropRecorder.last``; the warp on its first two pages),
    and their host ms a page (the twins' on one page)."""
    grays, page_lines, n_slot = last["host"]
    hc, bucket = pipe.crop_height, pipe.crop_bucket
    straight = []  # (gray, mats, widths) a page
    for gray, (b_list, h_list, *_) in zip(grays, page_lines):
        entries = [a for a in (pipe._line_affine(b, h) for b, h in zip(b_list, h_list)) if a]
        if entries:
            straight.append((gray, np.stack([m for m, _ in entries]),
                             np.asarray([w for _, w in entries], np.int32)))

    def warp_all(fn, pages=2, **kwargs):
        outs = []
        for gray, mats, widths in straight[:pages]:
            out = np.zeros((len(widths), hc, bucket), np.uint8)
            fn(gray, mats, widths, hc, out, np.arange(len(widths), dtype=np.int64) * hc * bucket,
               1, bucket, **kwargs)
            outs.append(out)
        return outs

    twin, scalar, dispatch = (warp_all(warp_affine_lines),
                              warp_all(native.native_warp_affine_lines, scalar=True),
                              warp_all(native.native_warp_affine_lines))
    scalar_diff = sum(int((a != b).sum()) for a, b in zip(scalar, twin))
    dispatch_max = max(int(np.abs(a.astype(int) - b).max()) for a, b in zip(dispatch, twin))
    dispatch_diff = sum(int((a != b).sum()) for a, b in zip(dispatch, twin))
    pixels = sum(int(w.sum()) * hc for _, _, w in straight[:2])
    arts = last["artifacts"]
    parse_diff = 0
    for slot in range(arts.packed.shape[0]):
        pipe.native = False
        twin_lines = pipe._lines_from_packed(arts.packed[slot], arts.heights_q[slot], 4)
        pipe.native = True
        parse_diff += _lines_differ(
            pipe._lines_from_packed(arts.packed[slot], arts.heights_q[slot], 4), twin_lines)
    pages = len(grays)
    numbers = {
        "straight_lines": sum(len(w) for _, _, w in straight), "warp_pixels": pixels,
        "avx2": native.warp_affine_avx2(), "scalar_vs_twin_pixels_differ": scalar_diff,
        "avx2_vs_twin_pixels_differ": dispatch_diff, "avx2_vs_twin_max": dispatch_max,
        "packed_parse_pages_differ": parse_diff,
        "warp_cpp_ms_a_page": host_ms(
            lambda: warp_all(native.native_warp_affine_lines, len(straight))) / len(straight),
        "warp_twin_ms_a_page": host_ms(lambda: warp_all(warp_affine_lines, 1), 3),
    }
    for route, name, n in ((True, "cpp", pages), (False, "twin", 1)):
        pipe.native = route
        numbers[f"parse_{name}_ms_a_page"] = host_ms(lambda: [pipe._lines_from_packed(
            arts.packed[s], arts.heights_q[s], 4) for s in range(n)], 3) / n
        numbers[f"strip_build_{name}_ms_a_page"] = host_ms(lambda: pipe._build_strip(
            grays[:n], page_lines[:n], n_slot, n), 3) / n
    pipe.native = True
    log(f"crop transport host C++ against its twins on the last batch: {numbers}")
    if scalar_diff or parse_diff or dispatch_max > 1:
        raise AssertionError(f"crop transport host C++ differs from its numpy twins: {numbers}")
    return numbers


def rebuild_times(pipe: TorchPagePipeline, payload, label: str) -> dict:
    """The strip rebuild (unpack, gather, mask) and the unpack alone on
    the card, on a batch's strip: device ms and the bound by bytes (the
    packed strip, offsets and widths read once, the crops written once)."""
    strip, offsets, widths = (torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in payload)
    rw = pipe._rebuild_width(payload[2])
    crops_bytes = len(payload[1]) * pipe.crop_height * rw
    read = strip.numel() + 8 * len(payload[1])
    out = {"rebuild_ms": cuda_ms(lambda: pipe.rebuild_strip(strip, offsets, widths, rw)),
           "rebuild_bound_ms": 1e3 * (read + crops_bytes) / HBM_BYTES_PER_S,
           "rebuild_width": rw, "strip_bytes": strip.numel(), "crops_bytes": crops_bytes}
    if pipe.transport_bits < 8:
        unpacked = strip.numel() * 8 // pipe.transport_bits
        out["unpack_ms"] = cuda_ms(lambda: unpack_bits(strip, pipe.transport_bits))
        out["unpack_bound_ms"] = 1e3 * (strip.numel() + unpacked) / HBM_BYTES_PER_S
    log(f"{label} strip on the card: {out}")
    return out


def crops_against_cpu(payload, rng) -> dict:
    """One batch's strip recognized by a small float32 recognizer on the
    card (TF32 off) and by the same weights on the CPU: labels and lengths
    equal on every line, or a line's differing frames are near-ties (the
    CPU's two best logits there closer than twice the card-CPU logit
    difference on that line); confidences of the equal lines within
    1e-4."""
    rec = CTCRecognizer(RecognizerSpec(
        num_classes=80, line_height=CROP_H, conv_features=(8, 16), subsampling=4,
        lstm_layers=1, lstm_features=16, dtype=torch.float32, stem="s2d", norm="group",
    ), generator=torch.Generator().manual_seed(int(rng.integers(1 << 30))))
    pipes = {device: TorchPagePipeline(None, copy.deepcopy(rec), crop_height=CROP_H,
                                       crop_bucket=BUCKET, transport="crops", device=device)
             for device in ("cuda", "cpu")}
    rw = pipes["cpu"]._rebuild_width(payload[2])
    outs, devs = {}, {}
    torch.backends.cudnn.allow_tf32 = False
    try:
        for device, p in pipes.items():
            devs[device] = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in payload]
            outs[device] = [t.cpu().numpy() for t in p._label_bytes(p.stage_b_strip(
                *devs[device], PAGE_BATCH, rw))[:3]]
        (cl, cn, cc), (pl, pn, pc) = outs["cuda"], outs["cpu"]
        real = payload[2].reshape(PAGE_BATCH, -1) > 0
        equal = np.all(cl == pl, axis=-1) & (cn == pn)
        differ = np.flatnonzero((~equal & real).reshape(-1))
        near_ties = []
        if len(differ):
            logits = {}
            with torch.inference_mode():
                for device, p in pipes.items():
                    crops = p.rebuild_strip(*devs[device], rw)[torch.from_numpy(differ).to(device)]
                    images = p._normalize(crops)[..., None].expand(-1, -1, -1, 3)
                    logits[device] = p.recognizer(images).float().cpu().numpy()
            for k, line in enumerate(differ):
                card, cpu = logits["cuda"][k], logits["cpu"][k]
                frames = np.flatnonzero(card.argmax(-1) != cpu.argmax(-1))
                top2 = np.sort(cpu[frames], axis=-1)[:, -2:]
                near_ties.append(bool(len(frames)) and bool(
                    (top2[:, 1] - top2[:, 0] <= 2 * np.abs(card - cpu).max()).all()))
                log(f"crop transport card vs CPU: line {line} differs at frames {frames[:8]}; the "
                    f"CPU's two best logits {top2[:, 1] - top2[:, 0]} apart, the line's logits "
                    f"{np.abs(card - cpu).max():.3g} apart ({'a near-tie' if near_ties[-1] else 'DIFFERS'})")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    err = float(np.abs(cc - pc)[real & equal].max(initial=0.0))
    n_real, n_equal = int(real.sum()), int((real & equal).sum())
    log(f"crop transport card vs CPU on one batch's strip (float32, TF32 off): labels equal on "
        f"{n_equal} of {n_real} lines, {sum(near_ties)} near-ties, confidences of the equal "
        f"lines within {err:.3g}")
    if n_equal + sum(near_ties) != n_real or err > 1e-4:
        raise AssertionError("crop transport: the card's labels differ from the CPU port's")
    return {"lines": n_real, "equal": n_equal, "near_ties": sum(near_ties),
            "conf_max_diff": err}


def run_crops(pipe: TorchPagePipeline, rng, smi: str):
    """The crop transport with the main path's modules and shapes (16
    two-column pages, 8 a batch, crop bucket 1024, 40 line slots): CNN
    detection at transport bits 8, 4 and 2, each with the strip and the
    dense buffer, then the lines the 8-bit strip run found as an override
    on both transports, with and without ``skip_stage_a``.  Checks: the
    crop transport finds the lines and launches no warp kernel; the strip
    and the dense buffer give byte-equal crops and the same lines;
    skip_stage_a gives stage A's labels; 4- and 2-bit crops give the same
    lines and label shapes as 8-bit (their label agreement is printed);
    one batch's strip recognized alike on card and CPU; the host C++
    equal to its twins.  Times: pages/s a transport and depth (the median
    of CROP_RUNS on the page transport and the 8- and 4-bit strip), the
    strip rebuild and unpack's device ms a batch against their bound, the
    host warp and parse ms a page."""
    n_pages = 2 * PAGE_BATCH
    pages, lines = synthetic_pages(rng, n_pages, TWO_COLUMNS)

    def drive(p, n_runs=1, override=None, skip=False):
        seconds = []
        last_ds = p._last_ds
        for _ in range(n_runs):
            p._last_ds = last_ds  # every run from the same scale
            t0 = time.perf_counter()
            out = list(p.run(pages, lines_override=override, page_batch=PAGE_BATCH,
                             skip_stage_a=skip))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        if [r.page_index for r in out] != list(range(n_pages)):
            raise AssertionError("crop transport: results out of page order")
        return out, n_pages / float(np.median(seconds))  # pages/s

    runs, speeds = {}, {}
    timing.reset_timing()
    warp_ops.warp_lines.launches = 0
    runs["page"], speeds["page"] = drive(pipe, CROP_RUNS)
    page_launches = warp_ops.warp_lines.launches
    log("stage times (the page transport's CNN runs):\n" + timing.timing_report())
    drive(crop_pipeline(pipe, transport_bits=4))  # warm-up at the crop transport's widths
    pipes, recorders = {}, {}
    timing.reset_timing()
    warp_ops.warp_lines.launches = 0
    native.calls.clear()
    for bits in CROP_DEPTHS:
        for payload in ("strip", "dense"):
            key = f"{bits}_{payload}"
            pipes[key] = crop_pipeline(pipe, transport_bits=bits, trim_crops=payload == "strip")
            recorders[key] = CropRecorder(pipes[key])
            timed = payload == "strip" and bits in (8, 4)
            runs[key], speeds[key] = drive(pipes[key], CROP_RUNS if timed else 1)
    crop_stats = timing.timing_stats()
    crop_report = timing.timing_report()
    crop_calls = dict(native.calls)
    crop_launches = warp_ops.warp_lines.launches
    last = {key: dict(r.last) for key, r in recorders.items()}  # the CNN runs' last batches
    override = [(r.baselines, r.heights) for r in runs["8_strip"]]
    runs["page_override"], speeds["page_override"] = drive(pipe, override=override)
    for bits in CROP_DEPTHS:
        runs[f"{bits}_override"], speeds[f"{bits}_override"] = drive(pipes[f"{bits}_strip"],
                                                                     override=override)
    runs["8_skip"], speeds["8_skip"] = drive(pipes["8_strip"], override=override, skip=True)
    # The page transport samples the page past each line's end and
    # decodes every frame; the crop transport's crops end at the line's
    # width and it decodes the valid frames: their labels are reported,
    # not held equal (nor are they in the JAX package).
    agreement = {f"{bits}_vs_8": label_agreement(runs[f"{bits}_override"], runs["8_override"])
                 for bits in (4, 2)}
    agreement["8_vs_page"] = label_agreement(runs["8_override"], runs["page_override"])
    log(f"crop transport on {smi}, {n_pages} pages, pages/s (median of {CROP_RUNS} for page, "
        "8_strip and 4_strip, one run otherwise): "
        + ", ".join(f"{k} {v:.3f}" for k, v in speeds.items()))
    log("stage times (the crop transport's CNN runs, all depths):\n" + crop_report)
    recall = {key: line_recall([r.baselines for r in runs[key]], lines)
              for key in ["page"] + [f"{b}_strip" for b in CROP_DEPTHS]}
    log(f"crop transport: line recall {recall}; warp_lines launches on the page transport "
        f"{page_launches}, on the crop transport {crop_launches}; host calls {crop_calls}; "
        f"label agreement on the same lines {agreement}")
    if min(recall.values()) < MIN_LINE_RECALL:
        raise AssertionError(f"crop transport: line recall {recall}")
    if crop_launches or page_launches != 2 * CROP_RUNS:
        raise AssertionError("crop transport: warp kernel launches on the wrong transport")
    if crop_calls.get("cc_lines_packed", 0) < n_pages or not crop_calls.get(
            "warp_affine_lines_u8"):
        raise AssertionError(f"crop transport: the host C++ did not run: {crop_calls}")
    for bits in CROP_DEPTHS:
        strip, dense = runs[f"{bits}_strip"], runs[f"{bits}_dense"]
        if any(_lines_differ((a.baselines, a.heights), (b.baselines, b.heights))
               for a, b in zip(strip, dense)):
            raise AssertionError(f"crop transport {bits}-bit: strip and dense lines differ")
        s_payload = last[f"{bits}_strip"]["payload"]
        d_payload = last[f"{bits}_dense"]["payload"]
        p = pipes[f"{bits}_strip"]
        rw = p._rebuild_width(s_payload[2])
        rebuilt = p.rebuild_strip(*(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                                    for a in s_payload), rw)
        dense_crops = unpack_bits(torch.from_numpy(d_payload[0]).cuda(), bits)
        if not (torch.equal(rebuilt, dense_crops[..., :rw])
                and not dense_crops[..., rw:].any()
                and np.array_equal(s_payload[2], d_payload[1])):
            raise AssertionError(f"crop transport {bits}-bit: the rebuilt strip differs from the "
                                 "dense buffer")
        # The JAX package's bound on quantized crops: the same lines and
        # label tensors (tests/test_pipeline.py test_crop_transport_4bit).
        for a, b in zip(runs[f"{bits}_override"], runs["8_override"]):
            if len(a.baselines) != len(b.baselines) or a.labels.shape != b.labels.shape:
                raise AssertionError(f"crop transport {bits}-bit: other lines or label shapes")
    for a, b in zip(runs["8_skip"], runs["8_override"]):
        if not (np.array_equal(a.labels, b.labels) and np.array_equal(a.label_lengths,
                                                                       b.label_lengths)
                and np.array_equal(a.confidences, b.confidences)):
            raise AssertionError(f"crop transport: skip_stage_a changed page {a.page_index}")
    log("crop transport: rebuilt strips equal the dense buffers at 8, 4 and 2 bits; "
        "skip_stage_a gives stage A's labels")
    numbers = {
        "pages": n_pages, "pages_per_s": speeds, "line_recall": recall,
        "label_agreement": agreement, "host_calls": crop_calls,
        "stage_ms": {k: 1e3 * v[0] / v[1] for k, v in crop_stats.items()},
        "stage_calls": {k: v[1] for k, v in crop_stats.items()},
        "host": host_crop_checks(pipes["8_strip"], last["8_strip"]),
        "against_cpu": crops_against_cpu(last["8_strip"]["payload"], rng),
        "card": smi,
    }
    for bits in CROP_DEPTHS:
        key = f"{bits}_strip"
        numbers[f"strip_{bits}"] = rebuild_times(pipes[key], last[key]["payload"], f"{bits}-bit")
    return numbers


def transformer_reocr(layout: PageLayout, page: np.ndarray, smi: str) -> dict:
    """A config-4 reference transformer at full width (CONFIG4_NET, line
    height 48) through ``FastPagePipeline(reocr=True)`` on the card:
    REOCR_TF_LINES lines of ``layout``, TF32 off.  On the crops that
    reached stage B: the graph-replayed decode against the eager loop
    (bit-equal tokens, lengths and confidences), and the tokens against
    the CPU port's greedy decode (equal, or a first difference that is a
    near-tie of float32 rounding)."""
    chars = BENCH_CHARS[:-1]
    spec = RefTransformerSpec.from_net_config(CONFIG4_NET, num_symbols=len(chars) + 2,
                                              in_height=48)
    model = RefTransformerOCR(spec, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        model.dec_out_proj.bias[spec.ignore_id] -= 3.0
    cpu_model = copy.deepcopy(model).eval()
    trimmed = copy.deepcopy(layout)
    for region in trimmed.regions:
        region.lines = []
    trimmed.regions[0].lines = list(layout.lines_iterator())[:REOCR_TF_LINES]
    real = len(trimmed.regions[0].lines)
    p = TorchPagePipeline(None, model, crop_height=48, crop_bucket=BUCKET,
                          line_slot=REOCR_TF_LINES, transport="crops", cluster_paragraphs=False,
                          device="cuda")
    seen = []
    recognize = p.stage_b_recognize

    def kept(crops, pb, widths=None):
        seen.append(crops)
        return recognize(crops, pb, widths)

    p.stage_b_recognize = kept
    fast = FastPagePipeline(p, list(chars) + ["\u200b", ""], page_batch=1, reocr=True)
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        (out,) = fast.process_existing_layouts([page], [trimmed])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        dec_len = max(8, min(p.crop_bucket // 4, spec.max_seq_len - 1))
        with torch.inference_mode():
            images = seen[0][..., None].expand(-1, -1, -1, 3)
            memory = model.encode(images)
            graph = [t.cpu().numpy() for t in p._graphed_decode(memory, dec_len)]
            eager = [t.cpu().numpy() for t in p._decode_from_memory(memory, dec_len)]
            cpu_tokens, _, cpu_logits = transformer_ref.greedy_decode_ref(
                cpu_model, images.cpu(), dec_len)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    if not all(np.array_equal(g, e) for g, e in zip(graph, eager)):
        raise AssertionError("re-OCR transformer: the graph's decode differs from the eager loop")
    texts = [ln.transcription for ln in out.lines_iterator()]
    if texts != ["".join(chars[t] for t in row[:n] if t < len(chars))
                 for row, n in zip(graph[0][:real], graph[1][:real])]:
        raise AssertionError("re-OCR transformer: the layout's text is not the decode's")
    verdicts = tokens_differ(graph[0], cpu_tokens.numpy(), cpu_logits.numpy(), real,
                             spec.dim_ff)
    counts = [sum(v is None for v in verdicts), sum(bool(v and v[1]) for v in verdicts),
              sum(bool(v and not v[1]) for v in verdicts)]
    log(f"re-OCR with the reference transformer on {smi}: {real} lines, {dec_len} steps, "
        f"{seconds:.3f} s (graph capture {p.graph_capture_seconds:.3f} s included); card vs "
        f"CPU equal/near-tie/differ {counts}; graph equals eager; first text {texts[0][:40]!r}")
    if counts[2]:
        raise AssertionError(f"re-OCR transformer: tokens differ from the CPU's {verdicts}")
    return {"lines": real, "steps": dec_len, "seconds": seconds,
            "graph_capture_s": p.graph_capture_seconds,
            "card_vs_cpu_equal_near_tie_differ": counts}


def run_reocr(pipe: TorchPagePipeline, rng, smi: str):
    """Re-OCR of existing layouts: REOCR_PAGES two-column pages to Page
    XML with the page transport, then ``parse_folder -x <that xml> -i
    <pages>`` with an OCR-only config (the bench recognizer's weights in
    float32, TF32 off) on the card with --fast-pipeline (the crop
    transport's recognize-only loop) and without (LineCropper's field
    warp, one launch a page), from colour JPEG pages with
    --output-line-path, each against the same command in this process on
    the CPU (its host C++ route, as on the card): equal Page XML (conf
    within 0.0015) and line files equal byte for byte.  Then a reference
    transformer through the fast re-OCR (``transformer_reocr``)."""
    pages, _ = synthetic_pages(rng, REOCR_PAGES, TWO_COLUMNS)
    ids = [f"x{i:04d}" for i in range(REOCR_PAGES)]
    layouts = list(FastPagePipeline(pipe, BENCH_CHARS, page_batch=CLI_PAGE_BATCH)
                   .process_pages(pages, ids))
    rec32 = CTCRecognizer(dataclasses.replace(pipe.recognizer.spec, dtype=torch.float32))
    rec32.load_state_dict({k: v.float() for k, v in pipe.recognizer.state_dict().items()})
    numbers = {"pages": REOCR_PAGES, "lines": sum(len(list(lay.lines_iterator()))
                                                  for lay in layouts), "card": smi}
    with tempfile.TemporaryDirectory(prefix="reocr_") as tmp:
        images = write_pages(tmp, dict(zip(ids, pages)), jpeg="color")
        xml_in = os.path.join(tmp, "xml_in")
        os.makedirs(xml_in)
        for layout in layouts:
            layout.to_pagexml(os.path.join(xml_in, layout.id + ".xml"))
        write_recognizer(tmp, rec32, dtype="float32")
        ini = os.path.join(tmp, "ocr_only.ini")
        with open(ini, "w", encoding="utf-8") as f:
            f.write(OCR_ONLY_INI)
        from pero_ocr_tpu_torch.scripts import parse_folder as cli

        for flags, name in (([], "staged"), (["--fast-pipeline"], "fast")):
            out, cpu_out = (os.path.join(tmp, f"{name}_{d}") for d in ("card", "cpu"))
            args = ["-c", ini, "-i", images, "-x", xml_in, "--timing-report", *flags]
            proc, seconds = run_parse_folder(
                args + ["--output-xml-path", out, "--output-line-path", out + "_lines"],
                f"re-OCR command line ({name})", NO_TF32_CLI)
            use_native = native.use_native
            native.use_native = lambda route, device: True  # the card's host route
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(sys.stderr):
                    cli.main(args + ["--output-xml-path", cpu_out, "--output-line-path",
                                     cpu_out + "_lines", "--device", "cpu"])
                cpu_seconds = time.perf_counter() - t0
            finally:
                native.use_native = use_native
                checkpoint.set_strict_loading(False)
            differ = [fid for fid in ids if not same_staged_page(
                read_text(out, fid + ".xml"), read_text(cpu_out, fid + ".xml"))]
            card_lines, cpu_lines = line_files(out + "_lines"), line_files(cpu_out + "_lines")
            lines_differ = sorted(n for n in set(card_lines) | set(cpu_lines)
                                  if card_lines.get(n) != cpu_lines.get(n))
            timed = re.search(r"^cli/pages\s+([0-9.]+)\s+1\s", proc.stdout, re.M)
            launches = re.search(r"^warp_fields kernel launches: (\d+)$", proc.stdout, re.M)
            numbers[name] = {"wall_s": seconds, "cpu_s": cpu_seconds,
                             "pages_per_s": REOCR_PAGES / float(timed.group(1)),
                             "warp_fields_launches": int(launches.group(1)),
                             "pages_differ": differ, "line_files": len(card_lines),
                             "line_files_differ": lines_differ}
            log(f"re-OCR command line ({name}) on {smi}: {numbers[name]}")
            if differ:
                raise AssertionError(f"re-OCR ({name}): the card's Page XML differs from the "
                                     f"CPU's on {differ}")
            if lines_differ or len(card_lines) != numbers["lines"]:
                raise AssertionError(f"re-OCR ({name}): the card's line files differ from the "
                                     f"CPU's: {lines_differ[:10]}, {len(card_lines)} files for "
                                     f"{numbers['lines']} lines")
            want = 0 if flags else REOCR_PAGES
            if numbers[name]["warp_fields_launches"] != want:
                raise AssertionError(f"re-OCR ({name}): warp_fields launched "
                                     f"{numbers[name]['warp_fields_launches']} times, want {want}")
    numbers["transformer"] = transformer_reocr(layouts[0], pages[0], smi)
    return numbers


# ----------------------------------------------------------------------
# The reference's TorchScript archives on both paths, and the layout
# stages and LAYOUT_CNN options of ROADMAP item 8d (run_torchscript)
class ArchiveParseNet(torch.nn.Module):
    """The port's ParseNet as the reference exports its detector: NCHW
    images in [0, 1] -> (NCHW maps, a scalar)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        maps = self.net(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return maps, maps.mean()


class ArchiveRecognizer(torch.nn.Module):
    """The port's CTCRecognizer as the reference exports it: NCHW line
    images in [0, 1] -> (N, C, T) logits."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return self.net(x.permute(0, 2, 3, 1)).permute(0, 2, 1)


TS_RECOGNIZER = dict(num_classes=80, line_height=CROP_H, conv_features=(48, 96, 192, 384),
                     subsampling=4, lstm_layers=2, lstm_features=256, stem="s2d", norm="group")
# Stage by stage: pages cut to their top 1,280 rows (MULTI_ORIENTATION's
# turned passes find ~200 regions and ~500 lines on a whole page, ~23 s
# of host layout a page on the card's host), the CPU replaying the first
# page; the command line on 1 (each took 2 until the phases of
# REGION_SIMPLE_THRESHOLD and --process-count needed the time).
# Stage by stage on 2 pages (4 before the user scripts' phase needed the
# time); 4 are still drawn, so that later phases see the generator as
# before.
TS_PAGES, TS_STAGED_PAGES, TS_CPU_PAGES, TS_CLI_PAGES = 2 * PAGE_BATCH, 2, 1, 1
TS_STAGED_DRAWN = 4
TS_STAGED_ROWS = 1280
TS_INI = """[PAGE_PARSER]
RUN_LAYOUT_PARSER = yes
RUN_LINE_CROPPER = yes
RUN_OCR = yes

[LAYOUT_PARSER_1]
METHOD = LAYOUT_CNN
MODEL_PATH = ./parsenet.pt
DOWNSAMPLE = 4
DETECTION_THRESHOLD = 0.2
MAX_MEGAPIXELS = 5
ADAPTIVE_DOWNSAMPLE = yes
{options}
{stages}
[LINE_CROPPER]
INTERP = 2
LINE_SCALE = 1.0
LINE_HEIGHT = 32

[OCR]
OCR_JSON = ./ocr.json
"""
TS_STAGES_A = """
[LAYOUT_PARSER_2]
METHOD = LINE_FILTER
FILTER_DIRECTIONS = yes
MODEL_PATH = ./orientation.msgpack
FILTER_INCOMPLETE_PAGES = yes

[LAYOUT_PARSER_3]
METHOD = LINE_POSTPROCESSING
STRETCH_LINES = max
RESAMPLE_LINES = yes

[LAYOUT_PARSER_4]
METHOD = LAYOUT_POSTPROCESSING
RETRACE_REGIONS = yes

[LAYOUT_PARSER_5]
METHOD = REGION_SORTER_NAIVE
"""
# ini (a): the LAYOUT_CNN options and every stage after the CNN; ini
# (b): straight lines in the CNN's regions.
TS_INIS = {"a": ("MULTI_ORIENTATION = yes\nMERGE_LINES = yes\nADJUST_BASELINES = yes",
                 TS_STAGES_A),
           "b": ("DETECT_STRAIGHT_LINES_IN_REGIONS = yes", "")}
TS_STAGE_TIMERS = STAGE_TIMERS + ("straight_lines", "adjust_baselines")
# Share of stage A's baseline-mask pixels that the archive and the
# native modules may set apart (vertical maxima that tie in float32).
TS_MASK_FLIPS = 0.001


def write_archives(tmp: str):
    """The detector (the hand-set edge detector at base 32, depth 4, conv
    stem, float32) and the bench recognizer (float32, seeded) traced on
    the CPU into ``tmp``/parsenet.pt and recognizer.pt, the OCR JSON
    naming the recognizer archive, a seeded OrientationNet as a flax
    msgpack, and the two inis.  Returns (detector, recognizer): the CPU
    modules the archives hold."""
    det = ParseNet(base_features=32, depth=4, stem="conv", dtype=torch.float32)
    edge_detector_(det)
    rec = CTCRecognizer(RecognizerSpec(dtype=torch.float32, **TS_RECOGNIZER),
                        generator=torch.Generator().manual_seed(1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", torch.jit.TracerWarning)  # shape arithmetic, constant
        torch.jit.trace(ArchiveParseNet(det).eval(), torch.rand(1, 3, 64, 64)).save(
            os.path.join(tmp, "parsenet.pt"))
        torch.jit.trace(ArchiveRecognizer(rec).eval(), torch.rand(1, 3, CROP_H, 128)).save(
            os.path.join(tmp, "recognizer.pt"))
    checkpoint.save_variables(convert.orientation_params_to_flax(
        OrientationNet(generator=torch.Generator().manual_seed(5))),
        os.path.join(tmp, "orientation.msgpack"))
    with open(os.path.join(tmp, "ocr.json"), "w", encoding="utf-8") as f:
        json.dump({"characters": BENCH_CHARS[:-1], "line_px_height": CROP_H,
                   "checkpoint": "recognizer.pt"}, f)
    for name, (options, stages) in [("fast", ("", ""))] + list(TS_INIS.items()):
        with open(os.path.join(tmp, f"{name}.ini"), "w", encoding="utf-8") as f:
            f.write(TS_INI.format(options=options, stages=stages))
    log(f"archives traced on the CPU: the detector ({sum(p.numel() for p in det.parameters())} "
        f"float32 weights), the recognizer ({sum(p.numel() for p in rec.parameters())})")
    return det, rec


def near_ties(model_a, model_b, images: torch.Tensor) -> list:
    """For each of ``images`` (a line each, NHWC in [0, 1]) whose labels
    two recognizers give apart: whether every frame whose argmax
    differs is a near-tie, ``model_b``'s two best logits closer than
    twice the two models' largest logit difference on the line."""
    with torch.inference_mode():
        a = model_a(images).float().cpu().numpy()
        b = model_b(images).float().cpu().numpy()
    out = []
    for la, lb in zip(a, b):
        frames = np.flatnonzero(la.argmax(-1) != lb.argmax(-1))
        top2 = np.sort(lb[frames], axis=-1)[:, -2:]
        out.append(bool(len(frames)) and bool(
            (top2[:, 1] - top2[:, 0] <= 2 * np.abs(la - lb).max()).all()))
    return out


def ts_fast_path(tmp: str, det, rec, rng, smi: str, device: str):
    """The fast path with both archives on the page transport (config 2's
    command-line settings, 8 pages a batch), the archives' stage A and
    stage B held against the native float32 modules on the same inputs,
    one batch run three times."""
    parser = staged_parser(os.path.join(tmp, "fast.ini"), device)
    wrapper, engine = parser.layout_parsers[0].engine.parsenet, parser.ocr.ocr_engine
    if not (isinstance(wrapper.model, TSParseNetModel) and isinstance(engine.model,
                                                                       TSRecognizerModel)):
        raise AssertionError("torchscript: the config did not load the archives")
    traced = ts_adapters.device_constants(
        torch.jit.load(os.path.join(tmp, "recognizer.pt"), map_location="cpu"))
    loaded = ts_adapters.device_constants(engine.model.archive)
    on_device = {p.device.type for m in (wrapper.model, engine.model) for p in m.parameters()}
    log(f"torchscript: the recognizer archive's Device constants {sorted(set(traced))} as "
        f"traced, {sorted(set(loaded))} as loaded for {device}; parameters on {on_device}; "
        f"spec {engine.spec}")
    if "cpu" not in traced or set(loaded) != {device} or on_device != {device}:
        raise AssertionError("torchscript: the archives do not run on the device")
    fast = FastPagePipeline.from_page_parser(parser, page_batch=PAGE_BATCH)
    pipe = fast.pipeline
    native_pipe = TorchPagePipeline(
        det, rec, crop_height=pipe.crop_height, crop_bucket=pipe.crop_bucket,
        detection_threshold=pipe.detection_threshold, line_end_weight=pipe.line_end_weight,
        device=device)
    pages, lines = synthetic_pages(rng, TS_PAGES, TWO_COLUMNS)
    ids = [f"t{i:04d}" for i in range(len(pages))]
    recorded, stage_a_in = [], []
    stage_b, stage_a = pipe.stage_b, pipe.stage_a

    def kept_stage_b(*b_args):
        out = stage_b(*b_args)
        recorded.append((b_args, [t.cpu() for t in out[:3]]))
        return out

    def kept_stage_a(pages_u8, ds_run):
        stage_a_in[:] = [(pages_u8, ds_run)]
        return stage_a(pages_u8, ds_run)

    pipe.stage_b, pipe.stage_a = kept_stage_b, kept_stage_a

    def drive(n):
        out = []
        t0 = time.perf_counter()
        for layout in fast.process_pages(pages[:n], ids[:n]):
            with timing.stage_timer("document/pagexml"):
                out.append((layout, layout.to_pagexml_string()))
        if device == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    drive(PAGE_BATCH)  # warm-up: cuDNN plans, the kernel's first load
    recorded.clear()
    timing.reset_timing()
    warp_ops.warp_lines.launches = 0
    out, seconds = drive(len(pages))
    launches = warp_ops.warp_lines.launches
    pipe.stage_b, pipe.stage_a = stage_b, stage_a
    n_lines = sum(len(list(layout.lines_iterator())) for layout, _ in out)
    recall = line_recall([[ln.baseline for ln in layout.lines_iterator()] for layout, _ in out],
                         lines)
    log(f"torchscript fast path (page transport, both archives): {len(pages)} pages, "
        f"{n_lines} lines, line recall {recall:.3f}; {len(pages) / seconds:.3f} pages/s to Page "
        f"XML ({seconds:.3f} s) on {smi}; warp_lines launches {launches}, stage-B batches "
        f"{len(recorded)}")
    log("stage times (torchscript fast path):\n" + timing.timing_report())
    if recall < MIN_LINE_RECALL or launches != (len(recorded) if device == "cuda" else 0):
        raise AssertionError("torchscript fast path: lines lost or launches != batches")

    # Stage B: the archive's labels against the native modules' on the
    # same pages and lines, near-ties counted apart.
    n_real = n_equal = n_ties = 0
    for (pages_u8, bl, hh), (labels, lengths, confs) in recorded:
        want = [t.cpu() for t in native_pipe.stage_b(pages_u8, bl, hh)[:3]]
        real = (bl.reshape(len(hh.reshape(-1, 2)), -1).abs().sum(dim=1) > 0).cpu()  # padding: 0
        equal = (labels == want[0]).reshape(len(real), -1).all(dim=1) & (
            lengths == want[1]).reshape(-1)
        differ = torch.nonzero(real & ~equal).reshape(-1)
        if len(differ):
            crops = warp_ops.warp_lines(pages_u8, bl, hh, pipe.crop_height, pipe.crop_bucket,
                                        out_dtype=torch.float32, normalize=True)
            images = crops.reshape(-1, *crops.shape[-2:])[differ.to(crops.device)]
            n_ties += sum(near_ties(pipe.recognizer, native_pipe.recognizer,
                                    images[..., None].expand(-1, -1, -1, 3)))
        n_real += int(real.sum())
        n_equal += int((real & equal).sum())
    pages_u8, bl, hh = recorded[-1][0]
    runs = [[t.cpu() for t in pipe.stage_b(pages_u8, bl, hh)[:3]] for _ in range(3)]
    repeat_equal = all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))
    # The archives run under TorchScript's default (profiling) executor;
    # the same batch with its optimizations off: labels and stage B's time.
    if device == "cuda":
        with torch.jit.optimized_execution(False):
            unoptimized = [t.cpu() for t in pipe.stage_b(pages_u8, bl, hh)[:3]]
            executor_off_ms = cuda_ms(lambda: pipe.stage_b(pages_u8, bl, hh), reps=5,
                                      warmup=1, ahead=False)
        executor_on_ms = cuda_ms(lambda: pipe.stage_b(pages_u8, bl, hh), reps=5, warmup=1,
                                 ahead=False)
        executor = {"stage_b_ms_default_executor": executor_on_ms,
                    "stage_b_ms_executor_off": executor_off_ms,
                    "executor_off_labels_equal": bool(
                        torch.equal(unoptimized[0], runs[0][0])
                        and torch.equal(unoptimized[1], runs[0][1]))}
        log(f"torchscript stage B on one batch: {executor_on_ms:.3f} ms under the default "
            f"executor, {executor_off_ms:.3f} ms with its optimizations off; labels "
            f"{'equal' if executor['executor_off_labels_equal'] else 'apart'} on {smi}")
    else:
        executor = {}
    pages_a, ds_a = stage_a_in[0]
    masks = [np.unpackbits(p.stage_a(pages_a, ds_a)[0].cpu().numpy(), bitorder="little")
             for p in (pipe, native_pipe)]
    flips = int((masks[0] != masks[1]).sum())
    log(f"torchscript vs native float32 modules: labels equal on {n_equal} of {n_real} lines, "
        f"{n_ties} near-ties; one batch three times: {'equal' if repeat_equal else 'DIFFERS'}; "
        f"stage A's last batch at ds {ds_a}: {flips} of {int(masks[1].sum())} mask pixels apart")
    if n_equal + n_ties != n_real or not repeat_equal or flips > TS_MASK_FLIPS * masks[1].sum():
        raise AssertionError("torchscript fast path: the archives differ from the native modules")
    numbers = {"pages": len(pages), "pages_per_s": len(pages) / seconds, "lines": n_lines,
               "line_recall": recall, "warp_lines_launches": launches,
               "labels_equal": n_equal, "near_ties": n_ties, "lines_compared": n_real,
               "repeat_equal": repeat_equal, "stage_a_mask_flips": flips, **executor,
               "card": smi}
    return launches, numbers, (pages_u8, bl, hh, pipe.crop_height, pipe.crop_bucket)


def page_lines(xml: str):
    """A Page XML's lines in document order as (id, text, conf); a line
    without a TextEquiv has text None, one without a conf conf 0."""
    out = []
    for line in ET.fromstring(xml.encode("utf-8")).iter(f"{PAGE_NS}TextLine"):
        equiv = line.find(f"{PAGE_NS}TextEquiv")
        if equiv is None:
            out.append((line.get("id"), None, 0.0))
            continue
        out.append((line.get("id"), equiv.find(f"{PAGE_NS}Unicode").text or "",
                    float(equiv.get("conf", 0.0))))
    return out


def sparse_near_tie(card, cpu) -> bool:
    """Whether two recognitions of one line (the engines' sparse (T, C)
    logits: entries of probability below 1e-4 dropped) differ only at
    near-ties: every frame whose argmax differs has the CPU's two best
    logits closer than twice the largest difference of the logits both
    kept."""
    kept = [(m != 0).toarray() for m in (card, cpu)]
    a, b = (np.where(k, m.toarray(), -np.inf) for k, m in zip(kept, (card, cpu)))
    frames = np.flatnonzero(a.argmax(-1) != b.argmax(-1))
    both = kept[0] & kept[1]
    top2 = np.sort(b[frames], axis=-1)[:, -2:]
    return bool(len(frames)) and bool(
        (top2[:, 1] - top2[:, 0] <= 2 * np.abs(a - b)[both].max(initial=0.0)).all())


def ts_staged(tmp: str, name: str, pages, ids, smi: str, device: str):
    """ini ``name`` stage by stage on the device, then the first
    TS_CPU_PAGES pages on the CPU from the device's ParseNet and
    OrientationNet maps, both in float32 with TF32 off: their Page XML
    equal apart from the texts, every line's crop equal, and each line's
    text equal (conf within 0.0015) or apart only at near-ties of the
    recognizer archive's logits (sparse_near_tie).  Returns (the device
    run's layouts and XML, numbers, the device parser, wall seconds by
    part)."""
    ini = os.path.join(tmp, f"{name}.ini")
    parsers = {d: staged_parser(ini, d) for d in (device, "cpu")}
    card = parsers[device]
    maps, replay = [], []

    def wrap(obj, recording):
        own = obj.get_maps

        def get_maps(img, ds):
            if recording:
                maps.append(own(img, ds))
                return maps[-1]
            return replay.pop(0)

        obj.get_maps = get_maps

    for d, parser in parsers.items():
        recording = d == device
        wrap(parser.layout_parsers[0].engine.parsenet, recording)
        for lp in parser.layout_parsers[1:]:
            if getattr(lp, "filter_directions", False):
                wrap(lp.engine.tiltnet, recording)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    wall = {}
    try:
        t0 = time.perf_counter()
        warm = pages[-1]
        card.process_page(warm, PageLayout(id="warm", page_size=warm.shape[:2]))
        card.layout_parsers[0].engine.parsenet.last_downsample = \
            card.layout_parsers[0].engine.parsenet.init_downsample
        maps.clear()
        wall[f"ini_{name}_warm_up"] = time.perf_counter() - t0
        timing.reset_timing()
        warp_ops.warp_fields.launches = 0
        out, seconds = staged_pages(card, ids, pages)
        launches = warp_ops.warp_fields.launches
        wall[f"ini_{name}_card"] = seconds
        stats = timing.timing_stats()
        log(f"stage times (torchscript, ini ({name}), TF32 off):\n" + timing.timing_report())
        replay[:] = maps
        t0 = time.perf_counter()
        cpu_out, _ = staged_pages(parsers["cpu"], ids[:TS_CPU_PAGES], pages[:TS_CPU_PAGES])
        wall[f"ini_{name}_cpu_replay"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    no_text = re.compile(r"\s*<TextEquiv[^>]*>.*?</TextEquiv>", re.S)
    n_compared = n_equal = n_ties = 0
    conf_err = 0.0
    for (layout, xml), (cpu_layout, cpu_xml) in zip(out, cpu_out):
        if mask_pagexml(no_text.sub("", xml)) != mask_pagexml(no_text.sub("", cpu_xml)):
            diff = difflib.unified_diff(no_text.sub("", cpu_xml).splitlines(),
                                        no_text.sub("", xml).splitlines(), "cpu", "card",
                                        lineterm="")
            log("\n".join(list(diff)[:60]))
            raise AssertionError(f"torchscript ini ({name}): the layouts differ from the CPU's")
        logits = {}
        for a, b in zip(layout.lines_iterator(), cpu_layout.lines_iterator()):
            if not np.array_equal(a.crop, b.crop):
                raise AssertionError(f"torchscript ini ({name}): line {a.id}'s crop differs")
            logits[a.id] = (a.logits, b.logits)
        for (line_id, text, conf), (_, cpu_text, cpu_conf) in zip(page_lines(xml),
                                                                   page_lines(cpu_xml)):
            n_compared += 1
            if text == cpu_text:
                n_equal += 1
                conf_err = max(conf_err, abs(conf - cpu_conf))
            elif sparse_near_tie(*logits[line_id]):
                n_ties += 1
                log(f"torchscript ini ({name}): line {line_id} reads {text!r} on the card, "
                    f"{cpu_text!r} on the CPU: a near-tie")
            else:
                raise AssertionError(f"torchscript ini ({name}): line {line_id}'s text "
                                     f"{text!r} differs from the CPU's {cpu_text!r}")
    if conf_err > 0.0015:
        raise AssertionError(f"torchscript ini ({name}): confidences {conf_err} apart")
    n_lines = sum(len(list(layout.lines_iterator())) for layout, _ in out)
    batched = sum(len(list(layout.lines_iterator())) >= card.line_cropper.DEVICE_BATCH_MIN
                  for layout, _ in out)
    regions = sum(len(layout.regions) for layout, _ in out)
    log(f"torchscript ini ({name}) stage by stage (float32, TF32 off): {len(pages)} pages, "
        f"{n_lines} lines, {regions} regions, {len(pages) / seconds:.3f} pages/s to Page XML "
        f"({seconds:.3f} s) on {smi}; the CPU from the card's maps: {len(cpu_out)} pages' "
        f"layouts and crops equal, texts equal on {n_equal} of {n_compared} lines, "
        f"{n_ties} near-ties, confidences within {conf_err:.3g}; warp_fields launches "
        f"{launches}, pages of {card.line_cropper.DEVICE_BATCH_MIN} lines or more {batched}")
    if launches != (batched if device == "cuda" else 0) or n_lines < 10 * len(pages):
        raise AssertionError(f"torchscript ini ({name}): launches or lines off")
    numbers = {"pages": len(pages), "pages_per_s": len(pages) / seconds, "lines": n_lines,
               "regions": regions, "cpu_pages_equal": len(cpu_out),
               "cpu_lines_compared": n_compared, "cpu_texts_equal": n_equal,
               "cpu_near_ties": n_ties, "cpu_conf_max_diff": conf_err,
               "warp_fields_launches": launches,
               "stage_ms": {k: 1e3 * stats[k][0] / stats[k][1] for k in TS_STAGE_TIMERS
                            if k in stats},
               "stage_calls": {k: stats[k][1] for k in TS_STAGE_TIMERS if k in stats},
               "card": smi}
    return out, numbers, card, wall


def run_torchscript(rng, smi: str, device: str = "cuda"):
    """The reference's model format on the card: both archives traced on
    the CPU (write_archives) and loaded for ``device`` by the config's
    MODEL_PATH and the OCR JSON's checkpoint.  The fast path on 16
    two-column pages (ts_fast_path); stage by stage on 4 others under
    ini (a) (MULTI_ORIENTATION, MERGE_LINES, ADJUST_BASELINES, then
    LINE_FILTER, LINE_POSTPROCESSING, LAYOUT_POSTPROCESSING and
    REGION_SORTER_NAIVE) and ini (b) (DETECT_STRAIGHT_LINES_IN_REGIONS)
    against the CPU (ts_staged); the command line on TS_CLI_PAGES pages
    with ini (a), its files equal to the in-process run's.  ``device`` "cpu"
    rehearses the phase with the plain versions and no kernel checks.
    Returns (warp_lines launches, warp_fields launches by ini, numbers,
    the last fast batch's warp arguments, ini (a)'s last page buckets)."""
    numbers, wall = {}, {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="torchscript_") as tmp:
        det, rec = write_archives(tmp)
        wall["trace_archives"] = time.perf_counter() - t_phase
        t0 = time.perf_counter()
        launches, numbers["fast"], fast_args = ts_fast_path(tmp, det, rec, rng, smi, device)
        wall["fast_path"] = time.perf_counter() - t0
        pages, _ = synthetic_pages(rng, TS_STAGED_DRAWN, TWO_COLUMNS)
        pages = [np.ascontiguousarray(p[:TS_STAGED_ROWS]) for p in pages[:TS_STAGED_PAGES]]
        ids = [f"s{i:04d}" for i in range(len(pages))]
        staged = {}
        for name in TS_INIS:
            t0 = time.perf_counter()
            staged[name] = ts_staged(tmp, name, pages, ids, smi, device)
            numbers[f"ini_{name}"] = staged[name][1]
            wall.update(staged[name][3])
            wall[f"ini_{name}"] = time.perf_counter() - t0
        out_a, _, parser_a, _ = staged["a"]
        last_page = page_buckets(parser_a, out_a[-1][0], pages[-1]) if device == "cuda" else None

        # The command line on the first pages with ini (a), TF32 off as
        # in the in-process run.
        images = write_pages(tmp, dict(zip(ids[:TS_CLI_PAGES], pages[:TS_CLI_PAGES])))
        out_dir = os.path.join(tmp, "page_xml")
        _, cli_seconds = run_parse_folder(
            ["-c", os.path.join(tmp, "a.ini"), "-i", images, "--output-xml-path", out_dir,
             "--timing-report", "--device", device], "command line (torchscript, ini (a))",
            NO_TF32_CLI)
        differ = []
        for pid, (_, xml) in zip(ids[:TS_CLI_PAGES], out_a):
            with open(os.path.join(out_dir, pid + ".xml"), encoding="utf-8") as f:
                if not same_staged_page(f.read(), xml):
                    differ.append(pid)
        log(f"torchscript command line vs in-process: {TS_CLI_PAGES - len(differ)} of "
            f"{TS_CLI_PAGES} files equal (lines of a row as a set; conf within 0.0015)")
        if differ:
            raise AssertionError(f"the torchscript command line's files differ: {differ}")
        numbers["cli_wall_s"] = wall["command_line"] = cli_seconds
    wall["phase"] = time.perf_counter() - t_phase
    numbers["wall_s"] = wall
    log("torchscript phase, wall seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in wall.items()))
    fields = {name: staged[name][1]["warp_fields_launches"] for name in TS_INIS}
    return launches, fields, numbers, fast_args, last_page


# ----------------------------------------------------------------------
# The host C++ (csrc/perotpu.cpp) against its numpy twins
FAST_STAGES = ("pipeline/host_geometry", "pipeline/cc_parse",
               "pipeline/make_clusters", "pipeline/textlines", "pipeline/stage_a_sync", "pipeline/upload+dispatch_a", "pipeline/stage_b",
               "document/assemble", "document/pagexml")
STAGED_HOST_STAGES = ("layout", "parsenet_maps", "map_postprocess", "paragraph_clustering",
                      "region_polygons", "line_crop", "ocr")
HOST_FUNCTIONS = {  # binding: (C++ function, its line in the JAX package's native/perotpu.cpp)
    "native_label": ("cc_label_u8", 46),
    "native_cc_baselines": ("cc_baselines_f32", 317),
    "native_separator_penalties": ("separator_penalties_f32", 405),
    "native_polygons_close": ("polygons_close_f64", 512),
    "native_cc_lines_packed": ("cc_lines_packed", 613),
    "native_viterbi_ctc": ("viterbi_ctc_f32", 539),
}
HOST_REPEATS = 9


def route_numbers(n_pages: int, seconds: float, stats: dict, stages) -> dict:
    """pages/s and each stage's ms a call and calls, of one run."""
    return {"pages_per_s": n_pages / seconds, "seconds": seconds,
            "stage_ms": {k: 1e3 * stats[k][0] / stats[k][1] for k in stages if k in stats},
            "stage_calls": {k: stats[k][1] for k in stages if k in stats}}


def route_ab(runs, stages, smi: str, label: str, host_calls: dict) -> dict:
    """The host-route A/B's record from its runs in order, each
    (route, [(layout, xml)], seconds, stage stats): every run's numbers
    and whether its Page XML equals the first run's on every page."""
    first = runs[0][1]
    record = {"order": [r[0] for r in runs], "pages": len(first), "host_calls": host_calls,
              "runs": [], "page_xml_equal": []}
    for route, out, seconds, stats in runs:
        record["runs"].append({"route": route, **route_numbers(len(out), seconds, stats, stages)})
        same = [mask_pagexml(a) == mask_pagexml(b) for (_, a), (_, b) in zip(first, out)]
        record["page_xml_equal"].append(sum(same))
        if not all(same):
            page = same.index(False)
            diff = difflib.unified_diff(mask_pagexml(first[page][1]).splitlines(),
                                        mask_pagexml(out[page][1]).splitlines(),
                                        "run 1", route, lineterm="")
            log("\n".join(list(diff)[:60]))
            raise AssertionError(f"{label}: the {route} run's Page XML differs on page {page}")
    log(f"{label} host-route A/B on {smi}, in the order run: " + ", ".join(
        f"{r['route']} {r['pages_per_s']:.3f} pages/s" for r in record["runs"])
        + f"; Page XML equal on {record['page_xml_equal']} of {len(first)} pages; host calls "
        f"in the first C++ run {host_calls}")
    return record


def staged_pages(parser: PageParser, ids, pages):
    """Each page through ``parser.process_page`` into Page XML, ``random``
    seeded first (it orders the lines of a row); (layouts and XML, s)."""
    random.seed(0)
    out = []
    t0 = time.perf_counter()
    for pid, page in zip(ids, pages):
        layout = parser.process_page(page, PageLayout(id=pid, page_size=page.shape[:2]))
        with timing.stage_timer("document/pagexml"):
            out.append((layout, layout.to_pagexml_string()))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class HostInputs:
    """Keeps the staged layout's host-geometry inputs a page at a time
    (a page starts at its labeling): the connected mask and the
    arguments of every pair test and penalty call."""

    def __init__(self):
        self.pages = []
        self._saved = {}

    def __enter__(self):
        label = morphology.connected_components

        def labeling(mask, route=False):
            self.pages.append({"connected": mask, "native_polygons_close": [],
                               "native_separator_penalties": []})
            return label(mask, route)

        self._saved = {(morphology, "connected_components"): label}
        morphology.connected_components = labeling
        for name in ("native_polygons_close", "native_separator_penalties"):
            fn = getattr(native, name)
            self._saved[(native, name)] = fn

            def kept(*args, fn=fn, name=name):
                self.pages[-1][name].append(args)
                return fn(*args)

            setattr(native, name, kept)
        return self

    def __exit__(self, *exc):
        for (module, name), fn in self._saved.items():
            setattr(module, name, fn)
        return False


def host_ms(fn, repeats: int = HOST_REPEATS) -> float:
    """Median host wall time of ``fn`` in ms, after one warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _lines_differ(a, b) -> int:
    """0 when two (baselines, heights) lists are equal, else 1."""
    (ab, ah), (bb, bh) = a, b
    return int(len(ab) != len(bb) or ah != bh
               or any(not np.array_equal(x, y) for x, y in zip(ab, bb)))


def viterbi_path(fn, costs: np.ndarray, skip: np.ndarray):
    """``fn``'s Viterbi path, or None where no path has a finite cost."""
    try:
        return fn(costs, skip)
    except ValueError:
        return None


def path_cost(costs: np.ndarray, path: np.ndarray) -> float:
    """A Viterbi path's cost, summed in float64."""
    return float(costs[np.arange(len(path)), path].astype(np.float64).sum())


def check_host_native(fast: dict, staged: dict, viterbi, smi: str) -> dict:
    """Every C++ function of the host library against its numpy twin on
    the card run's own inputs (config 2's last fast-path batch: its
    packed masks, heights and separator, its lines and clusters; the
    staged run's last page: its connected mask and its close pairs;
    ``viterbi``: the forced alignments of config 5's ALTO output), with
    0 differences allowed, and each timed on both routes (host median of
    HOST_REPEATS).  Two Viterbi paths that differ count as a tie, not a
    difference, when their float64 costs lie within the float32 sums'
    rounding (T * 2**-23 of the cost).  Returns the ``host_native``
    record."""
    pipe, numpy_pipe = fast["pipe"], fast["numpy_pipe"]
    (packed, heights_q, sep_q), ds, page_lines = fast["stage_a"], fast["ds"], fast["page_lines"]
    pages = range(len(page_lines))
    hf = packed.shape[1] // heights_q.shape[1]
    masks, connecteds, heights_maps, sep_pooled = numpy_pipe._unpack_stage_a(
        packed, heights_q, sep_q)
    sep_pool = masks.shape[1] // sep_pooled.shape[1]
    record = {}

    def compare(name, inputs, differences, native_fn, numpy_fn):
        cpp, line = HOST_FUNCTIONS[name]
        record[cpp] = {"differences": differences, "inputs": inputs,
                       "native_ms": host_ms(native_fn), "numpy_ms": host_ms(numpy_fn),
                       "source": "pero_ocr_tpu_torch/csrc/perotpu.cpp",
                       "replaces": f"native/perotpu.cpp:{line}"}
        log(f"host {cpp} on {inputs}: {differences} differences from its numpy twin; "
            f"{record[cpp]['native_ms']:.4f} ms C++, {record[cpp]['numpy_ms']:.4f} ms numpy")

    # cc_lines_packed (the JAX crop transport's parse; the page transport
    # labels the unpacked mask): lines, set-bit counts and histograms of
    # each page, against unpacking, dilation, labeling and the numpy
    # parse.  The page transport's own lines must equal the numpy parse.
    def packed_native():
        return [native.native_cc_lines_packed(packed[s], heights_q[s], hf) for s in pages]

    def packed_numpy():
        m, c, h, _ = numpy_pipe._unpack_stage_a(packed, heights_q, sep_q)
        return [numpy_pipe._lines_from_masks(m[s], c[s], h[s], ds) for s in pages]

    got, want = packed_native(), packed_numpy()
    q0 = heights_q[..., 0].repeat(hf, axis=1).repeat(hf, axis=2)
    diff = 0
    for s in pages:
        sel = masks[s] > 0
        pts, npts, hts, n = got[s][:4]
        diff += _lines_differ(([ds * pts[c, : npts[c]] for c in range(n)],
                               [[ds * float(hts[c, 0]), ds * float(hts[c, 1])] for c in range(n)]),
                              want[s])
        diff += _lines_differ(page_lines[s][:2], want[s])
        diff += int(got[s][4] != int(sel.sum()))
        diff += int(not np.array_equal(got[s][5], np.bincount(q0[s][sel], minlength=256)))
    compare("native_cc_lines_packed", f"config 2's last batch, {len(pages)} pages", diff,
            packed_native, packed_numpy)

    # cc_label_u8 on the batch's connected masks and the staged page's.
    connected = [connecteds[s] for s in pages] + [staged["inputs"]["connected"]]
    diff = 0
    for c in connected:
        a, b = (morphology.connected_components(c, route) for route in (True, False))
        diff += int(a[1] != b[1] or not np.array_equal(a[0], b[0]))
    compare("native_label", f"{len(connected)} connected masks (the batch's, the staged "
            "page's)", diff,
            lambda: [morphology.connected_components(c, True) for c in connected],
            lambda: [morphology.connected_components(c, False) for c in connected])

    # cc_baselines_f32 on the batch's labels.
    labelled = []
    for s in pages:
        labels, num = morphology.connected_components(connecteds[s], False)
        labelled.append((labels * masks[s], num, heights_maps[s]))
    diff = sum(_lines_differ(pipe._component_lines(*x, ds), numpy_pipe._component_lines(*x, ds))
               for x in labelled)
    compare("native_cc_baselines", f"config 2's last batch, {len(pages)} pages", diff,
            lambda: [pipe._component_lines(*x, ds) for x in labelled],
            lambda: [numpy_pipe._component_lines(*x, ds) for x in labelled])

    # The clustering's pair tests and penalties: the batch's pages
    # clustered again with their inputs kept, and the staged page's.
    with HostInputs() as kept:
        kept.pages.append({"connected": None, "native_polygons_close": [],
                           "native_separator_penalties": []})
        clusters = [pipe._cluster_lines(b, h, sep_pooled[s], ds, sep_pool)[0]
                    for s, (b, h, _, _) in enumerate(page_lines)]
    diff_clusters = sum(c != p[2] for c, p in zip(clusters, page_lines))
    for name, twin in (("native_polygons_close", geometry.polygons_close),
                       ("native_separator_penalties", separator_penalties)):
        calls = kept.pages[0][name] + staged["inputs"][name]
        fn = getattr(native, name)
        diff = diff_clusters + sum(int(not np.array_equal(fn(*args), twin(*args)))
                                   for args in calls)
        n = sum(len(args[1] if name == "native_polygons_close" else args[3]) for args in calls)
        compare(name, f"{len(calls)} calls ({len(kept.pages[0][name])} of the batch's pages, "
                f"{len(staged['inputs'][name])} of the staged page), {n} pairs or queries",
                diff, lambda fn=fn, calls=calls: [fn(*args) for args in calls],
                lambda twin=twin, calls=calls: [twin(*args) for args in calls])

    # viterbi_ctc_f32: float32 sums against numpy's float64 sums; a line
    # too short for its text has no path on either route.
    diff = ties = no_path = 0
    for costs, skip in viterbi:
        a, b = viterbi_path(native.native_viterbi_ctc, costs, skip), viterbi_path(
            viterbi_ctc, costs, skip)
        if a is None or b is None:
            no_path += a is None and b is None
            diff += (a is None) != (b is None)
        elif not np.array_equal(a, b):
            ca, cb = path_cost(costs, a), path_cost(costs, b)
            if abs(ca - cb) <= len(costs) * 2.0 ** -23 * max(abs(ca), abs(cb)):
                ties += 1
            else:
                diff += 1
    aligned = [x for x in viterbi if viterbi_path(viterbi_ctc, *x) is not None]
    frames = sum(len(c) for c, _ in aligned)
    compare("native_viterbi_ctc", f"{len(viterbi)} lines of config 5's ALTO output ({no_path} "
            f"without a path on both routes; timed on the other {len(aligned)}, {frames} "
            "frames)", diff, lambda: [native.native_viterbi_ctc(*x) for x in aligned],
            lambda: [viterbi_ctc(*x) for x in aligned])
    record["viterbi_ctc_f32"].update(ties=ties, no_path=no_path)
    log(f"host viterbi_ctc_f32: {ties} of {len(aligned)} paths differ from numpy's at a tie "
        "within float32 rounding")

    bad = {k: v["differences"] for k, v in record.items() if v["differences"]}
    if bad:
        raise AssertionError(f"host C++ differs from its numpy twins: {bad}")
    return {"card": smi, "repeats": HOST_REPEATS, "functions": record,
            "fast_path": fast["ab"], "staged": staged["ab"]}


# ----------------------------------------------------------------------
# Training on the card (run_train): the five trainers of
# pero_ocr_tpu_torch/parallel/train.py at full width.
TRAIN_DEVICE = "cuda"
TRAIN_STEPS = 30  # learning steps a trainer (warm-up steps included)
TRAIN_WARM = 3    # steps before the timed ones
# The first step, card against CPU, the same weights and batch, TF32
# off, with a float64 witness: the same step in float64 on the CPU and
# on the card.  Gradients are compared leaf by leaf in units of the
# leaf's largest float64 gradient (at least GRAD_FLOOR of the largest
# of all); a trainer's error is its worst leaf's.
# - the loss, card against CPU in float32: LOSS_RTOL relative, the
#   CPU-to-JAX tolerance of tests/test_torch_train.py;
# - the card computes the CPU's function: its float64 loss and
#   gradients within F64_REL of the CPU's;
# - the card's float32 gradients are as close to the float64 ones as
#   the CPU's float32 gradients are: within GRAD_REL (the CPU-to-JAX
#   1e-4) or F32_RATIO times the CPU's own error, whichever is larger.
#   A leaf whose exact gradient is ~0 (a conv bias under GroupNorm)
#   takes float32 rounding from both devices alike.
GRAD_FLOOR = 1e-5
LOSS_RTOL = 1e-5
F64_REL = 1e-9
GRAD_REL, F32_RATIO = 1e-4, 2.0
STEP_ATOL_LR = 0.01  # a weight's card-CPU difference after the first step beyond
                     # what its gradients' difference explains, in units of lr
# The trainers' models and batches: bench.py's recognizer, this
# script's detector, and OrientationNet, TransformerSpec and CharLMSpec
# at their defaults.
TRAIN_REC = dict(num_classes=80, line_height=32, conv_features=(48, 96, 192, 384),
                 subsampling=4, lstm_layers=2, lstm_features=256, stem="s2d", norm="group")
REC_BATCH, REC_WIDTH, REC_MAX_LABEL = 64, 768, 40
# The recognizer's lines: REC_GLYPHS seeded glyphs 12 to 20 px wide (3
# to 5 frames at subsampling 4, as bench's printed characters).  Its
# learning run, bench.py's recipe: curriculum steps on crops of 2 to 10
# glyphs, REC_CUR_WIDTH wide, until the mean of the last 25 losses is
# under REC_CUR_STOP (bench's 1.0; the blank plateau of such crops is
# ~20), which must happen within REC_CUR_STEPS, then TRAIN_STEPS steps
# on the full lines.  (On 79 glyphs of 6 to 14 px the loss stays on the
# plateau for 600 curriculum steps: PERF.md.)
REC_GLYPHS = 20
REC_CUR_WIDTH, REC_CUR_STEPS, REC_CUR_STOP = 256, 1000, 1.0
TRAIN_PN = dict(base_features=32, depth=4, stem="s2d", out_upsample=2)
PN_PAGES, PN_BATCH = 8, 4
TRAIN_ORIENTATION = dict(base_features=16, depth=3)
TILES, TILE = 8, 256
TRAIN_TF = dict(num_classes=80)
TF_BATCH, TF_WIDTH = 16, 768
TRAIN_LM = dict(vocab_size=80)
LM_BATCH, LM_LENGTH = 64, 128


def glyph_bank(rng, classes: int, height: int, widths=(6, 14)):
    """One seeded random bitmap a class (1 = ink), ``height`` rows,
    ``widths`` columns (inclusive), the ink between a fifth and four
    fifths of the rows."""
    bank = []
    for _ in range(classes):
        g = np.zeros((height, int(rng.integers(widths[0], widths[1] + 1))), bool)
        top, bottom = height // 5, height - height // 5
        g[top:bottom] = rng.random((bottom - top, g.shape[1])) < 0.45
        bank.append(g)
    return bank


def glyph_lines(rng, bank, n: int, height: int, width: int, max_len: int,
                min_len: Optional[int] = None):
    """n lines of random glyph strings (ink 0.1 on 0.9, RGB in [0, 1]),
    their labels (n, max_len) and lengths: each line starts 8 px in and
    stops before ``width``, after ``max_len`` glyphs, or, given
    ``min_len``, after a number drawn from [min_len, max_len]."""
    images = np.full((n, height, width, 3), 0.9, np.float32)
    labels = np.zeros((n, max_len), np.int64)
    lengths = np.zeros(n, np.int64)
    for i in range(n):
        x, k = 8, 0
        cap = max_len if min_len is None else int(rng.integers(min_len, max_len + 1))
        while k < cap:
            c = int(rng.integers(0, len(bank)))
            g = bank[c]
            if x + g.shape[1] > width - 4:
                break
            images[i, :, x:x + g.shape[1]][g] = 0.1
            labels[i, k] = c
            x += g.shape[1] + int(rng.integers(2, 5))
            k += 1
        lengths[i] = k
    return images, labels, lengths


def greedy_cer(logits: torch.Tensor, labels, lengths) -> float:
    """Greedy CTC decode (blank last) against the labels: edit distance
    over label characters."""
    from pero_ocr_tpu_torch.sequence_alignment import levenshtein_distance

    best = logits.argmax(-1).cpu().numpy()
    blank = logits.shape[-1] - 1
    errors = 0
    for row, lab, n in zip(best, labels, lengths):
        keep = np.concatenate([[True], row[1:] != row[:-1]]) & (row != blank)
        errors += levenshtein_distance(list(row[keep]), list(lab[:n]))
    return errors / float(np.sum(lengths))


def area_canvas(gray: np.ndarray, factor: int) -> np.ndarray:
    """cv2.resize(INTER_AREA) by an integer factor (block means), padded
    with zeros to multiples of 64, as bench.py's ParseNet trainer does."""
    h, w = gray.shape[0] // factor, gray.shape[1] // factor
    small = gray[:h * factor, :w * factor].reshape(h, factor, w, factor).mean((1, 3))
    canvas = np.zeros((-(-h // 64) * 64, -(-w // 64) * 64), np.float32)
    canvas[:h, :w] = np.round(small)
    return canvas


def parsenet_batch(pages, lines, ds: int, up: int = 2):
    """bench.py's ``scale_batch`` (:207-259) without cv2: canvases at
    map scale ``ds`` (canvas scale ds * up) and the targets painted from
    the pages' known lines, aligned to up-blocks."""
    images, targets = [], []
    for page, (baselines, heights) in zip(pages, lines):
        canvas = area_canvas(page[:, :, 0].astype(np.float32), ds * up)
        tgt = np.zeros((canvas.shape[0] * up, canvas.shape[1] * up, 5), np.float32)
        for b, (asc, desc) in zip(baselines, heights):
            y = int(b[0][1]) // ds
            x0, x1 = int(b[0][0]) // ds, int(b[1][0]) // ds
            ya = (y // up) * up
            xa0, xa1 = (x0 // up) * up, ((x1 + up - 1) // up) * up
            tgt[ya:ya + up, xa0:xa1, 2] = 1.0
            y0 = (max(y - int(asc // ds), 0) // up) * up
            tgt[y0:ya + up, xa0:xa1, 0] = asc / ds
            tgt[y0:ya + up, xa0:xa1, 1] = desc / ds
            tgt[ya:ya + up, xa0:xa0 + up, 3] = 1.0
            tgt[ya:ya + up, xa1 - up:xa1, 3] = 1.0
        images.append(np.repeat(canvas[:, :, None], 3, 2) / 255.0)
        targets.append(tgt)
    return np.stack(images).astype(np.float32), np.stack(targets)


def orientation_tiles(rng, n: int, size: int = 256):
    """n tiles of parallel dark text bands at a random angle each
    (+-45 degrees) on grainy paper, the unit direction of the bands
    inside them, and the band mask."""
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    images = np.full((n, size, size, 3), 0.9, np.float32)
    dirs = np.zeros((n, size, size, 2), np.float32)
    masks = np.zeros((n, size, size), np.float32)
    for i in range(n):
        a = rng.uniform(-np.pi / 4, np.pi / 4)
        across = -np.sin(a) * xx + np.cos(a) * yy + rng.uniform(0, 24)
        band = (across % 24) < 10
        images[i][band] = 0.15
        # Paper grain: on flat tiles whole GroupNorm groups are nearly
        # constant and their normalization magnifies float32 rounding
        # (the CPU's float32 directions off float64's by 7e-4 of their
        # largest; 1.7e-5 with the grain).
        images[i] += rng.normal(0, 0.03, (size, size, 1)).astype(np.float32)
        dirs[i] = (np.cos(a), np.sin(a))
        masks[i] = band
    return images, dirs, masks


def lm_corpus(rng, n: int, length: int, vocab: int):
    """n token sequences of ``length``: words drawn from 30 seeded random
    words over the first 20 tokens, joined by token vocab - 2."""
    words = [rng.integers(0, 20, int(rng.integers(2, 9))) for _ in range(30)]
    out = np.zeros((n, length), np.int64)
    for i in range(n):
        seq = []
        while len(seq) < length:
            seq.extend(words[int(rng.integers(0, len(words)))].tolist() + [vocab - 2])
        out[i] = seq[:length]
    return out


class Float64Casts(torch.overrides.TorchFunctionMode):
    """``Tensor.float()`` runs as ``Tensor.double()``: a float64 copy of
    a model (``float64_copy``) then keeps float64 through its float32
    casts (the heads', the LayerNorm statistics', the trainer's
    gradients)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.float:
            return args[0].double()
        return func(*args, **(kwargs or {}))


def float64_copy(model):
    """A float64 copy of ``model`` that computes in float64 under
    ``Float64Casts`` (its ``dtype`` or ``spec.dtype`` set to float64)."""
    model = copy.deepcopy(model).double()
    if isinstance(getattr(model, "dtype", None), torch.dtype):
        model.dtype = torch.float64
    if isinstance(getattr(getattr(model, "spec", None), "dtype", None), torch.dtype):
        model.spec = dataclasses.replace(model.spec, dtype=torch.float64)
    return model


def _grad_errors(grads, witness, scales):
    """Per leaf, max |grads - witness| over the leaf's scale."""
    return [float((g.double() - w).abs().max()) / s for g, w, s in zip(grads, witness, scales)]


def first_step_parity(label: str, build, make_step, batch, lr: float) -> dict:
    """One step of a trainer on the card and on the CPU from the same
    weights and batch, in float32 (TF32 off) and in float64 (see
    GRAD_REL): the float32 loss within LOSS_RTOL; the card's float64
    loss and gradients within F64_REL of the CPU's; the card's float32
    gradients within the float32 limit of the float64 ones, the global
    norm within it of the CPU's; every weight after the step within
    STEP_ATOL_LR * lr of the CPU's beyond what Adam's first update
    makes of the two gradients' difference (see below; a gradient near
    0 may take the other sign and move by up to 2 lr).  The card's
    float32 step without cuDNN is printed beside, as information."""
    initial = build()
    runs = {}
    for key, device, wide, cudnn in (("cpu", "cpu", False, True),
                                     ("card", TRAIN_DEVICE, False, True),
                                     ("cpu64", "cpu", True, True),
                                     ("card64", TRAIN_DEVICE, True, True),
                                     ("card_no_cudnn", TRAIN_DEVICE, False, False)):
        model = float64_copy(initial) if wide else copy.deepcopy(initial)
        optimizer = train.make_optimizer(lr)
        with Float64Casts() if wide else contextlib.nullcontext(), \
                torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            state = train.init_train_state(model, optimizer, device=device)
            state, loss = make_step(model, optimizer)(state, *batch)
            grads = [g.cpu() for g in train.gradients(model, state)]
        if device == TRAIN_DEVICE:
            torch.cuda.synchronize()
        runs[key] = dict(loss=float(loss), norm=float(state.opt_state.grad_norm), grads=grads,
                         weights=[w.detach().cpu() for w in state.params.values()],
                         names=list(state.params))
        del model, state, optimizer
    cpu, card, witness = runs["cpu"], runs["card"], runs["cpu64"]["grads"]
    floor = GRAD_FLOOR * max(float(g.abs().max()) for g in witness)
    scales = [max(float(g.abs().max()), floor) for g in witness]
    errors = {key: _grad_errors(runs[key]["grads"], witness, scales)
              for key in ("cpu", "card", "card64", "card_no_cudnn")}
    errors["card_vs_cpu"] = _grad_errors(card["grads"], [g.double() for g in cpu["grads"]],
                                         scales)
    rel = max(GRAD_REL, F32_RATIO * max(errors["cpu"]))
    faults = []
    if not abs(card["loss"] - cpu["loss"]) <= LOSS_RTOL * abs(cpu["loss"]):
        faults.append(f"loss {card['loss']} vs CPU {cpu['loss']}")
    loss64, loss64_card = runs["cpu64"]["loss"], runs["card64"]["loss"]
    if not abs(loss64_card - loss64) <= F64_REL * abs(loss64):
        faults.append(f"float64 loss {loss64_card} vs CPU {loss64}")
    if not abs(card["norm"] - cpu["norm"]) <= rel * cpu["norm"]:
        faults.append(f"global norm {card['norm']} vs CPU {cpu['norm']}")
    for key, limit in (("card64", F64_REL), ("card", rel)):
        for name, err in zip(cpu["names"], errors[key]):
            if not err <= limit:
                faults.append(f"{key} gradient {name} off by {err} of its scale (limit {limit})")
    # Adam's first update is g / (|g| + eps') in units of lr (eps' =
    # optax's eps on the clipped gradient, in units of the raw one), the
    # same weight decay on the same weights: two gradients a and b move
    # a weight apart by at most min(2, |a - b| / (min(|a|, |b|) + eps')).
    eps = 1e-8 * max(1.0, cpu["norm"])
    worst_excess, flips = 0.0, 0
    for name, gc, gd, wc, wd in zip(cpu["names"], cpu["grads"], card["grads"], cpu["weights"],
                                    card["weights"]):
        moved = (wd - wc).abs() / lr
        apart = torch.clamp((gd - gc).abs() / (torch.minimum(gc.abs(), gd.abs()) + eps), max=2.0)
        excess = float((moved - apart).max())
        worst_excess = max(worst_excess, excess)
        if excess > STEP_ATOL_LR:
            faults.append(f"weight {name} {excess} lr beyond its gradients' difference "
                          f"after one step (lr {lr})")
        flips += int((gc * gd < 0).sum())
    out = dict(loss_cpu=cpu["loss"], loss_card=card["loss"], loss_cpu64=runs["cpu64"]["loss"],
               loss_card64=runs["card64"]["loss"], grad_norm_cpu=cpu["norm"],
               grad_norm_card=card["norm"],
               grad_err_vs_f64={key: max(errors[key])
                                for key in ("cpu", "card", "card64", "card_no_cudnn")},
               grad_err_card_vs_cpu=max(errors["card_vs_cpu"]), grad_limit=rel,
               worst_leaf={key: cpu["names"][int(np.argmax(errors[key]))]
                           for key in ("cpu", "card", "card_no_cudnn")},
               weight_excess_lr=worst_excess, gradient_sign_flips=flips,
               weights=int(sum(w.numel() for w in cpu["weights"])))
    if faults:
        raise AssertionError(f"train {label}, first step card vs CPU: {json.dumps(out)}: "
                             + "; ".join(faults[:8]))
    log(f"train {label}, first step card vs CPU: {json.dumps(out)}")
    return out


def timed_steps(label: str, step, state, batches, lr_scale=None, batch_size=1,
                shape_of=None, steps=None) -> dict:
    """The learning run on the card: TRAIN_STEPS steps over ``batches``
    (a function of the step index), host clock to synchronize each step;
    the median after TRAIN_WARM steps (by ``shape_of(i)`` where the
    batches have several shapes), samples a second, the peak memory,
    and the losses (they must fall by a tenth)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = steps or TRAIN_STEPS
    losses, ms = [], []
    for i in range(steps):
        args = batches(i)
        t0 = time.perf_counter()
        kw = {} if lr_scale is None else {"lr_scale": lr_scale(i)}
        state, loss = step(state, *args, **kw)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    if not all(np.isfinite(losses)) or not last < 0.9 * first:
        raise AssertionError(f"train {label}: the loss does not fall: {losses}")
    median = float(np.median(ms[TRAIN_WARM:]))
    out = {"ms_per_step": median, "samples_per_s": 1e3 * batch_size / median,
           "max_memory_allocated": int(torch.cuda.max_memory_allocated()),
           "loss_first4": first, "loss_last4": last, "steps": steps,
           "losses": losses}
    if shape_of is not None:
        out["ms_per_step_by_shape"] = {
            str(key): float(np.median([t for i, t in enumerate(ms)
                                       if i >= TRAIN_WARM and shape_of(i) == key]))
            for key in sorted({shape_of(i) for i in range(TRAIN_WARM, steps)})}
    log(f"train {label}: {json.dumps(out)}")
    return out


def _sync_ms(fn, reps: int = 5) -> float:
    """Median device ms of ``fn``, a function that waits for the device
    itself (torch's CUDA CTC loss reads the label lengths on the host)."""
    return cuda_ms(fn, reps=reps, warmup=2, ahead=False)


def recognizer_flops(spec: RecognizerSpec, n: int, width: int) -> float:
    """Forward multiply-adds x 2 of the recognizer on n lines of
    ``width``, from the shapes (convolutions, LSTM gates, Dense)."""
    h, w, c = spec.line_height // 2, width // 2, 12  # after the s2d stem
    flops = 0.0
    w_sub = int(np.log2(spec.subsampling)) - 1
    for i, feat in enumerate(spec.conv_features):
        flops += 2 * 9 * (c * feat + feat * feat) * h * w
        c = feat
        h, w = -(-h // 2), (-(-w // 2) if i < w_sub else w)
    flops += 2 * h * c * c * w  # the height collapse
    hidden, inp = spec.lstm_features, c
    for _ in range(spec.lstm_layers):
        flops += 2 * 2 * 4 * hidden * (inp + hidden) * w
        inp = 2 * hidden
    flops += 2 * inp * spec.num_classes * w
    return n * flops


def recognizer_split(model, optimizer, state, images, labels, lengths) -> dict:
    """Where a recognizer step's device time goes: each part alone with
    CUDA events (the convolutions forward, and forward with backward;
    the BiLSTM alike; the Dense layer and CTC forward and backward; the
    optimizer), the whole step also with cuDNN's autotuner and with TF32
    convolutions, and one whole step under torch.profiler (busy, idle,
    kernels by name)."""
    x = torch.as_tensor(images, device=TRAIN_DEVICE)
    labels_t = torch.as_tensor(labels, device=TRAIN_DEVICE)
    lengths_t = torch.as_tensor(lengths, device=TRAIN_DEVICE)
    step = train.make_train_step(model, optimizer)
    model.train()
    nchw = x.permute(0, 3, 1, 2)
    feats = model.encoder(nchw)
    seq = model.blstm(feats.detach())
    g_feats, g_seq = torch.randn_like(feats), torch.randn_like(seq)

    def conv_fwd():
        with torch.no_grad():
            model.encoder(nchw)

    def conv_bwd():
        torch.autograd.grad(model.encoder(nchw), list(model.encoder.parameters()), g_feats)

    def lstm_fwd():
        with torch.no_grad():
            model.blstm(feats.detach())

    def lstm_bwd():
        f = feats.detach().requires_grad_(True)
        torch.autograd.grad(model.blstm(f), [f] + [p for p in model.blstm.parameters()
                                                  if p.requires_grad], g_seq)

    def head_ctc():
        s = seq.detach().requires_grad_(True)
        logits = model.dense(s.float())
        log_probs = F.log_softmax(logits, -1).transpose(0, 1)
        loss = F.ctc_loss(log_probs, labels_t, torch.full((x.shape[0],), logits.shape[1],
                                                           device=TRAIN_DEVICE, dtype=torch.long),
                          lengths_t, blank=logits.shape[-1] - 1, reduction="none",
                          zero_infinity=True).mean()
        torch.autograd.grad(loss, [s] + list(model.dense.parameters()))

    grads = train.gradients(model, state)

    def opt():
        optimizer.step_(list(state.params.values()), grads, copy.copy(state.opt_state))

    parts = {"whole_step": _sync_ms(lambda: step(state, x, labels_t, lengths_t)),
             "conv_forward": _median_ms(conv_fwd),
             "conv_forward_backward": _median_ms(conv_bwd),
             "lstm_forward": _median_ms(lstm_fwd),
             "lstm_forward_backward": _median_ms(lstm_bwd),
             "dense_ctc_forward_backward": _sync_ms(head_ctc), "optimizer": _median_ms(opt)}
    # The same step with cuDNN's autotuner, and with TF32 convolutions
    # (torch's default; run_train holds them off), then as before.
    torch.backends.cudnn.benchmark = True
    parts["whole_step_cudnn_benchmark"] = _sync_ms(lambda: step(state, x, labels_t, lengths_t))
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = True
    parts["whole_step_tf32_convolutions"] = _sync_ms(lambda: step(state, x, labels_t, lengths_t))
    torch.backends.cudnn.allow_tf32 = False
    prof = _profiled(lambda: step(state, x, labels_t, lengths_t), {
        "optimizer": (optimizer, "step_")},
        groups=(("ctc", r"ctc"), ("rnn", r"rnn|lstm|elemWise|LSTM"),
                ("conv", r"conv|dgrad|wgrad|xmma|implicit|cudnn"), ("foreach", r"foreach|multi_tensor")))
    return {"parts_ms": parts, "profile": prof}


def run_train(rng, smi: str) -> dict:
    """The five trainers on the card at full width (see the module
    docstring), float32 compute with TF32 off for the first-step parity;
    the learning runs in each model's own dtype."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    report = {"device": smi}
    t_phase = time.perf_counter()
    try:
        # --- CTC recognizer: the bench recognizer, float32 compute.
        spec32 = RecognizerSpec(dtype=torch.float32, **TRAIN_REC)
        bank = glyph_bank(np.random.default_rng(7), REC_GLYPHS, spec32.line_height, (12, 20))
        train_set = glyph_lines(rng, bank, 4 * REC_BATCH, spec32.line_height, REC_WIDTH,
                                REC_MAX_LABEL)
        held = glyph_lines(rng, bank, 32, spec32.line_height, REC_WIDTH, REC_MAX_LABEL)
        lr = 3e-3

        def rec_batch(i, data=train_set, n=REC_BATCH):
            rows = np.arange(i * n, (i + 1) * n) % data[0].shape[0]
            return tuple(a[rows] for a in data)

        def build_rec():
            return CTCRecognizer(spec32, generator=torch.Generator().manual_seed(11))

        report["ctc"] = {"first_step": first_step_parity(
            "ctc", build_rec, train.make_train_step, rec_batch(0), lr)}
        # (b) bench.py's recipe (:467-524): adamw(1.0) under lr_scale =
        # peak * min(1, (i + 1) / 100); a curriculum of short crops at
        # peak 3e-3 (on the full lines alone the loss stays on the blank
        # plateau, ~178, with a held-out CER of 1.0: PERF.md), then the
        # full lines at 1e-3, timed.  The curriculum runs with TF32
        # convolutions (torch's cuDNN default) to take its steps fast.
        curriculum = glyph_lines(np.random.default_rng(9), bank, 8 * REC_BATCH,
                                 spec32.line_height, REC_CUR_WIDTH, 10, min_len=2)
        rec = build_rec()
        opt = train.make_optimizer(1.0)
        state = train.init_train_state(rec, opt, device=TRAIN_DEVICE)
        rec_step = train.make_train_step(rec, opt)
        t_cur, cur_losses = time.perf_counter(), []
        torch.backends.cudnn.allow_tf32 = True
        for i in range(REC_CUR_STEPS):
            state, loss = rec_step(state, *rec_batch(i, curriculum),
                                   lr_scale=3e-3 * min(1.0, (i + 1) / 100))
            cur_losses.append(float(loss))
            if i % 50 == 49 and np.mean(cur_losses[-25:]) < REC_CUR_STOP:
                break
        torch.backends.cudnn.allow_tf32 = False
        cur = {"steps": len(cur_losses), "seconds": time.perf_counter() - t_cur,
               "loss_first4": float(np.mean(cur_losses[:4])),
               "loss_last25": float(np.mean(cur_losses[-25:])), "losses": cur_losses}
        log(f"train ctc curriculum: {json.dumps(cur)}")
        if not cur["loss_last25"] < REC_CUR_STOP:
            raise AssertionError(f"train ctc: the curriculum loss stays on the plateau: {cur}")
        report["ctc"]["curriculum"] = cur
        report["ctc"].update(timed_steps("ctc", rec_step, state, rec_batch,
                                         lambda i: 1e-3 * min(1.0, (i + 1) / 100), REC_BATCH))
        with torch.no_grad():
            held_logits = rec(torch.as_tensor(held[0], device=TRAIN_DEVICE))
        report["ctc"]["held_out_greedy_cer"] = greedy_cer(held_logits, held[1], held[2])
        flops = 3 * recognizer_flops(spec32, REC_BATCH, REC_WIDTH)
        report["ctc"]["flops_per_step"] = flops
        report["ctc"]["f32_peak_share"] = flops / (report["ctc"]["ms_per_step"] * 1e-3) \
            / F32_FLOP_PER_S
        # (c) the exported recognizer reads back to the same logits.
        tmp = tempfile.mkdtemp(prefix="train_export_")
        path = os.path.join(tmp, "rec.msgpack")
        checkpoint.save_variables(convert.recognizer_params_to_flax(
            rec, train.float32_state_dict(rec, state)), path)
        back = CTCRecognizer(spec32)
        back.load_state_dict(convert.recognizer_params_from_flax(checkpoint.load_variables(path)))
        back.to(TRAIN_DEVICE)
        with torch.no_grad():
            same = torch.equal(back(torch.as_tensor(held[0], device=TRAIN_DEVICE)), held_logits)
        if not same:
            raise AssertionError("train ctc: the exported recognizer's logits differ")
        report["ctc"]["export_logits_equal"] = True
        report["ctc"]["split"] = recognizer_split(rec, train.make_optimizer(1e-3), state,
                                                  *rec_batch(1))
        del rec, back, state, opt, held_logits

        # --- ParseNet: chip_smoke's detector, bench's third phase.
        pages, lines = synthetic_pages(np.random.default_rng(21), PN_PAGES)
        scales = {ds: parsenet_batch(pages, lines, ds) for ds in (4, 2)}
        # The third phase's weights (every term of the loss runs) at the
        # first two phases' lr: the third's 5e-4 settles a trained net.
        weights = dict(height_weight=0.3, off_mask_height_weight=0.05, pos_weight=10.0,
                       hard_neg_weight=8.0, height_over_weight=4.0)
        lr = 5e-3

        def pn_batch(i):
            images, targets = scales[4 if i % 2 == 0 else 2]
            rows = np.arange(PN_BATCH * (i // 2), PN_BATCH * (i // 2 + 1)) % len(pages)
            return images[rows], targets[rows]

        def make_pn_step(model, optimizer):
            return train.make_parsenet_train_step(model, optimizer, **weights)

        report["parsenet"] = {"first_step": first_step_parity(
            "parsenet", lambda: ParseNet(dtype=torch.float32, **TRAIN_PN,
                                         generator=torch.Generator().manual_seed(12)),
            make_pn_step, pn_batch(0), lr)}
        pn = ParseNet(**TRAIN_PN, generator=torch.Generator().manual_seed(12))
        opt = train.make_optimizer(lr)
        state = train.init_parsenet_train_state(pn, opt, device=TRAIN_DEVICE)
        report["parsenet"].update(timed_steps("parsenet", make_pn_step(pn, opt), state,
                                              pn_batch, batch_size=PN_BATCH,
                                              shape_of=lambda i: f"ds{4 if i % 2 == 0 else 2}"))
        path = os.path.join(tmp, "parsenet.msgpack")
        checkpoint.save_variables(convert.parsenet_params_to_flax(
            pn, train.float32_state_dict(pn, state)), path)
        back = ParseNet(**TRAIN_PN)
        back.load_state_dict(convert.parsenet_params_from_flax(checkpoint.load_variables(path)))
        back.to(TRAIN_DEVICE)
        probe = torch.as_tensor(scales[4][0][:2], device=TRAIN_DEVICE)
        with torch.no_grad():
            if not torch.equal(back(probe), pn(probe)):
                raise AssertionError("train parsenet: the exported ParseNet's maps differ")
        report["parsenet"]["export_maps_equal"] = True
        del pn, back, state, opt, scales

        # --- OrientationNet at its defaults, 8 tiles of 256x256.
        tiles = orientation_tiles(rng, 4 * TILES, TILE)
        lr = 1e-3

        def or_batch(i):
            rows = np.arange(TILES * i, TILES * (i + 1)) % (4 * TILES)
            return tuple(a[rows] for a in tiles)

        report["orientation"] = {"first_step": first_step_parity(
            "orientation", lambda: OrientationNet(**TRAIN_ORIENTATION, dtype=torch.float32,
                                                  generator=torch.Generator().manual_seed(13)),
            train.make_orientation_train_step, or_batch(0), lr)}
        onet = OrientationNet(**TRAIN_ORIENTATION, generator=torch.Generator().manual_seed(13))
        opt = train.make_optimizer(lr)
        state = train.init_train_state(onet, opt, device=TRAIN_DEVICE)
        report["orientation"].update(timed_steps(
            "orientation", train.make_orientation_train_step(onet, opt), state, or_batch,
            batch_size=TILES))
        del onet, state, opt

        # --- the native transformer at TransformerSpec's defaults, 16 lines.
        tspec = TransformerSpec(**TRAIN_TF)
        # Glyphs of 12 of the 80 classes: the loss falls on what the
        # decoder can learn in a few dozen steps.
        tbank = glyph_bank(np.random.default_rng(8), 12, tspec.line_height)
        tlines = glyph_lines(rng, tbank, 4 * TF_BATCH, tspec.line_height, TF_WIDTH, 48)
        lr = 3e-4

        def tf_batch(i):
            rows = np.arange(TF_BATCH * i, TF_BATCH * (i + 1)) % (4 * TF_BATCH)
            images, labels, lengths = (a[rows] for a in tlines)
            return images, labels[:, :int(lengths.max())], lengths

        report["transformer"] = {"first_step": first_step_parity(
            "transformer", lambda: TransformerOCR(dataclasses.replace(tspec, dtype=torch.float32),
                                                  generator=torch.Generator().manual_seed(14)),
            train.make_transformer_train_step, tf_batch(0), lr)}
        tmodel = TransformerOCR(tspec, generator=torch.Generator().manual_seed(14))
        opt = train.make_optimizer(lr)
        state = train.init_transformer_train_state(tmodel, opt, device=TRAIN_DEVICE)
        report["transformer"].update(timed_steps(
            "transformer", train.make_transformer_train_step(tmodel, opt), state,
            tf_batch, batch_size=TF_BATCH))
        del tmodel, state, opt

        # --- the character LM at the spec defaults, and one GRU.
        corpus = lm_corpus(rng, 4 * LM_BATCH, LM_LENGTH, TRAIN_LM["vocab_size"])
        lr = 3e-3

        def lm_batch(i):
            return (corpus[np.arange(LM_BATCH * i, LM_BATCH * (i + 1)) % (4 * LM_BATCH)],)

        for cell in ("lstm", "gru"):
            lspec = CharLMSpec(**TRAIN_LM, cell_type=cell)
            label = f"charlm_{cell}"
            report[label] = {"first_step": first_step_parity(
                label, lambda: CharLM(lspec, generator=torch.Generator().manual_seed(15)),
                train.make_lm_train_step, lm_batch(0), lr)}
            lm = CharLM(lspec, generator=torch.Generator().manual_seed(15))
            opt = train.make_optimizer(lr)
            state = train.init_lm_train_state(lm, opt, device=TRAIN_DEVICE)
            report[label].update(timed_steps(label, train.make_lm_train_step(lm, opt), state,
                                             lm_batch, batch_size=LM_BATCH))
            path = os.path.join(tmp, f"{label}.lm")
            train.export_lm_checkpoint(lm, path)
            wrapper = itf.construct_lm(path, BENCH_CHARS[:lspec.vocab_size - 1])
            wrapper.model.to(TRAIN_DEVICE)
            tokens = torch.as_tensor(corpus[:4, :32], device=TRAIN_DEVICE)
            with torch.no_grad():
                same = torch.equal(sequence_logprobs(wrapper.model, tokens),
                                   sequence_logprobs(lm, tokens))
            if not same:
                raise AssertionError(f"train {label}: the exported LM's log-probs differ")
            report[label]["export_logprobs_equal"] = True
            del lm, state, opt, wrapper
        shutil.rmtree(tmp, ignore_errors=True)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    report["seconds"] = time.perf_counter() - t_phase
    log(f"train: {json.dumps(report)}")
    return report


@contextlib.contextmanager
def phase(name: str):
    """Log the wall seconds of the block, as "phase <name>: <s> s"."""
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


def run_phases(smi: str) -> list:
    """Every phase in order; the lines to print at the end."""
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, text in kernels.build_logs.items():
        log(f"build {name}:\n{text.strip()}")

    with phase("jpeg"):
        jpeg_numbers = check_jpeg_fixtures(smi)
    rng = np.random.default_rng(0)
    with phase("check_warp mixed lines, check_against_cpu"):
        mixed = check_warp(mixed_line_args(rng), "mixed lines")
        check_against_cpu(rng)
    with phase("main path"):
        pipe, launches_page_transport, stage_b = run_main_path(rng)
    with phase("config2"):
        launches, config2, main_args, fast_host = run_config2(pipe, rng, smi)
    with phase("cli"):
        launches_cli, cli, cli_args = run_cli(pipe, rng, smi)
    with phase("staged"):
        staged_xml = check_staged_against_cpu(rng)
        launches_staged, staged, staged_args, staged_host, script_pages = run_staged(
            pipe, rng, smi)
    with phase("config1"):
        launches_config1, config1, config1_args = run_config1(rng, smi)
    # The phases of REGION_SIMPLE_THRESHOLD and --process-count draw from
    # their own generator: the other phases keep their pages.
    t_new = time.perf_counter()
    new_rng = np.random.default_rng(17)
    with phase("simple_regions"):
        launches_simple, simple, simple_args = run_simple_regions(new_rng, smi)
    with phase("process_count"):
        process_count = run_process_count(pipe, new_rng, smi)
    log(f"REGION_SIMPLE_THRESHOLD and --process-count add {time.perf_counter() - t_new:.1f} s")
    with phase("config5"):
        launches_config5, config5, config5_args, viterbi_inputs, config5_files = run_config5(
            pipe, rng, smi)
    with phase("user_scripts"):
        launches_scripts, user_scripts = run_user_scripts(script_pages, config5_files,
                                                          staged_xml, smi)
    with phase("config3"):
        launches_config3, config3, config3_args, (beam_decoder, beam_call) = run_config3(
            pipe, rng, smi)
    with phase("config4"):
        launches_config4, config4, config4_args = run_config4(pipe, rng, smi)
    with phase("crops"):
        crops = run_crops(pipe, rng, smi)
    with phase("reocr"):
        reocr = run_reocr(pipe, rng, smi)
    with phase("torchscript"):
        ts_launches, ts_fields, torchscript, ts_args, ts_page = run_torchscript(rng, smi)
    with phase("host_native"):
        host_native = check_host_native(fast_host, staged_host, viterbi_inputs, smi)
    with phase("train"):
        training = run_train(rng, smi)
    # The kernel against its plain version, and its times, at the main
    # path's shapes (the last config-2 batch's pages and detected lines)
    # and at the command line's (its last batch: page batch 4, line slot
    # 32, crop bucket 2048).
    main_check = check_warp(main_args, "config 2")
    cli_check = check_warp(cli_args, "command line")
    config5_check = check_warp(config5_args, "config 5")
    ts_check = check_warp(ts_args, "torchscript fast path (f32 store)")
    # Where the device time goes: one config-2 stage-B call and one
    # config-3 line decode (eager) under torch.profiler.
    config3["stage_b_split"] = profile_stage_b(pipe, main_args[:3])
    config3["beam_line_split"] = profile_beam_line(beam_decoder, beam_call)
    warp = {
        "name": "warp_lines", "route": "cuda",
        "source": "pero_ocr_tpu_torch/csrc/warp_lines.cu",
        "replaces": "pero_ocr_tpu/ops/warp.py:188",
        "launches": launches, **main_check,
        "launches_page_transport": launches_page_transport, "launches_cli": launches_cli,
        **stage_b, **config2,
        **{f"mixed_lines_{k}": v for k, v in mixed.items()},
        **{f"cli_{k}": v for k, v in cli_check.items()},
        "launches_config5": launches_config5["warp_lines"],
        **{f"config5_{k}": v for k, v in config5_check.items()},
        "launches_torchscript": ts_launches,
        **{f"torchscript_{k}": v for k, v in ts_check.items()},
    }

    fields = {
        "name": "warp_fields", "route": "cuda",
        "source": "pero_ocr_tpu_torch/csrc/warp_fields.cu",
        "replaces": "pero_ocr_tpu/ops/warp.py:188",
        "launches": launches_staged,
        **check_warp_fields(*staged_args, rng, "staged, last page"),
        "launches_config1": launches_config1,
        "launches_config5": launches_config5["warp_fields"],
        "launches_config3": launches_config3,
        "launches_config4": launches_config4,
        **{f"config1_{k}": v for k, v in check_warp_fields(
            *config1_args, rng, "config 1, last A4 page").items()},
        **{f"config3_{k}": v for k, v in check_warp_fields(
            *config3_args, rng, "config 3, last page").items()},
        **{f"config4_{k}": v for k, v in check_warp_fields(
            *config4_args, rng, "config 4, last page").items()},
        "launches_torchscript_a": ts_fields["a"], "launches_torchscript_b": ts_fields["b"],
        **{f"torchscript_{k}": v for k, v in check_warp_fields(
            *ts_page, rng, "torchscript ini (a), last page").items()},
        "launches_simple_regions": launches_simple,
        "launches_process_count": process_count["warp_fields_launches"],
        "launches_select_embed_id": launches_scripts,
        **{f"simple_regions_{k}": v for k, v in check_warp_fields(
            *simple_args, rng, "simple regions, last A4 page with lines").items()},
    }

    return [json.dumps({key: value}) for key, value in (
        ("jpeg", jpeg_numbers), ("cli", cli), ("staged", staged), ("config1", config1),
        ("simple_regions", simple), ("process_count", process_count), ("config5", config5),
        ("user_scripts", user_scripts),
        ("config3", config3), ("config4", config4), ("crops", crops), ("reocr", reocr),
        ("torchscript", torchscript),
        ("host_native", host_native),
        ("train", training))] + [smi, json.dumps({"kernels": [warp, fields]})]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # Every warning of the serving and training phases is recorded; the
    # BiLSTM's "not part of single contiguous chunk of memory" (cuDNN
    # compacting the weights on every call) fails the run.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lines = run_phases(smi)
    messages = sorted({f"{w.category.__name__}: {w.message}" for w in caught})
    log(f"warnings ({len(caught)}, {len(messages)} distinct):\n" + "\n".join(messages))
    if any("contiguous chunk of memory" in m for m in messages):
        raise AssertionError("an LSTM's weights were not one contiguous cuDNN buffer")
    for line in lines:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
