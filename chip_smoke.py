"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero):

1. Environment: the card's name and power limit (nvidia-smi).
2. Build: every ``pero_ocr_tpu_torch/csrc/*.cu`` with nvcc, in parallel.
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
   as PNG files and the bench modules as flax msgpack checkpoints, with
   an OCR JSON and a config, through
   ``python -m pero_ocr_tpu_torch.scripts.parse_folder`` in a
   subprocess; its Page XML files must equal an in-process
   ``FastPagePipeline`` with the command line's settings on the same
   modules and pages; the warp's launches are counted in both (the
   command line prints its count with ``--timing-report``).  Then the
   kernel is held against its plain version, and timed, on the in-process
   run's last batch, at the command line's shapes (page batch 4, line
   slot 32, crop bucket 2048); the ``kernels`` line reports these under
   ``cli_*``.
8. Stage by stage (``run_staged``): 8 pages through
   ``PageParser(config, device="cuda").process_page`` and its command
   line on 4 of them; the field warp checked and timed on the last page.
9. Config 1 (``run_config1``): 6 synthetic printed A4 pages at 300 dpi
   (40 rows) through ``PageParser(config 1, device="cuda")`` (whole-page
   region, the classical line detector, the field warp, the recognizer
   at bench widths) to Page XML, its layout equal to a CPU run's layout
   stages, the field warp bit-equal on every page's own fields, and the
   command line on 3 pages; the field warp timed on the last page
   (``config1_*``).
10. Config 5's outputs (``run_config5``): the page transport with
    ``want_logits`` and stage by stage, each with and without the logits
    pickle and ALTO (A B B A), the card's top-k against ``torch.topk``
    on the CPU, and the command line with --output-logit-path and
    --output-alto-path on both paths, every file loaded back against
    the in-process run's; warp_lines timed on its last batch
    (``config5_*``).
11. Host C++ (``csrc/perotpu.cpp``, built with the kernels): config 2's
    fast path and the staged run go on the C++ host route (the card's
    default), the numpy route (``native=False``), the numpy route and
    the C++ route again (A B B A); every run's Page XML must equal the
    first's.  Then ``check_host_native`` holds each C++ function against
    its numpy twin on the runs' own inputs (0 differences; the forced
    alignment's on config 5's lines) and times both.

Kernel times are taken warm (inputs in L2 from the run before) and
cold (a 128 MB scratch write before each timed run), since stage B finds
its pages after the next batch's upload.

The last lines are the command lines' numbers (``{"cli": ...}``,
``{"staged": ...}``), config 1's and config 5's (``{"config1": ...}``,
``{"config5": ...}``), the host library's (``{"host_native": ...}``),
the card's nvidia-smi line, one JSON object with the kernels' numbers,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import configparser
import copy
import difflib
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
import xml.etree.ElementTree as ET
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.core.force_alignment import viterbi_ctc
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.core.line_geometry import resample_baseline
from pero_ocr_tpu_torch.document.fast_pipeline import FastPagePipeline, assemble_page_layout
from pero_ocr_tpu_torch.document.page_parser import LayoutExtractor, PageParser
from pero_ocr_tpu_torch.layout_engines.cnn_engine import separator_penalties
from pero_ocr_tpu_torch.models.parsenet import ParseNet
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.ops import morphology
from pero_ocr_tpu_torch.ops import warp as warp_ops
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.scripts.parse_folder import PAGE_BATCH as CLI_PAGE_BATCH
from pero_ocr_tpu_torch.utils import kernels, native, timing

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


def synthetic_pages(rng, n: int, columns=ONE_COLUMN):
    """n BGR text-like pages and their text-line geometries: 40 lines in
    each of ``columns``."""
    pages, lines = [], []
    ys = np.linspace(90, PAGE_H - 70, LINES_PER_PAGE)
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
                    top = y - int(rng.integers(12, 24))
                    bottom = y + (int(rng.integers(3, 8)) if rng.random() < 0.2 else 0)
                    gray[top:bottom, x:x + gw] = rng.integers(20, 90)
                    x += gw + int(rng.integers(3, 12))
                b_list.append(np.array([[x0, y], [x1, y]], float))
                h_list.append([24.0, 8.0])
        pages.append(np.repeat(gray[:, :, None], 3, axis=2))
        lines.append((b_list, h_list))
    return pages, lines


def printed_pages(rng, n: int, h: int, w: int, rows: int):
    """n BGR printed-like pages of ``rows`` text rows: glyph-like ink
    outlines (strokes about an eighth of the x-height) on grey paper,
    words and line ends of random length.  Returns the pages and each
    page's row baselines (y)."""
    pages, baselines = [], []
    margin = max(h, w) // 20
    pitch = (h - 2 * margin) / rows
    xh = max(int(pitch * 0.32), 6)
    stroke = max(xh // 8, 2)
    for _ in range(n):
        gray = rng.normal(240, 5, (h, w)).clip(0, 255).astype(np.uint8)
        ys = []
        for r in range(rows):
            y = int(margin + (r + 0.8) * pitch)
            x = margin + int(rng.integers(0, 3 * xh))
            x_end = w - margin - int(rng.integers(0, 6 * xh))
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
# The JAX package's file formats, written here: flax msgpack checkpoints
# (the inverse of pero_ocr_tpu_torch/utils/convert.py) and PNG pages.
def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _flax_conv(sd, prefix: str) -> dict:
    k = _np(sd[f"{prefix}.weight"])
    k = k.transpose(2, 3, 1, 0) if k.ndim == 4 else k.transpose(2, 1, 0)
    return {"kernel": np.ascontiguousarray(k), "bias": _np(sd[f"{prefix}.bias"])}


def _flax_conv_transpose(sd, prefix: str) -> dict:
    k = _np(sd[f"{prefix}.weight"])[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return {"kernel": np.ascontiguousarray(k), "bias": _np(sd[f"{prefix}.bias"])}


def _flax_norm(sd, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _flax_block(sd, prefix: str) -> dict:
    node = {}
    for i in (0, 1):
        node[f"Conv_{i}"] = _flax_conv(sd, f"{prefix}.conv{i}")
        if f"{prefix}.norm{i}.weight" in sd:
            node[f"GroupNorm_{i}"] = _flax_norm(sd, f"{prefix}.norm{i}")
    return node


def flax_parsenet_variables(pn: ParseNet) -> dict:
    """The flax variables of the JAX ParseNet that ``pn`` ports
    (``parsenet_params_from_flax`` inverted), float32."""
    sd = pn.state_dict()
    n_levels, n_head = len(pn.down_blocks), len(pn.head_ups)
    p = {}
    for level in range(n_levels):
        p[f"ConvBlock_{level}"] = _flax_block(sd, f"down_blocks.{level}")
        p[f"Conv_{level}"] = _flax_conv(sd, f"down_convs.{level}")
    p[f"ConvBlock_{n_levels}"] = _flax_block(sd, "bottleneck")
    for level in range(n_levels):
        p[f"ConvTranspose_{level}"] = _flax_conv_transpose(sd, f"up_convs.{level}")
        p[f"ConvBlock_{n_levels + 1 + level}"] = _flax_block(sd, f"up_blocks.{level}")
    for k in range(n_head):
        p[f"ConvTranspose_{n_levels + k}"] = _flax_conv_transpose(sd, f"head_ups.{k}")
        p[f"Conv_{n_levels + k}"] = _flax_conv(sd, f"head_convs.{k}")
    p[f"Conv_{n_levels + n_head}"] = _flax_conv(sd, "out")
    return {"params": p}


def flax_recognizer_variables(rec: CTCRecognizer) -> dict:
    """The flax variables of the JAX CTCRecognizer that ``rec`` ports
    (``recognizer_params_from_flax`` inverted), float32.  Flax's LSTM
    has no input bias: torch's ``bias_ih`` is added into the hidden bias
    (exact when it is zero, as in a model loaded from flax)."""
    sd = rec.state_dict()
    enc = {}
    for i in range(len(rec.encoder.convs)):
        enc[f"Conv_{i}"] = _flax_conv(sd, f"encoder.convs.{i}")
        if f"encoder.norms.{i}.weight" in sd:
            enc[f"GroupNorm_{i}"] = _flax_norm(sd, f"encoder.norms.{i}")
    p = {"VGGEncoder_0": enc, "Dense_0": {
        "kernel": np.ascontiguousarray(_np(sd["dense.weight"]).T), "bias": _np(sd["dense.bias"]),
    }}
    if rec.spec.embed_num:
        p["Embed_0"] = {"embedding": _np(sd["embedding.weight"])}
    stack = {}
    if rec.spec.lstm_layers == 0:
        for i in range(2):
            stack[f"Conv_{i}"] = _flax_conv(sd, f"blstm.convs.{i}")
    for layer in range(rec.spec.lstm_layers):
        step = {}
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            w_ih = _np(sd[f"blstm.lstm.weight_ih_l{layer}{suffix}"]).T
            w_hh = _np(sd[f"blstm.lstm.weight_hh_l{layer}{suffix}"]).T
            bias = _np(sd[f"blstm.lstm.bias_hh_l{layer}{suffix}"]
                       + sd[f"blstm.lstm.bias_ih_l{layer}{suffix}"])
            gates = {}
            for g, name in enumerate("ifgo"):
                cols = slice(g * w_hh.shape[0], (g + 1) * w_hh.shape[0])
                gates[f"i{name}"] = {"kernel": np.ascontiguousarray(w_ih[:, cols])}
                gates[f"h{name}"] = {"kernel": np.ascontiguousarray(w_hh[:, cols]),
                                     "bias": bias[cols]}
            step[direction] = gates
        stack[f"FusedBiLSTM_{layer}"] = {"Scan_BiLSTMStep_0": step}
    p["BLSTMStack_0"] = stack
    return {"params": p}


def fold_lstm_input_bias_(rec: CTCRecognizer) -> None:
    """Move each LSTM layer's ``bias_ih`` into ``bias_hh`` (in the
    module's dtype), so that the module is exactly what its flax export
    loads back into."""
    if rec.spec.lstm_layers == 0:
        return
    with torch.no_grad():
        for name, b_ih in rec.blstm.lstm.named_parameters():
            if name.startswith("bias_ih"):
                getattr(rec.blstm.lstm, name.replace("bias_ih", "bias_hh")).add_(b_ih)
                b_ih.zero_()


def _msgpack(obj) -> bytes:
    """msgpack of the types a flax checkpoint holds: str-keyed dicts,
    lists/tuples, str, bytes, non-negative ints and numpy arrays (flax's
    extension type 1: a msgpack (shape, dtype name, C-order bytes))."""
    def sized(n, small_tag, small_max, tags):
        if n <= small_max and small_tag is not None:
            return bytes([small_tag | n])
        for tag, fmt in tags:
            if n < 1 << (8 * struct.calcsize(fmt)):
                return bytes([tag]) + struct.pack(fmt, n)
        raise ValueError(f"msgpack: length {n} too large")

    if isinstance(obj, dict):
        return sized(len(obj), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I"))) + b"".join(
            _msgpack(k) + _msgpack(v) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return sized(len(obj), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I"))) + b"".join(
            _msgpack(v) for v in obj)
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return sized(len(raw), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))) + raw
    if isinstance(obj, bytes):
        return sized(len(obj), None, -1, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))) + obj
    if isinstance(obj, (int, np.integer)) and not isinstance(obj, bool) and obj >= 0:
        return sized(int(obj), 0x00, 127, ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                                          (0xCF, ">Q")))
    if isinstance(obj, np.ndarray):
        payload = _msgpack((obj.shape, obj.dtype.name, np.ascontiguousarray(obj).tobytes()))
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        head = bytes([fixext[n]]) if n in fixext else sized(
            n, None, -1, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
        return head + bytes([1]) + payload
    raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def write_flax_checkpoint(variables: dict, path: str) -> None:
    """Write ``variables`` as ``flax.serialization.to_bytes`` does (the
    JAX package's ``save_variables``); arrays stay under flax's 2**30-byte
    chunk size."""
    with open(path, "wb") as f:
        f.write(_msgpack(variables))


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


def write_bundle(tmp: str, pn: ParseNet, rec: CTCRecognizer, pages: dict):
    """The command line's inputs in ``tmp``: ``pages`` (id -> BGR page)
    as PNG files under images/, the modules as flax msgpack checkpoints,
    the OCR JSON and CLI_INI.  Returns (ini path, images dir)."""
    images = write_pages(tmp, pages)
    write_flax_checkpoint(flax_parsenet_variables(pn), os.path.join(tmp, "parsenet.msgpack"))
    write_recognizer(tmp, rec)
    ini = os.path.join(tmp, "config.ini")
    with open(ini, "w", encoding="utf-8") as f:
        f.write(CLI_INI)
    return ini, images


def write_pages(tmp: str, pages: dict) -> str:
    """``pages`` (id -> BGR page) as PNG files under ``tmp``/images/."""
    images = os.path.join(tmp, "images")
    os.makedirs(images)
    for page_id, page in pages.items():
        with open(os.path.join(images, page_id + ".png"), "wb") as f:
            f.write(png_bytes(page))
    return images


def write_recognizer(folder: str, rec: CTCRecognizer) -> None:
    """The recognizer as a flax msgpack checkpoint beside its OCR JSON
    (``ocr.json``, BENCH_CHARS, bfloat16) in ``folder``; its LSTM input
    biases are folded first, so that the module equals what loads."""
    fold_lstm_input_bias_(rec)
    write_flax_checkpoint(flax_recognizer_variables(rec),
                          os.path.join(folder, "recognizer.msgpack"))
    spec = rec.spec
    with open(os.path.join(folder, "ocr.json"), "w", encoding="utf-8") as f:
        json.dump({"characters": BENCH_CHARS[:-1], "line_px_height": spec.line_height,
                   "checkpoint": "recognizer.msgpack", "net_spec": {
                       "conv_features": list(spec.conv_features),
                       "subsampling": spec.subsampling, "lstm_layers": spec.lstm_layers,
                       "lstm_features": spec.lstm_features, "stem": spec.stem,
                       "norm": spec.norm, "dtype": "bfloat16"}}, f)


def run_cli(pipe: TorchPagePipeline, rng, smi: str):
    """Config 2 through the port's command line: 16 two-column pages as
    PNG files, the bench modules as flax msgpack checkpoints with an OCR
    JSON and a config, ``python -m pero_ocr_tpu_torch.scripts.parse_folder``
    in a subprocess, then each Page XML file against an in-process
    FastPagePipeline with the command line's settings, on the same
    modules (not reloaded) and the in-memory pages.  The warp must
    launch once per stage-B batch in both runs.  Returns the warp's
    launches in the in-process run, the phase's numbers and the last
    stage-B batch's warp arguments (the command line's shapes)."""
    n_pages = 2 * PAGE_BATCH
    pages, lines = synthetic_pages(rng, n_pages, TWO_COLUMNS)
    ids = [f"p{i:04d}" for i in range(n_pages)]
    pn, rec = pipe.parsenet, pipe.recognizer
    with tempfile.TemporaryDirectory(prefix="cli_") as tmp:
        ini, images = write_bundle(tmp, pn, rec, dict(zip(ids, pages)))
        out_dir = os.path.join(tmp, "page_xml")
        command = [sys.executable, "-m", "pero_ocr_tpu_torch.scripts.parse_folder", "-c", ini,
                   "-i", images, "--output-xml-path", out_dir, "--fast-pipeline",
                   "--timing-report"]
        t0 = time.perf_counter()
        proc = subprocess.run(command, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        cli_seconds = time.perf_counter() - t0
        log(f"command line: exit {proc.returncode} in {cli_seconds:.3f} s\n"
            f"{proc.stdout.strip()}\n{proc.stderr.strip()[-4000:]}")
        if proc.returncode != 0:
            raise AssertionError(f"the command line exited {proc.returncode}")
        files = sorted(os.listdir(out_dir))
        if files != [page_id + ".xml" for page_id in ids]:
            raise AssertionError(f"the command line wrote {files}")
        cli_xml = {}
        for name in files:
            with open(os.path.join(out_dir, name), encoding="utf-8") as f:
                cli_xml[name[:-4]] = f.read()
            ET.fromstring(cli_xml[name[:-4]].encode("utf-8"))
    timed = re.search(r"^cli/pages\s+([0-9.]+)\s+1\s", proc.stdout, re.M)
    counted = re.search(r"^warp_lines kernel launches: (\d+)$", proc.stdout, re.M)
    if timed is None or counted is None:
        raise AssertionError("the command line's timing report lacks cli/pages or launches")
    cli_pages_per_s = n_pages / float(timed.group(1))
    cli_launches = int(counted.group(1))

    same = TorchPagePipeline(
        pn, rec, downsample=4, detection_threshold=0.2, line_end_weight=1.0,
        crop_height=CROP_H, crop_bucket=FastPagePipeline.CROP_BUCKET,
        line_slot=FastPagePipeline.LINE_SLOT, height_scale=1.0, transport_bits=4,
        adaptive_downsample=True, device="cuda",
    )
    fast = FastPagePipeline(same, BENCH_CHARS, page_batch=CLI_PAGE_BATCH)
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
    differ = [layout.id for layout, xml in out
              if mask_pagexml(xml) != mask_pagexml(cli_xml[layout.id])]
    n_lines = sum(len(list(layout.lines_iterator())) for layout, _ in out)
    recall = line_recall(
        [[line.baseline for line in layout.lines_iterator()] for layout, _ in out], lines
    )
    log(f"command line vs in-process: {n_pages - len(differ)} of {n_pages} Page XML files "
        f"equal (timestamps masked), {n_lines} lines, line recall {recall:.3f}; warp_lines "
        f"launches in-process {launches}, in the command line {cli_launches}, stage-B "
        f"batches {batches}, line slots a page {slots}; command line "
        f"{cli_pages_per_s:.3f} pages/s by its own timer ({cli_seconds:.3f} s wall), "
        f"in-process {n_pages / seconds:.3f} pages/s, on {smi}")
    if differ:
        raise AssertionError(f"the command line's Page XML differs on pages {differ}")
    if not launches == cli_launches == batches == n_pages // CLI_PAGE_BATCH:
        raise AssertionError("command line settings: warp kernel launches != stage-B batches")
    if recall < MIN_LINE_RECALL:
        raise AssertionError(f"command line: found {recall:.3f} < {MIN_LINE_RECALL} of the lines")
    same.stage_b = stage_b
    return launches, {"pages": n_pages, "cli_wall_s": cli_seconds,
                      "cli_pages_per_s": cli_pages_per_s,
                      "in_process_pages_per_s": n_pages / seconds, "lines": n_lines,
                      "warp_launches": launches, "cli_warp_launches": cli_launches,
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


def check_staged_against_cpu(rng) -> None:
    """A small float32 stage-by-stage run (TF32 off) on the card against
    the same PageParser on the CPU.  Each page's ParseNet maps must agree
    within STAGED_MAPS_ATOL; the CPU run then continues from the card's
    maps, and the two Page XMLs must be equal (conf within 0.0015).  The
    rest of the staged layout turns float heights into integer outlines
    (alpha shapes, the 5 px simplification, raster clipping), so maps
    1e-6 apart can move a vertex: equal maps isolate what follows them,
    the field warp kernel and the recognizer on the card."""
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


def run_staged(pipe: TorchPagePipeline, rng, smi: str):
    """Config 2 stage by stage on the card: each of 8 two-column
    2560x1792 BGR pages through ``PageParser(config, device="cuda")
    .process_page`` and into Page XML, with the bench modules loaded from
    flax msgpack checkpoints; then the command line without
    --fast-pipeline on 4 of the pages, whose files must equal the
    in-process run's.  Between the two, the host-route A/B: the same
    pages through a PageParser on the numpy route twice and this one
    again (A B B A), each run's Page XML equal to the first's.  Returns the field warp's launches, the
    phase's numbers, the last page's warp inputs and the host record
    for check_host_native (the last page's host inputs, the A/B)."""
    pages, lines = synthetic_pages(rng, PAGE_BATCH, TWO_COLUMNS)
    ids = [f"s{i:04d}" for i in range(len(pages))]
    n_cli = 4
    with tempfile.TemporaryDirectory(prefix="staged_") as tmp:
        ini, images = write_bundle(tmp, pipe.parsenet, pipe.recognizer,
                                   dict(zip(ids[:n_cli], pages[:n_cli])))
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

        # The command line without --fast-pipeline on the first pages.
        out_dir = os.path.join(tmp, "page_xml")
        command = [sys.executable, "-m", "pero_ocr_tpu_torch.scripts.parse_folder", "-c", ini,
                   "-i", images, "--output-xml-path", out_dir, "--timing-report"]
        t0 = time.perf_counter()
        proc = subprocess.run(command, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        cli_seconds = time.perf_counter() - t0
        log(f"command line (stage by stage): exit {proc.returncode} in {cli_seconds:.3f} s\n"
            f"{proc.stdout.strip()}\n{proc.stderr.strip()[-4000:]}")
        if proc.returncode != 0 or "ERROR" in proc.stdout:
            raise AssertionError(f"the stage-by-stage command line failed ({proc.returncode})")
        counted = re.search(r"^warp_fields kernel launches: (\d+)$", proc.stdout, re.M)
        timed = re.search(r"^cli/pages\s+([0-9.]+)\s+1\s", proc.stdout, re.M)
        differ = []
        for pid, (layout, xml) in zip(ids[:n_cli], out):
            with open(os.path.join(out_dir, pid + ".xml"), encoding="utf-8") as f:
                cli_xml = f.read()
            if not same_staged_page(cli_xml, xml):
                differ.append(pid)
        log(f"stage-by-stage command line vs in-process: {n_cli - len(differ)} of {n_cli} files "
            f"equal (lines of a row as a set; conf within 0.0015); its warp_fields "
            f"launches {counted.group(1) if counted else None}; "
            f"{n_cli / float(timed.group(1)) if timed else float('nan'):.3f} pages/s by its timer")
        if differ or counted is None or timed is None:
            raise AssertionError(f"the stage-by-stage command line's files differ: {differ}")
        if int(counted.group(1)) != sum(batched[:n_cli]):
            raise AssertionError("the stage-by-stage command line: warp_fields launches != "
                                 f"pages of {parser.line_cropper.DEVICE_BATCH_MIN} lines or more")
        last_page = page_buckets(parser, out[-1][0], pages[-1])

    numbers = {"pages": len(pages), "pages_per_s": len(pages) / seconds, "lines": n_lines,
               "regions": n_regions, "line_recall": recall,
               "stage_ms": {k: 1e3 * stats[k][0] / stats[k][1] for k in STAGE_TIMERS
                            if k in stats},
               "stage_calls": {k: stats[k][1] for k in STAGE_TIMERS if k in stats},
               "warp_fields_launches": launches, "pages_of_4_lines_or_more": sum(batched),
               "cli_pages_per_s": n_cli / float(timed.group(1)), "cli_wall_s": cli_seconds,
               "cli_warp_fields_launches": int(counted.group(1)), "card": smi}
    return launches, numbers, last_page, {"inputs": host_inputs.pages[-1], "ab": ab}


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


def run_parse_folder(args, label: str):
    """The port's command line in a subprocess from the repository root;
    raises when it fails.  Returns (the completed process, wall s)."""
    command = [sys.executable, "-m", "pero_ocr_tpu_torch.scripts.parse_folder", *args]
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
CONFIG5_CLI_FAST, CONFIG5_STAGED_PAGES = 8, 4  # the staged command line runs as many
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
    last batch's warp arguments and the forced alignment's inputs (for
    check_host_native)."""
    n_pages = 2 * PAGE_BATCH
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
    return {"warp_lines": launches, "warp_fields": staged_launches}, numbers, (
        *last_b[0], logits_pipe.crop_height, logits_pipe.crop_bucket), viterbi.calls


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for name, text in kernels.build_logs.items():
        log(f"build {name}:\n{text.strip()}")

    rng = np.random.default_rng(0)
    mixed = check_warp(mixed_line_args(rng), "mixed lines")
    check_against_cpu(rng)
    pipe, launches_page_transport, stage_b = run_main_path(rng)
    launches, config2, main_args, fast_host = run_config2(pipe, rng, smi)
    launches_cli, cli, cli_args = run_cli(pipe, rng, smi)
    check_staged_against_cpu(rng)
    launches_staged, staged, staged_args, staged_host = run_staged(pipe, rng, smi)
    launches_config1, config1, config1_args = run_config1(rng, smi)
    launches_config5, config5, config5_args, viterbi_inputs = run_config5(pipe, rng, smi)
    host_native = check_host_native(fast_host, staged_host, viterbi_inputs, smi)
    # The kernel against its plain version, and its times, at the main
    # path's shapes (the last config-2 batch's pages and detected lines)
    # and at the command line's (its last batch: page batch 4, line slot
    # 32, crop bucket 2048).
    main_check = check_warp(main_args, "config 2")
    cli_check = check_warp(cli_args, "command line")
    config5_check = check_warp(config5_args, "config 5")
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
    }

    fields = {
        "name": "warp_fields", "route": "cuda",
        "source": "pero_ocr_tpu_torch/csrc/warp_fields.cu",
        "replaces": "pero_ocr_tpu/ops/warp.py:188",
        "launches": launches_staged,
        **check_warp_fields(*staged_args, rng, "staged, last page"),
        "launches_config1": launches_config1,
        "launches_config5": launches_config5["warp_fields"],
        **{f"config1_{k}": v for k, v in check_warp_fields(
            *config1_args, rng, "config 1, last A4 page").items()},
    }

    print(json.dumps({"cli": cli}))
    print(json.dumps({"staged": staged}))
    print(json.dumps({"config1": config1}))
    print(json.dumps({"config5": config5}))
    print(json.dumps({"host_native": host_native}))
    print(smi)
    print(json.dumps({"kernels": [warp, fields]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
