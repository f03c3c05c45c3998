"""The port's host C++ (``pero_ocr_tpu_torch/csrc/perotpu.cpp``,
bound in ``pero_ocr_tpu_torch/utils/native.py``) against its numpy twins
and against the JAX package's binding of its own library
(``pero_ocr_tpu.utils.native``), on seeded inputs, on the CPU.

Held to equality everywhere, bit for bit: labels, component points,
heights, set-bit counts, histograms, penalties, pair flags.  The one
documented difference: ``cc_lines_packed`` (the JAX crop transport's
parse, which the page transport does not run) numbers components by
their first mask pixel, scipy by their first pixel after the (5, 3)
connection dilation, so components that reach the top three rows may
come in another order (equal as a set); its own test shows it.

Skipped only where there is no host C++ compiler, as
``tests/test_native.py`` is.
"""

import os
import shutil
import stat
import time

import numpy as np
import pytest
import torch
from scipy import ndimage

from pero_ocr_tpu.models.recognizer import CTCRecognizer as FlaxRecognizer
from pero_ocr_tpu.models.recognizer import RecognizerSpec as FlaxSpec
from pero_ocr_tpu.parallel.pipeline import TPUPagePipeline
from pero_ocr_tpu.utils import native as jax_native
from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.layout_engines.cnn_engine import separator_penalties
from pero_ocr_tpu_torch.models.parsenet import ParseNet
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.ops import morphology
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.utils import kernels
from pero_ocr_tpu_torch.utils import native

RECOGNIZER = dict(num_classes=6, line_height=16, conv_features=(4, 8), subsampling=4,
                  lstm_layers=1, lstm_features=8)
JAX_BUILD_WAIT_S = 60


def jax_native_library():
    """The JAX package's native library (``native/libperotpu.so``), or
    None where it cannot be built.

    Its loader builds the file with ``make -C native`` at first use,
    writing it in place, and remembers a failed load for the rest of the
    process.  pytest-xdist's workers import the test files at once: a
    worker that finds the file while another worker's build is still
    writing it fails to load it, and every test of that worker that
    needs the library would skip.  So while the file exists and does not
    load, ask the loader again, for up to JAX_BUILD_WAIT_S seconds."""
    lib = jax_native.get_library()
    deadline = time.monotonic() + JAX_BUILD_WAIT_S
    while lib is None and os.path.exists(jax_native._LIB_PATH) and time.monotonic() < deadline:
        time.sleep(0.5)
        with jax_native._lock:
            jax_native._load_attempted = False
        lib = jax_native.get_library()
    return lib


@pytest.fixture(autouse=True)
def _compiler():
    if shutil.which(os.environ.get("CXX") or "c++") is None:
        pytest.skip("no host C++ compiler")
    if jax_native_library() is None:
        pytest.skip("the JAX package's native library is unavailable")


def _pipe(route, **kwargs):
    """A tiny page pipeline on the CPU; ``route`` is its ``native``."""
    pn = ParseNet(base_features=4, depth=2, stem="s2d", out_upsample=2,
                  generator=torch.Generator().manual_seed(0))
    rec = CTCRecognizer(RecognizerSpec(**RECOGNIZER), generator=torch.Generator().manual_seed(1))
    return TorchPagePipeline(pn, rec, device="cpu", native=route, **kwargs)


@pytest.fixture(scope="module")
def pipes():
    return {"native": _pipe(True), "numpy": _pipe(False)}


def _jax_pipe(**kwargs):
    return TPUPagePipeline(None, None, FlaxRecognizer(FlaxSpec(**RECOGNIZER)), None, **kwargs)


def _assert_lines_equal(got, want):
    (gb, gh), (wb, wh) = got, want
    assert len(gb) == len(wb) == len(gh) == len(wh)
    for a, b in zip(gb, wb):
        np.testing.assert_array_equal(a, b)
    assert gh == wh


# ----------------------------------------------------------------------
# Routes and the build

def test_route_follows_the_device_unless_asked():
    assert native.use_native(None, None) and native.use_native(None, "cuda")
    assert not native.use_native(None, "cpu")
    assert native.use_native(True, "cpu") and not native.use_native(False, "cuda")
    assert not _pipe(None).native and not _pipe(None)._clusterer.native
    assert _pipe(True).native and _pipe(True)._clusterer.native


def test_library_is_built_from_the_ports_source():
    assert kernels.source("perotpu") == kernels.CSRC / "perotpu.cpp"
    assert "perotpu" in kernels.host_sources() and "perotpu" not in kernels.sources()
    lib = native.get_library()
    target = kernels._target("perotpu", kernels._command("perotpu"))
    assert lib._name == str(target) and target.parent == kernels.BUILD_DIR
    assert target.exists()


def _fake_compiler(tmp_path):
    """A 'compiler' that knows its version and fails every build."""
    path = tmp_path / "fake-cxx"
    path.write_text('#!/bin/sh\nif [ "$1" = --version ]; then echo fake 1.0; exit 0; fi\n'
                    'echo "fake-cxx: error"; exit 1\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_host_build_raises_and_does_not_fall_back(monkeypatch, tmp_path, compiler):
    cxx = str(tmp_path / "no-such-c++") if compiler == "missing" else _fake_compiler(tmp_path)
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(kernels, "_libraries", {})
    with pytest.raises(RuntimeError):
        native.native_label(np.ones((4, 4), np.uint8))
    pipe = _pipe(True)
    page = np.random.default_rng(0).integers(0, 256, (128, 128, 3), dtype=np.uint8)
    with pytest.raises(RuntimeError):
        list(pipe.run([page], page_batch=1))
    assert not list((tmp_path / "kernels").glob("*.so"))


# ----------------------------------------------------------------------
# cc_label_u8

def _mask(case, rng):
    if case == "empty":
        return np.zeros((7, 9), np.uint8)
    if case == "full":
        return np.ones((7, 9), np.uint8)
    if case == "top_rows":
        m = np.zeros((20, 33), np.uint8)
        m[0, 3:9] = m[1, 14:20] = m[0, 25:27] = m[2, 30:33] = 1
        return m
    if case == "odd_width":
        return (rng.random((41, 77)) > 0.6).astype(np.uint8)
    return (rng.random((64, 96)) > rng.uniform(0.3, 0.9)).astype(np.uint8)


@pytest.mark.parametrize("case", ["empty", "full", "top_rows", "odd_width", "random"])
def test_label_matches_scipy_and_jax(case):
    mask = _mask(case, np.random.default_rng(1))
    got, n = native.native_label(mask)
    want, n_want = ndimage.label(mask, structure=np.ones((3, 3)))
    assert n == n_want
    np.testing.assert_array_equal(got, want)
    jax_got, jax_n = jax_native.native_label(mask)
    assert n == jax_n
    np.testing.assert_array_equal(got, jax_got)
    for route in (True, False):
        labels, num = morphology.connected_components(mask.astype(bool), route)
        assert num == n
        np.testing.assert_array_equal(labels, want)


# ----------------------------------------------------------------------
# cc_baselines_f32

def _quarter_heights(rng, shape):
    """Heights maps as the fast path has them: quarter pixels, some
    negative (the parse clips them at 0)."""
    return (rng.integers(-8, 256, shape + (2,)) / 4.0).astype(np.float32)


@pytest.mark.parametrize("case", ["empty", "full", "top_rows", "odd_width", "random"])
def test_cc_baselines_matches_numpy_and_jax(pipes, case):
    rng = np.random.default_rng(2)
    mask = _mask(case, rng)
    connected = ndimage.maximum_filter(mask, size=(5, 3), mode="constant")
    labels, num = ndimage.label(connected, structure=np.ones((3, 3)))
    labels = (labels * mask).astype(np.int32)
    heights = _quarter_heights(rng, mask.shape)
    got = pipes["native"]._component_lines(labels, num, heights, 4)
    want = pipes["numpy"]._component_lines(labels, num, heights, 4)
    _assert_lines_equal(got, want)
    if num:
        ours = native.native_cc_baselines(labels, heights, num)
        theirs = jax_native.native_cc_baselines(labels, heights, num)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    # The whole unpacked parse, labeling included.
    _assert_lines_equal(pipes["native"]._lines_from_masks(mask, connected, heights, 2),
                        pipes["numpy"]._lines_from_masks(mask, connected, heights, 2))


# ----------------------------------------------------------------------
# cc_lines_packed

def _packed(rng, h, wb, density, top_rows=False):
    """A (h, wb) packed mask of short horizontal runs; rows 0-2 empty
    unless ``top_rows``."""
    bits = np.zeros((h, wb * 8), np.uint8)
    n = int(density * h * wb)
    ys = rng.integers(0 if top_rows else 3, h, n)
    xs = rng.integers(0, wb * 8, n)
    for y, x in zip(ys, xs):
        bits[y, x: x + rng.integers(1, 12)] = 1
    return np.packbits(bits, axis=1, bitorder="little")


def _packed_lines(out, ds):
    """``native_cc_lines_packed``'s components as (baselines, heights)
    scaled by ``ds``, as the parse of the unpacked mask gives them."""
    pts, npts, hts, n = out[:4]
    return ([ds * pts[c, : npts[c]] for c in range(n)],
            [[ds * float(hts[c, 0]), ds * float(hts[c, 1])] for c in range(n)])


def _numpy_packed(pipe, packed, heights_q, ds):
    """The numpy twin of cc_lines_packed: unpack, dilate, label, parse;
    the set-bit count and the channel-0 histogram under the set bits."""
    sep_q = np.zeros((1, 1, 1), np.uint8)
    masks, connecteds, heights_maps, _ = pipe._unpack_stage_a(
        packed[None], heights_q[None], sep_q
    )
    lines = pipe._lines_from_masks(masks[0], connecteds[0], heights_maps[0], ds)
    hf = packed.shape[0] // heights_q.shape[0]
    q0 = heights_q[..., 0].repeat(hf, axis=0).repeat(hf, axis=1)
    sel = masks[0] > 0
    return lines, int(sel.sum()), np.bincount(q0[sel], minlength=256)


@pytest.mark.parametrize("case", ["empty", "full", "sparse", "dense"])
@pytest.mark.parametrize("hf", [1, 2, 4])
@pytest.mark.parametrize("wb", [5, 8])
def test_cc_lines_packed_matches_numpy_and_jax(pipes, case, hf, wb):
    rng = np.random.default_rng(3 + hf + wb)
    h = 48
    if case == "empty":
        packed = np.zeros((h, wb), np.uint8)
    elif case == "full":
        packed = np.full((h, wb), 255, np.uint8)
    else:
        packed = _packed(rng, h, wb, 0.05 if case == "sparse" else 0.4)
    heights_q = rng.integers(0, 256, (h // hf, wb * 8 // hf, 2), dtype=np.uint8)
    ours = native.native_cc_lines_packed(packed, heights_q, hf)
    theirs = jax_native.native_cc_lines_packed(packed, heights_q, hf)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    lines, n_px, hist = _numpy_packed(pipes["numpy"], packed, heights_q, 4)
    _assert_lines_equal(_packed_lines(ours, 4), lines)
    assert ours[4] == n_px and ours[3] == len(lines[0])
    np.testing.assert_array_equal(ours[5], hist)
    if case in ("full", "dense"):
        assert ours[3] >= 1


def test_cc_lines_packed_orders_top_border_components_by_mask_pixel(pipes):
    """A starts in row 1 at x 48, B in row 0 at x 100: B comes first in
    the mask's raster order, A first after the dilation clamps both to
    row 0 (A at column 47, B at 99).  ``cc_lines_packed`` (the JAX crop
    transport's parse) emits B, A.  The page transport, the JAX one and
    the port's on both routes, labels the unpacked mask in scipy's order
    and emits A, B.  The lines are the same."""
    packed_bits = np.zeros((16, 128), np.uint8)
    packed_bits[1, 48:60] = 1
    packed_bits[0, 100:112] = 1
    packed = np.packbits(packed_bits, axis=1, bitorder="little")
    heights_q = np.full((4, 32, 2), 40, np.uint8)
    ours = native.native_cc_lines_packed(packed, heights_q, 4)
    for a, b in zip(ours, jax_native.native_cc_lines_packed(packed, heights_q, 4)):
        np.testing.assert_array_equal(a, b)
    got = _packed_lines(ours, 4)
    want, _, _ = _numpy_packed(pipes["numpy"], packed, heights_q, 4)
    assert [b[0, 0] for b in got[0]] == [4 * 98.0, 4 * 46.0]
    assert [b[0, 0] for b in want[0]] == [4 * 46.0, 4 * 98.0]
    _assert_lines_equal((got[0][::-1], got[1][::-1]), want)
    _assert_lines_equal(_numpy_packed(pipes["native"], packed, heights_q, 4)[0], want)
    jpipe = _jax_pipe()
    masks, connecteds, heights_maps, _ = jpipe._unpack_stage_a(
        packed[None], heights_q[None], np.zeros((1, 1, 1), np.uint8))
    _assert_lines_equal(jpipe._lines_from_masks(masks[0], connecteds[0], heights_maps[0], 4),
                        want)


def _crowded(h=264, wb=128):
    """More than 4096 components of 6 pixels: runs 10 px apart in x, 6
    rows apart in y (the connection reaches 3 px and 5 rows)."""
    bits = np.zeros((h, wb * 8), np.uint8)
    for y in range(3, h, 6):
        for x in range(0, wb * 8 - 6, 10):
            bits[y, x: x + 6] = 1
    return np.packbits(bits, axis=1, bitorder="little")


def test_component_budget_overflow_takes_the_unpacked_route_as_jax():
    """Past 4096 components ``cc_lines_packed`` gives up (None) on both
    sides.  The page transport does not read the packed mask: it
    unpacks and labels every page, so a batch whose middle page has
    more than 4096 components gets the JAX page transport's lines on
    both routes."""
    packed = _crowded()
    heights_q = np.full((packed.shape[0] // 4, packed.shape[1] * 2, 2), 48, np.uint8)
    assert native.native_cc_lines_packed(packed, heights_q, 4) is None
    assert jax_native.native_cc_lines_packed(packed, heights_q, 4) is None
    rng = np.random.default_rng(5)
    light = [_packed(rng, *packed.shape, 0.002) for _ in range(2)]
    batch = np.stack([light[0], packed, light[1]])
    hq = np.repeat(heights_q[None], 3, axis=0)
    sep_q = rng.integers(0, 256, (3, packed.shape[0] // 2, packed.shape[1] * 2), dtype=np.uint8)
    jpipe = _jax_pipe(cluster_paragraphs=False)
    want, _, _ = jpipe._batch_lines(
        [None] * 3, [0, 1, 2], None, jpipe._unpack_stage_a(batch, hq, sep_q), 4
    )
    for route in (True, False):
        pipe = _pipe(route, cluster_paragraphs=False)
        calls = (native.calls["cc_lines_packed"], native.calls["cc_label_u8"])
        got, _, _ = pipe._batch_lines(
            [None] * 3, [0, 1, 2], None, pipe._unpack_stage_a(batch, hq, sep_q), 4
        )
        assert len(got[1][0]) > 4096
        for g, w in zip(got, want):
            _assert_lines_equal(g[:2], w[:2])
        assert native.calls["cc_lines_packed"] == calls[0]
        assert native.calls["cc_label_u8"] - calls[1] == (3 if route else 0)


# ----------------------------------------------------------------------
# The adaptive decision

@pytest.mark.parametrize("case", ["seeded", "between_bins", "few_pixels", "in_band"])
def test_adapt_decision_matches_jax(case):
    """The page transport decides from the unpacked maps, as the JAX
    one does; ``cc_lines_packed``'s set-bit counts and histograms give
    the JAX crop transport's decision (``_adapt_from_stats``) the same
    scale, a median between two bins included."""
    rng = np.random.default_rng(6)
    packed = np.stack([_packed(rng, 64, 16, 0.05) for _ in range(2)])
    heights_q = rng.integers(0, 120, (2, 16, 32, 2), dtype=np.uint8)
    if case == "between_bins":
        # The same 320 set bits on both pages, under q 60 (15.0 px, in
        # the band) on one and 61 on the other: the median 15.125 lies
        # between two bins and out of the band.
        packed[:] = 0
        packed[:, 10:20, 2:6] = 0xFF
        heights_q[0, ..., 0], heights_q[1, ..., 0] = 60, 61
    elif case == "few_pixels":
        packed[:] = 0
        packed[0, 10, 2] = 0xFF
    elif case == "in_band":
        heights_q[..., 0] = 48
    sep_q = np.zeros((2, 32, 32), np.uint8)
    stats = [native.native_cc_lines_packed(packed[s], heights_q[s], 4) for s in range(2)]
    total, hist = sum(o[4] for o in stats), sum(o[5] for o in stats)
    decisions = []
    for route in (True, False):
        pipe = _pipe(route, adaptive_downsample=True)
        decisions.append((pipe._adapt_target_ds(pipe._unpack_stage_a(packed, heights_q, sep_q), 4),
                          pipe._last_ds))
    for from_stats in (True, False):
        jpipe = _jax_pipe(adaptive_downsample=True)
        jpipe._last_ds = 4
        got = (jpipe._adapt_from_stats(total, hist, 4) if from_stats else
               jpipe._adapt_target_ds(jpipe._unpack_stage_a(packed, heights_q, sep_q), 4))
        decisions.append((got, jpipe._last_ds))
    assert decisions[1:] == decisions[:1] * 3
    if case == "few_pixels" or case == "in_band":
        assert decisions[0][0] is None
    if case == "between_bins":
        assert decisions[0] == (6, 6)  # 4 * 15.125 / 12 -> the ladder's 6


# ----------------------------------------------------------------------
# separator_penalties_f32

def _penalty_queries(rng, n_lines=6, h=96, w=128):
    lines = []
    for k in range(n_lines):
        n = int(rng.integers(1, 6))
        xs = np.sort(rng.uniform(-10, w + 10, n))
        if k == 1:
            xs = np.full(n, xs[0])  # a vertical line: no span
        lines.append(np.stack([xs, rng.uniform(0, h, n)], axis=1))
    offs = np.cumsum([0] + [len(b) for b in lines])
    bx, by = np.concatenate(lines).T
    q = 40
    q_line = rng.integers(0, n_lines, q)
    q_shift = rng.uniform(-10, 10, q)
    x1 = rng.uniform(-10, w + 10, q)
    x2 = x1 + rng.uniform(-5, 80, q)
    # Window ends and interpolated rows on .5: llround rounds away from 0.
    x1[:8] = np.floor(x1[:8]) + 0.5
    x2[:8] = np.floor(x2[:8]) + 0.5
    x1[8], x2[8] = -0.5, 30.5
    q_shift[9:12] = 0.5 - by[offs[q_line[9:12]]] % 1.0
    return bx, by, offs, q_line, q_shift, x1, x2


@pytest.mark.parametrize("pool", [1, 2, 4])
def test_separator_penalties_match_numpy_and_jax(pool):
    rng = np.random.default_rng(7 + pool)
    args = _penalty_queries(rng)
    sep = rng.random((96 // pool, 128 // pool)).astype(np.float32)
    got = native.native_separator_penalties(*args, sep, pool)
    np.testing.assert_array_equal(got, separator_penalties(*args, sep, pool))
    bx, by, offs, q_line, *rest = args
    theirs = jax_native.native_separator_penalties(
        bx, by, np.asarray(offs, np.int32), np.asarray(q_line, np.int32), *rest, sep, pool
    )
    np.testing.assert_array_equal(got, theirs)
    assert (got == 1.0).any() and (got != 1.0).any()


def test_separator_penalties_reject_out_of_range_queries():
    args = list(_penalty_queries(np.random.default_rng(8)))
    args[3] = args[3].copy()
    args[3][0] = 99
    with pytest.raises(ValueError):
        native.native_separator_penalties(*args, np.zeros((96, 128), np.float32))


# ----------------------------------------------------------------------
# polygons_close_f64

def _touching_polygons():
    """Squares 3.0 apart side by side, a triangle whose apex is 3.0
    above a square's edge (no vertex pair that close), a far one."""
    square = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], float)
    return [square, square + [13, 0], np.array([[5, 13], [0, 20], [10, 20]], float),
            square + [100, 100]]


@pytest.mark.parametrize("case", ["at_threshold", "below_threshold", "random", "page_scale"])
def test_polygons_close_matches_numpy_and_jax(case):
    if case == "random":
        rng = np.random.default_rng(9)
        polys = [c + rng.uniform(-20, 20, (int(rng.integers(3, 9)), 2))
                 for c in rng.uniform(0, 100, (8, 2))]
        pairs = np.array([(i, j) for i in range(8) for j in range(i + 1, 8)])
        thresholds = rng.uniform(0, 30, len(pairs))
    elif case == "page_scale":
        # Outlines over a page: most pairs lie far apart (the C++'s box
        # reject); the first 60 thresholds are the pairs' box gaps.
        rng = np.random.default_rng(11)
        polys = [c + rng.uniform(-40, 40, (int(rng.integers(4, 24)), 2))
                 for c in rng.uniform(0, 3000, (40, 2))]
        pairs = np.array([(i, j) for i in range(40) for j in range(i + 1, 40)])
        thresholds = rng.uniform(0, 300, len(pairs))
        lo = np.array([p.min(axis=0) for p in polys])
        hi = np.array([p.max(axis=0) for p in polys])
        i, j = pairs[:60, 0], pairs[:60, 1]
        gap = np.maximum(np.maximum(lo[i] - hi[j], lo[j] - hi[i]), 0.0)
        thresholds[:60] = np.hypot(gap[:, 0], gap[:, 1])
    else:
        polys = _touching_polygons()
        pairs = np.array([[0, 1], [0, 2], [1, 2], [0, 3]])
        thr = 3.0 if case == "at_threshold" else np.nextafter(3.0, 0.0)
        thresholds = np.full(len(pairs), thr)
    got = native.native_polygons_close(polys, pairs, thresholds)
    np.testing.assert_array_equal(got, geometry.polygons_close(polys, pairs, thresholds))
    np.testing.assert_array_equal(got, jax_native.native_polygons_close(polys, pairs, thresholds))
    if case == "at_threshold":
        assert got.tolist() == [True, True, False, False]  # <=: touching counts
    if case == "below_threshold":
        assert not got.any()


def test_polygons_close_empty_and_bad_pairs():
    polys = _touching_polygons()
    assert native.native_polygons_close(polys, np.zeros((0, 2), int), np.zeros(0)).shape == (0,)
    with pytest.raises(ValueError):
        native.native_polygons_close(polys, np.array([[0, 4]]), np.ones(1))


# ----------------------------------------------------------------------
# The forced alignment's Viterbi

def _viterbi_inputs(rng, case):
    """(T, S) gathered costs and the skip mask of a label sequence with
    repeats; ``uniform``: every path costs the same; ``inf``: costs of
    +inf (log 0) on some states; ``long``: a page-wide line."""
    n = {"short": 2, "random": 9, "uniform": 4, "inf": 6, "long": 60}[case]
    t = {"short": 5, "random": 40, "uniform": 12, "inf": 30, "long": 512}[case]
    labels = rng.integers(0, 10, n)
    labels[1::3] = labels[0::3][: len(labels[1::3])]
    states = np.full(2 * n + 1, 10)
    states[1::2] = labels
    skip = np.zeros(len(states), bool)
    skip[3::2] = states[3::2] != states[1:-2:2]
    logits = rng.normal(0, 3, (t, 11))
    if case == "uniform":
        logits[:] = 0.0
    logprobs = (logits - np.logaddexp.reduce(logits, axis=1, keepdims=True)).astype(np.float32)
    costs = -logprobs[:, states]
    if case == "inf":
        costs[rng.random(costs.shape) < 0.1] = np.inf
        costs[:, -2:] = np.minimum(costs[:, -2:], 50.0)
    return costs, skip


@pytest.mark.parametrize("case", ["short", "random", "uniform", "inf", "long"])
def test_viterbi_matches_numpy_and_jax(case):
    """viterbi_ctc_f32 against the JAX binding of its own library (equal
    paths) and the numpy twin, whose float64 sums equal the float32 ones
    here (ties: stay, then advance, then skip; the last label before the
    last blank)."""
    from pero_ocr_tpu_torch.core.force_alignment import viterbi_ctc

    costs, skip = _viterbi_inputs(np.random.default_rng(len(case)), case)
    got = native.native_viterbi_ctc(costs, skip)
    assert got.dtype == np.int32 and got.shape == (costs.shape[0],)
    np.testing.assert_array_equal(got, jax_native.native_viterbi_ctc(costs, skip))
    np.testing.assert_array_equal(got, viterbi_ctc(costs, skip))
    assert got[-1] >= costs.shape[1] - 2 and (np.diff(got) >= 0).all()


def test_viterbi_without_a_path_raises_as_jax():
    costs = np.zeros((2, 7), np.float32)  # 3 labels need 3 frames or more
    skip = np.array([0, 0, 0, 1, 0, 1, 0], bool)
    with pytest.raises(ValueError) as got:
        native.native_viterbi_ctc(costs, skip)
    with pytest.raises(ValueError) as want:
        jax_native.native_viterbi_ctc(costs, skip)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        native.native_viterbi_ctc(costs, skip[:-1])
    before = native.calls["viterbi_ctc_f32"]
    native.native_viterbi_ctc(np.zeros((3, 3), np.float32), np.zeros(3, bool))
    assert native.calls["viterbi_ctc_f32"] == before + 1


# ----------------------------------------------------------------------
# levenshtein_i32 (the transformer's chunk merge)
LEVENSHTEIN_CASES = {
    "empty": ("", ""),
    "empty_source": ("", "abc"),
    "empty_target": ("abcd", ""),
    "equal": ("kitten", "kitten"),
    "classic": ("kitten", "sitting"),
    "unicode": ("žluťoučký kůň", "zlutoucky kun"),
    "symbols": ("€€\u200b<>&", "<€&\u200b"),
}


@pytest.mark.parametrize("case", sorted(LEVENSHTEIN_CASES))
def test_levenshtein_matches_numpy_and_jax(case):
    """levenshtein_i32 on symbols mapped to ids (one table, in order of
    first appearance) against its numpy twin, the JAX binding of its own
    library and the JAX package's levenshtein_distance: equal."""
    from pero_ocr_tpu.sequence_alignment import levenshtein_distance as jax_levenshtein
    from pero_ocr_tpu_torch import sequence_alignment

    a, b = LEVENSHTEIN_CASES[case]
    src, tgt = sequence_alignment.symbols_to_ids(list(a), list(b))
    before = native.calls["levenshtein_i32"]
    got = native.native_levenshtein(src, tgt)
    assert native.calls["levenshtein_i32"] == before + 1
    assert got == sequence_alignment.levenshtein_ids(src, tgt) == \
        jax_native.native_levenshtein(src, tgt) == jax_levenshtein(list(a), list(b))
    for route in (True, False):
        assert sequence_alignment.levenshtein_distance(list(a), list(b), native=route) == got
    if case == "equal":
        assert got == 0
    elif case.startswith("empty"):
        assert got == max(len(a), len(b))


def test_levenshtein_seeded_pairs_match_numpy_and_jax():
    from pero_ocr_tpu_torch import sequence_alignment

    rng = np.random.default_rng(17)
    for _ in range(200):
        src = rng.integers(0, int(rng.integers(1, 8)), int(rng.integers(0, 40))).astype(np.int32)
        tgt = rng.integers(0, int(rng.integers(1, 8)), int(rng.integers(0, 40))).astype(np.int32)
        got = native.native_levenshtein(src, tgt)
        assert got == sequence_alignment.levenshtein_ids(src, tgt)
        assert got == jax_native.native_levenshtein(src, tgt)


# ----------------------------------------------------------------------
# The clustering on both routes

def test_make_clusters_same_on_both_routes(pipes):
    """Two columns of lines with a separator between them: the same
    clusters, penalties and pair flags on both routes."""
    rng = np.random.default_rng(10)
    b_list, h_list = [], []
    for x0 in (20.0, 300.0):
        for y in range(40, 400, 30):
            b_list.append(np.array([[x0, y], [x0 + 200, y + rng.uniform(-2, 2)]]))
            h_list.append([12.0, 4.0])
    sep = np.zeros((100, 140), np.float32)
    sep[:, 68:71] = 1.0
    sep[50, :] = 0.6
    out = {}
    for route, pipe in pipes.items():
        calls = (native.calls["polygons_close_f64"], native.calls["separator_penalties_f32"])
        clusters, _ = pipe._cluster_lines(b_list, h_list, sep, 4, 1)
        used = (native.calls["polygons_close_f64"] - calls[0],
                native.calls["separator_penalties_f32"] - calls[1])
        assert used == ((1, 1) if route == "native" else (0, 0))
        out[route] = clusters
    assert out["native"] == out["numpy"]
    assert len(set(out["native"])) >= 2
