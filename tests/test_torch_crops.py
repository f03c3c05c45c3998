"""The crop transport (``TorchPagePipeline(transport="crops")``, its host
code in ``pero_ocr_tpu_torch/parallel/crop_transport.py``) against the
JAX ``TPUPagePipeline(transport="crops")`` on the CPU.

The pipelines are tests/test_torch_pipeline.py's: the toy trained
detector with the super-resolving head and the random recognizer, the
same float32 weights on both sides.  The port runs its C++ host route
(``native=True``): the JAX pipeline warps straight lines with its
native library, which this host builds with -march=native, so the
port's C++ must pick the same AVX2 body to give the same bytes.  The
JAX side is pinned to that library (``jax_native_library``), never to
its ``cv2.warpAffine`` fallback.

Held to:

- ``warp_affine_lines_u8``: the port's C++ equals the JAX binding byte
  for byte; its numpy twin equals the C++ scalar body byte for byte, and
  the AVX2 body is within 1 gray level of it (the two round their
  coordinates apart).
- ``_pack2`` (with and without dither), ``unpack2``, the canvas, the
  dense buffer and the strip: equal bytes.
- The pipelines: the same lines (baselines within 1e-4 px, equal
  heights), clusters, crop widths, label dtype, labels and lengths;
  confidences within 1e-5; the lines' top-k logits within one float16
  ulp and equal indices (a padding slot's logits are all equal, and
  ``torch.topk`` orders ties otherwise than ``lax.top_k``); for bits 8, 4 and 2, strip and dense, CNN detection and
  a lines override, ``skip_stage_a``, mixed page sizes, a batch without
  lines, ``prime``, the adaptive downsample, ``canvas_bits`` 2 and the
  dithered 2-bit crops.  The numpy route gives the C++ route's lines,
  labels and confidences on these pages (not its top-k order: its
  straight crops are the scalar body's).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from pero_ocr_tpu.models.recognizer import CTCRecognizer as FlaxRecognizer
from pero_ocr_tpu.models.recognizer import RecognizerSpec as FlaxSpec
from pero_ocr_tpu.parallel.pipeline import TPUPagePipeline
from pero_ocr_tpu.utils import native as jax_native
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.parallel.crop_transport import unpack_bits, warp_affine_lines
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.utils import native
from tests.test_torch_native import jax_native_library
from tests.test_torch_pipeline import PIPELINE, RECOGNIZER, _override, _page
from tests.test_torch_pipeline import models  # noqa: F401  (fixture)

pytestmark = pytest.mark.skipif(
    shutil.which(os.environ.get("CXX") or "c++") is None or jax_native_library() is None,
    reason="no host C++ compiler or the JAX package's native library is unavailable")

CONF_ATOL = 1e-5


def _pages():
    return [_page(), _page(shift=8, seed=1), _page(shift=-4, seed=2)]


# ----------------------------------------------------------------------
# warp_affine_lines_u8

def _warp_case(case, seed=0):
    """A gray page and (mats, widths) of 12 lines: straight, tilted, or
    reaching past the page's borders."""
    rng = np.random.default_rng(seed)
    h, w = 120, 260
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mats, widths = [], []
    for _ in range(12):
        angle = {"straight": 0.0, "tilted": rng.uniform(-0.15, 0.15),
                 "border": rng.uniform(-0.05, 0.05)}[case]
        scale = rng.uniform(0.6, 1.4)
        dv = rng.uniform(0.4, 1.2)
        if case == "border":
            x0, y0 = rng.uniform(-30, w - 10), rng.choice([-8.0, h - 12.0, rng.uniform(0, h)])
        else:
            x0, y0 = rng.uniform(2, w / 3), rng.uniform(2, h - 40)
        u = np.array([np.cos(angle), np.sin(angle)])
        mats.append([[u[0] * scale, -u[1] * dv, x0], [u[1] * scale, u[0] * dv, y0]])
        widths.append(int(rng.integers(1, 230)))
    return gray, np.array(mats), np.array(widths, np.int32)


def _warp_into(fn, gray, mats, widths, hc, layout, **kwargs):
    """Run a warp into the dense (n, hc, 240) buffer or the width-major
    strip; returns the buffer."""
    n = len(widths)
    if layout == "dense":
        out = np.full((n, hc, 240), 7, np.uint8)
        offsets, sc, sr = np.arange(n) * hc * 240, 1, 240
    else:
        out = np.full((int(widths.sum()), hc), 7, np.uint8)
        offsets, sc, sr = np.concatenate([[0], np.cumsum(widths)[:-1]]) * hc, hc, 1
    assert fn(gray, mats, widths, hc, out, offsets.astype(np.int64), sc, sr, **kwargs) in (
        True, None)
    return out


@pytest.mark.parametrize("layout", ["dense", "strip"])
@pytest.mark.parametrize("case", ["straight", "tilted", "border"])
def test_warp_affine_equals_the_jax_binding_and_the_twin(case, layout):
    gray, mats, widths = _warp_case(case)
    ours = _warp_into(native.native_warp_affine_lines, gray, mats, widths, 16, layout)
    theirs = _warp_into(jax_native.native_warp_affine_lines, gray, mats, widths, 16, layout)
    np.testing.assert_array_equal(ours, theirs)
    scalar = _warp_into(native.native_warp_affine_lines, gray, mats, widths, 16, layout,
                        scalar=True)
    twin = _warp_into(warp_affine_lines, gray, mats, widths, 16, layout)
    np.testing.assert_array_equal(twin, scalar)
    assert np.abs(ours.astype(int) - twin.astype(int)).max() <= 1
    if native.warp_affine_avx2():
        assert (ours != twin).any() or case == "border"  # the AVX2 body ran
    assert (twin != 7).any()


def test_warp_affine_rejects_lines_outside_the_buffer():
    gray, mats, widths = _warp_case("straight")
    out = np.zeros((len(widths), 16, 100), np.uint8)  # narrower than the widest line
    with pytest.raises(ValueError, match="outside out"):
        native.native_warp_affine_lines(gray, mats, widths, 16, out,
                                        np.arange(len(widths)) * 1600, 1, 100)


# ----------------------------------------------------------------------
# Packing and the host crops

@pytest.mark.parametrize("dither", [False, True])
def test_pack2_and_unpack_equal_jax(dither):
    rng = np.random.default_rng(3)
    grays = rng.integers(0, 256, (3, 6, 16), dtype=np.uint8)
    grays[0, 0, :4] = (0, 42, 43, 255)
    packed = TorchPagePipeline._pack2(grays, dither)
    np.testing.assert_array_equal(packed, TPUPagePipeline._pack2(grays, dither))
    jpipe = TPUPagePipeline(None, None, FlaxRecognizer(FlaxSpec(**RECOGNIZER)), None,
                            transport="crops")
    got = unpack_bits(torch.from_numpy(packed), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpipe._unpack2(packed)))
    assert set(np.unique(got)) <= {0, 85, 170, 255}
    four = TorchPagePipeline._pack4(grays)
    np.testing.assert_array_equal(unpack_bits(torch.from_numpy(four), 4).numpy(),
                                  np.asarray(jpipe._unpack4(four)))
    # Rank-2 input (the strip) unpacks along its last axis.
    np.testing.assert_array_equal(unpack_bits(torch.from_numpy(packed[0]), 2).numpy(), got[0])


def _pair(models, native_route=True, **kwargs):
    """(JAX pipeline, port pipeline) on the crop transport with the same
    weights and settings."""
    (flax_pn, pn_vars, flax_rec, rec_vars), torch_models = models
    kwargs = dict(PIPELINE, transport="crops", **kwargs)
    jax_pipe = TPUPagePipeline(flax_pn, pn_vars, flax_rec, rec_vars, **kwargs)
    pn, rec = torch_models()
    return jax_pipe, TorchPagePipeline(pn, rec, device="cpu", native=native_route, **kwargs)


def _curved_lines():
    xs = np.linspace(20, 300, 10)
    curved = np.stack([xs, 120 + 9 * np.sin(np.linspace(0, np.pi, 10))], 1)
    tilted = np.array([[30.0, 60.0], [160.0, 66.0], [290.0, 72.0]])
    off_page = np.array([[-20.0, 252.0], [330.0, 250.0]])
    return [curved, tilted, off_page], [[12.0, 4.0], [10.0, 3.0], [14.0, 5.0]]


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_host_crops_and_strip_equal_jax(models, bits):
    jax_pipe, port = _pair(models, transport_bits=bits, dither_2bit=bits == 2)
    gray = port._gray(_page())
    b_list, h_list = _curved_lines()
    assert port._line_affine(b_list[0], h_list[0]) is None  # the curved one
    crops, widths = port._host_crops(gray, b_list, h_list, 8)
    want_crops, want_widths = jax_pipe._host_crops(gray, b_list, h_list, 8)
    np.testing.assert_array_equal(crops, want_crops)
    np.testing.assert_array_equal(widths, want_widths)
    for bl, hh in zip(b_list, h_list):
        np.testing.assert_array_equal(port._host_crop_line(gray, bl, hh),
                                      jax_pipe._host_crop_line(gray, bl, hh))
    grays = np.stack([gray, port._gray(_page(shift=8, seed=1))])
    page_lines = [(b_list, h_list, None, None), ([], [], None, None)]
    (strip, offsets, swidths), per_page = port._build_strip(grays, page_lines, 8, 2)
    (want_strip, want_offsets, want_swidths), want_pages = jax_pipe._build_strip(
        grays, page_lines, 8, 2)
    np.testing.assert_array_equal(strip, want_strip)
    np.testing.assert_array_equal(offsets, want_offsets)
    np.testing.assert_array_equal(swidths, want_swidths)
    np.testing.assert_array_equal(per_page[0], want_pages[0])
    assert per_page[1] is want_pages[1] is None
    assert port._rebuild_width(swidths) == jax_pipe._rebuild_width(swidths)
    assert port._strip_cols(int(swidths.sum())) == jax_pipe._strip_cols(int(swidths.sum()))


@pytest.mark.parametrize("ds", [2, 3, 4])
def test_canvas_equals_jax(models, ds):
    jax_pipe, port = _pair(models)
    gray = port._gray(_page(shift=3, seed=4))[:250, :317]
    np.testing.assert_array_equal(port._canvas(gray, ds), jax_pipe._canvas(gray, ds))


# ----------------------------------------------------------------------
# The pipelines

def assert_results_equal(got, want, logits=False):
    assert [r.page_index for r in got] == [r.page_index for r in want]
    for g, w in zip(got, want):
        assert len(g.baselines) == len(w.baselines)
        for bg, bw in zip(g.baselines, w.baselines):
            np.testing.assert_allclose(bg, bw, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(np.asarray(g.heights), np.asarray(w.heights))
        assert g.clusters == w.clusters
        if w.labels is None:
            assert g.labels is None and g.crops_width is None
            continue
        np.testing.assert_array_equal(g.crops_width, w.crops_width)
        assert g.labels.dtype == w.labels.dtype
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.label_lengths, w.label_lengths)
        np.testing.assert_allclose(g.confidences, w.confidences, atol=CONF_ATOL, rtol=0)
        if logits:  # the lines' own (a padding slot's logits tie, and are never read)
            n = len(w.baselines)
            np.testing.assert_array_equal(g.logits_idx[:n], w.logits_idx[:n])
            np.testing.assert_allclose(g.logits_vals[:n].astype(np.float32),
                                       w.logits_vals[:n].astype(np.float32), rtol=1e-3,
                                       atol=1e-3)


@pytest.fixture(scope="module")
def jax_pipes(models):
    """One JAX crop-transport pipeline a depth, its compiled programs
    shared by the strip and dense cases (``trim_crops`` is read per
    batch)."""
    return {bits: _pair(models, transport_bits=bits)[0] for bits in (8, 4, 2)}


# Each depth with both payloads and both line sources, each payload with
# both sources (a pairwise cover of the three settings).
CROP_CASES = [(8, True, "cnn"), (8, False, "override"), (4, True, "override"),
              (4, False, "cnn"), (2, True, "cnn"), (2, False, "override")]


@pytest.mark.parametrize("bits,trim,source", CROP_CASES,
                         ids=[f"{b}-{'strip' if t else 'dense'}-{s}" for b, t, s in CROP_CASES])
def test_crop_transport_matches_jax(models, jax_pipes, bits, trim, source):
    jax_pipe = jax_pipes[bits]
    jax_pipe.trim_crops = trim
    port = _pair(models, transport_bits=bits, trim_crops=trim)[1]
    override = _override if source == "override" else None
    pages = _pages()
    want = list(jax_pipe.run(pages, lines_override=override, page_batch=2))
    got = list(port.run(pages, lines_override=override, page_batch=2))
    assert_results_equal(got, want)
    assert [len(r.baselines) for r in got] == [4, 4, 4]
    assert got[0].labels.dtype == np.uint8  # 8 classes: labels travel as bytes
    if source == "cnn":
        assert all(r.clusters is not None for r in got)


def test_crop_transport_logits_and_numpy_route_match(models):
    """Top-k logits on the strip; then the numpy host route (the twins
    of the packed parse and of the warp) on the same pages."""
    jax_pipe, port = _pair(models, transport_bits=4, want_logits=True)
    pages = _pages()
    want = list(jax_pipe.run(pages, page_batch=2))
    assert_results_equal(list(port.run(pages, page_batch=2)), want, logits=True)
    numpy_route = _pair(models, native_route=False, transport_bits=4, want_logits=True)[1]
    calls = native.calls["cc_lines_packed"], native.calls["warp_affine_lines_u8"]
    # Its straight crops are the scalar body's, within 1 gray level of
    # the AVX2 body's: the top-k order of near-equal logits may differ.
    assert_results_equal(list(numpy_route.run(pages, page_batch=2)), want)
    assert (native.calls["cc_lines_packed"], native.calls["warp_affine_lines_u8"]) == calls


def test_skip_stage_a_and_mixed_page_sizes_match_jax(models):
    """The recognize-only loop (no ParseNet on either side) on pages of
    three sizes, against the JAX loop; the same labels as with stage A."""
    (_, _, flax_rec, rec_vars), torch_models = models
    kwargs = dict(PIPELINE, transport="crops", transport_bits=4, cluster_paragraphs=False)
    jax_pipe = TPUPagePipeline(None, None, flax_rec, rec_vars, **kwargs)
    port = TorchPagePipeline(None, torch_models()[1], device="cpu", native=True, **kwargs)
    pages = [_page(), _page(shift=8, seed=1)[:200, :300], _page(seed=3)[:, :288]]
    want = list(jax_pipe.run(pages, lines_override=_override, page_batch=2, skip_stage_a=True))
    got = list(port.run(pages, lines_override=_override, page_batch=2, skip_stage_a=True))
    assert_results_equal(got, want)
    with_stage_a = _pair(models, transport_bits=4)[1]
    same = [_page()] * 3
    assert_results_equal(
        list(port.run(same, lines_override=_override, page_batch=2, skip_stage_a=True)),
        list(with_stage_a.run(same, lines_override=_override, page_batch=2)))
    dense = TorchPagePipeline(None, torch_models()[1], device="cpu", native=True,
                              trim_crops=False, **kwargs)
    with pytest.raises(ValueError, match="skip_stage_a currently requires trim_crops"):
        list(dense.run(pages, lines_override=_override, skip_stage_a=True))


def test_batches_without_lines_match_jax(models):
    """A batch whose pages have no lines yields geometry-only results
    on both loops; the strip's next batch recognizes normally."""
    jax_pipe, port = _pair(models, transport_bits=8)
    pages = _pages() + [_page(seed=5)]
    empty = [([], [])] * 2 + [_override(p) for p in pages[2:]]
    want = list(jax_pipe.run(pages, lines_override=empty, page_batch=2))
    got = list(port.run(pages, lines_override=empty, page_batch=2))
    assert_results_equal(got, want)
    assert [r.labels is None for r in got] == [True, True, False, False]
    blank = [np.full((256, 320, 3), 240, np.uint8)] * 2
    assert_results_equal(list(port.run(blank, page_batch=2)),
                         list(jax_pipe.run(blank, page_batch=2)))


def test_prime_adaptive_and_canvas_bits_match_jax(models):
    """``prime`` then run (the primed prep taken up, and a stale one
    ignored); the adaptive second pass from the packed statistics (one
    batch: the JAX loop reads the sticky scale for the next batch on its
    worker thread); a 2-bit canvas with dithered 2-bit crops."""
    pages = _pages()
    jax_pipe, port = _pair(models, transport_bits=4)
    want = list(jax_pipe.run(pages, page_batch=2))
    port.prime(pages, page_batch=2)
    assert port._primed is not None
    assert_results_equal(list(port.run(pages, page_batch=2)), want)
    assert port._primed is None
    port.prime(_pages()[1:], page_batch=2)  # other page objects: not taken
    assert_results_equal(list(port.run(pages, page_batch=2)), want)

    jax_pipe, port = _pair(models, transport_bits=8, adaptive_downsample=True)
    assert_results_equal(list(port.run(pages, page_batch=3)),
                         list(jax_pipe.run(pages, page_batch=3)))
    assert port._last_ds == jax_pipe._last_ds != PIPELINE["downsample"]

    jax_pipe, port = _pair(models, transport_bits=2, canvas_bits=2, dither_2bit=True)
    assert_results_equal(list(port.run(pages, page_batch=2)),
                         list(jax_pipe.run(pages, page_batch=2)))
    assert port.canvas_bits == 2


def test_transport_bits_bound_the_labels(models):
    """At 4 and 2 bits the crops quantize: the JAX loops' own bound
    (tests/test_pipeline.py: the same lines and label shapes), and
    lines that keep most of their 8-bit labels on these pages."""
    pages = _pages()
    runs = {bits: list(_pair(models, transport_bits=bits)[1].run(
        pages, lines_override=_override, page_batch=2)) for bits in (8, 4, 2)}
    for bits in (4, 2):
        for a, b in zip(runs[8], runs[bits]):
            assert len(a.baselines) == len(b.baselines)
            assert a.labels.shape == b.labels.shape


# ----------------------------------------------------------------------
# The parse of the packed mask

def _parse_pipes(route, **kwargs):
    """Recognize-only crop-transport pipelines (the parse needs no model):
    (JAX, port on ``route``)."""
    rec = FlaxRecognizer(FlaxSpec(**RECOGNIZER))
    jax_pipe = TPUPagePipeline(None, None, rec, None, transport="crops", **kwargs)
    port = TorchPagePipeline(None, CTCRecognizer(RecognizerSpec(**RECOGNIZER)), device="cpu",
                             transport="crops", native=route, **kwargs)
    return jax_pipe, port


@pytest.mark.parametrize("case", ["sparse", "dense", "top_rows"])
@pytest.mark.parametrize("hf", [1, 4])
def test_packed_parse_twin_equals_the_cpp_and_jax(case, hf):
    """``_lines_from_packed`` on both routes against the JAX crop
    transport's (components in the order of their first mask pixel,
    lines in the top rows included)."""
    from tests.test_torch_native import _packed

    rng = np.random.default_rng(11 + hf)
    packed = _packed(rng, 48, 8, 0.4 if case == "dense" else 0.05, top_rows=case == "top_rows")
    heights_q = rng.integers(0, 256, (48 // hf, 64 // hf, 2), dtype=np.uint8)
    jax_pipe, native_pipe = _parse_pipes(True)
    numpy_pipe = _parse_pipes(False)[1]
    want_b, want_h, *_ = jax_pipe._lines_from_packed(packed, heights_q, 4)
    for pipe in (native_pipe, numpy_pipe):
        got_b, got_h = pipe._lines_from_packed(packed, heights_q, 4)
        assert len(got_b) == len(want_b) > 0
        for a, b in zip(got_b, want_b):
            np.testing.assert_array_equal(a, b)
        assert got_h == want_h


@pytest.mark.parametrize("route", [True, False], ids=["native", "numpy"])
def test_packed_parse_overflow_takes_the_unpacked_route_as_jax(route):
    """A batch whose middle page has more than 4096 components: the
    packed parse gives up there on both sides, and that page and the
    rest of the batch are labeled unpacked, as the JAX crop transport
    does."""
    from pero_ocr_tpu_torch.parallel.crop_transport import StageAArtifacts
    from tests.test_torch_native import _crowded, _packed

    packed = _crowded()
    rng = np.random.default_rng(5)
    batch = np.stack([_packed(rng, *packed.shape, 0.002), packed,
                      _packed(rng, *packed.shape, 0.002, top_rows=True)])
    heights_q = np.full((3, packed.shape[0] // 4, packed.shape[1] * 2, 2), 48, np.uint8)
    sep_q = np.zeros((3, packed.shape[0] // 2, packed.shape[1] * 2), np.uint8)
    jax_pipe, port = _parse_pipes(route, cluster_paragraphs=False)
    want, _, _ = jax_pipe._batch_lines(
        [None] * 3, [0, 1, 2], None, jax_pipe._StageAArtifacts(batch, heights_q, sep_q, jax_pipe),
        4)
    calls = native.calls["cc_lines_packed"]
    got, _, _ = port._batch_lines([None] * 3, [0, 1, 2], None,
                                  StageAArtifacts(batch, heights_q, sep_q, port), 4)
    assert len(got[1][0]) > 4096
    for g, w in zip(got, want):
        assert len(g[0]) == len(w[0])
        for a, b in zip(g[0], w[0]):
            np.testing.assert_array_equal(a, b)
        assert g[1] == w[1]
    assert native.calls["cc_lines_packed"] - calls == (2 if route else 0)
