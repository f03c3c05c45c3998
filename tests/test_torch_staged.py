"""The port's stage-by-stage path (config 2 without ``--fast-pipeline``)
against the JAX package's, module by module and as a whole, on the CPU.

Every case builds its numpy inputs from a seed and runs the JAX function
and its port on them:

- ``resize_area`` and ``remap_linear`` against cv2 (INTER_AREA,
  INTER_LINEAR remap): bit-equal;
- ``warp_field`` against ``line_geometry.warp_field``: equal;
- ``warp_fields_plain`` against ``warp_lines_xla`` on a uint8 BGR page:
  float32 crops within 1e-3 (XLA may contract the blend into FMAs on the
  CPU), uint8 crops equal;
- the raster geometry, the line-to-region helpers and the dense logits:
  equal;
- ``LayoutEngine.parse`` and ``detect`` on the toy detector's maps and
  pages; ``process_lines``; ``PageParser.process_page`` on the command
  line's bundle (tests/test_torch_cli.py), pages in order with
  ``random`` seeded alike on both sides, ParseNet patched to float32 on
  both sides: equal layouts (coordinates within 1e-3 px: the heights are
  medians of the two ParseNets' float32 maps, ~1e-5 apart) and Page XML
  (timestamps masked), ``conf`` within 0.001; ``process_lines`` logits
  within 2e-5 on the same crops, and within 1e-3 end to end, where a
  crop value can round one gray level apart;
- config 3 (``RUN_DECODER``: TPU-BEAM, beam 8, a random character LM
  written as a flax msgpack with its sidecar, float16 transport, with
  and without CARRY_H_OVER, LSTM and GRU): ``PageParser`` and the
  command line against the JAX PageParser and command line, the same
  transcriptions line by line and equal Page XML.
"""

import configparser
import json
import os
import random
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from chip_smoke import random_fields
from pero_ocr_tpu.core import geometry as jax_geometry
from pero_ocr_tpu.core import line_geometry as jax_line_geometry
from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.core.layout import RegionLayout as JaxRegionLayout
from pero_ocr_tpu.core.layout import TextLine as JaxTextLine
from pero_ocr_tpu.document.page_parser import PageParser as JaxPageParser
from pero_ocr_tpu.layout_engines import helpers as jax_helpers
from pero_ocr_tpu.models.charlm import CharLM as FlaxCharLM
from pero_ocr_tpu.models.charlm import CharLMSpec as FlaxCharLMSpec
from pero_ocr_tpu.utils.checkpoint import save_variables
from pero_ocr_tpu.layout_engines.cnn_engine import LayoutEngine as JaxLayoutEngine
from pero_ocr_tpu.layout_engines.cnn_engine import _postprocess_maps
from pero_ocr_tpu.ocr.ctc_engine import CTCEngineLineOCR as JaxCTCEngine
from pero_ocr_tpu.ops import warp as jax_warp
from pero_ocr_tpu_torch.core import geometry, line_geometry
from pero_ocr_tpu_torch.core.crop_engine import EngineLineCropper
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from pero_ocr_tpu_torch.document.page_parser import LineCropper, PageParser
from pero_ocr_tpu_torch.layout_engines import helpers
from pero_ocr_tpu_torch.layout_engines.cnn_engine import LayoutEngine, postprocess_maps
from pero_ocr_tpu_torch.ocr.ctc_engine import CTCEngineLineOCR
from pero_ocr_tpu_torch.ops import warp
from pero_ocr_tpu_torch.utils import native as native_port
from pero_ocr_tpu_torch.utils.resize import remap_linear, resize_area
from tests.test_torch_cli import (  # noqa: F401  (bundle, float32_parsenets: fixtures)
    BF16_MASK_FLIPS, _config, _jax_cli, _masked, _run_port, assert_lines_close, assert_xml_equal,
    bundle, float32_parsenets, jax_staged_layouts, staged_config,
)
from tests.test_torch_pipeline import CHARS, LINES
from tests.test_torch_native import jax_native_library

# The JAX clustering runs its native library when it builds; its Python
# fallback rounds the penalty windows otherwise (ROADMAP.md, section 3).
needs_native = pytest.mark.skipif(jax_native_library() is None,
                                  reason="native library unavailable")


def _bgr(rng, h, w, c=3):
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


def _curved_baseline(rng, w, y):
    x = np.sort(rng.uniform(10, w - 10, 6))
    return np.stack([x, y + 3 * np.sin(x / 40.0) + rng.uniform(-1, 1, 6)], axis=1)


# ----------------------------------------------------------------------
# cv2 copies
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("scale", [8, 4, 2, 2.7, 5.33, 1.5])
def test_resize_area_matches_cv2(scale, channels):
    rng = np.random.default_rng(int(scale * 100) + channels)
    for h, w in ((97, 131), (256, 320), (64, 64)):
        img = _bgr(rng, h, w, channels)
        want = cv2.resize(img, (0, 0), fx=1 / scale, fy=1 / scale, interpolation=cv2.INTER_AREA)
        got = resize_area(img, scale)
        assert got.shape == (want.shape if want.ndim == 3 else want.shape + (1,))
        assert np.array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("channels", [1, 3])
def test_remap_linear_matches_cv2(channels):
    rng = np.random.default_rng(channels)
    img = _bgr(rng, 120, 200, channels)
    for _ in range(5):
        # Off-page coordinates on every side, and integer ones.
        mx = rng.uniform(-15, 215, (24, 150)).astype(np.float32)
        my = rng.uniform(-15, 135, (24, 150)).astype(np.float32)
        mx[:, :10] = np.round(mx[:, :10])
        want = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT)
        got = remap_linear(img, mx, my)
        assert np.array_equal(got.reshape(want.shape), want)


def test_line_crop_on_host_matches_jax():
    """EngineLineCropper.crop (fields and remap, the < 4 lines path)."""
    from pero_ocr_tpu.core.crop_engine import EngineLineCropper as JaxCropper

    rng = np.random.default_rng(3)
    img = _bgr(rng, 200, 300)
    for poly in (0, 2):
        ours, theirs = EngineLineCropper(16, poly, 1.25), JaxCropper(line_height=16, poly=poly,
                                                                     scale=1.25)
        for y in (40, 120, 195):  # the last runs off the page
            b = _curved_baseline(rng, 300, y)
            assert np.array_equal(ours.crop(img, b, [9.0, 4.0]), theirs.crop(img, b, [9.0, 4.0]))


# ----------------------------------------------------------------------
# Warp fields
@pytest.mark.parametrize("poly", [0, 2])
def test_warp_field_matches_jax(poly):
    rng = np.random.default_rng(poly)
    for k in range(6):
        b = _curved_baseline(rng, 400, 100)
        if k == 5:
            b = b[:2]  # two points: linear fit
        hh = [rng.uniform(5, 20), rng.uniform(2, 8)]
        got = line_geometry.warp_field(b, hh, 24, poly=poly, scale=1.25)
        want = jax_line_geometry.warp_field(b, hh, 24, poly=poly, scale=1.25)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


def test_width_buckets_and_pad_fields_match_jax():
    rng = np.random.default_rng(0)
    widths = rng.integers(1, 5000, 40).tolist()
    buckets = [256, 512, 1024, 2048, 4096]
    assert warp.width_buckets(widths, buckets) == jax_warp.width_buckets(widths, buckets)
    fields = [rng.normal(size=(8, w, 2)).astype(np.float32) for w in (3, 10, 20)]
    for got, want in zip(warp.pad_fields(fields, 16), jax_warp.pad_fields(fields, 16)):
        assert np.array_equal(got, want)


def _bucket_fields(rng, page_shape, bucket=512, n=6):
    h, w = page_shape[:2]
    fields = [line_geometry.warp_field(_curved_baseline(rng, w, rng.uniform(-5, h + 5)),
                                       [10.0, 4.0], 16, poly=2) for _ in range(n)]
    return warp.pad_fields(fields, bucket)[0]


def test_warp_fields_plain_matches_warp_lines_xla():
    rng = np.random.default_rng(1)
    page = _bgr(rng, 180, 500)
    fields = _bucket_fields(rng, page.shape)
    want = np.asarray(jax_warp.warp_lines_xla(jnp.asarray(page.astype(np.float32)),
                                              jnp.asarray(fields)))
    got = warp.warp_fields_plain(torch.from_numpy(page), torch.from_numpy(fields)).numpy()
    assert got.shape == want.shape == fields.shape[:3] + (3,)
    assert np.abs(got - want).max() <= 1e-3
    want_u8 = np.clip(np.round(want), 0, 255).astype(np.uint8)  # LineCropper's store
    got_u8 = warp.warp_fields(torch.from_numpy(page), torch.from_numpy(fields), "u8").numpy()
    assert np.array_equal(got_u8, want_u8)
    # A float32 gray page and the f32 store take the same path.
    gray = page[:, :, :1].astype(np.float32)
    got = warp.warp_fields(torch.from_numpy(gray), torch.from_numpy(fields)).numpy()
    want = np.asarray(jax_warp.warp_lines_xla(jnp.asarray(gray), jnp.asarray(fields)))
    assert np.abs(got - want).max() <= 1e-3


def test_warp_fields_edge_cases_are_defined():
    """Non-finite coordinates sample 0; padded (-1e6) and huge ones read
    only off-page taps (0); negative coordinates floor downwards."""
    page = torch.full((4, 5, 3), 200, dtype=torch.uint8)
    xy = [[np.nan, 1.0], [1.0, np.inf], [-1e6, -1e6], [3e9, 1.0], [1.0, -4e9],
          [-0.5, 1.0], [1.5, -0.25], [2.0, 1.0]]
    fields = torch.tensor(xy, dtype=torch.float32).reshape(1, 1, len(xy), 2)
    got = warp.warp_fields_plain(page, fields)[0, 0, :, 0].tolist()
    assert got == [0.0, 0.0, 0.0, 0.0, 0.0, 100.0, 150.0, 200.0]
    u8 = warp.warp_fields_plain(page, fields, "u8")[0, 0, :, 0].tolist()
    assert u8 == [0, 0, 0, 0, 0, 100, 150, 200]
    with pytest.raises(ValueError, match="1 or 3"):
        warp.warp_fields(torch.zeros((4, 5, 2), dtype=torch.uint8), fields)
    with pytest.raises(ValueError, match="store"):
        warp.warp_fields(page, fields, "bf16")


def test_warp_fields_bytes_counts_the_touched_footprint():
    page = torch.zeros((10, 10, 3), dtype=torch.uint8)
    fields = torch.tensor([[[[2.5, 3.5], [2.6, 3.4], [-1e6, -1e6], [np.nan, 0.0]]]])
    # One 2x2 footprint of 3 bytes a pixel, 4 samples of 8 field bytes,
    # 4 x 3 uint8 out.
    assert warp.warp_fields_bytes(page, fields, "u8") == 4 * 3 + 4 * 8 + 4 * 3
    assert warp.warp_fields_bytes(page, fields, "f32") == 4 * 3 + 4 * 8 + 4 * 3 * 4


# Buckets of one packed buffer: odd sizes (Wb = 1023, odd Hc), a bucket of
# LineCropper's shape, and an odd total, which leaves the kernel's last
# warp partly filled.
PACKED_SHAPES = [(3, 5, 1023), (1, 7, 17), (4, 16, 256), (1, 3, 5)]


def _packed_fields(rng, shapes, h, w):
    """A field_buffer of ``shapes`` filled with random_fields: uniform,
    NaN, infinite, padded (-1e6), beyond-int32 and integer coordinates."""
    buffer = warp.field_buffer(shapes)
    for view, (n, hc, wb) in zip(warp.split_fields(buffer, shapes), shapes):
        view[...] = random_fields(rng, n, hc, wb, h, w)
    return buffer


def test_field_layout_packs_buckets_back_to_back():
    offsets, total = warp.field_layout(PACKED_SHAPES)
    sizes = [n * hc * wb for n, hc, wb in PACKED_SHAPES]
    assert offsets == [0] + np.cumsum(sizes)[:-1].tolist() and total == sum(sizes)
    assert total % 2 == 1
    buffer = warp.field_buffer(PACKED_SHAPES)
    assert buffer.shape == (2 * total,) and buffer.dtype == np.float32
    views = warp.split_fields(buffer, PACKED_SHAPES)
    assert [v.shape for v in views] == [s + (2,) for s in PACKED_SHAPES]
    assert all(np.shares_memory(v, buffer) for v in views)
    # No buckets: an empty buffer, whose warp is empty and splits into nothing.
    empty = torch.from_numpy(warp.field_buffer([]))
    out = warp.warp_fields(torch.zeros((4, 5, 3), dtype=torch.uint8), empty.view(1, 1, -1, 2), "u8")
    assert out.shape == (1, 1, 0, 3) and warp.split_fields(out.view(-1), [], 3) == []


def test_pad_fields_into_a_buffer_view_equals_its_own_array():
    rng = np.random.default_rng(3)
    fields = [rng.normal(size=(8, w, 2)).astype(np.float32) for w in (3, 10, 20, 16)]
    want, want_widths = warp.pad_fields(fields, 16)
    view = warp.split_fields(warp.field_buffer([(4, 8, 16)]), [(4, 8, 16)])[0]
    got, got_widths = warp.pad_fields(fields, 16, out=view)
    assert got is view and np.array_equal(got, want) and np.array_equal(got_widths, want_widths)


@pytest.mark.parametrize("store", warp.FIELD_STORES)
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("page_dtype", ["u8", "f32"])
def test_warp_fields_packed_equals_plain_bucket_by_bucket(store, channels, page_dtype):
    """One warp_fields call over a packed buffer, as LineCropper makes it,
    on the CPU: each bucket's crop, split out of the flat result, is
    bit-equal to warp_fields_plain on that bucket."""
    rng = np.random.default_rng(channels * 7 + len(store) + 3 * len(page_dtype))
    h, w = 61, 97
    page = _bgr(rng, h, w, channels)
    if page_dtype == "f32":
        page = page.astype(np.float32) + rng.uniform(-0.5, 0.5, page.shape).astype(np.float32)
    page_t = torch.from_numpy(page)
    buffer = torch.from_numpy(_packed_fields(rng, PACKED_SHAPES, h, w))
    out = warp.warp_fields(page_t, buffer.view(1, 1, -1, 2), store)
    crops = warp.split_fields(out.view(-1), PACKED_SHAPES, channels)
    views = warp.split_fields(buffer, PACKED_SHAPES)
    assert len(crops) == len(views)
    for crop, view in zip(crops, views):
        want = warp.warp_fields_plain(page_t, view, store)
        assert crop.shape == want.shape == view.shape[:3] + (channels,)
        assert crop.dtype == want.dtype
        bits = torch.int32 if store == "f32" else torch.uint8
        assert torch.equal(crop.view(bits), want.view(bits))


def test_warp_fields_packed_rejects_what_the_kernel_does_not_take():
    page = torch.zeros((8, 9, 3), dtype=torch.uint8)
    total = warp.field_layout([(2, 3, 8), (1, 4, 5)])[1]
    packed = torch.zeros(2 * total).view(1, 1, -1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        warp.warp_fields(page, packed[:, :, ::2])
    with pytest.raises(ValueError, match="float32"):
        warp.warp_fields(page, packed.double())
    with pytest.raises(ValueError, match="store"):
        warp.warp_fields(page, packed, "bf16")
    with pytest.raises(ValueError, match="page"):
        warp.warp_fields(page[:, :, :2].contiguous(), packed)


def test_line_cropper_crops_unchanged_by_one_buffer_packing():
    """LineCropper on the CPU (one buffer, one warp call) gives every
    line the crop that the per-bucket warp gave: each bucket padded on
    its own and sampled by warp_fields_plain."""
    rng = np.random.default_rng(11)
    page = _bgr(rng, 300, 1300)
    config = configparser.ConfigParser()
    config.read_string("[LINE_CROPPER]\nLINE_HEIGHT = 16\nINTERP = 2\nLINE_SCALE = 1.0\n")
    cropper = LineCropper(config["LINE_CROPPER"], device="cpu")
    lines = []
    for i, length in enumerate((100, 250, 400, 700, 1150, 180, 40)):
        x = np.linspace(20, 20 + length, 6)
        y = 30 + 36 * i + 3 * np.sin(x / 40.0)
        lines.append(TextLine(id=f"l{i}", baseline=np.stack([x, y], 1), heights=[10.0, 4.0]))
    lines[3].baseline[:, 1] += 150  # partly off the page
    lines.append(TextLine(id="bad", baseline=np.zeros((0, 2)), heights=[10.0, 4.0]))
    layout = PageLayout(id="p", page_size=page.shape[:2])
    layout.regions = [RegionLayout("r0", np.array([[0, 0], [1300, 0], [1300, 300], [0, 300]]))]
    layout.regions[0].lines = lines

    fields = []
    for line in lines:
        try:
            fields.append(cropper.crop_engine.get_crop_inputs(line.baseline, line.heights, 16))
        except (ValueError, IndexError, np.linalg.LinAlgError):
            fields.append(None)
    assert fields[-1] is None
    want = {}
    widths = [f.shape[1] if f is not None else 0 for f in fields]
    buckets_used = 0
    for bucket, group in zip(cropper.BUCKETS, warp.width_buckets(widths, cropper.BUCKETS)):
        group = [g for g in group if fields[g] is not None]
        if not group:
            continue
        buckets_used += 1
        stacked, kept = warp.pad_fields([fields[g] for g in group], bucket)
        crops = warp.warp_fields_plain(torch.from_numpy(page), torch.from_numpy(stacked),
                                       "u8").numpy()
        for j, g in enumerate(group):
            want[g] = crops[j, :, : kept[j]]
    assert buckets_used >= 3

    cropper.process_page(page, layout)
    for i, line in enumerate(lines):
        if i in want:
            assert line.crop.dtype == np.uint8 and np.array_equal(line.crop, want[i])
        else:
            assert np.array_equal(line.crop, np.zeros((16, 32, 3), np.uint8))


# ----------------------------------------------------------------------
# Geometry and layout helpers
def _blob(rng, cx, cy, r, n=9):
    a = np.sort(rng.uniform(0, 2 * np.pi, n))
    rr = r * rng.uniform(0.6, 1.0, n)
    return np.stack([cx + rr * np.cos(a), cy + rr * np.sin(a)], axis=1)


def test_raster_geometry_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(40):
        a = _blob(rng, 50, 50, 30)
        b = _blob(rng, rng.uniform(20, 90), rng.uniform(20, 90), rng.uniform(5, 40))
        assert geometry.polygon_intersection_area(a, b) == \
            jax_geometry.polygon_intersection_area(a, b)
        got, want = geometry.polygon_intersection(a, b), jax_geometry.polygon_intersection(a, b)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got, want)
        line = np.stack([np.linspace(0, 100, 7), 50 + rng.uniform(-20, 20, 7)], axis=1)
        got = geometry.mask_polyline_by_polygon(line, a)
        want = jax_geometry.mask_polyline_by_polygon(line, a)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got, want)


def test_line_to_region_helpers_match_jax():
    rng = np.random.default_rng(5)
    regions = [np.array([[10, 10], [150, 10], [150, 90], [10, 90]], float),
               _blob(rng, 200, 60, 50)]
    b_list = [np.stack([np.linspace(x0, x0 + 120, 5), np.full(5, y)], axis=1)
              for x0, y in ((20, 30), (100, 60), (170, 70), (300, 20), (40, 80))]
    h_list = [[8.0, 3.0]] * len(b_list)
    t_list = [helpers.baseline_to_textline(b, h) for b, h in zip(b_list, h_list)]
    ours = helpers.assign_lines_to_regions(
        b_list, h_list, t_list, [RegionLayout(f"r{i}", p) for i, p in enumerate(regions)])
    theirs = jax_helpers.assign_lines_to_regions(
        b_list, h_list, t_list, [JaxRegionLayout(f"r{i}", p) for i, p in enumerate(regions)])
    assert [[(ln.id, ln.heights) for ln in r.lines] for r in ours] == \
        [[(ln.id, ln.heights) for ln in r.lines] for r in theirs]
    assert sum(len(r.lines) for r in ours) >= 4
    for r_ours, r_theirs in zip(ours, theirs):
        for a, b in zip(r_ours.lines, r_theirs.lines):
            assert np.array_equal(a.baseline, b.baseline) and np.array_equal(a.polygon, b.polygon)
    random.seed(7)
    got = helpers.order_lines_vertical(b_list, h_list, t_list)
    random.seed(7)
    want = jax_helpers.order_lines_vertical(b_list, h_list, t_list)
    assert [b.tolist() for b in got[0]] == [b.tolist() for b in want[0]]


def test_dense_logits_and_confidence_match_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 4, (30, 8)).astype(np.float32)
    sparse = scipy.sparse.csc_matrix(np.where(rng.random((30, 8)) < 0.5, 0.0, logits))
    ours, theirs = TextLine(logits=sparse), JaxTextLine(logits=sparse)
    assert np.array_equal(ours.get_dense_logits(), theirs.get_dense_logits())
    assert np.array_equal(ours.get_full_logprobs(), theirs.get_full_logprobs())
    assert PageParser.compute_line_confidence(ours) == \
        JaxPageParser.compute_line_confidence(theirs)


# ----------------------------------------------------------------------
# Engines on the command line's bundle (toy detector, noisy recognizer)
def _pages():
    from tests.test_torch_pipeline import _page

    return [_page(), _page(shift=8, seed=1), _page(shift=-4, seed=2)]


def _engines(config_path, native=None):
    """The port's PageParser on the CPU (its layout's host route set to
    ``native`` where given) and the JAX one, on one config."""
    config = _config(config_path)
    root = str(config_path.parent)
    ours = PageParser(config, device="cpu", config_path=root)
    if native is not None:
        for lp in ours.layout_parsers:
            lp.engine.native = native
    return ours, JaxPageParser(config, config_path=root)


def _close(a, b, atol=1e-3):
    return np.shape(a) == np.shape(b) and np.allclose(a, b, rtol=0, atol=atol)


def _layouts_equal(got, want):
    """Equal structure; coordinates within 1e-3 px (the two ParseNets'
    float32 maps differ by ~1e-5, and the heights are their medians)."""
    assert len(got.regions) == len(want.regions)
    for rg, rw in zip(got.regions, want.regions):
        assert rg.id == rw.id and _close(rg.polygon, rw.polygon)
        assert [ln.id for ln in rg.lines] == [ln.id for ln in rw.lines]
        for a, b in zip(rg.lines, rw.lines):
            assert _close(a.baseline, b.baseline)  # cut at the region's outline
            assert _close(a.polygon, b.polygon) and _close(a.heights, b.heights)


@needs_native
def test_layout_engine_parse_and_detect_match_jax(bundle, tmp_path, float32_parsenets):
    ours, theirs = _engines(staged_config(bundle, tmp_path))
    eng, jeng = ours.layout_parsers[0].engine, theirs.layout_parsers[0].engine
    assert isinstance(eng, LayoutEngine) and isinstance(jeng, JaxLayoutEngine)
    for page in _pages():
        maps, ds = eng.parsenet.get_maps_with_optimal_resolution(page)
        jmaps, jds = jeng.parsenet.get_maps_with_optimal_resolution(page)
        assert ds == jds and maps.shape == jmaps.shape
        assert np.abs(maps - jmaps).max() < 1e-3
        # parse on the same maps: equal lines.
        got, want = eng.parse(jmaps, jds), jeng.parse(jmaps, jds)
        assert len(got[0]) == len(want[0]) >= 3
        for g, w in zip(got, want):
            assert all(np.array_equal(a, b) for a, b in zip(g, w))
        # detect on each side's own maps: coordinates within 1e-3 px.
        random.seed(11)
        got = eng.detect(page)
        random.seed(11)
        want = jeng.detect(page)
        assert [len(x) for x in got] == [len(x) for x in want]
        for g, w in zip(got, want):
            assert all(_close(a, b) for a, b in zip(g, w))


def test_process_lines_matches_jax(bundle):
    ours = CTCEngineLineOCR(str(bundle / "ocr" / "ocr.json"), device="cpu")
    theirs = JaxCTCEngine(str(bundle / "ocr" / "ocr.json"))
    rng = np.random.default_rng(8)
    # Widths across three buckets (192, 384, 768) and a batch of more
    # than one line in one of them.
    lines = [_bgr(rng, 16, w) for w in (40, 100, 100, 300, 120, 90, 500)]
    got = ours.process_lines(lines)
    want = theirs.process_lines(lines)
    assert got[0] == want[0]
    assert any(got[0])
    assert got[2] == want[2]
    for a, b in zip(got[1], want[1]):
        assert np.array_equal((a != 0).toarray(), (b != 0).toarray())
        assert np.abs(a.toarray() - b.toarray()).max() < 2e-5
    assert [c[1] - c[0] for c in got[2]] == [w // 2 for w in (40, 100, 100, 300, 120, 90, 500)]


def _run_pages(parser, layout_cls, pages, seed=0):
    random.seed(seed)
    return [parser.process_page(p, layout_cls(id=f"p{i}", page_size=p.shape[:2]))
            for i, p in enumerate(pages)]


def _xml_equal(got, want):
    assert_xml_equal(got.to_pagexml_string(), want.to_pagexml_string())


@needs_native
def test_page_parser_matches_jax(bundle, tmp_path, float32_parsenets):
    ours, theirs = _engines(staged_config(bundle, tmp_path))
    pages = _pages()
    got = _run_pages(ours, PageLayout, pages)
    want = _run_pages(theirs, JaxPageLayout, pages)
    for g, w in zip(got, want):
        _layouts_equal(g, w)
        _xml_equal(g, w)
        lines = list(g.lines_iterator())
        assert len(lines) >= 4  # the warp_fields path
        for a, b in zip(lines, w.lines_iterator()):
            # The heights (float medians) differ by ~1e-5: a crop value
            # may round the other way.
            assert a.crop.shape == b.crop.shape
            assert np.abs(a.crop.astype(int) - b.crop.astype(int)).max() <= 1
            assert a.transcription == b.transcription and a.logit_coords == b.logit_coords
            assert abs(a.transcription_confidence - b.transcription_confidence) <= 0.001
            # Logits within 1e-3: a crop value one gray level apart moves them.
            assert np.abs(a.logits.toarray() - b.logits.toarray()).max() < 1e-3


@needs_native
def test_page_parser_native_route_matches_jax(bundle, tmp_path, float32_parsenets):
    """The port's C++ labeling and clustering (its own build of the host
    library) on the CPU: the same layouts and Page XML as the JAX
    PageParser, and the same as the numpy route's."""
    ours, theirs = _engines(staged_config(bundle, tmp_path), native=True)
    numpy_route, _ = _engines(staged_config(bundle, tmp_path))
    engine = ours.layout_parsers[0].engine
    assert engine.native and not numpy_route.layout_parsers[0].engine.native
    pages = _pages()
    calls = (native_port.calls["cc_label_u8"], native_port.calls["polygons_close_f64"],
             native_port.calls["separator_penalties_f32"])
    got = _run_pages(ours, PageLayout, pages)
    assert native_port.calls["cc_label_u8"] - calls[0] == len(pages)
    assert native_port.calls["polygons_close_f64"] > calls[1]
    assert native_port.calls["separator_penalties_f32"] > calls[2]
    want = _run_pages(theirs, JaxPageLayout, pages)
    twin = _run_pages(numpy_route, PageLayout, pages)
    for g, w, t in zip(got, want, twin):
        _layouts_equal(g, w)
        _xml_equal(g, w)
        assert _masked(g.to_pagexml_string()) == _masked(t.to_pagexml_string())


@needs_native
def test_page_parser_carries_the_adaptive_downsample(bundle, tmp_path, float32_parsenets):
    """The bundle's own config (adaptive downsample on): each page starts
    at the downsample the last one settled on."""
    ours, theirs = _engines(bundle / "config.ini")
    pages = _pages()
    settled = []
    for i, page in enumerate(pages):
        random.seed(i)
        g = ours.process_page(page, PageLayout(id=f"p{i}", page_size=page.shape[:2]))
        random.seed(i)
        w = theirs.process_page(page, JaxPageLayout(id=f"p{i}", page_size=page.shape[:2]))
        _xml_equal(g, w)
        pair = [pp.layout_parsers[0].engine.parsenet.last_downsample for pp in (ours, theirs)]
        assert pair[0] == pair[1]
        settled.append(pair[0])
    assert settled[0] != 4  # the first page moved it


@needs_native
def test_page_parser_bfloat16_detector_within_measured_bounds(bundle, tmp_path):
    """No patch: both ParseNets in bfloat16, as the config builds them.
    Measured on the three toy pages (CPU): the colour maps at ds 4 differ
    by up to 0.9 (the height channels), the baseline masks not at all,
    the clipped baselines by 0.006 px.  Held to the command line's bf16
    bounds (tests/test_torch_cli.py): masks within BF16_MASK_FLIPS,
    baselines and heights within BF16_BASELINE_PX and BF16_HEIGHT_PX."""
    ours, theirs = _engines(staged_config(bundle, tmp_path))
    eng, jeng = ours.layout_parsers[0].engine, theirs.layout_parsers[0].engine
    pages = _pages()
    for page in pages:
        maps, jmaps = eng.parsenet.get_maps(page, 4), jeng.parsenet.get_maps(page, 4)
        mask = postprocess_maps(torch.from_numpy(maps), 0.2, 1.0)[0].numpy()
        jmask = np.asarray(_postprocess_maps(jnp.asarray(jmaps), 0.2, 1.0)[0])
        assert jmask.sum() > 100 and (mask != jmask).sum() <= BF16_MASK_FLIPS * jmask.sum()
    for got, want in zip(_run_pages(ours, PageLayout, pages),
                         _run_pages(theirs, JaxPageLayout, pages)):
        assert [len(r.lines) for r in got.regions] == [len(r.lines) for r in want.regions]
        assert_lines_close(list(got.lines_iterator()), list(want.lines_iterator()))


def _few_line_page():
    rng = np.random.default_rng(9)
    page = rng.integers(235, 250, (256, 320, 3), dtype=np.uint8)
    for y, x0, x1 in LINES[1:3]:
        page[y - 12: y - 2, x0:x1] = rng.integers(20, 60, (10, x1 - x0, 3))
    return page


@needs_native
def test_page_with_fewer_than_four_lines_matches_jax(bundle, tmp_path, float32_parsenets):
    ours, theirs = _engines(staged_config(bundle, tmp_path))
    page = _few_line_page()
    launches = warp.warp_fields.launches
    (got,), (want,) = _run_pages(ours, PageLayout, [page]), _run_pages(theirs, JaxPageLayout,
                                                                       [page])
    assert 1 <= len(list(got.lines_iterator())) < 4
    _xml_equal(got, want)
    for a, b in zip(got.lines_iterator(), want.lines_iterator()):
        assert a.crop.shape == b.crop.shape
        assert np.abs(a.crop.astype(int) - b.crop.astype(int)).max() <= 1
    assert warp.warp_fields.launches == launches  # remapped on the host


@needs_native
@pytest.mark.parametrize("key,value", [
    ("PARAGRAPH_LINE_THRESHOLD", "0.0"),  # no clustering: a region a line
    ("MAX_MEGAPIXELS", "0.004"),          # the cap: ds 4.53 on 256x320
])
def test_page_parser_honours_layout_keys(bundle, tmp_path, float32_parsenets, key, value):
    """Each key off its default changes the layout, alike on both sides."""
    default = _run_pages(_engines(staged_config(bundle, tmp_path))[0], PageLayout, _pages())
    ours, theirs = _engines(staged_config(bundle, tmp_path, **{key: value}))
    got = _run_pages(ours, PageLayout, _pages())
    want = _run_pages(theirs, JaxPageLayout, _pages())
    for g, w in zip(got, want):
        _xml_equal(g, w)
    assert [_masked(g.to_pagexml_string()) for g in got] != \
        [_masked(d.to_pagexml_string()) for d in default]


@pytest.mark.parametrize("keys", [
    {"VERTICAL_LINE_CONNECTION_RANGE": "12"},
    {"SMOOTH_LINE_PREDICTIONS": "no", "VERTICAL_LINE_CONNECTION_RANGE": "2"},
])
def test_parse_honours_connection_keys(bundle, tmp_path, float32_parsenets, keys):
    """On the same maps (the JAX ParseNet's), parse follows the connection
    range and the smoothing switch exactly as the JAX engine does; range
    12 joins the page's lines into one."""
    base, _ = _engines(staged_config(bundle, tmp_path))
    ours, theirs = _engines(staged_config(bundle, tmp_path, **keys))
    jeng = theirs.layout_parsers[0].engine
    maps, ds = jeng.parsenet.get_maps_with_optimal_resolution(_pages()[0])
    got = ours.layout_parsers[0].engine.parse(maps, ds)
    want = jeng.parse(maps, ds)
    default = base.layout_parsers[0].engine.parse(maps, ds)
    assert len(got[0]) == len(want[0])
    for g, w in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))
    assert [b.tolist() for b in got[0]] != [b.tolist() for b in default[0]]


def test_page_parser_refuses_unported_layout_options(bundle, tmp_path):
    # The LAYOUT_CNN options are ported (ADJUST_HEIGHTS with config 4, the
    # rest of item 8d since): they run.  REGION_SIMPLE_THRESHOLD is the
    # one layout method left, refused by name.
    path = staged_config(bundle, tmp_path, ADJUST_HEIGHTS="yes", MULTI_ORIENTATION="yes")
    ours = PageParser(_config(path), device="cpu", config_path=str(tmp_path))
    page = _pages()[0]
    layout = ours.process_page(page, PageLayout(id="p", page_size=page.shape[:2]))
    assert layout.regions and layout.to_pagexml_string()
    config = _config(path)
    config["LAYOUT_PARSER_1"]["METHOD"] = "REGION_SIMPLE_THRESHOLD"
    with pytest.raises(ValueError, match=r"\[LAYOUT_PARSER_1\] METHOD = REGION_SIMPLE_THRESHOLD "
                                         "is not ported.*Stage-by-stage"):
        PageParser(config, device="cpu", config_path=str(tmp_path))


@needs_native
def test_detect_lines_only_keeps_the_given_regions(bundle, tmp_path, float32_parsenets):
    """DETECT_REGIONS = no: the lines go into the regions the layout
    already has."""
    ours, theirs = _engines(staged_config(bundle, tmp_path, DETECT_REGIONS="no"))
    page = _pages()[0]
    box = np.array([[0, 0], [320, 0], [320, 120], [0, 120]], float)
    got = PageLayout(id="p", page_size=page.shape[:2])
    got.regions = [RegionLayout("given", box)]
    want = JaxPageLayout(id="p", page_size=page.shape[:2])
    want.regions = [JaxRegionLayout("given", box)]
    random.seed(0)
    got = ours.process_page(page, got)
    random.seed(0)
    want = theirs.process_page(page, want)
    _xml_equal(got, want)
    assert [r.id for r in got.regions] == ["given"] and len(got.regions[0].lines) >= 1


# ----------------------------------------------------------------------
# The command line without --fast-pipeline (its files and DONE lines are
# also held in tests/test_torch_cli.py)
@needs_native
def test_cli_stage_by_stage_shards_and_transcriptions(bundle, tmp_path, float32_parsenets):
    """A shard of the folder, then the rest with -s, then the
    transcriptions file: the JAX Computator's files and lines."""
    ini = staged_config(bundle, tmp_path)
    out = tmp_path / "xml"
    common = ["-c", str(ini), "-i", str(bundle / "images"), "--output-xml-path", str(out),
              "--device", "cpu"]
    random.seed(0)
    _run_port(common + ["--shard-index", "0", "--shard-count", "2"])
    assert sorted(os.listdir(out)) == ["page-0.xml", "page-2.xml"]
    _run_port(common + ["-s"])
    assert sorted(os.listdir(out)) == [f"page-{i}.xml" for i in range(3)]
    transcriptions = tmp_path / "lines.txt"
    random.seed(0)
    _run_port(common + ["--output-transcriptions-file-path", str(transcriptions)])
    want = jax_staged_layouts(ini, bundle / "images")
    for fid, layout in want.items():
        assert_xml_equal((out / f"{fid}.xml").read_text(encoding="utf-8"),
                         layout.to_pagexml_string())
    lines = [f"{fid}-{line.id}.jpg {line.transcription}" for fid, layout in want.items()
             for line in sorted(layout.lines_iterator(), key=lambda x: x.id)
             if line.transcription]
    assert transcriptions.read_text(encoding="utf-8").split("\n")[:-1] == lines
    assert len(lines) >= 9


# ----------------------------------------------------------------------
# Config 3: the staged path, then the beam search with a character LM
def config3_ini(bundle, tmp_path, cell_type="lstm", carry="yes"):
    """The bundle's staged config with config 3's [DECODER] keys
    (configs/config3_beam_lm.ini) and a random flax CharLM over the
    bundle's charset (+ </s>) with its sidecar under lm/."""
    ini = staged_config(bundle, tmp_path, PAGE_PARSER__RUN_DECODER="yes")
    config = _config(ini)
    spec = dict(vocab_size=len(CHARS), embed_dim=8, hidden_dim=16, num_layers=2,
                cell_type=cell_type)
    variables = FlaxCharLM(FlaxCharLMSpec(**spec)).init(jax.random.PRNGKey(5),
                                                         jnp.zeros((1, 1), jnp.int32))
    (tmp_path / "lm").mkdir(exist_ok=True)
    save_variables(variables, str(tmp_path / "lm" / "charlm.lm"))
    (tmp_path / "lm" / "charlm.lm.json").write_text(json.dumps(spec))
    config["DECODER"] = {"TYPE": "TPU-BEAM", "BEAM_SIZE": "8", "LM": "./lm/charlm.lm",
                         "LM_SCALE": "0.5", "INSERTION_BONUS": "0.2",
                         "TRANSPORT_DTYPE": "float16", "CARRY_H_OVER": carry}
    with open(ini, "w") as f:
        config.write(f)
    return ini


@needs_native
@pytest.mark.parametrize("cell_type,carry", [("lstm", "yes"), ("gru", "yes"), ("lstm", "no")],
                         ids=["lstm_carry", "gru_carry", "lstm_batched"])
def test_config3_page_parser_matches_jax(bundle, tmp_path, float32_parsenets, cell_type, carry):
    ini = config3_ini(bundle, tmp_path, cell_type, carry)
    ours, theirs = _engines(ini)
    assert ours.decoder.continue_lines == (carry == "yes")
    assert ours.decoder.decoder.transport_dtype is np.float16
    pages = _pages()
    got = _run_pages(ours, PageLayout, pages)
    want = _run_pages(theirs, JaxPageLayout, pages)
    decoded = 0
    for g, w in zip(got, want):
        _layouts_equal(g, w)
        _xml_equal(g, w)
        texts = [line.transcription for line in g.lines_iterator()]
        assert texts == [line.transcription for line in w.lines_iterator()]
        decoded += len(texts)
    assert ours.decoder.lines_decoded == theirs.decoder.lines_decoded == decoded >= 9
    if cell_type != "lstm" or carry != "yes":
        return
    # The LM moves the text: not every line keeps its greedy transcription.
    greedy = PageParser(_config(staged_config(bundle, tmp_path)), device="cpu",
                        config_path=str(tmp_path))
    plain = _run_pages(greedy, PageLayout, pages)
    assert any(a.transcription != b.transcription for p, q in zip(got, plain)
               for a, b in zip(p.lines_iterator(), q.lines_iterator()))


@needs_native
def test_config3_cli_equals_jax_cli(bundle, tmp_path, float32_parsenets, capsys):
    """Config 3 through the port's command line (with --fast-pipeline,
    which falls back to the stage-by-stage path for RUN_DECODER) and the
    JAX one: equal Page XML files and transcriptions."""
    ini = config3_ini(bundle, tmp_path)
    common = ["-c", str(ini), "-i", str(bundle / "images")]
    random.seed(0)
    _run_port(common + ["--output-xml-path", str(tmp_path / "xml"), "--device", "cpu",
                        "--fast-pipeline", "--timing-report", "--output-transcriptions-file-path",
                        str(tmp_path / "lines.txt")])
    printed = capsys.readouterr().out
    random.seed(0)
    _jax_cli(common + ["--output-xml-path", str(tmp_path / "jax_xml"), "--fast-pipeline",
                       "--output-transcriptions-file-path", str(tmp_path / "jax_lines.txt")])
    names = sorted(os.listdir(tmp_path / "jax_xml"))
    assert sorted(os.listdir(tmp_path / "xml")) == names == [f"page-{i}.xml" for i in range(3)]
    for name in names:
        assert_xml_equal((tmp_path / "xml" / name).read_text(encoding="utf-8"),
                         (tmp_path / "jax_xml" / name).read_text(encoding="utf-8"))
    assert (tmp_path / "lines.txt").read_text(encoding="utf-8") == \
        (tmp_path / "jax_lines.txt").read_text(encoding="utf-8")
    assert re.search(r"^decoder\s+[0-9.]+\s+3\s", printed, re.M)
    assert "warp_fields kernel launches: 0" in printed  # the CPU runs the plain version
