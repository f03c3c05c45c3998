"""The layout stages and LAYOUT_CNN options of ROADMAP item 8d in the
port, function by function, against the JAX package and the libraries
it calls, on the CPU.  Every input is made from a seed with numpy.

- The cv2 copies: ``fillPoly`` on a float32 mask, ``findContours(RETR_TREE,
  CHAIN_APPROX_SIMPLE)`` (every outer and hole border, in cv2's order),
  ``warpAffine`` (INTER_LINEAR, float32, 1 and 3 channels),
  ``remap`` of a float32 image, ``getRotationMatrix2D`` and
  ``transform`` of float64 and float32 points: bit-equal to cv2 5.0.0.
- The DBSCAN copy of ``REGION_SORTER_NAIVE``: equal labels to sklearn's
  ``DBSCAN(min_samples=1)``.
- ``helpers`` (``check_line_position``, ``get_max_line_length``,
  ``retrace_region``, ``merge_lines`` with ``random`` seeded alike,
  ``filter_list``, ``get_rotation``, ``rotate_coords``), the naive
  sorter, ``PostprocessingEngine`` (each option), ``LineFilterEngine``
  and ``OrientationNetWrapper`` (float32 on both sides, a seeded flax
  checkpoint), ``EngineLineCropper.crop(..., return_forward_mapping=True)``
  of a float32 map, ``refine_baseline`` and ``detect_lines_in_region``
  on the same maps: equal to the JAX functions (float32 directions
  within 3e-4 of their largest magnitude).
"""

import functools
import random

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
from sklearn.cluster import DBSCAN

from pero_ocr_tpu.core.crop_engine import EngineLineCropper as JaxCropper
from pero_ocr_tpu.core.layout import RegionLayout as JaxRegionLayout
from pero_ocr_tpu.core.layout import TextLine as JaxTextLine
from pero_ocr_tpu.layout_engines import helpers as jax_helpers
from pero_ocr_tpu.layout_engines import parsenet_wrapper as jax_parsenet_wrapper
from pero_ocr_tpu.layout_engines.baseline_refiner import refine_baseline as jax_refine
from pero_ocr_tpu.layout_engines.cnn_engine import LineFilterEngine as JaxLineFilterEngine
from pero_ocr_tpu.layout_engines.line_in_region_detector import (
    detect_lines_in_region as jax_detect_lines_in_region,
)
from pero_ocr_tpu.layout_engines.line_postprocessing_engine import (
    PostprocessingEngine as JaxPostprocessingEngine,
)
from pero_ocr_tpu.layout_engines.naive_sorter import NaiveRegionSorter as JaxNaiveSorter
from pero_ocr_tpu.models.parsenet import OrientationNet as FlaxOrientationNet
from pero_ocr_tpu.utils.checkpoint import save_variables
from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.core.crop_engine import EngineLineCropper
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from pero_ocr_tpu_torch.layout_engines import helpers, parsenet_wrapper
from pero_ocr_tpu_torch.layout_engines.baseline_refiner import refine_baseline
from pero_ocr_tpu_torch.layout_engines.cnn_engine import LineFilterEngine
from pero_ocr_tpu_torch.layout_engines.line_in_region_detector import (
    _transform_f32, detect_lines_in_region,
)
from pero_ocr_tpu_torch.layout_engines.line_postprocessing_engine import PostprocessingEngine
from pero_ocr_tpu_torch.layout_engines.naive_sorter import NaiveRegionSorter, dbscan_1d
from pero_ocr_tpu_torch.layout_engines.smart_sorter import fma, rotation_matrix, transform
from pero_ocr_tpu_torch.models.parsenet import OrientationNet
from pero_ocr_tpu_torch.utils.resize import remap_linear_f32, warp_affine_linear
from tests.test_torch_layout_stages import one_thread  # noqa: F401  (fixture)


# ----------------------------------------------------------------------
# cv2 copies
def _masks(seed: int):
    """Binary masks of every kind the contour tracer meets: noise, blobs
    with holes, smooth shapes, striped noise, nested rings."""
    rng = np.random.default_rng(seed)
    out = []
    for kind in range(5):
        h, w = int(rng.integers(3, 70)), int(rng.integers(3, 70))
        if kind == 0:
            m = rng.random((h, w)) < rng.uniform(0.2, 0.8)
        elif kind == 1:
            m = ndi.binary_dilation(rng.random((h, w)) < 0.05, iterations=int(rng.integers(1, 4)))
            m &= ~ndi.binary_dilation(rng.random((h, w)) < 0.03)
        elif kind == 2:
            m = ndi.gaussian_filter(rng.random((h, w)), rng.uniform(0.5, 2.5)) > 0.5
        elif kind == 3:
            m = rng.random((h, w)) < 0.6
            m[:, ::3] = False
        else:
            yy, xx = np.mgrid[:h, :w]
            r = np.hypot(yy - h / 2, xx - w / 2)
            m = (r.astype(int) // int(rng.integers(2, 5))) % 2 == 1
            m ^= rng.random((h, w)) < 0.05
        out.append(m.astype(np.uint8))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_find_contours_tree_matches_cv2(seed):
    for mask in _masks(seed):
        want, _ = cv2.findContours(mask.copy(), cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
        got = geometry.find_contours_tree(mask)
        assert [c[:, 0].tolist() for c in want] == [c.astype(int).tolist() for c in got]


@pytest.mark.parametrize("seed", range(4))
def test_fill_polys_on_a_float_mask_matches_cv2(seed):
    """Polygons inside the mask and crossing its edges (OpenCV clips
    the outline and the edges), one or three at a time."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        h, w = int(rng.integers(5, 80)), int(rng.integers(5, 80))
        polys = np.round(rng.uniform(-30, [w + 30, h + 30],
                                     (int(rng.choice([1, 3])), int(rng.integers(3, 12)), 2)))
        want = np.zeros((h, w), np.float32)
        cv2.fillPoly(want, list(polys.astype(np.int32)), 1.0)
        got = np.zeros((h, w), np.float32)
        geometry._fill_polys(got, polys.astype(np.int32))
        assert np.array_equal(got, want)
        for p0, p1 in zip(polys[0], np.roll(polys[0], 1, axis=0)):
            want = np.zeros((h, w), np.uint8)
            cv2.line(want, tuple(int(v) for v in p0), tuple(int(v) for v in p1), 1)
            got = np.zeros((h, w), np.uint8)
            geometry._draw_lines(got, p0[None].astype(np.int64), p1[None].astype(np.int64))
            assert np.array_equal(got, want)


@pytest.mark.parametrize("channels", [None, 1, 3])
@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_matches_cv2(seed, channels):
    """Destination widths across multiples of 16 (OpenCV's vector
    columns against its scalar tail)."""
    rng = np.random.default_rng(10 * seed + (channels or 0))
    for dw in (1, 15, 16, 17, 32, 47, int(rng.integers(50, 120))):
        shape = (int(rng.integers(5, 80)), int(rng.integers(5, 80))) + (
            (channels,) if channels else ())
        img = (rng.random(shape) * rng.uniform(0.1, 10)).astype(np.float32)
        center = (shape[1] * rng.uniform(0, 1), shape[0] * rng.uniform(0, 1))
        matrix = cv2.getRotationMatrix2D(center, rng.uniform(-180, 180), 1)
        matrix[:, 2] += rng.uniform(-10, 10, 2)
        dsize = (dw, int(rng.integers(1, 90)))
        want = cv2.warpAffine(img, matrix, dsize)
        got = warp_affine_linear(img, matrix, dsize)
        assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("channels", [None, 1, 3])
def test_remap_float32_matches_cv2(channels):
    rng = np.random.default_rng(channels or 0)
    for _ in range(8):
        shape = (int(rng.integers(5, 60)), int(rng.integers(5, 60))) + (
            (channels,) if channels else ())
        img = (rng.random(shape) * 3).astype(np.float32)
        mx = rng.uniform(-3, shape[1] + 3, (20, 30)).astype(np.float32)
        my = rng.uniform(-3, shape[0] + 3, (20, 30)).astype(np.float32)
        want = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT)
        got = remap_linear_f32(img, mx, my)
        assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_rotation_and_transform_match_cv2_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        center = (float(rng.uniform(0, 500)), float(rng.uniform(0, 500)))
        angle = float(rng.uniform(-180, 180))
        matrix = cv2.getRotationMatrix2D(center, angle, 1)
        assert np.array_equal(rotation_matrix(center, angle), matrix)
        matrix[:, 2] += rng.uniform(-10, 10, 2)
        pts = rng.uniform(-500, 3000, (200, 2)) * rng.uniform(0.001, 10)
        assert np.array_equal(transform(pts, matrix), cv2.transform(pts[None], matrix)[0])
        pts32 = pts.astype(np.float32).reshape(-1, 2, 2)
        assert np.array_equal(_transform_f32(pts32, matrix), cv2.transform(pts32, matrix))


def test_fma_rounds_once():
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a, b = rng.standard_normal(5000), rng.standard_normal(5000)
    c = rng.standard_normal(5000) * 10.0 ** rng.integers(-8, 3, 5000)
    want = [float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)]
    assert np.array_equal(fma(a, b, c), want)
    assert fma(3.0, 1.0 / 3.0, -1.0) == float(Fraction(3) * Fraction(1.0 / 3.0) - 1)


# ----------------------------------------------------------------------
# REGION_SORTER_NAIVE
@pytest.mark.parametrize("seed", range(8))
def test_dbscan_1d_matches_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    values = np.round(rng.uniform(0, 1000, n), int(rng.integers(0, 3)))
    values[rng.random(n) < 0.2] = values[0]  # repeated values
    eps = float(rng.integers(1, 120))
    want = DBSCAN(eps=eps, min_samples=1).fit_predict(values.reshape(-1, 1))
    assert np.array_equal(dbscan_1d(values, eps), want)


def _regions(rng, n, cls):
    out = []
    for i in range(n):
        x, y = rng.uniform(0, 1500), rng.uniform(0, 2000)
        w, h = rng.uniform(50, 600), rng.uniform(30, 300)
        out.append(cls(f"r{i:03d}", np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_naive_sorter_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 14))
    ours, theirs = PageLayout(id="p", page_size=(2200, 1700)), None
    ours.regions = _regions(np.random.default_rng(seed), n, RegionLayout)
    from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout

    theirs = JaxPageLayout(id="p", page_size=(2200, 1700))
    theirs.regions = _regions(np.random.default_rng(seed), n, JaxRegionLayout)
    image = np.zeros((2200, 1700, 3), np.uint8)
    got = NaiveRegionSorter().process_page(image, ours)
    want = JaxNaiveSorter().process_page(image, theirs)
    assert [r.id for r in got.regions] == [r.id for r in want.regions]


# ----------------------------------------------------------------------
# helpers
def _baseline(rng, y, x0=None, tilt=0.0, points=None):
    x0 = rng.uniform(20, 900) if x0 is None else x0
    n = points or int(rng.integers(2, 9))
    xs = np.sort(rng.uniform(x0, x0 + rng.uniform(40, 700), n))
    return np.stack([xs, y + tilt * (xs - x0) + rng.uniform(-1.5, 1.5, n)], axis=1)


def _lines(seed, cls, n=12):
    """``n`` lines on rows, the odd ones continuing the even ones' row
    after a small gap (what MERGE_LINES joins), tilted alike."""
    rng = np.random.default_rng(seed)
    tilt = rng.uniform(-0.02, 0.02)
    lines = []
    for i in range(n):
        y = 80 + 45 * (i // 2) + rng.uniform(-2, 2)
        x0 = 60.0 if i % 2 == 0 else float(lines[-1].baseline[-1, 0] + rng.uniform(5, 25))
        b = _baseline(rng, y + tilt * (x0 - 60), x0, tilt, points=int(rng.integers(2, 7)))
        h = [float(rng.uniform(10, 25)), float(rng.uniform(4, 9))]
        lines.append(cls(id=f"l{i}", baseline=b, heights=h,
                         polygon=helpers.baseline_to_textline(b, h)))
    return lines


@pytest.mark.parametrize("seed", range(6))
def test_merge_lines_matches_jax(seed):
    lines = _lines(seed, TextLine)
    baselines = [ln.baseline for ln in lines]
    heights = [ln.heights for ln in lines]
    random.seed(seed)
    got = helpers.merge_lines(baselines, heights)
    random.seed(seed)
    want = jax_helpers.merge_lines(baselines, heights)
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a, b)
    assert [list(h) for h in got[1]] == [list(h) for h in want[1]]


def test_merge_lines_joins_a_split_row():
    baselines = [np.array([[50.0, 100.0], [300.0, 101.0]]), np.array([[320.0, 101.0], [600.0, 102.0]]),
                 np.array([[50.0, 160.0], [600.0, 161.0]])]
    heights = [[20.0, 6.0], [22.0, 5.0], [20.0, 6.0]]
    random.seed(0)
    got = helpers.merge_lines(baselines, heights)
    random.seed(0)
    want = jax_helpers.merge_lines(baselines, heights)
    assert len(got[0]) == len(want[0]) == 2
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
    assert got[1] == want[1] and [22.0, 6.0] in got[1]


@pytest.mark.parametrize("seed", range(4))
def test_rotation_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    baselines = [_baseline(rng, rng.uniform(0, 2000), tilt=rng.uniform(-0.3, 0.3))
                 for _ in range(int(rng.integers(0, 9)))]
    if seed == 0:
        baselines += [np.array([[10.0, 50.0], [200.0, 50.0]])]  # level: length 0
    assert helpers.get_rotation(baselines) == jax_helpers.get_rotation(baselines)
    angle, center = rng.uniform(-30, 30), rng.uniform(0, 500, 2)
    for b in baselines:
        assert np.array_equal(helpers.rotate_coords(b, angle, center),
                              jax_helpers.rotate_coords(b, angle, center))


@pytest.mark.parametrize("seed", range(4))
def test_page_position_and_length_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    page_size = (int(rng.integers(500, 3000)), int(rng.integers(500, 2500)))
    baselines = [np.array([[rng.uniform(-5, page_size[1] + 5), 0.0],
                           [rng.uniform(-5, page_size[1] + 5), 1.0]]) for _ in range(40)]
    baselines = [b[np.argsort(b[:, 0])] for b in baselines]
    assert ([helpers.check_line_position(b, page_size) for b in baselines]
            == [jax_helpers.check_line_position(b, page_size) for b in baselines])
    for subset in (baselines, baselines[:3], []):
        assert helpers.get_max_line_length(subset) == jax_helpers.get_max_line_length(subset)
    items = list(range(7))
    for remove in ([0, -1], [3], [], [-7, 6]):
        assert helpers.filter_list(items, remove) == jax_helpers.filter_list(items, remove)
    for bad in ([7], [-8]):
        with pytest.raises(ValueError):
            helpers.filter_list(items, bad)
        with pytest.raises(ValueError):
            jax_helpers.filter_list(items, bad)


@pytest.mark.parametrize("seed", range(4))
def test_retrace_region_matches_jax(seed):
    ours = RegionLayout("r", np.array([[0, 0], [10, 0], [10, 10]], float))
    theirs = JaxRegionLayout("r", np.array([[0, 0], [10, 0], [10, 10]], float))
    ours.lines = _lines(seed, TextLine, n=int(np.random.default_rng(seed).integers(1, 10)))
    theirs.lines = _lines(seed, JaxTextLine, n=len(ours.lines))
    helpers.retrace_region(ours)
    jax_helpers.retrace_region(theirs)
    assert np.array_equal(ours.polygon, theirs.polygon)
    empty, jempty = RegionLayout("e", ours.polygon), JaxRegionLayout("e", ours.polygon)
    helpers.retrace_region(empty)
    jax_helpers.retrace_region(jempty)
    assert np.array_equal(empty.polygon, jempty.polygon)


# ----------------------------------------------------------------------
# LINE_POSTPROCESSING
@pytest.mark.parametrize("options", [("max", False, False), (15, False, False),
                                     (0, True, False), (0, False, True), ("max", True, True)],
                         ids=["stretch_max", "stretch_15", "resample", "heights_from_regions",
                              "all"])
@pytest.mark.parametrize("seed", range(3))
def test_postprocessing_engine_matches_jax(seed, options):
    lines = _lines(seed, TextLine, n=6)
    jlines = _lines(seed, JaxTextLine, n=6)
    pts = np.concatenate([ln.polygon for ln in lines])
    x0, y0 = pts.min(axis=0) - 12
    x1, y1 = pts.max(axis=0) + 12
    outline = np.array([[x0, y0], [x1, y0 + 9], [x1 - 5, y1], [x0 + 7, y1 - 4]])
    ours, theirs = RegionLayout("r", outline), JaxRegionLayout("r", outline)
    ours.lines, theirs.lines = lines, jlines
    PostprocessingEngine(*options).postprocess(ours)
    JaxPostprocessingEngine(*options).postprocess(theirs)
    assert [ln.id for ln in ours.lines] == [ln.id for ln in theirs.lines]
    for a, b in zip(ours.lines, theirs.lines):
        assert np.array_equal(a.baseline, b.baseline)
        assert np.array_equal(a.polygon, b.polygon) and list(a.heights) == list(b.heights)


# ----------------------------------------------------------------------
# LINE_FILTER: OrientationNet and the direction test
@pytest.fixture
def orientation_checkpoint(tmp_path, monkeypatch):
    """A seeded flax OrientationNet checkpoint; both packages' wrappers
    build the net in float32 (bf16 convolutions round differently in XLA
    and torch)."""
    monkeypatch.setattr(parsenet_wrapper, "OrientationNet",
                        functools.partial(OrientationNet, dtype=torch.float32))
    monkeypatch.setattr(jax_parsenet_wrapper, "OrientationNet",
                        functools.partial(FlaxOrientationNet, dtype=jnp.float32))
    variables = FlaxOrientationNet(dtype=jnp.float32).init(jax.random.PRNGKey(3),
                                                           jnp.zeros((1, 64, 64, 3)))
    path = str(tmp_path / "orientation.msgpack")
    save_variables(variables, path)
    return path


def test_line_filter_engine_matches_jax(orientation_checkpoint):
    rng = np.random.default_rng(0)
    page = rng.integers(0, 256, (300, 420, 3), dtype=np.uint8)
    ours = LineFilterEngine(orientation_checkpoint, device="cpu")
    theirs = JaxLineFilterEngine(orientation_checkpoint)
    ours.predict_directions(page)
    theirs.predict_directions(page)
    assert ours.predictions.shape == theirs.predictions.shape == (75, 105, 2)
    # float32 convolutions of three U-Net levels summed in other orders:
    # measured 0.9e-5 of the largest magnitude with torch's thread pool,
    # 1.5e-4 with one thread (these tests run on one).
    assert np.abs(ours.predictions - theirs.predictions).max() <= 3e-4 * np.abs(
        theirs.predictions).max()
    ours.predictions = theirs.predictions  # the decisions on the same directions
    decisions = []
    for _ in range(60):
        angle = rng.uniform(-np.pi, np.pi)
        start = rng.uniform([20, 20], [400, 280])
        length = rng.uniform(5, 200)
        baseline = np.stack([start, start + length * np.array([np.cos(angle), np.sin(angle)])])
        polygon = helpers.baseline_to_textline(baseline, [rng.uniform(3, 20), 4.0])
        got = ours.check_line_rotation(polygon, baseline)
        assert got == theirs.check_line_rotation(polygon, baseline)
        decisions.append(got)
    assert 0 < sum(decisions) < len(decisions)


# ----------------------------------------------------------------------
# ADJUST_BASELINES and DETECT_STRAIGHT_LINES_IN_REGIONS on the same maps
def _maps(seed, h=160, w=220, rows=(30, 62, 95, 130), tilt=0.03):
    """Detector-like maps: ascender and descender heights, a baseline
    channel peaking along tilted rows, with noise."""
    rng = np.random.default_rng(seed)
    maps = np.zeros((h, w, 5), np.float32)
    maps[:, :, 0] = rng.uniform(5, 8, (h, w))
    maps[:, :, 1] = rng.uniform(1.5, 3, (h, w))
    yy, xx = np.mgrid[:h, :w]
    for r in rows:
        x0, x1 = rng.uniform(5, 40), rng.uniform(150, 210)
        d = yy - (r + tilt * (xx - x0) + 1.5 * np.sin(xx / 25.0))
        maps[:, :, 2] += np.exp(-d ** 2 / 1.5) * ((xx > x0) & (xx < x1))
    maps[:, :, 2] = np.clip(maps[:, :, 2] + rng.normal(0, 0.05, (h, w)), 0, 1)
    maps[:, :, 3:] = rng.uniform(0, 0.1, (h, w, 2))
    return maps.astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_crop_forward_mapping_matches_jax(seed):
    maps = _maps(seed)
    rng = np.random.default_rng(seed)
    ours = EngineLineCropper(line_height=32, poly=0, scale=1)
    theirs = JaxCropper(line_height=32, poly=0, scale=1)
    for r in (30, 62, 95):
        baseline = _baseline(rng, r + 2, x0=10, tilt=0.03)
        got = ours.crop(maps[:, :, 2:3], baseline, [6.0, 6.0], return_forward_mapping=True)
        want = theirs.crop(maps[:, :, 2:3], baseline, [6.0, 6.0], return_forward_mapping=True)
        assert got[0].dtype == want[0].dtype == np.float32 and got[0].ndim == 2
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(4))
def test_refine_baseline_matches_jax(seed):
    maps = _maps(seed)
    rng = np.random.default_rng(seed)
    ours = EngineLineCropper(line_height=32, poly=0, scale=1)
    theirs = JaxCropper(line_height=32, poly=0, scale=1)
    refined = 0
    for r in (30, 62, 95, 130):
        baseline = _baseline(rng, 4 * (r + rng.uniform(-1.5, 1.5)), x0=40, tilt=0.03) * [1, 1]
        heights = [float(rng.uniform(16, 30)), float(rng.uniform(5, 12))]
        got = refine_baseline(baseline, heights, maps, 4.0, ours)
        want = jax_refine(baseline, heights, maps, 4.0, theirs)
        assert np.array_equal(got, want)
        refined += not np.array_equal(got, baseline)
    assert refined >= 2
    off = np.array([[5000.0, 5000.0], [5100.0, 5001.0]])  # off the maps: kept
    assert np.array_equal(refine_baseline(off, [20.0, 6.0], maps, 4.0, ours),
                          jax_refine(off, [20.0, 6.0], maps, 4.0, theirs))


@pytest.mark.parametrize("seed", range(4))
def test_detect_lines_in_region_matches_jax(seed):
    maps = _maps(seed, tilt=(-0.08, 0.0, 0.05, 0.12)[seed])
    rng = np.random.default_rng(seed)
    region = np.array([[0, 0], [860, 10], [870, 600], [10, 630]], float) + rng.uniform(-8, 8, (4, 2))
    got = detect_lines_in_region(region, maps, 4.0)
    want = jax_detect_lines_in_region(region, maps, 4.0)
    assert len(got[0]) == len(want[0]) >= 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    tiny = np.array([[100, 100], [101, 100], [101, 101]], float)
    assert detect_lines_in_region(tiny, maps, 4.0) == ([], [], [])
    assert jax_detect_lines_in_region(tiny, maps, 4.0) == ([], [], [])
