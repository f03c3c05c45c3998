"""Host layout and Page XML of the port against the JAX package, which
runs them through cv2 (approxPolyDP, convexHull, fillPoly, findContours)
and lxml, on seeded numpy inputs.

Held to: the same points in the same order for simplification, hulls,
alpha-shape outlines (the raster fallback included) and cv2's raster
primitives; the same clusters and separator penalties within 1e-6 for
paragraph clustering; the same Page XML bytes apart from the Created and
LastChange timestamps, from the layout assembly and from the writer, and
equal fields when each package reads the other's file.
"""

import re
from fractions import Fraction

import cv2
import numpy as np
import pytest

from pero_ocr_tpu.core import geometry as jax_geometry
from pero_ocr_tpu.core import layout as jax_layout
from pero_ocr_tpu.document.fast_pipeline import assemble_page_layout as jax_assemble
from pero_ocr_tpu.layout_engines import helpers as jax_helpers
from pero_ocr_tpu.layout_engines.cnn_engine import ParagraphClusterer as JaxClusterer
from pero_ocr_tpu.utils import native
from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.core import layout as port_layout
from pero_ocr_tpu_torch.document.fast_pipeline import assemble_page_layout
from pero_ocr_tpu_torch.layout_engines import helpers
from pero_ocr_tpu_torch.layout_engines.cnn_engine import ParagraphClusterer
from pero_ocr_tpu_torch.parallel.pipeline import PageResult

# The JAX pipeline clusters through its native library; without it, its
# Python fallback rounds the penalty windows differently (ROADMAP.md,
# section 3), so the tests that hold the port to it need the library.
needs_native = pytest.mark.skipif(native.get_library() is None,
                                  reason="native library unavailable")


def _paragraph(rng, n_lines, x0=60.0, y0=80.0, spacing=56.0, points=10):
    """Baselines and heights of a ragged paragraph of text lines."""
    baselines, heights = [], []
    for r in range(n_lines):
        xa = x0 + rng.uniform(0, 40)
        xb = x0 + 700 - rng.uniform(0, 300)
        x = np.linspace(xa, xb, points)
        y = y0 + r * spacing + rng.normal(0, 1.5, points)
        baselines.append(np.stack([x, y], 1))
        heights.append([rng.uniform(18, 30), rng.uniform(5, 9)])
    return baselines, heights


def _polygon(kind, rng):
    n = int(rng.integers(3, 60))
    if kind == "random":
        return rng.uniform(0, 100, (n, 2))
    if kind == "star":
        a = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(20, 50, n)
        return np.stack([50 + r * np.cos(a), 50 + r * np.sin(a)], 1)
    if kind == "near_collinear":
        x = np.linspace(0, 200, n)
        top = np.stack([x, rng.normal(0, 2, n)], 1)
        return np.concatenate([top, top[::-1] + [0, 30]])
    if kind == "integer_grid":  # duplicates and exact ties
        return rng.integers(0, 8, (n, 2)).astype(float)
    # "paragraph": the alpha-shape outline that simplification gets.
    b, h = _paragraph(rng, int(rng.integers(1, 12)), spacing=rng.uniform(30, 70),
                      points=int(rng.integers(2, 12)))
    return jax_helpers.region_from_textlines(jax_helpers.baselines_to_textlines(b, h))


@pytest.mark.parametrize(
    "kind", ["random", "star", "near_collinear", "integer_grid", "paragraph"]
)
def test_simplify_polygon_matches_cv2(kind):
    rng = np.random.default_rng(10)
    for _ in range(150):
        poly = _polygon(kind, rng)
        for tolerance in (1.0, 5.0):
            want = jax_geometry.simplify_polygon(poly, tolerance)
            got = geometry.simplify_polygon(poly, tolerance)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "integer_grid", "horizontal", "paragraph"])
def test_convex_hull_matches_cv2(kind):
    rng = np.random.default_rng(11)
    for _ in range(200):
        n = int(rng.integers(1, 40))
        if kind == "random":
            pts = rng.uniform(0, 100, (n, 2))
        elif kind == "integer_grid":
            pts = rng.integers(0, 10, (n, 2)).astype(float)
        elif kind == "horizontal":
            pts = np.stack([rng.uniform(0, 100, n), np.full(n, 3.0)], 1)
        else:
            b, h = _paragraph(rng, int(rng.integers(1, 6)))
            pts = np.concatenate(jax_helpers.baselines_to_textlines(b, h))
        want = jax_geometry.convex_hull(pts)
        got = geometry.convex_hull(pts)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _turn_sine(hull, k):
    """|sin| of the turn at vertex k of a closed hull, from the exact
    cross product of its two edges (the float32 values as fractions)."""
    p, v, n = ([Fraction(float(c)) for c in hull[i % len(hull)]] for i in (k - 1, k, k + 1))
    cross = (v[0] - p[0]) * (n[1] - v[1]) - (v[1] - p[1]) * (n[0] - v[0])
    edges = np.hypot(float(v[0] - p[0]), float(v[1] - p[1])) * np.hypot(
        float(n[0] - v[0]), float(n[1] - v[1]))
    return float(abs(cross)) / edges if edges else 0.0


def test_convex_hull_near_collinear_float32():
    """The one known difference (ROADMAP.md, section 3): on points that
    lie on a line up to float32 rounding (y = 2x + 1), cv2's hull keeps
    or drops a vertex whose cross product with its neighbours is ~1e-8
    of its terms where the port's float32-difference, float64-product
    test decides the other way.  Held to: most hulls equal; in the
    others, every vertex that only one hull has turns by less than
    float32's machine epsilon (|sin| < 2**-23, from the exact cross
    product), and without those vertices the two hulls are the same
    cycle of points."""
    rng = np.random.default_rng(11)
    equal = 0
    for _ in range(300):
        x = rng.uniform(0, 100, int(rng.integers(1, 40)))
        pts = np.stack([x, 2 * x + 1], 1)
        want = jax_geometry.convex_hull(pts)
        got = geometry.convex_hull(pts)
        if got.shape == want.shape and np.array_equal(got, want):
            equal += 1
            continue
        cycles = []
        for hull, other in ((got, want), (want, got)):
            others = {tuple(p) for p in other}
            only = [k for k, p in enumerate(hull) if tuple(p) not in others]
            assert all(_turn_sine(hull, k) < 2.0 ** -23 for k in only)
            cycles.append([tuple(p) for k, p in enumerate(hull) if k not in only])
        a, b = cycles
        assert len(a) == len(b) and any(a == b[r:] + b[:r] for r in range(len(b)))
    assert equal >= 0.9 * 300


def test_raster_primitives_match_cv2():
    """The raster fallback's parts alone: 8-connected lines, fillPoly's
    even-odd scanline fill over several triangles, and the largest
    external contour with CHAIN_APPROX_SIMPLE."""
    rng = np.random.default_rng(12)
    for _ in range(300):
        ends = rng.integers(2, 40, (2, 2))
        want = np.zeros((45, 45), np.uint8)
        cv2.line(want, tuple(map(int, ends[0])), tuple(map(int, ends[1])), 1, 1, cv2.LINE_8)
        got = np.zeros_like(want)
        geometry._draw_lines(got, ends[:1], ends[1:])
        np.testing.assert_array_equal(got, want)
    for _ in range(300):
        tris = rng.integers(2, 40, (int(rng.integers(1, 6)), 3, 2)).astype(np.int32)
        want = np.zeros((45, 45), np.uint8)
        cv2.fillPoly(want, list(tris), 1)
        got = np.zeros_like(want)
        geometry._fill_polys(got, tris)
        np.testing.assert_array_equal(got, want)
    for _ in range(300):
        mask = (rng.random((30, 30)) < rng.uniform(0.3, 0.8)).astype(np.uint8)
        mask[:2], mask[-2:], mask[:, :2], mask[:, -2:] = 0, 0, 0, 0
        if not mask.any():
            continue
        contours, _ = cv2.findContours(mask.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        want = max(contours, key=cv2.contourArea).reshape(-1, 2)
        np.testing.assert_array_equal(geometry._largest_external_contour(mask), want)


def _count_raster_fallbacks(monkeypatch):
    calls = []
    inner = geometry._largest_external_contour
    monkeypatch.setattr(geometry, "_largest_external_contour",
                        lambda mask: calls.append(1) or inner(mask))
    return calls


def test_region_outlines_match_jax():
    """Alpha-shape region outlines (polygon and covers_all) on ragged
    paragraphs, then simplified, as the layout assembly draws them."""
    rng = np.random.default_rng(13)
    for _ in range(60):
        b, h = _paragraph(rng, int(rng.integers(1, 20)), spacing=rng.uniform(30, 70),
                          points=int(rng.integers(2, 12)))
        textlines = helpers.baselines_to_textlines(b, h)
        want_t = jax_helpers.baselines_to_textlines(b, h)
        for g, w in zip(textlines, want_t):
            np.testing.assert_array_equal(g, w)
        points = np.concatenate(textlines)
        alpha = 1.0 / rng.uniform(20, 200)
        got, got_all = geometry.alpha_shape_info(points, alpha)
        want, want_all = jax_geometry.alpha_shape_info(points, alpha)
        assert got_all == want_all
        np.testing.assert_array_equal(got, want)
        region = helpers.region_from_textlines(textlines)
        np.testing.assert_array_equal(region, jax_helpers.region_from_textlines(want_t))
        np.testing.assert_array_equal(geometry.simplify_polygon(region, 5),
                                      jax_geometry.simplify_polygon(region, 5))


def test_pinched_unions_take_the_raster_fallback_as_jax(monkeypatch):
    """A union of kept triangles whose rings meet at a vertex has no
    ring walk: both packages fill the int-truncated triangles and keep
    the largest external contour.  One paragraph of textlines (seed 144
    of this generator pinches) and seeded point clouds."""
    fallbacks = _count_raster_fallbacks(monkeypatch)
    rng = np.random.default_rng(144)
    baselines, heights = [], []
    for r in range(int(rng.integers(2, 5))):
        xa, length = rng.uniform(0, 200), rng.uniform(60, 300)
        y = 50 + r * rng.uniform(20, 45)
        points = int(rng.integers(3, 10))
        x = np.linspace(xa, xa + length, points)
        baselines.append(np.stack([x, y + rng.normal(0, 3, points)], 1))
        heights.append([rng.uniform(6, 20), rng.uniform(2, 8)])
    textlines = helpers.baselines_to_textlines(baselines, heights)
    got = helpers.region_from_textlines(textlines)
    assert len(fallbacks) == 1
    np.testing.assert_array_equal(got, jax_helpers.region_from_textlines(textlines))

    rng = np.random.default_rng(2)
    for _ in range(60):
        cloud = rng.uniform(0, 100, (int(rng.integers(6, 60)), 2))
        alpha = 1.0 / rng.uniform(8, 30)
        got, got_all = geometry.alpha_shape_info(cloud, alpha)
        want, want_all = jax_geometry.alpha_shape_info(cloud, alpha)
        assert got_all == want_all
        np.testing.assert_array_equal(got, want)
    assert len(fallbacks) > 10


def _two_column_page(sep_pool, separator):
    """Baselines of a two-column page of 7 lines a column (page px; a
    ds-4 map of 160 x 120) and its separator map at pooled resolution:
    low noise, and with ``separator`` a bar across the left column
    between its 4th and 5th lines.  Half-pixel heights make ties."""
    rng = np.random.default_rng(14)
    baselines, heights = [], []
    for x0, x1 in ((20.0, 220.0), (250.0, 460.0)):
        for r in range(7):
            y = 60 + 50 * r + rng.normal(0, 1, 6)
            baselines.append(np.stack([np.linspace(x0 + rng.uniform(0, 8), x1, 6), y], 1))
            heights.append([float(rng.integers(40, 50)) / 2, float(rng.integers(12, 16)) / 2])
    sep = (rng.random((160, 120)) * 0.05).astype(np.float32)
    if separator:
        sep[52:62, 2:56] = 1.0  # page y 208-248, x 8-224
    pooled = sep.reshape(160 // sep_pool, sep_pool, 120 // sep_pool, sep_pool).max(axis=(1, 3))
    return baselines, heights, pooled


@needs_native
@pytest.mark.parametrize("kind", ["random", "textlines"])
def test_polygons_close_matches_native(kind):
    """The close-pair test of the clustering (bounds, then the segment
    formula) against the JAX package's exact native test, with each
    threshold just off the pair's distance on either side; the batched
    distances equal the JAX function's."""
    rng = np.random.default_rng(16)
    if kind == "random":
        polys = [rng.uniform(0, 100, (int(n), 2)) for n in rng.integers(3, 9, size=10)]
    else:
        baselines, heights, _ = _two_column_page(1, False)
        polys = helpers.baselines_to_textlines(baselines, heights)
    pairs = np.array([[i, j] for i in range(len(polys)) for j in range(i + 1, len(polys))],
                     np.int32)
    dists = geometry.polygon_min_distance_batch(polys, pairs)
    np.testing.assert_array_equal(dists, jax_geometry.polygon_min_distance_batch(polys, pairs))
    for scale in (0.5, 1.0 - 1e-9, 1.0 + 1e-9, 2.0):
        thr = np.maximum(dists * scale, 1e-9)
        np.testing.assert_array_equal(geometry.polygons_close(polys, pairs, thr),
                                      native.native_polygons_close(polys, pairs, thr))


@needs_native
@pytest.mark.parametrize("separator", [False, True], ids=["no_bar", "bar"])
@pytest.mark.parametrize("sep_pool", [1, 4])
def test_make_clusters_matches_jax(sep_pool, separator):
    baselines, heights, sep = _two_column_page(sep_pool, separator)
    textlines = helpers.baselines_to_textlines(baselines, heights)
    got = ParagraphClusterer().make_clusters(baselines, heights, textlines, sep, 4,
                                             sep_pool=sep_pool)
    want = JaxClusterer().make_clusters(baselines, heights, textlines, sep, 4,
                                        sep_pool=sep_pool)
    np.testing.assert_array_equal(got, want)
    # One paragraph a column; the bar splits the left one.
    assert len(set(np.asarray(got).tolist())) == (3 if separator else 2)
    n = len(baselines)
    pairs = np.array([(i, j) for i in range(n) for j in range(i + 1, n)])
    got_pen = ParagraphClusterer()._pair_penalties_batch(baselines, heights, pairs, sep, 4,
                                                         pool=sep_pool)
    want_pen = JaxClusterer()._pair_penalties_batch(baselines, heights, pairs, sep, 4,
                                                    pool=sep_pool)
    np.testing.assert_allclose(got_pen, want_pen, atol=1e-6, rtol=0)
    for (i, j), p in zip(pairs[::7], got_pen[::7]):
        assert ParagraphClusterer().get_pair_penalty(
            baselines[i], baselines[j], heights[i], heights[j], sep, 4, pool=sep_pool
        ) == pytest.approx(p, abs=1e-12)


@needs_native
def test_penalty_window_rounds_half_away_from_zero():
    """The JAX package's two penalty paths disagree when the window's
    end, trunc(x) / ds, is a half: its native kernel (what its pipeline
    runs) rounds it away from zero, its Python get_penalty to even.  The
    port follows the native kernel (ROADMAP.md, section 3)."""
    sep = np.zeros((40, 60), np.float32)
    sep[:, 2] = 1.0  # only column 2 carries mass
    b1 = np.array([[0.0, 40.0], [200.0, 40.0]])
    b2 = np.array([[10.0, 80.0], [200.0, 80.0]])  # window starts at 10 / 4 = 2.5
    h = [12.0, 4.0]
    pairs = np.array([[0, 1]])
    native = JaxClusterer()._pair_penalties_batch([b1, b2], [h, h], pairs, sep, 4)[0]
    python = JaxClusterer().get_pair_penalty(b1, b2, h, h, sep, 4)
    port = ParagraphClusterer().get_pair_penalty(b1, b2, h, h, sep, 4)
    assert native == 0.0 and python == pytest.approx(3 / 47.5)
    assert port == native


# ----------------------------------------------------------------------
# Page XML
def _layout(module):
    lay = module.PageLayout(id='page &<>"\' ž 1', page_size=(2560, 1792))
    r1 = module.RegionLayout("r1", np.array([[0, 0], [10.5, 0.5], [11.5, 10], [0, 9.49]]))
    r1.transcription = 'a&b<c>d"e\'f ​ ž\n\tx'
    r1.lines.append(module.TextLine(
        id="r1-l001", index=0, baseline=np.array([[1, 2], [300.4, 4.6]]),
        polygon=np.array([[1, 1], [2, 2.5], [3, 3.5]]), heights=[3.25, 1.0],
        transcription='Příliš & <x> "q" ​', transcription_confidence=0.12345,
    ))
    r1.lines.append(module.TextLine(  # missing confidence, empty text
        id="r1-l002", baseline=np.array([[1, 20], [3, 40]]), heights=[2.0, 1.0],
        polygon=np.array([[0, 10], [5, 10], [5, 45], [0, 45]]), transcription="",
    ))
    r1.lines.append(module.TextLine(  # no heights: the reader guesses them
        id="r1-l003", index=7, baseline=np.array([[10, 100], [200, 100]]),
        polygon=np.array([[10, 80], [200, 80], [200, 106], [10, 106]]),
        transcription="\U0001F600 'ok'",
    ))
    r2 = module.RegionLayout("r2", np.array([[20, 20], [40, 20], [40, 40]]), region_type='a"b<')
    lay.regions += [r1, r2]
    return lay


def _masked(xml):
    return re.sub(r"<(Created|LastChange)>[^<]*</\1>", r"<\1/>", xml)


def _fields(lay):
    return [
        (r.id, r.region_type, r.transcription, np.asarray(r.polygon).tolist(),
         [(ln.id, ln.index, ln.transcription, ln.transcription_confidence,
           None if ln.heights is None else np.round(ln.heights, 9).tolist(),
           np.asarray(ln.baseline).tolist(), np.asarray(ln.polygon).tolist())
          for ln in r.lines])
        for r in lay.regions
    ] + [lay.id, tuple(lay.page_size), lay.reading_order]


@pytest.mark.parametrize("reading_order", [None, {"r2": 0, "r1": 1}], ids=["plain", "ordered"])
@pytest.mark.parametrize("version", ["PAGE_2019_07_15", "PAGE_2013_07_15"])
def test_pagexml_writer_matches_lxml_and_round_trips(version, reading_order):
    want_lay, got_lay = _layout(jax_layout), _layout(port_layout)
    want_lay.reading_order = got_lay.reading_order = reading_order
    want = want_lay.to_pagexml_string(version=getattr(jax_layout.PAGEVersion, version))
    got = got_lay.to_pagexml_string(version=getattr(port_layout.PAGEVersion, version))
    assert _masked(got).encode("utf-8") == _masked(want).encode("utf-8")
    if version == "PAGE_2019_07_15":
        assert "<Creator>pero_ocr_tpu</Creator>" in got and "<Created>" in got

    # Each package reads the other's file.
    port_reads_jax, jax_reads_port = port_layout.PageLayout(), jax_layout.PageLayout()
    port_reads_jax.from_pagexml_string(want)
    jax_reads_port.from_pagexml_string(got)
    jax_reads_jax = jax_layout.PageLayout()
    jax_reads_jax.from_pagexml_string(want)
    assert _fields(port_reads_jax) == _fields(jax_reads_jax) == _fields(jax_reads_port)


def _page_result(case):
    """A PageResult of three lines (one a zero-length baseline, whose
    outline is a vertical segment) for the assembly's branches."""
    rng = np.random.default_rng(15)
    baselines = [np.array([[40.0, 100.0], [400.0, 104.0]]),
                 np.array([[42.0, 160.0], [380.0, 158.0], [420.0, 163.0]]),
                 np.array([[900.0, 700.0], [900.0, 700.0]])]
    heights = [[20.0, 6.0], [18.5, 5.5], [12.0, 4.0]]
    labels = rng.integers(-1, 10, (3, 12))
    lengths = np.array([12, 5, 0])
    confidences = np.array([0.91234, 0.5, 0.0])
    if case == "no_lines":
        return PageResult(0, [], [], None, None, None)
    if case == "unclustered":
        return PageResult(0, baselines, heights, labels, lengths, None, None, confidences)
    if case == "no_labels":
        return PageResult(0, baselines, heights, None, None, None, [0, 0, 1])
    # Cluster 1 has no lines (skipped); cluster 2 is the degenerate line
    # alone, whose outline falls back to its bounding box.
    return PageResult(0, baselines, heights, labels, lengths, None, [0, 0, 2],
                      None if case == "no_confidences" else confidences,
                      textlines=helpers.baselines_to_textlines(baselines, heights))


@pytest.mark.parametrize("case", ["clustered", "no_confidences", "unclustered",
                                  "no_labels", "no_lines"])
def test_assemble_page_layout_matches_jax(case):
    """The layout assembly's branches against the JAX function on the
    same PageResult: labels outside the charset dropped, missing
    confidences and labels, a cluster id with no lines, a degenerate
    region's bounding box, one region when clusters is None, and the
    whole-page region of a page without lines."""
    result = _page_result(case)
    chars = list("ab&<\"'ž​")
    got = assemble_page_layout(result, "p&1", (1792, 2560), chars)
    want = jax_assemble(result, "p&1", (1792, 2560), chars)
    assert _masked(got.to_pagexml_string()) == _masked(want.to_pagexml_string())
    n_regions = {"clustered": 2, "no_confidences": 2, "unclustered": 1,
                 "no_labels": 2, "no_lines": 1}[case]
    assert len(got.regions) == n_regions


def test_pagexml_refuses_what_lxml_refuses():
    for module in (jax_layout, port_layout):
        lay = _layout(module)
        lay.regions[0].lines[0].transcription = "bad \x01 byte"
        with pytest.raises(ValueError, match="XML compatible"):
            lay.to_pagexml_string()
