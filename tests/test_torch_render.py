"""The port's layout render (pero_ocr_tpu_torch.core.render, numpy)
against the JAX package's (pero_ocr_tpu.core.render: cv2.polylines and
cv2.circle): bit for bit on the same seeded layouts and pages, with
segments off the raster, zero-length segments, one-point lines, closed
polygons and float coordinates at halves; and the primitives against
cv2 directly on random segments, thicknesses and circle centres.
"""

import cv2
import numpy as np
import pytest

from pero_ocr_tpu.core import render as jax_render
from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.core.layout import RegionLayout as JaxRegionLayout
from pero_ocr_tpu.core.layout import TextLine as JaxTextLine
from pero_ocr_tpu_torch import IMAGES
from pero_ocr_tpu_torch.core import render
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine


def _layouts(spec, size):
    """The same layout in both packages: ``spec`` is a list of (region
    polygon, [(baseline, polygon), ...])."""
    out = []
    for page_cls, region_cls, line_cls in ((PageLayout, RegionLayout, TextLine),
                                           (JaxPageLayout, JaxRegionLayout, JaxTextLine)):
        layout = page_cls(id="page", page_size=size)
        for r, (region_polygon, lines) in enumerate(spec):
            region = region_cls(f"r{r}", region_polygon)
            for k, (baseline, polygon) in enumerate(lines):
                region.lines.append(line_cls(id=f"r{r}-l{k}", baseline=baseline, polygon=polygon))
            layout.regions.append(region)
        out.append(layout)
    return out


def _random_spec(rng, h, w, n_regions=3, n_lines=6):
    """Regions of text lines: baselines of 1-6 points (one-point and
    repeated points among them), polygons around them, coordinates as
    float64 with halves, some far off the raster."""
    spec = []
    for _ in range(n_regions):
        x0, y0 = rng.uniform(-0.2 * w, w), rng.uniform(-0.2 * h, h)
        rw, rh = rng.uniform(20, 0.8 * w), rng.uniform(20, 0.5 * h)
        lines = []
        for k in range(n_lines):
            n = int(rng.integers(1, 7))
            xs = np.sort(rng.uniform(x0, x0 + rw, n))
            ys = y0 + (k + 1) * rh / (n_lines + 1) + rng.normal(0, 2, n)
            baseline = np.stack([xs, ys], 1)
            if rng.random() < 0.3:
                baseline = np.round(baseline * 2) / 2  # halves: rounded to even
            if n > 2 and rng.random() < 0.3:
                baseline[1] = baseline[0]  # a zero-length segment
            up = baseline - [0, rng.uniform(5, 15)]
            polygon = np.concatenate([up, baseline[::-1] + [0, 3]])
            lines.append((baseline, polygon if rng.random() < 0.9 else None))
        corners = np.array([[x0, y0], [x0 + rw, y0], [x0 + rw, y0 + rh], [x0, y0 + rh]])
        spec.append((corners + rng.normal(0, 1, corners.shape), lines))
    return spec


@pytest.mark.parametrize("seed", range(8))
def test_render_layout_equals_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(60, 240, 2))
    port, jax = _layouts(_random_spec(rng, h, w), (h, w))
    page = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    kwargs = [{}, {"thickness": 3}, {"circles": False}, {"thickness": 1}][seed % 4]
    got = port.render_to_image(page.copy(), **kwargs)
    want = jax.render_to_image(page.copy(), **kwargs)
    assert (got != page).any()
    np.testing.assert_array_equal(got, want)


def test_render_layout_edge_cases_equal_jax():
    """One-point baselines (circles only), two-point closed polygons,
    lines wholly off the raster, a region without polygon lines, points
    at x.5 (rounded half to even on both sides)."""
    h, w = 50, 70
    spec = [
        (np.array([[2.5, 3.5], [60.5, 3.5], [60.5, 45.5], [2.5, 45.5]]), [
            (np.array([[10.5, 20.5]]), np.array([[10, 15], [30, 15]])),
            (np.array([[-400.0, 30], [-100, 31]]), np.array([[-400.0, 20], [-100, 21]])),
            (np.array([[5.0, 40], [5, 40], [65, 44]]), np.array([[1e4, -1e4], [-1e4, 1e4],
                                                               [3, 3]])),
        ]),
        (np.array([[80.0, -20], [120, 200]]), []),
    ]
    page = np.full((h, w, 3), 200, np.uint8)
    port, jax = _layouts(spec, (h, w))
    np.testing.assert_array_equal(render.render_layout(port, page.copy()),
                                  jax_render.render_layout(jax, page.copy()))


def test_render_order_is_refused():
    port, _ = _layouts([(np.array([[0, 0], [5, 0], [5, 5]]), [])], (10, 10))
    with pytest.raises(ValueError, match=f"Hershey.*{IMAGES}"):
        port.render_to_image(np.zeros((10, 10, 3), np.uint8), render_order=True)


@pytest.mark.parametrize("thickness", [1, 2, 3, 5, 8])
def test_polylines_equal_cv2(thickness):
    """Random polylines, open and closed, on and off a small raster (the
    thick segments' clip to the raster grown by the thickness)."""
    rng = np.random.default_rng(thickness)
    h, w = 40, 50
    for trial in range(300):
        lo, hi = [(-30, 80), (-2000, 2000), (3, 45)][trial % 3]
        pts = rng.integers(lo, hi, (int(rng.integers(1, 6)), 2)).astype(np.int32)
        closed = bool(trial % 2)
        page = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = page.copy()
        cv2.polylines(want, [pts.reshape(-1, 1, 2)], closed, (0, 0, 255), thickness=thickness)
        got = page.copy()
        render.polylines(got, pts, closed, (0, 0, 255), thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{pts.tolist()} {closed}")


def test_circles_equal_cv2():
    """cv2.circle at radius 3, thickness 4 (render_layout's) at every
    centre on and around a 16x20 raster, and other radii in the middle."""
    h, w = 16, 20
    for cy in range(-10, h + 10):
        for cx in range(-10, w + 10):
            want = np.zeros((h, w, 3), np.uint8)
            cv2.circle(want, (cx, cy), 3, (255, 0, 0), 4)
            got = np.zeros((h, w, 3), np.uint8)
            render.circle(got, (cx, cy), 3, (255, 0, 0), 4)
            np.testing.assert_array_equal(got, want, err_msg=f"{(cx, cy)}")
    for radius, thickness in ((0, 2), (1, 3), (2, 2), (7, 4), (12, 3), (20, 6)):
        want = np.zeros((60, 60, 3), np.uint8)
        cv2.circle(want, (30, 29), radius, (0, 255, 0), thickness)
        got = np.zeros((60, 60, 3), np.uint8)
        render.circle(got, (30, 29), radius, (0, 255, 0), thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{radius} {thickness}")
