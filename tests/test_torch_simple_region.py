"""``REGION_SIMPLE_THRESHOLD`` in the port against cv2 5.0.0 and the JAX
package, on the CPU.

- Each OpenCV copy of the stage against its cv2 call, bit for bit on
  seeded images of random sizes (heights and widths of the form 4k + 2
  and odd ones among them) and on a blank page: ``resize_linear_u8``,
  ``normalize_minmax_u8``, ``pad_constant_u8``, the Gaussian kernel,
  blur and ``adaptive_threshold_gaussian``, ``close_u8``,
  ``near_ink_mask``, ``connected_components_cv``'s numbering, the
  NL-means twin and its C++ (which needs a host compiler and skips
  without one), and the largest external contour of a component that
  touches the image's edge.
- ``SimpleThresholdRegion`` against the JAX stage on synthetic one-,
  two- and three-column pages of a few hundred rows (where the 10% pad
  is narrower than the border distance, so components reach the padded
  frame), ink at the page's edges and a blank page: the same region ids
  and int32 outlines, with ``precise_envelope`` on and off.
- ``PageParser`` with the method in place of config 1's
  ``REGION_WHOLE_PAGE`` against the JAX PageParser: the same Page XML.
- The port's command line on that ini with ``--process-count 2`` (two
  spawned workers) against itself in one process and the JAX command
  line: the same files and transcriptions; a worker that cannot build
  its PageParser fails the command.
"""

import configparser
import os
import random
import re
import shutil

import cv2
import numpy as np
import pytest

from chip_smoke import printed_pages
from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.document.page_parser import PageParser as JaxPageParser
from pero_ocr_tpu.layout_engines.simple_region_engine import (
    SimpleThresholdRegion as JaxSimpleThresholdRegion,
)
from pero_ocr_tpu_torch.core import geometry
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.document.page_parser import PageParser
from pero_ocr_tpu_torch.layout_engines.simple_region_engine import SimpleThresholdRegion
from pero_ocr_tpu_torch.scripts import parse_folder
from pero_ocr_tpu_torch.utils import denoise, imgproc, threshold
from pero_ocr_tpu_torch.utils.resize import resize_linear_u8
from tests.test_torch_cli import (  # noqa: F401  (torch_threads_share: a fixture)
    _jax_cli, _masked, _run_port, assert_xml_equal, torch_threads_share,
)
from tests.test_torch_config1 import config1_bundle  # noqa: F401  (a fixture)

BORDER = cv2.BORDER_REPLICATE | cv2.BORDER_ISOLATED
needs_cxx = pytest.mark.skipif(shutil.which(os.environ.get("CXX") or "c++") is None,
                               reason="no host C++ compiler")


def _sizes(rng, n, lo=3, hi=160):
    """Random (h, w), a quarter of each of the forms 4k + 2 and odd."""
    out = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(lo, hi, 2))
        if i % 4 == 1:
            h, w = 4 * (h // 4) + 2, 4 * (w // 4) + 2
        elif i % 4 == 2:
            h, w = h | 1, w | 1
        out.append((h, w))
    return out


# ----------------------------------------------------------------------
# The OpenCV copies

@pytest.mark.parametrize("factor", [1, 2, 3, 4, 5, 6, 8])
def test_resize_linear_equals_cv2(factor):
    rng = np.random.default_rng(factor)
    for h, w in _sizes(rng, 40, lo=factor):
        for channels in (1, 3):
            shape = (h, w) if channels == 1 else (h, w, 3)
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            want = cv2.resize(img, None, fx=1 / factor, fy=1 / factor)
            np.testing.assert_array_equal(resize_linear_u8(img, factor), want)


def test_resize_linear_on_an_a4_page_and_other_factors():
    """Factor 4 on an A4 page at 300 dpi; factors that are not integers
    raise rather than give other numbers than cv2's."""
    img = np.random.default_rng(0).integers(0, 256, (3508, 2480), dtype=np.uint8)
    np.testing.assert_array_equal(resize_linear_u8(img, 4),
                                  cv2.resize(img, None, fx=1 / 4, fy=1 / 4))
    for bad in (0, 1.5, -2, True):
        with pytest.raises(ValueError, match="downscale"):
            resize_linear_u8(img[:8, :8], bad)


def test_normalize_minmax_equals_cv2():
    rng = np.random.default_rng(1)
    for h, w in _sizes(rng, 300):
        lo, hi = sorted(int(v) for v in rng.integers(0, 256, 2))
        img = rng.integers(lo, hi + 1, (h, w), dtype=np.uint8)
        want = cv2.normalize(img, None, alpha=0, beta=255, norm_type=cv2.NORM_MINMAX,
                             dtype=cv2.CV_8UC1)
        np.testing.assert_array_equal(threshold.normalize_minmax_u8(img), want)
    flat = np.full((9, 13), 77, np.uint8)  # max == min: scale 0, all zero
    np.testing.assert_array_equal(threshold.normalize_minmax_u8(flat), cv2.normalize(
        flat, None, alpha=0, beta=255, norm_type=cv2.NORM_MINMAX, dtype=cv2.CV_8UC1))
    assert not threshold.normalize_minmax_u8(flat).any()


@pytest.mark.parametrize("value", [150.5, 151.5, 100.0, 99.5, 254.7, 255.5, 300.0])
def test_pad_constant_rounds_like_cv2(value):
    img = np.random.default_rng(2).integers(0, 256, (7, 11), dtype=np.uint8)
    want = cv2.copyMakeBorder(img, 2, 3, 4, 5, cv2.BORDER_CONSTANT, value=value)
    np.testing.assert_array_equal(threshold.pad_constant_u8(img, 2, 3, 4, 5, value), want)


def test_gaussian_kernel_equals_cv2():
    for n in range(1, 152, 2):
        np.testing.assert_array_equal(threshold.gaussian_kernel_f32(n),
                                      cv2.getGaussianKernel(n, 0, cv2.CV_32F).ravel())


@pytest.mark.parametrize("block", [25, 51])
def test_gaussian_blur_f32_equals_cv2(block):
    """The float32 blur itself, bit for bit, at the stage's block (25)
    and one more."""
    rng = np.random.default_rng(block)
    for h, w in _sizes(rng, 24, hi=140):
        img = rng.integers(0, 256, (h, w)).astype(np.float32)
        want = cv2.GaussianBlur(img, (block, block), 0, borderType=BORDER)
        np.testing.assert_array_equal(threshold.gaussian_blur_f32(img, block), want)


@pytest.mark.parametrize("block,c", [(25, 80), (25, 3), (13, 10), (51, 80)])
def test_adaptive_threshold_gaussian_equals_cv2(block, c):
    rng = np.random.default_rng(block + c)
    images = [rng.integers(0, 256, s, dtype=np.uint8) for s in _sizes(rng, 16, hi=140)]
    images += [printed_pages(rng, 1, 200, 150, 5)[0][0][:, :, 0],
               np.full((40, 30), 200, np.uint8)]
    for img in images:
        want = cv2.adaptiveThreshold(img, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                     cv2.THRESH_BINARY, block, c)
        np.testing.assert_array_equal(threshold.adaptive_threshold_gaussian(img, block, c), want)


def _masks(rng, n):
    """Random ink masks (0/255) of random sizes: speckle, blobs, the
    page's edges inked, and a blank page."""
    out = [np.zeros((30, 41), np.uint8)]
    for i, (h, w) in enumerate(_sizes(rng, n, lo=4, hi=120)):
        m = rng.random((h, w)) < rng.uniform(0.002, 0.05)
        if i % 3 == 1:
            m = cv2.dilate(m.astype(np.uint8), np.ones((3, 3), np.uint8)) > 0
        if i % 3 == 2:
            m[:, 0] = m[-1, :] = True
        out.append(m.astype(np.uint8) * 255)
    return out


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_close_and_distance_mask_equal_cv2(k):
    rng = np.random.default_rng(k)
    for ink in _masks(rng, 30):
        want = cv2.morphologyEx(ink, cv2.MORPH_CLOSE, np.ones((k, k), np.uint8))
        closed = imgproc.close_u8(ink, k)
        np.testing.assert_array_equal(closed, want)
        dist = cv2.distanceTransform(255 - want, cv2.DIST_L2, cv2.DIST_MASK_PRECISE)
        for limit in (11, 3):
            np.testing.assert_array_equal(imgproc.near_ink_mask(closed, limit),
                                          (dist < limit).astype(np.uint8))
    blank = np.zeros((20, 20), np.uint8)  # no ink: cv2's distances are all ~1.8e19
    assert not imgproc.near_ink_mask(blank, 11).any()


@pytest.mark.parametrize("shape", [(60, 80), (61, 79), (258, 190), (1053, 744)])
def test_connected_components_numbered_as_cv2(shape):
    rng = np.random.default_rng(shape[0])
    for density in (0.05, 0.3, 0.5):
        for _ in range(3 if shape[0] < 1000 else 1):
            mask = (rng.random(shape) < density).astype(np.uint8)
            want_n, want = cv2.connectedComponents(mask, connectivity=8)
            got_n, got = imgproc.connected_components_cv(mask)
            assert got_n == want_n
            np.testing.assert_array_equal(got, want)
    n, labels = imgproc.connected_components_cv(np.zeros(shape, np.uint8))
    assert n == 1 and not labels.any()


def _nl_images(rng):
    images = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((31, 48), (20, 9), (1, 5))]
    smooth = cv2.GaussianBlur(rng.integers(0, 256, (64, 77), dtype=np.uint8), (7, 7), 0)
    page = printed_pages(rng, 1, 60, 70, 3)[0][0][:, :, 0]
    return images + [smooth, page]


@pytest.mark.parametrize("h", [5, 3, 10])
def test_nl_means_plain_equals_cv2(h):
    for img in _nl_images(np.random.default_rng(h)):
        np.testing.assert_array_equal(denoise.nl_means_plain(img, h),
                                      cv2.fastNlMeansDenoising(img, h=h))


@needs_cxx
@pytest.mark.parametrize("threads", [0, 1, 3])
def test_nl_means_cpp_equals_cv2(threads):
    rng = np.random.default_rng(threads)
    images = _nl_images(rng) + [printed_pages(rng, 1, 300, 230, 8)[0][0][:, :, 0]]
    for img in images:
        got = denoise.nl_means(img, 5, threads=threads)
        np.testing.assert_array_equal(got, cv2.fastNlMeansDenoising(img, h=5))
    assert denoise.calls["nl_means_u8"] >= len(images)


@pytest.mark.parametrize("edge", ["top", "bottom", "left", "right", "corner", "all"])
def test_largest_contour_of_a_component_on_the_edge(edge):
    """``_largest_external_contour`` needs no zero frame: components that
    touch the image's edge trace as cv2.findContours traces them."""
    rng = np.random.default_rng(len(edge))
    for _ in range(40):
        mask = (rng.random((24, 31)) < rng.uniform(0.3, 0.8)).astype(np.uint8)
        if edge in ("top", "corner", "all"):
            mask[0] = 1
        if edge in ("bottom", "all"):
            mask[-1] = 1
        if edge in ("left", "corner", "all"):
            mask[:, 0] = 1
        if edge in ("right", "all"):
            mask[:, -1] = 1
        contours, _ = cv2.findContours(mask.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        want = max(contours, key=cv2.contourArea).reshape(-1, 2)
        np.testing.assert_array_equal(geometry._largest_external_contour(mask), want)


# ----------------------------------------------------------------------
# The stage

def column_page(rng, h: int, w: int, rows: int, columns: int = 1, edges: bool = False):
    """A BGR page of ``columns`` printed columns of ``rows`` rows
    (``printed_pages``' glyphs); with ``edges`` a scanner's dark band at
    the left edge and ink blots in the corners and at the bottom."""
    page = rng.normal(240, 5, (h, w)).clip(0, 255).astype(np.uint8)
    for c in range(columns):
        x0, x1 = int(w * (0.04 + c / columns)), int(w * ((c + 1) / columns - 0.04))
        text = printed_pages(rng, 1, h, x1 - x0, rows)[0][0][:, :, 0]
        page[:, x0:x1] = np.minimum(page[:, x0:x1], text)
    if edges:
        page[:, :6] = 30
        page[:5, -9:] = 20
        page[-4:, w // 3: w // 2] = 40
        page[h // 2: h // 2 + 3, w - 12: w - 9] = 10  # a speck below min_points
    return np.repeat(page[:, :, None], 3, axis=2)


def _stage_pages():
    rng = np.random.default_rng(17)
    return {
        "one_column": column_page(rng, 300, 240, 7),
        "two_columns": column_page(rng, 320, 420, 8, columns=2),
        "three_columns_edges": column_page(rng, 280, 500, 6, columns=3, edges=True),
        "printed": printed_pages(rng, 1, 420, 560, 6)[0][0],
        "gray_input": column_page(rng, 260, 300, 5, columns=2)[:, :, 0],
        "blank": np.full((200, 150, 3), 235, np.uint8),
    }


def _regions_equal(got, want):
    assert [r.id for r in got.regions] == [r.id for r in want.regions]
    for a, b in zip(got.regions, want.regions):
        assert a.polygon.dtype == b.polygon.dtype == np.int32
        np.testing.assert_array_equal(a.polygon, b.polygon)


@pytest.mark.parametrize("name", list(_stage_pages()))
def test_stage_equals_jax(name):
    """process_page with the defaults (precise envelopes), and the
    convex-hull envelope through ``_compute_layout``, on the numpy route."""
    page = _stage_pages()[name]
    got = SimpleThresholdRegion(device="cpu").process_page(
        page, PageLayout(id=name, page_size=page.shape[:2]))
    want = JaxSimpleThresholdRegion().process_page(
        page, JaxPageLayout(id=name, page_size=page.shape[:2]))
    _regions_equal(got, want)
    if name == "blank":
        assert got.regions == []
    else:
        assert got.regions
    hull_got = SimpleThresholdRegion._compute_layout(page, precise_envelope=False, native=False)
    hull_want = JaxSimpleThresholdRegion._compute_layout(page, precise_envelope=False)
    assert len(hull_got) == len(hull_want)
    for a, b in zip(hull_got, hull_want):
        np.testing.assert_array_equal(a, b)


def test_stage_finds_the_columns_and_edges():
    """The pages are what they are meant to be: two regions for the two
    columns, and on the edge page regions that reach past the padded
    frame (outlines at the page's border or beyond)."""
    pages = _stage_pages()
    two = SimpleThresholdRegion._compute_layout(pages["two_columns"], native=False)
    assert len(two) == 2 and two[0][:, 0].max() < two[1][:, 0].min()
    edge = SimpleThresholdRegion._compute_layout(pages["three_columns_edges"], native=False)
    assert min(int(p[:, 0].min()) for p in edge) <= 0


@needs_cxx
def test_stage_cpp_route_equals_numpy_route():
    page = _stage_pages()["three_columns_edges"]
    stage = SimpleThresholdRegion(device="cpu")
    stage.native = True
    got = stage.process_page(page, PageLayout(id="p", page_size=page.shape[:2]))
    want = SimpleThresholdRegion(device="cpu").process_page(
        page, PageLayout(id="p", page_size=page.shape[:2]))
    _regions_equal(got, want)


def _threshold_config(bundle):
    config = configparser.ConfigParser()
    config.read(bundle / "config.ini")
    config["LAYOUT_PARSER_1"]["METHOD"] = "REGION_SIMPLE_THRESHOLD"
    return config


def test_page_parser_with_simple_threshold_equals_jax(config1_bundle):
    """Config 1 with REGION_SIMPLE_THRESHOLD for its first layout stage
    (the float32 recognizer of config1_bundle, ``random`` seeded alike):
    the same Page XML, texts included, on config 1's pages, on pages
    whose text runs to within 12 px of the left and right edges, and on
    a two-column page (two regions).

    The classical line detector clips a baseline across the region's
    bounding box to the region's outline and drops it where an end
    lies on or outside the outline, as the JAX one does: it finds
    lines only in a region that reaches past both sides of the page,
    not in config 1's pages' regions or the columns."""
    config = _threshold_config(config1_bundle)
    port = PageParser(config, device="cpu", config_path=str(config1_bundle))
    ref = JaxPageParser(config, config_path=str(config1_bundle))
    assert type(port.layout_parsers[0]).__name__ == "SimpleThresholdRegion"
    pages = {os.path.splitext(n)[0]: cv2.imread(str(config1_bundle / "images" / n), 1)
             for n in sorted(os.listdir(config1_bundle / "images"))}
    rng = np.random.default_rng(5)
    for i, page in enumerate(printed_pages(rng, 2, 420, 560, 6, side=12)[0]):
        pages[f"wide-{i}"] = page
    pages["two_columns"] = column_page(rng, 420, 560, 6, columns=2)
    lines = {}
    for fid, page in pages.items():
        random.seed(3)
        got = port.process_page(page, PageLayout(id=fid, page_size=page.shape[:2]))
        random.seed(3)
        want = ref.process_page(page, JaxPageLayout(id=fid, page_size=page.shape[:2]))
        assert_xml_equal(got.to_pagexml_string(), want.to_pagexml_string())
        assert got.regions
        lines[fid] = [ln.transcription for ln in got.lines_iterator()]
    assert len(got.regions) == 2
    assert all(len(lines[f"wide-{i}"]) >= 4 and any(lines[f"wide-{i}"]) for i in range(2))


# ----------------------------------------------------------------------
# --process-count

@pytest.mark.usefixtures("torch_threads_share")  # which its spawned workers split
def test_cli_process_count_equals_one_process_and_jax(config1_bundle, tmp_path, capsys):
    """Four PNG pages (text to within 12 px of the sides, so that lines
    are found) through the port's command line with two spawned workers,
    in one process, and through the JAX command line in one process:
    the same Page XML files (the port's two runs byte for byte but the
    timestamps), the same transcriptions file in page order, and the
    workers' stage times in the report."""
    config = _threshold_config(config1_bundle)
    with open(tmp_path / "threshold.ini", "w") as f:
        config.write(f)
    os.symlink(config1_bundle / "ocr_engine", tmp_path / "ocr_engine")
    images = tmp_path / "images"
    images.mkdir()
    pages, _ = printed_pages(np.random.default_rng(9), 4, 420, 560, 6, side=12)
    for i, page in enumerate(pages):
        assert cv2.imwrite(str(images / f"page-{i}.png"), page)
    common = ["-c", str(tmp_path / "threshold.ini"), "-i", str(images), "--device", "cpu"]
    runs = {"workers": ["--process-count", "2", "--timing-report"], "one": [], "jax": []}
    for name, extra in runs.items():
        run = _jax_cli if name == "jax" else _run_port
        run(common + ["--output-xml-path", str(tmp_path / name),
                      "--output-transcriptions-file-path", str(tmp_path / f"{name}.txt")] + extra)
        if name == "workers":
            printed = capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == [f"page-{i}.xml" for i in range(4)]
    for name in names:
        got = (tmp_path / "workers" / name).read_text(encoding="utf-8")
        assert _masked(got) == _masked((tmp_path / "one" / name).read_text(encoding="utf-8"))
        assert_xml_equal(got, (tmp_path / "jax" / name).read_text(encoding="utf-8"))
        assert got.count("<TextLine ") >= 1
    texts = (tmp_path / "workers.txt").read_text(encoding="utf-8")
    assert texts == (tmp_path / "one.txt").read_text(encoding="utf-8")
    assert texts == (tmp_path / "jax.txt").read_text(encoding="utf-8")
    assert [ln.split("-")[1] for ln in texts.splitlines() if ln] == sorted(
        ln.split("-")[1] for ln in texts.splitlines() if ln)
    assert re.search(r"^simple_regions/denoise\s+[0-9.]+\s+4\s", printed, re.M)
    assert re.search(r"^cli/pages\s+[0-9.]+\s+1\s", printed, re.M)


def test_worker_that_cannot_build_its_parser_fails(tmp_path, monkeypatch):
    """A worker's failed PageParser (here: a missing OCR JSON) is raised
    by its first page, so that the pool's map and the command fail;
    nothing runs on another device or route instead."""
    monkeypatch.setattr(parse_folder, "_worker", {})
    ini = tmp_path / "broken.ini"
    ini.write_text("[PAGE_PARSER]\nRUN_OCR = yes\n\n[OCR]\nOCR_JSON = ./missing.json\n")
    parse_folder._start_worker(str(ini), "cpu", True, None, None, None, None, 2)
    assert "parser" not in parse_folder._worker
    with pytest.raises(RuntimeError, match="could not build its PageParser"):
        parse_folder._worker_page("page.png", "page", 0, 1)
