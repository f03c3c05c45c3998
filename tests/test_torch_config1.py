"""Config 1 of the port (``configs/config1_printed_greedy.ini``: one
whole-page region, the classical line detector, greedy CTC) against the
JAX package's, on the CPU.

- ``adaptive_threshold_mean`` against ``cv2.adaptiveThreshold``
  (``ADAPTIVE_THRESH_MEAN_C``, ``THRESH_BINARY``): bit-equal on seeded
  images, odd blocks 3-91, several ``c``, images smaller than the block
  and config 1's own values;
- ``EngineLineDetectorSimple.detect_lines`` against the JAX one: equal
  baselines, heights and textlines on seeded printed pages
  (``chip_smoke.printed_pages``) and in a region that is not a
  rectangle;
- the port's ``PageParser(device="cpu")`` against the JAX
  ``PageParser`` on four printed pages of 6 rows with one recognizer's
  weights (flax msgpack, read by both): Page XML equal byte for byte
  with the timestamps masked, ``conf`` within 0.001 (the two packages'
  float32 recognizers differ by about 1e-5);
- the port's command line against the JAX command line
  (``scripts/parse_folder.py``) on config 1's ini, with and without
  ``--fast-pipeline`` (which falls back to the stage-by-stage path for
  a config without LAYOUT_CNN): the same files, under the same bound.
"""

import configparser
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import printed_pages
from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.document.page_parser import PageParser as JaxPageParser
from pero_ocr_tpu.layout_engines.simple_baseline_engine import (
    EngineLineDetectorSimple as JaxDetector,
)
from pero_ocr_tpu.models.recognizer import CTCRecognizer as FlaxRecognizer
from pero_ocr_tpu.models.recognizer import RecognizerSpec as FlaxSpec
from pero_ocr_tpu.utils.checkpoint import save_variables
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.document.page_parser import (
    PageParser, TextlineExtractorSimple, WholePageRegion,
)
from pero_ocr_tpu_torch.layout_engines.simple_baseline_engine import EngineLineDetectorSimple
from pero_ocr_tpu_torch.utils.threshold import adaptive_threshold_mean
from tests.test_torch_cli import _jax_cli, _run_port, assert_xml_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG1 = os.path.join(REPO, "configs", "config1_printed_greedy.ini")
CHARS = ["&", "<", ">", '"', "'", "ž", "a", "\u200b"]
PAGE_H, PAGE_W, ROWS = 420, 560, 6


# ----------------------------------------------------------------------
# cv2.adaptiveThreshold

def _cv2_threshold(img, block, c):
    return cv2.adaptiveThreshold(img, 255, cv2.ADAPTIVE_THRESH_MEAN_C, cv2.THRESH_BINARY,
                                 block, c)


def _images(rng):
    """Noise, a gradient with noise, and a printed crop."""
    noise = rng.integers(0, 256, (61, 83), dtype=np.uint8)
    ramp = (np.add.outer(np.arange(70), 2 * np.arange(90)) % 256
            + rng.integers(0, 5, (70, 90))).clip(0, 255).astype(np.uint8)
    printed = printed_pages(rng, 1, 120, 160, 2)[0][0].mean(axis=2).astype(np.uint8)
    return [noise, ramp, printed]


@pytest.mark.parametrize("block", [3, 5, 7, 9, 13, 15, 17, 21, 31, 45, 67, 91])
def test_adaptive_threshold_equals_cv2(block):
    """Bit-equal for each block size, at c values of both signs, whole
    and fractional (cv2 takes ceil(c))."""
    rng = np.random.default_rng(block)
    for img in _images(rng):
        for c in (-7.5, -1, 0, 0.3, 2, 5.5, 21, 91):
            np.testing.assert_array_equal(adaptive_threshold_mean(img, block, c),
                                          _cv2_threshold(img, block, c))


@pytest.mark.parametrize("shape", [(1, 1), (1, 40), (40, 1), (5, 7), (20, 90), (90, 20)])
def test_adaptive_threshold_on_images_smaller_than_the_block(shape):
    """A region narrower or shorter than the block is all border
    (replicated edge pixels), as in cv2."""
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    for block in (21, 91):
        for c in (0, 21, 91):
            np.testing.assert_array_equal(adaptive_threshold_mean(img, block, c),
                                          _cv2_threshold(img, block, c))


def test_adaptive_threshold_with_config1_values_on_a_printed_page():
    """Config 1's BLOCK_SIZE 21 and ADAPTIVE_THRESHOLD 91 on a whole
    printed page: bit-equal, with ink found."""
    page = printed_pages(np.random.default_rng(5), 1, 700, 500, 10)[0][0]
    gray = page.mean(axis=2).astype(np.uint8)
    got = adaptive_threshold_mean(gray, 21, 91)
    np.testing.assert_array_equal(got, _cv2_threshold(gray, 21, 91))
    assert 0 < (got == 0).sum() < got.size // 4


def test_adaptive_threshold_rejects_what_cv2_rejects():
    img = np.zeros((8, 8), np.uint8)
    for block in (2, 1, 0):
        with pytest.raises(ValueError):
            adaptive_threshold_mean(img, block, 5)
    with pytest.raises(ValueError):
        adaptive_threshold_mean(img.astype(np.float32), 3, 5)


# ----------------------------------------------------------------------
# The detector

def _assert_detections_equal(got, want):
    (gb, gh, gt), (wb, wh, wt) = got, want
    assert len(gb) == len(wb) == len(gh) == len(gt)
    for a, b in zip(gb, wb):
        assert a.dtype == b.dtype == np.int16
        np.testing.assert_array_equal(a, b)
    assert [list(map(int, h)) for h in gh] == [list(map(int, h)) for h in wh]
    for a, b in zip(gt, wt):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,h,w,rows", [(0, 420, 560, 6), (1, 600, 480, 12),
                                           (2, 900, 700, 20)])
def test_detect_lines_equals_jax(seed, h, w, rows):
    """The whole page as the region: equal detections, one line a row."""
    page = printed_pages(np.random.default_rng(seed), 1, h, w, rows)[0][0]
    region = np.array([[0, 0], [w, 0], [w, h], [0, h]])
    got = EngineLineDetectorSimple().detect_lines(page, region)
    _assert_detections_equal(got, JaxDetector().detect_lines(page, region))
    assert len(got[0]) == rows


def test_detect_lines_equals_jax_in_a_polygon_region():
    """A slanted, non-rectangular region in part off the page, and a
    region of zero width."""
    page = printed_pages(np.random.default_rng(3), 1, 600, 500, 10)[0][0]
    region = np.array([[40, -20], [470, 30], [520, 560], [10, 610], [60, 300]], float)
    got = EngineLineDetectorSimple(adaptive_threshold=60, block_size=15).detect_lines(page, region)
    want = JaxDetector(adaptive_threshold=60, block_size=15).detect_lines(page, region)
    _assert_detections_equal(got, want)
    assert len(got[0]) >= 3
    flat = np.array([[100, 10], [100, 300], [100, 20]])
    assert EngineLineDetectorSimple().detect_lines(page, flat) == ([], [], [])


def test_layout_stages_equal_jax():
    """WholePageRegion and TextlineExtractorSimple: region id r1, line
    ids r1-l001..., the same geometry as the JAX stages."""
    config = configparser.ConfigParser()
    config.read(CONFIG1)
    page = printed_pages(np.random.default_rng(4), 1, PAGE_H, PAGE_W, ROWS)[0][0]
    from pero_ocr_tpu.document import page_parser as jax_pp

    got = PageLayout(id="p", page_size=page.shape[:2])
    want = JaxPageLayout(id="p", page_size=page.shape[:2])
    for port_stage, jax_stage, section in (
            (WholePageRegion, jax_pp.WholePageRegion, "LAYOUT_PARSER_1"),
            (TextlineExtractorSimple, jax_pp.TextlineExtractorSimple, "LAYOUT_PARSER_2")):
        got = port_stage(config[section]).process_page(page, got)
        want = jax_stage(config[section]).process_page(page, want)
    assert [r.id for r in got.regions] == [r.id for r in want.regions] == ["r1"]
    np.testing.assert_array_equal(got.regions[0].polygon, want.regions[0].polygon)
    lines = list(got.lines_iterator())
    assert [ln.id for ln in lines] == [ln.id for ln in want.lines_iterator()]
    assert [ln.id for ln in lines] == [f"r1-l{i:03d}" for i in range(1, ROWS + 1)]
    for a, b in zip(lines, want.lines_iterator()):
        np.testing.assert_array_equal(a.baseline, b.baseline)
        np.testing.assert_array_equal(a.polygon, b.polygon)
        assert list(a.heights) == list(b.heights)


# ----------------------------------------------------------------------
# Config 1 end to end

@pytest.fixture(scope="module")
def config1_bundle(tmp_path_factory):
    """Config 1's ini beside an OCR JSON and a float32 recognizer
    checkpoint (random weights plus 0.1 x normal noise, as in
    tests/test_torch_cli.py), and four printed pages as PNG files."""
    root = tmp_path_factory.mktemp("config1")
    with open(CONFIG1, encoding="utf-8") as f:
        (root / "config.ini").write_text(f.read())
    (root / "ocr_engine").mkdir()
    spec = dict(num_classes=len(CHARS), line_height=40, conv_features=(4, 8), subsampling=4,
                lstm_layers=1, lstm_features=8, dtype=jnp.float32)
    variables = FlaxRecognizer(FlaxSpec(**spec)).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 40, 64, 3)))
    rng = np.random.default_rng(3)
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32),
        variables)
    save_variables(variables, str(root / "ocr_engine" / "recognizer.msgpack"))
    with open(root / "ocr_engine" / "ocr.json", "w", encoding="utf-8") as f:
        json.dump({"characters": CHARS[:-1], "line_px_height": 40,
                   "checkpoint": "recognizer.msgpack",
                   "net_spec": {"conv_features": [4, 8], "subsampling": 4, "lstm_layers": 1,
                                "lstm_features": 8, "dtype": "float32"}}, f)
    images = root / "images"
    images.mkdir()
    pages, _ = printed_pages(np.random.default_rng(7), 4, PAGE_H, PAGE_W, ROWS)
    for i, page in enumerate(pages):
        assert cv2.imwrite(str(images / f"page-{i}.png"), page)
    return root


def _config(path):
    config = configparser.ConfigParser()
    config.read(path)
    return config


def test_page_parser_config1_equals_jax(config1_bundle):
    """Every page through both PageParsers: the same Page XML, each
    page of 4 lines or more (one field warp a page on the card)."""
    config = _config(config1_bundle / "config.ini")
    port = PageParser(config, device="cpu", config_path=str(config1_bundle))
    ref = JaxPageParser(config, config_path=str(config1_bundle))
    assert [type(lp).__name__ for lp in port.layout_parsers] == [
        "WholePageRegion", "TextlineExtractorSimple"]
    texts = 0
    for name in sorted(os.listdir(config1_bundle / "images")):
        page = cv2.imread(str(config1_bundle / "images" / name), 1)
        fid = os.path.splitext(name)[0]
        got = port.process_page(page, PageLayout(id=fid, page_size=page.shape[:2]))
        want = ref.process_page(page, JaxPageLayout(id=fid, page_size=page.shape[:2]))
        assert len(list(got.lines_iterator())) == ROWS >= port.line_cropper.DEVICE_BATCH_MIN
        assert_xml_equal(got.to_pagexml_string(), want.to_pagexml_string())
        texts += sum(bool(ln.transcription) for ln in got.lines_iterator())
    assert texts > 0


@pytest.mark.parametrize("fast", [False, True], ids=["staged", "fast_pipeline_fallback"])
def test_cli_config1_equals_jax_cli(config1_bundle, tmp_path, capsys, fast):
    """Both command lines on config 1's ini: equal Page XML files; with
    --fast-pipeline both fall back to the stage-by-stage path."""
    flags = ["--fast-pipeline"] if fast else []
    common = ["-c", str(config1_bundle / "config.ini"), "-i", str(config1_bundle / "images")]
    _run_port(common + ["--output-xml-path", str(tmp_path / "port"), "--device", "cpu"]
              + flags)
    printed = capsys.readouterr().out
    _jax_cli(common + ["--output-xml-path", str(tmp_path / "jax"), "--device", "cpu"] + flags)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [f"page-{i}.xml" for i in range(4)]
    for name in names:
        assert_xml_equal((tmp_path / "port" / name).read_text(encoding="utf-8"),
                         (tmp_path / "jax" / name).read_text(encoding="utf-8"))
    assert printed.count("DONE ") == 4 and "(fast pipeline)" not in printed
