"""Config 4 (``configs/config4_handwritten.ini``: ``ADJUST_HEIGHTS``,
``REGION_SORTER_SMART``, a reference-style transformer recognizer) in the
port against the JAX package, on the CPU.

- ``resample_baselines``: equal to JAX's.
- The smart sorter: the numpy rotation within 1e-9 of cv2's
  ``getRotationMatrix2D`` + ``transform`` (cv2's sign convention); the
  region order and the turned-back coordinates equal JAX's on seeded
  multi-region layouts, tilted and level.
- ``ADJUST_HEIGHTS``: ``get_heights`` on the same maps equal; the
  layout stage end to end within 1e-3 px (the two ParseNets' float32
  maps differ by ~1e-5).
- The transformer engine's long-line chunking: ``_chunk_line``,
  ``merge_transcriptions_and_logits`` (an overlap of 0 included) and
  ``find_best_overlap`` (C++ and numpy routes) equal JAX's, and
  ``process_lines`` on over-wide lines with a small ``max_line_width``.
- The transformer line confidence against JAX's.
- ``PageParser`` on config 4's stages (the command line's toy detector
  and pages, ParseNet patched to float32 on both sides, a reference
  transformer ``.pt`` made here, ``random`` seeded alike): Page XML
  equal to the JAX ``PageParser``'s apart from timestamps; the port's
  command line writes the JAX command line's files.
"""

import configparser
import json
import math
import os
import random
import re

import cv2
import numpy as np
import pytest
import torch

from pero_ocr_tpu.core import confidence_estimation as jax_confidence
from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.core.layout import RegionLayout as JaxRegionLayout
from pero_ocr_tpu.core.layout import TextLine as JaxTextLine
from pero_ocr_tpu.document.page_parser import PageParser as JaxPageParser
from pero_ocr_tpu.layout_engines import helpers as jax_helpers
from pero_ocr_tpu.layout_engines.smart_sorter import SmartRegionSorter as JaxSorter
from pero_ocr_tpu.ocr import line_ocr_engine as jax_line_ocr
from pero_ocr_tpu.ocr.transformer_engine import TransformerEngineLineOCR as JaxEngine
from pero_ocr_tpu_torch.core import confidence_estimation
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from pero_ocr_tpu_torch.document.page_parser import PageParser
from pero_ocr_tpu_torch.layout_engines import helpers
from pero_ocr_tpu_torch.layout_engines.smart_sorter import SmartRegionSorter
from pero_ocr_tpu_torch.layout_engines.smart_sorter import rotation_matrix, transform
from pero_ocr_tpu_torch.models.transformer_ref import RefTransformerOCR, RefTransformerSpec
from pero_ocr_tpu_torch.ocr import line_ocr_engine
from pero_ocr_tpu_torch.ocr.transformer_engine import TransformerEngineLineOCR
from tests.test_torch_cli import (  # noqa: F401  (bundle, float32_parsenets: fixtures)
    _config, _jax_cli, _run_port, assert_xml_equal, bundle, float32_parsenets, staged_config,
)
from tests.test_torch_native import jax_native_library
from tests.test_torch_pipeline import CHARS

HEIGHT = 16  # the bundle's line height
# The test transformer's position table: decodes stop at 39 steps, the
# engine's cap (its lines of 256 px would take 96).
MAX_SEQ_LEN = 40


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The decode loops are thousands of tiny ops: one intra-op thread
    each (the test workers share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_native():
    """The JAX clustering runs its native library; its Python fallback
    rounds the penalty windows otherwise (ROADMAP.md, section 3)."""
    if jax_native_library() is None:
        pytest.skip("the JAX package's native library is unavailable")


# ----------------------------------------------------------------------
# Layout: resample_baselines, the smart sorter, ADJUST_HEIGHTS
@pytest.mark.parametrize("case", ["two_points", "curved", "vertical", "tilted"])
def test_resample_baselines_matches_jax(case):
    rng = np.random.default_rng(len(case))
    x = np.sort(rng.uniform(0, 900, 2 if case == "two_points" else 9))
    y = 300 + {"curved": 12 * np.sin(x / 80), "tilted": 0.03 * x}.get(case, 0 * x)
    baseline = np.stack([x, y], 1)
    if case == "vertical":
        baseline = baseline[:, ::-1]
    for n in (10, 40):
        got = helpers.resample_baselines([baseline], num_points=n)[0]
        want = jax_helpers.resample_baselines([baseline], num_points=n)[0]
        assert np.array_equal(got, want)


@pytest.mark.parametrize("angle", [1.5, -2.0, 0.25, 37.0])
@pytest.mark.parametrize("origin", [(0, 0), (12.3, 45.7)])
def test_rotation_matches_cv2(angle, origin):
    matrix = cv2.getRotationMatrix2D(origin, angle, 1)
    assert np.abs(rotation_matrix(origin, angle) - matrix).max() <= 1e-9
    points = np.random.default_rng(0).uniform(0, 3000, (40, 2))
    want = cv2.transform(points.reshape(1, -1, 2), matrix)[0]
    assert np.abs(transform(points, rotation_matrix(origin, angle)) - want).max() <= 1e-9
    # cv2's convention: a positive angle turns (1, 0) towards -y.
    assert transform([[1.0, 0.0]], rotation_matrix((0, 0), 90.0))[0, 1] < -0.99


def _tilted_layouts(seed: int, tilt_deg: float):
    """The same seeded page twice (port, JAX): columns of boxes, each
    with 2-5 lines tilted by ``tilt_deg``, in shuffled order."""
    rng = np.random.default_rng(seed)
    slope = math.tan(math.radians(tilt_deg))
    regions = []
    n_cols = int(rng.integers(1, 4))
    for c in range(n_cols):
        y = 50.0
        for r in range(int(rng.integers(2, 4))):
            x0 = 60 + c * 700 + rng.uniform(0, 30)
            w, h = rng.uniform(400, 600), rng.uniform(150, 400)
            box = np.array([[x0, y], [x0 + w, y], [x0 + w, y + h], [x0, y + h]])
            lines = []
            for k in range(int(rng.integers(2, 6))):
                ly = y + 30 + k * 30
                xs = np.linspace(x0 + 10, x0 + w - rng.uniform(10, 150), 5)
                baseline = np.stack([xs, ly + slope * (xs - x0)], 1)
                lines.append(baseline)
            regions.append((box + [[0, 0], [0, slope * w], [0, slope * w], [0, 0]], lines))
            y += h + rng.uniform(20, 120)
    order = rng.permutation(len(regions))
    out = []
    for layout_cls, region_cls, line_cls in ((PageLayout, RegionLayout, TextLine),
                                             (JaxPageLayout, JaxRegionLayout, JaxTextLine)):
        layout = layout_cls(id="p", page_size=(3000, 2200))
        for i in order:
            box, lines = regions[i]
            region = region_cls(f"r{i:03d}", box.copy())
            for k, baseline in enumerate(lines):
                region.lines.append(line_cls(
                    id=f"r{i:03d}-l{k:03d}", baseline=baseline.copy(), heights=[20.0, 6.0],
                    polygon=helpers.baseline_to_textline(baseline, [20.0, 6.0])))
            layout.regions.append(region)
        out.append(layout)
    return out


@pytest.mark.parametrize("tilt", [0.0, 1.5, -2.0])
@pytest.mark.parametrize("seed", range(4))
def test_smart_sorter_matches_jax(seed, tilt):
    got, want = _tilted_layouts(seed, tilt)
    assert SmartRegionSorter(None).get_rotation(got.regions[0].lines) == \
        JaxSorter.get_rotation(want.regions[0].lines)
    got = SmartRegionSorter(None).process_page(None, got)
    want = JaxSorter(None).process_page(None, want)
    assert [r.id for r in got.regions] == [r.id for r in want.regions]
    for a, b in zip(got.regions, want.regions):
        assert np.abs(np.asarray(a.polygon) - np.asarray(b.polygon)).max() <= 1e-9
        for la, lb in zip(a.lines, b.lines):
            assert np.abs(la.baseline - lb.baseline).max() <= 1e-9
            assert np.abs(la.polygon - lb.polygon).max() <= 1e-9


def test_smart_sorter_reads_its_parameter():
    config = configparser.ConfigParser()
    config["S"] = {"FakeIntersectionParameter": "0.3"}
    assert SmartRegionSorter(config["S"]).intersect_param == \
        JaxSorter(config["S"]).intersect_param == 0.3


def _engines(config_path):
    config = _config(config_path)
    root = str(config_path.parent)
    return (PageParser(config, device="cpu", config_path=root),
            JaxPageParser(config, config_path=root))


def _pages(bundle):
    return [cv2.imread(str(bundle / "images" / f"page-{i}.png"), 1) for i in range(3)]


def test_adjust_heights_matches_jax(bundle, tmp_path, float32_parsenets, jax_native):
    ours, theirs = _engines(staged_config(bundle, tmp_path, ADJUST_HEIGHTS="yes"))
    extractor, jextractor = ours.layout_parsers[0], theirs.layout_parsers[0]
    assert extractor.adjust_heights
    adjusted = 0
    for i, page in enumerate(_pages(bundle)):
        random.seed(i)
        got = extractor.process_page(page, PageLayout(id="p", page_size=page.shape[:2]))
        random.seed(i)
        want = jextractor.process_page(page, JaxPageLayout(id="p", page_size=page.shape[:2]))
        jmaps, ds = jextractor.engine.parsenet.get_maps_with_optimal_resolution(page)
        lines, jlines = list(got.lines_iterator()), list(want.lines_iterator())
        assert [ln.id for ln in lines] == [ln.id for ln in jlines] and lines
        for a, b in zip(lines, jlines):
            assert np.abs(np.asarray(a.heights) - np.asarray(b.heights)).max() <= 1e-3
            assert np.abs(a.polygon - b.polygon).max() <= 1e-3
            # On the same maps, the same heights.
            points = helpers.resample_baselines([b.baseline], num_points=40)[0]
            assert np.array_equal(extractor.engine.get_heights(jmaps, ds, points),
                                  jextractor.engine.get_heights(jmaps, ds, points))
            adjusted += not np.allclose(a.heights, [12.0, 4.0])
    assert adjusted


# ----------------------------------------------------------------------
# The transformer engine: a reference model's .pt and OCR JSON
def write_transformer(folder, max_line_width=None, seed=0):
    """A seeded reference-style transformer (dim 32, 2 + 2 layers) over
    the bundle's charset as ``ref.pt`` and its OCR JSON in ``folder``;
    returns the JSON's path."""
    spec = RefTransformerSpec(num_symbols=len(CHARS) + 1, in_height=HEIGHT, dim_model=32,
                              dim_ff=64, heads=4, encoder_layers=2, decoder_layers=2,
                              max_seq_len=MAX_SEQ_LEN)
    model = RefTransformerOCR(spec, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # lines of some length, few ignore ids
        model.dec_out_proj.bias[spec.boundary_id] += 0.5
        model.dec_out_proj.bias[spec.ignore_id] -= 3.0
    os.makedirs(folder, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(folder, "ref.pt"))
    cfg = {"characters": CHARS[:-1], "line_px_height": HEIGHT, "checkpoint": "ref.pt",
           "net_name": json.dumps({"dim_model": 32, "dim_ff": 64, "heads": 4,
                                   "encoder_layers": 2, "decoder_layers": 2,
                                   "conv_subsampling": [8, 4], "max_seq_len": MAX_SEQ_LEN})}
    if max_line_width is not None:
        cfg["max_line_width"] = max_line_width
    path = os.path.join(folder, "transformer.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(cfg, f)
    return path


def test_chunk_line_matches_jax(tmp_path):
    path = write_transformer(str(tmp_path), max_line_width=100)
    ours, theirs = TransformerEngineLineOCR(path, device="cpu"), JaxEngine(path)
    for width in (60, 100, 101, 250, 333):
        image = np.zeros((HEIGHT, width, 3), np.uint8)
        image[:] = np.arange(width)[None, :, None] % 251
        got, want = ours._chunk_line(image), theirs._chunk_line(image)
        assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


MERGE_CASES = [
    (["abcdef", "defghi"], None),         # overlap 3
    (["abc", "xyz"], None),               # overlap 0: the left text is kept
    (["hello wor", "o world", "ld!!"], None),
    (["", "abc"], None),
    (["aaaa", "aaaa", "aaab"], None),
]


@pytest.mark.parametrize("parts,_", MERGE_CASES)
@pytest.mark.parametrize("native", [False, True])
def test_merge_and_overlap_match_jax(parts, _, native):
    rng = np.random.default_rng(len("".join(parts)))
    logits = [rng.standard_normal((len(p) + 2, 5)).astype(np.float32) for p in parts]
    got = line_ocr_engine.merge_transcriptions_and_logits(parts, logits, native)
    want = jax_line_ocr.merge_transcriptions_and_logits(parts, logits)
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    for a in parts:
        for b in parts:
            assert line_ocr_engine.find_best_overlap(a, b, native) == \
                jax_line_ocr.find_best_overlap(a, b)
    if parts == ["abc", "xyz"]:
        assert got[0] == "abcxyz"


def test_find_best_overlap_matches_jax_on_seeded_strings():
    rng = np.random.default_rng(4)
    for _ in range(60):
        a = "".join(rng.choice(list("abž€ "), rng.integers(0, 14)))
        b = "".join(rng.choice(list("abž€ "), rng.integers(0, 14)))
        want = jax_line_ocr.find_best_overlap(a, b)
        assert line_ocr_engine.find_best_overlap(a, b, False) == want
        assert line_ocr_engine.find_best_overlap(a, b, True) == want


def test_process_lines_chunked_matches_jax(tmp_path):
    path = write_transformer(str(tmp_path), max_line_width=96)
    ours, theirs = TransformerEngineLineOCR(path, device="cpu"), JaxEngine(path)
    assert ours.ref_mode and ours.characters == tuple(theirs.characters)
    rng = np.random.default_rng(9)
    lines = []
    for width in (40, 96, 150, 260, 90):
        line = rng.integers(200, 250, (HEIGHT, width, 3), dtype=np.uint8)
        for x in range(4, width - 8, 13):
            line[3:12, x: x + int(rng.integers(3, 9))] = rng.integers(10, 80)
        lines.append(line)
    got, want = ours.process_lines(lines), theirs.process_lines(lines)
    assert got[0] == want[0] and got[2] == want[2]
    assert [c for c in got[2]] == [[0, len(t)] for t in got[0]]
    for a, b in zip(got[1], want[1]):
        assert a.shape == b.shape
        assert np.array_equal((a != 0).toarray(), (b != 0).toarray())
        assert np.abs(a.toarray() - b.toarray()).max(initial=0.0) < 1e-4


def test_transformer_line_confidence_matches_jax(tmp_path):
    path = write_transformer(str(tmp_path))
    ours = TransformerEngineLineOCR(path, device="cpu")
    line = np.random.default_rng(2).integers(0, 255, (HEIGHT, 180, 3), dtype=np.uint8)
    texts, logits, coords = ours.process_lines([line])
    n = logits[0].shape[0]
    labels = np.random.default_rng(3).integers(0, len(ours.characters), n)
    got_line = TextLine(id="l", baseline=np.zeros((2, 2)), heights=[1, 1], logits=logits[0],
                        characters=list(ours.characters), logit_coords=coords[0])
    want_line = JaxTextLine(id="l", baseline=np.zeros((2, 2)), heights=[1, 1],
                            logits=logits[0], characters=list(ours.characters),
                            logit_coords=coords[0])
    got = confidence_estimation.get_line_confidence(got_line, labels)
    want = jax_confidence.get_line_confidence(want_line, labels)
    assert n > 0 and np.array_equal(got, want)


# ----------------------------------------------------------------------
# Config 4 as a whole: PageParser and the command line
def config4_ini(bundle, tmp_path):
    """Config 4's stages on the bundle: its staged config with
    ADJUST_HEIGHTS, a REGION_SORTER_SMART stage, [LINE_CROPPER] as
    configs/config4_handwritten.ini has it (at the bundle's line height)
    and the transformer engine over a reference ``.pt``."""
    ini = staged_config(bundle, tmp_path, ADJUST_HEIGHTS="yes")
    config = _config(ini)
    repo = _config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "configs", "config4_handwritten.ini"))
    config["LAYOUT_PARSER_2"] = dict(repo["LAYOUT_PARSER_2"])
    config["LINE_CROPPER"] = {**repo["LINE_CROPPER"], "line_height": str(HEIGHT)}
    write_transformer(str(tmp_path / "transformer"))
    config["OCR"] = {"OCR_JSON": "./transformer/transformer.json",
                     "METHOD": repo["OCR"]["METHOD"]}
    with open(ini, "w") as f:
        config.write(f)
    return ini


def test_config4_page_parser_matches_jax(bundle, tmp_path, float32_parsenets, jax_native):
    ours, theirs = _engines(config4_ini(bundle, tmp_path))
    assert isinstance(ours.ocr.ocr_engine, TransformerEngineLineOCR)
    assert isinstance(ours.layout_parsers[1], SmartRegionSorter)
    assert not ours.provides_ctc_logits
    pages = _pages(bundle)
    random.seed(0)
    got = [ours.process_page(p, PageLayout(id=f"p{i}", page_size=p.shape[:2]))
           for i, p in enumerate(pages)]
    random.seed(0)
    want = [theirs.process_page(p, JaxPageLayout(id=f"p{i}", page_size=p.shape[:2]))
            for i, p in enumerate(pages)]
    n_lines = 0
    for g, w in zip(got, want):
        assert_xml_equal(g.to_pagexml_string(), w.to_pagexml_string())
        for a, b in zip(g.lines_iterator(), w.lines_iterator()):
            assert a.transcription == b.transcription and a.logit_coords == b.logit_coords
            assert abs(a.transcription_confidence - b.transcription_confidence) <= 1e-3
            n_lines += 1
    assert n_lines >= 9


def test_config4_cli_equals_jax_cli(bundle, tmp_path, float32_parsenets, jax_native, capsys):
    """Config 4 through the port's command line (with --fast-pipeline,
    which falls back to the stage-by-stage path for ADJUST_HEIGHTS and
    the sorter) and the JAX one: equal Page XML files."""
    ini = config4_ini(bundle, tmp_path)
    common = ["-c", str(ini), "-i", str(bundle / "images")]
    random.seed(0)
    _run_port(common + ["--output-xml-path", str(tmp_path / "xml"), "--device", "cpu",
                        "--fast-pipeline", "--timing-report"])
    printed = capsys.readouterr().out
    random.seed(0)
    _jax_cli(common + ["--output-xml-path", str(tmp_path / "jax_xml"), "--fast-pipeline"])
    names = sorted(os.listdir(tmp_path / "jax_xml"))
    assert sorted(os.listdir(tmp_path / "xml")) == names == [f"page-{i}.xml" for i in range(3)]
    for name in names:
        assert_xml_equal((tmp_path / "xml" / name).read_text(encoding="utf-8"),
                         (tmp_path / "jax_xml" / name).read_text(encoding="utf-8"))
    for stage in ("ocr/encode", "ocr/decode", "adjust_heights"):
        assert re.search(rf"^{stage}\s+[0-9.]+\s+\d+\s", printed, re.M), stage
