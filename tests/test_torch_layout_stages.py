"""Each layout stage and LAYOUT_CNN option of ROADMAP item 8d alone
through the port's ``PageParser`` against the JAX ``PageParser``, on
the CPU: ``MULTI_ORIENTATION``, ``MERGE_LINES``, ``ADJUST_BASELINES``,
``DETECT_STRAIGHT_LINES_IN_REGIONS``, ``LINE_FILTER`` (directions with
a seeded flax OrientationNet, incomplete pages, short lines),
``LINE_POSTPROCESSING`` (stretch to the region, resample; a fixed
stretch with heights from the regions), ``LAYOUT_POSTPROCESSING``
(``RETRACE_REGIONS``) and ``REGION_SORTER_NAIVE``.

The bundle: a ParseNet (s2d stem, base 8, depth 2, out_upsample 2) whose
weights are ``chip_smoke.edge_detector_``'s hand-set bottom-of-ink
detector, written as a flax msgpack; a small float32 CTC recognizer;
two-column synthetic pages (``chip_smoke.synthetic_pages``) with a gap
cut through some lines, so that a row holds two lines.  Both packages
build ParseNet and OrientationNet in float32 (bf16 convolutions round
differently in XLA and torch), and ``random`` is seeded alike.  Page
XML must be equal apart from the timestamps, ``conf`` within 0.001.

The port's ParseNet and OrientationNet wrappers hand on the JAX
wrappers' maps: the two float32 forwards agree within ~1e-5
(tests/test_torch_staged.py, tests/test_torch_layout_options.py), but
the layout turns float maps into integer outlines (thresholds, alpha
shapes, raster clipping, the straight-line detector's largest row sum),
where 1e-5 can move a vertex (ROADMAP.md section 3); the same maps
isolate the code that follows them, as the card check runs the CPU
from the card's maps.
"""

import configparser
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import chip_smoke
from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.document.page_parser import PageParser as JaxPageParser
from pero_ocr_tpu.layout_engines import parsenet_wrapper as jax_parsenet_wrapper
from pero_ocr_tpu.models.parsenet import OrientationNet as FlaxOrientationNet
from pero_ocr_tpu.models.parsenet import ParseNet as FlaxParseNet
from pero_ocr_tpu.utils.checkpoint import save_variables
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.document.page_parser import (
    LayoutPostprocessor, LineFilter, LinePostprocessor, PageParser,
)
from pero_ocr_tpu_torch.layout_engines import parsenet_wrapper
from pero_ocr_tpu_torch.layout_engines.naive_sorter import NaiveRegionSorter
from pero_ocr_tpu_torch.models.parsenet import OrientationNet, ParseNet
from pero_ocr_tpu_torch.utils import checkpoint, convert
from tests.test_torch_cli import assert_xml_equal

PAGE_ROWS = 768  # of the 2560-row synthetic pages: 12 lines a column
LAYOUT_KEYS = """[LAYOUT_PARSER_1]
METHOD = LAYOUT_CNN
MODEL_PATH = ./parsenet.msgpack
DOWNSAMPLE = 4
DETECTION_THRESHOLD = 0.2
ADAPTIVE_DOWNSAMPLE = yes
FAST_STEM = yes
OUT_UPSAMPLE = 2
BASE_FEATURES = 8
DEPTH = 2
{options}
{stages}
[LINE_CROPPER]
INTERP = 2
LINE_SCALE = 1.0
LINE_HEIGHT = 32

[OCR]
OCR_JSON = ./ocr.json
"""
STAGES = {
    "LINE_FILTER": "METHOD = LINE_FILTER\nFILTER_DIRECTIONS = yes\n"
                   "MODEL_PATH = ./orientation.msgpack\nFILTER_INCOMPLETE_PAGES = yes\n"
                   "FILTER_PAGES_WITH_SHORT_LINES = yes\nLENGTH_THRESHOLD = 100",
    "LINE_POSTPROCESSING": "METHOD = LINE_POSTPROCESSING\nSTRETCH_LINES = max\n"
                           "RESAMPLE_LINES = yes",
    "LINE_POSTPROCESSING_HEIGHTS": "METHOD = LINE_POSTPROCESSING\nSTRETCH_LINES = 20\n"
                                   "HEIGHTS_FROM_REGIONS = yes",
    "LAYOUT_POSTPROCESSING": "METHOD = LAYOUT_POSTPROCESSING\nRETRACE_REGIONS = yes",
    "REGION_SORTER_NAIVE": "METHOD = REGION_SORTER_NAIVE",
}
# ini (a): the LAYOUT_CNN options and every stage after it; ini (b): the
# straight lines in the CNN's regions.
INI_A = (("MULTI_ORIENTATION", "MERGE_LINES", "ADJUST_BASELINES"),
         ("LINE_FILTER", "LINE_POSTPROCESSING", "LAYOUT_POSTPROCESSING", "REGION_SORTER_NAIVE"))
INI_B = (("DETECT_STRAIGHT_LINES_IN_REGIONS",), ())


def layout_ini(options=(), stages=()) -> str:
    """The bundle's config with ``options`` set on LAYOUT_CNN and the
    named ``stages`` after it."""
    return "[PAGE_PARSER]\nRUN_LAYOUT_PARSER = yes\nRUN_LINE_CROPPER = yes\nRUN_OCR = yes\n\n" \
        + LAYOUT_KEYS.format(
            options="\n".join(f"{o} = yes" for o in options),
            stages="".join(f"\n[LAYOUT_PARSER_{i + 2}]\n{STAGES[s]}\n"
                           for i, s in enumerate(stages)))


def layout_pages(n: int, seed: int = 0):
    """``n`` two-column BGR pages, a gap cut through a few lines."""
    pages, _ = chip_smoke.synthetic_pages(np.random.default_rng(seed), n,
                                          chip_smoke.TWO_COLUMNS)
    pages = [np.ascontiguousarray(p[:PAGE_ROWS]) for p in pages]
    for p in pages:
        p[200:330, 300:370] = 238
    return pages


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS and one torch thread a process: the suite runs in
    parallel workers, and the many small host solves of these tests
    (``np.polyfit``) ran ~8x slower with every worker's thread pools
    spinning on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def layout_bundle(tmp_path_factory):
    root = tmp_path_factory.mktemp("layout")
    pn = ParseNet(base_features=8, depth=2, stem="s2d", out_upsample=2, dtype=torch.float32)
    chip_smoke.edge_detector_(pn)
    checkpoint.save_variables(convert.parsenet_params_to_flax(pn), str(root / "parsenet.msgpack"))
    save_variables(FlaxOrientationNet(dtype=jnp.float32).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3))), str(root / "orientation.msgpack"))
    rec = chip_smoke.CTCRecognizer(chip_smoke.RecognizerSpec(
        num_classes=80, line_height=32, conv_features=(8, 16), subsampling=4, lstm_layers=1,
        lstm_features=16, dtype=torch.float32, stem="s2d", norm="group",
    ), generator=torch.Generator().manual_seed(1))
    chip_smoke.write_recognizer(str(root), rec, dtype="float32")
    return root


@pytest.fixture
def float32_nets(monkeypatch):
    """Both packages' wrappers build ParseNet and OrientationNet in
    float32."""
    for cls, flax_cls in ((ParseNet, FlaxParseNet), (OrientationNet, FlaxOrientationNet)):
        monkeypatch.setattr(parsenet_wrapper, cls.__name__,
                            functools.partial(cls, dtype=torch.float32))
        monkeypatch.setattr(jax_parsenet_wrapper, cls.__name__,
                            functools.partial(flax_cls, dtype=jnp.float32))


def parsers(root, ini: str, name: str):
    """The port's PageParser on the CPU and the JAX one on ``ini``, the
    port's handed the JAX maps."""
    path = root / f"{name}.ini"
    path.write_text(ini)
    config = configparser.ConfigParser()
    config.read(path)
    ours = PageParser(config, device="cpu", config_path=str(root))
    theirs = JaxPageParser(config, config_path=str(root))
    share_maps(ours, theirs)
    return ours, theirs


def share_maps(ours, theirs) -> None:
    """The port's ParseNet (and OrientationNet) wrappers return the JAX
    wrappers' maps."""
    ours.layout_parsers[0].engine.parsenet.get_maps = \
        theirs.layout_parsers[0].engine.parsenet.get_maps
    for lp, jlp in zip(ours.layout_parsers[1:], theirs.layout_parsers[1:]):
        if getattr(lp, "filter_directions", False):
            lp.engine.tiltnet.get_maps = jlp.engine.tiltnet.get_maps


def run_both(ours, theirs, pages, seed: int = 0):
    got, want = [], []
    for parser, cls, out in ((ours, PageLayout, got), (theirs, JaxPageLayout, want)):
        random.seed(seed)
        for i, page in enumerate(pages):
            out.append(parser.process_page(page, cls(id=f"p{i}", page_size=page.shape[:2])))
    for g, w in zip(got, want):
        assert_xml_equal(g.to_pagexml_string(), w.to_pagexml_string())
    return got, want


def _region_ids(layouts):
    return [[r.id for r in lay.regions] for lay in layouts]


@pytest.mark.parametrize("option", ["MULTI_ORIENTATION", "MERGE_LINES", "ADJUST_BASELINES",
                                    "DETECT_STRAIGHT_LINES_IN_REGIONS"])
def test_layout_cnn_option_matches_jax(layout_bundle, float32_nets, option):
    ours, theirs = parsers(layout_bundle, layout_ini((option,)), option)
    base = parsers(layout_bundle, layout_ini(), "base")[0]
    pages = layout_pages(1)
    got, _ = run_both(ours, theirs, pages)
    random.seed(0)
    plain = base.process_page(pages[0], PageLayout(id="p0", page_size=pages[0].shape[:2]))
    lines = list(got[0].lines_iterator())
    assert len(lines) >= 12
    # The option changes the layout.
    assert got[0].to_pagexml_string().split("</Metadata>")[1] != \
        plain.to_pagexml_string().split("</Metadata>")[1]
    if option == "MULTI_ORIENTATION":
        assert any(r.id.endswith(("_1", "_3")) for r in got[0].regions)
    if option == "MERGE_LINES":
        assert len(lines) < len(list(plain.lines_iterator()))


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_layout_stage_matches_jax(layout_bundle, float32_nets, stage):
    ours, theirs = parsers(layout_bundle, layout_ini(stages=(stage,)), stage)
    kind = {"LINE_FILTER": LineFilter, "LINE_POSTPROCESSING": LinePostprocessor,
            "LINE_POSTPROCESSING_HEIGHTS": LinePostprocessor,
            "LAYOUT_POSTPROCESSING": LayoutPostprocessor,
            "REGION_SORTER_NAIVE": NaiveRegionSorter}[stage]
    assert isinstance(ours.layout_parsers[1], kind)
    got, _ = run_both(ours, theirs, layout_pages(1, seed=1))
    assert len(got[0].regions) >= 2 or stage == "LINE_FILTER"
