"""The config-2 command line of the port
(``python -m pero_ocr_tpu_torch.scripts.parse_folder``) against the JAX
package's on the same ini, OCR JSON, flax msgpack checkpoints and PNG
pages: with ``--fast-pipeline`` against its PageParser +
FastPagePipeline, without it (and when a config falls back from the
fast path) against ``PageParser.process_page`` one page at a time.

The detector is the toy trained one that tests/test_torch_pipeline.py
caches; the recognizer has random float32 weights.  Both are saved with
the JAX package's ``save_variables``.  The JAX side reads the pages with
``cv2.imread`` and runs its exact gather warp (the structured warp is
within 0.5 intensity steps of it, so labels could differ).

``ParseNetWrapper`` builds ParseNet in bfloat16 on both sides and no
config key changes that; XLA's and torch's bf16 convolutions round
differently on the CPU and the NMS equality test turns one-ulp
differences into other masks (ROADMAP section 3).  So the exact case
patches, in this test only, the ParseNet that each package's
parsenet_wrapper builds to float32, and holds every Page XML file equal
to the JAX ``to_pagexml_string()`` with the timestamps masked.  The bf16
case asks for the same number of pages, regions and lines per page.
"""

import configparser
import functools
import importlib.util
import json
import logging
import os
import pickle
import random
import re
import sys
import xml.etree.ElementTree as ET
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.document.fast_pipeline import FastPagePipeline as JaxFastPagePipeline
from pero_ocr_tpu.document.page_parser import PageParser as JaxPageParser
from pero_ocr_tpu.parallel import pipeline as jax_pipeline
from pero_ocr_tpu.utils import checkpoint as jax_checkpoint
from pero_ocr_tpu.layout_engines import parsenet_wrapper as jax_parsenet_wrapper
from pero_ocr_tpu.models.parsenet import ParseNet as FlaxParseNet
from pero_ocr_tpu.models.recognizer import CTCRecognizer as FlaxRecognizer
from pero_ocr_tpu.models.recognizer import RecognizerSpec as FlaxSpec
from pero_ocr_tpu.utils.checkpoint import save_variables
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.document.fast_pipeline import FastPagePipeline
from pero_ocr_tpu_torch.decoding.tpu_decoder import TorchBeamSearchDecoder
from pero_ocr_tpu_torch.document.page_parser import PageDecoder, PageParser
from pero_ocr_tpu_torch.layout_engines import parsenet_wrapper
from pero_ocr_tpu_torch.models.parsenet import ParseNet
from pero_ocr_tpu_torch.ocr.transformer_engine import TransformerEngineLineOCR
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.scripts import parse_folder
from pero_ocr_tpu_torch.utils import checkpoint, native
from tests.test_torch_pipeline import CHARS, DETECTOR, RECOGNIZER, _page, _train_detector
from tests.test_torch_native import jax_native_library

PAGE_NS = "{http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15}"
INI = """[PAGE_PARSER]
RUN_LAYOUT_PARSER = yes
RUN_LINE_CROPPER = yes
RUN_OCR = yes

[LAYOUT_PARSER_1]
METHOD = LAYOUT_CNN
MODEL_PATH = ./layout/parsenet.msgpack
DOWNSAMPLE = 4
DETECTION_THRESHOLD = 0.2
MAX_MEGAPIXELS = 5
ADAPTIVE_DOWNSAMPLE = yes
BASE_FEATURES = 8
DEPTH = 2
OUT_UPSAMPLE = 2

[LINE_CROPPER]
INTERP = 2
LINE_SCALE = 1.0
LINE_HEIGHT = 16

[OCR]
OCR_JSON = ./ocr/ocr.json
"""


CONF_RE = re.compile(r'conf="([0-9.]+)"')


def _masked(xml):
    return re.sub(r"<(Created|LastChange)>[^<]*</\1>", r"<\1/>", xml)


def assert_xml_equal(got: str, want: str) -> None:
    """Equal Page XML apart from the timestamps and ``conf`` (within
    0.001)."""
    assert _masked(CONF_RE.sub("conf", got)) == _masked(CONF_RE.sub("conf", want))
    confs = [np.asarray(CONF_RE.findall(x), float) for x in (got, want)]
    assert len(confs[0]) == len(confs[1])
    assert np.abs(confs[0] - confs[1]).max(initial=0) <= 0.001


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A folder of three PNG pages and a config bundle: ini, OCR JSON
    and the two flax checkpoints."""
    root = tmp_path_factory.mktemp("cli")
    images = root / "images"
    images.mkdir()
    pages = [_page(), _page(shift=8, seed=1), _page(shift=-4, seed=2)]
    for i, page in enumerate(pages):
        assert cv2.imwrite(str(images / f"page-{i}.png"), page)
    (root / "layout").mkdir()
    (root / "ocr").mkdir()
    flax_pn = FlaxParseNet(dtype=jnp.float32, **DETECTOR)
    save_variables(_train_detector(flax_pn), str(root / "layout" / "parsenet.msgpack"))
    # Random weights plus noise: without a Dense bias the logits of the
    # crops' long zero tail decay into denormals, whose argmax XLA (which
    # flushes them to zero) and torch decide differently.
    spec = dict(RECOGNIZER, dtype=jnp.float32)
    rec_vars = FlaxRecognizer(FlaxSpec(**spec)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 64, 3)))
    rng = np.random.default_rng(1)
    rec_vars = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32),
        rec_vars)
    save_variables(rec_vars, str(root / "ocr" / "recognizer.msgpack"))
    with open(root / "ocr" / "ocr.json", "w", encoding="utf-8") as f:
        json.dump({
            "characters": CHARS[:-1], "line_px_height": 16, "checkpoint": "recognizer.msgpack",
            "net_spec": {"conv_features": [4, 8], "subsampling": 2, "lstm_layers": 1,
                         "lstm_features": 8, "dtype": "float32"},
        }, f)
    (root / "config.ini").write_text(INI)
    return root


def cores_share() -> int:
    """This test process's share of the host's cores: all of them, or
    under xdist the cores over the workers (1 for 6 workers on 8)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


@pytest.fixture
def torch_threads_share():
    """torch's intra-op threads held to :func:`cores_share` for the test:
    the port's CPU loops run thousands of tiny ops, and idle threads
    spin on the cores that the other test workers need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, cores_share()))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def float32_parsenets(monkeypatch):
    monkeypatch.setattr(parsenet_wrapper, "ParseNet",
                        functools.partial(ParseNet, dtype=torch.float32))
    monkeypatch.setattr(jax_parsenet_wrapper, "ParseNet",
                        functools.partial(FlaxParseNet, dtype=jnp.float32))


def _config(path):
    config = configparser.ConfigParser()
    config.read(path)
    return config


# The toy detector's heights are 3 map px, which the adaptive downsample
# answers by dropping to ds 1, where it finds nothing: the stage-by-stage
# parity cases run at ds 4.
STAGED_KEYS = {"ADAPTIVE_DOWNSAMPLE": "no"}


def staged_config(bundle, tmp_path, **keys):
    """The bundle's config with ``keys`` set in [LAYOUT_PARSER_1]
    (``PAGE_PARSER__<key>`` in [PAGE_PARSER]) on top of STAGED_KEYS,
    written to ``tmp_path`` beside links to the bundle's checkpoints."""
    config = _config(bundle / "config.ini")
    for key, value in {**STAGED_KEYS, **keys}.items():
        section, key = (("PAGE_PARSER", key[len("PAGE_PARSER__"):])
                        if key.startswith("PAGE_PARSER__") else ("LAYOUT_PARSER_1", key))
        config[section][key] = value
    path = tmp_path / "staged.ini"
    with open(path, "w") as f:
        config.write(f)
    for name in ("layout", "ocr"):
        if not (tmp_path / name).exists():
            os.symlink(bundle / name, tmp_path / name)
    return path


def jax_staged_layouts(config_path, images):
    """The JAX PageParser on every page of ``images``, in order, with
    ``random`` seeded 0 first (the JAX command line's Computator loop)."""
    parser = JaxPageParser(_config(config_path), config_path=str(config_path.parent))
    out = {}
    random.seed(0)
    for name in sorted(os.listdir(images)):
        page = cv2.imread(str(images / name), 1)
        fid = os.path.splitext(name)[0]
        out[fid] = parser.process_page(page, JaxPageLayout(id=fid, page_size=page.shape[:2]))
    return out


def _run_port(args):
    try:
        parse_folder.main(args)
    finally:
        checkpoint.set_strict_loading(False)  # main() sets it process-wide


def _jax_cli(args):
    """The JAX command line (scripts/parse_folder.py) in this process."""
    spec = importlib.util.spec_from_file_location(
        "jax_parse_folder", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts", "parse_folder.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    argv = sys.argv
    sys.argv = ["parse_folder.py", *args]
    try:
        module.main()
    finally:
        sys.argv = argv
        jax_checkpoint.set_strict_loading(False)


def _jax_layouts(bundle):
    page_parser = JaxPageParser(_config(bundle / "config.ini"), config_path=str(bundle))
    fast = JaxFastPagePipeline(page_parser, page_batch=4, transport_bits=4)
    fast.pipeline._stage_b_warp = fast.pipeline._stage_b_warp_gather
    names = sorted(os.listdir(bundle / "images"))
    pages = [cv2.imread(str(bundle / "images" / n), 1) for n in names]
    return list(fast.process_pages(pages, [os.path.splitext(n)[0] for n in names]))


def _port_xml(bundle, out, *extra):
    _run_port(["-c", str(bundle / "config.ini"), "-i", str(bundle / "images"),
               "--output-xml-path", str(out), "--fast-pipeline", "--device", "cpu", *extra])
    return {name[:-4]: (out / name).read_text(encoding="utf-8")
            for name in sorted(os.listdir(out))}


# The JAX pipeline clusters through its native library; its Python
# fallback rounds the penalty windows differently (ROADMAP.md, section 3).
@pytest.mark.skipif(jax_native_library() is None, reason="native library unavailable")
def test_cli_page_xml_equals_jax(bundle, tmp_path, float32_parsenets, capsys):
    got = _port_xml(bundle, tmp_path / "xml", "--timing-report")
    printed = capsys.readouterr().out
    want = _jax_layouts(bundle)
    assert list(got) == [lay.id for lay in want] == ["page-0", "page-1", "page-2"]
    for lay in want:
        assert _masked(got[lay.id]) == _masked(lay.to_pagexml_string())
        assert len(list(lay.lines_iterator())) >= 3  # of the page's 4
    assert any(line.transcription for lay in want for line in lay.lines_iterator())
    assert [line for line in printed.splitlines() if line.startswith("DONE")] == [
        f"DONE page-{i} (fast pipeline)" for i in range(3)]
    assert re.search(r"^cli/pages\s+[0-9.]+\s+1\s", printed, re.M)
    assert "warp_lines kernel launches: 0" in printed  # the CPU runs the plain version


@pytest.mark.skipif(jax_native_library() is None, reason="native library unavailable")
def test_cli_fast_pipeline_ignores_process_count(bundle, tmp_path, float32_parsenets, capsys):
    """--fast-pipeline takes precedence over --process-count in both
    command lines: the fast path's files and DONE lines, no workers."""
    got = _port_xml(bundle, tmp_path / "xml", "--process-count", "2")
    printed = capsys.readouterr().out
    for lay in _jax_layouts(bundle):
        assert _masked(got[lay.id]) == _masked(lay.to_pagexml_string())
    assert [line for line in printed.splitlines() if line.startswith("DONE")] == [
        f"DONE page-{i} (fast pipeline)" for i in range(3)]
    _jax_cli(["-c", str(bundle / "config.ini"), "-i", str(bundle / "images"),
              "--output-xml-path", str(tmp_path / "jax"), "--fast-pipeline", "--device", "cpu",
              "--process-count", "2"])
    printed = capsys.readouterr().out
    assert printed.count("(fast pipeline)") == 3 and "Processing" not in printed


# bf16 detectors, measured on the three toy pages (tests/test_torch_cli.py
# bundle, CPU): stage A's baseline mask flips 0 of 754 pixels at ds 4,
# 10 of 379 at ds 6 and at most 19 (of 599, ds 5) over ds 2-8; the
# quantized heights differ by at most 3 quarter pixels; through the
# command line one line's end moves 12 px (2 map px at ds 6) and one
# height 0.8 px, counts and texts equal.  Held to: masks within
# BF16_MASK_FLIPS of their pixels, equal counts, baseline points within
# BF16_BASELINE_PX and heights within BF16_HEIGHT_PX of the JAX ones.
BF16_MASK_FLIPS = 0.05
BF16_BASELINE_PX = 16.0
BF16_HEIGHT_PX = 1.0


def bf16_masks_flipped(jax_pipe, port_pipe, pages, ds):
    """Stage A's packed baseline masks of both packages on the same
    4-bit gray pages at map scale ``ds``: (pixels flipped, mask pixels)."""
    grays = np.stack([TorchPagePipeline._gray(p) for p in pages])
    grays = TorchPagePipeline.unpack4(torch.from_numpy(TorchPagePipeline._pack4(grays))).numpy()
    want = np.asarray(jax_pipe._stage_a(jnp.asarray(grays), ds)[0])
    got = port_pipe.stage_a(torch.from_numpy(grays), ds)[0].numpy()
    want, got = (np.unpackbits(m, bitorder="little") for m in (want, got))
    return int((want != got).sum()), int(want.sum())


def assert_lines_close(got_lines, want_lines):
    """Matched lines of two bf16 runs: baseline points and heights within
    the measured bounds."""
    assert len(got_lines) == len(want_lines)
    for a, b in zip(got_lines, want_lines):
        pa, pb = np.asarray(a.baseline, float), np.asarray(b.baseline, float)
        assert pa.shape == pb.shape and np.abs(pa - pb).max() <= BF16_BASELINE_PX
        assert np.abs(np.subtract(a.heights, b.heights)).max() <= BF16_HEIGHT_PX


@pytest.mark.skipif(jax_native_library() is None, reason="native library unavailable")
def test_cli_bfloat16_detector_counts_match_jax(bundle, tmp_path):
    """No patch: both ParseNets in bfloat16, as the config builds them:
    stage A's masks, and the command line's Page XML against the JAX
    fast path's, within the measured bounds above."""
    config = _config(bundle / "config.ini")
    jax_pipe = JaxFastPagePipeline(JaxPageParser(config, config_path=str(bundle))).pipeline
    port_pipe = FastPagePipeline.from_page_parser(
        PageParser(config, device="cpu", config_path=str(bundle))).pipeline
    pages = [cv2.imread(str(bundle / "images" / n), 1)
             for n in sorted(os.listdir(bundle / "images"))]
    for ds in (4, 6):
        flipped, total = bf16_masks_flipped(jax_pipe, port_pipe, pages, ds)
        assert total > 100 and flipped <= BF16_MASK_FLIPS * total
    got = _port_xml(bundle, tmp_path / "xml")
    want = _jax_layouts(bundle)
    for lay in want:
        root = ET.fromstring(got[lay.id].encode("utf-8"))
        regions = root.findall(f"{PAGE_NS}Page/{PAGE_NS}TextRegion")
        assert len(regions) == len(lay.regions)
        assert ([len(r.findall(f"{PAGE_NS}TextLine")) for r in regions]
                == [len(r.lines) for r in lay.regions])
        port = PageLayout()
        port.from_pagexml_string(got[lay.id])
        assert_lines_close(list(port.lines_iterator()), list(lay.lines_iterator()))


def test_cli_shards_and_skips_processed(bundle, tmp_path, capsys):
    out = tmp_path / "xml"
    _port_xml(bundle, out, "--shard-index", "1", "--shard-count", "2")
    assert sorted(os.listdir(out)) == ["page-1.xml"]
    (out / "page-0.xml").write_text("done")
    got = _port_xml(bundle, out, "-s")
    assert got["page-0"] == "done"  # skipped
    assert [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("DONE")] == ["DONE page-1 (fast pipeline)"] * 1 + [
        "DONE page-2 (fast pipeline)"]
    transcriptions = tmp_path / "lines.txt"
    _port_xml(bundle, tmp_path / "xml2", "--output-transcriptions-file-path",
              str(transcriptions))
    assert transcriptions.read_text(encoding="utf-8").count("page-") >= 3


def _page_parser_fields(pp):
    extractor = pp.layout_parsers[0]
    engine = extractor.engine
    ocr = pp.ocr.ocr_engine
    spec = ocr.spec
    return {
        "run": (pp.run_layout_parser, pp.run_line_cropper, pp.run_ocr, pp.run_decoder,
                pp.filter_confident_lines_threshold),
        "extractor": tuple(getattr(extractor, k) for k in (
            "detect_regions", "detect_lines", "detect_straight_lines_in_regions",
            "merge_lines", "adjust_heights", "multi_orientation", "adjust_baselines")),
        "engine": tuple(getattr(engine, k) for k in (
            "line_end_weight", "vertical_line_connection_range", "smooth_line_predictions",
            "line_detection_threshold", "adaptive_downsample", "paragraph_line_threshold")),
        "parsenet": tuple(getattr(engine.parsenet, k) for k in (
            "detection_threshold", "adaptive_downsample", "init_downsample",
            "last_downsample", "max_megapixels")),
        "cropper": tuple(getattr(pp.line_cropper.crop_engine, k) for k in (
            "line_height", "poly", "scale"))
        + (pp.line_cropper.device_batched,),
        "ocr": (ocr.line_px_height, ocr.line_vertical_scale, ocr.checkpoint, ocr.characters,
                ocr.net_spec, ocr.embed_num, ocr.embed_id, ocr.max_line_width,
                ocr.net_subsampling, pp.provides_ctc_logits),
        "spec": tuple(getattr(spec, k) for k in (
            "num_classes", "line_height", "conv_features", "subsampling", "lstm_layers",
            "lstm_features", "embed_num", "embed_dim", "stem", "norm"))
        + (getattr(spec.dtype, "__name__", str(spec.dtype).split(".")[-1]),),
    }


KEYS_SET = {  # every key the fast path's construction reads, off its fallback
    "LAYOUT_PARSER_1": {"DOWNSAMPLE": "6", "DETECTION_THRESHOLD": "0.35",
                        "MAX_MEGAPIXELS": "7.5", "ADAPTIVE_DOWNSAMPLE": "no",
                        "LINE_END_WEIGHT": "0.5", "VERTICAL_LINE_CONNECTION_RANGE": "3",
                        "SMOOTH_LINE_PREDICTIONS": "no", "PARAGRAPH_LINE_THRESHOLD": "0.4",
                        "FAST_STEM": "yes", "DETECT_REGIONS": "yes", "DETECT_LINES": "yes"},
    "LINE_CROPPER": {"INTERP": "1", "LINE_SCALE": "1.25", "DEVICE_BATCHED": "no"},
    "PAGE_PARSER": {"FILTER_CONFIDENT_LINES_THRESHOLD": "-0.5"},
}


@pytest.mark.parametrize("variant", ["config2", "every_key"])
def test_page_parser_reads_the_same_fields(bundle, variant):
    config = _config(bundle / "config.ini")
    if variant == "every_key":
        for section, keys in KEYS_SET.items():
            config[section].update(keys)
        with open(bundle / "ocr" / "ocr.json", encoding="utf-8") as f:
            ocr = json.load(f)
        ocr.update(line_vertical_scale=2, embed_num=3, embed_id="1", max_line_width=900)
        (bundle / "ocr" / "ocr_every_key.json").write_text(json.dumps(ocr))
        config["OCR"]["OCR_JSON"] = "./ocr/ocr_every_key.json"
        config["LAYOUT_PARSER_1"]["MODEL_PATH"] = "./layout/missing.msgpack"  # random init
    got = _page_parser_fields(PageParser(config, device="cpu", config_path=str(bundle)))
    want = _page_parser_fields(JaxPageParser(config, config_path=str(bundle)))
    assert got == want


def test_unsupported_features_match_jax(bundle):
    config = _config(bundle / "config.ini")
    for key in ("MULTI_ORIENTATION", "MERGE_LINES", "ADJUST_HEIGHTS", "ADJUST_BASELINES",
                "DETECT_STRAIGHT_LINES_IN_REGIONS"):
        config["LAYOUT_PARSER_1"][key] = "yes"
    config["LAYOUT_PARSER_1"]["DETECT_LINES"] = "no"
    config["PAGE_PARSER"]["FILTER_CONFIDENT_LINES_THRESHOLD"] = "0.5"
    got = FastPagePipeline.unsupported_features(PageParser(config, config_path=str(bundle)))
    want = JaxFastPagePipeline.unsupported_features(
        JaxPageParser(config, config_path=str(bundle)))
    assert got == want and len(got) == 7


# (extra arguments, the error's text, whether it names a ROADMAP item),
# ids as before the crop transport was ported: -x, --transport crops,
# --transport-bits 2 and --canvas-bits run now, and what remains refused
# around them is held here.  The cases "x" and "output-line-path" (JPEG
# line crops, with and without -x) run since the JPEG codec was ported:
# test_cli_line_crops_equal_jax_cli holds their files; "process-count"
# runs since the spawned workers were ported:
# test_cli_process_count_equals_one_process_and_jax holds its files;
# "output-render-path" runs since the renders were ported:
# test_cli_renders_from_tiff_equal_jax_cli holds its files.  The cases
# "transport" (--transport crops --dp 2), "dp" and "profile" run since the
# mesh was ported: test_cli_dp_equals_jax_and_one_device holds the files
# of --dp 2 on both transports, test_cli_dp_mesh its exit where too few
# cards are visible, and test_cli_profile_writes_a_trace --profile on
# both paths.
REFUSED = [
    ("output-line-path-lmdb", ["--output-line-path", "{tmp}/lines.lmdb"], "LMDB store", True),
    ("transport-bits", ["--transport-bits", "2"],
     "--transport-bits 2 requires --transport crops", False),
    ("canvas-bits", ["--canvas-bits", "4"], "--canvas-bits requires --transport crops", False),
]


@pytest.mark.parametrize("extra,text,roadmap", [r[1:] for r in REFUSED],
                         ids=[r[0] for r in REFUSED])
def test_cli_refuses_unported_options(bundle, tmp_path, caplog, extra, text, roadmap):
    """Exit code 2, the reason logged (a ROADMAP item for what the port
    lacks, the JAX command line's own error otherwise), no output
    written."""
    args = ["-c", str(bundle / "config.ini"), "-i", str(bundle / "images"),
            "--output-xml-path", str(tmp_path / "xml"), "--device", "cpu", "--fast-pipeline"]
    args += [a.format(tmp=tmp_path) for a in extra]
    with caplog.at_level(logging.ERROR), pytest.raises(SystemExit) as e:
        _run_port(args)
    assert e.value.code == 2
    assert text in caplog.text and ("ROADMAP.md" in caplog.text) == roadmap
    assert not (tmp_path / "xml").exists()


def printed_done(capsys) -> int:
    return capsys.readouterr().out.count("(fast pipeline)")


def _layout(xml: str) -> PageLayout:
    layout = PageLayout()
    layout.from_pagexml_string(xml)
    return layout


@pytest.mark.skipif(jax_native_library() is None, reason="native library unavailable")
@pytest.mark.parametrize("transport", ["page", "crops"])
def test_cli_dp_equals_jax_and_one_device(bundle, tmp_path, float32_parsenets, jax_gather_warp,
                                          monkeypatch, capsys, transport):
    """--fast-pipeline --dp 2 --device cpu: a page batch of 4 split over
    two CPU replicas.  Its Page XML files equal the port's without --dp
    (timestamps masked) and the JAX command line's with --dp 2 (two of
    its 8 virtual CPU devices; timestamps masked, conf within 0.001).
    The crop transport's straight lines warp on the C++ route, whose
    bytes equal the JAX library's."""
    monkeypatch.setattr(native, "use_native", lambda route, device: True)
    runs = {}
    for name, run, extra in (("dp", _run_port, ["--dp", "2"]), ("one", _run_port, []),
                             ("jax", _jax_cli, ["--dp", "2"])):
        out = tmp_path / name
        run(["-c", str(bundle / "config.ini"), "-i", str(bundle / "images"), "--device", "cpu",
             "--output-xml-path", str(out), "--fast-pipeline", "--transport", transport]
            + extra)
        runs[name] = {f: (out / f).read_text(encoding="utf-8") for f in sorted(os.listdir(out))}
    assert printed_done(capsys) == 9
    assert list(runs["dp"]) == list(runs["one"]) == list(runs["jax"]) == [
        f"page-{i}.xml" for i in range(3)]
    for name, xml in runs["dp"].items():
        assert _masked(xml) == _masked(runs["one"][name])
        assert_xml_equal(xml, runs["jax"][name])
    assert any(line.transcription for name in runs["dp"]
               for line in _layout(runs["dp"][name]).lines_iterator())


def test_cli_dp_mesh(monkeypatch, caplog):
    """--dp's mesh: none for 0 and 1, N CPU replicas with --device cpu,
    and on CUDA exit 2 with the JAX message when fewer cards are
    visible."""
    assert parse_folder.dp_mesh(0, torch.device("cpu")) is None
    assert parse_folder.dp_mesh(1, torch.device("cuda")) is None
    mesh = parse_folder.dp_mesh(2, torch.device("cpu"))
    assert mesh.shape == {"dp": 2, "tp": 1} and mesh.dp_devices == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with caplog.at_level(logging.ERROR), pytest.raises(SystemExit) as e:
        parse_folder.dp_mesh(2, torch.device("cuda"))
    assert e.value.code == 2
    assert "--dp 2 requested but only 1 device(s) visible" in caplog.text


@pytest.mark.parametrize("fast", [False, True], ids=["staged", "fast_pipeline"])
def test_cli_profile_writes_a_trace(bundle, tmp_path, capsys, fast):
    """--profile DIR: a torch.profiler trace of the processing loop lands
    in DIR, on both paths, and the run writes its files.  Stage by stage
    --dp changes nothing, as in the JAX command line."""
    ini = bundle / "config.ini" if fast else staged_config(bundle, tmp_path)
    _run_port(["-c", str(ini), "-i", str(bundle / "images"), "--device", "cpu",
               "--output-xml-path", str(tmp_path / "xml"), "--profile",
               str(tmp_path / "trace"), "--dp", "2"] + (["--fast-pipeline"] if fast else []))
    printed = capsys.readouterr().out
    assert printed.count("(fast pipeline)" if fast else "DONE ") == 3
    assert sorted(os.listdir(tmp_path / "xml")) == [f"page-{i}.xml" for i in range(3)]
    traces = [f for f in os.listdir(tmp_path / "trace") if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    with open(tmp_path / "trace" / traces[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


@pytest.mark.skipif(jax_native_library() is None, reason="native library unavailable")
@pytest.mark.parametrize("fast", [False, True], ids=["no_fast", "fallback_filter"])
def test_cli_stage_by_stage_equals_jax_page_parser(bundle, tmp_path, float32_parsenets, capsys,
                                                    fast):
    """Without --fast-pipeline; and with it on a config that the fast path
    would run differently (FILTER_CONFIDENT_LINES_THRESHOLD, so the run
    falls back to the stage-by-stage path, as the JAX command line's
    does): the JAX PageParser's files and DONE lines."""
    keys = {"PAGE_PARSER__FILTER_CONFIDENT_LINES_THRESHOLD": "0.1"} if fast else {}
    ini = staged_config(bundle, tmp_path, **keys)
    out = tmp_path / "xml"
    _run_port(["-c", str(ini), "-i", str(bundle / "images"), "--output-xml-path", str(out),
               "--device", "cpu", "--timing-report"] + (["--fast-pipeline"] if fast else []))
    printed = capsys.readouterr().out
    want = jax_staged_layouts(ini, bundle / "images")
    assert sorted(os.listdir(out)) == [f"{fid}.xml" for fid in want]
    for fid, layout in want.items():
        assert_xml_equal((out / f"{fid}.xml").read_text(encoding="utf-8"),
                         layout.to_pagexml_string())
    assert sum(len(list(lay.lines_iterator())) for lay in want.values()) >= 9
    done = [line for line in printed.splitlines() if line.startswith("DONE")]
    assert [re.sub(r"Time:[0-9.]+$", "", d) for d in done] == [
        f"DONE {i + 1}/3 ({(i + 1) / 3 * 100:.2f} %) [id: page-{i}] " for i in range(3)]
    assert re.search(r"^cli/pages\s+[0-9.]+\s+1\s", printed, re.M)
    assert "warp_fields kernel launches: 0" in printed  # the CPU runs the plain version


def test_cli_refuses_config_features(bundle, tmp_path, caplog):
    # Every layout stage of item 8d runs, REGION_SIMPLE_THRESHOLD too:
    # after LAYOUT_CNN it sends --fast-pipeline to the stage-by-stage
    # path (an extra layout stage), whose Page XML equals the JAX
    # command line's on the same flags.
    config = _config(bundle / "config.ini")
    config.add_section("LAYOUT_PARSER_2")
    config["LAYOUT_PARSER_2"]["METHOD"] = "REGION_SIMPLE_THRESHOLD"
    with open(tmp_path / "threshold.ini", "w") as f:
        config.write(f)
    for name in ("layout", "ocr"):  # the bundle's relative paths
        os.symlink(bundle / name, tmp_path / name)
    assert "extra layout stage SimpleThresholdRegion" in FastPagePipeline.unsupported_features(
        PageParser(config, device="cpu", config_path=str(bundle)))
    common = ["-c", str(tmp_path / "threshold.ini"), "-i", str(bundle / "images"),
              "--fast-pipeline", "--device", "cpu"]
    with caplog.at_level(logging.ERROR):
        _run_port(common + ["--output-xml-path", str(tmp_path / "port")])
        _jax_cli(common + ["--output-xml-path", str(tmp_path / "jax")])
    assert "ERROR" not in caplog.text
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for name in names:  # the second stage's regions replace the first's, lines and all
        got = (tmp_path / "port" / name).read_text(encoding="utf-8")
        assert_xml_equal(got, (tmp_path / "jax" / name).read_text(encoding="utf-8"))
        assert 'TextRegion id="r-0"' in got
    config.remove_section("LAYOUT_PARSER_2")

    # MERGE_LINES is built, and sends --fast-pipeline to the
    # stage-by-stage path, as in the JAX command line.
    config["LAYOUT_PARSER_1"]["MERGE_LINES"] = "yes"
    assert "MERGE_LINES" in FastPagePipeline.unsupported_features(
        PageParser(config, device="cpu", config_path=str(bundle)))
    config["LAYOUT_PARSER_1"]["MERGE_LINES"] = "no"
    # RUN_DECODER is ported (config 3): the decoder stage is built.
    config["PAGE_PARSER"]["RUN_DECODER"] = "yes"
    config["DECODER"] = {"TYPE": "TPU-BEAM", "BEAM_SIZE": "4"}
    decoder = PageParser(config, device="cpu", config_path=str(bundle)).decoder
    assert isinstance(decoder, PageDecoder)
    assert isinstance(decoder.decoder, TorchBeamSearchDecoder) and decoder.decoder.k == 4
    assert "RUN_DECODER (beam/LM decoding stage)" in FastPagePipeline.unsupported_features(
        PageParser(config, device="cpu", config_path=str(bundle)))
    config["PAGE_PARSER"]["RUN_DECODER"] = "no"
    config.add_section("LAYOUT_PARSER_2")
    config["LAYOUT_PARSER_2"]["METHOD"] = "LINE_FILTER"
    assert "extra layout stage LineFilter" in FastPagePipeline.unsupported_features(
        PageParser(config, device="cpu", config_path=str(bundle)))
    # Transformer OCR is ported (config 4): the engine is built (the
    # bundle's JSON names no net_name: the native model).
    config.remove_section("LAYOUT_PARSER_2")
    config["OCR"]["METHOD"] = "transformer"
    engine = PageParser(config, device="cpu", config_path=str(bundle)).ocr.ocr_engine
    assert isinstance(engine, TransformerEngineLineOCR) and not engine.ref_mode


def test_cli_fails_without_checkpoint_or_decoder(bundle, tmp_path, float32_parsenets,
                                                 jax_gather_warp):
    config = _config(bundle / "config.ini")
    config["LAYOUT_PARSER_1"]["MODEL_PATH"] = str(tmp_path / "missing.msgpack")
    with open(tmp_path / "missing.ini", "w") as f:
        config.write(f)
    for name in ("layout", "ocr"):
        os.symlink(bundle / name, tmp_path / name)
    args = ["-c", str(tmp_path / "missing.ini"), "-i", str(bundle / "images"),
            "--output-xml-path", str(tmp_path / "xml"), "--fast-pipeline", "--device", "cpu"]
    with pytest.raises(FileNotFoundError, match="allow-random-weights"):
        _run_port(args)
    _run_port(args + ["--allow-random-weights"])
    assert len(os.listdir(tmp_path / "xml")) == 3

    # JPEG pages: the fast command line's Page XML equals the JAX
    # command line's on the same files (cv2.imread there).
    jpeg = tmp_path / "jpeg_pages"
    jpeg.mkdir()
    assert cv2.imwrite(str(jpeg / "scan.jpg"), _page(), [cv2.IMWRITE_JPEG_QUALITY, 90])
    for name, run in (("port", _run_port), ("jax", _jax_cli)):
        run(["-c", str(bundle / "config.ini"), "-i", str(jpeg), "--fast-pipeline",
             "--device", "cpu", "--output-xml-path", str(tmp_path / name)])
    got, want = ((tmp_path / name / "scan.xml").read_text(encoding="utf-8")
                 for name in ("port", "jax"))
    assert_xml_equal(got, want)
    assert "<TextLine" in got


def jpeg_pages(bundle, folder):
    """The bundle's pages as JPEG files (cv2, quality 90, 4:2:0)."""
    folder.mkdir(exist_ok=True)
    for name in sorted(os.listdir(bundle / "images")):
        page = cv2.imread(str(bundle / "images" / name), 1)
        assert cv2.imwrite(str(folder / (name[:-4] + ".jpg")), page,
                           [cv2.IMWRITE_JPEG_QUALITY, 90])
    return folder


@pytest.mark.skipif(jax_native_library() is None, reason="native library unavailable")
@pytest.mark.parametrize("fast", [False, True], ids=["staged", "fast_pipeline"])
@pytest.mark.parametrize("reocr", [False, True], ids=["output-line-path", "x"])
def test_cli_line_crops_equal_jax_cli(bundle, tmp_path, float32_parsenets, jax_gather_warp,
                                      monkeypatch, capsys, reocr, fast):
    """Both command lines from JPEG pages with --output-line-path, on
    the layout config and (``-x``) re-OCRing Page XML with an OCR-only
    config: the same Page XML (timestamps masked, conf within 0.001),
    the same line files byte for byte (cv2.imwrite at quality 98 there,
    the port's encoder here) and the same transcriptions file.  The
    fast path's straight lines warp on the host, pinned to the C++ route
    whose bytes equal the JAX library's."""
    from tests.test_torch_reocr import OCR_ONLY, SHIFTS, _input_xml

    monkeypatch.setattr(native, "use_native", lambda route, device: True)
    images = jpeg_pages(bundle, tmp_path / "jpeg")
    extra = ["--fast-pipeline"] if fast else []
    if reocr:
        (tmp_path / "ocr_only.ini").write_text(OCR_ONLY)
        os.symlink(bundle / "ocr", tmp_path / "ocr")
        ini = tmp_path / "ocr_only.ini"
        xml_in = tmp_path / "xml_in"
        xml_in.mkdir()
        for i, shift in enumerate(SHIFTS):
            page = cv2.imread(str(images / f"page-{i}.jpg"), 1)
            (xml_in / f"page-{i}.xml").write_text(
                _input_xml(f"page-{i}", page.shape[:2], shift), encoding="utf-8")
        extra += ["-x", str(xml_in)]
    else:
        ini = staged_config(bundle, tmp_path) if not fast else bundle / "config.ini"
    for name, run in (("port", _run_port), ("jax", _jax_cli)):
        out = tmp_path / name
        random.seed(0)
        run(["-c", str(ini), "-i", str(images), "--device", "cpu",
             "--output-xml-path", str(out / "xml"), "--output-line-path", str(out / "lines"),
             "--output-transcriptions-file-path", str(out / "lines.txt"), "--timing-report"]
            + extra)
    printed = capsys.readouterr().out
    assert re.search(r"^cli/write_lines\s+[0-9.]+\s+3\s", printed, re.M)
    port, jax_out = tmp_path / "port", tmp_path / "jax"
    for page in [f"page-{i}" for i in range(3)]:
        assert_xml_equal((port / "xml" / f"{page}.xml").read_text(encoding="utf-8"),
                         (jax_out / "xml" / f"{page}.xml").read_text(encoding="utf-8"))
    names = sorted(os.listdir(jax_out / "lines"))
    assert names == sorted(os.listdir(port / "lines")) and len(names) >= 9
    for name in names:
        assert (port / "lines" / name).read_bytes() == (jax_out / "lines" / name).read_bytes()
    layout = PageLayout()
    layout.from_pagexml_string((port / "xml" / "page-0.xml").read_text(encoding="utf-8"))
    assert sorted(n for n in names if n.startswith("page-0-")) == sorted(
        f"page-0-{line.id}.jpg" for line in layout.lines_iterator())
    assert ((port / "lines.txt").read_text(encoding="utf-8")
            == (jax_out / "lines.txt").read_text(encoding="utf-8"))


def tiff_pages(bundle, folder, kinds=3):
    """The bundle's first ``kinds`` pages as TIFF files, each of its own
    kind: RGB LZW (PIL's libtiff), 16x16 tiles of Deflate with Predictor
    2 (the test writer), gray PackBits in strips of 7 rows (PIL)."""
    from PIL import Image

    from tests.data.tiff.make_fixtures import base_tags, chunks_of, write_tiff

    folder.mkdir(exist_ok=True)
    for i, name in enumerate(sorted(os.listdir(bundle / "images"))[:kinds]):
        page = cv2.imread(str(bundle / "images" / name), 1)
        path = folder / (name[:-4] + ".tif")
        if i == 0:
            Image.fromarray(page[:, :, ::-1]).save(path, compression="tiff_lzw")
        elif i == 1:
            rgb = np.ascontiguousarray(page[:, :, ::-1])
            tags = base_tags(rgb.shape[0], rgb.shape[1], 8, 3, 2, 8, tile=(16, 16),
                             t317=(3, [2]))
            chunks = chunks_of(rgb, 8, lambda raw, _: zlib.compress(raw), tile=(16, 16),
                               predictor=True)
            path.write_bytes(write_tiff(tags, chunks, tiled=True))
        else:
            Image.fromarray(page[:, :, 0]).save(path, compression="packbits",
                                                strip_size=7 * page.shape[1])
        assert cv2.imread(str(path), 1) is not None
    return folder


def unreadable_tiff(bundle, path):
    """A page cv2.imread returns None for: a non-square TIFF with
    Orientation 6."""
    from tests.data.tiff.make_fixtures import base_tags, write_tiff

    page = cv2.imread(str(bundle / "images" / "page-0.png"), 1)
    rgb = np.ascontiguousarray(page[:40, :60, ::-1])
    path.write_bytes(write_tiff(base_tags(40, 60, 8, 3, 2, 1, t274=(3, [6])), [rgb.tobytes()]))
    assert cv2.imread(str(path), 1) is None
    return path


@pytest.mark.skipif(jax_native_library() is None, reason="native library unavailable")
@pytest.mark.parametrize("fast", [False, True], ids=["staged", "fast_pipeline"])
def test_cli_renders_from_tiff_equal_jax_cli(bundle, tmp_path, float32_parsenets,
                                             jax_gather_warp, monkeypatch, capsys, fast):
    """Both command lines from TIFF pages with --output-render-path: the
    same Page XML (timestamps masked, conf within 0.001) and the same
    render files byte for byte (cv2.polylines, cv2.circle and
    cv2.imwrite at quality 70 there, the port's numpy copies and encoder
    here), drawn after the Page XML stage by stage and last on the fast
    path.  Stage by stage (two pages, to save time) a third page that
    cv2.imread returns None for is reported by both ("Unable to read
    image") and skipped."""
    monkeypatch.setattr(native, "use_native", lambda route, device: True)
    images = tiff_pages(bundle, tmp_path / "tiff", 3 if fast else 2)
    pages = sorted(name[:-4] for name in os.listdir(images))
    if not fast:
        bad = unreadable_tiff(bundle, images / "page-9.tif")
    ini = staged_config(bundle, tmp_path) if not fast else bundle / "config.ini"
    for name, run in (("port", _run_port), ("jax", _jax_cli)):
        out = tmp_path / name
        random.seed(0)
        run(["-c", str(ini), "-i", str(images), "--device", "cpu", "--timing-report",
             "--output-xml-path", str(out / "xml"), "--output-render-path", str(out / "render")]
            + (["--fast-pipeline"] if fast else []))
        printed = capsys.readouterr().out
        if not fast:
            assert "ERROR: Failed to process file page-9." in printed
            assert f'Unable to read image "{bad}"' in printed
        if name == "port":
            assert re.search(rf"^cli/write_render\s+[0-9.]+\s+{len(pages)}\s", printed, re.M)
    port, jax_out = tmp_path / "port", tmp_path / "jax"
    assert sorted(os.listdir(port / "render")) == sorted(os.listdir(jax_out / "render")) == [
        f"{p}.jpg" for p in pages]
    lines = 0
    for page in pages:
        got = (port / "xml" / f"{page}.xml").read_text(encoding="utf-8")
        assert_xml_equal(got, (jax_out / "xml" / f"{page}.xml").read_text(encoding="utf-8"))
        lines += got.count("<TextLine")
        assert ((port / "render" / f"{page}.jpg").read_bytes()
                == (jax_out / "render" / f"{page}.jpg").read_bytes())
    assert lines >= 3 * len(pages)


def test_cli_fast_path_stops_at_an_unreadable_page(bundle, tmp_path):
    """On the fast path a page cv2.imread returns None for stops the run
    with a ValueError naming the file (the JAX command line stops with a
    TypeError), before any page is processed."""
    images = tmp_path / "images"
    images.mkdir()
    bad = unreadable_tiff(bundle, images / "page-0.tif")
    with pytest.raises(ValueError, match=f'Unable to read image "{bad}"'):
        _run_port(["-c", str(bundle / "config.ini"), "-i", str(images), "--device", "cpu",
                   "--output-xml-path", str(tmp_path / "fast"), "--fast-pipeline"])
    assert not os.listdir(tmp_path / "fast")


@pytest.mark.parametrize("fast", [False, True], ids=["staged", "fast_pipeline"])
def test_cli_reads_jpeg2000_pages_as_png(bundle, tmp_path, float32_parsenets, torch_threads_share,
                                         fast):
    """The port's command line on a folder of a JP2 page and a raw
    JPEG 2000 codestream page (5/3 lossless, Pillow's) writes the Page
    XML it writes for the same pixels as PNG files, stage by stage and
    on the fast path."""
    from PIL import Image

    folders = {"jpeg2000": tmp_path / "jpeg2000", "png": tmp_path / "png"}
    for folder in folders.values():
        folder.mkdir()
    for name, suffix in (("page-0", ".jp2"), ("page-1", ".j2k")):
        page = cv2.imread(str(bundle / "images" / f"{name}.png"), 1)
        Image.fromarray(np.ascontiguousarray(page[:, :, ::-1])).save(
            folders["jpeg2000"] / f"{name}{suffix}", "JPEG2000", no_jp2=suffix == ".j2k")
        assert np.array_equal(cv2.imread(str(folders["jpeg2000"] / f"{name}{suffix}"), 1), page)
        cv2.imwrite(str(folders["png"] / f"{name}.png"), page)
    ini = staged_config(bundle, tmp_path) if not fast else bundle / "config.ini"
    for kind, folder in folders.items():
        random.seed(0)
        _run_port(["-c", str(ini), "-i", str(folder), "--device", "cpu",
                   "--output-xml-path", str(tmp_path / f"{kind}_xml")]
                  + (["--fast-pipeline"] if fast else []))
    lines = 0
    for name in ("page-0", "page-1"):
        got = (tmp_path / "jpeg2000_xml" / f"{name}.xml").read_text(encoding="utf-8")
        assert_xml_equal(got, (tmp_path / "png_xml" / f"{name}.xml").read_text(encoding="utf-8"))
        lines += got.count("<TextLine")
    assert lines >= 4


@pytest.mark.parametrize("fast", [False, True], ids=["staged", "fast_pipeline"])
def test_cli_reads_webp_pages_as_png(bundle, tmp_path, float32_parsenets, torch_threads_share, fast):
    """The port's command line on a folder of a lossy WebP page (cv2's,
    quality 90) and a lossless one writes the Page XML it writes for cv2's
    decodes of the two files as PNG pages, stage by stage and on the
    fast path."""
    folders = {"webp": tmp_path / "webp", "png": tmp_path / "png"}
    for folder in folders.values():
        folder.mkdir()
    for name, quality in (("page-0", 90), ("page-1", 101)):
        page = cv2.imread(str(bundle / "images" / f"{name}.png"), 1)
        path = folders["webp"] / f"{name}.webp"
        assert cv2.imwrite(str(path), page, [cv2.IMWRITE_WEBP_QUALITY, quality])
        assert path.read_bytes()[12:16] == (b"VP8 " if quality <= 100 else b"VP8L")
        decoded = cv2.imread(str(path), 1)
        assert np.array_equal(decoded, page) == (quality > 100)
        cv2.imwrite(str(folders["png"] / f"{name}.png"), decoded)
    ini = staged_config(bundle, tmp_path) if not fast else bundle / "config.ini"
    for kind, folder in folders.items():
        random.seed(0)
        _run_port(["-c", str(ini), "-i", str(folder), "--device", "cpu",
                   "--output-xml-path", str(tmp_path / f"{kind}_xml")]
                  + (["--fast-pipeline"] if fast else []))
    lines = 0
    for name in ("page-0", "page-1"):
        got = (tmp_path / "webp_xml" / f"{name}.xml").read_text(encoding="utf-8")
        assert_xml_equal(got, (tmp_path / "png_xml" / f"{name}.xml").read_text(encoding="utf-8"))
        lines += got.count("<TextLine")
    assert lines >= 4


@pytest.mark.parametrize("fast", [False, True], ids=["staged", "fast_pipeline"])
def test_cli_reads_ycbcr_and_cut_short_tiff_pages_as_png(bundle, tmp_path, float32_parsenets,
                                                         torch_threads_share, fast):
    """The port's command line on a folder of a YCbCr TIFF page
    subsampled 2x2 in Deflate strips and an LZW TIFF page with a strip
    cut short (both of which it refused before it read every TIFF cv2
    reads) writes the Page XML it writes for cv2's decodes of the two
    files as PNG pages, stage by stage and on the fast path."""
    from tests.data.tiff.make_fixtures import base_tags, chunks_of, lzw, write_tiff, ycbcr_chunks

    folders = {"tiff": tmp_path / "tiff", "png": tmp_path / "png"}
    for folder in folders.values():
        folder.mkdir()
    for name in ("page-0", "page-1"):
        page = cv2.imread(str(bundle / "images" / f"{name}.png"), 1)
        h, w = page.shape[:2]
        if name == "page-0":
            ycc = cv2.cvtColor(page, cv2.COLOR_BGR2YCrCb)[:, :, [0, 2, 1]]
            data = write_tiff(base_tags(h, w, 8, 3, 6, 8, 16, t530=(3, [2, 2])),
                              ycbcr_chunks(ycc, 2, 2, lambda raw, _: zlib.compress(raw), rows=16))
        else:
            chunks = chunks_of(np.ascontiguousarray(page[:, :, ::-1]), 8, lzw, rows=16)
            chunks[len(chunks) // 2] = chunks[len(chunks) // 2][:100]
            data = write_tiff(base_tags(h, w, 8, 3, 2, 5, 16), chunks)
        (folders["tiff"] / f"{name}.tif").write_bytes(data)
        decoded = cv2.imread(str(folders["tiff"] / f"{name}.tif"), 1)
        assert decoded is not None and decoded.shape == page.shape
        cv2.imwrite(str(folders["png"] / f"{name}.png"), decoded)
    ini = staged_config(bundle, tmp_path) if not fast else bundle / "config.ini"
    for kind, folder in folders.items():
        random.seed(0)
        _run_port(["-c", str(ini), "-i", str(folder), "--device", "cpu",
                   "--output-xml-path", str(tmp_path / f"{kind}_xml")]
                  + (["--fast-pipeline"] if fast else []))
    lines = 0
    for name in ("page-0", "page-1"):
        got = (tmp_path / "tiff_xml" / f"{name}.xml").read_text(encoding="utf-8")
        assert_xml_equal(got, (tmp_path / "png_xml" / f"{name}.xml").read_text(encoding="utf-8"))
        lines += got.count("<TextLine")
    assert lines >= 4


@pytest.mark.parametrize("fast", [False, True], ids=["staged", "fast_pipeline"])
def test_cli_reads_arithmetic_and_cut_short_jpeg_pages_as_png(bundle, tmp_path, float32_parsenets,
                                                              torch_threads_share, fast):
    """The port's command line on a folder of an arithmetic-coded JPEG
    page (cv2's coefficients of the page re-coded by tests/jpeg_files.py)
    and a baseline JPEG page cut short past its first text lines writes
    the Page XML it writes for cv2's own decodes of the two files as PNG
    pages, stage by stage and on the fast path."""
    from tests.jpeg_files import arithmetic_file, quant_bodies, read_coefficients

    folders = {"jpeg": tmp_path / "jpeg", "png": tmp_path / "png"}
    for folder in folders.values():
        folder.mkdir()
    for name in ("page-0", "page-1"):
        page = cv2.imread(str(bundle / "images" / f"{name}.png"), 1)
        data = cv2.imencode(".jpg", page, [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
        if name == "page-0":
            frame, height, width, coefs, segs, _ = read_coefficients(data)
            data = arithmetic_file(frame, height, width, coefs, quant_bodies(segs))
            assert data[data.index(b"\xff\xc9") + 1] == 0xC9
        else:
            data = data[:len(data) * 3 // 4]
        (folders["jpeg"] / f"{name}.jpg").write_bytes(data)
        decoded = cv2.imread(str(folders["jpeg"] / f"{name}.jpg"), 1)
        if name == "page-1":
            assert (decoded[-8:] == 128).all() and not (decoded[:8] == 128).all()
        cv2.imwrite(str(folders["png"] / f"{name}.png"), decoded)
    ini = staged_config(bundle, tmp_path) if not fast else bundle / "config.ini"
    for kind, folder in folders.items():
        random.seed(0)
        _run_port(["-c", str(ini), "-i", str(folder), "--device", "cpu",
                   "--output-xml-path", str(tmp_path / f"{kind}_xml")]
                  + (["--fast-pipeline"] if fast else []))
    lines = {}
    for name in ("page-0", "page-1"):
        got = (tmp_path / "jpeg_xml" / f"{name}.xml").read_text(encoding="utf-8")
        assert_xml_equal(got, (tmp_path / "png_xml" / f"{name}.xml").read_text(encoding="utf-8"))
        lines[name] = got.count("<TextLine")
    assert lines["page-0"] >= 3 and lines["page-1"] >= 1


# The command lines' logits and ALTO files.  Held to: equal Page XML
# (timestamps masked, conf within 0.001); per logits file the same line
# ids, charsets and logit_coords, the same sparsity pattern and values
# within LOGITS_ATOL (the staged path's float32 logits differ by about
# 1e-5 between the packages, the fast path's float16 top-k by one
# float16 ulp); ALTO with the same lines and words, boxes within
# ALTO_BOX_PX and WC within ALTO_WC_TOL.
LOGITS_ATOL = 1e-3
ALTO_BOX_PX = 4
ALTO_WC_TOL = 0.02
ALTO_NS = "{http://www.loc.gov/standards/alto/ns-v2#}"


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def assert_logits_files_close(got_path, want_path):
    got, want = _load_pickle(got_path), _load_pickle(want_path)
    assert sorted(got) == sorted(want)
    assert got["line_characters"] == want["line_characters"]
    assert {k: list(v) for k, v in got["logit_coords"].items()} == {
        k: list(v) for k, v in want["logit_coords"].items()}
    lines = [k for k in got if k not in ("line_characters", "logit_coords")]
    for key in lines:
        a, b = got[key], want[key]
        assert a.format == b.format == "csc" and a.shape == b.shape and a.dtype == b.dtype
        a, b = a.toarray(), b.toarray()
        np.testing.assert_array_equal(a != 0, b != 0)
        np.testing.assert_allclose(a, b, atol=LOGITS_ATOL, rtol=0)
    return len(lines)


def alto_lines(xml):
    root = ET.fromstring(xml.encode("utf-8"))
    return [[{k: s.get(k) for k in ("CONTENT", "HPOS", "VPOS", "WIDTH", "HEIGHT", "WC")}
             for s in line.iter(ALTO_NS + "String")]
            for line in root.iter(ALTO_NS + "TextLine")]


def assert_alto_close(got, want):
    mask = functools.partial(re.sub, r"<processingDateTime>[^<]*</processingDateTime>",
                             "<processingDateTime/>")
    strip = functools.partial(re.sub, r"<String [^>]*/>|<SP [^>]*/>", "")
    assert strip(mask(got)) == strip(mask(want))  # all but the words' attributes
    got_lines, want_lines = alto_lines(got), alto_lines(want)
    assert [[w["CONTENT"] for w in ln] for ln in got_lines] == [
        [w["CONTENT"] for w in ln] for ln in want_lines]
    for a_line, b_line in zip(got_lines, want_lines):
        for a, b in zip(a_line, b_line):
            for key in ("HPOS", "VPOS", "WIDTH", "HEIGHT"):
                assert abs(int(a[key]) - int(b[key])) <= ALTO_BOX_PX, (key, a, b)
            assert (a["WC"] is None) == (b["WC"] is None)
            if a["WC"] is not None:
                assert abs(float(a["WC"]) - float(b["WC"])) <= ALTO_WC_TOL
    return sum(len(ln) for ln in got_lines)


@pytest.fixture
def jax_gather_warp(monkeypatch):
    """Every JAX page pipeline built in the test runs its exact gather
    warp, the operation the port's kernel computes."""
    init = jax_pipeline.TPUPagePipeline.__init__

    def gather_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._stage_b_warp = self._stage_b_warp_gather

    monkeypatch.setattr(jax_pipeline.TPUPagePipeline, "__init__", gather_init)


@pytest.mark.skipif(jax_native_library() is None, reason="native library unavailable")
@pytest.mark.parametrize("fast", [False, True], ids=["staged", "fast_pipeline"])
def test_cli_logits_and_alto_equal_jax_cli(bundle, tmp_path, float32_parsenets, jax_gather_warp,
                                           capsys, fast):
    """Both command lines with --output-xml-path, --output-logit-path
    and --output-alto-path, without and with --fast-pipeline."""
    ini = staged_config(bundle, tmp_path) if not fast else bundle / "config.ini"
    flags = ["--fast-pipeline"] if fast else []
    runs = {}
    for name, run in (("port", _run_port), ("jax", _jax_cli)):
        out = tmp_path / name
        random.seed(0)
        run(["-c", str(ini), "-i", str(bundle / "images"), "--device", "cpu",
             "--output-xml-path", str(out / "xml"), "--output-logit-path", str(out / "logits"),
             "--output-alto-path", str(out / "alto")] + flags)
        runs[name] = out
    printed = capsys.readouterr().out
    assert printed.count("(fast pipeline)") == (6 if fast else 0)
    lines = words = 0
    for page in [f"page-{i}" for i in range(3)]:
        got, want = runs["port"], runs["jax"]
        assert_xml_equal((got / "xml" / f"{page}.xml").read_text(encoding="utf-8"),
                         (want / "xml" / f"{page}.xml").read_text(encoding="utf-8"))
        lines += assert_logits_files_close(got / "logits" / f"{page}.logits",
                                           want / "logits" / f"{page}.logits")
        words += assert_alto_close((got / "alto" / f"{page}.xml").read_text(encoding="utf-8"),
                                   (want / "alto" / f"{page}.xml").read_text(encoding="utf-8"))
    assert lines >= 9 and words > 0
    for name in ("xml", "logits", "alto"):
        assert sorted(os.listdir(runs["port"] / name)) == sorted(os.listdir(runs["jax"] / name))


def test_cli_skips_pages_with_logits_and_refuses_alto_without_ctc(bundle, tmp_path, capsys,
                                                                  caplog):
    """-s needs a page in every asked output, as in the JAX command line;
    ALTO and logits files need a CTC recognizer (the JAX preflight)."""
    out = tmp_path / "out"
    args = ["-c", str(bundle / "config.ini"), "-i", str(bundle / "images"), "--device", "cpu",
            "--fast-pipeline", "--output-xml-path", str(out / "xml"),
            "--output-logit-path", str(out / "logits")]
    _run_port(args)
    os.remove(out / "logits" / "page-1.logits")
    capsys.readouterr()
    _run_port(args + ["-s"])
    assert [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("DONE")] == ["DONE page-1 (fast pipeline)"]
    assert sorted(os.listdir(out / "logits")) == [f"page-{i}.logits" for i in range(3)]

    config = _config(bundle / "config.ini")
    config.remove_section("OCR")
    config["PAGE_PARSER"]["RUN_OCR"] = "no"
    with open(tmp_path / "no_ocr.ini", "w") as f:
        config.write(f)
    os.symlink(bundle / "layout", tmp_path / "layout")
    for option in ("--output-alto-path", "--output-logit-path"):
        with caplog.at_level(logging.ERROR), pytest.raises(SystemExit) as e:
            _run_port(["-c", str(tmp_path / "no_ocr.ini"), "-i", str(bundle / "images"),
                       "--device", "cpu", option, str(tmp_path / "x")])
        assert e.value.code == 2 and "transformer outputs are incompatible" in caplog.text
