"""Re-OCR of existing Page XML on the port against the JAX package, on the
CPU: ``FastPagePipeline.process_existing_layouts`` (mirroring
tests/test_page_parser.py's re-OCR tests) and both command lines with
``-x`` (stage by stage, and ``--fast-pipeline`` on a config without
layout stages), and ``--input-logit-path`` with config 3's decoder on
stored logits.

The bundle is tests/test_torch_cli.py's (three PNG pages, the random
float32 recognizer as a flax checkpoint); the input layouts are one
region of the pages' four lines.  The fast path's straight lines warp on
the host: the port runs its C++ route there (``native``), whose bytes
equal the JAX library's, to which the JAX side is pinned.

Held to: the same Page XML text apart from the timestamps and ``conf``
(within 0.001), the same line ids and objects (updated in place), equal
line crops, equal transcription files.
"""

import configparser
import os
import random
import shutil

import cv2
import numpy as np
import pytest

from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.core.layout import RegionLayout as JaxRegionLayout
from pero_ocr_tpu.core.layout import TextLine as JaxTextLine
from pero_ocr_tpu.document.fast_pipeline import FastPagePipeline as JaxFastPagePipeline
from pero_ocr_tpu.document.page_parser import PageParser as JaxPageParser
from pero_ocr_tpu.layout_engines import helpers as jax_helpers
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.document.fast_pipeline import FastPagePipeline
from pero_ocr_tpu_torch.document.page_parser import PageParser
from pero_ocr_tpu_torch.utils import native
from tests.test_torch_cli import _jax_cli, _run_port, assert_xml_equal, bundle  # noqa: F401
from tests.test_torch_native import jax_native_library
from tests.test_torch_pipeline import LINES
from tests.test_torch_staged import config3_ini

pytestmark = pytest.mark.skipif(
    shutil.which(os.environ.get("CXX") or "c++") is None or jax_native_library() is None,
    reason="no host C++ compiler or the JAX package's native library is unavailable")

OCR_ONLY = """[PAGE_PARSER]
RUN_LAYOUT_PARSER = no
RUN_LINE_CROPPER = yes
RUN_OCR = yes

[LINE_CROPPER]
INTERP = 2
LINE_SCALE = 1.0
LINE_HEIGHT = 16

[OCR]
OCR_JSON = ./ocr/ocr.json
"""
SHIFTS = (0, 8, -4)  # the bundle pages' line shifts


def _input_xml(page_id, shape, shift):
    """One region of the page's lines, as Page XML text."""
    h, w = shape
    layout = JaxPageLayout(id=page_id, page_size=(h, w))
    region = JaxRegionLayout("r1", np.array([[0, 0], [w, 0], [w, h], [0, h]]))
    for i, (y, x0, x1) in enumerate(LINES):
        bl = np.array([[x0 - 2.0, y + shift], [(x0 + x1) / 2, y + shift + 1.5],
                       [x1 + 2.0, y + shift + 3.0]])
        region.lines.append(JaxTextLine(
            id=f"r1-l{i:03d}", index=i, baseline=bl, heights=[10.0, 4.0],
            polygon=jax_helpers.baseline_to_textline(bl, [10.0, 4.0])))
    layout.regions.append(region)
    return layout.to_pagexml_string()


@pytest.fixture(scope="module")
def reocr(bundle):  # noqa: F811
    """The bundle with an OCR-only config and the pages' input XML."""
    (bundle / "ocr_only.ini").write_text(OCR_ONLY)
    xml_in = bundle / "xml_in"
    xml_in.mkdir(exist_ok=True)
    for i, shift in enumerate(SHIFTS):
        page = cv2.imread(str(bundle / "images" / f"page-{i}.png"), 1)
        (xml_in / f"page-{i}.xml").write_text(_input_xml(f"page-{i}", page.shape[:2], shift),
                                              encoding="utf-8")
    return bundle


def _config(path):
    config = configparser.ConfigParser()
    config.read(path)
    return config


def test_process_existing_layouts_matches_jax(reocr):
    """Transcriptions in place, ids kept, crops on request, against the
    JAX recognize-only pipeline; mixed page sizes in one stream; a
    config with layout stages refused for re-OCR."""
    config = _config(reocr / "ocr_only.ini")
    theirs = JaxFastPagePipeline(JaxPageParser(config, config_path=str(reocr)), page_batch=2,
                                 reocr=True, want_crops=True)
    ours = FastPagePipeline.from_page_parser(
        PageParser(config, device="cpu", config_path=str(reocr)), page_batch=2, reocr=True,
        want_crops=True)
    ours.pipeline.native = True  # the C++ host warp: the JAX library's bytes
    assert ours.pipeline.transport == "crops" and ours.pipeline.parsenet is None
    pages = [cv2.imread(str(reocr / "images" / f"page-{i}.png"), 1) for i in range(3)]
    pages[1] = pages[1][:240, :300]  # mixed sizes
    xmls = [(reocr / "xml_in" / f"page-{i}.xml").read_text(encoding="utf-8") for i in range(3)]
    want_in = [JaxPageLayout() for _ in xmls]
    got_in = [PageLayout() for _ in xmls]
    for x, a, b in zip(xmls, want_in, got_in):
        a.from_pagexml_string(x)
        b.from_pagexml_string(x)
    want = list(theirs.process_existing_layouts(pages, want_in))
    got = list(ours.process_existing_layouts(pages, got_in))
    assert [lay.id for lay in got] == [lay.id for lay in want] == ["page-0", "page-1", "page-2"]
    for g, g_in, w in zip(got, got_in, want):
        assert g is g_in
        assert_xml_equal(g.to_pagexml_string(), w.to_pagexml_string())
        lines = list(g.lines_iterator())
        assert [ln.id for ln in lines] == [f"r1-l{i:03d}" for i in range(4)]
        for a, b in zip(lines, w.lines_iterator()):
            assert a.transcription_confidence is not None
            np.testing.assert_array_equal(a.crop, b.crop)
    assert any(ln.transcription for lay in got for ln in lay.lines_iterator())
    with pytest.raises(ValueError, match="re-OCR fast mode takes the layout"):
        FastPagePipeline.from_page_parser(
            PageParser(_config(reocr / "config.ini"), device="cpu", config_path=str(reocr)),
            reocr=True)


@pytest.mark.parametrize("fast", [False, True], ids=["staged", "fast_pipeline"])
def test_cli_reocr_equals_jax_cli(reocr, tmp_path, monkeypatch, capsys, fast):
    """``-x`` with an OCR-only config through both command lines: stage by
    stage (the layout from the XML, LineCropper, OCR) and with
    --fast-pipeline (the recognize-only crop transport, pinned to the
    C++ host warp); equal Page XML and transcription files."""
    monkeypatch.setattr(native, "use_native", lambda route, device: True)
    flags = ["--fast-pipeline"] if fast else []
    for name, run in (("port", _run_port), ("jax", _jax_cli)):
        out = tmp_path / name
        run(["-c", str(reocr / "ocr_only.ini"), "-i", str(reocr / "images"), "-x",
             str(reocr / "xml_in"), "--device", "cpu", "--output-xml-path", str(out / "xml"),
             "--output-transcriptions-file-path", str(out / "lines.txt")] + flags)
    printed = capsys.readouterr().out
    assert printed.count("(fast pipeline)") == (6 if fast else 0)
    names = sorted(os.listdir(tmp_path / "jax" / "xml"))
    assert names == sorted(os.listdir(tmp_path / "port" / "xml")) == [
        f"page-{i}.xml" for i in range(3)]
    for name in names:
        assert_xml_equal((tmp_path / "port" / "xml" / name).read_text(encoding="utf-8"),
                         (tmp_path / "jax" / "xml" / name).read_text(encoding="utf-8"))
    lines = (tmp_path / "port" / "lines.txt").read_text(encoding="utf-8")
    assert lines == (tmp_path / "jax" / "lines.txt").read_text(encoding="utf-8")
    assert lines.count("page-") >= 6


def test_cli_decodes_stored_logits_as_jax(reocr, tmp_path, capsys):
    """Config 3's decoder alone on stored logits: -x and
    --input-logit-path without -i (the pages are the XML files, one of
    them removed), against the JAX command line."""
    _jax_cli(["-c", str(reocr / "ocr_only.ini"), "-i", str(reocr / "images"), "-x",
              str(reocr / "xml_in"), "--device", "cpu", "--output-logit-path",
              str(tmp_path / "logits")])
    ini = config3_ini(reocr, tmp_path)
    config = _config(ini)
    for key in ("RUN_LAYOUT_PARSER", "RUN_LINE_CROPPER", "RUN_OCR"):
        config["PAGE_PARSER"][key] = "no"
    with open(ini, "w") as f:
        config.write(f)
    xml_in = tmp_path / "xml_in"
    shutil.copytree(reocr / "xml_in", xml_in)
    os.remove(xml_in / "page-2.xml")
    for name, run in (("port", _run_port), ("jax", _jax_cli)):
        random.seed(0)
        run(["-c", str(ini), "-x", str(xml_in), "--input-logit-path", str(tmp_path / "logits"),
             "--device", "cpu", "--output-xml-path", str(tmp_path / name)])
    capsys.readouterr()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["page-0.xml", "page-1.xml"]
    for name in names:
        got = (tmp_path / "port" / name).read_text(encoding="utf-8")
        assert_xml_equal(got, (tmp_path / "jax" / name).read_text(encoding="utf-8"))
        assert got.count("<TextLine ") == 4 and got.count("<Unicode>") >= 4


def test_cli_skips_missing_xml_and_ignores_logits_without_xml(reocr, tmp_path, capsys, caplog):
    """--skipp-missing-xml drops the pages whose XML is missing, as the
    JAX command line does; --input-logit-path without -x is ignored with
    the JAX warning."""
    xml_in = tmp_path / "xml_in"
    shutil.copytree(reocr / "xml_in", xml_in)
    os.remove(xml_in / "page-1.xml")
    common = ["-c", str(reocr / "ocr_only.ini"), "-i", str(reocr / "images"), "--device", "cpu"]
    _run_port(common + ["-x", str(xml_in), "--skipp-missing-xml", "--output-xml-path",
                        str(tmp_path / "xml")])
    assert sorted(os.listdir(tmp_path / "xml")) == ["page-0.xml", "page-2.xml"]
    _run_port(["-c", str(reocr / "config.ini"), "-i", str(reocr / "images"), "--device", "cpu",
               "--input-logit-path", str(tmp_path), "--output-xml-path", str(tmp_path / "x2"),
               "--fast-pipeline"])
    assert "Logits will be ignored" in caplog.text
    assert len(os.listdir(tmp_path / "x2")) == 3
    capsys.readouterr()
