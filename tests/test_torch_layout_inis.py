"""The two configs of item 8d's stages through the port against the JAX
package, on the CPU, on the bundle of tests/test_torch_layout_stages.py:

- ini (a): ``LAYOUT_CNN`` with ``MULTI_ORIENTATION``, ``MERGE_LINES``
  and ``ADJUST_BASELINES``, then ``LINE_FILTER`` (directions with a
  seeded OrientationNet, incomplete pages, short lines),
  ``LINE_POSTPROCESSING``, ``LAYOUT_POSTPROCESSING`` (``RETRACE_REGIONS``)
  and ``REGION_SORTER_NAIVE``;
- ini (b): ``LAYOUT_CNN`` with ``DETECT_STRAIGHT_LINES_IN_REGIONS``.

Each through ``PageParser.process_page`` on two pages, and ini (a)
through the port's command line against the JAX command line (PNG
pages, the flax checkpoints; with ``--fast-pipeline`` too, which falls
back to the stage-by-stage path): Page XML equal apart from the timestamps,
``conf`` within 0.001, ``random`` seeded alike.  The port's ParseNet and
OrientationNet wrappers hand on the JAX wrappers' maps, for the reason
tests/test_torch_layout_stages.py gives.
"""

import os

import cv2
import pytest

from pero_ocr_tpu.layout_engines.parsenet_wrapper import OrientationNetWrapper as JaxOrientation
from pero_ocr_tpu.layout_engines.parsenet_wrapper import ParseNetWrapper as JaxParseNetWrapper
from pero_ocr_tpu_torch.layout_engines import parsenet_wrapper
from tests.test_torch_cli import _jax_cli, _run_port, assert_xml_equal
from tests.test_torch_layout_stages import (  # noqa: F401  (fixtures)
    INI_A, INI_B, float32_nets, layout_bundle, layout_ini, layout_pages, one_thread, parsers,
    run_both,
)


@pytest.mark.parametrize("ini", ["a", "b"])
def test_layout_ini_matches_jax(layout_bundle, float32_nets, ini):
    options, stages = INI_A if ini == "a" else INI_B
    ours, theirs = parsers(layout_bundle, layout_ini(options, stages), f"ini_{ini}")
    got, _ = run_both(ours, theirs, layout_pages(2, seed=2))
    assert sum(len(list(lay.lines_iterator())) for lay in got) >= 20
    if ini == "a":
        assert [type(lp).__name__ for lp in ours.layout_parsers] == [
            "LayoutExtractor", "LineFilter", "LinePostprocessor", "LayoutPostprocessor",
            "NaiveRegionSorter"]


def test_layout_ini_command_line_matches_jax(layout_bundle, float32_nets, tmp_path,
                                             monkeypatch):
    images = tmp_path / "images"
    images.mkdir()
    for i, page in enumerate(layout_pages(2, seed=3)):
        assert cv2.imwrite(str(images / f"page-{i}.png"), page)
    ini = layout_bundle / "ini_a_cli.ini"
    ini.write_text(layout_ini(*INI_A))
    maps = JaxParseNetWrapper(str(layout_bundle / "parsenet.msgpack"), base_features=8, depth=2,
                              stem="s2d", out_upsample=2)
    directions = JaxOrientation(str(layout_bundle / "orientation.msgpack"))
    monkeypatch.setattr(parsenet_wrapper.ParseNetWrapper, "get_maps",
                        lambda self, img, ds: maps.get_maps(img, ds))
    monkeypatch.setattr(parsenet_wrapper.OrientationNetWrapper, "get_maps",
                        lambda self, img, ds: directions.get_maps(img, ds))
    # With --fast-pipeline the run falls back to the stage-by-stage path
    # (the fast path would change what these stages mean), as in JAX.
    for out, extra in (("port", []), ("port_fast", ["--fast-pipeline"])):
        _run_port(["-c", str(ini), "-i", str(images), "--output-xml-path", str(tmp_path / out),
                   "--device", "cpu", *extra])
    _jax_cli(["-c", str(ini), "-i", str(images), "--output-xml-path", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["page-0.xml", "page-1.xml"]
    for out in ("port", "port_fast"):
        assert sorted(os.listdir(tmp_path / out)) == names
        for name in names:
            assert_xml_equal((tmp_path / out / name).read_text(encoding="utf-8"),
                             (tmp_path / "jax" / name).read_text(encoding="utf-8"))
