"""Parity of the port's page quality (``core/quality.py``,
``PageLayout.get_quality``) and ALTO reader (``core/altoxml.py``
``read_altoxml*``, ``PageLayout.from_altoxml*``) with the JAX package's,
on the CPU.

- Quality: the JAX package's ``TestQuality`` layout, windowed and not; a
  page of two lines with a window that cuts one of them; the two-region
  layout of ``test_torch_alto.py`` (an Arabic line, blank lines and a
  line too short to align), windowed and not; on both of the port's
  alignment routes.  Values and the lines' ``transcription_confidence``
  within 1e-6.
- ALTO reader: the port's ALTO bytes read back by the port and by the
  JAX package, an ALTO file written by the JAX writer read through
  both, the same file under the ALTO v4 namespace, and the round trip of
  the JAX package's ``test_alto_round_trip``: the same page id and size,
  regions, lines, baselines, heights, polygons and transcriptions.
"""

import numpy as np
import pytest
import scipy.sparse

from pero_ocr_tpu.core import altoxml as jax_altoxml
from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.core.layout import RegionLayout as JaxRegionLayout
from pero_ocr_tpu.core.layout import TextLine as JaxTextLine
from pero_ocr_tpu_torch.core import altoxml
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from tests.test_torch_alto import _layout

QUALITY_TOL = 1e-6
PORT = (PageLayout, RegionLayout, TextLine)
JAX = (JaxPageLayout, JaxRegionLayout, JaxTextLine)
ROUTES = pytest.mark.parametrize("route", [True, False], ids=["native", "numpy"])
DATETIME = "2026-01-01T00:00:00+00:00"


def _peaked_line(line_cls, text, baseline, polygon, line_id, peak=15.0):
    """The JAX ``TestALTO._layout_with_logits`` line: ``peak`` (15) at
    each character's frame, a blank peak of 12 elsewhere."""
    chars = list("Helo wrd") + ["​"]
    t = len(text) * 3 + 4
    dense = np.full((t, len(chars)), -1.0)
    for i, ch in enumerate(text):
        dense[2 + 3 * i, chars.index(ch)] = peak
        if peak < 15.0:
            dense[2 + 3 * i, -1] = 11.0
    for f in range(t):
        if dense[f].max() < 10:
            dense[f, -1] = 12.0
    return line_cls(id=line_id, index=0, baseline=baseline, polygon=polygon,
                    heights=[30.0, 8.0], transcription=text, transcription_confidence=0.95,
                    logits=scipy.sparse.csc_matrix(np.where(dense > 0, dense, 0)),
                    characters=chars, logit_coords=[0, t])


def _quality_page(classes, two_lines):
    page_cls, region_cls, line_cls = classes
    layout = page_cls(id="page1.jpg", page_size=(1000, 800))
    region = region_cls("r001", np.array([[10, 10], [700, 10], [700, 200], [10, 200]]),
                        region_type="paragraph")
    region.lines.append(_peaked_line(
        line_cls, "Hello world", np.array([[20, 100], [600, 102]]),
        np.array([[20, 70], [600, 72], [600, 110], [20, 108]]), "r001-l001"))
    if two_lines:
        region.lines.append(_peaked_line(
            line_cls, "old word", np.array([[30, 160], [420, 150]]),
            np.array([[30, 130], [420, 120], [420, 158], [30, 168]]), "r001-l002",
            peak=11.5))  # letters less sure than the first line's
    layout.regions.append(region)
    return layout


PAGES = {
    "jax_test_page": lambda classes: _quality_page(classes, False),
    "two_lines": lambda classes: _quality_page(classes, True),
    "two_regions": lambda classes: _layout(classes, 5),
}
WINDOWS = {
    "whole": {},
    "page_window": dict(x=0, y=0, width=800, height=1000),
    # Cuts the second line of "two_lines" at x = 250 and keeps the first
    # line's left half.
    "cut": dict(x=0, y=60, width=250, height=80),
    "power_2": dict(x=100, y=0, width=500, height=400, power=2),
}


@ROUTES
@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("page", sorted(PAGES))
def test_quality_equals_jax(page, window, route):
    port, ref = PAGES[page](PORT), PAGES[page](JAX)
    got = port.get_quality(native=route, **WINDOWS[window])
    want = ref.get_quality(**WINDOWS[window])
    assert abs(got - want) <= QUALITY_TOL, (got, want)
    for a, b in zip(port.lines_iterator(), ref.lines_iterator()):
        if b.transcription_confidence is None:
            assert a.transcription_confidence is None
        else:
            assert abs(a.transcription_confidence - b.transcription_confidence) <= QUALITY_TOL
    if page == "jax_test_page" and window == "whole":
        assert 0.9 <= got <= 1.0  # the JAX test's own bound


def test_cut_window_counts_part_of_a_line():
    """The "cut" window holds some letters of the two-line page, not
    all and not none."""
    full = _quality_page(PORT, True).get_quality(power=1, native=False)
    first = _quality_page(PORT, False).get_quality(power=1, native=False)
    cut = _quality_page(PORT, True).get_quality(power=1, native=False, **WINDOWS["cut"])
    assert cut != -1 and cut != full and cut != first


def _assert_same_layout(got, want):
    assert got.id == want.id
    assert tuple(got.page_size) == tuple(want.page_size)
    assert [r.id for r in got.regions] == [r.id for r in want.regions]
    for rg, rw in zip(got.regions, want.regions):
        np.testing.assert_array_equal(np.asarray(rg.polygon), np.asarray(rw.polygon))
        assert len(rg.lines) == len(rw.lines)
        for lg, lw in zip(rg.lines, rw.lines):
            assert lg.id == lw.id
            assert lg.transcription == lw.transcription
            for key in ("baseline", "heights", "polygon"):
                a, b = np.asarray(getattr(lg, key)), np.asarray(getattr(lw, key))
                assert a.dtype == b.dtype and a.shape == b.shape, key
                np.testing.assert_array_equal(a, b)


def _read_both(alto):
    got, want = PageLayout(), JaxPageLayout()
    got.from_altoxml_string(alto)
    want.from_altoxml_string(alto)
    return got, want


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_alto_reader_equals_jax(writer):
    if writer == "port":
        alto = _layout(PORT, 5).to_altoxml_string(
            altoxml.create_ocr_processing_element(processing_datetime=DATETIME))
    else:
        alto = _layout(JAX, 5).to_altoxml_string(
            jax_altoxml.create_ocr_processing_element(processing_datetime=DATETIME))
    got, want = _read_both(alto)
    _assert_same_layout(got, want)
    assert len(got.regions) == 2
    assert sum(1 for _ in got.lines_iterator()) == 6


def test_alto_reader_v4_namespace_and_file(tmp_path):
    alto = _layout(JAX, 7).to_altoxml_string().replace(
        "http://www.loc.gov/standards/alto/ns-v2#", "http://www.loc.gov/standards/alto/ns-v4#")
    path = tmp_path / "page.xml"
    path.write_text(alto, encoding="utf-8")
    got, want = PageLayout(), JaxPageLayout()
    got.from_altoxml(str(path))
    want.from_altoxml(str(path))
    _assert_same_layout(got, want)
    assert any(line.transcription for line in got.lines_iterator())


def test_alto_round_trip_of_the_jax_test():
    port, ref = _quality_page(PORT, False), _quality_page(JAX, False)
    got, _ = _read_both(port.to_altoxml_string())
    _, want = _read_both(ref.to_altoxml_string())
    _assert_same_layout(got, want)
    assert got.page_size == (1000, 800)
    lines = list(got.lines_iterator())
    assert len(lines) == 1 and lines[0].transcription == "Hello world"
