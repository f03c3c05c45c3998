"""Config 5's outputs in the port (``core/force_alignment.py``,
``confidence_estimation.py``, ``arabic.py``, ``logits_io.py``,
``altoxml.py``) against the JAX package's modules, on the CPU, on
seeded inputs.

- ``force_align`` and ``align_text``: the port's C++ route
  (``viterbi_ctc_f32``) equal to the JAX package's, which runs its own
  C++ when its library builds; the port's numpy route equal to the JAX
  numpy ``viterbi_ctc``.  The two routes sum in float32 (C++) and
  float64 (numpy): on these seeded costs their paths are equal too, and
  on exact ties (uniform log-probs) both take stay before advance before
  skip and end on the last label before the last blank.
- ``get_line_confidence`` and ``ArabicHelper``: equal (the same numpy
  arithmetic).
- the logits pickle: a file or bytes that either package writes loads in
  the other with equal sparse logits, charsets and coordinates; files
  are pickle protocol 4.
- the ALTO writer: bytes equal to the JAX (lxml) writer's with a fixed
  ``processing_datetime``, on a layout of two regions with a plain line,
  lines that need blanks between repeats, an empty and a blank line, an
  Arabic line, a line with a character outside the charset, and a line
  too short to align (the uniform word fallback); with and without
  ``page_uuid`` and with a ``min_line_confidence`` that drops lines; on
  both of the port's alignment routes.
"""

import os
import pickle

import numpy as np
import pytest
import scipy.sparse

from pero_ocr_tpu.core import altoxml as jax_altoxml
from pero_ocr_tpu.core import arabic as jax_arabic
from pero_ocr_tpu.core import confidence_estimation as jax_confidence
from pero_ocr_tpu.core import force_alignment as jax_fa
from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.core.layout import RegionLayout as JaxRegionLayout
from pero_ocr_tpu.core.layout import TextLine as JaxTextLine
from pero_ocr_tpu_torch.core import altoxml, arabic, confidence_estimation
from pero_ocr_tpu_torch.core import force_alignment as fa
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from tests.test_torch_native import jax_native_library

ROUTES = pytest.mark.parametrize("route", [True, False], ids=["native", "numpy"])
CHARS = list("abcd ") + ["ب", "ت", "ل", "ا", "م", "\u200b"]
DATETIME = "2026-01-01T00:00:00+00:00"


@pytest.fixture(autouse=True)
def _jax_library():
    """The JAX force_align runs its C++ when its library builds and
    numpy otherwise; these tests hold the C++ route to the JAX C++."""
    if jax_native_library() is None:
        pytest.skip("the JAX package's native library is unavailable")


def _logprobs(rng, t, c, dtype=np.float32):
    logits = rng.normal(0, 2, (t, c))
    logits -= np.logaddexp.reduce(logits, axis=1, keepdims=True)
    return logits.astype(dtype)


def _labels(rng, n, c):
    """Labels with runs of repeats (the chain needs blanks there)."""
    labels = rng.integers(0, c - 1, n)
    labels[1::4] = labels[0::4][: len(labels[1::4])]
    return labels


# ----------------------------------------------------------------------
# Forced alignment

@ROUTES
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_force_align_equals_jax(route, dtype):
    rng = np.random.default_rng(0)
    for trial in range(12):
        c = int(rng.integers(3, 12))
        n = int(rng.integers(1, 9))
        t = 2 * n + int(rng.integers(1, 30))
        logprobs = _logprobs(rng, t, c, dtype)
        labels = _labels(rng, n, c)
        for positions in (False, True):
            got = fa.force_align(-logprobs, labels, c - 1, positions, native=route)
            want = jax_fa.force_align(-logprobs, labels, c - 1, positions)
            assert got == want, (trial, positions)
        np.testing.assert_array_equal(fa.align_text(-logprobs, labels, c - 1, native=route),
                                      jax_fa.align_text(-logprobs, labels, c - 1))


def test_viterbi_routes_agree_and_break_ties_alike():
    """numpy's float64 sums and the C++'s float32 sums give the same
    paths on seeded costs and on exact ties (every path costs the same
    under uniform log-probs: stay wins over advance, advance over skip,
    the last label over the last blank)."""
    rng = np.random.default_rng(1)
    for _ in range(20):
        c, n = 7, int(rng.integers(1, 8))
        t = 2 * n + int(rng.integers(1, 20))
        states, _ = fa.complete_state_seq(_labels(rng, n, c), c - 1)
        skip = fa._skip_allowed(states)
        gathered = -_logprobs(rng, t, c)[:, states]
        np.testing.assert_array_equal(fa.viterbi_ctc(gathered, skip),
                                      fa.native_lib.native_viterbi_ctc(gathered, skip))
        np.testing.assert_array_equal(fa.viterbi_ctc(gathered, skip),
                                      jax_fa.viterbi_ctc(gathered, skip))
    uniform = np.full((9, 7), np.log(7.0), np.float32)
    states, _ = fa.complete_state_seq([1, 1, 2], 6)
    skip = fa._skip_allowed(states)
    path = fa.viterbi_ctc(uniform[:, states], skip)
    np.testing.assert_array_equal(path, fa.native_lib.native_viterbi_ctc(uniform[:, states], skip))
    assert path[-1] == len(states) - 2  # ends on the last label
    assert list(path) == sorted(path)


@ROUTES
def test_force_align_errors_equal_jax(route):
    rng = np.random.default_rng(2)
    logprobs = _logprobs(rng, 3, 5)
    for labels, blank in (([1, 1, 2], 4), ([], 4), ([4], 4)):
        with pytest.raises(ValueError) as want:
            jax_fa.force_align(-logprobs, labels, blank)
        with pytest.raises(ValueError) as got:
            fa.force_align(-logprobs, labels, blank, native=route)
        assert str(got.value) == str(want.value)


# ----------------------------------------------------------------------
# Confidences, Arabic

def _sparse_line(cls, rng, text, chars=CHARS, t=None, coords=None, **kwargs):
    """A line whose logits peak at its text's characters (three frames
    a character) over a blank background, pruned below 0 as sparse."""
    t = t or 3 * len(text) + 4
    logits = rng.normal(0, 1, (t, len(chars))).astype(np.float32)
    for j, ch in enumerate(text[: (t - 2) // 3]):
        logits[2 + 3 * j, chars.index(ch) if ch in chars else 0] += 15
    logits[:, -1] += 6
    return cls(logits=scipy.sparse.csc_matrix(np.where(logits > 0, logits, 0)),
               characters=list(chars), logit_coords=coords or [0, t], transcription=text,
               **kwargs)


@ROUTES
def test_line_confidence_equals_jax(route):
    rng = np.random.default_rng(3)
    for text in ("ab cd", "aab", "d", "abba dcc"):
        seed = int(rng.integers(1 << 30))
        port = _sparse_line(TextLine, np.random.default_rng(seed), text)
        ref = _sparse_line(JaxTextLine, np.random.default_rng(seed), text)
        labels = port.get_labels()
        np.testing.assert_array_equal(labels, ref.get_labels())
        np.testing.assert_array_equal(
            confidence_estimation.get_line_confidence(port, labels, native=route),
            jax_confidence.get_line_confidence(ref, labels))


ARABIC = ["بتلا مب", "لا", "abc بت 12", "سلام عليكم", "كتاب، ممتع", "مرحبا - hello: ب", "x"]


def test_arabic_helper_equals_jax():
    port, ref = arabic.ArabicHelper(), jax_arabic.ArabicHelper()
    for text in ARABIC:
        for name in ("string_to_label_form", "label_form_to_string", "string_to_visual_form",
                     "visual_form_to_string", "label_form_to_visual_form",
                     "visual_form_to_label_form", "reshape", "is_arabic_line",
                     "ligatures_mapping"):
            assert getattr(port, name)(text) == getattr(ref, name)(text), (name, text)
        for word in text.split():
            assert port.is_arabic_word(word) == ref.is_arabic_word(word)
    assert port.is_arabic_line(ARABIC[0]) and not port.is_arabic_line("abc")


# ----------------------------------------------------------------------
# Layouts on both sides

def _layout(classes, seed, page_id="page 1/ä"):
    """Two regions; lines as the module docstring lists them."""
    page_cls, region_cls, line_cls = classes
    rng = np.random.default_rng(seed)
    layout = page_cls(id=page_id, page_size=(400, 600))
    texts = [["ab cd", "", "aab  bba", "   ", "لا بت"], ["dcx ab", "abcabcabc", "d"]]
    boxes = [np.array([[20, 30], [580, 25], [585, 200], [15, 205]]),
             np.array([[30, 220], [570, 220], [570, 380], [30, 380]])]
    for r, (lines, box) in enumerate(zip(texts, boxes)):
        region = region_cls(f"r{r + 1}", box)
        for i, text in enumerate(lines):
            y = box[0, 1] + 35 + 40 * i
            kwargs = dict(id=f"r{r + 1}-l{i + 1:03d}",
                          baseline=np.array([[box[0, 0] + 10, y], [box[1, 0] - 20, y + 3]]),
                          heights=[18, 6],
                          polygon=np.array([[box[0, 0] + 10, y - 18], [box[1, 0] - 20, y - 15],
                                            [box[1, 0] - 20, y + 9], [box[0, 0] + 10, y + 6]]))
            if text == "abcabcabc":  # 4 frames for 9 characters: no alignment
                region.lines.append(_sparse_line(line_cls, rng, text, t=30, coords=[2, 6],
                                                 **kwargs))
            else:
                region.lines.append(_sparse_line(line_cls, rng, text, **kwargs))
        layout.regions.append(region)
    return layout


PORT = (PageLayout, RegionLayout, TextLine)
JAX = (JaxPageLayout, JaxRegionLayout, JaxTextLine)


@ROUTES
@pytest.mark.parametrize("case", ["plain", "uuid", "min_confidence"])
def test_alto_bytes_equal_jax(route, case, caplog):
    port, ref = _layout(PORT, 5), _layout(JAX, 5)
    kwargs = {"uuid": {"page_uuid": "1234-abcd"},
              "min_confidence": {"min_line_confidence": 0.5}}.get(case, {})
    got = port.to_altoxml_string(
        altoxml.create_ocr_processing_element(processing_datetime=DATETIME),
        native=route, **kwargs)
    want = ref.to_altoxml_string(
        jax_altoxml.create_ocr_processing_element(processing_datetime=DATETIME), **kwargs)
    assert got == want
    assert "uniform word boxes" in caplog.text  # the short line fell back
    written = sum(bool((ln.transcription or "").strip()) for ln in ref.lines_iterator())
    if case == "min_confidence":
        assert 0 < got.count("<TextLine") < written
    else:
        assert got.count("<TextLine") == written == 6
    assert 'CONTENT="تب"' in got  # the Arabic line's "بت", label order back to logical
    for a, b in zip(port.lines_iterator(), ref.lines_iterator()):
        assert a.transcription_confidence == b.transcription_confidence


def test_alto_processing_element_equals_jax():
    import lxml.etree as ET

    got = altoxml.create_ocr_processing_element(
        id="X&1", software_creator_str="<me>", software_name_str="n",
        software_version_str="2", processing_datetime=DATETIME)
    want = jax_altoxml.create_ocr_processing_element(
        id="X&1", software_creator_str="<me>", software_name_str="n",
        software_version_str="2", processing_datetime=DATETIME)
    out = []
    got.write(out, 0)
    assert "".join(out) == ET.tostring(want, pretty_print=True, encoding="unicode")
    assert altoxml.polygon_hwvh([[3, 4], [10, 1], [7, 9]]) == jax_altoxml.polygon_hwvh(
        [[3, 4], [10, 1], [7, 9]])


def test_alto_file_is_the_string(tmp_path):
    layout = _layout(PORT, 6)
    layout.to_altoxml(str(tmp_path / "a.xml"),
                      altoxml.create_ocr_processing_element(processing_datetime=DATETIME),
                      native=False)
    assert (tmp_path / "a.xml").read_text(encoding="utf-8") == _layout(PORT, 6).to_altoxml_string(
        altoxml.create_ocr_processing_element(processing_datetime=DATETIME), native=False)


# ----------------------------------------------------------------------
# The logits pickle

def _assert_same_logits(got_layout, want_layout):
    got, want = list(got_layout.lines_iterator()), list(want_layout.lines_iterator())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.id == b.id and a.characters == b.characters
        assert list(a.logit_coords) == list(b.logit_coords)
        assert scipy.sparse.isspmatrix_csc(a.logits) and a.logits.dtype == b.logits.dtype
        np.testing.assert_array_equal(a.logits.toarray(), b.logits.toarray())


def _bare(classes):
    """The layout's geometry and ids without logits."""
    layout = _layout(classes, 8)
    for line in layout.lines_iterator():
        line.logits = line.characters = line.logit_coords = None
    return layout


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("medium", ["file", "bytes"])
def test_logits_round_trip_between_packages(tmp_path, direction, medium):
    port, ref = _layout(PORT, 8), _layout(JAX, 8)
    writer, reader_classes = (port, JAX) if direction == "port_to_jax" else (ref, PORT)
    reader = _bare(reader_classes)
    if medium == "file":
        path = str(tmp_path / "page.logits")
        writer.save_logits(path)
        with open(path, "rb") as f:
            assert f.read(2) == b"\x80\x04"  # pickle protocol 4
        reader.load_logits(path)
    else:
        reader.load_logits(writer.save_logits_bytes())
    _assert_same_logits(reader, writer)
    with open(str(tmp_path / "p.logits"), "wb") as f:
        pickle.dump({"r1-l001": port.regions[0].lines[0].logits}, f, protocol=4)
    old = _bare(PORT)
    old.load_logits(str(tmp_path / "p.logits"))  # a file without the charset dicts
    assert old.regions[0].lines[0].characters is None


def test_logits_missing_errors_equal_jax(tmp_path):
    port, ref = _bare(PORT), _bare(JAX)
    with pytest.raises(ValueError) as got:
        port.save_logits(str(tmp_path / "a"))
    with pytest.raises(ValueError) as want:
        ref.save_logits(str(tmp_path / "b"))
    assert str(got.value) == str(want.value)
    port.save_logits(str(tmp_path / "c"), missing_line_logits_ok=True)
    with open(str(tmp_path / "c"), "rb") as f:
        assert pickle.load(f) == {"line_characters": {}, "logit_coords": {}}
    assert os.path.getsize(str(tmp_path / "c")) > 0
