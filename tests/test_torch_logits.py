"""The fast path's logits (``want_logits``): stage B's top-k download in
the port's page transport against the JAX page transport's, and the
sparse logits, ``logit_coords`` and ALTO that the document layer builds
from it, on the CPU.

Both sides run tests/test_torch_pipeline.py's toy detector and its
float32 recognizer with 0.1 x normal noise on the weights (as
tests/test_torch_cli.py does, so that no logit decays into a denormal);
the JAX side runs its exact gather warp.  Held to:

- the same labels, lengths and crop widths;
- per frame, the same set of top-k class indices wherever the k-th and
  the (k+1)-th largest logits (the port's, from a run with k + 1) lie
  more than TOPK_GAP apart: the two recognizers' float32 logits differ
  by about 1e-5, so closer pairs may swap (``torch.topk`` promises no
  order among equal values either, so indices are compared as sets and
  values by class);
- the values, by class, within float16 rounding (half an ulp of float16
  on each side after float32 differences of about 1e-5: VALUE_ATOL
  plus VALUE_RTOL);
- the same ``logit_coords`` and charset on every line;
- ALTO from both layouts (the port's writer against the JAX lxml
  writer, each side's own forced alignment): the same pages, lines and
  words (``CONTENT``), box coordinates within BOX_PX and ``WC`` within
  WC_TOL (a frame that a near-tie moves shifts a box by frames_to_cols,
  a few pixels).

Measured on these pages: 0 top-k sets differ in 3072 frames, values
differ by at most 6.1e-5 (one float16 ulp), and the ALTO boxes and
``WC`` of all 12 words are equal.
"""

import types
import xml.etree.ElementTree as ET

import jax
import numpy as np
import pytest
import torch

from pero_ocr_tpu.core import altoxml as jax_altoxml
from pero_ocr_tpu.document.fast_pipeline import FastPagePipeline as JaxFastPagePipeline
from pero_ocr_tpu.document.fast_pipeline import assemble_page_layout as jax_assemble
from pero_ocr_tpu.parallel.pipeline import TPUPagePipeline
from pero_ocr_tpu_torch.core import altoxml
from pero_ocr_tpu_torch.document.fast_pipeline import FastPagePipeline
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.utils.convert import recognizer_params_from_flax
from tests.test_torch_native import jax_native_library
from tests.test_torch_pipeline import CHARS, PIPELINE, RECOGNIZER, _page, models  # noqa: F401

TOPK_GAP = 1e-3
VALUE_ATOL = 1e-4
VALUE_RTOL = 2.0 ** -10
BOX_PX = 2 * 2  # two frames of the toy recognizer (subsampling 2)
WC_TOL = 0.02
DATETIME = "2026-01-01T00:00:00+00:00"
ALTO_NS = "{http://www.loc.gov/standards/alto/ns-v2#}"
SUBSAMPLING = RECOGNIZER["subsampling"]


@pytest.fixture(scope="module")
def noisy(models):
    """The toy models with the recognizer's weights plus 0.1 x normal
    noise: (flax modules and variables, a maker of the torch pair)."""
    (flax_pn, pn_vars, flax_rec, rec_vars), torch_models = models
    rng = np.random.default_rng(1)
    rec_vars = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32),
        rec_vars)
    rec_state = recognizer_params_from_flax(rec_vars)

    def port_models():
        pn, _ = torch_models()
        rec = CTCRecognizer(RecognizerSpec(dtype=torch.float32, **RECOGNIZER))
        rec.load_state_dict(rec_state)
        return pn, rec

    return (flax_pn, pn_vars, flax_rec, rec_vars), port_models


def _runs(noisy, topk):
    (flax_pn, pn_vars, flax_rec, rec_vars), port_models = noisy
    pages = [_page(), _page(shift=8, seed=1), _page(shift=-4, seed=2)]
    jax_pipe = TPUPagePipeline(flax_pn, pn_vars, flax_rec, rec_vars, transport="page",
                               want_logits=True, logits_topk=topk, **PIPELINE)
    jax_pipe._stage_b_warp = jax_pipe._stage_b_warp_gather
    want = list(jax_pipe.run(pages, page_batch=2))
    got, wider = (list(TorchPagePipeline(*port_models(), device="cpu", want_logits=True,
                                         logits_topk=k, **PIPELINE).run(pages, page_batch=2))
                  for k in (topk, topk + 1))
    return pages, got, wider, want


@pytest.mark.parametrize("topk", [3, 8])
def test_top_k_logits_match_jax(noisy, topk):
    _, got, wider, want = _runs(noisy, topk)
    k = min(topk, len(CHARS))
    compared = 0
    for g, g1, w in zip(got, wider, want):
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.label_lengths, w.label_lengths)
        np.testing.assert_array_equal(g.crops_width, w.crops_width)
        assert g.logits_vals.dtype == w.logits_vals.dtype == np.float16
        assert g.logits_idx.dtype == w.logits_idx.dtype == np.uint16
        assert g.logits_vals.shape == w.logits_vals.shape == g.labels.shape + (k,)
        if k < len(CHARS):
            gap = g1.logits_vals[..., k - 1].astype(np.float32) - g1.logits_vals[..., k]
        else:
            gap = np.full(g.logits_vals.shape[:-1], np.inf, np.float32)
        n, t = g.labels.shape
        for i in range(n):
            for f in range(t):
                if gap[i, f] <= TOPK_GAP:
                    continue
                assert set(g.logits_idx[i, f]) == set(w.logits_idx[i, f]), (i, f)
                gv = g.logits_vals[i, f][np.argsort(g.logits_idx[i, f])].astype(np.float32)
                wv = w.logits_vals[i, f][np.argsort(w.logits_idx[i, f])].astype(np.float32)
                np.testing.assert_allclose(gv, wv, atol=VALUE_ATOL, rtol=VALUE_RTOL)
                compared += 1
    assert compared > 0.9 * sum(g.labels.size for g in got)


def _alto_words(xml):
    root = ET.fromstring(xml.encode("utf-8"))
    lines = []
    for line in root.iter(ALTO_NS + "TextLine"):
        lines.append([{k: s.get(k) for k in ("CONTENT", "HPOS", "VPOS", "WIDTH", "HEIGHT", "WC")}
                      for s in line.iter(ALTO_NS + "String")])
    return lines


def test_fast_path_logits_and_alto_match_jax(noisy):
    if jax_native_library() is None:
        pytest.skip("the JAX package's native library is unavailable")
    (flax_pn, pn_vars, flax_rec, rec_vars), port_models = noisy
    pages = [_page(), _page(shift=8, seed=1), _page(shift=-4, seed=2)]
    ids = [f"page-{i}" for i in range(3)]
    jax_pipe = TPUPagePipeline(flax_pn, pn_vars, flax_rec, rec_vars, transport="page",
                               want_logits=True, **PIPELINE)
    jax_pipe._stage_b_warp = jax_pipe._stage_b_warp_gather
    jax_fast = types.SimpleNamespace(characters=list(CHARS), net_subsampling=SUBSAMPLING)
    want = []
    for r in jax_pipe.run(pages, page_batch=2):
        want.append(jax_assemble(
            r, ids[r.page_index], pages[r.page_index].shape[:2], CHARS,
            line_hook=lambda line, i, r=r: JaxFastPagePipeline._attach_logits(
                jax_fast, line, r, i)))
    port = TorchPagePipeline(*port_models(), device="cpu", want_logits=True, **PIPELINE)
    got = list(FastPagePipeline(port, CHARS, page_batch=2).process_pages(pages, ids))

    words = 0
    for g, w in zip(got, want):
        g_lines, w_lines = list(g.lines_iterator()), list(w.lines_iterator())
        assert len(g_lines) == len(w_lines) >= 3
        for a, b in zip(g_lines, w_lines):
            assert a.transcription == b.transcription
            assert a.characters == b.characters == CHARS
            assert a.logit_coords == b.logit_coords and a.logit_coords[1] > 0
            assert a.logits.shape == b.logits.shape and a.logits.format == "csc"
        for route in (True, False):
            got_alto = _alto_words(g.to_altoxml_string(
                altoxml.create_ocr_processing_element(processing_datetime=DATETIME),
                native=route))
            want_alto = _alto_words(w.to_altoxml_string(
                jax_altoxml.create_ocr_processing_element(processing_datetime=DATETIME)))
            assert [[s["CONTENT"] for s in ln] for ln in got_alto] == [
                [s["CONTENT"] for s in ln] for ln in want_alto]
            for ga, wa in zip(got_alto, want_alto):
                for s, t in zip(ga, wa):
                    for key in ("HPOS", "VPOS", "WIDTH", "HEIGHT"):
                        assert abs(int(s[key]) - int(t[key])) <= BOX_PX, (key, s, t)
                    assert abs(float(s["WC"]) - float(t["WC"])) <= WC_TOL
                    words += 1
    assert words > 0
