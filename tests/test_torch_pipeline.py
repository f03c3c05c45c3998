"""Slice parity: TorchPagePipeline(device="cpu") against
TPUPagePipeline(transport="page") on the same pages and weights, in
float32.

The detector is a tiny ParseNet with the super-resolving head (maps at
twice the canvas resolution, as the bench builds it) trained with the
JAX trainer to find the test page's lines, and cached under its own key in ~/.cache/pero_test_ckpt/; the
recognizer has random weights.  The JAX side runs its exact gather
warp (``_stage_b_warp_gather``), the operation the port's kernel
computes; stage B looks the program up at call time, so the attribute
is set on the instance.

Held to: the same number of lines per page, baselines within 1e-4 px,
equal heights, equal labels and lengths, confidences within 1e-4.  To
Page XML (JAX's ``assemble_page_layout`` and lxml writer against the
port's ``FastPagePipeline``): the same paragraph clusters and the same
Page XML text apart from the Created and LastChange timestamps.

Under a mesh of 2 and 8 CPU replicas (fixed lines, page batch 8, on the
page transport, the crop transport and the recognize-only loop): labels,
lengths and confidences equal to the run without a mesh, and to JAX's
``TPUPagePipeline(mesh=make_mesh(8, tp=1))`` within the tolerances
above (confidences within 1e-4 on the page transport, 1e-5 on the
crops); with CNN detection and the adaptive downsample, whose corrected
scale sticks from the first batch on, equal to the run without a mesh
(the median is taken over the whole batch, not a shard).
"""

import fcntl
import hashlib
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pero_ocr_tpu.models.parsenet import ParseNet as FlaxParseNet
from pero_ocr_tpu.models.recognizer import (
    CTCRecognizer as FlaxRecognizer,
    RecognizerSpec as FlaxSpec,
)
from pero_ocr_tpu.document.fast_pipeline import assemble_page_layout as jax_assemble
from pero_ocr_tpu.parallel import mesh as jax_mesh
from pero_ocr_tpu.parallel.pipeline import TPUPagePipeline
from pero_ocr_tpu_torch.document.fast_pipeline import FastPagePipeline, assemble_page_layout
from pero_ocr_tpu_torch.models.parsenet import ParseNet
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.parallel.mesh import Mesh, make_mesh
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.utils import native as native_port
from pero_ocr_tpu_torch.utils.convert import (
    parsenet_params_from_flax,
    recognizer_params_from_flax,
)
from tests.test_torch_native import jax_native_library

LINES = [(64 + 40 * r, 32, 288) for r in range(4)]
DETECTOR = dict(base_features=8, depth=2, out_upsample=2)
RECOGNIZER = dict(num_classes=8, line_height=16, conv_features=(4, 8),
                  subsampling=2, lstm_layers=1, lstm_features=8)
PIPELINE = dict(downsample=4, crop_height=16, crop_bucket=256, line_slot=8)
# The recognizer's 8 classes as text, blank last: random weights emit
# every character that Page XML escapes.
CHARS = ["&", "<", ">", '"', "'", "ž", "a", "\u200b"]


def _page(shift=0, seed=0):
    rng = np.random.default_rng(seed)
    page = rng.integers(235, 250, (256, 320, 3), dtype=np.uint8)
    for y, x0, x1 in LINES:
        y += shift
        page[y - 12: y - 2, x0:x1] = rng.integers(20, 60, (10, x1 - x0, 3))
    return page


def _train_detector(model):
    """JAX-trained detector whose maps live at ds 4 (the SR head reads
    the ds-8 canvas), cached under ~/.cache/pero_test_ckpt.  One test
    process trains it (a file lock); the others wait and load it."""
    from pero_ocr_tpu.parallel import train as train_lib
    from pero_ocr_tpu.utils.checkpoint import load_variables, save_variables

    args = (jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    key = hashlib.sha1(b"torch-port-slice1-detector-v1").hexdigest()[:16]
    cache = os.path.expanduser(f"~/.cache/pero_test_ckpt/torchslice_{key}.ckpt")

    def cached():
        try:  # the variables' structure is all the load needs: no init run
            return jax.tree_util.tree_map(np.asarray, load_variables(
                cache, jax.eval_shape(model.init, *args)))
        except (OSError, ValueError):
            return None

    if os.path.exists(cache) and (variables := cached()) is not None:
        return variables
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    with open(cache + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(cache) and (variables := cached()) is not None:
            return variables
        template = model.init(*args)
        gray = _page()[:, :, 0].astype(np.float32)
        canvas = np.zeros((64, 64), np.float32)
        canvas[:32, :40] = gray.reshape(32, 8, 40, 8).mean(axis=(1, 3))
        tgt = np.zeros((128, 128, 5), np.float32)
        for y, x0, x1 in LINES:
            ym, xa, xb = y // 4, x0 // 4, x1 // 4
            tgt[ym, xa:xb, 2] = 1.0
            tgt[max(ym - 3, 0): ym + 1, xa:xb, 0] = 3.0
            tgt[max(ym - 3, 0): ym + 1, xa:xb, 1] = 1.0
            tgt[ym, xa, 3] = 1.0
            tgt[ym, xb - 1, 3] = 1.0
        x = jnp.asarray(np.repeat(canvas[:, :, None], 3, 2)[None] / 255.0)
        t = jnp.asarray(tgt[None])
        optimizer = train_lib.make_optimizer(5e-3)
        state = train_lib.TrainState(template, optimizer.init(template), jnp.zeros((), jnp.int32))
        step = jax.jit(train_lib.make_parsenet_train_step(model, optimizer, height_weight=0.05))
        for _ in range(400):
            state, loss = step(state, x, t)
        assert float(loss) < 0.1, f"detector failed to train: {loss}"
        save_variables(state.params, cache + ".tmp")
        os.replace(cache + ".tmp", cache)  # whole, for readers that take no lock
    return state.params


@pytest.fixture(scope="module")
def models():
    flax_pn = FlaxParseNet(dtype=jnp.float32, **DETECTOR)
    pn_vars = _train_detector(flax_pn)
    flax_rec = FlaxRecognizer(FlaxSpec(dtype=jnp.float32, **RECOGNIZER))
    rec_vars = flax_rec.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 64, 3)))
    np_tree = lambda v: jax.tree_util.tree_map(np.asarray, v)  # noqa: E731
    pn_state = parsenet_params_from_flax(np_tree(pn_vars))
    rec_state = recognizer_params_from_flax(np_tree(rec_vars))

    def torch_models():
        pn = ParseNet(dtype=torch.float32, **DETECTOR)
        pn.load_state_dict(pn_state)
        rec = CTCRecognizer(RecognizerSpec(dtype=torch.float32, **RECOGNIZER))
        rec.load_state_dict(rec_state)
        return pn, rec

    return (flax_pn, pn_vars, flax_rec, rec_vars), torch_models


def _override(page):
    b = [np.array([[x0 - 4.0, y + 0.5], [(x0 + x1) / 2, y + 3.0], [x1 + 4.0, y - 1.5]])
         for y, x0, x1 in LINES]
    return b, [[10.0, 4.0]] * len(b)


CASES = {
    "cnn_8bit": dict(kwargs={}, override=None, page_batch=2),
    "cnn_4bit": dict(kwargs={"transport_bits": 4}, override=None, page_batch=2),
    # One batch: the JAX loop reads the sticky scale for batch i+1 on
    # its worker thread, racing batch i's correction.
    "cnn_adaptive": dict(kwargs={"adaptive_downsample": True}, override=None, page_batch=3),
    "override_callable": dict(kwargs={}, override="callable", page_batch=2),
    "override_sequence_4bit": dict(kwargs={"transport_bits": 4}, override="sequence",
                                   page_batch=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_page_pipeline_matches_jax(models, case):
    (flax_pn, pn_vars, flax_rec, rec_vars), torch_models = models
    spec = CASES[case]
    pages = [_page(), _page(shift=8, seed=1), _page(shift=-4, seed=2)]
    override = {
        None: None, "callable": _override, "sequence": [_override(p) for p in pages],
    }[spec["override"]]

    jax_pipe = TPUPagePipeline(
        flax_pn, pn_vars, flax_rec, rec_vars, transport="page",
        cluster_paragraphs=False, **PIPELINE, **spec["kwargs"],
    )
    jax_pipe._stage_b_warp = jax_pipe._stage_b_warp_gather
    want = list(jax_pipe.run(pages, lines_override=override, page_batch=spec["page_batch"]))
    pn, rec = torch_models()
    port = TorchPagePipeline(pn, rec, device="cpu", **PIPELINE, **spec["kwargs"])
    got = list(port.run(pages, lines_override=override, page_batch=spec["page_batch"]))

    assert [r.page_index for r in got] == [r.page_index for r in want] == [0, 1, 2]
    adaptive = spec["kwargs"].get("adaptive_downsample", False)
    if spec["override"] is None and not adaptive:
        assert [len(r.baselines) for r in want] == [len(LINES)] * 3, "detector lost lines"
    for g, w in zip(got, want):
        assert len(g.baselines) == len(w.baselines)
        for bg, bw in zip(g.baselines, w.baselines):
            np.testing.assert_allclose(bg, bw, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(np.asarray(g.heights), np.asarray(w.heights))
        np.testing.assert_array_equal(g.crops_width, w.crops_width)
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.label_lengths, w.label_lengths)
        np.testing.assert_allclose(g.confidences, w.confidences, atol=1e-4, rtol=0)
    if adaptive:
        # The toy detector's ascenders fall outside the [9, 15] band:
        # both sides re-run stage A at the same corrected scale.
        assert port._last_ds == jax_pipe._last_ds != PIPELINE["downsample"]


def _masked(xml):
    return re.sub(r"<(Created|LastChange)>[^<]*</\1>", r"<\1/>", xml)


# The JAX pipeline clusters through its native library; its Python
# fallback rounds the penalty windows differently (ROADMAP.md, section 3).
@pytest.mark.skipif(jax_native_library() is None, reason="native library unavailable")
@pytest.mark.parametrize("case", ["cnn_8bit", "cnn_4bit", "cnn_adaptive", "override_callable"])
def test_page_xml_matches_jax(models, case):
    """The main path to Page XML: CNN detection, paragraph clustering,
    recognition, alpha-shape regions, Page XML.  The override case has
    no clusters: all its lines go into one region."""
    _page_xml_against_jax(models, case)


# The port's C++ route (its own build of the host library) on the CPU.
@pytest.mark.skipif(jax_native_library() is None or shutil.which(os.environ.get("CXX") or "c++")
                    is None, reason="no host C++ compiler")
@pytest.mark.parametrize("case", ["cnn_8bit", "cnn_4bit", "cnn_adaptive"])
def test_page_xml_matches_jax_on_the_native_route(models, case):
    calls = native_port.calls["cc_label_u8"], native_port.calls["cc_baselines_f32"]
    _page_xml_against_jax(models, case, native=True)
    assert native_port.calls["cc_label_u8"] > calls[0]
    assert native_port.calls["cc_baselines_f32"] > calls[1]


def _top_border_artifacts(port, pages):
    """Stage A's artifacts for ``pages`` (one batch) with two lines
    added at the top of the first page's map: A from row 1, x 10 and B
    from row 0, x 40.  B comes first in the mask's raster order (the
    order of ``cc_lines_packed``), A first after the (5, 3) connection
    dilation clamps both to row 0 (scipy's order)."""
    stack = torch.from_numpy(port._stack_grays(port._gray(p) for p in pages))
    packed, heights_q, sep_q = (t.cpu().numpy().copy() for t in port.stage_a(stack, 4))
    bits = np.unpackbits(packed[0], axis=1, bitorder="little")
    bits[:4] = 0
    bits[1, 10:30] = 1
    bits[0, 40:60] = 1
    packed[0] = np.packbits(bits, axis=1, bitorder="little")
    heights_q[0, 0] = (40, 12)  # 10 px up, 3 px down
    return packed, heights_q, sep_q


@pytest.mark.skipif(jax_native_library() is None or shutil.which(os.environ.get("CXX") or "c++")
                    is None, reason="no host C++ compiler")
@pytest.mark.parametrize("route", [True, False], ids=["native", "numpy"])
def test_page_xml_matches_jax_with_lines_at_the_top_border(models, route):
    """Lines whose components reach the top map rows, where
    ``cc_lines_packed``'s numbering and scipy's differ: with the same
    stage-A artifacts on both sides, the Page XML equals the JAX page
    transport's on both host routes."""
    _, torch_models = models
    pn, rec = torch_models()
    port = TorchPagePipeline(pn, rec, device="cpu", native=route, **PIPELINE)
    pages = [_page(), _page(shift=8, seed=1)]
    packed, heights_q, sep_q = _top_border_artifacts(port, pages)
    hf = packed.shape[1] // heights_q.shape[1]
    by_mask_pixel = native_port.native_cc_lines_packed(packed[0], heights_q[0], hf)
    masks, connecteds, heights_maps, _ = port._unpack_stage_a(packed, heights_q, sep_q)
    by_label, _ = port._lines_from_masks(masks[0], connecteds[0], heights_maps[0], 1)
    assert [b[0, 0] for b in by_label[:2]] == [8.0, 38.0]
    assert [p[0, 0] for p in by_mask_pixel[0][:2]] == [38.0, 8.0]
    _page_xml_against_jax(models, "cnn_8bit", native=route, stage_a=(packed, heights_q, sep_q))


def _page_xml_against_jax(models, case, native=None, stage_a=None):
    """``native``: the port's host route.  ``stage_a``: numpy (packed,
    heights_q, sep_q) that stage A returns on both sides for every batch
    in place of the detector's."""
    (flax_pn, pn_vars, flax_rec, rec_vars), torch_models = models
    spec = CASES[case]
    pages = [_page(), _page(shift=8, seed=1), _page(shift=-4, seed=2)]
    ids = [f"page-{i}" for i in range(len(pages))]
    override = _override if spec["override"] else None

    jax_pipe = TPUPagePipeline(
        flax_pn, pn_vars, flax_rec, rec_vars, transport="page",
        cluster_paragraphs=True, **PIPELINE, **spec["kwargs"],
    )
    jax_pipe._stage_b_warp = jax_pipe._stage_b_warp_gather
    if stage_a is not None:
        jax_pipe._stage_a = lambda stack, ds: stage_a
    want_results = list(jax_pipe.run(pages, lines_override=override,
                                     page_batch=spec["page_batch"]))
    want = [jax_assemble(r, ids[r.page_index], pages[r.page_index].shape[:2], CHARS)
            for r in want_results]

    pn, rec = torch_models()
    port = TorchPagePipeline(pn, rec, device="cpu", native=native, **PIPELINE,
                             **spec["kwargs"])
    if stage_a is not None:
        port.stage_a = lambda stack, ds: tuple(torch.from_numpy(a) for a in stage_a)
    if override is None:
        got = list(FastPagePipeline(port, CHARS, page_batch=spec["page_batch"])
                   .process_pages(pages, ids))
    else:
        got = [assemble_page_layout(r, ids[r.page_index], pages[r.page_index].shape[:2], CHARS)
               for r in port.run(pages, lines_override=override,
                                 page_batch=spec["page_batch"])]

    assert [lay.id for lay in got] == ids
    for g, w, result in zip(got, want, want_results):
        clusters = [None] * len(result.baselines)
        for region in g.regions:
            for line in region.lines:
                clusters[line.index] = int(region.id[1:]) - 1
        if override is None:
            assert clusters == result.clusters
        else:
            assert result.clusters is None and len(g.regions) == 1
            assert len(g.regions[0].lines) == len(LINES)
        assert _masked(g.to_pagexml_string()) == _masked(w.to_pagexml_string())
    assert any(line.transcription for lay in got for line in lay.lines_iterator())


def test_unported_options_raise(models):
    """No option is left unported: a mesh builds (its page batches must
    split over dp; the mesh tests below run it); the refusals are
    the JAX pipeline's own checks, with its messages."""
    (flax_pn, pn_vars, flax_rec, rec_vars), torch_models = models
    pn, rec = torch_models()
    meshed = TorchPagePipeline(pn, rec, device="cpu", mesh=make_mesh(2, device_type="cpu"))
    assert meshed.shard_devices == [torch.device("cpu")] * 2 and meshed.device.type == "cpu"
    with pytest.raises(ValueError, match="must be a multiple of the mesh's dp size 2"):
        list(meshed.run([_page()], page_batch=3))
    with pytest.raises(ValueError, match="must be a multiple of the mesh's dp size 2"):
        FastPagePipeline(meshed, CHARS, page_batch=3)
    with pytest.raises(ValueError, match="neither a CTCRecognizer nor a transformer"):
        TorchPagePipeline(pn, torch.nn.Linear(1, 1), device="cpu")
    for kwargs in ({"transport": "ribbon"}, {"transport_bits": 2},
                   {"transport": "crops", "transport_bits": 3}, {"canvas_bits": 4},
                   {"transport": "crops", "canvas_bits": 3}):
        with pytest.raises(ValueError) as got:
            TorchPagePipeline(pn, rec, device="cpu", **kwargs)
        with pytest.raises(ValueError) as want:
            TPUPagePipeline(flax_pn, pn_vars, flax_rec, rec_vars, **kwargs)
        assert str(got.value) == str(want.value)
    pipe = TorchPagePipeline(pn, rec, device="cpu")
    with pytest.raises(ValueError, match="lines_override sequence length"):
        list(pipe.run([_page()], lines_override=[]))
    with pytest.raises(ValueError, match="skip_stage_a requires transport='crops'"):
        list(pipe.run([_page()], lines_override=_override, skip_stage_a=True))
    pipe.prime([_page()])  # a no-op on the page transport, as in JAX
    assert getattr(pipe, "_primed", None) is None
    with pytest.raises(ValueError, match="re-OCR runs on the crop transport"):
        FastPagePipeline(pipe, CHARS, reocr=True)
    crops = TorchPagePipeline(pn, rec, device="cpu", transport="crops")
    with pytest.raises(ValueError, match="skip_stage_a requires"):
        list(crops.run([_page()], skip_stage_a=True))
    fast = FastPagePipeline(crops, CHARS, reocr=True)
    with pytest.raises(ValueError, match="pages and layouts must align"):
        list(fast.process_existing_layouts([_page()], []))


@pytest.mark.skipif(jax_native_library() is None or shutil.which(os.environ.get("CXX") or "c++")
                    is None, reason="no host C++ compiler")
def test_adaptive_decision_matches_jax_on_the_slice_pages(models):
    """On the slice pages' stage A, at every first-pass scale, the
    port's decision from the unpacked maps equals the JAX page
    transport's, and the JAX crop transport's from the port's
    ``cc_lines_packed`` histograms."""
    (flax_pn, pn_vars, flax_rec, rec_vars), torch_models = models
    pn, rec = torch_models()
    pages = [_page(), _page(shift=8, seed=1), _page(shift=-4, seed=2)]
    pipe = TorchPagePipeline(pn, rec, device="cpu", adaptive_downsample=True, **PIPELINE)
    jax_pipe = TPUPagePipeline(flax_pn, pn_vars, flax_rec, rec_vars, transport="page",
                               adaptive_downsample=True, **PIPELINE)
    stack = torch.from_numpy(pipe._stack_grays(pipe._gray(p) for p in pages))
    decided = []
    for ds in (1, 2, 4, 8):
        packed, heights_q, sep_q = (t.cpu().numpy() for t in pipe.stage_a(stack, ds))
        pipe._last_ds = PIPELINE["downsample"]
        got = (pipe._adapt_target_ds(pipe._unpack_stage_a(packed, heights_q, sep_q), ds),
               pipe._last_ds)
        hf = packed.shape[1] // heights_q.shape[1]
        stats = [native_port.native_cc_lines_packed(packed[s], heights_q[s], hf)
                 for s in range(len(pages))]
        for from_stats in (True, False):
            jax_pipe._last_ds = PIPELINE["downsample"]
            want = (jax_pipe._adapt_from_stats(sum(o[4] for o in stats),
                                               sum(o[5] for o in stats), ds) if from_stats
                    else jax_pipe._adapt_target_ds(
                        jax_pipe._unpack_stage_a(packed, heights_q, sep_q), ds),
                    jax_pipe._last_ds)
            assert got == want
        decided.append(got[0])
    assert any(d is not None for d in decided)


# ----------------------------------------------------------------------
# Under a mesh: page batches split over dp (counterpart of
# tests/test_pipeline.py's mesh case)

MESH_PAGES = [_page(shift=s, seed=i) for i, s in enumerate((0, 8, -4, 4, -8, 2, 6, -2))]


def _assert_same(got, want, conf_atol):
    assert [r.page_index for r in got] == [r.page_index for r in want] == list(range(8))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.crops_width, w.crops_width)
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.label_lengths, w.label_lengths)
        np.testing.assert_allclose(g.confidences, w.confidences, atol=conf_atol, rtol=0)


@pytest.mark.skipif(jax_native_library() is None or shutil.which(os.environ.get("CXX") or "c++")
                    is None, reason="no host C++ compiler or JAX native library")
@pytest.mark.parametrize("loop", ["page", "crops", "recognize_only"])
def test_pipeline_under_a_mesh_matches_one_device_and_jax(models, loop):
    (flax_pn, pn_vars, flax_rec, rec_vars), torch_models = models
    kwargs = dict(PIPELINE, transport="page" if loop == "page" else "crops",
                  cluster_paragraphs=False)
    skip = loop == "recognize_only"
    override = [_override(p) for p in MESH_PAGES]
    jmesh = jax_mesh.make_mesh(8, tp=1)
    with jmesh:
        jax_pipe = (TPUPagePipeline(None, None, flax_rec, rec_vars, mesh=jmesh, **kwargs) if skip
                    else TPUPagePipeline(flax_pn, pn_vars, flax_rec, rec_vars, mesh=jmesh,
                                         **kwargs))
        jax_pipe._stage_b_warp = jax_pipe._stage_b_warp_gather
        want = list(jax_pipe.run(MESH_PAGES, lines_override=override, page_batch=8,
                                 skip_stage_a=skip))
    runs = {}
    for dp in (1, 2, 8):
        pn, rec = torch_models()
        mesh = None if dp == 1 else make_mesh(dp, device_type="cpu")
        port = TorchPagePipeline(None if skip else pn, rec, device="cpu", native=True, mesh=mesh,
                                 **kwargs)
        assert len(port.shard_devices) == dp
        runs[dp] = list(port.run(MESH_PAGES, lines_override=override, page_batch=8,
                                 skip_stage_a=skip))
    for dp in (2, 8):
        _assert_same(runs[dp], runs[1], 0.0)
    _assert_same(runs[8], want, 1e-4 if loop == "page" else 1e-5)
    assert any(r.label_lengths.any() for r in want)


@pytest.mark.parametrize("transport", ["page", "crops"])
def test_adaptive_downsample_under_a_mesh_equals_one_device(models, transport):
    """CNN detection with the adaptive downsample on 6 pages, page batch
    2, over 2 CPU replicas: the first batch moves the sticky scale, the
    later ones start from it; every result equals the run without a
    mesh."""
    _, torch_models = models
    pages = [_page(shift=s, seed=i) for i, s in enumerate((0, 8, -4, 4, -8, 2))]
    runs, scales = {}, {}
    for dp in (1, 2):
        pn, rec = torch_models()
        port = TorchPagePipeline(
            pn, rec, device="cpu", transport=transport, adaptive_downsample=True,
            mesh=None if dp == 1 else make_mesh(dp, device_type="cpu"), **PIPELINE)
        runs[dp] = list(port.run(pages, page_batch=2))
        scales[dp] = port._last_ds
    assert scales[2] == scales[1] != PIPELINE["downsample"]
    assert [r.page_index for r in runs[2]] == list(range(6))
    for g, w in zip(runs[2], runs[1]):
        assert len(g.baselines) == len(w.baselines)
        for bg, bw in zip(g.baselines, w.baselines):
            np.testing.assert_array_equal(bg, bw)
        assert g.heights == w.heights and g.clusters == w.clusters
        for a, b in ((g.labels, w.labels), (g.label_lengths, w.label_lengths),
                     (g.confidences, w.confidences)):
            np.testing.assert_array_equal(a, b)




def test_replicas_on_a_second_device(models):
    """A mesh whose second dp row is another device (``cpu:1``, which the
    mesh keeps apart from ``cpu``): that row gets its own replica of both
    models, equal in weights and apart in storage, ``_models`` picks a
    shard's models by its device, and the run equals the one-device run.
    On the CPU every tensor lands on ``cpu``, so the run itself goes
    through the first row's models; a card's second device takes its
    replica."""
    _, torch_models = models
    second = torch.device("cpu", 1)
    pn, rec = torch_models()
    port = TorchPagePipeline(pn, rec, device="cpu", mesh=Mesh([["cpu"], [second]]), **PIPELINE)
    assert port.shard_devices == [torch.device("cpu"), second]
    assert list(port._replicas) == [second] and set(port._255s) == {torch.device("cpu"), second}
    assert port._models(torch.device("cpu")) == (port.parsenet, port.recognizer)
    replica = port._models(second)
    for mine, theirs in zip(replica, (port.parsenet, port.recognizer)):
        assert mine is not theirs
        for (name, a), b in zip(mine.state_dict().items(), theirs.state_dict().values()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), name
    pages = MESH_PAGES[:4]
    override = [_override(p) for p in pages]
    got = list(port.run(pages, lines_override=override, page_batch=4))
    pn, rec = torch_models()
    want = list(TorchPagePipeline(pn, rec, device="cpu", **PIPELINE).run(
        pages, lines_override=override, page_batch=4))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.confidences, w.confidences)
