"""The reference's TorchScript archives in the port
(``pero_ocr_tpu_torch/utils/ts_adapters.py``) against the JAX package's
interpretation of the same archives (``pero_ocr_tpu/utils/ts_adapters.py``
over ``ts_graph``), on the CPU.

The archives are traced here from the JAX tests' ``MiniUNet`` and
``MiniCTCNet`` families (tests/test_ts_graph.py) and saved as real
``.pt`` files: a ParseNet that returns ``(maps, extra)``, recognizers
that return ``(N, T, C)`` and, as the reference exports them,
``(N, C, T)``, and one with a writer-embedding input.  Held:

- the adapters' outputs within 2e-5 of JAX's (the JAX tests' own
  tolerance), at widths the probe never saw; the probed spec; the
  probe's errors, with the JAX messages;
- the device rewrite: a CPU trace's ``Device`` constants all name the
  target device after ``retarget_devices_`` (its run on the card is
  ``chip_smoke.py``'s);
- both engines (``CTCEngineLineOCR`` from an OCR JSON whose
  ``checkpoint`` is the archive, ``ParseNetWrapper`` from a
  ``MODEL_PATH`` archive): transcriptions equal, logits and maps within
  the JAX tests' 3e-5;
- ``TorchPagePipeline`` with both archives on the page and crop
  transports against ``TPUPagePipeline`` with the same archives: stage
  A's quantized heights and separator equal, its packed masks within
  MASK_FLIPS (float noise at a tie of the vertical maxima), and stage
  B's labels on a lines override equal (a random MiniUNet finds no
  lines);
- ``PageParser`` and ``FastPagePipeline`` on a config naming both
  archives: the JAX PageParser's Page XML.
"""

import configparser
import json
import os
import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.document.page_parser import PageParser as JaxPageParser
from pero_ocr_tpu.layout_engines.parsenet_wrapper import ParseNetWrapper as JaxParseNetWrapper
from pero_ocr_tpu.ocr.ctc_engine import CTCEngineLineOCR as JaxCTCEngine
from pero_ocr_tpu.parallel.pipeline import TPUPagePipeline
from pero_ocr_tpu.utils import ts_adapters as jax_ts
from pero_ocr_tpu_torch.core.layout import PageLayout
from pero_ocr_tpu_torch.document.fast_pipeline import FastPagePipeline
from pero_ocr_tpu_torch.document.page_parser import PageParser
from pero_ocr_tpu_torch.layout_engines.parsenet_wrapper import ParseNetWrapper
from pero_ocr_tpu_torch.ocr.ctc_engine import CTCEngineLineOCR
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.utils import ts_adapters
from tests.test_torch_cli import assert_xml_equal
from tests.test_torch_layout_stages import one_thread  # noqa: F401  (fixture)
from tests.test_torch_native import jax_native_library
from tests.test_ts_graph import MiniCTCNet, MiniUNet

ATOL = 2e-5
CHARS = list("abcdefghijk")  # 11 characters + the blank: 12 classes


class FramesLast(tnn.Module):
    """A recognizer exported as the reference exports it: (N, C, T)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return self.net(x).permute(0, 2, 1)


class EmbedCTC(MiniCTCNet):
    """MiniCTCNet with a writer embedding beside each frame's features."""

    def __init__(self, num_classes=12, embed_num=3):
        super().__init__(num_classes)
        self.embed = tnn.Embedding(embed_num + 1, 8)
        self.lstm = tnn.LSTM(56, 32, num_layers=2, batch_first=True, bidirectional=True)

    def forward(self, x, ids):
        x = torch.relu(self.collapse(self.convs(x))).squeeze(2).permute(0, 2, 1)
        e = self.embed(ids)[:, None, :].expand(-1, x.shape[1], -1)
        x, _ = self.lstm(torch.cat([x, e], dim=-1))
        return self.fc(x)


class Flat(tnn.Module):
    def forward(self, x):
        return x.mean(dim=(2, 3))


class Pooled(tnn.Module):
    """Logits whose length does not follow the width."""

    def forward(self, x):
        return x.mean(dim=(2, 3))[:, :, None].expand(-1, -1, 5)


class Stride3(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv2d(3, 12, (32, 3), stride=(1, 3))

    def forward(self, x):
        return self.conv(x)[:, :, 0].permute(0, 2, 1)


def _archive(module, example, path) -> str:
    torch.jit.trace(module.eval(), example).save(str(path))
    return str(path)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    root = tmp_path_factory.mktemp("ts")
    torch.manual_seed(0)
    unet = MiniUNet()
    with torch.no_grad():  # a baseline channel that crosses the threshold
        unet.head.bias[2] = 0.6
        unet.head.bias[3] = -0.2
    out = {"parsenet": _archive(unet, torch.rand(1, 3, 32, 32), root / "parsenet.pt"),
           "ntc": _archive(MiniCTCNet(num_classes=12), torch.rand(1, 3, 32, 64), root / "ntc.pt"),
           "nct": _archive(FramesLast(MiniCTCNet(num_classes=12)), torch.rand(1, 3, 32, 64),
                           root / "nct.pt"),
           "embed": _archive(EmbedCTC(), (torch.rand(1, 3, 32, 64), torch.zeros(1, dtype=torch.long)),
                             root / "embed.pt")}
    with open(root / "ocr.json", "w", encoding="utf-8") as f:
        json.dump({"characters": CHARS, "line_px_height": 32, "checkpoint": "nct.pt"}, f)
    out["root"] = root
    return out


def test_parsenet_adapter_matches_jax(archives):
    ours = ts_adapters.TSParseNetModel.load(archives["parsenet"], "cpu")
    theirs = jax_ts.TSParseNetModel.load(archives["parsenet"])
    assert ours.out_upsample == 1
    images = np.random.default_rng(0).random((2, 48, 64, 3)).astype(np.float32)
    with torch.inference_mode():
        got = ours(torch.from_numpy(images)).numpy()
    want = np.asarray(theirs.apply(theirs.variables, jnp.asarray(images)))
    assert got.shape == want.shape == (2, 48, 64, 5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("layout", ["ntc", "nct"])
def test_recognizer_adapter_matches_jax(archives, layout):
    ours = ts_adapters.TSRecognizerModel.load(archives[layout], "cpu", line_height=32)
    theirs = jax_ts.TSRecognizerModel.load(archives[layout], line_height=32)
    for key in ("num_classes", "line_height", "subsampling", "embed_num", "lstm_layers"):
        assert getattr(ours.spec, key) == getattr(theirs.spec, key)
    assert (ours.spec.num_classes, ours.spec.subsampling) == (12, 4)
    assert ours.spec.dtype == torch.float32
    images = np.random.default_rng(1).random((3, 32, 160, 3)).astype(np.float32)
    with torch.inference_mode():
        got = ours(torch.from_numpy(images)).numpy()
    want = np.asarray(theirs.apply(theirs.variables, jnp.asarray(images)))
    assert got.shape == want.shape == (3, 40, 12)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_recognizer_adapter_embed_input_matches_jax(archives):
    ours = ts_adapters.TSRecognizerModel.load(archives["embed"], "cpu", embed_num=3)
    theirs = jax_ts.TSRecognizerModel.load(archives["embed"], embed_num=3)
    assert ours.spec.embed_num == 3 and ours.spec.num_classes == 12
    images = np.random.default_rng(2).random((2, 32, 96, 3)).astype(np.float32)
    ids = np.array([2, 3])
    with torch.inference_mode():
        got = ours(torch.from_numpy(images), torch.from_numpy(ids)).numpy()
        default = ours(torch.from_numpy(images)).numpy()
    want = np.asarray(theirs.apply(theirs.variables, jnp.asarray(images), jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    want = np.asarray(theirs.apply(theirs.variables, jnp.asarray(images)))
    np.testing.assert_allclose(default, want, atol=ATOL, rtol=0)
    assert np.abs(got - default).max() > 1e-3  # the ids reach the logits


@pytest.mark.parametrize("module,text", [
    (Flat(), "expected 3-D frame logits"),
    (Pooled(), "cannot identify the frame axis"),
    (Stride3(), "non-integer width subsampling"),
], ids=["flat", "pooled", "stride3"])
def test_recognizer_probe_errors_match_jax(tmp_path, module, text):
    path = _archive(module, torch.rand(1, 3, 32, 96), tmp_path / "bad.pt")
    with pytest.raises(ValueError) as got:
        ts_adapters.TSRecognizerModel.load(path, "cpu")
    with pytest.raises(ValueError) as want:
        jax_ts.TSRecognizerModel.load(path)
    assert text in str(got.value) and str(got.value) == str(want.value)


def test_device_constants_are_retargeted(archives):
    """A CPU trace of an LSTM bakes the device of its zero initial state
    into the graph; the loader names the target device instead (CUDA
    here, without running it)."""
    module = torch.jit.load(archives["ntc"], map_location="cpu")
    before = ts_adapters.device_constants(module)
    assert before and set(before) == {"cpu"}
    assert ts_adapters.retarget_devices_(module, torch.device("cuda")) == len(before)
    assert set(ts_adapters.device_constants(module)) == {"cuda"}
    # On the CPU there is nothing to flatten; the archive still runs.
    loaded = ts_adapters.load_torchscript(archives["ntc"], "cpu")
    assert ts_adapters.flatten_rnn_weights_(loaded) == 0
    assert set(ts_adapters.device_constants(loaded)) == {"cpu"}
    # An archive runs on the device it was loaded for only.
    model = ts_adapters.TSParseNetModel(ts_adapters.load_torchscript(archives["parsenet"], "cpu"),
                                        "cpu")
    with pytest.raises(ValueError, match="loaded for cpu, called on meta"):
        model(torch.zeros((1, 32, 32, 3), device="meta"))


def test_ctc_engine_reads_the_archive_as_jax(archives, tmp_path):
    ours = CTCEngineLineOCR(str(archives["root"] / "ocr.json"), device="cpu")
    theirs = JaxCTCEngine(str(archives["root"] / "ocr.json"))
    assert isinstance(ours.model, ts_adapters.TSRecognizerModel)
    assert ours.net_subsampling == theirs.net_subsampling == 4
    assert ours.characters == theirs.characters and len(ours.characters) == 12
    rng = np.random.default_rng(3)
    lines = [rng.integers(0, 256, (32, w, 3), dtype=np.uint8) for w in (40, 100, 300, 120)]
    got = ours.process_lines(lines)
    want = theirs.process_lines(lines)
    assert got[0] == want[0] and any(got[0])
    assert got[2] == want[2]
    for a, b in zip(got[1], want[1]):
        assert np.abs(a.toarray() - b.toarray()).max() < 3e-5
    # The class count must fit the charset and the blank.
    with open(tmp_path / "wrong.json", "w", encoding="utf-8") as f:
        json.dump({"characters": CHARS[:-1], "line_px_height": 32,
                   "checkpoint": archives["nct"]}, f)
    with pytest.raises(ValueError, match="12 output classes but the OCR JSON charset"):
        CTCEngineLineOCR(str(tmp_path / "wrong.json"), device="cpu")


def test_parsenet_wrapper_reads_the_archive_as_jax(archives):
    ours = ParseNetWrapper(archives["parsenet"], downsample=2, adaptive_downsample=False,
                           device="cpu")
    theirs = JaxParseNetWrapper(archives["parsenet"], downsample=2, adaptive_downsample=False)
    assert isinstance(ours.model, ts_adapters.TSParseNetModel)
    img = np.random.default_rng(4).integers(0, 255, (100, 120, 3), dtype=np.uint8)
    for ds in (2, 3):
        got, want = ours.get_maps(img, ds), theirs.get_maps(img, ds)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)


# ----------------------------------------------------------------------
# the fast path
LINES = [np.array([[20.0, 60.0], [200.0, 62.0]]), np.array([[30.0, 140.0], [230.0, 136.0]]),
         np.array([[15.0, 200.0], [120.0, 205.0], [240.0, 201.0]])]
HEIGHTS = [[20.0, 7.0], [18.0, 6.0], [21.0, 8.0]]
KWARGS = dict(downsample=4, crop_height=32, crop_bucket=256, line_slot=4,
              cluster_paragraphs=False)


def _fast_pages():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (256, 320, 3), dtype=np.uint8) for _ in range(3)]


def _jax_pipe(archives, **kwargs):
    pn = jax_ts.TSParseNetModel.load(archives["parsenet"])
    rec = jax_ts.TSRecognizerModel.load(archives["nct"], line_height=32)
    pipe = TPUPagePipeline(pn, pn.variables, rec, rec.variables, **KWARGS, **kwargs)
    if kwargs.get("transport", "page") == "page":
        pipe._stage_b_warp = pipe._stage_b_warp_gather  # the exact warp (test_torch_pipeline)
    return pipe


def _port_pipe(archives, **kwargs):
    return TorchPagePipeline(ts_adapters.TSParseNetModel.load(archives["parsenet"], "cpu"),
                             ts_adapters.TSRecognizerModel.load(archives["nct"], "cpu"),
                             device="cpu", native=kwargs.get("transport") == "crops",
                             **KWARGS, **kwargs)


# The baseline mask is the vertical maxima of the smoothed baseline
# channel over the threshold; the two packages' float32 convolutions
# (XLA's, torch's) differ by ~1e-6, which can flip a pixel where two
# rows tie.  Measured on these pages (CPU): 0 of 14,808 mask pixels at
# ds 2, 1 of 5,207 at ds 4; held to MASK_FLIPS of the pixels.
MASK_FLIPS = 0.001


def test_stage_a_artifacts_match_jax(archives):
    pages = _fast_pages()
    ours, theirs = _port_pipe(archives), _jax_pipe(archives)
    grays = np.stack([TorchPagePipeline._gray(p) for p in pages])
    for ds in (2, 4):
        want = [np.asarray(a) for a in theirs._stage_a(jnp.asarray(grays), ds)]
        got = [a.numpy() for a in ours.stage_a(torch.from_numpy(grays), ds)]
        assert len(got) == len(want) == 3
        masks = [np.unpackbits(a[0], bitorder="little") for a in (got, want)]
        assert masks[1].sum() > 1000  # the biased maps pass the threshold widely
        assert (masks[0] != masks[1]).sum() <= MASK_FLIPS * masks[1].sum()
        for g, w in zip(got[1:], want[1:]):  # quantized heights, separator nibbles
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("transport", ["page", "crops"])
def test_stage_b_labels_match_jax(archives, transport):
    if transport == "crops" and (shutil.which(os.environ.get("CXX") or "c++") is None
                                 or jax_native_library() is None):
        pytest.skip("no host C++ compiler or the JAX package's native library is unavailable")
    pages = _fast_pages()
    override = [(LINES, HEIGHTS)] * len(pages)
    kwargs = {"transport": transport, "transport_bits": 8}
    want = list(_jax_pipe(archives, **kwargs).run(pages, lines_override=override, page_batch=2))
    got = list(_port_pipe(archives, **kwargs).run(pages, lines_override=override, page_batch=2))
    assert [r.page_index for r in got] == [r.page_index for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.crops_width, w.crops_width)
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.label_lengths, w.label_lengths)
        np.testing.assert_allclose(g.confidences, w.confidences, atol=1e-5, rtol=0)
    assert any(int(n) > 0 for r in got for n in r.label_lengths)


INI = """[PAGE_PARSER]
RUN_LAYOUT_PARSER = yes
RUN_LINE_CROPPER = yes
RUN_OCR = yes

[LAYOUT_PARSER_1]
METHOD = LAYOUT_CNN
MODEL_PATH = ./parsenet.pt
DOWNSAMPLE = 4
ADAPTIVE_DOWNSAMPLE = no

[LINE_CROPPER]
LINE_HEIGHT = 32

[OCR]
OCR_JSON = ./ocr.json
"""


def test_page_parser_and_fast_path_run_the_archives(archives):
    root = archives["root"]
    (root / "config.ini").write_text(INI)
    config = configparser.ConfigParser()
    config.read(root / "config.ini")
    ours = PageParser(config, device="cpu", config_path=str(root))
    theirs = JaxPageParser(config, config_path=str(root))
    pages = _fast_pages()
    for i, page in enumerate(pages):
        random.seed(i)
        got = ours.process_page(page, PageLayout(id=f"p{i}", page_size=page.shape[:2]))
        random.seed(i)
        want = theirs.process_page(page, JaxPageLayout(id=f"p{i}", page_size=page.shape[:2]))
        assert_xml_equal(got.to_pagexml_string(), want.to_pagexml_string())
    assert FastPagePipeline.unsupported_features(ours) == []
    for transport in ("page", "crops"):
        fast = FastPagePipeline.from_page_parser(ours, transport=transport,
                                                 transport_bits=8)
        assert isinstance(fast.pipeline.parsenet, ts_adapters.TSParseNetModel)
        assert fast.net_subsampling == 4
        layouts = list(fast.process_pages(pages, ["a", "b", "c"]))
        assert [lay.id for lay in layouts] == ["a", "b", "c"]
        for lay in layouts:
            assert lay.to_pagexml_string().startswith("<?xml")
