"""Stage B's transformer branch (``TorchPagePipeline`` with a
``TransformerOCR`` or ``RefTransformerOCR`` recognizer) against the JAX
``TPUPagePipeline``'s on the CPU, on both transports.

The models are tests/test_torch_transformer.py's pairs (float32, the
flax variables or the converted state dict carried across); the
detector is tests/test_torch_pipeline.py's toy trained one.  The JAX
page transport runs its exact gather warp; the crop transports warp on
the host (the port's C++, equal to the JAX library's bytes).

Held to: equal tokens (labels, the same dtype: int32 on the page
transport, uint8 on the crop transport where every id fits a byte) and
lengths; confidences within 1e-5; Page XML from the fast path's
assembly (the reference model's two specials dropped from the text)
equal to the JAX assembly's.
"""

import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from pero_ocr_tpu.document.fast_pipeline import assemble_page_layout as jax_assemble
from pero_ocr_tpu.parallel.pipeline import TPUPagePipeline
from pero_ocr_tpu_torch.document.fast_pipeline import FastPagePipeline
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from tests.test_torch_native import jax_native_library
from tests.test_torch_pipeline import PIPELINE, _override, _page
from tests.test_torch_pipeline import models  # noqa: F401  (fixture)
from tests.test_torch_transformer import _native_pair, one_torch_thread  # noqa: F401
from tests.test_torch_transformer import ref_pair  # noqa: F401  (fixture)

pytestmark = pytest.mark.skipif(
    shutil.which(os.environ.get("CXX") or "c++") is None or jax_native_library() is None,
    reason="no host C++ compiler or the JAX package's native library is unavailable")

CONF_ATOL = 1e-5
# The native pair's 9 characters; the reference pair's 10 and its two
# specials (12 symbols).
NATIVE_CHARS = list("abcdefghi")
REF_CHARS = list("abcdefghij") + ["\u200b", ""]


@pytest.fixture(scope="module")
def native_pair():
    return _native_pair(jnp.float32)


def _pipes(models, pair, transport):
    (flax_pn, pn_vars, _, _), torch_models = models
    ours, theirs, variables = pair
    kwargs = dict(PIPELINE, transport=transport, transport_bits=8 if transport == "page" else 4)
    jax_pipe = TPUPagePipeline(flax_pn, pn_vars, theirs, variables, **kwargs)
    jax_pipe._stage_b_warp = jax_pipe._stage_b_warp_gather
    port = TorchPagePipeline(torch_models()[0], ours, device="cpu", native=True, **kwargs)
    return jax_pipe, port


@pytest.mark.parametrize("transport", ["page", "crops"])
@pytest.mark.parametrize("family", ["native", "reference"])
def test_transformer_stage_b_matches_jax(models, native_pair, ref_pair, family, transport):
    pair, chars = ((native_pair, NATIVE_CHARS) if family == "native" else (ref_pair, REF_CHARS))
    jax_pipe, port = _pipes(models, pair, transport)
    assert port.is_transformer and port.is_ref_transformer == (family == "reference")
    pages = [_page(), _page(shift=8, seed=1), _page(shift=-4, seed=2)]
    # The CNN lines on the page transport, the override on the crops.
    override = _override if transport == "crops" else None
    want = list(jax_pipe.run(pages, lines_override=override, page_batch=2))
    got = list(port.run(pages, lines_override=override, page_batch=2))
    assert [r.page_index for r in got] == [r.page_index for r in want] == [0, 1, 2]
    for g, w in zip(got, want):
        assert len(g.baselines) == len(w.baselines) == 4
        assert g.labels.dtype == w.labels.dtype
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.label_lengths, w.label_lengths)
        np.testing.assert_allclose(g.confidences, w.confidences, atol=CONF_ATOL, rtol=0)
        # Steps: max(8, min(crop_bucket // 4, the model's cap)).
        assert g.labels.shape[1] == (31 if family == "reference" else 32)
    if transport == "page":
        ids = [f"p{i}" for i in range(3)]
        n_emit = len(chars) - (2 if family == "reference" else 0)
        fast = FastPagePipeline(port, chars, page_batch=2)
        assert fast._n_emit == n_emit
        mask = re.compile(r"<(Created|LastChange)>[^<]*</\1>")
        for lay, result in zip(fast.process_pages(pages, ids), want):
            theirs = jax_assemble(result, ids[result.page_index], pages[0].shape[:2], chars,
                                  n_emit=n_emit)
            assert mask.sub("", lay.to_pagexml_string()) == mask.sub(
                "", theirs.to_pagexml_string())
            assert all(line.transcription for line in lay.lines_iterator())


def test_transformer_with_logits_raises_as_jax(models, ref_pair):
    (_, _, _, _), torch_models = models
    with pytest.raises(ValueError, match="want_logits requires a CTC recognizer"):
        TorchPagePipeline(None, ref_pair[0], device="cpu", want_logits=True)
