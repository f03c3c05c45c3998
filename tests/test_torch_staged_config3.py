"""Config 3 on the port's stage-by-stage path (``RUN_DECODER``:
TPU-BEAM, beam 8, a random character LM written as a flax msgpack with
its sidecar, float16 transport, with and without CARRY_H_OVER, LSTM and
GRU): ``PageParser`` and the command line against the JAX PageParser and
command line, on the CPU, on the command line's bundle
(tests/test_torch_cli.py) with ParseNet patched to float32 on both
sides and ``random`` seeded alike: the same transcriptions line by line
and equal Page XML (timestamps masked).
"""

import json
import os
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.models.charlm import CharLM as FlaxCharLM
from pero_ocr_tpu.models.charlm import CharLMSpec as FlaxCharLMSpec
from pero_ocr_tpu.utils.checkpoint import save_variables
from pero_ocr_tpu_torch.core.layout import PageLayout
from tests.test_torch_cli import (  # noqa: F401  (bundle, float32_parsenets, torch_threads_share)
    _config, _jax_cli, _run_port, assert_xml_equal, bundle, float32_parsenets, torch_threads_share,
    staged_config,
)
from tests.test_torch_pipeline import CHARS
from tests.test_torch_staged import (
    _engines, _layouts_equal, _pages, _run_pages, _xml_equal, needs_native,
)


pytestmark = pytest.mark.usefixtures("torch_threads_share")  # the beam loop's tiny ops


# ----------------------------------------------------------------------
# Config 3: the staged path, then the beam search with a character LM
def config3_ini(bundle, tmp_path, cell_type="lstm", carry="yes"):
    """The bundle's staged config with config 3's [DECODER] keys
    (configs/config3_beam_lm.ini) and a random flax CharLM over the
    bundle's charset (+ </s>) with its sidecar under lm/."""
    ini = staged_config(bundle, tmp_path, PAGE_PARSER__RUN_DECODER="yes")
    config = _config(ini)
    spec = dict(vocab_size=len(CHARS), embed_dim=8, hidden_dim=16, num_layers=2,
                cell_type=cell_type)
    variables = FlaxCharLM(FlaxCharLMSpec(**spec)).init(jax.random.PRNGKey(5),
                                                         jnp.zeros((1, 1), jnp.int32))
    (tmp_path / "lm").mkdir(exist_ok=True)
    save_variables(variables, str(tmp_path / "lm" / "charlm.lm"))
    (tmp_path / "lm" / "charlm.lm.json").write_text(json.dumps(spec))
    config["DECODER"] = {"TYPE": "TPU-BEAM", "BEAM_SIZE": "8", "LM": "./lm/charlm.lm",
                         "LM_SCALE": "0.5", "INSERTION_BONUS": "0.2",
                         "TRANSPORT_DTYPE": "float16", "CARRY_H_OVER": carry}
    with open(ini, "w") as f:
        config.write(f)
    return ini


@needs_native
@pytest.mark.parametrize("cell_type,carry", [("lstm", "yes"), ("gru", "yes"), ("lstm", "no")],
                         ids=["lstm_carry", "gru_carry", "lstm_batched"])
def test_config3_page_parser_matches_jax(bundle, tmp_path, float32_parsenets, cell_type, carry):
    ini = config3_ini(bundle, tmp_path, cell_type, carry)
    ours, theirs = _engines(ini)
    assert ours.decoder.continue_lines == (carry == "yes")
    assert ours.decoder.decoder.transport_dtype is np.float16
    pages = _pages()
    got = _run_pages(ours, PageLayout, pages)
    want = _run_pages(theirs, JaxPageLayout, pages)
    decoded = 0
    for g, w in zip(got, want):
        _layouts_equal(g, w)
        _xml_equal(g, w)
        texts = [line.transcription for line in g.lines_iterator()]
        assert texts == [line.transcription for line in w.lines_iterator()]
        decoded += len(texts)
    assert ours.decoder.lines_decoded == theirs.decoder.lines_decoded == decoded >= 9
    if cell_type != "lstm" or carry != "yes":
        return
    # The LM moves the text: not every line keeps its greedy transcription
    # (the same parser without its decoder).
    ours.run_decoder = False
    plain = _run_pages(ours, PageLayout, pages)
    assert any(a.transcription != b.transcription for p, q in zip(got, plain)
               for a, b in zip(p.lines_iterator(), q.lines_iterator()))


@needs_native
def test_config3_cli_equals_jax_cli(bundle, tmp_path, float32_parsenets, capsys):
    """Config 3 through the port's command line (with --fast-pipeline,
    which falls back to the stage-by-stage path for RUN_DECODER) and the
    JAX one: equal Page XML files and transcriptions."""
    ini = config3_ini(bundle, tmp_path)
    common = ["-c", str(ini), "-i", str(bundle / "images")]
    random.seed(0)
    _run_port(common + ["--output-xml-path", str(tmp_path / "xml"), "--device", "cpu",
                        "--fast-pipeline", "--timing-report", "--output-transcriptions-file-path",
                        str(tmp_path / "lines.txt")])
    printed = capsys.readouterr().out
    random.seed(0)
    _jax_cli(common + ["--output-xml-path", str(tmp_path / "jax_xml"), "--fast-pipeline",
                       "--output-transcriptions-file-path", str(tmp_path / "jax_lines.txt")])
    names = sorted(os.listdir(tmp_path / "jax_xml"))
    assert sorted(os.listdir(tmp_path / "xml")) == names == [f"page-{i}.xml" for i in range(3)]
    for name in names:
        assert_xml_equal((tmp_path / "xml" / name).read_text(encoding="utf-8"),
                         (tmp_path / "jax_xml" / name).read_text(encoding="utf-8"))
    assert (tmp_path / "lines.txt").read_text(encoding="utf-8") == \
        (tmp_path / "jax_lines.txt").read_text(encoding="utf-8")
    assert re.search(r"^decoder\s+[0-9.]+\s+3\s", printed, re.M)
    assert "warp_fields kernel launches: 0" in printed  # the CPU runs the plain version
