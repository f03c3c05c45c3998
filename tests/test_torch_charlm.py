"""The port's character LM against the JAX package's, on the CPU.

- ``CharLM.advance`` and ``log_probs`` against the flax CharLM for both
  cells (flax ``OptimizedLSTMCell`` and ``GRUCell``), one and two
  layers, the flax variables carried across by
  ``charlm_params_from_flax``: states and log-probs within 1e-5;
- ``construct_lm`` on a flax msgpack with its sidecar JSON, on torch LM
  files (state dicts of an LSTM and a GRU LM, a state dict in a
  checkpoint container, a pickled module, TorchScript) built and saved
  here, and on a missing file: the port's LMWrapper equals the JAX
  ``construct_lm``'s JAXLMWrapper call for call within 1e-5;
- ``HiddenState``'s index, assign and concat, ``detect_lm_prefixes`` and
  ``lm_spec_from_variables`` against the JAX functions.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from pero_ocr_tpu.decoding import itf as jax_itf
from pero_ocr_tpu.decoding.lm_wrapper import HiddenState as JaxHiddenState
from pero_ocr_tpu.models.charlm import CharLM as FlaxCharLM
from pero_ocr_tpu.models.charlm import CharLMSpec as FlaxCharLMSpec
from pero_ocr_tpu.utils import checkpoint as jax_checkpoint
from pero_ocr_tpu.utils import convert_torch as jax_convert
from pero_ocr_tpu_torch.decoding import itf
from pero_ocr_tpu_torch.decoding.lm_wrapper import HiddenState
from pero_ocr_tpu_torch.models.charlm import CharLM, CharLMSpec, state_leaves
from pero_ocr_tpu_torch.utils import checkpoint
from pero_ocr_tpu_torch.utils import convert

TOL = 1e-5
SYMBOLS = ["a", "b", "c", "d", "e"]


def flax_lm(cell_type, layers, vocab=6, seed=0, hidden=16):
    spec = FlaxCharLMSpec(vocab_size=vocab, embed_dim=8, hidden_dim=hidden,
                          num_layers=layers, cell_type=cell_type)
    model = FlaxCharLM(spec)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def port_lm(variables) -> CharLM:
    spec = convert.lm_spec_from_variables(variables)
    model = CharLM(CharLMSpec(**spec))
    model.load_state_dict(convert.charlm_params_from_flax(variables))
    return model


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("cell_type", ["lstm", "gru"])
def test_advance_and_log_probs_match_flax(cell_type, layers):
    model, variables = flax_lm(cell_type, layers, seed=layers)
    ours = port_lm(variables)
    rng = np.random.default_rng(layers)
    tokens = rng.integers(0, 6, (7, 5))
    state = model.apply(variables, 5, method=FlaxCharLM.initial_state)
    with torch.no_grad():
        ours_state = ours.initial_state(5)
        for step in tokens:
            state = model.apply(variables, jnp.asarray(step), state, method=FlaxCharLM.advance)
            ours_state = ours.advance(torch.from_numpy(step), ours_state)
            for g, w in zip(state_leaves(ours_state), jax.tree_util.tree_leaves(state)):
                close(g, w)
            close(ours.log_probs(ours_state),
                  model.apply(variables, state, method=FlaxCharLM.log_probs))
    assert ours.spec.eos_id == 5
    assert len(state_leaves(ours_state)) == layers * (2 if cell_type == "lstm" else 1)


def test_charlm_rejects_unknown_cells():
    with pytest.raises(ValueError, match="cell_type"):
        CharLM(CharLMSpec(vocab_size=4, cell_type="rnn"))


def assert_wrappers_match(ours, theirs):
    """The port's LMWrapper against a JAXLMWrapper, call for call."""
    h, jh = ours.initial_h(3), theirs.initial_h(3)
    for g, w in zip(state_leaves(h.tree), jax.tree_util.tree_leaves(jh.tree)):
        close(g, w)
    for chars in ([0, 4, 2], [1, 1, 3]):
        h, jh = ours.advance_h0(np.asarray(chars), h), theirs.advance_h0(np.asarray(chars), jh)
        close(ours.log_probs(h), theirs.log_probs(jh))
        close(ours.eos_scores(h), theirs.eos_scores(jh))
    end, jend = ours.add_line_end(h), theirs.add_line_end(jh)
    for g, w in zip(state_leaves(end.tree), jax.tree_util.tree_leaves(jend.tree)):
        close(g, w)
    for g, w in zip(state_leaves(ours.initial_h_from_line("ab?e").tree),
                    jax.tree_util.tree_leaves(theirs.initial_h_from_line("ab?e").tree)):
        close(g, w)
    assert np.array_equal(ours.translate([0, 3]), theirs.translate([0, 3]))


@pytest.mark.parametrize("vocab", [None, {"a": 4, "b": 0, "c": 1, "d": 2, "e": 3}],
                         ids=["in_order", "remapped"])
@pytest.mark.parametrize("cell_type", ["lstm", "gru"])
def test_construct_lm_from_flax_msgpack_matches_jax(tmp_path, cell_type, vocab):
    _, variables = flax_lm(cell_type, 2, seed=4)
    path = tmp_path / "charlm.lm"
    jax_checkpoint.save_variables(variables, str(path))
    sidecar = {"vocab_size": 6, "embed_dim": 8, "hidden_dim": 16, "num_layers": 2,
               "cell_type": cell_type}
    if vocab is not None:
        sidecar["vocab"] = vocab
    (tmp_path / "charlm.lm.json").write_text(json.dumps(sidecar))
    ours = itf.construct_lm("charlm.lm", SYMBOLS, config_path=str(tmp_path))
    theirs = jax_itf.construct_lm("charlm.lm", SYMBOLS, config_path=str(tmp_path))
    assert ours.spec.cell_type == cell_type
    assert np.array_equal(ours.vocab_map, theirs._map)
    assert_wrappers_match(ours, theirs)


class TorchLM(nn.Module):
    """A brnolm-style torch LM: ``encoder``, an nn.LSTM/GRU ``rnn`` and a
    ``decoder`` Linear."""

    def __init__(self, cell_type, layers=2, vocab=6, embed=8, hidden=16):
        super().__init__()
        self.encoder = nn.Embedding(vocab, embed)
        rnn = nn.LSTM if cell_type == "lstm" else nn.GRU
        self.rnn = rnn(embed, hidden, num_layers=layers, batch_first=True)
        self.decoder = nn.Linear(hidden, vocab)

    def forward(self, tokens):
        return self.decoder(self.rnn(self.encoder(tokens))[0])


@pytest.mark.parametrize("kind", ["state_dict", "container", "module", "torchscript"])
@pytest.mark.parametrize("cell_type", ["lstm", "gru"])
def test_construct_lm_from_a_torch_file_matches_jax(tmp_path, cell_type, kind):
    torch.manual_seed(3)
    module = TorchLM(cell_type)
    with torch.no_grad():  # biases away from 0, so that a lost bias shows
        for p in module.parameters():
            p.add_(0.1 * torch.randn_like(p))
    path = tmp_path / "lm.pt"
    if kind == "state_dict":
        torch.save(module.state_dict(), path)
    elif kind == "container":
        torch.save({"epoch": 3, "state_dict": module.state_dict()}, path)
    elif kind == "module":
        torch.save(module, path)
    else:
        torch.jit.save(torch.jit.script(module), str(path))
    assert itf._is_torch_lm_file(str(path))
    ours = itf.construct_lm(str(path), SYMBOLS)
    theirs = jax_itf.construct_lm(str(path), SYMBOLS)
    assert ours.spec == CharLMSpec(vocab_size=6, embed_dim=8, hidden_dim=16, num_layers=2,
                                   cell_type=cell_type)
    assert_wrappers_match(ours, theirs)
    # The converted LM scores as the torch module does.
    tokens = torch.tensor([[5, 0, 3, 1]])
    with torch.no_grad():
        want = torch.log_softmax(module(tokens), -1)[0]
        state = ours.model.initial_state(1)
        for i, tok in enumerate(tokens[0]):
            state = ours.model.advance(tok[None], state)
            close(ours.model.log_probs(state)[0], want[i], 1e-5)


def test_construct_lm_missing_file(tmp_path, caplog):
    (tmp_path / "gone.lm.json").write_text(json.dumps({"hidden_dim": 8, "embed_dim": 4,
                                                       "num_layers": 1}))
    checkpoint.set_strict_loading(True)
    try:
        with pytest.raises(FileNotFoundError, match="allow-random-weights"):
            itf.construct_lm("gone.lm", SYMBOLS, config_path=str(tmp_path))
    finally:
        checkpoint.set_strict_loading(False)
    with caplog.at_level(logging.WARNING):
        wrapper = itf.construct_lm("gone.lm", SYMBOLS, config_path=str(tmp_path))
    assert "RANDOM weights" in caplog.text
    assert wrapper.spec == CharLMSpec(vocab_size=6, embed_dim=4, hidden_dim=8, num_layers=1)
    assert wrapper.log_probs(wrapper.initial_h(2)).shape == (2, 5)


def test_hidden_state_index_assign_concat_match_jax():
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(4)]
    ours = HiddenState(((leaves[0], leaves[1]), (leaves[2], leaves[3])))
    theirs = JaxHiddenState(((leaves[0].copy(), leaves[1].copy()),
                             (leaves[2].copy(), leaves[3].copy())))
    picked, jpicked = ours[[3, 1]], theirs[[3, 1]]
    ours[[0, 2]], theirs[[0, 2]] = picked, jpicked
    joined, jjoined = ours + picked, theirs + jpicked
    assert joined.batch_size() == jjoined.batch_size() == 6
    for g, w in zip(state_leaves(joined.tree), jax.tree_util.tree_leaves(jjoined.tree)):
        assert np.array_equal(g, w)
    empty = HiddenState(tuple(np.zeros((0, 3), np.float32) for _ in range(2)))
    assert (empty + HiddenState((leaves[0], leaves[1]))).batch_size() == 4


@pytest.mark.parametrize("naming", [("embed", "lstm", "head"), ("encoder", "rnn", "decoder"),
                                    ("model.emb", "model.rnn", "out")])
@pytest.mark.parametrize("cell_type", ["lstm", "gru"])
def test_lm_prefixes_and_spec_match_jax(naming, cell_type):
    module = TorchLM(cell_type, layers=1, embed=16, hidden=16)  # ambiguous shapes
    sd = {}
    for key, value in module.state_dict().items():
        part, rest = key.split(".", 1)
        sd[f"{dict(zip(('encoder', 'rnn', 'decoder'), naming))[part]}.{rest}"] = value
    assert convert.detect_lm_prefixes(sd) == jax_convert.detect_lm_prefixes(sd)
    prefixes = convert.detect_lm_prefixes(sd)
    ours, theirs = convert.convert_torch_lm(sd, **prefixes), jax_convert.convert_torch_lm(
        sd, **prefixes)
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
    for g, w in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert np.array_equal(g, w)
    assert convert.lm_spec_from_variables(ours) == jax_convert.lm_spec_from_variables(theirs)
    with pytest.raises(ValueError, match="recurrent stack"):
        convert.detect_lm_prefixes({"head.weight": np.zeros((3, 3))})


@pytest.mark.parametrize("cell_type", ["lstm", "gru"])
def test_chip_smoke_writer_round_trips_through_flax(tmp_path, cell_type):
    """The port's export_lm_checkpoint (no flax on the card's machine;
    chip_smoke.py writes its LMs with it) writes a msgpack and sidecar
    that the JAX construct_lm reads into the same LM, and that the port
    reads back bit for bit."""
    from pero_ocr_tpu_torch.parallel.train import export_lm_checkpoint

    lm = CharLM(CharLMSpec(vocab_size=6, embed_dim=8, hidden_dim=16, num_layers=2,
                           cell_type=cell_type), generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "charlm.lm")
    export_lm_checkpoint(lm, path)
    ours, theirs = itf.construct_lm(path, SYMBOLS), jax_itf.construct_lm(path, SYMBOLS)
    for name, value in lm.state_dict().items():
        assert torch.equal(ours.model.state_dict()[name], value), name
    assert_wrappers_match(ours, theirs)
