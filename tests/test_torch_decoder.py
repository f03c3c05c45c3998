"""The port's batched beam search (``TorchBeamSearchDecoder``) on the CPU
against the host decoder and the JAX package's ``TPUBeamSearchDecoder``.

Every class of tests/test_tpu_decoder.py's contract runs on the port's
decoder: visual-only parity with the host decoder without pruning,
batched lines with lengths, the prefix-joining mass, the float16
transport, a wide charset, a long line, LM fusion (LSTM and GRU), the
remapped LM, EOS scoring and CARRY_H_OVER, with PageDecoder's routes.
Each case also feeds the same numpy inputs to the JAX decoder on the
CPU, with the same LM weights (flax variables carried across by
``charlm_params_from_flax``), and holds the port to it: bags equal in
text and order, visual and LM scores within SCORE_TOL, final LM states
within STATE_TOL; where the inputs tie (top-k ties, wrapping hashes) the
per-frame backpointers are equal.
"""

import configparser
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

from pero_ocr_tpu.core.layout import PageLayout as JaxPageLayout
from pero_ocr_tpu.core.layout import RegionLayout as JaxRegionLayout
from pero_ocr_tpu.core.layout import TextLine as JaxTextLine
from pero_ocr_tpu.decoding import itf as jax_itf
from pero_ocr_tpu.decoding.decoders import CTCPrefixLogRawNumpyDecoder as JaxHostDecoder
from pero_ocr_tpu.decoding.lm_wrapper import JAXLMWrapper
from pero_ocr_tpu.decoding.tpu_decoder import TPUBeamSearchDecoder
from pero_ocr_tpu.document.page_parser import PageDecoder as JaxPageDecoder
from pero_ocr_tpu.models.charlm import CharLM as FlaxCharLM
from pero_ocr_tpu.models.charlm import CharLMSpec as FlaxCharLMSpec
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from pero_ocr_tpu_torch.decoding import itf
from pero_ocr_tpu_torch.decoding.decoders import (
    BLANK_SYMBOL, CTCPrefixLogRawNumpyDecoder, GreedyDecoder,
)
from pero_ocr_tpu_torch.decoding.lm_wrapper import LMWrapper
from pero_ocr_tpu_torch.decoding.tpu_decoder import (
    HASH_MASK, HASH_MULT, NEG_INF, TorchBeamSearchDecoder,
)
from pero_ocr_tpu_torch.document.page_parser import PageDecoder
from pero_ocr_tpu_torch.models.charlm import CharLM, CharLMSpec, state_leaves
from pero_ocr_tpu_torch.utils.convert import charlm_params_from_flax

LETTERS = ["a", "b", "c", BLANK_SYMBOL]
SCORE_TOL = 1e-4   # float32 scores: XLA's and torch's logaddexp and matmuls
STATE_TOL = 1e-5


def no_prune(logits):
    return (np.arange(len(logits)),)


def lp(rng, t, c):
    probs = rng.dirichlet(np.ones(c), size=t)
    return np.log(probs).astype(np.float32)


def make_lm(cell_type, seed, vocab=len(LETTERS), layers=1, hidden=8):
    """A flax CharLM's (model, variables) and the port's CharLM with the
    same weights."""
    spec = dict(vocab_size=vocab, embed_dim=4, hidden_dim=hidden, num_layers=layers,
                cell_type=cell_type)
    model = FlaxCharLM(FlaxCharLMSpec(**spec))
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1), jnp.int32))
    port = CharLM(CharLMSpec(**spec))
    port.load_state_dict(charlm_params_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return (model, variables), port


_JAX_DECODERS = {}


def decoders(letters, k, lm=None, max_len=256, **kw):
    """The JAX decoder and the port's (on the CPU), same settings
    (``max_len``: the JAX decoder's, which neither decoder uses).  A JAX
    decoder is built once for its settings and LM (the LM is kept with
    it, so its id stays its own), so its compiled scans serve every test
    that asks for it."""
    jax_lm, port_lm = (None, None) if lm is None else lm
    key = (tuple(letters), k, id(lm), max_len,
           tuple((name, v.tobytes() if isinstance(v, np.ndarray) else repr(v))
                 for name, v in sorted(kw.items())))
    if key not in _JAX_DECODERS:
        _JAX_DECODERS[key] = (lm, TPUBeamSearchDecoder(letters, k=k, lm=jax_lm, max_len=max_len,
                                                       **kw))
    return (_JAX_DECODERS[key][1],
            TorchBeamSearchDecoder(letters, k=k, lm=port_lm, device="cpu", **kw))


def assert_bags_match(got, want, tol=SCORE_TOL):
    assert [h.transcript for h in got] == [h.transcript for h in want]
    for g, w in zip(got, want):
        assert abs(g.vis_sc - w.vis_sc) <= tol, g.transcript
        assert abs(g.lm_sc - w.lm_sc) <= tol, g.transcript


def assert_states_match(got, want):
    got, want = state_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=STATE_TOL)


def both(jax_dec, port_dec, logits, lengths=None, **kw):
    """Decode ``logits`` with both; the bags must match.  Returns the
    port's result."""
    want = jax_dec.decode_batch(logits, lengths, **kw)
    got = port_dec.decode_batch(logits, lengths, **kw)
    if kw.get("return_lm_states"):
        (want, want_states), (got, got_states) = want, got
        assert_states_match(got_states, want_states)
    for g, w in zip(got, want):
        assert_bags_match(g, w)
    return got


def jax_backpointers(dec, logits, lengths):
    (rows, cols), *_ = dec._decode_jit(jnp.asarray(logits, dec.transport_dtype),
                                       jnp.asarray(lengths, jnp.int32), False, None)
    return np.asarray(rows), np.asarray(cols)


def port_backpointers(dec, logits, lengths):
    out = dec.run(logits, lengths)
    return out.bp_rows.numpy(), out.bp_cols.numpy()


class TestVisualOnlyParity:
    @pytest.mark.parametrize("beam", [2, 4, 8])
    def test_matches_host_decoder(self, beam):
        rng = np.random.default_rng(0)
        logits = lp(rng, 12, len(LETTERS))
        host = CTCPrefixLogRawNumpyDecoder(LETTERS, k=beam, relevant_logits_selector=no_prune)
        host_bag = host(logits.astype(np.float64))
        host_scores = {h.transcript: h.vis_sc for h in host_bag}

        jax_dec, port = decoders(LETTERS, beam, max_len=16)
        bag = both(jax_dec, port, logits[None])[0]
        scores = {h.transcript: h.vis_sc for h in bag}
        assert host_bag.best_hyp() == bag.best_hyp()
        for text, score in scores.items():
            if text in host_scores:
                assert score == pytest.approx(host_scores[text], abs=1e-3), text
        assert len(set(host_scores) & set(scores)) >= min(beam, len(scores)) - 1

    def test_batched_lines_with_lengths(self):
        rng = np.random.default_rng(1)
        batch = np.stack([lp(rng, 15, 4), lp(rng, 15, 4)])
        lengths = np.array([15, 9])
        jax_dec, port = decoders(LETTERS, 4, max_len=16)
        bags = both(jax_dec, port, batch, lengths)
        host = CTCPrefixLogRawNumpyDecoder(LETTERS, k=4, relevant_logits_selector=no_prune)
        for i, bag in enumerate(bags):
            ref = host(batch[i, : lengths[i]].astype(np.float64))
            assert bag.best_hyp() == ref.best_hyp()
            assert bag.confidence() == pytest.approx(ref.confidence(), abs=1e-3)

    def test_prefix_joining_mass(self):
        """Every hypothesis's mass equals the brute-force sum over its
        CTC paths."""
        rng = np.random.default_rng(5)
        t, c = 4, 4
        probs = rng.dirichlet(np.ones(c), size=t)
        logits = np.log(probs).astype(np.float32)
        jax_dec, port = decoders(LETTERS, 16, max_len=8)
        bag = both(jax_dec, port, logits[None])[0]
        got = {h.transcript: np.exp(h.vis_sc) for h in bag}
        brute = {}
        for path in itertools.product(range(c), repeat=t):
            p = np.prod(probs[np.arange(t), list(path)])
            out, prev = [], None
            for s in path:
                if s != prev and s != c - 1:
                    out.append(LETTERS[s])
                prev = s
            brute["".join(out)] = brute.get("".join(out), 0.0) + p
        for transcript, p in got.items():
            assert p == pytest.approx(brute[transcript], rel=1e-3), transcript


class TestTransportDtype:
    def test_f16_transport_matches_f32(self):
        rng = np.random.default_rng(5)
        batch = np.stack([lp(rng, 14, len(LETTERS)), lp(rng, 14, len(LETTERS))])
        _, full = decoders(LETTERS, 4, max_len=16)
        jax_half, half = decoders(LETTERS, 4, max_len=16, transport_dtype=np.float16)
        bags_half = both(jax_half, half, batch)  # the same float16 rounding as JAX
        for bf, bh in zip(full.decode_batch(batch), bags_half):
            assert bf.best_hyp() == bh.best_hyp()
            sf = {h.transcript: h.vis_sc for h in bf}
            for h in bh:
                if h.transcript in sf:
                    assert h.vis_sc == pytest.approx(sf[h.transcript], abs=5e-2)


class TestBigCharsetParity:
    def test_wide_vocab_matches_host(self):
        letters = [chr(0x100 + i) for i in range(80)] + [BLANK_SYMBOL]
        rng = np.random.default_rng(11)
        logits = lp(rng, 7, len(letters))
        host_bag = CTCPrefixLogRawNumpyDecoder(letters, k=6, relevant_logits_selector=no_prune)(
            logits.astype(np.float64))
        jax_dec, port = decoders(letters, 6)
        bag = both(jax_dec, port, logits[None])[0]
        assert bag.best_hyp() == host_bag.best_hyp()
        host_scores = {h.transcript: h.vis_sc for h in host_bag}
        for h in bag:
            if h.transcript in host_scores:
                assert h.vis_sc == pytest.approx(host_scores[h.transcript], abs=1e-3)


class TestNoLengthCap:
    def test_long_line_not_truncated(self):
        """600 sure frames alternating a and b: a 600-char best
        hypothesis, whose prefix hashes wrap uint32 many times."""
        t = 600
        logits = np.full((t, 4), -20.0, np.float32)
        logits[np.arange(t), np.arange(t) % 2] = 0.0
        logits = logits - np.logaddexp.reduce(logits, axis=1, keepdims=True)
        jax_dec, port = decoders(LETTERS, 2, max_len=256)
        best = both(jax_dec, port, logits[None])[0].best_hyp()
        assert best == "ab" * (t // 2)


class TestTiesAndHashes:
    """Inputs on which the beam's totals tie exactly, and lines long
    enough that the prefix hashes wrap: the port's per-frame
    backpointers equal the JAX scan's."""

    @pytest.mark.parametrize("case", ["uniform", "padding", "two_chars", "batched_padding"])
    def test_exact_ties_pick_the_lower_index(self, case):
        rng = np.random.default_rng(3)
        letters = LETTERS
        if case == "uniform":  # every cell ties every frame
            logits = np.full((1, 9, 4), np.log(0.25), np.float32)
            lengths = np.array([9])
        elif case == "two_chars":  # one char and the blank, equal halves
            letters = ["a", BLANK_SYMBOL]
            logits = np.full((1, 8, 2), np.log(0.5), np.float32)
            lengths = np.array([8])
        else:  # padding frames: -30 everywhere, the blank at 0
            n = 3 if case == "batched_padding" else 1
            logits = np.full((n, 16, 4), -30.0, np.float32)
            logits[:, :, -1] = 0.0
            lengths = np.array([5, 11, 0][:n])
            for i in range(n):
                logits[i, : lengths[i]] = lp(rng, lengths[i], 4)
        for k in (3, 8):
            jax_dec, port = decoders(letters, k)
            rows, cols = port_backpointers(port, logits, lengths)
            want_rows, want_cols = jax_backpointers(jax_dec, logits, lengths)
            assert np.array_equal(rows, want_rows) and np.array_equal(cols, want_cols)
            both(jax_dec, port, logits, lengths)

    def test_top_k_ties_with_an_lm(self):
        lm = make_lm("lstm", 5)
        logits = np.full((2, 10, 4), np.log(0.25), np.float32)
        lengths = np.array([10, 6])
        jax_dec, port = decoders(LETTERS, 8, lm, lm_scale=0.0)  # the LM's scores tie too
        assert np.array_equal(port_backpointers(port, logits, lengths),
                              jax_backpointers(jax_dec, logits, lengths))
        both(jax_dec, port, logits, lengths, return_lm_states=True)

    def test_hashes_wrap_as_uint32(self):
        """The beam's int64 hashes after every frame equal the uint32
        rolling hash of each entry's prefix computed in numpy."""
        rng = np.random.default_rng(8)
        logits = torch.from_numpy(lp(rng, 40, 4)[None])
        port = TorchBeamSearchDecoder(LETTERS, k=4, device="cpu")
        beam = port._init_beam(1, None)
        prefixes = [()] * 4
        active = torch.ones(1, dtype=torch.bool)
        rows_t = torch.empty(1, 4, dtype=torch.uint8)
        cols_t = torch.empty(1, 4, dtype=torch.uint8)
        wrapped = False
        for t in range(logits.shape[1]):
            beam = port._step(beam, logits[:, t], active, rows_t, cols_t, None,
                              ~torch.eye(4, dtype=torch.bool), torch.arange(4) * 4 + 3)
            prefixes = [prefixes[r] if c == 3 else prefixes[r] + (c,)
                        for r, c in zip(rows_t[0].tolist(), cols_t[0].tolist())]
            for j, prefix in enumerate(prefixes):
                h = np.uint32(0)
                with np.errstate(over="ignore"):
                    for c in prefix:
                        h = h * np.uint32(HASH_MULT) + np.uint32(c) + np.uint32(1)
                assert int(beam.hash[0, j]) == int(h)
                wrapped |= len(prefix) > 1 and int(h) < HASH_MULT ** (len(prefix) - 1)
            assert 0 <= int(beam.hash.min()) and int(beam.hash.max()) <= HASH_MASK
        assert wrapped


    def test_step_on_crafted_beams_matches_jax(self):
        """One frame of both decoders' step on crafted beams: hashes
        drawn from a small set (so an entry may match several, where the
        first True decides, and parents are voided through the merge
        mask), void (-1e30) entries, empty and full prefixes, inactive
        lines: the same new beams and backpointers."""
        from pero_ocr_tpu.decoding.tpu_decoder import _BeamArrays

        rng = np.random.default_rng(21)
        b, k, v = 256, 4, 3
        lengths = rng.integers(0, 4, (b, k))
        scores = [np.where(rng.random((b, k)) < 0.3, NEG_INF,
                           rng.normal(-5, 3, (b, k))).astype(np.float32) for _ in range(2)]
        arrays = dict(
            lengths=lengths, hash=rng.choice([0, 5, 7], (b, k)),
            parent_hash=rng.choice([0, 5, 7], (b, k)),
            last_char=np.where(lengths > 0, rng.integers(0, v, (b, k)), 0),
            p_blank=scores[0], p_nonblank=scores[1],
            p_lm=rng.normal(-2, 1, (b, k)).astype(np.float32))
        frame = lp(rng, b, v + 1)
        active = rng.random(b) < 0.8
        jax_dec, port = decoders(LETTERS, k, insertion_bonus=0.3)
        want, (want_rows, want_cols) = jax.jit(jax_dec._step)(_BeamArrays(
            lengths=jnp.asarray(arrays["lengths"], jnp.int32),
            hash=jnp.asarray(arrays["hash"], jnp.uint32),
            parent_hash=jnp.asarray(arrays["parent_hash"], jnp.uint32),
            last_char=jnp.asarray(arrays["last_char"], jnp.int32),
            p_blank=jnp.asarray(scores[0]), p_nonblank=jnp.asarray(scores[1]),
            p_lm=jnp.asarray(arrays["p_lm"]), lm_state=None,
            lm_preds=jnp.zeros((b, k, v), jnp.float32)), jnp.asarray(frame), jnp.asarray(active))
        rows, cols = torch.empty(b, k, dtype=torch.uint8), torch.empty(b, k, dtype=torch.uint8)
        got = port._step(port._init_beam(b, None)._replace(**{
            name: torch.from_numpy(np.asarray(value, np.int64 if value.dtype.kind == "i"
                                              else np.float32))
            for name, value in arrays.items()}), torch.from_numpy(frame),
            torch.from_numpy(active), rows, cols, None, ~torch.eye(k, dtype=torch.bool),
            torch.arange(k) * (v + 1) + v)
        assert np.array_equal(rows.numpy(), np.asarray(want_rows))
        assert np.array_equal(cols.numpy(), np.asarray(want_cols))
        for name in ("lengths", "hash", "parent_hash", "last_char"):
            assert np.array_equal(getattr(got, name).numpy(),
                                  np.asarray(getattr(want, name)).astype(np.int64)), name
        for name in ("p_blank", "p_nonblank", "p_lm"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)), rtol=1e-6, atol=1e-5)
        # The crafted beams do hold entries matching several others.
        parent, hashes = arrays["parent_hash"], arrays["hash"]
        multi = ((parent[:, :, None] == hashes[:, None, :]).sum(axis=2) >= 2) & (lengths > 0)
        assert multi.sum() > 10


class TestLMFusionParity:
    @pytest.fixture(scope="class", params=["lstm", "gru"])
    def charlm(self, request):
        return make_lm(request.param, 3)

    def test_matches_host_lm_decoder(self, charlm):
        (model, variables), port_lm = charlm
        rng = np.random.default_rng(2)
        logits = lp(rng, 10, len(LETTERS))
        host = CTCPrefixLogRawNumpyDecoder(
            LETTERS, k=4, lm=LMWrapper(port_lm, LETTERS[:-1]), lm_scale=0.7,
            insertion_bonus=0.4, relevant_logits_selector=no_prune)
        host_bag = host(logits.astype(np.float64))
        jax_dec, port = decoders(LETTERS, 4, charlm, lm_scale=0.7, insertion_bonus=0.4,
                                 max_len=16)
        bag = both(jax_dec, port, logits[None], return_lm_states=True)[0]
        assert bag.best_hyp() == host_bag.best_hyp()
        host_lm_scores = {h.transcript: h.lm_sc for h in host_bag}
        for h in bag:
            if h.transcript in host_lm_scores:
                assert h.lm_sc == pytest.approx(host_lm_scores[h.transcript], abs=1e-3)

    def test_batched_lines_with_lengths(self, charlm):
        rng = np.random.default_rng(12)
        batch = np.stack([lp(rng, 20, 4) for _ in range(3)])
        jax_dec, port = decoders(LETTERS, 4, charlm, lm_scale=0.6, insertion_bonus=0.2)
        both(jax_dec, port, batch, np.array([20, 13, 1]), return_lm_states=True)

    def test_remapped_lm_matches_host(self, charlm):
        """An LM on a permuted vocabulary ([c, a, b, </s>]) through the
        decoder's vocab_map and through the host wrapper."""
        (model, variables), port_lm = charlm
        rng = np.random.default_rng(6)
        logits = lp(rng, 10, len(LETTERS))
        host = CTCPrefixLogRawNumpyDecoder(
            LETTERS, k=4, lm=LMWrapper(port_lm, LETTERS[:-1], vocab_map={"a": 1, "b": 2, "c": 0}),
            lm_scale=0.7, insertion_bonus=0.2, relevant_logits_selector=no_prune)
        host_bag = host(logits.astype(np.float64))
        jax_dec, port = decoders(LETTERS, 4, charlm, lm_scale=0.7, insertion_bonus=0.2,
                                 max_len=16, vocab_map=np.array([1, 2, 0], np.int32))
        bag = both(jax_dec, port, logits[None], return_lm_states=True)[0]
        assert bag.best_hyp() == host_bag.best_hyp()
        host_scores = {h.transcript: h.lm_sc for h in host_bag}
        for h in bag:
            if h.transcript in host_scores:
                assert h.lm_sc == pytest.approx(host_scores[h.transcript], abs=1e-3)

    def test_eos_scoring(self, charlm):
        rng = np.random.default_rng(4)
        logits = lp(rng, 6, len(LETTERS))
        jax_dec, port = decoders(LETTERS, 4, charlm, lm_scale=1.0, max_len=8)
        plain = {h.transcript: h.lm_sc for h in both(jax_dec, port, logits[None])[0]}
        with_eos = {h.transcript: h.lm_sc
                    for h in both(jax_dec, port, logits[None], model_eos=True)[0]}
        for text in set(plain) & set(with_eos):
            assert with_eos[text] < plain[text]  # eos log-prob < 0


def _layout(layout_cls, region_cls, line_cls, logits_list, transcriptions=None):
    layout = layout_cls(id="p", page_size=(100, 100))
    region = region_cls("r", np.array([[0, 0], [100, 0], [100, 100], [0, 100]]))
    for i, logits in enumerate(logits_list):
        line = line_cls(
            id=f"l{i}", baseline=np.array([[0, 10 + i * 20], [100, 10 + i * 20]]),
            heights=[10, 2],
            polygon=np.array([[0, i * 20], [100, i * 20], [100, 20 + i * 20], [0, 20 + i * 20]]))
        line.logits = sparse.csc_matrix(np.asarray(logits, np.float64))
        line.characters = LETTERS
        line.logit_coords = [0, logits.shape[0]]
        if transcriptions is not None:
            line.transcription = transcriptions[i]
        region.lines.append(line)
    layout.regions.append(region)
    return layout


class TestCarryHOver:
    @pytest.fixture(scope="class", params=["lstm", "gru"])
    def charlm(self, request):
        return make_lm(request.param, 7, layers=2)

    def test_chained_lines_match_host(self, charlm):
        (model, variables), port_lm = charlm
        rng = np.random.default_rng(8)
        lines = [lp(rng, 8, len(LETTERS)) for _ in range(3)]
        host_lm = LMWrapper(port_lm, LETTERS[:-1])
        host = CTCPrefixLogRawNumpyDecoder(LETTERS, k=4, lm=host_lm, lm_scale=0.8,
                                           insertion_bonus=0.3, relevant_logits_selector=no_prune)
        host_texts, h = [], None
        for logits in lines:
            bag, last_h = host(logits.astype(np.float64), return_h=True, init_h=h)
            host_texts.append(bag.best_hyp())
            h = host_lm.add_line_end(last_h)

        jax_dec, port = decoders(LETTERS, 4, charlm, lm_scale=0.8, insertion_bonus=0.3,
                                 max_len=16)
        texts, state, jax_state = [], None, None
        for logits in lines:
            jax_bags, jax_final = jax_dec.decode_batch(logits[None], init_lm_states=jax_state,
                                                       return_lm_states=True)
            bags, final = port.decode_batch(logits[None], init_lm_states=state,
                                            return_lm_states=True)
            assert_bags_match(bags[0], jax_bags[0])
            assert_states_match(final, jax_final)
            texts.append(bags[0].best_hyp())
            state, jax_state = port.add_line_end(final), jax_dec.add_line_end(jax_final)
            assert_states_match(state, jax_state)
        assert texts == host_texts

    def test_carry_changes_the_decode(self, charlm):
        rng = np.random.default_rng(9)
        logits = lp(rng, 8, len(LETTERS))
        jax_dec, port = decoders(LETTERS, 4, charlm, lm_scale=0.8, max_len=16)
        fresh = both(jax_dec, port, logits[None])[0]
        seeded_state = port.states_from_line("abcabc")
        assert_states_match(seeded_state, jax_dec.states_from_line("abcabc"))
        seeded = port.decode_batch(logits[None], init_lm_states=seeded_state)[0]
        assert_bags_match(seeded, jax_dec.decode_batch(
            logits[None], init_lm_states=jax_dec.states_from_line("abcabc"))[0])
        fresh_scores = {h.transcript: h.lm_sc for h in fresh}
        seeded_scores = {h.transcript: h.lm_sc for h in seeded}
        shared = [t for t in fresh_scores if t in seeded_scores and t]
        assert shared
        assert any(abs(fresh_scores[t] - seeded_scores[t]) > 1e-6 for t in shared)

    def test_states_from_line_matches_wrapper(self, charlm):
        (model, variables), port_lm = charlm
        h_host = LMWrapper(port_lm, LETTERS[:-1]).initial_h_from_line("abc")
        h_jax = JAXLMWrapper(model, variables, LETTERS[:-1]).initial_h_from_line("abc")
        port = TorchBeamSearchDecoder(LETTERS, k=2, lm=port_lm, device="cpu")
        for a, b, c in zip(state_leaves(h_host.tree), state_leaves(port.states_from_line("abc")),
                           jax.tree_util.tree_leaves(h_jax.tree)):
            np.testing.assert_allclose(a, b.numpy(), atol=1e-6)
            np.testing.assert_allclose(a, np.asarray(c), atol=STATE_TOL)

    @pytest.mark.parametrize("route", ["carry", "carry_confident", "batched"])
    def test_page_decoder_routes(self, charlm, route):
        """PageDecoder's carry and batched routes against the JAX
        PageDecoder's on the same lines, and the carry route against the
        host decoder's carry path line for line."""
        (model, variables), port_lm = charlm
        rng = np.random.default_rng(10)
        logits = [lp(rng, n, len(LETTERS)) for n in (8, 150, 8, 40)]
        texts = ["ab", "ca", "bb", "c"]
        threshold = None
        if route == "carry_confident":  # line 2 is sure: it keeps its OCR text
            logits[2] = np.log(np.full((8, 4), 1e-4 / 3, np.float32))
            logits[2][:, 0] = np.log(1 - 1e-4)
            threshold = 0.99
        carry = route != "batched"
        layout = _layout(PageLayout, RegionLayout, TextLine, logits, texts)
        jax_layout = _layout(JaxPageLayout, JaxRegionLayout, JaxTextLine, logits, texts)
        jax_dec, port = decoders(LETTERS, 4, charlm, lm_scale=0.8, max_len=16)
        ours = PageDecoder(port, line_confidence_threshold=threshold, carry_h_over=carry)
        theirs = JaxPageDecoder(jax_dec, line_confidence_threshold=threshold, carry_h_over=carry)
        ours.process_page(layout)
        theirs.process_page(jax_layout)
        got = [line.transcription for line in layout.lines_iterator()]
        assert got == [line.transcription for line in jax_layout.lines_iterator()]
        assert ours.lines_decoded == theirs.lines_decoded == (3 if threshold else 4)
        assert ours.lines_examined == theirs.lines_examined == 4
        if route == "carry_confident":
            assert got[2] == "bb"
        if carry:
            host = CTCPrefixLogRawNumpyDecoder(
                LETTERS, k=4, lm=LMWrapper(port_lm, LETTERS[:-1]), lm_scale=0.8,
                relevant_logits_selector=no_prune)
            host_layout = _layout(PageLayout, RegionLayout, TextLine, logits, texts)
            PageDecoder(host, line_confidence_threshold=threshold,
                        carry_h_over=True).process_page(host_layout)
            assert got == [line.transcription for line in host_layout.lines_iterator()]
        summary = ours.decoding_summary()
        assert summary.startswith(f"Ran on 4, decoded {ours.lines_decoded} lines")


def test_page_decoder_without_lm_takes_the_batched_route():
    rng = np.random.default_rng(13)
    logits = [lp(rng, n, len(LETTERS)) for n in (20, 130, 7)]
    jax_dec, port = decoders(LETTERS, 4)
    assert not port.supports_carry
    layout = _layout(PageLayout, RegionLayout, TextLine, logits)
    jax_layout = _layout(JaxPageLayout, JaxRegionLayout, JaxTextLine, logits)
    PageDecoder(port, carry_h_over=True).process_page(layout)
    JaxPageDecoder(jax_dec, carry_h_over=True).process_page(jax_layout)
    assert [ln.transcription for ln in layout.lines_iterator()] == \
        [ln.transcription for ln in jax_layout.lines_iterator()]


def test_margins_are_the_cut_between_the_kth_and_next_total():
    """``run(margins=True)`` records, per frame, the smallest gap between
    consecutive totals among the K + 1 best (the cut between the K-th
    and the (K+1)-th, and the K kept's order); the backpointers do not
    change with it."""
    rng = np.random.default_rng(14)
    logits = lp(rng, 12, 4)[None]
    port = TorchBeamSearchDecoder(LETTERS, k=3, device="cpu")
    plain, with_margins = port.run(logits), port.run(logits, margins=True)
    assert plain.margins is None and with_margins.margins.shape == (12, 1)
    assert torch.equal(plain.bp_rows, with_margins.bp_rows)
    assert torch.equal(plain.bp_cols, with_margins.bp_cols)
    assert (with_margins.margins >= 0).all()
    best = np.sort(logits[0, 0])[::-1]  # frame 0: one entry, the totals its cells
    assert float(with_margins.margins[0, 0]) == pytest.approx(
        np.min(best[:3] - best[1:4]), abs=1e-6)
    assert NEG_INF == -1e30


@pytest.mark.parametrize("cell_type", ["lstm", "gru"])
def test_lines_without_frames_leave_the_others_alone(cell_type):
    """On CUDA a batch is padded to a power of two with lines of no
    frames: such lines change nothing of the real lines' backpointers,
    scores and final LM states."""
    _, port_lm = make_lm(cell_type, 9)
    port = TorchBeamSearchDecoder(LETTERS, k=4, lm=port_lm, lm_scale=0.6,
                                  insertion_bonus=0.2, device="cpu")
    rng = np.random.default_rng(15)
    batch = np.stack([lp(rng, 14, 4) for _ in range(3)])
    lengths = np.array([14, 8, 3])
    padded = np.concatenate([batch, np.zeros((1, 14, 4), np.float32)])
    want = port.run(batch, lengths)
    got = port.run(padded, np.append(lengths, 0))
    assert torch.equal(got.bp_rows[:, :3], want.bp_rows)
    assert torch.equal(got.bp_cols[:, :3], want.bp_cols)
    assert torch.equal(got.p_total[:3], want.p_total)
    assert torch.equal(got.p_lm[:3], want.p_lm)
    for g, w in zip(state_leaves(got.best_states), state_leaves(want.best_states)):
        assert torch.equal(g[:3], w)


@pytest.mark.parametrize("kind", ["GREEDY", "FAST-LOG-RAW", "TPU-BEAM"])
def test_decoder_factory_and_decode_page_match_jax(kind):
    """decoder_factory's three decoders (no LM) through decode_page on
    sparse paragraphs of logits: the JAX package's transcriptions."""
    config = configparser.ConfigParser()
    config["DECODER"] = {"TYPE": kind, "BEAM_SIZE": "4", "LM_SCALE": "0.5",
                         "TRANSPORT_DTYPE": "float16"}
    ours = itf.decoder_factory(config["DECODER"], LETTERS[:-1], device="cpu")
    theirs = jax_itf.decoder_factory(config["DECODER"], LETTERS[:-1])
    assert type(ours).__name__ == type(theirs).__name__.replace("TPU", "Torch")
    if kind == "GREEDY":
        assert isinstance(ours, GreedyDecoder)
    rng = np.random.default_rng(15)
    page = []
    for n_lines in (2, 1):
        paragraph = {}
        for i in range(n_lines):
            logits = rng.normal(0, 3, (int(rng.integers(5, 12)), len(LETTERS)))
            logits[logits < -2] = 0  # pruned entries, as in a sparse logits file
            paragraph[f"l{i}"] = sparse.csc_matrix(logits)
        page.append(paragraph)
    assert np.array_equal(itf.prepare_dense_logits(page[0]["l0"]),
                          jax_itf.prepare_dense_logits(page[0]["l0"]))
    if kind == "TPU-BEAM":  # decode_page calls a host decoder per line
        wrapped = lambda d: lambda logits: d.decode_batch(logits[None].astype(np.float32))[0]
        ours, theirs = wrapped(ours), wrapped(theirs)
    got = itf.decode_page(page, ours, time_logging=True)
    assert got == jax_itf.decode_page(page, theirs)
    assert [sorted(p) for p in got] == [["l0", "l1"], ["l0"]]


@pytest.mark.parametrize("pruned", [True, False], ids=["pruned", "no_prune"])
@pytest.mark.parametrize("cell_type", [None, "lstm", "gru"])
def test_host_decoder_matches_jax_host_decoder(cell_type, pruned):
    """The port's numpy copy of the host decoder (with its -10 logit
    pruning or without, with an LM through each package's wrapper,
    EOS scoring and a carried state) against the JAX package's."""
    rng = np.random.default_rng(16)
    logits = np.log(rng.dirichlet(np.full(4, 0.3), size=14))  # float64, some below -10
    kw = dict(lm_scale=0.6, insertion_bonus=0.3)
    if not pruned:
        kw["relevant_logits_selector"] = no_prune
    if cell_type is None:
        ours = CTCPrefixLogRawNumpyDecoder(LETTERS, 4, **kw)
        theirs = JaxHostDecoder(LETTERS, 4, **kw)
        assert_bags_match(ours(logits), theirs(logits), tol=1e-9)
        return
    (model, variables), port_lm = make_lm(cell_type, 17, layers=2)
    ours_lm, theirs_lm = LMWrapper(port_lm, LETTERS[:-1]), JAXLMWrapper(model, variables,
                                                                        LETTERS[:-1])
    ours = CTCPrefixLogRawNumpyDecoder(LETTERS, 4, ours_lm, **kw)
    theirs = JaxHostDecoder(LETTERS, 4, theirs_lm, **kw)
    init, jinit = ours_lm.initial_h_from_line("ab"), theirs_lm.initial_h_from_line("ab")
    bag, h = ours(logits, model_eos=True, return_h=True, init_h=init)
    want, jh = theirs(logits, model_eos=True, return_h=True, init_h=jinit)
    assert_bags_match(bag, want, tol=SCORE_TOL)
    for g, w in zip(state_leaves(h.tree), jax.tree_util.tree_leaves(jh.tree)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=STATE_TOL)
