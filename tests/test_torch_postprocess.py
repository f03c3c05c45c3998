"""Parity of the port's label narrowing (``ocr/postprocess.py``) and
confusion networks (``decoding/confusion_networks.py``) with the JAX
package's, on the CPU.

- ``narrow_label``: the four cases of the JAX package's
  ``TestNarrowLabel``, and numpy-seeded random label runs (blank-heavy,
  with repeats, both fill modes): equal lists.
- Confusion networks: the JAX package's test cases and numpy-seeded
  random bags of hypotheses.  Slot dicts hold the same keys in the same
  order, with probabilities within 1e-12; best paths and sorted path
  lists equal (probabilities within 1e-12).
"""

import math

import numpy as np
import pytest

from pero_ocr_tpu.decoding import bag_of_hypotheses as jax_boh
from pero_ocr_tpu.decoding import confusion_networks as jax_cn
from pero_ocr_tpu.ocr import postprocess as jax_pp
from pero_ocr_tpu_torch.decoding import bag_of_hypotheses as port_boh
from pero_ocr_tpu_torch.decoding import confusion_networks as port_cn
from pero_ocr_tpu_torch.ocr import postprocess as port_pp

PROB_TOL = 1e-12

BLANK = 3
NARROW_CASES = {
    "repeated_run": ([0, 0, 0, 1], np.array(
        [[1.0, 0, 0, 0], [5.0, 0, 0, 0], [2.0, 0, 0, 0], [0, 9.0, 0, 0]]), False),
    "single_frames": ([0, BLANK, 1, BLANK], np.zeros((4, 4)), False),
    "liberal_fill": ([0, 0], np.array([[1.0, 0, 0, 0], [5.0, 0, 0, 0]]), True),
    "blank_separated": ([0, 0, BLANK, 0, 0], np.array(
        [[2.0, 0, 0, 0], [1.0, 0, 0, 0], [0, 0, 0, 0], [1.0, 0, 0, 0], [4.0, 0, 0, 0]]),
        False),
}


@pytest.mark.parametrize("case", sorted(NARROW_CASES))
def test_narrow_label_cases_equal_jax(case):
    label, logit, liberal = NARROW_CASES[case]
    want = jax_pp.narrow_label(label, logit, BLANK, on_one_liberal=liberal)
    assert port_pp.narrow_label(label, logit, BLANK, on_one_liberal=liberal) == want


@pytest.mark.parametrize("liberal", [False, True])
def test_narrow_label_random_runs_equal_jax(liberal):
    rng = np.random.RandomState(5)
    for _ in range(200):
        c = int(rng.randint(2, 7))
        t = int(rng.randint(1, 40))
        # Runs of a few frames each, a third of them blank.
        label = []
        while len(label) < t:
            sym = c - 1 if rng.rand() < 0.33 else int(rng.randint(0, c - 1))
            label += [sym] * int(rng.randint(1, 5))
        label = label[:t]
        logit = rng.randint(0, 4, size=(t, c)).astype(np.float64)  # ties too
        assert port_pp.find_optimal(logit, [0], 0) == jax_pp.find_optimal(logit, [0], 0)
        want = jax_pp.narrow_label(label, logit, c - 1, on_one_liberal=liberal)
        assert port_pp.narrow_label(label, logit, c - 1, on_one_liberal=liberal) == want


def _assert_cn_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            assert abs(g[key] - w[key]) <= PROB_TOL, (key, g[key], w[key])


def _fold(module, hyps):
    cn = []
    for transcript, score in hyps:
        cn = module.add_hypothese(cn, transcript, score)
    return cn


CN_CASES = {
    "first": [("ab", 0.6)],
    "accumulate": [("ab", 0.6), ("ab", 0.3)],
    "substitution": [("ab", 0.6), ("ax", 0.3)],
    "shorter": [("ab", 0.6), ("a", 0.3)],
    "longer": [("ab", 0.6), ("axb", 0.3)],
    "normalize": [("ab", 0.6), ("ax", 0.2)],
}


@pytest.mark.parametrize("case", sorted(CN_CASES))
def test_cn_cases_equal_jax(case):
    want = _fold(jax_cn, CN_CASES[case])
    got = _fold(port_cn, CN_CASES[case])
    _assert_cn_equal(got, want)
    assert port_cn.get_pivot(got) == jax_cn.get_pivot(want)
    _assert_cn_equal(port_cn.normalize_cn(got), jax_cn.normalize_cn(want))
    assert port_cn.best_cn_path(got) == jax_cn.best_cn_path(want)


@pytest.mark.parametrize("cn", [
    [{"a": 0.9, "b": 0.1}, {None: 0.6, "c": 0.4}],
    [{"a": 0.9}, {"b": 0.8, "c": 0.2}],
    [{"a": 0.7, "b": 0.3}, {"c": 0.6, None: 0.4}],
    [],
])
def test_cn_paths_equal_jax(cn):
    assert port_cn.best_cn_path([dict(s) for s in cn]) == jax_cn.best_cn_path(cn)
    got = port_cn.sorted_cn_paths([dict(s) for s in cn])
    want = jax_cn.sorted_cn_paths(cn)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert np.allclose([q for _, q in got], [q for _, q in want], rtol=0, atol=PROB_TOL)


def _random_bag(rng, alphabet="abcde"):
    hyps = []
    base = "".join(rng.choice(list(alphabet), size=int(rng.randint(1, 8))))
    for _ in range(int(rng.randint(1, 6))):
        text = list(base)
        for _ in range(int(rng.randint(0, 3))):  # edits: sub, ins, del
            op = rng.randint(0, 3)
            pos = int(rng.randint(0, len(text) + 1))
            if op == 0 and pos < len(text):
                text[pos] = rng.choice(list(alphabet))
            elif op == 1:
                text.insert(pos, rng.choice(list(alphabet)))
            elif text and pos < len(text):
                del text[pos]
        lm = None if rng.rand() < 0.3 else float(-rng.rand() * 3)
        hyps.append(("".join(text), float(-rng.rand() * 5), lm))
    return hyps


@pytest.mark.parametrize("normalize", [True, False])
def test_cn_from_random_bags_equal_jax(normalize):
    rng = np.random.RandomState(11)
    for _ in range(60):
        hyps = _random_bag(rng)
        bags = []
        for module in (jax_boh, port_boh):
            bag = module.BagOfHypotheses()
            for text, vis, lm in hyps:
                bag.add(text, vis, lm)
            bags.append(bag)
        want = jax_cn.produce_cn_from_boh(bags[0], 0.7, 1.3, normalize=normalize)
        got = port_cn.produce_cn_from_boh(bags[1], 0.7, 1.3, normalize=normalize)
        _assert_cn_equal(got, want)
        assert port_cn.best_cn_path(got) == jax_cn.best_cn_path(want)
        if len(got) <= 8:
            gp, wp = port_cn.sorted_cn_paths(got), jax_cn.sorted_cn_paths(want)
            assert [p for p, _ in gp] == [p for p, _ in wp]
            assert all(math.isclose(a, b, rel_tol=0, abs_tol=PROB_TOL)
                       for (_, a), (_, b) in zip(gp, wp))
