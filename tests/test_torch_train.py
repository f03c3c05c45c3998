"""The port's trainers (pero_ocr_tpu_torch/parallel/train.py and
optim.py) against the JAX package's, on the CPU, with small float32
models and inputs made from a numpy seed.

Tolerances and why:

- Losses: within 1e-5 relative (float32 sums in another order).
- Gradients, in the flax layout (``*_params_to_flax`` of the port's
  gradients): each leaf within 1e-4 of that leaf's largest JAX gradient.
  A leaf's small entries are sums of products as large as its large
  ones, so their rounding is relative to the leaf's scale, not to their
  own value.  A leaf whose exact gradient is 0 (a conv bias under a
  GroupNorm of one channel a group) holds rounding noise in both
  frameworks (measured up to 1.5e-6 of the largest gradient of all
  leaves, OrientationNet's first conv bias): a leaf's bound is at least
  1e-5 of that largest gradient.
- clip + AdamW against optax 0.2.6: weights within 1e-6 relative after
  every step (the same float32 arithmetic; torch and XLA may round a
  product of three factors in another order).
- Trajectories: Adam's first update is about ``lr * sign(g)``, so an
  entry whose gradient is ~0 in one framework and a rounding error in
  the other may move by up to 2 lr a step the other way.  After 3 steps
  the conv biases under a GroupNorm of one channel a group (exact
  gradient 0, so Adam follows the rounding noise) lie within 6 lr of
  JAX's (that bound), and every other weight within 0.01 lr: where the
  gradients agree to 1e-4 of a leaf's largest, Adam's update moves by
  far less (measured: 1.2e-4 lr).
- Forward passes and LM scores: within 1e-4 / 1e-5 absolute, as the
  conversion tests hold the models.
- Checkpoints and converters: exact (bytes, dtypes, shapes, values).
"""

import copy
import dataclasses
import json
import re

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pero_ocr_tpu.decoding import itf as jax_itf
from pero_ocr_tpu.models import charlm as jax_charlm
from pero_ocr_tpu.models import parsenet as jax_parsenet
from pero_ocr_tpu.models import transformer as jax_tf
from pero_ocr_tpu.models.recognizer import CTCRecognizer as FlaxRecognizer
from pero_ocr_tpu.models.recognizer import RecognizerSpec as FlaxSpec
from pero_ocr_tpu.parallel import train as jax_train
from pero_ocr_tpu.utils import checkpoint as jax_checkpoint
from pero_ocr_tpu_torch import SCALE_OUT
from pero_ocr_tpu_torch.decoding import itf
from pero_ocr_tpu_torch.models import charlm
from pero_ocr_tpu_torch.models import transformer as tf
from pero_ocr_tpu_torch.models.parsenet import OrientationNet, ParseNet
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.parallel import optim, train
from pero_ocr_tpu_torch.utils import checkpoint, convert

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-5
FORWARD_ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small models: one intra-op thread each (the test workers share the
    machine's cores, and oversubscribed tiny ops crawl)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------------
# helpers
def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_trees_equal(got, want):
    """The same paths, shapes, dtypes and values, leaf for leaf."""
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def _sorted(tree):
    """A dict tree with its keys sorted at every level (flax's init
    orders keys by creation, the converters by their own walk)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _assert_grads_close(got, want):
    """Each leaf within GRAD_REL of the leaf's largest JAX gradient, or
    of GRAD_FLOOR x the largest gradient of all leaves where that is
    more (a leaf whose exact gradient is 0 holds rounding noise only)."""
    g, w = _leaves(_sorted(got)), _leaves(_sorted(jax.tree_util.tree_map(np.asarray, want)))
    assert [p for p, _ in g] == [p for p, _ in w]
    floor = GRAD_FLOOR * max(float(np.abs(b).max()) for _, b in w)
    for (path, a), (_, b) in zip(g, w):
        scale = max(float(np.abs(b).max()), floor / GRAD_REL)
        err = float(np.abs(np.asarray(a) - b).max())
        assert err <= GRAD_REL * scale, (jax.tree_util.keystr(path), err, scale)


def _port_grads(model, state, to_flax):
    """The last backward's gradients in the flax layout (zero for the
    frozen parameters, as flax has none)."""
    sd = {name: torch.zeros_like(t, dtype=torch.float32) for name, t in model.state_dict().items()}
    sd.update(zip(state.params, train.gradients(model, state)))
    return to_flax(model, sd)


def _backward(model, loss_fn, *args, **kw):
    """(the port's loss, its state) after one backward on a fresh state."""
    state = train.init_train_state(model, train.make_optimizer(), device="cpu")
    loss = loss_fn(model, *args, **kw)
    loss.backward()
    return float(loss.detach()), state


def _jax_value_and_grad(loss_fn, model, variables, *args, **kw):
    """JAX's loss and gradients, jitted as the JAX trainers run them."""
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, *a: loss_fn(model, p, *a, **kw)))(variables, *args)
    return float(loss), grads


def _perturbed(variables, seed, scale=0.1):
    """Flax variables with seeded noise on every leaf (nonzero biases and
    norm parameters to place)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        variables)


# ----------------------------------------------------------------------
# the CTC recognizer
REC_SPECS = {
    "s2d_group_lstm": dict(stem="s2d", norm="group", lstm_layers=2, embed_num=0),
    "conv_lstm_embed": dict(stem="conv", norm="none", lstm_layers=1, embed_num=3),
    "conv_no_lstm": dict(stem="conv", norm="none", lstm_layers=0, embed_num=0),
}


def _rec_pair(kind, seed=0):
    kw = dict(num_classes=7, line_height=16, conv_features=(4, 8), subsampling=4,
              lstm_features=8, embed_dim=4, **REC_SPECS[kind])
    flax_model = FlaxRecognizer(FlaxSpec(dtype=jnp.float32, **kw))
    variables = _perturbed(flax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 48, 3))),
                           seed)
    module = CTCRecognizer(RecognizerSpec(dtype=torch.float32, **kw))
    module.load_state_dict(convert.recognizer_params_from_flax(variables))
    return module, flax_model, variables


def _ctc_batch(seed, n=4, width=48, max_len=5, classes=7):
    rng = np.random.default_rng(seed)
    images = rng.random((n, 16, width, 3), np.float32)
    lengths = rng.integers(1, max_len + 1, n).astype(np.int32)
    labels = np.zeros((n, max_len), np.int32)
    for i, k in enumerate(lengths):
        labels[i, :k] = rng.integers(0, classes - 1, k)
    return images, labels, lengths


@pytest.mark.parametrize("kind", sorted(REC_SPECS))
def test_ctc_loss_and_gradients_match_jax(kind):
    module, flax_model, variables = _rec_pair(kind)
    batch = _ctc_batch(1)
    want, want_grads = _jax_value_and_grad(jax_train.ctc_loss_fn, flax_model, variables, *batch)
    got, state = _backward(module, train.ctc_loss_fn, *batch)
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    _assert_grads_close(_port_grads(module, state, convert.recognizer_params_to_flax),
                        want_grads)


def test_ctc_loss_of_a_label_that_cannot_fit_its_frames():
    """12 frames; a label of 10 with 3 repeats needs 13: optax gives it a
    large finite loss, the port 0 and no gradient (torch alone: inf)."""
    module, flax_model, variables = _rec_pair("s2d_group_lstm")
    twin = copy.deepcopy(module)
    images, labels, lengths = _ctc_batch(2, n=3, max_len=10)
    labels[0] = [0, 0, 1, 1, 2, 2, 3, 4, 5, 0]
    lengths[0] = 10
    lengths[1:] = np.minimum(lengths[1:], 4)
    per_seq = np.asarray(jax.jit(lambda v, x: optax.ctc_loss(
        flax_model.apply(v, x), jnp.zeros((3, 12)), labels,
        (np.arange(10)[None] >= lengths[:, None]).astype(np.float32), blank_id=6))(
            variables, images))
    assert per_seq[0] > 1e4
    got, state = _backward(module, train.ctc_loss_fn, images, labels, lengths)
    assert got == pytest.approx(per_seq[1:].sum() / 3, rel=LOSS_RTOL)
    assert all(bool(torch.isfinite(g).all()) for g in train.gradients(module, state))
    _, state_without = _backward(twin, train.ctc_loss_fn, images[1:], labels[1:], lengths[1:])
    for g, w in zip(train.gradients(module, state), train.gradients(twin, state_without)):
        torch.testing.assert_close(g, w * 2 / 3, rtol=0, atol=1e-6)


def test_recognizer_trajectory_matches_jitted_jax_step():
    """3 steps of the tiny recognizer against jax.jit(make_train_step)."""
    lr = 1e-3
    module, flax_model, variables = _rec_pair("s2d_group_lstm", seed=2)
    jopt = jax_train.make_optimizer(lr)
    jstate = jax_train.TrainState(variables, jopt.init(variables), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_train.make_train_step(flax_model, jopt))
    state = train.init_train_state(module, train.make_optimizer(lr), device="cpu")
    step = train.make_train_step(module, train.make_optimizer(lr))
    for i in range(3):
        batch = _ctc_batch(10 + i)
        jstate, jloss = jstep(jstate, *batch)
        state, loss = step(state, *batch)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    assert state.step == 3 and state.opt_state.count == 3
    got = _leaves(_sorted(convert.recognizer_params_to_flax(module)))
    want = _leaves(_sorted(jax.tree_util.tree_map(np.asarray, jstate.params)))
    for (path, a), (_, b) in zip(got, want):
        name = jax.tree_util.keystr(path)
        # A conv bias under a GroupNorm of one channel a group has an
        # exact gradient of 0: Adam moves it by +-lr on rounding noise.
        noise = re.search(r"Conv_\d+'\]\['bias", name) and "VGGEncoder" in name
        assert np.abs(a - b).max() <= (6 if noise else 0.01) * lr, name


# ----------------------------------------------------------------------
# clip + AdamW
@pytest.mark.parametrize("grad_scale,lr_scale", [(0.01, 1.0), (10.0, 1.0), (10.0, 0.25)],
                         ids=["unclipped", "clipped", "clipped_scaled"])
def test_clip_adamw_matches_optax(grad_scale, lr_scale):
    """Three steps of optax's chain(clip_by_global_norm(1), adamw(lr))
    (weight decay 1e-4 on every leaf); ``lr_scale`` multiplies the whole
    update, as bench.py scales adamw(1.0)'s."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3), ()]
    params = [jnp.asarray(rng.standard_normal(s), jnp.float32) for s in shapes]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(3e-3))
    jparams, jstate = list(params), None
    jstate = tx.init(jparams)
    ours = train.make_optimizer(3e-3)
    tparams = [torch.tensor(np.asarray(p)) for p in params]
    tstate = ours.init(tparams)
    for step in range(3):
        grads = [jnp.asarray(grad_scale * rng.standard_normal(s), jnp.float32) for s in shapes]
        updates, jstate = tx.update(grads, jstate, jparams)
        updates = jax.tree_util.tree_map(lambda u: u * lr_scale, updates)
        jparams = optax.apply_updates(jparams, updates)
        tstate = ours.step_(tparams, [torch.tensor(np.asarray(g)) for g in grads], tstate,
                            lr_scale)
        norm = np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum()) for g in grads))
        assert float(tstate.grad_norm) == pytest.approx(norm, rel=1e-6)
        for got, want in zip(tparams, jparams):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_clip_is_exactly_optax_at_the_threshold():
    grads = [torch.tensor([0.6, 0.8])]  # norm 1.0: clipped, optax's ">= max_norm"
    clipped, norm = optim.clip_by_global_norm(grads, 1.0)
    want, _ = optax.clip_by_global_norm(1.0).update([np.array([0.6, 0.8], np.float32)], None)
    assert float(norm) == pytest.approx(1.0)
    np.testing.assert_array_equal(clipped[0].numpy(), np.asarray(want[0]))
    small = [torch.tensor([0.3, 0.4])]
    assert torch.equal(optim.clip_by_global_norm(small, 1.0)[0][0], small[0])


def test_bias_ih_is_frozen_and_out_of_the_update():
    """nn.LSTM's bias_ih (flax has none) is folded into bias_hh, zero,
    untrained, out of the weight decay and the global norm."""
    module = CTCRecognizer(RecognizerSpec(num_classes=7, line_height=16, conv_features=(4, 8),
                                          lstm_layers=1, lstm_features=8, dtype=torch.float32),
                           generator=torch.Generator().manual_seed(0))
    sums = {n: (module.blstm.lstm.get_parameter(n) + module.blstm.lstm.get_parameter(
        n.replace("hh", "ih"))).detach().clone() for n in ("bias_hh_l0", "bias_hh_l0_reverse")}
    state = train.init_train_state(module, train.make_optimizer(1e-2), device="cpu")
    frozen = [n for n in dict(module.named_parameters()) if "bias_ih" in n]
    assert frozen and not any(n in state.params for n in frozen)
    for n, s in sums.items():
        torch.testing.assert_close(module.blstm.lstm.get_parameter(n), s, rtol=0, atol=1e-7)
    step = train.make_train_step(module, train.make_optimizer(1e-2))
    for i in range(2):
        state, _ = step(state, *_ctc_batch(i))
    for n in frozen:
        p = module.get_parameter(n)
        assert not p.requires_grad and not p.any()


def test_bfloat16_spec_trains_from_float32_weights():
    """A bf16 spec computes in bf16 from float32 weights: the state's
    weights stay float32, the module's are their bf16 rounding, and the
    loss falls on a fixed batch."""
    module = CTCRecognizer(RecognizerSpec(num_classes=7, line_height=16, conv_features=(4, 8),
                                          lstm_layers=1, lstm_features=8),
                           generator=torch.Generator().manual_seed(0))
    state = train.init_train_state(module, train.make_optimizer(3e-3), device="cpu")
    step = train.make_train_step(module, train.make_optimizer(3e-3))
    batch = _ctc_batch(5)
    losses = [float(step(state, *batch)[1]) for _ in range(12)]
    assert losses[-1] < 0.9 * losses[0], losses
    for (name, w), p in zip(state.params.items(), state.targets):
        assert w.dtype == torch.float32, name
        assert torch.equal(p, w.to(p.dtype)), name
    assert any(p.dtype == torch.bfloat16 for p in state.targets)


def test_trainers_default_to_cuda_and_the_mesh_is_not_ported():
    module = CTCRecognizer(RecognizerSpec(num_classes=7, line_height=16, conv_features=(4, 8),
                                          lstm_layers=1, lstm_features=8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.init_train_state(module, train.make_optimizer())
    for fn, args in ((train.shard_train_state, (None, None)),
                     (train.make_sharded_train_step, (module, None, None))):
        with pytest.raises(ValueError, match=SCALE_OUT):
            fn(*args)


# ----------------------------------------------------------------------
# ParseNet and OrientationNet
PHASES = {  # bench.py's first and third ParseNet phases: (height, off-mask, pos, hard-neg,
    # over); the third runs every term of the loss
    "masks": (0.01, 0.0, 1.0, 0.0, 1.0),
    "settle": (0.3, 0.05, 10.0, 8.0, 4.0),
}


def _parsenet_batch(seed, n=2, h=64, w=64, up=2):
    rng = np.random.default_rng(seed)
    images = rng.random((n, h, w, 3), np.float32)
    maps = np.zeros((n, h * up, w * up, 5), np.float32)
    maps[..., 2:5] = rng.random((n, h * up, w * up, 3)) < 0.05
    maps[..., 0:2] = rng.uniform(0, 6, (n, h * up, w * up, 2)) * maps[..., 2:3]
    return images, maps


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_parsenet_loss_and_gradients_match_jax(phase):
    hw, off, pos, hard, over = PHASES[phase]
    weights = dict(height_weight=hw, off_mask_height_weight=off, pos_weight=pos,
                   hard_neg_weight=hard, height_over_weight=over)
    kw = dict(base_features=4, depth=2, stem="s2d", out_upsample=2)
    flax_model = jax_parsenet.ParseNet(dtype=jnp.float32, **kw)
    variables = _perturbed(flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 1)
    module = ParseNet(dtype=torch.float32, **kw)
    module.load_state_dict(convert.parsenet_params_from_flax(variables))
    batch = _parsenet_batch(2)
    want, want_grads = _jax_value_and_grad(jax_train.parsenet_loss_fn, flax_model, variables,
                                           *batch, **weights)
    got, state = _backward(module, train.parsenet_loss_fn, *batch, **weights)
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    _assert_grads_close(_port_grads(module, state, convert.parsenet_params_to_flax), want_grads)


def _orientation_pair(seed=0):
    flax_model = jax_parsenet.OrientationNet(base_features=4, depth=2, dtype=jnp.float32)
    variables = _perturbed(flax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3))),
                           seed)
    module = OrientationNet(base_features=4, depth=2, dtype=torch.float32)
    module.load_state_dict(convert.orientation_params_from_flax(variables))
    return module, flax_model, variables


def test_orientation_net_forward_matches_jax():
    module, flax_model, variables = _orientation_pair()
    x = np.random.default_rng(3).random((2, 32, 48, 3), np.float32)
    want = np.asarray(flax_model.apply(variables, x))
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 48, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)
    default = OrientationNet()
    assert default.down_blocks[0].conv0.weight.dtype == torch.bfloat16
    assert default.out.weight.dtype == torch.float32
    assert len(default.down_blocks) == 3 and default.down_blocks[0].conv0.out_channels == 16


def test_orientation_loss_and_gradients_match_jax():
    module, flax_model, variables = _orientation_pair(1)
    rng = np.random.default_rng(4)
    images = rng.random((2, 32, 32, 3), np.float32)
    angles = rng.uniform(-np.pi, np.pi, (2, 32, 32))
    dirs = np.stack([np.cos(angles), np.sin(angles)], -1).astype(np.float32)
    mask = (rng.random((2, 32, 32)) < 0.3).astype(np.float32)
    want, want_grads = _jax_value_and_grad(jax_train.orientation_loss_fn, flax_model, variables,
                                           images, dirs, mask)
    got, state = _backward(module, train.orientation_loss_fn, images, dirs, mask)
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    _assert_grads_close(_port_grads(module, state, convert.orientation_params_to_flax),
                        want_grads)


# ----------------------------------------------------------------------
# the native transformer
def _transformer_pair(seed=0):
    kw = dict(num_classes=9, line_height=16, conv_features=(8, 16), subsampling=4, d_model=32,
              num_heads=4, encoder_layers=1, decoder_layers=2, mlp_dim=64, max_decode_len=32)
    flax_model = jax_tf.TransformerOCR(jax_tf.TransformerSpec(dtype=jnp.float32, **kw))
    variables = _perturbed(flax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 64, 3)),
                                           jnp.zeros((1, 4), jnp.int32)), seed, scale=0.05)
    module = tf.TransformerOCR(tf.TransformerSpec(dtype=torch.float32, **kw))
    module.load_state_dict(convert.transformer_params_from_flax(variables))
    return module, flax_model, variables


def test_transformer_loss_and_gradients_match_jax():
    module, flax_model, variables = _transformer_pair()
    rng = np.random.default_rng(5)
    images = rng.random((3, 16, 64, 3), np.float32)
    lengths = np.array([0, 3, 6], np.int32)
    targets = rng.integers(0, 9, (3, 6)).astype(np.int32)
    want, want_grads = _jax_value_and_grad(jax_train.transformer_loss_fn, flax_model, variables,
                                           images, targets, lengths)
    got, state = _backward(module, train.transformer_loss_fn, images, targets, lengths)
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    _assert_grads_close(_port_grads(module, state, convert.transformer_params_to_flax),
                        want_grads)


# ----------------------------------------------------------------------
# the character LM
def _lm_pair(cell_type, seed=0):
    spec = jax_charlm.CharLMSpec(vocab_size=7, embed_dim=8, hidden_dim=16, num_layers=2,
                                 cell_type=cell_type)
    flax_model = jax_charlm.CharLM(spec)
    variables = _perturbed(flax_model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1), jnp.int32)),
                           seed)
    module = charlm.CharLM(charlm.CharLMSpec(**convert.lm_spec_from_variables(variables)))
    module.load_state_dict(convert.charlm_params_from_flax(variables))
    return module, flax_model, variables


def _tokens(seed, n=3, length=9, vocab=7):
    return np.random.default_rng(seed).integers(0, vocab, (n, length)).astype(np.int32)


@pytest.mark.parametrize("cell_type", ["lstm", "gru"])
def test_lm_loss_and_gradients_match_jax(cell_type):
    module, flax_model, variables = _lm_pair(cell_type)
    tokens = _tokens(6)
    want, want_grads = _jax_value_and_grad(jax_train.lm_loss_fn, flax_model, variables, tokens)
    got, state = _backward(module, train.lm_loss_fn, tokens)
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    _assert_grads_close(_port_grads(module, state, convert.charlm_params_to_flax), want_grads)


@pytest.mark.parametrize("cell_type", ["lstm", "gru"])
def test_sequence_logprobs_and_state_helpers_match_jax(cell_type):
    module, flax_model, variables = _lm_pair(cell_type, seed=1)
    tokens = _tokens(7)
    want = np.asarray(jax_charlm.sequence_logprobs(flax_model, variables, jnp.asarray(tokens)))
    with torch.no_grad():
        got = charlm.sequence_logprobs(module, torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    def states(offset):
        with torch.no_grad():
            s = module.advance(torch.tensor([1, 2, 3, 4]) + offset, module.initial_state(4))
        js = flax_model.apply(variables, jnp.asarray([1, 2, 3, 4]) + offset,
                              flax_model.apply(variables, 4, method=jax_charlm.CharLM.initial_state),
                              method=jax_charlm.CharLM.advance)
        return s, js

    (a, ja), (b, jb) = states(0), states(2)
    idx = np.array([3, 0, 3])
    pairs = [
        (charlm.state_select(a, torch.from_numpy(idx)), jax_charlm.state_select(ja, idx)),
        (charlm.state_assign(a, torch.tensor([2, 0]), charlm.state_select(b, torch.tensor([1, 3]))),
         jax_charlm.state_assign(ja, np.array([2, 0]), jax_charlm.state_select(jb, np.array([1, 3])))),
        (charlm.state_concat([a, b, a]), jax_charlm.state_concat([ja, jb, ja])),
    ]
    for got_state, want_state in pairs:
        for g, w in zip(charlm.state_leaves(got_state), jax.tree_util.tree_leaves(want_state)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert charlm.state_leaves(a)[0].shape == (4, 16)  # state_assign copied, a is unchanged


@pytest.mark.parametrize("cell_type", ["lstm", "gru"])
def test_export_lm_checkpoint_loads_in_both_packages(tmp_path, cell_type):
    symbols = ["a", "b", "c", "d", "e", "f"]
    module = charlm.CharLM(charlm.CharLMSpec(vocab_size=7, embed_dim=8, hidden_dim=16,
                                             cell_type=cell_type),
                           generator=torch.Generator().manual_seed(2))
    path = str(tmp_path / "trained.lm")
    train.export_lm_checkpoint(module, path)
    with open(path + ".json") as f:
        assert json.load(f) == dataclasses.asdict(module.spec)
    ours = itf.construct_lm(path, symbols)
    theirs = jax_itf.construct_lm(path, symbols)
    for name, value in module.state_dict().items():
        assert torch.equal(ours.model.state_dict()[name], value), name
    h, jh = ours.initial_h(2), theirs.initial_h(2)
    for chars in ([0, 5], [3, 3]):
        h, jh = ours.advance_h0(np.asarray(chars), h), theirs.advance_h0(np.asarray(chars), jh)
        np.testing.assert_allclose(np.asarray(ours.log_probs(h)), np.asarray(theirs.log_probs(jh)),
                                   rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# checkpoints and converters
def _round_trip(module, to_flax, from_flax):
    """to_flax then from_flax gives the module's state dict exactly, and
    from_flax then to_flax the flax tree exactly."""
    variables = to_flax(module)
    back = from_flax(variables)
    sd = module.state_dict()
    assert set(back) <= set(sd)
    for name, value in sd.items():
        if name in back:
            assert torch.equal(back[name], value.float()), name
        else:  # a zero block flax lacks (nn.LSTM's bias_ih after folding)
            assert not value.any(), name
    fresh = type(module).__new__(type(module))
    fresh.__dict__ = dict(module.__dict__)
    fresh.load_state_dict({**sd, **back})
    _assert_trees_equal(to_flax(fresh), variables)


def _seeded(module, seed):
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(seed)))
            seed += 1
    return module


@pytest.mark.parametrize("kind", [
    "parsenet_s2d", "parsenet_conv", "orientation", "recognizer_lstm", "recognizer_no_lstm",
    "charlm_lstm", "charlm_gru", "transformer",
])
def test_converters_round_trip_exactly(kind):
    g = torch.Generator().manual_seed(0)
    if kind.startswith("parsenet"):
        stem = kind.split("_")[1]
        module = ParseNet(base_features=4, depth=3, stem=stem, out_upsample=2 if stem == "s2d" else 1,
                          dtype=torch.float32, generator=g)
        fns = convert.parsenet_params_to_flax, convert.parsenet_params_from_flax
    elif kind == "orientation":
        module = OrientationNet(base_features=4, depth=2, generator=g)
        fns = convert.orientation_params_to_flax, convert.orientation_params_from_flax
    elif kind.startswith("recognizer"):
        layers = 2 if kind.endswith("_lstm") else 0
        module = CTCRecognizer(RecognizerSpec(num_classes=7, line_height=16, conv_features=(4, 8),
                                              lstm_layers=layers, lstm_features=8, embed_num=2,
                                              embed_dim=4, norm="group", dtype=torch.float32),
                               generator=g)
        convert.fold_lstm_input_bias_(module)
        fns = convert.recognizer_params_to_flax, convert.recognizer_params_from_flax
    elif kind.startswith("charlm"):
        module = charlm.CharLM(charlm.CharLMSpec(vocab_size=7, embed_dim=8, hidden_dim=16,
                                                 cell_type=kind.split("_")[1]), generator=g)
        fns = convert.charlm_params_to_flax, convert.charlm_params_from_flax
    else:
        module = tf.TransformerOCR(tf.TransformerSpec(
            num_classes=9, line_height=16, conv_features=(8, 16), d_model=32, num_heads=4,
            encoder_layers=1, decoder_layers=1, mlp_dim=64, dtype=torch.float32))
    if kind == "transformer":
        _seeded(module, 1)
        fns = convert.transformer_params_to_flax, convert.transformer_params_from_flax
    elif not kind.startswith("recognizer"):
        _seeded(module, 1)
    _round_trip(module, *fns)


@pytest.mark.parametrize("kind", ["parsenet", "orientation", "recognizer", "charlm", "transformer"])
def test_to_flax_gives_the_jax_models_tree(kind):
    """The converters' flax trees have the JAX models' paths, shapes and
    dtypes, and the JAX model applied to them gives the port's outputs."""
    rng = np.random.default_rng(0)
    if kind == "parsenet":
        kw = dict(base_features=4, depth=2, stem="s2d", out_upsample=2)
        module = _seeded(ParseNet(dtype=torch.float32, **kw), 3)
        flax_model, to_flax = jax_parsenet.ParseNet(dtype=jnp.float32, **kw), convert.parsenet_params_to_flax
        inputs = (rng.random((1, 32, 32, 3), np.float32),)
        scale = 0.1
    elif kind == "orientation":
        module = OrientationNet(base_features=4, depth=2, dtype=torch.float32)
        flax_model = jax_parsenet.OrientationNet(base_features=4, depth=2, dtype=jnp.float32)
        to_flax, inputs, scale = convert.orientation_params_to_flax, (rng.random((1, 32, 32, 3), np.float32),), 0.1
    elif kind == "recognizer":
        spec = dict(num_classes=7, line_height=16, conv_features=(4, 8), lstm_layers=1,
                    lstm_features=8, stem="s2d", norm="group")
        module = CTCRecognizer(RecognizerSpec(dtype=torch.float32, **spec),
                               generator=torch.Generator().manual_seed(1))
        flax_model = FlaxRecognizer(FlaxSpec(dtype=jnp.float32, **spec))
        to_flax, inputs, scale = convert.recognizer_params_to_flax, (rng.random((2, 16, 48, 3), np.float32),), None
    elif kind == "charlm":
        module = charlm.CharLM(charlm.CharLMSpec(vocab_size=7, embed_dim=8, hidden_dim=16),
                               generator=torch.Generator().manual_seed(1))
        flax_model = jax_charlm.CharLM(jax_charlm.CharLMSpec(vocab_size=7, embed_dim=8, hidden_dim=16))
        to_flax, inputs, scale = convert.charlm_params_to_flax, (np.array([[3]], np.int32),), None
    else:
        kw = dict(num_classes=9, line_height=16, conv_features=(8, 16), d_model=32, num_heads=4,
                  encoder_layers=1, decoder_layers=1, mlp_dim=64)
        module = tf.TransformerOCR(tf.TransformerSpec(dtype=torch.float32, **kw),
                                   generator=torch.Generator().manual_seed(1))
        flax_model = jax_tf.TransformerOCR(jax_tf.TransformerSpec(dtype=jnp.float32, **kw))
        to_flax, scale = convert.transformer_params_to_flax, None
        inputs = (rng.random((2, 16, 32, 3), np.float32), np.array([[9, 1, 2], [9, 4, 4]], np.int32))
    if scale:
        _seeded(module, 5)
        with torch.no_grad():
            for p in module.parameters():
                p.mul_(scale)
    variables = to_flax(module)
    template = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0), *[jnp.asarray(x) for x in inputs])
    g, w = _leaves(_sorted(variables)), _leaves(_sorted(template))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    want = np.asarray(flax_model.apply(variables, *inputs))
    with torch.no_grad():
        got = module(*[torch.from_numpy(x).long() if x.dtype == np.int32 else torch.from_numpy(x)
                       for x in inputs]) if kind != "charlm" else module.log_probs(
            module.advance(torch.tensor([3]), module.initial_state(1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FORWARD_ATOL)


def test_save_variables_writes_flax_bytes_that_both_packages_read(tmp_path):
    module = CTCRecognizer(RecognizerSpec(num_classes=7, line_height=16, conv_features=(4, 8),
                                          lstm_layers=1, lstm_features=8, norm="group",
                                          dtype=torch.float32),
                           generator=torch.Generator().manual_seed(1))
    convert.fold_lstm_input_bias_(module)
    variables = convert.recognizer_params_to_flax(module)
    variables["extra"] = {"step": 3, "bf16": torch.ones((2, 3), dtype=torch.bfloat16),
                          "u8": np.arange(6, dtype=np.uint8)}
    path = str(tmp_path / "rec.msgpack")
    checkpoint.save_variables(variables, path)
    with open(path, "rb") as f:
        data = f.read()
    flax_tree = dict(variables, extra=dict(variables["extra"],
                                           bf16=jnp.ones((2, 3), jnp.bfloat16)))
    assert data == flax.serialization.to_bytes(flax_tree)
    template = jax.tree_util.tree_map(np.zeros_like, jax.tree_util.tree_map(np.asarray, flax_tree))
    restored = jax_checkpoint.load_variables(path, template)
    _assert_trees_equal(restored["params"], variables["params"])
    ours = checkpoint.load_variables(path)
    _assert_trees_equal(ours["params"], variables["params"])
    assert torch.equal(ours["extra"]["bf16"], variables["extra"]["bf16"])
    reloaded = CTCRecognizer(module.spec)
    reloaded.load_state_dict(convert.recognizer_params_from_flax(ours))
    for name, value in module.state_dict().items():
        assert torch.equal(reloaded.state_dict()[name], value), name


def test_msgpack_serialize_matches_flax_with_chunks(monkeypatch):
    """Arrays over the chunk limit are written as flax chunks them (the
    limit lowered to 64 bytes on both sides), in the key order of
    ``to_bytes`` (flax's ``in_place=True``: as inserted)."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 64)

    def tree():
        return {"q": np.arange(3, dtype=np.float32),
                "p": {"k": np.arange(50, dtype=np.float32), "b": np.arange(20, dtype=np.int16)}}

    assert checkpoint.msgpack_serialize(tree()) == \
        flax.serialization.msgpack_serialize(tree(), in_place=True)
    with pytest.raises(TypeError, match="cannot pack float"):
        checkpoint.packb({"lr": 0.5})
    restored = checkpoint.msgpack_restore(checkpoint.msgpack_serialize(tree()))
    _assert_trees_equal(_sorted(restored), _sorted(tree()))
