"""The native transformer's ``src_valid`` key masks (``encode``,
``decode_train`` and the cached ``decode_step`` of
``models/transformer.py``) against the JAX package's, on the CPU, in
float32 at the width of ``test_torch_transformer.py`` (dim 32, 4 heads,
2 + 2 layers), the flax variables carried across by
``transformer_params_from_flax``.

A batch of four lines whose masks keep 16, 11, 3 and 0 of the 16 memory
frames (the last line's mask is all False: every key takes the dtype's
minimum and the softmax spreads evenly, as flax's does): the encoder
output, the teacher-forced logits and three cached steps' logits within
1e-4.  The masks change the outputs (against no mask), and
``greedy_decode`` takes ``src_valid`` and ignores it, as JAX's does
(``pero_ocr_tpu/models/transformer.py:249`` passes it to nothing; its
greedy decode is held to JAX's in test_torch_transformer.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pero_ocr_tpu.models import transformer as jax_tf
from pero_ocr_tpu_torch.models import transformer as tf
from pero_ocr_tpu_torch.utils.convert import transformer_params_from_flax
from tests.test_torch_transformer import HEIGHT, _images

TOL = 1e-4
KEEP = [16, 11, 3, 0]
SPEC = dict(num_classes=9, line_height=HEIGHT, conv_features=(8, 16), subsampling=4,
            d_model=32, num_heads=4, encoder_layers=2, decoder_layers=2, mlp_dim=64,
            max_decode_len=32)


@pytest.fixture(scope="module")
def pair():
    """(port model, JAX model, JAX variables): test_torch_transformer's
    float32 native pair (EOS raised so that lines end apart), the flax
    initialisation jitted."""
    theirs = jax_tf.TransformerOCR(jax_tf.TransformerSpec(**SPEC, dtype=jnp.float32))
    variables = jax.jit(theirs.init)(jax.random.PRNGKey(3), jnp.zeros((1, HEIGHT, 64, 3)),
                                     jnp.zeros((1, 4), jnp.int32))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["out_proj"]["bias"][theirs.spec.eos_id] = 1.5
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    ours = tf.TransformerOCR(tf.TransformerSpec(**SPEC, dtype=torch.float32)).eval()
    ours.load_state_dict(transformer_params_from_flax(variables), strict=True)
    return ours, theirs, variables


def _inputs():
    x = _images(11, n=len(KEEP))
    valid = np.arange(16)[None, :] < np.array(KEEP)[:, None]
    targets = np.random.default_rng(12).integers(0, 9, (len(KEEP), 6))
    return x, valid, targets


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


def test_encode_and_decode_train_mask_like_jax(pair):
    ours, theirs, variables = pair
    x, valid, targets = _inputs()
    with torch.inference_mode():
        memory = ours.encode(torch.from_numpy(x), torch.from_numpy(valid))
        logits = ours.decode_train(memory, torch.from_numpy(targets), torch.from_numpy(valid))
        unmasked = ours.encode(torch.from_numpy(x))
    jmemory = jax.jit(functools.partial(theirs.apply, method=jax_tf.TransformerOCR.encode))(
        variables, jnp.asarray(x), jnp.asarray(valid))
    jlogits = jax.jit(functools.partial(
        theirs.apply, method=jax_tf.TransformerOCR.decode_train))(
        variables, jmemory, jnp.asarray(targets, jnp.int32), jnp.asarray(valid))
    assert memory.shape == jmemory.shape == (len(KEEP), 16, 32)
    _close(memory, jmemory)
    _close(logits, jlogits)
    # The first line keeps every frame: its memory is the unmasked one.
    _close(memory[0], unmasked[0])
    assert (memory[1:] - unmasked[1:]).abs().max() > 1e-3


def test_cached_steps_mask_like_jax(pair):
    ours, theirs, variables = pair
    x, valid, targets = _inputs()
    n, max_len = len(KEEP), 8
    jmemory = jax.jit(functools.partial(theirs.apply, method=jax_tf.TransformerOCR.encode))(
        variables, jnp.asarray(x))
    decode_model = jax_tf.TransformerOCR(theirs.spec, decode=True)
    _, cache_vars = jax.jit(functools.partial(
        decode_model.apply, method=jax_tf.TransformerOCR.init_cache, mutable=["cache"]),
        static_argnums=2)({"params": variables["params"]}, jmemory, max_len)
    cache_j = cache_vars["cache"]
    jax_step = jax.jit(functools.partial(
        decode_model.apply, method=jax_tf.TransformerOCR.decode_step, mutable=["cache"]))
    with torch.inference_mode():
        memory = ours.encode(torch.from_numpy(x))
        cache = ours.init_cache(n, max_len, "cpu")
        cross = ours.cross_kv(memory)
        unmasked_cache = ours.init_cache(n, max_len, "cpu")
        tokens = np.concatenate([np.full((n, 1), theirs.spec.bos_id), targets[:, :2]], 1)
        for pos in range(3):
            token = tokens[:, pos]
            got = ours.decode_step(torch.from_numpy(token), pos, cache, cross,
                                   torch.from_numpy(valid))
            plain = ours.decode_step(torch.from_numpy(token), pos, unmasked_cache, cross)
            want, new_vars = jax_step(
                {"params": variables["params"], "cache": cache_j}, jmemory,
                jnp.asarray(token, jnp.int32), jnp.full((n,), pos, jnp.int32),
                jnp.asarray(valid))
            cache_j = new_vars["cache"]
            assert got.shape == want.shape == (n, theirs.spec.vocab)
            _close(got, want)
            _close(got[0], plain[0])
            assert (got[1:] - plain[1:]).abs().max() > 1e-3


def test_greedy_decode_ignores_src_valid(pair):
    ours = pair[0]
    x, valid, _ = _inputs()
    with torch.inference_mode():
        masked = tf.greedy_decode(ours, torch.from_numpy(x), 8, src_valid=torch.from_numpy(valid))
        plain = tf.greedy_decode(ours, torch.from_numpy(x), 8)
    for a, b in zip(masked, plain):
        assert np.array_equal(a.numpy(), b.numpy())
    assert (masked[1] > 0).any()  # lines were decoded
