"""The port's transformer recognizers against the JAX package's, on the
CPU, at a small width (dim 32, feed-forward 64, 4 heads, 2 + 2 layers,
line height 16).

- Reference model (``models/transformer_ref.py``): a state dict of stock
  torch modules in the reference's layout (tests/test_convert_torch.py)
  loads into the port with ``strict=True`` and gives the stock model's
  logits; the port's seeded weights go to the JAX mirror through
  ``convert_torch_transformer``.  ``encode``, ``decode_train`` and
  ``greedy_decode_ref``'s logits within 1e-4; tokens and lengths equal
  (the port projects the cross-attention's keys and values once a
  batch, JAX every step).
- Native model (``models/transformer.py``) in float32 (the spec's dtype
  replaced on both sides), the flax variables carried across by
  ``transformer_params_from_flax``: ``greedy_decode``'s tokens and
  lengths equal, confidences within 1e-5, the teacher-forced logits
  within 1e-4; ``beam_decode`` with k = 1 equals greedy, with k = 3 its
  tokens and lengths equal JAX's.
- The native engine reads a flax msgpack checkpoint that the JAX
  package's ``save_variables`` wrote: the same weights.
- Native model in bfloat16 (the spec's default): the teacher-forced
  logits within BF16_LOGITS_ATOL of JAX's; tokens and lengths equal, or
  the first differing step a near-tie (JAX's two best logits within
  that bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pero_ocr_tpu.models import transformer as jax_tf
from pero_ocr_tpu.models import transformer_ref as jax_ref
from pero_ocr_tpu.utils.convert_torch import convert_torch_transformer
from pero_ocr_tpu_torch.models import transformer as tf
from pero_ocr_tpu_torch.models import transformer_ref as ref
from pero_ocr_tpu_torch.utils.convert import transformer_params_from_flax
from tests.test_convert_torch import _TorchRefTransformer

TOL = 1e-4
# bfloat16 native model, teacher-forced logits (magnitude ~2): the two
# frameworks round to bfloat16 at other places; measured max |diff|
# 0.0216 on these inputs (a few bfloat16 steps through 2 + 2 layers).
BF16_LOGITS_ATOL = 0.05
HEIGHT = 16
NUM_SYMBOLS = 12  # 10 characters + the boundary and ignore specials


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The decode loops are thousands of tiny ops: one intra-op thread
    each (the test workers share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed: int, n: int = 3, width: int = 64) -> np.ndarray:
    """(n, HEIGHT, width, 3) in [0, 1]: 8x8 blocks of seeded values, each
    line darkened by its own factor (the random models tell such lines
    apart; they answer fine noise alike)."""
    rng = np.random.default_rng(seed)
    blocks = rng.uniform(size=(n, HEIGHT // 8, width // 8, 3))
    images = np.repeat(np.repeat(blocks, 8, 1), 8, 2) * rng.uniform(0.2, 1.0, (n, 1, 1, 1))
    return images.astype(np.float32)


def _ref_spec(module):
    return module.RefTransformerSpec(num_symbols=NUM_SYMBOLS, in_height=HEIGHT, dim_model=32,
                                     dim_ff=64, heads=4, encoder_layers=2, decoder_layers=2,
                                     max_seq_len=32)


@pytest.fixture(scope="module")
def ref_pair():
    """(port model, JAX model, JAX variables) of one state dict of the
    reference's layout: the port's seeded random weights, BatchNorm
    statistics non-trivial, the boundary's bias raised so that lines end
    at different steps."""
    gen = torch.Generator().manual_seed(1)
    ours = ref.RefTransformerOCR(_ref_spec(ref), generator=gen).eval()
    bn = ours.encoder_frontend.blocks_2d[21]
    with torch.no_grad():
        bn.running_mean.uniform_(-0.3, 0.3, generator=gen)
        bn.running_var.uniform_(0.5, 1.5, generator=gen)
        bn.weight.uniform_(0.8, 1.2, generator=gen)
        bn.bias.uniform_(-0.2, 0.2, generator=gen)
        ours.dec_out_proj.bias[NUM_SYMBOLS - 2] += 0.9
    variables = jax.tree_util.tree_map(jnp.asarray, convert_torch_transformer(
        ours.state_dict(), heads=4, encoder_layers=2, decoder_layers=2))
    return ours, jax_ref.RefTransformerOCR(_ref_spec(jax_ref)), variables


def test_ref_loads_a_stock_torch_state_dict_unconverted():
    """A state dict of the reference's modules (stock torch layers)
    loads with strict=True and gives the stock model's outputs."""
    torch.manual_seed(1)
    stock = _TorchRefTransformer(NUM_SYMBOLS, 32, 64, 4, enc_layers=2, dec_layers=2,
                                 in_height=HEIGHT, max_seq_len=32).eval()
    ours = ref.RefTransformerOCR(_ref_spec(ref)).eval()
    ours.load_state_dict(stock.state_dict(), strict=True)
    x = _images(7)
    targets = torch.from_numpy(np.random.default_rng(7).integers(0, NUM_SYMBOLS, (3, 5)))
    with torch.inference_mode():
        want = stock(torch.from_numpy(x).permute(0, 3, 1, 2), targets).transpose(0, 1)
        got = ours(torch.from_numpy(x), targets)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    assert ref.vgg_frontend_plan((8, 4)) == jax_ref.vgg_frontend_plan((8, 4))


def test_ref_encode_and_decode_train_match_jax(ref_pair):
    ours, theirs, variables = ref_pair
    x = _images(0)
    targets = np.random.default_rng(1).integers(0, NUM_SYMBOLS, (3, 7))
    with torch.inference_mode():
        memory = ours.encode(torch.from_numpy(x))
        logits = ours.decode_train(memory, torch.from_numpy(targets))
    jmemory = theirs.apply(variables, jnp.asarray(x), method=jax_ref.RefTransformerOCR.encode)
    jlogits = theirs.apply(variables, jmemory, jnp.asarray(targets, jnp.int32),
                           method=jax_ref.RefTransformerOCR.decode_train)
    assert memory.shape == (3, 16, 32)
    np.testing.assert_allclose(memory.numpy(), np.asarray(jmemory), rtol=0, atol=TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=TOL)


@pytest.mark.parametrize("width,max_len", [(64, 16), (96, 24)])
def test_ref_greedy_decode_matches_jax(ref_pair, width, max_len):
    ours, theirs, variables = ref_pair
    x = _images(2, n=4, width=width)
    with torch.inference_mode():
        tokens, lengths, logits = ref.greedy_decode_ref(ours, torch.from_numpy(x), max_len)
    jtokens, jlengths, jlogits = jax_ref.greedy_decode_ref(theirs, variables, jnp.asarray(x),
                                                           max_len)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=TOL)
    # Lines end at different steps, and dead lines emit the boundary.
    assert len(set(lengths.tolist())) > 1 and lengths.min() < max_len
    boundary = NUM_SYMBOLS - 2
    for row, n in zip(tokens.numpy(), lengths.numpy()):
        assert (row[n:] == boundary).all() and (row[:n] != boundary).all()


def test_decode_length_past_the_position_table_raises(ref_pair):
    with pytest.raises(ValueError, match="position table"):
        ref.greedy_decode_ref(ref_pair[0], torch.from_numpy(_images(0)), 33)


# ----------------------------------------------------------------------
# The native pre-LN model
def _native_pair(dtype):
    jspec = jax_tf.TransformerSpec(num_classes=9, line_height=HEIGHT, conv_features=(8, 16),
                                   subsampling=4, d_model=32, num_heads=4, encoder_layers=2,
                                   decoder_layers=2, mlp_dim=64, max_decode_len=32)
    jspec = dataclasses.replace(jspec, dtype=dtype)
    theirs = jax_tf.TransformerOCR(jspec)
    variables = theirs.init(jax.random.PRNGKey(3), jnp.zeros((1, HEIGHT, 64, 3)),
                            jnp.zeros((1, 4), jnp.int32))
    # Raise EOS so that lines end at different steps.
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["out_proj"]["bias"][jspec.eos_id] = 1.5
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params)}
    spec = tf.TransformerSpec(num_classes=9, line_height=HEIGHT, conv_features=(8, 16),
                              subsampling=4, d_model=32, num_heads=4, encoder_layers=2,
                              decoder_layers=2, mlp_dim=64, max_decode_len=32,
                              dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    ours = tf.TransformerOCR(spec).eval()
    ours.load_state_dict(transformer_params_from_flax(variables), strict=True)
    return ours, theirs, variables


@pytest.fixture(scope="module")
def native_f32():
    return _native_pair(jnp.float32)


def _teacher_forced(model, images, tokens):
    bos = torch.full((tokens.shape[0], 1), model.spec.bos_id, dtype=torch.int64)
    with torch.inference_mode():
        return model.decode_train(model.encode(images), torch.cat([bos, tokens[:, :-1]], 1))


def _jax_teacher_forced(model, variables, images, tokens):
    bos = jnp.full((tokens.shape[0], 1), model.spec.bos_id, jnp.int32)
    prefixed = jnp.concatenate([bos, jnp.asarray(tokens, jnp.int32)[:, :-1]], axis=1)
    memory = model.apply(variables, images, method=jax_tf.TransformerOCR.encode)
    return model.apply(variables, memory, prefixed, method=jax_tf.TransformerOCR.decode_train)


def test_native_greedy_decode_matches_jax(native_f32):
    ours, theirs, variables = native_f32
    x = _images(4, n=4)
    with torch.inference_mode():
        tokens, lengths, conf = tf.greedy_decode(ours, torch.from_numpy(x), 16)
    jtokens, jlengths, jconf = jax_tf.greedy_decode(theirs, variables, jnp.asarray(x), 16)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=0, atol=1e-5)
    assert len(set(lengths.tolist())) > 1 and lengths.max() < 16
    logits = _teacher_forced(ours, torch.from_numpy(x), tokens)
    jlogits = _jax_teacher_forced(theirs, variables, jnp.asarray(x), np.asarray(jtokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=TOL)


def test_native_beam_decode_matches_jax_and_greedy(native_f32):
    ours, theirs, variables = native_f32
    x = _images(5, n=3)
    with torch.inference_mode():
        greedy = tf.greedy_decode(ours, torch.from_numpy(x), 16)
        one = tf.beam_decode(ours, torch.from_numpy(x), 16, k=1)
        three = tf.beam_decode(ours, torch.from_numpy(x), 16, k=3)
    for a, b in zip(greedy[:2], one[:2]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(one[2].numpy(), greedy[2].numpy(), rtol=0, atol=1e-5)
    jtokens, jlengths, jconf = jax_tf.beam_decode(theirs, variables, jnp.asarray(x), 16, k=3)
    np.testing.assert_array_equal(three[0].numpy(), np.asarray(jtokens))
    np.testing.assert_array_equal(three[1].numpy(), np.asarray(jlengths))
    np.testing.assert_allclose(three[2].numpy(), np.asarray(jconf), rtol=0, atol=1e-5)


def test_native_bfloat16_within_measured_bound():
    ours, theirs, variables = _native_pair(jnp.bfloat16)
    assert ours.embed.weight.dtype == torch.bfloat16 and ours.out_proj.weight.dtype == torch.float32
    x = _images(6, n=4)
    with torch.inference_mode():
        tokens, lengths, _ = tf.greedy_decode(ours, torch.from_numpy(x), 16)
    jtokens, jlengths, _ = jax_tf.greedy_decode(theirs, variables, jnp.asarray(x), 16)
    jtokens = np.asarray(jtokens)
    # The same target tokens on both sides (JAX's), teacher-forced.
    logits = _teacher_forced(ours, torch.from_numpy(x), torch.from_numpy(jtokens).long()).numpy()
    jlogits = np.asarray(_jax_teacher_forced(theirs, variables, jnp.asarray(x), jtokens))
    assert np.abs(logits - jlogits).max() <= BF16_LOGITS_ATOL
    # A line's tokens and length equal JAX's, or its first difference is
    # a near-tie: JAX's two best logits there within the bound.
    best2 = np.sort(jlogits, axis=-1)[..., -2:]
    equal = 0
    for i, (got, want) in enumerate(zip(tokens.numpy(), jtokens)):
        if np.array_equal(got, want):
            assert int(lengths[i]) == int(jlengths[i])
            equal += 1
            continue
        t = int(np.flatnonzero(got != want)[0])
        assert best2[i, t, 1] - best2[i, t, 0] <= BF16_LOGITS_ATOL, (i, t)
    assert equal >= 3


def test_native_engine_loads_the_jax_packages_checkpoint(native_f32, tmp_path):
    """An OCR JSON without ``net_name`` and a flax msgpack checkpoint
    written by the JAX package's ``save_variables``: the port's engine
    holds those weights (in the spec's bfloat16, LayerNorms and the
    output projection in float32) and recognizes with the transformer's
    one-frame-a-character logits."""
    import json

    from pero_ocr_tpu.utils.checkpoint import save_variables
    from pero_ocr_tpu_torch.ocr.transformer_engine import TransformerEngineLineOCR

    variables = native_f32[2]
    save_variables(variables, str(tmp_path / "native.msgpack"))
    (tmp_path / "ocr.json").write_text(json.dumps({
        "characters": list("abcdefghi"), "line_px_height": HEIGHT,
        "checkpoint": "native.msgpack", "net_spec": {
            "conv_features": [8, 16], "subsampling": 4, "d_model": 32, "num_heads": 4,
            "encoder_layers": 2, "decoder_layers": 2, "mlp_dim": 64, "max_decode_len": 32}}))
    engine = TransformerEngineLineOCR(str(tmp_path / "ocr.json"), device="cpu")
    assert not engine.ref_mode and engine.spec.dtype == torch.bfloat16
    got, want = engine.model.state_dict(), transformer_params_from_flax(variables)
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value.to(got[name].dtype)), name
    assert got["embed.weight"].dtype == torch.bfloat16
    assert got["out_proj.weight"].dtype == got["decoder_norm.weight"].dtype == torch.float32
    line = (_images(9, n=1)[0] * 255).astype(np.uint8)
    texts, logits, coords = engine.process_lines([line])
    assert coords == [[0, len(texts[0])]]
    # A row a decoded token (the start id among them drops from the text).
    assert logits[0].shape[1] == 10 and logits[0].shape[0] >= len(texts[0])
