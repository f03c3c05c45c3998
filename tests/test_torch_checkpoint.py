"""The port's flax msgpack reader (pero_ocr_tpu_torch.utils.checkpoint)
against the msgpack package and flax.serialization, and its writer
(``save_variables``) and torch-to-flax mapping (utils/convert.py's
``*_params_to_flax``, which chip_smoke.py writes its checkpoints with)
against flax and utils/convert.py.

Tolerances: the reader and the writer are exact (every leaf's dtype,
shape and bytes).  The JAX models applied to the mapping's output match
the torch modules in float32 within 1e-4, as tests/test_torch_models.py
holds the converter.
"""

import logging
import struct

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke
from pero_ocr_tpu.models.parsenet import ParseNet as FlaxParseNet
from pero_ocr_tpu.models.recognizer import (
    CTCRecognizer as FlaxRecognizer,
    RecognizerSpec as FlaxSpec,
)
from pero_ocr_tpu.utils.checkpoint import save_variables
from pero_ocr_tpu_torch.layout_engines.parsenet_wrapper import ParseNetWrapper
from pero_ocr_tpu_torch.models.parsenet import ParseNet
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.utils import checkpoint, convert

F32_TOL = 1e-4
BENCH_PARSENET = dict(base_features=32, depth=4, stem="s2d", out_upsample=2)
BENCH_RECOGNIZER = dict(num_classes=80, line_height=32, conv_features=(48, 96, 192, 384),
                        subsampling=4, lstm_layers=2, lstm_features=256, stem="s2d",
                        norm="group")


def _random_variables(model, *inputs, seed=0):
    """The model's variables tree with seeded random leaves of the right
    shapes and dtypes (shapes from jax.eval_shape: no compile)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes
    )


def _assert_same_tree(got, want):
    """Leaf for leaf: the same paths, dtypes, shapes and bytes."""
    got_leaves = jax.tree_util.tree_leaves_with_path(got, is_leaf=torch.is_tensor)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16, path
            assert tuple(g.shape) == w.shape, path
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            assert isinstance(g, (np.ndarray, np.generic)), path
            assert g.dtype == w.dtype and g.shape == w.shape, path
            np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------------
# msgpack
_scalars = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=40))
_values = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=6) | st.dictionaries(st.text(max_size=6), inner,
                                                                max_size=6),
    max_leaves=40,
)


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(_values, st.booleans())
def test_unpackb_matches_msgpack(value, single_float):
    data = msgpack.packb(value, use_single_float=single_float)
    assert checkpoint.unpackb(data) == msgpack.unpackb(data, raw=False)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_unpackb_every_length_width(n):
    """fix/8/16/32-bit lengths of str, bin, arrays, maps and ext."""
    value = {"s": "x" * n, "b": b"\x01" * n, "a": list(range(n % 300)) + [None] * (n - n % 300),
             "m": {str(i): i for i in range(n)}}
    data = msgpack.packb(value)
    assert checkpoint.unpackb(data) == msgpack.unpackb(data, raw=False)
    ext = msgpack.ExtType(5, bytes(range(256)) * (n // 256) + bytes(n % 256))
    assert checkpoint.unpackb(msgpack.packb(ext)) == ext


def test_unpackb_every_int_and_float_width():
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    floats = [0.0, -0.0, 1.5, 1e300, float("inf"), -float("inf")]
    for single in (False, True):
        data = msgpack.packb(ints + floats, use_single_float=single)
        assert checkpoint.unpackb(data) == msgpack.unpackb(data)
    # Fixed-size extension objects, a negative code, and trailing bytes.
    for n in (1, 2, 4, 8, 16):
        ext = msgpack.ExtType(7, bytes(range(n)))
        assert checkpoint.unpackb(msgpack.packb(ext)) == ext
    assert checkpoint.unpackb(b"\xd4\xf9\x2a") == (-7, b"\x2a")  # fixext 1, code -7
    with pytest.raises(ValueError, match="trailing"):
        checkpoint.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="ends inside"):
        checkpoint.unpackb(msgpack.packb("abcdef")[:-1])
    with pytest.raises(ValueError, match="0xc1"):
        checkpoint.unpackb(b"\xc1")


# ----------------------------------------------------------------------
# flax's format
@pytest.mark.parametrize("which", ["parsenet", "recognizer"])
def test_bench_width_checkpoints_read_exactly(which, tmp_path):
    if which == "parsenet":
        model = FlaxParseNet(**BENCH_PARSENET)
        variables = _random_variables(model, jnp.zeros((1, 64, 64, 3)))
    else:
        model = FlaxRecognizer(FlaxSpec(**BENCH_RECOGNIZER))
        variables = _random_variables(model, jnp.zeros((1, 32, 64, 3)))
    path = str(tmp_path / f"{which}.msgpack")
    save_variables(variables, path)
    with open(path, "rb") as f:
        want = flax.serialization.msgpack_restore(f.read())
    _assert_same_tree(checkpoint.load_variables(path), want)
    # And the converter takes the tree as read.
    convert_fn = (convert.parsenet_params_from_flax if which == "parsenet"
                  else convert.recognizer_params_from_flax)
    module = (ParseNet(**BENCH_PARSENET) if which == "parsenet"
              else CTCRecognizer(RecognizerSpec(**BENCH_RECOGNIZER)))
    module.load_state_dict(convert_fn(checkpoint.load_variables(path)))


def test_bf16_scalars_complex_and_chunked_arrays(monkeypatch):
    """bfloat16 leaves become torch.bfloat16; numpy scalars, complex
    numbers and arrays over flax's chunk size (lowered to 64 bytes here)
    come back as flax restores them."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {
        "bf16": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
        "bf16_chunked": jnp.asarray(rng.standard_normal((7, 9)), jnp.bfloat16),
        "f32_chunked": rng.standard_normal((5, 11)).astype(np.float32),
        "i8": rng.integers(-128, 128, (4,), dtype=np.int8),
        "u64": np.arange(3, dtype=np.uint64),
        "bool": np.array([True, False]),
        "f16": np.ones((2, 2), np.float16),
        "scalars": {"f32": np.float32(1.25), "i64": np.int64(-3), "bf16": jnp.bfloat16(0.5)},
        "complex": 1.5 - 2j,
        "empty": np.zeros((0, 3), np.float32),
        "nested": {"x": {"y": np.float64(2.5)}},
    }
    data = flax.serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = checkpoint.msgpack_restore(data)
    want = flax.serialization.msgpack_restore(data)
    assert got["complex"] == want["complex"] == 1.5 - 2j
    scalar = got["scalars"]
    assert type(scalar["f32"]) is np.float32 and scalar["f32"] == 1.25
    assert type(scalar["i64"]) is np.int64 and scalar["i64"] == -3
    assert scalar["bf16"].dtype == torch.bfloat16 and float(scalar["bf16"]) == 0.5
    for key in ("complex", "scalars"):
        del got[key], want[key]
    _assert_same_tree(got, want)


def test_strict_and_lenient_loading(tmp_path, caplog):
    missing = str(tmp_path / "missing.msgpack")
    corrupt = tmp_path / "corrupt.msgpack"
    corrupt.write_bytes(b"\x92\x01")  # an array that ends early
    wrong = tmp_path / "wrong.msgpack"
    wrong.write_bytes(flax.serialization.msgpack_serialize({"params": {"x": np.zeros(2)}}))

    def init():
        return "init"

    def restore(tree):
        return ParseNetWrapper(None).model.load_state_dict(
            convert.parsenet_params_from_flax(tree))

    try:
        checkpoint.set_strict_loading(True)
        with pytest.raises(FileNotFoundError, match="--allow-random-weights"):
            checkpoint.load_or_init(missing, init, name="ParseNet")
        with pytest.raises(ValueError, match="Failed to load ParseNet checkpoint"):
            checkpoint.load_or_init(str(corrupt), init, name="ParseNet")
        with pytest.raises(ValueError, match="Failed to load ParseNet checkpoint"):
            checkpoint.load_or_init(str(wrong), init, name="ParseNet", restore=restore)
        with pytest.raises(FileNotFoundError):
            ParseNetWrapper(missing)
        checkpoint.set_strict_loading(False)
        with caplog.at_level(logging.WARNING):
            assert checkpoint.load_or_init(missing, init, name="ParseNet") == "init"
            assert checkpoint.load_or_init(str(corrupt), init, name="ParseNet") == "init"
            assert checkpoint.load_or_init(str(wrong), init, restore=restore) == "init"
            assert checkpoint.load_or_init(None, init) == "init"
        assert "RANDOM weights" in caplog.text and "using random init" in caplog.text
        # The fallback is the seeded torch init, the same on every call.
        a, b = ParseNetWrapper(missing).model, ParseNetWrapper(missing).model
        for x, y in zip(a.parameters(), b.parameters()):
            assert torch.equal(x, y)
    finally:
        checkpoint.set_strict_loading(False)


def test_torchscript_files_are_refused(tmp_path):
    path = tmp_path / "model.pt"
    path.write_bytes(b"PK\x03\x04" + bytes(16))
    assert checkpoint.is_torchscript_file(str(path))
    assert not checkpoint.is_torchscript_file(str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="TorchScript checkpoints"):
        ParseNetWrapper(str(path))


# ----------------------------------------------------------------------
# the writer and the torch-to-flax mapping
def test_chip_smoke_writer_restores_through_flax(tmp_path):
    rng = np.random.default_rng(1)
    tree = _random_variables(FlaxRecognizer(FlaxSpec(**BENCH_RECOGNIZER)),
                             jnp.zeros((1, 32, 64, 3)))
    tree["extra"] = {
        "k" * 40: np.zeros(()),                     # str8 key, a 0-d array
        **{f"many_{i}": rng.integers(0, 9, (i,)).astype(np.int32) for i in range(20)},
        "u8": np.arange(300, dtype=np.uint8).reshape(3, 100) % 7,
        "f64": rng.standard_normal((70000,)),       # ext32 payload
        "i16": np.arange(40000, dtype=np.int16),    # ext16 payload
        "tiny": np.zeros((0,), np.uint8),
    }
    path = str(tmp_path / "written.msgpack")
    checkpoint.save_variables(tree, path)
    with open(path, "rb") as f:
        data = f.read()
    _assert_same_tree(flax.serialization.msgpack_restore(data), tree)
    _assert_same_tree(checkpoint.msgpack_restore(data), tree)


def _perturbed(variables, seed):
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        treedef, [np.asarray(l) + 0.1 * rng.standard_normal(l.shape).astype(np.float32)
                  for l in leaves])


@pytest.mark.parametrize("stem,up", [("conv", 1), ("s2d", 2)])
def test_parsenet_mapping_inverts_convert(stem, up):
    kw = dict(base_features=8, depth=2, stem=stem, out_upsample=up)
    flax_model = FlaxParseNet(dtype=jnp.float32, **kw)
    variables = _perturbed(flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 0)
    module = ParseNet(dtype=torch.float32, **kw)
    module.load_state_dict(convert.parsenet_params_from_flax(variables))
    _assert_same_tree(convert.parsenet_params_to_flax(module), variables)

    seeded = ParseNet(dtype=torch.float32, generator=torch.Generator().manual_seed(3), **kw)
    with torch.no_grad():  # nonzero biases and norm parameters to place
        for p in seeded.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(4)))
    x = np.random.default_rng(1).random((2, 64, 128, 3), np.float32)
    want = seeded(torch.from_numpy(x)).detach().numpy()
    got = np.asarray(flax_model.apply(convert.parsenet_params_to_flax(seeded), x))
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("stem,norm,lstm_layers,embed_num", [
    ("conv", "none", 0, 3),
    ("s2d", "group", 1, 0),
    ("s2d", "none", 2, 3),
])
def test_recognizer_mapping_inverts_convert(stem, norm, lstm_layers, embed_num):
    kw = dict(num_classes=10, line_height=16, conv_features=(4, 8), subsampling=4,
              lstm_layers=lstm_layers, lstm_features=8, embed_num=embed_num, embed_dim=4,
              stem=stem, norm=norm)
    flax_model = FlaxRecognizer(FlaxSpec(dtype=jnp.float32, **kw))
    variables = _perturbed(flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 48, 3))), 0)
    module = CTCRecognizer(RecognizerSpec(dtype=torch.float32, **kw))
    module.load_state_dict(convert.recognizer_params_from_flax(variables))
    _assert_same_tree(convert.recognizer_params_to_flax(module), variables)

    # A seeded torch init has nonzero LSTM input biases: the mapping adds
    # them into flax's hidden biases.
    seeded = CTCRecognizer(RecognizerSpec(dtype=torch.float32, **kw),
                           generator=torch.Generator().manual_seed(3))
    x = np.random.default_rng(2).random((3, 16, 48, 3), np.float32)
    want = seeded(torch.from_numpy(x)).detach().numpy()
    got = np.asarray(flax_model.apply(convert.recognizer_params_to_flax(seeded), x))
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    # Folded in place, the module is exactly what its export loads into.
    if lstm_layers:
        convert.fold_lstm_input_bias_(seeded)
        reloaded = CTCRecognizer(RecognizerSpec(dtype=torch.float32, **kw))
        reloaded.load_state_dict(convert.recognizer_params_from_flax(
            convert.recognizer_params_to_flax(seeded)))
        for (name, p), q in zip(seeded.state_dict().items(), reloaded.state_dict().values()):
            assert torch.equal(p, q), name


def test_png_writer_reads_back():
    from pero_ocr_tpu_torch.utils.image_io import decode_png

    page = np.random.default_rng(0).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    data = chip_smoke.png_bytes(page)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", data[16:24]) == (5, 7)
    np.testing.assert_array_equal(decode_png(data), page)
