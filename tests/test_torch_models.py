"""Parity of the PyTorch models (pero_ocr_tpu_torch.models) with the flax
models they port, on the same numpy-seeded inputs and the same weights
converted by pero_ocr_tpu_torch.utils.convert.

Tolerances: float32 on both sides, max abs <= 1e-4 on maps and logits
(the two frameworks sum convolutions and GroupNorm statistics in other
orders).  bfloat16 on both sides rounds at other places (flax casts
params per op, torch stores bf16 params), so the one bf16 case is held
at max abs <= 0.1 on maps in [0, 1] and logits of scale ~1.
"""

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from pero_ocr_tpu.models.parsenet import ParseNet as FlaxParseNet
from pero_ocr_tpu.models.recognizer import (
    CTCRecognizer as FlaxRecognizer,
    FusedBiLSTM as FlaxFusedBiLSTM,
    RecognizerSpec as FlaxSpec,
)
from pero_ocr_tpu_torch.models.parsenet import (
    ParseNet,
    SameConv2d,
    group_norm,
    same_pads,
)
from pero_ocr_tpu_torch.models.recognizer import (
    CTCRecognizer,
    RecognizerSpec,
    _max_pool_same,
)
from pero_ocr_tpu_torch.utils import convert

F32_TOL = 1e-4
BF16_TOL = 0.1


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _perturbed(variables, seed):
    """Random init plus noise, so zero-initialised biases and unit norm
    scales carry values the converter must place right."""
    leaves, treedef = jax.tree_util.tree_flatten(variables)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        treedef,
        [l + 0.1 * rng.standard_normal(l.shape).astype(np.float32) for l in leaves],
    )


def _parsenets(stem, up, dtype_jax, dtype_torch, seed=0):
    fm = FlaxParseNet(base_features=8, depth=2, stem=stem, out_upsample=up,
                      dtype=dtype_jax)
    v = _perturbed(fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3))), seed)
    tm = ParseNet(base_features=8, depth=2, stem=stem, out_upsample=up, dtype=dtype_torch)
    tm.load_state_dict(convert.parsenet_params_from_flax(_np_tree(v)))
    return fm, v, tm


@pytest.mark.parametrize("stem", ["conv", "s2d"])
@pytest.mark.parametrize("up", [1, 2])
def test_parsenet_f32(stem, up):
    fm, v, tm = _parsenets(stem, up, jnp.float32, torch.float32)
    x = np.random.default_rng(1).random((2, 64, 128, 3), np.float32)
    want = np.asarray(fm.apply(v, x))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, 64 * up, 128 * up, 5)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def _recognizers(kw, dtype_jax, dtype_torch, seed=0, width=48):
    fm = FlaxRecognizer(FlaxSpec(dtype=dtype_jax, **kw))
    v = _perturbed(
        fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, kw["line_height"], width, 3))),
        seed,
    )
    tm = CTCRecognizer(RecognizerSpec(dtype=dtype_torch, **kw))
    tm.load_state_dict(convert.recognizer_params_from_flax(_np_tree(v)))
    return fm, v, tm


def _rec_kw(stem="conv", norm="none", lstm_layers=2, embed_num=0):
    return dict(
        num_classes=10, line_height=16, conv_features=(4, 8), subsampling=4,
        lstm_layers=lstm_layers, lstm_features=8, embed_num=embed_num,
        embed_dim=4, stem=stem, norm=norm,
    )


# Every value of every branch, each LSTM depth under both stems.
@pytest.mark.parametrize("stem,norm,lstm_layers,embed_num", [
    ("conv", "none", 0, 0),
    ("s2d", "group", 0, 3),
    ("conv", "group", 1, 0),
    ("s2d", "none", 1, 3),
    ("conv", "none", 2, 3),
    ("s2d", "group", 2, 0),
])
def test_recognizer_f32(stem, norm, lstm_layers, embed_num):
    kw = _rec_kw(stem, norm, lstm_layers, embed_num)
    fm, v, tm = _recognizers(kw, jnp.float32, torch.float32)
    rng = np.random.default_rng(2)
    x = rng.random((3, 16, 48, 3), np.float32)
    ids = np.array([0, 2, 3], np.int32) if embed_num else None
    for embed_ids in (None, ids) if embed_num else (None,):
        want = np.asarray(fm.apply(v, x, embed_ids))
        got = tm(
            torch.from_numpy(x),
            None if embed_ids is None else torch.from_numpy(embed_ids).long(),
        ).detach().numpy()
        assert got.shape == want.shape == (3, 12, 10)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_bf16_models():
    """The default dtype on both sides, at the stated looser tolerance."""
    fm, v, tm = _parsenets("s2d", 2, jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(3).random((1, 64, 64, 3), np.float32)
    got = tm(torch.from_numpy(x)).detach().float().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(fm.apply(v, x)), atol=BF16_TOL, rtol=0)

    kw = _rec_kw("s2d", "group", 2, 0)
    fm, v, tm = _recognizers(kw, jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(4).random((2, 16, 48, 3), np.float32)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(fm.apply(v, x)), atol=BF16_TOL, rtol=0)


# ----------------------------------------------------------------------
# The traps of the port, each pinned on its own.

@pytest.mark.parametrize("size", [64, 65])
def test_same_padding_stride2_conv(size):
    """flax 'SAME' on a stride-2 3x3 conv pads (0, 1) for an even input
    (torch padding=1 would pad (1, 1)) and (1, 1) for an odd one."""
    assert same_pads(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))
    conv = nn.Conv(5, (3, 3), strides=(2, 2))
    x = np.random.default_rng(5).standard_normal((1, size, size, 3)).astype(np.float32)
    v = _perturbed(conv.init(jax.random.PRNGKey(0), x), 5)
    want = np.asarray(conv.apply(v, x))
    tconv = SameConv2d(3, 5, 3, stride=2)
    state = convert._conv(_np_tree(v)["params"])
    tconv.load_state_dict(state)
    got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("strides", [(2, 1), (2, 2)])
def test_max_pool_same_pads_with_neg_inf(strides):
    """flax max_pool 'SAME' with stride (2, 1) pads the width by (0, 1)
    with -inf: a zero pad would leak 0 into an all-negative input."""
    x = -1.0 - np.random.default_rng(6).random((1, 8, 7, 2)).astype(np.float32)
    want = np.asarray(nn.max_pool(x, (2, 2), strides=strides, padding="SAME"))
    got = _max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), strides[1])
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert (want < 0).all()


def test_group_norm_epsilon():
    """GroupNorm epsilon is flax's 1e-6: on a low-variance input torch's
    default 1e-5 would be visibly off."""
    x = 1e-3 * np.random.default_rng(7).standard_normal((2, 4, 4, 8)).astype(np.float32)
    gn = nn.GroupNorm(num_groups=8)
    v = gn.init(jax.random.PRNGKey(0), x)
    want = np.asarray(gn.apply(v, x))
    got = group_norm(8)(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-3, rtol=0)
    loose = torch.nn.GroupNorm(8, 8)(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(loose.permute(0, 2, 3, 1).detach().numpy() - want).max() > 1e-2


def test_conv_transpose_kernel_flip():
    """flax ConvTranspose (transpose_kernel=False, kernel 2, stride 2)
    is torch's ConvTranspose2d with the kernel flipped spatially; the
    unflipped kernel does not match."""
    ct = nn.ConvTranspose(3, (2, 2), strides=(2, 2))
    x = np.random.default_rng(8).standard_normal((1, 5, 6, 4)).astype(np.float32)
    v = _perturbed(ct.init(jax.random.PRNGKey(0), x), 8)
    want = np.asarray(ct.apply(v, x))
    state = convert._conv_transpose(_np_tree(v)["params"])
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = torch.nn.functional.conv_transpose2d(tx, state["weight"], state["bias"], 2)
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0
    )
    unflipped = torch.nn.functional.conv_transpose2d(
        tx, state["weight"].flip(2, 3), state["bias"], 2
    )
    assert np.abs(unflipped.permute(0, 2, 3, 1).numpy() - want).max() > 1e-2


def test_fused_bilstm_gates_and_carry():
    """OptimizedLSTMCell: bias-free i* kernels, biased h* kernels, gate
    order i, f, g, o, carry (c, h); the backward direction runs over the
    full padded length.  One torch nn.LSTM(bidirectional=True) layer
    with the converted weights matches flax's fused scan."""
    m = FlaxFusedBiLSTM(6, dtype=jnp.float32)
    x = np.random.default_rng(9).standard_normal((2, 7, 5)).astype(np.float32)
    x[1, 4:] = 0.0  # a zero tail, as a padded crop gives
    v = _perturbed(m.init(jax.random.PRNGKey(0), x), 9)
    want = np.asarray(m.apply(v, x))
    step = _np_tree(v)["params"]["Scan_BiLSTMStep_0"]
    lstm = torch.nn.LSTM(5, 6, batch_first=True, bidirectional=True)
    state = {}
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        for name, value in convert._lstm_direction(step[direction]).items():
            state[f"{name}_l0{suffix}"] = value
    lstm.load_state_dict(state)
    got = lstm(torch.from_numpy(x))[0].detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
