"""The device mesh of the port (``pero_ocr_tpu_torch/parallel/mesh.py``)
against the JAX package's (``pero_ocr_tpu/parallel/mesh.py``, on its 8
virtual CPU devices) on the CPU.

Held to:

- the mesh's shapes, ``auto_mesh`` and the JAX error text for a tp that
  does not divide the devices;
- ``param_sharding_rules``: on the tiny recognizer and ParseNet, a
  weight is split over tp exactly where JAX's rules split every flax
  kernel it maps to (``utils/convert.py``), on the torch axis that holds
  those kernels' last axis;
- the sharded trainer at dp2 x tp1 and dp2 x tp2, in spawned gloo ranks
  (``tests/torch_mesh_ranks.py``, each group within its own time limit):
  5 steps' losses within 1e-4 of JAX's ``make_sharded_train_step`` (on
  dp2 x tp2) from the same flax weights (relative), the final weights within 0.01 x lr
  of JAX's (a conv bias under a GroupNorm of one channel a group moves
  by +-lr on rounding noise: 6 x lr), the loss falling, each rank's
  weights and Adam moments its tp shards of the unsharded trainer's
  (within 1e-6; the GroupNorm-fed conv biases within 6 x lr), and the
  module holding the gathered weights.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pero_ocr_tpu.parallel import mesh as jax_mesh
from pero_ocr_tpu.parallel import train as jax_train
from pero_ocr_tpu_torch.models.parsenet import ParseNet
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.parallel import mesh as mesh_lib
from pero_ocr_tpu_torch.parallel import train
from pero_ocr_tpu_torch.utils import convert
from tests.test_torch_train import REC_SPECS, _ctc_batch, _leaves, _rec_pair, _sorted
from tests.torch_mesh_ranks import Ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


# ----------------------------------------------------------------------
# Mesh and rules

def test_mesh_shapes_auto_mesh_and_errors():
    mesh = mesh_lib.make_mesh(8, tp=2, device_type="cpu")
    assert mesh.shape == dict(jax_mesh.make_mesh(8, tp=2).shape) == {"dp": 4, "tp": 2}
    assert mesh.axis_names == ("dp", "tp") and mesh.dp_devices == [torch.device("cpu")] * 4
    assert mesh_lib.auto_mesh(8, device_type="cpu").shape["tp"] == 2
    assert mesh_lib.auto_mesh(2, device_type="cpu").shape == {"dp": 2, "tp": 1}
    with pytest.raises(ValueError) as got:
        mesh_lib.make_mesh(8, tp=3)
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(8, tp=3)
    assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.make_mesh(1)
    with pytest.raises(ValueError, match="of one type"):
        mesh_lib.Mesh([["cpu"], ["meta"]])
    assert [str(p) for p in mesh_lib.batch_sharding(mesh)] == ["S(0)", "R"]
    assert [str(p) for p in mesh_lib.replicated(mesh)] == ["R", "R"]


def _flax_leaves_of(module, to_flax, name, axis):
    """The flax kernels that weight ``name`` maps to, found by converting
    a state dict in which only that weight is nonzero (its values the
    index along torch ``axis``, plus one)."""
    sd = {k: torch.zeros_like(v) for k, v in module.state_dict().items()}
    w = sd[name]
    shape = [1] * w.ndim
    shape[axis] = w.shape[axis]
    sd[name] = (torch.arange(w.shape[axis], dtype=torch.float32) + 1).reshape(shape).expand_as(w)
    return [(path, np.asarray(leaf)) for path, leaf in _leaves(to_flax(module, sd))
            if np.asarray(leaf).any()]


@pytest.mark.parametrize("model", ["recognizer", "parsenet"])
def test_param_sharding_rules_match_jax(model):
    if model == "recognizer":  # test_torch_train.py's s2d_group_lstm recognizer
        module = CTCRecognizer(RecognizerSpec(
            num_classes=7, line_height=16, conv_features=(4, 8), subsampling=4,
            lstm_features=8, embed_dim=4, dtype=torch.float32, **REC_SPECS["s2d_group_lstm"]))
        to_flax = convert.recognizer_params_to_flax
    else:
        module = ParseNet(base_features=8, depth=2, out_upsample=2, dtype=torch.float32)
        to_flax = convert.parsenet_params_to_flax
    flax_tree = to_flax(module)
    jax_rules = jax_mesh.param_sharding_rules(flax_tree, jax_mesh.make_mesh(8, tp=2))
    jax_split = {jax.tree_util.keystr(path): "tp" in str(s.spec)
                 for path, s in jax.tree_util.tree_leaves_with_path(
                     jax_rules, is_leaf=lambda n: hasattr(n, "spec"))}
    rules = mesh_lib.param_sharding_rules(module, mesh_lib.make_mesh(8, tp=2, device_type="cpu"))
    axes = mesh_lib.shard_axes(module, mesh_lib.make_mesh(8, tp=2, device_type="cpu"))
    assert set(rules) == set(axes) == set(dict(module.named_parameters()))
    split = 0
    for name, axis in axes.items():
        assert rules[name][0].is_replicate()
        assert rules[name][1].is_replicate() == (axis is None)
        leaves = _flax_leaves_of(module, to_flax, name, 0 if axis is None else axis)
        if "bias_ih" in name:  # folded into the hidden bias, which flax keeps 1-D
            assert axis is None
            continue
        assert leaves, name
        want = {jax_split[jax.tree_util.keystr(path)] for path, _ in leaves}
        assert want == {axis is not None}, name
        if axis is not None:
            split += 1
            for path, leaf in leaves:  # the torch axis runs along flax's last axis
                assert np.ptp(leaf.reshape(-1, leaf.shape[-1]), axis=0).max() == 0, path
                assert len(np.unique(leaf[(0,) * (leaf.ndim - 1)])) == leaf.shape[-1], path
    assert split >= 5 and any(a is None for a in axes.values())


# ----------------------------------------------------------------------
# The sharded trainer

STEPS = 5
LR = 1e-3


MESHES = [(2, 1), (2, 2)]


def _jax_trajectory(flax_model, variables, batch):
    """JAX's make_sharded_train_step on a dp2 x tp2 mesh of its virtual
    devices: STEPS steps' losses and the final flax params (its GSPMD
    computes the same function on every mesh, so both port meshes are
    held to this one compile)."""
    jmesh = jax_mesh.make_mesh(4, tp=2)
    jopt = jax_train.make_optimizer(LR)
    with jmesh:
        jstate = jax_train.shard_train_state(
            jax_train.TrainState(variables, jopt.init(variables), jnp.zeros((), jnp.int32)),
            jmesh)
        jstep = jax_train.make_sharded_train_step(flax_model, jopt, jmesh)
        losses = []
        for _ in range(STEPS):
            jstate, jloss = jstep(jstate, *batch)
            losses.append(float(jloss))
    return losses, jax.tree_util.tree_map(np.asarray, jstate.params)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Both meshes' gloo groups started at once; while they run, JAX's
    trajectory and the unsharded port trainer on the same batch (for the
    shards); then the groups joined, each within its time limit."""
    module, flax_model, variables = _rec_pair("s2d_group_lstm", seed=2)
    batch = _ctc_batch(7, n=8)
    job = {"spec": module.spec, "state_dict": module.state_dict(), "lr": LR, "steps": STEPS,
           "batch": batch}
    folder = tmp_path_factory.mktemp("ranks")
    groups = {}
    try:
        for dp, tp in MESHES:
            groups[dp, tp] = Ranks(dp * tp, tp, job, folder / f"dp{dp}xtp{tp}")
        want, jax_params = _jax_trajectory(flax_model, variables, batch)
        optimizer = train.make_optimizer(LR)
        plain = train.init_train_state(module, optimizer, device="cpu")
        step = train.make_train_step(module, optimizer)
        for _ in range(STEPS):
            plain, _ = step(plain, *batch)
    finally:  # every group joined (or killed) before any error is raised
        joined = {}
        for key, group in groups.items():
            try:
                joined[key] = group.join()
            except (TimeoutError, RuntimeError) as e:
                joined[key] = e
    for out in joined.values():
        if isinstance(out, Exception):
            raise out
    whole = {"params": plain.params, "mu": dict(zip(plain.params, plain.opt_state.mu)),
             "nu": dict(zip(plain.params, plain.opt_state.nu))}
    return module, joined, want, jax_params, whole


@pytest.mark.parametrize("dp,tp", MESHES, ids=["dp2xtp1", "dp2xtp2"])
def test_sharded_training_matches_jax(sharded, dp, tp):
    module, ranks, want, jax_params, whole = sharded
    ranks = ranks[dp, tp]

    # Their exact gradient is 0 (GroupNorm of one channel a group):
    # rounding noise, summed in another order, moves them apart.
    noise = {f"encoder.convs.{i}.bias" for i in range(len(module.encoder.convs))
             if f"encoder.norms.{i}.weight" in whole["params"]}
    assert noise
    for rank, out in enumerate(ranks):
        assert out["losses"] == ranks[0]["losses"]
        assert out["count"] == STEPS
        for got, w in zip(out["losses"], want):
            assert got == pytest.approx(w, rel=1e-4)
        tp_rank = rank % tp
        for name, axis in out["axes"].items():
            for key in ("params", "mu", "nu"):
                full = whole[key][name]
                shard = full if axis is None else full.chunk(tp, dim=axis)[tp_rank]
                assert out[key][name].shape == shard.shape, (key, name)
                atol = 6 * LR if key == "params" and name in noise else 1e-6
                torch.testing.assert_close(out[key][name], shard, rtol=0, atol=atol,
                                           msg=f"{key} {name}")
            gathered = out["params"][name] if axis is None else torch.cat(
                [ranks[rank - tp_rank + j]["params"][name] for j in range(tp)], dim=axis)
            assert torch.equal(out["module"][name], gathered), name
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    split = [n for n, a in ranks[0]["axes"].items() if a is not None]
    assert bool(split) == (tp > 1)

    module.load_state_dict(ranks[0]["module"])
    got = _leaves(_sorted(convert.recognizer_params_to_flax(module)))
    wanted = _leaves(_sorted(jax_params))
    assert [p for p, _ in got] == [p for p, _ in wanted]
    for (path, a), (_, b) in zip(got, wanted):
        name = jax.tree_util.keystr(path)
        noise = re.search(r"Conv_\d+'\]\['bias", name) and "VGGEncoder" in name
        assert np.abs(a - b).max() <= (6 if noise else 0.01) * LR, name
