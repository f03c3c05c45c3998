"""The port's ``scripts/convert_torch_lm.py`` and
``scripts/convert_torchscript.py`` against the JAX package's scripts,
on the CPU.

- ``convert_torch_lm``: a small torch char-LSTM state dict (and a GRU
  module), with and without ``--vocab-json``, through both scripts: equal
  msgpack bytes, equal ``.json`` sidecar bytes, an equal printed line.
- ``inspect``: its lines equal the JAX ``inspect_torchscript`` report's
  with the "NOT SUPPORTED" marks stripped, on ``MiniUNet`` and
  ``MiniCTCNet`` archives traced here.
- ``verify`` exits 2 with its reason, which its help gives too.
- ``distill``: ``synthetic_pages`` bit for bit; ``--images`` read and
  resized equal to the JAX script's (cv2) images, an unreadable file
  skipped as cv2 skips it; the batch indices of a
  run equal the JAX script's draws from one ``RandomState(0)``; the
  teachers' outputs (the port's ``torch.jit.load`` against the JAX
  interpreter) within 1e-4; the distillation loss of each family on the
  same float32 student weights (the JAX initialisation carried across)
  within 1e-5 relative; the written checkpoint read back by both
  packages' loaders (equal trees, the JAX student's structure) and
  served by the port's recognizer; ``optim.Adam`` against
  ``optax.adam`` on three steps within 1e-6.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pero_ocr_tpu.models.parsenet import ParseNet as JaxParseNet
from pero_ocr_tpu.models.recognizer import CTCRecognizer as JaxRecognizer
from pero_ocr_tpu.models.recognizer import RecognizerSpec as JaxSpec
from pero_ocr_tpu.utils import checkpoint as jax_checkpoint
from pero_ocr_tpu.utils.ts_adapters import TSRecognizerModel as JaxTSRecognizer
from pero_ocr_tpu.utils.ts_graph import inspect_torchscript, load_torchscript, ts_to_jax
from pero_ocr_tpu_torch.parallel.optim import Adam
from pero_ocr_tpu_torch.scripts import convert_torch_lm, convert_torchscript as cts
from pero_ocr_tpu_torch.utils import checkpoint
from tests.test_convert_torch import TorchLM
from tests.test_ts_graph import MiniCTCNet, MiniUNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEACHER_TOL = 1e-4
LOSS_RTOL = 1e-5
MARK = "   <-- NOT SUPPORTED by the JAX interpreter"


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The bench-width students on two intra-op threads: the test
    workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_cts():
    return _jax_script("convert_torchscript")


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    root = tmp_path_factory.mktemp("ts")
    torch.manual_seed(0)
    paths = {}
    for name, module, example in (("unet", MiniUNet(), torch.rand(1, 3, 32, 48)),
                                  ("ctc", MiniCTCNet(num_classes=12), torch.rand(1, 3, 32, 64))):
        paths[name] = str(root / f"{name}.pt")
        torch.jit.trace(module.eval(), example).save(paths[name])
    return paths


# ----------------------------------------------------------------------
# convert_torch_lm
@pytest.mark.parametrize("vocab", [False, True], ids=["plain", "vocab_json"])
@pytest.mark.parametrize("form", ["lstm_state_dict", "gru_module"])
def test_convert_torch_lm_writes_the_jax_bytes(tmp_path, monkeypatch, capsys, form, vocab):
    torch.manual_seed(3)
    lm = TorchLM(9, 6, 10, 2, "lstm" if form.startswith("lstm") else "gru").eval()
    src = tmp_path / "lm.pt"
    torch.save(lm.state_dict() if form == "lstm_state_dict" else lm, src)
    extra = []
    if vocab:
        (tmp_path / "chars.json").write_text(json.dumps(list("abcdefgž​")), "utf8")
        extra = ["--vocab-json", str(tmp_path / "chars.json")]
    outputs = {}
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        argv = [str(src), "out.lm"] + extra
        if side == "jax":
            monkeypatch.setattr("sys.argv", ["convert_torch_lm.py"] + argv)
            _jax_script("convert_torch_lm").main()
        else:
            convert_torch_lm.main(argv)
        printed = capsys.readouterr().out
        outputs[side] = ((tmp_path / side / "out.lm").read_bytes(),
                         (tmp_path / side / "out.lm.json").read_bytes(), printed)
    assert outputs["port"] == outputs["jax"]
    assert outputs["port"][2].startswith("converted: vocab=9 embed=6 hidden=10 layers=2 -> ")


# ----------------------------------------------------------------------
# inspect and verify
@pytest.mark.parametrize("name", ["unet", "ctc"])
def test_inspect_lines_equal_jax(archives, capsys, name):
    assert cts.main(["inspect", archives[name]]) == 0
    got = capsys.readouterr().out.splitlines()
    want = [line.replace(MARK, "") for line in
            inspect_torchscript(load_torchscript(archives[name])).splitlines()]
    assert got == want
    assert "NOT SUPPORTED" not in "\n".join(got)
    assert got[0] == "== op histogram ==" and got[-1].startswith("== total parameters:")


def test_verify_exits_2_with_its_reason(archives, capsys):
    assert cts.main(["verify", archives["unet"], "--family", "parsenet"]) == 2
    assert "nothing to verify" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cts.main(["verify", "-h"])
    assert "No meaning in the port" in capsys.readouterr().out


# ----------------------------------------------------------------------
# distill
@pytest.mark.parametrize("shape", [(32, 512), (256, 320)])
def test_synthetic_pages_equal_jax(jax_cts, shape):
    want = jax_cts._synthetic_pages(5, shape, np.random.RandomState(0))
    got = cts.synthetic_pages(5, shape, np.random.RandomState(0))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and np.array_equal(g, w)


@pytest.mark.parametrize("shape", [(32, 512), (256, 320)])
def test_load_images_equal_jax(jax_cts, tmp_path, shape):
    import cv2

    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate([(40, 300), (300, 420), (25, 700)]):
        cv2.imwrite(str(tmp_path / f"p{i}.png"), rng.integers(0, 256, (h, w, 3), np.uint8))
    (tmp_path / "p3.png").write_bytes(b"not an image")
    pattern = str(tmp_path / "*.png")
    want = [cv2.resize(im, (shape[1], shape[0]))
            for im in jax_cts._load_images(pattern, 10, np.random.RandomState(0))]
    got = cts.load_images(pattern, 10, shape)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert len(cts.load_images(pattern, 2, shape)) == 2


def _args(path, out, family, steps=3):
    return cts.parse_arguments(["distill", path, "--family", family, "--out", str(out),
                                "--steps", str(steps), "--batch", "1", "--num-samples", "5"])


@pytest.fixture(scope="module")
def ctc_run(archives, tmp_path_factory):
    """A 3-step CTC distillation on the CPU (float32 student, batch 1)."""
    out = tmp_path_factory.mktemp("distill") / "ocr.ckpt"
    args = _args(archives["ctc"], out, "ctc")
    return args, cts.distill(args, device="cpu", dtype=torch.float32)


def test_distill_batch_indices_equal_jax(jax_cts, ctc_run):
    args, run = ctc_run
    rng = np.random.RandomState(0)
    jax_cts._synthetic_pages(5, (32, 512), rng)
    want = [rng.randint(0, 5, 1) for _ in range(3)]
    assert [i.tolist() for i in run["indices"]] == [w.tolist() for w in want]
    assert len(run["losses"]) == 3 and all(np.isfinite(run["losses"]))


def _batch(shape, n=1):
    pages = cts.synthetic_pages(n, shape, np.random.RandomState(0))
    return np.stack(pages).astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def jax_ctc(archives):
    """The JAX teacher of the CTC archive, and the JAX script's student
    for it in float32 with its initial variables."""
    jteacher = JaxTSRecognizer(load_torchscript(archives["ctc"]), line_height=32)
    spec = JaxSpec(num_classes=jteacher.spec.num_classes, line_height=32,
                   subsampling=jteacher.spec.subsampling, stem="s2d", dtype=jnp.float32)
    student = JaxRecognizer(spec)
    # The weights do not depend on the line's width.
    variables = jax.jit(student.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 32, 64, 3), jnp.float32))
    return jteacher, student, variables


def test_ctc_teacher_and_loss_equal_jax(ctc_run, jax_ctc):
    args, run = ctc_run
    jteacher, student, variables = jax_ctc
    batch = _batch((32, 512))
    jtarget = np.asarray(jteacher.apply(jteacher.variables, jnp.asarray(batch)))
    with torch.no_grad():
        target = run["teacher"](torch.from_numpy(batch)).numpy()
    assert target.shape == jtarget.shape == (1, 128, 12)
    np.testing.assert_allclose(target, jtarget, rtol=0, atol=TEACHER_TOL)
    pred = jax.nn.log_softmax(jax.jit(student.apply)(variables, jnp.asarray(batch)))
    tgt = jax.nn.softmax(jnp.asarray(jtarget))
    t = min(pred.shape[1], tgt.shape[1])
    want = float(-jnp.mean(jnp.sum(tgt[:, :t] * pred[:, :t], axis=-1)))
    ours = cts.make_student(args, run["teacher"], torch.float32,
                            jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        got = float(cts.distill_loss("ctc", ours(torch.from_numpy(batch)),
                                     torch.from_numpy(jtarget.copy())))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_parsenet_teacher_and_loss_equal_jax(archives, tmp_path):
    args = _args(archives["unet"], tmp_path / "p.ckpt", "parsenet")
    batch = _batch((256, 320))
    teacher = cts.load_teacher(args, "cpu")
    fn, params = ts_to_jax(load_torchscript(archives["unet"]))
    jtarget = fn(params, jnp.transpose(jnp.asarray(batch), (0, 3, 1, 2)))[0]
    jtarget = np.asarray(jnp.transpose(jtarget, (0, 2, 3, 1)))
    with torch.no_grad():
        target = teacher(torch.from_numpy(batch)).numpy()
    assert target.shape == jtarget.shape == (1, 256, 320, 5)
    np.testing.assert_allclose(target, jtarget, rtol=0, atol=TEACHER_TOL)
    student = JaxParseNet(stem="s2d", dtype=jnp.float32)
    variables = jax.jit(student.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 64, 64, 3), jnp.float32))
    pred = jax.jit(student.apply)(variables, jnp.asarray(batch))
    want = float(jnp.mean((pred[..., :5] - jnp.asarray(jtarget)[..., :5]) ** 2))
    ours = cts.make_student(args, teacher, torch.float32,
                            jax.tree_util.tree_map(np.asarray, variables))
    with torch.no_grad():
        got = float(cts.distill_loss("parsenet", ours(torch.from_numpy(batch)),
                                     torch.from_numpy(jtarget.copy())))
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_distilled_checkpoint_reads_in_both_packages(ctc_run, jax_ctc):
    args, run = ctc_run
    # The JAX loader restores into the JAX student's own structure.
    ours = checkpoint.load_variables(args.out)
    theirs = jax_checkpoint.load_variables(args.out, jax_ctc[2])
    flat_ours = jax.tree_util.tree_leaves_with_path(ours)
    flat_theirs = jax.tree_util.tree_leaves_with_path(theirs)
    assert [p for p, _ in flat_ours] == [p for p, _ in flat_theirs]
    for (_, a), (_, b) in zip(flat_ours, flat_theirs):
        assert np.asarray(a).dtype == np.float32 and np.array_equal(a, b)
    # The port's recognizer serves it: the distilled model's logits.
    served = cts.make_student(args, run["teacher"], torch.float32, ours).eval()
    batch = torch.from_numpy(_batch((32, 512)))
    with torch.no_grad():
        np.testing.assert_allclose(served(batch).numpy(), run["model"].eval()(batch).numpy(),
                                   rtol=0, atol=1e-5)


def test_adam_equals_optax_adam():
    rng = np.random.default_rng(0)
    params = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=5).astype(np.float32)]
    tx = optax.adam(3e-3)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    ours = [torch.from_numpy(p.copy()) for p in params]
    opt = Adam(3e-3)
    state = opt.init(ours)
    for _ in range(3):
        grads = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate)
        jparams = optax.apply_updates(jparams, updates)
        opt.step_(ours, [torch.from_numpy(g) for g in grads], state)
    assert state.grad_norm is None
    for a, b in zip(ours, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
