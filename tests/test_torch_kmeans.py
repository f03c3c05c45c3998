"""``pero_ocr_tpu_torch.utils.kmeans.KMeans`` against scikit-learn's
``KMeans(n_clusters, random_state=0)`` (labels equal, centres within
1e-9, inertia within 1e-9 relative, on seeded float64 tables, one with
duplicate rows; labels and iterations equal on a float32 table), and
``pero_ocr_tpu_torch.scripts.select_embed_id --device cpu`` against the
JAX script (both in this process) on the same OCR JSON (``embed_num`` 16), flax
msgpack checkpoint (the JAX recognizer's seeded init, which the port
reads through ``utils/checkpoint.py`` and ``utils/convert.py``), PNG
pages and Page XML: the same printed ids, CER lines and selected id
(times masked), the same ``--out`` files and the same OCR JSON written
back.  The JAX script runs once, on the KMeans route (numpy's global
generator seeded alike on both sides); the port runs that route and
``--representative-embed-ids`` with the ids the JAX run printed."""

import contextlib
import io
import json
import os
import re
import runpy
import shutil
import sys
import warnings

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans as SklearnKMeans

from pero_ocr_tpu.models.recognizer import CTCRecognizer as FlaxRecognizer
from pero_ocr_tpu.models.recognizer import RecognizerSpec as FlaxSpec
from pero_ocr_tpu.utils import checkpoint as jax_checkpoint
from pero_ocr_tpu.utils.checkpoint import save_variables
from pero_ocr_tpu_torch.ocr.ctc_engine import CTCEngineLineOCR
from pero_ocr_tpu_torch.scripts import select_embed_id
from pero_ocr_tpu_torch.utils import checkpoint
from pero_ocr_tpu_torch.utils.kmeans import KMeans
from tests.test_torch_scripts import make_page

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def table(shape, seed, duplicates=False, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) + 3.0 * rng.integers(0, 4, (shape[0], 1))
    if duplicates:
        x[shape[0] // 2:] = x[: shape[0] - shape[0] // 2]
    return x.astype(dtype)


@pytest.mark.parametrize("shape,duplicates,k", [
    ((9, 8), False, 3), ((65, 32), False, 4), ((129, 64), False, 8), ((65, 32), True, 5),
    ((17, 64), False, 4),
])
def test_kmeans_matches_sklearn(shape, duplicates, k):
    x = table(shape, seed=shape[0], duplicates=duplicates)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn's duplicate-points warning
        want = SklearnKMeans(n_clusters=k, random_state=0).fit(x)
    got = KMeans(n_clusters=k, random_state=0).fit(x)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_, rtol=0, atol=1e-9)
    assert abs(got.inertia_ - want.inertia_) <= 1e-9 * abs(want.inertia_)
    assert got.n_iter_ == want.n_iter_


def test_kmeans_float32_matches_sklearn():
    """A float32 table (an embedding table's type) stays float32 on both
    sides: the same labels and iterations, centres within float32
    rounding."""
    x = table((129, 64), seed=3, dtype=np.float32)
    want = SklearnKMeans(n_clusters=6, random_state=0).fit(x)
    got = KMeans(n_clusters=6, random_state=0).fit(x)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert got.cluster_centers_.dtype == want.cluster_centers_.dtype == np.float32
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_, atol=1e-5)
    assert got.n_iter_ == want.n_iter_


# ----------------------------------------------------------------------
# select_embed_id
CHARS = list("abcde ")
INI = """[PAGE_PARSER]
RUN_LINE_CROPPER = yes
RUN_OCR = yes
[LINE_CROPPER]
LINE_HEIGHT = 16
[OCR]
OCR_JSON = ocr.json
"""
TIMES = re.compile(r"(Time: |PROCESSING TIME )[0-9.e-]+")


@pytest.fixture(scope="module")
def embed_bundle(tmp_path_factory):
    """An ini, an OCR JSON with embed_num 16, the JAX recognizer's seeded
    float32 init (plus noise) as a flax msgpack, 3 PNG pages of 6 lines
    and their Page XML with texts."""
    root = tmp_path_factory.mktemp("embed")
    spec = dict(num_classes=len(CHARS) + 1, line_height=16, conv_features=(4, 8),
                subsampling=2, lstm_layers=1, lstm_features=8, embed_num=16, embed_dim=8,
                dtype=jnp.float32)
    variables = FlaxRecognizer(FlaxSpec(**spec)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 128, 3)), jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(2)
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.3 * rng.standard_normal(v.shape).astype(np.float32),
        variables)
    save_variables(variables, str(root / "rec.msgpack"))
    (root / "ocr.json").write_text(json.dumps({
        "characters": CHARS, "line_px_height": 16, "checkpoint": "rec.msgpack",
        "embed_num": 16, "net_spec": {"conv_features": [4, 8], "subsampling": 2,
                                      "lstm_layers": 1, "lstm_features": 8, "embed_dim": 8,
                                      "dtype": "float32"}}), encoding="utf-8")
    (root / "config.ini").write_text(INI)
    (root / "images").mkdir()
    (root / "xml").mkdir()
    for p in range(3):
        image = rng.integers(200, 256, (240, 320, 3), dtype=np.uint8)
        texts = ["".join(rng.choice(CHARS[:-1], int(rng.integers(3, 12)))) for _ in range(6)]
        for i in range(6):
            y = 40 + 30 * i
            image[y - 12: y - 2, 20: 300] = rng.integers(0, 80, (10, 280, 3))
        assert cv2.imwrite(str(root / "images" / f"p{p}.png"), image)
        make_page(f"p{p}", texts).to_pagexml(str(root / "xml" / f"p{p}.xml"))
    return root


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The recognizer is tiny: one intra-op thread (the test workers share
    the machine's cores, and the LSTM's threads wait on each other)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_script(main, folder, argv):
    """A script's ``main`` in this process on ``folder``, a copy of the
    bundle, numpy's global generator seeded with 0 just before and the
    strict checkpoint loading that ``main`` sets undone after: (stdout
    with times masked, the OCR JSON written back, the --out files)."""
    out = io.StringIO()
    saved = sys.argv
    try:
        np.random.seed(0)
        with contextlib.redirect_stdout(out):
            main(argv)
    finally:
        sys.argv = saved
        checkpoint.set_strict_loading(False)
        jax_checkpoint.set_strict_loading(False)
    files = {name: (folder / "out" / name).read_bytes()
             for name in sorted(os.listdir(folder / "out"))}
    return TIMES.sub(r"\1", out.getvalue()), (folder / "ocr.json").read_bytes(), files


def bundle_args(bundle, folder, *args):
    shutil.copytree(bundle, folder)
    return ["-c", str(folder / "config.ini"), "-i", str(folder / "images"),
            "-x", str(folder / "xml"), "--out", str(folder / "out"), *args]


KMEANS_ARGS = ("--n-lines", "14", "--n-clusters", "4")


@pytest.fixture(scope="module")
def jax_run(embed_bundle, tmp_path_factory):
    """The JAX script once, on the KMeans route: the port's runs on both
    routes are held against it."""
    folder = tmp_path_factory.mktemp("jax") / "bundle"
    argv = bundle_args(embed_bundle, folder, *KMEANS_ARGS)
    script = runpy.run_path(os.path.join(REPO, "scripts", "select_embed_id.py"))

    def main(argv):
        sys.argv = ["select_embed_id.py", *argv]
        script["main"]()

    return run_script(main, folder, argv)


@pytest.mark.parametrize("route", ["kmeans", "ids"])
def test_select_embed_id_matches_jax(embed_bundle, jax_run, tmp_path, route):
    """The KMeans route as the JAX script's; --representative-embed-ids
    with the ids that run printed as the same run less its table line."""
    out, ocr_json, files = jax_run
    ids = re.search(r"^REPRESENTATIVE EMBEDDING IDS: ([0-9,]+)$", out, re.M).group(1)
    args = KMEANS_ARGS if route == "kmeans" else (
        "--n-lines", "14", "--representative-embed-ids", ids)
    port = run_script(select_embed_id.main, tmp_path / "bundle", bundle_args(
        embed_bundle, tmp_path / "bundle", *args, "--device", "cpu"))
    table_line = "EMBEDDINGS SHAPE: (17, 8)\n"
    assert table_line in out
    assert port == ((out if route == "kmeans" else out.replace(table_line, "")), ocr_json, files)
    assert len(ids.split(",")) == 4
    assert len(re.findall(r"% CER \[ \d+ / \d+ \]", out)) == 4
    assert json.loads(ocr_json)["embed_id"] in ids.split(",")


def test_embedding_table_and_no_logits(embed_bundle):
    """embedding_table() is the (embed_num + 1, embed_dim) float32 matrix,
    the mean row last, equal to the checkpoint's; process_lines with
    no_logits gives the same texts and None for logits and coords."""
    engine = CTCEngineLineOCR(str(embed_bundle / "ocr.json"), device="cpu")
    table_ = engine.embedding_table()
    want = checkpoint.load_variables(str(embed_bundle / "rec.msgpack"))
    want = want["params"]["Embed_0"]["embedding"]
    assert table_.shape == (17, 8) and table_.dtype == np.float32
    np.testing.assert_array_equal(table_, want)
    lines = [np.random.default_rng(0).integers(0, 256, (16, w, 3), dtype=np.uint8)
             for w in (40, 90)]
    texts, logits, coords = engine.process_lines(lines, no_logits=True)
    assert texts == engine.process_lines(lines)[0]
    assert logits == coords == [None, None]
