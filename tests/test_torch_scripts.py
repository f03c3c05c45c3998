"""The port's CER tools and their modules against the JAX package's on
the same seeded inputs: ``sequence_alignment`` (alignments, paths,
substring variants, edit stats, with empty strings and other costs),
``levenshtein_batch_i32`` and its numpy twin, ``error_summary``,
``char_confidences``, ``transcription_io`` and ``line_images_io``; and
the scripts ``compare_page_xml_texts``, ``compare_txt``, ``eval_parity``
and ``merge_ocr_results``: the port's (``main(argv)`` in this process)
prints the same lines and writes the same files, byte for byte, as the
JAX script run as a subprocess on the same folders (Page XML with
errors, missing lines and missing files; text folders; engines' Page XML
and logits).  The Page XML that merge writes is compared with its
Created/LastChange timestamps masked."""

import os
import pickle
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
import scipy.sparse

from pero_ocr_tpu import char_confidences as jax_char_confidences
from pero_ocr_tpu import error_summary as jax_error_summary
from pero_ocr_tpu import sequence_alignment as jax_alignment
from pero_ocr_tpu import transcription_io as jax_transcription_io
from pero_ocr_tpu.utils import native as jax_native
from pero_ocr_tpu_torch import char_confidences, error_summary, line_images_io
from pero_ocr_tpu_torch import sequence_alignment, transcription_io
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from pero_ocr_tpu_torch.scripts import compare_page_xml_texts, compare_txt, eval_parity
from pero_ocr_tpu_torch.scripts import merge_ocr_results
from pero_ocr_tpu_torch.utils import native
from tests.test_torch_native import jax_native_library

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_cxx = pytest.mark.skipif(
    __import__("shutil").which(os.environ.get("CXX") or "c++") is None,
    reason="no host C++ compiler")


def jax_script(name, *args, cwd=None):
    """scripts/<name>.py in a subprocess: (return code, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", name + ".py"), *args],
                         cwd=cwd, env=env, capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout, out.stderr


def port_script(module, capsys, *args):
    """The port's script's ``main(argv)`` here: (return code, stdout,
    stderr)."""
    capsys.readouterr()
    try:
        module.main(list(args))
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    out = capsys.readouterr()
    return rc, out.out, out.err


# ----------------------------------------------------------------------
# Alignments and edit distances
def _strings(seed):
    rng = np.random.default_rng(seed)
    alphabet = list("abcž ")[: int(rng.integers(1, 6))]
    return ["".join(rng.choice(alphabet, int(rng.integers(0, 14)))) for _ in range(2)]


ALIGNMENT_CASES = [
    ("", "", (1, 1, 1)), ("", "abc", (1, 1, 1)), ("abcd", "", (1, 1, 1)),
    ("kitten", "sitting", (1, 1, 1)), ("kitten", "sitting", (2, 1, 1)),
    ("žluťoučký", "zlutoucky", (1, 2, 3)), ("abab", "ba", (1.5, 0.5, 1)),
] + [(*_strings(seed), costs) for seed in range(8)
     for costs in ((1, 1, 1), (3, 1, 2))]


@pytest.mark.parametrize("source,target,costs", ALIGNMENT_CASES)
def test_alignments_match_jax(source, target, costs):
    """Alignments, paths, distances, substring variants and edit stats:
    equal to pero_ocr_tpu.sequence_alignment, empty_symbol given or not."""
    src, tgt = list(source), list(target)
    for name in ("levenshtein_alignment_path", "levenshtein_alignment",
                 "levenshtein_distance", "levenshtein_distance_substring",
                 "levenshtein_alignment_substring"):
        got = getattr(sequence_alignment, name)(src, tgt, *costs)
        want = getattr(jax_alignment, name)(src, tgt, *costs)
        assert got == want, name
    for empty in (None, "#"):
        for name in ("levenshtein_alignment", "levenshtein_alignment_substring"):
            got = getattr(sequence_alignment, name)(src, tgt, *costs, empty_symbol=empty)
            assert got == getattr(jax_alignment, name)(src, tgt, *costs, empty_symbol=empty)
            assert sequence_alignment.edit_stats_for_alignment(got, empty) == \
                jax_alignment.edit_stats_for_alignment(got, empty)


@needs_cxx
@pytest.mark.skipif(jax_native_library() is None, reason="JAX native library unavailable")
def test_levenshtein_batch_matches_jax_binding():
    """levenshtein_batch_i32 and its numpy twin on 300 seeded pairs (empty
    ones among them), against the JAX binding native_levenshtein_batch:
    equal, in one call."""
    rng = np.random.default_rng(18)
    seqs_a = [rng.integers(0, int(rng.integers(1, 9)), int(rng.integers(0, 50))).astype(np.int32)
              for _ in range(300)]
    seqs_b = [rng.integers(0, int(rng.integers(1, 9)), int(rng.integers(0, 50))).astype(np.int32)
              for _ in range(300)]
    before = native.calls["levenshtein_batch_i32"]
    got = native.native_levenshtein_batch(seqs_a, seqs_b)
    assert native.calls["levenshtein_batch_i32"] == before + 1
    want = jax_native.native_levenshtein_batch(seqs_a, seqs_b)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sequence_alignment.levenshtein_ids_batch(seqs_a, seqs_b), want)
    pairs = [("".join(map(str, a)), "".join(map(str, b))) for a, b in zip(seqs_a, seqs_b)]
    for route in (True, False):
        np.testing.assert_array_equal(
            sequence_alignment.levenshtein_batch([(list(a), list(b)) for a, b in pairs], route),
            [jax_alignment.levenshtein_distance(list(a), list(b)) for a, b in pairs])
    assert native.native_levenshtein_batch([], []).shape == (0,)


# ----------------------------------------------------------------------
# Error summaries, confidences, transcript files
def test_error_summaries_match_jax():
    """ErrorsSummary.from_lists, aggregate and str(), the boundary
    classes of every line, get_match_type: equal to the JAX module."""
    rng = np.random.default_rng(5)
    refs, hyps = [], []
    for _ in range(40):
        ref = "".join(rng.choice(list("abcde "), int(rng.integers(0, 20))))
        hyp = list(ref)
        for _ in range(int(rng.integers(0, 4))):
            op, at = int(rng.integers(3)), int(rng.integers(len(hyp) + 1))
            if op == 0:
                hyp.insert(at, "x")
            elif hyp and at < len(hyp):
                if op == 1:
                    del hyp[at]
                else:
                    hyp[at] = "y"
        refs.append(list(ref))
        hyps.append(hyp)
    got, want = [], []
    for ref, hyp in zip(refs, hyps):
        try:
            w = jax_error_summary.ErrorsSummary.from_lists(ref, hyp)
        except AssertionError as e:  # insertions and deletions in one ending
            with pytest.raises(AssertionError, match=str(e)):
                error_summary.ErrorsSummary.from_lists(ref, hyp)
            continue
        g = error_summary.ErrorsSummary.from_lists(ref, hyp)
        assert str(g) == str(w)
        assert g.confusions == w.confusions
        for attr in ("correct", "pure_deletions", "mixed_deletions", "pure_insertions",
                     "mixed_insertions", "pure_substitutions"):
            assert getattr(g.ending_errors, attr) == getattr(w.ending_errors, attr), attr
        got.append(g)
        want.append(w)
    assert len(got) > 20
    total_g = error_summary.ErrorsSummary.aggregate(got)
    total_w = jax_error_summary.ErrorsSummary.aggregate(want)
    assert str(total_g) == str(total_w) and total_g.nb_lines_summarized == len(got)
    assert vars(total_g.ending_errors) == vars(total_w.ending_errors)
    for pair in (("a", "a"), ("a", "b"), (None, "b"), ("a", None)):
        assert error_summary.get_match_type(*pair).name == \
            jax_error_summary.get_match_type(*pair).name


def test_greedy_filtration_and_transcripts_match_jax(tmp_path):
    """greedy_filtration on seeded probabilities (runs, blanks, repeats)
    and the transcript file reader and writer: equal to the JAX
    modules."""
    rng = np.random.default_rng(6)
    chars = list("ab ž") + ["​"]
    for _ in range(20):
        probs = rng.dirichlet(np.full(len(chars), 0.3), int(rng.integers(1, 40)))
        assert char_confidences.greedy_filtration(probs, chars) == \
            jax_char_confidences.greedy_filtration(probs, chars)
    lines = ["l1 plain text\n", "l2 12 with an embed id\n", "l3\n", "l4 7\n", "\n",
             "l5  two spaces\n"]
    for line in lines:
        for keep in (False, True):
            assert transcription_io.parse_transcription_line(line, keep) == \
                jax_transcription_io.parse_transcription_line(line, keep)
    path = tmp_path / "t.txt"
    path.write_text("".join(lines), encoding="utf-8")
    loaded = transcription_io.load_transcriptions(str(path))
    assert loaded == jax_transcription_io.load_transcriptions(str(path))
    transcription_io.save_transcriptions(str(tmp_path / "a.txt"), loaded)
    jax_transcription_io.save_transcriptions(str(tmp_path / "b.txt"), loaded)
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()


def test_line_images_io_matches_cv2(tmp_path):
    """write_images: cv2.imwrite's JPEG bytes; read_images of a folder of
    JPEG, PNG and a file neither reads: the images and names that the
    JAX module's cv2 reader gives."""
    from pero_ocr_tpu import line_images_io as jax_line_images_io

    rng = np.random.default_rng(7)
    crops = [rng.integers(0, 256, (16, int(w), 3), dtype=np.uint8) for w in (40, 64, 33)]
    line_images_io.write_images(str(tmp_path / "port"), crops, ["a", "b", "c"])
    jax_line_images_io.write_images(str(tmp_path / "jax"), crops, ["a", "b", "c"])
    for name in ("a.jpg", "b.jpg", "c.jpg"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    cv2.imwrite(str(tmp_path / "port" / "d.png"), crops[0])
    (tmp_path / "port" / "e.bmp").write_bytes(b"not an image")
    got_images, got_names = line_images_io.read_images(str(tmp_path / "port"))
    want_images, want_names = jax_line_images_io.read_images(str(tmp_path / "port"))
    assert got_names == want_names == ["a", "b", "c", "d", "e"]
    assert len(got_images) == len(want_images) == 4
    for g, w in zip(got_images, want_images):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="JPEG only"):
        line_images_io.write_images(str(tmp_path / "png"), crops, ["a", "b", "c"], ".png")


# ----------------------------------------------------------------------
# Page XML folders for the CER scripts
def make_page(page_id, texts, ids=None):
    page = PageLayout(id=page_id, page_size=(800, 600))
    region = RegionLayout("r000", np.array([[0, 0], [600, 0], [600, 800], [0, 800]]))
    for i, text in enumerate(texts):
        y = 40 + 30 * i
        line = TextLine(id=ids[i] if ids else f"r000-l{i + 1:03d}",
                        baseline=np.array([[10, y], [590, y]], float), heights=[20.0, 6.0],
                        polygon=np.array([[10, y - 20], [590, y - 20], [590, y + 6],
                                          [10, y + 6]], float), index=i)
        line.transcription = text
        region.lines.append(line)
    page.regions.append(region)
    return page


def seeded_texts(rng, n):
    return ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyzěščřžýáíé ,."),
                               int(rng.integers(5, 40)))) for _ in range(n)]


def mangle(rng, text):
    chars = list(text)
    for _ in range(int(rng.integers(0, 4))):
        at = int(rng.integers(len(chars) + 1))
        op = int(rng.integers(3))
        if op == 0:
            chars.insert(at, "q")
        elif at < len(chars):
            if op == 1:
                del chars[at]
            else:
                chars[at] = "Z"
    return "".join(chars)


@pytest.fixture(scope="module")
def xml_folders(tmp_path_factory):
    """ref/ and hyp/ Page XML: errors on every page, a line missing from
    a hypothesis page and one only in it, a page missing from hyp/, one
    only in hyp/, a file that is no XML, an empty transcription, and
    blank edges that the scripts strip."""
    root = tmp_path_factory.mktemp("cer")
    rng = np.random.default_rng(11)
    for folder in ("ref", "hyp"):
        (root / folder).mkdir()
    for p in range(4):
        texts = seeded_texts(rng, 6)
        texts[1] = "  " + texts[1] + " "
        texts[4] = ""
        make_page(f"p{p}", texts).to_pagexml(str(root / "ref" / f"p{p}.xml"))
        if p == 3:
            continue  # missing in hyp/
        hyp_texts = [mangle(rng, t) for t in texts]
        ids = [f"r000-l{i + 1:03d}" for i in range(6)]
        if p == 1:
            ids[2] = "r000-extra"  # one ref line missing, one hyp line extra
        make_page(f"p{p}", hyp_texts, ids).to_pagexml(str(root / "hyp" / f"p{p}.xml"))
    make_page("p9", seeded_texts(rng, 2)).to_pagexml(str(root / "hyp" / "p9.xml"))
    (root / "ref" / "broken.xml").write_text("<PcGts>not closed", encoding="utf-8")
    return root


@needs_cxx
@pytest.mark.parametrize("print_all", [False, True])
def test_compare_page_xml_texts_matches_jax(xml_folders, capsys, print_all):
    args = ["--hyp", str(xml_folders / "hyp"), "--ref", str(xml_folders / "ref")]
    args += ["--print-all"] if print_all else []
    before = native.calls["levenshtein_batch_i32"]
    got = port_script(compare_page_xml_texts, capsys, *args)
    want = jax_script("compare_page_xml_texts", *args)
    assert got[:2] == want[:2]
    assert sorted(got[2].splitlines()) == sorted(want[2].splitlines())  # set order
    assert "missing in" in got[2] and "unable to load" in got[1]
    assert native.calls["levenshtein_batch_i32"] - before == 3  # one call a compared page


@needs_cxx
def test_compare_txt_matches_jax(tmp_path, capsys):
    """Text folders with a file missing on each side, an empty GT,
    unicode, extra whitespace: the same CSV bytes, stdout and stderr."""
    rng = np.random.default_rng(12)
    gt, hyp = tmp_path / "gt", tmp_path / "hyp"
    gt.mkdir()
    hyp.mkdir()
    for i in range(5):
        text = "\n".join(seeded_texts(rng, 4))
        (gt / f"f{i}.txt").write_text(text, encoding="utf-8")
        (hyp / f"f{i}.txt").write_text("  " + mangle(rng, text).replace(" ", "  "),
                                       encoding="utf-8")
    (gt / "empty.txt").write_text("  \n", encoding="utf-8")
    (hyp / "empty.txt").write_text("abc", encoding="utf-8")
    (gt / "only_gt.txt").write_text("x", encoding="utf-8")
    (hyp / "only_hyp.TXT").write_text("y", encoding="utf-8")
    got = port_script(compare_txt, capsys, "--gt", str(gt), "--hyp", str(hyp),
                      "--output", str(tmp_path / "port.csv"))
    want = jax_script("compare_txt", "--gt", str(gt), "--hyp", str(hyp),
                      "--output", str(tmp_path / "jax.csv"))
    assert got[0] == want[0] == 0
    assert got[1].replace("port.csv", "jax.csv") == want[1]
    assert got[2] == want[2]
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    empty = tmp_path / "none"
    empty.mkdir()
    assert port_script(compare_txt, capsys, "--gt", str(empty), "--hyp", str(empty),
                       "--output", str(tmp_path / "x.csv")) == jax_script(
        "compare_txt", "--gt", str(empty), "--hyp", str(empty), "--output",
        str(tmp_path / "x.csv"))


@needs_cxx
@pytest.mark.parametrize("layout,match", [("configs", "auto"), ("configs", "id"),
                                          ("configs", "page"), ("flat", "auto")])
def test_eval_parity_matches_jax(xml_folders, tmp_path, capsys, layout, match):
    """Roots with a config a subfolder (one config in ref/ only, one with
    renamed line ids, which auto mode reads as page text, one with a
    missing page) or one flat folder: the same table, warnings and exit
    code."""
    ref, hyp = tmp_path / "ref", tmp_path / "hyp"
    if layout == "flat":
        ref, hyp = xml_folders / "ref", xml_folders / "hyp"
    else:
        rng = np.random.default_rng(13)
        for cfg in ("config-1", "config-2", "config-5", "ref-only"):
            (ref / cfg).mkdir(parents=True)
            if cfg != "ref-only":
                (hyp / cfg).mkdir(parents=True)
            for p in range(3):
                texts = seeded_texts(rng, 4)
                make_page(f"p{p}", texts).to_pagexml(str(ref / cfg / f"p{p}.xml"))
                if cfg == "ref-only" or (cfg == "config-5" and p == 2):
                    continue
                ids = [f"x-{i}" for i in range(4)] if cfg == "config-2" else None
                hyp_texts = texts if cfg == "config-1" else [mangle(rng, t) for t in texts]
                make_page(f"p{p}", hyp_texts, ids).to_pagexml(str(hyp / cfg / f"p{p}.xml"))
    args = ["--ref-root", str(ref), "--hyp-root", str(hyp), "--match", match]
    got = port_script(eval_parity, capsys, *args)
    want = jax_script("eval_parity", *args)
    assert got == want
    assert got[0] == 1


def test_eval_parity_self_test(capsys):
    rc, out, _ = port_script(eval_parity, capsys, "--self-test")
    assert rc == 0 and "self-test PASSED" in out


# ----------------------------------------------------------------------
# merge_ocr_results
MERGE_CHARS = list("abcdeفيكم ") + ["​"]


def line_logits(rng, text, noise):
    """Synthetic CTC logits of ``text``: a peak of 15 + noise at the
    character's class every third frame, blank at 12 elsewhere."""
    frames = len(text) * 3 + 4
    logits = np.zeros((frames, len(MERGE_CHARS)), np.float32)
    logits[:, -1] = 12.0
    for i, ch in enumerate(text):
        logits[2 + 3 * i, MERGE_CHARS.index(ch)] = 15.0 + noise * rng.standard_normal()
        logits[2 + 3 * i, -1] = 0.0
    logits += np.abs(rng.standard_normal(logits.shape).astype(np.float32)) * noise
    return scipy.sparse.csc_matrix(np.where(logits > 0, logits, 0))


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Two engines' folders of Page XML and .logits, the same line ids,
    texts and confidences apart; Arabic lines among them; page p2 has no
    logits in engine b; a filter list."""
    root = tmp_path_factory.mktemp("merge")
    rng = np.random.default_rng(14)
    texts = [["abcde", "ab cd", "فيكم", "", "cab"], ["dead", "كم في", "bad"], ["ace"]]
    for e, engine in enumerate(("a", "b")):
        (root / engine).mkdir()
        for p, page_texts in enumerate(texts):
            page = make_page(f"p{p}", [t if e == 0 else t[::-1] for t in page_texts])
            for line in page.lines_iterator():
                line.logits = line_logits(rng, line.transcription, 0.5 + 2.0 * e)
                line.characters = MERGE_CHARS
                line.logit_coords = [0, line.logits.shape[0]]
            page.to_pagexml(str(root / engine / f"p{p}.xml"))
            if not (engine == "b" and p == 2):
                page.save_logits(str(root / engine / f"p{p}.logits"))
    (root / "filter.txt").write_text("p0 p2\n")
    return root


@needs_cxx
@pytest.mark.parametrize("flags", [[], ["--min-confidence", "0.5"], ["--fix-arabic-order"],
                                   ["--filter-list", "FILTER"]])
def test_merge_ocr_results_matches_jax(engines, tmp_path, capsys, flags):
    """The same stdout (a failed load reported), Page XML (timestamps
    masked) and logits pickles as the JAX script."""
    flags = [str(engines / "filter.txt") if f == "FILTER" else f for f in flags]
    inputs = [str(engines / "a"), str(engines / "b")]
    got = port_script(merge_ocr_results, capsys, "--output-path", str(tmp_path / "port"),
                      *flags, *inputs)
    want = jax_script("merge_ocr_results", "--output-path", str(tmp_path / "jax"), *flags,
                      *inputs)
    assert got[0] == want[0] == 0
    assert got[1] == want[1]
    assert 'ERROR: Failed to load "p2.xml"' in got[1] or "--filter-list" in flags
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and names
    masked = re.compile(r"<(Created|LastChange)>[^<]*</\1>")
    for name in names:
        g, w = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
        if name.endswith(".xml"):
            g, w = (masked.sub("", x.decode("utf-8")) for x in (g, w))
        assert g == w, name
    if "--min-confidence" in flags:
        assert any(len(pickle.loads((tmp_path / "port" / n).read_bytes())) < 4
                   for n in names if n.endswith(".logits"))


def test_document_ocr_aliases():
    """The document_ocr alias modules name the port's classes."""
    from pero_ocr_tpu_torch import document_ocr
    from pero_ocr_tpu_torch.document import page_parser, pdf
    from pero_ocr_tpu_torch.document_ocr import page_parser as alias_parser
    from pero_ocr_tpu_torch.document_ocr import pdf_production

    assert document_ocr.PageParser is page_parser.PageParser
    assert alias_parser.LineCropper is page_parser.LineCropper
    assert alias_parser.page_decoder_factory is page_parser.page_decoder_factory
    assert pdf_production.Merger is pdf.Merger
    assert pdf_production.SearchablePDFWriter is pdf.SearchablePDFWriter
