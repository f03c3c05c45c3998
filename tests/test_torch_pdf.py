"""The port's searchable PDF against the JAX package's: every object but
the FontFile2 stream (its /Length and /Length1 with it) byte-equal, the
header and trailer equal but for the xref offsets, for the lines and
font of tests/test_pdf.py's cases (one and two pages), ``Merger`` from
Page XML and from ALTO, and ``produce_2layer_pdf`` on folders (the JAX
script in one subprocess for both kinds).  The port's font program (its own TrueType
subsetter, ``utils/truetype.py``) opens in fontTools, keeps the
original glyph count, and every glyph the text uses (and .notdef, and
the components of composite glyphs) has its original ``glyf`` outline
and ``hmtx`` advance.  The TrueType reader's character map, advances,
composite components and checksums are held to fontTools on the system's DejaVu
Sans (cmap format 12) and on the committed Latin subset (format 4)."""

import io
import json
import os
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
from fontTools.ttLib import TTFont

import chip_smoke
from pero_ocr_tpu.document import pdf as jax_pdf
from pero_ocr_tpu_torch.document import pdf
from pero_ocr_tpu_torch.scripts import produce_2layer_pdf
from pero_ocr_tpu_torch.utils import truetype
from pero_ocr_tpu_torch.utils.image_io import encode_jpeg, imread
from tests.test_torch_scripts import MERGE_CHARS, line_logits, make_page

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LATIN_FONT = os.path.join(REPO, "tests", "data", "pdf", "DejaVuSans-Latin.ttf")
SYSTEM_FONT = pdf.find_unicode_font()
needs_font = pytest.mark.skipif(SYSTEM_FONT is None, reason="no system DejaVu Sans")

LINES = [(30, 70, 270, 20, "Hello world"), (25, 140, 300, 18, "příliš žluťoučký kůň"),
         (40, 210, 200, 16, "Größe & façade №5"), (10, 250, 60, 12, ""),
         (12, 280, 90, 10, "ﬁ 中 ́e")]


def pdf_objects(data: bytes):
    """(header, {object number: bytes}, trailer without startxref) of a
    PDF written by the writer: objects sliced at their xref offsets."""
    xref = int(data[data.rfind(b"startxref") + 10: data.rfind(b"%%EOF")])
    rows = data[xref:].split(b"\n")
    count = int(rows[1].split()[1])
    offsets = [int(r[:10]) for r in rows[3: 2 + count]]
    ends = offsets[1:] + [xref]
    objects = {i + 1: data[a:b] for i, (a, b) in enumerate(zip(offsets, ends))}
    for number, body in objects.items():
        assert body.startswith(f"{number} 0 obj\n".encode())
    trailer = data[data.index(b"trailer", xref): data.rindex(b"startxref")]
    return data[: offsets[0]], objects, trailer


def font_file(objects):
    """The number of the FontFile2 stream object."""
    (number,) = [n for n, body in objects.items() if b"/Length1 " in body]
    return number


def font_program(objects) -> bytes:
    body = objects[font_file(objects)]
    start = body.index(b"stream\n") + 7
    return zlib.decompress(body[start: body.rindex(b"\nendstream")])


def assert_same_pdf_but_font(got: bytes, want: bytes) -> bytes:
    """Equal but for the font program and the offsets; returns the port's
    font program."""
    g_head, g_objs, g_trailer = pdf_objects(got)
    w_head, w_objs, w_trailer = pdf_objects(want)
    assert g_head == w_head and g_trailer == w_trailer
    assert sorted(g_objs) == sorted(w_objs)
    skip = font_file(w_objs)
    assert font_file(g_objs) == skip
    for number in w_objs:
        if number != skip:
            assert g_objs[number] == w_objs[number], number
    return font_program(g_objs)


def assert_font_program(program: bytes, source: str, texts):
    """The subset opens in fontTools with the source's glyph count; the
    glyphs of ``texts``, their components and .notdef keep the source's
    outline and advance; the other glyphs are empty; checksums hold."""
    original, subset = TTFont(source), TTFont(io.BytesIO(program), checkChecksums=2)
    order, sub_order = original.getGlyphOrder(), subset.getGlyphOrder()
    assert len(sub_order) == len(order) == subset["maxp"].numGlyphs
    cmap = original.getBestCmap()
    used = {order.index(cmap[ord(c)]) for t in texts for c in t if ord(c) in cmap} | {0}
    kept = truetype.TrueTypeFont(open(source, "rb").read()).closure(used)
    assert used <= kept
    for gid in range(len(order)):
        g_sub, g_orig = subset["glyf"][sub_order[gid]], original["glyf"][order[gid]]
        if gid in kept:
            assert g_sub.compile(subset["glyf"]) == g_orig.compile(original["glyf"]), gid
            assert subset["hmtx"][sub_order[gid]] == original["hmtx"][order[gid]], gid
        else:
            assert g_sub.numberOfContours == 0, gid
    assert truetype.table_checksum(program) == 0xB1B0AFBA  # checkSumAdjustment


def write_both(lines_by_page, font=None, images=None):
    out = []
    for module in (pdf, jax_pdf):
        writer = module.SearchablePDFWriter(font)
        for page, lines in enumerate(lines_by_page):
            img = images[page] if images else np.full((300, 500, 3), 240, np.uint8)
            writer.add_page(img, [module.TextLinePlacement(*line) for line in lines])
        out.append(writer.tobytes())
    return out


@needs_font
@pytest.mark.parametrize("pages", [[LINES], [LINES[:1], [(10, 40, 100, 12, "stránka dvě")]],
                                   [[(0, 30, 90, 12, "žluťoučký")]], [[]]])
def test_writer_equals_jax_but_font(pages):
    rng = np.random.default_rng(len(pages))
    images = [rng.integers(0, 256, (300, 500, 3), dtype=np.uint8) for _ in pages]
    got, want = write_both(pages, images=images)
    program = assert_same_pdf_but_font(got, want)
    assert_font_program(program, SYSTEM_FONT, [line[4] for lines in pages for line in lines])


def test_writer_with_the_committed_font():
    """The committed Latin subset (cmap format 4), as the card's check
    passes it."""
    got, want = write_both([LINES[:3]], font=LATIN_FONT)
    program = assert_same_pdf_but_font(got, want)
    assert_font_program(program, LATIN_FONT, [line[4] for line in LINES[:3]])


def test_no_font_raises_as_jax(monkeypatch):
    monkeypatch.setattr(pdf, "find_unicode_font", lambda: None)
    monkeypatch.setattr(jax_pdf, "find_unicode_font", lambda: None)
    for module in (pdf, jax_pdf):
        with pytest.raises(RuntimeError, match="No TrueType font found"):
            module.SearchablePDFWriter()
    assert pdf.SearchablePDFWriter(LATIN_FONT).font.upm == 2048


@needs_font
def test_find_unicode_font_matches_jax():
    assert pdf.find_unicode_font() == jax_pdf.find_unicode_font()


@pytest.mark.parametrize("source", ["system", "latin"])
def test_truetype_reader_matches_fonttools(source):
    path = LATIN_FONT if source == "latin" else SYSTEM_FONT
    if path is None:
        pytest.skip("no system DejaVu Sans")
    with open(path, "rb") as f:
        font = truetype.TrueTypeFont(f.read())
    ref = TTFont(path)
    order = ref.getGlyphOrder()
    assert {code: order[gid] for code, gid in font.best_cmap().items()} == ref.getBestCmap()
    assert font.units_per_em == ref["head"].unitsPerEm
    assert font.num_glyphs == ref["maxp"].numGlyphs == len(order)
    assert [font.advance(g) for g in range(font.num_glyphs)] == [ref["hmtx"][n][0] for n in order]
    composite = [g for g in range(font.num_glyphs) if ref["glyf"][order[g]].isComposite()]
    assert composite
    for g in composite[:50]:
        assert [order[c] for c in font.components(g)] == \
            ref["glyf"][order[g]].getComponentNames(ref["glyf"])


# ----------------------------------------------------------------------
# Merger and the command line
@pytest.fixture(scope="module")
def page_files(tmp_path_factory):
    """Two pages: PNG and JPEG images, Page XML (an empty line among the
    lines) and ALTO (from the same layout with synthetic logits)."""
    root = tmp_path_factory.mktemp("pdf")
    for folder in ("xml", "alto", "images"):
        (root / folder).mkdir()
    rng = np.random.default_rng(15)
    for p in range(2):
        texts = ["abcde", "ab cd", "", "cab dead", "ace"]
        layout = make_page(f"page{p}", texts)
        layout.page_size = (220, 300)
        for line in layout.lines_iterator():
            line.logits = line_logits(rng, line.transcription, 0.5)
            line.characters = MERGE_CHARS
            line.logit_coords = [0, line.logits.shape[0]]
        layout.to_pagexml(str(root / "xml" / f"page{p}.xml"))
        layout.to_altoxml(str(root / "alto" / f"page{p}_alto.xml"), native=False)
        image = rng.integers(0, 256, (220, 300, 3), dtype=np.uint8)
        ext = ".png" if p == 0 else ".jpg"
        assert cv2.imwrite(str(root / "images" / f"page{p}{ext}"), image)
    (root / "images" / "unmatched.png").write_bytes((root / "images" / "page0.png").read_bytes())
    return root


@needs_font
@pytest.mark.parametrize("kind", ["xml", "alto"])
def test_merger_equals_jax_but_font(page_files, tmp_path, kind):
    name = "page0.xml" if kind == "xml" else "page0_alto.xml"
    for module, out in ((pdf, "port.pdf"), (jax_pdf, "jax.pdf")):
        module.Merger().merge(str(page_files / kind / name), str(page_files / "images" /
                                                                  "page0.png"),
                              str(tmp_path / out))
    got, want = (tmp_path / "port.pdf").read_bytes(), (tmp_path / "jax.pdf").read_bytes()
    program = assert_same_pdf_but_font(got, want)
    assert_font_program(program, SYSTEM_FONT, ["abcde", "ab cd", "cab dead", "ace"])
    assert b"/DCTDecode" in got
    with pytest.raises(ValueError, match="Unable to read image"):
        pdf.Merger().merge(str(page_files / kind / name), str(tmp_path / "missing.png"),
                           str(tmp_path / "x.pdf"))


KIND_FLAGS = {"xml": [], "alto": ["--xml-drop-suffix", "_alto"]}
# The JAX script run as __main__ once a kind in one interpreter, which
# imports the JAX package once: its path, the output root and a JSON
# object of each kind's arguments.
RUN_KINDS = """import json, runpy, sys
script, root, runs = sys.argv[1:]
for kind, args in json.loads(runs).items():
    sys.argv = [script, *args, root + "/" + kind]
    print("KIND", kind, file=sys.stderr, flush=True)
    runpy.run_path(script, run_name="__main__")
"""


@pytest.fixture(scope="module")
def jax_script_outputs(page_files, tmp_path_factory):
    """The JAX produce_2layer_pdf.py on both kinds' folders, in one
    subprocess: (output root, each kind's stderr)."""
    root = tmp_path_factory.mktemp("jax_pdf")
    runs = {kind: [*flags, str(page_files / kind), str(page_files / "images")]
            for kind, flags in KIND_FLAGS.items()}
    proc = subprocess.run([sys.executable, "-c", RUN_KINDS,
                           os.path.join(REPO, "scripts", "produce_2layer_pdf.py"), str(root),
                           json.dumps(runs)], env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    stderr = dict(part.split("\n", 1) for part in proc.stderr.split("KIND ")[1:])
    return root, stderr


@needs_font
@pytest.mark.parametrize("kind", ["xml", "alto"])
def test_produce_2layer_pdf_equals_jax_script(page_files, jax_script_outputs, tmp_path, kind):
    """Folders (the ALTO names with a suffix to drop, an unmatched image)
    and --single-file: the same files; read back by chip_smoke.pdf_pages,
    the text layer is the file's lines and the image stream the page's
    decoded pixels encoded at quality 80."""
    args = [*KIND_FLAGS[kind], str(page_files / kind), str(page_files / "images")]
    produce_2layer_pdf.main(args + [str(tmp_path / "port")])
    jax_root, stderr = jax_script_outputs
    assert "Not matched" in stderr[kind]
    names = sorted(os.listdir(jax_root / kind))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["page0.pdf", "page1.pdf"]
    for name in names:
        assert_same_pdf_but_font((tmp_path / "port" / name).read_bytes(),
                                 (jax_root / kind / name).read_bytes())
    for name in names:  # chip_smoke's reader: the text layer and the image stream
        ((texts, image),) = chip_smoke.pdf_pages((tmp_path / "port" / name).read_bytes())
        assert texts == ["abcde", "ab cd", "cab dead", "ace"]
        page = imread(str(page_files / "images" / (name[:-4] + (".png" if "0" in name
                                                                 else ".jpg"))))
        assert image == encode_jpeg(page, 80)
    single = page_files / kind / (f"page1{'_alto' if kind == 'alto' else ''}.xml")
    produce_2layer_pdf.main(["--single-file", str(single), str(page_files / "images" / "page1.jpg"),
                             str(tmp_path / "single.pdf")])
    assert (tmp_path / "single.pdf").read_bytes() == (tmp_path / "port" / "page1.pdf").read_bytes()
