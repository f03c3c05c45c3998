"""The port stands alone: with jax, flax, optax, cv2, lxml, msgpack, PIL,
sklearn, fontTools and lmdb blocked (none of them is installed beside the
card), every module of
pero_ocr_tpu_torch and chip_smoke.py imports, a tiny CPU
TorchPagePipeline runs through FastPagePipeline to Page XML that
xml.etree parses, and on the crop transport (2-bit, with CNN detection
and skip_stage_a), the command line re-OCRs the Page XML it wrote
(``-x``, fast and stage by stage), the command line turns a folder of PNG pages into Page
XML files (a flax checkpoint written by the port's save_variables, a missing one
with --allow-random-weights), with logits and ALTO files on both paths,
config 1 (whole-page region, classical line detector) runs through the
command line to Page XML and ALTO, config 3 (the beam search with a
character LM written by the port's export_lm_checkpoint) through the command line to Page
XML, config 4 (ADJUST_HEIGHTS, the smart sorter and a reference
transformer .pt written here) through the command line to Page XML,
the layout stages and options of item 8d with TorchScript archives of
the port's ParseNet and recognizer traced here through the command line
to Page XML, JPEG pages written by the port's encoder (one with an EXIF
orientation) re-OCRed by both command lines into Page XML and JPEG line
crops that the port reads back,
PageParser's transformer engine runs on CUDA unless asked for the CPU,
the user scripts run on the command line's Page XML (compare_page_xml_texts
between its two paths, produce_2layer_pdf with the committed Latin font,
select_embed_id's KMeans route with --device cpu on a recognizer of 4
writer embeddings, which without --device asks for CUDA),
and no module of the JAX package gets loaded.  Runs in a subprocess so the blocking does not leak into the
other tests."""

import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "flax", "optax", "cv2", "lxml", "msgpack", "PIL", "sklearn", "fontTools",
           "lmdb")

SCRIPT = r"""
import importlib, json, os, pkgutil, re, sys
import xml.etree.ElementTree as ET
for name in %(blocked)r:
    sys.modules[name] = None  # any import of it raises ImportError

import numpy as np
import torch
import pero_ocr_tpu_torch

# The test worker's share of the cores: idle threads of tiny models spin
# on the cores that the other workers need.
workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // workers)))
modules = sorted(
    m.name for m in pkgutil.walk_packages(pero_ocr_tpu_torch.__path__, "pero_ocr_tpu_torch.")
)
for name in modules:
    importlib.import_module(name)

from pero_ocr_tpu_torch.models.parsenet import ParseNet
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.document.fast_pipeline import FastPagePipeline, assemble_page_layout

pn = ParseNet(base_features=4, depth=2, stem="s2d", out_upsample=2,
              generator=torch.Generator().manual_seed(0))
rec = CTCRecognizer(RecognizerSpec(num_classes=6, line_height=16, conv_features=(4, 8),
                                   lstm_layers=1, lstm_features=8),
                    generator=torch.Generator().manual_seed(1))
rng = np.random.default_rng(0)
pages = [rng.integers(0, 256, (128, 192, 3), dtype=np.uint8) for _ in range(3)]
lines = [([np.array([[10.0, 60.0], [150.0, 64.0]])], [[12.0, 4.0]])] * 3
pipe = TorchPagePipeline(pn, rec, crop_height=16, crop_bucket=64, line_slot=4, device="cpu")
override = list(pipe.run(pages, lines_override=lines, page_batch=2))
cnn = list(pipe.run(pages, page_batch=2))
crop_pipe = TorchPagePipeline(pn, rec, crop_height=16, crop_bucket=64, line_slot=4,
                              device="cpu", transport="crops", transport_bits=2)
crops = list(crop_pipe.run(pages, page_batch=2)) + list(
    crop_pipe.run(pages, lines_override=lines, page_batch=2, skip_stage_a=True))
chars = ["a", "&", "<", "ž", "'", "\u200b"]
ids = ["p0", "p1", "p2"]
xmls = [lay.to_pagexml_string()
        for lay in FastPagePipeline(pipe, chars, page_batch=2).process_pages(pages, ids)]
xmls += [assemble_page_layout(r, ids[r.page_index], (128, 192), chars).to_pagexml_string()
         for r in override]
ns = "{http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15}"
parsed = [[ET.fromstring(x.encode("utf-8")).find(ns + "Page").get("imageFilename"),
           len(ET.fromstring(x.encode("utf-8")).findall(f".//{ns}TextLine"))] for x in xmls]

try:
    TorchPagePipeline(pn, rec)
    raised = None
except RuntimeError as e:
    raised = str(e)

import os, tempfile
import chip_smoke
from pero_ocr_tpu_torch.scripts.parse_folder import main as cli_main
tmp = tempfile.mkdtemp()
os.makedirs(os.path.join(tmp, "images"))
for page_id, page in zip(ids, pages):
    with open(os.path.join(tmp, "images", page_id + ".png"), "wb") as f:
        f.write(chip_smoke.png_bytes(page))
small = RecognizerSpec(num_classes=6, line_height=16, conv_features=(4, 8), lstm_layers=1,
                       lstm_features=8)
from pero_ocr_tpu_torch.utils import checkpoint, convert
checkpoint.save_variables(convert.recognizer_params_to_flax(
    CTCRecognizer(small, generator=torch.Generator().manual_seed(2))),
    os.path.join(tmp, "rec.msgpack"))
with open(os.path.join(tmp, "ocr.json"), "w", encoding="utf-8") as f:
    json.dump({"characters": chars[:-1], "line_px_height": 16, "checkpoint": "rec.msgpack",
               "net_spec": {"conv_features": [4, 8], "lstm_layers": 1, "lstm_features": 8,
                            "dtype": "float32"}}, f)
with open(os.path.join(tmp, "config.ini"), "w") as f:
    f.write("[PAGE_PARSER]\nRUN_LAYOUT_PARSER = yes\nRUN_LINE_CROPPER = yes\nRUN_OCR = yes\n"
            "[LAYOUT_PARSER_1]\nMETHOD = LAYOUT_CNN\nMODEL_PATH = missing.msgpack\n"
            "FAST_STEM = yes\nOUT_UPSAMPLE = 2\nBASE_FEATURES = 4\nDEPTH = 2\n"
            "[LINE_CROPPER]\nLINE_HEIGHT = 16\n[OCR]\nOCR_JSON = ocr.json\n")
cli_main(["-c", os.path.join(tmp, "config.ini"), "-i", os.path.join(tmp, "images"),
          "--output-xml-path", os.path.join(tmp, "xml"), "--fast-pipeline", "--device", "cpu",
          "--allow-random-weights"])
cli_main(["-c", os.path.join(tmp, "config.ini"), "-i", os.path.join(tmp, "images"),
          "--output-xml-path", os.path.join(tmp, "xml_staged"), "--device", "cpu",
          "--allow-random-weights"])
with open(os.path.join(tmp, "ocr_only.ini"), "w") as f:
    f.write("[PAGE_PARSER]\nRUN_LINE_CROPPER = yes\nRUN_OCR = yes\n"
            "[LINE_CROPPER]\nLINE_HEIGHT = 16\n[OCR]\nOCR_JSON = ocr.json\n")
for flags, out in ((["--fast-pipeline", "--transport-bits", "2"], "reocr_fast"), ([], "reocr")):
    cli_main(["-c", os.path.join(tmp, "ocr_only.ini"), "-i", os.path.join(tmp, "images"),
              "-x", os.path.join(tmp, "xml"), "--output-xml-path", os.path.join(tmp, out),
              "--device", "cpu", "--transport", "crops", "--allow-random-weights", *flags])
from pero_ocr_tpu_torch.utils.image_io import encode_jpeg, imread
os.makedirs(os.path.join(tmp, "jpeg"))
os.makedirs(os.path.join(tmp, "xml_lines"))
for page_id, page, xml in zip(ids, pages, xmls[3:]):  # the override pages: one line each
    with open(os.path.join(tmp, "jpeg", page_id + ".jpg"), "wb") as f:
        f.write(encode_jpeg(page, 90))
    with open(os.path.join(tmp, "xml_lines", page_id + ".xml"), "w", encoding="utf-8") as f:
        f.write(xml)
turned = encode_jpeg(pages[0], 90)
exif = b"Exif\x00\x00II*\x00\x08\x00\x00\x00\x01\x00\x12\x01\x03\x00\x01\x00\x00\x00\x06\x00\x00\x00\x00\x00\x00\x00"
turned = turned[:2] + b"\xff\xe1" + (len(exif) + 2).to_bytes(2, "big") + exif + turned[2:]
with open(os.path.join(tmp, "turned.jpg"), "wb") as f:
    f.write(turned)
jpeg_shapes = [list(imread(os.path.join(tmp, "jpeg", "p0.jpg")).shape),
               list(imread(os.path.join(tmp, "turned.jpg")).shape)]
for flags, out in ((["--fast-pipeline"], "lines_fast"), ([], "lines_staged")):
    cli_main(["-c", os.path.join(tmp, "ocr_only.ini"), "-i", os.path.join(tmp, "jpeg"),
              "-x", os.path.join(tmp, "xml_lines"), "--output-line-path",
              os.path.join(tmp, out), "--output-xml-path", os.path.join(tmp, out + "_xml"),
              "--device", "cpu", "--allow-random-weights", *flags])
line_files = {out: [[name, list(imread(os.path.join(tmp, out, name)).shape)]
                    for name in sorted(os.listdir(os.path.join(tmp, out)))]
              for out in ("lines_fast", "lines_staged")}
for flag, out in (("--fast-pipeline", "fast"), ("--skip-processed", "staged")):
    cli_main(["-c", os.path.join(tmp, "config.ini"), "-i", os.path.join(tmp, "images"),
              "--output-logit-path", os.path.join(tmp, out + "_logits"), "--output-alto-path",
              os.path.join(tmp, out + "_alto"), flag, "--device", "cpu",
              "--allow-random-weights"])
printed, _ = chip_smoke.printed_pages(np.random.default_rng(3), 2, 240, 320, 5)
os.makedirs(os.path.join(tmp, "printed"))
for i, page in enumerate(printed):
    with open(os.path.join(tmp, "printed", f"c{i}.png"), "wb") as f:
        f.write(chip_smoke.png_bytes(page))
with open(os.path.join(tmp, "config1.ini"), "w") as f:
    f.write("[PAGE_PARSER]\nRUN_LAYOUT_PARSER = yes\nRUN_LINE_CROPPER = yes\nRUN_OCR = yes\n"
            "[LAYOUT_PARSER_1]\nMETHOD = REGION_WHOLE_PAGE\n"
            "[LAYOUT_PARSER_2]\nMETHOD = LINES_SIMPLE_THRESHOLD\n"
            "[LINE_CROPPER]\nLINE_HEIGHT = 16\n[OCR]\nOCR_JSON = ocr.json\n")
cli_main(["-c", os.path.join(tmp, "config1.ini"), "-i", os.path.join(tmp, "printed"),
          "--output-xml-path", os.path.join(tmp, "xml1"), "--output-alto-path",
          os.path.join(tmp, "alto1"), "--device", "cpu"])
from pero_ocr_tpu_torch.models.charlm import CharLM, CharLMSpec
os.makedirs(os.path.join(tmp, "lm"))
from pero_ocr_tpu_torch.parallel.train import export_lm_checkpoint
export_lm_checkpoint(CharLM(CharLMSpec(vocab_size=len(chars), embed_dim=8, hidden_dim=16),
                            generator=torch.Generator().manual_seed(4)),
                     os.path.join(tmp, "lm", "charlm.lm"))
with open(os.path.join(tmp, "config.ini")) as f:
    config3 = f.read().replace("RUN_OCR = yes\n", "RUN_OCR = yes\nRUN_DECODER = yes\n")
with open(os.path.join(tmp, "config3.ini"), "w") as f:
    f.write(config3 + "[DECODER]\nTYPE = TPU-BEAM\nBEAM_SIZE = 8\nLM = lm/charlm.lm\n"
            "LM_SCALE = 0.5\nINSERTION_BONUS = 0.2\nTRANSPORT_DTYPE = float16\n"
            "CARRY_H_OVER = yes\n")
from pero_ocr_tpu_torch.utils.checkpoint import set_strict_loading
set_strict_loading(False)  # the config-1 run above set it process-wide
cli_main(["-c", os.path.join(tmp, "config3.ini"), "-i", os.path.join(tmp, "images"),
          "--output-xml-path", os.path.join(tmp, "xml3"), "--fast-pipeline", "--device", "cpu",
          "--allow-random-weights"])
from pero_ocr_tpu_torch.models.transformer_ref import RefTransformerOCR, RefTransformerSpec
net = {"dim_model": 16, "dim_ff": 32, "heads": 2, "encoder_layers": 1, "decoder_layers": 1,
       "max_seq_len": 64}
torch.save(RefTransformerOCR(RefTransformerSpec(num_symbols=len(chars) + 1, in_height=16, **net),
                             generator=torch.Generator().manual_seed(5)).state_dict(),
           os.path.join(tmp, "ref.pt"))
with open(os.path.join(tmp, "transformer.json"), "w", encoding="utf-8") as f:
    json.dump({"characters": chars[:-1], "line_px_height": 16, "checkpoint": "ref.pt",
               "net_name": json.dumps(net)}, f)
with open(os.path.join(tmp, "config.ini")) as f:
    config4 = f.read().replace("DEPTH = 2\n", "DEPTH = 2\nADJUST_HEIGHTS = yes\n")
config4 = config4.replace("[LINE_CROPPER]", "[LAYOUT_PARSER_2]\nMETHOD = REGION_SORTER_SMART\n"
                          "[LINE_CROPPER]").replace("OCR_JSON = ocr.json",
                                                    "OCR_JSON = transformer.json\n"
                                                    "METHOD = transformer")
with open(os.path.join(tmp, "config4.ini"), "w") as f:
    f.write(config4)
cli_main(["-c", os.path.join(tmp, "config4.ini"), "-i", os.path.join(tmp, "images"),
          "--output-xml-path", os.path.join(tmp, "xml4"), "--device", "cpu",
          "--allow-random-weights"])
torch.jit.trace(chip_smoke.ArchiveParseNet(ParseNet(base_features=4, depth=2, dtype=torch.float32,
                                         generator=torch.Generator().manual_seed(6))).eval(),
                torch.rand(1, 3, 64, 64)).save(os.path.join(tmp, "parsenet.pt"))
torch.jit.trace(chip_smoke.ArchiveRecognizer(CTCRecognizer(RecognizerSpec(
    num_classes=6, line_height=16, conv_features=(4, 8), lstm_layers=1, lstm_features=8,
    dtype=torch.float32), generator=torch.Generator().manual_seed(7))).eval(),
    torch.rand(1, 3, 16, 64)).save(os.path.join(tmp, "rec.pt"))
with open(os.path.join(tmp, "ocr_ts.json"), "w", encoding="utf-8") as f:
    json.dump({"characters": chars[:-1], "line_px_height": 16, "checkpoint": "rec.pt"}, f)
with open(os.path.join(tmp, "config8d.ini"), "w") as f:
    f.write("[PAGE_PARSER]\nRUN_LAYOUT_PARSER = yes\nRUN_LINE_CROPPER = yes\nRUN_OCR = yes\n"
            "[LAYOUT_PARSER_1]\nMETHOD = LAYOUT_CNN\nMODEL_PATH = parsenet.pt\n"
            "MULTI_ORIENTATION = yes\nMERGE_LINES = yes\nADJUST_BASELINES = yes\n"
            "DETECT_STRAIGHT_LINES_IN_REGIONS = yes\n"
            "[LAYOUT_PARSER_2]\nMETHOD = LINE_FILTER\nFILTER_DIRECTIONS = yes\n"
            "FILTER_INCOMPLETE_PAGES = yes\n"
            "[LAYOUT_PARSER_3]\nMETHOD = LINE_POSTPROCESSING\nSTRETCH_LINES = max\n"
            "[LAYOUT_PARSER_4]\nMETHOD = LAYOUT_POSTPROCESSING\nRETRACE_REGIONS = yes\n"
            "[LAYOUT_PARSER_5]\nMETHOD = REGION_SORTER_NAIVE\n"
            "[LINE_CROPPER]\nLINE_HEIGHT = 16\n[OCR]\nOCR_JSON = ocr_ts.json\n")
set_strict_loading(False)
cli_main(["-c", os.path.join(tmp, "config8d.ini"), "-i", os.path.join(tmp, "images"),
          "--output-xml-path", os.path.join(tmp, "xml8d"), "--device", "cpu",
          "--allow-random-weights"])
import configparser
from pero_ocr_tpu_torch.document.page_parser import PageParser
parsed4 = configparser.ConfigParser()
parsed4.read(os.path.join(tmp, "config4.ini"))
engine4 = PageParser(parsed4, config_path=tmp).ocr.ocr_engine
try:
    engine4.run_ocr(np.zeros((1, 16, 64, 3), np.uint8), np.array([64]))
    raised4 = None
except RuntimeError as e:
    raised4 = str(e)
from pero_ocr_tpu_torch.scripts import compare_page_xml_texts, produce_2layer_pdf, select_embed_id
compare_page_xml_texts.main(["--hyp", os.path.join(tmp, "xml_staged"), "--ref",
                             os.path.join(tmp, "xml")])
produce_2layer_pdf.main([os.path.join(tmp, "xml"), os.path.join(tmp, "images"),
                         os.path.join(tmp, "pdf"), "--font",
                         os.path.join("tests", "data", "pdf", "DejaVuSans-Latin.ttf")])
embed = RecognizerSpec(num_classes=6, line_height=16, conv_features=(4, 8), lstm_layers=1,
                       lstm_features=8, embed_num=4, embed_dim=4, dtype=torch.float32)
checkpoint.save_variables(convert.recognizer_params_to_flax(
    CTCRecognizer(embed, generator=torch.Generator().manual_seed(8))),
    os.path.join(tmp, "embed.msgpack"))
with open(os.path.join(tmp, "embed.json"), "w", encoding="utf-8") as f:
    json.dump({"characters": chars[:-1], "line_px_height": 16, "checkpoint": "embed.msgpack",
               "embed_num": 4, "net_spec": {"conv_features": [4, 8], "lstm_layers": 1,
                                            "lstm_features": 8, "embed_dim": 4,
                                            "dtype": "float32"}}, f)
with open(os.path.join(tmp, "embed.ini"), "w") as f:
    f.write("[PAGE_PARSER]\nRUN_LINE_CROPPER = yes\nRUN_OCR = yes\n"
            "[LINE_CROPPER]\nLINE_HEIGHT = 16\n[OCR]\nOCR_JSON = embed.json\n")
embed_args = ["-c", os.path.join(tmp, "embed.ini"), "-i", os.path.join(tmp, "images"), "-x",
              os.path.join(tmp, "xml_lines"), "--n-clusters", "2", "--n-lines", "3"]
np.random.seed(0)  # the representatives: a random member of each cluster
select_embed_id.main(embed_args + ["--device", "cpu"])
with open(os.path.join(tmp, "embed.json"), encoding="utf-8") as f:
    selected = json.load(f)["embed_id"]
try:
    select_embed_id.main(embed_args)
    raised_embed = None
except RuntimeError as e:
    raised_embed = str(e)
outputs = {out: sorted(os.listdir(os.path.join(tmp, out)))
           for out in ("fast_logits", "fast_alto", "staged_logits", "staged_alto", "xml1", "alto1",
                       "xml3", "xml4", "reocr_fast", "reocr", "xml8d", "pdf")}
alto_ns = "{http://www.loc.gov/standards/alto/ns-v2#}"
config1_lines = []
for name in outputs["xml1"]:
    with open(os.path.join(tmp, "xml1", name), "rb") as f:
        config1_lines.append(len(ET.fromstring(f.read()).findall(f".//{ns}TextLine")))
    with open(os.path.join(tmp, "alto1", name), "rb") as f:
        ET.fromstring(f.read()).find(alto_ns + "Layout")

cli = []
for out in ("xml", "xml_staged"):
    for name in sorted(os.listdir(os.path.join(tmp, out))):
        with open(os.path.join(tmp, out, name), "rb") as f:
            cli.append([name, ET.fromstring(f.read()).find(ns + "Page").get("imageFilename")])

print(json.dumps({
    "modules": modules,
    "override": [[r.page_index, r.labels.shape[0]] for r in override],
    "cnn_pages": [r.page_index for r in cnn],
    "crops": [[r.page_index, str(r.labels.dtype) if r.labels is not None else None]
              for r in crops],
    "xml": parsed,
    "raised": raised,
    "loaded": sorted(k for k in sys.modules
                     if k == "pero_ocr_tpu" or k.startswith("pero_ocr_tpu.")),
    "cuda": torch.cuda.is_available(),
    "cli": cli,
    "outputs": outputs,
    "config1_lines": config1_lines,
    "jpeg_shapes": jpeg_shapes,
    "line_files": line_files,
    "line_ids": [re.search(r'TextLine id="([^"]+)"', x).group(1) for x in xmls[3:]],
    "engine4": [type(engine4).__name__, engine4.device, engine4.ref_mode],
    "raised4": raised4,
    "selected": selected,
    "raised_embed": raised_embed,
}))
"""


def test_port_runs_without_jax_and_host_libraries():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT % {"blocked": BLOCKED}],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pero_ocr_tpu_torch.parallel.pipeline" in got["modules"]
    assert "pero_ocr_tpu_torch.ops.warp" in got["modules"]
    assert got["loaded"] == []
    assert "pero_ocr_tpu_torch.scripts.parse_folder" in got["modules"]
    assert got["cli"] == [[f"p{i}.xml", f"p{i}"] for i in range(3)] * 2  # fast, staged
    for path in ("fast", "staged"):
        assert got["outputs"][path + "_logits"] == [f"p{i}.logits" for i in range(3)]
        assert got["outputs"][path + "_alto"] == [f"p{i}.xml" for i in range(3)]
    assert got["outputs"]["xml1"] == got["outputs"]["alto1"] == ["c0.xml", "c1.xml"]
    assert got["outputs"]["xml3"] == [f"p{i}.xml" for i in range(3)]  # config 3, decoded
    assert got["outputs"]["xml4"] == [f"p{i}.xml" for i in range(3)]  # config 4, transformer
    assert got["outputs"]["xml8d"] == [f"p{i}.xml" for i in range(3)]  # item 8d, TorchScript
    for name in ("naive_sorter", "line_in_region_detector", "baseline_refiner",
                 "line_postprocessing_engine"):
        assert f"pero_ocr_tpu_torch.layout_engines.{name}" in got["modules"]
    assert "pero_ocr_tpu_torch.utils.ts_adapters" in got["modules"]
    assert "pero_ocr_tpu_torch.utils.jpeg" in got["modules"]
    assert got["jpeg_shapes"] == [[128, 192, 3], [192, 128, 3]]  # EXIF orientation 6 turns
    for out in ("lines_fast", "lines_staged"):  # one line a page, its crop 16 rows high
        assert [name for name, _ in got["line_files"][out]] == [
            f"p{i}-{lid}.jpg" for i, lid in enumerate(got["line_ids"])]
        assert all(shape[0] == 16 and shape[2] == 3 for _, shape in got["line_files"][out])
    for out in ("reocr_fast", "reocr"):  # -x on the crop transport, and stage by stage
        assert got["outputs"][out] == [f"p{i}.xml" for i in range(3)]
    assert [c[0] for c in got["crops"]] == [0, 1, 2] * 2  # CNN, then skip_stage_a
    assert got["crops"][3:] == [[i, "uint8"] for i in range(3)]
    assert got["engine4"] == ["TransformerEngineLineOCR", None, True]  # CUDA by default
    assert got["config1_lines"] == [5, 5]
    assert got["outputs"]["pdf"] == [f"p{i}.pdf" for i in range(3)]
    assert got["selected"] in ("0", "1", "2", "3", "4")  # 4: the mean row
    for name in ("compare_page_xml_texts", "compare_txt", "eval_parity", "merge_ocr_results",
                 "produce_2layer_pdf", "select_embed_id"):
        assert f"pero_ocr_tpu_torch.scripts.{name}" in got["modules"]
    for name in ("sequence_alignment", "error_summary", "char_confidences", "transcription_io",
                 "line_images_io", "utils.kmeans", "utils.truetype", "document.pdf",
                 "document_ocr.page_parser", "document_ocr.pdf_production"):
        assert f"pero_ocr_tpu_torch.{name}" in got["modules"]
    assert got["override"] == [[0, 4], [1, 4], [2, 4]]  # one slot of line_slot 4
    assert got["cnn_pages"] == [0, 1, 2]
    # CNN pages (random weights), then the override pages with their line.
    assert [p[0] for p in got["xml"]] == ["p0", "p1", "p2"] * 2
    assert [p[1] for p in got["xml"]][3:] == [1, 1, 1]
    if got["cuda"]:
        pytest.skip("a CUDA device is present: the no-device error cannot show")
    assert got["raised"] is not None and "device='cpu'" in got["raised"]
    assert got["raised4"] is not None and "device='cpu'" in got["raised4"]
    assert got["raised_embed"] is not None and "device='cpu'" in got["raised_embed"]


NATIVE_SCRIPT = r"""
import json, re, sys
for name in %(blocked)r:
    sys.modules[name] = None

import numpy as np
import torch
from pero_ocr_tpu_torch.models.parsenet import ParseNet
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.utils import kernels, native

pn = ParseNet(base_features=4, depth=2, stem="s2d", out_upsample=2,
              generator=torch.Generator().manual_seed(0))
rec = CTCRecognizer(RecognizerSpec(num_classes=6, line_height=16, conv_features=(4, 8),
                                   lstm_layers=1, lstm_features=8),
                    generator=torch.Generator().manual_seed(1))
pages = [np.random.default_rng(0).integers(0, 256, (128, 192, 3), dtype=np.uint8)] * 2
pipe = TorchPagePipeline(pn, rec, crop_height=16, crop_bucket=64, line_slot=4, device="cpu",
                         native=True)
list(pipe.run(pages, page_batch=2))
with open("/proc/self/maps") as f:
    maps = sorted({line.split()[-1] for line in f if "perotpu" in line})
print(json.dumps({
    "maps": maps,
    "calls": native.calls["cc_label_u8"],
    "target": str(kernels._target("perotpu", kernels._command("perotpu"))),
    "source": str(kernels.source("perotpu")),
    "loaded": sorted(k for k in sys.modules
                     if k == "pero_ocr_tpu" or k.startswith("pero_ocr_tpu.")),
}))
"""


def test_native_route_loads_only_the_ports_library():
    """A native-route run loads the port's build of csrc/perotpu.cpp and
    never the JAX package's native/libperotpu.so; no module of the port
    imports the JAX package (its native bindings included)."""
    import shutil

    if shutil.which(os.environ.get("CXX") or "c++") is None:
        pytest.skip("no host C++ compiler")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", NATIVE_SCRIPT % {"blocked": BLOCKED}],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["calls"] == 2  # one cc_label_u8 call a page
    assert got["maps"] == [got["target"]]
    assert "/build/kernels/" in got["target"] and "/native/" not in got["target"]
    assert got["source"] == os.path.join(REPO, "pero_ocr_tpu_torch", "csrc", "perotpu.cpp")
    assert got["loaded"] == []
    port = os.path.join(REPO, "pero_ocr_tpu_torch")
    imports = re.compile(r"^\s*(from|import)\s+pero_ocr_tpu(\.|\s|$)", re.M)
    for root, _, files in os.walk(port):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name), encoding="utf-8") as f:
                    assert not imports.search(f.read()), os.path.join(root, name)


LEFTOVERS_SCRIPT = r"""
import contextlib, io, json, os, sys, tempfile
for name in %(blocked)r:
    sys.modules[name] = None

import numpy as np
import scipy.sparse
import torch

from pero_ocr_tpu_torch.core.crop_engine import EngineLineCropper
from pero_ocr_tpu_torch.core.layout import PageLayout, RegionLayout, TextLine
from pero_ocr_tpu_torch.decoding.bag_of_hypotheses import BagOfHypotheses
from pero_ocr_tpu_torch.decoding.confusion_networks import best_cn_path, produce_cn_from_boh
from pero_ocr_tpu_torch.models import transformer as tf
from pero_ocr_tpu_torch.ocr.postprocess import narrow_label
from pero_ocr_tpu_torch.ops.ctc import align_text_batch
from pero_ocr_tpu_torch.scripts import convert_torch_lm, convert_torchscript

chars = list("ab ") + ["​"]
dense = np.full((13, 4), -1.0)
for i, ch in enumerate("ab ab"):
    dense[1 + 2 * i, chars.index(ch)] = 15.0
dense[dense.max(axis=1) < 10, -1] = 12.0
layout = PageLayout(id="p0", page_size=(100, 200))
region = RegionLayout("r1", np.array([[5, 5], [190, 5], [190, 90], [5, 90]]))
region.lines.append(TextLine(id="r1-l1", baseline=np.array([[10, 50], [180, 52]]),
                             polygon=np.array([[10, 30], [180, 32], [180, 58], [10, 56]]),
                             heights=[20.0, 6.0], transcription="ab ab",
                             logits=scipy.sparse.csc_matrix(np.where(dense > 0, dense, 0)),
                             characters=chars, logit_coords=[0, 13]))
layout.regions.append(region)
back = PageLayout()
back.from_altoxml_string(layout.to_altoxml_string(native=False))
quality = layout.get_quality(native=False)

lp = np.log(np.full((2, 6, 3), 1 / 3, np.float32))
positions, valid = align_text_batch(lp, np.array([[0, 1], [1, 1]]), np.array([2, 2]),
                                    np.array([6, 5]), device="cpu")
bag = BagOfHypotheses()
bag.add("ab", -0.1)
bag.add("ax", -2.0)
page = np.random.default_rng(0).integers(0, 256, (100, 200, 3), dtype=np.uint8)
cropper = EngineLineCropper(16, 2, 1.0)
crop, mapping, offset = cropper.crop(page, np.array([[10.0, 50], [180, 52]]), [14.0, 5.0],
                                     return_mapping=True)
blended = cropper.blend_in(page.copy(), 255 - crop, mapping, offset)
spec = tf.TransformerSpec(num_classes=5, line_height=16, conv_features=(4, 8), d_model=16,
                          num_heads=2, encoder_layers=1, decoder_layers=1, mlp_dim=16,
                          max_decode_len=8, dtype=torch.float32)
model = tf.TransformerOCR(spec, generator=torch.Generator().manual_seed(0)).eval()
with torch.no_grad():
    memory = model.encode(torch.rand(2, 16, 32, 3), torch.tensor([[True] * 8, [True] * 3 + [False] * 5]))

class Frames(torch.nn.Module):  # a CTC-shaped archive: (N, 3, 32, W) -> (N, W / 4, 5)
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 5, (32, 4), stride=(32, 4))

    def forward(self, x):
        return self.conv(x)[:, :, 0].permute(0, 2, 1)


torch.set_num_threads(2)
tmp = tempfile.mkdtemp()
lm = torch.nn.Module()
lm.embed = torch.nn.Embedding(5, 4)
lm.lstm = torch.nn.LSTM(4, 6, batch_first=True)
lm.head = torch.nn.Linear(6, 5)
torch.save(lm.state_dict(), os.path.join(tmp, "lm.pt"))
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    convert_torch_lm.main([os.path.join(tmp, "lm.pt"), os.path.join(tmp, "out.lm")])
    torch.jit.trace(Frames().eval(), torch.rand(1, 3, 32, 64)).save(os.path.join(tmp, "net.pt"))
    convert_torchscript.main(["inspect", os.path.join(tmp, "net.pt")])
    args = convert_torchscript.parse_arguments(
        ["distill", os.path.join(tmp, "net.pt"), "--family", "ctc", "--out",
         os.path.join(tmp, "net.ckpt"), "--steps", "1", "--batch", "1", "--num-samples", "1"])
    run = convert_torchscript.distill(args, device="cpu", dtype=torch.float32)
import hashlib
from pero_ocr_tpu_torch.utils.image_io import imread
read = {}
for folder in ("jpeg", "bmp", "jpeg2000", "webp"):
    with open(os.path.join("tests", "data", folder, "fixtures.json"), encoding="utf-8") as f:
        spec = json.load(f)
    for name, digest in spec["decode"].items():
        if name.startswith(("prog_", "base_c", "base_y", "o_", "b_", "c_lossy_q75", "c_lossless_37",
                            "v_partitions8", "r_anim_lossy", "r_alph_lossless_f3", "p_exif_o6")) \
                or folder == "bmp":
            img = imread(os.path.join("tests", "data", folder, name))
            read[name] = hashlib.sha256(img.tobytes()).hexdigest() == digest["sha256"]
print(json.dumps({
    "images": read,
    "texts": [line.transcription for line in back.lines_iterator()],
    "quality": quality,
    "positions": positions.tolist(), "valid": valid.tolist(),
    "cn": best_cn_path(produce_cn_from_boh(bag)),
    "narrow": narrow_label([0, 0, 2], np.eye(3), 2),
    "blend": [list(mapping.shape), list(offset), bool((blended != page).any())],
    "memory": list(memory.shape),
    "printed": printed.getvalue().splitlines(),
    "loss": run["losses"],
    "files": sorted(os.listdir(tmp)),
    "loaded": sorted(k for k in sys.modules
                     if k == "pero_ocr_tpu" or k.startswith("pero_ocr_tpu.")),
    "jpeg2000": "pero_ocr_tpu_torch.utils.jpeg2000" in sys.modules,
    "webp": "pero_ocr_tpu_torch.utils.webp" in sys.modules,
}))
"""


def test_leftover_modules_run_without_jax():
    """The ALTO reader and page quality, the batched alignment, confusion
    networks, label narrowing, crop re-compositing, the transformer's
    source masks and both conversion scripts (convert_torch_lm;
    convert_torchscript inspect and a one-step CTC distillation on the
    CPU), and the image readers of progressive and four-component JPEG,
    BMP, PAM, JPEG 2000 and WebP (each committed fixture, or for JPEG
    2000 those of libopenjp2 and of hand-built boxes and for WebP a
    lossy, a lossless, an 8-partition, an animated, an alpha and an
    EXIF-turned one, to its digest) run with jax,
    flax, optax, cv2, lxml, msgpack and PIL blocked."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", LEFTOVERS_SCRIPT % {"blocked": BLOCKED}],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["texts"] == ["ab ab"]
    assert 0.9 <= got["quality"] <= 1.0
    assert got["valid"] == [True, True] and got["positions"][1][0] < got["positions"][1][1]
    assert got["cn"] == "ab" and got["narrow"] == [0, 2, 2]
    assert got["blend"][2] and got["memory"] == [2, 8, 16]
    assert got["printed"][0].startswith("converted: vocab=5 embed=4 hidden=6 layers=1 -> ")
    assert "== op histogram ==" in got["printed"]
    assert len(got["loss"]) == 1 and got["loss"][0] > 0
    assert {"out.lm", "out.lm.json", "net.ckpt"} <= set(got["files"])
    assert got["loaded"] == []
    names = " ".join(got["images"])
    assert got["jpeg2000"] and got["webp"]
    for kind in ("prog_cut", "cmyk", "ycck", ".bmp", ".pam", ".jp2", ".j2k", ".webp"):
        assert kind in names, kind
    assert all(got["images"].values()), [k for k, ok in got["images"].items() if not ok]
