"""The port stands alone: with jax, flax, cv2, lxml and msgpack blocked
(none of them is installed beside the card), every module of
pero_ocr_tpu_torch imports, a tiny CPU TorchPagePipeline runs through
FastPagePipeline to Page XML that xml.etree parses, and no module of the
JAX package gets loaded.  Runs in a subprocess so the blocking does not
leak into the other tests."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "flax", "cv2", "lxml", "msgpack")

SCRIPT = r"""
import importlib, json, pkgutil, sys
import xml.etree.ElementTree as ET
for name in %(blocked)r:
    sys.modules[name] = None  # any import of it raises ImportError

import numpy as np
import torch
import pero_ocr_tpu_torch

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

print(json.dumps({
    "modules": modules,
    "override": [[r.page_index, r.labels.shape[0]] for r in override],
    "cnn_pages": [r.page_index for r in cnn],
    "xml": parsed,
    "raised": raised,
    "loaded": sorted(k for k in sys.modules
                     if k == "pero_ocr_tpu" or k.startswith("pero_ocr_tpu.")),
    "cuda": torch.cuda.is_available(),
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
    assert got["override"] == [[0, 4], [1, 4], [2, 4]]  # one slot of line_slot 4
    assert got["cnn_pages"] == [0, 1, 2]
    # CNN pages (random weights), then the override pages with their line.
    assert [p[0] for p in got["xml"]] == ["p0", "p1", "p2"] * 2
    assert [p[1] for p in got["xml"]][3:] == [1, 1, 1]
    if got["cuda"]:
        pytest.skip("a CUDA device is present: the no-device error cannot show")
    assert got["raised"] is not None and "device='cpu'" in got["raised"]
