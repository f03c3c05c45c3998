"""``pero_ocr_tpu_torch.utils.timing.torch_profile`` against the JAX
package's ``jax_profile`` (tests/test_timing.py): a no-op without a
directory, and a trace on disk with one."""

import json
import os

import torch

from pero_ocr_tpu_torch.utils.timing import torch_profile


def test_noop_without_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with torch_profile(None):
        pass
    with torch_profile(""):
        pass
    assert os.listdir(tmp_path) == []


def test_writes_trace(tmp_path):
    """The trace lands in the directory as a ``*.pt.trace.json`` that
    names the ops run inside the block."""
    log_dir = str(tmp_path / "trace")
    with torch_profile(log_dir):
        x = torch.ones(64, 64)
        (x @ x).sum()
    found = [os.path.join(root, f) for root, _, files in os.walk(log_dir) for f in files]
    assert len(found) == 1 and found[0].endswith(".pt.trace.json")
    with open(found[0], encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
