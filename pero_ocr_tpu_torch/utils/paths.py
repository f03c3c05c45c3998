"""Path helpers (copy of pero_ocr_tpu/utils/paths.py)."""

from __future__ import annotations

import os


def compose_path(file_path: str, reference_path: str) -> str:
    """Resolve `file_path` relative to `reference_path` (a config dir)
    unless it is already absolute."""
    if reference_path and file_path and not os.path.isabs(file_path):
        return os.path.join(reference_path, file_path)
    return file_path
