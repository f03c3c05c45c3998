"""Per-line transcript files: ``"<id> <text>"`` lines with an optional
embedding-id column (port of pero_ocr_tpu/transcription_io.py)."""

from __future__ import annotations

from typing import Dict, Optional


def parse_transcription_line(line: str, keep_eol: bool = False):
    """Split a transcript file line into (id, embed_id or None, text)."""
    if not keep_eol:
        line = line.rstrip("\n")
    parts = line.split(" ", 1)
    line_id = parts[0]
    rest = parts[1] if len(parts) > 1 else ""
    embed_id: Optional[int] = None
    if rest and rest.split(" ", 1)[0].isdigit():
        first, _, remainder = rest.partition(" ")
        embed_id = int(first)
        rest = remainder
    return line_id, embed_id, rest


def load_transcriptions(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for raw in f:
            if not raw.strip():
                continue
            line_id, _, text = parse_transcription_line(raw)
            out[line_id] = text
    return out


def save_transcriptions(path: str, transcriptions: Dict[str, str]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for line_id, text in transcriptions.items():
            f.write(f"{line_id} {text}\n")
