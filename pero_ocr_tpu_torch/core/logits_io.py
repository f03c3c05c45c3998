"""The sparse-logits pickle of ``--output-logit-path`` (port of
pero_ocr_tpu/core/logits_io.py), the same format as the JAX package's,
so either package reads the other's files: a pickled dict of one
``scipy.sparse.csc_matrix`` (T, C) per line id, plus ``'line_characters'``
and ``'logit_coords'`` dicts by line id; files at pickle protocol 4.

``load_logits`` unpickles: give it only files this program or the JAX
package wrote.
"""

from __future__ import annotations

import pickle
from typing import Union


def _gen_logits(layout, missing_line_logits_ok: bool = False) -> dict:
    logits = {}
    characters = {}
    logit_coords = {}
    for line in layout.lines_iterator():
        missing = line.logits is None or line.characters is None or line.logit_coords is None
        if missing:
            if missing_line_logits_ok:
                continue
            if line.logits is None:
                raise ValueError(f"Missing logits for line {line.id}.")
            if line.characters is None:
                raise ValueError(f"Missing logits mapping to characters for line {line.id}.")
            raise ValueError(f"Missing logits coords for line {line.id}.")
        logits[line.id] = line.logits
        characters[line.id] = line.characters
        logit_coords[line.id] = line.logit_coords
    logits["line_characters"] = characters
    logits["logit_coords"] = logit_coords
    return logits


def save_logits(layout, file_name: str, missing_line_logits_ok: bool = False) -> None:
    with open(file_name, "wb") as f:
        pickle.dump(_gen_logits(layout, missing_line_logits_ok), f, protocol=4)


def save_logits_bytes(layout, missing_line_logits_ok: bool = False) -> bytes:
    return pickle.dumps(
        _gen_logits(layout, missing_line_logits_ok), protocol=pickle.HIGHEST_PROTOCOL
    )


def load_logits(layout, file: Union[str, bytes]) -> None:
    if isinstance(file, bytes):
        logits_dict = pickle.loads(file)
    else:
        with open(file, "rb") as f:
            logits_dict = pickle.load(f)

    characters = logits_dict.get("line_characters", {k: None for k in logits_dict})
    logit_coords = logits_dict.get("logit_coords", {k: [None, None] for k in logits_dict})

    for line in layout.lines_iterator():
        if line.id not in logits_dict:
            continue
        line.logits = logits_dict[line.id]
        line.characters = characters[line.id]
        line.logit_coords = logit_coords[line.id]
