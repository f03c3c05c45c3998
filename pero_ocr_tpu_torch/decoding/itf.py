"""Decoder and LM construction from the pipeline config, plus batch
decode helpers (port of pero_ocr_tpu/decoding/itf.py).

``[DECODER] LM`` names the character LM: a CharLM flax msgpack
checkpoint (the JAX package's ``save_variables``) with a sidecar JSON
spec (``<LM path> + '.json'``: ``vocab_size``, ``embed_dim``,
``hidden_dim``, ``num_layers``, ``cell_type`` and an optional ``vocab``
map), or a torch LM file (state dict, pickled module or TorchScript),
converted at load with the JAX package's gate mapping.
"""

from __future__ import annotations

import json
import logging
import os
import time
import zipfile
from typing import List

import numpy as np
import torch

from pero_ocr_tpu_torch.decoding.decoders import (
    BLANK_SYMBOL,
    CTCPrefixLogRawNumpyDecoder,
    GreedyDecoder,
)
from pero_ocr_tpu_torch.decoding.lm_wrapper import LMWrapper
from pero_ocr_tpu_torch.models.charlm import CharLM, CharLMSpec
from pero_ocr_tpu_torch.utils.checkpoint import load_variables, strict_loading_enabled
from pero_ocr_tpu_torch.utils.convert import charlm_params_from_flax, load_torch_lm_file
from pero_ocr_tpu_torch.utils.paths import compose_path

ZERO_LOGITS = -80.0

logger = logging.getLogger(__name__)


def get_ocr_charset(fn: str) -> List[str]:
    with open(fn, encoding="utf8") as f:
        return json.load(f)["characters"]


def _is_torch_lm_file(path: str) -> bool:
    """Torch artifacts are zip archives (torch>=1.6 pickles, TorchScript)
    or legacy pickle streams (0x80 protocol byte); flax msgpack
    checkpoints are neither."""
    if zipfile.is_zipfile(path):
        return True
    with open(path, "rb") as f:
        return f.read(1) == b"\x80"


def _charlm(spec_dict: dict, variables=None) -> CharLM:
    spec = CharLMSpec(
        vocab_size=spec_dict["vocab_size"], embed_dim=spec_dict["embed_dim"],
        hidden_dim=spec_dict["hidden_dim"], num_layers=spec_dict["num_layers"],
        cell_type=spec_dict["cell_type"],
    )
    model = CharLM(spec, generator=torch.Generator().manual_seed(0))
    if variables is not None:
        model.load_state_dict(charlm_params_from_flax(variables))
    return model


def construct_lm(path: str, decoder_symbols, config_path: str = "") -> LMWrapper:
    """A ``[DECODER] LM`` file and its sidecar spec -> an LMWrapper.

    A missing file raises under strict loading (the command line's
    default) and otherwise gives random weights with a warning."""
    full_path = compose_path(path, config_path)
    spec_path = full_path + ".json"
    spec_dict = None
    if os.path.exists(spec_path):
        with open(spec_path, encoding="utf8") as f:
            spec_dict = json.load(f)

    if os.path.exists(full_path) and _is_torch_lm_file(full_path):
        logger.info("Converting torch LM %s at load.", full_path)
        variables, derived_spec = load_torch_lm_file(full_path)
        if spec_dict and "vocab" in spec_dict:
            derived_spec["vocab"] = spec_dict["vocab"]
        return LMWrapper(_charlm(derived_spec, variables), decoder_symbols,
                         vocab_map=derived_spec.get("vocab"))

    if spec_dict is None:
        logger.warning("LM spec sidecar %s not found; using defaults sized to the "
                       "decoder charset.", spec_path)
        spec_dict = {}
    spec_dict = {
        "vocab_size": spec_dict.get("vocab_size", len(decoder_symbols) + 1),
        "embed_dim": spec_dict.get("embed_dim", 64),
        "hidden_dim": spec_dict.get("hidden_dim", 512),
        "num_layers": spec_dict.get("num_layers", 2),
        "cell_type": spec_dict.get("cell_type", "lstm"),
        "vocab": spec_dict.get("vocab"),  # optional {char: lm_id}
    }
    if os.path.exists(full_path):
        model = _charlm(spec_dict, load_variables(full_path))
    else:
        if strict_loading_enabled():
            raise FileNotFoundError(
                f"LM checkpoint {full_path} not found. Fix the [DECODER] "
                "LM path, or pass --allow-random-weights."
            )
        logger.warning("LM checkpoint %s not found; using RANDOM weights.", full_path)
        model = _charlm(spec_dict)
    return LMWrapper(model, decoder_symbols, vocab_map=spec_dict["vocab"])


def lm_factory(config, decoder_symbols, config_path: str = ""):
    if "LM" not in config:
        return None
    return construct_lm(config["LM"], decoder_symbols, config_path=config_path)


def decoder_factory(config, characters, device=None, config_path: str = ""):
    """The ``[DECODER]`` section's decoder: ``GREEDY``, ``FAST-LOG-RAW``
    (the host decoder; its LM runs on the CPU) or ``TPU-BEAM`` (the
    batched beam search on ``device``, None meaning CUDA; ``MAX_LEN``,
    which the JAX decoder accepts and does not use, is not read)."""
    full_characters = list(characters) + [BLANK_SYMBOL]
    decoder_type = config["TYPE"]

    if decoder_type == "FAST-LOG-RAW":
        k = config.getint("BEAM_SIZE")
        lm_scale = config.getfloat("LM_SCALE")
        if lm_scale is None:
            raise ValueError("Missing LM_SCALE key in the config")
        insertion_bonus = config.getfloat("INSERTION_BONUS", fallback=0.0)
        lm = lm_factory(config, full_characters[:-1], config_path=config_path)
        logger.info("Constructing CTCPrefixLogRawNumpyDecoder(k=%d, insertion_bonus=%s, "
                    "lm=%s)", k, insertion_bonus, lm)
        return CTCPrefixLogRawNumpyDecoder(full_characters, k, lm, lm_scale,
                                           insertion_bonus=insertion_bonus)
    if decoder_type == "TPU-BEAM":
        from pero_ocr_tpu_torch.decoding.tpu_decoder import TorchBeamSearchDecoder

        wrapper = lm_factory(config, full_characters[:-1], config_path=config_path)
        return TorchBeamSearchDecoder(
            full_characters,
            k=config.getint("BEAM_SIZE", fallback=8),
            lm=None if wrapper is None else wrapper.model,
            lm_scale=config.getfloat("LM_SCALE", fallback=1.0),
            insertion_bonus=config.getfloat("INSERTION_BONUS", fallback=0.0),
            vocab_map=None if wrapper is None else wrapper.vocab_map,
            transport_dtype=np.dtype(config.get("TRANSPORT_DTYPE", fallback="float32")).type,
            device=device,
        )
    if decoder_type == "GREEDY":
        return GreedyDecoder(full_characters)
    raise ValueError(f"Unknown decoder type: '{decoder_type}'")


def prepare_dense_logits(logits) -> np.ndarray:
    """Sparse CSC logits -> dense normalized log-probs."""
    dense = np.asarray(logits.todense(), dtype=np.float64)
    dense[dense == 0] = ZERO_LOGITS
    norm = np.logaddexp.reduce(dense, axis=-1, keepdims=True)
    return dense - norm


def decode_paragraph(logits, decoder, time_logger) -> dict:
    out = {}
    for label, sparse in logits.items():
        dense = prepare_dense_logits(sparse)
        time_logger.log_line_start()
        out[label] = decoder(dense).best_hyp()
        time_logger.log_line_end(len(dense))
    return out


def decode_page(page_logits, decoder, time_logging: bool = False):
    time_logger = TimeLogger(loud=time_logging)
    out = [decode_paragraph(paragraph, decoder, time_logger) for paragraph in page_logits]
    time_logger.print_final_stats()
    return out


class TimeLogger:
    """Per-line decode timing."""

    def __init__(self, loud: bool = True):
        self._loud = loud
        self._total_nb_frames = 0
        self._nb_lines = 0
        self._total_decoding_time = 0.0
        self._creation_time = time.time()
        self._line_start = None

    def log_line_start(self):
        self._line_start = time.time()

    def log_line_end(self, nb_frames: int):
        duration = time.time() - self._line_start
        self._total_decoding_time += duration
        self._total_nb_frames += nb_frames
        self._nb_lines += 1
        if self._loud:
            logger.info("decoding took %.3f. Line length %3d frames -> %5.2f ms/frame",
                        duration, nb_frames, 1000.0 * duration / max(nb_frames, 1))

    def print_final_stats(self):
        duration = time.time() - self._creation_time
        if self._loud and self._nb_lines:
            logger.info("%.3fs (%.3fs decoding) = %.3fs/line = %.2fms/frame",
                        duration, self._total_decoding_time, duration / self._nb_lines,
                        1000.0 * duration / max(self._total_nb_frames, 1))
