"""PyTorch/CUDA port of pero_ocr_tpu for NVIDIA Hopper (H100).

The package mirrors the module layout of :mod:`pero_ocr_tpu` (the JAX
reference) and imports nothing of it.  It runs configs 1 to 5: the
page and crop transports, the stage-by-stage path and the re-OCR of
existing Page XML on both, CTC and transformer recognizers (the
reference's post-LN model from a torch ``.pt``, the native pre-LN model
from a flax checkpoint) on every path, the beam search with a character
LM, every layout stage of the JAX package but ``REGION_SIMPLE_THRESHOLD``,
the reference's TorchScript ParseNet and CTC archives on both paths, and
it trains every model it serves (``parallel/train.py``).  Plain
tensor code is PyTorch; the line-crop warp, the one Pallas kernel of
the JAX package, is two hand-written CUDA kernels built with ``nvcc``
on first use: the fast path's fused version (``csrc/warp_lines.cu``)
and the stage-by-stage path's, which samples precomputed fields as the
Pallas kernel does (``csrc/warp_fields.cu``).

Entry points run on CUDA unless the caller asks for the CPU: see
:func:`resolve_device`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA.  A CUDA device that is not present raises
    instead of silently running on the CPU; the plain-PyTorch CPU path
    runs only when the caller passes ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return device


# Titles of the items in ROADMAP.md's queue 1 that unported features
# name in their errors.
STAGE_BY_STAGE = "Stage-by-stage path"
SCALE_OUT = "Training and scale-out"
IMAGES = "JPEG/TIFF decoding on the card's machine"


def not_ported(what: str, item: str) -> ValueError:
    """The error for a feature of the JAX package the port lacks;
    ``item`` is the title of its item in ROADMAP.md's queue 1."""
    return ValueError(
        f"{what} is not ported to pero_ocr_tpu_torch yet "
        f"(ROADMAP.md, queue 1: '{item}')"
    )
