"""Flax parameter trees -> torch state dicts.

Both functions take the flax ``params`` of a JAX model (a nested
mapping of arrays, or the variables dict holding it under "params") and
return a ``state_dict`` for the matching module of this package, in
float32 (``load_state_dict`` casts to the module's dtype).

Layout rules:

- ``Conv`` kernels are (kh, kw, in, out) -> torch (out, in, kh, kw);
  1-D (k, in, out) -> (out, in, k); ``Dense`` (in, out) -> (out, in).
- ``ConvTranspose`` with ``transpose_kernel=False`` (the flax default)
  computes ``y[s*i + a] = x[i] * K[k-1-a]`` for kernel 2, stride 2:
  the kernel is flipped spatially relative to torch's
  ``ConvTranspose2d`` (checked numerically in
  tests/test_torch_models.py), and (kh, kw, in, out) -> (in, out, kh, kw).
- ``OptimizedLSTMCell`` keeps bias-free input kernels ``i{i,f,g,o}``
  and biased hidden kernels ``h{i,f,g,o}``; torch's LSTM gate order is
  the same i, f, g, o, so the four kernels concatenate into
  ``weight_ih``/``weight_hh`` and the hidden biases into ``bias_hh``
  (``bias_ih`` is zero).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_GATES = ("i", "f", "g", "o")


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a bfloat16 leaf of a checkpoint
        return a.float()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _conv(node: Mapping) -> Dict[str, torch.Tensor]:
    k = _t(node["kernel"])
    k = k.permute(3, 2, 0, 1) if k.ndim == 4 else k.permute(2, 1, 0)
    return {"weight": k.contiguous(), "bias": _t(node["bias"])}


def _conv_transpose(node: Mapping) -> Dict[str, torch.Tensor]:
    k = _t(node["kernel"]).permute(2, 3, 0, 1).flip(2, 3)
    return {"weight": k.contiguous(), "bias": _t(node["bias"])}


def _norm(node: Mapping) -> Dict[str, torch.Tensor]:
    return {"weight": _t(node["scale"]), "bias": _t(node["bias"])}


def _dense(node: Mapping) -> Dict[str, torch.Tensor]:
    return {"weight": _t(node["kernel"]).T.contiguous(), "bias": _t(node["bias"])}


def _count(tree: Mapping, prefix: str) -> int:
    return sum(1 for k in tree if re.fullmatch(rf"{prefix}_\d+", k))


def _put(out: dict, prefix: str, tensors: Mapping[str, torch.Tensor]) -> None:
    for name, value in tensors.items():
        out[f"{prefix}.{name}"] = value


def _conv_block(out: dict, prefix: str, node: Mapping) -> None:
    for i in (0, 1):
        _put(out, f"{prefix}.conv{i}", _conv(node[f"Conv_{i}"]))
        if f"GroupNorm_{i}" in node:
            _put(out, f"{prefix}.norm{i}", _norm(node[f"GroupNorm_{i}"]))


def parsenet_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for :class:`pero_ocr_tpu_torch.models.parsenet.ParseNet`
    from the params of ``pero_ocr_tpu.models.parsenet.ParseNet``."""
    p = _params(tree)
    n_levels = (_count(p, "ConvBlock") - 1) // 2
    n_head = _count(p, "ConvTranspose") - n_levels
    out: dict = {}
    for level in range(n_levels):
        _conv_block(out, f"down_blocks.{level}", p[f"ConvBlock_{level}"])
        _put(out, f"down_convs.{level}", _conv(p[f"Conv_{level}"]))
    _conv_block(out, "bottleneck", p[f"ConvBlock_{n_levels}"])
    for level in range(n_levels):
        _put(out, f"up_convs.{level}", _conv_transpose(p[f"ConvTranspose_{level}"]))
        _conv_block(out, f"up_blocks.{level}", p[f"ConvBlock_{n_levels + 1 + level}"])
    for k in range(n_head):
        _put(out, f"head_ups.{k}",
             _conv_transpose(p[f"ConvTranspose_{n_levels + k}"]))
        _put(out, f"head_convs.{k}", _conv(p[f"Conv_{n_levels + k}"]))
    _put(out, "out", _conv(p[f"Conv_{n_levels + n_head}"]))
    return out


def _lstm_direction(node: Mapping) -> Dict[str, torch.Tensor]:
    w_ih = torch.cat([_t(node[f"i{g}"]["kernel"]) for g in _GATES], dim=1)
    w_hh = torch.cat([_t(node[f"h{g}"]["kernel"]) for g in _GATES], dim=1)
    b_hh = torch.cat([_t(node[f"h{g}"]["bias"]) for g in _GATES])
    return {
        "weight_ih": w_ih.T.contiguous(),
        "weight_hh": w_hh.T.contiguous(),
        "bias_ih": torch.zeros_like(b_hh),
        "bias_hh": b_hh,
    }


def recognizer_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for
    :class:`pero_ocr_tpu_torch.models.recognizer.CTCRecognizer` from the
    params of ``pero_ocr_tpu.models.recognizer.CTCRecognizer``."""
    p = _params(tree)
    out: dict = {}
    enc = p["VGGEncoder_0"]
    for i in range(_count(enc, "Conv")):
        _put(out, f"encoder.convs.{i}", _conv(enc[f"Conv_{i}"]))
        if f"GroupNorm_{i}" in enc:
            _put(out, f"encoder.norms.{i}", _norm(enc[f"GroupNorm_{i}"]))
    if "Embed_0" in p:
        out["embedding.weight"] = _t(p["Embed_0"]["embedding"])
    stack = p["BLSTMStack_0"]
    for i in range(_count(stack, "Conv")):
        _put(out, f"blstm.convs.{i}", _conv(stack[f"Conv_{i}"]))
    for layer in range(_count(stack, "FusedBiLSTM")):
        step = stack[f"FusedBiLSTM_{layer}"]["Scan_BiLSTMStep_0"]
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            for name, value in _lstm_direction(step[direction]).items():
                out[f"blstm.lstm.{name}_l{layer}{suffix}"] = value
    _put(out, "dense", _dense(p["Dense_0"]))
    return out
