"""Flax parameter trees <-> torch state dicts, and torch LM files.

The ``*_params_from_flax`` functions take the flax ``params`` of a JAX
model (a nested mapping of arrays, or the variables dict holding it
under "params") and return a ``state_dict`` for the matching module of
this package, in float32 (``load_state_dict`` casts to the module's
dtype).  The ``*_params_to_flax`` functions invert them: a module of
this package (or, with ``tensors``, any tensors under its state-dict
names, such as a trainer's float32 weights or its gradients) -> the
flax variables ``{"params": ...}`` of the JAX model, float32 numpy, as
``utils/checkpoint.save_variables`` writes them; ``from(to(m))``
reproduces ``m``'s state dict exactly.  ``load_torch_lm_file`` reads a torch character LM (state dict,
pickled module or TorchScript) as the JAX package's
``utils/convert_torch.py`` does: into the CharLM's flax tree, with its
gate mapping, which ``charlm_params_from_flax`` then loads.

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
  flax has no input bias, so ``*_to_flax`` adds torch's ``bias_ih``
  into the hidden bias (exact when it is zero, as in a module loaded
  from flax or folded by :func:`fold_lstm_input_bias_`).
- Attention (``models/transformer.py``) keeps torch's layout: the
  q/k/v kernels stack into ``in_proj_weight``, the output kernel
  flattens its (heads, head_dim) axes.
- The CharLM (``models/charlm.py``) keeps the flax kernels' (in, out)
  layout: a cell's gate kernels concatenate side by side (LSTM i, f,
  g, o; GRU r, z, n), as ``OptimizedLSTMCell`` concatenates them.  The
  GRU's ``hn`` bias stays apart (``bias_hn``): r scales only it.
- ``OrientationNet`` has ParseNet's module names (no thin head), so
  ParseNet's converters serve it.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

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


def charlm_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for :class:`pero_ocr_tpu_torch.models.charlm.CharLM`
    from the params of ``pero_ocr_tpu.models.charlm.CharLM``."""
    p = _params(tree)
    out = {"embed.weight": _t(p["embed"]["embedding"]),
           "head.weight": _t(p["head"]["kernel"]).T.contiguous(),
           "head.bias": _t(p["head"]["bias"])}
    for k in range(_count(p, "cells")):
        cell = p[f"cells_{k}"]
        if "hi" in cell:  # OptimizedLSTMCell
            out[f"cells.{k}.weight_i"] = torch.cat([_t(cell[f"i{g}"]["kernel"]) for g in _GATES], 1)
            out[f"cells.{k}.weight_h"] = torch.cat([_t(cell[f"h{g}"]["kernel"]) for g in _GATES], 1)
            out[f"cells.{k}.bias_h"] = torch.cat([_t(cell[f"h{g}"]["bias"]) for g in _GATES])
        else:  # GRUCell
            out[f"cells.{k}.weight_i"] = torch.cat([_t(cell[g]["kernel"]) for g in ("ir", "iz", "in")], 1)
            out[f"cells.{k}.bias_i"] = torch.cat([_t(cell[g]["bias"]) for g in ("ir", "iz", "in")])
            out[f"cells.{k}.weight_h"] = torch.cat([_t(cell[g]["kernel"]) for g in ("hr", "hz", "hn")], 1)
            out[f"cells.{k}.bias_hn"] = _t(cell["hn"]["bias"])
    return out


def _attention(node: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``MultiHeadDotProductAttention`` -> torch's attention layout:
    the q/k/v ``DenseGeneral`` kernels (d, heads, head_dim) stacked into
    ``in_proj_weight`` (3d, d), the output kernel (heads, head_dim, d)
    into ``out_proj.weight`` (d, d)."""
    parts = [node[name] for name in ("query", "key", "value")]
    weight = torch.cat([_t(p["kernel"]).flatten(1).T for p in parts])
    bias = torch.cat([_t(p["bias"]).flatten() for p in parts])
    out = _t(node["out"]["kernel"])
    return {"in_proj_weight": weight.contiguous(), "in_proj_bias": bias,
            "out_proj.weight": out.reshape(-1, out.shape[-1]).T.contiguous(),
            "out_proj.bias": _t(node["out"]["bias"])}


def transformer_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for
    :class:`pero_ocr_tpu_torch.models.transformer.TransformerOCR` from the
    params of ``pero_ocr_tpu.models.transformer.TransformerOCR``."""
    p = _params(tree)
    out: dict = {}
    front = p["frontend"]
    n_conv = _count(front, "Conv") - 1
    for i in range(n_conv):
        _put(out, f"frontend.convs.{i}", _conv(front[f"Conv_{i}"]))
    _put(out, "frontend.agg", _conv(front[f"Conv_{n_conv}"]))
    for kind, names in (("encoder", ("self_attn",)), ("decoder", ("self_attn", "multihead_attn"))):
        for i in range(_count(p, f"{kind}_layers_")):
            node = p[f"{kind}_layers__{i}"]
            prefix = f"{kind}_layers.{i}"
            for j in range(len(names) + 1):
                _put(out, f"{prefix}.norm{j + 1}", _norm(node[f"LayerNorm_{j}"]))
            for j, name in enumerate(names):
                _put(out, f"{prefix}.{name}", _attention(node[f"MultiHeadDotProductAttention_{j}"]))
            _put(out, f"{prefix}.linear1", _dense(node["Dense_0"]))
            _put(out, f"{prefix}.linear2", _dense(node["Dense_1"]))
    _put(out, "encoder_norm", _norm(p["encoder_norm"]))
    _put(out, "decoder_norm", _norm(p["decoder_norm"]))
    out["embed.weight"] = _t(p["embed"]["embedding"])
    _put(out, "out_proj", _dense(p["out_proj"]))
    return out


def orientation_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for
    :class:`pero_ocr_tpu_torch.models.parsenet.OrientationNet` from the
    params of ``pero_ocr_tpu.models.parsenet.OrientationNet``."""
    return parsenet_params_from_flax(tree)


# ----------------------------------------------------------------------
# torch modules -> flax variables (the inverse of the above)
def _f32(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _tensors(module: torch.nn.Module, tensors: Optional[Mapping]) -> Mapping:
    return module.state_dict() if tensors is None else tensors


def _flax_conv(sd: Mapping, prefix: str) -> dict:
    k = _f32(sd[f"{prefix}.weight"])
    k = k.transpose(2, 3, 1, 0) if k.ndim == 4 else k.transpose(2, 1, 0)
    return {"kernel": np.ascontiguousarray(k), "bias": _f32(sd[f"{prefix}.bias"])}


def _flax_conv_transpose(sd: Mapping, prefix: str) -> dict:
    k = _f32(sd[f"{prefix}.weight"])[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return {"kernel": np.ascontiguousarray(k), "bias": _f32(sd[f"{prefix}.bias"])}


def _flax_norm(sd: Mapping, prefix: str) -> dict:
    return {"scale": _f32(sd[f"{prefix}.weight"]), "bias": _f32(sd[f"{prefix}.bias"])}


def _flax_dense(sd: Mapping, prefix: str) -> dict:
    return {"kernel": np.ascontiguousarray(_f32(sd[f"{prefix}.weight"]).T),
            "bias": _f32(sd[f"{prefix}.bias"])}


def _flax_block(sd: Mapping, prefix: str) -> dict:
    node = {}
    for i in (0, 1):
        node[f"Conv_{i}"] = _flax_conv(sd, f"{prefix}.conv{i}")
        if f"{prefix}.norm{i}.weight" in sd:
            node[f"GroupNorm_{i}"] = _flax_norm(sd, f"{prefix}.norm{i}")
    return node


def parsenet_params_to_flax(module, tensors: Optional[Mapping] = None) -> dict:
    """The flax variables of the JAX ParseNet that ``module`` (a
    :class:`~pero_ocr_tpu_torch.models.parsenet.ParseNet`) ports."""
    sd = _tensors(module, tensors)
    n_levels, n_head = len(module.down_blocks), len(getattr(module, "head_ups", ()))
    p = {}
    for level in range(n_levels):
        p[f"ConvBlock_{level}"] = _flax_block(sd, f"down_blocks.{level}")
        p[f"Conv_{level}"] = _flax_conv(sd, f"down_convs.{level}")
    p[f"ConvBlock_{n_levels}"] = _flax_block(sd, "bottleneck")
    for level in range(n_levels):
        p[f"ConvTranspose_{level}"] = _flax_conv_transpose(sd, f"up_convs.{level}")
        p[f"ConvBlock_{n_levels + 1 + level}"] = _flax_block(sd, f"up_blocks.{level}")
    for k in range(n_head):
        p[f"ConvTranspose_{n_levels + k}"] = _flax_conv_transpose(sd, f"head_ups.{k}")
        p[f"Conv_{n_levels + k}"] = _flax_conv(sd, f"head_convs.{k}")
    p[f"Conv_{n_levels + n_head}"] = _flax_conv(sd, "out")
    return {"params": p}


def orientation_params_to_flax(module, tensors: Optional[Mapping] = None) -> dict:
    """The flax variables of the JAX OrientationNet that ``module`` (an
    :class:`~pero_ocr_tpu_torch.models.parsenet.OrientationNet`) ports."""
    return parsenet_params_to_flax(module, tensors)


def recognizer_params_to_flax(module, tensors: Optional[Mapping] = None) -> dict:
    """The flax variables of the JAX CTCRecognizer that ``module`` (a
    :class:`~pero_ocr_tpu_torch.models.recognizer.CTCRecognizer`) ports.
    Flax's LSTM has no input bias: torch's ``bias_ih`` is added into the
    hidden bias."""
    sd = _tensors(module, tensors)
    spec = module.spec
    enc = {}
    for i in range(len(module.encoder.convs)):
        enc[f"Conv_{i}"] = _flax_conv(sd, f"encoder.convs.{i}")
        if f"encoder.norms.{i}.weight" in sd:
            enc[f"GroupNorm_{i}"] = _flax_norm(sd, f"encoder.norms.{i}")
    p = {"VGGEncoder_0": enc, "Dense_0": _flax_dense(sd, "dense")}
    if spec.embed_num:
        p["Embed_0"] = {"embedding": _f32(sd["embedding.weight"])}
    stack = {}
    if spec.lstm_layers == 0:
        for i in range(2):
            stack[f"Conv_{i}"] = _flax_conv(sd, f"blstm.convs.{i}")
    for layer in range(spec.lstm_layers):
        step = {}
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            name = f"blstm.lstm.{{}}_l{layer}{suffix}"
            w_ih = _f32(sd[name.format("weight_ih")]).T
            w_hh = _f32(sd[name.format("weight_hh")]).T
            bias = _f32(sd[name.format("bias_hh")]) + _f32(sd[name.format("bias_ih")])
            gates = {}
            for g, gate in enumerate(_GATES):
                cols = slice(g * w_hh.shape[0], (g + 1) * w_hh.shape[0])
                gates[f"i{gate}"] = {"kernel": np.ascontiguousarray(w_ih[:, cols])}
                gates[f"h{gate}"] = {"kernel": np.ascontiguousarray(w_hh[:, cols]),
                                     "bias": bias[cols]}
            step[direction] = gates
        stack[f"FusedBiLSTM_{layer}"] = {"Scan_BiLSTMStep_0": step}
    p["BLSTMStack_0"] = stack
    return {"params": p}


def fold_lstm_input_bias_(module) -> None:
    """Move each LSTM layer's ``bias_ih`` of a CTCRecognizer into its
    ``bias_hh`` (in the module's dtype) and zero it, so that the module
    is exactly what its flax export loads back into, and ``bias_ih``
    (which flax lacks) can stay frozen at zero in training."""
    if module.spec.lstm_layers == 0:
        return
    lstm = module.blstm.lstm
    with torch.no_grad():
        for name, b_ih in lstm.named_parameters():
            if name.startswith("bias_ih"):
                getattr(lstm, name.replace("bias_ih", "bias_hh")).add_(b_ih)
                b_ih.zero_()


def _gate_columns(w: np.ndarray, g: int, hidden: int) -> np.ndarray:
    return np.ascontiguousarray(w[..., g * hidden:(g + 1) * hidden])


def charlm_params_to_flax(module, tensors: Optional[Mapping] = None) -> dict:
    """The flax variables of the JAX CharLM that ``module`` (a
    :class:`~pero_ocr_tpu_torch.models.charlm.CharLM`) ports."""
    sd = _tensors(module, tensors)
    spec = module.spec
    hidden = spec.hidden_dim
    p = {"embed": {"embedding": _f32(sd["embed.weight"])}, "head": _flax_dense(sd, "head")}
    for k in range(spec.num_layers):
        w_i, w_h = _f32(sd[f"cells.{k}.weight_i"]), _f32(sd[f"cells.{k}.weight_h"])
        if spec.cell_type == "lstm":
            b_h = _f32(sd[f"cells.{k}.bias_h"])
            cell = {}
            for g, gate in enumerate(_GATES):
                cell[f"i{gate}"] = {"kernel": _gate_columns(w_i, g, hidden)}
                cell[f"h{gate}"] = {"kernel": _gate_columns(w_h, g, hidden),
                                    "bias": _gate_columns(b_h, g, hidden)}
        else:
            b_i = _f32(sd[f"cells.{k}.bias_i"])
            cell = {f"i{gate}": {"kernel": _gate_columns(w_i, g, hidden),
                                 "bias": _gate_columns(b_i, g, hidden)}
                    for g, gate in enumerate("rzn")}
            cell.update({f"h{gate}": {"kernel": _gate_columns(w_h, g, hidden)}
                         for g, gate in enumerate("rzn")})
            cell["hn"]["bias"] = _f32(sd[f"cells.{k}.bias_hn"])
        p[f"cells_{k}"] = cell
    return {"params": p}


def _flax_attention(sd: Mapping, prefix: str, heads: int) -> dict:
    """torch's attention layout -> flax ``MultiHeadDotProductAttention``
    (``_attention`` inverted)."""
    w = _f32(sd[f"{prefix}.in_proj_weight"])
    b = _f32(sd[f"{prefix}.in_proj_bias"])
    d = w.shape[1]
    node = {}
    for part, name in enumerate(("query", "key", "value")):
        rows = slice(part * d, (part + 1) * d)
        node[name] = {"kernel": np.ascontiguousarray(w[rows].T.reshape(d, heads, -1)),
                      "bias": b[rows].reshape(heads, -1)}
    out = _f32(sd[f"{prefix}.out_proj.weight"])
    node["out"] = {"kernel": np.ascontiguousarray(out.T.reshape(heads, -1, d)),
                   "bias": _f32(sd[f"{prefix}.out_proj.bias"])}
    return node


def transformer_params_to_flax(module, tensors: Optional[Mapping] = None) -> dict:
    """The flax variables of the JAX TransformerOCR that ``module`` (a
    :class:`~pero_ocr_tpu_torch.models.transformer.TransformerOCR`)
    ports."""
    sd = _tensors(module, tensors)
    heads = module.spec.num_heads
    front = {f"Conv_{i}": _flax_conv(sd, f"frontend.convs.{i}")
             for i in range(len(module.frontend.convs))}
    front[f"Conv_{len(module.frontend.convs)}"] = _flax_conv(sd, "frontend.agg")
    p = {"frontend": front}
    for kind, names in (("encoder", ("self_attn",)), ("decoder", ("self_attn", "multihead_attn"))):
        for i in range(len(getattr(module, f"{kind}_layers"))):
            prefix = f"{kind}_layers.{i}"
            node = {f"LayerNorm_{j}": _flax_norm(sd, f"{prefix}.norm{j + 1}")
                    for j in range(len(names) + 1)}
            for j, name in enumerate(names):
                node[f"MultiHeadDotProductAttention_{j}"] = _flax_attention(
                    sd, f"{prefix}.{name}", heads)
            node["Dense_0"] = _flax_dense(sd, f"{prefix}.linear1")
            node["Dense_1"] = _flax_dense(sd, f"{prefix}.linear2")
            p[f"{kind}_layers__{i}"] = node
    p["encoder_norm"] = _flax_norm(sd, "encoder_norm")
    p["decoder_norm"] = _flax_norm(sd, "decoder_norm")
    p["embed"] = {"embedding": _f32(sd["embed.weight"])}
    p["out_proj"] = _flax_dense(sd, "out_proj")
    return {"params": p}


def lm_spec_from_variables(variables: Mapping) -> Dict:
    """The CharLM sidecar spec dict of a CharLM's flax variables (JAX
    ``utils/convert_torch.py`` ``lm_spec_from_variables``)."""
    params = _params(variables)
    vocab_size, embed_dim = np.shape(params["embed"]["embedding"])
    cell0 = params["cells_0"]
    cell_type = "lstm" if "hi" in cell0 else "gru"
    hidden_dim = np.shape(cell0["hi" if cell_type == "lstm" else "hr"]["kernel"])[0]
    return {
        "vocab_size": int(vocab_size),
        "embed_dim": int(embed_dim),
        "hidden_dim": int(hidden_dim),
        "num_layers": _count(params, "cells"),
        "cell_type": cell_type,
    }


# ----------------------------------------------------------------------
# Torch character-LM files (copy of the LM part of the JAX package's
# utils/convert_torch.py): a torch embedding, nn.LSTM or nn.GRU stack
# and output Linear -> the CharLM's flax tree.
def _np(tensor) -> np.ndarray:
    try:
        return tensor.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(tensor)


def _torch_rnn_layer(state_dict: Mapping, prefix: str, layer: int):
    w_ih = _np(state_dict[f"{prefix}.weight_ih_l{layer}"])  # (gates*H, in)
    w_hh = _np(state_dict[f"{prefix}.weight_hh_l{layer}"])  # (gates*H, H)
    b_ih = _np(state_dict.get(f"{prefix}.bias_ih_l{layer}", np.zeros(w_ih.shape[0])))
    b_hh = _np(state_dict.get(f"{prefix}.bias_hh_l{layer}", np.zeros(w_hh.shape[0])))
    hidden = w_hh.shape[1]

    def gate(idx):
        lo, hi = idx * hidden, (idx + 1) * hidden
        return w_ih[lo:hi].T, w_hh[lo:hi].T, b_ih[lo:hi], b_hh[lo:hi]

    return gate


def convert_lstm_layer(state_dict: Mapping, prefix: str, layer: int) -> Dict:
    """One torch nn.LSTM layer -> flax OptimizedLSTMCell params: the
    same gate order; torch's two biases summed into the hidden one."""
    gate = _torch_rnn_layer(state_dict, prefix, layer)
    gates = {}
    for name, idx in (("i", 0), ("f", 1), ("g", 2), ("o", 3)):
        wi, wh, bi, bh = gate(idx)
        gates["i" + name] = {"kernel": wi}
        gates["h" + name] = {"kernel": wh, "bias": bi + bh}
    return gates


def convert_gru_layer(state_dict: Mapping, prefix: str, layer: int) -> Dict:
    """One torch nn.GRU layer (gates r, z, n) -> flax GRUCell params.

    Both share r = sigma(W_ir x + W_hr h + b), z likewise, and
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn)); flax keeps no bias on
    hr/hz, so those torch biases fold into ir/iz."""
    gate = _torch_rnn_layer(state_dict, prefix, layer)
    wi_r, wh_r, bi_r, bh_r = gate(0)
    wi_z, wh_z, bi_z, bh_z = gate(1)
    wi_n, wh_n, bi_n, bh_n = gate(2)
    return {
        "ir": {"kernel": wi_r, "bias": bi_r + bh_r},
        "iz": {"kernel": wi_z, "bias": bi_z + bh_z},
        "in": {"kernel": wi_n, "bias": bi_n},
        "hr": {"kernel": wh_r},
        "hz": {"kernel": wh_z},
        "hn": {"kernel": wh_n, "bias": bh_n},
    }


def detect_lm_prefixes(state_dict: Mapping) -> Dict[str, str]:
    """The (embed, recurrent stack, head) attribute prefixes of a torch
    char-RNN LM state dict.

    The recurrent stack is ``<p>.weight_ih_l0``.  The head is the 2-D
    ``.weight`` whose input dim equals the recurrent hidden size; the
    embedding is the 2-D ``.weight`` whose output dim equals the
    recurrent input size (brnolm's ``model``/``decoder`` naming
    included)."""
    rnn_prefix = None
    for key in state_dict:
        if key.endswith(".weight_ih_l0"):
            rnn_prefix = key[: -len(".weight_ih_l0")]
            break
    if rnn_prefix is None:
        raise ValueError(
            "no recurrent stack (*.weight_ih_l0) in the LM state dict; "
            f"keys: {sorted(state_dict)[:10]}"
        )
    w_ih = _np(state_dict[f"{rnn_prefix}.weight_ih_l0"])
    w_hh = _np(state_dict[f"{rnn_prefix}.weight_hh_l0"])
    in_dim, hidden = w_ih.shape[1], w_hh.shape[1]
    candidates = []  # (prefix, shape, has_bias) of 2-D .weight tensors
    for key, value in state_dict.items():
        if not key.endswith(".weight") or key.startswith(rnn_prefix + "."):
            continue
        arr = _np(value)
        if arr.ndim != 2:
            continue
        prefix = key[: -len(".weight")]
        candidates.append((prefix, arr.shape, prefix + ".bias" in state_dict))
    embed_prefix = head_prefix = None
    for prefix, shape, has_bias in candidates:
        # nn.Embedding has no bias; nn.Linear heads usually do — use that
        # first, since embed_dim == hidden makes the shapes ambiguous.
        if shape[1] == hidden and has_bias and head_prefix is None:
            head_prefix = prefix
        elif shape[1] == in_dim and not has_bias and embed_prefix is None:
            embed_prefix = prefix
    for prefix, shape, _ in candidates:
        if prefix in (embed_prefix, head_prefix):
            continue
        if embed_prefix is None and shape[1] == in_dim:
            embed_prefix = prefix
        elif head_prefix is None and shape[1] == hidden:
            head_prefix = prefix
    if embed_prefix is None or head_prefix is None:
        raise ValueError(
            "could not identify embedding/head Linear in the LM state "
            f"dict (rnn={rnn_prefix}, in={in_dim}, hidden={hidden})"
        )
    return {"embed_prefix": embed_prefix, "lstm_prefix": rnn_prefix,
            "head_prefix": head_prefix}


def convert_torch_lm(state_dict: Mapping, embed_prefix: str = "embed",
                     lstm_prefix: str = "lstm", head_prefix: str = "head",
                     num_layers: Optional[int] = None) -> Dict:
    """Torch char-RNN LM -> the CharLM's flax variables (numpy).  The
    cell type follows the gate-row count (4H rows LSTM, 3H GRU)."""
    if num_layers is None:
        num_layers = 0
        while f"{lstm_prefix}.weight_ih_l{num_layers}" in state_dict:
            num_layers += 1
    head = {"kernel": _np(state_dict[head_prefix + ".weight"]).T}
    if head_prefix + ".bias" in state_dict:
        head["bias"] = _np(state_dict[head_prefix + ".bias"])
    params = {"embed": {"embedding": _np(state_dict[embed_prefix + ".weight"])}, "head": head}
    w_ih = _np(state_dict[f"{lstm_prefix}.weight_ih_l0"])
    w_hh = _np(state_dict[f"{lstm_prefix}.weight_hh_l0"])
    gates = w_ih.shape[0] // w_hh.shape[1]
    if gates == 3:
        convert_layer = convert_gru_layer
    elif gates == 4:
        convert_layer = convert_lstm_layer
    else:
        raise ValueError(
            f"unrecognized recurrent layer: {w_ih.shape[0]} gate rows for "
            f"hidden size {w_hh.shape[1]}"
        )
    for k in range(num_layers):
        params[f"cells_{k}"] = convert_layer(state_dict, lstm_prefix, k)
    return {"params": params}


def load_torch_lm_file(path: str):
    """A torch LM file (state dict, pickled module or TorchScript) ->
    (the CharLM's flax variables, its sidecar spec dict), the prefixes
    detected from the keys."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:  # not a pickle archive: TorchScript
        obj = torch.jit.load(path, map_location="cpu")
    state_dict = obj.state_dict() if hasattr(obj, "state_dict") else obj
    if isinstance(state_dict, dict):
        # Unwrap common {checkpoint key: state_dict} containers.
        for container_key in ("state_dict", "model_state_dict", "model"):
            inner = state_dict.get(container_key)
            if isinstance(inner, dict) and inner:
                state_dict = inner
                break
    variables = convert_torch_lm(state_dict, **detect_lm_prefixes(state_dict))
    return variables, lm_spec_from_variables(variables)
