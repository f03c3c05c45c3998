"""The reference's TorchScript archives behind the port's model contract
(port of pero_ocr_tpu/utils/ts_adapters.py).

pero-ocr ships its ParseNet and its CTC recognizer only as TorchScript
archives (``.pt``); a layout config's ``MODEL_PATH`` or an OCR JSON's
``checkpoint`` may name one.  The JAX package interprets the archive's
graph; the port runs it with ``torch.jit.load``, and these adapters give
it the surface of the port's own modules:

- the port's modules take NHWC float images in [0, 1]; the archives
  take NCHW (the engines divide by 255 on both sides, so the adapters
  only transpose);
- a ParseNet archive returns ``(maps, extra)``: the adapter keeps
  element 0 and returns NHWC maps; its ``out_upsample`` is 1;
- a recognizer archive returns frame logits as ``(N, C, T)`` (the
  reference's exports) or ``(N, T, C)``: the adapter runs two probe
  widths on the device at load, takes the axis that grows with the width
  as the frame axis, and always returns ``(N, T, C)``; its ``spec``
  (:class:`TSRecognizerSpec`) holds the probed class count and width
  subsampling.

:func:`load_torchscript` loads an archive onto one device and makes it
run there: an archive traced on the CPU holds ``Device`` constants
(``prim::Constant[value="cpu"]``, e.g. the zeros of an ``nn.LSTM``'s
initial state), which it rewrites to the target device, and it puts each
recurrent layer's weights on the card into one cuDNN buffer, as
``nn.LSTM`` keeps them.  The archive then runs on that device only:
calling an adapter with inputs on another device raises.  The graph
runs under TorchScript's default executor, as the reference runs it.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import List, Optional

import torch
from torch import nn

logger = logging.getLogger(__name__)

# cuDNN's RNN modes by gates a hidden unit (torch.backends.cudnn.rnn).
_CUDNN_MODES = {4: 2, 3: 3}  # LSTM, GRU
_RNN_WEIGHT = re.compile(r"^weight_ih_l(\d+)(_reverse)?$")


def _graph_nodes(block, out: List) -> List:
    for node in block.nodes():
        out.append(node)
        for sub in node.blocks():
            _graph_nodes(sub, out)
    return out


def _device_nodes(module: torch.jit.ScriptModule) -> List:
    """The ``Device`` constants in the graphs of ``module``'s methods and
    its submodules'."""
    return [node for _, sub in module.named_modules() for name in sub._c._method_names()
            for node in _graph_nodes(sub._c._get_method(name).graph, [])
            if node.kind() == "prim::Constant"
            and node.output().type().kind() == "DeviceObjType"]


def device_constants(module: torch.jit.ScriptModule) -> List[str]:
    """The values of ``module``'s ``Device`` constants."""
    return [node.s("value") for node in _device_nodes(module)]


def retarget_devices_(module: torch.jit.ScriptModule, device: torch.device) -> int:
    """Rewrite every ``Device`` constant of ``module`` to ``device``;
    returns how many there were.  Must run before the module's first
    call (the executor compiles each graph once)."""
    nodes = _device_nodes(module)
    for node in nodes:
        node.s_("value", str(device))
    return len(nodes)


def flatten_rnn_weights_(module: nn.Module) -> int:
    """Put each LSTM or GRU submodule's weights on the card into one
    cuDNN weight buffer (``torch._cudnn_rnn_flatten_weight``, as
    ``nn.LSTM.flatten_parameters`` does), so that ``aten::lstm`` finds
    them as one contiguous chunk.  A loaded archive keeps no layer
    attributes, so the sizes are read from the weights' names and shapes.
    Returns the number of layers flattened."""
    count = 0
    for _, sub in module.named_modules():
        params = dict(sub.named_parameters(recurse=False))
        layers = sorted({(int(m.group(1)), bool(m.group(2)))
                         for m in map(_RNN_WEIGHT.match, params) if m})
        if not layers or not params["weight_ih_l0"].is_cuda:
            continue
        proj = params.get("weight_hr_l0")  # (P, H) with a projection
        hidden = (params["weight_hh_l0"] if proj is None else proj.T).shape[1]
        gates = params["weight_ih_l0"].shape[0] // hidden
        bias = "bias_ih_l0" in params
        names = ["weight_ih", "weight_hh"] + (["bias_ih", "bias_hh"] if bias else []) + (
            ["weight_hr"] if proj is not None else [])
        bidirectional = any(reverse for _, reverse in layers)
        weights = [params[f"{n}_l{layer}{'_reverse' if reverse else ''}"]
                   for layer, reverse in layers for n in names]
        with torch.no_grad():
            torch._cudnn_rnn_flatten_weight(
                weights, len(names), params["weight_ih_l0"].shape[1], _CUDNN_MODES[gates],
                hidden, 0 if proj is None else proj.shape[0], 1 + max(layer for layer, _ in layers),
                False, bidirectional)
        count += 1
    return count


def load_torchscript(path: str, device) -> torch.jit.ScriptModule:
    """``torch.jit.load(path, map_location=device)`` in eval mode, its
    ``Device`` constants rewritten to ``device`` and its recurrent
    weights flattened on the card."""
    device = torch.device(device)
    module = torch.jit.load(path, map_location=device).eval()
    retarget_devices_(module, device)
    flatten_rnn_weights_(module)
    return module


class _TSModel(nn.Module):
    """An archive loaded for ``device``."""

    def __init__(self, module: torch.jit.ScriptModule, device):
        super().__init__()
        self.archive = module
        self.device = torch.device(device)

    def _call(self, *args):
        if args[0].device.type != self.device.type:
            raise ValueError(f"TorchScript archive loaded for {self.device}, called on "
                             f"{args[0].device}")
        return self.archive(*args)


class TSParseNetModel(_TSModel):
    """A ParseNet archive as the port's ParseNet: (N, H, W, 3) float in
    [0, 1] -> (N, H, W, C) float32 maps."""

    out_upsample = 1

    @classmethod
    def load(cls, path: str, device) -> "TSParseNetModel":
        logger.info("Loading TorchScript ParseNet archive %s", path)
        return cls(load_torchscript(path, device), device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        out = self._call(images.float().permute(0, 3, 1, 2))
        if isinstance(out, (tuple, list)):
            out = out[0]
        return out.float().permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class TSRecognizerSpec:
    """What the engines and the fast path read of a recognizer's spec,
    probed from a CTC recognizer archive."""

    num_classes: int
    line_height: int
    subsampling: int
    embed_num: int = 0
    dtype: torch.dtype = torch.float32
    lstm_layers: int = -1  # unknown; only != 0 matters to callers


class TSRecognizerModel(_TSModel):
    """A CTC recognizer archive as the port's CTCRecognizer: (N, H, W, 3)
    float in [0, 1] (and optional (N,) writer ids) -> (N, T, C) float32
    logits."""

    PROBE_WIDTH = 256

    def __init__(self, module: torch.jit.ScriptModule, device, line_height: int = 32,
                 embed_num: int = 0):
        super().__init__(module, device)
        self._embed = embed_num > 0

        def probe(width: int):
            dummy = torch.zeros((1, 3, line_height, width), device=self.device)
            args = (dummy,)
            if self._embed:
                args = (dummy, torch.zeros((1,), dtype=torch.long, device=self.device))
            with torch.inference_mode():
                out = self._call(*args)
            if out.dim() != 3:
                raise ValueError(f"recognizer graph returned shape {tuple(out.shape)}; "
                                 "expected 3-D frame logits")
            return tuple(out.shape)

        # The axis that grows with the input width is the frame axis.
        w1, w2 = self.PROBE_WIDTH, self.PROBE_WIDTH + 32
        s1, s2 = probe(w1), probe(w2)
        if s1[1] != s2[1] and s1[2] == s2[2]:
            self._frames_last = False          # (N, T, C)
            t1, classes = s1[1], s1[2]
        elif s1[2] != s2[2] and s1[1] == s2[1]:
            self._frames_last = True           # (N, C, T)
            t1, classes = s1[2], s1[1]
        else:
            raise ValueError(
                f"cannot identify the frame axis of recognizer logits (probe shapes {s1} at "
                f"width {w1}, {s2} at {w2})")
        sub = w1 / t1
        if not float(sub).is_integer():
            raise ValueError(f"non-integer width subsampling {sub} (probe width {w1} -> "
                             f"{t1} frames)")
        self.spec = TSRecognizerSpec(num_classes=int(classes), line_height=line_height,
                                     subsampling=int(sub), embed_num=embed_num)

    @classmethod
    def load(cls, path: str, device, line_height: int = 32,
             embed_num: int = 0) -> "TSRecognizerModel":
        logger.info("Loading TorchScript CTC recognizer archive %s", path)
        return cls(load_torchscript(path, device), device, line_height=line_height,
                   embed_num=embed_num)

    def forward(self, images: torch.Tensor,
                embed_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = images.float().permute(0, 3, 1, 2)
        if self._embed:
            if embed_ids is None:
                embed_ids = torch.zeros((images.shape[0],), dtype=torch.long,
                                        device=images.device)
            out = self._call(x, embed_ids)
        else:
            out = self._call(x)
        if self._frames_last:  # (N, C, T), the reference's layout
            out = out.permute(0, 2, 1)
        return out.float()
