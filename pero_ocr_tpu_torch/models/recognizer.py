"""CTC line recognizer: VGG conv frontend + BiLSTM (port of
pero_ocr_tpu/models/recognizer.py).

The public boundary is NHWC, as in the JAX package: ``forward`` takes
(N, H, W, 3) line images in [0, 1] and returns (N, W // subsampling,
num_classes) float32 logits, blank last.  The encoder, the writer
embedding and the LSTM run in ``spec.dtype`` (bfloat16 by default); the
output Dense layer runs in float32.

The bidirectional LSTM is ``torch.nn.LSTM(bidirectional=True)`` over
the full padded length, like the JAX fused scan: the backward direction
starts at the zero tail of the crop (no ``pack_padded_sequence``).
Flax's ``max_pool(..., padding="SAME")`` is reproduced with explicit
-inf padding; GroupNorm uses flax's epsilon 1e-6.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pero_ocr_tpu_torch.models.parsenet import (
    SameConv2d,
    group_norm,
    init_weights_,
    same_pads,
    space_to_depth,
)


@dataclasses.dataclass(frozen=True)
class RecognizerSpec:
    """Architecture spec, field for field the JAX ``RecognizerSpec``."""

    num_classes: int = 0           # charset size incl. blank (last)
    line_height: int = 32
    conv_features: Sequence[int] = (48, 96, 192, 384)
    subsampling: int = 4           # horizontal subsample factor
    lstm_layers: int = 2
    lstm_features: int = 256
    embed_num: int = 0             # number of writer embeddings (0 = off)
    embed_dim: int = 64
    dtype: torch.dtype = torch.bfloat16
    stem: str = "conv"             # "s2d" = space-to-depth fast stem
    norm: str = "none"             # "group" = GroupNorm after each conv

    @staticmethod
    def from_json_dict(cfg: dict, num_classes: int) -> "RecognizerSpec":
        """The spec an OCR engine JSON declares: ``line_px_height``,
        ``embed_num`` and the ``net_spec`` architecture dict."""
        spec = cfg.get("net_spec", {})
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            spec.get("dtype", "bfloat16")
        ]
        return RecognizerSpec(
            num_classes=num_classes,
            line_height=cfg.get("line_px_height", 32),
            conv_features=tuple(spec.get("conv_features", (48, 96, 192, 384))),
            subsampling=spec.get("subsampling", 4),
            lstm_layers=spec.get("lstm_layers", 2),
            lstm_features=spec.get("lstm_features", 256),
            embed_num=cfg.get("embed_num", 0) or 0,
            embed_dim=spec.get("embed_dim", 64),
            dtype=dtype,
            stem=spec.get("stem", "conv"),
            norm=spec.get("norm", "none"),
        )


def _max_pool_same(x: torch.Tensor, stride_w: int) -> torch.Tensor:
    """flax ``max_pool(x, (2, 2), strides=(2, stride_w), padding="SAME")``."""
    ph = same_pads(x.shape[2], 2, 2)
    pw = same_pads(x.shape[3], 2, stride_w)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 2, (2, stride_w))


class VGGEncoder(nn.Module):
    """Conv frontend: halves H every block, subsamples W in the first
    log2(subsampling) blocks (the s2d stem counts as one), and ends with
    a full-height conv that collapses H: (N, C, H, W) -> (N, W', F)."""

    def __init__(self, spec: RecognizerSpec):
        super().__init__()
        w_sub_blocks = int(math.log2(spec.subsampling))
        w_done = 1 if spec.stem == "s2d" else 0
        in_c = 12 if spec.stem == "s2d" else 3
        height = spec.line_height // 2 if spec.stem == "s2d" else spec.line_height
        self.stem = spec.stem
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()

        def norm(features):
            return group_norm(features) if spec.norm == "group" else nn.Identity()

        self.pool_strides = []
        for i, feat in enumerate(spec.conv_features):
            self.convs.extend([SameConv2d(in_c, feat, 3), SameConv2d(feat, feat, 3)])
            self.norms.extend([norm(feat), norm(feat)])
            self.pool_strides.append(2 if i + w_done < w_sub_blocks else 1)
            in_c = feat
            height = -(-height // 2)
        # Height collapse: one VALID conv over the remaining height.
        self.convs.append(nn.Conv2d(in_c, in_c, (height, 1)))
        self.norms.append(norm(in_c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        for i, stride_w in enumerate(self.pool_strides):
            for j in (2 * i, 2 * i + 1):
                x = F.relu(self.norms[j](self.convs[j](x)))
            x = _max_pool_same(x, stride_w)
        x = F.relu(self.norms[-1](self.convs[-1](x)))
        return x[:, :, 0].transpose(1, 2)  # (N, W', F)


class BLSTMStack(nn.Module):
    """``lstm_layers`` bidirectional LSTM layers, or with
    ``lstm_layers=0`` two 1-D convs (kernel 5, SAME) over the
    sequence."""

    def __init__(self, spec: RecognizerSpec, in_features: int):
        super().__init__()
        self.lstm_layers = spec.lstm_layers
        if spec.lstm_layers == 0:
            width = 2 * spec.lstm_features
            self.convs = nn.ModuleList(
                [nn.Conv1d(in_features, width, 5, padding=2),
                 nn.Conv1d(width, width, 5, padding=2)]
            )
        else:
            self.lstm = nn.LSTM(
                in_features, spec.lstm_features, num_layers=spec.lstm_layers,
                batch_first=True, bidirectional=True,
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, T, F) -> (N, T, 2 * lstm_features)."""
        if self.lstm_layers == 0:
            x = x.transpose(1, 2)
            for conv in self.convs:
                x = F.relu(conv(x))
            return x.transpose(1, 2)
        flatten_lstm_(self.lstm)
        return self.lstm(x)[0]


def flatten_lstm_(lstm: nn.LSTM) -> None:
    """Put the LSTM's weights on the card into one cuDNN weight buffer
    unless they already share one: after a move to the card (a float32
    LSTM's ``_apply`` flattens itself, a bfloat16 one's does not) or
    after a weight was replaced.  Loading a state dict and the trainer's
    write-back copy into the buffer and keep it.  torch's
    ``flatten_parameters`` leaves a bfloat16 LSTM alone
    (``torch.backends.cudnn.is_acceptable`` admits float16, float32 and
    float64 only), though cuDNN runs it, which then warns that the
    weights "are not part of single contiguous chunk of memory" and
    compacts them on every call; so this flattens bfloat16 itself."""
    weights = lstm._flat_weights
    if not weights[0].is_cuda or len({w.untyped_storage().data_ptr() for w in weights}) == 1:
        return
    if weights[0].dtype != torch.bfloat16 or not torch.backends.cudnn.enabled:
        lstm.flatten_parameters()
        return
    from torch.backends.cudnn import rnn

    with torch.no_grad():
        torch._cudnn_rnn_flatten_weight(
            weights, 4 if lstm.bias else 2, lstm.input_size, rnn.get_cudnn_mode(lstm.mode),
            lstm.hidden_size, lstm.proj_size, lstm.num_layers, lstm.batch_first,
            bool(lstm.bidirectional))


class CTCRecognizer(nn.Module):
    """Full CTC line recognizer."""

    def __init__(self, spec: RecognizerSpec,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spec.stem not in ("conv", "s2d"):
            raise ValueError(f"stem={spec.stem!r} must be 'conv' or 's2d'")
        if spec.norm not in ("none", "group"):
            raise ValueError(f"norm={spec.norm!r} must be 'none' or 'group'")
        self.spec = spec
        self.encoder = VGGEncoder(spec)
        features = spec.conv_features[-1]
        if spec.embed_num:
            self.embedding = nn.Embedding(spec.embed_num + 1, spec.embed_dim)
            features += spec.embed_dim
        self.blstm = BLSTMStack(spec, features)
        self.to(spec.dtype)
        self.dense = nn.Linear(2 * spec.lstm_features, spec.num_classes)  # float32
        if generator is not None:
            init_weights_(self, generator)

    def forward(self, images: torch.Tensor,
                embed_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images: (N, H, W, 3) float in [0, 1]; embed_ids: (N,) int
        writer ids or None (the mean-embedding id ``embed_num``).
        Returns (N, W // subsampling, num_classes) float32 logits."""
        sp = self.spec
        x = self.encoder(images.permute(0, 3, 1, 2).to(sp.dtype))
        if sp.embed_num:
            if embed_ids is None:
                embed_ids = torch.full(
                    (x.shape[0],), sp.embed_num, dtype=torch.long, device=x.device
                )
            e = self.embedding(embed_ids)[:, None, :]
            x = torch.cat([x, e.expand(-1, x.shape[1], -1)], dim=-1)
        x = self.blstm(x)
        return self.dense(x.float())
