"""The reference-style transformer recognizer's inference graph (port of
pero_ocr_tpu/models/transformer_ref.py): the post-LN encoder-decoder
with a VGG16-slice frontend that OCR JSONs with a ``net_name`` and a
torch ``.pt`` state dict describe.

The module names are the reference state dict's
(``encoder_frontend.blocks_2d.*``, ``encoder_frontend.aggregation_conv.0``,
``encoder.input_norm``, ``encoder.trans_encoder.layers.{i}.*``,
``trans_decoder.layers.{i}.*``, ``dec_embeder``, ``dec_out_proj``), so a
``.pt`` file loads with ``load_state_dict(strict=True)``, unconverted.
``blocks_2d`` keeps the reference's indices: each group's convs and
activations, its max pool and a dropout slot (identity at inference);
the last group nested in its own Sequential, then the eval-mode
BatchNorm after its leaky relu, then a dropout slot.

Everything runs in float32.  Attention and the decode loops are
:mod:`.transformer`'s: the KV-cached greedy decode starts from the
shared sentence-boundary id and ends at it.  ``encode`` normalizes
before it adds the positions, as the reference does.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pero_ocr_tpu_torch.models.transformer import (
    MultiHeadAttention,
    Seq2SeqDecoding,
    check_length,
    greedy_loop,
    positions,
    random_init_,
    sinusoidal_positions,
)


@dataclasses.dataclass(frozen=True)
class RefTransformerSpec:
    """The ``net_name`` config plus the charset size (with the two
    specials)."""

    num_symbols: int
    in_height: int = 40
    dim_model: int = 512
    dim_ff: int = 2048
    heads: int = 8
    encoder_layers: int = 4
    decoder_layers: int = 4
    subsampling: Tuple[int, int] = (8, 4)   # (vertical, horizontal)
    max_seq_len: int = 500

    @staticmethod
    def from_net_config(cfg, num_symbols: int, in_height: int) -> "RefTransformerSpec":
        """``cfg``: the OCR JSON's ``net_name``, a dict or its JSON text."""
        if isinstance(cfg, str):
            cfg = json.loads(cfg)
        return RefTransformerSpec(
            num_symbols=num_symbols, in_height=in_height, dim_model=cfg["dim_model"],
            dim_ff=cfg["dim_ff"], heads=cfg["heads"], encoder_layers=cfg["encoder_layers"],
            decoder_layers=cfg["decoder_layers"],
            subsampling=tuple(cfg.get("conv_subsampling", (8, 4))),
            max_seq_len=cfg.get("max_seq_len", 500),
        )

    @property
    def boundary_id(self) -> int:
        """The shared start and end id."""
        return self.num_symbols - 2

    @property
    def ignore_id(self) -> int:
        return self.num_symbols - 1


def vgg_frontend_plan(subsampling: Tuple[int, int]):
    """The frontend's stages: VGG16's 64x2, 128x2 and 256x3 conv/relu
    groups and one 512x2 conv/leaky-relu group, each followed by a max
    pool with the strides that bring the running subsampling to
    ``subsampling`` (None vertically: always 2), the last by the affine
    (eval BatchNorm).  Returns (stages, (sub_v, sub_h)); a stage is
    ("conv", features, act), ("pool", (sv, sh)) or ("affine",
    features)."""
    groups = [(64, 2, "relu"), (128, 2, "relu"), (256, 3, "relu"), (512, 2, "leaky")]
    stages = []
    v = h = 1
    sub_v, sub_h = subsampling
    for feats, n, act in groups:
        stages.extend([("conv", feats, act)] * n)
        sv = 2 if (sub_v is None or v < sub_v) else 1
        sh = 2 if h < sub_h else 1
        if (sv, sh) != (1, 1):
            stages.append(("pool", (sv, sh)))
        v *= sv
        h *= sh
        if act == "leaky":
            stages.append(("affine", feats))
    return tuple(stages), (v, h)


def _group_modules(in_c: int, feats: int, n: int, act, pool) -> list:
    mods = []
    for _ in range(n):
        mods += [nn.Conv2d(in_c, feats, 3, padding=1), act()]
        in_c = feats
    return mods + [nn.MaxPool2d(pool, stride=pool)]


class RefConvFrontend(nn.Module):
    """The plan as the reference's modules; ends with the aggregation
    conv over the remaining height and its leaky relu: (N, 3, H, W) ->
    (N, W', dim_model)."""

    def __init__(self, spec: RefTransformerSpec):
        super().__init__()
        stages, (sub_v, _) = vgg_frontend_plan(spec.subsampling)
        groups = [(64, 2), (128, 2), (256, 3), (512, 2)]
        # Each group's pool (a group whose strides are reached has none:
        # a 1x1 pool keeps the reference's indices).
        last_conv = np.cumsum([n for _, n in groups])
        strides, convs = [(1, 1)] * len(groups), 0
        for stage in stages:
            if stage[0] == "conv":
                convs += 1
            elif stage[0] == "pool":
                strides[int(np.searchsorted(last_conv, convs))] = stage[1]
        blocks, in_c = [], 3
        for (feats, n), pool in zip(groups[:3], strides[:3]):
            blocks += _group_modules(in_c, feats, n, nn.ReLU, pool) + [nn.Identity()]
            in_c = feats
        blocks.append(nn.Sequential(*_group_modules(in_c, 512, 2, nn.LeakyReLU, strides[3])))
        blocks += [nn.BatchNorm2d(512), nn.Identity()]
        self.blocks_2d = nn.Sequential(*blocks)
        self.aggregation_conv = nn.Sequential(
            nn.Conv2d(512, spec.dim_model, (spec.in_height // sub_v, 1)), nn.LeakyReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.aggregation_conv(self.blocks_2d(x))[:, :, 0].transpose(1, 2)


def _feed_forward(layer, x: torch.Tensor) -> torch.Tensor:
    return layer.linear2(F.relu(layer.linear1(x)))


class RefEncoderLayer(nn.Module):
    """torch's ``TransformerEncoderLayer``: post-LN, relu feed-forward."""

    def __init__(self, spec: RefTransformerSpec):
        super().__init__()
        d = spec.dim_model
        self.self_attn = MultiHeadAttention(d, spec.heads)
        self.linear1 = nn.Linear(d, spec.dim_ff)
        self.linear2 = nn.Linear(spec.dim_ff, d)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + _feed_forward(self, x))


class RefDecoderLayer(nn.Module):
    """torch's ``TransformerDecoderLayer``, post-LN: self-attention,
    cross-attention, relu feed-forward."""

    def __init__(self, spec: RefTransformerSpec):
        super().__init__()
        d = spec.dim_model
        self.self_attn = MultiHeadAttention(d, spec.heads)
        self.multihead_attn = MultiHeadAttention(d, spec.heads)
        self.linear1 = nn.Linear(d, spec.dim_ff)
        self.linear2 = nn.Linear(spec.dim_ff, d)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)

    def _rest(self, x, cross) -> torch.Tensor:
        x = self.norm2(x + self.multihead_attn.attend(x, *cross))
        return self.norm3(x + _feed_forward(self, x))

    def forward(self, x, cross, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._rest(self.norm1(x + self.self_attn(x, mask)), cross)

    def step(self, x, pos: int, cache, cross) -> torch.Tensor:
        return self._rest(self.norm1(x + self.self_attn.cached(x, pos, cache)), cross)


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Encoder(nn.Module):
    def __init__(self, spec: RefTransformerSpec):
        super().__init__()
        self.input_norm = nn.LayerNorm(spec.dim_model, eps=1e-5)
        self.trans_encoder = _Layers(RefEncoderLayer(spec) for _ in range(spec.encoder_layers))


class RefTransformerOCR(nn.Module, Seq2SeqDecoding):
    """The reference model: ``encode``, ``decode_train``,
    ``decode_step``, as the native model's."""

    cache_dtype = torch.float32

    def __init__(self, spec: RefTransformerSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.encoder_frontend = RefConvFrontend(spec)
        self.encoder = _Encoder(spec)
        self.trans_decoder = _Layers(RefDecoderLayer(spec) for _ in range(spec.decoder_layers))
        self.dec_embeder = nn.Embedding(spec.num_symbols, spec.dim_model)
        self.dec_out_proj = nn.Linear(spec.dim_model, spec.num_symbols)
        if generator is not None:
            random_init_(self, generator)
        self.register_buffer("pe", sinusoidal_positions(spec.max_seq_len, spec.dim_model),
                             persistent=False)

    @property
    def decoder_layers(self):
        return self.trans_decoder.layers

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """images (N, H, W, 3) in [0, 1] -> memory (N, W', d):
        input_norm, then the positions, then the encoder layers."""
        x = self.encoder_frontend(images.permute(0, 3, 1, 2).float())
        x = self.encoder.input_norm(x)
        x = x + positions(self.pe, x.shape[1])
        for layer in self.encoder.trans_encoder.layers:
            x = layer(x)
        return x

    def embed_positions(self, tokens: torch.Tensor, pos: Optional[int]) -> torch.Tensor:
        x = self.dec_embeder(tokens)
        return x + (positions(self.pe, tokens.shape[1]) if pos is None else self.pe[pos:pos + 1])

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self.dec_out_proj(x).float()

    def forward(self, images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return self.decode_train(self.encode(images), targets)


def greedy_decode_ref(model: RefTransformerOCR, images: torch.Tensor, max_len: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX ``greedy_decode_ref``: (tokens (N, max_len), lengths (N,),
    step logits (N, max_len, V)); a line's length counts its tokens
    before the first boundary."""
    return greedy_ref_from_memory(model, model.encode(images), max_len)


def greedy_ref_from_memory(model: RefTransformerOCR, memory: torch.Tensor, max_len: int):
    sp = model.spec
    check_length(max_len, sp.max_seq_len)
    tokens, logits = greedy_loop(model, memory, max_len, sp.boundary_id, sp.boundary_id)
    lengths = (torch.cumsum((tokens == sp.boundary_id).long(), dim=1) == 0).sum(1)
    return tokens, lengths, logits
