"""Autoregressive transformer line recognizer, pre-LN (port of
pero_ocr_tpu/models/transformer.py), and the attention and decode loops
that the reference-style model (:mod:`.transformer_ref`) shares.

The public boundary is NHWC, as in the JAX package: ``encode`` takes
(N, H, W, 3) line images in [0, 1] and returns the memory (N, W', d).
The model computes in ``spec.dtype`` (bfloat16 by default, as the JAX
spec); LayerNorms take their statistics in float32 (flax's) and the
output projection runs in float32.

Attention is written out in torch ops in flax's order: the query is
scaled by 1/sqrt(head_dim) before QK^T, masked logits take the dtype's
``finfo.min``, softmax over the keys.  The parameters keep torch's
``nn.MultiheadAttention`` layout (``in_proj_weight`` (3d, d),
``in_proj_bias``, ``out_proj``), which the reference state dicts use.

Greedy and beam decodes are the JAX ``lax.scan``s as fixed-length
Python loops of torch ops with no host synchronisation: a KV cache
preallocated per decoder layer, (N, heads, max_len, head_dim), written
at step ``pos`` and attended up to it (flax's cache masks the positions
after ``pos``; their weights are exactly 0); dead lines emit the end
id.  The cross-attention's keys and values of the memory are projected
once a batch (``cross_kv``), not every step as flax's ``decode_step``
does: the same products, the same values.  The loops run eagerly, and
the OCR engine captures them as one CUDA graph a shape on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pero_ocr_tpu_torch.models.parsenet import SameConv2d
from pero_ocr_tpu_torch.models.recognizer import _max_pool_same

Cache = List[Tuple[torch.Tensor, torch.Tensor]]  # per decoder layer: (keys, values)
NEG = -1e9  # the beam's void score (JAX ``neg``)


@dataclasses.dataclass(frozen=True)
class TransformerSpec:
    """Architecture spec, field for field the JAX ``TransformerSpec``
    (``net_spec`` in the OCR JSON)."""

    num_classes: int = 0
    line_height: int = 40
    conv_features: Tuple[int, ...] = (64, 128, 256)
    subsampling: int = 4
    d_model: int = 512
    num_heads: int = 8
    encoder_layers: int = 4
    decoder_layers: int = 4
    mlp_dim: int = 1024
    max_decode_len: int = 256
    dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def from_json_dict(cfg: dict, num_classes: int) -> "TransformerSpec":
        spec = cfg.get("net_spec", {})
        return TransformerSpec(
            num_classes=num_classes,
            line_height=cfg.get("line_px_height", 40),
            conv_features=tuple(spec.get("conv_features", (64, 128, 256))),
            subsampling=spec.get("subsampling", 4),
            d_model=spec.get("d_model", 512),
            num_heads=spec.get("num_heads", 8),
            encoder_layers=spec.get("encoder_layers", 4),
            decoder_layers=spec.get("decoder_layers", 4),
            mlp_dim=spec.get("mlp_dim", 1024),
            max_decode_len=spec.get("max_decode_len", 256),
        )

    @property
    def bos_id(self) -> int:
        return self.num_classes

    @property
    def eos_id(self) -> int:
        return self.num_classes + 1

    @property
    def vocab(self) -> int:
        return self.num_classes + 2


def sinusoidal_positions(length: int, dim: int) -> torch.Tensor:
    """(length, dim) float32 sine (even) / cosine (odd) table, computed
    in float64 as the JAX package does."""
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


def positions(table: torch.Tensor, length: int) -> torch.Tensor:
    """The first ``length`` rows of a model's position table (on its
    device, so that no copy from the host enters a captured loop), or a
    longer table made anew: the rows are the same either way."""
    if length <= table.shape[0]:
        return table[:length]
    return sinusoidal_positions(length, table.shape[1]).to(table.device)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm``: statistics and affine in float32, the result
    in ``x``'s dtype."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(),
                     norm.eps)
    return y.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (no dropout) with torch's
    parameter layout."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        # sqrt(head_dim) as a device tensor: a true division, as flax's,
        # with no host-to-device copy inside a captured loop.
        self.register_buffer("depth_sqrt", torch.tensor(math.sqrt(dim // heads)),
                             persistent=False)

    def _split(self, y: torch.Tensor) -> torch.Tensor:
        n, length, _ = y.shape
        return y.view(n, length, self.heads, -1).transpose(1, 2)  # (N, h, L, hd)

    def project(self, x: torch.Tensor, part: int) -> torch.Tensor:
        """The query (0), key (1) or value (2) projection, (N, h, L, hd)."""
        d = x.shape[-1]
        w = self.in_proj_weight[part * d:(part + 1) * d]
        b = self.in_proj_bias[part * d:(part + 1) * d]
        return self._split(F.linear(x, w, b))

    def kv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.project(x, 1), self.project(x, 2)

    def attend(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Queries from ``x`` (N, Lq, d) over keys and values (N, h, Lk,
        hd); ``mask`` (Lq, Lk) or (N, 1, Lq or 1, Lk) bool keeps True."""
        q = self.project(x, 0) / self.depth_sqrt.to(x.dtype)
        w = q @ k.transpose(-1, -2)  # (N, h, Lq, Lk)
        if mask is not None:
            w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        y = (w @ v).transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
        return self.out_proj(y)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.attend(x, *self.kv(x), mask)

    def cached(self, x: torch.Tensor, pos: int, cache: Tuple[torch.Tensor, torch.Tensor]
               ) -> torch.Tensor:
        """Self-attention of one step ``x`` (N, 1, d): its key and value
        written at ``pos`` of the layer's cache, attended over 0..pos."""
        k_cache, v_cache = cache
        k, v = self.kv(x)
        k_cache[:, :, pos:pos + 1] = k
        v_cache[:, :, pos:pos + 1] = v
        return self.attend(x, k_cache[:, :, :pos + 1], v_cache[:, :, :pos + 1])


def check_length(max_len: int, table: int) -> None:
    """A decode reads the position table at every step: it may not run
    past the table (JAX would clamp the index and repeat the last row)."""
    if not 1 <= max_len <= table:
        raise ValueError(f"decode length {max_len} outside the position table's 1..{table}")


def causal_mask(length: int, device) -> torch.Tensor:
    return torch.ones(length, length, dtype=torch.bool, device=device).tril()


def key_mask(src_valid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """flax ``make_attention_mask(ones, src_valid)``: (N, 1, 1, Lk), every
    query keeps the valid memory frames (N, Lk) of its line."""
    return None if src_valid is None else src_valid.bool()[:, None, None, :]


def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: normal kernels scaled by 1/sqrt(fan in),
    zero biases, unit norms, normal embeddings."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0.0, m.weight[0].numel() ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MultiHeadAttention):
                m.in_proj_weight.normal_(0.0, m.in_proj_weight.shape[1] ** -0.5,
                                         generator=generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)


class ConvFrontend(nn.Module):
    """Pairs of SAME 3x3 convs with relu and a SAME 2x2 max pool (stride
    2 down, 2 across in the first log2(subsampling) blocks), then a
    VALID conv over the remaining height: (N, C, H, W) -> (N, W', d)."""

    def __init__(self, spec: TransformerSpec):
        super().__init__()
        w_blocks = int(math.log2(spec.subsampling))
        self.convs = nn.ModuleList()
        self.strides = []
        in_c, height = 3, spec.line_height
        for i, feat in enumerate(spec.conv_features):
            self.convs.extend([SameConv2d(in_c, feat, 3), SameConv2d(feat, feat, 3)])
            self.strides.append(2 if i < w_blocks else 1)
            in_c, height = feat, -(-height // 2)
        self.agg = nn.Conv2d(in_c, spec.d_model, (height, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, stride_w in enumerate(self.strides):
            x = F.relu(self.convs[2 * i](x))
            x = F.relu(self.convs[2 * i + 1](x))
            x = _max_pool_same(x, stride_w)
        return self.agg(x)[:, :, 0].transpose(1, 2)


def feed_forward(norm: nn.LayerNorm, linear1: nn.Linear, linear2: nn.Linear,
                 x: torch.Tensor) -> torch.Tensor:
    """Pre-LN gelu (tanh, flax's default) feed-forward, added back."""
    return x + linear2(F.gelu(linear1(layer_norm(norm, x)), approximate="tanh"))


class EncoderLayer(nn.Module):
    """Pre-LN: self-attention, then the feed-forward, each on its
    LayerNorm's output (flax's epsilon 1e-6), added back."""

    def __init__(self, spec: TransformerSpec):
        super().__init__()
        d = spec.d_model
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.self_attn = MultiHeadAttention(d, spec.num_heads)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.linear1 = nn.Linear(d, spec.mlp_dim)
        self.linear2 = nn.Linear(spec.mlp_dim, d)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(layer_norm(self.norm1, x), mask)
        return feed_forward(self.norm2, self.linear1, self.linear2, x)


class DecoderLayer(nn.Module):
    """Pre-LN: self-attention, cross-attention over the memory, the
    feed-forward."""

    def __init__(self, spec: TransformerSpec):
        super().__init__()
        d = spec.d_model
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.self_attn = MultiHeadAttention(d, spec.num_heads)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.multihead_attn = MultiHeadAttention(d, spec.num_heads)
        self.norm3 = nn.LayerNorm(d, eps=1e-6)
        self.linear1 = nn.Linear(d, spec.mlp_dim)
        self.linear2 = nn.Linear(spec.mlp_dim, d)

    def forward(self, x, cross: Tuple[torch.Tensor, torch.Tensor],
                mask: Optional[torch.Tensor] = None,
                cross_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(layer_norm(self.norm1, x), mask)
        x = x + self.multihead_attn.attend(layer_norm(self.norm2, x), *cross, cross_mask)
        return feed_forward(self.norm3, self.linear1, self.linear2, x)

    def step(self, x, pos: int, cache, cross,
             cross_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn.cached(layer_norm(self.norm1, x), pos, cache)
        x = x + self.multihead_attn.attend(layer_norm(self.norm2, x), *cross, cross_mask)
        return feed_forward(self.norm3, self.linear1, self.linear2, x)


class Seq2SeqDecoding:
    """The decode entry points both models share; a model defines
    ``embed_positions(tokens, offset)``, ``decoder_layers``,
    ``head(x)`` and ``cache_dtype``."""

    def cross_kv(self, memory: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each decoder layer's cross-attention keys and values of the
        memory, projected once a batch."""
        return [layer.multihead_attn.kv(memory) for layer in self.decoder_layers]

    def init_cache(self, n: int, max_len: int, device) -> Cache:
        """Zeroed self-attention caches, (n, heads, max_len, head_dim)
        keys and values a decoder layer."""
        layer = self.decoder_layers[0].self_attn
        d = layer.in_proj_weight.shape[1]
        shape = (n, layer.heads, max_len, d // layer.heads)
        return [(torch.zeros(shape, dtype=self.cache_dtype, device=device),
                 torch.zeros(shape, dtype=self.cache_dtype, device=device))
                for _ in self.decoder_layers]

    def decode_train(self, memory: torch.Tensor, targets: torch.Tensor,
                     src_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced logits (N, L, V) float32 of ``targets`` (N, L)
        (which start with the start id); ``src_valid`` (N, W') bool
        masks the memory frames the cross-attention reads."""
        x = self.embed_positions(targets, None)
        cross = self.cross_kv(memory)
        mask = causal_mask(targets.shape[1], targets.device)
        cross_mask = key_mask(src_valid)
        for layer, kv in zip(self.decoder_layers, cross):
            x = layer(x, kv, mask, cross_mask)
        return self.head(x)

    def decode_step(self, token: torch.Tensor, pos: int, cache: Cache, cross,
                    src_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cached step: token (N,) at position ``pos`` -> logits
        (N, V) float32; writes ``cache`` at ``pos``.  ``src_valid`` as
        in :meth:`decode_train`."""
        x = self.embed_positions(token[:, None], pos)
        cross_mask = key_mask(src_valid)
        for layer, layer_cache, kv in zip(self.decoder_layers, cache, cross):
            x = layer.step(x, pos, layer_cache, kv, cross_mask)
        return self.head(x)[:, 0]


def greedy_loop(model: Seq2SeqDecoding, memory: torch.Tensor, max_len: int, start_id: int,
                end_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX greedy scan: ``max_len`` cached steps from ``start_id``;
    a line emits ``end_id`` from its first ``end_id`` on.  Returns the
    tokens (N, max_len) int64 and every step's logits (N, max_len, V)
    float32 (a dead line's too, as the scan computes them)."""
    n = memory.shape[0]
    device = memory.device
    cache = model.init_cache(n, max_len, device)
    cross = model.cross_kv(memory)
    token = torch.full((n,), start_id, dtype=torch.int64, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    end = torch.full((n,), end_id, dtype=torch.int64, device=device)
    tokens, logits = [], []
    for pos in range(max_len):
        step_logits = model.decode_step(token, pos, cache, cross)
        token = torch.where(alive, torch.argmax(step_logits, dim=-1), end)
        alive = alive & (token != end_id)
        tokens.append(token)
        logits.append(step_logits)
    return torch.stack(tokens, 1), torch.stack(logits, 1)


class TransformerOCR(nn.Module, Seq2SeqDecoding):
    """The native pre-LN encoder-decoder (JAX ``TransformerOCR``)."""

    def __init__(self, spec: TransformerSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.spec = spec
        self.frontend = ConvFrontend(spec)
        self.encoder_layers = nn.ModuleList(EncoderLayer(spec) for _ in range(spec.encoder_layers))
        self.encoder_norm = nn.LayerNorm(spec.d_model, eps=1e-6)
        self.embed = nn.Embedding(spec.vocab, spec.d_model)
        self.decoder_layers = nn.ModuleList(DecoderLayer(spec) for _ in range(spec.decoder_layers))
        self.decoder_norm = nn.LayerNorm(spec.d_model, eps=1e-6)
        self.out_proj = nn.Linear(spec.d_model, spec.vocab)
        if generator is not None:
            random_init_(self, generator)
        # flax computes in spec.dtype (kernels cast per call); LayerNorms
        # and the output projection stay float32.
        for name, child in self.named_children():
            if name not in ("encoder_norm", "decoder_norm", "out_proj"):
                child.to(spec.dtype)
        for m in self.modules():
            if isinstance(m, nn.LayerNorm):
                m.float()
        self.register_buffer("pe", sinusoidal_positions(spec.max_decode_len, spec.d_model),
                             persistent=False)

    @property
    def cache_dtype(self) -> torch.dtype:
        return self.spec.dtype

    def encode(self, images: torch.Tensor, src_valid: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """images (N, H, W, 3) in [0, 1] -> memory (N, W', d);
        ``src_valid`` (N, W') bool masks the frames that self-attention
        reads (a line's padding)."""
        sp = self.spec
        x = self.frontend(images.permute(0, 3, 1, 2).to(sp.dtype))
        x = x + positions(self.pe, x.shape[1]).to(sp.dtype)
        mask = key_mask(src_valid)
        for layer in self.encoder_layers:
            x = layer(x, mask)
        return layer_norm(self.encoder_norm, x)

    def forward(self, images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Training forward (the JAX ``__call__``): images (N, H, W, 3) and
        start-prefixed targets (N, L) -> teacher-forced logits (N, L, V)
        float32."""
        return self.decode_train(self.encode(images), targets)

    def embed_positions(self, tokens: torch.Tensor, pos: Optional[int]) -> torch.Tensor:
        x = self.embed(tokens)
        pe = positions(self.pe, tokens.shape[1]) if pos is None else self.pe[pos:pos + 1]
        return x + pe.to(x.dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(layer_norm(self.decoder_norm, x).float())


def greedy_decode(model: TransformerOCR, images: torch.Tensor, max_len: int,
                  src_valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX ``greedy_decode``: (tokens (N, max_len), lengths (N,),
    confidences (N,)); the confidence is the least chosen-token
    probability over the emitted characters.  ``src_valid`` is taken
    and not used, as in the JAX function, which passes it to nothing."""
    return greedy_from_memory(model, model.encode(images), max_len)[:3]


def greedy_from_memory(model: TransformerOCR, memory: torch.Tensor, max_len: int):
    """``greedy_decode`` from the memory; also returns the step logits."""
    sp = model.spec
    check_length(max_len, sp.max_decode_len)
    tokens, logits = greedy_loop(model, memory, max_len, sp.bos_id, sp.eos_id)
    lengths = (tokens != sp.eos_id).sum(1)
    chosen = torch.log_softmax(logits, dim=-1).amax(-1)
    return tokens, lengths, _confidences(chosen, lengths), logits


def _confidences(step_lp: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    emitted = torch.arange(step_lp.shape[1], device=step_lp.device)[None, :] < lengths[:, None]
    return torch.exp(torch.where(emitted, step_lp, 0.0).amin(1)).float()


def beam_decode(model: TransformerOCR, images: torch.Tensor, max_len: int, k: int = 4
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX ``beam_decode``: k beams a line, a fixed ``max_len`` steps
    that reorder the KV caches by parent, the best final beam walked
    back.  Same outputs as :func:`greedy_decode`; ``k=1`` is greedy."""
    return beam_from_memory(model, model.encode(images), max_len, k)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: descending, the lower
    index first among equal values (a stable sort)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def beam_from_memory(model: TransformerOCR, memory: torch.Tensor, max_len: int, k: int):
    sp = model.spec
    check_length(max_len, sp.max_decode_len)
    n = memory.shape[0]
    device = memory.device
    memory = torch.repeat_interleave(memory, k, dim=0)  # (N*k, W', d)
    cache = model.init_cache(n * k, max_len, device)
    cross = model.cross_kv(memory)
    token = torch.full((n * k,), sp.bos_id, dtype=torch.int64, device=device)
    scores = torch.where(torch.arange(k, device=device) == 0, 0.0, NEG)[None].repeat(n, 1)
    done = torch.zeros((n, k), dtype=torch.bool, device=device)
    is_eos = torch.arange(sp.vocab, device=device) == sp.eos_id
    eos_only = torch.where(is_eos, 0.0, NEG)
    line = torch.arange(n, device=device)[:, None]
    parents, toks, deltas = [], [], []
    for pos in range(max_len):
        logits = model.decode_step(token, pos, cache, cross)
        lp = torch.log_softmax(logits.float(), dim=-1).reshape(n, k, -1)
        v = lp.shape[-1]
        # Finished beams continue only through EOS, at no cost.
        cont = torch.where(done[:, :, None], eos_only, lp)
        cand = scores[:, :, None] + cont
        new_scores, flat = _top_k(cand.reshape(n, k * v), k)
        parent = flat // v
        tok = flat % v
        delta = new_scores - torch.gather(scores, 1, parent)
        rows = (line * k + parent).reshape(-1)
        for k_cache, v_cache in cache:
            k_cache.copy_(k_cache.index_select(0, rows))
            v_cache.copy_(v_cache.index_select(0, rows))
        done = torch.gather(done, 1, parent) | (tok == sp.eos_id)
        token, scores = tok.reshape(-1), new_scores
        parents.append(parent)
        toks.append(tok)
        deltas.append(delta)
    cursor = torch.argmax(scores, dim=1)[:, None]  # (N, 1)
    out_tokens, out_lp = [], []
    for parent, tok, delta in zip(reversed(parents), reversed(toks), reversed(deltas)):
        out_tokens.append(torch.gather(tok, 1, cursor)[:, 0])
        out_lp.append(torch.gather(delta, 1, cursor)[:, 0])
        cursor = torch.gather(parent, 1, cursor)
    tokens = torch.stack(out_tokens[::-1], 1)
    step_lp = torch.stack(out_lp[::-1], 1)
    lengths = (tokens != sp.eos_id).sum(1)
    return tokens, lengths, _confidences(step_lp, lengths)
