"""Character-level recurrent language model for beam-search rescoring
(port of pero_ocr_tpu/models/charlm.py).

The decoder drives it through three calls on a batch of states:

- ``initial_state(batch)`` — zero states;
- ``advance(tokens, state) -> state`` — one recurrent step;
- ``log_probs(state) -> (B, V)`` — the head on the top layer, in
  float32; ``</s>`` is the last vocabulary entry (``spec.eos_id``).

:func:`sequence_logprobs` scores whole sequences (LM training), and
``state_select``, ``state_assign`` and ``state_concat`` gather, scatter
and join batched states, as the JAX module's helpers do.

The cells are written out as the flax cells compute them, so that
states keep the JAX package's layout (a tuple per layer: (c, h) pairs
for the LSTM, bare h for the GRU) and the flax parameters map onto
them without refolding:

- ``OptimizedLSTMCell``: ``gates = (h @ W_h + b_h) + x @ W_i`` with the
  gates in the order i, f, g, o; ``c' = f * c + i * g``,
  ``h' = o * tanh(c')``;
- ``GRUCell``: ``r = sigmoid((x @ W_ir + b_ir) + h @ W_hr)``, z alike,
  ``n = tanh((x @ W_in + b_in) + r * (h @ W_hn + b_hn))``,
  ``h' = (1 - z) * n + z * h``.  The n gate keeps both biases apart
  (r scales only the hidden one), so they cannot be folded.

Kernels are stored (in, out), as flax stores them, with a cell's gates
side by side.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CharLMSpec:
    vocab_size: int                 # characters + </s>
    embed_dim: int = 64
    hidden_dim: int = 512
    num_layers: int = 2
    cell_type: str = "lstm"         # "lstm" | "gru"

    @property
    def eos_id(self) -> int:
        """``</s>`` is the last vocabulary entry."""
        return self.vocab_size - 1


def _uniform(shape, bound: float, generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: bias-free input kernels, biased
    hidden kernels; carry (c, h)."""

    def __init__(self, in_dim: int, hidden: int, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden)
        self.weight_i = _uniform((in_dim, 4 * hidden), bound, generator)
        self.weight_h = _uniform((hidden, 4 * hidden), bound, generator)
        self.bias_h = _uniform((4 * hidden,), bound, generator)

    def forward(self, carry, x):
        c, h = carry
        gates = torch.addmm(self.bias_h, h, self.weight_h) + x @ self.weight_i
        i, f, g, o = gates.chunk(4, dim=1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class GRUCell(nn.Module):
    """flax ``GRUCell``: biased input kernels ir, iz, in; bias-free hr,
    hz; biased hn."""

    def __init__(self, in_dim: int, hidden: int, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(hidden)
        self.weight_i = _uniform((in_dim, 3 * hidden), bound, generator)
        self.bias_i = _uniform((3 * hidden,), bound, generator)
        self.weight_h = _uniform((hidden, 3 * hidden), bound, generator)
        self.bias_hn = _uniform((hidden,), bound, generator)

    def forward(self, h, x):
        xi_r, xi_z, xi_n = torch.addmm(self.bias_i, x, self.weight_i).chunk(3, dim=1)
        hh_r, hh_z, hh_n = (h @ self.weight_h).chunk(3, dim=1)
        r = torch.sigmoid(xi_r + hh_r)
        z = torch.sigmoid(xi_z + hh_z)
        n = torch.tanh(xi_n + r * (hh_n + self.bias_hn))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h


class CharLM(nn.Module):
    """Recurrent character LM in float32.  States are tuples of per-layer
    carries, each leaf (B, hidden_dim)."""

    def __init__(self, spec: CharLMSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        if spec.cell_type not in ("lstm", "gru"):
            raise ValueError(f"unknown cell_type {spec.cell_type!r}")
        self.spec = spec
        self.embed = nn.Embedding(spec.vocab_size, spec.embed_dim)
        nn.init.normal_(self.embed.weight, std=1.0, generator=generator)
        cell = LSTMCell if spec.cell_type == "lstm" else GRUCell
        self.cells = nn.ModuleList(
            cell(spec.embed_dim if k == 0 else spec.hidden_dim, spec.hidden_dim, generator)
            for k in range(spec.num_layers)
        )
        self.head = nn.Linear(spec.hidden_dim, spec.vocab_size)
        bound = 1.0 / math.sqrt(spec.hidden_dim)
        nn.init.uniform_(self.head.weight, -bound, bound, generator=generator)
        nn.init.zeros_(self.head.bias)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def initial_state(self, batch_size: int) -> Tuple:
        zeros = torch.zeros(batch_size, self.spec.hidden_dim, device=self.device,
                            dtype=self.head.weight.dtype)
        if self.spec.cell_type == "gru":
            return tuple(zeros for _ in range(self.spec.num_layers))
        return tuple((zeros, zeros) for _ in range(self.spec.num_layers))

    def advance(self, tokens: torch.Tensor, state) -> Tuple:
        """One step: tokens (B,) int -> the new state."""
        x = self.embed(tokens)
        new_state = []
        for cell, s in zip(self.cells, state):
            s2, x = cell(s, x)
            new_state.append(s2)
        return tuple(new_state)

    def log_probs(self, state) -> torch.Tensor:
        """(B, V) float32 log-probabilities from the top layer's h."""
        top = state[-1]
        h_top = top if self.spec.cell_type == "gru" else top[1]
        return F.log_softmax(self.head(h_top.float()), dim=-1)


def state_leaves(state):
    """The (B, hidden) tensors of a state, in order: (c, h) per layer
    for the LSTM, h for the GRU."""
    out = []
    for s in state:
        out.extend(s if isinstance(s, tuple) else (s,))
    return out


def state_map(fn, *states):
    """``fn`` applied leaf by leaf to states of one layout."""
    out = []
    for layer in zip(*states):
        if isinstance(layer[0], tuple):
            out.append(tuple(fn(*leaves) for leaves in zip(*layer)))
        else:
            out.append(fn(*layer))
    return tuple(out)


def sequence_logprobs(model: CharLM, tokens: torch.Tensor) -> torch.Tensor:
    """(B, T) tokens -> (B, T, V) float32 log-probs of the NEXT token
    after each position, from the initial (zero) state: the JAX scan of
    ``advance`` then ``log_probs``, with the head applied once to every
    step's top-layer h (the same rows, one product)."""
    state = model.initial_state(tokens.shape[0])
    tops = []
    for t in range(tokens.shape[1]):
        state = model.advance(tokens[:, t], state)
        top = state[-1]
        tops.append(top if model.spec.cell_type == "gru" else top[1])
    return F.log_softmax(model.head(torch.stack(tops, 1).float()), dim=-1)


def state_select(state, indices: torch.Tensor):
    """The rows ``indices`` of every leaf of a batched state."""
    return state_map(lambda x: x[indices], state)


def state_assign(state, indices: torch.Tensor, values):
    """``state`` with the rows ``indices`` of every leaf replaced by
    ``values`` (a state of len(indices) rows); ``state`` is unchanged."""
    def put(x, v):
        x = x.clone()
        x[indices] = v
        return x
    return state_map(put, state, values)


def state_concat(states):
    """States of one layout joined along the batch."""
    return state_map(lambda *xs: torch.cat(xs, 0), *states)
