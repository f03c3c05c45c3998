"""optax's ``chain(clip_by_global_norm(1.0), adamw(learning_rate))``
on torch tensors (the JAX trainers' ``make_optimizer``,
``pero_ocr_tpu/parallel/train.py:33``), and plain ``optax.adam`` (no
clip, no weight decay: the JAX ``convert_torchscript distill``'s).

The arithmetic is optax 0.2.6's, op for op, on float32 weights:

- clip: ``g_norm = sqrt(sum of every leaf's sum of squares)``; when
  ``g_norm >= max_norm`` each gradient becomes ``g / g_norm * max_norm``
  (no epsilon: ``torch.nn.utils.clip_grad_norm_`` adds 1e-6, so it is
  not used);
- Adam: ``mu = (1 - b1) * g + b1 * mu``, ``nu = (1 - b2) * g * g + b2 *
  nu``, the step count ``n`` one more, ``u = (mu / (1 - b1**n)) /
  (sqrt(nu / (1 - b2**n)) + eps)`` (optax's ``eps_root`` is 0);
- decoupled weight decay on every leaf, biases and norm scales too:
  ``u = u + 1e-4 * p`` (optax's default, not torch's 1e-2);
- ``p = p + (-learning_rate * u) * lr_scale``.  ``lr_scale`` is a
  per-step factor on the whole update, weight decay included, as
  ``bench.py`` runs ``adamw(1.0)`` under a warm-up factor.

Every update runs on the device with no host synchronisation (the clip
decides on the device), as multi-tensor ``torch._foreach_*`` ops; the
weights are updated in place.

On a device mesh (``parallel/train.py``'s sharded step) the weights and
moments a rank holds may be its shards of weights split over the ranks
of a tp group.  Adam's arithmetic is elementwise, so a shard updates as
its part of the whole; the global norm is taken over the whole
gradient: the sums of squares of the shards are summed over the group,
those of the replicated weights counted once, so the clip decides as
the unsharded optimizer does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``, leaf for
    leaf as the weights), and the global norm of the last step's
    gradients before the clip, a 0-d device tensor (None before the
    first step)."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    grad_norm: Optional[torch.Tensor] = None


def global_norm(tensors: Sequence[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element of ``tensors``.
    ``sharded``: per tensor, whether it is this rank's shard of a tensor
    split over the ranks of the process group ``group``; the sum of
    squares of the shards is summed over the group (an all-reduce)."""
    norms = torch.stack(torch._foreach_norm(list(tensors)))
    if sharded is None or not any(sharded):
        return torch.linalg.vector_norm(norms)
    import torch.distributed as dist

    split = torch.tensor(list(sharded), device=norms.device)
    squares = norms * norms
    whole = torch.where(split, squares, 0).sum()  # no mask indexing: it would sync
    dist.all_reduce(whole, group=group)
    return torch.sqrt(whole + torch.where(split, 0, squares).sum())


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        sharded: Optional[Sequence[bool]] = None, group=None):
    """optax's ``clip_by_global_norm``: (the clipped gradients, new
    tensors, and their global norm before the clip); ``sharded`` and
    ``group`` as for :func:`global_norm`."""
    g_norm = global_norm(grads, sharded, group)
    keep = g_norm < max_norm
    one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
    # keep: g / 1 * 1 == g exactly; else optax's (g / g_norm) * max_norm.
    divisor = torch.where(keep, one, g_norm)
    factor = torch.where(keep, one, one * max_norm)
    clipped = torch._foreach_div(list(grads), divisor)
    torch._foreach_mul_(clipped, factor)
    return clipped, g_norm


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


# optax 0.2.6's defaults for clip_by_global_norm(1.0) and adamw(lr).
MAX_NORM = 1.0
B1, B2, EPS = 0.9, 0.999, 1e-8  # eps_root 0
WEIGHT_DECAY = 1e-4


class ClipAdamW:
    """``optax.chain(optax.clip_by_global_norm(MAX_NORM),
    optax.adamw(learning_rate))`` at optax's defaults."""

    max_norm: Optional[float] = MAX_NORM
    weight_decay: float = WEIGHT_DECAY

    def __init__(self, learning_rate: float = 3e-4):
        self.learning_rate = learning_rate

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        """Zero moments in float32, shaped as ``params``."""
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return AdamWState(count=0, mu=zeros, nu=[z.clone() for z in zeros])

    @torch.no_grad()
    def step_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              state: AdamWState, lr_scale: float = 1.0,
              sharded: Optional[Sequence[bool]] = None, group=None) -> AdamWState:
        """One update of the float32 ``params`` in place from ``grads``
        (float32, one per weight); returns ``state`` updated.  On a mesh,
        ``sharded`` marks the weights (and gradients and moments) that are
        this rank's shards over the ranks of ``group``."""
        params, grads = list(params), list(grads)
        if self.max_norm is None:
            g = grads
        else:
            g, state.grad_norm = clip_by_global_norm(grads, self.max_norm, sharded, group)
        torch._foreach_mul_(state.mu, B1)
        torch._foreach_add_(state.mu, torch._foreach_mul(g, 1 - B1))
        torch._foreach_mul_(state.nu, B2)
        torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2))
        state.count += 1
        mu_hat = torch._foreach_div(state.mu, _bias_correction(B1, state.count))
        nu_hat = torch._foreach_div(state.nu, _bias_correction(B2, state.count))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(updates, -self.learning_rate)
        if lr_scale != 1.0:
            torch._foreach_mul_(updates, lr_scale)
        torch._foreach_add_(params, updates)
        return state


class Adam(ClipAdamW):
    """``optax.adam(learning_rate)`` at optax's defaults: the same Adam
    arithmetic with no clip and no weight decay (``grad_norm`` stays
    None)."""

    max_norm = None
    weight_decay = 0.0
