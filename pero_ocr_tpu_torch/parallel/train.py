"""Single-device training (port of pero_ocr_tpu/parallel/train.py).

The five trainers of the JAX package, with its names: the CTC
recognizer (``ctc_loss_fn``, ``make_train_step``), ParseNet
(``parsenet_loss_fn``, ``make_parsenet_train_step``), OrientationNet
(``orientation_loss_fn``, ``make_orientation_train_step``), the native
transformer (``transformer_loss_fn``, ``make_transformer_train_step``)
and the character LM (``lm_loss_fn``, ``make_lm_train_step``,
``export_lm_checkpoint``), under ``make_optimizer``'s clip + AdamW
(:mod:`.optim`, optax's arithmetic).  Each step takes the JAX step's
inputs in its layout (NHWC float images in [0, 1], int labels with
lengths, the same loss weights), numpy arrays or tensors, and computes
the same loss; it returns ``(state, loss)`` with the loss a 0-d device
tensor.  The update itself runs on the device without host
synchronisation (torch's CUDA CTC loss reads the label lengths on the
host).

The modules hold their own parameters, so the loss functions take the
module where the JAX ones take ``(model, params)``.  What the port's
state keeps:

- **float32 weights**, as flax keeps them, under the module's
  state-dict names: the module's own parameters where they are float32
  (updated in place), and float32 copies of the others (a bf16 spec's),
  which the step writes back into the module after every update; so
  the model computes in its spec's dtype from float32 weights, as flax
  does;
- **no weight that flax lacks**: ``nn.LSTM``'s ``bias_ih`` (flax's
  ``OptimizedLSTMCell`` has one hidden bias, which the port holds as
  ``bias_hh``) is folded into ``bias_hh``, zeroed and frozen, out of
  the optimizer, the weight decay and the global norm; trained too, the
  sum of the two would move twice as fast as flax's bias.

Steps run the module in training mode (cuDNN's RNN backward needs it;
no module here has dropout or batch statistics, so no number changes).
Initialisation puts the module on CUDA unless the caller passes
``device="cpu"`` (:func:`pero_ocr_tpu_torch.resolve_device`).

The CTC loss is ``F.ctc_loss`` (blank last, per sequence, then the
batch mean: torch's ``"mean"`` would divide by the label lengths, and
optax's does not) with ``zero_infinity=True``: a label sequence that
cannot fit its frames (its length plus its repeats exceed the frames)
adds 0 to the batch's sum and no gradient.  optax instead gives such a
sequence a large finite loss (its ``log_epsilon`` is -1e5, so about
1e5 a missing frame) and a gradient, where torch's plain loss is inf
and would turn every weight into NaN.

The mesh trainer (``shard_train_state``, ``make_sharded_train_step``)
trains the CTC recognizer over a (dp, tp)
:class:`~pero_ocr_tpu_torch.parallel.mesh.Mesh` in a
``torch.distributed`` group of dp * tp ranks that the caller initialised
(NCCL on CUDA, gloo on the CPU), one rank a mesh position.  Each rank
keeps its shards of the float32 weights and of Adam's mu and nu, split
over tp as ``mesh.shard_axes`` says (the count and the step
are replicated).  A step runs forward and backward on the rank's dp
share of the global batch, with the module holding the whole weights;
the per-sequence losses are summed over the global batch and divided by
its size, and the gradients summed over dp, so the loss is the global
batch mean, as JAX's is.  Each rank then clips (the global norm over
the whole gradient) and updates its shards, and the updated shards are
gathered over tp into the module.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pero_ocr_tpu_torch import resolve_device
from pero_ocr_tpu_torch.models.charlm import sequence_logprobs
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer
from pero_ocr_tpu_torch.parallel import mesh as mesh_lib
from pero_ocr_tpu_torch.parallel.optim import AdamWState, ClipAdamW
from pero_ocr_tpu_torch.utils import checkpoint, convert

_FROZEN = re.compile(r"bias_ih_l\d+(_reverse)?")


@dataclasses.dataclass
class TrainState:
    """The JAX ``TrainState``: ``params`` the float32 weights by
    state-dict name (see the module docstring), ``opt_state`` the
    optimizer's, ``step`` the steps taken.  ``targets`` holds, weight
    for weight, the module parameter each one trains, and ``model`` the
    module.  A state sharded over a mesh (:func:`shard_train_state`)
    holds this rank's shards of the weights and moments, and
    ``shard_axes`` the torch axis of each weight split over tp (None
    where it is replicated)."""

    params: Dict[str, torch.Tensor]
    opt_state: object
    step: int
    targets: List[nn.Parameter]
    model: Optional[nn.Module] = dataclasses.field(default=None, repr=False)
    shard_axes: Optional[Dict[str, Optional[int]]] = None


def make_optimizer(learning_rate: float = 3e-4) -> ClipAdamW:
    """``optax.chain(clip_by_global_norm(1.0), adamw(learning_rate))``."""
    return ClipAdamW(learning_rate)


def _frozen(model: nn.Module):
    """(name, parameter) of every parameter flax does not have."""
    for prefix, module in model.named_modules():
        if isinstance(module, nn.LSTM):
            for name, p in module.named_parameters():
                if _FROZEN.fullmatch(name):
                    yield f"{prefix}.{name}" if prefix else name, p


def init_train_state(model: nn.Module, optimizer: ClipAdamW, device=None) -> TrainState:
    """Put ``model`` on ``device`` (CUDA unless "cpu" is asked for),
    fold and freeze the parameters flax lacks, and make the state of its
    current weights.  It serves every trainer: the JAX package's
    ``init_*_train_state`` differ only in the dummy inputs flax needs to
    create parameters, which a torch module already holds."""
    model.to(resolve_device(device))
    if isinstance(model, CTCRecognizer):
        convert.fold_lstm_input_bias_(model)
    frozen = dict(_frozen(model))
    for p in frozen.values():
        p.requires_grad_(False)
    params, targets = {}, []
    for name, p in model.named_parameters():
        if name in frozen:
            continue
        p.requires_grad_(True)
        params[name] = p if p.dtype == torch.float32 else p.detach().float().clone()
        targets.append(p)
    return TrainState(params, optimizer.init(list(params.values())), 0, targets, model)


init_parsenet_train_state = init_transformer_train_state = init_lm_train_state = init_train_state


def float32_state_dict(model: nn.Module, state: TrainState) -> Dict[str, torch.Tensor]:
    """``model``'s state dict with the state's float32 weights in place
    of the module's own (what a flax export of the training holds)."""
    sd = model.state_dict()
    sd.update({name: p.detach() for name, p in state.params.items()})
    return sd


def gradients(model: nn.Module, state: TrainState) -> List[torch.Tensor]:
    """The last backward's gradient of each trained weight, float32
    (zeros where the loss did not reach the parameter)."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) if p.grad is None
            else p.grad.float() for p in state.targets]


def _apply_step(model, optimizer: ClipAdamW, state: TrainState,
                loss_fn: Callable[[], torch.Tensor], lr_scale: float):
    model.train()
    for p in state.targets:
        p.grad = None
    loss = loss_fn()
    loss.backward()
    optimizer.step_(list(state.params.values()), gradients(model, state), state.opt_state,
                    lr_scale)
    with torch.no_grad():
        for w, p in zip(state.params.values(), state.targets):
            if w is not p:
                p.copy_(w)
    state.step += 1
    return state, loss.detach()


def make_loss_step(model, optimizer: ClipAdamW, loss_fn: Callable[..., torch.Tensor]):
    """``step(state, *inputs, lr_scale=1.0)`` for any ``loss_fn(model,
    *inputs)``: the update of the other trainers' steps (used by
    ``scripts/convert_torchscript.py distill``)."""
    def train_step(state: TrainState, *inputs, lr_scale: float = 1.0):
        return _apply_step(model, optimizer, state, lambda: loss_fn(model, *inputs), lr_scale)

    return train_step


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _tensor(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


# ----------------------------------------------------------------------
# CTC recognizer
def ctc_loss_fn(model, images, labels, label_lengths) -> torch.Tensor:
    """Mean CTC loss of (B, H, W, 3) images against (B, S) labels of
    ``label_lengths``; blank is the last class."""
    return ctc_losses(model, images, labels, label_lengths).mean()


def ctc_losses(model, images, labels, label_lengths) -> torch.Tensor:
    """:func:`ctc_loss_fn`'s loss of each sequence, (B,)."""
    device = _device_of(model)
    logits = model(_tensor(images, device, torch.float32))
    b, t, c = logits.shape
    log_probs = F.log_softmax(logits, dim=-1).transpose(0, 1)
    return F.ctc_loss(
        log_probs, _tensor(labels, device, torch.long),
        torch.full((b,), t, dtype=torch.long, device=device),
        _tensor(label_lengths, device, torch.long),
        blank=c - 1, reduction="none", zero_infinity=True,
    )


def make_train_step(model, optimizer: ClipAdamW):
    """``step(state, images, labels, label_lengths, lr_scale=1.0)``."""
    def train_step(state: TrainState, images, labels, label_lengths, lr_scale: float = 1.0):
        return _apply_step(model, optimizer, state,
                           lambda: ctc_loss_fn(model, images, labels, label_lengths), lr_scale)

    return train_step


def _all_gather(shard: torch.Tensor, axis: int, tp: int, group) -> torch.Tensor:
    """The whole tensor from the tp ranks' shards split along ``axis``."""
    import torch.distributed as dist

    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    part = shard.movedim(axis, 0).contiguous()
    whole = part.new_empty((tp * part.shape[0], *part.shape[1:]))
    gather(whole, part, group=group)
    return whole.movedim(0, axis)


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """This rank's part of ``state`` (the same unsharded state on every
    rank, on the rank's mesh device): the weights and Adam's mu and nu
    split over tp by ``mesh.shard_axes`` on the state's model,
    the count and the step replicated.  Runs in the process group of
    ``mesh`` (:func:`~pero_ocr_tpu_torch.parallel.mesh.device_mesh`)."""
    dmesh = mesh_lib.device_mesh(mesh)
    tp, tp_rank = mesh.shape["tp"], dmesh.get_local_rank("tp")
    device = mesh.devices[tuple(dmesh.get_coordinate())]
    rules = mesh_lib.shard_axes(state.model, mesh)
    axes = {name: rules[name] for name in state.params}
    for name, w in state.params.items():
        if mesh_lib.indexed_device(w.device) != device:
            raise ValueError(f"{name} is on {w.device}; this rank's mesh device is {device}")

    def piece(name, t):
        axis = axes[name]
        return t if axis is None else t.chunk(tp, dim=axis)[tp_rank].contiguous()

    names = list(state.params)
    opt = state.opt_state
    opt_state = AdamWState(opt.count, [piece(n, m) for n, m in zip(names, opt.mu)],
                           [piece(n, v) for n, v in zip(names, opt.nu)], opt.grad_norm)
    return TrainState({n: piece(n, w) for n, w in state.params.items()}, opt_state,
                      state.step, state.targets, state.model, axes)


def make_sharded_train_step(model, optimizer: ClipAdamW, mesh):
    """``step(state, images, labels, label_lengths, lr_scale=1.0)`` on a
    state from :func:`shard_train_state`: every rank passes the same
    global batch, whose size dp divides, and gets the global batch's
    mean loss."""
    import torch.distributed as dist

    dmesh = mesh_lib.device_mesh(mesh)
    dp_group, tp_group = dmesh.get_group("dp"), dmesh.get_group("tp")
    dp, dp_rank = mesh.shape["dp"], dmesh.get_local_rank("dp")
    tp, tp_rank = mesh.shape["tp"], dmesh.get_local_rank("tp")

    def train_step(state: TrainState, images, labels, label_lengths, lr_scale: float = 1.0):
        if state.shard_axes is None:
            raise ValueError("make_sharded_train_step takes a state from shard_train_state")
        b = len(images)
        if b % dp:
            raise ValueError(f"batch of {b} does not split over dp={dp}")
        rows = slice(dp_rank * (b // dp), (dp_rank + 1) * (b // dp))
        model.train()
        for p in state.targets:
            p.grad = None
        loss = ctc_losses(model, images[rows], labels[rows], label_lengths[rows]).sum() / b
        loss.backward()
        grads = gradients(model, state)
        # The gradients and the loss summed over dp in one all-reduce.
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1).float()])
        dist.all_reduce(flat, group=dp_group)
        grads = [g.view_as(full) for g, full in
                 zip(torch.split(flat[:-1], [g.numel() for g in grads]), grads)]
        axes = [state.shard_axes[name] for name in state.params]
        local = [g if axis is None else g.chunk(tp, dim=axis)[tp_rank]
                 for g, axis in zip(grads, axes)]
        optimizer.step_(list(state.params.values()), local, state.opt_state, lr_scale,
                        sharded=[axis is not None for axis in axes], group=tp_group)
        with torch.no_grad():
            for w, p, axis in zip(state.params.values(), state.targets, axes):
                if axis is not None:
                    p.copy_(_all_gather(w, axis, tp, tp_group))
                elif w is not p:
                    p.copy_(w)
        state.step += 1
        return state, flat[-1]

    return train_step


# ----------------------------------------------------------------------
# ParseNet
def parsenet_loss_fn(model, images, target_maps, height_weight: float = 0.01,
                     off_mask_height_weight: float = 0.0, pos_weight: float = 1.0,
                     hard_neg_weight: float = 0.0, height_over_weight: float = 1.0
                     ) -> torch.Tensor:
    """The JAX ``parsenet_loss_fn``: images (B, H, W, 3); target_maps
    (B, H*U, W*U, 5) with channels [asc_height, desc_height, baseline,
    endpoint, separator].  BCE on the probability channels (positives
    weighted ``pos_weight``, negatives predicted above 0.15 weighted
    ``1 + hard_neg_weight``, that weight out of the gradient), plus
    ``height_weight`` x the L1 of the heights on the baseline mask (an
    over-prediction counting ``height_over_weight`` times), plus
    ``off_mask_height_weight`` x their mean L1 off it."""
    device = _device_of(model)
    pred = model(_tensor(images, device, torch.float32))
    target_maps = _tensor(target_maps, device, torch.float32)
    p = pred[..., 2:5].clamp(1e-6, 1.0 - 1e-6)
    mask_tgt = target_maps[..., 2:5]
    neg_w = 1.0
    if hard_neg_weight:
        neg_w = 1.0 + hard_neg_weight * (p > 0.15).to(p.dtype).detach()
    bce = -(pos_weight * mask_tgt * torch.log(p)
            + neg_w * (1.0 - mask_tgt) * torch.log(1.0 - p)).mean()
    on = target_maps[..., 2:3]
    h_diff = pred[..., 0:2] - target_maps[..., 0:2]
    h_abs = h_diff.abs()
    if height_over_weight != 1.0:
        h_abs = h_abs * torch.where(h_diff > 0, height_over_weight, 1.0)
    h_l1 = (h_abs * on).sum() / torch.clamp(on.sum() * 2.0, min=1.0)
    loss = bce + height_weight * h_l1
    if off_mask_height_weight:
        loss = loss + off_mask_height_weight * (h_abs * (1.0 - on)).mean()
    return loss


def make_parsenet_train_step(model, optimizer: ClipAdamW, height_weight: float = 0.01,
                             off_mask_height_weight: float = 0.0, pos_weight: float = 1.0,
                             hard_neg_weight: float = 0.0, height_over_weight: float = 1.0):
    """``step(state, images, target_maps, lr_scale=1.0)``."""
    weights = dict(height_weight=height_weight, off_mask_height_weight=off_mask_height_weight,
                   pos_weight=pos_weight, hard_neg_weight=hard_neg_weight,
                   height_over_weight=height_over_weight)

    def train_step(state: TrainState, images, target_maps, lr_scale: float = 1.0):
        return _apply_step(model, optimizer, state,
                           lambda: parsenet_loss_fn(model, images, target_maps, **weights),
                           lr_scale)

    return train_step


# ----------------------------------------------------------------------
# OrientationNet
def orientation_loss_fn(model, images, target_dirs, text_mask) -> torch.Tensor:
    """Mean ``1 - cos`` between the normalized predicted and the target
    (B, H, W, 2) unit directions inside ``text_mask`` (B, H, W); the
    1e-8 inside the square root keeps the gradient finite at zero."""
    device = _device_of(model)
    pred = model(_tensor(images, device, torch.float32))
    text_mask = _tensor(text_mask, device, torch.float32)
    norm = torch.sqrt((pred * pred).sum(-1, keepdim=True) + 1e-8)
    cos = ((pred / norm) * _tensor(target_dirs, device, torch.float32)).sum(-1)
    return ((1.0 - cos) * text_mask).sum() / torch.clamp(text_mask.sum(), min=1.0)


def make_orientation_train_step(model, optimizer: ClipAdamW):
    """``step(state, images, target_dirs, text_mask, lr_scale=1.0)``."""
    def train_step(state: TrainState, images, target_dirs, text_mask, lr_scale: float = 1.0):
        return _apply_step(model, optimizer, state,
                           lambda: orientation_loss_fn(model, images, target_dirs, text_mask),
                           lr_scale)

    return train_step


# ----------------------------------------------------------------------
# Transformer OCR
def transformer_loss_fn(model, images, targets, target_lengths) -> torch.Tensor:
    """Teacher-forced cross-entropy: ``targets`` (B, L) char ids without
    specials; the start id is prefixed, the end id is the label at each
    line's length, and positions past it are masked."""
    device = _device_of(model)
    sp = model.spec
    targets = _tensor(targets, device, torch.long)
    lengths = _tensor(target_lengths, device, torch.long)[:, None]
    b, length = targets.shape
    inputs = torch.cat([torch.full((b, 1), sp.bos_id, dtype=torch.long, device=device),
                        targets], dim=1)
    pos = torch.arange(length + 1, device=device)[None, :]
    shifted = torch.cat([targets, torch.zeros((b, 1), dtype=torch.long, device=device)], dim=1)
    labels = torch.where(pos == lengths, sp.eos_id, shifted)
    valid = (pos <= lengths).float()
    logp = F.log_softmax(model(_tensor(images, device, torch.float32), inputs), dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def make_transformer_train_step(model, optimizer: ClipAdamW):
    """``step(state, images, targets, target_lengths, lr_scale=1.0)``."""
    def train_step(state: TrainState, images, targets, target_lengths, lr_scale: float = 1.0):
        return _apply_step(model, optimizer, state,
                           lambda: transformer_loss_fn(model, images, targets, target_lengths),
                           lr_scale)

    return train_step


# ----------------------------------------------------------------------
# Character LM
def lm_loss_fn(model, tokens) -> torch.Tensor:
    """Next-token NLL over (B, T) sequences; position t predicts t+1."""
    tokens = _tensor(tokens, _device_of(model), torch.long)
    logprobs = sequence_logprobs(model, tokens[:, :-1])
    return -logprobs.gather(-1, tokens[:, 1:, None]).mean()


def make_lm_train_step(model, optimizer: ClipAdamW):
    """``step(state, tokens, lr_scale=1.0)``."""
    def train_step(state: TrainState, tokens, lr_scale: float = 1.0):
        return _apply_step(model, optimizer, state, lambda: lm_loss_fn(model, tokens), lr_scale)

    return train_step


def export_lm_checkpoint(model, path: str) -> None:
    """Write the LM as ``decoding/itf.py``'s ``construct_lm`` loads it
    (both packages'): the flax msgpack at ``path`` and its sidecar spec
    at ``path + ".json"``."""
    checkpoint.save_variables(convert.charlm_params_to_flax(model), path)
    with open(path + ".json", "w", encoding="utf8") as f:
        json.dump(dataclasses.asdict(model.spec), f)
