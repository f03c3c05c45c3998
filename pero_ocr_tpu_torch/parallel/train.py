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
is not ported: they raise.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pero_ocr_tpu_torch import SCALE_OUT, not_ported, resolve_device
from pero_ocr_tpu_torch.models.charlm import sequence_logprobs
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer
from pero_ocr_tpu_torch.parallel.optim import ClipAdamW
from pero_ocr_tpu_torch.utils import checkpoint, convert

_FROZEN = re.compile(r"bias_ih_l\d+(_reverse)?")


@dataclasses.dataclass
class TrainState:
    """The JAX ``TrainState``: ``params`` the float32 weights by
    state-dict name (see the module docstring), ``opt_state`` the
    optimizer's, ``step`` the steps taken.  ``targets`` holds, weight
    for weight, the module parameter each one trains."""

    params: Dict[str, torch.Tensor]
    opt_state: object
    step: int
    targets: List[nn.Parameter]


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
    return TrainState(params, optimizer.init(list(params.values())), 0, targets)


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
    return [torch.zeros_like(w) if p.grad is None else p.grad.float()
            for w, p in zip(state.params.values(), state.targets)]


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


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _tensor(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


# ----------------------------------------------------------------------
# CTC recognizer
def ctc_loss_fn(model, images, labels, label_lengths) -> torch.Tensor:
    """Mean CTC loss of (B, H, W, 3) images against (B, S) labels of
    ``label_lengths``; blank is the last class."""
    device = _device_of(model)
    logits = model(_tensor(images, device, torch.float32))
    b, t, c = logits.shape
    log_probs = F.log_softmax(logits, dim=-1).transpose(0, 1)
    per_seq = F.ctc_loss(
        log_probs, _tensor(labels, device, torch.long),
        torch.full((b,), t, dtype=torch.long, device=device),
        _tensor(label_lengths, device, torch.long),
        blank=c - 1, reduction="none", zero_infinity=True,
    )
    return per_seq.mean()


def make_train_step(model, optimizer: ClipAdamW):
    """``step(state, images, labels, label_lengths, lr_scale=1.0)``."""
    def train_step(state: TrainState, images, labels, label_lengths, lr_scale: float = 1.0):
        return _apply_step(model, optimizer, state,
                           lambda: ctc_loss_fn(model, images, labels, label_lengths), lr_scale)

    return train_step


def shard_train_state(state, mesh):
    raise not_ported("shard_train_state (the dp/tp mesh)", SCALE_OUT)


def make_sharded_train_step(model, optimizer, mesh):
    raise not_ported("make_sharded_train_step (the dp/tp mesh)", SCALE_OUT)


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
