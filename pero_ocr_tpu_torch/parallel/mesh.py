"""Device mesh and sharding rules (port of pero_ocr_tpu/parallel/mesh.py).

The JAX package scales out over a ``jax.sharding.Mesh`` with two axes:

- ``dp`` (data): page batches and training batches split over it; pages
  are independent, so serving needs no collective;
- ``tp`` (tensor): the feature axis of the large convolution, dense and
  LSTM kernels is split over it.

Here a :class:`Mesh` is the same (dp, tp) array of ``torch.device``.
The page pipeline runs one replica of its models on each dp row's first
device in one process (``TorchPagePipeline(mesh=...)``).  The trainer
runs in a ``torch.distributed`` group of dp * tp ranks, one a mesh
position (:func:`device_mesh`); its weights and Adam moments are stored
split over tp as :func:`shard_axes` says.  cuDNN's convolutions
and ``nn.LSTM`` take no split weights, so a step computes on the weights
gathered over tp: tp splits their storage, not the arithmetic.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

AXES = ("dp", "tp")


class Mesh:
    """A (dp, tp) array of ``torch.device`` named ("dp", "tp"), the
    counterpart of ``jax.sharding.Mesh(device_array, ("dp", "tp"))``.

    A device may appear more than once.  The CPU is one torch device, so
    a mesh of N CPU positions puts N replicas on it, as the JAX tests put
    8 virtual CPU devices on one host; on the card, ``[[cuda:0],
    [cuda:0]]`` runs two dp shards on one GPU."""

    def __init__(self, devices: Sequence[Sequence]):
        rows = [[indexed_device(torch.device(d)) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh needs a non-empty (dp, tp) array of devices")
        if len({d.type for row in rows for d in row}) != 1:
            raise ValueError("a mesh's devices must be of one type")
        self.devices = np.array(rows, dtype=object)
        self.axis_names = AXES
        self._device_mesh = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.devices.shape[0], "tp": self.devices.shape[1]}

    @property
    def device_type(self) -> str:
        return self.devices[0, 0].type

    @property
    def dp_devices(self) -> List[torch.device]:
        """Each dp row's first device: where its shard of a page batch
        runs."""
        return [row[0] for row in self.devices]

    def __repr__(self) -> str:
        return f"Mesh({self.devices.tolist()}, axis_names={self.axis_names})"


def indexed_device(device: torch.device) -> torch.device:
    """``cuda`` as the current CUDA device with its index, so that it
    compares equal to a tensor's device."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _devices(n_devices: Optional[int], device_type: str) -> List[torch.device]:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device_type='cpu' for a "
                               "mesh of CPU replicas")
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        n = len(visible) if n_devices is None else n_devices
        if n > len(visible):
            raise ValueError(f"n_devices={n} but only {len(visible)} device(s) visible")
        return visible[:n]
    if device_type == "cpu":
        return [torch.device("cpu")] * (1 if n_devices is None else n_devices)
    raise ValueError(f"unsupported device_type {device_type!r}")


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              device_type: Optional[str] = None) -> Mesh:
    """A (dp, tp) mesh over the first ``n_devices`` CUDA devices (all of
    them by default), or over ``n_devices`` CPU replicas with
    ``device_type="cpu"`` (one by default)."""
    device_type = device_type or "cuda"
    if n_devices is None:
        n_devices = len(_devices(None, device_type))
    if n_devices % tp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by tp={tp}")
    devices = _devices(n_devices, device_type)
    dp = n_devices // tp
    return Mesh([devices[i * tp:(i + 1) * tp] for i in range(dp)])


def auto_mesh(n_devices: Optional[int] = None, device_type: Optional[str] = None) -> Mesh:
    """Default topology: tp=2 from 4 devices up (an even count), else pure
    dp."""
    n = n_devices if n_devices is not None else len(_devices(None, device_type or "cuda"))
    tp = 2 if n >= 4 and n % 2 == 0 else 1
    return make_mesh(n, tp=tp, device_type=device_type)


def _placements():
    from torch.distributed.tensor import Replicate, Shard

    return Replicate, Shard


def batch_sharding(mesh: Mesh):
    """The leading (batch) axis split over dp, replicated over tp: the
    ``torch.distributed.tensor`` placements, one a mesh axis."""
    replicate, shard = _placements()
    return (shard(0), replicate())


def replicated(mesh: Mesh):
    replicate, _ = _placements()
    return (replicate(), replicate())


def _flax_last_axis(module: nn.Module, name: str, weight: torch.Tensor):
    """(the torch axis that holds the last axis of the flax kernels this
    weight maps to in ``utils/convert.py``, that axis's size in flax);
    None for a weight whose flax leaves are 1-D."""
    if weight.ndim < 2:
        return None
    if isinstance(module, (nn.Conv1d, nn.Conv2d)):
        return 0, weight.shape[0]  # (out, in, k...) -> (k..., in, out)
    if isinstance(module, nn.ConvTranspose2d):
        return 1, weight.shape[1]  # (in, out, k, k) -> (k, k, in, out)
    if isinstance(module, nn.Linear):
        return 0, weight.shape[0]  # (out, in) -> (in, out)
    if isinstance(module, nn.Embedding):
        return 1, weight.shape[1]  # (num, features) as in flax
    if isinstance(module, (nn.LSTM, nn.GRU)):
        # (gates * H, in) -> one (in, H) kernel a gate
        gates = 4 if isinstance(module, nn.LSTM) else 3
        return 0, weight.shape[0] // gates
    raise ValueError(f"param_sharding_rules: no flax layout known for {name} "
                     f"({type(module).__name__})")


def shard_axes(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """Per parameter name, the torch axis split over tp, or None where the
    weight is replicated.  JAX's rule on the flax leaves: the last axis
    of a kernel of 2 or more dims, where it is divisible by tp and at
    least 2 * tp; decided on the flax shape each weight maps to."""
    tp = mesh.shape["tp"]
    out: Dict[str, Optional[int]] = {}
    for prefix, module in model.named_modules():
        for local, weight in module.named_parameters(recurse=False):
            name = f"{prefix}.{local}" if prefix else local
            rule = _flax_last_axis(module, name, weight)
            axis = None
            if rule is not None and tp > 1:
                torch_axis, size = rule
                if size % tp == 0 and size >= 2 * tp:
                    axis = torch_axis
            out[name] = axis
    return out


def param_sharding_rules(model: nn.Module, mesh: Mesh):
    """:func:`shard_axes` as ``torch.distributed.tensor`` placements, the
    counterpart of JAX's rules: per parameter name of ``model``,
    ``(Replicate(), Shard(axis))`` where it is split over tp, else
    ``(Replicate(), Replicate())``."""
    replicate, shard = _placements()
    return {name: (replicate(), replicate() if axis is None else shard(axis))
            for name, axis in shard_axes(model, mesh).items()}


def device_mesh(mesh: Mesh):
    """The ``init_device_mesh`` over the default process group, shaped
    and named as ``mesh``, made once a mesh.  The group must hold dp * tp
    ranks; rank r takes mesh position (r // tp, r % tp)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if mesh._device_mesh is None:
        if not dist.is_initialized():
            raise RuntimeError("device_mesh needs torch.distributed.init_process_group first")
        size = mesh.shape["dp"] * mesh.shape["tp"]
        if dist.get_world_size() != size:
            raise ValueError(f"the process group has {dist.get_world_size()} ranks; the mesh "
                             f"{mesh.shape} needs {size}")
        mesh._device_mesh = init_device_mesh(
            mesh.device_type, (mesh.shape["dp"], mesh.shape["tp"]), mesh_dim_names=AXES)
    return mesh._device_mesh
