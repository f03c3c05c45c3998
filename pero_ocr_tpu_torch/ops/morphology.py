"""Map post-processing ops (port of pero_ocr_tpu/ops/morphology.py).

Grey dilation and vertical non-maxima suppression are window max
filters with lax ``'SAME'`` (-inf) padding; the box smooth is a
separable mean filter with zero padding.  All take (..., H, W) tensors.
Connected-component labeling stays on the host (the port's C++ or
scipy).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pero_ocr_tpu_torch.models.parsenet import same_pads
from pero_ocr_tpu_torch.utils import native as native_lib


def _as_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1, 1) + tuple(x.shape[-2:]))


def _max_window(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """Max filter with a (wh, ww) window, SAME padding."""
    ph = same_pads(x.shape[-2], wh, 1)
    pw = same_pads(x.shape[-1], ww, 1)
    y = F.pad(_as_nchw(x), (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(y, (wh, ww), 1).reshape(x.shape)


def grey_dilation(x: torch.Tensor, size_h: int = 7, size_w: int = 9) -> torch.Tensor:
    return _max_window(x, size_h, size_w)


def _box_1d(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """SAME zero-padded mean over ``size`` taps along ``dim``, summed as
    XLA's convolution sums: each tap times 1/size, added left to right,
    every step rounded (a library conv rounds otherwise, and the NMS
    equality test downstream flips on a one-ulp difference)."""
    k = torch.tensor(1.0, dtype=torch.float32) / size
    lo, hi = same_pads(x.shape[dim], size, 1)
    pads = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [lo, hi]
    xp = F.pad(x, pads)
    n = x.shape[dim]
    out = xp.narrow(dim, 0, n) * k
    for i in range(1, size):
        out = out + xp.narrow(dim, i, n) * k
    return out


def box_smooth(x: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Mean filter, horizontal then vertical (SAME, zero padding)."""
    return _box_1d(_box_1d(x.float(), size, -1), size, -2)


def vertical_nonmaxima_suppression(x: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Keep values that are the maximum of their vertical (window, 1)
    neighbourhood, zero elsewhere."""
    return torch.where(x == _max_window(x, window, 1), x, 0.0)


def connected_components(mask: np.ndarray, native: bool = False):
    """Host-side 8-connected component labeling: (labels, count).
    ``native``: the port's C++ (``cc_label_u8``), which numbers the
    components as scipy does; else scipy."""
    if native:
        return native_lib.native_label(mask)
    from scipy import ndimage

    return ndimage.label(np.asarray(mask), structure=np.ones((3, 3)))
