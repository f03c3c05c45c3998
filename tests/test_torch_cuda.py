"""Tests of the port's hand-written kernels that need an NVIDIA GPU and
nvcc (marker ``cuda``).  They skip where there is no card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine does not have.)"""

import numpy as np
import pytest
import torch

from pero_ocr_tpu_torch.core.line_geometry import resample_baseline
from pero_ocr_tpu_torch.ops import warp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _lines(rng, n, h, w, p=16):
    bls = np.zeros((n, p, 2), np.float32)
    hs = np.ones((n, 2), np.float32)
    for i in range(n):
        kind = i % 5
        if kind == 4:
            continue  # a padded slot
        x = np.linspace(rng.uniform(10, w / 4), rng.uniform(w / 2, w - 10), 12)
        y = np.full_like(x, rng.uniform(30, h - 30))
        if kind == 1:
            y += rng.uniform(3, 10) * np.sin(x / rng.uniform(30, 90))
        elif kind == 2:
            y += np.tan(np.radians(rng.choice([-10, 10]))) * (x - x[0])
        elif kind == 3:
            x = x + 0.6 * w
        bls[i] = resample_baseline(np.stack([x, y], 1), p)
        hs[i] = (rng.uniform(8, 24), rng.uniform(3, 8))
    return bls, hs


@pytest.mark.parametrize("pb,n,crop_h,bucket", [(1, 5, 16, 128), (3, 10, 32, 512)])
def test_warp_kernel_matches_plain(cuda, pb, n, crop_h, bucket):
    """Both do the same correctly rounded float32 steps in the same
    order: equal to 1e-3 gray levels, except at most one validity
    boundary column per line."""
    rng = np.random.default_rng(pb * n)
    h, w = 300, 700
    pages = torch.from_numpy(rng.integers(0, 256, (pb, h, w), dtype=np.uint8)).to(cuda)
    geo = [_lines(rng, n, h, w) for _ in range(pb)]
    bl = torch.from_numpy(np.stack([g[0] for g in geo])).to(cuda)
    hh = torch.from_numpy(np.stack([g[1] for g in geo])).to(cuda)
    before = warp.warp_lines.launches
    got = warp.warp_lines(pages, bl, hh, crop_h, bucket)
    want = warp.warp_lines_plain(pages, bl, hh, crop_h, bucket)
    torch.cuda.synchronize()
    assert warp.warp_lines.launches == before + 1
    assert got.shape == (pb * n, crop_h, bucket) and got.dtype == torch.float32
    bad_cols = ((got - want).abs() > 1e-3).any(dim=1).sum(dim=1)
    assert int(bad_cols.max()) <= 1


def test_warp_kernel_rejects_bad_inputs(cuda):
    pages = torch.zeros((1, 32, 32), dtype=torch.uint8, device=cuda)
    bl = torch.zeros((1, 2, 16, 2), device=cuda)
    with pytest.raises(ValueError, match="heights"):
        warp.warp_lines(pages, bl, torch.ones((1, 2, 2), device=cuda, dtype=torch.float64), 8, 16)
    with pytest.raises(ValueError, match="disagree"):
        warp.warp_lines(pages, bl, torch.ones((1, 3, 2), device=cuda), 8, 16)
