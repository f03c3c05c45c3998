"""Parity of the port's device ops (pero_ocr_tpu_torch) with the JAX
package on the CPU, on the same numpy-seeded inputs.

- Map post-processing and the stage-A packing of mask, heights_q and
  sep_q: byte-exact against ``_postprocess_maps`` + the pipeline's
  ``maps_and_pack`` on identical maps.  The box smooth sums its taps in
  XLA's order, so the NMS equality test sees the same values and no tie
  flips.
- The warp's plain version against ``build_fields_device`` +
  ``warp_lines_xla`` (the Pallas kernel's own fallback): max abs <= 0.05
  gray levels, apart from at most one validity-boundary column per line;
  with ``normalize=True`` against the same crops ``/ 255.0`` and cast,
  to 0.05 / 255 plus one ulp of the output type.  The arguments both
  paths refuse, and the footprint byte count of the bound.
- Greedy CTC: labels and lengths equal, confidences within 1e-6.
- ``_gray`` against ``cv2.cvtColor``, and the 4-bit transport packing:
  exact.
"""

import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pero_ocr_tpu.ops import ctc as jax_ctc
from pero_ocr_tpu.ops import warp as jax_warp
from pero_ocr_tpu.parallel.pipeline import TPUPagePipeline
from pero_ocr_tpu_torch.ops import ctc
from pero_ocr_tpu_torch.ops import warp
from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline
from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec

WARP_TOL = 0.05
FIELD_TOL_PX = 5e-3
SMOOTH_GRADIENT = 16.0


# ----------------------------------------------------------------------
# Stage A: post-processing and packing on identical maps.

class _FixedMaps:
    """A detector stand-in that returns given maps (JAX side)."""

    out_upsample = 1

    def __init__(self, maps):
        self.maps = jnp.asarray(maps)

    def apply(self, variables, images):
        return self.maps


class _FixedMapsTorch(torch.nn.Module):
    out_upsample = 1

    def __init__(self, maps):
        super().__init__()
        self.maps = torch.from_numpy(maps)

    def forward(self, images):
        return self.maps


def _tiny_recognizers():
    spec = dict(num_classes=6, line_height=16, conv_features=(4, 8),
                subsampling=4, lstm_layers=1, lstm_features=8)
    from pero_ocr_tpu.models.recognizer import (
        CTCRecognizer as FlaxRec, RecognizerSpec as FlaxSpec,
    )
    return FlaxRec(FlaxSpec(**spec)), CTCRecognizer(RecognizerSpec(**spec))


def _maps(kind, pb, h, w, seed):
    rng = np.random.default_rng(seed)
    maps = np.zeros((pb, h, w, 5), np.float32)
    maps[..., :2] = rng.gamma(2.0, 3.0, (pb, h, w, 2))
    maps[..., 2:] = rng.random((pb, h, w, 3), np.float32)
    if kind == "lines":
        # Text-line-like plateaus: one-row baselines of constant
        # probability (the smooth of a plateau gives exact ties across
        # rows), endpoints at the line ends, quantized heights.
        maps[..., 2:4] *= 0.05
        for p in range(pb):
            for y in range(6, h - 6, 11):
                x0, x1 = rng.integers(2, w // 3), rng.integers(w // 2, w - 2)
                maps[p, y, x0:x1, 2] = rng.choice([0.9, 0.75, 0.6])
                maps[p, y, [x0, x1 - 1], 3] = 0.8
        maps[..., :2] = np.round(maps[..., :2] * 2) / 2
    return maps


@pytest.mark.parametrize("kind,h", [("random", 64), ("lines", 64), ("lines", 704)])
def test_stage_a_packing_matches_jax(kind, h):
    """packed mask, heights_q, sep_q vs the JAX maps_and_pack; h=704
    takes the doubled pool factors (map height > 640)."""
    pb, w = 2, 128
    maps = _maps(kind, pb, h, w, seed=h)
    frec, trec = _tiny_recognizers()
    jpipe = TPUPagePipeline(
        _FixedMaps(maps), None, frec, None, transport="crops",
        cluster_paragraphs=False,
    )
    want = jax.tree_util.tree_map(
        np.asarray, jpipe._stage_a_small(jnp.zeros((pb, h, w), jnp.uint8))
    )
    tpipe = TorchPagePipeline(_FixedMapsTorch(maps), trec, device="cpu")
    got = [t.numpy() for t in tpipe.maps_and_pack(torch.zeros((pb, h, w)))]
    for g, e in zip(got, want):
        assert g.shape == e.shape and g.dtype == e.dtype
    for g, e in zip(got, want):  # packed mask, heights_q, sep_q
        np.testing.assert_array_equal(g, e)
    assert np.unpackbits(want[0]).sum() > 0


def test_postprocess_maps_matches_jax():
    from pero_ocr_tpu.layout_engines.cnn_engine import _postprocess_maps
    from pero_ocr_tpu_torch.layout_engines.cnn_engine import postprocess_maps

    maps = _maps("lines", 2, 96, 80, seed=3)
    got = postprocess_maps(torch.from_numpy(maps), 0.2, 1.0)
    for p in range(2):
        mask, _, heights, sep = _postprocess_maps(
            jnp.asarray(maps[p]), 0.2, 1.0, connected=False
        )
        np.testing.assert_array_equal(got[0][p].numpy(), np.asarray(mask))
        np.testing.assert_array_equal(got[1][p].numpy(), np.asarray(heights))
        np.testing.assert_array_equal(got[2][p].numpy(), np.asarray(sep))


def test_unpack_stage_a_matches_jax():
    """Host side of the artifacts, the (5, 3) dilation included; the
    separator stays pooled, as the JAX artifacts' ``sep_pooled``, and
    repeats to JAX's map-resolution separator."""
    rng = np.random.default_rng(4)
    packed = rng.integers(0, 256, (2, 64, 16), dtype=np.uint8)
    packed[packed > 40] = 0  # sparse mask
    heights_q = rng.integers(0, 256, (2, 16, 32, 2), dtype=np.uint8)
    sep_q = rng.integers(0, 256, (2, 32, 32), dtype=np.uint8)
    frec, trec = _tiny_recognizers()
    jpipe = TPUPagePipeline(None, None, frec, None, cluster_paragraphs=False)
    tpipe = TorchPagePipeline(_FixedMapsTorch(np.zeros(1, np.float32)), trec, device="cpu")
    got = tpipe._unpack_stage_a(packed, heights_q, sep_q)
    want = jpipe._unpack_stage_a(packed, heights_q, sep_q)
    for g, e in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, e)
    pooled, pool = TPUPagePipeline._StageAArtifacts(packed, heights_q, sep_q, jpipe).sep_pooled
    np.testing.assert_array_equal(got[3], pooled)
    assert packed.shape[1] // got[3].shape[1] == pool == 2
    np.testing.assert_array_equal(got[3].repeat(pool, axis=1).repeat(pool, axis=2), want[3])


# ----------------------------------------------------------------------
# The line-crop warp.

def _line_geometry(kind, rng, h, w, p=16):
    x = np.linspace(rng.uniform(20, w / 4), rng.uniform(w / 2, w - 20), p)
    y0 = rng.uniform(40, h - 40)
    if kind == "straight":
        y = np.full(p, y0)
    elif kind == "curved":
        y = y0 + rng.uniform(4, 12) * np.sin(x / rng.uniform(40, 120))
    elif kind == "tilted":
        y = y0 + rng.choice([-1, 1]) * np.tan(np.radians(10)) * (x - x[0])
    elif kind == "off_page":
        x, y = x + 0.6 * w, np.full(p, h - 10.0)
    else:  # a padded slot
        return np.zeros((p, 2)), np.ones(2)
    return np.stack([x, y], 1), np.array([rng.uniform(10, 30), rng.uniform(3, 9)])


KINDS = ["straight", "curved", "tilted", "off_page", "padded"]


@functools.lru_cache(maxsize=None)
def _warp_case(kind):
    """A smooth page, six lines of ``kind``, and the JAX fields and
    crops (``build_fields_device`` + ``warp_lines_xla``) on them."""
    from scipy import ndimage

    rng = np.random.default_rng(sum(map(ord, kind)))
    h, w, crop_h, bucket, n = 1280, 1792, 32, 1024, 6
    page = ndimage.gaussian_filter(rng.random((h, w)), 8.0)
    page = ((page - page.min()) / np.ptp(page) * 255).astype(np.uint8)
    bl, hh = map(np.asarray, zip(*[_line_geometry(kind, rng, h, w) for _ in range(n)]))
    bl, hh = bl.astype(np.float32), hh.astype(np.float32)
    want_f = jax_warp.build_fields_device(jnp.asarray(bl), jnp.asarray(hh), crop_h, bucket)
    want = jax_warp.warp_lines_xla(jnp.asarray(page[:, :, None]), want_f)[..., 0]
    return page, bl, hh, crop_h, bucket, np.asarray(want_f), want


@pytest.mark.parametrize("kind", KINDS)
def test_warp_plain_matches_jax(kind):
    """The fields agree to FIELD_TOL_PX: the rotation and the lengths
    round a few ulps apart (one ulp near 1500 px is 1.2e-4 px) and the
    baseline normal amplifies that up to ~2 * crop height.  The crops
    then agree to WARP_TOL gray levels on a page whose gradient is at
    most SMOOTH_GRADIENT per px (on pure noise, up to 255 per px, the
    same coordinates give up to ~0.7)."""
    page, bl, hh, crop_h, bucket, want_f, want = _warp_case(kind)
    n = bl.shape[0]
    gy, gx = np.gradient(page.astype(np.float32))
    assert max(np.abs(gx).max(), np.abs(gy).max()) <= SMOOTH_GRADIENT

    got_f = warp.build_fields(torch.from_numpy(bl), torch.from_numpy(hh), crop_h, bucket).numpy()
    valid_j, valid_t = want_f[:, 0, :, 0] > -1e5, got_f[:, 0, :, 0] > -1e5
    assert (valid_j != valid_t).sum(axis=1).max() <= 1
    both = (valid_j & valid_t)[:, None, :, None]
    assert np.abs(np.where(both, got_f - want_f, 0)).max() <= FIELD_TOL_PX

    want = np.asarray(want)
    got = warp.warp_lines(
        torch.from_numpy(page[None]), torch.from_numpy(bl[None]),
        torch.from_numpy(hh[None]), crop_h, bucket,
    ).numpy()
    assert got.shape == want.shape == (n, crop_h, bucket)
    bad_cols = (np.abs(got - want) > WARP_TOL).any(axis=1).sum(axis=1)
    assert bad_cols.max() <= 1, bad_cols
    if kind == "padded":
        assert (valid_j.sum(axis=1) == 1).all()  # t = 0 <= arc 0 at column 0
    else:
        assert valid_j.sum(axis=1).min() > 100


def _ulp(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """One unit in the last place of ``dtype`` at |x| (bfloat16 keeps 16
    fewer mantissa bits than float32)."""
    ulp32 = np.spacing(np.abs(x).astype(np.float32))
    return ulp32 * (2.0 ** 16 if dtype == torch.bfloat16 else 1.0)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_warp_plain_normalized_matches_jax(kind, out_dtype):
    """``normalize=True`` against what the JAX pipeline feeds its
    recognizer: ``warp_lines_xla`` crops, ``/ 255.0``, then the cast.
    Tolerance: WARP_TOL gray levels (over 255) for the fields' few-ulp
    differences (test_warp_plain_matches_jax), plus one ulp of the
    output type, since two values that close may round to neighbouring
    bf16 values.  At most one column per line may differ beyond that:
    the validity test t <= arc length decided one ulp apart switches a
    whole boundary column between the page and 0."""
    page, bl, hh, crop_h, bucket, _, want = _warp_case(kind)
    want = np.asarray((want / 255.0).astype(jnp.dtype(str(out_dtype).split(".")[1])),
                      np.float32)
    got = warp.warp_lines(
        torch.from_numpy(page[None]), torch.from_numpy(bl[None]),
        torch.from_numpy(hh[None]), crop_h, bucket, out_dtype=out_dtype, normalize=True,
    )
    assert got.dtype == out_dtype and got.shape == want.shape
    got = got.float().numpy()
    assert 0.0 <= got.min() and got.max() <= 1.0
    tol = WARP_TOL / 255.0 + _ulp(np.maximum(np.abs(got), np.abs(want)), out_dtype)
    bad_cols = (np.abs(got - want) > tol).any(axis=1).sum(axis=1)
    assert bad_cols.max() <= 1, bad_cols


def test_warp_normalized_store_is_one_rounding():
    """normalize=True stores out_dtype(v / 255) with v the float32 crop:
    a true float32 division, then one rounding to nearest even."""
    page, bl, hh, crop_h, bucket, _, _ = _warp_case("curved")
    args = (torch.from_numpy(page[None]), torch.from_numpy(bl[None]),
            torch.from_numpy(hh[None]), crop_h, bucket)
    raw = warp.warp_lines(*args)
    for dtype in (torch.float32, torch.bfloat16):
        got = warp.warp_lines(*args, out_dtype=dtype, normalize=True)
        assert torch.equal(got, (raw / 255.0).to(dtype))
        assert torch.equal(warp.warp_lines(*args, out_dtype=dtype), raw.to(dtype))


def test_div255_is_correctly_rounded():
    """The kernel stores v / 255 by a multiply and Markstein's
    correction instead of a division: it equals the IEEE division on
    every 61st float32 in [0, 255] here (every one in
    tests/test_torch_cuda.py, on the card)."""
    from test_torch_cuda import div255_markstein, float32s

    n = 0
    for a in float32s(0.0, 255.0, stride=61, chunk=1 << 23):
        got, midpoints = div255_markstein(a)
        want = a / torch.full_like(a, 255.0)
        assert midpoints == 0
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        n += a.numel()
    assert n > 18_000_000


@pytest.mark.parametrize("change,match", [
    ({"crop_h": 65}, "crop_h"),
    ({"bucket": 1}, "bucket"),
    ({"out_dtype": torch.float16}, "out_dtype"),
    ({"out_dtype": torch.uint8}, "out_dtype"),
    ({"normalize": 1}, "normalize"),
    ({"heights": torch.ones((1, 2, 2), dtype=torch.float64)}, "heights"),
    ({"baselines": torch.zeros((1, 2, 65, 2))}, "points"),
    ({"pages": torch.zeros((1, 32, 32))}, "pages"),
])
def test_warp_lines_rejects_unsupported_arguments(change, match):
    """Both paths take what the kernel takes: crop_h <= 64 (its shared
    row table), 2..64 baseline points, float32 or bfloat16 out."""
    args = dict(pages=torch.zeros((1, 32, 32), dtype=torch.uint8),
                baselines=torch.zeros((1, 2, 16, 2)), heights=torch.ones((1, 2, 2)),
                crop_h=8, bucket=16, out_dtype=torch.float32, normalize=False)
    assert warp.warp_lines(**args).shape == (2, 8, 16)
    with pytest.raises(ValueError, match=match):
        warp.warp_lines(**{**args, **change})


def test_warp_lines_bytes_counts_touched_pixels():
    """The page bytes are the distinct pixels the valid columns' four
    taps touch, counted here by brute force over the fields."""
    rng = np.random.default_rng(11)
    pb, n, h, w, crop_h, bucket = 2, 5, 120, 160, 8, 64
    bls, hs = [], []
    for _ in range(pb):
        g = [_line_geometry(k, rng, h, w) for k in ("straight", "tilted", "off_page",
                                                    "curved", "padded")]
        bls.append(np.stack([b for b, _ in g]))
        hs.append(np.stack([x for _, x in g]))
    bl = torch.from_numpy(np.stack(bls).astype(np.float32))
    hh = torch.from_numpy(np.stack(hs).astype(np.float32))
    pages = torch.zeros((pb, h, w), dtype=torch.uint8)
    fields = warp.build_fields(bl.reshape(-1, 16, 2), hh.reshape(-1, 2), crop_h, bucket)
    f = fields.reshape(pb, n, crop_h, bucket, 2).numpy()
    touched = set()
    for i, line, r, j in zip(*np.nonzero(f[..., 0] > warp.OFF_PAGE / 2)):
        x0, y0 = (int(np.floor(c)) for c in f[i, line, r, j])
        for y in (y0, y0 + 1):
            for x in (x0, x0 + 1):
                if 0 <= y < h and 0 <= x < w:
                    touched.add((i, y, x))
    geometry = bl.numel() * 4 + hh.numel() * 4
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        want = len(touched) + geometry + pb * n * crop_h * bucket * size
        assert warp.warp_lines_bytes(pages, bl, hh, crop_h, bucket, dtype) == want
        assert warp.warp_lines_bytes(pages, bl, hh, crop_h, bucket, dtype, fields) == want
    assert 0 < len(touched) < pb * h * w


def test_warp_lines_validates_cuda_inputs():
    """A tensor that is neither on the CPU nor on CUDA is refused."""
    meta = torch.empty((1, 8, 8), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        warp.warp_lines(meta, torch.zeros(1, 1, 16, 2), torch.ones(1, 1, 2), 8, 16)


# ----------------------------------------------------------------------
# Greedy CTC.

@pytest.mark.parametrize("quantized", [False, True])
def test_greedy_ctc_matches_jax(quantized):
    rng = np.random.default_rng(5 + quantized)
    b, t, c = 12, 40, 7
    logits = rng.standard_normal((b, t, c)).astype(np.float32) * 3
    if quantized:  # argmax ties: the first maximum wins on both sides
        logits = np.round(logits)
    valid = rng.integers(0, t + 1, b).astype(np.int32)
    valid[:2] = (0, t)
    jl, jn = jax_ctc.greedy_ctc_labels(jnp.asarray(logits), jnp.asarray(valid))
    jc = jax_ctc.greedy_worst_run_confidence(jnp.asarray(logits), jnp.asarray(valid))
    tl, tn = ctc.greedy_ctc_labels(torch.from_numpy(logits), torch.from_numpy(valid))
    tc = ctc.greedy_worst_run_confidence(torch.from_numpy(logits), torch.from_numpy(valid))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    assert tc[0] == 1.0  # no valid frame
    chars = list("abcdef") + ["​"]
    assert ctc.labels_to_strings(tl.numpy(), tn.numpy(), chars) == \
        jax_ctc.labels_to_strings(np.asarray(jl), np.asarray(jn), chars)


# ----------------------------------------------------------------------
# Host transport helpers.

def test_gray_matches_cv2():
    rng = np.random.default_rng(6)
    page = rng.integers(0, 256, (97, 131, 3), dtype=np.uint8)
    page[0, :8] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0],
                   [0, 0, 255], [1, 2, 3], [254, 128, 7], [128, 128, 128]]
    np.testing.assert_array_equal(
        TorchPagePipeline._gray(page), cv2.cvtColor(page, cv2.COLOR_BGR2GRAY)
    )
    assert TorchPagePipeline._gray(page[:, :, 0]) is not None


@pytest.mark.parametrize("width", [130, 131])
def test_pack4_roundtrip_matches_jax(width):
    grays = np.random.default_rng(7).integers(0, 256, (2, 9, width), dtype=np.uint8)
    packed = TorchPagePipeline._pack4(grays)
    np.testing.assert_array_equal(packed, TPUPagePipeline._pack4(grays))
    unpacked = TorchPagePipeline.unpack4(torch.from_numpy(packed)).numpy()
    assert np.abs(unpacked[:, :, :width].astype(int) - grays).max() <= 9
    frec, _ = _tiny_recognizers()
    jpipe = TPUPagePipeline(None, None, frec, None, cluster_paragraphs=False)
    np.testing.assert_array_equal(unpacked, np.asarray(jpipe._unpack4(jnp.asarray(packed))))
