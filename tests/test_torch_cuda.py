"""Tests of the port's hand-written kernels that need an NVIDIA GPU and
nvcc (marker ``cuda``).  They skip where there is no card; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX, which the card's
machine does not have.)

The warp kernel and its plain version do the same correctly rounded
float32 steps in the same order, then the same division by 255 and one
rounding to the output type, so they are held to bit equality in the
output type.  The one exception allowed is a validity-boundary column
per line: the test t <= arc length switches a whole column between the
page and 0 when the two sides decide it one ulp apart.  The field warp
(``warp_fields``) has no such test and is held to bit equality
everywhere, in both stores."""

import copy
import os

import numpy as np
import pytest
import torch

from chip_smoke import random_fields
from pero_ocr_tpu_torch.core.line_geometry import resample_baseline, warp_field
from pero_ocr_tpu_torch.ops import warp

pytestmark = pytest.mark.cuda

# (out_dtype, normalize): the raw float32 crops, and the normalized store
# the pipeline uses in float32 and bfloat16.
MODES = {
    "f32_raw": (torch.float32, False),
    "f32_normalized": (torch.float32, True),
    "bf16_normalized": (torch.bfloat16, True),
}


# RN(1/255) in float32, the kernel's kRcp255 (0x3b808081).
RCP255 = float(np.float32(1) / np.float32(255))


def div255_markstein(a: torch.Tensor):
    """The kernel's division by 255 (``div255`` in csrc/warp_lines.cu),
    emulated exactly: q = RN(a * RN(1/255)); r = RN(a - 255 q), an FMA,
    so the exact remainder rounded once; result RN(q + r * RN(1/255)).
    Every product is exact in float64.  The last sum may round in
    float64, which can mislead the final rounding only where it lands on
    a float32 midpoint: returns the float32 results and the count of
    such midpoints."""
    y = torch.tensor(RCP255, dtype=torch.float64, device=a.device)
    a64 = a.double()
    q = (a64 * y).float()
    r = (a64 - 255.0 * q.double()).float()
    s = q.double() + r.double() * y
    out = s.float()
    up = torch.nextafter(out, torch.full_like(out, float("inf"))).double()
    down = torch.nextafter(out, torch.full_like(out, float("-inf"))).double()
    mid = (s == (out.double() + up) / 2) | (s == (out.double() + down) / 2)
    return out, int(mid.sum())


def float32s(lo: float, hi: float, stride: int = 1, chunk: int = 1 << 26):
    """Every ``stride``-th float32 in [lo, hi] (lo >= 0), in chunks."""
    first = int(np.float32(lo).view(np.int32))
    last = int(np.float32(hi).view(np.int32))
    for start in range(first, last + 1, stride * chunk):
        bits = torch.arange(start, min(start + stride * chunk, last + 1), stride,
                            dtype=torch.int32)
        yield bits.view(torch.float32)


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


def _bad_columns(got, want):
    """Per line, the number of columns where the two differ in any bit."""
    return (got.view(torch.int16 if got.dtype == torch.bfloat16 else torch.int32)
            != want.view(torch.int16 if want.dtype == torch.bfloat16 else torch.int32)
            ).any(dim=1).sum(dim=1)


def _check(pages, bl, hh, crop_h, bucket, mode):
    out_dtype, normalize = MODES[mode]
    before = warp.warp_lines.launches
    got = warp.warp_lines(pages, bl, hh, crop_h, bucket, out_dtype, normalize)
    assert warp.warp_lines.launches == before + 1
    want = warp.warp_lines_plain(pages, bl, hh, crop_h, bucket, out_dtype, normalize)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (bl.shape[0] * bl.shape[1], crop_h, bucket)
    assert got.dtype == out_dtype
    bad = _bad_columns(got, want)
    assert int(bad.max()) <= 1, bad.tolist()
    return got


@pytest.mark.parametrize("bucket", [512, 517])
@pytest.mark.parametrize("crop_h", [16, 32, 48])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_warp_kernel_matches_plain(cuda, mode, crop_h, bucket):
    """Mixed lines on three pages; bucket 517 is odd (the kernel's
    scalar tail column) and not a multiple of the 128-column tile."""
    rng = np.random.default_rng(crop_h * bucket)
    pb, n, h, w = 3, 10, 300, 700
    pages = torch.from_numpy(rng.integers(0, 256, (pb, h, w), dtype=np.uint8)).to(cuda)
    geo = [_lines(rng, n, h, w) for _ in range(pb)]
    bl = torch.from_numpy(np.stack([g[0] for g in geo])).to(cuda)
    hh = torch.from_numpy(np.stack([g[1] for g in geo])).to(cuda)
    got = _check(pages, bl, hh, crop_h, bucket, mode)
    if MODES[mode][1]:
        assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_warp_kernel_arc_ends_on_tile_edge(cuda, mode):
    """Lines whose last valid column is the last of a 128-column tile or
    the first of the next: the normal there reads the halo column that
    the neighbouring tile also computes.  Heights 24 + 8 over 32 rows
    make the scale 1, so the arc length in px is the last valid column."""
    rng = np.random.default_rng(3)
    h, w, crop_h, bucket = 200, 700, 32, 640
    arcs = [127.0, 127.5, 128.0, 128.25, 255.0, 256.0, 383.75, 384.0]
    bls = np.zeros((1, len(arcs), 16, 2), np.float32)
    for i, arc in enumerate(arcs):
        x0, y0 = 20.0 + 7 * i, 40.0 + 18 * i
        t = np.linspace(0.0, 1.0, 16)
        # A gentle bend: the normal differs column to column, and the
        # arc stays within 1e-3 px of the chord.
        pts = np.stack([x0 + arc * t, y0 + 0.05 * np.sin(np.pi * t)], 1)
        bls[0, i] = pts.astype(np.float32)
    hh = np.tile(np.array([24.0, 8.0], np.float32), (1, len(arcs), 1))
    pages = torch.from_numpy(rng.integers(0, 256, (1, h, w), dtype=np.uint8)).to(cuda)
    bl, hh = torch.from_numpy(bls).to(cuda), torch.from_numpy(hh).to(cuda)
    got = _check(pages, bl, hh, crop_h, bucket, mode).float()
    live = (got != 0).any(dim=1)
    last = torch.where(live, torch.arange(bucket, device=cuda), -1).max(dim=1).values
    # Each line's last sampled column lies within a column of its arc end.
    ends = torch.tensor(arcs, device=cuda)
    assert bool(((last - ends.floor()).abs() <= 1).all()), last.tolist()


def test_warp_kernel_rejects_bad_inputs(cuda):
    pages = torch.zeros((1, 32, 32), dtype=torch.uint8, device=cuda)
    bl = torch.zeros((1, 2, 16, 2), device=cuda)
    hh = torch.ones((1, 2, 2), device=cuda)
    with pytest.raises(ValueError, match="heights"):
        warp.warp_lines(pages, bl, hh.double(), 8, 16)
    with pytest.raises(ValueError, match="disagree"):
        warp.warp_lines(pages, bl, torch.ones((1, 3, 2), device=cuda), 8, 16)
    with pytest.raises(ValueError, match="crop_h"):
        warp.warp_lines(pages, bl, hh, 65, 16)
    with pytest.raises(ValueError, match="out_dtype"):
        warp.warp_lines(pages, bl, hh, 8, 16, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="on cuda"):
        warp.warp_lines(pages, bl.cpu(), hh, 8, 16)


def test_div255_is_correctly_rounded_everywhere(cuda):
    """The kernel's division by 255 equals the IEEE division for every
    float32 in [0, 255], the range of the blended values it divides."""
    n = 0
    for a in float32s(0.0, 255.0):
        a = a.to(cuda)
        got, midpoints = div255_markstein(a)
        want = a / torch.full_like(a, 255.0)
        assert midpoints == 0
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        n += a.numel()
    assert n == int(np.float32(255).view(np.int32)) + 1



@pytest.mark.parametrize("store", ["f32", "u8"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("page_dtype", ["u8", "f32"])
def test_warp_fields_kernel_matches_plain(cuda, store, channels, page_dtype):
    rng = np.random.default_rng(channels * 10 + len(store) + len(page_dtype))
    h, w = 300, 700
    page = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    if page_dtype == "f32":
        page = page.astype(np.float32) + rng.uniform(-0.5, 0.5, page.shape).astype(np.float32)
    fields = random_fields(rng, 12, 24, 517, h, w)
    # And the fields the stage-by-stage LineCropper builds, in a bucket.
    lines = [warp_field(np.stack([np.linspace(20, 600, 6), 40 + 20 * i + 3 * np.sin(
        np.arange(6.0))], 1), [14.0, 5.0], 24, poly=2) for i in range(12)]
    stacked = warp.pad_fields(lines, 1024)[0]
    for f in (fields, stacked):
        page_t, f_t = torch.from_numpy(page).to(cuda), torch.from_numpy(f).to(cuda)
        before = warp.warp_fields.launches
        got = warp.warp_fields(page_t, f_t, store)
        assert warp.warp_fields.launches == before + 1
        want = warp.warp_fields_plain(page_t, f_t, store)
        torch.cuda.synchronize()
        assert got.shape == want.shape == f.shape[:3] + (channels,)
        assert got.dtype == (torch.uint8 if store == "u8" else torch.float32)
        if store == "f32":
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            assert torch.equal(got, want)


def test_warp_fields_kernel_rejects_bad_inputs(cuda):
    page = torch.zeros((32, 32, 3), dtype=torch.uint8, device=cuda)
    fields = torch.zeros((2, 4, 8, 2), device=cuda)
    with pytest.raises(ValueError, match="1 or 3"):
        warp.warp_fields(page[:, :, :2].contiguous(), fields)
    with pytest.raises(ValueError, match="float32"):
        warp.warp_fields(page, fields.double())
    with pytest.raises(ValueError, match="one device"):
        warp.warp_fields(page, fields.cpu())
    with pytest.raises(ValueError, match="aligned"):  # a view one float into its storage
        warp.warp_fields(page, torch.zeros(66, device=cuda)[1:65].reshape(1, 4, 8, 2))
    assert warp.warp_fields(page, fields[:0]).shape == (0, 4, 8, 3)


# Buckets of one packed buffer for one warp call: odd sizes (Wb 1023,
# odd Hc), LineCropper's shape, and an odd total, so that the last warp
# is partly filled.
PACKED_SHAPES = [(3, 5, 1023), (12, 24, 517), (2, 32, 256), (1, 2, 5)]


def _edge_fields(h, w):
    """(1, 12, 2 w + 8, 2) fields on every half pixel from x = -2.5 to
    w + 1, on rows around the first and the last: the tap pairs that end
    on the page's last byte, the last column and the rows off the page."""
    xs = np.arange(-2.5, w + 1.5, 0.5)[: 2 * w + 8]
    ys = np.array([-1.5, -0.5, 0.0, 0.25, 1.0, h - 2.5, h - 2.0, h - 1.5, h - 1.0, h - 0.75,
                   h - 0.5, h + 0.5])
    return np.stack(np.broadcast_arrays(xs[None], ys[:, None]), -1)[None].astype(np.float32)


def _packed_inputs(rng, h, w):
    shapes = [(1, 12, 2 * w + 8)] + PACKED_SHAPES
    buffer = warp.field_buffer(shapes)
    views = warp.split_fields(buffer, shapes)
    views[0][...] = _edge_fields(h, w)
    for view, (n, hc, wb) in zip(views[1:], shapes[1:]):
        view[...] = random_fields(rng, n, hc, wb, h, w)
    return buffer, shapes


def _assert_bit_equal(got, want, store):
    assert got.shape == want.shape and got.dtype == want.dtype
    bits = torch.int32 if store == "f32" else torch.uint8
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("store", ["f32", "u8"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("page_dtype", ["u8", "f32"])
def test_warp_fields_packed_kernel_matches_plain(cuda, store, channels, page_dtype):
    """One launch over all the buckets of a packed buffer, bit-equal to
    the plain version bucket by bucket, the page's last row and column
    included."""
    rng = np.random.default_rng(100 + channels * 10 + len(store) + len(page_dtype))
    h, w = 301, 701
    page = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    if page_dtype == "f32":
        page = page.astype(np.float32) + rng.uniform(-0.5, 0.5, page.shape).astype(np.float32)
    buffer, shapes = _packed_inputs(rng, h, w)
    assert warp.field_layout(shapes)[1] % 2 == 1  # the last warp partly filled
    page_t = torch.from_numpy(page).to(cuda)
    packed = torch.from_numpy(buffer).to(cuda)
    before = warp.warp_fields.launches
    out = warp.warp_fields(page_t, packed.view(1, 1, -1, 2), store)
    assert warp.warp_fields.launches == before + 1
    for crop, view in zip(warp.split_fields(out.view(-1), shapes, channels),
                          warp.split_fields(packed, shapes)):
        _assert_bit_equal(crop, warp.warp_fields_plain(page_t, view, store), store)
    torch.cuda.synchronize()


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("page_dtype", ["u8", "f32"])
def test_warp_fields_unaligned_page_and_fields_match_plain(cuda, channels, page_dtype):
    """Fields only 8-byte aligned and a page one element into its storage:
    still bit-equal, in both stores."""
    rng = np.random.default_rng(200 + channels + len(page_dtype))
    h, w = 97, 131
    page = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    if page_dtype == "f32":
        page = page.astype(np.float32) + 0.375
    storage = torch.zeros(page.size + 1, dtype=torch.from_numpy(page).dtype, device=cuda)
    shifted = storage[1:].view(h, w, channels)
    shifted.copy_(torch.from_numpy(page))
    fields = np.concatenate([random_fields(rng, 3, 7, 61, h, w).reshape(-1, 2),
                             _edge_fields(h, w).reshape(-1, 2)])
    f_storage = torch.zeros(2 * len(fields) + 2, device=cuda)
    f_t = f_storage[2:].view(1, 1, len(fields), 2)
    f_t.copy_(torch.from_numpy(fields).view(1, 1, -1, 2))
    assert f_t.data_ptr() % 16 == 8
    for page_t in (shifted, shifted.clone()):
        for f in (f_t, f_t.clone()):
            for store in ("f32", "u8"):
                got = warp.warp_fields(page_t, f, store)
                _assert_bit_equal(got, warp.warp_fields_plain(page_t, f, store), store)
    torch.cuda.synchronize()


def test_warp_fields_packed_kernel_rejects_bad_inputs(cuda):
    page = torch.zeros((32, 32, 3), dtype=torch.uint8, device=cuda)
    total = warp.field_layout([(2, 4, 8), (1, 3, 5)])[1]
    packed = torch.zeros(2 * total, device=cuda).view(1, 1, -1, 2)
    before = warp.warp_fields.launches
    with pytest.raises(ValueError, match="aligned"):  # one float into its storage
        warp.warp_fields(page, torch.zeros(2 * total + 1, device=cuda)[1:].view(1, 1, -1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        warp.warp_fields(page, packed[:, :, ::2])
    with pytest.raises(ValueError, match="one device"):
        warp.warp_fields(page, packed.cpu())
    with pytest.raises(ValueError, match="one device"):
        warp.warp_fields(page.cpu(), packed)
    assert warp.warp_fields.launches == before
    empty = torch.from_numpy(warp.field_buffer([])).to(cuda).view(1, 1, -1, 2)
    assert warp.warp_fields(page, empty).shape == (1, 1, 0, 3)
    assert warp.warp_fields.launches == before


def test_warp_fields_kernel_on_a_page_past_int32(cuda):
    """A page of more than 2**31 values takes the kernel's 64-bit offsets:
    bit-equal to the plain version on samples all over it, its last rows
    and columns included (about 11 GB of card memory)."""
    h, w = 1 << 10, (1 << 21) + 3
    gen = torch.Generator(device=cuda).manual_seed(5)
    page = torch.randint(0, 256, (h, w, 1), dtype=torch.uint8, device=cuda, generator=gen)
    rng = np.random.default_rng(5)
    far = np.stack([rng.uniform(w - 6, w + 2, 4096), rng.uniform(h - 4, h + 1, 4096)], -1)
    corner = np.stack(np.meshgrid(np.arange(w - 3, w + 1.5, 0.5),
                                  np.arange(h - 3, h + 1.5, 0.5)), -1).reshape(-1, 2)
    fields = np.concatenate([random_fields(rng, 2, 8, 512, h, w).reshape(-1, 2), far,
                             corner]).astype(np.float32)
    f_t = torch.from_numpy(fields).to(cuda).view(1, 1, -1, 2)
    for store in ("f32", "u8"):
        _assert_bit_equal(warp.warp_fields(page, f_t, store),
                          warp.warp_fields_plain(page, f_t, store), store)
    torch.cuda.synchronize()


# ----------------------------------------------------------------------
# The host C++ on the card's path: the route follows the device.

def _tiny_pipeline(**kwargs):
    from pero_ocr_tpu_torch.models.parsenet import ParseNet
    from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
    from pero_ocr_tpu_torch.parallel.pipeline import TorchPagePipeline

    pn = ParseNet(base_features=4, depth=2, stem="s2d", out_upsample=2,
                  generator=torch.Generator().manual_seed(0))
    rec = CTCRecognizer(RecognizerSpec(num_classes=6, line_height=16, conv_features=(4, 8),
                                       lstm_layers=1, lstm_features=8),
                        generator=torch.Generator().manual_seed(1))
    return TorchPagePipeline(pn, rec, crop_height=16, crop_bucket=64, line_slot=4, **kwargs)


def test_cuda_takes_the_native_route(cuda):
    from pero_ocr_tpu_torch.layout_engines.cnn_engine import LayoutEngine
    from pero_ocr_tpu_torch.utils import native

    pipe = _tiny_pipeline(device="cuda")
    assert pipe.native and pipe._clusterer.native
    assert LayoutEngine(device="cuda").native and LayoutEngine().native
    assert not LayoutEngine(device="cpu").native
    pages = [np.random.default_rng(0).integers(0, 256, (128, 192, 3), dtype=np.uint8)] * 3
    calls = native.calls["cc_label_u8"]
    assert [r.page_index for r in pipe.run(pages, page_batch=2)] == [0, 1, 2]
    assert native.calls["cc_label_u8"] - calls == 3  # one a page
    with open("/proc/self/maps") as f:
        assert not any("native/libperotpu" in line for line in f)


def test_cuda_failed_host_build_raises(cuda, monkeypatch, tmp_path):
    from pero_ocr_tpu_torch.utils import kernels, native

    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(kernels, "_libraries", {})
    pipe = _tiny_pipeline(device="cuda")
    pages = [np.zeros((128, 192, 3), np.uint8)]
    calls = native.calls["cc_label_u8"]
    with pytest.raises(RuntimeError, match="compiler"):
        list(pipe.run(pages, page_batch=1))
    assert native.calls["cc_label_u8"] == calls


def test_config1_field_warp_matches_plain(cuda):
    """Config 1's crops: the classical detector's lines on a printed page
    (host code), their fields packed as LineCropper packs them, one
    warp_fields launch on the card, bit-equal to the plain version; and
    LineCropper on the card gives the CPU's crops."""
    import configparser

    from chip_smoke import printed_pages
    from pero_ocr_tpu_torch.core.layout import PageLayout
    from pero_ocr_tpu_torch.document.page_parser import (
        LineCropper, TextlineExtractorSimple, WholePageRegion,
    )

    page = printed_pages(np.random.default_rng(0), 1, 1400, 1000, 16)[0][0]
    config = configparser.ConfigParser()
    config.read_string("[L]\n[C]\nLINE_HEIGHT = 40\nLINE_SCALE = 1.0\n")
    crops = {}
    for device in ("cpu", "cuda"):
        layout = PageLayout(id="p", page_size=page.shape[:2])
        layout = WholePageRegion().process_page(page, layout)
        layout = TextlineExtractorSimple(config["L"]).process_page(page, layout)
        cropper = LineCropper(config["C"], device=device)
        before = warp.warp_fields.launches
        cropper.process_page(page, layout)
        assert warp.warp_fields.launches - before == (device == "cuda")
        crops[device] = [line.crop for line in layout.lines_iterator()]
    assert len(crops["cuda"]) == 16
    for a, b in zip(crops["cuda"], crops["cpu"]):
        np.testing.assert_array_equal(a, b)
    fields = [cropper.crop_engine.get_crop_inputs(ln.baseline, ln.heights, 40)
              for ln in layout.lines_iterator()]
    buffer, shapes, _, _ = cropper.pack_fields(fields)
    page_t = torch.from_numpy(page).cuda()
    packed = torch.from_numpy(buffer).cuda().view(1, 1, -1, 2)
    for store in warp.FIELD_STORES:
        got = warp.warp_fields(page_t, packed, store).view(-1)
        for out, f in zip(warp.split_fields(got, shapes, 3), warp.split_fields(buffer, shapes)):
            want = warp.warp_fields_plain(page_t, torch.from_numpy(f).cuda(), store)
            assert torch.equal(out.view(torch.uint8), want.view(torch.uint8))


def test_top_k_logits_on_the_card_match_cpu_topk(cuda):
    """Stage B's top-k on the card against torch.topk on the CPU of the
    same logits: values equal as sorted lists, index sets equal wherever
    the k-th logit is larger than the (k+1)-th, each index pointing at
    its value."""
    from chip_smoke import topk_check

    pipe = _tiny_pipeline(device="cuda", want_logits=True, logits_topk=3)
    rng = np.random.default_rng(1)
    pages = torch.from_numpy(rng.integers(0, 256, (2, 128, 192), dtype=np.uint8)).cuda()
    bl, hh = _lines(rng, 4, 128, 192)
    bl = torch.from_numpy(np.stack([bl, bl])).cuda()
    hh = torch.from_numpy(np.stack([hh, hh])).cuda()
    record = topk_check(pipe, (pages, bl, hh))
    assert record["k"] == 3 and record["frames"] > 0


# ----------------------------------------------------------------------
# The beam search with a character LM (config 3) on the card: no
# hand-written kernel, torch ops in a CUDA graph a decode shape.
BEAM_LETTERS = ["a", "b", "c", "d", "e", "\u200b"]


def _beam_decoders(cuda, cell_type):
    from pero_ocr_tpu_torch.decoding.tpu_decoder import TorchBeamSearchDecoder
    from pero_ocr_tpu_torch.models.charlm import CharLM, CharLMSpec

    lm = CharLM(CharLMSpec(vocab_size=6, embed_dim=8, hidden_dim=32, num_layers=2,
                           cell_type=cell_type), generator=torch.Generator().manual_seed(2))
    kw = dict(k=8, lm=lm, lm_scale=0.5, insertion_bonus=0.2, transport_dtype=np.float16)
    return (TorchBeamSearchDecoder(BEAM_LETTERS, device="cpu", **kw),
            TorchBeamSearchDecoder(BEAM_LETTERS, device=cuda, **kw))


def _beam_inputs(seed, b=3, t=128):
    rng = np.random.default_rng(seed)
    logits = np.log(rng.dirichlet(np.full(6, 0.3), size=(b, t))).astype(np.float32)
    lengths = np.array([t, t - 40, 9][:b])
    return logits, lengths


@pytest.mark.parametrize("cell_type", ["lstm", "gru"])
def test_beam_search_on_the_card_matches_cpu(cuda, cell_type):
    """Lines of three lengths and a carried state: the card's graph
    decode against the CPU port's, equal backpointers unless the CPU's
    smallest gap among its K + 1 best totals is a float32 near-tie."""
    from chip_smoke import decode_differs
    from pero_ocr_tpu_torch.models.charlm import state_leaves, state_map

    cpu, card = _beam_decoders(cuda, cell_type)
    logits, lengths = _beam_inputs(1)
    init = cpu.states_from_line("abcab")
    init = state_map(lambda x: x.repeat(3, 1), init)
    ref = cpu.run(logits, lengths, init_lm_states=init, margins=True)
    out = card.run(logits, lengths, init_lm_states=state_map(lambda x: x.to(cuda), init))
    totals = (ref.p_total + 0.5 * ref.p_lm).numpy()
    verdicts = decode_differs((out.bp_rows.cpu().numpy(), out.bp_cols.cpu().numpy()),
                              (ref.bp_rows.numpy(), ref.bp_cols.numpy()),
                              ref.margins.numpy(), totals, lengths)
    assert all(v is None or v[1] for v in verdicts), verdicts
    for i, v in enumerate(verdicts):
        if v is None:
            assert np.allclose(out.p_total[i].cpu().numpy(), ref.p_total[i].numpy(), atol=1e-3)
            assert card.hypotheses(out)[i].best_hyp() == cpu.hypotheses(ref)[i].best_hyp()
    for g, w in zip(state_leaves(out.best_states), state_leaves(ref.best_states)):
        if all(v is None for v in verdicts):
            assert torch.allclose(g.cpu(), w, atol=1e-4)
    assert len(card._graphs) == 1


def test_beam_graph_replay_equals_the_eager_loop(cuda):
    """A replayed graph gives the eager loop's backpointers and scores on
    the card; one graph a (B, T) shape, B padded to a power of two,
    reused; a carried-state chain through decode_batch."""
    _, card = _beam_decoders(cuda, "lstm")
    for seed in (2, 3):
        logits, lengths = _beam_inputs(seed)
        graph = card.run(logits, lengths)
        graph = [t.clone() for t in (graph.bp_rows, graph.bp_cols, graph.p_total, graph.p_lm)]
        eager = card.run(logits, lengths, graph=False)
        for g, e in zip(graph, (eager.bp_rows, eager.bp_cols, eager.p_total, eager.p_lm)):
            assert torch.equal(g, e)
    assert list(card._graphs) == [(4, 128, False, False)]
    assert card.graph_capture_seconds > 0
    state = None
    for seed in (4, 5):
        line, _ = _beam_inputs(seed, b=1)
        bags, final = card.decode_batch(line, init_lm_states=state, return_lm_states=True)
        eager = card.hypotheses(card.run(line, init_lm_states=state, graph=False))
        assert [h.transcript for h in bags[0]] == [h.transcript for h in eager[0]]
        state = card.add_line_end(final)
    assert (1, 128, False, False) in card._graphs


def test_beam_graphs_are_bounded(cuda, monkeypatch):
    """A batch of 3 lines runs as 4; past GRAPH_CACHE shapes the least
    recently used graph goes, and a shape captured again still decodes
    as the eager loop does."""
    from pero_ocr_tpu_torch.decoding import tpu_decoder

    monkeypatch.setattr(tpu_decoder, "GRAPH_CACHE", 2)
    _, card = _beam_decoders(cuda, "lstm")
    logits, lengths = _beam_inputs(6, t=256)
    for b in (3, 2, 1):
        card.run(logits[:b], lengths[:b])
    assert list(card._graphs) == [(2, 256, False, False), (1, 256, False, False)]
    out = card.run(logits, lengths)
    assert list(card._graphs) == [(1, 256, False, False), (4, 256, False, False)]
    assert out.bp_rows.shape[1] == 3
    eager = card.run(logits, lengths, graph=False)
    assert torch.equal(out.bp_rows, eager.bp_rows) and torch.equal(out.p_total, eager.p_total)


# ----------------------------------------------------------------------
# The transformer recognizers (config 4) on the card: no hand-written
# kernel, torch ops, each decode shape a CUDA graph.
TRANSFORMER_CHARS = [chr(0x61 + i) for i in range(10)]
SMALL_NET = {"dim_model": 32, "dim_ff": 64, "heads": 4, "encoder_layers": 2,
             "decoder_layers": 2, "conv_subsampling": [8, 4], "max_seq_len": 64}


def _transformer_engines(cuda, tmp_path, kind):
    """(CPU engine, card engine) of one model: ``ref`` a reference .pt,
    ``native`` / ``beam`` the native model (seeded, float32; ``beam``
    with beam_size 3)."""
    import dataclasses
    import json

    from chip_smoke import write_ref_transformer
    from pero_ocr_tpu_torch.models.transformer import TransformerOCR
    from pero_ocr_tpu_torch.ocr.transformer_engine import TransformerEngineLineOCR

    os.makedirs(tmp_path, exist_ok=True)
    if kind == "ref":
        path = write_ref_transformer(str(tmp_path), TRANSFORMER_CHARS, 16, SMALL_NET, 3)
    else:
        path = str(tmp_path / "native.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"characters": TRANSFORMER_CHARS, "line_px_height": 16,
                       "beam_size": 3 if kind == "beam" else 1,
                       "net_spec": {"conv_features": [8, 16], "d_model": 32, "num_heads": 4,
                                    "encoder_layers": 2, "decoder_layers": 2, "mlp_dim": 64,
                                    "max_decode_len": 64}}, f)
    engines = (TransformerEngineLineOCR(path, device="cpu"),
               TransformerEngineLineOCR(path, device=cuda))
    # The end id's bias raised so that lines end at different steps.
    if kind == "ref":
        for engine in engines:
            with torch.no_grad():
                engine.model.dec_out_proj.bias[engine.spec.boundary_id] += 1.5
    else:
        spec = dataclasses.replace(engines[0].spec, dtype=torch.float32)
        model = TransformerOCR(spec, generator=torch.Generator().manual_seed(4)).eval()
        with torch.no_grad():
            model.out_proj.bias[spec.eos_id] += 0.5
        for engine in engines:
            engine.spec, engine.model = spec, copy.deepcopy(model)
    return engines


def _transformer_batch(seed, n=4, width=192):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n, 2, width // 8, 3), dtype=np.uint8)
    return np.repeat(np.repeat(blocks, 8, 1), 8, 2)


@pytest.mark.parametrize("kind", ["ref", "native", "beam"])
def test_transformer_graph_replay_equals_the_eager_loop(cuda, tmp_path, kind):
    """A replayed graph gives the eager loop's tokens, lengths and logits
    bit for bit; one graph a (batch shape, steps), reused."""
    _, card = _transformer_engines(cuda, tmp_path, kind)
    for seed in (1, 2):
        batch = torch.from_numpy(_transformer_batch(seed)).to(cuda)
        graph = [t.clone() for t in card.decode(batch, 48)]
        eager = card.decode(batch, 48, graph=False)
        for g, e in zip(graph, eager):
            assert g.dtype == e.dtype and torch.equal(g, e)
    assert list(card._graphs) == [((4, 16, 192, 3), 48)]
    assert card.graph_capture_seconds > 0


@pytest.mark.parametrize("kind", ["ref", "native", "beam"])
def test_transformer_on_the_card_matches_cpu(cuda, tmp_path, kind):
    """The card's tokens (TF32 off) equal the CPU port's, unless the
    first difference is a near-tie of the CPU's logits (float32
    rounding over dim_ff terms); lengths equal where the tokens are."""
    from chip_smoke import tokens_differ

    cpu, card = _transformer_engines(cuda, tmp_path, kind)
    batch = _transformer_batch(3, n=8)
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = [t.cpu().numpy() for t in card.decode(torch.from_numpy(batch).to(cuda), 48)]
    finally:
        torch.backends.cudnn.allow_tf32 = True
    want = [t.numpy() for t in cpu.decode(torch.from_numpy(batch), 48)]
    terms = SMALL_NET["dim_ff"]
    verdicts = tokens_differ(got[0], want[0], want[2], len(batch), terms)
    assert all(v is None or v[1] for v in verdicts), verdicts
    assert sum(v is None for v in verdicts) >= len(batch) // 2
    for i, v in enumerate(verdicts):
        if v is None:
            assert got[1][i] == want[1][i]
            n = int(got[1][i])
            np.testing.assert_allclose(got[2][i, :n], want[2][i, :n], rtol=0, atol=1e-3)
    assert len(set(want[1].tolist())) > 1  # lines end at different steps


def test_transformer_decode_loops_do_not_sync(cuda, tmp_path):
    """The greedy and beam loops run with every synchronising op raising
    (what capturing them needs)."""
    from pero_ocr_tpu_torch.models import transformer, transformer_ref

    for kind in ("ref", "beam"):
        _, card = _transformer_engines(cuda, tmp_path / kind, kind)
        card.model.to(cuda)
        batch = torch.from_numpy(_transformer_batch(5)).to(cuda).float() / 255
        with torch.inference_mode():
            memory = card.model.encode(batch)
            torch.cuda.synchronize()
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                if kind == "ref":
                    transformer_ref.greedy_ref_from_memory(card.model, memory, 40)
                else:
                    transformer.beam_from_memory(card.model, memory, 40, 3)
                    transformer.greedy_from_memory(card.model, memory, 40)
                card.decode_from_memory(memory, 40)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()


def test_transformer_graphs_are_bounded(cuda, tmp_path, monkeypatch):
    """Past GRAPH_CACHE shapes the least recently used graph goes; a
    shape captured again still decodes as the eager loop does."""
    from pero_ocr_tpu_torch.ocr import transformer_engine

    monkeypatch.setattr(transformer_engine, "GRAPH_CACHE", 2)
    _, card = _transformer_engines(cuda, tmp_path, "ref")
    batches = {n: torch.from_numpy(_transformer_batch(6, n=n)).to(cuda) for n in (1, 2, 4)}
    for n in (4, 2, 1):
        card.decode(batches[n], 40)
    assert [key[0][0] for key in card._graphs] == [2, 1]
    out = [t.clone() for t in card.decode(batches[4], 40)]
    assert [key[0][0] for key in card._graphs] == [1, 4]
    for g, e in zip(out, card.decode(batches[4], 40, graph=False)):
        assert torch.equal(g, e)


def test_bfloat16_lstm_weights_are_one_cudnn_buffer(cuda):
    """A bf16 BiLSTM (stage B's) runs from one cuDNN weight buffer:
    torch's flatten_parameters skips bfloat16 weights, so cuDNN warned
    and compacted them on every call; flatten_lstm_ flattens them once."""
    import warnings

    from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec

    rec = CTCRecognizer(RecognizerSpec(num_classes=7, line_height=16, conv_features=(4, 8),
                                       lstm_layers=2, lstm_features=8),
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.rand(2, 16, 64, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.no_grad():
            rec(x)
        torch.cuda.synchronize()
    assert not [w for w in caught if "contiguous chunk" in str(w.message)]
    storages = {w.untyped_storage().data_ptr() for w in rec.blstm.lstm._flat_weights}
    assert len(storages) == 1
    # Flattened once: a later call, and a state dict loaded into the
    # module, keep the buffer.
    rec.load_state_dict(rec.state_dict())
    with torch.no_grad():
        rec(x)
    assert {w.untyped_storage().data_ptr() for w in rec.blstm.lstm._flat_weights} == storages


@pytest.mark.parametrize("kind", ["ctc", "lm"])
def test_train_step_on_the_card_matches_cpu(cuda, kind):
    """One training step on the card against the CPU's (float32, TF32
    off), with chip_smoke.first_step_parity's tolerances (the loss to
    1e-5 relative, as tests/test_torch_train.py holds it to JAX)."""
    import chip_smoke
    from pero_ocr_tpu_torch.models.charlm import CharLM, CharLMSpec
    from pero_ocr_tpu_torch.models.recognizer import CTCRecognizer, RecognizerSpec
    from pero_ocr_tpu_torch.parallel import train

    rng = np.random.default_rng(0)
    if kind == "ctc":
        def build():
            return CTCRecognizer(RecognizerSpec(num_classes=7, line_height=16,
                                                conv_features=(8, 16), lstm_layers=2,
                                                lstm_features=16, stem="s2d", norm="group",
                                                dtype=torch.float32),
                                 generator=torch.Generator().manual_seed(0))
        labels = rng.integers(0, 6, (4, 5))
        batch = (rng.random((4, 16, 96, 3), np.float32), labels, np.array([5, 3, 1, 4]))
        make_step = train.make_train_step
    else:
        def build():
            return CharLM(CharLMSpec(vocab_size=9, embed_dim=8, hidden_dim=32),
                          generator=torch.Generator().manual_seed(0))
        batch = (rng.integers(0, 9, (4, 12)),)
        make_step = train.make_lm_train_step
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = chip_smoke.first_step_parity(kind, build, make_step, batch, 1e-3)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert out["loss_card"] == pytest.approx(out["loss_cpu"], rel=1e-5)


def test_cpu_traced_lstm_archive_runs_on_the_card(cuda, tmp_path):
    """A recurrent archive traced on the CPU (its initial state's Device
    constant baked as "cpu") loads for the card, runs there with its
    LSTM weights in one cuDNN buffer (no contiguity warning), and gives
    the CPU's logits within float32 rounding."""
    import warnings

    from pero_ocr_tpu_torch.utils import ts_adapters

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 16, (32, 4), stride=(1, 4))
            self.lstm = torch.nn.LSTM(16, 24, num_layers=2, batch_first=True,
                                      bidirectional=True)
            self.fc = torch.nn.Linear(48, 9)

        def forward(self, x):
            y = self.conv(x)[:, :, 0].permute(0, 2, 1)
            return self.fc(self.lstm(y)[0]).permute(0, 2, 1)  # (N, C, T)

    torch.manual_seed(0)
    path = str(tmp_path / "rec.pt")
    torch.jit.trace(Net().eval(), torch.rand(1, 3, 32, 64)).save(path)
    images = torch.rand(3, 32, 200, 3)
    cpu = ts_adapters.TSRecognizerModel.load(path, "cpu")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*contiguous chunk of memory.*")
        card = ts_adapters.TSRecognizerModel.load(path, "cuda")
        assert set(ts_adapters.device_constants(card.archive)) == {"cuda"}
        with torch.inference_mode():
            got = card(images.cuda()).cpu()
    torch.backends.cudnn.allow_tf32 = tf32
    weights = [p for n, p in card.archive.named_parameters() if n.startswith("lstm.")]
    assert len({w.untyped_storage().data_ptr() for w in weights}) == 1
    with torch.inference_mode():
        want = cpu(images)
    assert got.shape == want.shape == (3, 50, 9) and card.spec.subsampling == 4
    assert (got - want).abs().max() < 1e-4
