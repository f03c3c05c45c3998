"""Write the WebP fixtures of this folder, the two committed WebP pages
and their digests.

    python3 tests/data/webp/make_fixtures.py
    python3 tests/data/webp/make_fixtures.py --time   # cv2 and the port on the two pages

Needs cv2 (OpenCV 5.0, libwebp) and Pillow (libwebp 1.6), and runs where
the tests run, never on the card's machine.  It writes small files at
odd sizes:

- cv2's (``c_``): lossy at qualities 1-100 and lossless (quality 101),
  BGRA (a ``VP8X`` file with ``ALPH``), at 37x29, 1x1, 1x40, 40x1 and
  17x3;
- Pillow's (``p_``): lossy at qualities 5-95 across ``method`` 0-6,
  lossless at ``quality`` 0-100 and ``method`` 0-6 (the transforms, the
  colour cache and LZ77), alpha with ``exact`` on and off and
  ``alpha_quality`` 0-100, ICC and XMP chunks, EXIF Orientation 1-8,
  gray-looking images, palettes of 2-200 colours (colour indexing with
  pixel bundling);
- rewritten here at the chunk level by tests/webp_files.py (``r_``):
  animations (ANMF offsets, blend and dispose bits, canvases larger than
  the frame, a lossy frame with alpha, a background colour, a second
  frame), ``VP8X`` flags, RIFF sizes exact and with bytes after, odd
  chunk padding, unknown chunks, ALPH raw and lossless with each filter
  and with pre-processing, an EXIF chunk without the flag;
- written by tests/webp_files.py's VP8 rewriter (``v_``) from cv2's
  lossy files: the simple loop filter, sharpness 1-7, filter level 0,
  mode and reference deltas, 2, 4 and 8 token partitions, segment
  updates without a segment map;
- cv2's None cases (``n_``): files cut short, RIFF sizes short and past
  the end, a canvas that is not the bitstream's size, bad ALPH chunks,
  animations the demuxer rejects, a file of 31 bytes, ...; and a
  canvas past OpenCV's size limits, for which cv2 raises (``x_``).

It also writes the committed pages ``tests/data/page/two_columns_2560x1792_q85.webp``
(the pixels of ``two_columns_progressive_2560x1792_q85.jpg`` as cv2 reads
them, lossy at quality 85) and ``two_columns_1280x896_lossless.webp``
(those pixels shrunk to half with ``cv2.INTER_AREA``, lossless); and
``fixtures.json``: the sha256 and shape of ``cv2.imread(path, 1)`` for
each file (the pages' under "pages", their paths from ``tests/data``),
cv2's None cases under "none", the files cv2 raises for under
"raises", and under "mutations" the seeded byte mutations of a few
bases (tests/webp_files.py's ``mutate``) with cv2's digest of each or
None, and under "cuts" cv2's reads of a few files cut at every 13th
length with their RIFF size fixed (tests/webp_files.py's ``cut``).
tests/test_torch_webp.py holds the port's reader to the JSON on
the CPU, ``chip_smoke.check_webp_fixtures`` on the card's machine.
"""

import hashlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

import cv2  # noqa: E402
import numpy as np  # noqa: E402
from PIL import Image, features  # noqa: E402

from tests import webp_files as wf  # noqa: E402

PAGE_JPEG = "page/two_columns_progressive_2560x1792_q85.jpg"  # from tests/data
PAGES = ("page/two_columns_2560x1792_q85.webp", "page/two_columns_1280x896_lossless.webp")
MUTATION_SEED, MUTATIONS_PER_BASE = 25, 60
CUT_STEP = 13  # every 13th length of these files, cut with their RIFF size fixed
CUT_BASES = ("c_lossy_q75_37x29.webp", "p_lossless_m4_q50_37x29.webp", "c_bgra_lossy_37x29.webp",
             "r_anim_lossy_alpha_45x40.webp")
MUTATION_BASES = ("c_lossy_q75_37x29.webp", "p_lossless_m4_q50_37x29.webp", "c_bgra_lossy_37x29.webp",
                  "r_alph_lossless_f3_37x29.webp", "r_anim_lossy_alpha_45x40.webp",
                  "v_partitions8_53x131.webp")


def sample(h, w, c=3, seed=0):
    """Smooth waves, noise and a flat block, as uint8 (h, w, c)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 5 + k) * 60 + np.cos(y / 7 - k) * 50 + 128
                    + rng.normal(0, 12, (h, w)) for k in range(c)], -1)
    img[h // 3: h // 2 + 1, w // 4: w // 2 + 1] = 200
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_webp(img, quality):
    return cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])[1].tobytes()


def pil_webp(rgb_or_rgba, **kw):
    mode = "RGBA" if rgb_or_rgba.shape[-1] == 4 else "RGB"
    b = io.BytesIO()
    Image.fromarray(rgb_or_rgba, mode).save(b, "WEBP", **kw)
    return b.getvalue()


def exif_block(orientation: int) -> bytes:
    exif = Image.Exif()
    exif[0x0112] = orientation
    return exif.tobytes()


def files() -> dict:
    """name -> bytes of every fixture."""
    out = {}
    bgr = sample(29, 37)
    rgb = np.ascontiguousarray(bgr[:, :, ::-1])
    alpha = sample(29, 37, 1, seed=9)[:, :, 0]
    alpha[5:10, 5:20] = 0
    rgba = np.dstack([rgb, alpha])
    # cv2
    for q in (1, 10, 30, 50, 75, 90, 100):
        out[f"c_lossy_q{q}_37x29.webp"] = cv2_webp(bgr, q)
    out["c_lossless_37x29.webp"] = cv2_webp(bgr, 101)
    for h, w in ((1, 1), (1, 40), (40, 1), (17, 3)):
        img = sample(h, w, seed=h * 100 + w)
        out[f"c_lossy_q50_{w}x{h}.webp"] = cv2_webp(img, 50)
        out[f"c_lossless_{w}x{h}.webp"] = cv2_webp(img, 101)
    bgra = np.dstack([bgr, alpha])
    out["c_bgra_lossy_37x29.webp"] = cv2_webp(bgra, 80)
    out["c_bgra_lossless_37x29.webp"] = cv2_webp(bgra, 101)
    # Pillow
    for method in range(7):
        for q in (5, 50, 95):
            out[f"p_lossy_m{method}_q{q}_37x29.webp"] = pil_webp(rgb, quality=q, method=method)
        for q in (0, 50, 100):
            out[f"p_lossless_m{method}_q{q}_37x29.webp"] = pil_webp(rgb, lossless=True, quality=q,
                                                                    method=method)
    flat = np.full((61, 45, 3), 128, np.uint8)  # macroblocks without coefficients: methods 0-2
    flat[20:40, 20:40] = sample(20, 20, seed=1)   # then code a skip probability
    for method, q in ((0, 50), (2, 5)):
        out[f"p_lossy_skip_m{method}_q{q}_45x61.webp"] = pil_webp(np.ascontiguousarray(flat[:, :, ::-1]),
                                                                 quality=q, method=method)
    for exact in (False, True):
        for aq in (0, 50, 100):
            out[f"p_alpha_lossy_aq{aq}_exact{int(exact)}_37x29.webp"] = pil_webp(
                rgba, quality=80, alpha_quality=aq, exact=exact)
        out[f"p_alpha_lossless_exact{int(exact)}_37x29.webp"] = pil_webp(rgba, lossless=True, exact=exact)
    out["p_icc_xmp_37x29.webp"] = pil_webp(rgb, quality=70, icc_profile=b"\0" * 131,
                                           xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>")
    for o in range(1, 9):
        out[f"p_exif_o{o}_37x29.webp"] = pil_webp(rgb, lossless=o % 2 == 0, quality=70,
                                                  exif=exif_block(o))
    gray = np.repeat(sample(31, 45, 1, seed=2), 3, axis=2)
    out["p_gray_lossless_45x31.webp"] = pil_webp(gray, lossless=True)
    out["p_gray_lossy_45x31.webp"] = pil_webp(gray, quality=60)
    rng = np.random.default_rng(5)
    for ncol in (2, 3, 4, 5, 16, 17, 200):
        pal = rng.integers(0, 256, (ncol, 3))
        idx = rng.integers(0, ncol, (23, 41))
        idx[:, :10] = 0
        out[f"p_palette{ncol}_41x23.webp"] = pil_webp(pal[idx].astype(np.uint8), lossless=True, method=4)
    # chunk-level rewrites
    vp8 = wf.payload(out["c_lossy_q75_37x29.webp"], b"VP8 ")
    vp8l = wf.payload(out["c_lossless_37x29.webp"], b"VP8L")
    odd_vp8l = wf.payload(out["c_lossless_40x1.webp"], b"VP8L")
    assert len(odd_vp8l) & 1
    out["r_riff_trailing_bytes_37x29.webp"] = wf.riff(wf.chunk(b"VP8L", vp8l)) + b"trailing garbage...."
    out["r_riff_unknown_chunk_after_37x29.webp"] = wf.riff(wf.chunk(b"VP8 ", vp8) + wf.chunk(b"ABCD", b"xyz"))
    out["r_odd_no_padding_40x1.webp"] = (b"RIFF" + (12 + len(odd_vp8l)).to_bytes(4, "little") + b"WEBP"
                                         + b"VP8L" + len(odd_vp8l).to_bytes(4, "little") + odd_vp8l)
    out["r_odd_padded_40x1.webp"] = wf.riff(wf.chunk(b"VP8L", odd_vp8l))
    out["r_vp8l_chunk_size_short_37x29.webp"] = wf.riff(wf.chunk(b"VP8L", vp8l, size=10)[:8] + vp8l)
    for flags, name in ((0, "none"), (0x01 | 0x40 | 0x80, "reserved"), (0x10, "alpha_no_alph"),
                        (0x20 | 0x04, "iccp_xmp_flags")):
        out[f"r_vp8x_flags_{name}_37x29.webp"] = wf.riff(wf.vp8x(flags, 37, 29) + wf.chunk(b"VP8 ", vp8))
    out["r_vp8x_unknown_chunks_37x29.webp"] = wf.riff(
        wf.vp8x(0, 37, 29) + wf.chunk(b"ABCD", b"12345") + wf.chunk(b"VP8L", vp8l) + wf.chunk(b"EFGH", b"6"))
    out["r_exif_without_flag_37x29.webp"] = wf.riff(
        wf.vp8x(0, 37, 29) + wf.chunk(b"VP8L", vp8l) + wf.chunk(b"EXIF", exif_block(6)))
    out["r_exif_reserved_flag_37x29.webp"] = wf.riff(
        wf.vp8x(0x08 | 0x40, 37, 29) + wf.chunk(b"VP8L", vp8l) + wf.chunk(b"EXIF", exif_block(6)))
    out["r_exif_first_of_two_37x29.webp"] = wf.riff(
        wf.vp8x(0x08, 37, 29) + wf.chunk(b"EXIF", exif_block(6)) + wf.chunk(b"EXIF", exif_block(3))
        + wf.chunk(b"VP8L", vp8l))
    out["r_exif_riff_trailing_bytes_37x29.webp"] = wf.riff(
        wf.vp8x(0x08, 37, 29) + wf.chunk(b"VP8L", vp8l) + wf.chunk(b"EXIF", exif_block(8))) + b"tail"
    out["r_exif_trailing_bytes_in_riff_37x29.webp"] = wf.riff(
        wf.vp8x(0x08, 37, 29) + wf.chunk(b"VP8L", vp8l) + wf.chunk(b"EXIF", exif_block(8)) + b"tail")
    out["r_alph_before_vp8l_37x29.webp"] = wf.riff(
        wf.vp8x(0x10, 37, 29) + wf.chunk(b"ALPH", wf.alph_raw(alpha, 0)) + wf.chunk(b"VP8L", vp8l))
    # ALPH with each filter, raw and lossless
    for method in range(4):
        residual = wf.alph_filter(alpha, method)
        green = np.dstack([np.zeros_like(residual), residual, np.zeros_like(residual)])
        stream = wf.payload(pil_webp(green, lossless=True, method=4, exact=True), b"VP8L")[5:]
        for kind, body in (("raw", wf.alph_raw(alpha, method)),
                           ("lossless", wf.alph_lossless(alpha, method, stream))):
            out[f"r_alph_{kind}_f{method}_37x29.webp"] = wf.riff(
                wf.vp8x(0x10, 37, 29) + wf.chunk(b"ALPH", body) + wf.chunk(b"VP8 ", vp8))
    out["r_alph_raw_preprocessed_37x29.webp"] = wf.riff(
        wf.vp8x(0x10, 37, 29) + wf.chunk(b"ALPH", wf.alph_raw(alpha, 1, 1)) + wf.chunk(b"VP8 ", vp8))
    out["r_alph_second_chunk_wins_37x29.webp"] = wf.riff(
        wf.vp8x(0x10, 37, 29) + wf.chunk(b"ALPH", b"\x03bad") + wf.chunk(b"ALPH", wf.alph_raw(alpha, 2))
        + wf.chunk(b"VP8 ", vp8))
    # animations (a frame's size in ANMF is the bitstream's for libwebp)
    frame_alpha = wf.chunk(b"ALPH", wf.alph_raw(alpha, 3)) + wf.chunk(b"VP8 ", vp8)
    out["r_anim_one_frame_37x29.webp"] = wf.riff(
        wf.vp8x(0x02, 37, 29) + wf.anim() + wf.anmf(0, 0, 37, 29, wf.chunk(b"VP8L", vp8l)))
    for flags in range(4):
        out[f"r_anim_offset_flags{flags}_45x40.webp"] = wf.riff(
            wf.vp8x(0x02, 45, 40) + wf.anim(0xFF1263C7) + wf.anmf(2, 3, 37, 29, wf.chunk(b"VP8L", vp8l),
                                                               flags=flags))
    out["r_anim_at_corner_41x33.webp"] = wf.riff(
        wf.vp8x(0x02, 41, 33) + wf.anim() + wf.anmf(2, 2, 37, 29, wf.chunk(b"VP8 ", vp8)))
    out["r_anim_lossy_alpha_45x40.webp"] = wf.riff(
        wf.vp8x(0x12, 45, 40) + wf.anim(0x80808080) + wf.anmf(1, 4, 37, 29, frame_alpha, flags=2))
    out["r_anim_two_frames_45x40.webp"] = wf.riff(
        wf.vp8x(0x02, 45, 40) + wf.anim() + wf.anmf(3, 1, 37, 29, wf.chunk(b"VP8 ", vp8))
        + wf.anmf(0, 0, 37, 29, wf.chunk(b"VP8L", vp8l), flags=1))
    out["r_anim_anmf_size_not_bitstreams_45x40.webp"] = wf.riff(
        wf.vp8x(0x02, 45, 40) + wf.anim() + wf.anmf(2, 3, 30, 20, wf.chunk(b"VP8L", vp8l)))
    out["r_anim_exif_45x40.webp"] = wf.riff(
        wf.vp8x(0x0A, 45, 40) + wf.anim() + wf.anmf(2, 3, 37, 29, wf.chunk(b"VP8L", vp8l))
        + wf.chunk(b"EXIF", exif_block(5)))
    # the VP8 rewriter
    tall = sample(131, 53, seed=11)
    base = cv2_webp(tall, 60)
    out["v_base_53x131.webp"] = base
    out["v_simple_filter_53x131.webp"] = wf.rewrite(base, simple=1)
    for sharpness in range(1, 8):
        out[f"v_sharpness{sharpness}_53x131.webp"] = wf.rewrite(base, sharpness=sharpness,
                                                                simple=int(sharpness > 5))
    out["v_filter_level0_53x131.webp"] = wf.rewrite(base, level=0)
    out["v_deltas_53x131.webp"] = wf.rewrite(base, use_lf_delta=1, ref_lf_delta0=9, mode_lf_delta0=-12,
                                             ref_lf_delta2=3, mode_lf_delta1=4)
    out["v_deltas_simple_53x131.webp"] = wf.rewrite(base, simple=1, level=40, use_lf_delta=1,
                                                    ref_lf_delta0=-20, mode_lf_delta0=30)
    for bits in (1, 2, 3):
        out[f"v_partitions{1 << bits}_53x131.webp"] = wf.rewrite(base, partitions=bits)
    out["v_segments_without_map_53x131.webp"] = wf.rewrite(
        base, segments_without_map=([50, 10, 20, 30], [7, None, 20, -3], True))
    out["v_segments_without_map_relative_53x131.webp"] = wf.rewrite(
        base, segments_without_map=([-12, 10, 20, 30], [-6, None, 20, -3], False))
    # cv2's None cases
    lossy, lossless = out["c_lossy_q75_37x29.webp"], out["c_lossless_37x29.webp"]
    out["n_lossy_cut_half_37x29.webp"] = lossy[:len(lossy) // 2]
    out["n_lossless_cut_half_37x29.webp"] = lossless[:len(lossless) // 2]
    out["n_lossy_cut_last_byte_37x29.webp"] = wf.riff(wf.chunk(b"VP8 ", vp8))[:-1]
    out["n_riff_size_past_end_37x29.webp"] = wf.riff(wf.chunk(b"VP8 ", vp8), extra=10)
    out["n_riff_size_short_37x29.webp"] = wf.riff(wf.chunk(b"VP8 ", vp8), extra=-2)
    out["n_31_bytes.webp"] = lossless[:31]
    out["n_vp8x_canvas_not_bitstreams_37x29.webp"] = wf.riff(wf.vp8x(0, 38, 29) + wf.chunk(b"VP8 ", vp8))
    out["n_vp8x_size_12_37x29.webp"] = wf.riff(
        wf.chunk(b"VP8X", b"\0" * 4 + (36).to_bytes(3, "little") + (28).to_bytes(3, "little") + b"\0\0")
        + wf.chunk(b"VP8L", vp8l))
    out["n_vp8x_animation_without_anim_37x29.webp"] = wf.riff(wf.vp8x(0x02, 37, 29) + wf.chunk(b"VP8 ", vp8))
    out["n_alph_raw_short_37x29.webp"] = wf.riff(
        wf.vp8x(0x10, 37, 29) + wf.chunk(b"ALPH", wf.alph_raw(alpha, 0)[:-1]) + wf.chunk(b"VP8 ", vp8))
    out["n_alph_bad_header_37x29.webp"] = wf.riff(
        wf.vp8x(0x10, 37, 29) + wf.chunk(b"ALPH", b"\xc0" + wf.alph_raw(alpha, 0)[1:]) + wf.chunk(b"VP8 ", vp8))
    out["n_alph_second_chunk_bad_37x29.webp"] = wf.riff(
        wf.vp8x(0x10, 37, 29) + wf.chunk(b"ALPH", wf.alph_raw(alpha, 2)) + wf.chunk(b"ALPH", b"\x03bad")
        + wf.chunk(b"VP8 ", vp8))
    out["n_vp8_not_a_key_frame_37x29.webp"] = wf.riff(wf.chunk(b"VP8 ", bytes([vp8[0] | 1]) + vp8[1:]))
    out["n_vp8l_version_1_37x29.webp"] = wf.riff(wf.chunk(b"VP8L", vp8l[:4] + bytes([vp8l[4] | 0x20]) + vp8l[5:]))
    out["n_anim_without_anim_chunk_45x40.webp"] = wf.riff(
        wf.vp8x(0x02, 45, 40) + wf.anmf(2, 3, 37, 29, wf.chunk(b"VP8L", vp8l)))
    out["n_anim_frame_past_canvas_40x40.webp"] = wf.riff(
        wf.vp8x(0x02, 40, 40) + wf.anim() + wf.anmf(2, 3, 37, 29, wf.chunk(b"VP8L", vp8l)))
    out["n_anim_trailing_bytes_in_riff_45x40.webp"] = wf.riff(
        wf.vp8x(0x02, 45, 40) + wf.anim() + wf.anmf(2, 3, 37, 29, wf.chunk(b"VP8L", vp8l)) + b"abcd")
    out["n_anim_first_frame_corrupt_45x40.webp"] = wf.riff(
        wf.vp8x(0x02, 45, 40) + wf.anim() + wf.anmf(2, 3, 37, 29, wf.chunk(b"VP8L", vp8l[:5] + b"\xff" * 40)))
    out["n_anim_alph_before_vp8l_45x40.webp"] = wf.riff(
        wf.vp8x(0x12, 45, 40) + wf.anim() + wf.anmf(2, 3, 37, 29, wf.chunk(b"ALPH", wf.alph_raw(alpha, 0))
                                                   + wf.chunk(b"VP8L", vp8l)))
    out["n_vp8_token_partition_cut_53x131.webp"] = wf.riff(wf.chunk(b"VP8 ", wf.payload(base, b"VP8 ")[:-40]))
    # cv2 raises: a canvas wider than OpenCV's 2^20
    out["x_canvas_past_opencv_limit.webp"] = wf.riff(wf.vp8x(0, (1 << 20) + 1, 29) + wf.chunk(b"VP8 ", vp8))
    return out


def digest(img: np.ndarray) -> dict:
    return {"sha256": hashlib.sha256(img.tobytes()).hexdigest(), "shape": list(img.shape)}


def cv2_read(path: str):
    """cv2's digest, None, or "raises"."""
    try:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
    except cv2.error:
        return "raises"
    return None if img is None else digest(img)


def main():
    data = os.path.dirname(HERE)
    spec = {"decode": {}, "none": [], "raises": [], "pages": {}, "mutations": {}, "cuts": {},
            "made_with": f"cv2 {cv2.__version__}, Pillow {Image.__version__} "
                         f"(libwebp {features.version('webp')})"}
    for old in os.listdir(HERE):
        if old.endswith(".webp"):
            os.remove(os.path.join(HERE, old))
    for name, blob in sorted(files().items()):
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(blob)
        got = cv2_read(path)
        want = {"n": "None", "x": "raises"}.get(name[0], "a decode")
        if {"n": got is None, "x": got == "raises"}.get(name[0], isinstance(got, dict)) is False:
            raise SystemExit(f"{name}: cv2 gives {got}, the fixture wants {want}")
        if got is None:
            spec["none"].append(name)
        elif got == "raises":
            spec["raises"].append(name)
        else:
            spec["decode"][name] = got
    tmp = os.path.join(HERE, "mutation.tmp")
    for name in MUTATION_BASES:
        with open(os.path.join(HERE, name), "rb") as f:
            base = f.read()
        rng = wf.mutation_rng(MUTATION_SEED, name)
        results = []
        for _ in range(MUTATIONS_PER_BASE):
            with open(tmp, "wb") as f:
                f.write(wf.mutate(base, rng))
            results.append(cv2_read(tmp))
        spec["mutations"][name] = results
    for name in CUT_BASES:
        with open(os.path.join(HERE, name), "rb") as f:
            base = f.read()
        results = []
        for length in range(12, len(base), CUT_STEP):
            with open(tmp, "wb") as f:
                f.write(wf.cut(base, length))
            results.append(cv2_read(tmp))
        spec["cuts"][name] = results
    os.remove(tmp)
    spec["mutation_seed"], spec["cut_step"] = MUTATION_SEED, CUT_STEP
    page = cv2.imread(os.path.join(data, PAGE_JPEG), cv2.IMREAD_COLOR)
    small = cv2.resize(page, (page.shape[1] // 2, page.shape[0] // 2), interpolation=cv2.INTER_AREA)
    blobs = (cv2_webp(page, 85), pil_webp(np.ascontiguousarray(small[:, :, ::-1]), lossless=True, method=6,
                                          quality=100))
    for rel, blob in zip(PAGES, blobs):
        with open(os.path.join(data, rel), "wb") as f:
            f.write(blob)
        spec["pages"][rel] = cv2_read(os.path.join(data, rel))
    with open(os.path.join(HERE, "fixtures.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in os.listdir(HERE))
    print(f"{len(spec['decode'])} decodes, {len(spec['none'])} None, {len(spec['raises'])} raise, "
          f"{sum(len(v) for v in spec['mutations'].values())} mutations "
          f"({sum(v is None for r in spec['mutations'].values() for v in r)} None), "
          f"{sum(map(len, spec['cuts'].values()))} cuts "
          f"({sum(v is None for r in spec['cuts'].values() for v in r)} None); {total} B here")


def time_pages(repeats: int = 7):
    """Median ms, one thread, of cv2.imdecode and of the port's reader on
    the two committed pages (after a warm-up call)."""
    import time

    from pero_ocr_tpu_torch.utils import image_io

    cv2.setNumThreads(1)
    for rel in PAGES:
        with open(os.path.join(os.path.dirname(HERE), rel), "rb") as f:
            blob = f.read()
        buf = np.frombuffer(blob, np.uint8)
        for name, fn in (("cv2.imdecode", lambda: cv2.imdecode(buf, cv2.IMREAD_COLOR)),
                         ("the port", lambda: image_io.decode_webp(blob))):
            fn()
            times = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                fn()
                times.append(1e3 * (time.perf_counter() - t0))
            print(f"{rel}: {name} {np.median(times):.1f} ms (median of {repeats}, one thread)")


if __name__ == "__main__":
    time_pages() if sys.argv[1:] == ["--time"] else main()
