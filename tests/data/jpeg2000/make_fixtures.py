"""Write the JPEG 2000 fixtures of this folder and their digests.

    python3 tests/data/jpeg2000/make_fixtures.py

Needs cv2 (OpenCV 5.0, OpenJPEG 2.5.3), Pillow (OpenJPEG 2.5.4) and the
system's ``libopenjp2.so.7`` (2.5.0, driven through ctypes for what
Pillow does not write), and runs where the tests run, never on the
card's machine.  It writes small files at odd sizes:

- Pillow's: 5/3 lossless in gray, RGB, RGBA, LA and 16-bit gray; 5/3
  with 2 and 3 layers; 9/7 by rate and by dB in gray and RGB; 1, 2 and
  6 resolutions; code-blocks of 4x4, 16x64, 32x32 and 64x64; precincts
  smaller than the code-blocks; each of the five progression orders
  with 100-px tiles, precincts and 3 layers, in 5/3 and 9/7; PLT, COM,
  raw ``.j2k`` codestreams, ``mct=0`` and ``mct=1``; 1x1, 1x40, 40x1;
- libopenjp2's: the code-block styles (BYPASS, RESET, TERMALL, VSC,
  PTERM, SEGSYM, each alone and all together), SOP, EPH, tile-parts
  (split by resolution, layer and component), POC and RGN;
- JP2 boxes built by tests/test_torch_jpeg2000.py's writer around those
  codestreams: ``colr`` sYCC, CMYK, e-sYCC, an unknown EnumCS, a
  restricted ICC profile and no ``colr`` at all; a ``pclr``+``cmap``
  palette (8- and 16-bit entries, indexes past the palette); ``cdef``
  orders; gray over three components;
- codestreams rewritten by the test's rewriters: tile-parts interleaved
  across tiles, ``Psot = 0`` on the last tile-part, TLM, PLM, CRG, COC
  and QCC segments, 9- and 12-bit samples, another marker in EOC's
  place; a one-code-block codestream written by the test with an empty
  segment;
- cv2's None cases: a gray codestream (no colour box), CMYK, e-sYCC,
  signed and 7-bit samples, an image offset, a subsampled component,
  five components, a file cut at two thirds, files without their EOC
  marker, that one-code-block codestream with a segment length past
  the tile's end (2^31 and 2^32 - 1 in 32 bits, 5 in 3), and ``cdef``,
  ``cmap`` and ``pclr`` boxes too short for their fields.

It also writes the committed page ``tests/data/page/two_columns_2560x1792.jp2``:
the pixels of ``two_columns_progressive_2560x1792_q85.jpg`` as cv2
reads them, encoded as archive masters are (9/7, RPCL, 6 resolutions,
64x64 code-blocks, 256x256 precincts, 3 layers by rate, PLT, 1024x1024
tiles, the component transform); and ``fixtures.json``: the sha256 and
shape of ``cv2.imread(path, 1)`` for each file (the page's under
"pages", its path from ``tests/data``), cv2's None cases under "none".
tests/test_torch_jpeg2000.py holds the port's reader to the JSON on the
CPU, ``chip_smoke.check_jpeg2000_fixtures`` on the card's machine.
"""

import ctypes
import ctypes.util
import hashlib
import io
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

import cv2  # noqa: E402
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from tests.test_torch_jpeg2000 import (  # noqa: E402
    box, cdef, cmap, codestream_of, colr, colr_icc, interleave_tile_parts, jp2, last_psot_zero,
    one_block_codestream, pclr, with_coc_qcc, with_crg, with_plm, with_precision,
    with_subsampling, with_tlm,
)

PAGE_JPEG = "page/two_columns_progressive_2560x1792_q85.jpg"  # from tests/data
PAGE = "page/two_columns_2560x1792.jp2"
PAGE_RATES = [72, 36, 18]  # compression ratios of the 3 layers: 767,764 B
LIBOPENJP2 = ctypes.util.find_library("openjp2") or "libopenjp2.so.7"


def sample(h, w, c=3, seed=0):
    """Smooth waves, noise and a flat block, as uint8 (h, w, c)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 5 + k) * 60 + np.cos(y / 7 - k) * 50 + 128
                    + rng.normal(0, 12, (h, w)) for k in range(c)], -1)
    img[h // 3: h // 2 + 1, w // 4: w // 2 + 1] = 200
    return np.clip(img, 0, 255).astype(np.uint8)


def pillow(img, mode=None, j2k=False, **options) -> bytes:
    f = io.BytesIO()
    Image.fromarray(img, mode).save(f, "JPEG2000", no_jp2=j2k, **options)
    return f.getvalue()


# ----------------------------------------------------------------------
# libopenjp2 through ctypes (openjpeg.h of 2.5; the layout is checked
# against opj_set_default_encoder_parameters' defaults)
_U32, _I32 = ctypes.c_uint32, ctypes.c_int32


class _Poc(ctypes.Structure):
    _fields_ = [(n, _U32) for n in ("resno0", "compno0", "layno1", "resno1", "compno1", "layno0",
                                    "precno0", "precno1")] + [
        ("prg1", _I32), ("prg", _I32), ("progorder", ctypes.c_char * 5), ("tile", _U32)] + [
        (n, _I32) for n in ("tx0", "tx1", "ty0", "ty1")] + [
        (n, _U32) for n in ("layS", "resS", "compS", "prcS", "layE", "resE", "compE", "prcE",
                            "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t", "res_t", "comp_t",
                            "prc_t", "tx0_t", "ty0_t")]


class _Params(ctypes.Structure):
    _fields_ = [(n, _I32) for n in ("tile_size_on", "cp_tx0", "cp_ty0", "cp_tdx", "cp_tdy",
                                    "cp_disto_alloc", "cp_fixed_alloc", "cp_fixed_quality")] + [
        ("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p), ("csty", _I32),
        ("prog_order", _I32), ("POC", _Poc * 32), ("numpocs", _U32), ("tcp_numlayers", _I32),
        ("tcp_rates", ctypes.c_float * 100), ("tcp_distoratio", ctypes.c_float * 100)] + [
        (n, _I32) for n in ("numresolution", "cblockw_init", "cblockh_init", "mode",
                            "irreversible", "roi_compno", "roi_shift", "res_spec")] + [
        ("prcw_init", _I32 * 33), ("prch_init", _I32 * 33), ("infile", ctypes.c_char * 4096),
        ("outfile", ctypes.c_char * 4096), ("index_on", _I32), ("index", ctypes.c_char * 4096)] + [
        (n, _I32) for n in ("image_offset_x0", "image_offset_y0", "subsampling_dx",
                            "subsampling_dy", "decod_format", "cod_format", "jpwl_epc_on",
                            "jpwl_hprot_MH")] + [
        ("jpwl_hprot_TPH_tileno", _I32 * 16), ("jpwl_hprot_TPH", _I32 * 16),
        ("jpwl_pprot_tileno", _I32 * 16), ("jpwl_pprot_packno", _I32 * 16),
        ("jpwl_pprot", _I32 * 16)] + [
        (n, _I32) for n in ("jpwl_sens_size", "jpwl_sens_addr", "jpwl_sens_range",
                            "jpwl_sens_MH")] + [
        ("jpwl_sens_TPH_tileno", _I32 * 16), ("jpwl_sens_TPH", _I32 * 16), ("cp_cinema", _I32),
        ("max_comp_size", _I32), ("cp_rsiz", _I32), ("tp_on", ctypes.c_char),
        ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char), ("jpip_on", _I32),
        ("mct_data", ctypes.c_void_p), ("max_cs_size", _I32), ("rsiz", ctypes.c_uint16)]


class _CompParams(ctypes.Structure):
    _fields_ = [(n, _U32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _Comp(ctypes.Structure):
    _fields_ = [(n, _U32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                                    "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(_I32)), ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):
    _fields_ = [(n, _U32) for n in ("x0", "y0", "x1", "y1", "numcomps")] + [
        ("color_space", _I32), ("comps", ctypes.POINTER(_Comp)),
        ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", _U32)]


PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
STYLES = {"BYPASS": 1, "RESET": 2, "TERMALL": 4, "VSC": 8, "PTERM": 16, "SEGSYM": 32}


def openjp2(planes, subsampling=None, numres=3, cblk=(16, 16), mode=0, csty=0, irreversible=False,
            rates=None, prog="LRCP", tiles=None, tile_parts=None, pocs=(), roi=None) -> bytes:
    """A raw codestream of uint8 ``planes`` (each at its component's
    size) written by libopenjp2.  ``pocs``: (tile, resno0, compno0,
    layno1, resno1, compno1, order) each; ``roi``: (component, shift)."""
    lib = ctypes.CDLL(LIBOPENJP2)
    lib.opj_image_create.restype = ctypes.POINTER(_Image)
    lib.opj_create_compress.restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, _I32]
    lib.opj_setup_encoder.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Params),
                                      ctypes.POINTER(_Image)]
    lib.opj_start_compress.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Image), ctypes.c_void_p]
    for name in ("opj_encode", "opj_end_compress"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for name in ("opj_stream_destroy", "opj_destroy_codec"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]

    n = len(planes)
    subsampling = subsampling or [(1, 1)] * n
    parms = (_CompParams * n)()
    for i, plane in enumerate(planes):
        parms[i].dx, parms[i].dy = subsampling[i]
        parms[i].h, parms[i].w = plane.shape
        parms[i].prec, parms[i].bpp, parms[i].sgnd = 8, 8, 0
    image = lib.opj_image_create(n, parms, 1 if n >= 3 else 2)
    img = image.contents
    img.x0 = img.y0 = 0
    img.x1 = planes[0].shape[1] * subsampling[0][0]
    img.y1 = planes[0].shape[0] * subsampling[0][1]
    for i, plane in enumerate(planes):
        data = np.ascontiguousarray(plane, np.int32)
        ctypes.memmove(img.comps[i].data, data.ctypes.data, data.nbytes)
    p = _Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    assert (p.numresolution, p.cblockw_init, p.cblockh_init, p.roi_compno, p.subsampling_dx,
            p.decod_format, p.cod_format) == (6, 64, 64, -1, 1, -1, -1), "openjpeg.h layout"
    p.numresolution, (p.cblockw_init, p.cblockh_init) = numres, cblk
    p.mode, p.csty, p.irreversible, p.prog_order = mode, csty, int(irreversible), PROGRESSIONS[prog]
    rates = rates or [0]
    p.tcp_numlayers, p.cp_disto_alloc = len(rates), 1
    for i, rate in enumerate(rates):
        p.tcp_rates[i] = rate
    if tiles:
        p.tile_size_on, p.cp_tdx, p.cp_tdy = 1, tiles[0], tiles[1]
    if tile_parts:
        p.tp_on, p.tp_flag = b"\x01", tile_parts.encode()
    for i, (tile, r0, c0, l1, r1, c1, order) in enumerate(pocs):
        q = p.POC[i]
        q.tile, q.resno0, q.compno0, q.layno1, q.resno1, q.compno1 = tile, r0, c0, l1, r1, c1
        q.prg1, q.progorder = PROGRESSIONS[order], order.encode()
    p.numpocs = len(pocs)
    if roi:
        p.roi_compno, p.roi_shift = roi
    p.tcp_mct = b"\x01" if n >= 3 and len(set(subsampling)) == 1 else b"\x00"
    path = os.path.join(HERE, ".openjp2.j2k")
    codec = lib.opj_create_compress(0)  # OPJ_CODEC_J2K
    stream = lib.opj_stream_create_default_file_stream(os.fsencode(path), 0)
    ok = (lib.opj_setup_encoder(codec, ctypes.byref(p), image)
          and lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
          and lib.opj_end_compress(codec, stream))
    lib.opj_stream_destroy(stream)
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(image)
    with open(path, "rb") as f:
        data = f.read()
    os.remove(path)
    if not ok:
        raise RuntimeError("libopenjp2 failed to encode")
    return data


# ----------------------------------------------------------------------
def files():
    """(name -> bytes of files cv2 reads, name -> bytes of its None cases)."""
    out, none = {}, {}
    rgb = sample(29, 37, seed=1)
    gray = sample(37, 29, 1, seed=2)[:, :, 0]
    rgba = sample(29, 37, 4, seed=3)
    la = sample(29, 37, 2, seed=4)
    g16 = (sample(29, 37, 1, seed=5)[:, :, 0].astype(np.uint16) * 257
           + np.random.default_rng(5).integers(0, 256, (29, 37))).astype(np.uint16)
    big = sample(83, 61, seed=6)
    tiled = sample(237, 311, seed=7)
    # Pillow: 5/3 lossless
    out["p_gray_53_37x29.jp2"] = pillow(gray)
    out["p_rgb_53_37x29.jp2"] = pillow(rgb)
    out["p_rgb_53_37x29.j2k"] = pillow(rgb, j2k=True)
    out["p_rgba_53_37x29.jp2"] = pillow(rgba, "RGBA")
    out["p_la_53_37x29.jp2"] = pillow(la, "LA")
    out["p_gray16_53_37x29.jp2"] = pillow(g16)
    out["p_rgb_53_mct_37x29.jp2"] = pillow(rgb, mct=1)
    # layers, rates, dB
    out["p_rgb_53_layers3_83x61.jp2"] = pillow(big, quality_layers=[40, 20, 10], mct=1)
    out["p_gray_53_layers2_83x61.jp2"] = pillow(big[:, :, 0], quality_mode="dB",
                                                quality_layers=[30, 45])
    out["p_gray_97_rate_83x61.jp2"] = pillow(big[:, :, 0], irreversible=True,
                                             quality_layers=[20])
    out["p_rgb_97_rate_83x61.jp2"] = pillow(big, irreversible=True, quality_layers=[30, 12],
                                            mct=1)
    out["p_rgb_97_rate_mct0_83x61.jp2"] = pillow(big, irreversible=True, quality_layers=[16],
                                                 mct=0)
    out["p_gray_97_db_83x61.jp2"] = pillow(big[:, :, 1], irreversible=True, quality_mode="dB",
                                           quality_layers=[38])
    out["p_rgb_97_db_83x61.jp2"] = pillow(big, irreversible=True, quality_mode="dB",
                                          quality_layers=[32, 40], mct=1)
    # resolutions and code-blocks
    out["p_rgb_res1_37x29.jp2"] = pillow(rgb, num_resolutions=1)
    out["p_rgb_97_res2_37x29.jp2"] = pillow(rgb, num_resolutions=2, irreversible=True, mct=1)
    out["p_rgb_res6_100x100.jp2"] = pillow(sample(100, 100, seed=8), num_resolutions=6,
                                           tile_size=(100, 100))
    out["p_rgb_97_res6_100x100.jp2"] = pillow(sample(100, 100, seed=9), num_resolutions=6,
                                              irreversible=True, quality_layers=[25], mct=1)
    for w, h in ((4, 4), (16, 64), (32, 32), (64, 64)):
        out[f"p_rgb_cblk{w}x{h}_83x61.jp2"] = pillow(big, codeblock_size=(w, h),
                                                     irreversible=w == 32, mct=1)
    out["p_rgb_prec16_cblk32_83x61.jp2"] = pillow(big, precinct_size=(16, 16),
                                                  codeblock_size=(32, 32), progression="RPCL",
                                                  quality_layers=[30, 10], mct=1)
    # the five progression orders with 100-px tiles, precincts and layers
    for order in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        for irreversible in (False, True):
            name = f"p_rgb_{'97' if irreversible else '53'}_{order.lower()}_tiles100_311x237.jp2"
            out[name] = pillow(tiled, progression=order, tile_size=(100, 100),
                               precinct_size=(32, 32), codeblock_size=(16, 16),
                               quality_layers=[60, 30, 15], irreversible=irreversible, mct=1)
    out["p_rgb_plt_com_83x61.j2k"] = pillow(big, j2k=True, plt=True, comment="fixture",
                                            irreversible=True, quality_layers=[20], mct=1)
    for h, w in ((1, 1), (1, 40), (40, 1)):
        small = sample(h, w, seed=h + w)
        out[f"p_rgb_53_{w}x{h}.jp2"] = pillow(small)
        out[f"p_rgb_97_{w}x{h}.jp2"] = pillow(small, irreversible=True, mct=1)
    # libopenjp2: code-block styles, SOP/EPH, tile-parts, POC, RGN
    planes = [big[:, :, i] for i in range(3)]
    for style, bit in STYLES.items():
        out[f"o_{style.lower()}_53_83x61.j2k"] = openjp2(planes, mode=bit)
        out[f"o_{style.lower()}_97_83x61.j2k"] = openjp2(planes, mode=bit, irreversible=True,
                                                          rates=[20, 8])
    out["o_allstyles_97_83x61.j2k"] = openjp2(planes, mode=63, irreversible=True,
                                              rates=[30, 15, 6], tiles=(32, 32))
    out["o_sop_83x61.j2k"] = openjp2(planes, csty=2)
    out["o_eph_97_83x61.j2k"] = openjp2(planes, csty=4, irreversible=True, rates=[20, 10])
    out["o_sop_eph_tiles_83x61.j2k"] = openjp2(planes, csty=6, rates=[20, 10], tiles=(32, 32),
                                               prog="RPCL")
    by_res = openjp2(planes, tiles=(32, 32), tile_parts="R", rates=[20, 10], prog="RLCP")
    out["o_tileparts_r_83x61.j2k"] = by_res
    out["o_tileparts_l_97_83x61.j2k"] = openjp2(planes, tile_parts="L", rates=[20, 10],
                                                irreversible=True)
    out["o_tileparts_c_83x61.j2k"] = openjp2(planes, tile_parts="C", prog="CPRL")
    out["o_poc_83x61.j2k"] = openjp2(planes, pocs=[(1, 0, 0, 1, 2, 3, "LRCP"),
                                                   (1, 2, 0, 1, 3, 3, "RLCP")])
    out["o_rgn_83x61.j2k"] = openjp2(planes, roi=(0, 7))
    # codestreams rewritten
    out["r_tileparts_interleaved_83x61.j2k"] = interleave_tile_parts(by_res)
    out["r_psot0_83x61.j2k"] = last_psot_zero(openjp2(planes, tiles=(32, 32)))
    out["r_tlm_crg_plm_83x61.j2k"] = with_plm(with_crg(with_tlm(by_res), 3))
    out["r_coc_qcc_83x61.j2k"] = with_coc_qcc(codestream_of(out["p_rgb_53_37x29.j2k"]), 1)
    out["r_com_for_eoc_37x29.j2k"] = out["p_rgb_53_37x29.j2k"][:-2] + b"\xff\x64"
    for bits in (9, 12):
        cs = codestream_of(pillow(g16, j2k=True))
        out[f"r_gray{bits}_37x29.jp2"] = jp2(with_precision(cs, 0, bits), 29, 37, 1,
                                             [colr(17)], bits - 1)
    # JP2 boxes around codestreams
    rgb_cs = codestream_of(out["p_rgb_53_37x29.j2k"])
    gray_cs = codestream_of(out["p_gray_53_37x29.jp2"])
    rgba_cs = codestream_of(out["p_rgba_53_37x29.jp2"])
    out["b_sycc_37x29.jp2"] = jp2(rgb_cs, 29, 37, 3, [colr(18)])
    out["b_unknown_enumcs_37x29.jp2"] = jp2(rgb_cs, 29, 37, 3, [colr(20)])
    out["b_icc_37x29.jp2"] = jp2(rgb_cs, 29, 37, 3, [colr_icc(bytes(128))])
    out["b_no_colr_37x29.jp2"] = jp2(rgb_cs, 29, 37, 3)
    out["b_gray_over_rgb_37x29.jp2"] = jp2(rgb_cs, 29, 37, 3, [colr(17)])
    out["b_two_colr_37x29.jp2"] = jp2(rgb_cs, 29, 37, 3, [colr(18), colr(16)])
    index = sample(29, 37, 1, seed=10)[:, :, 0]
    index_cs = codestream_of(pillow(index, j2k=True))
    rng = np.random.default_rng(11)
    out["b_palette8_37x29.jp2"] = jp2(index_cs, 29, 37, 1, [
        colr(16), pclr(rng.integers(0, 256, (200, 3)), 8), cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])])
    out["b_palette16_37x29.jp2"] = jp2(index_cs, 29, 37, 1, [
        colr(16), pclr(rng.integers(0, 65536, (256, 3)), 16),
        cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])])
    for i, order in enumerate(([(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)],
                               [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)],
                               [(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0)],
                               [(0, 0, 2), (1, 0, 3), (2, 0, 1), (3, 0, 0)])):
        out[f"b_cdef{i}_rgba_37x29.jp2"] = jp2(rgba_cs, 29, 37, 4, [colr(16), cdef(order)])
    la_cs = codestream_of(out["p_la_53_37x29.jp2"])
    out["b_cdef_la_alpha_first_37x29.jp2"] = jp2(la_cs, 29, 37, 2, [colr(17),
                                                                    cdef([(0, 1, 0), (1, 0, 1)])])
    # cv2's None cases
    none["n_gray_37x29.j2k"] = gray_cs
    none["n_gray_no_colr_37x29.jp2"] = jp2(gray_cs, 37, 29, 1)
    none["n_la_srgb_37x29.jp2"] = jp2(la_cs, 29, 37, 2, [colr(16)])
    none["n_pclr_without_cmap_37x29.jp2"] = jp2(index_cs, 29, 37, 1, [
        colr(16), pclr(rng.integers(0, 256, (200, 3)), 8)])
    none["n_cmyk_37x29.jp2"] = jp2(rgba_cs, 29, 37, 4, [colr(12)])
    none["n_esycc_37x29.jp2"] = jp2(rgb_cs, 29, 37, 3, [colr(24)])
    none["n_signed_37x29.jp2"] = jp2(with_precision(gray_cs, 0, 8, True), 37, 29, 1, [colr(17)],
                                     0x87)
    none["n_7bit_37x29.jp2"] = jp2(with_precision(gray_cs, 0, 7), 37, 29, 1, [colr(17)], 6)
    none["n_offset_37x29.jp2"] = pillow(rgb, offset=(3, 5), tile_size=(64, 64))
    none["n_subsampled_37x29.j2k"] = with_subsampling(rgb_cs, 1, 2)
    none["n_subsampled_openjp2_83x61.j2k"] = openjp2(
        [big[:, :, 0], big[::2, ::2, 1], big[::2, ::2, 2]], subsampling=[(1, 1), (2, 2), (2, 2)])
    none["n_five_components_37x29.j2k"] = openjp2([rgb[:, :, i % 3] for i in range(5)])
    whole = out["p_rgb_97_rate_83x61.jp2"]
    none["n_cut_two_thirds_83x61.jp2"] = whole[:len(whole) * 2 // 3]
    none["n_no_eoc_83x61.jp2"] = whole[:-2]
    none["n_no_eoc_83x61.j2k"] = rgb_cs[:-2]
    # a code-block segment length past the tile's end, in 32 bits (2^31
    # and 2^32 - 1, negative as a signed int) and in 3; and the same
    # file with an empty segment, which reads
    for name, length, bits in (("2p31", 2 ** 31, 32), ("2p32m1", 2 ** 32 - 1, 32), ("5", 5, 3)):
        none[f"n_segment_length_{name}_8x8.jp2"] = jp2(one_block_codestream(length, bits), 8, 8,
                                                        1, [colr(17)])
    out["r_one_block_empty_8x8.jp2"] = jp2(one_block_codestream(0, 3), 8, 8, 1, [colr(17)])
    # boxes too short for their fields
    table = pclr(np.arange(600).reshape(200, 3) % 256, 8)
    for name, inner in (("cdef_empty", [box(b"cdef", b"")]), ("cdef_1byte", [box(b"cdef", b"\0")]),
                        ("cmap_short", [table, box(b"cmap", b"\0\0\1")]),
                        ("pclr_short", [box(b"pclr", b"\0")])):
        none[f"n_{name}_37x29.jp2"] = jp2(rgb_cs, 29, 37, 3, [colr(16), *inner])
    return out, none


def page() -> bytes:
    bgr = cv2.imread(os.path.join(os.path.dirname(HERE), PAGE_JPEG), cv2.IMREAD_COLOR)
    return pillow(np.ascontiguousarray(bgr[:, :, ::-1]), irreversible=True, progression="RPCL",
                  num_resolutions=6, codeblock_size=(64, 64), precinct_size=(256, 256),
                  quality_mode="rates", quality_layers=PAGE_RATES, plt=True,
                  tile_size=(1024, 1024), mct=1)


def main():
    import PIL

    spec = {"made_with": f"OpenCV {cv2.__version__}; written by Pillow {PIL.__version__} and "
                         f"libopenjp2.so.7", "decode": {}, "none": [], "pages": {}}
    for name in os.listdir(HERE):
        if name.endswith((".jp2", ".j2k")):
            os.remove(os.path.join(HERE, name))
    decoded, none = files()
    for name, data in {**decoded, **none}.items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if name in none:
            assert img is None, name
            spec["none"].append(name)
        else:
            assert img is not None, name
            spec["decode"][name] = {"shape": list(img.shape),
                                    "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    path = os.path.join(os.path.dirname(HERE), PAGE)
    with open(path, "wb") as f:
        f.write(page())
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    spec["pages"][PAGE] = {"shape": list(img.shape),
                           "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    spec["none"].sort()
    with open(os.path.join(HERE, "fixtures.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
