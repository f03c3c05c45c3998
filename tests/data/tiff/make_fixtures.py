"""Write the TIFF fixtures of this folder and their digests.

    python3 tests/data/tiff/make_fixtures.py

Needs cv2 (OpenCV 5, libtiff 4.7) and PIL with libtiff, and runs where
the tests run, never on the card's machine.  PIL's libtiff writes the
pages of each compression it offers (none, LZW and Deflate with and
without Predictor 2, PackBits, CCITT Modified Huffman, T.4 1D and 2D,
T.6 and JPEG), 16-bit gray, gray+alpha, RGBA, palette and a two-page
file.  :func:`write_tiff`, a writer of the container from strips or
tiles already compressed, makes what PIL does not write: tiles,
PlanarConfiguration 2, big-endian files, BigTIFF, 16-bit RGB(A),
sub-byte gray and palette, FillOrder 2, YCbCr JPEG with shared
JPEGTables, other alpha kinds and the Orientation tag; its compressed
chunks come from zlib, a PackBits coder here, and PIL (LZW, CCITT) or
cv2 (JPEG) on a chunk-sized image.  ``a4_g4_text.tif`` is an A4
300-dpi page of text as a bilevel T.6 (Group 4) file.

``fixtures.json``: for each file the sha256 and shape of
``cv2.imread(path, 1)``'s array, and under ``none`` the files for which
it returns None.  tests/test_torch_tiff.py holds the port's reader to
the JSON and to cv2 on the CPU, ``chip_smoke.check_tiff_fixtures`` on
the card's machine.
"""

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from pero_ocr_tpu_torch.utils.tiff import Directory  # noqa: E402

H, W = 23, 37  # odd sizes: partial last strips and edge tiles
TILE = 16


# ----------------------------------------------------------------------
# The container
def write_tiff(tags: dict, chunks, order: str = "<", big: bool = False, tiled: bool = False,
               pages: int = 1) -> bytes:
    """A TIFF file: ``tags`` {tag: (type, values or bytes)} plus the
    chunks' offsets and byte counts (strips, or tiles with ``tiled``), in
    ``order`` ("<" II, ">" MM), classic or BigTIFF.  ``pages`` > 1
    chains copies of the directory (a multi-page file)."""
    head = 16 if big else 8
    blob = bytearray(head)
    offsets = []
    for chunk in chunks:
        offsets.append(len(blob))
        blob += chunk
        if len(blob) % 2:
            blob += b"\0"
    long_type = 16 if big else 4
    tags = dict(tags)
    tags[324 if tiled else 273] = (long_type, offsets)
    tags[325 if tiled else 279] = (long_type, [len(c) for c in chunks])
    inline = 8 if big else 4
    ifd_offsets = []
    for page in range(pages):
        entries = []
        for tag in sorted(tags):
            kind, values = tags[tag]
            if isinstance(values, (bytes, bytearray)):
                raw, count = bytes(values), len(values)
            else:
                code = {3: "H", 4: "I", 16: "Q", 5: "I", 1: "B"}[kind]
                raw = struct.pack(f"{order}{len(values)}{code}", *values)
                count = len(values) // (2 if kind == 5 else 1)
            if len(raw) <= inline:
                field = raw.ljust(inline, b"\0")
            else:
                field = struct.pack(order + ("Q" if big else "I"), len(blob))
                blob += raw
                if len(blob) % 2:
                    blob += b"\0"
            entries.append(struct.pack(order + ("HHQ" if big else "HHI"), tag, kind, count)
                           + field)
        ifd_offsets.append(len(blob))
        blob += struct.pack(order + ("Q" if big else "H"), len(entries)) + b"".join(entries)
        blob += b"\0" * (8 if big else 4)  # next IFD, patched below
    for page, at in enumerate(ifd_offsets):
        nxt = ifd_offsets[page + 1] if page + 1 < len(ifd_offsets) else 0
        end = at + (8 if big else 2) + len(tags) * (20 if big else 12)
        blob[end:end + (8 if big else 4)] = struct.pack(order + ("Q" if big else "I"), nxt)
    if big:
        blob[:16] = (b"II" if order == "<" else b"MM") + struct.pack(order + "HHHQ", 43, 8, 0,
                                                                    ifd_offsets[0])[:14]
    else:
        blob[:8] = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42,
                                                                    ifd_offsets[0])
    return bytes(blob)


def base_tags(h, w, bps, spp, photometric, compression, rows=None, tile=None, planar=1,
              big=False, **more):
    """The usual tags; ``more`` adds tag numbers given as ``t<number>``
    = (type, values)."""
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if tile:
        tags[322], tags[323] = (3, [tile[0]]), (3, [tile[1]])
    else:
        tags[278] = (4, [rows or h])
    for key, value in more.items():
        tags[int(key[1:])] = value
    return tags


def pack_rows(samples: np.ndarray, bps: int, order: str) -> np.ndarray:
    """(h, w, n) samples -> (h, row_bytes) bytes as TIFF stores them."""
    h, w, n = samples.shape
    if bps == 16:
        return samples.astype(order + "u2").reshape(h, w * n).view(np.uint8)
    if bps == 8:
        return samples.astype(np.uint8).reshape(h, w * n)
    flat = samples.reshape(h, w * n).astype(np.uint8)
    bits = (flat[:, :, None] >> np.arange(bps - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def differences(samples: np.ndarray) -> np.ndarray:
    """Predictor 2's horizontal differences, wrapping."""
    out = samples.copy()
    out[:, 1:] = samples[:, 1:] - samples[:, :-1]
    return out


def chunks_of(samples, bps, compress, order="<", rows=None, tile=None, planar=1,
              predictor=False):
    """The page's strips (``rows`` a strip) or tiles, each
    ``compress(raw bytes, (h, w, n) samples)``'d; with PlanarConfiguration
    2 all of the first sample's chunks, then the second's, ...."""
    h, w, n = samples.shape
    planes = [samples[:, :, k:k + 1] for k in range(n)] if planar == 2 else [samples]
    out = []
    for plane in planes:
        if tile:
            tw, th = tile
            padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw, plane.shape[2]), plane.dtype)
            padded[:h, :w] = plane
            parts = [padded[y:y + th, x:x + tw] for y in range(0, h, th)
                     for x in range(0, w, tw)]
        else:
            r = rows or h
            parts = [plane[y:y + r] for y in range(0, h, r)]
        for part in parts:
            if predictor:
                part = differences(part)
            out.append(compress(pack_rows(part, bps, order).tobytes(), part))
    return out


def packbits(raw: bytes) -> bytes:
    """A PackBits coder: runs of 3 or more equal bytes as repeats, the
    rest as literals of at most 128."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        j = i
        while j < n and j - i < 128 and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            out += bytes([(1 - (j - i)) & 0xFF, raw[i]])
            i = j
            continue
        start = i
        while i < n and i - start < 128 and not (i + 2 < n and raw[i] == raw[i + 1] == raw[i + 2]):
            i += 1
        out += bytes([i - start - 1]) + raw[start:i]
    return bytes(out)


def pil_strip(image, compression: str, **kw):
    """The one strip (and JPEGTables) of a PIL-written TIFF of
    ``image``."""
    buf = io.BytesIO()
    image.save(buf, format="TIFF", compression=compression, strip_size=1 << 30, **kw)
    data = buf.getvalue()
    d = Directory(data)
    (offset,), (count,) = d.values(273), d.values(279)
    return data[offset:offset + count], d.tags.get(347)


def lzw(raw: bytes, _=None) -> bytes:
    """libtiff's LZW of a byte string (PIL, as a one-row gray image)."""
    from PIL import Image

    return pil_strip(Image.frombytes("L", (len(raw), 1), raw), "tiff_lzw")[0]


def ccitt(compression: str, t4=None):
    """A chunk coder: libtiff's CCITT coding of the chunk's 1-bit
    samples (PIL, with T4Options ``t4``)."""
    from PIL import Image, TiffImagePlugin

    def code(_raw, part):
        info = TiffImagePlugin.ImageFileDirectory_v2()
        if t4 is not None:
            info[292] = t4
        bits = part[:, :, 0].astype(bool)
        return pil_strip(Image.fromarray(bits), compression, tiffinfo=info)[0]
    return code


def split_jpeg(data: bytes):
    """A JPEG interchange stream -> (tables-only stream: SOI, DQT, DHT,
    EOI; the abbreviated image stream without them)."""
    tables, image, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xDA:
            image += data[pos:]
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        segment = data[pos:pos + 2 + length]
        (tables if marker in (0xDB, 0xC4) else image).extend(segment)
        pos += 2 + length
    return bytes(tables + b"\xff\xd9"), bytes(image)


def jpeg_chunks(samples, tile=None, rows=None, quality=90):
    """YCbCr (three samples, cv2's 4:2:0) or gray JPEG chunks sharing
    their tables: (chunks, JPEGTables)."""
    import cv2

    tables = None
    out = []
    for raw in chunks_of(samples, 8, lambda raw, part: part, rows=rows, tile=tile):
        img = raw[:, :, ::-1] if raw.shape[2] == 3 else raw[:, :, 0]
        ok, data = cv2.imencode(".jpg", np.ascontiguousarray(img),
                                [cv2.IMWRITE_JPEG_QUALITY, quality])
        t, image = split_jpeg(data.tobytes())
        assert tables in (None, t)
        tables = t
        out.append(image)
    return out, tables


# ----------------------------------------------------------------------
# Pages
def smooth(h, w, n, top=255, seed=0):
    """Gradients plus noise, different in each sample."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 7 + y * 5)[:, :, None] * (top // 255 or 1) + np.arange(n) * (top // 5)
    noise = rng.integers(0, max(top // 16, 2), (h, w, n))
    return ((base + noise) % (top + 1)).astype(np.uint16 if top > 255 else np.uint8)


def blobs(h, w, seed=0):
    """A bilevel page: random rectangles and noise, 1 = black."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.uint8)
    for _ in range(12):
        y, x = rng.integers(0, h), rng.integers(0, w)
        img[y:y + rng.integers(1, 8), x:x + rng.integers(1, 20)] = 1
    img ^= (rng.random((h, w)) < 0.05).astype(np.uint8)
    return img[:, :, None]


def text_page(h=3508, w=2480, seed=0):
    """An A4 page at 300 dpi: rows of random words in cv2's Hershey
    font, 1 = black."""
    import cv2

    rng = np.random.default_rng(seed)
    page = np.full((h, w), 255, np.uint8)
    letters = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    for y in range(260, h - 250, 70):
        x = 200
        while x < w - 400:
            word = "".join(rng.choice(list(letters), rng.integers(2, 10)))
            cv2.putText(page, word, (int(x), int(y)), cv2.FONT_HERSHEY_SIMPLEX, 1.4, 0, 3)
            x += 40 * len(word) + 40
    return (page < 128).astype(np.uint8)[:, :, None]


def pil_page(image, compression, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, format="TIFF", compression=compression, **kw)
    return buf.getvalue()


def fixtures() -> dict:
    """name -> file bytes."""
    from PIL import Image, TiffImagePlugin

    rgb = smooth(H, W, 3, seed=1)
    gray = smooth(H, W, 1, seed=2)
    bw = blobs(H, W, seed=3)
    out = {}
    pred = TiffImagePlugin.ImageFileDirectory_v2()
    pred[317] = 2
    # PIL's libtiff, one compression at a time
    for name, comp in (("none", "raw"), ("lzw", "tiff_lzw"), ("deflate", "tiff_deflate"),
                       ("adobe_deflate", "tiff_adobe_deflate"), ("packbits", "packbits"),
                       ("jpeg", "jpeg")):
        out[f"pil_rgb_{name}"] = pil_page(Image.fromarray(rgb), comp)
        out[f"pil_gray_{name}"] = pil_page(Image.fromarray(gray[:, :, 0]), comp)
    out["pil_rgb_lzw_predictor"] = pil_page(Image.fromarray(rgb), "tiff_lzw", tiffinfo=pred)
    out["pil_gray_deflate_predictor"] = pil_page(Image.fromarray(gray[:, :, 0]),
                                                 "tiff_adobe_deflate", tiffinfo=pred)
    bits = Image.fromarray(bw[:, :, 0].astype(bool))
    for name, comp, t4 in (("none", "raw", None), ("mh", "tiff_ccitt", None),
                           ("g3_1d", "group3", None), ("g3_2d", "group3", 1),
                           ("g3_2d_fill", "group3", 5), ("g3_1d_fill", "group3", 4),
                           ("g4", "group4", None), ("lzw", "tiff_lzw", None),
                           ("packbits", "packbits", None)):
        info = TiffImagePlugin.ImageFileDirectory_v2()
        if t4 is not None:
            info[292] = t4
        out[f"pil_bilevel_{name}"] = pil_page(bits, comp, tiffinfo=info)
    out["pil_gray16"] = pil_page(Image.fromarray(smooth(H, W, 1, 65535, 4)[:, :, 0]), "raw")
    out["pil_gray_alpha"] = pil_page(Image.fromarray(smooth(H, W, 2, seed=5), "LA"), "raw")
    out["pil_rgba_unassociated"] = pil_page(Image.fromarray(smooth(H, W, 4, seed=6), "RGBA"),
                                            "tiff_lzw")
    out["pil_palette"] = pil_page(Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE),
                                  "tiff_lzw")
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="TIFF", save_all=True,
                              append_images=[Image.fromarray(255 - rgb)])
    out["pil_two_pages"] = buf.getvalue()

    # The hand writer
    def page(samples, bps, photometric, compression, coder, order="<", big=False, rows=None,
             tile=None, planar=1, predictor=False, **more):
        h, w, n = samples.shape
        tags = base_tags(h, w, bps, n, photometric, compression, rows, tile, planar, **more)
        if predictor:
            tags[317] = (3, [2])
        return write_tiff(tags, chunks_of(samples, bps, coder, order, rows, tile, planar,
                                          predictor), order, big, tiled=tile is not None)

    none = lambda raw, _: raw  # noqa: E731
    deflate = lambda raw, _: zlib.compress(raw, 6)  # noqa: E731
    pb = lambda raw, _: packbits(raw)  # noqa: E731
    tile = (TILE, TILE)
    out["tiles_rgb_lzw"] = page(rgb, 8, 2, 5, lzw, tile=tile)
    out["tiles_gray_deflate_predictor"] = page(gray, 8, 1, 8, deflate, tile=tile, predictor=True)
    out["tiles_bilevel_g4_miniswhite"] = page(bw, 1, 0, 4, ccitt("group4"), tile=tile)
    out["tiles_bilevel_g3_2d"] = page(bw, 1, 0, 3, ccitt("group3", 1), tile=tile,
                                      t292=(4, [1]))
    out["strips_bilevel_g4_miniswhite"] = page(bw, 1, 0, 4, ccitt("group4"), rows=8)
    out["strips_bilevel_mh_miniswhite"] = page(bw, 1, 0, 2, ccitt("tiff_ccitt"), rows=5)
    out["strips_rgb_packbits"] = page(rgb, 8, 2, 32773, pb, rows=4)
    out["strips_gray_none"] = page(gray, 8, 1, 1, none, rows=7)
    chunks, tables = jpeg_chunks(rgb, rows=8)
    out["strips_jpeg_ycbcr"] = write_tiff(
        base_tags(H, W, 8, 3, 6, 7, 8, t347=(7, tables), t530=(3, [2, 2])), chunks)
    chunks, tables = jpeg_chunks(rgb, tile=tile)
    out["tiles_jpeg_ycbcr"] = write_tiff(
        base_tags(H, W, 8, 3, 6, 7, tile=tile, t347=(7, tables), t530=(3, [2, 2])), chunks,
        tiled=True)
    chunks, tables = jpeg_chunks(gray, rows=16)
    out["strips_jpeg_gray_miniswhite"] = write_tiff(
        base_tags(H, W, 8, 1, 0, 7, 16, t347=(7, tables)), chunks)
    out["planar_rgb_packbits"] = page(rgb, 8, 2, 32773, pb, rows=8, planar=2)
    rgba16 = smooth(H, W, 4, 65535, seed=7)
    out["planar_rgba16_unassociated_deflate"] = page(rgba16, 16, 2, 8, deflate, planar=2,
                                                     rows=8, t338=(3, [2]))
    gray_alpha = smooth(H, W, 2, seed=8)
    out["planar_gray_alpha_miniswhite"] = page(gray_alpha, 8, 0, 1, none, planar=2,
                                               t338=(3, [2]))
    out["planar_gray16_alpha_associated"] = page(smooth(H, W, 2, 65535, seed=9), 16, 1, 1, none,
                                                 planar=2, t338=(3, [1]))
    for order, tag in (("<", "le"), (">", "be")):
        out[f"rgb16_lzw_predictor_{tag}"] = page(smooth(H, W, 3, 65535, seed=10), 16, 2, 5, lzw,
                                                 order=order, rows=9, predictor=True)
        out[f"gray16_miniswhite_{tag}"] = page(smooth(H, W, 1, 65535, seed=11), 16, 0, 1, none,
                                               order=order, rows=9)
        out[f"bigtiff_rgb_deflate_{tag}"] = page(rgb, 8, 2, 32946, deflate, order=order,
                                                 big=True, rows=10, tile=None)
        out[f"bigtiff_tiles_gray_lzw_{tag}"] = page(gray, 8, 1, 5, lzw, order=order, big=True,
                                                    tile=tile)
    out["big_endian_bilevel_g4"] = page(bw, 1, 0, 4, ccitt("group4"), order=">", rows=12)
    out["rgba16_unassociated"] = page(rgba16, 16, 2, 1, none, t338=(3, [2]))
    out["rgba16_associated"] = page(rgba16, 16, 2, 1, none, t338=(3, [1]))
    rgba = smooth(H, W, 4, seed=12)
    out["rgba_associated"] = page(rgba, 8, 2, 5, lzw, t338=(3, [1]))
    out["rgba_unspecified"] = page(rgba, 8, 2, 5, lzw, t338=(3, [0]))
    out["rgb_extra_without_extrasamples"] = page(rgba, 8, 2, 1, none)
    out["gray_alpha_unspecified"] = page(gray_alpha, 8, 1, 1, none, t338=(3, [0]))
    out["gray16_alpha_unassociated"] = page(smooth(H, W, 2, 65535, seed=13), 16, 1, 8, deflate,
                                            t338=(3, [2]))
    rng = np.random.default_rng(14)
    for bps in (1, 2, 4):
        top = (1 << bps) - 1
        levels = rng.integers(0, top + 1, (H, W, 1)).astype(np.uint8)
        out[f"gray{bps}_minisblack"] = page(levels, bps, 1, 1, none, rows=6)
        out[f"gray{bps}_miniswhite_packbits"] = page(levels, bps, 0, 32773, pb)
        cmap8 = rng.integers(0, 256, 3 * (top + 1))
        out[f"palette{bps}_8bit_colormap"] = page(levels, bps, 3, 5, lzw, t320=(3, list(cmap8)))
        cmap16 = rng.integers(0, 65536, 3 * (top + 1))
        out[f"palette{bps}_16bit_colormap"] = page(levels, bps, 3, 1, none,
                                                   t320=(3, list(cmap16)))
    idx = rng.integers(0, 256, (H, W, 1)).astype(np.uint8)
    out["palette8_16bit_colormap_tiles"] = page(idx, 8, 3, 8, deflate, tile=tile,
                                                t320=(3, list(rng.integers(0, 65536, 768))))
    for name, samples, bps, photometric, comp, coder in (
            ("bilevel_g4", bw, 1, 0, 4, ccitt("group4")),
            ("bilevel_g3_2d", bw, 1, 0, 3, ccitt("group3", 1)),
            ("bilevel_none", bw, 1, 0, 1, none), ("gray_lzw", gray, 8, 1, 5, lzw),
            ("gray_deflate", gray, 8, 1, 8, deflate),
            ("gray_packbits", gray, 8, 1, 32773, pb)):
        more = {"t292": (4, [1])} if comp == 3 else {}
        out[f"fillorder2_{name}"] = page(
            samples, bps, photometric, comp,
            lambda raw, part, c=coder: bytes(_REVERSE[np.frombuffer(c(raw, part), np.uint8)]),
            rows=9, t266=(3, [2]), **more)
    square = smooth(24, 24, 3, seed=15)
    for value in range(0, 10):
        out[f"orientation{value}"] = page(rgb, 8, 2, 1, none, t274=(3, [value]))
        out[f"orientation{value}_square"] = page(square, 8, 2, 1, none, t274=(3, [value]))
    for value in (2, 3, 4):
        out[f"orientation{value}_strips"] = page(rgb, 8, 2, 8, deflate, rows=5,
                                                 t274=(3, [value]))
        out[f"orientation{value}_tiles"] = page(rgb, 8, 2, 8, deflate, tile=tile,
                                                t274=(3, [value]))
    for value in (6, 7):
        out[f"orientation{value}_square_tiles"] = page(smooth(40, 40, 3, seed=16), 8, 2, 8,
                                                       deflate, tile=tile, t274=(3, [value]))
    a4 = text_page()
    out["a4_g4_text"] = page(a4, 1, 0, 4, ccitt("group4"),
                             rows=max(1, 8192 * 8 // a4.shape[1]))
    return out


_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def main() -> None:
    import cv2
    import PIL

    names = fixtures()
    for old in os.listdir(HERE):
        if old.endswith(".tif"):
            os.remove(os.path.join(HERE, old))
    spec = {"made_with": f"OpenCV {cv2.__version__}, PIL {PIL.__version__}",
            "decode": {}, "none": []}
    for name, data in sorted(names.items()):
        path = os.path.join(HERE, name + ".tif")
        with open(path, "wb") as f:
            f.write(data)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            spec["none"].append(name + ".tif")
            continue
        spec["decode"][name + ".tif"] = {"sha256": hashlib.sha256(img.tobytes()).hexdigest(),
                                         "shape": list(img.shape)}
    with open(os.path.join(HERE, "fixtures.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(len(d) for d in names.values())
    print(f"{len(names)} files, {total} bytes; cv2 returns None for {spec['none']}")


if __name__ == "__main__":
    main()
