"""WebP files that neither cv2 nor Pillow writes, for the WebP tests and
``tests/data/webp/make_fixtures.py``.

- RIFF chunks: :func:`chunk` (padded to an even length), :func:`riff`
  (its size field may be made short or long), :func:`vp8x`,
  :func:`anim`, :func:`anmf`, and :func:`chunks` to take a file apart.
- A VP8 rewriter: :func:`parse_vp8` reads a key frame's header, every
  macroblock's modes and every block's tokens with a Python boolean
  decoder (RFC 6386); :func:`write_vp8` writes them back with a Python
  boolean encoder, after the caller has changed the header: the loop
  filter's type, level and sharpness, the mode and reference deltas,
  the number of token partitions (1, 2, 4 or 8), the segment header
  (updates with or without a segment map).  The tokens and modes are
  kept, so the file is cv2's own with another header; cv2 reading it is
  the oracle.  libwebp's encoder writes none of these.

The probability tables are read from ``pero_ocr_tpu_torch/csrc/webp.cpp``
(a wrong table there shows as a file cv2 reads otherwise than the port).
"""

import copy
import os
import re
import struct

import numpy as np

_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "pero_ocr_tpu_torch", "csrc", "webp.cpp")


def _table(name: str, shape) -> np.ndarray:
    with open(_SOURCE, encoding="utf-8") as f:
        text = f.read()
    body = re.search(re.escape(name) + r"\[[^=]*=\s*\{(.*?)\};", text, re.S).group(1)
    return np.array([int(v) for v in re.findall(r"\d+", body)], np.int64).reshape(shape)


B_MODES_PROBA = _table("kBModesProba", (10, 10, 9))
COEFFS_PROBA0 = _table("kCoeffsProba0", (4, 8, 3, 11))
COEFFS_UPDATE_PROBA = _table("kCoeffsUpdateProba", (4, 8, 3, 11))
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
           (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's mode numbers
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
DC_PRED, TM_PRED, V_PRED, H_PRED = B_DC, B_TM, B_VE, B_HE
# The 4x4 mode tree: node -> (child for 0, child for 1); a leaf is -mode - 1.
_BMODE_TREE = {0: (-B_DC - 1, 1), 1: (-B_TM - 1, 2), 2: (-B_VE - 1, 3), 3: (4, 6), 4: (-B_HE - 1, 5),
               5: (-B_RD - 1, -B_VR - 1), 6: (-B_LD - 1, 7), 7: (-B_VL - 1, 8), 8: (-B_HD - 1, -B_HU - 1)}


# ----------------------------------------------------------------------
# RIFF chunks
def chunk(tag: bytes, payload: bytes, size: int = None) -> bytes:
    """A chunk, its payload padded to an even length; ``size`` writes
    another size field."""
    body = tag + struct.pack("<I", len(payload) if size is None else size) + payload
    return body + b"\0" if len(payload) & 1 else body


def riff(body: bytes, extra: int = 0) -> bytes:
    """RIFF + WEBP around ``body``; the size field ``extra`` bytes long."""
    return b"RIFF" + struct.pack("<I", 4 + len(body) + extra) + b"WEBP" + body


def vp8x(flags: int, width: int, height: int) -> bytes:
    return chunk(b"VP8X", struct.pack("<I", flags) + (width - 1).to_bytes(3, "little")
                 + (height - 1).to_bytes(3, "little"))


def anim(background: int = 0, loops: int = 0) -> bytes:
    return chunk(b"ANIM", struct.pack("<IH", background, loops))


def anmf(x: int, y: int, width: int, height: int, inner: bytes, duration: int = 100,
         flags: int = 0) -> bytes:
    """An animation frame at (2x, 2y); flags bit 0 disposes to the
    background, bit 1 turns blending off."""
    return chunk(b"ANMF", x.to_bytes(3, "little") + y.to_bytes(3, "little")
                 + (width - 1).to_bytes(3, "little") + (height - 1).to_bytes(3, "little")
                 + duration.to_bytes(3, "little") + bytes([flags]) + inner)


def chunks(data: bytes):
    """[(tag, payload)] of a RIFF WEBP file's top-level chunks."""
    pos, out = 12, []
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def payload(data: bytes, tag: bytes) -> bytes:
    return dict(chunks(data))[tag]


# ----------------------------------------------------------------------
# The boolean coder (RFC 6386, 7)
class BoolDecoder:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = int.from_bytes(data[:2].ljust(2, b"\0"), "big")
        self.range, self.count = 255, 0

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            bit, self.range, self.value = 1, self.range - split, self.value - big
        else:
            bit, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
        return bit

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def flagged(self, n: int, signed: bool = False):
        """A value behind a one-bit flag: None where the flag is 0."""
        if not self.bit(128):
            return None
        return self.signed(n) if signed else self.literal(n)


class BoolEncoder:
    """The arithmetic coder the decoder above inverts: the interval's low
    end as an exact integer, written out with enough bytes that
    libwebp's reader never runs past them."""

    def __init__(self):
        self.low, self.range, self.shifts = 0, 255, 0

    def bit(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.low += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            self.low <<= 1
            self.shifts += 1

    def literal(self, n: int, v: int) -> None:
        for i in reversed(range(n)):
            self.bit(128, (v >> i) & 1)

    def signed(self, n: int, v: int) -> None:
        self.literal(n, abs(v))
        self.bit(128, v < 0)

    def flagged(self, n: int, v, signed: bool = False) -> None:
        self.bit(128, v is not None)
        if v is not None:
            (self.signed if signed else self.literal)(n, v)

    def bytes(self) -> bytes:
        nbytes = (self.shifts + 8 + 7) // 8 + 1
        return (self.low << (8 * nbytes - 8 - self.shifts)).to_bytes(nbytes, "big")


# ----------------------------------------------------------------------
# The VP8 key frame
class VP8Frame:
    """A parsed key frame: ``header`` (the first partition's fields, each
    flagged value None where its flag is 0), ``mbs`` (per macroblock:
    segment, skip, is_i4x4, modes, uv mode) and ``blocks`` (per
    macroblock: [(type, ctx, first, values, stop)] of its coded blocks)."""

    def __init__(self):
        self.tag_bits = 0
        self.width = self.height = 0
        self.scale = (0, 0)
        self.header = {}
        self.mbs = []
        self.blocks = []

    @property
    def mb_w(self) -> int:
        return (self.width + 15) >> 4

    @property
    def mb_h(self) -> int:
        return (self.height + 15) >> 4


def _header_fields(coder, h: dict, write: bool) -> None:
    """The first partition's header, read into or written from ``h``."""
    def field(name, n=1, kind="literal"):
        if write:
            v = h[name]
            if kind == "literal":
                coder.literal(n, v)
            elif kind == "signed":
                coder.signed(n, v)
            else:
                coder.flagged(n, v, kind == "flag_signed")
        else:
            if kind == "literal":
                h[name] = coder.literal(n)
            elif kind == "signed":
                h[name] = coder.signed(n)
            else:
                h[name] = coder.flagged(n, kind == "flag_signed")
        return h[name]

    field("colorspace")
    field("clamp")
    if field("use_segment"):
        update_map = field("update_map")
        if field("update_data"):
            field("absolute_delta")
            for s in range(4):
                field(f"quantizer{s}", 7, "flag_signed")
            for s in range(4):
                field(f"filter_strength{s}", 6, "flag_signed")
        if update_map:
            for s in range(3):
                field(f"segment_proba{s}", 8, "flag")
    field("simple")
    field("level", 6)
    field("sharpness", 3)
    if field("use_lf_delta") and field("lf_delta_update"):
        for i in range(4):
            field(f"ref_lf_delta{i}", 6, "flag_signed")
        for i in range(4):
            field(f"mode_lf_delta{i}", 6, "flag_signed")
    field("partitions", 2)
    field("base_q", 7)
    for name in ("dqy1_dc", "dqy2_dc", "dqy2_ac", "dquv_dc", "dquv_ac"):
        field(name, 4, "flag_signed")
    field("update_proba")
    if write:
        for t, b, c, p in np.ndindex(4, 8, 3, 11):
            v = h["proba_updates"].get((t, b, c, p))
            coder.bit(int(COEFFS_UPDATE_PROBA[t, b, c, p]), v is not None)
            if v is not None:
                coder.literal(8, v)
    else:
        h["proba_updates"] = {}
        for t, b, c, p in np.ndindex(4, 8, 3, 11):
            if coder.bit(int(COEFFS_UPDATE_PROBA[t, b, c, p])):
                h["proba_updates"][(t, b, c, p)] = coder.literal(8)
    field("skip_proba", 8, "flag")


def _probas(h: dict) -> np.ndarray:
    probas = COEFFS_PROBA0.copy()
    for key, v in h["proba_updates"].items():
        probas[key] = v
    return probas


def _segment_probas(h: dict):
    return [255 if h.get(f"segment_proba{s}") is None else h[f"segment_proba{s}"] for s in range(3)]


def _modes(coder, frame: VP8Frame, write: bool) -> None:
    """Every macroblock's header in partition 0."""
    h = frame.header
    seg_p = _segment_probas(h)
    update_map = h["use_segment"] and h["update_map"]
    skip_p = h["skip_proba"]
    intra_t = [B_DC] * (4 * frame.mb_w)
    for mb_y in range(frame.mb_h):
        intra_l = [B_DC] * 4
        for mb_x in range(frame.mb_w):
            mb = frame.mbs[mb_y * frame.mb_w + mb_x] if write else {}
            top = intra_t[4 * mb_x:4 * mb_x + 4]

            def bit(prob, value=None):
                if write:
                    coder.bit(prob, value)
                    return value
                return coder.bit(prob)

            if update_map:
                s = mb.get("segment", 0)
                if not bit(seg_p[0], s >> 1):
                    s = bit(seg_p[1], s & 1)
                else:
                    s = 2 + bit(seg_p[2], s & 1)
                mb["segment"] = s
            else:
                mb["segment"] = 0
            if skip_p is not None:
                mb["skip"] = bit(skip_p, mb.get("skip"))
            else:
                mb["skip"] = 0
            is_i4x4 = not bit(145, None if not write else int(not mb["is_i4x4"]))
            mb["is_i4x4"] = is_i4x4
            if not is_i4x4:
                y = mb.get("ymode")
                if bit(156, None if not write else int(y in (TM_PRED, H_PRED))):
                    y = TM_PRED if bit(128, None if not write else int(y == TM_PRED)) else H_PRED
                else:
                    y = V_PRED if bit(163, None if not write else int(y == V_PRED)) else DC_PRED
                mb["ymode"] = y
                top = [y] * 4
                intra_l = [y] * 4
            else:
                modes = mb.get("bmodes", [0] * 16)
                out = []
                for yy in range(4):
                    left = intra_l[yy]
                    for xx in range(4):
                        prob = B_MODES_PROBA[top[xx], left]
                        want = modes[4 * yy + xx]
                        node = 0
                        while node >= 0:
                            if write:
                                b = int(_path_bit(node, want))
                                coder.bit(int(prob[node]), b)
                            else:
                                b = coder.bit(int(prob[node]))
                            node = _BMODE_TREE[node][b]
                        left = -node - 1
                        top[xx] = left
                        out.append(left)
                    intra_l[yy] = left
                mb["bmodes"] = out
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            uv = mb.get("uvmode")
            if not bit(142, None if not write else int(uv != DC_PRED)):
                uv = DC_PRED
            elif not bit(114, None if not write else int(uv != V_PRED)):
                uv = V_PRED
            else:
                uv = TM_PRED if bit(183, None if not write else int(uv == TM_PRED)) else H_PRED
            mb["uvmode"] = uv
            if not write:
                frame.mbs.append(mb)


def _leaves(node: int):
    a, b = _BMODE_TREE[node]
    out = set()
    for child in (a, b):
        out |= {-child - 1} if child < 0 else _leaves(child)
    return out


def _path_bit(node: int, mode: int) -> bool:
    """The branch at ``node`` towards the leaf ``mode``."""
    zero = _BMODE_TREE[node][0]
    return not (zero < 0 and -zero - 1 == mode or zero >= 0 and mode in _leaves(zero))


def _read_block(br: BoolDecoder, probas, btype: int, ctx: int, first: int):
    values, n = [], first
    p = probas[btype, BANDS[n], ctx]
    while n < 16:
        if not br.bit(int(p[0])):
            return values, n
        while not br.bit(int(p[1])):
            values.append(0)
            n += 1
            if n == 16:
                return values, 16
            p = probas[btype, BANDS[n], 0]
        if not br.bit(int(p[2])):
            v, nctx = 1, 1
        else:
            nctx = 2
            if not br.bit(int(p[3])):
                v = 2 if not br.bit(int(p[4])) else 3 + br.bit(int(p[5]))
            elif not br.bit(int(p[6])):
                if not br.bit(int(p[7])):
                    v = 5 + br.bit(159)
                else:
                    v = 7 + 2 * br.bit(165)
                    v += br.bit(145)
            else:
                bit1 = br.bit(int(p[8]))
                bit0 = br.bit(int(p[9 + bit1]))
                cat = 2 * bit1 + bit0
                v = 0
                for prob in CAT3456[cat]:
                    v = 2 * v + br.bit(prob)
                v += 3 + (8 << cat)
        values.append(-v if br.bit(128) else v)
        n += 1
        p = probas[btype, BANDS[n], nctx]
    return values, 16


def _write_block(enc: BoolEncoder, probas, btype: int, ctx: int, first: int, values, stop: int):
    n = first
    p = probas[btype, BANDS[n], ctx]
    if stop == first:
        enc.bit(int(p[0]), 0)
        return
    enc.bit(int(p[0]), 1)
    for v in values:
        if v == 0:
            enc.bit(int(p[1]), 0)
            n += 1
            if n < 16:
                p = probas[btype, BANDS[n], 0]
            continue
        enc.bit(int(p[1]), 1)
        a = abs(v)
        if a == 1:
            enc.bit(int(p[2]), 0)
            nctx = 1
        else:
            enc.bit(int(p[2]), 1)
            nctx = 2
            if a <= 4:
                enc.bit(int(p[3]), 0)
                enc.bit(int(p[4]), a > 2)
                if a > 2:
                    enc.bit(int(p[5]), a - 3)
            else:
                enc.bit(int(p[3]), 1)
                if a <= 10:
                    enc.bit(int(p[6]), 0)
                    enc.bit(int(p[7]), a > 6)
                    if a <= 6:
                        enc.bit(159, a - 5)
                    else:
                        enc.bit(165, (a - 7) >> 1)
                        enc.bit(145, (a - 7) & 1)
                else:
                    enc.bit(int(p[6]), 1)
                    cat = 0 if a < 19 else 1 if a < 35 else 2 if a < 67 else 3
                    enc.bit(int(p[8]), cat >> 1)
                    enc.bit(int(p[9 + (cat >> 1)]), cat & 1)
                    extra = a - 3 - (8 << cat)
                    bits = CAT3456[cat]
                    for i, prob in enumerate(bits):
                        enc.bit(prob, (extra >> (len(bits) - 1 - i)) & 1)
        enc.bit(128, v < 0)
        n += 1
        if n < 16:
            p = probas[btype, BANDS[n], nctx]
            if n < stop:
                enc.bit(int(p[0]), 1)
            else:
                enc.bit(int(p[0]), 0)
                return


def _residuals(coder, frame: VP8Frame, mb_index: int, nz: dict, probas, write: bool):
    """One macroblock's blocks, with the non-zero contexts as libwebp
    keeps them in ``nz`` (top per column, left per row)."""
    mb = frame.mbs[mb_index]
    mb_x = mb_index % frame.mb_w
    top, left = nz["top"][mb_x], nz["left"]
    blocks = frame.blocks[mb_index] if write else []
    k = 0

    def block(btype, ctx, first):
        nonlocal k
        if write:
            t, c, f, values, stop = blocks[k]
            _write_block(coder, probas, t, c, f, values, stop)
        else:
            values, stop = _read_block(coder, probas, btype, ctx, first)
            blocks.append((btype, ctx, first, values, stop))
            t, c, f, values, stop = blocks[-1]
        k += 1
        return stop

    if not mb["is_i4x4"]:
        stop = block(1, top["dc"] + left["dc"], 0)
        top["dc"] = left["dc"] = int(stop > 0)
        first, ac_type = 1, 0
    else:
        first, ac_type = 0, 3
    for y in range(4):
        for x in range(4):
            ctx = left["y"][y] + top["y"][x]
            stop = block(ac_type, ctx, first)
            left["y"][y] = top["y"][x] = int(stop > first)
    for ch in ("u", "v"):
        for y in range(2):
            for x in range(2):
                ctx = left[ch][y] + top[ch][x]
                stop = block(2, ctx, 0)
                left[ch][y] = top[ch][x] = int(stop > 0)
    if not write:
        frame.blocks[mb_index] = blocks


def _fresh_nz():
    return {"y": [0] * 4, "u": [0] * 2, "v": [0] * 2, "dc": 0}


def _tokens(parts, frame: VP8Frame, write: bool) -> None:
    probas = _probas(frame.header)
    skip_used = frame.header["skip_proba"] is not None
    top = [_fresh_nz() for _ in range(frame.mb_w)]
    nparts = len(parts)
    for mb_y in range(frame.mb_h):
        left = _fresh_nz()
        coder = parts[mb_y % nparts]
        for mb_x in range(frame.mb_w):
            i = mb_y * frame.mb_w + mb_x
            mb = frame.mbs[i]
            if skip_used and mb["skip"]:
                for ctx in (top[mb_x], left):
                    ctx["y"], ctx["u"], ctx["v"] = [0] * 4, [0] * 2, [0] * 2
                    if not mb["is_i4x4"]:
                        ctx["dc"] = 0
                if not write:
                    frame.blocks[i] = []
                continue
            _residuals(coder, frame, i, {"top": top, "left": left}, probas, write)


def parse_vp8(data: bytes) -> VP8Frame:
    """A VP8 key frame (a ``VP8 `` chunk's payload) taken apart."""
    frame = VP8Frame()
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    frame.tag_bits = bits & 0x1F
    first_size = bits >> 5
    assert data[3:6] == b"\x9d\x01\x2a" and not bits & 1
    w, h = struct.unpack("<HH", data[6:10])
    frame.width, frame.height, frame.scale = w & 0x3FFF, h & 0x3FFF, (w >> 14, h >> 14)
    br = BoolDecoder(data[10:10 + first_size])
    _header_fields(br, frame.header, write=False)
    frame.blocks = [None] * (frame.mb_w * frame.mb_h)
    _modes(br, frame, write=False)
    rest = data[10 + first_size:]
    nparts = 1 << frame.header["partitions"]
    sizes = [int.from_bytes(rest[3 * i:3 * i + 3], "little") for i in range(nparts - 1)]
    pos, parts = 3 * (nparts - 1), []
    for size in sizes:
        parts.append(BoolDecoder(rest[pos:pos + size]))
        pos += size
    parts.append(BoolDecoder(rest[pos:]))
    _tokens(parts, frame, write=False)
    return frame


def write_vp8(frame: VP8Frame) -> bytes:
    """The key frame's bytes (a ``VP8 `` chunk's payload)."""
    first = BoolEncoder()
    _header_fields(first, frame.header, write=True)
    _modes(first, frame, write=True)
    first_bytes = first.bytes()
    nparts = 1 << frame.header["partitions"]
    encoders = [BoolEncoder() for _ in range(nparts)]
    _tokens(encoders, frame, write=True)
    parts = [e.bytes() for e in encoders]
    tag = frame.tag_bits | (len(first_bytes) << 5)
    head = bytes([tag & 0xFF, (tag >> 8) & 0xFF, tag >> 16]) + b"\x9d\x01\x2a"
    head += struct.pack("<HH", frame.width | (frame.scale[0] << 14), frame.height | (frame.scale[1] << 14))
    sizes = b"".join(len(p).to_bytes(3, "little") for p in parts[:-1])
    return head + first_bytes + sizes + b"".join(parts)


def rewrite(data: bytes, **changes) -> bytes:
    """A simple lossy WebP file (cv2's) with its VP8 header fields set as
    ``changes`` name them (keys of :class:`VP8Frame`'s header, or
    ``segments_without_map=(quantizers, strengths, absolute)``), as a
    simple lossy WebP file."""
    frame = copy.deepcopy(parse_vp8(payload(data, b"VP8 ")))
    h = frame.header
    seg = changes.pop("segments_without_map", None)
    if seg is not None:
        quantizers, strengths, absolute = seg
        h.update(use_segment=1, update_map=0, update_data=1, absolute_delta=int(absolute))
        for s in range(4):
            h[f"quantizer{s}"], h[f"filter_strength{s}"] = quantizers[s], strengths[s]
    if changes.get("use_lf_delta") and "lf_delta_update" not in changes:
        changes["lf_delta_update"] = 1
    for key, value in changes.items():
        h[key] = value
    if h.get("use_lf_delta") and h.get("lf_delta_update"):
        for i in range(4):
            h.setdefault(f"ref_lf_delta{i}", None)
            h.setdefault(f"mode_lf_delta{i}", None)
    return riff(chunk(b"VP8 ", write_vp8(frame)))


# ----------------------------------------------------------------------
# ALPH chunks and seeded mutations
def alph_filter(alpha: np.ndarray, method: int) -> np.ndarray:
    """The residuals of libwebp's alpha filter ``method`` (0 none,
    1 horizontal, 2 vertical, 3 gradient), whose unfilter gives
    ``alpha`` back."""
    a = alpha.astype(np.int64)
    out = np.empty_like(a)
    h, w = a.shape
    for y in range(h):
        for x in range(w):
            if method == 0:
                pred = 0
            elif y == 0:
                pred = 0 if x == 0 else a[y, x - 1]
            elif x == 0:
                pred = a[y - 1, 0]
            elif method == 1:
                pred = a[y, x - 1]
            elif method == 2:
                pred = a[y - 1, x]
            else:
                pred = min(max(a[y, x - 1] + a[y - 1, x] - a[y - 1, x - 1], 0), 255)
            out[y, x] = (a[y, x] - pred) & 0xFF
    return out.astype(np.uint8)


def alph_raw(alpha: np.ndarray, method: int, preprocessing: int = 0) -> bytes:
    """An ALPH payload of raw (uncompressed) filtered alpha."""
    return bytes([(preprocessing << 4) | (method << 2)]) + alph_filter(alpha, method).tobytes()


def alph_lossless(alpha: np.ndarray, method: int, vp8l_image_stream: bytes, preprocessing: int = 0) -> bytes:
    """An ALPH payload of compression 1: ``vp8l_image_stream`` is a VP8L
    bitstream without its 5-byte header whose green channel holds
    :func:`alph_filter`'s residuals."""
    return bytes([(preprocessing << 4) | (method << 2) | 1]) + vp8l_image_stream


def cut(data: bytes, length: int) -> bytes:
    """The first ``length`` bytes with the RIFF size made theirs: a file
    cut short whose container still adds up."""
    return data[:4] + max(length - 8, 0).to_bytes(4, "little") + data[8:length]


def mutation_rng(seed: int, name: str) -> np.random.Generator:
    """The generator of ``name``'s mutations: seeded by the seed and the
    base's file name, so each base's mutations stand alone."""
    return np.random.default_rng([seed, *name.encode()])


def mutate(data: bytes, rng: np.random.Generator) -> bytes:
    """1 to 3 bytes past the RIFF header replaced or with a bit flipped."""
    d = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        i = int(rng.integers(12, len(d)))
        if rng.random() < 0.5:
            d[i] = int(rng.integers(0, 256))
        else:
            d[i] ^= 1 << int(rng.integers(0, 8))
    return bytes(d)
