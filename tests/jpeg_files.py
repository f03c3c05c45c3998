"""JPEG files that cv2 does not write, made with numpy and ``struct`` for
the tests of the port's JPEG decoder (tests/test_torch_jpeg.py,
tests/test_torch_cli.py) and for the committed fixtures
(tests/data/jpeg/make_fixtures.py).

- :func:`read_coefficients` reads the quantized coefficients of a
  one-scan baseline file (cv2's own output).
- :func:`arithmetic_file` codes such coefficients with the arithmetic
  coder of T.81 Annex D, as libjpeg's ``jcarith.c`` codes them:
  sequential (SOF9) or progressive (SOF10) with any scan script
  (spectral selection and successive approximation), restart intervals
  and DAC conditioning.  cv2 reads it to the pixels of the Huffman file
  the coefficients came from, which checks this writer without the port.
- :func:`huffman_file` codes them sequentially with Huffman tables made
  for the data (any precision, SOF1).
- :func:`lossless_file` codes samples losslessly with Huffman tables
  (SOF3): predictors 1-7, the point transform Pt, restart intervals, one
  scan or a scan a component.

Frames are lists of ``(id, h, v, tq)``; coefficients are ``{component
index: (block rows, block columns, 64)}`` arrays in zigzag order, as
:func:`read_coefficients` returns them (MCU-padded).
"""

import heapq
import struct

import numpy as np

SOI, EOI = b"\xff\xd8", b"\xff\xd9"
JFIF = (0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def adobe(transform: int):
    return (0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


# ----------------------------------------------------------------------
# Reading cv2's baseline files
def segments(data: bytes):
    """The marker segments of a JPEG file up to its first SOS: [(marker,
    body)], and the entropy-coded data after that SOS up to EOI."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((marker, data[pos + 4:pos + 2 + length]))
        pos += 2 + length
        if marker == 0xDA:
            return out, data[pos:data.rindex(EOI)]


def huffman_tables(body: bytes):
    """A DHT body -> {(class, id): (codes {(length, code): symbol},
    sizes {symbol: (length, code)}, the table's DHT body)}."""
    tables, pos = {}, 0
    while pos < len(body):
        tc, counts = body[pos], body[pos + 1:pos + 17]
        vals = body[pos + 17:pos + 17 + sum(counts)]
        pos += 17 + sum(counts)
        codes, code, k = {}, 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                codes[(length, code)] = vals[k]
                code, k = code + 1, k + 1
            code <<= 1
        tables[(tc >> 4, tc & 15)] = (codes, {s: lc for lc, s in codes.items()},
                                     bytes([tc]) + counts + vals)
    return tables


def read_coefficients(data: bytes):
    """A one-scan baseline file without restarts (cv2's output) ->
    (frame: [(id, h, v, tq)], height, width, {component index: (bh, bw,
    64) int zigzag coefficients}, the segments, the Huffman tables)."""
    segs, entropy = segments(data)
    tables = {}
    for marker, body in segs:
        if marker == 0xC4:
            tables.update(huffman_tables(body))
        if marker == 0xC0:
            height, width, n = struct.unpack(">HHB", body[1:6])
            frame = [tuple(body[6 + 3 * i:9 + 3 * i]) for i in range(n)]
            frame = [(i, hv >> 4, hv & 15, tq) for i, hv, tq in frame]
        if marker == 0xDA:
            scan = [(body[1 + 2 * i], body[2 + 2 * i]) for i in range(body[0])]
    bits = "".join(f"{b:08b}" for b in entropy.replace(b"\xff\x00", b"\xff"))
    pos = 0

    def symbol(codes):
        nonlocal pos
        for length in range(1, 17):
            key = (length, int(bits[pos:pos + length], 2))
            if key in codes:
                pos += length
                return codes[key]
        raise ValueError("bad code")

    def value(s):
        nonlocal pos
        if s == 0:
            return 0
        v = int(bits[pos:pos + s], 2)
        pos += s
        return v if v >= 1 << (s - 1) else v - (1 << s) + 1

    maxh, maxv = max(c[1] for c in frame), max(c[2] for c in frame)
    mcux, mcuy = -(-width // (8 * maxh)), -(-height // (8 * maxv))
    coefs = {i: np.zeros((mcuy * c[2], mcux * c[1], 64), int) for i, c in enumerate(frame)}
    pred = [0] * len(frame)
    index = {c[0]: i for i, c in enumerate(frame)}
    for my in range(mcuy):
        for mx in range(mcux):
            for cid, t in scan:
                i = index[cid]
                _, h, v, _ = frame[i]
                for by in range(v):
                    for bx in range(h):
                        blk = coefs[i][my * v + by, mx * h + bx]
                        pred[i] += value(symbol(tables[(0, t >> 4)][0]))
                        blk[0] = pred[i]
                        k = 1
                        while k < 64:
                            rs = symbol(tables[(1, t & 15)][0])
                            if rs & 15:
                                k += rs >> 4
                                blk[k] = value(rs & 15)
                            elif rs != 0xF0:
                                break
                            else:
                                k += 15
                            k += 1
    return frame, height, width, coefs, segs, tables


def quant_bodies(segs) -> list:
    return [body for marker, body in segs if marker == 0xDB]


# ----------------------------------------------------------------------
# Shared layout
def mcu_geometry(frame, height, width):
    maxh, maxv = max(c[1] for c in frame), max(c[2] for c in frame)
    return maxh, maxv, -(-width // (8 * maxh)), -(-height // (8 * maxv))


def component_blocks(frame, height, width, i):
    """(block rows, block columns) holding samples of component i."""
    maxh, maxv, _, _ = mcu_geometry(frame, height, width)
    _, h, v, _ = frame[i]
    return -(-(-(-height * v // maxv)) // 8), -(-(-(-width * h // maxh)) // 8)


def scan_blocks(frame, height, width, comps):
    """The blocks of a scan in coding order, as MCUs: [[(component,
    row, column), ...] each MCU].  One component: its own blocks in
    raster order; more: the interleaved MCUs."""
    if len(comps) == 1:
        bh, bw = component_blocks(frame, height, width, comps[0])
        return [[(comps[0], r, c)] for r in range(bh) for c in range(bw)]
    _, _, mcux, mcuy = mcu_geometry(frame, height, width)
    return [[(i, my * frame[i][2] + by, mx * frame[i][1] + bx)
             for i in comps for by in range(frame[i][2]) for bx in range(frame[i][1])]
            for my in range(mcuy) for mx in range(mcux)]


def frame_header(marker, frame, height, width, precision=8, ids=None) -> bytes:
    ids = ids or [c[0] for c in frame]
    return segment(marker, struct.pack(">BHHB", precision, height, width, len(frame)) + b"".join(
        bytes([ids[i], (h << 4) | v, tq]) for i, (_, h, v, tq) in enumerate(frame)))


def sos(frame, comps, tables, ss, se, ah, al, ids=None) -> bytes:
    """An SOS segment; ``tables[i]`` is component i's (Td, Ta)."""
    ids = ids or [c[0] for c in frame]
    return segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([ids[i], (tables[i][0] << 4) | tables[i][1]]) for i in comps)
        + bytes([ss, se, (ah << 4) | al]))


def dri(interval: int) -> bytes:
    return segment(0xDD, struct.pack(">H", interval))


# ----------------------------------------------------------------------
# The arithmetic coder (T.81 Annex D; jcarith.c's arith_encode)
# Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS); entry 113
# is libjpeg's fixed 0.5 estimate.
QE_TABLE = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
)
FIXED = 113  # the state of the fixed 0.5 bin


class ArithEncoder:
    """jcarith.c's encoder registers, its renormalization and byte output
    (carry over stacked 0xFF bytes, FF 00 stuffing) and its termination
    ("Pacman": no final zero bytes)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out += b"\x00" * self.zc
        self.zc = 0

    def encode(self, st: bytearray, i: int, val: int):
        sv = st[i]
        qe, nlps, nmps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = ((sv & 0x80) ^ (switch << 7)) | nlps
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) | nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out()
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def _byte_out(self):
        temp = self.c >> 19
        if temp > 0xFF:
            if self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            self._flush_stack()
            self.buffer = temp & 0xFF

    def _flush_stack(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0x8000000:
            if self.buffer >= 0:
                self._zeros()
                self.out.append(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self.out.append(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush_stack()
        if self.c & 0x7FFF800:
            self._zeros()
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if self.c & mask:
                    b = (self.c >> shift) & 0xFF
                    self.out.append(b)
                    if b == 0xFF:
                        self.out.append(0)
        data = bytes(self.out)
        self.out = bytearray()
        self.reset()
        return data


def _magnitude(enc, st, i, v, x2=None):
    """Figures F.8 and F.9 for v = |value| - 1: the magnitude category
    (its first decision at ``st[i]``, then X1 = 20 on for DC; for AC a
    second decision at ``st[i]``, then X2 = ``x2`` on), then the bits
    below its top at the category's bin + 14."""
    m = 0
    if v:
        enc.encode(st, i, 1)
        m, rest = 1, v >> 1
        if x2 is None:
            i = 20
        elif rest:
            enc.encode(st, i, 1)
            m, rest, i = 2, rest >> 1, x2
        while rest:
            enc.encode(st, i, 1)
            m, rest, i = m << 1, rest >> 1, i + 1
    enc.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1


class _ArithScan:
    """The statistics and predictions of one arithmetic-coded scan."""

    def __init__(self, enc, comps, tables, dac):
        self.enc, self.comps, self.tables, self.dac = enc, comps, tables, dac
        self.reset()

    def reset(self):
        self.dc_stats = {t: bytearray(64) for t in {self.tables[i][0] for i in self.comps}}
        self.ac_stats = {t: bytearray(256) for t in {self.tables[i][1] for i in self.comps}}
        self.fixed = bytearray([FIXED])
        self.last_dc = {i: 0 for i in self.comps}
        self.context = {i: 0 for i in self.comps}

    def dc(self, i, value):
        """F.1.4.1: a DC difference, its context from DAC's L and U."""
        enc, t = self.enc, self.tables[i][0]
        st, s0 = self.dc_stats[t], self.context[i]
        v = value - self.last_dc[i]
        if v == 0:
            enc.encode(st, s0, 0)
            self.context[i] = 0
            return
        self.last_dc[i] = value
        enc.encode(st, s0, 1)
        if v > 0:
            enc.encode(st, s0 + 1, 0)
            j, ctx = s0 + 2, 4
        else:
            v = -v
            enc.encode(st, s0 + 1, 1)
            j, ctx = s0 + 3, 8
        m = 0 if v == 1 else 1 << ((v - 1).bit_length() - 1)
        _magnitude(enc, st, j, v - 1)
        low, high = self.dac.get(("dc", t), (0, 1))
        if m < (1 << low) >> 1:
            ctx = 0
        elif m > (1 << high) >> 1:
            ctx += 8
        self.context[i] = ctx

    def ac(self, i, blk, ss, se, al):
        """F.1.4.2 / G.1.3.2: the band ss..se of one block, each value
        divided by 2^al towards zero."""
        enc, t = self.enc, self.tables[i][1]
        st, kx = self.ac_stats[t], self.dac.get(("ac", t), 5)
        vals = [int(abs(x)) >> al for x in blk]
        ke = se
        while ke >= ss and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            j = 3 * (k - 1)
            enc.encode(st, j, 0)
            while vals[k] == 0:
                enc.encode(st, j + 1, 0)
                j += 3
                k += 1
            enc.encode(st, j + 1, 1)
            enc.encode(self.fixed, 0, 1 if blk[k] < 0 else 0)
            _magnitude(enc, st, j + 2, vals[k] - 1, 189 if k <= kx else 217)
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, i, blk, ss, se, al):
        """G.1.3.3: one more bit of the band's coefficients."""
        enc, st = self.enc, self.ac_stats[self.tables[i][1]]
        vals = [int(abs(x)) >> al for x in blk]
        ke = se
        while ke >= ss and vals[ke] == 0:
            ke -= 1
        kex = ke
        while kex >= ss and (vals[kex] >> 1) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            j = 3 * (k - 1)
            if k > kex:
                enc.encode(st, j, 0)
            while True:
                v = vals[k]
                if v:
                    if v >> 1:
                        enc.encode(st, j + 2, v & 1)
                    else:
                        enc.encode(st, j + 1, 1)
                        enc.encode(self.fixed, 0, 1 if blk[k] < 0 else 0)
                    break
                enc.encode(st, j + 1, 0)
                j += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)


def dac_segment(dac: dict) -> bytes:
    """DAC of {("dc", t): (L, U)} and {("ac", t): Kx}."""
    body = b""
    for (kind, t), value in sorted(dac.items()):
        if kind == "dc":
            body += bytes([t, value[0] | (value[1] << 4)])
        else:
            body += bytes([0x10 | t, value])
    return segment(0xCC, body)


def progressive_script(n: int):
    """libjpeg's jpeg_simple_progression: 10 scans for 3 components
    (YCbCr), 6 for one; [(components, Ss, Se, Ah, Al)]."""
    if n == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    dc = tuple(range(n))
    if n == 1:
        return [(dc, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                (dc, 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]
    return ([(dc, 0, 0, 0, 1)] + [((i,), 1, 63, 0, 1) for i in range(n)] + [(dc, 0, 0, 1, 0)]
            + [((i,), 1, 63, 1, 0) for i in range(n)])


def arithmetic_file(frame, height, width, coefs, quant, *, script=None, restart=0,
                    dac=None, apps=(JFIF,), tables=None, precision=8, ids=None,
                    scan_dac=None) -> bytes:
    """An arithmetic-coded file of ``coefs``: SOF9 with one interleaved
    scan when ``script`` is None, else SOF10 with the scans of
    ``script`` ([(components, Ss, Se, Ah, Al)]).  ``dac`` ({("dc", t):
    (L, U), ("ac", t): Kx}) goes in a DAC segment before the first scan
    (``scan_dac``: {scan number: dac} before later scans); ``tables[i]``
    is component i's (DC, AC) conditioning table number (default 0 for
    the first component, 1 for the rest)."""
    n = len(frame)
    tables = tables or [(0, 0) if i == 0 else (1, 1) for i in range(n)]
    dac = dict(dac or {})
    progressive = script is not None
    out = SOI + b"".join(segment(m, b) for m, b in apps)
    out += b"".join(segment(0xDB, b) for b in quant)
    out += frame_header(0xCA if progressive else 0xC9, frame, height, width, precision, ids)
    if restart:
        out += dri(restart)
    for number, (comps, ss, se, ah, al) in enumerate(script or [(tuple(range(n)), 0, 63, 0, 0)]):
        current = dac if number == 0 else (scan_dac or {}).get(number)
        if current:
            out += dac_segment(current)
            if number:
                dac.update(current)
        out += sos(frame, comps, tables, ss, se, ah, al, ids)
        enc = ArithEncoder()
        coder = _ArithScan(enc, comps, tables, dac)
        for count, mcu in enumerate(scan_blocks(frame, height, width, list(comps))):
            if restart and count and count % restart == 0:
                out += enc.finish() + bytes([0xFF, 0xD0 + (count // restart - 1) % 8])
                coder.reset()
            for i, r, c in mcu:
                blk = coefs[i][r, c]
                if not progressive:
                    coder.dc(i, int(blk[0]))
                    coder.ac(i, blk, 1, 63, 0)
                elif ss == 0 and ah == 0:
                    coder.dc(i, int(blk[0]) >> al)
                elif ss == 0:
                    enc.encode(coder.fixed, 0, (int(blk[0]) >> al) & 1)
                elif ah == 0:
                    coder.ac(i, blk, ss, se, al)
                else:
                    coder.ac_refine(i, blk, ss, se, al)
        out += enc.finish()
    return out + EOI


# ----------------------------------------------------------------------
# Huffman tables made for the data (jchuff.c jpeg_gen_optimal_table)
def optimal_table(freq: dict) -> tuple:
    """(bits[1..16], symbols) of a Huffman table for symbol -> count,
    lengths at most 16 and no code of all ones (K.2's reserved symbol)."""
    counts = dict(freq)
    counts[256] = 1
    heap = [(c, s, (s,)) for s, c in counts.items() if c]
    heapq.heapify(heap)
    size = {s: 0 for s in counts}
    tie = 1000
    while len(heap) > 1:
        c1, _, a = heapq.heappop(heap)
        c2, _, b = heapq.heappop(heap)
        for s in a + b:
            size[s] += 1
        tie += 1
        heapq.heappush(heap, (c1 + c2, tie, a + b))
    if len(counts) == 1:
        size[256] = 1
    bits = [0] * 33
    for s, n in size.items():
        if counts[s]:
            bits[n] += 1
    for i in range(32, 16, -1):  # K.3 adjust_bits: lengths over 16
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved symbol's code
    order = sorted((s for s in counts if counts[s] and s != 256), key=lambda s: (size[s], s))
    return bits[1:17], order


def dht_body(tc: int, th: int, bits, symbols) -> bytes:
    return bytes([(tc << 4) | th]) + bytes(bits) + bytes(symbols)


def canonical_codes(bits, symbols) -> dict:
    """symbol -> (length, code)."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[symbols[k]] = (length, code)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, length, code):
        if length:
            self.bits.append(format(code & ((1 << length) - 1), f"0{length}b"))

    def flush(self) -> bytes:
        stream = "".join(self.bits)
        stream += "1" * (-len(stream) % 8)
        self.bits = []
        return bytes(int(stream[i:i + 8], 2) for i in range(0, len(stream), 8)).replace(
            b"\xff", b"\xff\x00")


def _category(v: int):
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def huffman_file(frame, height, width, coefs, quant, *, precision=8, apps=(JFIF,)) -> bytes:
    """A sequential Huffman file (SOF1) of ``coefs`` in one interleaved
    scan, one DC and one AC table a component made for its data."""
    n = len(frame)
    coded = []  # (class, component, symbol, value bits, value) in coding order
    pred = [0] * n
    for mcu in scan_blocks(frame, height, width, list(range(n))):
        for i, r, c in mcu:
            blk = [int(x) for x in coefs[i][r, c]]
            s, bits = _category(blk[0] - pred[i])
            pred[i] = blk[0]
            coded.append((0, i, s, s, bits))
            run = 0
            for k in range(1, 64):
                if blk[k] == 0:
                    run += 1
                    continue
                while run > 15:
                    coded.append((1, i, 0xF0, 0, 0))
                    run -= 16
                s, bits = _category(blk[k])
                coded.append((1, i, (run << 4) | s, s, bits))
                run = 0
            if run:
                coded.append((1, i, 0, 0, 0))
    out = SOI + b"".join(segment(m, b) for m, b in apps)
    out += b"".join(segment(0xDB, b) for b in quant)
    out += frame_header(0xC1, frame, height, width, precision)
    codes = {}
    for i in range(n):
        for cls in (0, 1):
            freq = {}
            for k, j, sym, _, _ in coded:
                if (k, j) == (cls, i):
                    freq[sym] = freq.get(sym, 0) + 1
            bits, order = optimal_table(freq)
            out += segment(0xC4, dht_body(cls, i, bits, order))
            codes[(cls, i)] = canonical_codes(bits, order)
    out += sos(frame, range(n), [(i, i) for i in range(n)], 0, 63, 0, 0)
    w = BitWriter()
    for cls, i, sym, s, bits in coded:
        w.put(*codes[(cls, i)][sym])
        w.put(s, bits)
    return out + w.flush() + EOI


# ----------------------------------------------------------------------
# Lossless (T.81 Annex H)
def predict(psv: int, ra: int, rb: int, rc: int) -> int:
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]


def lossless_differences(plane: np.ndarray, psv: int, pt: int, precision: int,
                         restart_rows: int = 0) -> np.ndarray:
    """H.1.2.1: the differences of one component's samples (shifted down
    by Pt), rows restarting at every ``restart_rows`` rows (the first
    row of an interval is predicted as the first row of the scan)."""
    x = plane.astype(np.int64) >> pt
    h, w = x.shape
    out = np.zeros_like(x)
    for r in range(h):
        first = r == 0 or (restart_rows and r % restart_rows == 0)
        for c in range(w):
            if first:
                p = (1 << (precision - pt - 1)) if c == 0 else x[r, c - 1]
            elif c == 0:
                p = x[r - 1, c]
            else:
                p = predict(psv, int(x[r, c - 1]), int(x[r - 1, c]), int(x[r - 1, c - 1]))
            d = (int(x[r, c]) - p) & 0xFFFF
            out[r, c] = d - 0x10000 if d > 0x8000 else d
    return out


def lossless_file(planes, *, psv=1, pt=0, precision=8, restart_rows=0, one_scan=True,
                  apps=(), ids=None) -> bytes:
    """A lossless Huffman file (SOF3) of the (h, w) sample planes
    ``planes`` (1 or more components, all 1x1 sampled): one interleaved
    scan, or a scan a component; a DRI of ``restart_rows`` rows' MCUs
    when given; Huffman tables made for the data."""
    n = len(planes)
    h, w = planes[0].shape
    frame = [(i + 1, 1, 1, 0) for i in range(n)]
    ids = ids or [c[0] for c in frame]
    diffs = [lossless_differences(p, psv, pt, precision, restart_rows) for p in planes]
    scans = [tuple(range(n))] if one_scan else [(i,) for i in range(n)]
    out = SOI + b"".join(segment(m, b) for m, b in apps)
    out += frame_header(0xC3, frame, h, w, precision, ids)
    if restart_rows:
        out += dri(restart_rows * w)
    tables = [(i, 0) for i in range(n)]
    for comps in scans:
        codes = {}
        for i in comps:
            freq = {}
            for d in diffs[i].ravel():
                s = 16 if d == 32768 else int(abs(d)).bit_length()
                freq[s] = freq.get(s, 0) + 1
            bits, order = optimal_table(freq)
            out += segment(0xC4, dht_body(0, i, bits, order))
            codes[i] = canonical_codes(bits, order)
        out += sos(frame, comps, tables, psv, 0, 0, pt, ids)
        wr = BitWriter()
        for r in range(h):
            if restart_rows and r and r % restart_rows == 0:
                out += wr.flush() + bytes([0xFF, 0xD0 + (r // restart_rows - 1) % 8])
            for c in range(w):
                for i in comps:
                    d = int(diffs[i][r, c])
                    s = 16 if d == 32768 else int(abs(d)).bit_length()
                    wr.put(*codes[i][s])
                    if s and s < 16:
                        wr.put(s, d if d >= 0 else d + (1 << s) - 1)
        out += wr.flush()
    return out + EOI


def scan_script(data: bytes, frame_ids) -> list:
    """The scans of a JPEG file as [(component indices, Ss, Se, Ah,
    Al)], read from its SOS headers."""
    out, pos = [], 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF or data[pos + 1] in (0x00, 0xFF) or 0xD0 <= data[pos + 1] <= 0xD7:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            body = data[pos + 4:pos + 2 + length]
            n = body[0]
            comps = tuple(frame_ids.index(body[1 + 2 * i]) for i in range(n))
            ss, se, a = body[1 + 2 * n:4 + 2 * n]
            out.append((comps, ss, se, a >> 4, a & 15))
        pos += 2 + length
    return out
