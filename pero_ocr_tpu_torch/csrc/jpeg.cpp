// Baseline JPEG in and out, equal to OpenCV 5's libjpeg-turbo (3.1) to
// the bit: the port's cv2.imread(path, IMREAD_COLOR) for JPEG pages and
// cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q]) for line crops.
//
// Decoder (jpeg_header, jpeg_decode_bgr): libjpeg's default
// decompression of baseline sequential Huffman files (SOF0, and SOF1 at
// 8 bits), one or three components, interleaved or not, restart
// intervals; the integer IDCT (jidctint.c) with its range limit, fancy
// upsampling (jdsample.c: h2v1, h2v2, h1v2, else the integral box),
// YCbCr to BGR with jdcolor.c's fixed-point tables, gray as three equal
// channels, and default_decompress_parms's colour-space guess.  What it
// does not copy it refuses with a message: progressive, lossless,
// hierarchical and arithmetic coding, other than 8-bit samples, four
// components, and truncated or corrupt entropy data (where libjpeg
// warns and fills the page with grey).
//
// Encoder (jpeg_encode): jpeg_set_defaults + jpeg_set_quality(q, TRUE)
// as cv2 calls them: JFIF APP0, the standard quantization tables scaled
// by jpeg_quality_scaling, 4:2:0 for three channels (BGR to YCbCr with
// jccolor.c's tables, h2v2_downsample with its 1, 2 bias, the edges
// replicated to whole MCUs, dummy blocks as jccoefct.c makes them),
// one component for gray, the integer forward DCT (jfdctint.c),
// jcdctmgr.c's reciprocal quantizer, the standard Huffman tables and no
// restart interval.
//
// Built with the host compiler and loaded through ctypes by
// pero_ocr_tpu_torch/utils/kernels.py; bound in utils/jpeg.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

const int kZigzag[64 + 16] = {  // jpeg_natural_order, with libjpeg's overrun guard
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Failure {
    std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Failure{what}; }

// ---------------------------------------------------------------------
// Huffman tables (jdhuff.c jpeg_make_d_derived_tbl / jchuff.c
// jpeg_make_c_derived_tbl)
struct HuffTable {
    bool defined = false;
    uint8_t bits[17] = {0};
    uint8_t vals[256] = {0};
    // decoding
    int32_t maxcode[17];
    int32_t valoffset[17];
    uint16_t lookup[1 << 9];  // (length << 8) | symbol, 0 = longer code
    // AC tables: a code and its value bits within 9 bits, decoded at
    // once (run, value, bits taken; bits 0 = take the long way)
    struct FastAC {
        int16_t value;
        uint8_t run, bits;
    } fast[1 << 9];
    // encoding
    uint16_t code[256];
    uint8_t size[256];
};

void build_table(HuffTable& t, bool is_dc) {
    int count = 0;
    for (int l = 1; l <= 16; l++) count += t.bits[l];
    if (count > 256) fail("a Huffman table with more than 256 codes");
    std::vector<int> huffsize, huffcode;
    for (int l = 1; l <= 16; l++)
        for (int i = 0; i < t.bits[l]; i++) huffsize.push_back(l);
    int code = 0, si = huffsize.empty() ? 0 : huffsize[0];
    size_t p = 0;
    while (p < huffsize.size()) {
        while (p < huffsize.size() && huffsize[p] == si) {
            huffcode.push_back(code++);
            p++;
        }
        if (code >= (1 << si)) fail("a Huffman table with an impossible code");
        code <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (t.bits[l]) {
            t.valoffset[l] = static_cast<int32_t>(p) - huffcode[p];
            p += t.bits[l];
            t.maxcode[l] = huffcode[p - 1];
        } else {
            t.maxcode[l] = -1;
        }
    }
    std::memset(t.lookup, 0, sizeof(t.lookup));
    p = 0;
    for (int l = 1; l <= 9; l++) {
        for (int i = 0; i < t.bits[l]; i++, p++) {
            int lookbits = huffcode[p] << (9 - l);
            for (int c = 0; c < (1 << (9 - l)); c++)
                t.lookup[lookbits + c] = static_cast<uint16_t>((l << 8) | t.vals[p]);
        }
    }
    if (is_dc)
        for (int i = 0; i < count; i++)
            if (t.vals[i] > 15) fail("a DC Huffman table with a symbol over 15");
    for (int look = 0; look < (1 << 9); look++) {
        HuffTable::FastAC f{0, 0, 0};
        uint16_t e = t.lookup[look];
        int l = e >> 8, rs = e & 0xFF, sz = rs & 15;
        if (!is_dc && e && sz && l + sz <= 9) {
            int v = (look >> (9 - l - sz)) & ((1 << sz) - 1);
            v = v < (1 << (sz - 1)) ? v - (1 << sz) + 1 : v;
            f = {static_cast<int16_t>(v), static_cast<uint8_t>(rs >> 4),
                 static_cast<uint8_t>(l + sz)};
        }
        t.fast[look] = f;
    }
    std::memset(t.size, 0, sizeof(t.size));
    for (size_t i = 0; i < huffsize.size(); i++) {
        t.code[t.vals[i]] = static_cast<uint16_t>(huffcode[i]);
        t.size[t.vals[i]] = static_cast<uint8_t>(huffsize[i]);
    }
    t.defined = true;
}

// ---------------------------------------------------------------------
// Entropy-coded data, read as jdhuff.c's jpeg_fill_bit_buffer reads it:
// FF 00 is a data byte FF, fill bytes FF FF ... before a marker are
// skipped, and a marker ends the segment; bits past it read as zeros,
// and taking one of them is libjpeg's "premature end of data segment".
struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t pos;
    uint64_t buf = 0;
    int bits = 0;       // bits in buf, zero fill included
    int real = 0;       // of which came from the data
    bool at_marker = false;

    void reset() {
        buf = 0;
        bits = real = 0;
        at_marker = false;
    }

    void fill() {
        // Eight bytes without an FF among them go in at once; the bytes
        // past those that fit reach buf as their own bits, which the
        // next fill puts in again.
        if (!at_marker && pos + 8 <= size) {
            uint64_t w;
            std::memcpy(&w, data + pos, 8);
            uint64_t x = ~w;
            if (((x - 0x0101010101010101ULL) & ~x & 0x8080808080808080ULL) == 0) {
                int n = (64 - bits) >> 3;
                buf |= __builtin_bswap64(w) >> bits;
                pos += n;
                bits += 8 * n;
                real += 8 * n;
                return;
            }
        }
        while (bits <= 56) {
            uint64_t c = 0;
            if (!at_marker) {
                if (pos >= size) {
                    at_marker = true;
                } else if (data[pos] != 0xFF) {
                    c = data[pos++];
                    real += 8;
                } else {
                    size_t q = pos + 1;
                    while (q < size && data[q] == 0xFF) q++;
                    if (q < size && data[q] == 0x00) {
                        c = 0xFF;
                        pos = q + 1;
                        real += 8;
                    } else {
                        at_marker = true;  // pos stays on the marker's first FF
                    }
                }
            }
            buf |= c << (56 - bits);
            bits += 8;
        }
    }

    inline uint32_t peek16() {
        if (bits < 16) fill();
        return static_cast<uint32_t>(buf >> 48);
    }

    inline void skip(int n) {
        if (n > real) fail("truncated or corrupt entropy-coded data");
        buf <<= n;
        bits -= n;
        real -= n;
    }

    inline int32_t get(int n) {
        if (n == 0) return 0;
        if (bits < n) fill();
        int32_t v = static_cast<int32_t>(buf >> (64 - n));
        skip(n);
        return v;
    }

    inline int decode(const HuffTable& t) {
        uint32_t look = peek16();
        uint16_t e = t.lookup[look >> 7];
        if (e) {
            skip(e >> 8);
            return e & 0xFF;
        }
        for (int l = 10; l <= 16; l++) {
            int32_t code = static_cast<int32_t>(look >> (16 - l));
            if (code <= t.maxcode[l]) {
                skip(l);
                return t.vals[t.valoffset[l] + code];
            }
        }
        fail("corrupt entropy-coded data (a Huffman code not in its table)");
    }
};

inline int32_t extend(int32_t v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------------
// The integer IDCT of jidctint.c (jpeg_idct_islow), with the range
// limit table of jdmaster.c's prepare_range_limit_table.
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

struct RangeLimit {
    uint8_t idct[1024];  // indexed by (x & 1023), x the IDCT's centred output
    RangeLimit() {
        for (int i = 0; i < 1024; i++) {
            int x = i < 512 ? i : i - 1024;
            // [-128, 127] -> [0, 255], clamped out to +-512 as in the table
            idct[i] = static_cast<uint8_t>(std::min(255, std::max(0, x + 128)));
        }
    }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
    int64_t ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t* in = coef + c;
        const uint16_t* q = quant + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            int64_t dc = (int64_t(in[0]) * q[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
            continue;
        }
        int64_t z2 = int64_t(in[16]) * q[16], z3 = int64_t(in[48]) * q[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = int64_t(in[0]) * q[0];
        z3 = int64_t(in[32]) * q[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = int64_t(in[56]) * q[56];
        tmp1 = int64_t(in[40]) * q[40];
        tmp2 = int64_t(in[24]) * q[24];
        tmp3 = int64_t(in[8]) * q[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS - PASS1_BITS;
        ws[0 * 8 + c] = descale(tmp10 + tmp3, n);
        ws[7 * 8 + c] = descale(tmp10 - tmp3, n);
        ws[1 * 8 + c] = descale(tmp11 + tmp2, n);
        ws[6 * 8 + c] = descale(tmp11 - tmp2, n);
        ws[2 * 8 + c] = descale(tmp12 + tmp1, n);
        ws[5 * 8 + c] = descale(tmp12 - tmp1, n);
        ws[3 * 8 + c] = descale(tmp13 + tmp0, n);
        ws[4 * 8 + c] = descale(tmp13 - tmp0, n);
    }
    for (int r = 0; r < 8; r++) {
        const int64_t* w = ws + r * 8;
        uint8_t* o = out + r * stride;
        const int n = CONST_BITS + PASS1_BITS + 3;
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            uint8_t v = kRange.idct[descale(w[0], PASS1_BITS + 3) & 1023];
            std::memset(o, v, 8);
            continue;
        }
        int64_t z2 = w[2], z3 = w[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
        int64_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        o[0] = kRange.idct[descale(tmp10 + tmp3, n) & 1023];
        o[7] = kRange.idct[descale(tmp10 - tmp3, n) & 1023];
        o[1] = kRange.idct[descale(tmp11 + tmp2, n) & 1023];
        o[6] = kRange.idct[descale(tmp11 - tmp2, n) & 1023];
        o[2] = kRange.idct[descale(tmp12 + tmp1, n) & 1023];
        o[5] = kRange.idct[descale(tmp12 - tmp1, n) & 1023];
        o[3] = kRange.idct[descale(tmp13 + tmp0, n) & 1023];
        o[4] = kRange.idct[descale(tmp13 - tmp0, n) & 1023];
    }
}

// ---------------------------------------------------------------------
// YCbCr to RGB (jdcolor.c build_ycc_rgb_table)
struct YccTables {
    int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    uint8_t limit[1024];  // jdmaster.c's range limit: x + 384 -> clamp(x, 0, 255)
    YccTables() {
        for (int i = 0; i < 1024; i++) limit[i] = static_cast<uint8_t>(std::min(255, std::max(0, i - 384)));
        const int SCALEBITS = 16;
        const int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
        auto fix = [](double x) { return static_cast<int64_t>(x * (1L << 16) + 0.5); };
        for (int i = 0; i < 256; i++) {
            int64_t x = i - 128;
            cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = static_cast<int32_t>(-fix(0.71414) * x);
            cb_g[i] = static_cast<int32_t>(-fix(0.34414) * x + ONE_HALF);
        }
    }
};
const YccTables kYcc;

// ---------------------------------------------------------------------
// The decoder
struct Component {
    int id, h, v, tq;
    int td = 0, ta = 0;
    int dw, dh;      // downsampled size
    int wib, hib;    // blocks holding samples of the image
    int bw, bh;      // blocks in the MCU-padded buffer
    std::vector<int16_t> coef;
    std::vector<uint8_t> plane;  // samples, (bh * 8, bw * 8)
    uint16_t quant[64];  // latched at the component's first scan (jdinput.c)
    bool scanned = false;
};

struct Decoder {
    const uint8_t* data;
    size_t size;
    size_t pos = 0;
    int width = 0, height = 0, ncomp = 0, maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
    bool frame = false, jfif = false, adobe = false;
    int adobe_transform = -1;
    int restart_interval = 0;
    int64_t app1_offset = -1, app1_length = 0;
    uint16_t quant[4][64];
    bool quant_defined[4] = {false, false, false, false};
    HuffTable dc[4], ac[4];
    std::vector<Component> comps;
    bool done = false;

    uint8_t byte() {
        if (pos >= size) fail("truncated (the file ends inside a marker segment)");
        return data[pos++];
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }

    // The next marker, skipping what libjpeg's next_marker skips (any
    // bytes before FF, then fill bytes).  -1 at the end of the file.
    int next_marker() {
        while (true) {
            while (pos < size && data[pos] != 0xFF) pos++;
            if (pos >= size) return -1;
            while (pos < size && data[pos] == 0xFF) pos++;
            if (pos >= size) return -1;
            int m = data[pos++];
            if (m != 0) return m;
        }
    }

    void read_app(int m, int length, size_t start) {
        const uint8_t* p = data + start;
        int n = length - 2;
        if (m == 0xE0 && n >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
        if (m == 0xEE && n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
            adobe = true;
            adobe_transform = p[11];
        }
        if (m == 0xE1 && app1_offset < 0 && !frame_scanned && n >= 6 &&
            std::memcmp(p, "Exif\0\0", 6) == 0) {  // the EXIF block cv2 reads
            app1_offset = static_cast<int64_t>(start) + 6;
            app1_length = n - 6;
        }
    }
    bool frame_scanned = false;  // an SOS was seen: later APP1s are not read by cv2
    bool single_scan = false;

    void read_dqt(int length) {
        size_t end = pos + length - 2;
        while (pos < end) {
            int pq = byte();
            int tq = pq & 15, prec = pq >> 4;
            if (tq > 3 || prec > 1) fail("a DQT segment with a bad table");
            for (int i = 0; i < 64; i++)
                quant[tq][kZigzag[i]] = static_cast<uint16_t>(prec ? u16() : byte());
            quant_defined[tq] = true;
        }
        if (pos != end) fail("a DQT segment of the wrong length");
    }

    void read_dht(int length) {
        size_t end = pos + length - 2;
        while (pos < end) {
            int tc = byte();
            int cls = tc >> 4, th = tc & 15;
            if (cls > 1 || th > 3) fail("a DHT segment with a bad table");
            HuffTable& t = cls ? ac[th] : dc[th];
            int count = 0;
            for (int l = 1; l <= 16; l++) count += (t.bits[l] = byte());
            if (count > 256 || pos + count > end) fail("a DHT segment of the wrong length");
            for (int i = 0; i < count; i++) t.vals[i] = byte();
            build_table(t, cls == 0);
        }
        if (pos != end) fail("a DHT segment of the wrong length");
    }

    void read_sof(int length) {
        if (frame) fail("two frames in one file");
        int precision = byte();
        height = u16();
        width = u16();
        ncomp = byte();
        if (precision != 8)
            fail(std::to_string(precision) + "-bit samples (only 8-bit JPEG is read)");
        if (height == 0) fail("a height given by a DNL marker");
        if (width == 0) fail("an empty image");
        if (ncomp == 4) fail("four components (CMYK or YCCK)");
        if (ncomp != 1 && ncomp != 3) fail(std::to_string(ncomp) + " components");
        if (length != 8 + 3 * ncomp) fail("an SOF segment of the wrong length");
        comps.resize(ncomp);
        for (auto& c : comps) {
            c.id = byte();
            int hv = byte();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = byte();
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                fail("bad sampling factors or quantization table in the frame header");
            maxh = std::max(maxh, c.h);
            maxv = std::max(maxv, c.v);
        }
        mcux = (width + 8 * maxh - 1) / (8 * maxh);
        mcuy = (height + 8 * maxv - 1) / (8 * maxv);
        for (auto& c : comps) {
            c.dw = static_cast<int>((int64_t(width) * c.h + maxh - 1) / maxh);
            c.dh = static_cast<int>((int64_t(height) * c.v + maxv - 1) / maxv);
            c.wib = (c.dw + 7) / 8;
            c.hib = (c.dh + 7) / 8;
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
        }
        frame = true;
    }

    // Markers up to the first SOS: the frame header and the APPn that
    // the colour-space guess and the EXIF orientation read.
    void read_header() {
        if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI)");
        pos = 2;
        while (true) {
            int m = next_marker();
            if (m < 0) fail("truncated (no SOS before the end of the file)");
            if (m == 0xDA) {
                pos -= 2;  // the scan is read by decode()
                if (!frame) fail("an SOS before the frame header");
                return;
            }
            handle_marker(m);
        }
    }

    void handle_marker(int m) {
        if (m == 0xD8) fail("a second SOI");
        if (m == 0xD9) {
            done = true;
            return;
        }
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) return;  // RSTn outside a scan, TEM
        int length = u16();
        if (length < 2 || pos + length - 2 > size)
            fail("truncated (a marker segment runs past the end of the file)");
        size_t start = pos;
        switch (m) {
            case 0xC0:
            case 0xC1:
                read_sof(length);
                break;
            case 0xC2:
            case 0xC6:
                fail("progressive coding (SOF2)");
            case 0xC3:
            case 0xC7:
                fail("lossless coding (SOF3)");
            case 0xC5:
            case 0xDE:
            case 0xDF:
                fail("hierarchical coding");
            case 0xC9:
            case 0xCA:
            case 0xCB:
            case 0xCD:
            case 0xCE:
            case 0xCF:
            case 0xCC:
                fail("arithmetic coding");
            case 0xC4:
                read_dht(length);
                break;
            case 0xDB:
                read_dqt(length);
                break;
            case 0xDD:
                if (length != 4) fail("a DRI segment of the wrong length");
                restart_interval = u16();
                break;
            case 0xDC:
                fail("a DNL marker");
            case 0xFE:
                break;
            default:
                if (m >= 0xE0 && m <= 0xEF) {
                    read_app(m, length, start);
                    break;
                }
                char name[8];
                std::snprintf(name, sizeof(name), "FF%02X", m);
                fail(std::string("an unknown marker ") + name);
        }
        pos = start + length - 2;
    }

    void decode_scan() {
        int length = u16();
        size_t start = pos;
        int ns = byte();
        if (ns < 1 || ns > 4 || length != 6 + 2 * ns) fail("an SOS segment of the wrong length");
        std::vector<Component*> scan;
        for (int i = 0; i < ns; i++) {
            int id = byte(), t = byte();
            Component* found = nullptr;
            for (auto& c : comps)
                if (c.id == id) found = &c;
            if (!found) fail("a scan of a component the frame lacks");
            for (auto* s : scan)
                if (s == found) fail("a scan that names a component twice");
            found->td = t >> 4;
            found->ta = t & 15;
            if (found->td > 3 || found->ta > 3) fail("a scan with a bad Huffman table number");
            scan.push_back(found);
        }
        int ss = byte(), se = byte(), a = byte();
        if (ss != 0 || se != 63 || a != 0) fail("a scan that is not sequential (Ss, Se, Ah/Al)");
        pos = start + length - 2;
        // jdinput.c: a first scan of every component makes a one-scan
        // file (any later SOS is an error), decoded straight into
        // samples; otherwise the coefficients wait for the last scan.
        if (!frame_scanned)
            single_scan = ns == ncomp;
        else if (single_scan)
            fail("a second scan after a scan of every component");
        frame_scanned = true;
        for (auto* c : scan) {
            if (!dc[c->td].defined || !ac[c->ta].defined) fail("a scan with an undefined Huffman table");
            if (!quant_defined[c->tq]) fail("a component with an undefined quantization table");
            if (!c->scanned) {
                std::memcpy(c->quant, quant[c->tq], sizeof(c->quant));
                if (single_scan)
                    c->plane.assign(size_t(c->bw) * 8 * c->bh * 8, 0);
                else
                    c->coef.assign(size_t(c->bw) * c->bh * 64, 0);
            }
            c->scanned = true;
        }
        int blocks_per_mcu = 0;
        for (auto* c : scan) blocks_per_mcu += ns == 1 ? 1 : c->h * c->v;
        if (blocks_per_mcu > 10) fail("an MCU of more than 10 blocks");

        BitReader br{data, size, pos};
        int pred[4] = {0, 0, 0, 0};
        int64_t n_mcu, mx;
        if (ns == 1) {
            mx = scan[0]->wib;
            n_mcu = mx * scan[0]->hib;
        } else {
            mx = mcux;
            n_mcu = mx * mcuy;
        }
        int restarts_to_go = restart_interval, next_rst = 0;
        for (int64_t m = 0; m < n_mcu; m++) {
            if (restart_interval) {
                if (restarts_to_go == 0) {
                    // process_restart: drop the bits left, read RSTn
                    pos = br.pos;
                    int marker = next_marker();
                    if (marker != 0xD0 + next_rst)
                        fail("corrupt entropy-coded data (a missing or wrong restart marker)");
                    next_rst = (next_rst + 1) & 7;
                    br.pos = pos;
                    br.reset();
                    for (int i = 0; i < 4; i++) pred[i] = 0;
                    restarts_to_go = restart_interval;
                }
                restarts_to_go--;
            }
            int64_t my = m / mx, mxx = m % mx;
            for (int si = 0; si < ns; si++) {
                Component& c = *scan[si];
                int nh = ns == 1 ? 1 : c.h, nv = ns == 1 ? 1 : c.v;
                for (int by = 0; by < nv; by++)
                    for (int bx = 0; bx < nh; bx++) {
                        int64_t row = my * nv + by, col = mxx * nh + bx;
                        if (single_scan) {
                            int16_t blk[64];
                            std::memset(blk, 0, sizeof(blk));
                            decode_block(br, c, blk, pred[si]);
                            if (row < c.hib && col < c.wib) {
                                size_t stride = size_t(c.bw) * 8;
                                idct_islow(blk, c.quant, c.plane.data() + row * 8 * stride + col * 8,
                                           static_cast<int>(stride));
                            }
                        } else {
                            decode_block(br, c, c.coef.data() + (row * c.bw + col) * 64, pred[si]);
                        }
                    }
            }
        }
        pos = br.pos;
    }

    void decode_block(BitReader& br, const Component& c, int16_t* blk, int& pred) {
        const HuffTable& dct = dc[c.td];
        const HuffTable& act = ac[c.ta];
        int s = br.decode(dct);
        int diff = s ? extend(br.get(s), s) : 0;
        pred += diff;
        blk[0] = static_cast<int16_t>(pred);
        for (int k = 1; k < 64; k++) {
            const HuffTable::FastAC& f = act.fast[br.peek16() >> 7];
            if (f.bits) {
                br.skip(f.bits);
                k += f.run;
                blk[kZigzag[k]] = f.value;
                continue;
            }
            int rs = br.decode(act);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;  // past 63 lands on 63, as libjpeg's natural order table does
                blk[kZigzag[k]] = static_cast<int16_t>(extend(br.get(s), s));
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    void decode() {
        read_header();
        while (!done) {
            int m = next_marker();
            if (m < 0) break;  // no EOI: libjpeg's source inserts one
            if (m == 0xDA) {
                decode_scan();
            } else {
                handle_marker(m);
            }
        }
        for (auto& c : comps)
            if (!c.scanned) fail("truncated (a component without a scan)");
    }

    // The colour space libjpeg's default_decompress_parms guesses: 0
    // gray, 1 YCbCr, 2 RGB.
    int color_space() const {
        if (ncomp == 1) return 0;
        if (jfif) return 1;
        if (adobe) return adobe_transform == 0 ? 2 : 1;
        if (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B') return 2;
        return 1;
    }

    // The samples of a multi-scan file's components: the IDCT of every
    // block that holds samples of the image.
    void inverse_dct() {
        for (auto& c : comps) {
            if (c.coef.empty()) continue;
            int stride = c.bw * 8;
            c.plane.assign(size_t(stride) * c.bh * 8, 0);
            for (int by = 0; by < c.hib; by++)
                for (int bx = 0; bx < c.wib; bx++)
                    idct_islow(c.coef.data() + (size_t(by) * c.bw + bx) * 64, c.quant,
                               c.plane.data() + size_t(by) * 8 * stride + bx * 8, stride);
            std::vector<int16_t>().swap(c.coef);
        }
    }

    mutable std::vector<int> colsum;  // h2v2_fancy_upsample's column sums of a row

    // Output row y of component c upsampled to the image's width (jdsample.c).
    void upsample_row(const Component& c, int y, uint8_t* out) const {
        const std::vector<uint8_t>& plane = c.plane;
        int stride = c.bw * 8;
        int hx = maxh / c.h, vy = maxv / c.v;
        const uint8_t* row = plane.data() + size_t(y / vy) * stride;
        if (hx == 1 && vy == 1) {
            std::memcpy(out, row, width);
            return;
        }
        bool fancy_h = hx == 2 && c.dw > 2;
        if (hx == 2 && vy == 1 && fancy_h) {  // h2v1_fancy_upsample
            int n = c.dw;
            for (int i = 0; i < n; i++) {
                int v3 = row[i] * 3;
                int left = row[i > 0 ? i - 1 : 0], right = row[i < n - 1 ? i + 1 : n - 1];
                int x = 2 * i;
                if (x < width) out[x] = static_cast<uint8_t>((v3 + left + 1) >> 2);
                if (x + 1 < width) out[x + 1] = static_cast<uint8_t>((v3 + right + 2) >> 2);
            }
            return;
        }
        if (hx == 1 && vy == 2) {  // h1v2_fancy_upsample
            int r = y / 2;
            int near = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
            int bias = (y & 1) ? 2 : 1;
            const uint8_t* other = plane.data() + size_t(near) * stride;
            for (int x = 0; x < width; x++)
                out[x] = static_cast<uint8_t>((row[x] * 3 + other[x] + bias) >> 2);
            return;
        }
        if (hx == 2 && vy == 2 && fancy_h) {  // h2v2_fancy_upsample
            int r = y / 2;
            int near = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
            const uint8_t* other = plane.data() + size_t(near) * stride;
            int n = c.dw;  // > 2
            colsum.resize(size_t(n));
            int* cs = colsum.data();
            for (int i = 0; i < n; i++) cs[i] = row[i] * 3 + other[i];
            // the first and last columns as their own neighbours
            out[0] = static_cast<uint8_t>((cs[0] * 4 + 8) >> 4);
            out[1] = static_cast<uint8_t>((cs[0] * 3 + cs[1] + 7) >> 4);
            for (int i = 1; i < n - 1; i++) {
                out[2 * i] = static_cast<uint8_t>((cs[i] * 3 + cs[i - 1] + 8) >> 4);
                out[2 * i + 1] = static_cast<uint8_t>((cs[i] * 3 + cs[i + 1] + 7) >> 4);
            }
            out[2 * n - 2] = static_cast<uint8_t>((cs[n - 1] * 3 + cs[n - 2] + 8) >> 4);
            if (2 * n - 1 < width) out[2 * n - 1] = static_cast<uint8_t>((cs[n - 1] * 4 + 7) >> 4);
            return;
        }
        for (int x = 0; x < width; x++) out[x] = row[x / hx];  // int_upsample
    }

    void output_bgr(uint8_t* out) {
        int space = color_space();
        for (const auto& c : comps)
            if (maxh % c.h || maxv % c.v)
                fail("fractional sampling factors (libjpeg cannot upsample them)");
        inverse_dct();
        std::vector<uint8_t> rows(size_t(width) * ncomp);
        for (int y = 0; y < height; y++) {
            for (int ci = 0; ci < ncomp; ci++)
                upsample_row(comps[ci], y, rows.data() + size_t(ci) * width);
            uint8_t* o = out + size_t(y) * width * 3;
            const uint8_t* c0 = rows.data();
            if (space == 0) {
                for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = c0[x];
                continue;
            }
            const uint8_t* c1 = c0 + width;
            const uint8_t* c2 = c1 + width;
            if (space == 2) {
                for (int x = 0; x < width; x++) {
                    o[3 * x] = c2[x];
                    o[3 * x + 1] = c1[x];
                    o[3 * x + 2] = c0[x];
                }
                continue;
            }
            const uint8_t* limit = kYcc.limit + 384;
            for (int x = 0; x < width; x++) {
                int yy = c0[x], cb = c1[x], cr = c2[x];
                o[3 * x + 2] = limit[yy + kYcc.cr_r[cr]];
                o[3 * x + 1] = limit[yy + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)];
                o[3 * x] = limit[yy + kYcc.cb_b[cb]];
            }
        }
    }
};

void set_error(const Failure& f, char* err, int errlen) {
    if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", f.what.c_str());
}

// ---------------------------------------------------------------------
// The encoder
const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
// jstdhuff.c: bits[1..16], then the values
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

HuffTable std_table(const uint8_t* bits, const uint8_t* vals, bool is_dc) {
    HuffTable t;
    std::memcpy(t.bits, bits, 17);
    int n = 0;
    for (int l = 1; l <= 16; l++) n += bits[l];
    std::memcpy(t.vals, vals, size_t(n));
    build_table(t, is_dc);
    return t;
}

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
void scaled_table(const uint8_t* base, int quality, uint16_t* out) {
    quality = std::min(100, std::max(1, quality));
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; i++) {
        long t = (long(base[i]) * scale + 50L) / 100L;
        out[i] = static_cast<uint16_t>(std::min(255L, std::max(1L, t)));
    }
}

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM: the divisor's
// reciprocal, rounding correction and shift.
struct Divisor {
    uint32_t recip, corr;
    int shift;
};

Divisor reciprocal(uint32_t divisor) {
    if (divisor == 1) return {1, 0, 0};
    int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
    int r = 16 + b;
    uint64_t fq = (uint64_t(1) << r) / divisor, fr = (uint64_t(1) << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        r--;
    } else if (fr <= divisor / 2U) {
        c++;
    } else {
        fq++;
    }
    return {static_cast<uint32_t>(fq), c, r};
}

// The integer forward DCT of jfdctint.c (jpeg_fdct_islow), in place.
void fdct_islow(int32_t* d) {
    for (int r = 0; r < 8; r++) {
        int32_t* p = d + r * 8;
        int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
        int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4] = static_cast<int32_t>((tmp10 - tmp11) * (1 << PASS1_BITS));
        int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[2] = static_cast<int32_t>(descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS));
        p[6] = static_cast<int32_t>(descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS - PASS1_BITS));
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[7] = static_cast<int32_t>(descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS));
        p[5] = static_cast<int32_t>(descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS));
        p[3] = static_cast<int32_t>(descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS));
        p[1] = static_cast<int32_t>(descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS));
    }
    for (int c = 0; c < 8; c++) {
        int32_t* p = d + c;
        int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
        int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32],
                tmp4 = p[24] - p[32];
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = static_cast<int32_t>(descale(tmp10 + tmp11, PASS1_BITS));
        p[32] = static_cast<int32_t>(descale(tmp10 - tmp11, PASS1_BITS));
        int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[16] = static_cast<int32_t>(descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS));
        p[48] = static_cast<int32_t>(descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS + PASS1_BITS));
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[56] = static_cast<int32_t>(descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS));
        p[40] = static_cast<int32_t>(descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS));
        p[24] = static_cast<int32_t>(descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS));
        p[8] = static_cast<int32_t>(descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS));
    }
}

struct BitWriter {
    uint8_t* out;
    int64_t cap, n = 0;
    uint64_t acc = 0;
    int bits = 0;

    void byte(uint8_t b) {
        if (n >= cap) fail("the output buffer is too small");
        out[n++] = b;
    }
    inline void put(uint32_t code, int size) {  // size <= 27
        acc = (acc << size) | (code & ((1u << size) - 1));
        bits += size;
        if (bits < 32) return;
        if (n + 8 > cap) fail("the output buffer is too small");
        while (bits >= 8) {
            uint8_t b = static_cast<uint8_t>(acc >> (bits - 8));
            out[n++] = b;
            if (b == 0xFF) out[n++] = 0;
            bits -= 8;
        }
    }
    // What is left in the accumulator, padded with ones (flush_bits).
    void flush() {
        if (bits % 8) put(0x7F, 8 - bits % 8);
        while (bits >= 8) {
            uint8_t b = static_cast<uint8_t>(acc >> (bits - 8));
            byte(b);
            if (b == 0xFF) byte(0);
            bits -= 8;
        }
    }
};

struct Encoder {
    BitWriter w;
    HuffTable dc[2], ac[2];
    uint16_t quant[2][64];
    Divisor div[2][64];

    void marker(uint8_t m) {
        w.byte(0xFF);
        w.byte(m);
    }
    void u16(int v) {
        w.byte(static_cast<uint8_t>(v >> 8));
        w.byte(static_cast<uint8_t>(v & 0xFF));
    }

    void write_headers(int h, int wd, int nc) {
        marker(0xD8);
        marker(0xE0);  // JFIF APP0: version 1.01, no units, density 1:1, no thumbnail
        u16(16);
        const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
        for (uint8_t b : jfif) w.byte(b);
        for (int t = 0; t < (nc == 3 ? 2 : 1); t++) {
            marker(0xDB);
            u16(67);
            w.byte(static_cast<uint8_t>(t));
            for (int i = 0; i < 64; i++) w.byte(static_cast<uint8_t>(quant[t][kZigzag[i]]));
        }
        marker(0xC0);
        u16(8 + 3 * nc);
        w.byte(8);
        u16(h);
        u16(wd);
        w.byte(static_cast<uint8_t>(nc));
        for (int c = 0; c < nc; c++) {
            w.byte(static_cast<uint8_t>(c + 1));
            w.byte(nc == 3 && c == 0 ? 0x22 : 0x11);
            w.byte(c == 0 ? 0 : 1);
        }
        const uint8_t* bits[4] = {kDcLumaBits, kAcLumaBits, kDcChromaBits, kAcChromaBits};
        const uint8_t* vals[4] = {kDcVals, kAcLumaVals, kDcVals, kAcChromaVals};
        const int classes[4] = {0x00, 0x10, 0x01, 0x11};
        for (int t = 0; t < (nc == 3 ? 4 : 2); t++) {
            int n = 0;
            for (int l = 1; l <= 16; l++) n += bits[t][l];
            marker(0xC4);
            u16(2 + 1 + 16 + n);
            w.byte(static_cast<uint8_t>(classes[t]));
            for (int l = 1; l <= 16; l++) w.byte(bits[t][l]);
            for (int i = 0; i < n; i++) w.byte(vals[t][i]);
        }
        marker(0xDA);
        u16(6 + 2 * nc);
        w.byte(static_cast<uint8_t>(nc));
        for (int c = 0; c < nc; c++) {
            w.byte(static_cast<uint8_t>(c + 1));
            w.byte(c == 0 ? 0x00 : 0x11);
        }
        w.byte(0);
        w.byte(63);
        w.byte(0);
    }

    // jcdctmgr.c forward_DCT for one 8x8 block of a plane: samples minus
    // 128, the DCT, the reciprocal quantizer.
    void forward(const uint8_t* src, int stride, int t, int16_t* out) const {
        int32_t d[64];
        for (int r = 0; r < 8; r++)
            for (int c = 0; c < 8; c++) d[r * 8 + c] = int32_t(src[r * stride + c]) - 128;
        fdct_islow(d);
        for (int i = 0; i < 64; i++) {  // branch-free: the sign as a mask
            const Divisor& q = div[t][i];
            int32_t v = d[i], sign = v >> 31;
            uint32_t a = static_cast<uint32_t>((v ^ sign) - sign);
            int32_t p = static_cast<int32_t>(((a + q.corr) * q.recip) >> q.shift);  // a < 2^14, recip < 2^16
            out[i] = static_cast<int16_t>((p ^ sign) - sign);
        }
    }

    // jchuff.c encode_one_block: each code and its value bits in one put
    inline void encode_block(const int16_t* blk, int& last_dc, int t) {
        const HuffTable& dct = dc[t];
        const HuffTable& act = ac[t];
        int temp = blk[0] - last_dc;
        last_dc = blk[0];
        int temp2 = temp;
        if (temp < 0) {
            temp = -temp;
            temp2--;
        }
        int nbits = temp ? 32 - __builtin_clz(static_cast<uint32_t>(temp)) : 0;
        if (nbits > 11) fail("a DC coefficient out of range");
        w.put((uint32_t(dct.code[nbits]) << nbits) | (uint32_t(temp2) & ((1u << nbits) - 1)),
              dct.size[nbits] + nbits);
        // The nonzero AC coefficients in zigzag order as a bit mask, its
        // set bits walked in order: runs of zeros between them.
        int16_t zz[64];
        uint64_t nonzero = 0;
        for (int k = 1; k < 64; k++) {
            zz[k] = blk[kZigzag[k]];
            nonzero |= uint64_t(zz[k] != 0) << k;
        }
        int last = 0;
        while (nonzero) {
            int k = __builtin_ctzll(nonzero);
            nonzero &= nonzero - 1;
            int r = k - last - 1;
            last = k;
            while (r > 15) {
                w.put(act.code[0xF0], act.size[0xF0]);
                r -= 16;
            }
            temp = zz[k];
            temp2 = temp;
            if (temp < 0) {
                temp = -temp;
                temp2--;
            }
            nbits = 32 - __builtin_clz(static_cast<uint32_t>(temp));
            if (nbits > 10) fail("an AC coefficient out of range");
            int i = (r << 4) + nbits;
            w.put((uint32_t(act.code[i]) << nbits) | (uint32_t(temp2) & ((1u << nbits) - 1)),
                  act.size[i] + nbits);
        }
        if (last < 63) w.put(act.code[0], act.size[0]);  // EOB after trailing zeros
    }
};

// A plane of h x w samples copied into a (ph, pw) buffer, its last
// column and row repeated (expand_right_edge, expand_bottom_edge).
void pad_plane(std::vector<uint8_t>& plane, int h, int w, int ph, int pw) {
    for (int y = 0; y < h; y++) {
        uint8_t* row = plane.data() + size_t(y) * pw;
        std::memset(row + w, row[w - 1], size_t(pw - w));
    }
    for (int y = h; y < ph; y++)
        std::memcpy(plane.data() + size_t(y) * pw, plane.data() + size_t(h - 1) * pw, size_t(pw));
}

}  // namespace

extern "C" {

// The header of a JPEG file: out[0] height, out[1] width, out[2]
// components, out[3]/out[4] the offset and length of the TIFF block of
// the first APP1 "Exif\0\0" segment before the first scan (-1, 0 when
// there is none).
// Returns 0, or -1 with the reason in err.
int32_t jpeg_header(const uint8_t* data, int64_t size, int64_t* out, char* err, int32_t errlen) {
    try {
        Decoder d{data, static_cast<size_t>(size)};
        d.read_header();
        out[0] = d.height;
        out[1] = d.width;
        out[2] = d.ncomp;
        out[3] = d.app1_offset;
        out[4] = d.app1_length;
        return 0;
    } catch (const Failure& f) {
        set_error(f, err, errlen);
        return -1;
    }
}

// The file decoded into out, a (height, width, 3) BGR uint8 buffer of
// the size jpeg_header gives.  Returns 0, or -1 with the reason in err.
int32_t jpeg_decode_bgr(const uint8_t* data, int64_t size, uint8_t* out, int32_t height,
                        int32_t width, char* err, int32_t errlen) {
    try {
        Decoder d{data, static_cast<size_t>(size)};
        d.decode();
        if (d.height != height || d.width != width) fail("the output buffer has another size");
        d.output_bgr(out);
        return 0;
    } catch (const Failure& f) {
        set_error(f, err, errlen);
        return -1;
    } catch (const std::bad_alloc&) {
        set_error(Failure{"out of memory"}, err, errlen);
        return -1;
    }
}

// The JPEG bytes of an (h, w, c) uint8 image, c 3 (BGR, coded YCbCr
// 4:2:0) or 1 (gray), at quality 1-100, written to out.  Returns the
// byte count, or -1 with the reason in err (out too small: cap bytes).
int64_t jpeg_encode(const uint8_t* img, int32_t h, int32_t w, int32_t c, int32_t quality,
                    uint8_t* out, int64_t cap, char* err, int32_t errlen) {
    try {
        if (h < 1 || w < 1 || h > 65535 || w > 65535 || (c != 1 && c != 3))
            fail("an image JPEG cannot hold (size or channels)");
        Encoder e{BitWriter{out, cap}};
        scaled_table(kStdLuma, quality, e.quant[0]);
        scaled_table(kStdChroma, quality, e.quant[1]);
        for (int t = 0; t < 2; t++)
            for (int i = 0; i < 64; i++) e.div[t][i] = reciprocal(uint32_t(e.quant[t][i]) << 3);
        e.dc[0] = std_table(kDcLumaBits, kDcVals, true);
        e.ac[0] = std_table(kAcLumaBits, kAcLumaVals, false);
        e.dc[1] = std_table(kDcChromaBits, kDcVals, true);
        e.ac[1] = std_table(kAcChromaBits, kAcChromaVals, false);
        e.write_headers(h, w, c);
        int16_t blk[64];
        if (c == 1) {
            int wib = (w + 7) / 8, hib = (h + 7) / 8, pw = wib * 8, ph = hib * 8;
            std::vector<uint8_t> plane(size_t(pw) * ph);
            for (int y = 0; y < h; y++) std::memcpy(plane.data() + size_t(y) * pw, img + size_t(y) * w, w);
            pad_plane(plane, h, w, ph, pw);
            int last = 0;
            for (int by = 0; by < hib; by++)
                for (int bx = 0; bx < wib; bx++) {
                    e.forward(plane.data() + size_t(by) * 8 * pw + bx * 8, pw, 0, blk);
                    e.encode_block(blk, last, 0);
                }
        } else {
            // jccolor.c rgb_ycc_start tables
            const int64_t ONE_HALF = int64_t(1) << 15, CBCR_OFFSET = int64_t(128) << 16;
            auto fix = [](double x) { return static_cast<int64_t>(x * (1L << 16) + 0.5); };
            std::vector<int64_t> tab(8 * 256);
            for (int i = 0; i < 256; i++) {
                tab[i] = fix(0.29900) * i;
                tab[i + 256] = fix(0.58700) * i;
                tab[i + 512] = fix(0.11400) * i + ONE_HALF;
                tab[i + 768] = -fix(0.16874) * i;
                tab[i + 1024] = -fix(0.33126) * i;
                tab[i + 1280] = fix(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;
                tab[i + 1536] = -fix(0.41869) * i;
                tab[i + 1792] = -fix(0.08131) * i;
            }
            int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
            int pw = mcux * 16, ph = mcuy * 16;
            std::vector<uint8_t> yp(size_t(pw) * ph), cbp(size_t(pw) * ph), crp(size_t(pw) * ph);
            for (int y = 0; y < h; y++) {
                const uint8_t* s = img + size_t(y) * w * 3;
                uint8_t* py = yp.data() + size_t(y) * pw;
                uint8_t* pb = cbp.data() + size_t(y) * pw;
                uint8_t* pr = crp.data() + size_t(y) * pw;
                for (int x = 0; x < w; x++) {
                    int b = s[3 * x], g = s[3 * x + 1], r = s[3 * x + 2];
                    py[x] = static_cast<uint8_t>((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
                    pb[x] = static_cast<uint8_t>((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
                    pr[x] = static_cast<uint8_t>((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
                }
            }
            pad_plane(yp, h, w, ph, pw);
            pad_plane(cbp, h, w, ph, pw);
            pad_plane(crp, h, w, ph, pw);
            // h2v2_downsample over row pairs of the image (its last row
            // repeated to an even count), then the last downsampled row
            // repeated to the MCU rows.
            int cw = mcux * 8, ch = mcuy * 8, dh = (h + 1) / 2;
            std::vector<uint8_t> cb(size_t(cw) * ch), cr(size_t(cw) * ch);
            for (int plane = 0; plane < 2; plane++) {
                const std::vector<uint8_t>& full = plane ? crp : cbp;
                std::vector<uint8_t>& small = plane ? cr : cb;
                for (int r = 0; r < dh; r++) {
                    const uint8_t* in0 = full.data() + size_t(2 * r) * pw;
                    const uint8_t* in1 = full.data() + size_t(2 * r + 1) * pw;
                    uint8_t* o = small.data() + size_t(r) * cw;
                    int bias = 1;
                    for (int x = 0; x < cw; x++) {
                        o[x] = static_cast<uint8_t>(
                            (in0[2 * x] + in0[2 * x + 1] + in1[2 * x] + in1[2 * x + 1] + bias) >> 2);
                        bias ^= 3;
                    }
                }
                for (int r = dh; r < ch; r++)
                    std::memcpy(small.data() + size_t(r) * cw, small.data() + size_t(dh - 1) * cw,
                                size_t(cw));
            }
            int wib = (w + 7) / 8, hib = (h + 7) / 8;
            int last[3] = {0, 0, 0};
            int16_t ys[4][64];
            for (int my = 0; my < mcuy; my++)
                for (int mx = 0; mx < mcux; mx++) {
                    // jccoefct.c compress_data: dummy blocks past the
                    // image's blocks hold only the DC of the block before.
                    for (int b = 0; b < 4; b++) {
                        int by = 2 * my + b / 2, bx = 2 * mx + b % 2;
                        if (by >= hib) {
                            std::memset(ys[b], 0, sizeof(ys[b]));
                            ys[b][0] = ys[(b / 2) * 2 - 1][0];
                        } else if (bx >= wib) {
                            std::memset(ys[b], 0, sizeof(ys[b]));
                            ys[b][0] = ys[b - 1][0];
                        } else {
                            e.forward(yp.data() + size_t(by) * 8 * pw + bx * 8, pw, 0, ys[b]);
                        }
                    }
                    for (int b = 0; b < 4; b++) e.encode_block(ys[b], last[0], 0);
                    e.forward(cb.data() + size_t(my) * 8 * cw + mx * 8, cw, 1, blk);
                    e.encode_block(blk, last[1], 1);
                    e.forward(cr.data() + size_t(my) * 8 * cw + mx * 8, cw, 1, blk);
                    e.encode_block(blk, last[2], 1);
                }
        }
        e.w.flush();
        e.w.byte(0xFF);
        e.w.byte(0xD9);
        return e.w.n;
    } catch (const Failure& f) {
        set_error(f, err, errlen);
        return -1;
    } catch (const std::bad_alloc&) {
        set_error(Failure{"out of memory"}, err, errlen);
        return -1;
    }
}

}  // extern "C"
