// JPEG in, baseline JPEG out, equal to OpenCV 5's libjpeg-turbo (3.1) to
// the bit: the port's cv2.imread(path, IMREAD_COLOR) for JPEG pages and
// cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, q]) for line crops.
//
// Decoder (jpeg_header, jpeg_decode_bgr, jpeg_decode_components for a
// TIFF strip's unconverted components): libjpeg's default
// decompression as OpenCV drives it, of every JPEG file OpenCV reads.
//  - Codings: sequential (SOF0, SOF1) and progressive (SOF2) Huffman,
//    sequential (SOF9) and progressive (SOF10) arithmetic (jdarith.c:
//    the QM decoder, DAC conditioning, statistics reset at restarts),
//    and lossless Huffman (SOF3: jdlhuff.c, jddiffct.c and jdlossls.c's
//    predictors 1-7, point transform and restarts by MCU rows).
//  - One, three or four components, interleaved or not, restart
//    intervals.  Progressive scans (DC and AC first and refining scans,
//    spectral selection, successive approximation, EOB runs) fill a
//    whole-image coefficient buffer; where the file leaves the DC or the
//    first nine AC coefficients short of full precision, the output pass
//    smooths them from the neighbouring blocks' DC values as jdcoefct.c's
//    decompress_smooth_data does, with the previous scan's precision past
//    the last iMCU row a cut-short scan reached.
//  - Then the integer IDCT (jidctint.c) with its range limit, fancy
//    upsampling (jdsample.c: h2v1, h2v2, h1v2, else the integral box;
//    lossless files take the box), YCbCr to BGR with jdcolor.c's
//    fixed-point tables, gray as three equal channels, and
//    default_decompress_parms's colour-space guess.  Four components are
//    CMYK (Adobe transform 0 or no Adobe marker) or YCCK (any other
//    transform), turned into CMYK as jdcolor.c does and into BGR as
//    OpenCV's icvCvt_CMYK2BGR_8u_C4C3R does.
//  - Data cut short or corrupt is read as libjpeg reads it: past the end
//    of the file, the stdio source's fake EOI markers; bits past a marker
//    read as zeros and, once one is taken, the rest of the Huffman scan
//    (or restart interval) is left as it was (grey in a one-scan file); a
//    Huffman code not in its table takes 17 bits and gives symbol 0;
//    bytes before a marker are skipped; a missing or wrong RSTn goes
//    through jpeg_resync_to_restart; the markers after the scan of a
//    one-scan file are never read.
// Where libjpeg or OpenCV gives up (cv2.imread returns None) the decoder
// fails: hierarchical and arithmetic lossless coding, samples of other
// than 8 bits (2 to 8 for lossless), lossless files that are not RGB or
// CMYK (libjpeg converts no other lossless colour space), two components,
// fractional sampling, a bad or missing table or segment in the headers
// or, in a file of several scans, anywhere before its EOI.
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
#include <climits>
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
    bool bad = false;     // counts that make no code (libjpeg fails when a scan uses it)
    int max_symbol = 0;   // the largest symbol (DC tables hold at most 15, 16 lossless)
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
    t.defined = true;
    t.bad = count > 256;
    if (t.bad) return;
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
        if (code >= (1 << si)) {  // no code may be all ones
            t.bad = true;
            return;
        }
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
    t.max_symbol = 0;
    for (int i = 0; i < count; i++) t.max_symbol = std::max<int>(t.max_symbol, t.vals[i]);
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
}

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

// ---------------------------------------------------------------------
// The file as libjpeg's stdio source manager hands it out: its bytes,
// then a fake EOI marker (FF D9) for every read past its end
// (jdatasrc.c fill_input_buffer's "Premature end of JPEG file").
inline uint8_t stream_at(const uint8_t* data, size_t size, size_t p) {
    return p < size ? data[p] : ((p - size) & 1 ? 0xD9 : 0xFF);
}

// Entropy-coded data, read as jdhuff.c's jpeg_fill_bit_buffer reads it:
// FF 00 is a data byte FF, fill bytes FF FF ... before a marker are
// skipped, and a marker ends the segment; bits past it read as zeros,
// and taking one of them sets libjpeg's insufficient_data ("premature
// end of data segment").
struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t pos;
    uint64_t buf = 0;
    int bits = 0;       // bits in buf, zero fill included
    int real = 0;       // of which came from the data
    bool at_marker = false;  // pos stays on the marker's first FF
    bool insufficient = false;
    bool bad_code = false;   // a Huffman code not in its table was read

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
                uint8_t b = stream_at(data, size, pos);
                if (b != 0xFF) {
                    c = b;
                    pos++;
                    real += 8;
                } else {
                    size_t q = pos + 1;
                    while (stream_at(data, size, q) == 0xFF) q++;
                    if (stream_at(data, size, q) == 0x00) {
                        c = 0xFF;
                        pos = q + 1;
                        real += 8;
                    } else {
                        at_marker = true;
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
        if (n > real) {
            insufficient = true;
            real = 0;
        } else {
            real -= n;
        }
        buf <<= n;
        bits -= n;
    }

    inline int32_t get(int n) {
        if (n == 0) return 0;
        if (bits < n) fill();
        int32_t v = static_cast<int32_t>(buf >> (64 - n));
        skip(n);
        return v;
    }

    // A symbol; a code not in the table takes 17 bits and reads as
    // symbol 0 (jpeg_huff_decode's "bad Huffman code").
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
        if (bits < 17) fill();
        skip(17);
        bad_code = true;
        return 0;
    }
};

inline int32_t extend(int32_t v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------------
// The arithmetic decoder of jdarith.c (T.81 D.2): Table D.2 packed as
// libjpeg's jaricom.c packs it, Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 bin.
#define QE(qe, lps, mps, sw) ((int64_t(qe) << 16) | (int64_t(mps) << 8) | ((sw) << 7) | (lps))
const int64_t kQe[114] = {
    QE(0x5a1d, 1, 1, 1),     QE(0x2586, 14, 2, 0),    QE(0x1114, 16, 3, 0),
    QE(0x080b, 18, 4, 0),    QE(0x03d8, 20, 5, 0),    QE(0x01da, 23, 6, 0),
    QE(0x00e5, 25, 7, 0),    QE(0x006f, 28, 8, 0),    QE(0x0036, 30, 9, 0),
    QE(0x001a, 33, 10, 0),   QE(0x000d, 35, 11, 0),   QE(0x0006, 9, 12, 0),
    QE(0x0003, 10, 13, 0),   QE(0x0001, 12, 13, 0),   QE(0x5a7f, 15, 15, 1),
    QE(0x3f25, 36, 16, 0),   QE(0x2cf2, 38, 17, 0),   QE(0x207c, 39, 18, 0),
    QE(0x17b9, 40, 19, 0),   QE(0x1182, 42, 20, 0),   QE(0x0cef, 43, 21, 0),
    QE(0x09a1, 45, 22, 0),   QE(0x072f, 46, 23, 0),   QE(0x055c, 48, 24, 0),
    QE(0x0406, 49, 25, 0),   QE(0x0303, 51, 26, 0),   QE(0x0240, 52, 27, 0),
    QE(0x01b1, 54, 28, 0),   QE(0x0144, 56, 29, 0),   QE(0x00f5, 57, 30, 0),
    QE(0x00b7, 59, 31, 0),   QE(0x008a, 60, 32, 0),   QE(0x0068, 62, 33, 0),
    QE(0x004e, 63, 34, 0),   QE(0x003b, 32, 35, 0),   QE(0x002c, 33, 9, 0),
    QE(0x5ae1, 37, 37, 1),   QE(0x484c, 64, 38, 0),   QE(0x3a0d, 65, 39, 0),
    QE(0x2ef1, 67, 40, 0),   QE(0x261f, 68, 41, 0),   QE(0x1f33, 69, 42, 0),
    QE(0x19a8, 70, 43, 0),   QE(0x1518, 72, 44, 0),   QE(0x1177, 73, 45, 0),
    QE(0x0e74, 74, 46, 0),   QE(0x0bfb, 75, 47, 0),   QE(0x09f8, 77, 48, 0),
    QE(0x0861, 78, 49, 0),   QE(0x0706, 79, 50, 0),   QE(0x05cd, 48, 51, 0),
    QE(0x04de, 50, 52, 0),   QE(0x040f, 50, 53, 0),   QE(0x0363, 51, 54, 0),
    QE(0x02d4, 52, 55, 0),   QE(0x025c, 53, 56, 0),   QE(0x01f8, 54, 57, 0),
    QE(0x01a4, 55, 58, 0),   QE(0x0160, 56, 59, 0),   QE(0x0125, 57, 60, 0),
    QE(0x00f6, 58, 61, 0),   QE(0x00cb, 59, 62, 0),   QE(0x00ab, 61, 63, 0),
    QE(0x008f, 61, 32, 0),   QE(0x5b12, 65, 65, 1),   QE(0x4d04, 80, 66, 0),
    QE(0x412c, 81, 67, 0),   QE(0x37d8, 82, 68, 0),   QE(0x2fe8, 83, 69, 0),
    QE(0x293c, 84, 70, 0),   QE(0x2379, 86, 71, 0),   QE(0x1edf, 87, 72, 0),
    QE(0x1aa9, 87, 73, 0),   QE(0x174e, 72, 74, 0),   QE(0x1424, 72, 75, 0),
    QE(0x119c, 74, 76, 0),   QE(0x0f6b, 74, 77, 0),   QE(0x0d51, 75, 78, 0),
    QE(0x0bb6, 77, 79, 0),   QE(0x0a40, 77, 48, 0),   QE(0x5832, 80, 81, 1),
    QE(0x4d1c, 88, 82, 0),   QE(0x438e, 89, 83, 0),   QE(0x3bdd, 90, 84, 0),
    QE(0x34ee, 91, 85, 0),   QE(0x2eae, 92, 86, 0),   QE(0x299a, 93, 87, 0),
    QE(0x2516, 86, 71, 0),   QE(0x5570, 88, 89, 1),   QE(0x4ca9, 95, 90, 0),
    QE(0x44d9, 96, 91, 0),   QE(0x3e22, 97, 92, 0),   QE(0x3824, 99, 93, 0),
    QE(0x32b4, 99, 94, 0),   QE(0x2e17, 93, 86, 0),   QE(0x56a8, 95, 96, 1),
    QE(0x4f46, 101, 97, 0),  QE(0x47e5, 102, 98, 0),  QE(0x41cf, 103, 99, 0),
    QE(0x3c3d, 104, 100, 0), QE(0x375e, 99, 93, 0),   QE(0x5231, 105, 102, 0),
    QE(0x4c0f, 106, 103, 0), QE(0x4639, 107, 104, 0), QE(0x415e, 103, 99, 0),
    QE(0x5627, 105, 106, 1), QE(0x50e7, 108, 107, 0), QE(0x4b85, 109, 103, 0),
    QE(0x5597, 110, 109, 0), QE(0x504f, 111, 107, 0), QE(0x5a10, 110, 111, 1),
    QE(0x5522, 112, 109, 0), QE(0x59eb, 112, 111, 1), QE(0x5a1d, 113, 113, 0)};
#undef QE

struct ArithReader {
    const uint8_t* data;
    size_t size;
    size_t pos;
    bool at_marker = false;  // as BitReader: pos stays on the marker's first FF
    int64_t c = 0, a = 0;
    int ct = -16;            // -16: two bytes to read before the first decision
    bool error = false;      // jdarith.c's ct == -1: skip to the next restart

    void restart() {
        c = a = 0;
        ct = -16;
        error = false;
    }

    // jdarith.c get_byte with its marker handling: past a marker, zeros.
    int byte_in() {
        if (at_marker) return 0;
        int v = stream_at(data, size, pos);
        if (v != 0xFF) {
            pos++;
            return v;
        }
        size_t q = pos + 1;
        while (stream_at(data, size, q) == 0xFF) q++;
        if (stream_at(data, size, q) == 0) {
            pos = q + 1;
            return 0xFF;
        }
        at_marker = true;
        return 0;
    }

    inline int decode(uint8_t* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                c = (c << 8) | byte_in();
                if ((ct += 8) < 0)
                    if (++ct == 0) a = 0x8000;
            }
            a <<= 1;
        }
        int sv = *st;
        int64_t qe = kQe[sv & 0x7F];
        int nl = static_cast<int>(qe & 0xFF);
        qe >>= 8;
        int nm = static_cast<int>(qe & 0xFF);
        qe >>= 8;
        int64_t temp = a - qe;
        a = temp;
        temp <<= ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {  // conditional exchange: the MPS after all
                a = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            } else {
                a = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }
};

// ---------------------------------------------------------------------
// The integer IDCT, as libjpeg-turbo's AVX2 jsimd_idct_islow computes it
// (jidctint.c's arithmetic in 16-bit lanes): coefficients times
// quantizers and the sums in0 + in4, in0 - in4, in7 + in3 and in5 + in1
// wrap at 16 bits, the products accumulate in 32 bits, each pass's
// outputs saturate to 16 bits and the last to -128..127 before the
// centre is added.  A block whose rows 1-7 are all zero takes the first
// pass's shortcut, the DC shifted left in 16 bits.  On valid data this
// equals jidctint.c with its range-limit table; on extreme values (data
// cut short or corrupt) it is what OpenCV's build gives.
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

inline int16_t saturate16(int32_t x) {
    return static_cast<int16_t>(std::min(32767, std::max(-32768, x)));
}

// One 1-D pass on eight 16-bit inputs (in[k * step]), descaled by n,
// saturated to 16 bits.  Without AC inputs every output is the same
// value, taken at once.
inline void idct_pass(const int16_t* in, int step, int16_t* out, int n) {
    const int32_t in0 = in[0], in1 = in[step], in2 = in[2 * step], in3 = in[3 * step],
                  in4 = in[4 * step], in5 = in[5 * step], in6 = in[6 * step], in7 = in[7 * step];
    const int32_t round = 1 << (n - 1);
    if (!(in1 | in2 | in3 | in4 | in5 | in6 | in7)) {
        std::fill(out, out + 8, saturate16((in0 * (1 << CONST_BITS) + round) >> n));
        return;
    }
    const int32_t f130 = FIX_0_541196100 + FIX_0_765366865, f054 = FIX_0_541196100,
                  mf130 = FIX_0_541196100 - FIX_1_847759065;
    int32_t tmp3 = in2 * f130 + in6 * f054;
    int32_t tmp2 = in2 * f054 + in6 * mf130;
    int32_t tmp0 = int32_t(static_cast<int16_t>(in0 + in4)) * (1 << CONST_BITS);
    int32_t tmp1 = int32_t(static_cast<int16_t>(in0 - in4)) * (1 << CONST_BITS);
    const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
                  tmp12 = tmp1 - tmp2;
    const int32_t z3 = static_cast<int16_t>(in7 + in3), z4 = static_cast<int16_t>(in5 + in1);
    const int32_t z3r =
        z3 * int32_t(FIX_1_175875602 - FIX_1_961570560) + z4 * int32_t(FIX_1_175875602);
    const int32_t z4r =
        z3 * int32_t(FIX_1_175875602) + z4 * int32_t(FIX_1_175875602 - FIX_0_390180644);
    tmp0 = in7 * int32_t(FIX_0_298631336 - FIX_0_899976223) + in1 * int32_t(-FIX_0_899976223) +
           z3r;
    tmp3 = in7 * int32_t(-FIX_0_899976223) + in1 * int32_t(FIX_1_501321110 - FIX_0_899976223) +
           z4r;
    tmp1 = in5 * int32_t(FIX_2_053119869 - FIX_2_562915447) + in3 * int32_t(-FIX_2_562915447) +
           z4r;
    tmp2 = in5 * int32_t(-FIX_2_562915447) + in3 * int32_t(FIX_3_072711026 - FIX_2_562915447) +
           z3r;
    out[0] = saturate16((tmp10 + tmp3 + round) >> n);
    out[7] = saturate16((tmp10 - tmp3 + round) >> n);
    out[1] = saturate16((tmp11 + tmp2 + round) >> n);
    out[6] = saturate16((tmp11 - tmp2 + round) >> n);
    out[2] = saturate16((tmp12 + tmp1 + round) >> n);
    out[5] = saturate16((tmp12 - tmp1 + round) >> n);
    out[3] = saturate16((tmp13 + tmp0 + round) >> n);
    out[4] = saturate16((tmp13 - tmp0 + round) >> n);
}

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
    int16_t ws[64];  // the first pass's output, column by column
    uint64_t words[14];
    std::memcpy(words, coef + 8, sizeof(words));
    uint64_t ac_rows = 0;
    for (uint64_t w : words) ac_rows |= w;
    for (int c = 0; c < 8; c++) {
        const int16_t dc = static_cast<int16_t>(coef[c] * quant[c]);
        int16_t v;
        if (!ac_rows) {  // the whole-block shortcut: the DC shifted in 16 bits
            v = static_cast<int16_t>(static_cast<uint16_t>(dc) << PASS1_BITS);
        } else if (!(coef[8 + c] | coef[16 + c] | coef[24 + c] | coef[32 + c] | coef[40 + c] |
                     coef[48 + c] | coef[56 + c])) {
            v = saturate16(dc * (1 << PASS1_BITS));  // idct_pass without AC inputs
        } else {
            int16_t col[8];
            for (int r = 0; r < 8; r++)
                col[r] = static_cast<int16_t>(coef[r * 8 + c] * quant[r * 8 + c]);
            idct_pass(col, 1, ws + c * 8, CONST_BITS - PASS1_BITS);
            continue;
        }
        std::fill(ws + c * 8, ws + c * 8 + 8, v);
    }
    for (int r = 0; r < 8; r++) {
        uint8_t* o = out + r * stride;
        if (r && !ac_rows) {  // the first pass gave every row the same inputs
            std::memcpy(o, out, 8);
            continue;
        }
        int16_t res[8];
        idct_pass(ws + r, 8, res, CONST_BITS + PASS1_BITS + 3);
        for (int c = 0; c < 8; c++)
            o[c] = static_cast<uint8_t>(std::min(127, std::max(-128, int(res[c]))) + 128);
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
    int wib, hib;    // blocks holding samples of the image (lossless: samples)
    int bw, bh;      // blocks in the MCU-padded buffer (lossless: samples)
    int stride = 0;  // of plane
    std::vector<int16_t> coef;
    std::vector<uint8_t> plane;  // samples, (bh * 8, bw * 8); lossless (bh, bw)
    uint16_t quant[64];  // latched at the component's first scan (jdinput.c)
    bool scanned = false;
    // jdphuff.c's coef_bits: the Al each zigzag coefficient was last
    // coded at by a progressive scan, -1 before any; and the first ten
    // as they were before the component's latest scan (the bits
    // jdcoefct.c smooths with past the last good iMCU row).
    int coef_bits[64];
    int prev_bits[10];
    // lossless: the differences of one iMCU row (v rows of bw), the
    // previous row's samples, and whether the next row is undifferenced
    // as a first row (jdlossls.c's predict_undifference)
    std::vector<int32_t> diff, last;
    bool first_row = true;
    int last_row_height = 1;
    Component() {
        std::fill(coef_bits, coef_bits + 64, -1);
        std::fill(prev_bits, prev_bits + 10, -1);
        std::memset(quant, 0, sizeof(quant));
    }
};

struct Decoder {
    const uint8_t* data;
    size_t size;
    size_t pos = 0;
    int width = 0, height = 0, ncomp = 0, maxh = 1, maxv = 1, mcux = 0, mcuy = 0, precision = 8;
    bool frame = false, progressive = false, arithmetic = false, lossless = false;
    bool jfif = false, adobe = false;
    int adobe_transform = -1;
    int restart_interval = 0;
    int next_rst = 0;  // jdmarker.c's next_restart_num
    int64_t app1_offset = -1, app1_length = 0;
    uint16_t quant[4][64];
    bool quant_defined[4] = {false, false, false, false};
    HuffTable dc[4], ac[4];
    uint8_t dac_l[16], dac_u[16], dac_k[16];  // DAC conditioning (T.81 F.1.4.4)
    uint8_t dc_stats[16][64], ac_stats[16][256];
    std::vector<Component> comps;
    bool frame_scanned = false;  // an SOS was seen: later APP1s are not read by cv2
    bool single_scan = false;    // jdinput.c: not has_multiple_scans
    int scans = 0;               // input_scan_number
    int64_t last_good_imcu = 0;  // jdcoefct.c's master->last_good_iMCU_row
    int space = 0;               // the colour space, fixed at the first scan
    bool warned = false;         // libjpeg warned of data cut short or corrupt
    bool raw = false;            // no colour conversion (JCS_UNKNOWN)

    Decoder(const uint8_t* d, size_t n) : data(d), size(n) {
        std::fill(dac_l, dac_l + 16, 0);
        std::fill(dac_u, dac_u + 16, 1);
        std::fill(dac_k, dac_k + 16, 5);
    }

    uint8_t byte() { return stream_at(data, size, pos++); }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }

    // jdmarker.c next_marker: any bytes before FF skipped, then fill
    // bytes and FF 00; pos ends past the marker, whose FF is at pos - 2.
    int next_marker() {
        while (true) {
            int c = byte();
            while (c != 0xFF) c = byte();
            do c = byte();
            while (c == 0xFF);
            if (c != 0) return c;
        }
    }

    void skip_variable() {
        int length = u16() - 2;
        if (length > 0) pos += size_t(length);
    }

    // APP0 (JFIF) and APP14 (Adobe) as get_interesting_appn reads them;
    // the first "Exif\0\0" APP1 before the first scan, which cv2 saves.
    void read_app(int m) {
        int length = u16() - 2;
        size_t start = pos;
        if (length <= 0) return;
        if (start + size_t(length) <= size) {
            const uint8_t* p = data + start;
            int n = length;
            if (m == 0xE0 && n >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif = true;
            if (m == 0xEE && n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
                adobe = true;
                adobe_transform = p[11];
            }
            if (m == 0xE1 && app1_offset < 0 && !frame_scanned && n >= 6 &&
                std::memcmp(p, "Exif\0\0", 6) == 0) {
                app1_offset = static_cast<int64_t>(start) + 6;
                app1_length = n - 6;
            }
        }
        pos = start + size_t(length);
    }

    void read_dqt() {
        int length = u16() - 2;
        while (length > 0) {
            length--;
            int n = byte();
            int prec = n >> 4;
            n &= 15;
            if (n > 3) fail("a DQT segment with a bad table number");
            for (int i = 0; i < 64; i++)
                quant[n][kZigzag[i]] = static_cast<uint16_t>(prec ? u16() : byte());
            quant_defined[n] = true;
            length -= prec ? 128 : 64;
        }
        if (length != 0) fail("a DQT segment of the wrong length");
    }

    void read_dht() {
        int length = u16() - 2;
        while (length > 16) {
            int index = byte();
            uint8_t bits[17] = {0};
            int count = 0;
            for (int l = 1; l <= 16; l++) count += (bits[l] = byte());
            length -= 17;
            if (count > 256 || count > length) fail("a bad DHT segment");
            uint8_t vals[256] = {0};
            for (int i = 0; i < count; i++) vals[i] = byte();
            length -= count;
            bool is_ac = index & 0x10;
            if (is_ac) index -= 0x10;
            if (index < 0 || index > 3) fail("a DHT segment with a bad table number");
            HuffTable& t = is_ac ? ac[index] : dc[index];
            std::memcpy(t.bits, bits, sizeof(bits));
            std::memcpy(t.vals, vals, sizeof(vals));
            build_table(t, !is_ac);
        }
        if (length != 0) fail("a DHT segment of the wrong length");
    }

    void read_dac() {
        int length = u16() - 2;
        while (length > 0) {
            int index = byte(), val = byte();
            length -= 2;
            if (index >= 32) fail("a DAC segment with a bad table number");
            if (index >= 16) {
                dac_k[index - 16] = static_cast<uint8_t>(val);
            } else {
                dac_l[index] = static_cast<uint8_t>(val & 15);
                dac_u[index] = static_cast<uint8_t>(val >> 4);
                if (dac_l[index] > dac_u[index]) fail("a DAC segment with L over U");
            }
        }
        if (length != 0) fail("a DAC segment of the wrong length");
    }

    void read_sof(bool is_progressive, bool is_lossless, bool is_arithmetic) {
        if (frame) fail("two frames in one file");
        progressive = is_progressive;
        lossless = is_lossless;
        arithmetic = is_arithmetic;
        int length = u16();
        precision = byte();
        height = u16();
        width = u16();
        ncomp = byte();
        if (height == 0 || width == 0 || ncomp == 0)
            fail("an empty image (a height of 0, as a DNL marker would give it, among them)");
        if (length - 8 != ncomp * 3) fail("an SOF segment of the wrong length");
        comps.resize(ncomp);
        for (auto& c : comps) {
            c.id = byte();
            int hv = byte();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = byte();
        }
        frame = true;
    }

    // What libjpeg's initial_setup and jpeg_start_decompress, and
    // OpenCV's colour request (BGR, or CMYK for four components), refuse.
    void setup() {
        if (height > 65500 || width > 65500) fail("an image over 65500 pixels a side");
        if (arithmetic && lossless) fail("arithmetic lossless coding (SOF11)");
        if (lossless ? (precision < 2 || precision > 8) : precision != 8)
            fail(std::to_string(precision) + "-bit samples");
        if (ncomp != 1 && ncomp != 3 && ncomp != 4) fail(std::to_string(ncomp) + " components");
        for (auto& c : comps) {
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors");
            maxh = std::max(maxh, c.h);
            maxv = std::max(maxv, c.v);
        }
        for (auto& c : comps)
            if (maxh % c.h || maxv % c.v)
                fail("fractional sampling factors (libjpeg cannot upsample them)");
        space = color_space();  // default_decompress_parms: APPn after this change nothing
        if (lossless && space != 2 && space != 3 && !raw)
            fail("a lossless file that is not RGB or CMYK (libjpeg converts no other)");
        const int block = lossless ? 1 : 8;
        mcux = (width + block * maxh - 1) / (block * maxh);
        mcuy = (height + block * maxv - 1) / (block * maxv);
        for (auto& c : comps) {
            c.dw = static_cast<int>((int64_t(width) * c.h + maxh - 1) / maxh);
            c.dh = static_cast<int>((int64_t(height) * c.v + maxv - 1) / maxv);
            c.wib = (c.dw + block - 1) / block;
            c.hib = (c.dh + block - 1) / block;
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.stride = c.bw * block;
            c.last_row_height = c.hib % c.v ? c.hib % c.v : c.v;
        }
        // jinit_huff_decoder's std_huff_tables (sequential Huffman only):
        // Motion JPEG leaves out the standard tables, which fill the first
        // two slots of each class not defined by now.
        if (progressive || lossless || arithmetic) return;
        if (!dc[0].defined) dc[0] = std_table(kDcLumaBits, kDcVals, true);
        if (!ac[0].defined) ac[0] = std_table(kAcLumaBits, kAcLumaVals, false);
        if (!dc[1].defined) dc[1] = std_table(kDcChromaBits, kDcVals, true);
        if (!ac[1].defined) ac[1] = std_table(kAcChromaBits, kAcChromaVals, false);
    }

    // Markers up to the first SOS (jpeg_read_header): the frame header,
    // tables and the APPn that the colour-space guess and the EXIF
    // orientation read.  Returns past the SOS marker.
    void read_header() {
        if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI)");
        pos = 2;
        while (true) {
            int m = next_marker();
            if (m == 0xDA) {
                if (!frame) fail("an SOS before the frame header");
                return;
            }
            if (m == 0xD9) fail("no image before EOI (or the end of the file)");
            handle_marker(m);
        }
    }

    // One marker and its segment, as jdmarker.c's read_markers takes it.
    void handle_marker(int m) {
        switch (m) {
            case 0xD8:
                fail("a second SOI");
            case 0xC0:
            case 0xC1:
                return read_sof(false, false, false);
            case 0xC2:
                return read_sof(true, false, false);
            case 0xC3:
                return read_sof(false, true, false);
            case 0xC9:
                return read_sof(false, false, true);
            case 0xCA:
                return read_sof(true, false, true);
            case 0xCB:
                return read_sof(false, true, true);
            case 0xC5:
            case 0xC6:
            case 0xC7:
            case 0xC8:
            case 0xCD:
            case 0xCE:
            case 0xCF:
                fail("hierarchical coding or a reserved SOF");
            case 0xC4:
                return read_dht();
            case 0xCC:
                return read_dac();
            case 0xDB:
                return read_dqt();
            case 0xDD:
                if (u16() != 4) fail("a DRI segment of the wrong length");
                restart_interval = u16();
                return;
            case 0xDC:  // DNL: ignored
            case 0xFE:
                return skip_variable();
            case 0x01:
                return;
            default:
                if (m >= 0xD0 && m <= 0xD7) return;  // RSTn outside a scan
                if (m >= 0xE0 && m <= 0xEF) return read_app(m);
                char name[8];
                std::snprintf(name, sizeof(name), "FF%02X", m);
                fail(std::string("an unknown marker ") + name);
        }
    }

    // jdmarker.c read_restart_marker at pos, with jpeg_resync_to_restart
    // when the marker is not the next RSTn.  Returns false where the
    // marker is left unread (pos back on it): the entropy decoder then
    // reads an empty segment.
    bool read_restart_marker() {
        int marker = next_marker();
        int desired = next_rst;
        next_rst = (next_rst + 1) & 7;
        if (marker == 0xD0 + desired) return true;
        warned = true;
        while (true) {
            int action = 1;
            if (marker < 0xC0)
                action = 2;  // not a valid marker: scan on
            else if (marker < 0xD0 || marker > 0xD7)
                action = 3;  // a marker that is no RSTn
            else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7))
                action = 3;  // one of the next two
            else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7))
                action = 2;  // a prior one: scan on
            if (action == 1) return true;
            if (action == 3) {
                pos -= 2;
                return false;
            }
            marker = next_marker();
        }
    }

    // A scan's kind: sequential, or one of the four progressive decoders.
    enum ScanKind { kSequential, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

    void decode_scan() {
        int length = u16();
        int ns = byte();
        if (ns < 1 || ns > 4 || length != 6 + 2 * ns) fail("an SOS segment of the wrong length");
        std::vector<Component*> scan;
        for (int i = 0; i < ns; i++) {
            int id = byte(), t = byte();
            Component* found = nullptr;
            for (auto& c : comps)
                if (c.id == id && std::find(scan.begin(), scan.end(), &c) == scan.end()) {
                    found = &c;
                    break;
                }
            if (!found) fail("a scan of a component the frame lacks");
            found->td = t >> 4;
            found->ta = t & 15;
            scan.push_back(found);
        }
        int ss = byte(), se = byte(), a = byte();
        int ah = a >> 4, al = a & 15;
        scans++;
        next_rst = 0;
        if (!frame_scanned) {
            setup();
            single_scan = !progressive && ns == ncomp;
        }
        frame_scanned = true;
        int blocks_per_mcu = 0;
        for (auto* c : scan) blocks_per_mcu += ns == 1 ? 1 : c->h * c->v;
        if (blocks_per_mcu > 10) fail("an MCU of more than 10 blocks");
        if (lossless) return decode_lossless_scan(scan, ss, se, ah, al);

        ScanKind kind = kSequential;
        if (progressive) {
            // start_pass_phuff_decoder's and jdarith.c start_pass's checks
            bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
            if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
            if (bad) fail("a progressive scan with bad Ss, Se, Ah or Al");
            kind = ss == 0 ? (ah ? kDcRefine : kDcFirst) : (ah ? kAcRefine : kAcFirst);
        }  // a sequential scan's Ss, Se, Ah and Al only draw a warning
        bool need_dc = kind == kSequential || kind == kDcFirst;
        bool need_ac = kind == kSequential || kind == kAcFirst || kind == kAcRefine;
        for (auto* c : scan) {
            if (arithmetic) {
                if (c->td > 15 || c->ta > 15) fail("a scan with a bad conditioning table number");
            } else {
                if ((need_dc && !usable(c->td, true)) || (need_ac && !usable(c->ta, false)))
                    fail("a scan with an undefined or bad Huffman table");
            }
        }
        // jdinput.c latch_quant_tables, and the coefficient buffer of a
        // file of several scans (every component, zero until scanned)
        for (auto* c : scan) {
            if (c->scanned) continue;
            if (c->tq > 3 || !quant_defined[c->tq])
                fail("a component with an undefined quantization table");
            std::memcpy(c->quant, quant[c->tq], sizeof(c->quant));
            c->scanned = true;
        }
        for (auto& c : comps) {
            if (single_scan && c.plane.empty())
                c.plane.assign(size_t(c.stride) * c.bh * 8, 0);
            else if (!single_scan && c.coef.empty())
                c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
        }
        if (progressive) {
            for (auto* c : scan) {
                for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
                    if (k < 10) c->prev_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
                for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
            }
        }
        if (arithmetic) {
            for (auto* c : scan) {
                if (need_dc) std::memset(dc_stats[c->td], 0, 64);
                if (kind == kSequential || ss) std::memset(ac_stats[c->ta], 0, 256);
            }
        }

        int64_t n_mcu, mx;
        if (ns == 1) {
            mx = scan[0]->wib;
            n_mcu = mx * scan[0]->hib;
        } else {
            mx = mcux;
            n_mcu = mx * mcuy;
        }
        const int rows_per_imcu = ns == 1 ? scan[0]->v : 1;  // MCU rows an iMCU row
        BitReader br{data, size, pos};
        ArithReader ar{data, size, pos};
        int pred[4] = {0, 0, 0, 0}, context[4] = {0, 0, 0, 0};
        int eobrun = 0;
        uint8_t fixed = 113;
        int restarts_to_go = restart_interval;
        for (int64_t m = 0; m < n_mcu; m++) {
            if (restart_interval) {
                if (restarts_to_go == 0) {
                    // process_restart: the bits left dropped, RSTn read,
                    // predictions (and statistics) reset
                    pos = arithmetic ? ar.pos : br.pos;
                    bool resumed = read_restart_marker();
                    if (arithmetic) {
                        ar.pos = pos;
                        ar.at_marker = !resumed;
                        ar.restart();
                        for (auto* c : scan) {
                            if (need_dc) std::memset(dc_stats[c->td], 0, 64);
                            if (kind == kSequential || ss) std::memset(ac_stats[c->ta], 0, 256);
                        }
                    } else {
                        br.reset();
                        br.pos = pos;
                        if (resumed) br.insufficient = false;
                    }
                    for (int i = 0; i < 4; i++) pred[i] = context[i] = 0;
                    eobrun = 0;
                    restarts_to_go = restart_interval;
                }
                restarts_to_go--;
            }
            int64_t my = m / mx, mxx = m % mx;
            // Once the data has run out, the rest of the segment is left
            // as it is (zeros in a one-scan file); the MCU where it ran
            // out is read to its end from zero bits.
            const bool dead = br.insufficient;
            if (!dead) last_good_imcu = my / rows_per_imcu;
            for (int si = 0; si < ns; si++) {
                Component& c = *scan[si];
                int nh = ns == 1 ? 1 : c.h, nv = ns == 1 ? 1 : c.v;
                for (int by = 0; by < nv; by++)
                    for (int bx = 0; bx < nh; bx++) {
                        int64_t row = my * nv + by, col = mxx * nh + bx;
                        if (single_scan) {
                            int16_t blk[64];
                            std::memset(blk, 0, sizeof(blk));
                            if (arithmetic)
                                arith_sequential(ar, c, blk, pred[si], context[si], fixed);
                            else if (!dead)
                                decode_block(br, c, blk, pred[si]);
                            if (row < c.hib && col < c.wib)
                                idct_islow(blk, c.quant, c.plane.data() + row * 8 * c.stride + col * 8,
                                           c.stride);
                            continue;
                        }
                        int16_t* blk = c.coef.data() + (row * c.bw + col) * 64;
                        if (arithmetic) {
                            switch (kind) {
                                case kSequential:
                                    arith_sequential(ar, c, blk, pred[si], context[si], fixed);
                                    break;
                                case kDcFirst:
                                    if (!ar.error && arith_dc(ar, c, pred[si], context[si]))
                                        blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred[si]) << al);
                                    break;
                                case kDcRefine:
                                    if (!ar.error && ar.decode(&fixed))
                                        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
                                    break;
                                case kAcFirst:
                                    if (!ar.error) arith_ac(ar, c, blk, ss, se, al, fixed);
                                    break;
                                case kAcRefine:
                                    if (!ar.error) arith_ac_refine(ar, c, blk, ss, se, al, fixed);
                                    break;
                            }
                            continue;
                        }
                        if (dead) continue;
                        switch (kind) {
                            case kSequential:
                                decode_block(br, c, blk, pred[si]);
                                break;
                            case kDcFirst: {  // decode_mcu_DC_first
                                int s = br.decode(dc[c.td]);
                                int diff = s ? extend(br.get(s), s) : 0;
                                if ((pred[si] >= 0 && diff > INT_MAX - pred[si]) ||
                                    (pred[si] < 0 && diff < INT_MIN - pred[si]))
                                    fail("a DC coefficient out of range");
                                pred[si] += diff;
                                blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred[si]) << al);
                                break;
                            }
                            case kDcRefine:  // decode_mcu_DC_refine
                                if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
                                break;
                            case kAcFirst:
                                ac_first(br, ac[c.ta], blk, ss, se, al, eobrun);
                                break;
                            case kAcRefine:
                                ac_refine(br, ac[c.ta], blk, ss, se, al, eobrun);
                                break;
                        }
                    }
            }
        }
        pos = arithmetic ? ar.pos : br.pos;
        if (br.insufficient || br.bad_code || ar.error || (arithmetic && ar.pos >= size))
            warned = true;
    }

    // A Huffman table that jpeg_make_d_derived_tbl takes for a scan.
    bool usable(int t, bool is_dc) const {
        if (t > 3) return false;
        const HuffTable& h = is_dc ? dc[t] : ac[t];
        return h.defined && !h.bad && (!is_dc || h.max_symbol <= (lossless ? 16 : 15));
    }

    void decode_block(BitReader& br, const Component& c, int16_t* blk, int& pred) {
        const HuffTable& dct = dc[c.td];
        const HuffTable& act = ac[c.ta];
        int s = br.decode(dct);
        int diff = s ? extend(br.get(s), s) : 0;
        pred = static_cast<int>(static_cast<unsigned>(pred) + static_cast<unsigned>(diff));
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

    // jdphuff.c decode_mcu_AC_first: the band Ss..Se of one block, or one
    // block of an EOB run.
    static void ac_first(BitReader& br, const HuffTable& act, int16_t* blk, int ss, int se, int al,
                         int& eobrun) {
        if (eobrun > 0) {
            eobrun--;
            return;
        }
        for (int k = ss; k <= se; k++) {
            const HuffTable::FastAC& f = act.fast[br.peek16() >> 7];
            if (f.bits) {
                br.skip(f.bits);
                k += f.run;
                blk[kZigzag[k]] = static_cast<int16_t>(static_cast<unsigned>(f.value) << al);
                continue;
            }
            int rs = br.decode(act);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                blk[kZigzag[k]] =
                    static_cast<int16_t>(static_cast<unsigned>(extend(br.get(s), s)) << al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = 1 << r;
                if (r) eobrun += br.get(r);
                eobrun--;
                break;
            }
        }
    }

    // jdphuff.c decode_mcu_AC_refine: one more bit of the band's
    // nonzero coefficients, and the coefficients that become nonzero (a
    // size other than 1 draws a warning and is read as 1).
    static void ac_refine(BitReader& br, const HuffTable& act, int16_t* blk, int ss, int se, int al,
                          int& eobrun) {
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        auto refine = [&](int16_t& coef) {
            if (br.get(1) && (coef & p1) == 0)
                coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
        };
        int k = ss;
        if (eobrun == 0) {
            for (; k <= se; k++) {
                int rs = br.decode(act);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    if (s != 1) br.bad_code = true;
                    s = br.get(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += br.get(r);
                    break;
                }
                // Past the coefficients that are nonzero already (each
                // takes a correction bit), r zeros, to the new one.
                do {
                    int16_t& coef = blk[kZigzag[k]];
                    if (coef != 0) {
                        refine(coef);
                    } else {
                        if (--r < 0) break;
                    }
                    k++;
                } while (k <= se);
                if (s) blk[kZigzag[k]] = static_cast<int16_t>(s);
            }
        }
        if (eobrun > 0) {
            for (; k <= se; k++) {
                int16_t& coef = blk[kZigzag[k]];
                if (coef != 0) refine(coef);
            }
            eobrun--;
        }
    }

    // jdarith.c's DC difference (F.2.4.1), conditioned by the last one's
    // category and DAC's L and U; false on a magnitude overflow (the
    // decoder then rests until the next restart).
    bool arith_dc(ArithReader& ar, const Component& c, int& last_dc, int& context) {
        uint8_t* stats = dc_stats[c.td];
        uint8_t* st = stats + context;
        if (ar.decode(st) == 0) {
            context = 0;
            return true;
        }
        int sign = ar.decode(st + 1);
        st += 2 + sign;
        int m = ar.decode(st);
        if (m) {
            st = stats + 20;
            while (ar.decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    ar.error = true;
                    return false;
                }
                st++;
            }
        }
        if (m < ((1 << dac_l[c.td]) >> 1))
            context = 0;
        else if (m > ((1 << dac_u[c.td]) >> 1))
            context = 12 + sign * 4;
        else
            context = 4 + sign * 4;
        int v = m;
        st += 14;
        while (m >>= 1)
            if (ar.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        last_dc = (last_dc + v) & 0xFFFF;
        return true;
    }

    // jdarith.c's AC coefficients Ss..Se of one block (F.2.4.2, G.1.3.2),
    // scaled by 2^al; false on a spectral or magnitude overflow.
    bool arith_ac(ArithReader& ar, const Component& c, int16_t* blk, int ss, int se, int al,
                  uint8_t& fixed) {
        uint8_t* stats = ac_stats[c.ta];
        const int kx = dac_k[c.ta];
        for (int k = ss; k <= se; k++) {
            uint8_t* st = stats + 3 * (k - 1);
            if (ar.decode(st)) break;  // EOB
            while (ar.decode(st + 1) == 0) {
                st += 3;
                if (++k > se) {
                    ar.error = true;
                    return false;
                }
            }
            int sign = ar.decode(&fixed);
            st += 2;
            int m = ar.decode(st);
            if (m && ar.decode(st)) {
                m <<= 1;
                st = stats + (k <= kx ? 189 : 217);
                while (ar.decode(st)) {
                    if ((m <<= 1) == 0x8000) {
                        ar.error = true;
                        return false;
                    }
                    st++;
                }
            }
            int v = m;
            st += 14;
            while (m >>= 1)
                if (ar.decode(st)) v |= m;
            v += 1;
            if (sign) v = -v;
            blk[kZigzag[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
        }
        return true;
    }

    // jdarith.c decode_mcu_AC_refine: past the previous stage's end of
    // block an EOB decision, then a correction bit for each nonzero
    // coefficient and a new one of +-2^al.
    void arith_ac_refine(ArithReader& ar, const Component& c, int16_t* blk, int ss, int se, int al,
                         uint8_t& fixed) {
        uint8_t* stats = ac_stats[c.ta];
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        int kex = se;
        for (; kex > 0; kex--)
            if (blk[kZigzag[kex]]) break;
        for (int k = ss; k <= se; k++) {
            uint8_t* st = stats + 3 * (k - 1);
            if (k > kex && ar.decode(st)) break;
            while (true) {
                int16_t& coef = blk[kZigzag[k]];
                if (coef) {
                    if (ar.decode(st + 2)) coef = static_cast<int16_t>(coef + (coef < 0 ? m1 : p1));
                    break;
                }
                if (ar.decode(st + 1)) {
                    coef = static_cast<int16_t>(ar.decode(&fixed) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > se) {
                    ar.error = true;
                    return;
                }
            }
        }
    }

    // jdarith.c decode_mcu for one block of a sequential scan.
    void arith_sequential(ArithReader& ar, const Component& c, int16_t* blk, int& last_dc,
                          int& context, uint8_t& fixed) {
        if (ar.error || !arith_dc(ar, c, last_dc, context)) return;
        blk[0] = static_cast<int16_t>(last_dc);
        arith_ac(ar, c, blk, 1, 63, 0, fixed);
    }

    // A lossless scan (jddiffct.c decompress_data, jdlhuff.c decode_mcus,
    // jdlossls.c): each iMCU row's MCU rows decoded into differences
    // (restarts at MCU rows; once the data has run out, a row of zeros
    // and every predictor back to its first-row form), then each row
    // undifferenced and shifted up by Pt.
    void decode_lossless_scan(const std::vector<Component*>& scan, int psv, int se, int ah,
                              int pt) {
        if (psv < 1 || psv > 7 || se != 0 || ah != 0 || pt >= precision)
            fail("a lossless scan with bad Ss, Se, Ah or Al");
        for (auto* c : scan)
            if (!usable(c->td, true)) fail("a scan with an undefined or bad Huffman table");
        const int ns = static_cast<int>(scan.size());
        const int64_t per_row = ns == 1 ? scan[0]->wib : mcux;
        if (restart_interval % per_row) fail("a lossless restart interval of part of an MCU row");
        const int64_t restart_rows = restart_interval / per_row;
        for (auto& c : comps) {
            if (c.plane.empty()) c.plane.assign(size_t(c.stride) * c.bh, 0);
            c.first_row = true;  // start_pass_lossless, for every component
        }
        for (auto* c : scan) {
            c->diff.assign(size_t(c->v) * c->stride, 0);
            c->last.assign(size_t(c->stride), 0);
        }
        BitReader br{data, size, pos};
        int64_t rows_to_go = restart_rows;
        for (int64_t imcu = 0; imcu < mcuy; imcu++) {
            const bool last_imcu = imcu == mcuy - 1;
            const int mcu_rows = ns > 1 ? 1 : (last_imcu ? scan[0]->last_row_height : scan[0]->v);
            for (int y = 0; y < mcu_rows; y++) {
                if (restart_interval && rows_to_go == 0) {
                    pos = br.pos;
                    br.reset();
                    bool resumed = read_restart_marker();
                    br.pos = pos;
                    if (resumed) br.insufficient = false;
                    for (auto& c : comps) c.first_row = true;
                    rows_to_go = restart_rows;
                }
                if (br.insufficient) {
                    for (auto* c : scan)
                        for (int r = 0; r < (ns > 1 ? c->v : 1); r++)
                            std::fill_n(c->diff.begin() + size_t(ns > 1 ? r : y) * c->stride,
                                        c->stride, 0);
                    for (auto& c : comps) c.first_row = true;
                } else {
                    for (int64_t mx = 0; mx < per_row; mx++)
                        for (auto* c : scan) {
                            int nh = ns > 1 ? c->h : 1, nv = ns > 1 ? c->v : 1;
                            for (int by = 0; by < nv; by++)
                                for (int bx = 0; bx < nh; bx++) {
                                    int s = br.decode(dc[c->td]);
                                    int d = s == 16 ? 32768 : s ? extend(br.get(s), s) : 0;
                                    c->diff[size_t(ns > 1 ? by : y) * c->stride + mx * nh + bx] = d;
                                }
                        }
                }
                if (restart_interval) rows_to_go--;
            }
            for (auto* c : scan) {
                int rows = last_imcu ? c->last_row_height : c->v;
                for (int r = 0; r < rows; r++)
                    undifference(*c, c->diff.data() + size_t(r) * c->stride,
                                 c->plane.data() + size_t(imcu * c->v + r) * c->stride, psv, pt);
            }
        }
        pos = br.pos;
        if (br.insufficient || br.bad_code) warned = true;
        for (auto* c : scan) c->scanned = true;
    }

    // jdlossls.c: one row of a component from its differences.
    void undifference(Component& c, const int32_t* d, uint8_t* out, int psv, int pt) {
        int32_t* prev = c.last.data();
        const int w = c.wib;
        int ra;
        if (c.first_row) {  // jpeg_undifference_first_row
            ra = (d[0] + (1 << (precision - pt - 1))) & 0xFFFF;
            prev[0] = ra;
            for (int x = 1; x < w; x++) prev[x] = ra = (d[x] + ra) & 0xFFFF;
            c.first_row = false;
        } else if (psv == 1) {
            ra = (d[0] + prev[0]) & 0xFFFF;
            prev[0] = ra;
            for (int x = 1; x < w; x++) prev[x] = ra = (d[x] + ra) & 0xFFFF;
        } else {
            int rb = prev[0], rc;
            ra = (d[0] + rb) & 0xFFFF;
            prev[0] = ra;
            for (int x = 1; x < w; x++) {
                rc = rb;
                rb = prev[x];
                int p;
                switch (psv) {
                    case 2: p = rb; break;
                    case 3: p = rc; break;
                    case 4: p = ra + rb - rc; break;
                    case 5: p = ra + ((rb - rc) >> 1); break;
                    case 6: p = rb + ((ra - rc) >> 1); break;
                    default: p = (ra + rb) >> 1; break;
                }
                prev[x] = ra = (d[x] + p) & 0xFFFF;
            }
        }
        for (int x = 0; x < w; x++) out[x] = static_cast<uint8_t>(prev[x] << pt);
    }

    // The whole file: the headers, then the scans, of a file of several
    // scans up to EOI (the fake EOI past its end included); the markers
    // after the scan of a one-scan file are never read (cv2 has its page
    // before jpeg_finish_decompress reads them).
    void decode() {
        read_header();
        while (true) {
            decode_scan();
            if (single_scan) return;
            int m = next_marker();
            while (m != 0xDA) {
                if (m == 0xD9) {
                    // libjpeg-turbo's lossless decoder gives up on a
                    // component that no scan reached
                    for (const auto& c : comps)
                        if (lossless && !c.scanned) fail("a lossless component without a scan");
                    return;
                }
                handle_marker(m);
                m = next_marker();
            }
        }
    }

    // The colour space libjpeg's default_decompress_parms guesses: 0
    // gray, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK; without a JFIF or Adobe
    // marker a lossless file of three components is RGB.
    int color_space() const {
        if (ncomp == 1) return 0;
        if (ncomp == 4) return adobe && adobe_transform != 0 ? 4 : 3;
        if (jfif) return 1;
        if (adobe) return adobe_transform == 0 ? 2 : 1;
        if (lossless) return 2;
        if (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B') return 2;
        return 1;
    }

    // jdcoefct.c smoothing_ok: block smoothing runs after a progressive
    // file whose every component had a DC scan, whose DC and first nine
    // AC quantizers are nonzero, and where one of those nine AC
    // coefficients of some component is not known to full precision.
    bool smoothing_ok() const {
        if (!progressive) return false;
        bool useful = false;
        for (const auto& c : comps) {
            if (!c.scanned) return false;
            for (int k = 0; k < 10; k++)
                if (c.quant[kZigzag[k]] == 0) return false;
            if (c.coef_bits[0] < 0) return false;
            for (int k = 1; k < 10; k++)
                if (c.coef_bits[k] != 0) useful = true;
        }
        return useful;
    }

    // The samples of a multi-scan file's components: the IDCT of every
    // block that holds samples of the image, smoothed where
    // smoothing_ok says so.
    void inverse_dct() {
        bool smooth = smoothing_ok();
        for (auto& c : comps) {
            if (c.coef.empty()) continue;
            int stride = c.stride;
            c.plane.assign(size_t(stride) * c.bh * 8, 0);
            if (smooth) {
                smooth_component(c);
            } else {
                for (int by = 0; by < c.hib; by++)
                    for (int bx = 0; bx < c.wib; bx++)
                        idct_islow(c.coef.data() + (size_t(by) * c.bw + bx) * 64, c.quant,
                                   c.plane.data() + size_t(by) * 8 * stride + bx * 8, stride);
            }
            std::vector<int16_t>().swap(c.coef);
        }
    }

    // jdcoefct.c decompress_smooth_data for one component: each block's
    // coefficients copied, the first nine AC coefficients that are zero
    // and not known to full precision estimated from the 5x5 blocks'
    // DC values around it (with no AC data at all, the DC as well, by a
    // Gaussian-like kernel), then the IDCT.  The rows above and below a
    // block are taken as libjpeg reaches them an iMCU row (v block
    // rows) at a time; the columns stop at the image's last block.
    void smooth_component(Component& c) {
        int prev[10];  // smoothing_ok's prev_coef_bits_latch
        for (int k = 0; k < 10; k++) prev[k] = scans > 1 ? c.prev_bits[k] : -1;
        const int64_t q00 = c.quant[0], q01 = c.quant[1], q10 = c.quant[8], q20 = c.quant[16],
                      q11 = c.quant[9], q02 = c.quant[2], q03 = c.quant[3], q12 = c.quant[10],
                      q21 = c.quant[17], q30 = c.quant[24];
        const int stride = c.stride;
        const int v = c.v, last_imcu = mcuy - 1;
        auto dc_at = [&](int row, int col) {
            return static_cast<int>(c.coef[(size_t(row) * c.bw + col) * 64]);
        };
        // An estimate: (num / Q + 1/2) in units of Q00 / 256, held under
        // 2^Al where Al is known.
        auto estimate = [](int64_t num, int64_t q, int al, bool clamp) {
            int64_t pred = ((q << 7) + (num >= 0 ? num : -num)) / (q << 8);
            if (clamp && al > 0 && pred >= (int64_t(1) << al)) pred = (int64_t(1) << al) - 1;
            return static_cast<int16_t>(num >= 0 ? pred : -pred);
        };
        int16_t ws[64];
        for (int row = 0; row < c.hib; row++) {
            // libjpeg numbers the rows of the last iMCU row, and counts
            // the image's, by that row's real block rows: short of v,
            // the numbers are off, and the bounds move with them.  Above
            // the last iMCU row a dummy row may serve as next2.
            int imcu = row / v, b = row % v;
            int block_rows = imcu < last_imcu ? v : (c.hib % v ? c.hib % v : v);
            int image_row = imcu * block_rows + b, image_rows = block_rows * mcuy;
            // Past the last iMCU row a cut-short scan reached, the
            // precision the scans before it left.
            const int* bits = imcu > last_good_imcu ? prev : c.coef_bits;
            const bool change_dc =
                std::all_of(bits + 1, bits + 10, [](int b) { return b == -1; });
            int prev = image_row > 0 ? row - 1 : row;
            int prev2 = image_row > 1 ? row - 2 : prev;
            int next = image_row < image_rows - 1 ? row + 1 : row;
            int next2 = image_row < image_rows - 2 ? row + 2 : next;
            const int rows[5] = {prev2, prev, row, next, next2};
            const int last_col = c.wib - 1;
            int d[5][5];  // d[r][x]: DC01..DC25, x = 2 the current column
            for (int col = 0; col < c.wib; col++) {
                std::memcpy(ws, c.coef.data() + (size_t(row) * c.bw + col) * 64, sizeof(ws));
                for (int r = 0; r < 5; r++)
                    for (int x = 0; x < 5; x++)
                        d[r][x] = dc_at(rows[r], std::min(std::max(col + x - 2, 0), last_col));
                const int DC01 = d[0][0], DC02 = d[0][1], DC03 = d[0][2], DC04 = d[0][3],
                          DC05 = d[0][4], DC06 = d[1][0], DC07 = d[1][1], DC08 = d[1][2],
                          DC09 = d[1][3], DC10 = d[1][4], DC11 = d[2][0], DC12 = d[2][1],
                          DC13 = d[2][2], DC14 = d[2][3], DC15 = d[2][4], DC16 = d[3][0],
                          DC17 = d[3][1], DC18 = d[3][2], DC19 = d[3][3], DC20 = d[3][4],
                          DC21 = d[4][0], DC22 = d[4][1], DC23 = d[4][2], DC24 = d[4][3],
                          DC25 = d[4][4];
                int al;
                if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
                    int64_t num = q00 * (change_dc
                        ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                           3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                           13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                        : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
                    ws[1] = estimate(num, q01, al, true);
                }
                if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
                    int64_t num = q00 * (change_dc
                        ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                           38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                           13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                        : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
                    ws[8] = estimate(num, q10, al, true);
                }
                if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
                    int64_t num = q00 * (change_dc
                        ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                           5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                        : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
                    ws[16] = estimate(num, q20, al, true);
                }
                if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
                    int64_t num = q00 * (change_dc
                        ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 -
                           DC25)
                        : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 +
                           DC04 - DC06 + 10 * DC07 - 10 * DC09));
                    ws[9] = estimate(num, q11, al, true);
                }
                if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
                    int64_t num = q00 * (change_dc
                        ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                           7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                        : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
                    ws[2] = estimate(num, q02, al, true);
                }
                if (change_dc) {
                    if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
                        ws[3] = estimate(q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19),
                                         q03, al, true);
                    if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
                        ws[10] = estimate(q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19),
                                          q12, al, true);
                    if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
                        ws[17] = estimate(q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19),
                                          q21, al, true);
                    if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
                        ws[24] = estimate(q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19),
                                          q30, al, true);
                    ws[0] = estimate(
                        q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                               6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 +
                               42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                               6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 -
                               6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25),
                        q00, 0, false);
                }
                idct_islow(ws, c.quant, c.plane.data() + size_t(row) * 8 * stride + col * 8, stride);
            }
        }
    }

    mutable std::vector<int> colsum;  // h2v2_fancy_upsample's column sums of a row

    // Output row y of component c upsampled to the image's width (jdsample.c).
    void upsample_row(const Component& c, int y, uint8_t* out) const {
        const std::vector<uint8_t>& plane = c.plane;
        int stride = c.stride;
        int hx = maxh / c.h, vy = maxv / c.v;
        const uint8_t* row = plane.data() + size_t(y / vy) * stride;
        if (hx == 1 && vy == 1) {
            std::memcpy(out, row, width);
            return;
        }
        // jdsample.c: fancy upsampling needs DCT blocks (lossless files
        // take the box), and h2 rows of more than two samples
        bool fancy = !lossless, fancy_h = fancy && hx == 2 && c.dw > 2;
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
        if (hx == 1 && vy == 2 && fancy) {  // h1v2_fancy_upsample
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

    // The components as libjpeg outputs them for JCS_UNKNOWN (no colour
    // conversion, as libtiff asks for its strips): upsampled, interleaved.
    void output_components(uint8_t* out) {
        inverse_dct();
        std::vector<uint8_t> rows(size_t(width) * ncomp);
        for (int y = 0; y < height; y++) {
            for (int ci = 0; ci < ncomp; ci++)
                upsample_row(comps[ci], y, rows.data() + size_t(ci) * width);
            uint8_t* o = out + size_t(y) * width * ncomp;
            for (int ci = 0; ci < ncomp; ci++)
                for (int x = 0; x < width; x++) o[size_t(x) * ncomp + ci] = rows[size_t(ci) * width + x];
        }
    }

    void output_bgr(uint8_t* out) {
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
            if (space == 1) {
                for (int x = 0; x < width; x++) {
                    int yy = c0[x], cb = c1[x], cr = c2[x];
                    o[3 * x + 2] = limit[yy + kYcc.cr_r[cr]];
                    o[3 * x + 1] = limit[yy + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)];
                    o[3 * x] = limit[yy + kYcc.cb_b[cb]];
                }
                continue;
            }
            const uint8_t* c3 = c2 + width;
            for (int x = 0; x < width; x++) {
                int cyan = c0[x], magenta = c1[x], yellow = c2[x], k = c3[x];
                if (space == 4) {  // jdcolor.c ycck_cmyk_convert
                    int yy = c0[x], cb = c1[x], cr = c2[x];
                    cyan = limit[255 - (yy + kYcc.cr_r[cr])];
                    magenta = limit[255 - (yy + ((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16))];
                    yellow = limit[255 - (yy + kYcc.cb_b[cb])];
                }
                // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
                o[3 * x + 2] = static_cast<uint8_t>(k - ((255 - cyan) * k >> 8));
                o[3 * x + 1] = static_cast<uint8_t>(k - ((255 - magenta) * k >> 8));
                o[3 * x] = static_cast<uint8_t>(k - ((255 - yellow) * k >> 8));
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
// Returns 0, or -1 (cv2.imread returns None) with the reason in err.
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
// the size jpeg_header gives.  Returns 0; 1 where libjpeg would have
// warned of data cut short or corrupt (the page is written all the
// same); or -1, where cv2.imread returns None, with the reason in err.
int32_t jpeg_decode_bgr(const uint8_t* data, int64_t size, uint8_t* out, int32_t height,
                        int32_t width, char* err, int32_t errlen) {
    try {
        Decoder d{data, static_cast<size_t>(size)};
        d.decode();
        if (d.height != height || d.width != width) fail("the output buffer has another size");
        d.output_bgr(out);
        return d.warned ? 1 : 0;
    } catch (const Failure& f) {
        set_error(f, err, errlen);
        return -1;
    } catch (const std::bad_alloc&) {
        set_error(Failure{"out of memory"}, err, errlen);
        return -1;
    }
}

// The file's components without colour conversion into out, a (height,
// width, components) uint8 buffer (libtiff's JCS_UNKNOWN strips).
// Returns as jpeg_decode_bgr does.
int32_t jpeg_decode_components(const uint8_t* data, int64_t size, uint8_t* out, int32_t height,
                               int32_t width, int32_t ncomp, char* err, int32_t errlen) {
    try {
        Decoder d{data, static_cast<size_t>(size)};
        d.raw = true;
        d.decode();
        if (d.height != height || d.width != width || d.ncomp != ncomp)
            fail("the output buffer has another size");
        d.output_components(out);
        return d.warned ? 1 : 0;
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
