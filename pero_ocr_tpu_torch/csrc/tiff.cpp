// The decompressors of TIFF strips and tiles that OpenCV 5's libtiff
// (4.7) applies before TIFFRGBAImage turns the samples into pixels: the
// port's cv2.imread(path, IMREAD_COLOR) for TIFF pages.  The container,
// Deflate (Python's zlib), JPEG (csrc/jpeg.cpp), the predictor and the
// pixel rules are in pero_ocr_tpu_torch/utils/tiff.py.
//
// - tiff_lzw: tif_lzw.c's LZWDecode, new-style codes (MSB first, 9 to
//   12 bits, the width growing one code early); decoding stops when the
//   output is full or at EOI, and data that ends (or a code that points
//   past the table) before the output is full is an error, as in
//   libtiff.
// - tiff_packbits: tif_packbits.c's PackBitsDecode.
// - tiff_fax: tif_fax3.c's decoders, white runs as 0 bits and black
//   runs as 1 bits, rows packed MSB first: Modified Huffman
//   (compression 2, each row from a byte boundary), T.4 (compression 3,
//   an EOL before each row, with 2D coding a tag bit after it; fill bits
//   are the zeros before an EOL) and T.6 (compression 4).  A run past
//   the row's end, a premature EOL, a code that does not exist and
//   uncompressed mode are errors here (libtiff pads such a row and
//   goes on), so a page is read whole or not at all.
//
// Built with the host compiler and loaded through ctypes by
// pero_ocr_tpu_torch/utils/kernels.py; bound in utils/tiff.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Failure {
    std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw Failure{what}; }

void set_error(const Failure& f, char* err, int errlen) {
    if (errlen > 0) {
        std::snprintf(err, static_cast<size_t>(errlen), "%s", f.what.c_str());
    }
}

// ---------------------------------------------------------------------
// LZW
int64_t lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    if (n >= 2 && in[0] == 0 && (in[1] & 1)) {
        fail("old-style (LSB-first) LZW data");
    }
    const int kClear = 256, kEoi = 257, kFirst = 258, kSize = 4096;
    std::vector<int32_t> prefix(kSize), length(kSize);
    std::vector<uint8_t> suffix(kSize), first(kSize);
    for (int i = 0; i < 256; ++i) {
        prefix[i] = -1;
        length[i] = 1;
        suffix[i] = first[i] = static_cast<uint8_t>(i);
    }
    int nbits = 9, free_ent = kFirst, old = -1;
    uint64_t acc = 0;
    int have = 0;
    int64_t pos = 0, done = 0;
    while (done < cap) {
        while (have < nbits && pos < n) {
            acc = (acc << 8) | in[pos++];
            have += 8;
        }
        if (have < nbits) {
            fail("LZW data ends before the strip is full");
        }
        int code = static_cast<int>((acc >> (have - nbits)) & ((1u << nbits) - 1));
        have -= nbits;
        if (code == kEoi) {
            fail("LZW data ends (EOI) before the strip is full");
        }
        if (code == kClear) {
            nbits = 9;
            free_ent = kFirst;
            old = -1;
            continue;
        }
        if (code > free_ent || (old < 0 && code >= 256)) {
            fail("corrupt LZW data (a code past the table)");
        }
        int emit = code;
        if (old >= 0) {
            // Entries past 4095 cannot be coded in 12 bits: libtiff's
            // table holds 1024 more before it calls the data corrupt.
            if (free_ent >= kSize + 1024) {
                fail("corrupt LZW data (the table overflows without a clear code)");
            }
            if (free_ent < kSize) {
                prefix[free_ent] = old;
                suffix[free_ent] = first[code == free_ent ? old : code];
                first[free_ent] = first[old];
                length[free_ent] = length[old] + 1;
            }
            ++free_ent;
            if (free_ent > (1 << nbits) - 2 && nbits < 12) {
                ++nbits;
            }
        }
        // The string of `emit`, written backwards into its place.
        int64_t len = length[emit];
        int64_t take = len < cap - done ? len : cap - done;
        int c = emit;
        for (int64_t k = len - 1; k >= 0; --k) {
            if (k < take) {
                out[done + k] = suffix[c];
            }
            c = prefix[c];
        }
        done += take;
        old = code;
    }
    return done;
}

// ---------------------------------------------------------------------
// PackBits
int64_t packbits_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    int64_t pos = 0, done = 0;
    while (done < cap) {
        if (pos >= n) {
            fail("PackBits data ends before the strip is full");
        }
        int c = static_cast<int8_t>(in[pos++]);
        if (c < 0) {
            if (c == -128) {
                continue;
            }
            if (pos >= n) {
                fail("PackBits data ends before the strip is full");
            }
            int64_t run = 1 - c;
            if (run > cap - done) {
                run = cap - done;  // libtiff discards the rest
            }
            std::memset(out + done, in[pos++], static_cast<size_t>(run));
            done += run;
        } else {
            int64_t run = c + 1;
            if (pos + run > n) {
                fail("PackBits data ends before the strip is full");
            }
            if (run > cap - done) {
                run = cap - done;
            }
            std::memcpy(out + done, in + pos, static_cast<size_t>(run));
            done += run;
            pos += c + 1;
        }
    }
    return done;
}

// ---------------------------------------------------------------------
// CCITT T.4 / T.6
struct Code {
    const char* bits;
    int value;
};

// Terminating (0-63) and make-up (64-1728) codes of ITU-T T.4 tables
// 2 and 3; then the extended make-up codes (1792-2560) shared by both
// colours.
const Code kWhite[] = {
    {"00110101", 0},   {"000111", 1},     {"0111", 2},       {"1000", 3},
    {"1011", 4},       {"1100", 5},       {"1110", 6},       {"1111", 7},
    {"10011", 8},      {"10100", 9},      {"00111", 10},     {"01000", 11},
    {"001000", 12},    {"000011", 13},    {"110100", 14},    {"110101", 15},
    {"101010", 16},    {"101011", 17},    {"0100111", 18},   {"0001100", 19},
    {"0001000", 20},   {"0010111", 21},   {"0000011", 22},   {"0000100", 23},
    {"0101000", 24},   {"0101011", 25},   {"0010011", 26},   {"0100100", 27},
    {"0011000", 28},   {"00000010", 29},  {"00000011", 30},  {"00011010", 31},
    {"00011011", 32},  {"00010010", 33},  {"00010011", 34},  {"00010100", 35},
    {"00010101", 36},  {"00010110", 37},  {"00010111", 38},  {"00101000", 39},
    {"00101001", 40},  {"00101010", 41},  {"00101011", 42},  {"00101100", 43},
    {"00101101", 44},  {"00000100", 45},  {"00000101", 46},  {"00001010", 47},
    {"00001011", 48},  {"01010010", 49},  {"01010011", 50},  {"01010100", 51},
    {"01010101", 52},  {"00100100", 53},  {"00100101", 54},  {"01011000", 55},
    {"01011001", 56},  {"01011010", 57},  {"01011011", 58},  {"01001010", 59},
    {"01001011", 60},  {"00110010", 61},  {"00110011", 62},  {"00110100", 63},
    {"11011", 64},     {"10010", 128},    {"010111", 192},   {"0110111", 256},
    {"00110110", 320}, {"00110111", 384}, {"01100100", 448}, {"01100101", 512},
    {"01101000", 576}, {"01100111", 640}, {"011001100", 704}, {"011001101", 768},
    {"011010010", 832}, {"011010011", 896}, {"011010100", 960}, {"011010101", 1024},
    {"011010110", 1088}, {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280},
    {"011011010", 1344}, {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536},
    {"010011010", 1600}, {"011000", 1664},  {"010011011", 1728},
};

const Code kBlack[] = {
    {"0000110111", 0},   {"010", 1},          {"11", 2},           {"10", 3},
    {"011", 4},          {"0011", 5},         {"0010", 6},         {"00011", 7},
    {"000101", 8},       {"000100", 9},       {"0000100", 10},     {"0000101", 11},
    {"0000111", 12},     {"00000100", 13},    {"00000111", 14},    {"000011000", 15},
    {"0000010111", 16},  {"0000011000", 17},  {"0000001000", 18},  {"00001100111", 19},
    {"00001101000", 20}, {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26}, {"000011001011", 27},
    {"000011001100", 28}, {"000011001101", 29}, {"000001101000", 30}, {"000001101001", 31},
    {"000001101010", 32}, {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38}, {"000011010111", 39},
    {"000001101100", 40}, {"000001101101", 41}, {"000011011010", 42}, {"000011011011", 43},
    {"000001010100", 44}, {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50}, {"000001010011", 51},
    {"000000100100", 52}, {"000000110111", 53}, {"000000111000", 54}, {"000000100111", 55},
    {"000000101000", 56}, {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62}, {"000001100111", 63},
    {"0000001111", 64},  {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448},
    {"0000001101100", 512}, {"0000001101101", 576}, {"0000001001010", 640},
    {"0000001001011", 704}, {"0000001001100", 768}, {"0000001001101", 832},
    {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344}, {"0000001010100", 1408},
    {"0000001010101", 1472}, {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728},
};

const Code kExtended[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560},
};

// The 2D mode codes of T.4 table 4 decode to 0-6 (vertical: a1 - b1
// + 3), kPass, kHorizontal or kExtension (uncompressed mode).
enum Mode { kPass = 7, kHorizontal = 8, kExtension = 9 };

// A binary decoding tree: each node's two children as indexes (-1:
// none), a leaf's value (-1: an inner node).
struct Tree {
    std::vector<int32_t> child0{-1}, child1{-1}, leaf{-1};

    void add(const char* bits, int value) {
        int node = 0;
        for (const char* p = bits; *p; ++p) {
            if (leaf[node] >= 0) {
                fail("a CCITT code table is not prefix-free");
            }
            std::vector<int32_t>& next = (*p == '0') ? child0 : child1;
            if (next[node] < 0) {
                next[node] = static_cast<int32_t>(leaf.size());
                child0.push_back(-1);
                child1.push_back(-1);
                leaf.push_back(-1);
            }
            node = next[node];
        }
        if (leaf[node] >= 0 || child0[node] >= 0 || child1[node] >= 0) {
            fail("a CCITT code table is not prefix-free");
        }
        leaf[node] = value;
    }
};

struct Tables {
    Tree white, black, modes;

    Tables() {
        for (const Code& c : kWhite) white.add(c.bits, c.value);
        for (const Code& c : kBlack) black.add(c.bits, c.value);
        for (const Code& c : kExtended) {
            white.add(c.bits, c.value);
            black.add(c.bits, c.value);
        }
        modes.add("1", 3);
        modes.add("011", 4);
        modes.add("010", 2);
        modes.add("000011", 5);
        modes.add("000010", 1);
        modes.add("0000011", 6);
        modes.add("0000010", 0);
        modes.add("0001", kPass);
        modes.add("001", kHorizontal);
        modes.add("0000001", kExtension);
    }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

struct BitReader {
    const uint8_t* data;
    int64_t nbits;
    int64_t pos = 0;

    int bit() {
        if (pos >= nbits) {
            fail("CCITT data ends before the last row");
        }
        int b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
        ++pos;
        return b;
    }

    int decode(const Tree& tree, const char* what) {
        int node = 0;
        while (tree.leaf[node] < 0) {
            int next = bit() ? tree.child1[node] : tree.child0[node];
            if (next < 0) {
                fail(std::string("an invalid CCITT ") + what + " code");
            }
            node = next;
        }
        return tree.leaf[node];
    }

    // One run length: make-up codes until a terminating code.
    int run(bool black) {
        const Tree& tree = black ? tables().black : tables().white;
        int total = 0;
        for (;;) {
            int v = decode(tree, black ? "black run" : "white run");
            total += v;
            if (v < 64) {
                return total;
            }
        }
    }

    void align() { pos = (pos + 7) & ~int64_t(7); }

    // The EOL before a T.4 row: bits are skipped until 11 zeros in a
    // row, then zeros until the 1 that ends the EOL.
    void sync_eol() {
        int zeros = 0;
        for (;;) {
            int b = bit();
            if (b == 0) {
                ++zeros;
            } else if (zeros >= 11) {
                return;
            } else {
                zeros = 0;
            }
        }
    }
};

// Changing elements of a row (positions where the colour flips, the
// first from white to black), then sentinels at the width.
void push_change(std::vector<int32_t>& changes, int32_t at, int32_t width) {
    if (at > width) {
        fail("a CCITT run reaches past the end of the row");
    }
    changes.push_back(at);
}

void decode_1d(BitReader& r, std::vector<int32_t>& changes, int32_t width) {
    changes.clear();
    int32_t a0 = 0;
    bool black = false;
    while (a0 < width) {
        int n = r.run(black);
        a0 += n;
        push_change(changes, a0, width);
        black = !black;
    }
    // A row that ends on a white run has an even number of changes, the
    // last one at the width; one that ends black, an odd number.
}

void decode_2d(BitReader& r, const std::vector<int32_t>& ref, std::vector<int32_t>& changes,
               int32_t width) {
    changes.clear();
    int32_t a0 = -1;
    int color = 0;  // 0 white, 1 black
    size_t i = 0;   // index into ref of the b1 candidate
    while (a0 < width) {
        // b1: the first change of ref right of a0 that turns ref to the
        // colour opposite a0's (even indexes turn white to black).
        while (i > 0 && ref[i - 1] > a0) --i;
        while (ref[i] <= a0 || static_cast<int>(i & 1) != color) ++i;
        int32_t b1 = ref[i], b2 = ref[i + 1];
        int mode = r.decode(tables().modes, "2D mode");
        int32_t start = a0 < 0 ? 0 : a0;
        if (mode == kPass) {
            a0 = b2;
        } else if (mode == kHorizontal) {
            int32_t a1 = start + r.run(color == 1);
            push_change(changes, a1, width);
            int32_t a2 = a1 + r.run(color == 0);
            push_change(changes, a2, width);
            a0 = a2;
        } else if (mode == kExtension) {
            fail("CCITT uncompressed mode");
        } else {
            int32_t a1 = b1 + (mode - 3);
            if (a1 < start) {
                fail("a CCITT vertical code points left of a0");
            }
            push_change(changes, a1, width);
            a0 = a1;
            color ^= 1;
        }
    }
    if (a0 > width) {
        fail("a CCITT run reaches past the end of the row");
    }
}

// Packed row from its changes: 1 bits from each even change to the next.
void fill_row(const std::vector<int32_t>& changes, int32_t width, uint8_t* row) {
    std::memset(row, 0, static_cast<size_t>((width + 7) / 8));
    for (size_t k = 0; k + 1 <= changes.size(); k += 2) {
        int32_t x0 = changes[k];
        int32_t x1 = k + 1 < changes.size() ? changes[k + 1] : width;
        if (x1 > width) x1 = width;
        for (int32_t x = x0; x < x1; ++x) {
            row[x >> 3] |= static_cast<uint8_t>(0x80 >> (x & 7));
        }
    }
}

void fax_decode(const uint8_t* in, int64_t n, uint8_t* out, int32_t width, int32_t rows,
                int32_t compression, int32_t two_d) {
    BitReader r{in, n * 8};
    const int64_t stride = (width + 7) / 8;
    std::vector<int32_t> ref, cur;
    ref.assign(4, width);  // an all-white reference row
    for (int32_t y = 0; y < rows; ++y) {
        bool coded_2d = false;
        if (compression == 3) {
            r.sync_eol();
            if (two_d) {
                coded_2d = r.bit() == 0;
            }
        } else if (compression == 4) {
            coded_2d = true;
        }
        if (coded_2d) {
            decode_2d(r, ref, cur, width);
        } else {
            decode_1d(r, cur, width);
        }
        if (compression == 2) {
            r.align();
        }
        fill_row(cur, width, out + y * stride);
        ref = cur;
        ref.push_back(width);
        ref.push_back(width);
        ref.push_back(width);
        ref.push_back(width);
    }
}

}  // namespace

extern "C" {

// Each returns the bytes written to `out` (LZW and PackBits: `cap`,
// the strip's decoded size) or -1 with a message in `err`.
int64_t tiff_lzw(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap, char* err,
                 int32_t errlen) {
    try {
        return lzw_decode(in, n, out, cap);
    } catch (const Failure& f) {
        set_error(f, err, errlen);
    } catch (const std::bad_alloc&) {
        set_error(Failure{"out of memory"}, err, errlen);
    }
    return -1;
}

int64_t tiff_packbits(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap, char* err,
                      int32_t errlen) {
    try {
        return packbits_decode(in, n, out, cap);
    } catch (const Failure& f) {
        set_error(f, err, errlen);
    }
    return -1;
}

// `rows` rows of `width` pixels into `out`, (width + 7) / 8 bytes a
// row; compression 2, 3 (two_d: T4Options bit 0) or 4.
int64_t tiff_fax(const uint8_t* in, int64_t n, uint8_t* out, int32_t width, int32_t rows,
                 int32_t compression, int32_t two_d, char* err, int32_t errlen) {
    try {
        if (width <= 0 || rows < 0 || compression < 2 || compression > 4) {
            fail("bad CCITT arguments");
        }
        fax_decode(in, n, out, width, rows, compression, two_d);
        return static_cast<int64_t>(rows) * ((width + 7) / 8);
    } catch (const Failure& f) {
        set_error(f, err, errlen);
    } catch (const std::bad_alloc&) {
        set_error(Failure{"out of memory"}, err, errlen);
    }
    return -1;
}

}  // extern "C"
