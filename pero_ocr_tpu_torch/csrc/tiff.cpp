// The decompressors of TIFF strips and tiles that OpenCV 5's libtiff
// (4.7) applies before TIFFRGBAImage turns the samples into pixels: the
// port's cv2.imread(path, IMREAD_COLOR) for TIFF pages.  The container,
// JPEG (csrc/jpeg.cpp), the predictor and the pixel rules are in
// pero_ocr_tpu_torch/utils/tiff.py.
//
// Each decoder copies its libtiff counterpart's handling of data that is
// cut short or corrupt, since OpenCV keeps what a failed strip decoded:
// the caller zeroes `out`, the decoder writes what libtiff writes, and
// the return value is libtiff's (1 the strip decoded whole, 0 it failed;
// -1 out of memory).
//
// - tiff_lzw: tif_lzw.c's LZWDecode (new-style codes, MSB first, 9 to
//   12 bits, a clear code first; data that runs out reads as EOI; a code
//   past the table ends the strip) and LZWDecodeCompat (old-style
//   codes, LSB first, for data that starts 00 and an odd byte).
// - tiff_packbits: tif_packbits.c's PackBitsDecode.
// - tiff_deflate: zlib's inflate as tif_zip.c's ZIPDecode drives it:
//   the zlib header, stored, fixed and dynamic blocks, every check zlib
//   makes; each symbol whose bits are all there is written.
// - tiff_thunder: tif_thunder.c's ThunderDecodeRow (4-bit samples).
// - tiff_sgilog: tif_luv.c's LogL16Decode, LogLuvDecode32 and
//   LogLuvDecode24 with the 8-bit conversions TIFFRGBAImage asks for
//   (L16toGry, XYZtoRGB24), and the (u', v') code table.
// - tiff_fax: tif_fax3.c's decoders and tif_fax3.h's state machine,
//   with mkg3states.c's tables: Modified Huffman (compression 2, each
//   row from a byte boundary; 32771, from a 16-bit word boundary), T.4
//   (compression 3, 1D or 2D after an EOL) and T.6 (compression 4).  A
//   bad code ends the row, which is padded as libtiff pads it; the run
//   arrays live across the strips of a page as libtiff's do.
//
// Built with the host compiler and loaded through ctypes by
// pero_ocr_tpu_torch/utils/kernels.py; bound in utils/tiff.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <new>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// LZW
constexpr int kBitsMin = 9, kBitsMax = 12;
constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kCsize = (1 << kBitsMax) - 1 + 1024;  // MAXCODE(BITS_MAX) + 1024

struct Code {
    int32_t next;  // -1: none
    uint16_t length;
    uint8_t value, firstchar;
};

// New-style codes: MSB first; the width grows when the next free entry
// passes 2^nbits - 2.  `free_ent` -1 is libtiff's full table, where the
// next code that is neither a clear nor an EOI is an error.
int lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t occ, std::vector<Code>& tab) {
    uint64_t bitsleft = static_cast<uint64_t>(n) * 8;
    int64_t pos = 0;
    uint64_t acc = 0;
    int have = 0;
    int nbits = kBitsMin;
    int free_ent = -1, old = 0;
    int maxcode = (1 << nbits) - 2;
    auto next_code = [&]() -> int {
        if (bitsleft < static_cast<uint64_t>(nbits)) {
            return kEoi;  // "not terminated with EOI code": a warning
        }
        while (have < nbits) {
            acc = (acc << 8) | in[pos++];
            have += 8;
        }
        bitsleft -= nbits;
        have -= nbits;
        return static_cast<int>((acc >> have) & ((1u << nbits) - 1));
    };
    auto add_entry = [&](int value) {
        Code& e = tab[free_ent];
        e.value = static_cast<uint8_t>(value);
        e.next = old;
        e.firstchar = tab[old].firstchar;
        e.length = static_cast<uint16_t>(tab[old].length + 1);
        if (++free_ent > maxcode) {
            if (++nbits > kBitsMax) nbits = kBitsMax;
            maxcode = (1 << nbits) - 2;
            if (free_ent >= kCsize) free_ent = -1;
        }
    };
    while (occ > 0) {
        int code = next_code();
        if (code == kEoi) break;
        if (code == kClear) {
            free_ent = kFirst;
            nbits = kBitsMin;
            maxcode = (1 << nbits) - 2;
            do {
                code = next_code();
            } while (code == kClear);
            if (code == kEoi) break;
            if (code > kEoi) {
                std::memset(out, 0, static_cast<size_t>(occ));
                return 0;  // "Using code not yet in table"
            }
            *out++ = static_cast<uint8_t>(code);
            --occ;
            old = code;
            continue;
        }
        if (code < kClear) {
            if (free_ent < 0 || code > free_ent) {
                std::memset(out, 0, static_cast<size_t>(occ));
                return 0;
            }
            add_entry(code);
            old = code;
            *out++ = static_cast<uint8_t>(code);
            --occ;
            continue;
        }
        // code >= 258
        if (free_ent < 0 || code > free_ent) {
            std::memset(out, 0, static_cast<size_t>(occ));
            return 0;
        }
        add_entry(code == free_ent ? tab[old].firstchar : tab[code].firstchar);
        old = code;
        int64_t len = tab[code].length;
        int c = code;
        if (len > occ) {  // the part that fits: the string's first bytes
            while (tab[c].length > occ) c = tab[c].next;
            for (int64_t k = occ - 1; k >= 0; --k) {
                out[k] = tab[c].value;
                c = tab[c].next;
            }
            out += occ;
            occ = 0;
            break;
        }
        for (int64_t k = len - 1; k >= 0; --k) {
            out[k] = tab[c].value;
            c = tab[c].next;
        }
        out += len;
        occ -= len;
    }
    if (occ > 0) {
        std::memset(out, 0, static_cast<size_t>(occ));
        return 0;
    }
    return 1;
}

// Old-style codes: LSB first; the width grows one entry later.
int lzw_decode_compat(const uint8_t* in, int64_t n, uint8_t* out, int64_t occ,
                      std::vector<Code>& tab) {
    uint64_t bitsleft = static_cast<uint64_t>(n) * 8;
    int64_t pos = 0;
    uint64_t acc = 0;
    int have = 0;
    int nbits = kBitsMin;
    int free_ent = -1, old = 0;
    int maxcode = (1 << nbits) - 1;
    auto next_code = [&]() -> int {
        if (bitsleft < static_cast<uint64_t>(nbits)) {
            return kEoi;
        }
        while (have < nbits) {
            acc |= static_cast<uint64_t>(in[pos++]) << have;
            have += 8;
        }
        bitsleft -= nbits;
        int code = static_cast<int>(acc & ((1u << nbits) - 1));
        acc >>= nbits;
        have -= nbits;
        return code;
    };
    while (occ > 0) {
        int code = next_code();
        if (code == kEoi) break;
        if (code == kClear) {
            do {
                free_ent = kFirst;
                for (int k = kFirst; k < kCsize; ++k) tab[k] = Code{-1, 0, 0, 0};
                nbits = kBitsMin;
                maxcode = (1 << nbits) - 1;
                code = next_code();
            } while (code == kClear);
            if (code == kEoi) break;
            if (code > kClear) return 0;  // "Corrupted LZW table"
            *out++ = static_cast<uint8_t>(code);
            --occ;
            old = code;
            continue;
        }
        if (free_ent < 0 || free_ent >= kCsize) return 0;
        Code& e = tab[free_ent];
        e.next = old;
        e.firstchar = tab[old].firstchar;
        e.length = static_cast<uint16_t>(tab[old].length + 1);
        e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
        if (++free_ent > maxcode) {
            if (++nbits > kBitsMax) nbits = kBitsMax;
            maxcode = (1 << nbits) - 1;
        }
        old = code;
        if (code >= 256) {
            int64_t len = tab[code].length;
            if (len == 0) return 0;  // "Wrong length of decoded string"
            int c = code;
            if (len > occ) {
                while (tab[c].length > occ) c = tab[c].next;
                for (int64_t k = occ - 1; k >= 0; --k) {
                    out[k] = tab[c].value;
                    c = tab[c].next;
                }
                return 1;
            }
            for (int64_t k = len - 1; k >= 0 && c >= 0; --k) {
                out[k] = tab[c].value;
                c = tab[c].next;
            }
            out += len;
            occ -= len;
        } else {
            *out++ = static_cast<uint8_t>(code);
            --occ;
        }
    }
    return occ > 0 ? 0 : 1;  // the rest is left as it was
}

// ---------------------------------------------------------------------
// PackBits
int packbits_decode(const uint8_t* in, int64_t cc, uint8_t* out, int64_t occ) {
    const int8_t* bp = reinterpret_cast<const int8_t*>(in);
    while (cc > 0 && occ > 0) {
        int64_t n = *bp++;
        --cc;
        if (n < 0) {
            if (n == -128) continue;
            n = -n + 1;
            if (occ < n) n = occ;
            if (cc == 0) break;
            occ -= n;
            uint8_t b = static_cast<uint8_t>(*bp++);
            --cc;
            std::memset(out, b, static_cast<size_t>(n));
            out += n;
        } else {
            if (occ < n + 1) n = occ - 1;
            if (cc < n + 1) break;
            ++n;
            std::memcpy(out, bp, static_cast<size_t>(n));
            out += n;
            occ -= n;
            bp += n;
            cc -= n;
        }
    }
    if (occ > 0) {
        std::memset(out, 0, static_cast<size_t>(occ));
        return 0;
    }
    return 1;
}

// ---------------------------------------------------------------------
// Deflate (zlib's inflate, as ZIPDecode calls it)
constexpr int kFastBits = 10;

struct Huffman {
    std::vector<int16_t> count, symbol;
    int max = 0;  // the longest code length used
    // The codes of kFastBits or fewer bits by their first kFastBits bits
    // (first bit lowest): (length << 16) | symbol, or -1.
    std::vector<int32_t> fast;
};

// inflate_table's checks: 0 good, -1 over-subscribed or incomplete
// (an incomplete code is allowed where its longest length is 1, as zlib
// allows it for literal/length and distance codes).
int build(Huffman& h, const int16_t* lengths, int n, bool lens_or_dists) {
    h.count.assign(16, 0);
    h.symbol.assign(n, 0);
    for (int s = 0; s < n; ++s) h.count[lengths[s]]++;
    h.max = 0;
    for (int len = 15; len >= 1; --len) {
        if (h.count[len]) {
            h.max = len;
            break;
        }
    }
    std::vector<int16_t> offs(16, 0);
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + h.count[len];
    for (int s = 0; s < n; ++s) {
        if (lengths[s]) h.symbol[offs[lengths[s]]++] = static_cast<int16_t>(s);
    }
    h.fast.assign(1 << kFastBits, -1);
    for (int len = 1, code = 0, k = 0; len <= kFastBits; ++len, code <<= 1) {
        for (int c = 0; c < h.count[len]; ++c, ++code, ++k) {
            int rev = 0;
            for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
            for (int e = rev; e < (1 << kFastBits); e += 1 << len) {
                h.fast[e] = (len << 16) | h.symbol[k];
            }
        }
    }
    if (h.max == 0) return 0;  // no codes: each lookup fails (or reads 0, see decode)
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
        left <<= 1;
        left -= h.count[len];
        if (left < 0) return -1;
    }
    if (left > 0 && (!lens_or_dists || h.max != 1)) return -1;
    return 0;
}

struct Inflater {
    const uint8_t* in;
    int64_t n, pos = 0;
    uint64_t bitbuf = 0;
    int bitcnt = 0;
    uint8_t* out;
    int64_t cap, done = 0;

    // false: the input ran out (the caller stops, keeping the output)
    bool need(int k) {
        while (bitcnt < k) {
            if (pos >= n) return false;
            bitbuf |= static_cast<uint64_t>(in[pos++]) << bitcnt;
            bitcnt += 8;
        }
        return true;
    }
    uint32_t take(int k) {
        uint32_t v = static_cast<uint32_t>(bitbuf & ((1ull << k) - 1));
        bitbuf >>= k;
        bitcnt -= k;
        return v;
    }
    // A symbol, or -1 the input ran out, -2 an invalid code.  A code
    // table without codes reads symbol 0 from one bit for the code
    // lengths code (zlib's table of invalid entries has value 0 there)
    // and fails elsewhere.
    int decode(const Huffman& h, bool codes) {
        if (h.max == 0) {
            if (!need(1)) return -1;
            if (codes) {
                take(1);
                return 0;
            }
            return -2;
        }
        if (bitcnt >= kFastBits || need(kFastBits)) {
            int32_t e = h.fast[bitbuf & ((1u << kFastBits) - 1)];
            if (e >= 0) {
                take(e >> 16);
                return e & 0xffff;
            }
        }
        int code = 0, first = 0, index = 0;
        for (int len = 1; len <= 15; ++len) {
            if (!need(len)) return -1;
            code |= static_cast<int>((bitbuf >> (len - 1)) & 1);
            int count = h.count[len];
            if (code - count < first) {
                take(len);
                return h.symbol[index + (code - first)];
            }
            index += count;
            first += count;
            first <<= 1;
            code <<= 1;
            if (len >= h.max) {
                // no code of this many bits or more: zlib's invalid
                // entry (the bits are all there to look it up)
                return -2;
            }
        }
        return -2;
    }
};

constexpr int16_t kLenBase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
                                  31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
constexpr int16_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                   2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
constexpr int32_t kDistBase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                                   193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                                   6145, 8193, 12289, 16385, 24577};
constexpr int16_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                                    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// zlib's inflate goes on past a full output buffer until a symbol
// needs room: an error there (a bad code, a distance too far back, a
// bad block header, the Adler-32 check of a stream that ends with the
// buffer) still fails the strip, which then skips the predictor.
// `full()` is whether the output is full; input that runs out is then
// no error.
constexpr int kEndOfBlock = 0, kOk = 1, kFail = -1;

uint32_t adler32(const uint8_t* p, int64_t n) {
    uint64_t a = 1, b = 0;
    for (int64_t k = 0; k < n; ++k) {
        a = (a + p[k]) % 65521;
        b = (b + a) % 65521;
    }
    return static_cast<uint32_t>((b << 16) | a);
}

// The block's symbols until its end (kEndOfBlock), a symbol that needs
// room in a full output (kOk), or an error or the end of the input
// (kFail, or kOk where the output is full).
int codes(Inflater& s, const Huffman& lencode, const Huffman& distcode) {
    for (;;) {
        const bool full = s.done == s.cap;
        const int ran_out = full ? kOk : kFail;
        int sym = s.decode(lencode, false);
        if (sym == -1) return ran_out;
        if (sym < 0) return kFail;  // "invalid literal/length code"
        if (sym < 256) {
            if (full) return kOk;
            s.out[s.done++] = static_cast<uint8_t>(sym);
            continue;
        }
        if (sym == 256) return kEndOfBlock;
        sym -= 257;
        if (sym >= 29) return kFail;
        if (!s.need(kLenExtra[sym])) return ran_out;
        int len = kLenBase[sym] + static_cast<int>(s.take(kLenExtra[sym]));
        int dsym = s.decode(distcode, false);
        if (dsym == -1) return ran_out;
        if (dsym < 0 || dsym >= 30) return kFail;  // "invalid distance code"
        if (!s.need(kDistExtra[dsym])) return ran_out;
        int64_t dist = kDistBase[dsym] + static_cast<int64_t>(s.take(kDistExtra[dsym]));
        if (dist > s.done) return kFail;  // "invalid distance too far back"
        if (full) return kOk;
        int k = 0;
        for (; k < len && s.done < s.cap; ++k) {
            s.out[s.done] = s.out[s.done - dist];
            ++s.done;
        }
        if (k < len) return kOk;  // the rest of the match waits for room
    }
}

int inflate_zlib(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    Inflater s{in, n};
    s.out = out;
    s.cap = cap;
    if (n < 2) return cap == 0 ? 1 : 0;
    int cmf = in[0], flg = in[1];
    if (((cmf << 8) | flg) % 31 != 0 || (cmf & 15) != 8 || (cmf >> 4) + 8 > 15) return 0;
    if (flg & 0x20) return 0;  // a preset dictionary: Z_NEED_DICT
    s.pos = 2;
    static const Huffman* fixed_len = nullptr;
    static const Huffman* fixed_dist = nullptr;
    if (fixed_len == nullptr) {
        static Huffman fl, fd;
        int16_t lengths[288];
        for (int k = 0; k < 144; ++k) lengths[k] = 8;
        for (int k = 144; k < 256; ++k) lengths[k] = 9;
        for (int k = 256; k < 280; ++k) lengths[k] = 7;
        for (int k = 280; k < 288; ++k) lengths[k] = 8;
        build(fl, lengths, 288, true);
        for (int k = 0; k < 30; ++k) lengths[k] = 5;
        build(fd, lengths, 30, true);  // incomplete, as zlib's fixed table is
        fixed_len = &fl;
        fixed_dist = &fd;
    }
    // 1: the strip decoded whole (the output full and no error after
    // it), 0: it failed.
    auto ran_out = [&]() { return s.done == s.cap ? 1 : 0; };
    for (;;) {
        if (!s.need(3)) return ran_out();
        int last = static_cast<int>(s.take(1));
        int type = static_cast<int>(s.take(2));
        if (type == 0) {
            s.take(s.bitcnt & 7);
            if (!s.need(32)) return ran_out();
            uint32_t len = s.take(16), nlen = s.take(16);
            if (len != (~nlen & 0xffff)) return 0;  // "invalid stored block lengths"
            // the bit buffer holds whole bytes only here
            while (len > 0) {
                if (s.done == s.cap) return 1;
                if (s.bitcnt >= 8) {
                    s.out[s.done++] = static_cast<uint8_t>(s.take(8));
                } else if (s.pos < s.n) {
                    s.out[s.done++] = s.in[s.pos++];
                } else {
                    return 0;
                }
                --len;
            }
        } else if (type == 1 || type == 2) {
            Huffman lencode, distcode;
            const Huffman* lc = fixed_len;
            const Huffman* dc = fixed_dist;
            if (type == 2) {
                if (!s.need(14)) return ran_out();
                int nlen = static_cast<int>(s.take(5)) + 257;
                int ndist = static_cast<int>(s.take(5)) + 1;
                int ncode = static_cast<int>(s.take(4)) + 4;
                if (nlen > 286 || ndist > 30) return 0;
                static const int order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                              11, 4, 12, 3, 13, 2, 14, 1, 15};
                int16_t lengths[320] = {0};
                for (int k = 0; k < ncode; ++k) {
                    if (!s.need(3)) return ran_out();
                    lengths[order[k]] = static_cast<int16_t>(s.take(3));
                }
                if (build(lencode, lengths, 19, false) != 0) return 0;
                int have = 0;
                int16_t lens[320] = {0};
                while (have < nlen + ndist) {
                    int sym = s.decode(lencode, true);
                    if (sym == -1) return ran_out();
                    if (sym < 0) return 0;
                    if (sym < 16) {
                        lens[have++] = static_cast<int16_t>(sym);
                        continue;
                    }
                    int16_t len = 0;
                    int copy;
                    if (sym == 16) {
                        if (have == 0) return 0;  // "invalid bit length repeat"
                        len = lens[have - 1];
                        if (!s.need(2)) return ran_out();
                        copy = 3 + static_cast<int>(s.take(2));
                    } else if (sym == 17) {
                        if (!s.need(3)) return ran_out();
                        copy = 3 + static_cast<int>(s.take(3));
                    } else {
                        if (!s.need(7)) return ran_out();
                        copy = 11 + static_cast<int>(s.take(7));
                    }
                    if (have + copy > nlen + ndist) return 0;
                    while (copy--) lens[have++] = len;
                }
                if (lens[256] == 0) return 0;  // "missing end-of-block"
                if (build(lencode, lens, nlen, true) != 0) return 0;
                if (build(distcode, lens + nlen, ndist, true) != 0) return 0;
                lc = &lencode;
                dc = &distcode;
            }
            int r = codes(s, *lc, *dc);
            if (r == kOk) return s.done == s.cap ? 1 : 0;
            if (r == kFail) return 0;
        } else {
            return 0;  // "invalid block type"
        }
        if (last) {
            // Z_STREAM_END before the strip is full fails; with it full,
            // the Adler-32 check decides, where its bytes are there.
            if (s.done != s.cap) return 0;
            s.take(s.bitcnt & 7);
            if (!s.need(32)) return 1;
            uint32_t check = 0;
            for (int k = 0; k < 4; ++k) check = (check << 8) | s.take(8);
            return check == adler32(s.out, s.done) ? 1 : 0;
        }
    }
}

// ---------------------------------------------------------------------
// ThunderScan (4-bit)
int thunder_row(const uint8_t*& bp, int64_t& cc, uint8_t* op, int64_t maxpixels) {
    static const int twobit[4] = {0, 1, 0, -1};
    static const int threebit[8] = {0, 1, 2, 3, 0, -3, -2, -1};
    uint8_t* const op0 = op;
    unsigned lastpixel = 0;
    int64_t npixels = 0;
    auto setpixel = [&](unsigned v) {
        lastpixel = v & 0xf;
        if (npixels < maxpixels) {
            if (npixels++ & 1) {
                *op++ |= static_cast<uint8_t>(lastpixel);
            } else {
                op[0] = static_cast<uint8_t>(lastpixel << 4);
            }
        }
    };
    while (cc > 0 && npixels < maxpixels) {
        int n = *bp++;
        cc--;
        int delta;
        switch (n & 0xc0) {
            case 0x00:  // a run of the last pixel
                if (npixels & 1) {
                    op[0] |= static_cast<uint8_t>(lastpixel);
                    lastpixel = *op++;
                    npixels++;
                    n--;
                } else {
                    lastpixel |= lastpixel << 4;
                }
                npixels += n;
                if (npixels <= maxpixels) {
                    for (; n > 0; n -= 2) *op++ = static_cast<uint8_t>(lastpixel);
                }
                if (n == -1) *--op &= 0xf0;
                lastpixel &= 0xf;
                break;
            case 0x40:
                if ((delta = (n >> 4) & 3) != 2) setpixel(lastpixel + twobit[delta]);
                if ((delta = (n >> 2) & 3) != 2) setpixel(lastpixel + twobit[delta]);
                if ((delta = n & 3) != 2) setpixel(lastpixel + twobit[delta]);
                break;
            case 0x80:
                if ((delta = (n >> 3) & 7) != 4) setpixel(lastpixel + threebit[delta]);
                if ((delta = n & 7) != 4) setpixel(lastpixel + threebit[delta]);
                break;
            default:
                setpixel(static_cast<unsigned>(n));
                break;
        }
    }
    if (npixels != maxpixels) {
        uint8_t* end = op0 + (maxpixels + 1) / 2;
        if (op < end) std::memset(op, 0, static_cast<size_t>(end - op));
        return 0;
    }
    return 1;
}

// ---------------------------------------------------------------------
// SGILog (tif_luv.c), read as TIFFRGBAImage asks for it:
// SGILOGDATAFMT_8BIT, each row decoded whole or not at all.
constexpr double kLn2 = 0.69314718055994530942;  // M_LN2

double logl16_to_y(int p16) {
    int le = p16 & 0x7fff;
    if (!le) return 0.;
    double y = std::exp(kLn2 / 256. * (le + .5) - kLn2 * 64.);
    return !(p16 & 0x8000) ? y : -y;
}

double logl10_to_y(int p10) {
    if (p10 == 0) return 0.;
    return std::exp(kLn2 / 64. * (p10 + .5) - kLn2 * 12.);
}

uint8_t gamma8(double v) {
    return static_cast<uint8_t>((v <= 0.) ? 0 : (v >= 1.) ? 255 : static_cast<int>(256. * std::sqrt(v)));
}

// XYZtoRGB24: CCIR-709 primaries, a 2.0 gamma.
void xyz_to_rgb24(const float* xyz, uint8_t* rgb) {
    double r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2];
    double g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2];
    double b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2];
    rgb[0] = gamma8(r);
    rgb[1] = gamma8(g);
    rgb[2] = gamma8(b);
}

void uv_to_xyz(double L, double u, double v, float* xyz) {
    double s = 1. / (6. * u - 16. * v + 12.);
    double x = 9. * u * s;
    double y = 4. * v * s;
    xyz[0] = static_cast<float>(x / y * L);
    xyz[1] = static_cast<float>(L);
    xyz[2] = static_cast<float>((1. - x - y) / y * L);
}

// tif_luv.c's uv_row (uvcode.h): each row of (u', v') squares, its
// first u', its count and the codes before it; recovered from OpenCV's
// decode of every code (tests/data/tiff/uv_table.py).
struct UvRow {
    float ustart;
    int16_t nus, ncum;
};
const UvRow kUvRow[] = {
    {0.247663f, 4, 0}, {0.243779f, 6, 4}, {0.241684f, 7, 10}, {0.237874f, 9, 17},
    {0.235906f, 10, 26}, {0.232153f, 12, 36}, {0.228352f, 14, 48}, {0.226259f, 15, 62},
    {0.222371f, 17, 77}, {0.220410f, 18, 94}, {0.214710f, 21, 112}, {0.212714f, 22, 133},
    {0.210721f, 23, 155}, {0.204976f, 26, 178}, {0.202986f, 27, 204}, {0.199245f, 29, 231},
    {0.195525f, 31, 260}, {0.193560f, 32, 291}, {0.189878f, 34, 323}, {0.186216f, 36, 357},
    {0.186216f, 36, 393}, {0.182592f, 38, 429}, {0.179003f, 40, 467}, {0.175466f, 42, 507},
    {0.172001f, 44, 549}, {0.172001f, 44, 593}, {0.168612f, 46, 637}, {0.168612f, 46, 683},
    {0.163575f, 49, 729}, {0.158642f, 52, 778}, {0.158642f, 52, 830}, {0.158642f, 52, 882},
    {0.153815f, 55, 934}, {0.153815f, 55, 989}, {0.149097f, 58, 1044}, {0.149097f, 58, 1102},
    {0.142746f, 62, 1160}, {0.142746f, 62, 1222}, {0.142746f, 62, 1284}, {0.138270f, 65, 1346},
    {0.138270f, 65, 1411}, {0.138270f, 65, 1476}, {0.132166f, 69, 1541}, {0.132166f, 69, 1610},
    {0.126204f, 73, 1679}, {0.126204f, 73, 1752}, {0.126204f, 73, 1825}, {0.120381f, 77, 1898},
    {0.120381f, 77, 1975}, {0.120381f, 77, 2052}, {0.120381f, 77, 2129}, {0.112962f, 82, 2206},
    {0.112962f, 82, 2288}, {0.112962f, 82, 2370}, {0.107450f, 86, 2452}, {0.107450f, 86, 2538},
    {0.107450f, 86, 2624}, {0.107450f, 86, 2710}, {0.100343f, 91, 2796}, {0.100343f, 91, 2887},
    {0.100343f, 91, 2978}, {0.095126f, 95, 3069}, {0.095126f, 95, 3164}, {0.095126f, 95, 3259},
    {0.095126f, 95, 3354}, {0.088276f, 100, 3449}, {0.088276f, 100, 3549},
    {0.088276f, 100, 3649}, {0.088276f, 100, 3749}, {0.081523f, 105, 3849},
    {0.081523f, 105, 3954}, {0.081523f, 105, 4059}, {0.081523f, 105, 4164},
    {0.074861f, 110, 4269}, {0.074861f, 110, 4379}, {0.074861f, 110, 4489},
    {0.074861f, 110, 4599}, {0.068290f, 115, 4709}, {0.068290f, 115, 4824},
    {0.068290f, 115, 4939}, {0.068290f, 115, 5054}, {0.063573f, 119, 5169},
    {0.063573f, 119, 5288}, {0.063573f, 119, 5407}, {0.063573f, 119, 5526},
    {0.057219f, 124, 5645}, {0.057219f, 124, 5769}, {0.057219f, 124, 5893},
    {0.057219f, 124, 6017}, {0.050985f, 129, 6141}, {0.050985f, 129, 6270},
    {0.050985f, 129, 6399}, {0.050985f, 129, 6528}, {0.050985f, 129, 6657},
    {0.044859f, 134, 6786}, {0.044859f, 134, 6920}, {0.044859f, 134, 7054},
    {0.044859f, 134, 7188}, {0.040571f, 138, 7322}, {0.040571f, 138, 7460},
    {0.040571f, 138, 7598}, {0.040571f, 138, 7736}, {0.036339f, 142, 7874},
    {0.036339f, 142, 8016}, {0.036339f, 142, 8158}, {0.036339f, 142, 8300},
    {0.032139f, 146, 8442}, {0.032139f, 146, 8588}, {0.032139f, 146, 8734},
    {0.032139f, 146, 8880}, {0.027947f, 150, 9026}, {0.027947f, 150, 9176},
    {0.027947f, 150, 9326}, {0.023739f, 154, 9476}, {0.023739f, 154, 9630},
    {0.023739f, 154, 9784}, {0.023739f, 154, 9938}, {0.019504f, 158, 10092},
    {0.019504f, 158, 10250}, {0.019504f, 158, 10408}, {0.016976f, 161, 10566},
    {0.016976f, 161, 10727}, {0.016976f, 161, 10888}, {0.016976f, 161, 11049},
    {0.012639f, 165, 11210}, {0.012639f, 165, 11375}, {0.012639f, 165, 11540},
    {0.009991f, 168, 11705}, {0.009991f, 168, 11873}, {0.009991f, 168, 12041},
    {0.009016f, 170, 12209}, {0.009016f, 170, 12379}, {0.009016f, 170, 12549},
    {0.006217f, 173, 12719}, {0.006217f, 173, 12892}, {0.005097f, 175, 13065},
    {0.005097f, 175, 13240}, {0.005097f, 175, 13415}, {0.003909f, 177, 13590},
    {0.003909f, 177, 13767}, {0.002340f, 177, 13944}, {0.002389f, 170, 14121},
    {0.001068f, 164, 14291}, {0.001653f, 157, 14455}, {0.000717f, 150, 14612},
    {0.001614f, 143, 14762}, {0.000270f, 136, 14905}, {0.000484f, 129, 15041},
    {0.001103f, 123, 15170}, {0.001242f, 115, 15293}, {0.001188f, 109, 15408},
    {0.001011f, 103, 15517}, {0.000709f, 97, 15620}, {0.000301f, 89, 15717},
    {0.002416f, 82, 15806}, {0.003251f, 76, 15888}, {0.003246f, 69, 15964},
    {0.004141f, 62, 16033}, {0.005963f, 55, 16095}, {0.008839f, 47, 16150},
    {0.010490f, 40, 16197}, {0.016994f, 31, 16237}, {0.023659f, 21, 16268},
};
constexpr int kUvNvs = 163, kUvNdivs = 16289;
constexpr float kUvSqsiz = 0.0035f, kUvVstart = 0.01694f;

// uv_decode: the (u', v') at the middle of code c's square; false past
// the table.
bool uv_decode(double* up, double* vp, int c) {
    if (c < 0 || c >= kUvNdivs) return false;
    int lower = 0, upper = kUvNvs;
    while (upper - lower > 1) {
        int vi = (lower + upper) >> 1;
        int ui = c - kUvRow[vi].ncum;
        if (ui > 0) {
            lower = vi;
        } else if (ui < 0) {
            upper = vi;
        } else {
            lower = vi;
            break;
        }
    }
    int vi = lower;
    int ui = c - kUvRow[vi].ncum;
    *up = kUvRow[vi].ustart + (ui + .5) * kUvSqsiz;
    *vp = kUvVstart + (vi + .5) * kUvSqsiz;
    return true;
}

void luv24_to_xyz(uint32_t p, float* xyz) {
    double L = logl10_to_y(p >> 14 & 0x3ff);
    if (L <= 0.) {
        xyz[0] = xyz[1] = xyz[2] = 0.f;
        return;
    }
    double u, v;
    if (!uv_decode(&u, &v, p & 0x3fff)) {
        u = 4. / 19.;  // U_NEU
        v = 9. / 19.;  // V_NEU
    }
    uv_to_xyz(L, u, v, xyz);
}

void luv32_to_xyz(uint32_t p, float* xyz) {
    double L = logl16_to_y(static_cast<int>(p) >> 16);
    if (L <= 0.) {
        xyz[0] = xyz[1] = xyz[2] = 0.f;
        return;
    }
    const double kUvScale = 410.;
    double u = 1. / kUvScale * (((p >> 8) & 0xff) + .5);
    double v = 1. / kUvScale * ((p & 0xff) + .5);
    uv_to_xyz(L, u, v, xyz);
}

// LogL16Decode / LogLuvDecode32: run-length coded byte planes, the most
// significant first.  `tp` holds the row's npixels words, zeroed.
template <typename T>
int sgilog_rle_row(const uint8_t*& bp, int64_t& cc, T* tp, int64_t npixels, int top_shift) {
    for (int shft = top_shift; shft >= 0; shft -= 8) {
        int64_t i = 0;
        while (i < npixels && cc > 0) {
            if (*bp >= 128) {  // a run
                if (cc < 2) break;
                int rc = *bp++ + (2 - 128);
                T b = static_cast<T>(static_cast<uint32_t>(*bp++) << shft);
                cc -= 2;
                while (rc-- && i < npixels) tp[i++] |= b;
            } else {  // literal bytes; 0 is a no-op
                int rc = *bp++;
                while (--cc && rc-- && i < npixels) {
                    tp[i++] |= static_cast<T>(static_cast<uint32_t>(*bp++) << shft);
                }
            }
        }
        if (i != npixels) return 0;
    }
    return 1;
}


enum State : uint8_t {
    S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
    S_MakeUp, S_EOL
};

struct TabEnt {
    uint8_t State = S_Null, Width = 0;
    uint32_t Param = 0;
};

struct Proto {
    const char* bits;  // the code, first bit first
    uint32_t param;
};

// ITU-T T.4 tables 2 and 3 (terminating and make-up codes), then the
// extended make-up codes both colours share.
const Proto kTermW[] = {
    {"00110101", 0}, {"000111", 1}, {"0111", 2}, {"1000", 3}, {"1011", 4}, {"1100", 5},
    {"1110", 6}, {"1111", 7}, {"10011", 8}, {"10100", 9}, {"00111", 10}, {"01000", 11},
    {"001000", 12}, {"000011", 13}, {"110100", 14}, {"110101", 15}, {"101010", 16},
    {"101011", 17}, {"0100111", 18}, {"0001100", 19}, {"0001000", 20}, {"0010111", 21},
    {"0000011", 22}, {"0000100", 23}, {"0101000", 24}, {"0101011", 25}, {"0010011", 26},
    {"0100100", 27}, {"0011000", 28}, {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35}, {"00010101", 36},
    {"00010110", 37}, {"00010111", 38}, {"00101000", 39}, {"00101001", 40}, {"00101010", 41},
    {"00101011", 42}, {"00101100", 43}, {"00101101", 44}, {"00000100", 45}, {"00000101", 46},
    {"00001010", 47}, {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55}, {"01011001", 56},
    {"01011010", 57}, {"01011011", 58}, {"01001010", 59}, {"01001011", 60}, {"00110010", 61},
    {"00110011", 62}, {"00110100", 63},
};
const Proto kMakeUpW[] = {
    {"11011", 64}, {"10010", 128}, {"010111", 192}, {"0110111", 256}, {"00110110", 320},
    {"00110111", 384}, {"01100100", 448}, {"01100101", 512}, {"01101000", 576},
    {"01100111", 640}, {"011001100", 704}, {"011001101", 768}, {"011010010", 832},
    {"011010011", 896}, {"011010100", 960}, {"011010101", 1024}, {"011010110", 1088},
    {"011010111", 1152}, {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536}, {"010011010", 1600},
    {"011000", 1664}, {"010011011", 1728},
};
const Proto kTermB[] = {
    {"0000110111", 0}, {"010", 1}, {"11", 2}, {"10", 3}, {"011", 4}, {"0011", 5},
    {"0010", 6}, {"00011", 7}, {"000101", 8}, {"000100", 9}, {"0000100", 10},
    {"0000101", 11}, {"0000111", 12}, {"00000100", 13}, {"00000111", 14}, {"000011000", 15},
    {"0000010111", 16}, {"0000011000", 17}, {"0000001000", 18}, {"00001100111", 19},
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
};
const Proto kMakeUpB[] = {
    {"0000001111", 64}, {"000011001000", 128}, {"000011001001", 192}, {"000001011011", 256},
    {"000000110011", 320}, {"000000110100", 384}, {"000000110101", 448},
    {"0000001101100", 512}, {"0000001101101", 576}, {"0000001001010", 640},
    {"0000001001011", 704}, {"0000001001100", 768}, {"0000001001101", 832},
    {"0000001110010", 896}, {"0000001110011", 960}, {"0000001110100", 1024},
    {"0000001110101", 1088}, {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344}, {"0000001010100", 1408},
    {"0000001010101", 1472}, {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728},
};
const Proto kMakeUp[] = {
    {"00000001000", 1792}, {"00000001100", 1856}, {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560},
};
const Proto kEOLH[] = {{"00000000000", 0}};  // 11 zeros: the EOL's 1 is left
const Proto kPass[] = {{"0001", 0}};
const Proto kHoriz[] = {{"001", 0}};
const Proto kV0[] = {{"1", 0}};
const Proto kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}};
const Proto kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}};
const Proto kExt[] = {{"0000001", 0}};
const Proto kEOLV[] = {{"0000000", 0}};

struct FaxTables {
    TabEnt main[128], white[4096], black[8192];
    uint8_t rev[256];

    template <size_t N>
    static void fill(TabEnt* t, int size, const Proto (&protos)[N], State state) {
        for (const Proto& p : protos) {
            int width = static_cast<int>(std::strlen(p.bits));
            int code = 0;
            for (int k = 0; k < width; ++k) code |= (p.bits[k] == '1') << k;  // LSB first
            for (int c = code; c < (1 << size); c += 1 << width) {
                t[c].State = state;
                t[c].Width = static_cast<uint8_t>(width);
                t[c].Param = p.param;
            }
        }
    }

    FaxTables() {
        fill(main, 7, kPass, S_Pass);
        fill(main, 7, kHoriz, S_Horiz);
        fill(main, 7, kV0, S_V0);
        fill(main, 7, kVR, S_VR);
        fill(main, 7, kVL, S_VL);
        fill(main, 7, kExt, S_Ext);
        fill(main, 7, kEOLV, S_EOL);
        fill(white, 12, kMakeUpW, S_MakeUpW);
        fill(white, 12, kMakeUp, S_MakeUp);
        fill(white, 12, kTermW, S_TermW);
        fill(white, 12, kEOLH, S_EOL);
        fill(black, 13, kMakeUpB, S_MakeUpB);
        fill(black, 13, kMakeUp, S_MakeUp);
        fill(black, 13, kTermB, S_TermB);
        fill(black, 13, kEOLH, S_EOL);
        for (int i = 0; i < 256; ++i) {
            int r = 0;
            for (int k = 0; k < 8; ++k) r |= ((i >> k) & 1) << (7 - k);
            rev[i] = static_cast<uint8_t>(r);
        }
    }
};

const FaxTables& fax_tables() {
    static const FaxTables t;
    return t;
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them.
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
    if ((erun - runs) & 1) *erun++ = 0;
    uint32_t x = 0;
    for (; runs < erun; runs += 2) {
        for (int colour = 0; colour < 2; ++colour) {
            uint32_t run = runs[colour];
            if (x + run > lastx || run > lastx) run = runs[colour] = lastx - x;
            for (uint32_t k = 0; k < run; ++k) {
                uint32_t p = x + k;
                if (colour) {
                    buf[p >> 3] |= static_cast<uint8_t>(0x80 >> (p & 7));
                } else {
                    buf[p >> 3] &= static_cast<uint8_t>(~(0x80 >> (p & 7)));
                }
            }
            x += run;
        }
    }
}

// The decoders' shared state, as Fax3CodecState holds it: the run
// arrays outlive a strip (the caller keeps `runs` for the page).
constexpr int32_t kNoEol = 1;

struct Fax {
    int32_t* mode;  // kNoEol, kept for the page
    const uint8_t* cp;
    const uint8_t* ep;
    uintptr_t base;  // the address parity the 16-bit word alignment sees
    const uint8_t* start;
    uint32_t BitAcc = 0;
    int BitsAvail = 0, EOLcnt = 0;
    uint32_t* runs;
    uint32_t nruns;
    uint32_t* curruns;
    uint32_t* refruns;
    uint32_t lastx;
    int line = 0;
};

#define EndOfData() (cp >= ep)
#define NeedBits8(n, eoflab)                                      \
    do {                                                          \
        if (BitsAvail < (n)) {                                    \
            if (EndOfData()) {                                    \
                if (BitsAvail == 0) goto eoflab;                  \
                BitsAvail = (n);                                  \
            } else {                                              \
                BitAcc |= static_cast<uint32_t>(rev[*cp++]) << BitsAvail; \
                BitsAvail += 8;                                   \
            }                                                     \
        }                                                         \
    } while (0)
#define NeedBits16(n, eoflab)                                                 \
    do {                                                                      \
        if (BitsAvail < (n)) {                                                \
            if (EndOfData()) {                                                \
                if (BitsAvail == 0) goto eoflab;                              \
                BitsAvail = (n);                                              \
            } else {                                                          \
                BitAcc |= static_cast<uint32_t>(rev[*cp++]) << BitsAvail;     \
                if ((BitsAvail += 8) < (n)) {                                 \
                    if (EndOfData()) {                                        \
                        BitsAvail = (n);                                      \
                    } else {                                                  \
                        BitAcc |= static_cast<uint32_t>(rev[*cp++]) << BitsAvail; \
                        BitsAvail += 8;                                       \
                    }                                                         \
                }                                                             \
            }                                                                 \
        }                                                                     \
    } while (0)
#define GetBits(n) (BitAcc & ((1u << (n)) - 1))
#define ClrBits(n)        \
    do {                  \
        BitsAvail -= (n); \
        BitAcc >>= (n);   \
    } while (0)
#define LOOKUP8(wid, tab, eoflab)    \
    do {                             \
        NeedBits8(wid, eoflab);      \
        TabEnt = tab + GetBits(wid); \
        ClrBits(TabEnt->Width);      \
    } while (0)
#define LOOKUP16(wid, tab, eoflab)   \
    do {                             \
        NeedBits16(wid, eoflab);     \
        TabEnt = tab + GetBits(wid); \
        ClrBits(TabEnt->Width);      \
    } while (0)
#define SETVALUE(x)                                   \
    do {                                              \
        if (pa >= thisrun + f.nruns) return -1;       \
        *pa++ = RunLength + (x);                      \
        a0 += (x);                                    \
        RunLength = 0;                                \
    } while (0)
#define CLEANUP_RUNS()                                      \
    do {                                                    \
        if (RunLength) SETVALUE(0);                         \
        if (a0 != lastx) {                                  \
            while (a0 > lastx && pa > thisrun) a0 -= *--pa; \
            if (a0 < lastx) {                               \
                if (a0 < 0) a0 = 0;                         \
                if ((pa - thisrun) & 1) SETVALUE(0);        \
                SETVALUE(lastx - a0);                       \
            } else if (a0 > lastx) {                        \
                SETVALUE(lastx);                            \
                SETVALUE(0);                                \
            }                                               \
        }                                                   \
    } while (0)
// libtiff 4.7 retries a strip whose EOLs run out (no 1 after the zeros
// before the data ends) without EOLs, from the strip's first bit, and
// keeps that mode for the page's later strips.
#define SYNC_EOL(eoflab, retrywithouteol)            \
    do {                                             \
        if (!(*f.mode & kNoEol)) {                   \
            if (EOLcnt == 0) {                       \
                for (;;) {                           \
                    NeedBits16(11, eoflab);          \
                    if (GetBits(11) == 0) break;     \
                    ClrBits(1);                      \
                }                                    \
            }                                        \
            for (;;) {                               \
                NeedBits8(8, noEOLFound);            \
                if (GetBits(8)) break;               \
                ClrBits(8);                          \
            }                                        \
            while (GetBits(1) == 0) ClrBits(1);      \
            ClrBits(1);                              \
            EOLcnt = 0;                              \
            break;                                   \
        noEOLFound:                                  \
            *f.mode |= kNoEol;                       \
            goto retrywithouteol;                    \
        }                                            \
    } while (0)

#define EXPAND1D(eoflab)                                   \
    do {                                                   \
        for (;;) {                                         \
            for (;;) {                                     \
                LOOKUP16(12, T.white, eof1d);              \
                switch (TabEnt->State) {                   \
                    case S_EOL:                            \
                        EOLcnt = 1;                        \
                        goto done1d;                       \
                    case S_TermW:                          \
                        SETVALUE(TabEnt->Param);           \
                        goto doneWhite1d;                  \
                    case S_MakeUpW:                        \
                    case S_MakeUp:                         \
                        a0 += TabEnt->Param;               \
                        RunLength += TabEnt->Param;        \
                        break;                             \
                    default:                               \
                        goto done1d;                       \
                }                                          \
            }                                              \
        doneWhite1d:                                       \
            if (a0 >= lastx) goto done1d;                  \
            for (;;) {                                     \
                LOOKUP16(13, T.black, eof1d);              \
                switch (TabEnt->State) {                   \
                    case S_EOL:                            \
                        EOLcnt = 1;                        \
                        goto done1d;                       \
                    case S_TermB:                          \
                        SETVALUE(TabEnt->Param);           \
                        goto doneBlack1d;                  \
                    case S_MakeUpB:                        \
                    case S_MakeUp:                         \
                        a0 += TabEnt->Param;               \
                        RunLength += TabEnt->Param;        \
                        break;                             \
                    default:                               \
                        goto done1d;                       \
                }                                          \
            }                                              \
        doneBlack1d:                                       \
            if (a0 >= lastx) goto done1d;                  \
            if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2; \
        }                                                  \
    eof1d:                                                 \
        CLEANUP_RUNS();                                    \
        goto eoflab;                                       \
    done1d:                                                \
        CLEANUP_RUNS();                                    \
    } while (0)

#define CHECK_b1                                                 \
    do {                                                         \
        if (pa != thisrun)                                       \
            while (b1 <= a0 && b1 < static_cast<int32_t>(lastx)) { \
                if (pb + 1 >= f.refruns + f.nruns) return -1;    \
                b1 += pb[0] + pb[1];                             \
                pb += 2;                                         \
            }                                                    \
    } while (0)

#define EXPAND2D(eoflab)                                               \
    do {                                                               \
        while (a0 < static_cast<int32_t>(lastx)) {                     \
            if (pa >= thisrun + f.nruns) return -1;                    \
            LOOKUP8(7, T.main, eof2d);                                 \
            switch (TabEnt->State) {                                   \
                case S_Pass:                                           \
                    CHECK_b1;                                          \
                    if (pb + 1 >= f.refruns + f.nruns) return -1;      \
                    b1 += *pb++;                                       \
                    RunLength += b1 - a0;                              \
                    a0 = b1;                                           \
                    b1 += *pb++;                                       \
                    break;                                             \
                case S_Horiz:                                          \
                    if ((pa - thisrun) & 1) {                          \
                        for (;;) {                                     \
                            LOOKUP16(13, T.black, eof2d);              \
                            switch (TabEnt->State) {                   \
                                case S_TermB:                          \
                                    SETVALUE(TabEnt->Param);           \
                                    goto doneWhite2da;                 \
                                case S_MakeUpB:                        \
                                case S_MakeUp:                         \
                                    a0 += TabEnt->Param;               \
                                    RunLength += TabEnt->Param;        \
                                    break;                             \
                                default:                               \
                                    goto badBlack2d;                   \
                            }                                          \
                        }                                              \
                    doneWhite2da:;                                     \
                        for (;;) {                                     \
                            LOOKUP16(12, T.white, eof2d);              \
                            switch (TabEnt->State) {                   \
                                case S_TermW:                          \
                                    SETVALUE(TabEnt->Param);           \
                                    goto doneBlack2da;                 \
                                case S_MakeUpW:                        \
                                case S_MakeUp:                         \
                                    a0 += TabEnt->Param;               \
                                    RunLength += TabEnt->Param;        \
                                    break;                             \
                                default:                               \
                                    goto badWhite2d;                   \
                            }                                          \
                        }                                              \
                    doneBlack2da:;                                     \
                    } else {                                           \
                        for (;;) {                                     \
                            LOOKUP16(12, T.white, eof2d);              \
                            switch (TabEnt->State) {                   \
                                case S_TermW:                          \
                                    SETVALUE(TabEnt->Param);           \
                                    goto doneWhite2db;                 \
                                case S_MakeUpW:                        \
                                case S_MakeUp:                         \
                                    a0 += TabEnt->Param;               \
                                    RunLength += TabEnt->Param;        \
                                    break;                             \
                                default:                               \
                                    goto badWhite2d;                   \
                            }                                          \
                        }                                              \
                    doneWhite2db:;                                     \
                        for (;;) {                                     \
                            LOOKUP16(13, T.black, eof2d);              \
                            switch (TabEnt->State) {                   \
                                case S_TermB:                          \
                                    SETVALUE(TabEnt->Param);           \
                                    goto doneBlack2db;                 \
                                case S_MakeUpB:                        \
                                case S_MakeUp:                         \
                                    a0 += TabEnt->Param;               \
                                    RunLength += TabEnt->Param;        \
                                    break;                             \
                                default:                               \
                                    goto badBlack2d;                   \
                            }                                          \
                        }                                              \
                    doneBlack2db:;                                     \
                    }                                                  \
                    CHECK_b1;                                          \
                    break;                                             \
                case S_V0:                                             \
                    CHECK_b1;                                          \
                    SETVALUE(b1 - a0);                                 \
                    if (pb >= f.refruns + f.nruns) return -1;          \
                    b1 += *pb++;                                       \
                    break;                                             \
                case S_VR:                                             \
                    CHECK_b1;                                          \
                    SETVALUE(b1 - a0 + TabEnt->Param);                 \
                    if (pb >= f.refruns + f.nruns) return -1;          \
                    b1 += *pb++;                                       \
                    break;                                             \
                case S_VL:                                             \
                    CHECK_b1;                                          \
                    if (b1 < static_cast<int32_t>(a0 + TabEnt->Param)) { \
                        goto eol2d;                                    \
                    }                                                  \
                    SETVALUE(b1 - a0 - TabEnt->Param);                 \
                    b1 -= *--pb;                                       \
                    break;                                             \
                case S_Ext:                                            \
                    *pa++ = lastx - a0;                                \
                    goto eol2d;                                        \
                case S_EOL:                                            \
                    *pa++ = lastx - a0;                                \
                    NeedBits8(4, eof2d);                               \
                    ClrBits(4);                                        \
                    EOLcnt = 1;                                        \
                    goto eol2d;                                        \
                default:                                               \
                badMain2d:                                             \
                    goto eol2d;                                        \
                badBlack2d:                                            \
                    goto eol2d;                                        \
                badWhite2d:                                            \
                    goto eol2d;                                        \
                eof2d:                                                 \
                    CLEANUP_RUNS();                                    \
                    goto eoflab;                                       \
            }                                                          \
        }                                                              \
        if (RunLength) {                                               \
            if (RunLength + a0 < static_cast<int32_t>(lastx)) {        \
                NeedBits8(1, eof2d);                                   \
                if (!GetBits(1)) goto badMain2d;                       \
                ClrBits(1);                                            \
            }                                                          \
            SETVALUE(0);                                               \
        }                                                              \
    eol2d:                                                             \
        CLEANUP_RUNS();                                                \
    } while (0)

#define DECLARE_STATE                             \
    const FaxTables& T = fax_tables();            \
    const uint8_t* rev = T.rev;                   \
    const uint8_t* cp = f.cp;                     \
    const uint8_t* ep = f.ep;                     \
    uint32_t BitAcc = f.BitAcc;                   \
    int BitsAvail = f.BitsAvail;                  \
    int EOLcnt = f.EOLcnt;                        \
    const int32_t lastx = static_cast<int32_t>(f.lastx);             \
    int32_t a0 = 0;                               \
    int32_t RunLength = 0;                        \
    uint32_t* pa = nullptr;                       \
    uint32_t* thisrun = nullptr;                  \
    const TabEnt* TabEnt = nullptr;               \
    (void)TabEnt

#define DECLARE_STATE_2D \
    DECLARE_STATE;       \
    int32_t b1 = 0;      \
    uint32_t* pb = nullptr

// Modified Huffman (compression 2) and its word-aligned form (32771).
int fax_rle(Fax& f, uint8_t* buf, int64_t occ, int64_t rowbytes, bool word_align) {
    DECLARE_STATE;
    (void)EOLcnt;  // set by EXPAND1D, read by nothing here
    thisrun = f.curruns;
    while (occ > 0) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun;
        EXPAND1D(EOFRLE);
        fill_runs(buf, thisrun, pa, lastx);
        if (!word_align) {
            int n = BitsAvail - (BitsAvail & ~7);
            ClrBits(n);
        } else {
            int n = BitsAvail - (BitsAvail & ~15);
            ClrBits(n);
            if (BitsAvail == 0 && ((f.base + static_cast<uintptr_t>(cp - f.start)) & 1)) cp++;
        }
        buf += rowbytes;
        occ -= rowbytes;
        f.line++;
        continue;
    EOFRLE:
        fill_runs(buf, thisrun, pa, lastx);
        return -1;
    }
    return 1;
}

int fax3_1d(Fax& f, uint8_t* buf, int64_t occ, int64_t rowbytes) {
    DECLARE_STATE;
RETRY_WITHOUT_EOL_1D:
    cp = f.cp;
    BitAcc = 0;
    BitsAvail = 0;
    EOLcnt = 0;
    thisrun = f.curruns;
    while (occ > 0) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun;
        SYNC_EOL(EOF1D, RETRY_WITHOUT_EOL_1D);
        EXPAND1D(EOF1Da);
        fill_runs(buf, thisrun, pa, lastx);
        buf += rowbytes;
        occ -= rowbytes;
        f.line++;
        continue;
    EOF1D:
        CLEANUP_RUNS();
    EOF1Da:
        fill_runs(buf, thisrun, pa, lastx);
        return -1;
    }
    return 1;
}

int fax3_2d(Fax& f, uint8_t* buf, int64_t occ, int64_t rowbytes) {
    DECLARE_STATE_2D;
RETRY_WITHOUT_EOL_2D:
    cp = f.cp;
    BitAcc = 0;
    BitsAvail = 0;
    EOLcnt = 0;
    while (occ > 0) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun = f.curruns;
        SYNC_EOL(EOF2D, RETRY_WITHOUT_EOL_2D);
        NeedBits8(1, EOF2D);
        {
            int is1D = GetBits(1);
            ClrBits(1);
            pb = f.refruns;
            b1 = static_cast<int32_t>(*pb++);
            if (is1D) {
                EXPAND1D(EOF2Da);
            } else {
                EXPAND2D(EOF2Da);
            }
        }
        fill_runs(buf, thisrun, pa, lastx);
        if (pa < thisrun + f.nruns) SETVALUE(0);
        std::swap(f.curruns, f.refruns);
        buf += rowbytes;
        occ -= rowbytes;
        f.line++;
        continue;
    EOF2D:
        CLEANUP_RUNS();
    EOF2Da:
        fill_runs(buf, thisrun, pa, lastx);
        return -1;
    }
    return 1;
}

int fax4(Fax& f, uint8_t* buf, int64_t occ, int64_t rowbytes) {
    DECLARE_STATE_2D;
    const int start = f.line;
    while (occ > 0) {
        a0 = 0;
        RunLength = 0;
        pa = thisrun = f.curruns;
        pb = f.refruns;
        b1 = static_cast<int32_t>(*pb++);
        EXPAND2D(EOFG4);
        if (EOLcnt) goto EOFG4;
        fill_runs(buf, thisrun, pa, lastx);
        SETVALUE(0);
        std::swap(f.curruns, f.refruns);
        buf += rowbytes;
        occ -= rowbytes;
        f.line++;
        continue;
    EOFG4:
        NeedBits16(13, BADG4);
    BADG4:
        ClrBits(13);
        fill_runs(buf, thisrun, pa, lastx);
        return f.line != start ? 1 : -1;
    }
    return 1;
}

}  // namespace

extern "C" {

// Each decoder writes at most `cap` (or rows * row_bytes) bytes into
// `out`, which the caller has zeroed, and returns 1 where libtiff's
// decoder succeeds, 0 where it fails (what it wrote stays), -1 out of
// memory.
int32_t tiff_lzw(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    try {
        std::vector<Code> tab(kCsize + 1);
        for (int c = 0; c < 256; ++c) {
            tab[c] = Code{-1, 1, static_cast<uint8_t>(c), static_cast<uint8_t>(c)};
        }
        if (n >= 2 && in[0] == 0 && (in[1] & 1)) {
            return lzw_decode_compat(in, n, out, cap, tab);
        }
        return lzw_decode(in, n, out, cap, tab);
    } catch (const std::bad_alloc&) {
        return -1;
    }
}

int32_t tiff_packbits(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    return packbits_decode(in, n, out, cap);
}

int32_t tiff_deflate(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
    return inflate_zlib(in, n, out, cap);
}

// `rows` rows of `width` 4-bit pixels, `row_bytes` apart.
int32_t tiff_thunder(const uint8_t* in, int64_t n, uint8_t* out, int64_t width, int64_t rows,
                     int64_t row_bytes) {
    const uint8_t* bp = in;
    int64_t cc = n;
    for (int64_t y = 0; y < rows; ++y) {
        if (!thunder_row(bp, cc, out + y * row_bytes, width)) return 0;
    }
    return 1;
}

// `rows` rows of `width` SGILog pixels into 8-bit rows `row_bytes`
// apart: kind 0 LogL (16-bit, gray bytes), 1 LogLuv (32-bit, RGB
// bytes), 2 LogLuv (24-bit, RGB bytes).  A row whose data runs out stays zero, and so do the rows
// after it.
int32_t tiff_sgilog(const uint8_t* in, int64_t n, uint8_t* out, int64_t width, int64_t rows,
                    int64_t row_bytes, int32_t kind) {
    try {
        const uint8_t* bp = in;
        int64_t cc = n;
        std::vector<int16_t> l16(static_cast<size_t>(width));
        std::vector<uint32_t> luv(static_cast<size_t>(width));
        for (int64_t y = 0; y < rows; ++y) {
            uint8_t* row = out + y * row_bytes;
            if (kind == 0) {
                std::fill(l16.begin(), l16.end(), 0);
                if (!sgilog_rle_row(bp, cc, l16.data(), width, 8)) return 0;
                for (int64_t x = 0; x < width; ++x) row[x] = gamma8(logl16_to_y(l16[x]));
            } else if (kind == 1) {
                std::fill(luv.begin(), luv.end(), 0u);
                if (!sgilog_rle_row(bp, cc, luv.data(), width, 24)) return 0;
                for (int64_t x = 0; x < width; ++x) {
                    float xyz[3];
                    luv32_to_xyz(luv[x], xyz);
                    xyz_to_rgb24(xyz, row + 3 * x);
                }
            } else {  // LogLuvDecode24: three bytes a pixel, no coding
                int64_t i = 0;
                for (; i < width && cc >= 3; ++i, bp += 3, cc -= 3) {
                    luv[i] = static_cast<uint32_t>(bp[0]) << 16 | bp[1] << 8 | bp[2];
                }
                if (i != width) return 0;
                for (int64_t x = 0; x < width; ++x) {
                    float xyz[3];
                    luv24_to_xyz(luv[x], xyz);
                    xyz_to_rgb24(xyz, row + 3 * x);
                }
            }
        }
        return 1;
    } catch (const std::bad_alloc&) {
        return -1;
    }
}

// `rows` rows of `width` pixels, `row_bytes` apart; compression 2, 3
// (two_d: T4Options bit 0), 4 or 32771.  `runs` holds 2 * nruns + 1
// uint32s and `mode` one int32 that the caller zeroes once for the page
// (libtiff's codec state outlives a strip), nruns = tiff_fax_runs(width,
// two_d); `parity` is the strip's file offset modulo 2 (32771 aligns
// each row to a 16-bit word of the file).
int32_t tiff_fax_runs(int32_t width, int32_t two_d) {
    uint32_t n = ((static_cast<uint32_t>(width) + 1 + 31) / 32) * 32;
    return static_cast<int32_t>(two_d ? 2 * n : n);
}

int32_t tiff_fax(const uint8_t* in, int64_t n, uint8_t* out, int32_t width, int32_t rows,
                 int64_t row_bytes, int32_t compression, int32_t two_d, uint32_t* runs,
                 int32_t* mode, int32_t parity) {
    if (width <= 0 || rows < 0) return 0;
    Fax f;
    f.mode = mode;
    f.cp = in;
    f.ep = in + n;
    f.start = in;
    f.base = static_cast<uintptr_t>(parity & 1);
    f.runs = runs;
    f.nruns = static_cast<uint32_t>(tiff_fax_runs(width, compression == 4 || two_d));
    f.curruns = runs;
    f.refruns = nullptr;
    f.lastx = static_cast<uint32_t>(width);
    const int64_t occ = static_cast<int64_t>(rows) * row_bytes;
    if (compression == 4 || (compression == 3 && two_d)) {
        f.refruns = runs + f.nruns;
        f.refruns[0] = static_cast<uint32_t>(width);
        f.refruns[1] = 0;
        return (compression == 4 ? fax4(f, out, occ, row_bytes)
                                 : fax3_2d(f, out, occ, row_bytes)) > 0 ? 1 : 0;
    }
    if (compression == 3) return fax3_1d(f, out, occ, row_bytes) > 0 ? 1 : 0;
    return fax_rle(f, out, occ, row_bytes, compression == 32771) > 0 ? 1 : 0;
}

}  // extern "C"
