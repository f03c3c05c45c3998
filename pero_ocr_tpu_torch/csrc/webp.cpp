// The WebP bitstream decoders behind the port's cv2.imread(path,
// IMREAD_COLOR) for WebP files: they give the pixels libwebp (the
// library OpenCV 5 reads WebP with) gives OpenCV through WebPDecode
// in MODE_BGR or MODE_BGRA with default options.  The RIFF container,
// the demuxer's checks, the animation canvas and the EXIF orientation
// are in pero_ocr_tpu_torch/utils/webp.py.
//
// - VP8L, lossless (the WebP lossless bitstream, RFC 9649): the image
//   header; the predictor (14 modes, the top row predicted from the
//   left, the left column from the top), cross-colour, subtract-green
//   and colour-indexing transforms (pixel bundling at 2, 4 and 16
//   colours), applied last read first; the colour cache of 1-11 bits;
//   the entropy image and its meta prefix codes; simple and normal
//   prefix codes, the code-length code with its repeat codes, and the
//   rejection of codes that are neither complete nor a single symbol;
//   LZ77 with the 120-entry distance map.  A read past the end of the
//   data fails the decode, as libwebp's bit reader fails it.
// - ALPH, the alpha of a lossy image: raw or a headerless VP8L stream
//   whose green channel is the alpha; the horizontal, vertical and
//   gradient filters.  Alpha is dropped under IMREAD_COLOR, but a bad
//   ALPH chunk fails libwebp's whole decode, so it is decoded in full.
// - VP8, lossy key frames (RFC 6386): the boolean decoder, with
//   libwebp's end-of-partition rule; segmentation; the loop filter's
//   type, level, sharpness and deltas; 1, 2, 4 or 8 token partitions;
//   the quantizer tables and clips; coefficient probability updates;
//   the 16x16, 4x4 and chroma intra modes with libwebp's edge samples;
//   the inverse WHT and DCT; the simple and normal loop filters.
// - YUV 4:2:0 to BGR as libwebp emits it for an RGB mode: the "fancy"
//   upsampler and the 14-bit VP8YUVToR/G/B.
//
// One thread.  Errors: return code 1 with a message (libwebp fails the
// decode, cv2.imread returns None).
//
// Built with the host compiler and loaded through ctypes by
// pero_ocr_tpu_torch/utils/kernels.py; bound in utils/webp.py.

#include <algorithm>
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

[[noreturn]] void corrupt(const std::string& what) { throw Failure{what}; }

// Features met while decoding, reported to Python (bit -> name in
// utils/webp.py's FEATURES); cleared by each C entry point.
enum Feature : uint64_t {
    F_PREDICTOR = 1 << 0, F_CROSS_COLOR = 1 << 1, F_SUBTRACT_GREEN = 1 << 2, F_COLOR_INDEXING = 1 << 3,
    F_BUNDLE_2 = 1 << 4, F_BUNDLE_4 = 1 << 5, F_BUNDLE_8 = 1 << 6, F_COLOR_CACHE = 1 << 7,
    F_META_CODES = 1 << 8, F_LZ77 = 1 << 9, F_SIMPLE_CODE = 1 << 10, F_ALPH_RAW = 1 << 11,
    F_ALPH_LOSSLESS = 1 << 12, F_ALPH_HORIZONTAL = 1 << 13, F_ALPH_VERTICAL = 1 << 14,
    F_ALPH_GRADIENT = 1 << 15, F_ALPH_PREPROCESSED = 1 << 16, F_SIMPLE_FILTER = 1 << 17,
    F_NORMAL_FILTER = 1 << 18, F_NO_FILTER = 1 << 19, F_PARTITIONS_2 = 1 << 20, F_PARTITIONS_4 = 1 << 21,
    F_PARTITIONS_8 = 1 << 22, F_SEGMENT_MAP = 1 << 23, F_SEGMENTS_WITHOUT_MAP = 1 << 24, F_SKIP = 1 << 25,
    F_LF_DELTAS = 1 << 26, F_SHARPNESS = 1 << 27, F_I4X4 = 1 << 28, F_I16 = 1 << 29,
};
thread_local uint64_t features_seen = 0;
inline void seen(uint64_t bits) { features_seen |= bits; }

// =====================================================================
// VP8L
constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kMaxCacheBits = 11;
constexpr int kRootBits = 8;
constexpr uint32_t kArgbBlack = 0xff000000u;

enum TransformType { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

// The distance map: (dx, dy) of the first 120 distance codes, as
// yoffset << 4 | (8 - xoffset).
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

// The VP8L bit reader: least significant bit first.  `limit` is the
// number of bits libwebp's reader may consume before it reports the end
// of the stream: the data's, or 64 when the data is shorter than its
// 64-bit window.  Reads past the data give zeros; `eos()` tells.
class LBitReader {
  public:
    LBitReader(const uint8_t* data, size_t len)
        : buf_(len + 8, 0), limit_(8 * uint64_t(std::max<size_t>(len, 8))) {
        if (len) std::memcpy(buf_.data(), data, len);
    }
    uint64_t peek() const {  // at least 57 bits from the current position
        const size_t byte = size_t(pos_ >> 3);
        uint64_t v = 0;
        if (byte + 8 <= buf_.size()) {
            std::memcpy(&v, buf_.data() + byte, 8);
        } else if (byte < buf_.size()) {
            std::memcpy(&v, buf_.data() + byte, buf_.size() - byte);
        }
        return v >> (pos_ & 7);
    }
    void skip(int n) {
        pos_ += uint64_t(n);
        if (pos_ > limit_) pos_ = limit_ + 1;  // sticky end of stream
    }
    uint32_t read(int n) {
        if (eos()) return 0;
        const uint32_t v = n ? uint32_t(peek() & ((uint64_t(1) << n) - 1)) : 0;
        skip(n);
        return eos() ? 0 : v;
    }
    bool eos() const { return pos_ > limit_; }

  private:
    std::vector<uint8_t> buf_;
    uint64_t limit_;
    uint64_t pos_ = 0;
};

// A prefix code as a two-level table: kRootBits bits first, then a
// second-level table for longer codes (root entry bits > kRootBits:
// value is the second table's offset).
struct HEntry {
    uint8_t bits;
    uint16_t value;
};

struct HCode {
    std::vector<HEntry> table;
    bool trivial() const { return table[0].bits == 0; }  // one symbol, no bits
};

// A table from code lengths; false for lengths libwebp rejects: all
// zero, over 15, or a code that is neither complete nor one symbol.
bool build_code(const int* lengths, int n, HCode& code) {
    int count[16] = {0};
    for (int s = 0; s < n; ++s) {
        if (lengths[s] < 0 || lengths[s] > 15) return false;
        ++count[lengths[s]];
    }
    if (count[0] == n) return false;
    code.table.assign(size_t(1) << kRootBits, HEntry{0, 0});
    if (n - count[0] == 1) {
        for (int s = 0; s < n; ++s)
            if (lengths[s]) {
                for (auto& e : code.table) e = HEntry{0, uint16_t(s)};
                return true;
            }
    }
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
        left = (left << 1) - count[len];
        if (left < 0) return false;
    }
    if (left != 0) return false;
    int next[17] = {0};
    for (int len = 1, c = 0; len <= 15; ++len) {
        c = (c + count[len - 1] * (len > 1)) << 1;
        next[len] = c;
    }
    // canonical codes, reversed for an LSB-first reader
    std::vector<int> rev(size_t(n), 0);
    int sub_bits[1 << kRootBits] = {0};
    for (int s = 0; s < n; ++s) {
        const int len = lengths[s];
        if (!len) continue;
        const int c = next[len]++;
        int r = 0;
        for (int i = 0; i < len; ++i) r |= ((c >> i) & 1) << (len - 1 - i);
        rev[size_t(s)] = r;
        if (len > kRootBits) {
            const int low = r & ((1 << kRootBits) - 1);
            sub_bits[low] = std::max(sub_bits[low], len - kRootBits);
        }
    }
    for (int low = 0; low < (1 << kRootBits); ++low) {
        if (!sub_bits[low]) continue;
        const size_t offset = code.table.size();
        code.table.resize(offset + (size_t(1) << sub_bits[low]), HEntry{0, 0});
        code.table[size_t(low)] = HEntry{uint8_t(kRootBits + sub_bits[low]), uint16_t(offset)};
    }
    for (int s = 0; s < n; ++s) {
        const int len = lengths[s];
        if (!len) continue;
        const int r = rev[size_t(s)];
        if (len <= kRootBits) {
            for (int i = r; i < (1 << kRootBits); i += 1 << len) code.table[size_t(i)] = HEntry{uint8_t(len), uint16_t(s)};
        } else {
            const HEntry root = code.table[size_t(r & ((1 << kRootBits) - 1))];
            const int size = 1 << (root.bits - kRootBits);
            for (int i = r >> kRootBits; i < size; i += 1 << (len - kRootBits))
                code.table[size_t(root.value + i)] = HEntry{uint8_t(len - kRootBits), uint16_t(s)};
        }
    }
    return true;
}

inline int read_symbol(const HCode& code, LBitReader& br) {
    const uint64_t v = br.peek();
    const HEntry e = code.table[size_t(v & ((1 << kRootBits) - 1))];
    if (e.bits <= kRootBits) {
        br.skip(e.bits);
        return e.value;
    }
    const int nb = e.bits - kRootBits;
    const HEntry s = code.table[size_t(e.value + ((v >> kRootBits) & ((uint64_t(1) << nb) - 1)))];
    br.skip(kRootBits + s.bits);
    return s.value;
}

struct Transform {
    int type = 0, bits = 0, xsize = 0, ysize = 0;
    std::vector<uint32_t> data;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct HGroup {
    HCode codes[5];  // green (+ lengths + cache), red, blue, alpha, distance
};

class VP8LDecoder {
  public:
    VP8LDecoder(const uint8_t* data, size_t len) : br_(data, len) {}

    // The main image after its header: the ARGB pixels, transforms undone.
    std::vector<uint32_t> decode_image(int width, int height) {
        int xsize = width;
        std::vector<uint32_t> packed = decode_stream(xsize, height, true);
        if (br_.eos()) corrupt("the lossless bitstream ends early");
        return undo_transforms(std::move(packed));
    }

    // An ALPH stream: the green channel, transforms undone.  libwebp's
    // 8-bit path (only a colour-indexing transform, no colour cache,
    // single-symbol red, blue and alpha codes) lets the last symbol read
    // past the end; its other path does not.
    std::vector<uint32_t> decode_alpha(int width, int height) {
        alpha_ = true;
        int xsize = width;
        std::vector<uint32_t> packed = decode_stream(xsize, height, true);
        return undo_transforms(std::move(packed));
    }

    LBitReader& reader() { return br_; }

  private:
    LBitReader br_;
    std::vector<Transform> transforms_;
    unsigned transforms_seen_ = 0;
    bool alpha_ = false, eight_bit_ = false;

    void read_transform(int& xsize, int ysize) {
        const int type = int(br_.read(2));
        if (transforms_seen_ & (1u << type)) corrupt("a transform given twice");
        seen(uint64_t(1) << type);
        transforms_seen_ |= 1u << type;
        Transform t;
        t.type = type;
        t.xsize = xsize;
        t.ysize = ysize;
        if (type == PREDICTOR || type == CROSS_COLOR) {
            t.bits = int(br_.read(3)) + 2;
            int sx = subsample(xsize, t.bits);
            t.data = decode_stream(sx, subsample(ysize, t.bits), false);
        } else if (type == COLOR_INDEXING) {
            const int num_colors = int(br_.read(8)) + 1;
            t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
            if (t.bits) seen(F_BUNDLE_2 << (t.bits - 1));
            xsize = subsample(t.xsize, t.bits);
            int n = num_colors;
            std::vector<uint32_t> map = decode_stream(n, 1, false);
            // The palette is delta coded channel by channel; entries past
            // num_colors are transparent black.
            const int final_colors = 1 << (8 >> t.bits);
            t.data.assign(size_t(final_colors), 0);
            uint8_t* out = reinterpret_cast<uint8_t*>(t.data.data());
            const uint8_t* in = reinterpret_cast<const uint8_t*>(map.data());
            for (int i = 0; i < 4 * num_colors; ++i) out[i] = uint8_t(in[i] + (i >= 4 ? out[i - 4] : 0));
        }
        transforms_.push_back(std::move(t));
    }

    bool read_code(int alphabet, HCode& code) {
        std::vector<int> lengths(size_t(std::max(alphabet, 256)), 0);
        if (br_.read(1)) {  // simple code: one or two symbols
            seen(F_SIMPLE_CODE);
            const int num_symbols = int(br_.read(1)) + 1;
            const int first_bits = br_.read(1) ? 8 : 1;
            lengths[br_.read(first_bits)] = 1;
            if (num_symbols == 2) lengths[br_.read(8)] = 1;
        } else {
            int cl_lengths[19] = {0};
            const int num_codes = int(br_.read(4)) + 4;
            for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = int(br_.read(3));
            HCode cl;
            if (!build_code(cl_lengths, 19, cl)) return false;
            int max_symbol = alphabet;
            if (br_.read(1)) {
                const int nbits = 2 + 2 * int(br_.read(3));
                max_symbol = 2 + int(br_.read(nbits));
                if (max_symbol > alphabet) return false;
            }
            int prev = 8, symbol = 0;
            while (symbol < alphabet) {
                if (max_symbol-- == 0) break;
                const int len = read_symbol(cl, br_);
                if (len < 16) {
                    lengths[size_t(symbol++)] = len;
                    if (len) prev = len;
                } else {
                    static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
                    const int slot = len - 16;
                    const int repeat = int(br_.read(kExtra[slot])) + kOffset[slot];
                    if (symbol + repeat > alphabet) return false;
                    const int value = len == 16 ? prev : 0;
                    for (int i = 0; i < repeat; ++i) lengths[size_t(symbol++)] = value;
                }
            }
        }
        if (br_.eos()) return false;
        return build_code(lengths.data(), alphabet, code);
    }

    static inline int copy_value(int symbol, LBitReader& br) {
        if (symbol < 4) return symbol + 1;
        const int extra = (symbol - 2) >> 1;
        const int offset = (2 + (symbol & 1)) << extra;
        return offset + int(br.read(extra)) + 1;
    }

    static inline int plane_to_distance(int xsize, int code) {
        if (code > 120) return code - 120;
        const int d = kCodeToPlane[code - 1];
        const int dist = (d >> 4) * xsize + (8 - (d & 0xf));
        return dist >= 1 ? dist : 1;
    }

    // One entropy-coded image of xsize x ysize (xsize may shrink under
    // the colour-indexing transform of a level-0 image).
    std::vector<uint32_t> decode_stream(int& xsize, int ysize, bool level0) {
        if (level0)
            while (br_.read(1)) read_transform(xsize, ysize);
        int cache_bits = 0;
        if (br_.read(1)) {
            cache_bits = int(br_.read(4));
            seen(F_COLOR_CACHE);
            if (cache_bits < 1 || cache_bits > kMaxCacheBits) corrupt("a colour cache size out of range");
        }
        // meta prefix codes
        int meta_bits = 0, meta_xsize = 0, num_groups = 1;
        std::vector<uint32_t> meta;
        if (level0 && br_.read(1)) {
            meta_bits = int(br_.read(3)) + 2;
            seen(F_META_CODES);
            meta_xsize = subsample(xsize, meta_bits);
            int mx = meta_xsize;
            meta = decode_stream(mx, subsample(ysize, meta_bits), false);
            for (auto& m : meta) {
                m = (m >> 8) & 0xffff;
                num_groups = std::max(num_groups, int(m) + 1);
            }
        }
        if (br_.eos()) corrupt("the lossless bitstream ends early");
        const int cache_size = cache_bits ? 1 << cache_bits : 0;
        // Every group's codes are read and checked; only the groups the
        // entropy image names are kept.
        std::vector<char> used(static_cast<size_t>(num_groups), meta_bits ? 0 : 1);
        for (const uint32_t m : meta) used[m] = 1;
        std::vector<HGroup> groups(static_cast<size_t>(num_groups));
        HGroup unused;
        const int alphabets[5] = {kNumLiteralCodes + kNumLengthCodes + cache_size, 256, 256, 256,
                                  kNumDistanceCodes};
        for (int k = 0; k < num_groups; ++k) {
            HGroup& g = used[size_t(k)] ? groups[size_t(k)] : unused;
            for (int i = 0; i < 5; ++i)
                if (!read_code(alphabets[i], g.codes[i])) corrupt("an invalid prefix code");
        }
        if (level0) {
            eight_bit_ = transforms_.size() == 1 && transforms_[0].type == COLOR_INDEXING && cache_size == 0;
            for (int k = 0; k < num_groups; ++k) {
                const HGroup& g = groups[size_t(k)];
                if (used[size_t(k)])
                    eight_bit_ = eight_bit_ && g.codes[1].trivial() && g.codes[2].trivial() && g.codes[3].trivial();
            }
        }
        // the pixels
        const size_t total = size_t(xsize) * size_t(ysize);
        std::vector<uint32_t> out(total, 0);
        std::vector<uint32_t> cache(size_t(cache_size), 0);
        const int hash_shift = 32 - cache_bits;
        size_t pos = 0, cached = 0;
        int x = 0, y = 0;
        const int mask = meta_bits ? (1 << meta_bits) - 1 : -1;
        const HGroup* g = &groups[0];
        const bool lenient = alpha_ && level0 && eight_bit_;
        auto group_at = [&](int gx, int gy) -> const HGroup* {
            if (!meta_bits) return &groups[0];
            return &groups[meta[size_t((gy >> meta_bits) * meta_xsize + (gx >> meta_bits))]];
        };
        auto insert_cached = [&]() {
            if (cache_size)
                for (; cached < pos; ++cached)
                    cache[(out[cached] * 0x1e35a7bdu) >> hash_shift] = out[cached];
        };
        while (pos < total && !br_.eos()) {
            if ((x & mask) == 0) g = group_at(x, y);
            const int code = read_symbol(g->codes[0], br_);
            if (code < kNumLiteralCodes) {
                const int red = read_symbol(g->codes[1], br_);
                const int blue = read_symbol(g->codes[2], br_);
                const int alpha = read_symbol(g->codes[3], br_);
                if (br_.eos() && !lenient) break;
                out[pos++] = (uint32_t(alpha) << 24) | (uint32_t(red) << 16) | (uint32_t(code) << 8) | uint32_t(blue);
                if (++x >= xsize) {
                    x = 0;
                    ++y;
                    insert_cached();
                }
            } else if (code < kNumLiteralCodes + kNumLengthCodes) {
                const int length = copy_value(code - kNumLiteralCodes, br_);
                const int dist_symbol = read_symbol(g->codes[4], br_);
                const int dist = plane_to_distance(xsize, copy_value(dist_symbol, br_));
                if (br_.eos() && !lenient) break;
                if (pos < size_t(dist) || total - pos < size_t(length)) corrupt("a backward reference out of the image");
                seen(F_LZ77);
                for (int i = 0; i < length; ++i, ++pos) out[pos] = out[pos - size_t(dist)];
                x += length;
                while (x >= xsize) {
                    x -= xsize;
                    ++y;
                }
                if (x & mask) g = group_at(x, y);
                insert_cached();
            } else {
                const int key = code - (kNumLiteralCodes + kNumLengthCodes);
                if (key >= cache_size) corrupt("a colour cache code without a cache");
                insert_cached();
                out[pos++] = cache[size_t(key)];
                if (++x >= xsize) {
                    x = 0;
                    ++y;
                    insert_cached();
                }
            }
        }
        if (br_.eos() && !(lenient && pos == total)) corrupt("the lossless bitstream ends early");
        return out;
    }

    static inline uint32_t add_pixels(uint32_t a, uint32_t b) {
        const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
        const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
        return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
    }
    static inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
    static inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
    static inline uint32_t select(uint32_t t, uint32_t l, uint32_t tl) {
        int sum = 0;
        for (int s = 0; s < 32; s += 8) {
            const int a = int((t >> s) & 0xff), b = int((l >> s) & 0xff), c = int((tl >> s) & 0xff);
            sum += std::abs(b - c) - std::abs(a - c);
        }
        return sum <= 0 ? t : l;
    }
    static inline uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
        uint32_t out = 0;
        for (int s = 0; s < 32; s += 8)
            out |= uint32_t(clip255(int((a >> s) & 0xff) + int((b >> s) & 0xff) - int((c >> s) & 0xff))) << s;
        return out;
    }
    static inline uint32_t clamp_add_sub_half(uint32_t a, uint32_t b, uint32_t c) {
        const uint32_t ave = average2(a, b);
        uint32_t out = 0;
        for (int s = 0; s < 32; s += 8) {
            const int x = int((ave >> s) & 0xff), y = int((c >> s) & 0xff);
            out |= uint32_t(clip255(x + (x - y) / 2)) << s;
        }
        return out;
    }
    static inline uint32_t predict(int mode, uint32_t l, const uint32_t* top) {
        switch (mode) {
            case 0: return kArgbBlack;
            case 1: return l;
            case 2: return top[0];
            case 3: return top[1];
            case 4: return top[-1];
            case 5: return average2(average2(l, top[1]), top[0]);
            case 6: return average2(l, top[-1]);
            case 7: return average2(l, top[0]);
            case 8: return average2(top[-1], top[0]);
            case 9: return average2(top[0], top[1]);
            case 10: return average2(average2(l, top[-1]), average2(top[0], top[1]));
            case 11: return select(top[0], l, top[-1]);
            case 12: return clamp_add_sub_full(l, top[0], top[-1]);
            case 13: return clamp_add_sub_half(l, top[0], top[-1]);
            default: return kArgbBlack;  // 14 and 15
        }
    }

    std::vector<uint32_t> undo_transforms(std::vector<uint32_t> pixels) {
        for (size_t n = transforms_.size(); n-- > 0;) {
            const Transform& t = transforms_[n];
            const int w = t.xsize, h = t.ysize;
            if (t.type == PREDICTOR) {
                std::vector<uint32_t> out(size_t(w) * size_t(h));
                const int tiles = subsample(w, t.bits);
                for (int y = 0; y < h; ++y) {
                    uint32_t* o = out.data() + size_t(y) * size_t(w);
                    const uint32_t* in = pixels.data() + size_t(y) * size_t(w);
                    const uint32_t* top = o - w;
                    for (int x = 0; x < w; ++x) {
                        uint32_t pred;
                        if (y == 0) pred = x == 0 ? kArgbBlack : o[x - 1];
                        else if (x == 0) pred = top[0];
                        else pred = predict(int((t.data[size_t((y >> t.bits) * tiles + (x >> t.bits))] >> 8) & 0xf), o[x - 1], top + x);
                        o[x] = add_pixels(in[x], pred);
                    }
                }
                pixels.swap(out);
            } else if (t.type == CROSS_COLOR) {
                const int tiles = subsample(w, t.bits);
                for (int y = 0; y < h; ++y) {
                    uint32_t* row = pixels.data() + size_t(y) * size_t(w);
                    for (int x = 0; x < w; ++x) {
                        const uint32_t code = t.data[size_t((y >> t.bits) * tiles + (x >> t.bits))];
                        const int8_t g2r = int8_t(code & 0xff), g2b = int8_t((code >> 8) & 0xff), r2b = int8_t((code >> 16) & 0xff);
                        const uint32_t argb = row[x];
                        const int8_t green = int8_t((argb >> 8) & 0xff);
                        int red = int((argb >> 16) & 0xff), blue = int(argb & 0xff);
                        red = (red + ((int(g2r) * green) >> 5)) & 0xff;
                        blue += (int(g2b) * green) >> 5;
                        blue += (int(r2b) * int8_t(red)) >> 5;
                        blue &= 0xff;
                        row[x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
                    }
                }
            } else if (t.type == SUBTRACT_GREEN) {
                for (auto& p : pixels) {
                    const uint32_t green = (p >> 8) & 0xff;
                    const uint32_t rb = ((p & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
                    p = (p & 0xff00ff00u) | rb;
                }
            } else {  // colour indexing: the packed width -> xsize
                const int packed_w = subsample(w, t.bits);
                std::vector<uint32_t> out(size_t(w) * size_t(h));
                const int bits_per_pixel = 8 >> t.bits;
                const int count_mask = (1 << t.bits) - 1;
                const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
                for (int y = 0; y < h; ++y) {
                    const uint32_t* in = pixels.data() + size_t(y) * size_t(packed_w);
                    uint32_t* o = out.data() + size_t(y) * size_t(w);
                    uint32_t packed = 0;
                    for (int x = 0; x < w; ++x) {
                        if ((x & count_mask) == 0) packed = (in[x >> t.bits] >> 8) & 0xff;
                        o[x] = t.data[packed & bit_mask];
                        packed >>= bits_per_pixel;
                    }
                }
                pixels.swap(out);
            }
        }
        return pixels;
    }
};

// =====================================================================
// ALPH
std::vector<uint8_t> decode_alph(const uint8_t* data, size_t len, int width, int height) {
    if (len <= 1) corrupt("an empty ALPH chunk");
    const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3, rsrv = data[0] >> 6;
    if (method > 1 || pre > 1 || rsrv != 0) corrupt("an ALPH header libwebp rejects");
    seen((method ? F_ALPH_LOSSLESS : F_ALPH_RAW) | (filter ? F_ALPH_HORIZONTAL << (filter - 1) : 0) |
         (pre ? F_ALPH_PREPROCESSED : 0));
    const size_t n = size_t(width) * size_t(height);
    std::vector<uint8_t> alpha(n);
    if (method == 0) {
        if (len - 1 < n) corrupt("a raw ALPH chunk shorter than the image");
        std::memcpy(alpha.data(), data + 1, n);
    } else {
        VP8LDecoder dec(data + 1, len - 1);
        std::vector<uint32_t> argb = dec.decode_alpha(width, height);
        for (size_t i = 0; i < n; ++i) alpha[i] = uint8_t(argb[i] >> 8);
    }
    // the filters (WebPUnfilters), row by row, in place
    for (int y = 0; y < height && filter; ++y) {
        uint8_t* row = alpha.data() + size_t(y) * size_t(width);
        const uint8_t* prev = y ? row - width : nullptr;
        if (filter == 1 || !prev) {  // horizontal; the first row of every filter
            uint8_t pred = prev ? prev[0] : 0;
            for (int x = 0; x < width; ++x) pred = row[x] = uint8_t(pred + row[x]);
        } else if (filter == 2) {  // vertical
            for (int x = 0; x < width; ++x) row[x] = uint8_t(prev[x] + row[x]);
        } else {  // gradient
            int left = prev[0], top_left = prev[0];
            for (int x = 0; x < width; ++x) {
                const int top = prev[x];
                const int g = left + top - top_left;
                left = uint8_t(row[x] + (g < 0 ? 0 : g > 255 ? 255 : g));
                top_left = top;
                row[x] = uint8_t(left);
            }
        }
    }
    return alpha;
}

// =====================================================================
// VP8
// The quantizer steps of the 7-bit index (RFC 6386, 14.1).
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
// The key-frame probabilities of the 4x4 intra modes, by the modes above
// and to the left (RFC 6386, 11.5), in libwebp's mode order.
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
// The default token probabilities (RFC 6386, 13.5).
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// The probabilities that each token probability is updated (RFC 6386, 13.4).
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// The boolean decoder as libwebp's VP8BitReader runs it on a 64-bit
// host: 56 bits (7 bytes) are loaded at a time while 8 bytes remain,
// then one at a time; `eof` is set when a bit is asked for after every
// byte has been taken.  The 64-bit value and the 32-bit comparisons
// wrap as libwebp's do, which decides what a corrupt partition decodes
// to.
struct BoolReader {
    const uint8_t* buf = nullptr;
    const uint8_t* end = nullptr;
    uint64_t value = 0;
    int bits = -8;
    uint32_t range = 255 - 1;
    bool eof = false;

    void init(const uint8_t* p, size_t size) {
        buf = p;
        end = p + size;
        value = 0;
        bits = -8;
        range = 255 - 1;
        eof = false;
        load();
    }
    void load() {
        if (end - buf >= 8) {
            uint64_t in = 0;
            for (int i = 0; i < 7; ++i) in = (in << 8) | buf[i];
            buf += 7;
            value = in | (value << 56);
            bits += 56;
        } else if (buf < end) {
            bits += 8;
            value = uint64_t(*buf++) | (value << 8);
        } else if (!eof) {
            value <<= 8;
            bits += 8;
            eof = true;
        } else {
            bits = 0;
        }
    }
    int get(int prob) {
        uint32_t r = range;
        if (bits < 0) load();
        const int pos = bits;
        const uint32_t split = (r * uint32_t(prob)) >> 8;
        const uint32_t v = uint32_t(value >> pos);
        const int bit = v > split;
        if (bit) {
            r -= split;
            value -= uint64_t(split + 1) << pos;
        } else {
            r = split + 1;
        }
        const int shift = 7 ^ (31 - __builtin_clz(r));
        r <<= shift;
        bits -= shift;
        range = r - 1;
        return bit;
    }
    // VP8GetSigned: a bit at probability 1/2 that signs `v`.
    int get_signed(int v) {
        if (bits < 0) load();
        const int pos = bits;
        const uint32_t split = range >> 1;
        const uint32_t val = uint32_t(value >> pos);
        const int32_t mask = int32_t(split - val) >> 31;  // -1 or 0
        bits -= 1;
        range += uint32_t(mask);
        range |= 1;
        value -= uint64_t((split + 1) & uint32_t(mask)) << pos;
        return (v ^ mask) - mask;
    }
    int value_bits(int n) {
        int v = 0;
        while (n-- > 0) v |= get(0x80) << n;
        return v;
    }
    int signed_value(int n) {
        const int v = value_bits(n);
        return get(0x80) ? -v : v;
    }
};

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED };
enum { DC_NOTOP = 10, DC_NOLEFT = 11, DC_NOTOPLEFT = 12 };

constexpr int BPS = 32;
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
const int8_t kYModesIntra4[18] = {-B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
                                  -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};
// Where each 4x4 block of a macroblock starts in the BPS workspace.
inline int scan(int n) { return (n & 3) * 4 + (n >> 2) * 4 * BPS; }

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

// --- inverse transforms (dsp/dec.c, dsp/dec_sse2.c)
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The full inverse DCT as libwebp's Transform_SSE2 computes it: in
// 16-bit lanes that wrap, the multiplies as _mm_mulhi_epi16 by 20091 and
// -30068 plus the input, an arithmetic shift of 3, a saturating pack.
// On a valid stream it equals the C transform; on a corrupt one (huge
// coefficients) the wrap decides the pixels, as it does in libwebp.
inline int16_t w16(int v) { return int16_t(uint16_t(v)); }
inline int16_t mulhi(int16_t a, int k) { return w16((int(a) * k) >> 16); }
inline void idct4(int16_t r0, int16_t r1, int16_t r2, int16_t r3, int16_t dc_round, int16_t out[4]) {
    const int16_t dc = w16(r0 + dc_round);
    const int16_t a = w16(dc + r2), b = w16(dc - r2);
    const int16_t c = w16(w16(r1 - r3) + w16(mulhi(r1, -30068) - mulhi(r3, 20091)));
    const int16_t d = w16(w16(r1 + r3) + w16(mulhi(r1, 20091) + mulhi(r3, -30068)));
    out[0] = w16(a + d);
    out[1] = w16(b + c);
    out[2] = w16(b - c);
    out[3] = w16(a - d);
}

void transform_one(const int16_t* in, uint8_t* dst) {
    int16_t col[4][4];  // col[c][k]: the vertical pass's output k of column c
    for (int c = 0; c < 4; ++c) idct4(in[c], in[4 + c], in[8 + c], in[12 + c], 0, col[c]);
    for (int k = 0; k < 4; ++k) {
        int16_t row[4];
        idct4(col[0][k], col[1][k], col[2][k], col[3][k], 4, row);
        uint8_t* d = dst + k * BPS;
        for (int j = 0; j < 4; ++j) d[j] = clip8(w16(d[j] + (row[j] >> 3)));
    }
}

void transform_ac3(const int16_t* in, uint8_t* dst) {
    const int a = in[0] + 4;
    const int c4 = mul2(in[4]), d4 = mul1(in[4]);
    const int c1 = mul2(in[1]), d1 = mul1(in[1]);
    const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
    for (int y = 0; y < 4; ++y) {
        uint8_t* d = dst + y * BPS;
        d[0] = clip8(d[0] + ((rows[y] + d1) >> 3));
        d[1] = clip8(d[1] + ((rows[y] + c1) >> 3));
        d[2] = clip8(d[2] + ((rows[y] - c1) >> 3));
        d[3] = clip8(d[3] + ((rows[y] - d1) >> 3));
    }
}

void transform_dc(const int16_t* in, uint8_t* dst) {
    const int dc = in[0] + 4;
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) dst[x + y * BPS] = clip8(dst[x + y * BPS] + (dc >> 3));
}

void do_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    switch (bits >> 30) {
        case 3: transform_one(src, dst); break;
        case 2: transform_ac3(src, dst); break;
        case 1: transform_dc(src, dst); break;
        default: break;
    }
}

void do_uv_transform(uint32_t bits, const int16_t* src, uint8_t* dst) {
    if (bits & 0xff) {
        if (bits & 0xaa) {  // any non-DC coefficient: the full transform on each
            transform_one(src, dst);
            transform_one(src + 16, dst + 4);
            transform_one(src + 32, dst + 4 * BPS);
            transform_one(src + 48, dst + 4 * BPS + 4);
        } else {
            transform_dc(src, dst);
            transform_dc(src + 16, dst + 4);
            transform_dc(src + 32, dst + 4 * BPS);
            transform_dc(src + 48, dst + 4 * BPS + 4);
        }
    }
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = int16_t((a0 + a1) >> 3);
        out[16] = int16_t((a3 + a2) >> 3);
        out[32] = int16_t((a0 - a1) >> 3);
        out[48] = int16_t((a3 - a2) >> 3);
        out += 64;
    }
}

// --- intra predictors (dsp/dec.c), on the BPS workspace
inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    const int tl = top[-1];
    for (int y = 0; y < size; ++y) {
        const int left = dst[-1];
        for (int x = 0; x < size; ++x) dst[x] = clip8(left + top[x] - tl);
        dst += BPS;
    }
}

void fill(uint8_t* dst, int size, int v) {
    for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size_t(size));
}

void pred_luma16(int mode, uint8_t* dst) {
    int dc;
    switch (mode) {
        case DC_PRED:
            dc = 16;
            for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
            fill(dst, 16, dc >> 5);
            break;
        case TM_PRED: true_motion(dst, 16); break;
        case V_PRED:
            for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
            break;
        case H_PRED:
            for (int j = 0; j < 16; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
            break;
        case DC_NOTOP:
            dc = 8;
            for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
            fill(dst, 16, dc >> 4);
            break;
        case DC_NOLEFT:
            dc = 8;
            for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
            fill(dst, 16, dc >> 4);
            break;
        default: fill(dst, 16, 0x80); break;
    }
}

void pred_chroma8(int mode, uint8_t* dst) {
    int dc;
    switch (mode) {
        case DC_PRED:
            dc = 8;
            for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
            fill(dst, 8, dc >> 4);
            break;
        case TM_PRED: true_motion(dst, 8); break;
        case V_PRED:
            for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
            break;
        case H_PRED:
            for (int j = 0; j < 8; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
            break;
        case DC_NOTOP:
            dc = 4;
            for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
            fill(dst, 8, dc >> 3);
            break;
        case DC_NOLEFT:
            dc = 4;
            for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
            fill(dst, 8, dc >> 3);
            break;
        default: fill(dst, 8, 0x80); break;
    }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void pred_luma4(int mode, uint8_t* dst) {
    const uint8_t* top = dst - BPS;
    const int X = dst[-1 - BPS];
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
    const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6], H = top[7];
    switch (mode) {
        case B_DC_PRED: {
            uint32_t dc = 4;
            for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
            fill(dst, 4, int(dc >> 3));
            break;
        }
        case B_TM_PRED: true_motion(dst, 4); break;
        case B_VE_PRED: {
            const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
            for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
            break;
        }
        case B_HE_PRED:
            std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
            std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
            std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
            std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
            break;
        case B_RD_PRED:
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        case B_LD_PRED:
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        case B_VR_PRED:
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        case B_VL_PRED:
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        case B_HD_PRED:
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
        default:  // B_HU_PRED
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = uint8_t(L);
            break;
    }
}
#undef DST

// --- loop filters (dsp/dec.c)
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020] -> [-128, 127]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }     // [-112, 112] -> [-16, 15]

inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0];
    const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
           std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {  // 16 pixels along an edge
    const int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i)
        if (needs_filter(p + i * vstride, hstride, thresh2)) do_filter2(p + i * vstride, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh, bool edge) {
    const int thresh2 = 2 * thresh + 1;
    while (size-- > 0) {
        if (needs_filter2(p, hstride, thresh2, ithresh)) {
            if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
            else if (edge) do_filter6(p, hstride);
            else do_filter4(p, hstride);
        }
        p += vstride;
    }
}

struct FInfo {
    int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
    int16_t coeffs[384];
    uint8_t is_i4x4 = 0, imodes[16] = {0}, uvmode = 0, segment = 0, skip = 0;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
};

struct QuantMatrix {
    int y1[2], y2[2], uv[2];
};

class VP8Decoder {
  public:
    int width = 0, height = 0, mb_w = 0, mb_h = 0;
    std::vector<uint8_t> Y, U, V;  // mb_w*16 x mb_h*16 and mb_w*8 x mb_h*8

    void decode(const uint8_t* data, size_t size) {
        if (size < 4) corrupt("a truncated VP8 header");
        const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
        const bool key_frame = !(bits & 1);
        const int profile = (bits >> 1) & 7;
        const int show = (bits >> 4) & 1;
        const uint32_t partition_length = bits >> 5;
        if (profile > 3) corrupt("an incorrect VP8 key frame profile");
        if (!show) corrupt("a VP8 frame that is not shown");
        data += 3;
        size -= 3;
        if (!key_frame) corrupt("a VP8 frame that is not a key frame");
        if (size < 7) corrupt("a truncated VP8 picture header");
        if (data[0] != 0x9d || data[1] != 0x01 || data[2] != 0x2a) corrupt("a bad VP8 start code");
        width = ((data[4] << 8) | data[3]) & 0x3fff;
        height = ((data[6] << 8) | data[5]) & 0x3fff;
        data += 7;
        size -= 7;
        if (width == 0 || height == 0) corrupt("a VP8 frame of zero size");
        mb_w = (width + 15) >> 4;
        mb_h = (height + 15) >> 4;
        if (partition_length > size) corrupt("a VP8 first partition past the data");
        br_.init(data, partition_length);
        data += partition_length;
        size -= partition_length;
        br_.get(0x80);  // colour space
        br_.get(0x80);  // clamping type
        parse_segment_header();
        parse_filter_header();
        parse_partitions(data, size);
        parse_quant();
        br_.get(0x80);  // update_proba, ignored
        parse_proba();
        decode_frame();
    }

  private:
    BoolReader br_;
    BoolReader parts_[8];
    int num_parts_minus_one_ = 0;
    // segment header
    bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
    int quantizer_[4] = {0}, filter_strength_[4] = {0};
    uint8_t segment_proba_[3] = {255, 255, 255};
    // filter header
    bool simple_ = false, use_lf_delta_ = false;
    int level_ = 0, sharpness_ = 0, ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
    int filter_type_ = 0;
    QuantMatrix dqm_[4];
    uint8_t proba_[4][8][3][11];
    bool use_skip_proba_ = false;
    int skip_p_ = 0;
    FInfo fstrengths_[4][2];

    void parse_segment_header() {
        use_segment_ = br_.get(0x80);
        if (use_segment_) {
            update_map_ = br_.get(0x80);
            seen(update_map_ ? F_SEGMENT_MAP : F_SEGMENTS_WITHOUT_MAP);
            if (br_.get(0x80)) {
                absolute_delta_ = br_.get(0x80);
                for (int s = 0; s < 4; ++s) quantizer_[s] = br_.get(0x80) ? br_.signed_value(7) : 0;
                for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.get(0x80) ? br_.signed_value(6) : 0;
            }
            if (update_map_)
                for (int s = 0; s < 3; ++s) segment_proba_[s] = uint8_t(br_.get(0x80) ? br_.value_bits(8) : 255);
        } else {
            update_map_ = false;
        }
        if (br_.eof) corrupt("a VP8 segment header past its partition");
    }

    void parse_filter_header() {
        simple_ = br_.get(0x80);
        level_ = br_.value_bits(6);
        sharpness_ = br_.value_bits(3);
        use_lf_delta_ = br_.get(0x80);
        if (use_lf_delta_ && br_.get(0x80)) {
            for (int i = 0; i < 4; ++i)
                if (br_.get(0x80)) ref_lf_delta_[i] = br_.signed_value(6);
            for (int i = 0; i < 4; ++i)
                if (br_.get(0x80)) mode_lf_delta_[i] = br_.signed_value(6);
        }
        filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
        seen((filter_type_ == 0 ? F_NO_FILTER : filter_type_ == 1 ? F_SIMPLE_FILTER : F_NORMAL_FILTER) |
             (sharpness_ ? F_SHARPNESS : 0) | (use_lf_delta_ ? F_LF_DELTAS : 0));
        if (br_.eof) corrupt("a VP8 filter header past its partition");
    }

    void parse_partitions(const uint8_t* buf, size_t size) {
        const uint8_t* sz = buf;
        const uint8_t* buf_end = buf + size;
        num_parts_minus_one_ = (1 << br_.value_bits(2)) - 1;
        if (num_parts_minus_one_) seen(F_PARTITIONS_2 << (num_parts_minus_one_ == 1 ? 0 : num_parts_minus_one_ == 3 ? 1 : 2));
        const size_t last_part = size_t(num_parts_minus_one_);
        if (size < 3 * last_part) corrupt("VP8 partition sizes past the data");
        const uint8_t* part_start = buf + last_part * 3;
        size_t size_left = size - last_part * 3;
        for (size_t p = 0; p < last_part; ++p) {
            size_t psize = size_t(sz[0] | (sz[1] << 8) | (sz[2] << 16));
            if (psize > size_left) psize = size_left;
            parts_[p].init(part_start, psize);
            part_start += psize;
            size_left -= psize;
            sz += 3;
        }
        parts_[last_part].init(part_start, size_left);
        if (part_start >= buf_end) corrupt("an empty last VP8 partition");
    }

    void parse_quant() {
        static const auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
        const int base_q0 = br_.value_bits(7);
        const int dqy1_dc = br_.get(0x80) ? br_.signed_value(4) : 0;
        const int dqy2_dc = br_.get(0x80) ? br_.signed_value(4) : 0;
        const int dqy2_ac = br_.get(0x80) ? br_.signed_value(4) : 0;
        const int dquv_dc = br_.get(0x80) ? br_.signed_value(4) : 0;
        const int dquv_ac = br_.get(0x80) ? br_.signed_value(4) : 0;
        for (int i = 0; i < 4; ++i) {
            int q;
            if (use_segment_) {
                q = quantizer_[i];
                if (!absolute_delta_) q += base_q0;
            } else if (i > 0) {
                dqm_[i] = dqm_[0];
                continue;
            } else {
                q = base_q0;
            }
            QuantMatrix& m = dqm_[i];
            m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
            m.y1[1] = kAcTable[clip(q + 0, 127)];
            m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
            m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
            if (m.y2[1] < 8) m.y2[1] = 8;
            m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
            m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
        }
    }

    void parse_proba() {
        for (int t = 0; t < 4; ++t)
            for (int b = 0; b < 8; ++b)
                for (int c = 0; c < 3; ++c)
                    for (int p = 0; p < 11; ++p)
                        proba_[t][b][c][p] = uint8_t(br_.get(kCoeffsUpdateProba[t][b][c][p]) ? br_.value_bits(8)
                                                                                         : kCoeffsProba0[t][b][c][p]);
        use_skip_proba_ = br_.get(0x80);
        if (use_skip_proba_) skip_p_ = br_.value_bits(8);
    }

    void precompute_filter_strengths() {
        if (filter_type_ == 0) return;
        for (int s = 0; s < 4; ++s) {
            int base_level;
            if (use_segment_) {
                base_level = filter_strength_[s];
                if (!absolute_delta_) base_level += level_;
            } else {
                base_level = level_;
            }
            for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
                FInfo& info = fstrengths_[s][i4x4];
                int level = base_level;
                if (use_lf_delta_) {
                    level += ref_lf_delta_[0];
                    if (i4x4) level += mode_lf_delta_[0];
                }
                level = level < 0 ? 0 : level > 63 ? 63 : level;
                if (level > 0) {
                    int ilevel = level;
                    if (sharpness_ > 0) {
                        ilevel >>= sharpness_ > 4 ? 2 : 1;
                        if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
                    }
                    if (ilevel < 1) ilevel = 1;
                    info.ilevel = ilevel;
                    info.limit = 2 * level + ilevel;
                    info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
                } else {
                    info.limit = 0;
                }
                info.inner = i4x4;
            }
        }
    }

    void parse_intra_mode(MBData& block, uint8_t* top, uint8_t* left) {
        if (update_map_) {
            block.segment = uint8_t(!br_.get(segment_proba_[0]) ? br_.get(segment_proba_[1])
                                                               : br_.get(segment_proba_[2]) + 2);
        } else {
            block.segment = 0;
        }
        if (use_skip_proba_) {
            block.skip = uint8_t(br_.get(skip_p_));
            seen(F_SKIP);
        }
        block.is_i4x4 = !br_.get(145);
        seen(block.is_i4x4 ? F_I4X4 : F_I16);
        if (!block.is_i4x4) {
            const int ymode = br_.get(156) ? (br_.get(128) ? TM_PRED : H_PRED) : (br_.get(163) ? V_PRED : DC_PRED);
            block.imodes[0] = uint8_t(ymode);
            std::memset(top, ymode, 4);
            std::memset(left, ymode, 4);
        } else {
            uint8_t* modes = block.imodes;
            for (int y = 0; y < 4; ++y) {
                int ymode = left[y];
                for (int x = 0; x < 4; ++x) {
                    const uint8_t* prob = kBModesProba[top[x]][ymode];
                    int i = kYModesIntra4[br_.get(prob[0])];
                    while (i > 0) i = kYModesIntra4[2 * i + br_.get(prob[i])];
                    ymode = -i;
                    top[x] = uint8_t(ymode);
                }
                std::memcpy(modes, top, 4);
                modes += 4;
                left[y] = uint8_t(ymode);
            }
        }
        block.uvmode = uint8_t(!br_.get(142) ? DC_PRED : !br_.get(114) ? V_PRED : br_.get(183) ? TM_PRED : H_PRED);
    }

    // GetCoeffs: tokens from `n` on, dequantized into out (zigzag order);
    // returns the position after the last token read.
    int get_coeffs(BoolReader& br, int type, int ctx, const int* dq, int n, int16_t* out) {
        const uint8_t* p = proba_[type][kBands[n]][ctx];
        for (; n < 16; ++n) {
            if (!br.get(p[0])) return n;
            while (!br.get(p[1])) {
                p = proba_[type][kBands[++n]][0];
                if (n == 16) return 16;
            }
            int v;
            const int band_next = kBands[n + 1];
            if (!br.get(p[2])) {
                v = 1;
                p = proba_[type][band_next][1];
            } else {
                if (!br.get(p[3])) {
                    if (!br.get(p[4])) v = 2;
                    else v = 3 + br.get(p[5]);
                } else if (!br.get(p[6])) {
                    if (!br.get(p[7])) {
                        v = 5 + br.get(159);
                    } else {
                        v = 7 + 2 * br.get(165);
                        v += br.get(145);
                    }
                } else {
                    const int bit1 = br.get(p[8]);
                    const int bit0 = br.get(p[9 + bit1]);
                    const int cat = 2 * bit1 + bit0;
                    v = 0;
                    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
                    v += 3 + (8 << cat);
                }
                p = proba_[type][band_next][2];
            }
            out[kZigzag[n]] = int16_t(br.get_signed(v) * dq[n > 0]);
        }
        return 16;
    }

    static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
        nz_coeffs <<= 2;
        nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
        return nz_coeffs;
    }

    // ParseResiduals: true when every coefficient is zero.
    bool parse_residuals(MBData& block, uint8_t& top_nz, uint8_t& top_nz_dc, uint8_t& left_nz,
                         uint8_t& left_nz_dc, BoolReader& br) {
        const QuantMatrix& q = dqm_[block.segment];
        int16_t* dst = block.coeffs;
        std::memset(dst, 0, sizeof(block.coeffs));
        uint32_t non_zero_y = 0, non_zero_uv = 0;
        int first, ac_type;
        if (!block.is_i4x4) {
            int16_t dc[16] = {0};
            const int ctx = top_nz_dc + left_nz_dc;
            const int nz = get_coeffs(br, 1, ctx, q.y2, 0, dc);
            top_nz_dc = left_nz_dc = uint8_t(nz > 0);
            if (nz > 1) {
                transform_wht(dc, dst);
            } else {
                const int dc0 = (dc[0] + 3) >> 3;
                for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
            }
            first = 1;
            ac_type = 0;
        } else {
            first = 0;
            ac_type = 3;
        }
        uint32_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
        for (int y = 0; y < 4; ++y) {
            int l = lnz & 1;
            uint32_t nz_coeffs = 0;
            for (int x = 0; x < 4; ++x) {
                const int ctx = l + int(tnz & 1);
                const int nz = get_coeffs(br, ac_type, ctx, q.y1, first, dst);
                l = nz > first;
                tnz = (tnz >> 1) | (uint32_t(l) << 7);
                nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                dst += 16;
            }
            tnz >>= 4;
            lnz = (lnz >> 1) | (uint32_t(l) << 7);
            non_zero_y = (non_zero_y << 8) | nz_coeffs;
        }
        uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
            uint32_t nz_coeffs = 0;
            tnz = uint32_t(top_nz) >> (4 + ch);
            lnz = uint32_t(left_nz) >> (4 + ch);
            for (int y = 0; y < 2; ++y) {
                int l = lnz & 1;
                for (int x = 0; x < 2; ++x) {
                    const int ctx = l + int(tnz & 1);
                    const int nz = get_coeffs(br, 2, ctx, q.uv, 0, dst);
                    l = nz > 0;
                    tnz = (tnz >> 1) | (uint32_t(l) << 3);
                    nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                    dst += 16;
                }
                tnz >>= 2;
                lnz = (lnz >> 1) | (uint32_t(l) << 5);
            }
            non_zero_uv |= nz_coeffs << (4 * ch);
            out_t_nz |= (tnz << 4) << ch;
            out_l_nz |= (lnz & 0xf0) << ch;
        }
        top_nz = uint8_t(out_t_nz);
        left_nz = uint8_t(out_l_nz);
        block.non_zero_y = non_zero_y;
        block.non_zero_uv = non_zero_uv;
        return !(non_zero_y | non_zero_uv);
    }

    void decode_frame() {
        precompute_filter_strengths();
        const int yw = mb_w * 16, uvw = mb_w * 8;
        Y.assign(size_t(yw) * size_t(mb_h * 16), 0);
        U.assign(size_t(uvw) * size_t(mb_h * 8), 0);
        V.assign(size_t(uvw) * size_t(mb_h * 8), 0);
        std::vector<uint8_t> intra_t(size_t(4 * mb_w), B_DC_PRED);
        std::vector<uint8_t> top_nz(size_t(mb_w), 0), top_nz_dc(size_t(mb_w), 0);
        std::vector<MBData> row(static_cast<size_t>(mb_w));
        std::vector<FInfo> finfo(size_t(mb_w) * size_t(mb_h));
        // unfiltered bottom samples of the row above: y, u, v per column
        std::vector<uint8_t> top_y(static_cast<size_t>(yw)), top_u(static_cast<size_t>(uvw)), top_v(static_cast<size_t>(uvw));
        uint8_t ws[YUV_SIZE];
        for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
            uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
            uint8_t left_nz = 0, left_nz_dc = 0;
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(row[size_t(mb_x)], &intra_t[size_t(4 * mb_x)], intra_l);
            if (br_.eof) corrupt("a VP8 first partition that ends early");
            BoolReader& token_br = parts_[mb_y & num_parts_minus_one_];
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                MBData& block = row[size_t(mb_x)];
                int skip = use_skip_proba_ ? block.skip : 0;
                if (!skip) {
                    skip = parse_residuals(block, top_nz[size_t(mb_x)], top_nz_dc[size_t(mb_x)], left_nz, left_nz_dc, token_br);
                } else {
                    left_nz = top_nz[size_t(mb_x)] = 0;
                    if (!block.is_i4x4) left_nz_dc = top_nz_dc[size_t(mb_x)] = 0;
                    block.non_zero_y = block.non_zero_uv = 0;
                }
                if (filter_type_ > 0) {
                    FInfo f = fstrengths_[block.segment][block.is_i4x4];
                    f.inner |= !skip;
                    finfo[size_t(mb_y) * size_t(mb_w) + size_t(mb_x)] = f;
                }
                if (token_br.eof) corrupt("a VP8 token partition that ends early");
            }
            reconstruct_row(mb_y, row, ws, top_y, top_u, top_v);
        }
        if (filter_type_ > 0)
            for (int mb_y = 0; mb_y < mb_h; ++mb_y)
                for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(mb_x, mb_y, finfo[size_t(mb_y) * size_t(mb_w) + size_t(mb_x)]);
    }

    static int check_mode(int mb_x, int mb_y, int mode) {
        if (mode == B_DC_PRED) {
            if (mb_x == 0) return mb_y == 0 ? int(DC_NOTOPLEFT) : int(DC_NOLEFT);
            return mb_y == 0 ? int(DC_NOTOP) : int(B_DC_PRED);
        }
        return mode;
    }

    void reconstruct_row(int mb_y, const std::vector<MBData>& row, uint8_t* ws, std::vector<uint8_t>& top_y,
                         std::vector<uint8_t>& top_u, std::vector<uint8_t>& top_v) {
        uint8_t* const y_dst = ws + Y_OFF;
        uint8_t* const u_dst = ws + U_OFF;
        uint8_t* const v_dst = ws + V_OFF;
        for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
        for (int j = 0; j < 8; ++j) {
            u_dst[j * BPS - 1] = 129;
            v_dst[j * BPS - 1] = 129;
        }
        if (mb_y > 0) {
            y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
        } else {
            std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
            std::memset(u_dst - BPS - 1, 127, 8 + 1);
            std::memset(v_dst - BPS - 1, 127, 8 + 1);
        }
        const int yw = mb_w * 16, uvw = mb_w * 8;
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            const MBData& block = row[size_t(mb_x)];
            if (mb_x > 0) {
                for (int j = -1; j < 16; ++j) std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
                for (int j = -1; j < 8; ++j) {
                    std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
                    std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
                }
            }
            const int16_t* coeffs = block.coeffs;
            uint32_t bits = block.non_zero_y;
            if (mb_y > 0) {
                std::memcpy(y_dst - BPS, &top_y[size_t(mb_x * 16)], 16);
                std::memcpy(u_dst - BPS, &top_u[size_t(mb_x * 8)], 8);
                std::memcpy(v_dst - BPS, &top_v[size_t(mb_x * 8)], 8);
            }
            if (block.is_i4x4) {
                uint8_t* const top_right = y_dst - BPS + 16;
                if (mb_y > 0) {
                    if (mb_x >= mb_w - 1) std::memset(top_right, top_y[size_t(mb_x * 16 + 15)], 4);
                    else std::memcpy(top_right, &top_y[size_t(mb_x * 16 + 16)], 4);
                }
                for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
                for (int n = 0; n < 16; ++n, bits <<= 2) {
                    uint8_t* const dst = y_dst + scan(n);
                    pred_luma4(block.imodes[n], dst);
                    do_transform(bits, coeffs + n * 16, dst);
                }
            } else {
                pred_luma16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
                if (bits != 0)
                    for (int n = 0; n < 16; ++n, bits <<= 2) do_transform(bits, coeffs + n * 16, y_dst + scan(n));
            }
            const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
            pred_chroma8(uv_mode, u_dst);
            pred_chroma8(uv_mode, v_dst);
            do_uv_transform(block.non_zero_uv >> 0, coeffs + 16 * 16, u_dst);
            do_uv_transform(block.non_zero_uv >> 8, coeffs + 20 * 16, v_dst);
            if (mb_y < mb_h - 1) {
                std::memcpy(&top_y[size_t(mb_x * 16)], y_dst + 15 * BPS, 16);
                std::memcpy(&top_u[size_t(mb_x * 8)], u_dst + 7 * BPS, 8);
                std::memcpy(&top_v[size_t(mb_x * 8)], v_dst + 7 * BPS, 8);
            }
            for (int j = 0; j < 16; ++j)
                std::memcpy(&Y[size_t(mb_y * 16 + j) * size_t(yw) + size_t(mb_x * 16)], y_dst + j * BPS, 16);
            for (int j = 0; j < 8; ++j) {
                std::memcpy(&U[size_t(mb_y * 8 + j) * size_t(uvw) + size_t(mb_x * 8)], u_dst + j * BPS, 8);
                std::memcpy(&V[size_t(mb_y * 8 + j) * size_t(uvw) + size_t(mb_x * 8)], v_dst + j * BPS, 8);
            }
        }
    }

    void filter_mb(int mb_x, int mb_y, const FInfo& f) {
        const int limit = f.limit;
        if (limit == 0) return;
        const int y_bps = mb_w * 16, uv_bps = mb_w * 8;
        uint8_t* const y_dst = &Y[size_t(mb_y * 16) * size_t(y_bps) + size_t(mb_x * 16)];
        if (filter_type_ == 1) {
            if (mb_x > 0) simple_filter(y_dst, 1, y_bps, limit + 4);
            if (f.inner)
                for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k, 1, y_bps, limit);
            if (mb_y > 0) simple_filter(y_dst, y_bps, 1, limit + 4);
            if (f.inner)
                for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k * y_bps, y_bps, 1, limit);
            return;
        }
        uint8_t* const u_dst = &U[size_t(mb_y * 8) * size_t(uv_bps) + size_t(mb_x * 8)];
        uint8_t* const v_dst = &V[size_t(mb_y * 8) * size_t(uv_bps) + size_t(mb_x * 8)];
        const int il = f.ilevel, hev_t = f.hev_thresh;
        if (mb_x > 0) {
            filter_loop(y_dst, 1, y_bps, 16, limit + 4, il, hev_t, true);
            filter_loop(u_dst, 1, uv_bps, 8, limit + 4, il, hev_t, true);
            filter_loop(v_dst, 1, uv_bps, 8, limit + 4, il, hev_t, true);
        }
        if (f.inner) {
            for (int k = 1; k <= 3; ++k) filter_loop(y_dst + 4 * k, 1, y_bps, 16, limit, il, hev_t, false);
            filter_loop(u_dst + 4, 1, uv_bps, 8, limit, il, hev_t, false);
            filter_loop(v_dst + 4, 1, uv_bps, 8, limit, il, hev_t, false);
        }
        if (mb_y > 0) {
            filter_loop(y_dst, y_bps, 1, 16, limit + 4, il, hev_t, true);
            filter_loop(u_dst, uv_bps, 1, 8, limit + 4, il, hev_t, true);
            filter_loop(v_dst, uv_bps, 1, 8, limit + 4, il, hev_t, true);
        }
        if (f.inner) {
            for (int k = 1; k <= 3; ++k) filter_loop(y_dst + 4 * k * y_bps, y_bps, 1, 16, limit, il, hev_t, false);
            filter_loop(u_dst + 4 * uv_bps, uv_bps, 1, 8, limit, il, hev_t, false);
            filter_loop(v_dst + 4 * uv_bps, uv_bps, 1, 8, limit, il, hev_t, false);
        }
    }
};

// =====================================================================
// YUV 4:2:0 -> BGR: libwebp's fancy upsampler and VP8YUVToR/G/B
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return uint8_t((v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255); }
inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
    bgr[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
    bgr[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    bgr[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
}

// One output row from luma row `y_row` and its nearer (weight 3) and
// farther chroma rows, as libwebp's UpsampleRgbLinePair computes the
// row of a pair that lies next to `near`.
void upsample_line(const uint8_t* y_row, const uint8_t* near_u, const uint8_t* near_v, const uint8_t* far_u,
                   const uint8_t* far_v, uint8_t* dst, int len) {
    const int last_pair = (len - 1) >> 1;
    int tl_u = near_u[0], tl_v = near_v[0], l_u = far_u[0], l_v = far_v[0];
    yuv_to_bgr(y_row[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, dst);
    for (int x = 1; x <= last_pair; ++x) {
        const int t_u = near_u[x], t_v = near_v[x], u = far_u[x], v = far_v[x];
        const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
        const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
        const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
        yuv_to_bgr(y_row[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, dst + 3 * (2 * x - 1));
        yuv_to_bgr(y_row[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, dst + 3 * (2 * x));
        tl_u = t_u;
        tl_v = t_v;
        l_u = u;
        l_v = v;
    }
    if (!(len & 1)) yuv_to_bgr(y_row[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, dst + 3 * (len - 1));
}

void emit_fancy_bgr(const VP8Decoder& d, uint8_t* out) {
    const int w = d.width, h = d.height, yw = d.mb_w * 16, uvw = d.mb_w * 8;
    const int ch = (h + 1) / 2;
    for (int y = 0; y < h; ++y) {
        int near, far;
        if (y == 0) {
            near = far = 0;
        } else if (y & 1) {
            const int k = (y + 1) / 2;
            near = k - 1;
            far = k < ch ? k : k - 1;
        } else {
            near = y / 2;
            far = y / 2 - 1;
        }
        upsample_line(&d.Y[size_t(y) * size_t(yw)], &d.U[size_t(near) * size_t(uvw)], &d.V[size_t(near) * size_t(uvw)],
                      &d.U[size_t(far) * size_t(uvw)], &d.V[size_t(far) * size_t(uvw)], out + size_t(y) * size_t(w) * 3, w);
    }
}

void set_error(const Failure& f, char* err, int errlen) {
    if (errlen > 0) std::snprintf(err, size_t(errlen), "%s", f.what.c_str());
}

}  // namespace

extern "C" {

// A VP8L bitstream (from its signature byte; `len` bytes readable, to
// the end of the data libwebp is given) -> BGR (height, width, 3) and,
// if `alpha` is not null, the alpha plane; `features` gets the bits of
// the features met.  Returns 0, or 1 with a message in `err`.
int webp_decode_vp8l(const uint8_t* data, int64_t len, int32_t width, int32_t height, uint8_t* bgr, uint8_t* alpha,
                     uint64_t* features, char* err, int errlen) {
    features_seen = 0;
    try {
        if (len < 0 || width <= 0 || height <= 0) corrupt("bad arguments");
        VP8LDecoder dec(data, size_t(len));
        LBitReader& br = dec.reader();
        if (br.read(8) != 0x2f) corrupt("no VP8L signature");
        const int w = int(br.read(14)) + 1, h = int(br.read(14)) + 1;
        br.read(1);  // alpha hint
        if (br.read(3) != 0 || br.eos()) corrupt("an unknown VP8L version");
        if (w != width || h != height) corrupt("a VP8L size other than the header's");
        const std::vector<uint32_t> argb = dec.decode_image(w, h);
        const size_t n = size_t(w) * size_t(h);
        for (size_t i = 0; i < n; ++i) {
            bgr[3 * i] = uint8_t(argb[i]);
            bgr[3 * i + 1] = uint8_t(argb[i] >> 8);
            bgr[3 * i + 2] = uint8_t(argb[i] >> 16);
            if (alpha) alpha[i] = uint8_t(argb[i] >> 24);
        }
        *features = features_seen;
        return 0;
    } catch (const Failure& f) {
        set_error(f, err, errlen);
        return 1;
    } catch (const std::bad_alloc&) {
        set_error(Failure{"out of memory"}, err, errlen);
        return 1;
    } catch (...) {
        set_error(Failure{"the lossless bitstream could not be read"}, err, errlen);
        return 1;
    }
}

// A VP8 key frame (from its frame tag; `len` bytes readable) and its
// ALPH chunk's payload (null when there is none) -> BGR (height, width,
// 3) through the fancy upsampler and, if `alpha` is not null and there
// is an ALPH chunk, the alpha plane; `features` gets the bits of the
// features met.  Returns 0, or 1 with a message.
int webp_decode_vp8(const uint8_t* data, int64_t len, const uint8_t* alph, int64_t alph_len, int32_t width,
                    int32_t height, uint8_t* bgr, uint8_t* alpha, uint64_t* features, char* err, int errlen) {
    features_seen = 0;
    try {
        if (len < 0 || alph_len < 0 || width <= 0 || height <= 0) corrupt("bad arguments");
        VP8Decoder dec;
        dec.decode(data, size_t(len));
        if (dec.width != width || dec.height != height) corrupt("a VP8 size other than the header's");
        if (alph) {
            const std::vector<uint8_t> a = decode_alph(alph, size_t(alph_len), width, height);
            if (alpha) std::memcpy(alpha, a.data(), a.size());
        }
        emit_fancy_bgr(dec, bgr);
        *features = features_seen;
        return 0;
    } catch (const Failure& f) {
        set_error(f, err, errlen);
        return 1;
    } catch (const std::bad_alloc&) {
        set_error(Failure{"out of memory"}, err, errlen);
        return 1;
    } catch (...) {
        set_error(Failure{"the lossy bitstream could not be read"}, err, errlen);
        return 1;
    }
}

}  // extern "C"
