// The JPEG 2000 codestream decoder (ITU-T T.800, Part 1) behind the
// port's cv2.imread(path, IMREAD_COLOR) for JP2 files and raw
// codestreams: it returns each component's samples as OpenJPEG 2.5
// (the library OpenCV 5 reads JPEG 2000 with) hands them to OpenCV.
// The JP2 boxes, the palette and the turn into BGR are in
// pero_ocr_tpu_torch/utils/jpeg2000.py.
//
// - The codestream: SIZ, COD, COC, QCD, QCC, RGN and POC in the main
//   and tile-part headers; TLM, PLM, PLT, CRG, COM and unknown markers
//   are skipped; SOT and SOD with tile-parts in any order and Psot = 0
//   on the last one.  PPM and PPT (packed packet headers) are refused.
// - Tier 2 (Annex B): the T.800 geometry of tiles, tile-components,
//   resolutions, bands, precincts and code-blocks; tag trees; packet
//   headers with SOP and EPH markers; the five progression orders and
//   POC, walked as OpenJPEG's pi.c walks them.
// - Tier 1 (Annex C and D): the MQ decoder and the three coding passes
//   in stripes of 4 rows, with the code-block styles (BYPASS, RESET,
//   TERMALL, VSC, PTERM, SEGSYM).  Coefficients are kept as OpenJPEG's
//   t1.c keeps them: twice the magnitude, plus half of the lowest
//   decoded bit-plane.
// - Dequantisation, RGN's max-shift, the inverse 5/3 (integer) and 9/7
//   (float32, OpenJPEG's constants, scaling and lifting order) wavelets,
//   the inverse RCT or ICT, the DC level shift and the clamp, with
//   lrintf's round-half-even for the 9/7 path.  Built with
//   -ffp-contract=off (utils/kernels.py) so no multiply-add is fused.
//
// One thread.  Errors: 1 for data OpenJPEG rejects (cv2.imread returns
// None), 2 for a feature this decoder does not read.
//
// Built with the host compiler and loaded through ctypes by
// pero_ocr_tpu_torch/utils/kernels.py; bound in utils/jpeg2000.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

struct Failure {
    int code;  // 1: corrupt (OpenJPEG fails), 2: not read by this decoder
    std::string what;
};

[[noreturn]] void corrupt(const std::string& what) { throw Failure{1, what}; }
[[noreturn]] void refuse(const std::string& what) { throw Failure{2, what}; }

// Features met while decoding, reported to Python (bit -> name in
// utils/jpeg2000.py).
enum Feature : int64_t {
    F_BYPASS = 1 << 0, F_RESET = 1 << 1, F_TERMALL = 1 << 2, F_VSC = 1 << 3,
    F_PTERM = 1 << 4, F_SEGSYM = 1 << 5, F_SOP = 1 << 6, F_EPH = 1 << 7,
    F_POC = 1 << 8, F_RGN = 1 << 9, F_TILEPARTS = 1 << 10, F_TLM = 1 << 11,
    F_PLM = 1 << 12, F_PLT = 1 << 13, F_COC = 1 << 14, F_QCC = 1 << 15,
    F_PRECINCTS = 1 << 16, F_LAYERS = 1 << 17, F_IRREVERSIBLE = 1 << 18,
    F_MCT = 1 << 19, F_TILES = 1 << 20, F_PSOT0 = 1 << 21, F_COM = 1 << 22,
    F_CRG = 1 << 23,
};

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ---------------------------------------------------------------------
// Coding parameters
struct StepSize {
    int expn = 0, mant = 0;
};

struct CompParams {  // COD/COC/QCD/QCC/RGN for one component of a tile
    int numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
    int prcw[33], prch[33];
    int qntsty = 0, numgbits = 0;
    StepSize steps[3 * 33 - 2];
    int roishift = 0;
};

struct Poc {
    int resno0, compno0, layno1, resno1, compno1, prg;
};

struct TileParams {
    int csty = 0, prg = 0, numlayers = 0, mct = 0;
    std::vector<CompParams> comps;
    std::vector<Poc> pocs;
};

struct Comp {
    int dx, dy, prec, sgnd;
};

struct Tile {
    TileParams params;
    std::vector<uint8_t> data;  // the bodies of its tile-parts, in order
    int parts = 0, tnsot = 0;  // tile-parts read, and how many TNsot says
    bool seen = false;
};

struct Codestream {
    int64_t x0, y0, x1, y1, tx0, ty0, tdx, tdy;
    int ntx = 0, nty = 0;
    std::vector<Comp> comps;
    TileParams defaults;
    std::vector<Tile> tiles;
    int64_t features = 0;
    bool cod_seen = false, qcd_seen = false;
};

class Reader {
public:
    Reader(const uint8_t* p, int64_t n) : p_(p), n_(n) {}
    int64_t pos() const { return pos_; }
    int64_t left() const { return n_ - pos_; }
    void seek(int64_t pos) { pos_ = pos; }
    void need(int64_t k) const {
        if (pos_ + k > n_) corrupt("the codestream ends inside a marker segment");
    }
    uint32_t u8() { need(1); return p_[pos_++]; }
    uint32_t u16() { need(2); uint32_t v = (p_[pos_] << 8) | p_[pos_ + 1]; pos_ += 2; return v; }
    uint32_t u32() { uint32_t hi = u16(); return (hi << 16) | u16(); }
    const uint8_t* at(int64_t pos) const { return p_ + pos; }

private:
    const uint8_t* p_;
    int64_t n_, pos_ = 0;
};

void read_spcod(Reader& r, int64_t end, CompParams& c, bool precincts, Codestream& cs) {
    c.numres = int(r.u8()) + 1;
    if (c.numres > 33) corrupt("more than 32 decomposition levels");
    c.cblkw = int(r.u8()) + 2;
    c.cblkh = int(r.u8()) + 2;
    if (c.cblkw > 10 || c.cblkh > 10 || c.cblkw + c.cblkh > 12) corrupt("a code-block size out of range");
    c.cblksty = int(r.u8());
    if (c.cblksty & 0xC0) refuse("high-throughput (HTJ2K) or mixed code-blocks");
    c.qmfbid = int(r.u8());
    if (c.qmfbid > 1) refuse("a Part 2 wavelet kernel");
    for (int i = 0; i < c.numres; ++i) {
        if (precincts) {
            uint32_t b = r.u8();
            c.prcw[i] = int(b & 15);
            c.prch[i] = int(b >> 4);
            if (i > 0 && (c.prcw[i] == 0 || c.prch[i] == 0)) corrupt("a precinct size of 1 above resolution 0");
        } else {
            c.prcw[i] = c.prch[i] = 15;
        }
    }
    if (precincts) cs.features |= F_PRECINCTS;
    if (r.pos() > end) corrupt("a COD or COC segment too short");
    static const int64_t styles[6] = {F_BYPASS, F_RESET, F_TERMALL, F_VSC, F_PTERM, F_SEGSYM};
    for (int i = 0; i < 6; ++i) {
        if (c.cblksty & (1 << i)) cs.features |= styles[i];
    }
    if (c.qmfbid == 0) cs.features |= F_IRREVERSIBLE;
}

void read_sqcd(Reader& r, int64_t end, CompParams& c) {
    uint32_t s = r.u8();
    c.qntsty = int(s & 31);
    c.numgbits = int(s >> 5);
    if (c.qntsty > 2) corrupt("an unknown quantisation style");
    int n;
    if (c.qntsty == 0) n = int(end - r.pos());
    else if (c.qntsty == 1) n = 1;
    else n = int((end - r.pos()) / 2);
    if (n > 3 * 33 - 2) corrupt("too many step sizes");
    for (int i = 0; i < n; ++i) {
        if (c.qntsty == 0) {
            c.steps[i].expn = int(r.u8() >> 3);
            c.steps[i].mant = 0;
        } else {
            uint32_t v = r.u16();
            c.steps[i].expn = int(v >> 11);
            c.steps[i].mant = int(v & 0x7ff);
        }
    }
    if (c.qntsty == 1) {  // scalar derived: OpenJPEG's j2k.c rule
        for (int b = 1; b < 3 * 33 - 2; ++b) {
            int e = c.steps[0].expn - (b - 1) / 3;
            c.steps[b].expn = e > 0 ? e : 0;
            c.steps[b].mant = c.steps[0].mant;
        }
    }
}

int read_compno(Reader& r, const Codestream& cs) {
    int compno = cs.comps.size() <= 256 ? int(r.u8()) : int(r.u16());
    if (compno >= int(cs.comps.size())) corrupt("a component index out of range");
    return compno;
}

// One marker segment of the main header (tile == nullptr) or of a
// tile-part header.
void read_segment(Reader& r, uint32_t marker, int64_t end, Codestream& cs, Tile* tile, bool first_part) {
    TileParams& tp = tile ? tile->params : cs.defaults;
    const bool body = !tile || first_part;  // COD/COC/QCD/QCC/RGN: first tile-part only
    switch (marker) {
    case 0xFF52: {  // COD
        if (!body) corrupt("COD in a later tile-part");
        uint32_t scod = r.u8();
        tp.csty = int(scod);
        tp.prg = int(r.u8());
        tp.numlayers = int(r.u16());
        tp.mct = int(r.u8());
        if (tp.prg > 4) corrupt("an unknown progression order");
        if (tp.numlayers == 0) corrupt("no quality layers");
        if (tp.mct > 1) refuse("a Part 2 component transform");
        CompParams c = tp.comps[0];
        read_spcod(r, end, c, scod & 1, cs);
        for (auto& comp : tp.comps) {  // COD applies to every component (j2k.c)
            int qntsty = comp.qntsty, numgbits = comp.numgbits, roishift = comp.roishift;
            StepSize steps[3 * 33 - 2];
            std::memcpy(steps, comp.steps, sizeof(steps));
            comp = c;
            comp.qntsty = qntsty;
            comp.numgbits = numgbits;
            comp.roishift = roishift;
            std::memcpy(comp.steps, steps, sizeof(steps));
        }
        if (scod & 2) cs.features |= F_SOP;
        if (scod & 4) cs.features |= F_EPH;
        if (tp.numlayers > 1) cs.features |= F_LAYERS;
        if (tp.mct) cs.features |= F_MCT;
        if (!tile) cs.cod_seen = true;
        break;
    }
    case 0xFF53: {  // COC
        if (!body) corrupt("COC in a later tile-part");
        int compno = read_compno(r, cs);
        uint32_t scoc = r.u8();
        CompParams& c = tp.comps[compno];
        CompParams n = c;
        read_spcod(r, end, n, scoc & 1, cs);
        c.numres = n.numres; c.cblkw = n.cblkw; c.cblkh = n.cblkh; c.cblksty = n.cblksty;
        c.qmfbid = n.qmfbid;
        std::memcpy(c.prcw, n.prcw, sizeof(c.prcw));
        std::memcpy(c.prch, n.prch, sizeof(c.prch));
        cs.features |= F_COC;
        break;
    }
    case 0xFF5C: {  // QCD
        if (!body) corrupt("QCD in a later tile-part");
        CompParams q;
        read_sqcd(r, end, q);
        for (auto& comp : tp.comps) {
            comp.qntsty = q.qntsty;
            comp.numgbits = q.numgbits;
            std::memcpy(comp.steps, q.steps, sizeof(q.steps));
        }
        if (!tile) cs.qcd_seen = true;
        break;
    }
    case 0xFF5D: {  // QCC
        if (!body) corrupt("QCC in a later tile-part");
        int compno = read_compno(r, cs);
        CompParams q;
        read_sqcd(r, end, q);
        CompParams& c = tp.comps[compno];
        c.qntsty = q.qntsty;
        c.numgbits = q.numgbits;
        std::memcpy(c.steps, q.steps, sizeof(q.steps));
        cs.features |= F_QCC;
        break;
    }
    case 0xFF5E: {  // RGN
        if (!body) corrupt("RGN in a later tile-part");
        int compno = read_compno(r, cs);
        if (r.u8() != 0) corrupt("an RGN style other than max-shift");
        tp.comps[compno].roishift = int(r.u8());
        cs.features |= F_RGN;
        break;
    }
    case 0xFF5F: {  // POC
        size_t csize = cs.comps.size() <= 256 ? 1 : 2;
        int64_t n = (end - r.pos()) / int64_t(5 + 2 * csize);
        if (n <= 0) corrupt("an empty POC segment");
        for (int64_t i = 0; i < n; ++i) {
            Poc p;
            p.resno0 = int(r.u8());
            p.compno0 = int(csize == 1 ? r.u8() : r.u16());
            p.layno1 = int(r.u16());
            p.resno1 = int(r.u8());
            p.compno1 = int(csize == 1 ? r.u8() : r.u16());
            if (p.compno1 == 0) p.compno1 = csize == 1 ? 256 : 16384;
            p.prg = int(r.u8());
            if (p.prg > 4) corrupt("an unknown progression order in POC");
            p.compno1 = std::min(p.compno1, int(cs.comps.size()));
            tp.pocs.push_back(p);
        }
        cs.features |= F_POC;
        break;
    }
    case 0xFF60:  // PPM
        refuse("packed packet headers (PPM)");
    case 0xFF61:  // PPT
        refuse("packed packet headers (PPT)");
    case 0xFF55: cs.features |= F_TLM; break;
    case 0xFF57: cs.features |= F_PLM; break;
    case 0xFF58: cs.features |= F_PLT; break;
    case 0xFF63: cs.features |= F_CRG; break;
    case 0xFF64: cs.features |= F_COM; break;
    default: break;  // unknown markers are skipped, as OpenJPEG skips them
    }
}

// SOC and SIZ: the image, tile grid and components.
void read_siz(Reader& r, Codestream& cs) {
    if (r.left() < 4 || r.u16() != 0xFF4F) corrupt("no SOC marker");
    if (r.u16() != 0xFF51) corrupt("no SIZ marker after SOC");
    {
        int64_t start = r.pos();
        uint32_t lsiz = r.u16();
        uint32_t rsiz = r.u16();
        if (rsiz & 0x4000) refuse("a high-throughput (HTJ2K) codestream");
        if (rsiz & 0x8000) refuse("Part 2 extensions");
        cs.x1 = r.u32(); cs.y1 = r.u32(); cs.x0 = r.u32(); cs.y0 = r.u32();
        cs.tdx = r.u32(); cs.tdy = r.u32(); cs.tx0 = r.u32(); cs.ty0 = r.u32();
        uint32_t ncomp = r.u16();
        if (ncomp == 0 || ncomp > 16384) corrupt("a component count out of range");
        if (lsiz != 38 + 3 * ncomp) corrupt("a SIZ length that does not fit its components");
        if (cs.x0 >= cs.x1 || cs.y0 >= cs.y1) corrupt("an empty image area");
        if (cs.tdx == 0 || cs.tdy == 0) corrupt("a tile size of 0");
        if (cs.tx0 > cs.x0 || cs.ty0 > cs.y0 || cs.tx0 + cs.tdx <= cs.x0 || cs.ty0 + cs.tdy <= cs.y0)
            corrupt("a tile grid that does not cover the image");
        for (uint32_t i = 0; i < ncomp; ++i) {
            Comp c;
            uint32_t s = r.u8();
            c.prec = int(s & 0x7f) + 1;
            c.sgnd = int(s >> 7);
            c.dx = int(r.u8());
            c.dy = int(r.u8());
            if (c.prec > 38) corrupt("a component precision over 38 bits");
            if (c.dx == 0 || c.dy == 0) corrupt("a component subsampling of 0");
            cs.comps.push_back(c);
        }
        r.seek(start + lsiz);
        int64_t ntx = ceildiv(cs.x1 - cs.tx0, cs.tdx), nty = ceildiv(cs.y1 - cs.ty0, cs.tdy);
        if (ntx * nty > 65535) corrupt("more than 65535 tiles");
        cs.ntx = int(ntx);
        cs.nty = int(nty);
        cs.defaults.comps.resize(ncomp);
        cs.tiles.resize(size_t(ntx * nty));
        if (ntx * nty > 1) cs.features |= F_TILES;
    }
}

Codestream parse(const uint8_t* data, int64_t len) {
    Reader r(data, len);
    Codestream cs;
    read_siz(r, cs);
    // Main header
    for (;;) {
        uint32_t marker = r.u16();
        if (marker == 0xFF90) break;
        if (marker < 0xFF00) corrupt("a main header marker expected");
        int64_t start = r.pos();
        int64_t lseg = r.u16();
        if (lseg < 2) corrupt("a marker segment length under 2");
        r.need(lseg - 2);
        read_segment(r, marker, start + lseg, cs, nullptr, true);
        r.seek(start + lseg);
    }
    if (!cs.cod_seen) corrupt("no COD marker in the main header");
    if (!cs.qcd_seen) corrupt("no QCD marker in the main header");
    // Tile-parts
    int64_t sot = r.pos() - 2;
    for (;;) {
        r.seek(sot + 2);
        int64_t lsot = r.u16();
        if (lsot != 10) corrupt("a SOT length other than 10");
        uint32_t isot = r.u16();
        int64_t psot = r.u32();
        r.u8();  // TPsot
        int tnsot = int(r.u8());
        if (isot >= cs.tiles.size()) corrupt("a tile index out of range");
        Tile& tile = cs.tiles[isot];
        int64_t part_end;
        if (psot == 0) {  // the last tile-part runs to EOC
            part_end = len;
            if (len >= 2 && data[len - 2] == 0xFF && data[len - 1] == 0xD9) part_end = len - 2;
            cs.features |= F_PSOT0;
        } else {
            if (psot < 14) corrupt("a tile-part shorter than its header");
            part_end = sot + psot;
            if (part_end > len) corrupt("the codestream ends inside a tile-part");
        }
        const bool first = !tile.seen;
        if (first) {
            tile.params = cs.defaults;
            tile.seen = true;
        } else {
            cs.features |= F_TILEPARTS;
        }
        tile.parts++;
        if (tnsot) tile.tnsot = tnsot;
        for (;;) {
            uint32_t marker = r.u16();
            if (marker == 0xFF93) break;
            if (marker < 0xFF00) corrupt("a tile-part header marker expected");
            int64_t start = r.pos();
            int64_t lseg = r.u16();
            if (lseg < 2 || start + lseg > part_end) corrupt("a marker segment past its tile-part");
            read_segment(r, marker, start + lseg, cs, &tile, first);
            r.seek(start + lseg);
        }
        if (r.pos() > part_end) corrupt("a tile-part header past its tile-part");
        tile.data.insert(tile.data.end(), data + r.pos(), data + part_end);
        if (psot == 0) break;
        // OpenJPEG reads the next marker: a stream that ends here, without
        // EOC, is "too short"
        if (part_end + 2 > len) corrupt("the codestream ends without EOC");
        r.seek(part_end);
        uint32_t next = r.u16();
        if (next == 0xFFD9) break;
        if (next != 0xFF90) {
            // OpenJPEG stops at another marker once every tile is whole
            bool whole = true;
            for (const Tile& t : cs.tiles) whole = whole && t.seen && t.tnsot && t.parts == t.tnsot;
            if (whole) break;
            corrupt("neither SOT nor EOC after a tile-part");
        }
        sot = part_end;
    }
    for (const Tile& t : cs.tiles) {
        // OpenJPEG leaves such a tile's samples at 0 and OpenCV returns
        // the page; it is not read here (a page is read whole or not at all)
        if (!t.seen) refuse("a tile without tile-parts");
    }
    return cs;
}

// ---------------------------------------------------------------------
// Tier 1: the MQ decoder (Annex C)
struct QeState {
    uint32_t qe;
    uint8_t nmps, nlps, sw;
};

const QeState kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19 };

struct Mq {
    const uint8_t* bp;  // the segment, followed by two 0xFF bytes
    uint32_t a, c, ct;
    uint8_t state[NUM_CTX], mps[NUM_CTX];

    void reset_states() {
        std::memset(state, 0, sizeof(state));
        std::memset(mps, 0, sizeof(mps));
        state[CTX_UNI] = 46;
        state[CTX_AGG] = 3;
        state[CTX_ZC] = 4;
    }
    void bytein() {  // C.3.4, as OpenJPEG's opj_mqc_bytein
        if (bp[0] == 0xFF) {
            if (bp[1] > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                bp++;
                c += uint32_t(bp[0]) << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += uint32_t(bp[0]) << 8;
            ct = 8;
        }
    }
    void init(const uint8_t* p, uint32_t len) {  // C.3.5
        bp = p;
        c = len == 0 ? (0xFFu << 16) : (uint32_t(p[0]) << 16);
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while ((a & 0x8000) == 0);
    }
    int decode(int cx) {  // C.3.2
        const QeState& s = kQe[state[cx]];
        int d;
        a -= s.qe;
        if ((c >> 16) < s.qe) {
            if (a < s.qe) {
                d = mps[cx];
                state[cx] = s.nmps;
            } else {
                d = 1 - mps[cx];
                if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
                state[cx] = s.nlps;
            }
            a = s.qe;
            renorm();
        } else {
            c -= s.qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < s.qe) {
                    d = 1 - mps[cx];
                    if (s.sw) mps[cx] = uint8_t(1 - mps[cx]);
                    state[cx] = s.nlps;
                } else {
                    d = mps[cx];
                    state[cx] = s.nmps;
                }
                renorm();
            } else {
                d = mps[cx];
            }
        }
        return d;
    }
    // Raw (bypass) bits, as opj_mqc_raw_decode
    void raw_init(const uint8_t* p) {
        bp = p;
        c = 0;
        ct = 0;
    }
    int raw() {
        if (ct == 0) {
            if (c == 0xFF) {
                if (bp[0] > 0x8F) {
                    c = 0xFF;
                    ct = 8;
                } else {
                    c = bp[0];
                    bp++;
                    ct = 7;
                }
            } else {
                c = bp[0];
                bp++;
                ct = 8;
            }
        }
        ct--;
        return int((c >> ct) & 1);
    }
};

// ---------------------------------------------------------------------
// Tier 1: the coding passes (Annex D).  Each coefficient's flags word
// holds its neighbours' significance (and, for the four direct ones,
// their signs) so that the contexts are table lookups.
enum : uint32_t {
    S_NW = 1 << 0, S_N = 1 << 1, S_NE = 1 << 2, S_W = 1 << 3, S_E = 1 << 4,
    S_SW = 1 << 5, S_S = 1 << 6, S_SE = 1 << 7,
    NEG_N = 1 << 8, NEG_S = 1 << 9, NEG_W = 1 << 10, NEG_E = 1 << 11,
    SIG = 1 << 12, VISIT = 1 << 13, REFINE = 1 << 14,
    NEIGHBOURS = 0xFF,
    VSC_MASK = S_SW | S_S | S_SE | NEG_S,
};

uint8_t g_zc[4][256];
uint8_t g_sc[256];   // sign context, by the 4 significance and 4 sign bits
uint8_t g_spb[256];  // sign prediction bit, likewise
bool g_luts = false;

// The 8-bit index of the sign tables: N S W E significance, then signs.
inline uint32_t sign_index(uint32_t f) {
    return ((f & S_N) ? 1u : 0u) | ((f & S_S) ? 2u : 0u) | ((f & S_W) ? 4u : 0u) |
           ((f & S_E) ? 8u : 0u) | ((f >> 4) & 0xF0u);
}

void init_luts() {
    if (g_luts) return;
    for (int orient = 0; orient < 4; ++orient) {
        for (int f = 0; f < 256; ++f) {
            int h = ((f & S_W) != 0) + ((f & S_E) != 0);
            int v = ((f & S_N) != 0) + ((f & S_S) != 0);
            int d = ((f & S_NW) != 0) + ((f & S_NE) != 0) + ((f & S_SW) != 0) + ((f & S_SE) != 0);
            int n = 0;
            if (orient == 3) {  // HH
                int hv = h + v;
                if (d >= 3) n = 8;
                else if (d == 2) n = hv ? 7 : 6;
                else if (d == 1) n = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
                else n = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
            } else {
                if (orient == 1) std::swap(h, v);  // HL (horizontally high-pass)
                if (h == 2) n = 8;
                else if (h == 1) n = v ? 7 : d ? 6 : 5;
                else if (v == 2) n = 4;
                else if (v == 1) n = 3;
                else n = d >= 2 ? 2 : d == 1 ? 1 : 0;
            }
            g_zc[orient][f] = uint8_t(CTX_ZC + n);
        }
    }
    for (int i = 0; i < 256; ++i) {
        auto contrib = [&](int sig, int neg) { return !(i & sig) ? 0 : (i & neg) ? -1 : 1; };
        // bits: 1 N, 2 S, 4 W, 8 E significant; 16 N, 32 S, 64 W, 128 E negative
        int hc = contrib(4, 64) + contrib(8, 128);
        int vc = contrib(1, 16) + contrib(2, 32);
        hc = hc > 0 ? 1 : hc < 0 ? -1 : 0;
        vc = vc > 0 ? 1 : vc < 0 ? -1 : 0;
        int xorbit = (hc < 0 || (hc == 0 && vc < 0)) ? 1 : 0;
        if (hc < 0) { hc = -hc; vc = -vc; }
        int n = hc == 0 ? (vc == 0 ? 0 : 1) : (vc == -1 ? 2 : vc == 0 ? 3 : 4);
        g_sc[i] = uint8_t(CTX_SC + n);
        g_spb[i] = uint8_t(xorbit);
    }
    g_luts = true;
}

struct T1 {
    int w = 0, h = 0, stride = 0;
    std::vector<int32_t> data;
    std::vector<uint32_t> flags;  // (h + 2) x (w + 2), a border of zeros
    Mq mq;
    const uint8_t* zc = nullptr;
    bool vsc = false;

    void reset(int w_, int h_) {
        w = w_;
        h = h_;
        stride = w + 2;
        data.assign(size_t(w) * h, 0);
        flags.assign(size_t(stride) * (h + 2), 0);
    }
    uint32_t* flag(int x, int y) { return &flags[size_t(y + 1) * stride + x + 1]; }

    void set_significant(uint32_t* f, int negative) {
        uint32_t* n = f - stride;
        uint32_t* s = f + stride;
        n[-1] |= S_SE;
        n[0] |= S_S | (negative ? NEG_S : 0);
        n[1] |= S_SW;
        f[-1] |= S_E | (negative ? NEG_E : 0);
        f[0] |= SIG;
        f[1] |= S_W | (negative ? NEG_W : 0);
        s[-1] |= S_NE;
        s[0] |= S_N | (negative ? NEG_N : 0);
        s[1] |= S_NW;
    }
    // The flags that contexts see: in VSC mode the last row of a stripe
    // does not see the stripe below.
    uint32_t seen(const uint32_t* f, int y) const {
        return (vsc && ((y & 3) == 3 || y == h - 1)) ? (*f & ~VSC_MASK) : *f;
    }
    void decode_sign(uint32_t* f, uint32_t fl, int32_t* d, int32_t oneplushalf) {
        uint32_t si = sign_index(fl);
        int v = mq.decode(g_sc[si]) ^ g_spb[si];
        *d = v ? -oneplushalf : oneplushalf;
        set_significant(f, v);
    }

    void sigpass(int bpno, bool raw) {
        const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        for (int k = 0; k < h; k += 4) {
            for (int x = 0; x < w; ++x) {
                for (int y = k; y < k + 4 && y < h; ++y) {
                    uint32_t* f = flag(x, y);
                    uint32_t fl = seen(f, y);
                    if ((*f & (SIG | VISIT)) || !(fl & NEIGHBOURS)) continue;
                    int32_t* d = &data[size_t(y) * w + x];
                    if (raw) {
                        if (mq.raw()) {
                            int v = mq.raw();
                            *d = v ? -oneplushalf : oneplushalf;
                            set_significant(f, v);
                        }
                    } else if (mq.decode(zc[fl & NEIGHBOURS])) {
                        decode_sign(f, fl, d, oneplushalf);
                    }
                    *f |= VISIT;
                }
            }
        }
    }

    void refpass(int bpno, bool raw) {
        const int32_t poshalf = (1 << bpno) >> 1;
        for (int k = 0; k < h; k += 4) {
            for (int x = 0; x < w; ++x) {
                for (int y = k; y < k + 4 && y < h; ++y) {
                    uint32_t* f = flag(x, y);
                    if ((*f & (SIG | VISIT)) != SIG) continue;
                    int32_t* d = &data[size_t(y) * w + x];
                    int v;
                    if (raw) {
                        v = mq.raw();
                    } else {
                        uint32_t fl = seen(f, y);
                        int cx = (*f & REFINE) ? CTX_MAG + 2 : (fl & NEIGHBOURS) ? CTX_MAG + 1 : CTX_MAG;
                        v = mq.decode(cx);
                    }
                    *d += (v ^ (*d < 0)) ? poshalf : -poshalf;
                    *f |= REFINE;
                }
            }
        }
    }

    void clnpass(int bpno, bool segsym) {
        const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        for (int k = 0; k < h; k += 4) {
            for (int x = 0; x < w; ++x) {
                int runlen = 0;
                bool agg = false;
                if (k + 3 < h) {
                    agg = true;
                    for (int y = k; y < k + 4; ++y) {
                        uint32_t fl = seen(flag(x, y), y);
                        if (fl & (SIG | VISIT | NEIGHBOURS)) {
                            agg = false;
                            break;
                        }
                    }
                }
                if (agg) {
                    if (!mq.decode(CTX_AGG)) continue;
                    runlen = mq.decode(CTX_UNI);
                    runlen = (runlen << 1) | mq.decode(CTX_UNI);
                }
                for (int y = k + runlen; y < k + 4 && y < h; ++y) {
                    uint32_t* f = flag(x, y);
                    uint32_t fl = seen(f, y);
                    int32_t* d = &data[size_t(y) * w + x];
                    if (agg && y == k + runlen) {
                        decode_sign(f, fl, d, oneplushalf);
                    } else if (!(*f & (SIG | VISIT))) {
                        if (mq.decode(zc[fl & NEIGHBOURS])) decode_sign(f, fl, d, oneplushalf);
                    }
                    *f &= ~VISIT;
                }
            }
        }
        if (segsym) {
            for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
        }
    }
};

// ---------------------------------------------------------------------
// Tier 2 structures
struct TagTree {
    struct Node {
        int parent;
        int value, low;
    };
    std::vector<Node> nodes;

    void build(int w, int h) {
        nodes.clear();
        if (w <= 0 || h <= 0) return;
        std::vector<std::pair<int, int>> levels;
        int lw = w, lh = h;
        for (;;) {
            levels.push_back({lw, lh});
            if (lw == 1 && lh == 1) break;
            lw = (lw + 1) / 2;
            lh = (lh + 1) / 2;
        }
        size_t total = 0;
        for (auto& l : levels) total += size_t(l.first) * l.second;
        nodes.assign(total, Node{-1, 999, 0});
        size_t base = 0;
        for (size_t li = 0; li + 1 < levels.size(); ++li) {
            int cw = levels[li].first, ch = levels[li].second;
            size_t next = base + size_t(cw) * ch;
            int pw = levels[li + 1].first;
            for (int j = 0; j < ch; ++j) {
                for (int i = 0; i < cw; ++i) {
                    nodes[base + size_t(j) * cw + i].parent = int(next + size_t(j / 2) * pw + i / 2);
                }
            }
            base = next;
        }
    }
};

struct Bits {  // packet header bits (B.10.1), as opj_bio
    const uint8_t* p;
    const uint8_t* end;
    uint32_t buf = 0;
    int ct = 0;

    void bytein() {
        buf = (buf << 8) & 0xFFFF;
        ct = buf == 0xFF00 ? 7 : 8;
        if (p < end) buf |= *p++;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = n - 1; i >= 0; --i) v |= bit() << i;
        return v;
    }
    void align() {
        if ((buf & 0xFF) == 0xFF) bytein();
        ct = 0;
    }
};

int tagtree_decode(Bits& bits, TagTree& tree, int leaf, int threshold) {
    int stack[32];
    int sp = 0;
    int node = leaf;
    while (tree.nodes[node].parent >= 0) {
        stack[sp++] = node;
        node = tree.nodes[node].parent;
    }
    int low = 0;
    for (;;) {
        TagTree::Node& n = tree.nodes[node];
        if (low > n.low) n.low = low;
        else low = n.low;
        while (low < threshold && low < n.value) {
            if (bits.bit()) n.value = low;
            else ++low;
        }
        n.low = low;
        if (sp == 0) break;
        node = stack[--sp];
    }
    return tree.nodes[node].value < threshold ? 1 : 0;
}

struct Segment {
    int numpasses = 0, maxpasses = 0;
    int64_t len = 0;
};

struct CodeBlock {
    int x0, y0, x1, y1;
    int numbps = 0, numlenbits = 3;
    bool included = false;
    std::vector<Segment> segs;
    std::vector<uint8_t> data;
    int numnewpasses = 0;  // in the packet being read
    std::vector<std::pair<int, int64_t>> newsegs;  // (segment, bytes) in the packet being read
};

struct Precinct {  // one band's part of one precinct
    int x0, y0, x1, y1, cw = 0, ch = 0;
    std::vector<CodeBlock> cblks;
    TagTree incl, imsb;
};

struct Band {
    int bandno;  // 0 LL, 1 HL, 2 LH, 3 HH
    int64_t x0, y0, x1, y1;
    int numbps;
    float stepsize;
    std::vector<Precinct> precincts;
};

struct Resolution {
    int64_t x0, y0, x1, y1;
    int pw = 0, ph = 0, pdx = 15, pdy = 15;
    std::vector<Band> bands;
};

struct TileComp {
    int64_t x0, y0, x1, y1;
    int numres;
    std::vector<Resolution> res;
    std::vector<int32_t> idata;  // 5/3 path
    std::vector<float> fdata;    // 9/7 path
};

void init_segment(CodeBlock& cb, int cblksty, bool first) {
    Segment s;
    if (cblksty & 4) {
        s.maxpasses = 1;  // TERMALL
    } else if (cblksty & 1) {  // BYPASS
        if (first) s.maxpasses = 10;
        else {
            int prev = cb.segs.back().maxpasses;
            s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
        }
    } else {
        s.maxpasses = 109;
    }
    cb.segs.push_back(s);
}

int num_passes(Bits& b) {
    if (!b.bit()) return 1;
    if (!b.bit()) return 2;
    int n = int(b.read(2));
    if (n != 3) return 3 + n;
    n = int(b.read(5));
    if (n != 31) return 6 + n;
    return 37 + int(b.read(7));
}

inline int floorlog2(int v) {
    int l = 0;
    while (v > 1) { v >>= 1; ++l; }
    return l;
}

// ---------------------------------------------------------------------
// The tile
class TileDecoder {
public:
    TileDecoder(const Codestream& cs, Tile& tile, int tileno) : cs_(cs), tile_(tile), tp_(tile.params) {
        int p = tileno % cs.ntx, q = tileno / cs.ntx;
        tx0_ = std::max(cs.tx0 + p * cs.tdx, cs.x0);
        ty0_ = std::max(cs.ty0 + q * cs.tdy, cs.y0);
        tx1_ = std::min(cs.tx0 + (p + 1) * cs.tdx, cs.x1);
        ty1_ = std::min(cs.ty0 + (q + 1) * cs.tdy, cs.y1);
    }

    void decode() {
        build();
        read_packets();
        for (size_t c = 0; c < comps_.size(); ++c) decode_blocks(int(c));
        for (size_t c = 0; c < comps_.size(); ++c) inverse_dwt(int(c));
        inverse_mct();
    }

    // DC shift and clamp into the component planes (OpenJPEG's
    // opj_tcd_dc_level_shift_decode and opj_j2k_update_image_data).
    void store(std::vector<int32_t*>& planes, const std::vector<int64_t>& comp_x0,
               const std::vector<int64_t>& comp_y0, const std::vector<int64_t>& comp_w) {
        for (size_t c = 0; c < comps_.size(); ++c) {
            const TileComp& tc = comps_[c];
            const Comp& ic = cs_.comps[c];
            int64_t mn, mx;
            if (ic.sgnd) {
                mn = -(int64_t(1) << (ic.prec - 1));
                mx = (int64_t(1) << (ic.prec - 1)) - 1;
            } else {
                mn = 0;
                mx = (int64_t(1) << ic.prec) - 1;
            }
            int64_t shift = ic.sgnd ? 0 : (int64_t(1) << (ic.prec - 1));
            int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
            const bool real = tp_.comps[c].qmfbid == 0;
            for (int64_t y = 0; y < h; ++y) {
                int32_t* out = planes[c] + (tc.y0 - comp_y0[c] + y) * comp_w[c] + (tc.x0 - comp_x0[c]);
                for (int64_t x = 0; x < w; ++x) {
                    int64_t v;
                    if (real) {
                        float f = tc.fdata[size_t(y * w + x)];
                        if (f > float(INT32_MAX)) { out[x] = int32_t(mx); continue; }
                        if (f < float(INT32_MIN)) { out[x] = int32_t(mn); continue; }
                        v = int64_t(std::lrintf(f));
                    } else {
                        v = tc.idata[size_t(y * w + x)];
                    }
                    v += shift;
                    out[x] = int32_t(v < mn ? mn : v > mx ? mx : v);
                }
            }
        }
    }

private:
    const Codestream& cs_;
    Tile& tile_;
    const TileParams& tp_;
    int64_t tx0_, ty0_, tx1_, ty1_;
    std::vector<TileComp> comps_;

    void build() {
        comps_.resize(cs_.comps.size());
        for (size_t c = 0; c < comps_.size(); ++c) {
            const Comp& ic = cs_.comps[c];
            const CompParams& cp = tp_.comps[c];
            TileComp& tc = comps_[c];
            tc.x0 = ceildiv(tx0_, ic.dx);
            tc.y0 = ceildiv(ty0_, ic.dy);
            tc.x1 = ceildiv(tx1_, ic.dx);
            tc.y1 = ceildiv(ty1_, ic.dy);
            tc.numres = cp.numres;
            size_t n = size_t((tc.x1 - tc.x0) * (tc.y1 - tc.y0));
            if (cp.qmfbid == 1) tc.idata.assign(n, 0);
            else tc.fdata.assign(n, 0.0f);
            tc.res.resize(size_t(cp.numres));
            for (int r = 0; r < cp.numres; ++r) {
                Resolution& res = tc.res[size_t(r)];
                int level = cp.numres - 1 - r;
                res.x0 = ceildivpow2(tc.x0, level);
                res.y0 = ceildivpow2(tc.y0, level);
                res.x1 = ceildivpow2(tc.x1, level);
                res.y1 = ceildivpow2(tc.y1, level);
                res.pdx = cp.prcw[r];
                res.pdy = cp.prch[r];
                int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx;
                int64_t py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
                int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
                int64_t py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
                res.pw = res.x0 == res.x1 ? 0 : int((px1 - px0) >> res.pdx);
                res.ph = res.y0 == res.y1 ? 0 : int((py1 - py0) >> res.pdy);
                int64_t cbgx0, cbgy0;
                int cbgw, cbgh;
                if (r == 0) {
                    cbgx0 = px0; cbgy0 = py0; cbgw = res.pdx; cbgh = res.pdy;
                } else {
                    cbgx0 = ceildivpow2(px0, 1); cbgy0 = ceildivpow2(py0, 1);
                    cbgw = res.pdx - 1; cbgh = res.pdy - 1;
                }
                int cbw = std::min(cp.cblkw, cbgw), cbh = std::min(cp.cblkh, cbgh);
                int nbands = r == 0 ? 1 : 3;
                res.bands.resize(size_t(nbands));
                for (int b = 0; b < nbands; ++b) {
                    Band& band = res.bands[size_t(b)];
                    band.bandno = r == 0 ? 0 : b + 1;
                    if (r == 0) {
                        band.x0 = ceildivpow2(tc.x0, level);
                        band.y0 = ceildivpow2(tc.y0, level);
                        band.x1 = ceildivpow2(tc.x1, level);
                        band.y1 = ceildivpow2(tc.y1, level);
                    } else {
                        int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
                        band.x0 = ceildivpow2(tc.x0 - (xob << level), level + 1);
                        band.y0 = ceildivpow2(tc.y0 - (yob << level), level + 1);
                        band.x1 = ceildivpow2(tc.x1 - (xob << level), level + 1);
                        band.y1 = ceildivpow2(tc.y1 - (yob << level), level + 1);
                    }
                    int stepno = r == 0 ? 0 : 3 * (r - 1) + b + 1;
                    const StepSize& st = cp.steps[stepno];
                    // OpenJPEG 2.5's tcd.c: the 9/7 decoder takes no band
                    // gain (its inverse wavelet scales the high bands by
                    // 1.625732422 instead of 1/K).
                    int log2_gain = cp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
                    int rb = ic.prec + log2_gain;
                    band.stepsize = float((1.0 + st.mant / 2048.0) * std::pow(2.0, double(rb - st.expn)));
                    band.numbps = st.expn + cp.numgbits - 1;
                    int nprec = res.pw * res.ph;
                    band.precincts.resize(size_t(nprec));
                    for (int pno = 0; pno < nprec; ++pno) {
                        Precinct& pr = band.precincts[size_t(pno)];
                        int64_t gx0 = cbgx0 + int64_t(pno % res.pw) * (int64_t(1) << cbgw);
                        int64_t gy0 = cbgy0 + int64_t(pno / res.pw) * (int64_t(1) << cbgh);
                        int64_t gx1 = gx0 + (int64_t(1) << cbgw), gy1 = gy0 + (int64_t(1) << cbgh);
                        pr.x0 = int(std::max(gx0, band.x0));
                        pr.y0 = int(std::max(gy0, band.y0));
                        pr.x1 = int(std::min(gx1, band.x1));
                        pr.y1 = int(std::min(gy1, band.y1));
                        if (pr.x0 >= pr.x1 || pr.y0 >= pr.y1) {
                            pr.cw = pr.ch = 0;
                            continue;
                        }
                        int64_t bx0 = floordivpow2(pr.x0, cbw) << cbw;
                        int64_t by0 = floordivpow2(pr.y0, cbh) << cbh;
                        int64_t bx1 = ceildivpow2(pr.x1, cbw) << cbw;
                        int64_t by1 = ceildivpow2(pr.y1, cbh) << cbh;
                        pr.cw = int((bx1 - bx0) >> cbw);
                        pr.ch = int((by1 - by0) >> cbh);
                        pr.cblks.resize(size_t(pr.cw) * pr.ch);
                        for (int i = 0; i < pr.cw * pr.ch; ++i) {
                            CodeBlock& cb = pr.cblks[size_t(i)];
                            int64_t cx0 = bx0 + int64_t(i % pr.cw) * (int64_t(1) << cbw);
                            int64_t cy0 = by0 + int64_t(i / pr.cw) * (int64_t(1) << cbh);
                            cb.x0 = int(std::max<int64_t>(cx0, pr.x0));
                            cb.y0 = int(std::max<int64_t>(cy0, pr.y0));
                            cb.x1 = int(std::min<int64_t>(cx0 + (int64_t(1) << cbw), pr.x1));
                            cb.y1 = int(std::min<int64_t>(cy0 + (int64_t(1) << cbh), pr.y1));
                        }
                        pr.incl.build(pr.cw, pr.ch);
                        pr.imsb.build(pr.cw, pr.ch);
                    }
                }
            }
        }
    }

    // The packet order: OpenJPEG's pi.c iterators, one per POC entry
    // (or one for the whole tile), sharing one include table.
    struct Packet {
        int layno, resno, compno, precno;
    };

    std::vector<Packet> packet_order() {
        const int ncomp = int(comps_.size());
        int maxres = 0, maxprec = 0;
        for (auto& tc : comps_) {
            maxres = std::max(maxres, tc.numres);
            for (auto& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
        }
        const int nlayers = tp_.numlayers;
        std::vector<uint8_t> include(size_t(nlayers) * maxres * ncomp * std::max(maxprec, 1), 0);
        auto index = [&](int l, int r, int c, int p) {
            return ((size_t(l) * maxres + r) * ncomp + c) * std::max(maxprec, 1) + p;
        };
        std::vector<Packet> order;
        auto emit = [&](int l, int r, int c, int p) {
            size_t i = index(l, r, c, p);
            if (!include[i]) {
                include[i] = 1;
                order.push_back({l, r, c, p});
            }
        };
        std::vector<Poc> pocs = tp_.pocs;
        if (pocs.empty()) pocs.push_back({0, 0, nlayers, maxres, ncomp, tp_.prg});
        for (const Poc& poc : pocs) {
            int l1 = std::min(poc.layno1, nlayers), r0 = poc.resno0, r1 = std::min(poc.resno1, maxres);
            int c0 = poc.compno0, c1 = std::min(poc.compno1, ncomp);
            auto nprec = [&](int c, int r) { return comps_[size_t(c)].res[size_t(r)].pw * comps_[size_t(c)].res[size_t(r)].ph; };
            switch (poc.prg) {
            case 0:  // LRCP
                for (int l = 0; l < l1; ++l)
                    for (int r = r0; r < r1; ++r)
                        for (int c = c0; c < c1; ++c) {
                            if (r >= comps_[size_t(c)].numres) continue;
                            for (int p = 0; p < nprec(c, r); ++p) emit(l, r, c, p);
                        }
                break;
            case 1:  // RLCP
                for (int r = r0; r < r1; ++r)
                    for (int l = 0; l < l1; ++l)
                        for (int c = c0; c < c1; ++c) {
                            if (r >= comps_[size_t(c)].numres) continue;
                            for (int p = 0; p < nprec(c, r); ++p) emit(l, r, c, p);
                        }
                break;
            default:
                position_order(poc.prg, l1, r0, r1, c0, c1, emit);
            }
        }
        return order;
    }

    template <class Emit>
    void position_order(int prg, int l1, int r0, int r1, int c0, int c1, Emit& emit) {
        // dx, dy: the smallest precinct step on the reference grid
        uint64_t dx = 0, dy = 0;
        for (size_t c = 0; c < comps_.size(); ++c) {
            const TileComp& tc = comps_[c];
            for (int r = 0; r < tc.numres; ++r) {
                const Resolution& res = tc.res[size_t(r)];
                int level = tc.numres - 1 - r;
                if (res.pdx + level < 32) {
                    uint64_t v = uint64_t(cs_.comps[c].dx) << (res.pdx + level);
                    dx = dx ? std::min(dx, v) : v;
                }
                if (res.pdy + level < 32) {
                    uint64_t v = uint64_t(cs_.comps[c].dy) << (res.pdy + level);
                    dy = dy ? std::min(dy, v) : v;
                }
            }
        }
        if (dx == 0 || dy == 0) return;
        // One (component, resolution) at (x, y): the precinct that starts there.
        auto visit = [&](int c, int r, uint64_t x, uint64_t y) {
            const TileComp& tc = comps_[size_t(c)];
            if (r >= tc.numres) return;
            const Resolution& res = tc.res[size_t(r)];
            int level = tc.numres - 1 - r;
            uint64_t cdx = uint64_t(cs_.comps[size_t(c)].dx) << level;
            uint64_t cdy = uint64_t(cs_.comps[size_t(c)].dy) << level;
            uint64_t trx0 = uint64_t(ceildiv(tx0_, int64_t(cdx))), try0 = uint64_t(ceildiv(ty0_, int64_t(cdy)));
            uint64_t trx1 = uint64_t(ceildiv(tx1_, int64_t(cdx))), try1 = uint64_t(ceildiv(ty1_, int64_t(cdy)));
            int rpx = res.pdx + level, rpy = res.pdy + level;
            if (rpx >= 31 || rpy >= 31) return;
            if (!((y % (uint64_t(cs_.comps[size_t(c)].dy) << rpy) == 0) ||
                  (y == uint64_t(ty0_) && ((try0 << level) % (uint64_t(1) << rpy)))))
                return;
            if (!((x % (uint64_t(cs_.comps[size_t(c)].dx) << rpx) == 0) ||
                  (x == uint64_t(tx0_) && ((trx0 << level) % (uint64_t(1) << rpx)))))
                return;
            if (res.pw == 0 || res.ph == 0) return;
            if (trx0 == trx1 || try0 == try1) return;
            uint64_t prci = (ceildiv(int64_t(x), int64_t(cdx)) >> res.pdx) - (trx0 >> res.pdx);
            uint64_t prcj = (ceildiv(int64_t(y), int64_t(cdy)) >> res.pdy) - (try0 >> res.pdy);
            int p = int(prci + prcj * uint64_t(res.pw));
            for (int l = 0; l < l1; ++l) emit(l, r, c, p);
        };
        const uint64_t x0 = uint64_t(tx0_), x1 = uint64_t(tx1_), y0 = uint64_t(ty0_), y1 = uint64_t(ty1_);
        auto next = [](uint64_t v, uint64_t d) { return v + (d - v % d); };
        if (prg == 2) {  // RPCL
            for (int r = r0; r < r1; ++r)
                for (uint64_t y = y0; y < y1; y = next(y, dy))
                    for (uint64_t x = x0; x < x1; x = next(x, dx))
                        for (int c = c0; c < c1; ++c) visit(c, r, x, y);
        } else if (prg == 3) {  // PCRL
            for (uint64_t y = y0; y < y1; y = next(y, dy))
                for (uint64_t x = x0; x < x1; x = next(x, dx))
                    for (int c = c0; c < c1; ++c)
                        for (int r = r0; r < r1; ++r) visit(c, r, x, y);
        } else {  // CPRL
            for (int c = c0; c < c1; ++c) {
                // CPRL steps by the component's own precincts (pi.c)
                uint64_t cdxs = 0, cdys = 0;
                const TileComp& tc = comps_[size_t(c)];
                for (int r = 0; r < tc.numres; ++r) {
                    const Resolution& res = tc.res[size_t(r)];
                    int level = tc.numres - 1 - r;
                    if (res.pdx + level < 32) {
                        uint64_t v = uint64_t(cs_.comps[size_t(c)].dx) << (res.pdx + level);
                        cdxs = cdxs ? std::min(cdxs, v) : v;
                    }
                    if (res.pdy + level < 32) {
                        uint64_t v = uint64_t(cs_.comps[size_t(c)].dy) << (res.pdy + level);
                        cdys = cdys ? std::min(cdys, v) : v;
                    }
                }
                if (cdxs == 0 || cdys == 0) continue;
                for (uint64_t y = y0; y < y1; y = next(y, cdys))
                    for (uint64_t x = x0; x < x1; x = next(x, cdxs))
                        for (int r = r0; r < r1; ++r) visit(c, r, x, y);
            }
        }
    }

    void read_packets() {
        const std::vector<uint8_t>& d = tile_.data;
        const uint8_t* base = d.data();
        const int64_t n = int64_t(d.size());
        int64_t pos = 0;
        for (const Packet& pk : packet_order()) {
            TileComp& tc = comps_[size_t(pk.compno)];
            Resolution& res = tc.res[size_t(pk.resno)];
            const CompParams& cp = tp_.comps[size_t(pk.compno)];
            if (pos >= n) corrupt("the tile's data ends before its last packet");
            if ((tp_.csty & 2) && pos + 6 <= n && base[pos] == 0xFF && base[pos + 1] == 0x91) pos += 6;
            Bits bits{base + pos, base + n};
            bool present = bits.bit() != 0;
            if (present) {
                for (Band& band : res.bands) {
                    Precinct& pr = band.precincts[size_t(pk.precno)];
                    for (int i = 0; i < pr.cw * pr.ch; ++i) {
                        CodeBlock& cb = pr.cblks[size_t(i)];
                        cb.numnewpasses = 0;
                        cb.newsegs.clear();
                        bool included;
                        if (!cb.included) included = tagtree_decode(bits, pr.incl, i, pk.layno + 1) != 0;
                        else included = bits.bit() != 0;
                        if (!included) continue;
                        if (!cb.included) {
                            int z = 0;
                            while (!tagtree_decode(bits, pr.imsb, i, z)) {
                                if (++z > 74) corrupt("a zero bit-plane count out of range");
                            }
                            cb.numbps = band.numbps + 1 - z;
                            cb.numlenbits = 3;
                        }
                        cb.numnewpasses = num_passes(bits);
                        int incr = 0;
                        while (bits.bit()) {
                            if (++incr > 32) corrupt("a length-bit increment out of range");
                        }
                        cb.numlenbits += incr;
                        int segno;
                        if (cb.segs.empty()) {
                            init_segment(cb, cp.cblksty, true);
                            segno = 0;
                        } else {
                            segno = int(cb.segs.size()) - 1;
                            if (cb.segs[size_t(segno)].numpasses == cb.segs[size_t(segno)].maxpasses) {
                                init_segment(cb, cp.cblksty, false);
                                ++segno;
                            }
                        }
                        int left = cb.numnewpasses;
                        for (;;) {
                            Segment& s = cb.segs[size_t(segno)];
                            int np = std::min(s.maxpasses - s.numpasses, left);
                            int nbits = cb.numlenbits + floorlog2(np);
                            if (nbits > 32) corrupt("a segment length of more than 32 bits");
                            int64_t len = int64_t(bits.read(nbits));  // up to 2^32 - 1
                            cb.newsegs.push_back({segno, len});
                            s.numpasses += np;
                            left -= np;
                            if (left <= 0) break;
                            init_segment(cb, cp.cblksty, false);
                            ++segno;
                        }
                        cb.included = true;
                    }
                }
            }
            bits.align();
            pos = bits.p - base;
            if (tp_.csty & 4) {
                if (pos + 2 <= n && base[pos] == 0xFF && base[pos + 1] == 0x92) pos += 2;
            }
            if (!present) continue;
            for (Band& band : res.bands) {
                Precinct& pr = band.precincts[size_t(pk.precno)];
                for (CodeBlock& cb : pr.cblks) {
                    for (auto& ns : cb.newsegs) {
                        if (ns.second > n - pos) corrupt("a code-block's data runs past its tile");
                        cb.data.insert(cb.data.end(), base + pos, base + pos + ns.second);
                        cb.segs[size_t(ns.first)].len += ns.second;
                        pos += ns.second;
                    }
                    cb.newsegs.clear();
                }
            }
        }
    }

    void decode_blocks(int c) {
        TileComp& tc = comps_[size_t(c)];
        const CompParams& cp = tp_.comps[size_t(c)];
        const int64_t tw = tc.x1 - tc.x0;
        T1 t1;
        for (int r = 0; r < tc.numres; ++r) {
            Resolution& res = tc.res[size_t(r)];
            for (Band& band : res.bands) {
                // the band's place in the tile-component buffer (Mallat layout)
                int64_t offx = 0, offy = 0;
                if (r > 0) {
                    const Resolution& prev = tc.res[size_t(r - 1)];
                    if (band.bandno & 1) offx = prev.x1 - prev.x0;
                    if (band.bandno & 2) offy = prev.y1 - prev.y0;
                }
                for (Precinct& pr : band.precincts) {
                    for (CodeBlock& cb : pr.cblks) {
                        int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
                        if (w <= 0 || h <= 0) continue;
                        t1.reset(w, h);
                        if (!cb.segs.empty()) decode_block(t1, cb, band.bandno, cp);
                        // RGN max-shift (t1.c)
                        if (cp.roishift) {
                            if (cp.roishift >= 31) {
                                std::fill(t1.data.begin(), t1.data.end(), 0);
                            } else {
                                int32_t thresh = int32_t(1) << cp.roishift;
                                for (int32_t& v : t1.data) {
                                    int32_t mag = v < 0 ? -v : v;
                                    if (mag >= thresh) {
                                        mag >>= cp.roishift;
                                        v = v < 0 ? -mag : mag;
                                    }
                                }
                            }
                        }
                        int64_t x = cb.x0 - band.x0 + offx, y = cb.y0 - band.y0 + offy;
                        if (cp.qmfbid == 1) {
                            for (int j = 0; j < h; ++j) {
                                int32_t* out = &tc.idata[size_t((y + j) * tw + x)];
                                const int32_t* in = &t1.data[size_t(j) * w];
                                for (int i = 0; i < w; ++i) out[i] = in[i] / 2;
                            }
                        } else {
                            const float step = 0.5f * band.stepsize;
                            for (int j = 0; j < h; ++j) {
                                float* out = &tc.fdata[size_t((y + j) * tw + x)];
                                const int32_t* in = &t1.data[size_t(j) * w];
                                for (int i = 0; i < w; ++i) out[i] = float(in[i]) * step;
                            }
                        }
                    }
                }
            }
        }
    }

    static void decode_block(T1& t1, const CodeBlock& cb, int orient, const CompParams& cp) {
        init_luts();
        t1.zc = g_zc[orient];
        t1.vsc = (cp.cblksty & 8) != 0;
        int bpno_plus_one = cp.roishift + cb.numbps;
        if (bpno_plus_one >= 31) corrupt("a code-block with more than 30 bit-planes");
        int passtype = 2;
        t1.mq.reset_states();
        size_t offset = 0;
        std::vector<uint8_t> segbuf;
        for (const Segment& seg : cb.segs) {
            bool raw = bpno_plus_one <= cb.numbps - 4 && passtype < 2 && (cp.cblksty & 1);
            // each segment is read up to its end, then the two 0xFF bytes
            // of OpenJPEG's artificial marker
            segbuf.assign(cb.data.begin() + long(offset), cb.data.begin() + long(offset + size_t(seg.len)));
            segbuf.push_back(0xFF);
            segbuf.push_back(0xFF);
            if (raw) t1.mq.raw_init(segbuf.data());
            else t1.mq.init(segbuf.data(), uint32_t(seg.len));
            offset += size_t(seg.len);
            for (int p = 0; p < seg.numpasses && bpno_plus_one >= 1; ++p) {
                switch (passtype) {
                case 0: t1.sigpass(bpno_plus_one, raw); break;
                case 1: t1.refpass(bpno_plus_one, raw); break;
                case 2: t1.clnpass(bpno_plus_one, (cp.cblksty & 32) != 0); break;
                }
                if ((cp.cblksty & 2) && !raw) t1.mq.reset_states();
                if (++passtype == 3) {
                    passtype = 0;
                    bpno_plus_one--;
                }
            }
        }
    }

    // ------------------------------------------------------------------
    // Inverse wavelets, as OpenJPEG 2.5's dwt.c: per level, every row
    // (horizontal) and then every column (vertical).  A signal holds
    // `lanes` independent columns side by side (the vertical pass takes
    // kLanes columns at a time, as OpenJPEG's does); its samples are
    // interleaved, the low ones at positions cas + 2i.
    static constexpr int kLanes = 8;

    template <int lanes>
    static void idwt53(int32_t* x, int sn, int dn, int cas) {
        const int len = sn + dn;
        if (cas == 0) {
            if (len <= 1) return;
        } else if (len == 1) {
            for (int k = 0; k < lanes; ++k) x[k] /= 2;
            return;
        }
        // T.800 F.3.8.2 with the whole-sample symmetric extension
        auto mirror = [len](int p) { return p < 0 ? -p : p >= len ? 2 * (len - 1) - p : p; };
        for (int p = cas; p < len; p += 2) {  // the low samples
            const int32_t* l = x + mirror(p - 1) * lanes;
            const int32_t* r = x + mirror(p + 1) * lanes;
            int32_t* t = x + p * lanes;
            for (int k = 0; k < lanes; ++k) t[k] -= (l[k] + r[k] + 2) >> 2;
        }
        for (int p = 1 - cas; p < len; p += 2) {  // the high samples
            const int32_t* l = x + mirror(p - 1) * lanes;
            const int32_t* r = x + mirror(p + 1) * lanes;
            int32_t* t = x + p * lanes;
            for (int k = 0; k < lanes; ++k) t[k] += (l[k] + r[k]) >> 1;
        }
    }

    // opj_v8dwt_decode: the scaling, then four lifting steps.
    template <int lanes>
    static void idwt97(float* w, int sn, int dn, int cas) {
        if (cas == 0) {
            if (!(dn > 0 || sn > 1)) return;
        } else {
            if (!(sn > 0 || dn > 1)) return;
        }
        const float K = 1.230174105f, two_invK = 1.625732422f;
        const float alpha = -1.586134342f, beta = -0.052980118f, gamma = 0.882911075f, delta = 0.443506852f;
        const int a = cas, b = 1 - cas;
        for (int i = 0; i < sn; ++i) {
            float* t = w + (a + 2 * i) * lanes;
            for (int k = 0; k < lanes; ++k) t[k] = t[k] * K;
        }
        for (int i = 0; i < dn; ++i) {
            float* t = w + (b + 2 * i) * lanes;
            for (int k = 0; k < lanes; ++k) t[k] = t[k] * two_invK;
        }
        step2<lanes>(w + b * lanes, w + (a + 1) * lanes, sn, std::min(sn, dn - a), -delta);
        step2<lanes>(w + a * lanes, w + (b + 1) * lanes, dn, std::min(dn, sn - b), -gamma);
        step2<lanes>(w + b * lanes, w + (a + 1) * lanes, sn, std::min(sn, dn - a), -beta);
        step2<lanes>(w + a * lanes, w + (b + 1) * lanes, dn, std::min(dn, sn - b), -alpha);
    }

    // opj_v8dwt_decode_step2: w[-1], w[1], w[3], ... += (left + right) * c
    template <int lanes>
    static void step2(float* l, float* w, int end, int m, float c) {
        int imax = std::min(end, m);
        float* fl = l;
        float* fw = w;
        for (int i = 0; i < imax; ++i) {
            for (int k = 0; k < lanes; ++k) fw[k - lanes] = fw[k - lanes] + ((fl[k] + fw[k]) * c);
            fl = fw;
            fw += 2 * lanes;
        }
        if (m < end) {
            c += c;
            for (int k = 0; k < lanes; ++k) fw[k - lanes] = fw[k - lanes] + fl[k] * c;
        }
    }

    // One level on data (stride w): rows, then columns kLanes at a time
    // (the last few one at a time).
    template <class T, void (*transform1)(T*, int, int, int), void (*transformN)(T*, int, int, int)>
    static void idwt_level(T* data, int64_t w, int rw, int rh, int hsn, int hcas, int vsn, int vcas,
                           std::vector<T>& buf) {
        const int hdn = rw - hsn, vdn = rh - vsn;
        buf.resize(size_t(std::max(rw, rh)) * kLanes);
        for (int j = 0; j < rh; ++j) {
            T* row = data + j * w;
            for (int i = 0; i < hsn; ++i) buf[size_t(hcas + 2 * i)] = row[i];
            for (int i = 0; i < hdn; ++i) buf[size_t(1 - hcas + 2 * i)] = row[hsn + i];
            transform1(buf.data(), hsn, hdn, hcas);
            std::memcpy(row, buf.data(), size_t(rw) * sizeof(T));
        }
        for (int i0 = 0; i0 < rw;) {
            const int lanes = rw - i0 >= kLanes ? kLanes : 1;
            T* col = data + i0;
            for (int j = 0; j < vsn; ++j)
                std::memcpy(&buf[size_t(vcas + 2 * j) * lanes], col + j * w, size_t(lanes) * sizeof(T));
            for (int j = 0; j < vdn; ++j)
                std::memcpy(&buf[size_t(1 - vcas + 2 * j) * lanes], col + (vsn + j) * w, size_t(lanes) * sizeof(T));
            (lanes == kLanes ? transformN : transform1)(buf.data(), vsn, vdn, vcas);
            for (int j = 0; j < rh; ++j)
                std::memcpy(col + j * w, &buf[size_t(j) * lanes], size_t(lanes) * sizeof(T));
            i0 += lanes;
        }
    }

    void inverse_dwt(int c) {
        TileComp& tc = comps_[size_t(c)];
        const int64_t w = tc.x1 - tc.x0;
        const bool real = tp_.comps[size_t(c)].qmfbid == 0;
        std::vector<int32_t> ibuf;
        std::vector<float> fbuf;
        for (int r = 1; r < tc.numres; ++r) {
            const Resolution& lo = tc.res[size_t(r - 1)];
            const Resolution& hi = tc.res[size_t(r)];
            const int rw = int(hi.x1 - hi.x0), rh = int(hi.y1 - hi.y0);
            const int hsn = int(lo.x1 - lo.x0), hcas = int(hi.x0 % 2);
            const int vsn = int(lo.y1 - lo.y0), vcas = int(hi.y0 % 2);
            if (real) {
                idwt_level<float, idwt97<1>, idwt97<kLanes>>(tc.fdata.data(), w, rw, rh, hsn, hcas,
                                                             vsn, vcas, fbuf);
            } else {
                idwt_level<int32_t, idwt53<1>, idwt53<kLanes>>(tc.idata.data(), w, rw, rh, hsn, hcas,
                                                               vsn, vcas, ibuf);
            }
        }
    }

    void inverse_mct() {
        if (tp_.mct != 1 || comps_.size() < 3) return;
        for (int c = 1; c < 3; ++c) {
            if (comps_[size_t(c)].x1 - comps_[size_t(c)].x0 != comps_[0].x1 - comps_[0].x0 ||
                comps_[size_t(c)].y1 - comps_[size_t(c)].y0 != comps_[0].y1 - comps_[0].y0)
                corrupt("a component transform over components of unequal size");
        }
        size_t n = size_t((comps_[0].x1 - comps_[0].x0) * (comps_[0].y1 - comps_[0].y0));
        if (tp_.comps[0].qmfbid == 1) {
            for (int c = 1; c < 3; ++c) {
                if (tp_.comps[size_t(c)].qmfbid != 1) corrupt("a reversible transform over irreversible components");
            }
            int32_t* c0 = comps_[0].idata.data();
            int32_t* c1 = comps_[1].idata.data();
            int32_t* c2 = comps_[2].idata.data();
            for (size_t i = 0; i < n; ++i) {
                int32_t y = c0[i], u = c1[i], v = c2[i];
                int32_t g = y - ((u + v) >> 2);
                c0[i] = v + g;
                c1[i] = g;
                c2[i] = u + g;
            }
        } else {
            for (int c = 1; c < 3; ++c) {
                if (tp_.comps[size_t(c)].qmfbid != 0) corrupt("an irreversible transform over reversible components");
            }
            float* c0 = comps_[0].fdata.data();
            float* c1 = comps_[1].fdata.data();
            float* c2 = comps_[2].fdata.data();
            for (size_t i = 0; i < n; ++i) {
                float y = c0[i], u = c1[i], v = c2[i];
                float r = y + (v * 1.402f);
                float g = y - (u * 0.34413f) - (v * 0.71414f);
                float b = y + (u * 1.772f);
                c0[i] = r;
                c1[i] = g;
                c2[i] = b;
            }
        }
    }
};

void set_error(const Failure& f, char* err, int errlen) {
    if (errlen > 0) std::snprintf(err, size_t(errlen), "%s", f.what.c_str());
}

}  // namespace

extern "C" {

// The image header: out[0..7] = x0, y0, x1, y1 (the image area on the
// reference grid), components, then 0; and for each component c,
// out[8 + 4c ..] = dx, dy, precision, signed.  Returns 0, or 1 (corrupt)
// or 2 (not read) with a message in `err`.
int j2k_header(const uint8_t* data, int64_t len, int64_t* out, int64_t out_len, char* err, int errlen) {
    try {
        Reader r(data, len);
        Codestream cs;
        read_siz(r, cs);
        const int64_t ncomp = int64_t(cs.comps.size());
        if (8 + 4 * ncomp > out_len) corrupt("more components than the output holds");
        out[0] = cs.x0; out[1] = cs.y0; out[2] = cs.x1; out[3] = cs.y1; out[4] = ncomp;
        out[5] = out[6] = out[7] = 0;
        for (int64_t c = 0; c < ncomp; ++c) {
            const Comp& k = cs.comps[size_t(c)];
            out[8 + 4 * c] = k.dx;
            out[9 + 4 * c] = k.dy;
            out[10 + 4 * c] = k.prec;
            out[11 + 4 * c] = k.sgnd;
        }
        return 0;
    } catch (const Failure& f) {
        set_error(f, err, errlen);
        return f.code;
    } catch (...) {
        set_error(Failure{1, "the header could not be read"}, err, errlen);
        return 1;
    }
}

// Decodes the codestream into one int32 plane per component, each
// ceil(x1/dx) - ceil(x0/dx) wide and likewise high, one after another
// in `out` (out_len int32 in all).  features[0] gets the Feature bits.
int j2k_decode(const uint8_t* data, int64_t len, int32_t* out, int64_t out_len, int64_t* features,
               char* err, int errlen) {
    try {
        Codestream cs = parse(data, len);
        std::vector<int32_t*> planes;
        std::vector<int64_t> cx0, cy0, cw;
        int64_t total = 0;
        for (const Comp& c : cs.comps) {
            int64_t x0 = ceildiv(cs.x0, c.dx), y0 = ceildiv(cs.y0, c.dy);
            int64_t w = ceildiv(cs.x1, c.dx) - x0, h = ceildiv(cs.y1, c.dy) - y0;
            planes.push_back(out + total);
            cx0.push_back(x0);
            cy0.push_back(y0);
            cw.push_back(w);
            total += w * h;
        }
        if (total > out_len) corrupt("the output is too small");
        for (size_t t = 0; t < cs.tiles.size(); ++t) {
            TileDecoder td(cs, cs.tiles[t], int(t));
            td.decode();
            td.store(planes, cx0, cy0, cw);
            cs.tiles[t].data.clear();
            cs.tiles[t].data.shrink_to_fit();
        }
        features[0] = cs.features;
        return 0;
    } catch (const Failure& f) {
        set_error(f, err, errlen);
        return f.code;
    } catch (const std::bad_alloc&) {
        set_error(Failure{1, "out of memory"}, err, errlen);
        return 1;
    } catch (...) {
        set_error(Failure{1, "the codestream could not be decoded"}, err, errlen);
        return 1;
    }
}

}  // extern "C"
