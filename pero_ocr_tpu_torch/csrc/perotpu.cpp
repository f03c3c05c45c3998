// Host code of the layout parse, the crop transport's line warp and the
// forced alignment: the port's own copy of the nine functions of the
// JAX package's C++ library (native/perotpu.cpp) that config 2's paths
// (both transports and stage by stage), config 5's ALTO output, config
// 4's chunked transformer lines and the CER scripts run, with the same C interface
// and semantics.  Each has a numpy twin in the port, which the CPU path
// runs and the tests hold it against:
//
//   cc_label_u8              ops/morphology.connected_components
//   cc_baselines_f32         parallel/pipeline.py component lines
//   cc_lines_packed          parallel/crop_transport.py packed_lines
//   warp_affine_lines_u8     parallel/crop_transport.py warp_affine_lines
//   separator_penalties_f32  layout_engines/cnn_engine.separator_penalties
//   polygons_close_f64       core/geometry.polygons_close
//   viterbi_ctc_f32          core/force_alignment.viterbi_ctc
//   levenshtein_i32          sequence_alignment.levenshtein_distance
//   levenshtein_batch_i32    sequence_alignment.levenshtein_ids_batch
//
// Built with the host compiler and loaded through ctypes by
// pero_ocr_tpu_torch/utils/kernels.py; bound in utils/native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// Connected components, 8-connectivity, two-pass union-find.
// mask: h*w uint8 (nonzero = foreground); labels_out: h*w int32.
// Returns the number of components.
// ---------------------------------------------------------------------
static inline int32_t uf_find(std::vector<int32_t>& parent, int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
        int32_t next = parent[x];
        parent[x] = root;
        x = next;
    }
    return root;
}

static inline void uf_union(std::vector<int32_t>& parent, int32_t a, int32_t b) {
    int32_t ra = uf_find(parent, a);
    int32_t rb = uf_find(parent, b);
    if (ra != rb) parent[std::max(ra, rb)] = std::min(ra, rb);
}

int32_t cc_label_u8(const uint8_t* mask, int32_t h, int32_t w,
                    int32_t* labels_out) {
    std::vector<int32_t> parent;
    parent.reserve(1024);
    parent.push_back(0);  // background sentinel

    // First pass: provisional labels + equivalences.
    for (int32_t y = 0; y < h; ++y) {
        for (int32_t x = 0; x < w; ++x) {
            const int64_t idx = (int64_t)y * w + x;
            if (!mask[idx]) {
                labels_out[idx] = 0;
                continue;
            }
            int32_t neighbors[4];
            int n_neighbors = 0;
            if (y > 0) {
                const int64_t up = idx - w;
                if (x > 0 && labels_out[up - 1]) neighbors[n_neighbors++] = labels_out[up - 1];
                if (labels_out[up]) neighbors[n_neighbors++] = labels_out[up];
                if (x + 1 < w && labels_out[up + 1]) neighbors[n_neighbors++] = labels_out[up + 1];
            }
            if (x > 0 && labels_out[idx - 1]) neighbors[n_neighbors++] = labels_out[idx - 1];

            if (n_neighbors == 0) {
                const int32_t fresh = (int32_t)parent.size();
                parent.push_back(fresh);
                labels_out[idx] = fresh;
            } else {
                int32_t lo = neighbors[0];
                for (int i = 1; i < n_neighbors; ++i) lo = std::min(lo, neighbors[i]);
                labels_out[idx] = lo;
                for (int i = 0; i < n_neighbors; ++i) uf_union(parent, lo, neighbors[i]);
            }
        }
    }

    // Flatten equivalences into dense labels 1..n.
    std::vector<int32_t> dense(parent.size(), 0);
    int32_t next_label = 0;
    for (size_t i = 1; i < parent.size(); ++i) {
        const int32_t root = uf_find(parent, (int32_t)i);
        if (dense[root] == 0) dense[root] = ++next_label;
        dense[i] = dense[root];
    }

    const int64_t total = (int64_t)h * w;
    for (int64_t i = 0; i < total; ++i) {
        if (labels_out[i]) labels_out[i] = dense[labels_out[i]];
    }
    return next_label;
}

// ---------------------------------------------------------------------
// Batched inverse-affine line warp, uint8 gray page -> uint8 crops (the
// crop transport's straight lines).  For each line n, output pixel
// (row y, col x) samples the page bilinearly at
//   sx = m[0]*x + m[1]*y + m[2],  sy = m[3]*x + m[4]*y + m[5]
// (cv2.warpAffine's WARP_INVERSE_MAP convention, in float arithmetic);
// out-of-page samples are 0.  The destination is addressed per line as
//   out[offsets[n] + x * stride_col + y * stride_row]
// so one call fills the width-major strip (stride_col = crop_h,
// stride_row = 1) or the dense (Hc, bucket) buffer (stride_col = 1,
// stride_row = bucket).
//
// Two bodies, as the JAX library has when it is built with
// -march=native on an AVX2 host: an AVX2 body (8 pixels a step, float32
// coordinates from fused multiply-adds) for the interior of a row, and a
// scalar tail (coordinates accumulated in double) for the rest and the
// page's edges.  This library is built without -march=native, so the
// AVX2 body is compiled for avx2 and fma on its own and chosen at run
// time; elsewhere the scalar body does every pixel.  The two round apart
// by at most one gray level where their coordinates differ.
// ---------------------------------------------------------------------
static inline __attribute__((always_inline)) void warp_row_tail(
    const uint8_t* gray, int32_t h, int32_t w, const double* m, int32_t width,
    int32_t x, double sx, double sy, uint8_t* row_tmp) {
    for (; x < width; ++x, sx += m[0], sy += m[3]) {
        const int32_t x0 = (int32_t)std::floor(sx);
        const int32_t y0 = (int32_t)std::floor(sy);
        uint8_t value = 0;
        if (x0 >= 0 && x0 + 1 < w && y0 >= 0 && y0 + 1 < h) {
            const float fx = (float)(sx - x0);
            const float fy = (float)(sy - y0);
            const uint8_t* p = gray + (size_t)y0 * w + x0;
            const float top = p[0] + fx * (p[1] - p[0]);
            const float bot = p[w] + fx * (p[w + 1] - p[w]);
            const float v = top + fy * (bot - top);
            value = (uint8_t)(v + 0.5f);
        } else if (x0 >= -1 && x0 < w && y0 >= -1 && y0 < h) {
            const float fx = (float)(sx - x0);
            const float fy = (float)(sy - y0);
            const bool xl = x0 >= 0, xr = x0 + 1 < w;
            const bool yt = y0 >= 0, yb = y0 + 1 < h;
            const size_t idx = (size_t)y0 * w + x0;
            const float p00 = (xl && yt) ? gray[idx] : 0.f;
            const float p01 = (xr && yt) ? gray[idx + 1] : 0.f;
            const float p10 = (xl && yb) ? gray[idx + w] : 0.f;
            const float p11 = (xr && yb) ? gray[idx + w + 1] : 0.f;
            const float top = p00 + fx * (p01 - p00);
            const float bot = p10 + fx * (p11 - p10);
            const float v = top + fy * (bot - top);
            value = (uint8_t)std::min(255.f, std::max(0.f, v + 0.5f));
        }
        row_tmp[x] = value;
    }
}

static inline __attribute__((always_inline)) void store_row(
    const uint8_t* row_tmp, int32_t width, uint8_t* row, int64_t stride_col) {
    if (stride_col == 1) {
        std::memcpy(row, row_tmp, width);
    } else {
        for (int32_t i = 0; i < width; ++i) row[(int64_t)i * stride_col] = row_tmp[i];
    }
}

void warp_affine_lines_u8_scalar(const uint8_t* gray, int32_t h, int32_t w,
                                 const double* mats, const int32_t* widths,
                                 int32_t n_lines, int32_t crop_h,
                                 uint8_t* out, const int64_t* offsets,
                                 int64_t stride_col, int64_t stride_row) {
    std::vector<uint8_t> row_tmp;
    for (int32_t n = 0; n < n_lines; ++n) {
        const double* m = mats + (size_t)n * 6;
        uint8_t* base = out + offsets[n];
        const int32_t width = widths[n];
        row_tmp.resize(width);
        for (int32_t y = 0; y < crop_h; ++y) {
            const double sx_d = m[1] * y + m[2];
            const double sy_d = m[4] * y + m[5];
            warp_row_tail(gray, h, w, m, width, 0, sx_d, sy_d, row_tmp.data());
            store_row(row_tmp.data(), width, base + (int64_t)y * stride_row, stride_col);
        }
    }
}

#if defined(__x86_64__)
__attribute__((target("avx2,fma")))
static void warp_affine_lines_u8_avx2(const uint8_t* gray, int32_t h, int32_t w,
                                      const double* mats, const int32_t* widths,
                                      int32_t n_lines, int32_t crop_h,
                                      uint8_t* out, const int64_t* offsets,
                                      int64_t stride_col, int64_t stride_row) {
    std::vector<uint8_t> row_tmp;
    for (int32_t n = 0; n < n_lines; ++n) {
        const double* m = mats + (size_t)n * 6;
        uint8_t* base = out + offsets[n];
        const int32_t width = widths[n];
        row_tmp.resize(width);
        for (int32_t y = 0; y < crop_h; ++y) {
            double sx_d = m[1] * y + m[2];
            double sy_d = m[4] * y + m[5];
            int32_t x = 0;
            // 8 pixels a step; a 32-bit gather at byte index idx holds
            // p00|p01 in its low two bytes, one at idx + w p10|p11.  Lanes
            // within 4 bytes of the page's right or bottom edge leave the
            // block loop to the scalar tail (the gather would read past
            // the buffer).
            {
                const __m256 lane = _mm256_setr_ps(0, 1, 2, 3, 4, 5, 6, 7);
                const __m256 m0v = _mm256_set1_ps((float)m[0]);
                const __m256 m3v = _mm256_set1_ps((float)m[3]);
                const __m256 sx_row = _mm256_set1_ps((float)sx_d);
                const __m256 sy_row = _mm256_set1_ps((float)sy_d);
                const __m256 zero = _mm256_setzero_ps();
                const __m256 xmax = _mm256_set1_ps((float)(w - 4));
                const __m256 ymax = _mm256_set1_ps((float)(h - 2));
                for (; x + 8 <= width; x += 8) {
                    const __m256 xv = _mm256_add_ps(lane, _mm256_set1_ps((float)x));
                    const __m256 sx_v = _mm256_fmadd_ps(xv, m0v, sx_row);
                    const __m256 sy_v = _mm256_fmadd_ps(xv, m3v, sy_row);
                    const __m256 fx0 = _mm256_floor_ps(sx_v);
                    const __m256 fy0 = _mm256_floor_ps(sy_v);
                    const __m256 ok = _mm256_and_ps(
                        _mm256_and_ps(_mm256_cmp_ps(fx0, zero, _CMP_GE_OQ),
                                      _mm256_cmp_ps(fx0, xmax, _CMP_LT_OQ)),
                        _mm256_and_ps(_mm256_cmp_ps(fy0, zero, _CMP_GE_OQ),
                                      _mm256_cmp_ps(fy0, ymax, _CMP_LT_OQ)));
                    if (_mm256_movemask_ps(ok) != 0xFF) break;
                    const __m256i x0 = _mm256_cvtps_epi32(fx0);
                    const __m256i y0 = _mm256_cvtps_epi32(fy0);
                    const __m256i idx = _mm256_add_epi32(
                        _mm256_mullo_epi32(y0, _mm256_set1_epi32(w)), x0);
                    const __m256i idx2 = _mm256_add_epi32(idx, _mm256_set1_epi32(w));
                    const __m256i top2 = _mm256_i32gather_epi32((const int*)gray, idx, 1);
                    const __m256i bot2 = _mm256_i32gather_epi32((const int*)gray, idx2, 1);
                    const __m256i mask8 = _mm256_set1_epi32(0xFF);
                    const __m256 p00 = _mm256_cvtepi32_ps(_mm256_and_si256(top2, mask8));
                    const __m256 p01 = _mm256_cvtepi32_ps(
                        _mm256_and_si256(_mm256_srli_epi32(top2, 8), mask8));
                    const __m256 p10 = _mm256_cvtepi32_ps(_mm256_and_si256(bot2, mask8));
                    const __m256 p11 = _mm256_cvtepi32_ps(
                        _mm256_and_si256(_mm256_srli_epi32(bot2, 8), mask8));
                    const __m256 fx = _mm256_sub_ps(sx_v, fx0);
                    const __m256 fy = _mm256_sub_ps(sy_v, fy0);
                    const __m256 top = _mm256_add_ps(
                        p00, _mm256_mul_ps(fx, _mm256_sub_ps(p01, p00)));
                    const __m256 bot = _mm256_add_ps(
                        p10, _mm256_mul_ps(fx, _mm256_sub_ps(p11, p10)));
                    const __m256 v = _mm256_add_ps(
                        _mm256_add_ps(top, _mm256_mul_ps(fy, _mm256_sub_ps(bot, top))),
                        _mm256_set1_ps(0.5f));
                    const __m256i vi = _mm256_cvttps_epi32(v);
                    const __m256i packed16 = _mm256_packs_epi32(vi, _mm256_setzero_si256());
                    const __m256i packed8 = _mm256_packus_epi16(packed16,
                                                                _mm256_setzero_si256());
                    const uint32_t lo = (uint32_t)_mm256_extract_epi32(packed8, 0);
                    const uint32_t hi = (uint32_t)_mm256_extract_epi32(packed8, 4);
                    std::memcpy(row_tmp.data() + x, &lo, 4);
                    std::memcpy(row_tmp.data() + x + 4, &hi, 4);
                }
                sx_d = m[1] * y + m[2] + m[0] * x;
                sy_d = m[4] * y + m[5] + m[3] * x;
            }
            warp_row_tail(gray, h, w, m, width, x, sx_d, sy_d, row_tmp.data());
            store_row(row_tmp.data(), width, base + (int64_t)y * stride_row, stride_col);
        }
    }
}
#endif

// 1 when warp_affine_lines_u8 runs the AVX2 body on this host.
int32_t warp_affine_avx2(void) {
#if defined(__x86_64__)
    return __builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma");
#else
    return 0;
#endif
}

void warp_affine_lines_u8(const uint8_t* gray, int32_t h, int32_t w,
                          const double* mats, const int32_t* widths,
                          int32_t n_lines, int32_t crop_h,
                          uint8_t* out, const int64_t* offsets,
                          int64_t stride_col, int64_t stride_row) {
#if defined(__x86_64__)
    if (warp_affine_avx2()) {
        warp_affine_lines_u8_avx2(gray, h, w, mats, widths, n_lines, crop_h, out, offsets,
                                  stride_col, stride_row);
        return;
    }
#endif
    warp_affine_lines_u8_scalar(gray, h, w, mats, widths, n_lines, crop_h, out, offsets,
                                stride_col, stride_row);
}

// ---------------------------------------------------------------------
// Per-component baseline extraction (the CC-parse hot loop of the
// device pipeline's host geometry; semantics identical to the numpy
// loop of TorchPagePipeline._component_lines):
//   for each label c in [1, num]: collect its pixels in row-major
//   order; components with <= 5 px are invalid; baseline point per
//   unique x = FIRST-seen y (row-major => min y), xs ascending;
//   decimate to target = clamp(n_unique/10, 2, 10) points via
//   numpy-linspace index truncation; pos[0].x -= 2, pos[-1].x += 2;
//   heights = per-channel MEDIAN (numpy percentile-50 interpolation)
//   of max(heights_map, 0) over ALL component pixels.
// ---------------------------------------------------------------------
static double median_of(std::vector<float>& v) {
    const size_t n = v.size();
    if (n == 0) return 0.0;
    const size_t mid = n / 2;
    std::nth_element(v.begin(), v.begin() + mid, v.end());
    const double hi = v[mid];
    if (n % 2 == 1) return hi;
    const double lo =
        *std::max_element(v.begin(), v.begin() + mid);
    return 0.5 * (lo + hi);
}

void cc_baselines_f32(const int32_t* labels, int32_t h, int32_t w,
                      int32_t num, const float* heights,
                      int32_t max_pts, double* out_pts,
                      int32_t* out_npts, double* out_heights,
                      uint8_t* out_valid) {
    std::vector<std::vector<std::pair<int32_t, int32_t>>> px(num + 1);
    std::vector<std::vector<float>> h0(num + 1), h1(num + 1);
    for (int32_t y = 0; y < h; ++y) {
        const int32_t* row = labels + (size_t)y * w;
        const float* hrow = heights + (size_t)y * w * 2;
        for (int32_t x = 0; x < w; ++x) {
            const int32_t c = row[x];
            if (c <= 0 || c > num) continue;
            px[c].push_back({x, y});
            h0[c].push_back(std::max(hrow[2 * x], 0.f));
            h1[c].push_back(std::max(hrow[2 * x + 1], 0.f));
        }
    }
    std::vector<std::pair<int32_t, int32_t>> uniq;
    for (int32_t c = 1; c <= num; ++c) {
        const int32_t o = c - 1;
        out_npts[o] = 0;
        out_valid[o] = 0;
        if ((int64_t)px[c].size() <= 5) continue;
        // First-seen y per x (pixels are row-major, so first = min y),
        // then ascending x: stable sort by x keeps encounter order.
        uniq.clear();
        {
            // px[c] is row-major; collect first occurrence per x.
            // xs are bounded by w: use a visit stamp array lazily.
            static thread_local std::vector<int32_t> first_y;
            if ((int32_t)first_y.size() < w) first_y.assign(w, -1);
            std::vector<int32_t> touched;
            for (const auto& p : px[c]) {
                if (first_y[p.first] < 0) {
                    first_y[p.first] = p.second;
                    touched.push_back(p.first);
                }
            }
            std::sort(touched.begin(), touched.end());
            for (int32_t x : touched) {
                uniq.push_back({x, first_y[x]});
                first_y[x] = -1;  // reset for the next component
            }
        }
        const int64_t n_unique = (int64_t)uniq.size();
        int32_t target = (int32_t)std::min<int64_t>(10, n_unique / 10);
        target = std::max(target, 2);
        target = std::min<int32_t>(target, max_pts);
        // numpy linspace(0, n-1, target).astype(int): delta * k,
        // truncated toward zero.
        const double delta =
            (double)(n_unique - 1) / (double)(target - 1);
        double* pts = out_pts + (size_t)o * max_pts * 2;
        for (int32_t k = 0; k < target; ++k) {
            // numpy pins the linspace endpoint exactly.
            int64_t idx =
                (k == target - 1) ? n_unique - 1 : (int64_t)(delta * k);
            if (idx > n_unique - 1) idx = n_unique - 1;
            pts[2 * k] = (double)uniq[idx].first;
            pts[2 * k + 1] = (double)uniq[idx].second;
        }
        pts[0] -= 2.0;
        pts[2 * (target - 1)] += 2.0;
        out_npts[o] = target;
        out_heights[2 * o] = median_of(h0[c]);
        out_heights[2 * o + 1] = median_of(h1[c]);
        out_valid[o] = 1;
    }
}

// ---------------------------------------------------------------------
// Batched separator-map penalties for paragraph clustering (the
// per-pair Python loop was the clustering's hot path at ~0.1-0.2ms per
// query).  Query q samples line q_line[q]'s polyline (points sorted by
// x, already map-scale), shifted by q_shift[q], over integer columns
// [round(q_x1), round(q_x2)) clipped to the polyline span and the map,
// sums a 3-row band of sep_map around round(interp(y)), and divides by
// (q_x2 - q_x1).  Columns outside the span contribute nothing; empty
// sample sets yield 1.0 — exactly the semantics of the numpy
// layout_engines/cnn_engine.py separator_penalties.
// ---------------------------------------------------------------------
// ``pool``: the sep_map is POOL-pooled (H/pool, W/pool) while h/w stay
// the FULL map dims the query coordinates live in — sampling indexes
// sep_map[(yy/pool) * (w/pool) + x/pool], which equals sampling the
// repeat-upsampled full-res map (values constant within each cell), so
// the pooled call is byte-exact vs pool=1 on the upsampled array
// without ever materializing it (36MB/batch at the ds-2 shapes).
void separator_penalties_f32(
    const double* bx, const double* by, const int32_t* offs,
    const int32_t* q_line, const double* q_shift,
    const double* q_x1, const double* q_x2, int32_t n_q,
    const float* sep_map, int32_t h, int32_t w, int32_t pool,
    double* out) {
    const int32_t wq = w / pool;
    for (int32_t q = 0; q < n_q; ++q) {
        const int32_t lo = offs[q_line[q]];
        const int32_t hi = offs[q_line[q] + 1];
        const int32_t npts = hi - lo;
        const double* px = bx + lo;
        const double* py = by + lo;
        const double shift = q_shift[q];
        const int64_t x1 = (int64_t)std::llround(q_x1[q]);
        const int64_t x2 = (int64_t)std::llround(q_x2[q]);
        const double denom = std::max(q_x2[q] - q_x1[q], 1e-6);
        if (x2 <= x1 || npts < 1 || px[npts - 1] <= px[0]) {
            out[q] = 1.0;
            continue;
        }
        int64_t xa = std::max(
            x1, (int64_t)std::ceil(std::max(px[0], 0.0)));
        int64_t xb = std::min(
            {x2 - 1, (int64_t)std::floor(px[npts - 1]), (int64_t)w - 1});
        if (xa > xb) {
            out[q] = 1.0;
            continue;
        }
        double total = 0.0;
        int32_t seg = 0;
        bool any = false;
        for (int64_t x = xa; x <= xb; ++x) {
            const double xf = (double)x;
            double y;
            if (xf <= px[0]) {
                y = py[0];
            } else if (xf >= px[npts - 1]) {
                y = py[npts - 1];
            } else {
                while (seg + 2 < npts && px[seg + 1] < xf) ++seg;
                const double dx = px[seg + 1] - px[seg];
                const double t_ = dx > 0 ? (xf - px[seg]) / dx : 0.0;
                y = py[seg] + t_ * (py[seg + 1] - py[seg]);
            }
            const int64_t yc = (int64_t)std::llround(y + shift);
            for (int64_t dy = -1; dy <= 1; ++dy) {
                const int64_t yy =
                    std::min((int64_t)h - 1, std::max((int64_t)0, yc + dy));
                total += sep_map[(yy / pool) * wq + x / pool];
            }
            any = true;
        }
        out[q] = any ? total / denom : 1.0;
    }
}

// ---------------------------------------------------------------------
// Batched polygon proximity test for paragraph clustering: for each
// candidate pair (a, b), decide whether the minimum boundary distance
// between polygon a and polygon b is <= thresholds[k] (the Minkowski
// dilated-intersection test, cnn_engine.make_clusters).  Early-exits on
// the first segment pair under the threshold — the common case for
// same-paragraph neighbors.  Unlike the reference, pairs whose bounding
// boxes lie clearly farther apart than the threshold are rejected
// before the segment loop (core/geometry.polygons_close's first bound),
// with the same answers.
// verts: (n_polys, pmax, 2) float64, padded by repeating the last
// vertex; npts: per-polygon vertex counts; pairs: (K, 2) int32;
// out: (K,) uint8 booleans.
// ---------------------------------------------------------------------
static inline double seg_seg_dist2(double ax, double ay, double bx,
                                   double by, double cx, double cy,
                                   double dx_, double dy_) {
    const double d1x = bx - ax, d1y = by - ay;
    const double d2x = dx_ - cx, d2y = dy_ - cy;
    const double rx = ax - cx, ry = ay - cy;
    const double A = d1x * d1x + d1y * d1y;
    const double E = d2x * d2x + d2y * d2y;
    const double B = d1x * d2x + d1y * d2y;
    const double C = d1x * rx + d1y * ry;
    const double F = d2x * rx + d2y * ry;
    const double denom = A * E - B * B;
    // Convex quadratic over the [0,1]^2 box: the minimum is either the
    // unconstrained stationary point (when it lands inside) or on one
    // of the four boundary edges, each a 1-D convex problem in closed
    // form.  Evaluating all candidates is exact — a single clamped
    // alternation pass is not.
    auto dist2_at = [&](double s, double t) {
        const double px = ax + s * d1x - (cx + t * d2x);
        const double py = ay + s * d1y - (cy + t * d2y);
        return px * px + py * py;
    };
    auto clamp01 = [](double v) { return std::min(1.0, std::max(0.0, v)); };
    const double t_s0 = (E > 1e-12) ? clamp01(F / E) : 0.0;
    const double t_s1 = (E > 1e-12) ? clamp01((B + F) / E) : 0.0;
    const double s_t0 = (A > 1e-12) ? clamp01(-C / A) : 0.0;
    const double s_t1 = (A > 1e-12) ? clamp01((B - C) / A) : 0.0;
    double best = std::min(
        std::min(dist2_at(0.0, t_s0), dist2_at(1.0, t_s1)),
        std::min(dist2_at(s_t0, 0.0), dist2_at(s_t1, 1.0)));
    if (denom > 1e-12) {
        const double s = (B * F - C * E) / denom;
        const double t = (B * s + F) / E;
        if (s > 0.0 && s < 1.0 && t > 0.0 && t < 1.0)
            best = std::min(best, dist2_at(s, t));
    }
    return best;
}

void polygons_close_f64(const double* verts, const int32_t* npts,
                        int32_t pmax, const int32_t* pairs, int32_t k,
                        const double* thresholds, uint8_t* out) {
    // Each polygon's bounding box (x0, y0, x1, y1), for the reject below.
    int32_t n_polys = 0;
    for (int32_t q = 0; q < 2 * k; ++q) n_polys = std::max(n_polys, pairs[q] + 1);
    std::vector<double> box((size_t)n_polys * 4);
    for (int32_t p = 0; p < n_polys; ++p) {
        const double* v = verts + (size_t)p * pmax * 2;
        double* b = box.data() + (size_t)p * 4;
        b[0] = b[2] = npts[p] > 0 ? v[0] : 0.0;
        b[1] = b[3] = npts[p] > 0 ? v[1] : 0.0;
        for (int32_t i = 1; i < npts[p]; ++i) {
            b[0] = std::min(b[0], v[2 * i]);
            b[2] = std::max(b[2], v[2 * i]);
            b[1] = std::min(b[1], v[2 * i + 1]);
            b[3] = std::max(b[3], v[2 * i + 1]);
        }
    }
    for (int32_t q = 0; q < k; ++q) {
        const int32_t ia = pairs[2 * q], ib = pairs[2 * q + 1];
        const double* va = verts + (size_t)ia * pmax * 2;
        const double* vb = verts + (size_t)ib * pmax * 2;
        const int32_t na = npts[ia], nb = npts[ib];
        const double thr2 = thresholds[q] * thresholds[q];
        uint8_t close = 0;
        // No boundary point lies outside its box, so a gap between the
        // boxes bounds the distance from below.  The reject keeps a
        // margin far above seg_seg_dist2's rounding (a few ulps of the
        // coordinates, squared), so a rejected pair is one the segment
        // loop would also find apart: the answers stay the reference's.
        const double* ba = box.data() + (size_t)ia * 4;
        const double* bb = box.data() + (size_t)ib * 4;
        const double gx = std::max(std::max(ba[0] - bb[2], bb[0] - ba[2]), 0.0);
        const double gy = std::max(std::max(ba[1] - bb[3], bb[1] - ba[3]), 0.0);
        double scale = 1.0;
        for (int32_t c = 0; c < 4; ++c)
            scale = std::max(scale, std::max(std::fabs(ba[c]), std::fabs(bb[c])));
        if (gx * gx + gy * gy > thr2 + 1e-9 * scale * scale) {
            out[q] = 0;
            continue;
        }
        for (int32_t i = 0; i < na && !close; ++i) {
            const int32_t i2 = (i + 1 == na) ? 0 : i + 1;
            const double ax = va[2 * i], ay = va[2 * i + 1];
            const double bx = va[2 * i2], by = va[2 * i2 + 1];
            for (int32_t j = 0; j < nb; ++j) {
                const int32_t j2 = (j + 1 == nb) ? 0 : j + 1;
                if (seg_seg_dist2(ax, ay, bx, by, vb[2 * j], vb[2 * j + 1],
                                  vb[2 * j2], vb[2 * j2 + 1]) <= thr2) {
                    close = 1;
                    break;
                }
            }
        }
        out[q] = close;
    }
}

// ---------------------------------------------------------------------
// Fused packed-mask -> component baselines (the fast path's CC parse in
// one pass, in place of unpacking, the connection dilation, labeling
// and the per-component loop).
//
// Input is the stage-A transport's 1-bit baseline mask (8 px/byte, bit
// k = pixel x = byte*8 + k) and the pooled heights_q (hqh, hqw, 2)
// uint8 quarter-pixels with pool factor hf.  Replicates EXACTLY the
// numpy path (TorchPagePipeline._unpack_stage_a + ops.morphology +
// TorchPagePipeline._lines_from_masks):
//
//   connected = dilate(mask, ones(5,3)); label(connected, ones(3,3));
//   labels *= mask; per component with >5 px: unique-x first-y points,
//   linspace to clamp(n/10, 2, 10) pts, endpoints x -+= 2, heights =
//   per-channel median of the pooled map sampled at component pixels.
//
// The (5,3) dilation + 8-connected labeling collapses to a direct rule
// on baseline pixels: p ~ q iff |dy| <= 5 and |dx| <= 3 (their dilated
// rects touch 8-connectedly), so the labeling is a sparse union-find
// over set bits only -- no dilated image is ever materialized.
// Component order matches scipy's raster numbering (first baseline
// pixel in raster order; the constant (-2,-1) shift to the first
// DILATED pixel preserves comparisons except for components starting
// within 2 px of the top border, where scipy's clamped rows can tie).
//
// Also emits the adaptation statistics the caller otherwise needed the
// unpacked mask for (TorchPagePipeline._adapt_target_ds): total set-bit
// count and a 256-bin histogram of the channel-0 heights_q value under
// every set bit (batch-exact median of q/4 = median over the upsampled
// float map, which is constant within each hf x hf cell).
//
// out_pts: (max_comps, max_pts, 2); out_npts/out_heights: per emitted
// component; returns the number of components emitted (valid only,
// in component order), or -1 if max_comps would overflow.
// ---------------------------------------------------------------------
int32_t cc_lines_packed(
    const uint8_t* packed, int32_t h, int32_t wb,
    const uint8_t* hq, int32_t hqw, int32_t hf,
    int32_t max_comps, int32_t max_pts,
    double* out_pts, int32_t* out_npts, double* out_heights,
    int64_t* out_npx, int64_t* hist0) {
    struct Px { int32_t x, y; };
    std::vector<Px> px;
    px.reserve(4096);
    std::vector<int32_t> row_start(h + 1, 0);
    for (int32_t y = 0; y < h; ++y) {
        row_start[y] = (int32_t)px.size();
        const uint8_t* row = packed + (size_t)y * wb;
        const int32_t yq = y / hf;
        for (int32_t b = 0; b < wb; ++b) {
            uint8_t v = row[b];
            while (v) {
                const int32_t k = __builtin_ctz(v);
                v = (uint8_t)(v & (v - 1));
                const int32_t x = b * 8 + k;
                px.push_back({x, y});
                ++hist0[hq[((size_t)yq * hqw + x / hf) * 2]];
            }
        }
    }
    row_start[h] = (int32_t)px.size();
    const int32_t n = (int32_t)px.size();
    *out_npx = n;
    if (n == 0) return 0;

    std::vector<int32_t> parent(n);
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
    // Pixels are raster-ordered: same-row links need only the previous
    // pixel (sorted x, transitive); cross-row links sweep rows y-5..y-1
    // with a monotone cursor per row pair.
    for (int32_t y = 0; y < h; ++y) {
        const int32_t lo = row_start[y], hi = row_start[y + 1];
        if (lo == hi) continue;
        for (int32_t i = lo + 1; i < hi; ++i) {
            if (px[i].x - px[i - 1].x <= 3) uf_union(parent, i, i - 1);
        }
        for (int32_t yp = std::max(0, y - 5); yp < y; ++yp) {
            int32_t j = row_start[yp];
            const int32_t jhi = row_start[yp + 1];
            if (j == jhi) continue;
            for (int32_t i = lo; i < hi; ++i) {
                const int32_t x = px[i].x;
                while (j < jhi && px[j].x < x - 3) ++j;
                for (int32_t jj = j; jj < jhi && px[jj].x <= x + 3; ++jj) {
                    uf_union(parent, i, jj);
                }
            }
        }
    }

    // Component numbering by first (raster-order) pixel: uf_union is
    // union-by-min, so each root is its component's minimal pixel
    // index and first-encounter order IS raster order.
    std::vector<int32_t> comp_of(n);
    std::vector<int32_t> comp_id_of_root(n, -1);
    int32_t n_comp = 0;
    for (int32_t i = 0; i < n; ++i) {
        const int32_t r = uf_find(parent, i);
        if (comp_id_of_root[r] < 0) comp_id_of_root[r] = n_comp++;
        comp_of[i] = comp_id_of_root[r];
    }

    // Gather per-component pixel lists (raster order preserved).
    std::vector<int32_t> comp_count(n_comp, 0);
    for (int32_t i = 0; i < n; ++i) ++comp_count[comp_of[i]];
    std::vector<int32_t> comp_off(n_comp + 1, 0);
    for (int32_t c = 0; c < n_comp; ++c)
        comp_off[c + 1] = comp_off[c] + comp_count[c];
    std::vector<int32_t> comp_px(n);
    {
        std::vector<int32_t> cur(comp_off.begin(), comp_off.end() - 1);
        for (int32_t i = 0; i < n; ++i) comp_px[cur[comp_of[i]]++] = i;
    }

    int32_t emitted = 0;
    std::vector<int32_t> first_y;
    std::vector<int32_t> touched;
    std::vector<float> h0, h1;
    const int32_t w = wb * 8;
    first_y.assign(w, -1);
    for (int32_t c = 0; c < n_comp; ++c) {
        const int32_t lo = comp_off[c], hi = comp_off[c + 1];
        if (hi - lo <= 5) continue;
        if (emitted >= max_comps) return -1;
        touched.clear();
        h0.clear();
        h1.clear();
        for (int32_t t = lo; t < hi; ++t) {
            const Px& p = px[comp_px[t]];
            if (first_y[p.x] < 0) {
                first_y[p.x] = p.y;
                touched.push_back(p.x);
            }
            const uint8_t* cell =
                hq + ((size_t)(p.y / hf) * hqw + p.x / hf) * 2;
            h0.push_back(cell[0] * 0.25f);
            h1.push_back(cell[1] * 0.25f);
        }
        std::sort(touched.begin(), touched.end());
        const int64_t n_unique = (int64_t)touched.size();
        int32_t target = (int32_t)std::min<int64_t>(10, n_unique / 10);
        target = std::max(target, 2);
        target = std::min<int32_t>(target, max_pts);
        const double delta =
            (double)(n_unique - 1) / (double)(target - 1);
        double* pts = out_pts + (size_t)emitted * max_pts * 2;
        for (int32_t k = 0; k < target; ++k) {
            int64_t idx =
                (k == target - 1) ? n_unique - 1 : (int64_t)(delta * k);
            if (idx > n_unique - 1) idx = n_unique - 1;
            pts[2 * k] = (double)touched[idx];
            pts[2 * k + 1] = (double)first_y[touched[idx]];
        }
        pts[0] -= 2.0;
        pts[2 * (target - 1)] += 2.0;
        out_npts[emitted] = target;
        out_heights[2 * emitted] = median_of(h0);
        out_heights[2 * emitted + 1] = median_of(h1);
        for (int32_t x : touched) first_y[x] = -1;
        ++emitted;
    }
    return emitted;
}

// ---------------------------------------------------------------------
// CTC forced alignment: Viterbi over the blank-interleaved state chain.
// neg_logprobs_states: (t, s) float32 costs gathered per state (+inf
// clamped to 1e30 by the caller); skip_ok: (s,) whether the advance by
// two into a state is legal.  Each frame takes, per state, the cheapest
// of stay, advance by one and advance by two, the first of equals
// (as numpy's argmin).  The path must end in one of the last two
// states, the last label before the last blank on a tie.  path_out:
// (t,) state per frame.  Returns 0, or -1 when no path has a finite
// cost.
// ---------------------------------------------------------------------
// Levenshtein distance over int32 symbol sequences (rolling 1-row DP).
// ---------------------------------------------------------------------
int32_t levenshtein_i32(const int32_t* a, int32_t n, const int32_t* b,
                        int32_t m) {
    if (n == 0) return m;
    if (m == 0) return n;
    std::vector<int32_t> row(m + 1);
    for (int32_t j = 0; j <= m; ++j) row[j] = j;
    for (int32_t i = 1; i <= n; ++i) {
        int32_t diag = row[0];
        row[0] = i;
        for (int32_t j = 1; j <= m; ++j) {
            const int32_t sub = diag + (a[i - 1] != b[j - 1]);
            diag = row[j];
            row[j] = std::min(std::min(row[j] + 1, row[j - 1] + 1), sub);
        }
    }
    return row[m];
}

// Batched: distances_out[i] = levenshtein_i32(a_i, b_i), the sequences
// packed back to back, sequence i at [offsets[i], offsets[i + 1]).
void levenshtein_batch_i32(const int32_t* data_a, const int32_t* offsets_a,
                           const int32_t* data_b, const int32_t* offsets_b,
                           int32_t count, int32_t* distances_out) {
    for (int32_t i = 0; i < count; ++i) {
        distances_out[i] = levenshtein_i32(
            data_a + offsets_a[i], offsets_a[i + 1] - offsets_a[i],
            data_b + offsets_b[i], offsets_b[i + 1] - offsets_b[i]);
    }
}

// ---------------------------------------------------------------------
int32_t viterbi_ctc_f32(const float* neg_logprobs_states, int32_t t,
                        int32_t s, const uint8_t* skip_ok,
                        int32_t* path_out) {
    const float INF = 1e30f;
    std::vector<float> cost(s, INF);
    std::vector<float> next(s);
    std::vector<int8_t> deltas((size_t)t * s, 0);

    cost[0] = neg_logprobs_states[0];
    if (s > 1) cost[1] = neg_logprobs_states[1];

    for (int32_t i = 1; i < t; ++i) {
        const float* frame = neg_logprobs_states + (size_t)i * s;
        int8_t* drow = deltas.data() + (size_t)i * s;
        for (int32_t k = 0; k < s; ++k) {
            float best = cost[k];
            int8_t d = 0;
            if (k >= 1 && cost[k - 1] < best) { best = cost[k - 1]; d = 1; }
            if (k >= 2 && skip_ok[k] && cost[k - 2] < best) { best = cost[k - 2]; d = 2; }
            next[k] = best + frame[k];
            drow[k] = d;
        }
        std::swap(cost, next);
    }

    float best = INF;
    int32_t state = -1;
    for (int32_t k = std::max(0, s - 2); k < s; ++k) {
        if (cost[k] < best) { best = cost[k]; state = k; }
    }
    if (state < 0 || best >= INF * 0.5f) return -1;

    for (int32_t i = t - 1; i >= 0; --i) {
        path_out[i] = state;
        if (i > 0) state -= deltas[(size_t)i * s + state];
    }
    return 0;
}

}  // extern "C"
