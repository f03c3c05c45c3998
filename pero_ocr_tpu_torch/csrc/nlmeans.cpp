// Non-local means denoising of a grey uint8 image, equal to OpenCV 5's
// cv2.fastNlMeansDenoising(img, h=h) (7x7 template, 21x21 search
// window) to the bit: the denoising step of REGION_SIMPLE_THRESHOLD
// (pero_ocr_tpu/layout_engines/simple_region_engine.py).
//
// OpenCV's FastNlMeansDenoisingInvoker, in exact integers:
// - the image is padded by 13 (search half 10 + template half 3) with
//   BORDER_REFLECT_101;
// - for every pixel and each of the 441 offsets of its search window,
//   D is the sum of squared differences between the 7x7 patch around
//   the pixel and the one around the offset pixel;
// - the weight is table[D >> 6]: 49 template pixels are rounded up to
//   64, so the table is indexed by the "almost average" distance, and
//   table[a] = cvRound(fpm * exp(-(a * 64/49) / (h*h))) with
//   fpm = INT_MAX / (441 * 255) = 19096, set to 0 below 0.001 * fpm;
// - the output is (sum(w * p) + sum(w) / 2) / sum(w) over the window's
//   pixels p, in unsigned integers.
//
// OpenCV walks each row keeping running column sums; here each stripe
// of rows takes one offset at a time over all its pixels, with running
// 7-row column sums and a running 7-column window.  The sums are the
// same integers in any order, so the result does not depend on the
// stripes or the threads (cv2 with 1 thread equals cv2 with 8).
//
// Built with the host compiler and loaded through ctypes by
// pero_ocr_tpu_torch/utils/kernels.py; bound in utils/denoise.py.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

const int kTemplateHalf = 3;
const int kTemplate = 2 * kTemplateHalf + 1;  // 7
const int kSearchHalf = 10;
const int kBorder = kSearchHalf + kTemplateHalf;  // 13
const int kShift = 6;  // 49 rounded up to 64

// cv::borderInterpolate for BORDER_REFLECT_101.
int reflect101(int p, int len) {
    if (len == 1) return 0;
    while (p < 0 || p >= len) p = p < 0 ? -p : 2 * len - 2 - p;
    return p;
}

struct Job {
    const uint8_t* padded;  // (h + 2 kBorder) x (w + 2 kBorder)
    int h, w, pw;
    const int32_t* table;
    uint8_t* dst;
};

// Rows [r0, r1) of the output.
void denoise_rows(const Job& job, int r0, int r1, std::vector<uint32_t>& est,
                  std::vector<uint32_t>& wsum, std::vector<int32_t>& col,
                  std::vector<int32_t>& sq) {
    const int w = job.w, pw = job.pw;
    const int cols = w + 2 * kTemplateHalf;  // template columns around the output's
    const int rows = r1 - r0;
    std::fill(est.begin(), est.begin() + (size_t)rows * w, 0u);
    std::fill(wsum.begin(), wsum.begin() + (size_t)rows * w, 0u);
    // Padded coordinates: output (y, x) is the template centre
    // (y + kBorder, x + kBorder); its template's columns start at
    // x + kSearchHalf.
    for (int dy = -kSearchHalf; dy <= kSearchHalf; ++dy) {
        for (int dx = -kSearchHalf; dx <= kSearchHalf; ++dx) {
            auto sq_row = [&](int y, int32_t* out) {  // y: padded row of the centre patch
                const uint8_t* a = job.padded + (size_t)y * pw + kSearchHalf;
                const uint8_t* b = job.padded + (size_t)(y + dy) * pw + kSearchHalf + dx;
                for (int x = 0; x < cols; ++x) {
                    int32_t d = (int32_t)a[x] - (int32_t)b[x];
                    out[x] = d * d;
                }
            };
            // Column sums of the template rows of output row r0.
            std::fill(col.begin(), col.begin() + cols, 0);
            for (int t = -kTemplateHalf; t <= kTemplateHalf; ++t) {
                sq_row(r0 + kBorder + t, sq.data());
                for (int x = 0; x < cols; ++x) col[x] += sq[x];
            }
            for (int y = r0; y < r1; ++y) {
                if (y > r0) {
                    sq_row(y + kBorder + kTemplateHalf, sq.data());
                    sq_row(y + kBorder - kTemplateHalf - 1, sq.data() + cols);
                    for (int x = 0; x < cols; ++x) col[x] += sq[x] - sq[cols + x];
                }
                int32_t dist = 0;
                for (int x = 0; x < kTemplate - 1; ++x) dist += col[x];
                const uint8_t* p = job.padded + (size_t)(y + kBorder + dy) * pw + kBorder + dx;
                uint32_t* e = est.data() + (size_t)(y - r0) * w;
                uint32_t* s = wsum.data() + (size_t)(y - r0) * w;
                for (int x = 0; x < w; ++x) {
                    dist += col[x + kTemplate - 1];
                    const uint32_t weight = (uint32_t)job.table[dist >> kShift];
                    e[x] += weight * p[x];
                    s[x] += weight;
                    dist -= col[x];
                }
            }
        }
    }
    for (int y = r0; y < r1; ++y) {
        const uint32_t* e = est.data() + (size_t)(y - r0) * w;
        const uint32_t* s = wsum.data() + (size_t)(y - r0) * w;
        uint8_t* out = job.dst + (size_t)y * w;
        for (int x = 0; x < w; ++x) {
            const uint32_t v = (e[x] + s[x] / 2) / s[x];
            out[x] = (uint8_t)std::min<uint32_t>(v, 255u);
        }
    }
}

}  // namespace

extern "C" {

// dst = cv2.fastNlMeansDenoising(src, h=h) for an h x w grey image;
// threads <= 0 takes the machine's hardware threads.  Returns 0, or -1
// for an empty image.
int nl_means_u8(const uint8_t* src, int h, int w, float strength, uint8_t* dst, int threads) {
    if (h <= 0 || w <= 0) return -1;
    const int ph = h + 2 * kBorder, pw = w + 2 * kBorder;
    std::vector<uint8_t> padded((size_t)ph * pw);
    std::vector<int> xmap(pw);
    for (int x = 0; x < pw; ++x) xmap[x] = reflect101(x - kBorder, w);
    for (int y = 0; y < ph; ++y) {
        const uint8_t* row = src + (size_t)reflect101(y - kBorder, h) * w;
        uint8_t* out = padded.data() + (size_t)y * pw;
        for (int x = 0; x < pw; ++x) out[x] = row[xmap[x]];
    }

    const int window = 2 * kSearchHalf + 1;
    const int fpm = INT_MAX / (window * window * 255);
    const double mult = (double)(1 << kShift) / (kTemplate * kTemplate);
    const int table_size = (int)(255 * 255 / mult + 1);
    const float hh = strength * strength;  // float, as OpenCV squares h
    std::vector<int32_t> table(table_size);
    for (int a = 0; a < table_size; ++a) {
        double weight = std::exp(-(a * mult) / hh);
        if (std::isnan(weight)) weight = 1.0;  // h = 0
        int32_t v = (int32_t)std::nearbyint(fpm * weight);
        table[a] = v < 0.001 * fpm ? 0 : v;
    }

    Job job{padded.data(), h, w, pw, table.data(), dst};
    if (threads <= 0) threads = (int)std::max(1u, std::thread::hardware_concurrency());
    // Stripes of up to 64 rows, at least four a thread where the image
    // has the rows; each restarts its column sums (7 rows of overhead).
    const int stripe = std::max(8, std::min(64, (h + 4 * threads - 1) / (4 * threads)));
    const int stripes = (h + stripe - 1) / stripe;
    threads = std::min(threads, stripes);
    std::atomic<int> next(0);
    auto worker = [&]() {
        const int cols = w + 2 * kTemplateHalf;
        std::vector<uint32_t> est((size_t)stripe * w), wsum((size_t)stripe * w);
        std::vector<int32_t> col(cols), sq(2 * (size_t)cols);
        for (int k = next++; k < stripes; k = next++) {
            denoise_rows(job, k * stripe, std::min(h, (k + 1) * stripe), est, wsum, col, sq);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
    worker();
    for (auto& t : pool) t.join();
    return 0;
}

}  // extern "C"
