// Line-crop warp for Hopper (sm_90a): fields built in the kernel, bilinear
// sampling of u8 grayscale pages.
//
// Replaces the Pallas TPU kernel `_warp_kernel` / `warp_lines_pallas`
// (pero_ocr_tpu/ops/warp.py:188, :223), which samples a page held whole
// in VMEM at the coordinates of a dense (N, Hc, Wb, 2) warp field that
// `build_fields_device` (:126-182) stores first.  Here:
//
//  - the page stays in global memory (one grayscale byte per pixel, read
//    through L2), so there is no page-size cap;
//  - the field is built inside the kernel from each line's P baseline
//    points and two heights and never stored;
//  - one channel is warped (the caller broadcasts the crop to the
//    recognizer's three identical channels).
//
// Bound: memory.  Each output pixel is four byte gathers from an
// L2-resident page and ~30 float operations; the least traffic is one
// read of the page and one write of the f32 crops, which at the main
// path's shapes (8 pages of 2560x1792, 320 lines of 32x1024) is ~79 MB,
// ~23 us at 3.35 TB/s.  Design: one block of 128 threads per (line,
// 128-column tile); thread 0 computes the line's chord rotation and arc
// table into shared memory; each thread then builds its column's
// baseline position and normal once and walks the Hc rows, so the
// per-column interpolation is paid once and the stores of a warp are
// coalesced along the columns.
//
// The arithmetic is that of `warp_lines_plain` (ops/warp.py), a
// transcription of build_fields_device + _bilinear_gather, in the same
// order.  The _rn intrinsics keep nvcc from contracting a multiply and
// an add into one FMA, so each step rounds as the plain version's
// separate PyTorch ops do; the chord rotation and the lengths use only
// such correctly rounded steps (no atan2/cos/sin/hypot, whose last ulp
// differs between math libraries).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxPoints = 64;
constexpr int kThreads = 128;
// jnp.interp treats an arc step |dx| <= np.spacing(float32 eps) = 2**-46
// as zero length.
constexpr float kInterpEps = 1.4210854715202004e-14f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// hypot as sqrt(a*a + b*b), every step correctly rounded.
__device__ __forceinline__ float length(float a, float b) {
  return __fsqrt_rn(add(mul(a, a), mul(b, b)));
}

// jnp.interp(t, arc, fp) with constant extrapolation.
__device__ float interp(float t, const float* arc, const float* fp, int p) {
  int i = 0;
  while (i < p && arc[i] <= t) ++i;  // searchsorted(arc, t, side="right")
  i = min(max(i, 1), p - 1);
  const float df = sub(fp[i], fp[i - 1]);
  const float dx = sub(arc[i], arc[i - 1]);
  const float delta = sub(t, arc[i - 1]);
  float f = fabsf(dx) <= kInterpEps ? fp[i - 1] : add(fp[i - 1], mul(dvd(delta, dx), df));
  if (t < arc[0]) f = fp[0];
  if (t > arc[p - 1]) f = fp[p - 1];
  return f;
}

__device__ __forceinline__ float tap(const uint8_t* page, int h, int w, int y, int x) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? (float)page[(int64_t)y * w + x] : 0.0f;
}

__global__ void __launch_bounds__(kThreads) warp_lines_kernel(
    const uint8_t* __restrict__ pages, const float* __restrict__ baselines,
    const float* __restrict__ heights, float* __restrict__ out, int h, int w,
    int n, int p, int crop_h, int bucket) {
  const int line = blockIdx.x;
  const uint8_t* page = pages + (int64_t)(line / n) * h * w;
  __shared__ float s_x[kMaxPoints], s_y[kMaxPoints], s_arc[kMaxPoints];
  __shared__ float s_cos, s_sin, s_scale;

  if (threadIdx.x == 0) {
    const float* bl = baselines + (int64_t)line * p * 2;
    // cos, sin of atan2(dy, dx) of the chord; atan2(0, 0) = 0.
    const float cx = sub(bl[2 * p - 2], bl[0]), cy = sub(bl[2 * p - 1], bl[1]);
    const float chord = length(cx, cy);
    const float c = chord > 0.0f ? dvd(cx, chord) : 1.0f;
    const float s = chord > 0.0f ? dvd(cy, chord) : 0.0f;
    float arc = 0.0f;
    for (int k = 0; k < p; ++k) {
      // Chord frame: pts = bl @ [[c, s], [-s, c]].T
      const float x = add(mul(bl[2 * k], c), mul(bl[2 * k + 1], s));
      const float y = add(mul(bl[2 * k], -s), mul(bl[2 * k + 1], c));
      if (k > 0) arc = add(arc, length(sub(x, s_x[k - 1]), sub(y, s_y[k - 1])));
      s_x[k] = x;
      s_y[k] = y;
      s_arc[k] = arc;
    }
    s_cos = c;
    s_sin = s;
    s_scale = dvd((float)crop_h, fmaxf(add(heights[2 * line], heights[2 * line + 1]), 1e-6f));
  }
  __syncthreads();

  const int j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= bucket) return;
  float* o = out + (int64_t)line * crop_h * bucket + j;
  const float scale = s_scale;
  const float t = dvd((float)j, scale);
  if (!(t <= s_arc[p - 1])) {  // beyond the arc: the padded tail reads 0
    for (int r = 0; r < crop_h; ++r) o[(int64_t)r * bucket] = 0.0f;
    return;
  }

  // Baseline position at this column and jnp.gradient's normal, over the
  // whole bucket: one-sided at j = 0 and j = bucket - 1, central between.
  const float xs = interp(t, s_arc, s_x, p), ys = interp(t, s_arc, s_y, p);
  const int ja = j == 0 ? 0 : j - 1, jb = j == bucket - 1 ? j : j + 1;
  const float ta = dvd((float)ja, scale), tb = dvd((float)jb, scale);
  float dx = sub(interp(tb, s_arc, s_x, p), interp(ta, s_arc, s_x, p));
  float dy = sub(interp(tb, s_arc, s_y, p), interp(ta, s_arc, s_y, p));
  if (j != 0 && j != bucket - 1) {
    dx = mul(dx, 0.5f);
    dy = mul(dy, 0.5f);
  }
  const float nrm = fmaxf(length(dx, dy), 1e-6f);
  const float nx = dvd(-dy, nrm), ny = dvd(dx, nrm);

  const float h0 = heights[2 * line], h1 = heights[2 * line + 1];
  const float c = s_cos, s = s_sin;
  for (int r = 0; r < crop_h; ++r) {
    // jnp.linspace(-h0, h1, crop_h)[r]
    float v;
    if (r == crop_h - 1 && crop_h > 1) {
      v = h1;
    } else {
      const float step = crop_h > 1 ? dvd((float)r, (float)(crop_h - 1)) : 0.0f;
      v = add(mul(-h0, sub(1.0f, step)), mul(h1, step));
    }
    const float mx = add(mul(nx, v), xs), my = add(mul(ny, v), ys);
    // Back to the page frame: [mx, my] @ [[c, s], [-s, c]]
    const float px = add(mul(mx, c), mul(my, -s));
    const float py = add(mul(mx, s), mul(my, c));
    const float x0 = floorf(px), y0 = floorf(py);
    const float fx = sub(px, x0), fy = sub(py, y0);
    // Clamp before the int conversion; taps outside the page read 0
    // either way.
    const int xi = (int)fminf(fmaxf(x0, -2.0f), (float)w + 1.0f);
    const int yi = (int)fminf(fmaxf(y0, -2.0f), (float)h + 1.0f);
    const float top = add(mul(tap(page, h, w, yi, xi), sub(1.0f, fx)),
                          mul(tap(page, h, w, yi, xi + 1), fx));
    const float bot = add(mul(tap(page, h, w, yi + 1, xi), sub(1.0f, fx)),
                          mul(tap(page, h, w, yi + 1, xi + 1), fx));
    o[(int64_t)r * bucket] = add(mul(top, sub(1.0f, fy)), mul(bot, fy));
  }
}

}  // namespace

// pages (pb, h, w) u8; baselines (pb * n, p, 2) f32; heights (pb * n, 2)
// f32; out (pb * n, crop_h, bucket) f32.  All contiguous on one device.
// Launches on `stream` and returns the launch's cudaError_t (0 = ok).
extern "C" int warp_lines_u8(const void* pages, const void* baselines,
                             const void* heights, void* out, int pb, int h,
                             int w, int n, int p, int crop_h, int bucket,
                             void* stream) {
  if (p < 2 || p > kMaxPoints || crop_h < 1 || bucket < 2 || h < 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  if (pb * n == 0) return 0;
  const dim3 grid(pb * n, (bucket + kThreads - 1) / kThreads);
  warp_lines_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pages, (const float*)baselines, (const float*)heights,
      (float*)out, h, w, n, p, crop_h, bucket);
  return (int)cudaGetLastError();
}
