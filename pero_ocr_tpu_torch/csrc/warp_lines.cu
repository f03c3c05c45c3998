// Line-crop warp for Hopper (sm_90a): warp fields built in the kernel,
// bilinear sampling of u8 grayscale pages, crops stored as float32 or
// bfloat16, optionally divided by 255.
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
// Bound: memory, by its least traffic: the page pixels that the taps
// touch, each read once, the geometry, and the crops written once
// (`warp_lines_bytes` in ops/warp.py counts them on the inputs).  At the
// main path's shapes (8 pages of 2560x1792, 320 lines of 32x1024) that
// is a few MB of page pixels against 21 MB of bf16 crops (42 MB in
// float32).  What limits it in practice is the instruction throughput
// and latency of the ~50 dependent instructions of each sample
// (coordinates, four byte gathers from L2, the blend), not the bytes.
// Design:
//
//  - one block of 256 threads per (line, 128-column tile), at most 40
//    registers a thread so that six blocks fit an SM: more warps in
//    flight hide more of the gathers' latency;
//  - the line's geometry is built once per block in shared memory, in
//    parallel where the steps are independent: the chord rotation, the
//    P rotated points and their segment lengths (a lane each); the arc
//    table (one lane: the same sequential sum as the plain version); the
//    crop_h row offsets (a lane each, so no thread divides per row); the
//    baseline position at the tile's 128 columns and one halo column on
//    each side (a lane each, with a bisection of the arc table: 130
//    interpolations instead of 3 a column); then each column's normal
//    from its neighbours' shared positions;
//  - a tile wholly beyond the arc skips the geometry and stores zeros;
//  - each thread samples 2 adjacent columns on every 4th row; the four
//    taps of a sample are loaded (__ldg) without per-tap bounds tests
//    when all four lie on the page, and bytes and integer-valued floats
//    are converted by exact bit tricks instead of the SMs' slower
//    conversion unit;
//  - each row's pair is stored as one float2 or __nv_bfloat162: a warp
//    writes 256 or 128 contiguous bytes a row;
//  - the division by 255 and the rounding to bf16 are done in the store,
//    so no float32 crop tensor is written and read again; the division
//    is the correctly rounded one without __fdiv_rn's slow path.
//
// The arithmetic is that of `warp_lines_plain` (ops/warp.py), a
// transcription of build_fields_device + _bilinear_gather, in the same
// order.  The _rn intrinsics keep nvcc from contracting a multiply and
// an add into one FMA, so each step rounds as the plain version's
// separate PyTorch ops do; the chord rotation and the lengths use only
// such correctly rounded steps (no atan2/cos/sin/hypot, whose last ulp
// differs between math libraries).  A value shared between lanes (a
// neighbour's position, a row offset) is computed once, by the same
// steps the plain version takes for it, so sharing changes no bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxPoints = 64;
constexpr int kMaxCropH = 64;
constexpr int kTile = 128;                      // columns per block
constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;                   // per SM: at most 40 registers
constexpr int kPairs = kTile / 2;               // two columns a thread
constexpr int kRowGroups = kThreads / kPairs;   // rows r, r + 4, ...
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

// jnp.interp(t, arc, fx) and jnp.interp(t, arc, fy) with constant
// extrapolation; x and y share the search and the fraction.
__device__ void interp2(float t, const float* arc, const float* fx, const float* fy,
                        int p, float* x, float* y) {
  // searchsorted(arc, t, side="right"), by bisection: arc is a running
  // sum of lengths, so it does not decrease.
  int lo = 0, hi = p;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (arc[mid] <= t) lo = mid + 1; else hi = mid;
  }
  const int i = min(max(lo, 1), p - 1);
  const float dx = sub(arc[i], arc[i - 1]);
  const bool flat = fabsf(dx) <= kInterpEps;
  const float q = flat ? 0.0f : dvd(sub(t, arc[i - 1]), dx);
  float xv = flat ? fx[i - 1] : add(fx[i - 1], mul(q, sub(fx[i], fx[i - 1])));
  float yv = flat ? fy[i - 1] : add(fy[i - 1], mul(q, sub(fy[i], fy[i - 1])));
  if (t < arc[0]) xv = fx[0], yv = fy[0];
  if (t > arc[p - 1]) xv = fx[p - 1], yv = fy[p - 1];
  *x = xv;
  *y = yv;
}

// A byte as a float, exactly: the bits of 2**23 + b, less 2**23.
__device__ __forceinline__ float u8f(uint32_t b) {
  return sub(__uint_as_float(0x4B000000u | b), 8388608.0f);
}

// An integer-valued float x, |x| < 2**22, as an int, exactly: x + 1.5 * 2**23
// has a unit last place, so its low mantissa bits are x + 2**22.
__device__ __forceinline__ int f2i_exact(float x) {
  return __float_as_int(add(x, 12582912.0f)) - 0x4B400000;
}

__device__ __forceinline__ uint32_t tap(const uint8_t* __restrict__ page, int h, int w,
                                        int y, int x) {
  return (unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w ? __ldg(page + (y * w + x)) : 0u;
}

// Bilinear sample at row offset v from a column's baseline point
// (xs, ys) along its normal (nx, ny), in the chord frame (c, s).
__device__ __forceinline__ float sample(const uint8_t* __restrict__ page, int h, int w,
                                        float xs, float ys, float nx, float ny, float v,
                                        float c, float s) {
  const float mx = add(mul(nx, v), xs), my = add(mul(ny, v), ys);
  // Back to the page frame: [mx, my] @ [[c, s], [-s, c]]
  const float px = add(mul(mx, c), mul(my, -s));
  const float py = add(mul(mx, s), mul(my, c));
  const float x0 = floorf(px), y0 = floorf(py);
  const float fx = sub(px, x0), fy = sub(py, y0);
  // Clamp before the int conversion; taps outside the page read 0
  // either way.
  const int xi = f2i_exact(fminf(fmaxf(x0, -2.0f), (float)w + 1.0f));
  const int yi = f2i_exact(fminf(fmaxf(y0, -2.0f), (float)h + 1.0f));
  uint32_t t00, t01, t10, t11;
  if ((unsigned)xi < (unsigned)(w - 1) && (unsigned)yi < (unsigned)(h - 1)) {
    const uint8_t* q = page + (yi * w + xi);  // all four taps inside
    t00 = __ldg(q);
    t01 = __ldg(q + 1);
    t10 = __ldg(q + w);
    t11 = __ldg(q + w + 1);
  } else {
    t00 = tap(page, h, w, yi, xi);
    t01 = tap(page, h, w, yi, xi + 1);
    t10 = tap(page, h, w, yi + 1, xi);
    t11 = tap(page, h, w, yi + 1, xi + 1);
  }
  const float top = add(mul(u8f(t00), sub(1.0f, fx)), mul(u8f(t01), fx));
  const float bot = add(mul(u8f(t10), sub(1.0f, fx)), mul(u8f(t11), fx));
  return add(mul(top, sub(1.0f, fy)), mul(bot, fy));
}

// v / 255 for 0 <= v <= 255, correctly rounded (what __fdiv_rn gives)
// without __fdiv_rn's range check and slow path: q = v * RN(1/255), then
// Markstein's correction by the exact remainder v - 255 q.
__device__ __forceinline__ float div255(float v) {
  const float kRcp255 = 0.0039215688593685627f;  // RN(1/255) = 0x3b808081
  const float q = __fmul_rn(v, kRcp255);
  return __fmaf_rn(__fmaf_rn(-255.0f, q, v), kRcp255, q);
}

// The store: one rounding to nearest even into the output type.
template <typename T> struct Out;
template <> struct Out<float> {
  using Pair = float2;
  static __device__ float one(float v) { return v; }
  static __device__ float2 two(float a, float b) { return make_float2(a, b); }
};
template <> struct Out<__nv_bfloat16> {
  using Pair = __nv_bfloat162;
  static __device__ __nv_bfloat16 one(float v) { return __float2bfloat16_rn(v); }
  static __device__ __nv_bfloat162 two(float a, float b) {
    return __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
  }
};

template <typename OutT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) warp_lines_kernel(
    const uint8_t* __restrict__ pages, const float* __restrict__ baselines,
    const float* __restrict__ heights, OutT* __restrict__ out, int h, int w,
    int n, int p, int crop_h, int bucket, int normalize) {
  const int line = blockIdx.x;
  const int j0 = blockIdx.y * kTile;
  const int tid = threadIdx.x;
  const uint8_t* page = pages + (int64_t)(line / n) * h * w;
  const float* bl = baselines + (int64_t)line * p * 2;
  const float h0 = heights[2 * line], h1 = heights[2 * line + 1];

  __shared__ float s_x[kMaxPoints], s_y[kMaxPoints], s_seg[kMaxPoints], s_arc[kMaxPoints];
  __shared__ float s_v[kMaxCropH];
  __shared__ float s_xs[kTile + 2], s_ys[kTile + 2];  // columns j0 - 1 .. j0 + kTile
  __shared__ float s_nx[kTile], s_ny[kTile];
  __shared__ bool s_ok[kTile];
  __shared__ float s_cos, s_sin, s_scale;

  // 1. Rotated points and segment lengths (lanes 0..p-1), row offsets
  //    (lanes 64..64+crop_h-1), the column scale (lane 128).
  if (tid < p) {
    // cos, sin of atan2(dy, dx) of the chord; atan2(0, 0) = 0.
    const float cx = sub(bl[2 * p - 2], bl[0]), cy = sub(bl[2 * p - 1], bl[1]);
    const float chord = length(cx, cy);
    const float c = chord > 0.0f ? dvd(cx, chord) : 1.0f;
    const float s = chord > 0.0f ? dvd(cy, chord) : 0.0f;
    // Chord frame: pts = bl @ [[c, s], [-s, c]].T
    const float x = add(mul(bl[2 * tid], c), mul(bl[2 * tid + 1], s));
    const float y = add(mul(bl[2 * tid], -s), mul(bl[2 * tid + 1], c));
    s_x[tid] = x;
    s_y[tid] = y;
    if (tid > 0) {
      const float xp = add(mul(bl[2 * tid - 2], c), mul(bl[2 * tid - 1], s));
      const float yp = add(mul(bl[2 * tid - 2], -s), mul(bl[2 * tid - 1], c));
      s_seg[tid] = length(sub(x, xp), sub(y, yp));
    } else {
      s_cos = c;
      s_sin = s;
    }
  } else if (tid >= kMaxPoints && tid < kMaxPoints + crop_h) {
    // jnp.linspace(-h0, h1, crop_h)[r]
    const int r = tid - kMaxPoints;
    if (r == crop_h - 1 && crop_h > 1) {
      s_v[r] = h1;
    } else {
      const float step = crop_h > 1 ? dvd((float)r, (float)(crop_h - 1)) : 0.0f;
      s_v[r] = add(mul(-h0, sub(1.0f, step)), mul(h1, step));
    }
  } else if (tid == 2 * kMaxPoints) {
    s_scale = dvd((float)crop_h, fmaxf(add(h0, h1), 1e-6f));
  }
  __syncthreads();

  // 2. The arc table: a sequential sum, as in the plain version.
  if (tid == 0) {
    float arc = 0.0f;
    s_arc[0] = arc;
    for (int k = 1; k < p; ++k) {
      arc = add(arc, s_seg[k]);
      s_arc[k] = arc;
    }
  }
  __syncthreads();

  const float scale = s_scale, arc_end = s_arc[p - 1];
  // t = j / scale rises with j: if the tile's first column lies beyond
  // the arc, so do all of them (block-uniform, so the barriers below
  // are reached by all threads or none).
  const bool live = dvd((float)j0, scale) <= arc_end;
  if (live) {
    // 3. Baseline position at columns j0 - 1 .. j0 + kTile.
    if (tid < kTile + 2) {
      const int jj = j0 - 1 + tid;
      if (jj >= 0 && jj < bucket) {
        const float t = dvd((float)jj, scale);
        interp2(t, s_arc, s_x, s_y, p, &s_xs[tid], &s_ys[tid]);
        if (tid >= 1 && tid <= kTile) s_ok[tid - 1] = t <= arc_end;
      }
    }
    __syncthreads();
    // 4. jnp.gradient's normal over the whole bucket: one-sided at
    //    j = 0 and j = bucket - 1, central between.
    if (tid < kTile) {
      const int j = j0 + tid;
      if (j < bucket && s_ok[tid]) {
        const int ia = j == 0 ? tid + 1 : tid, ib = j == bucket - 1 ? tid + 1 : tid + 2;
        float dx = sub(s_xs[ib], s_xs[ia]), dy = sub(s_ys[ib], s_ys[ia]);
        if (j != 0 && j != bucket - 1) {
          dx = mul(dx, 0.5f);
          dy = mul(dy, 0.5f);
        }
        const float nrm = fmaxf(length(dx, dy), 1e-6f);
        s_nx[tid] = dvd(-dy, nrm);
        s_ny[tid] = dvd(dx, nrm);
      }
    }
    __syncthreads();
  }

  // 5. Sampling: columns c0, c0 + 1 on rows group, group + 4, ...
  const int c0 = 2 * (tid % kPairs), group = tid / kPairs;
  const int j = j0 + c0;
  if (j >= bucket) return;
  const bool pair = j + 1 < bucket;  // else the odd tail column
  const bool ok0 = live && s_ok[c0], ok1 = live && pair && s_ok[c0 + 1];
  const float xs0 = s_xs[c0 + 1], ys0 = s_ys[c0 + 1], nx0 = s_nx[c0], ny0 = s_ny[c0];
  const float xs1 = s_xs[c0 + 2], ys1 = s_ys[c0 + 2], nx1 = s_nx[c0 + 1], ny1 = s_ny[c0 + 1];
  const float c = s_cos, s = s_sin;
  // An even bucket keeps every row's pair aligned for one vector store.
  const bool vec = (bucket & 1) == 0;
  OutT* o = out + (int64_t)line * crop_h * bucket + j;
#pragma unroll 4
  for (int r = group; r < crop_h; r += kRowGroups) {
    const float v = s_v[r];
    float a = ok0 ? sample(page, h, w, xs0, ys0, nx0, ny0, v, c, s) : 0.0f;
    float b = ok1 ? sample(page, h, w, xs1, ys1, nx1, ny1, v, c, s) : 0.0f;
    if (normalize) {
      a = div255(a);
      b = div255(b);
    }
    OutT* row = o + (int64_t)r * bucket;
    if (vec) {
      *reinterpret_cast<typename Out<OutT>::Pair*>(row) = Out<OutT>::two(a, b);
    } else {
      row[0] = Out<OutT>::one(a);
      if (pair) row[1] = Out<OutT>::one(b);
    }
  }
}

}  // namespace

// pages (pb, h, w) u8; baselines (pb * n, p, 2) f32; heights (pb * n, 2)
// f32; out (pb * n, crop_h, bucket) bf16 if out_bf16 else f32, each
// value divided by 255 if normalize.  All contiguous on one device.
// Launches on `stream` and returns the launch's cudaError_t (0 = ok).
extern "C" int warp_lines_u8(const void* pages, const void* baselines,
                             const void* heights, void* out, int pb, int h,
                             int w, int n, int p, int crop_h, int bucket,
                             int out_bf16, int normalize, void* stream) {
  // 32-bit page offsets and exact float-to-int conversions need
  // h * w < 2**31 and h, w < 2**22.
  if (p < 2 || p > kMaxPoints || crop_h < 1 || crop_h > kMaxCropH || bucket < 2 ||
      h < 1 || w < 1 || h >= (1 << 22) || w >= (1 << 22) || (int64_t)h * w >= (1LL << 31) ||
      pb < 0 || n < 0 || (bucket + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  if (pb * n == 0) return 0;
  const dim3 grid(pb * n, (bucket + kTile - 1) / kTile);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16) {
    warp_lines_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const uint8_t*)pages, (const float*)baselines, (const float*)heights,
        (__nv_bfloat16*)out, h, w, n, p, crop_h, bucket, normalize);
  } else {
    warp_lines_kernel<float><<<grid, kThreads, 0, st>>>(
        (const uint8_t*)pages, (const float*)baselines, (const float*)heights,
        (float*)out, h, w, n, p, crop_h, bucket, normalize);
  }
  return (int)cudaGetLastError();
}
