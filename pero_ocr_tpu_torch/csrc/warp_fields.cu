// Field warp for Hopper (sm_90a): bilinear sampling of an (H, W, C) page,
// uint8 or float32 with C in {1, 3}, at a precomputed (N, Hc, Wb, 2)
// field of (x, y) page coordinates; crops stored as float32, or as uint8
// rounded half to even and clamped to [0, 255].
//
// Replaces the Pallas TPU kernel `_warp_kernel` / `warp_lines_pallas`
// (pero_ocr_tpu/ops/warp.py:188, :223) in its own contract: the page and
// the dense field in, (N, Hc, Wb, C) crops out, taps off the page read 0
// (cv2.remap, BORDER_CONSTANT).  The stage-by-stage LineCropper runs it
// once per width bucket on the colour page, with fields from
// core/line_geometry.py's polynomial fit.  (csrc/warp_lines.cu is the fused
// special case of the page-transport path: gray pages, fields built in the
// kernel.)
//
// Bound: memory.  Each sample reads its 8-byte field entry, four taps of C
// page values (mostly from L2: neighbouring samples share them) and writes
// C values; the field alone is 8 of the 11 bytes a sample moves at C = 3
// with the uint8 store (`warp_fields_bytes` in ops/warp.py counts the
// inputs' least traffic).  Design, kept simple and right first:
//
//  - one thread per output pixel (x, y, line), 256 threads a block over the
//    flattened N * Hc * Wb samples, so neighbouring threads read
//    neighbouring field entries (one float2 each, coalesced) and write
//    neighbouring crop pixels;
//  - the page is read through the read-only cache (__ldg), each tap's C
//    values from one pixel's contiguous bytes or floats;
//  - no shared memory: consecutive samples of a line touch nearby pixels,
//    which L1 and L2 serve.
//
// The arithmetic is `warp_fields_plain`'s (ops/warp.py), a transcription
// of `_bilinear_gather` (pero_ocr_tpu/ops/warp.py:32-62) widened to C
// channels, step for step: the _rn intrinsics keep nvcc from contracting a
// multiply and an add into one FMA, so each step rounds as the plain
// version's separate PyTorch ops do.  Defined edge cases, the same on both
// sides: a non-finite x or y samples 0; the floor of a coordinate is
// clamped to [-2, W + 1] (rows [-2, H + 1]) before the integer conversion,
// so padded columns (-1e6) and coordinates beyond int32 read 0 like any tap
// off the page.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float load(const uint8_t* p) { return (float)__ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

// The C values of page pixel (y, x), or zeros off the page.
template <typename PageT, int C>
__device__ __forceinline__ void tap(const PageT* __restrict__ page, int h, int w, int y, int x,
                                    float* v) {
  if ((unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w) {
    const PageT* p = page + ((int64_t)y * w + x) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = load(p + c);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
  }
}

// The store: float32 as is, or uint8 = clamp(round half to even).
__device__ __forceinline__ void put(float* o, float v) { *o = v; }
__device__ __forceinline__ void put(uint8_t* o, float v) {
  *o = (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

template <typename PageT, typename OutT, int C>
__global__ void __launch_bounds__(kThreads) warp_fields_kernel(
    const PageT* __restrict__ page, const float2* __restrict__ fields,
    OutT* __restrict__ out, int h, int w, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const float2 f = fields[i];
  OutT* o = out + i * C;
  if (!(isfinite(f.x) && isfinite(f.y))) {
#pragma unroll
    for (int c = 0; c < C; ++c) put(o + c, 0.0f);
    return;
  }
  const float x0 = floorf(f.x), y0 = floorf(f.y);
  const float fx = sub(f.x, x0), fy = sub(f.y, y0);
  // Clamp before the int conversion; a tap off the page reads 0 either way.
  const int xi = (int)fminf(fmaxf(x0, -2.0f), (float)w + 1.0f);
  const int yi = (int)fminf(fmaxf(y0, -2.0f), (float)h + 1.0f);
  float v00[C], v01[C], v10[C], v11[C];
  tap<PageT, C>(page, h, w, yi, xi, v00);
  tap<PageT, C>(page, h, w, yi, xi + 1, v01);
  tap<PageT, C>(page, h, w, yi + 1, xi, v10);
  tap<PageT, C>(page, h, w, yi + 1, xi + 1, v11);
  const float gx = sub(1.0f, fx), gy = sub(1.0f, fy);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float top = add(mul(v00[c], gx), mul(v01[c], fx));
    const float bot = add(mul(v10[c], gx), mul(v11[c], fx));
    put(o + c, add(mul(top, gy), mul(bot, fy)));
  }
}

template <typename PageT, typename OutT>
cudaError_t launch(const void* page, const void* fields, void* out, int h, int w, int c,
                   int64_t total, cudaStream_t st) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const PageT* pg = (const PageT*)page;
  const float2* fl = (const float2*)fields;
  if (c == 1) {
    warp_fields_kernel<PageT, OutT, 1><<<(unsigned)blocks, kThreads, 0, st>>>(
        pg, fl, (OutT*)out, h, w, total);
  } else {
    warp_fields_kernel<PageT, OutT, 3><<<(unsigned)blocks, kThreads, 0, st>>>(
        pg, fl, (OutT*)out, h, w, total);
  }
  return cudaGetLastError();
}

}  // namespace

// page (h, w, c) uint8, or float32 if page_f32; fields (total, 2) float32,
// 8-byte aligned; out (total, c) uint8 if out_u8, else float32.  All
// contiguous on one device.  Launches on `stream` and returns the launch's
// cudaError_t (0 = ok).
extern "C" int warp_fields(const void* page, const void* fields, void* out, int h, int w,
                           int c, long long total, int page_f32, int out_u8, void* stream) {
  if (h < 1 || w < 1 || h >= (1 << 22) || w >= (1 << 22) || (c != 1 && c != 3) || total < 0)
    return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (page_f32) {
    err = out_u8 ? launch<float, uint8_t>(page, fields, out, h, w, c, total, st)
                 : launch<float, float>(page, fields, out, h, w, c, total, st);
  } else {
    err = out_u8 ? launch<uint8_t, uint8_t>(page, fields, out, h, w, c, total, st)
                 : launch<uint8_t, float>(page, fields, out, h, w, c, total, st);
  }
  return (int)err;
}
