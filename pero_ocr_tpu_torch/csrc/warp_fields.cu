// Field warp for Hopper (sm_90a): bilinear sampling of an (H, W, C) page,
// uint8 or float32 with C in {1, 3}, at precomputed (x, y) page
// coordinates, float32 pairs; crops stored as float32, or as uint8 rounded
// half to even and clamped to [0, 255].
//
// Replaces the Pallas TPU kernel `_warp_kernel` / `warp_lines_pallas`
// (pero_ocr_tpu/ops/warp.py:188, :223) in its own contract: the page and
// the dense field in, crops out, taps off the page read 0 (cv2.remap,
// BORDER_CONSTANT).  The stage-by-stage LineCropper packs all of a page's
// width buckets back to back in one field buffer (ops/warp.py
// `field_layout`) and runs this kernel once over it.  (csrc/warp_lines.cu
// is the fused special case of the page-transport path: gray pages,
// fields built in the kernel.)
//
// Bound: memory.  Each sample reads its 8-byte field entry, four taps of C
// page values (mostly from L1 and L2: neighbouring samples share them) and
// writes C values; the field alone is 8 of the 11 bytes a sample moves at
// C = 3 with the uint8 store (`warp_fields_bytes` in ops/warp.py counts
// the inputs' least traffic).  On the card the kernel is held back by its
// instructions more than by its bytes (PERF.md): every variant that
// traded loads for arithmetic was slower.  Design:
//
//  - warp-strided samples: warp g takes the 32 kVec samples from 32 kVec g
//    on, lane l of it the samples l + 32 k (kVec = 2), so that each load
//    and store instruction of a warp covers 32 consecutive samples: the
//    fields as 256 contiguous bytes, read with the streaming hint (__ldcs)
//    so that the once-read field does not push page lines out of L1 and
//    L2; the taps as the page bytes along 32 consecutive columns of a crop
//    row; the crops as 32 C contiguous values, float32 streamed out with
//    __stcs;
//  - each tap's C values read with __ldg, one load a value: in the A/B,
//    aligned word loads picked apart with __byte_perm, and several
//    consecutive samples a thread with float4 field loads and vector
//    stores, were slower (PERF.md);
//  - the uint8 store rounds by adding 2^23 (one add in place of a rounding
//    and a conversion), and offsets are 32-bit where the page and the
//    crops allow it: every instruction saved shows in the time;
//  - __launch_bounds__(256, 8): at most 32 registers, so 2048 threads an SM
//    are resident; no shared memory and no TMA: a tilted line's tap
//    footprint is not a rectangle, and the page (13.8 MB for a 2560x1792
//    BGR page) stays in the 50 MB L2.
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
constexpr int kMinBlocks = 8;
constexpr int kVec = 2;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float load(const uint8_t* p) { return (float)__ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

// The C values of page pixel (y, x), or zeros off the page.
template <typename PageT, int C, typename Index>
__device__ __forceinline__ void tap(const PageT* __restrict__ page, int h, int w, int y, int x,
                                    float* v) {
  if ((unsigned)y < (unsigned)h && (unsigned)x < (unsigned)w) {
    const PageT* p = page + ((Index)y * w + x) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = load(p + c);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
  }
}

// One sample's C values at (x, y).
template <typename PageT, int C, typename Index>
__device__ __forceinline__ void sample(const PageT* __restrict__ page, int h, int w, float x,
                                       float y, float* v) {
  if (!(isfinite(x) && isfinite(y))) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.0f;
    return;
  }
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = sub(x, x0), fy = sub(y, y0);
  // Clamp before the int conversion; a tap off the page reads 0 either way.
  const int xi = (int)fminf(fmaxf(x0, -2.0f), (float)w + 1.0f);
  const int yi = (int)fminf(fmaxf(y0, -2.0f), (float)h + 1.0f);
  float v00[C], v01[C], v10[C], v11[C];
  tap<PageT, C, Index>(page, h, w, yi, xi, v00);
  tap<PageT, C, Index>(page, h, w, yi, xi + 1, v01);
  tap<PageT, C, Index>(page, h, w, yi + 1, xi, v10);
  tap<PageT, C, Index>(page, h, w, yi + 1, xi + 1, v11);
  const float gx = sub(1.0f, fx), gy = sub(1.0f, fy);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float top = add(mul(v00[c], gx), mul(v01[c], fx));
    const float bot = add(mul(v10[c], gx), mul(v11[c], fx));
    v[c] = add(mul(top, gy), mul(bot, fy));
  }
}

// The stores: float32 as is; uint8 clamped, then 2^23 + v rounds half to
// even (v <= 255, so the sum's unit is 1) and leaves the byte in the low
// bits.
__device__ __forceinline__ void put(float* o, float v) { __stcs(o, v); }
__device__ __forceinline__ void put(uint8_t* o, float v) {
  *o = (uint8_t)__float_as_uint(add(fminf(fmaxf(v, 0.0f), 255.0f), 8388608.0f));
}

// Lane l of warp g takes the samples 32 kVec g + l + 32 k, k < kVec.
// Index: int where the page's values and the crops' fit in it, for fewer
// address instructions; else int64_t.
template <typename PageT, typename OutT, int C, typename Index>
__global__ void __launch_bounds__(kThreads, kMinBlocks) warp_fields_kernel(
    const PageT* __restrict__ page, const float2* __restrict__ fields,
    OutT* __restrict__ out, int h, int w, Index total) {
  const Index first = ((Index)blockIdx.x * kThreads + (threadIdx.x & ~31u)) * kVec +
                      (threadIdx.x & 31u);
  float2 xy[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (first + 32 * k < total) xy[k] = __ldcs(fields + first + 32 * k);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const Index t = first + 32 * k;
    if (t >= total) break;
    float v[C];
    sample<PageT, C, Index>(page, h, w, xy[k].x, xy[k].y, v);
#pragma unroll
    for (int c = 0; c < C; ++c) put(out + t * C + c, v[c]);
  }
}

template <typename PageT, typename OutT, int C, typename Index>
void launch_c(const void* page, const void* fields, void* out, int h, int w, int64_t total,
              unsigned blocks, cudaStream_t st) {
  warp_fields_kernel<PageT, OutT, C, Index><<<blocks, kThreads, 0, st>>>(
      (const PageT*)page, (const float2*)fields, (OutT*)out, h, w, (Index)total);
}

template <typename PageT, typename OutT>
cudaError_t launch(const void* page, const void* fields, void* out, int h, int w, int c,
                   int64_t total, cudaStream_t st) {
  const int64_t blocks = (total + kThreads * kVec - 1) / (kThreads * kVec);
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  // 32-bit offsets: the page's values, the crops' (C <= 3 a sample) and
  // the last warp's sample indices all below 2^31.
  const bool small = (int64_t)h * w * c < (1ll << 31) && (total + 32 * kVec) * 3 < (1ll << 31);
  if (c == 1) {
    small ? launch_c<PageT, OutT, 1, int>(page, fields, out, h, w, total, blocks, st)
          : launch_c<PageT, OutT, 1, int64_t>(page, fields, out, h, w, total, blocks, st);
  } else {
    small ? launch_c<PageT, OutT, 3, int>(page, fields, out, h, w, total, blocks, st)
          : launch_c<PageT, OutT, 3, int64_t>(page, fields, out, h, w, total, blocks, st);
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
