// Q1: one blended output of the hopperq / hopperxq families -- 1/64-pel
// bilinear samples of both directions, the float32 blend, the occlusion
// correction (hopperxq) and the level maps -- for Hopper (sm_90a).
//
// Not a TPU kernel: the JAX package samples these families with XLA, its
// shift-decomposed 1/64-pel sampler ops/warp._bilinear_all_planes
// (mpv_frame_interpolator_tpu/ops/warp.py:521-595, bit-identical to the
// gather path _bilinear_sample, :128-150) followed by the blend, occlusion
// and level maps of _warp_sample's bilinear branch (:1007-1018 luma,
// :1087-1105 chroma).  Per output sample, with fs12 = t and fs21 = 1 - t
// in float32:
//   * luma: f1 at (p << 6) + iround(flow12 * (fs12 * 64)) and f2 at
//     (p << 6) - iround(flow21 * (fs21 * 64)), in 1/64 pel, the flow and
//     the back-projected reverse flow at p's low-res cell (flow_at, as K2);
//   * chroma: in the planar half-width domain, column (cx >> 1) << 6 and
//     row cy << 6 plus iround(flow * (fs * 32)), the taps mirrored over
//     (H / 2, Wa / 2), u read from the even and v from the odd columns of
//     the interleaved plane; each output column takes the flow of its own
//     interleaved column (u and v share one flow cell);
//   * the taps at p >> 6 and (p >> 6) + 1 (an arithmetic shift, so it
//     floors), each mirrored with mirror_edge2, weighted by p & 63 in int32:
//     the sample in 1/4096 units (at most 65535 * 4096 < 2^31);
//   * b = floor((q12 * fs21 + q21 * fs12) * (1 / 4096) + 0.5) in the JAX
//     order, each int->float conversion, product and sum rounded once
//     (__int2float_rn, __fmul_rn, __fadd_rn, and the library is built with
//     --fmad=false): under P010 q reaches 65280 * 4096 > 2^24, where the
//     conversion rounds to nearest even, as XLA's does;
//   * hopperxq: s12 = floor(q12 / 4096 + 0.5), s21 likewise, then
//     occlusion_adjust(b, s12, s21, fs12 < 0.5);
//   * the level maps levels_y / levels_uv (warp_common.cuh).
// With the measured sub-pel flow (kFrac, the subpel_flow option: the
// bilinear branch of _warp_sample with its FX fields, :1021-1032 luma,
// :1113-1126 chroma) a (2, lh, lw) int32 field frac in 1/64 pel comes
// with the flow: the positions are (p << 6) + iround(float((flow12 << 6) +
// frac12) * fs12) and (p << 6) - iround(float((flow21 << 6) + frac21) *
// fs21), fs halved for chroma, with frac21 read at the SAME back-projected
// low-res cell as flow21.  At frac = 0 these are the positions above (the
// products differ from flow * (fs * 64) by an exact power of two).
//
// What bounds it: operations.  A 4K position reads the two source frames
// (2 x 12.4 MB at 8 bits) and writes one (12.4 MB), ~11 us at 3.35 TB/s;
// its ~80 scalar operations a sample (two positions of four products and
// roundings, eight mirrored taps and their addresses, twelve tap products,
// the float blend and the level map) take ~15 us at 67 TOP/s.  This first
// design is one thread a sample (a 32 x 8 block), every tap a separate
// load through L1; the 16-byte runs of K2/K5 (one flow lookup and one
// displacement a cell, aligned windows shared by neighbouring samples) are
// a later redesign.  One launch covers both planes, the luma block rows
// first, so the branch on the plane is uniform per block.  t is read on the
// device.

#include "warp_common.cuh"

namespace {

constexpr int kQX = 32, kQY = 8;

// The bilinear sample of a plane of dim_y x dim_x positions at (py, px)
// in 1/64 pel, in 1/4096 units (ops/warp._bilinear_sample).  Position x of
// the plane is source column x * cstep + cpar: luma (1, 0), the u or v
// samples of an interleaved chroma row (2, parity).
template <typename T>
__device__ __forceinline__ int bilinear_tap(const T* __restrict__ src,
                                            int pitch, int py, int px,
                                            int dim_y, int dim_x, int cstep,
                                            int cpar) {
  const int y0 = py >> 6, x0 = px >> 6;
  const int fy = py & 63, fx = px & 63;
  const T* r0 = src + (size_t)mfi::mirror_edge2(y0, dim_y) * pitch;
  const T* r1 = src + (size_t)mfi::mirror_edge2(y0 + 1, dim_y) * pitch;
  const int c0 = mfi::mirror_edge2(x0, dim_x) * cstep + cpar;
  const int c1 = mfi::mirror_edge2(x0 + 1, dim_x) * cstep + cpar;
  const int top = (int)r0[c0] * (64 - fx) + (int)r0[c1] * fx;
  const int bot = (int)r1[c0] * (64 - fx) + (int)r1[c1] * fx;
  return top * (64 - fy) + bot * fy;
}

template <typename T, bool kChroma, bool kOcclusion>
__device__ __forceinline__ void bilinear_pixel(
    const T* __restrict__ f1, const T* __restrict__ f2,
    const int* __restrict__ blurred, T* __restrict__ out, int pitch,
    int rows, int Wa, int lh, int lw, int rs, int cx, int cy, float t,
    int ss, int k, int w) {
  float fx12, fy12, fx21, fy21;
  mfi::flow_at<kChroma>(blurred, cx, cy, lh, lw, rs, &fx12, &fy12, &fx21,
                        &fy21);
  const float fs21 = __fsub_rn(1.0f, t);
  const float unit = kChroma ? 32.0f : 64.0f;
  const float s12 = __fmul_rn(t, unit), s21 = __fmul_rn(fs21, unit);
  const int bx = (kChroma ? cx >> 1 : cx) << 6;
  const int by = cy << 6;
  const int dim_x = kChroma ? Wa >> 1 : Wa;
  const int cstep = kChroma ? 2 : 1, cpar = kChroma ? cx & 1 : 0;
  const int q12 =
      bilinear_tap(f1, pitch, by + mfi::iround(__fmul_rn(fy12, s12)),
                   bx + mfi::iround(__fmul_rn(fx12, s12)), rows, dim_x,
                   cstep, cpar);
  const int q21 =
      bilinear_tap(f2, pitch, by - mfi::iround(__fmul_rn(fy21, s21)),
                   bx - mfi::iround(__fmul_rn(fx21, s21)), rows, dim_x,
                   cstep, cpar);
  const float a = __int2float_rn(q12), b = __int2float_rn(q21);
  constexpr float kInv = 1.0f / 4096.0f;
  const float val = __fmul_rn(__fadd_rn(__fmul_rn(a, fs21), __fmul_rn(b, t)),
                              kInv);
  int blended = (int)floorf(__fadd_rn(val, 0.5f));
  if (kOcclusion) {
    const int s12i = (int)floorf(__fadd_rn(__fmul_rn(a, kInv), 0.5f));
    const int s21i = (int)floorf(__fadd_rn(__fmul_rn(b, kInv), 0.5f));
    blended = mfi::occlusion_adjust(blended, s12i, s21i, t < 0.5f, ss);
  }
  out[(size_t)cy * Wa + cx] =
      (T)(kChroma ? mfi::levels_uv((unsigned)blended, ss, w)
                  : mfi::levels_y((unsigned)blended, ss, k, w));
}

// bilinear_pixel with the sub-pel field: each flow is (flow << 6) + frac
// at the same low-res cells (the reverse one through the back-projected
// cell), scaled by t and 1 - t (halved for chroma).  The rest is
// bilinear_pixel's, written out again: one function for both took
// bilinear_pixel from 26 to 32 registers.
template <typename T, bool kChroma, bool kOcclusion>
__device__ __forceinline__ void bilinear_pixel_frac(
    const T* __restrict__ f1, const T* __restrict__ f2,
    const int* __restrict__ blurred, const int* __restrict__ frac,
    T* __restrict__ out, int pitch, int rows, int Wa, int lh, int lw, int rs,
    int cx, int cy, float t, int ss, int k, int w) {
  int scx, scy;
  mfi::flow_cell<kChroma>(cx, cy, lh, lw, rs, &scx, &scy);
  const size_t plane = (size_t)lh * lw;
  const int c = scy * lw + scx;
  const int ox12 = blurred[c], oy12 = blurred[plane + c];
  const int bscy = min(max(scy - (oy12 >> rs), 0), lh - 1);
  const int bscx = min(max(scx - (ox12 >> rs), 0), lw - 1);
  const int r = bscy * lw + bscx;
  const float fs21 = __fsub_rn(1.0f, t);
  const float s12 = kChroma ? __fmul_rn(t, 0.5f) : t;
  const float s21 = kChroma ? __fmul_rn(fs21, 0.5f) : fs21;
  const int bx = (kChroma ? cx >> 1 : cx) << 6;
  const int by = cy << 6;
  const int dim_x = kChroma ? Wa >> 1 : Wa;
  const int cstep = kChroma ? 2 : 1, cpar = kChroma ? cx & 1 : 0;
  const int q12 = bilinear_tap(
      f1, pitch,
      by + mfi::iround(__fmul_rn(
               __int2float_rn(oy12 * 64 + frac[plane + c]), s12)),
      bx + mfi::iround(__fmul_rn(__int2float_rn(ox12 * 64 + frac[c]), s12)),
      rows, dim_x, cstep, cpar);
  const int q21 = bilinear_tap(
      f2, pitch,
      by - mfi::iround(__fmul_rn(
               __int2float_rn(blurred[plane + r] * 64 + frac[plane + r]),
               s21)),
      bx - mfi::iround(
               __fmul_rn(__int2float_rn(blurred[r] * 64 + frac[r]), s21)),
      rows, dim_x, cstep, cpar);
  const float a = __int2float_rn(q12), b = __int2float_rn(q21);
  constexpr float kInv = 1.0f / 4096.0f;
  const float val = __fmul_rn(__fadd_rn(__fmul_rn(a, fs21), __fmul_rn(b, t)),
                              kInv);
  int blended = (int)floorf(__fadd_rn(val, 0.5f));
  if (kOcclusion) {
    const int s12i = (int)floorf(__fadd_rn(__fmul_rn(a, kInv), 0.5f));
    const int s21i = (int)floorf(__fadd_rn(__fmul_rn(b, kInv), 0.5f));
    blended = mfi::occlusion_adjust(blended, s12i, s21i, t < 0.5f, ss);
  }
  out[(size_t)cy * Wa + cx] =
      (T)(kChroma ? mfi::levels_uv((unsigned)blended, ss, w)
                  : mfi::levels_y((unsigned)blended, ss, k, w));
}

template <typename T, bool kOcclusion, bool kFrac>
__global__ void __launch_bounds__(kQX * kQY) bilinear_blend_kernel(
    const T* __restrict__ f1y, const T* __restrict__ f1uv,
    const T* __restrict__ f2y, const T* __restrict__ f2uv,
    const int* __restrict__ blurred, const int* __restrict__ frac,
    const float* __restrict__ t, T* __restrict__ out_y,
    T* __restrict__ out_uv, int H, int Wa, int pitch, int lh, int lw, int rs,
    int luma_blocks, int ss, int k, int w) {
  const bool chroma = (int)blockIdx.y >= luma_blocks;
  const int cy = (chroma ? blockIdx.y - luma_blocks : blockIdx.y) * kQY +
                 threadIdx.y;
  const int cx = blockIdx.x * kQX + threadIdx.x;
  if (cx >= Wa) return;
  if constexpr (kFrac) {
    if (chroma) {
      if (cy < H / 2)
        bilinear_pixel_frac<T, true, kOcclusion>(f1uv, f2uv, blurred, frac,
                                                 out_uv, pitch, H / 2, Wa,
                                                 lh, lw, rs, cx, cy, *t, ss,
                                                 k, w);
    } else if (cy < H) {
      bilinear_pixel_frac<T, false, kOcclusion>(f1y, f2y, blurred, frac,
                                                out_y, pitch, H, Wa, lh, lw,
                                                rs, cx, cy, *t, ss, k, w);
    }
  } else if (chroma) {
    if (cy < H / 2)
      bilinear_pixel<T, true, kOcclusion>(f1uv, f2uv, blurred, out_uv, pitch,
                                          H / 2, Wa, lh, lw, rs, cx, cy, *t,
                                          ss, k, w);
  } else if (cy < H) {
    bilinear_pixel<T, false, kOcclusion>(f1y, f2y, blurred, out_y, pitch, H,
                                         Wa, lh, lw, rs, cx, cy, *t, ss, k, w);
  }
}

template <typename T, bool kOcclusion, bool kFrac>
int launch(const void* f1y, const void* f1uv, const void* f2y,
           const void* f2uv, const void* blurred, const void* frac,
           const void* t, void* out_y, void* out_uv, int H, int Wa, int pitch,
           int lh, int lw, int rs, int ss, int k, int w, cudaStream_t s) {
  const int luma_blocks = (H + kQY - 1) / kQY;
  const dim3 grid((Wa + kQX - 1) / kQX,
                  luma_blocks + (H / 2 + kQY - 1) / kQY);
  bilinear_blend_kernel<T, kOcclusion, kFrac><<<grid, dim3(kQX, kQY), 0, s>>>(
      static_cast<const T*>(f1y), static_cast<const T*>(f1uv),
      static_cast<const T*>(f2y), static_cast<const T*>(f2uv),
      static_cast<const int*>(blurred), static_cast<const int*>(frac),
      static_cast<const float*>(t), static_cast<T*>(out_y),
      static_cast<T*>(out_uv), H, Wa, pitch, lh, lw, rs, luma_blocks, ss, k,
      w);
  return (int)cudaGetLastError();
}

template <typename T>
using Launch = int (*)(const void*, const void*, const void*, const void*,
                       const void*, const void*, const void*, void*, void*,
                       int, int, int, int, int, int, int, int, int,
                       cudaStream_t);

template <typename T>
Launch<T> launch_for(bool occlusion, bool frac) {
  if (frac)
    return occlusion ? &launch<T, true, true> : &launch<T, false, true>;
  return occlusion ? &launch<T, true, false> : &launch<T, false, false>;
}

}  // namespace

// f1y, f2y (H, pitch) and f1uv, f2uv (H/2, pitch) interleaved sources;
// blurred (2, lh, lw) int32; frac null, or (2, lh, lw) int32 the sub-pel
// field in 1/64 pel; t one float on the device; out_y (H, Wa) and out_uv
// (H/2, Wa) interleaved; all contiguous, uint8 when ss == 0 and uint16
// when ss == 8; (k, w) the levels; occlusion 1 for hopperxq.
extern "C" int mfi_bilinear_blend(const void* f1y, const void* f1uv,
                                  const void* f2y, const void* f2uv,
                                  const void* blurred, const void* frac,
                                  const void* t, void* out_y, void* out_uv,
                                  int H, int Wa, int pitch, int lh, int lw,
                                  int rs, int ss, int k, int w, int occlusion,
                                  void* stream) {
  if (H < 6 || Wa < 6 || (Wa & 1) || pitch < Wa || lh < 1 || lw < 1 ||
      (ss != 0 && ss != 8))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ss)
    return launch_for<uint16_t>(occlusion, frac != nullptr)(
        f1y, f1uv, f2y, f2uv, blurred, frac, t, out_y, out_uv, H, Wa, pitch,
        lh, lw, rs, ss, k, w, s);
  return launch_for<uint8_t>(occlusion, frac != nullptr)(
      f1y, f1uv, f2y, f2uv, blurred, frac, t, out_y, out_uv, H, Wa, pitch, lh,
      lw, rs, ss, k, w, s);
}
