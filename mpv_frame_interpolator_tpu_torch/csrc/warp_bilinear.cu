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
// The design: K5's 16-byte runs (warp_runs.cuh).  A thread owns one
// 16-byte output run of one row, cut into flow-cell segments as K5 cuts
// it.  Within a segment the flow, the back-projected reverse cell, both
// 1/64-pel displacements d and the sub-pel terms are constant, and
// ((x << 6) + d) >> 6 == x + (d >> 6) with the weight d & 63 the same for
// every sample, so a segment computes once a tap offset and a weight pair
// a direction.  A segment is interior when both taps of every sample, in
// both rows y0 and y0 + 1 of both sources, lie where mirror_edge2 is the
// identity; it then reads, from each of its 2 rows x 2 sources, a window
// of kSeg + 1 samples (luma) or kSeg + 2 interleaved samples (chroma: the
// taps of column cx sit at cx + 2 (d >> 6) and two columns on, u and v
// from one window), built from the aligned 16-byte chunks around it
// (mfi::window_words: a word select and __funnelshift_r, never a load at
// an unaligned address), and every tap comes from registers.  A run whose
// segments are all interior writes one 16-byte store; every other run --
// and every run of a launch with vec == 0, or whose planes fail
// mfi::vector_ok -- takes the per-sample step (bilinear_tap at the
// segment's displacement, each tap mirrored and read from memory).  Both
// paths end in bilinear_mix, the one float order above.
//
// What bounds it: bytes.  A 4K position reads the two source frames (2 x
// 12.4 MB at 8 bits) and the ~1 MB flow once and writes one frame: ~11.5
// us at 3.35 TB/s (~22.6 us under P010).  With the cell's work shared, a
// sample needs ~28 operations (three products and sums a row pair and
// direction, the float blend, the level map; ~49 with the occlusion
// correction): ~5.2 us (~9.1 us) at 67 TOP/s -- a rate that counts an FMA
// as two, where this library, built with --fmad=false, issues each product
// and sum on its own.  The first design was one thread a sample,
// eight taps and four flow loads a sample through L1, at ~8.6x the bound;
// this one takes about a third of its time and stays ~3.5x the bound
// (PERF.md, Q1).  What holds it back is the four window reads a segment:
// on the card, variants without the tap arithmetic and the blend, or
// without the flow loads, were little faster, and exact rewrites of the
// taps (in float, or as __dp4a of the window words) and a stack of four
// runs a thread (fewer window rows, a quarter of the threads) were not.
// One launch covers both planes, the luma block rows first, so the branch
// on the plane is uniform per block.  t is read on the device.

#include "warp_runs.cuh"

namespace {

using mfi::kBX;
using mfi::kBY;

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

// The blend of the two directions' samples q12, q21 (1/4096 units) in the
// JAX order, the occlusion correction and the level map: one output sample.
template <bool kChroma, bool kOcclusion>
__device__ __forceinline__ unsigned bilinear_mix(int q12, int q21, float t,
                                                 float fs21, int ss,
                                                 const mfi::Levels& lv) {
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
  return kChroma ? mfi::levels_uv((unsigned)blended, ss, lv)
                 : mfi::levels_y((unsigned)blended, ss, lv);
}

// The 1/64-pel displacements d = {x12, y12, x21, y21} of the segment whose
// first output sample is (xs, cy): the flow at its low-res cell and the
// reverse flow at the back-projected cell, each product rounded once.
// With kFrac each flow is (flow << 6) + frac at the same cell, scaled by t
// (chroma t * 0.5); without, flow * (t * 64) (chroma t * 32).
template <bool kChroma, bool kFrac>
__device__ __forceinline__ void displacements(const int* __restrict__ blurred,
                                              const int* __restrict__ frac,
                                              int xs, int cy, int lh, int lw,
                                              int rs, float t, float fs21,
                                              int d[4]) {
  int scx, scy;
  mfi::flow_cell<kChroma>(xs, cy, lh, lw, rs, &scx, &scy);
  const size_t plane = (size_t)lh * lw;
  const int c = scy * lw + scx;
  const int ox12 = blurred[c], oy12 = blurred[plane + c];
  const int bscy = min(max(scy - (oy12 >> rs), 0), lh - 1);
  const int bscx = min(max(scx - (ox12 >> rs), 0), lw - 1);
  const int r = bscy * lw + bscx;
  const int ox21 = blurred[r], oy21 = blurred[plane + r];
  if constexpr (kFrac) {
    const float s12 = kChroma ? __fmul_rn(t, 0.5f) : t;
    const float s21 = kChroma ? __fmul_rn(fs21, 0.5f) : fs21;
    d[0] = mfi::iround(__fmul_rn(__int2float_rn(ox12 * 64 + frac[c]), s12));
    d[1] = mfi::iround(
        __fmul_rn(__int2float_rn(oy12 * 64 + frac[plane + c]), s12));
    d[2] = -mfi::iround(
        __fmul_rn(__int2float_rn(ox21 * 64 + frac[r]), s21));
    d[3] = -mfi::iround(
        __fmul_rn(__int2float_rn(oy21 * 64 + frac[plane + r]), s21));
  } else {
    const float unit = kChroma ? 32.0f : 64.0f;
    const float s12 = __fmul_rn(t, unit), s21 = __fmul_rn(fs21, unit);
    d[0] = mfi::iround(__fmul_rn(__int2float_rn(ox12), s12));
    d[1] = mfi::iround(__fmul_rn(__int2float_rn(oy12), s12));
    d[2] = -mfi::iround(__fmul_rn(__int2float_rn(ox21), s21));
    d[3] = -mfi::iround(__fmul_rn(__int2float_rn(oy21), s21));
  }
}

// The bilinear sample of window position j, its taps at j and j + kStep of
// the rows' windows r0 (row y0) and r1 (row y0 + 1), in 1/4096 units
template <typename T, int kStep>
__device__ __forceinline__ int window_tap(const unsigned* r0,
                                          const unsigned* r1, int j, int fx,
                                          int fy) {
  const int top = (int)mfi::sample_of<T>(r0, j) * (64 - fx) +
                  (int)mfi::sample_of<T>(r0, j + kStep) * fx;
  const int bot = (int)mfi::sample_of<T>(r1, j) * (64 - fx) +
                  (int)mfi::sample_of<T>(r1, j + kStep) * fx;
  return top * (64 - fy) + bot * fy;
}

// The blended run at (x0, cy) of one plane (rows x Wa samples, sources of
// `pitch` samples a row), written to `o` (the run's first output sample).
template <typename T, bool kChroma, bool kOcclusion, bool kFrac, int kLogSeg>
__device__ __forceinline__ void bilinear_run(
    const T* __restrict__ f1, const T* __restrict__ f2,
    const int* __restrict__ blurred, const int* __restrict__ frac, float t,
    T* __restrict__ o, int x0, int cy, int rows, int Wa, int pitch, int lh,
    int lw, int rs, int ss, const mfi::Levels& lv, int vec) {
  constexpr int item = sizeof(T);
  constexpr int kE = 16 / item;          // samples a run
  constexpr int kSeg = 1 << kLogSeg;
  constexpr int kNSeg = kE / kSeg;
  constexpr int kStep = kChroma ? 2 : 1;  // from a tap to the next one
  constexpr int kNeed = (kSeg + kStep) * item;  // window bytes
  constexpr int kW = (kNeed + 3) / 4;
  const float fs21 = __fsub_rn(1.0f, t);
  // planar positions: chroma is sampled on half the columns
  const int dim_x = kChroma ? Wa >> 1 : Wa;
  constexpr int kPlanarSeg = kChroma ? kSeg / 2 : kSeg;
  int d[kNSeg][4];
  bool interior = vec != 0;
#pragma unroll
  for (int g = 0; g < kNSeg; ++g) {
    const int xs = x0 + g * kSeg;
    displacements<kChroma, kFrac>(blurred, frac, xs, cy, lh, lw, rs, t, fs21,
                                  d[g]);
    // both taps of every sample, in rows y0 and y0 + 1: the planar
    // segment widened by one column and one row
    interior = interior &&
               mfi::segment_interior(
                   kChroma ? xs >> 1 : xs, kPlanarSeg + 1, cy,
                   min(d[g][0] >> 6, d[g][2] >> 6),
                   max(d[g][0] >> 6, d[g][2] >> 6),
                   min(d[g][1] >> 6, d[g][3] >> 6),
                   max(d[g][1] >> 6, d[g][3] >> 6) + 1, dim_x, rows);
  }
  if (interior) {
    unsigned r[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int g = 0; g < kNSeg; ++g) {
      const int xs = x0 + g * kSeg;
      const int y12 = cy + (d[g][1] >> 6), y21 = cy + (d[g][3] >> 6);
      const int sb12 = (xs + kStep * (d[g][0] >> 6)) * item;
      const int sb21 = (xs + kStep * (d[g][2] >> 6)) * item;
      const unsigned char* p1 = reinterpret_cast<const unsigned char*>(f1);
      const unsigned char* p2 = reinterpret_cast<const unsigned char*>(f2);
      const size_t row = (size_t)pitch * item;
      unsigned a0[kW], a1[kW], b0[kW], b1[kW];
      mfi::window_words<kW, kNeed>(p1 + y12 * row, sb12, a0);
      mfi::window_words<kW, kNeed>(p1 + (y12 + 1) * row, sb12, a1);
      mfi::window_words<kW, kNeed>(p2 + y21 * row, sb21, b0);
      mfi::window_words<kW, kNeed>(p2 + (y21 + 1) * row, sb21, b1);
      const int fx12 = d[g][0] & 63, fy12 = d[g][1] & 63;
      const int fx21 = d[g][2] & 63, fy21 = d[g][3] & 63;
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        const unsigned v = bilinear_mix<kChroma, kOcclusion>(
            window_tap<T, kStep>(a0, a1, j, fx12, fy12),
            window_tap<T, kStep>(b0, b1, j, fx21, fy21), t, fs21, ss, lv);
        const int i = g * kSeg + j;
        r[i / (4 / item)] |= v << (8 * item * (i % (4 / item)));
      }
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(r[0], r[1], r[2], r[3]);
    return;
  }
  // edge run (or no vector path): the per-sample step, a store a sample
  const int by = cy << 6;
#pragma unroll
  for (int g = 0; g < kNSeg; ++g) {
#pragma unroll 1
    for (int j = 0; j < kSeg; ++j) {
      const int cx = x0 + g * kSeg + j;
      if (cx >= Wa) return;
      const int bx = (kChroma ? cx >> 1 : cx) << 6;
      const int cpar = kChroma ? cx & 1 : 0;
      const int q12 = bilinear_tap(f1, pitch, by + d[g][1], bx + d[g][0],
                                   rows, dim_x, kStep, cpar);
      const int q21 = bilinear_tap(f2, pitch, by + d[g][3], bx + d[g][2],
                                   rows, dim_x, kStep, cpar);
      o[g * kSeg + j] =
          (T)bilinear_mix<kChroma, kOcclusion>(q12, q21, t, fs21, ss, lv);
    }
  }
}

template <typename T, bool kOcclusion, bool kFrac, int kLogSegY,
          int kLogSegC>
__global__ void __launch_bounds__(kBX * kBY) bilinear_blend_kernel(
    const T* __restrict__ f1y, const T* __restrict__ f1uv,
    const T* __restrict__ f2y, const T* __restrict__ f2uv,
    const int* __restrict__ blurred, const int* __restrict__ frac,
    const float* __restrict__ t, T* __restrict__ out_y,
    T* __restrict__ out_uv, int H, int Wa, int pitch, int lh, int lw, int rs,
    int luma_blocks, int ss, mfi::Levels lv, int vec) {
  constexpr int kE = 16 / sizeof(T);
  const bool chroma = (int)blockIdx.y >= luma_blocks;
  const int x0 = (blockIdx.x * kBX + threadIdx.x) * kE;
  const int cy = (chroma ? blockIdx.y - luma_blocks : blockIdx.y) * kBY +
                 threadIdx.y;
  const int rows = chroma ? H / 2 : H;
  if (x0 >= Wa || cy >= rows) return;
  const float t12 = *t;
  if (chroma)
    bilinear_run<T, true, kOcclusion, kFrac, kLogSegC>(
        f1uv, f2uv, blurred, frac, t12, out_uv + (size_t)cy * Wa + x0, x0, cy,
        rows, Wa, pitch, lh, lw, rs, ss, lv, vec);
  else
    bilinear_run<T, false, kOcclusion, kFrac, kLogSegY>(
        f1y, f2y, blurred, frac, t12, out_y + (size_t)cy * Wa + x0, x0, cy,
        rows, Wa, pitch, lh, lw, rs, ss, lv, vec);
}

template <bool kOcclusion, bool kFrac>
struct Variant {
  template <typename T, int kLogSegY, int kLogSegC>
  struct Launch {
    static int run(const void* f1y, const void* f1uv, const void* f2y,
                   const void* f2uv, const void* blurred, const void* frac,
                   const void* t, void* out_y, void* out_uv, int H, int Wa,
                   int pitch, int lh, int lw, int rs, int ss, int k, int w,
                   int vec, cudaStream_t s) {
      int luma_blocks;
      const dim3 grid = mfi::two_plane_grid<T>(H, Wa, &luma_blocks);
      bilinear_blend_kernel<T, kOcclusion, kFrac, kLogSegY, kLogSegC>
          <<<grid, dim3(kBX, kBY), 0, s>>>(
              static_cast<const T*>(f1y), static_cast<const T*>(f1uv),
              static_cast<const T*>(f2y), static_cast<const T*>(f2uv),
              static_cast<const int*>(blurred), static_cast<const int*>(frac),
              static_cast<const float*>(t), static_cast<T*>(out_y),
              static_cast<T*>(out_uv), H, Wa, pitch, lh, lw, rs, luma_blocks,
              ss, mfi::levels(k, w), vec);
      return (int)cudaGetLastError();
    }
  };
};

template <typename T, bool kOcclusion, bool kFrac>
int launch(const void* f1y, const void* f1uv, const void* f2y,
           const void* f2uv, const void* blurred, const void* frac,
           const void* t, void* out_y, void* out_uv, int H, int Wa, int pitch,
           int lh, int lw, int rs, int ss, int k, int w, int vec,
           cudaStream_t s) {
  const int item = (int)sizeof(T);
  const void* planes[] = {f1y, f1uv, f2y, f2uv, out_y, out_uv};
  if (vec && !mfi::vector_ok(planes, 6, pitch * item, Wa * item))
    return (int)cudaErrorMisalignedAddress;
  return mfi::dispatch_segments<T,
                                Variant<kOcclusion, kFrac>::template Launch>(
      rs, f1y, f1uv, f2y, f2uv, blurred, frac, t, out_y, out_uv, H, Wa, pitch,
      lh, lw, rs, ss, k, w, vec, s);
}

template <typename T>
using LaunchFn = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, const void*, void*, void*,
                         int, int, int, int, int, int, int, int, int, int,
                         cudaStream_t);

template <typename T>
LaunchFn<T> launch_for(bool occlusion, bool frac) {
  if (frac)
    return occlusion ? &launch<T, true, true> : &launch<T, false, true>;
  return occlusion ? &launch<T, true, false> : &launch<T, false, false>;
}

}  // namespace

// f1y, f2y (H, pitch) and f1uv, f2uv (H/2, pitch) interleaved sources;
// blurred (2, lh, lw) int32; frac null, or (2, lh, lw) int32 the sub-pel
// field in 1/64 pel; t one float on the device; out_y (H, Wa) and out_uv
// (H/2, Wa) interleaved; all contiguous, uint8 when ss == 0 and uint16
// when ss == 8; (k, w) the levels; occlusion 1 for hopperxq; vec: 1 for
// the 16-byte runs (refused unless every plane pointer is 16-byte aligned
// and pitch and Wa are rows of a multiple of 16 bytes), 0 for the
// per-sample step in every run.
extern "C" int mfi_bilinear_blend(const void* f1y, const void* f1uv,
                                  const void* f2y, const void* f2uv,
                                  const void* blurred, const void* frac,
                                  const void* t, void* out_y, void* out_uv,
                                  int H, int Wa, int pitch, int lh, int lw,
                                  int rs, int ss, int k, int w, int occlusion,
                                  int vec, void* stream) {
  if (H < 6 || Wa < 6 || (Wa & 1) || pitch < Wa || lh < 1 || lw < 1 ||
      (ss != 0 && ss != 8))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ss)
    return launch_for<uint16_t>(occlusion, frac != nullptr)(
        f1y, f1uv, f2y, f2uv, blurred, frac, t, out_y, out_uv, H, Wa, pitch,
        lh, lw, rs, ss, k, w, vec, s);
  return launch_for<uint8_t>(occlusion, frac != nullptr)(
      f1y, f1uv, f2y, f2uv, blurred, frac, t, out_y, out_uv, H, Wa, pitch, lh,
      lw, rs, ss, k, w, vec, s);
}
