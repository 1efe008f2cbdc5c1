// The per-pixel step of the blended warp, shared by K2 (warp_pair.cu, every
// blend position of a pair) and K4 (warp_fused.cu, one position), and the
// one-direction raw sample of K5 (warp_sample.cu, sample_dir_pixel); the
// flow lookups and the rounded displacements their 16-byte runs compute once
// a flow cell (warp_runs.cuh).  G1 (blend_levels.cu) blends two raw samples
// with the same weight and level maps; G1's occlusion variant and Q1
// (warp_bilinear.cu, the 1/64-pel bilinear blend) add occlusion_adjust.
// V1 and V2 (warp_views.cu, the side-by-side and HSV views) compose
// flow_at, dir_displacement, blend_fix and the level maps per sample.
//
// The semantics are those of the JAX blended warp (ops/warp._warp_sample,
// mode 2), i.e. the reference's warpFrameKernel.cl with the fixed-point
// blend of ops/warp._blend_fix and the exact-integer level maps of
// ops/warp._levels_y / _levels_uv.  Per output pixel p of a plane and per
// blend position t:
//   * the flow at p's low-res cell (luma: (y >> rs, x >> rs); chroma:
//     ((y >> rs) << 1, (x >> rs) & ~1)) and the reverse flow read at that
//     cell minus the flow >> rs, clamped to the field (flow_at);
//   * f1 sampled at mirror_edge2(p + iround(flow12 * t)) and f2 at
//     mirror_edge2(p - iround(flow21 * (1 - t))), with chroma's vertical
//     component halved and its column addressed as (x' & ~1) + (x & 1)
//     in the interleaved plane (u on even columns, v on odd);
//   * b = (s12 * (2^F - T) + s21 * T) >> F in uint32, F = 24 - (8 if
//     scale_shift) and T = clip(round_half_even(t * 2^F), 0, 2^F): for
//     uint16 samples 65535 * 2^16 < 2^32, so the sum never wraps;
//   * luma: min(floor(max((b - (k << ss)) * 255, 0) / max(w - k, 1)),
//     255 << ss); chroma: with m = 128 << ss, min(floor(max((b - m) * 255
//     + m * w, 0) / max(w, 1)), 255 << ss), with (k, w) the black and
//     white levels rounded half to even by the caller.  C division of the
//     positive numerators is already the exact floor (no _div_exact), and
//     so is the multiply and shift (Divider) the kernels take in its
//     place.  At the default levels (0, 255) both maps are the clip to the
//     cap, which levels_* takes directly (the same value, without the
//     division).
// iround rounds half away from zero; every float product is rounded once
// (__fmul_rn, and the library is built with --fmad=false).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mfi {

__device__ __forceinline__ int mirror_edge2(int pos, int dim) {
  int res = pos >= dim - 1 ? pos - (pos - (dim - 2)) * 2 : pos;
  if (pos < 1) res = -pos + 1;
  return min(max(res, 1), dim - 2);
}

// (int)(sign(x) * floor(|x| + 0.5)), in float32, without a branch:
// round-to-nearest is symmetric, so x + copysign(0.5, x) is sign(x) times
// |x| + 0.5 as that sum rounds, and its truncation toward zero is
// sign(x) * floor(|x| + 0.5) (0 for x = 0)
__device__ __forceinline__ int iround(float x) {
  return __float2int_rz(__fadd_rn(x, copysignf(0.5f, x)));
}

__device__ __forceinline__ unsigned blend_weight(float t, int frac) {
  const float one = (float)(1u << frac);
  float w = rintf(__fmul_rn(t, one));  // round half to even
  w = fminf(fmaxf(w, 0.0f), one);
  return (unsigned)w;
}

// The quotient floor(n / d) of a level map, 0 <= n < 2^31, by a divisor
// d >= 1 fixed for a launch: one 32 x 32 -> 64-bit product and a shift,
// exact for every such n (Granlund and Montgomery 1994, theorem 4.2: with
// l = ceil(log2 d) and m = ceil(2^(31 + l) / d), 0 <= m d - 2^(31 + l) <
// d <= 2^l).  divider() makes it on the host.
struct Divider {
  int d;
  unsigned m;
  int sh;
  __device__ __forceinline__ int operator()(int n) const {
    return (int)(((unsigned long long)(unsigned)n * m) >> sh);
  }
};

inline Divider divider(int d) {
  int l = 0;
  while ((1ll << l) < d) ++l;
  return {d, (unsigned)(((1ull << (31 + l)) + d - 1) / d), 31 + l};
}

// A launch's black and white levels (k, w) and the divisors of its luma
// and chroma maps, max(w - k, 1) and max(w, 1) (host: levels(k, w)).
struct Levels {
  int k, w;
  Divider y, uv;
};

inline Levels levels(int k, int w) {
  return {k, w, divider(w - k > 1 ? w - k : 1), divider(w > 1 ? w : 1)};
}

// int32 arithmetic, as the JAX maps compute (b <= 65535, so the
// numerators fit for any level in [-8000, 8000])
__device__ __forceinline__ unsigned levels_y(unsigned b, int ss,
                                             const Levels& lv) {
  const int cap = 255 << ss;
  if (lv.k == 0 && lv.w == 255) return min((int)b, cap);
  const int n = ((int)b - lv.k * (1 << ss)) * 255;
  if (n <= 0) return 0;
  return min(lv.y(n), cap);
}

__device__ __forceinline__ unsigned levels_uv(unsigned b, int ss,
                                              const Levels& lv) {
  const int cap = 255 << ss;
  if (lv.w == 255) return min((int)b, cap);
  const int m = 128 << ss;
  const int n = ((int)b - m) * 255 + m * lv.uv.d;
  if (n <= 0) return 0;
  return min(lv.uv(n), cap);
}

// The occlusion correction of the hopperx families (ops/warp.
// _occlusion_adjust): with d8 = |s12 - s21| >> ss and a = clip((d8 - 32) *
// 4, 0, 256), (blended * (256 - a) + near * a) >> 8, near = s12 where the
// blend position is below 0.5, else s21.  blended <= 65535, so the products
// fit int32.
__device__ __forceinline__ int occlusion_adjust(int blended, int s12,
                                                int s21, bool near12,
                                                int ss) {
  const int near = near12 ? s12 : s21;
  const int a = min(max(((abs(s12 - s21) >> ss) - 32) * 4, 0), 256);
  return (blended * (256 - a) + near * a) >> 8;
}

// Output pixel (cx, cy)'s low-res flow cell: luma (cy >> rs, cx >> rs),
// chroma ((cy >> rs) << 1, (cx >> rs) & ~1), clamped to the field.
template <bool kChroma>
__device__ __forceinline__ void flow_cell(int cx, int cy, int lh, int lw,
                                          int rs, int* scx, int* scy) {
  if (kChroma) {
    *scx = min((cx >> rs) & ~1, lw - 1);
    *scy = min((cy >> rs) << 1, lh - 1);
  } else {
    *scx = min(cx >> rs, lw - 1);
    *scy = min(cy >> rs, lh - 1);
  }
}

// The forward flow at output pixel (cx, cy)'s low-res cell and the reverse
// flow read back through it, as floats.
template <bool kChroma>
__device__ __forceinline__ void flow_at(const int* __restrict__ blurred,
                                        int cx, int cy, int lh, int lw,
                                        int rs, float* fx12, float* fy12,
                                        float* fx21, float* fy21) {
  int scx, scy;
  flow_cell<kChroma>(cx, cy, lh, lw, rs, &scx, &scy);
  const int* bx = blurred;
  const int* by = blurred + (size_t)lh * lw;
  const int ox12 = bx[scy * lw + scx];
  const int oy12 = by[scy * lw + scx];
  const int bscy = min(max(scy - (oy12 >> rs), 0), lh - 1);
  const int bscx = min(max(scx - (ox12 >> rs), 0), lw - 1);
  *fx12 = (float)ox12;
  *fy12 = (float)oy12;
  *fx21 = (float)bx[bscy * lw + bscx];
  *fy21 = (float)by[bscy * lw + bscx];
}

// The flow of ONE direction at output pixel (cx, cy)'s low-res cell:
// direction 12 the forward flow there, direction 21 the reverse flow read
// back through it (flow_at's lookups; direction 12 reads no reverse flow).
template <bool kChroma>
__device__ __forceinline__ void flow_dir(const int* __restrict__ blurred,
                                         int cx, int cy, int lh, int lw,
                                         int rs, bool dir21, float* fx,
                                         float* fy) {
  int scx, scy;
  flow_cell<kChroma>(cx, cy, lh, lw, rs, &scx, &scy);
  const int* bx = blurred;
  const int* by = blurred + (size_t)lh * lw;
  int ox = bx[scy * lw + scx];
  int oy = by[scy * lw + scx];
  if (dir21) {
    const int bscy = min(max(scy - (oy >> rs), 0), lh - 1);
    const int bscx = min(max(scx - (ox >> rs), 0), lw - 1);
    ox = bx[bscy * lw + bscx];
    oy = by[bscy * lw + bscx];
  }
  *fx = (float)ox;
  *fy = (float)oy;
}

// The rounded displacement of one direction: (iround(fx * s),
// iround(fy * s [* 0.5 for chroma])), negated for direction 21 (backward),
// each product rounded once.
template <bool kChroma>
__device__ __forceinline__ void dir_displacement(float fx, float fy, float s,
                                                 bool backward, int* dx,
                                                 int* dy) {
  float a = __fmul_rn(fy, s);
  if (kChroma) a = __fmul_rn(a, 0.5f);
  const int x = iround(__fmul_rn(fx, s));
  const int y = iround(a);
  *dx = backward ? -x : x;
  *dy = backward ? -y : y;
}

// One raw nearest sample of ONE direction (K5's, and each of blend_pixel's
// two) at output pixel (cx, cy) displaced by (ddx, ddy) (dir_displacement
// of flow_dir at t for direction 12, at 1 - t for 21): the source at
// mirror_edge2(p + d), chroma's column addressed as (x' & ~1) + (cx & 1).
// No blend, no levels, no cap.
template <typename T, bool kChroma>
__device__ __forceinline__ T sample_dir_pixel(const T* __restrict__ src,
                                              int pitch, int rows, int Wa,
                                              int cx, int cy, int ddx,
                                              int ddy) {
  int x = mirror_edge2(cx + ddx, Wa);
  const int y = mirror_edge2(cy + ddy, rows);
  if (kChroma) x = (x & ~1) + (cx & 1);
  return src[(size_t)y * pitch + x];
}

// The fixed-point blend of two raw samples with weight tw of 2^frac
// (blend_weight): (s12 * (2^frac - tw) + s21 * tw) >> frac in uint32, with
// no level map (the views of warp_views.cu: V1 maps its levels after it,
// V2 recolours it first).
__device__ __forceinline__ unsigned blend_fix(unsigned s12, unsigned s21,
                                              unsigned tw, int frac) {
  return (s12 * ((1u << frac) - tw) + s21 * tw) >> frac;
}

// One blended output sample of a plane (rows x Wa, sources of `pitch`
// samples a row) at blend position t12, given the pixel's displacements
// (dir_displacement of the forward flow at t12 and of the reverse flow at
// 1 - t12): the two raw samples, the fixed-point blend and the level map.
template <typename T, bool kChroma>
__device__ __forceinline__ T blend_pixel(const T* __restrict__ f1,
                                         const T* __restrict__ f2, int pitch,
                                         int rows, int Wa, int cx, int cy,
                                         int dx12, int dy12, int dx21,
                                         int dy21, float t12, int ss,
                                         const Levels& lv) {
  const unsigned s12 =
      sample_dir_pixel<T, kChroma>(f1, pitch, rows, Wa, cx, cy, dx12, dy12);
  const unsigned s21 =
      sample_dir_pixel<T, kChroma>(f2, pitch, rows, Wa, cx, cy, dx21, dy21);
  const int frac = ss ? 16 : 24;
  const unsigned tw = blend_weight(t12, frac);
  const unsigned b = (s12 * ((1u << frac) - tw) + s21 * tw) >> frac;
  return (T)(kChroma ? levels_uv(b, ss, lv) : levels_y(b, ss, lv));
}

}  // namespace mfi
