// The per-pixel step of the blended warp, shared by K2 (warp_pair.cu, every
// blend position of a pair) and K4 (warp_fused.cu, one position), and the
// one-direction raw sample of K5 (warp_sample.cu, sample_dir_pixel).
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
//     positive numerators is already the exact floor (no _div_exact).  At
//     the default levels (0, 255) both maps are the clip to the cap, which
//     levels_* takes directly (the same value, without the division).
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

// (int)(sign(x) * floor(|x| + 0.5)), in float32
__device__ __forceinline__ int iround(float x) {
  const float r = floorf(__fadd_rn(fabsf(x), 0.5f));
  return x > 0.f ? (int)r : (x < 0.f ? -(int)r : 0);
}

__device__ __forceinline__ unsigned blend_weight(float t, int frac) {
  const float one = (float)(1u << frac);
  float w = rintf(__fmul_rn(t, one));  // round half to even
  w = fminf(fmaxf(w, 0.0f), one);
  return (unsigned)w;
}

// int32 arithmetic, as the JAX maps compute (b <= 65535, so the
// numerators fit for any level in [-8000, 8000])
__device__ __forceinline__ unsigned levels_y(unsigned b, int ss, int k,
                                             int w) {
  const int cap = 255 << ss;
  if (k == 0 && w == 255) return min((int)b, cap);
  const int n = ((int)b - k * (1 << ss)) * 255;
  if (n <= 0) return 0;
  return min(n / max(w - k, 1), cap);
}

__device__ __forceinline__ unsigned levels_uv(unsigned b, int ss, int w) {
  const int cap = 255 << ss;
  if (w == 255) return min((int)b, cap);
  const int d = max(w, 1);
  const int m = 128 << ss;
  const int n = ((int)b - m) * 255 + m * d;
  if (n <= 0) return 0;
  return min(n / d, cap);
}

// The forward flow at output pixel (cx, cy)'s low-res cell and the reverse
// flow read back through it, as floats.
template <bool kChroma>
__device__ __forceinline__ void flow_at(const int* __restrict__ blurred,
                                        int cx, int cy, int lh, int lw,
                                        int rs, float* fx12, float* fy12,
                                        float* fx21, float* fy21) {
  int scx, scy;
  if (kChroma) {
    scx = min((cx >> rs) & ~1, lw - 1);
    scy = min((cy >> rs) << 1, lh - 1);
  } else {
    scx = min(cx >> rs, lw - 1);
    scy = min(cy >> rs, lh - 1);
  }
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

// One output sample of a plane (rows x Wa, sources of `pitch` samples a
// row) at blend position t12.
template <typename T, bool kChroma>
__device__ __forceinline__ T blend_pixel(const T* __restrict__ f1,
                                         const T* __restrict__ f2, int pitch,
                                         int rows, int Wa, int cx, int cy,
                                         float fx12, float fy12, float fx21,
                                         float fy21, float t12, int ss, int k,
                                         int w) {
  const float t21 = __fsub_rn(1.0f, t12);
  float dy12 = __fmul_rn(fy12, t12), dy21 = __fmul_rn(fy21, t21);
  if (kChroma) {
    dy12 = __fmul_rn(dy12, 0.5f);
    dy21 = __fmul_rn(dy21, 0.5f);
  }
  int x12 = mirror_edge2(cx + iround(__fmul_rn(fx12, t12)), Wa);
  int x21 = mirror_edge2(cx - iround(__fmul_rn(fx21, t21)), Wa);
  const int y12 = mirror_edge2(cy + iround(dy12), rows);
  const int y21 = mirror_edge2(cy - iround(dy21), rows);
  if (kChroma) {
    x12 = (x12 & ~1) + (cx & 1);
    x21 = (x21 & ~1) + (cx & 1);
  }
  const unsigned s12 = f1[(size_t)y12 * pitch + x12];
  const unsigned s21 = f2[(size_t)y21 * pitch + x21];
  const int frac = ss ? 16 : 24;
  const unsigned tw = blend_weight(t12, frac);
  const unsigned b = (s12 * ((1u << frac) - tw) + s21 * tw) >> frac;
  return (T)(kChroma ? levels_uv(b, ss, w) : levels_y(b, ss, k, w));
}

// One raw nearest sample of ONE direction (K5, warp_sample.cu): direction 12
// reads f1 at mirror_edge2(p + iround(flow12 * t)), direction 21 reads f2 at
// mirror_edge2(p - iround(flow21 * (1 - t))), with chroma's vertical
// product halved and its column addressed as in blend_pixel.  The products
// are those of blend_pixel, one __fmul_rn each; no blend, no levels, no cap.
template <typename T, bool kChroma>
__device__ __forceinline__ T sample_dir_pixel(const int* __restrict__ blurred,
                                              const T* __restrict__ src,
                                              int pitch, int rows, int Wa,
                                              int cx, int cy, int lh, int lw,
                                              int rs, float t12, bool dir21) {
  float fx12, fy12, fx21, fy21;
  flow_at<kChroma>(blurred, cx, cy, lh, lw, rs, &fx12, &fy12, &fx21, &fy21);
  const float s = dir21 ? __fsub_rn(1.0f, t12) : t12;
  const float fx = dir21 ? fx21 : fx12;
  float dy = __fmul_rn(dir21 ? fy21 : fy12, s);
  if (kChroma) dy = __fmul_rn(dy, 0.5f);
  int ddx = iround(__fmul_rn(fx, s));
  int ddy = iround(dy);
  if (dir21) {
    ddx = -ddx;
    ddy = -ddy;
  }
  int x = mirror_edge2(cx + ddx, Wa);
  const int y = mirror_edge2(cy + ddy, rows);
  if (kChroma) x = (x & ~1) + (cx & 1);
  return src[(size_t)y * pitch + x];
}

}  // namespace mfi
