// Every blended output of one source pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel mpv_frame_interpolator_tpu/ops/pallas/
// warp_pair.py:pair_blend_plane (reached through blended_pair_from_prep);
// the semantics are those of the JAX blended warp (ops/warp._warp_sample,
// mode 2, 8-bit, default levels), i.e. the reference's warpFrameKernel.cl
// with the fixed-point blend of ops/oracle.blend_weights.  Per output
// pixel p of a plane and per blend position t:
//   * the flow at p's low-res cell (luma: (y >> rs, x >> rs); chroma:
//     ((y >> rs) << 1, (x >> rs) & ~1)) and the reverse flow read at that
//     cell minus the flow >> rs, clamped to the field;
//   * f1 sampled at mirror_edge2(p + iround(flow12 * t)) and f2 at
//     mirror_edge2(p - iround(flow21 * (1 - t))), with chroma's vertical
//     component halved and its column addressed as (x' & ~1) + (x & 1)
//     in the interleaved NV12 plane;
//   * out = (s12 * (2^24 - T) + s21 * T) >> 24 in uint32, with
//     T = clip(round_half_even(t * 2^24), 0, 2^24), clipped to 255.
// iround rounds half away from zero; every float product is rounded once
// (__fmul_rn, and the library is built with --fmad=false).
//
// What bounds it: at 4K with five positions a pair writes 5 x 12.4 MB and
// reads two nearest samples per output byte from sources that stay in the
// 50 MB L2 -- about 62 MB written and ~25 MB of distinct reads, ~26 us at
// the card's 3.35 TB/s.  This first form moves one byte per load and per
// store, so it is bound by the instruction count of those byte accesses
// instead (0.28 ms per 4K pair on an H100 SXM, about a tenth of the
// bandwidth); packing 4-16 output bytes per thread is the next step.  The
// design keeps the loop over the N positions inside the thread, so the
// flow and reverse-flow lookups are read once per pixel, not once per
// output.
//
// None of the TPU kernel's machinery is needed: no padded tile sources,
// no distinct-displacement tables or their budget, no packed-byte
// selects, no aligned DMA with rolls.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ unsigned blend_weight(float t) {
  float w = rintf(__fmul_rn(t, 16777216.0f));  // round half to even
  w = fminf(fmaxf(w, 0.0f), 16777216.0f);
  return (unsigned)w;
}

template <bool kChroma>
__global__ void pair_blend_kernel(const uint8_t* __restrict__ f1,
                                  const uint8_t* __restrict__ f2,
                                  const int* __restrict__ blurred,
                                  const float* __restrict__ ts,
                                  uint8_t* __restrict__ out, int n_out,
                                  int rows, int Wa, int pitch, int lh, int lw,
                                  int rs) {
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cy = blockIdx.y * blockDim.y + threadIdx.y;
  if (cx >= Wa || cy >= rows) return;
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
  const float fx12 = (float)ox12, fy12 = (float)oy12;
  const float fx21 = (float)bx[bscy * lw + bscx];
  const float fy21 = (float)by[bscy * lw + bscx];
  const size_t plane = (size_t)rows * Wa;
  uint8_t* o = out + (size_t)cy * Wa + cx;
  for (int n = 0; n < n_out; ++n) {
    const float t12 = ts[n];
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
    if (kChroma) {  // NV12: u on even columns, v on odd
      x12 = (x12 & ~1) + (cx & 1);
      x21 = (x21 & ~1) + (cx & 1);
    }
    const unsigned s12 = f1[(size_t)y12 * pitch + x12];
    const unsigned s21 = f2[(size_t)y21 * pitch + x21];
    const unsigned T = blend_weight(t12);
    const unsigned acc = s12 * (16777216u - T) + s21 * T;
    o[n * plane] = (uint8_t)min(acc >> 24, 255u);
  }
}

}  // namespace

// out_y (n, H, Wa), out_uv (n, H/2, Wa); sources (H, pitch) and
// (H/2, pitch) with pitch >= Wa; blurred (2, lh, lw) int32; ts (n,) float.
extern "C" int mfi_pair_blend(const void* f1y, const void* f1uv,
                              const void* f2y, const void* f2uv,
                              const void* blurred, const void* ts, void* out_y,
                              void* out_uv, int n, int H, int Wa, int pitch,
                              int lh, int lw, int rs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(32, 8);
  const dim3 gy((Wa + 31) / 32, (H + 7) / 8);
  pair_blend_kernel<false><<<gy, block, 0, s>>>(
      static_cast<const uint8_t*>(f1y), static_cast<const uint8_t*>(f2y),
      static_cast<const int*>(blurred), static_cast<const float*>(ts),
      static_cast<uint8_t*>(out_y), n, H, Wa, pitch, lh, lw, rs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int hc = H / 2;
  const dim3 gc((Wa + 31) / 32, (hc + 7) / 8);
  pair_blend_kernel<true><<<gc, block, 0, s>>>(
      static_cast<const uint8_t*>(f1uv), static_cast<const uint8_t*>(f2uv),
      static_cast<const int*>(blurred), static_cast<const float*>(ts),
      static_cast<uint8_t*>(out_uv), n, hc, Wa, pitch, lh, lw, rs);
  return (int)cudaGetLastError();
}
