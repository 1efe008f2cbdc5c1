// G1: the fixed-point blend and the black/white level maps of one blend
// position, over two directions' raw samples, for Hopper (sm_90a).
//
// Not a TPU kernel: it replaces the XLA fusion of the JAX package's
// ops/warp._blend_fix followed by _levels_y_rt / _levels_uv_rt
// (mpv_frame_interpolator_tpu/ops/warp.py:700, :737-:774), which the JAX
// engine runs around its one-direction sampler (warp_sampling "pallas",
// and mode 3 before its colours).  The port ran it as ~ten unfused int64
// tensor passes a plane.  Per sample of the luma plane and of the
// interleaved chroma plane, with F = 24 - (8 if scale_shift) and
// T = clip(round_half_even(t * 2^F), 0, 2^F):
//   b = (s12 * (2^F - T) + s21 * T) >> F            in uint32, as the JAX
//       package computes it: s * 2^F < 2^32 for 8-bit and 16-bit samples,
//       so the sum never wraps;
//   luma:   min(floor(max((b - (k << ss)) * 255, 0) / max(w - k, 1)), cap)
//   chroma: min(floor(max((b - m) * 255 + m * w, 0) / max(w, 1)), cap),
//           m = 128 << ss,
// in int32 (warp_common.cuh's levels_y / levels_uv, with the clip shortcut
// at the default levels), cap = 255 << ss.  The hopperx families' variant
// (kOcclusion, mode 2 of model hopperx) moves b toward the nearer source
// between the blend and the level maps (occlusion_adjust on the raw s12 and
// s21, ops/warp._occlusion_adjust, ops/warp.py:1049-1053 and :1155-1163);
// without it the kernel is the plain blend's.
//
// What bounds it: bytes.  One 4K position reads s12 and s21 and writes the
// output, 3 x 12.4 MB at 8 bits (x 2 under P010): ~11 us / ~22 us at
// 3.35 TB/s.  A thread per 16-byte run of a row: two aligned 16-byte loads,
// the blend and level map of each sample in registers, one 16-byte store;
// planes that do not qualify for 16-byte access (warp_pair.vector_path)
// take a per-sample loop instead.  One launch covers both planes, the luma
// block rows first (warp_runs.cuh's two_plane_grid, as K4 and K5), so the
// branch on the plane is uniform per block.  t is read on the device.

#include "warp_runs.cuh"

namespace {

using mfi::kBX;
using mfi::kBY;

template <typename T, bool kOcclusion>
__global__ void __launch_bounds__(kBX * kBY) blend_levels_kernel(
    const T* __restrict__ s12y, const T* __restrict__ s12uv,
    const T* __restrict__ s21y, const T* __restrict__ s21uv,
    const float* __restrict__ t, T* __restrict__ out_y,
    T* __restrict__ out_uv, int H, int Wa, int luma_blocks, int ss,
    mfi::Levels lv, int vec) {
  constexpr int item = sizeof(T);
  constexpr int kE = 16 / item;  // samples a run
  const bool chroma = (int)blockIdx.y >= luma_blocks;
  const int rows = chroma ? H / 2 : H;
  const int cy = (chroma ? blockIdx.y - luma_blocks : blockIdx.y) * kBY +
                 threadIdx.y;
  const int x0 = (blockIdx.x * kBX + threadIdx.x) * kE;
  if (x0 >= Wa || cy >= rows) return;
  const size_t at = (size_t)cy * Wa + x0;
  const T* a = (chroma ? s12uv : s12y) + at;
  const T* b = (chroma ? s21uv : s21y) + at;
  T* o = (chroma ? out_uv : out_y) + at;
  const int frac = ss ? 16 : 24;
  const unsigned tw = mfi::blend_weight(*t, frac);
  const unsigned w1 = (1u << frac) - tw;
  const bool near12 = *t < 0.5f;
  if (vec) {
    const uint4 qa = __ldg(reinterpret_cast<const uint4*>(a));
    const uint4 qb = __ldg(reinterpret_cast<const uint4*>(b));
    const unsigned wa[4] = {qa.x, qa.y, qa.z, qa.w};
    const unsigned wb[4] = {qb.x, qb.y, qb.z, qb.w};
    unsigned vals[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const unsigned sa = mfi::sample_of<T>(wa, j);
      const unsigned sb = mfi::sample_of<T>(wb, j);
      unsigned bl = (sa * w1 + sb * tw) >> frac;
      if (kOcclusion)
        bl = mfi::occlusion_adjust((int)bl, (int)sa, (int)sb, near12, ss);
      vals[j] = chroma ? mfi::levels_uv(bl, ss, lv)
                       : mfi::levels_y(bl, ss, lv);
    }
    unsigned r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      r[q] = mfi::pack_word<T>(vals + q * (4 / item));
    *reinterpret_cast<uint4*>(o) = make_uint4(r[0], r[1], r[2], r[3]);
    return;
  }
  const int n = min(kE, Wa - x0);
  for (int j = 0; j < n; ++j) {
    unsigned bl = ((unsigned)a[j] * w1 + (unsigned)b[j] * tw) >> frac;
    if (kOcclusion)
      bl = mfi::occlusion_adjust((int)bl, (int)a[j], (int)b[j], near12, ss);
    o[j] = (T)(chroma ? mfi::levels_uv(bl, ss, lv)
                      : mfi::levels_y(bl, ss, lv));
  }
}

template <typename T, bool kOcclusion>
int launch(const void* s12y, const void* s12uv, const void* s21y,
           const void* s21uv, const void* t, void* out_y, void* out_uv,
           int H, int Wa, int ss, int k, int w, int vec, cudaStream_t s) {
  const int row_bytes = Wa * (int)sizeof(T);
  const void* planes[] = {s12y, s12uv, s21y, s21uv, out_y, out_uv};
  if (vec && !mfi::vector_ok(planes, 6, row_bytes, row_bytes))
    return (int)cudaErrorMisalignedAddress;
  int luma_blocks;
  const dim3 grid = mfi::two_plane_grid<T>(H, Wa, &luma_blocks);
  blend_levels_kernel<T, kOcclusion><<<grid, dim3(kBX, kBY), 0, s>>>(
      static_cast<const T*>(s12y), static_cast<const T*>(s12uv),
      static_cast<const T*>(s21y), static_cast<const T*>(s21uv),
      static_cast<const float*>(t), static_cast<T*>(out_y),
      static_cast<T*>(out_uv), H, Wa, luma_blocks, ss, mfi::levels(k, w),
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// s12y, s21y, out_y (H, Wa); s12uv, s21uv, out_uv (H/2, Wa) interleaved;
// all contiguous, uint8 when ss == 0 and uint16 when ss == 8; t one float
// on the device; (k, w) the levels; vec: 1 for the 16-byte path (refused
// unless every plane pointer is 16-byte aligned and Wa samples are a
// multiple of 16 bytes); occlusion: 1 for the hopperx correction.
extern "C" int mfi_blend_levels(const void* s12y, const void* s12uv,
                                const void* s21y, const void* s21uv,
                                const void* t, void* out_y, void* out_uv,
                                int H, int Wa, int ss, int k, int w, int vec,
                                int occlusion, void* stream) {
  if (H < 2 || Wa < 1 || (ss != 0 && ss != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = ss ? (occlusion ? &launch<uint16_t, true>
                                  : &launch<uint16_t, false>)
                     : (occlusion ? &launch<uint8_t, true>
                                  : &launch<uint8_t, false>);
  return go(s12y, s12uv, s21y, s21uv, t, out_y, out_uv, H, Wa, ss, k, w, vec,
            s);
}
