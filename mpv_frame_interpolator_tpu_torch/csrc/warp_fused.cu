// K4: one blended output -- a luma plane and an interleaved chroma plane --
// for ONE blend position, for Hopper (sm_90a).
//
// Replaces the TPU kernel mpv_frame_interpolator_tpu/ops/pallas/
// warp_fused.py:fused_blend_plane (reached through blended_from_prep),
// which the JAX engine runs once per blend position under
// warp_sampling="fused".  The per-pixel step is K2's (warp_common.cuh):
// two mirrored nearest samples, the fixed-point blend with 24 - (8 if
// scale_shift) fraction bits, the black/white level maps and the cap
// 255 << scale_shift, for uint8 NV12 and uint16 P010 alike.  The TPU
// kernel runs only under `ok & default levels` (its distinct-value budget,
// engine.py:559-568,641-666) and hands everything else to XLA; this kernel
// has no budget, no gate and no fallback.
//
// t is one float in device memory (an element of the engine's blend
// vector after the scene cut is folded in on the card), so no host sync
// decides it; the kernel has no loop over positions.
//
// What bounds it: bytes.  Per position at 4K it writes one output (12.4
// MB for NV12, 24.9 MB for P010) and reads the two source frames (~25 /
// ~50 MB) -- ~11 us / ~22 us at 3.35 TB/s.  A thread per output sample,
// with one- or two-byte accesses and four dependent flow loads per sample,
// was bound by the count of accesses and instructions.  The design is K2's
// run body at one position (warp_runs.cuh, blend_run): one thread per
// 16-byte output run of a row, the flow and reverse flow read once a flow
// cell, the four displacements and the blend weights once, interior runs
// read with aligned 16-byte loads and written with one 16-byte store, edge
// runs per sample (mfi::blend_pixel).  One launch covers both planes: the
// first ceil(H / 32) block rows do luma, the rest chroma (a branch uniform
// per block), with both segment lengths fixed at compile time.  Unlike K2
// under P010, it cannot share a run's flow lookups among positions: the
// engine launches it once per position.

#include "warp_runs.cuh"

namespace {

using mfi::kBX;
using mfi::kBY;

// one plane's run (x0, cy) of block row `by`
template <typename T, bool kChroma, int kLogSeg>
__device__ __forceinline__ void fused_plane(
    const T* __restrict__ f1, const T* __restrict__ f2,
    const int* __restrict__ blurred, float t12, T* __restrict__ out, int by,
    int rows, int Wa, int pitch, int lh, int lw, int rs, int ss,
    const mfi::Levels& lv, int vec) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kSeg = 1 << kLogSeg;
  constexpr int kNSeg = kE / kSeg;
  const int x0 = (blockIdx.x * kBX + threadIdx.x) * kE;
  const int cy = by * kBY + threadIdx.y;
  if (x0 >= Wa || cy >= rows) return;
  float fx12[kNSeg], fy12[kNSeg], fx21[kNSeg], fy21[kNSeg];
  mfi::run_flows<kChroma, kSeg, kNSeg>(blurred, x0, cy, lh, lw, rs, fx12,
                                       fy12, fx21, fy21);
  mfi::blend_run<T, kChroma, kLogSeg>(f1, f2, fx12, fy12, fx21, fy21, t12,
                                      out + (size_t)cy * Wa + x0, x0, cy,
                                      rows, Wa, pitch, ss, lv, vec);
}

template <typename T, int kLogSegY, int kLogSegC>
__global__ void __launch_bounds__(kBX * kBY) fused_blend_kernel(
    const T* __restrict__ f1y, const T* __restrict__ f1uv,
    const T* __restrict__ f2y, const T* __restrict__ f2uv,
    const int* __restrict__ blurred, const float* __restrict__ t,
    T* __restrict__ out_y, T* __restrict__ out_uv, int H, int Wa, int pitch,
    int lh, int lw, int rs, int luma_blocks, int ss, mfi::Levels lv,
    int vec) {
  const float t12 = *t;
  if ((int)blockIdx.y >= luma_blocks)
    fused_plane<T, true, kLogSegC>(f1uv, f2uv, blurred, t12, out_uv,
                                   blockIdx.y - luma_blocks, H / 2, Wa, pitch,
                                   lh, lw, rs, ss, lv, vec);
  else
    fused_plane<T, false, kLogSegY>(f1y, f2y, blurred, t12, out_y,
                                    blockIdx.y, H, Wa, pitch, lh, lw, rs, ss,
                                    lv, vec);
}

template <typename T, int kLogSegY, int kLogSegC>
struct Launch {
  static int run(const void* f1y, const void* f1uv, const void* f2y,
                 const void* f2uv, const void* blurred, const void* t,
                 void* out_y, void* out_uv, int H, int Wa, int pitch, int lh,
                 int lw, int rs, int ss, int k, int w, int vec,
                 cudaStream_t s) {
    int luma_blocks;
    const dim3 grid = mfi::two_plane_grid<T>(H, Wa, &luma_blocks);
    fused_blend_kernel<T, kLogSegY, kLogSegC><<<grid, dim3(kBX, kBY), 0, s>>>(
        static_cast<const T*>(f1y), static_cast<const T*>(f1uv),
        static_cast<const T*>(f2y), static_cast<const T*>(f2uv),
        static_cast<const int*>(blurred), static_cast<const float*>(t),
        static_cast<T*>(out_y), static_cast<T*>(out_uv), H, Wa, pitch, lh, lw,
        rs, luma_blocks, ss, mfi::levels(k, w), vec);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int launch(const void* f1y, const void* f1uv, const void* f2y,
           const void* f2uv, const void* blurred, const void* t, void* out_y,
           void* out_uv, int H, int Wa, int pitch, int lh, int lw, int rs,
           int ss, int k, int w, int vec, cudaStream_t s) {
  const int item = (int)sizeof(T);
  const void* planes[] = {f1y, f1uv, f2y, f2uv, out_y, out_uv};
  if (vec && !mfi::vector_ok(planes, 6, pitch * item, Wa * item))
    return (int)cudaErrorMisalignedAddress;
  return mfi::dispatch_segments<T, Launch>(rs, f1y, f1uv, f2y, f2uv, blurred,
                                           t, out_y, out_uv, H, Wa, pitch, lh,
                                           lw, rs, ss, k, w, vec, s);
}

}  // namespace

// out_y (H, Wa), out_uv (H/2, Wa); sources (H, pitch) and (H/2, pitch) with
// pitch >= Wa, uint8 when ss == 0 and uint16 when ss == 8; blurred
// (2, lh, lw) int32; t one float on the device; (k, w) the levels; vec: 1
// for the 16-byte path (refused unless every plane pointer is 16-byte
// aligned and pitch and Wa are rows of a multiple of 16 bytes).
extern "C" int mfi_fused_blend(const void* f1y, const void* f1uv,
                               const void* f2y, const void* f2uv,
                               const void* blurred, const void* t, void* out_y,
                               void* out_uv, int H, int Wa, int pitch, int lh,
                               int lw, int rs, int ss, int k, int w, int vec,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ss)
    return launch<uint16_t>(f1y, f1uv, f2y, f2uv, blurred, t, out_y, out_uv,
                            H, Wa, pitch, lh, lw, rs, ss, k, w, vec, s);
  return launch<uint8_t>(f1y, f1uv, f2y, f2uv, blurred, t, out_y, out_uv, H,
                         Wa, pitch, lh, lw, rs, ss, k, w, vec, s);
}
