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
// ~50 MB, L2-resident only in part) -- ~11 us / ~22 us at 3.35 TB/s.  The
// design: one launch covers both planes (blocks of the first ceil(H / 8)
// rows of the grid do luma, the rest chroma, a branch uniform per block),
// one thread per output sample, sources read at mirrored coordinates
// directly.  None of the TPU machinery is carried over: no tile-grid
// over-padding, presence bitmasks, packed displacement tables or aligned
// DMA with rotates.  Like K2 it moves one sample per access, so it is
// bound by the count of those accesses before the bytes; and as it runs
// N times a pair, the flow lookups are repeated N times where K2 reads
// them once.

#include "warp_common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

template <typename T>
__global__ void fused_blend_kernel(const T* __restrict__ f1y,
                                   const T* __restrict__ f1uv,
                                   const T* __restrict__ f2y,
                                   const T* __restrict__ f2uv,
                                   const int* __restrict__ blurred,
                                   const float* __restrict__ t,
                                   T* __restrict__ out_y,
                                   T* __restrict__ out_uv, int H, int Wa,
                                   int pitch, int lh, int lw, int rs,
                                   int luma_blocks, int ss, int k, int w) {
  const int cx = blockIdx.x * kBX + threadIdx.x;
  const bool chroma = (int)blockIdx.y >= luma_blocks;
  const int cy = (chroma ? blockIdx.y - luma_blocks : blockIdx.y) * kBY +
                 threadIdx.y;
  const int rows = chroma ? H / 2 : H;
  if (cx >= Wa || cy >= rows) return;
  const float t12 = *t;
  float fx12, fy12, fx21, fy21;
  if (chroma) {
    mfi::flow_at<true>(blurred, cx, cy, lh, lw, rs, &fx12, &fy12, &fx21,
                       &fy21);
    out_uv[(size_t)cy * Wa + cx] = mfi::blend_pixel<T, true>(
        f1uv, f2uv, pitch, rows, Wa, cx, cy, fx12, fy12, fx21, fy21, t12, ss,
        k, w);
  } else {
    mfi::flow_at<false>(blurred, cx, cy, lh, lw, rs, &fx12, &fy12, &fx21,
                        &fy21);
    out_y[(size_t)cy * Wa + cx] = mfi::blend_pixel<T, false>(
        f1y, f2y, pitch, rows, Wa, cx, cy, fx12, fy12, fx21, fy21, t12, ss, k,
        w);
  }
}

template <typename T>
int launch(const void* f1y, const void* f1uv, const void* f2y,
           const void* f2uv, const void* blurred, const void* t, void* out_y,
           void* out_uv, int H, int Wa, int pitch, int lh, int lw, int rs,
           int ss, int k, int w, cudaStream_t s) {
  const int luma_blocks = (H + kBY - 1) / kBY;
  const int chroma_blocks = (H / 2 + kBY - 1) / kBY;
  const dim3 grid((Wa + kBX - 1) / kBX, luma_blocks + chroma_blocks);
  fused_blend_kernel<T><<<grid, dim3(kBX, kBY), 0, s>>>(
      static_cast<const T*>(f1y), static_cast<const T*>(f1uv),
      static_cast<const T*>(f2y), static_cast<const T*>(f2uv),
      static_cast<const int*>(blurred), static_cast<const float*>(t),
      static_cast<T*>(out_y), static_cast<T*>(out_uv), H, Wa, pitch, lh, lw,
      rs, luma_blocks, ss, k, w);
  return (int)cudaGetLastError();
}

}  // namespace

// out_y (H, Wa), out_uv (H/2, Wa); sources (H, pitch) and (H/2, pitch) with
// pitch >= Wa, uint8 when ss == 0 and uint16 when ss == 8; blurred
// (2, lh, lw) int32; t one float on the device; (k, w) the levels.
extern "C" int mfi_fused_blend(const void* f1y, const void* f1uv,
                               const void* f2y, const void* f2uv,
                               const void* blurred, const void* t, void* out_y,
                               void* out_uv, int H, int Wa, int pitch, int lh,
                               int lw, int rs, int ss, int k, int w,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ss)
    return launch<uint16_t>(f1y, f1uv, f2y, f2uv, blurred, t, out_y, out_uv,
                            H, Wa, pitch, lh, lw, rs, ss, k, w, s);
  return launch<uint8_t>(f1y, f1uv, f2y, f2uv, blurred, t, out_y, out_uv, H,
                         Wa, pitch, lh, lw, rs, ss, k, w, s);
}
