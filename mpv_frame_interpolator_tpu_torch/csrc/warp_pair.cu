// K2: every blended output of one source pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel mpv_frame_interpolator_tpu/ops/pallas/
// warp_pair.py:pair_blend_plane (reached through blended_pair_from_prep).
// The per-pixel semantics are in warp_common.cuh: two mirrored nearest
// samples, the fixed-point blend and the black/white level maps, for
// uint8 NV12 (scale_shift 0) and uint16 P010 (scale_shift 8) planes.  The
// TPU kernel serves only 8-bit NV12 at the default levels; this one serves
// every case.
//
// What bounds it: at 4K with five positions a pair writes 5 x 12.4 MB and
// reads two nearest samples per output sample from sources that stay in
// the 50 MB L2 -- about 62 MB written and ~25 MB of distinct reads, ~26 us
// at the card's 3.35 TB/s (twice that under P010).  This first form moves
// one sample per load and per store, so it is bound by the instruction
// count of those accesses instead (0.28 ms per 4K 8-bit pair on an H100
// SXM, about a tenth of the bandwidth); packing several output samples per
// thread is the next step.  The design keeps the loop over the N positions
// inside the thread, so the flow and reverse-flow lookups are read once per
// pixel, not once per output.
//
// None of the TPU kernel's machinery is needed: no padded tile sources,
// no distinct-displacement tables or their budget, no packed-byte
// selects, no aligned DMA with rolls.

#include "warp_common.cuh"

namespace {

template <typename T, bool kChroma>
__global__ void pair_blend_kernel(const T* __restrict__ f1,
                                  const T* __restrict__ f2,
                                  const int* __restrict__ blurred,
                                  const float* __restrict__ ts,
                                  T* __restrict__ out, int n_out, int rows,
                                  int Wa, int pitch, int lh, int lw, int rs,
                                  int ss, int k, int w) {
  const int cx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cy = blockIdx.y * blockDim.y + threadIdx.y;
  if (cx >= Wa || cy >= rows) return;
  float fx12, fy12, fx21, fy21;
  mfi::flow_at<kChroma>(blurred, cx, cy, lh, lw, rs, &fx12, &fy12, &fx21,
                        &fy21);
  const size_t plane = (size_t)rows * Wa;
  T* o = out + (size_t)cy * Wa + cx;
  for (int n = 0; n < n_out; ++n)
    o[n * plane] = mfi::blend_pixel<T, kChroma>(
        f1, f2, pitch, rows, Wa, cx, cy, fx12, fy12, fx21, fy21, ts[n], ss,
        k, w);
}

template <typename T>
int launch(const void* f1y, const void* f1uv, const void* f2y,
           const void* f2uv, const void* blurred, const void* ts, void* out_y,
           void* out_uv, int n, int H, int Wa, int pitch, int lh, int lw,
           int rs, int ss, int k, int w, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 gy((Wa + 31) / 32, (H + 7) / 8);
  pair_blend_kernel<T, false><<<gy, block, 0, s>>>(
      static_cast<const T*>(f1y), static_cast<const T*>(f2y),
      static_cast<const int*>(blurred), static_cast<const float*>(ts),
      static_cast<T*>(out_y), n, H, Wa, pitch, lh, lw, rs, ss, k, w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int hc = H / 2;
  const dim3 gc((Wa + 31) / 32, (hc + 7) / 8);
  pair_blend_kernel<T, true><<<gc, block, 0, s>>>(
      static_cast<const T*>(f1uv), static_cast<const T*>(f2uv),
      static_cast<const int*>(blurred), static_cast<const float*>(ts),
      static_cast<T*>(out_uv), n, hc, Wa, pitch, lh, lw, rs, ss, k, w);
  return (int)cudaGetLastError();
}

}  // namespace

// out_y (n, H, Wa), out_uv (n, H/2, Wa); sources (H, pitch) and
// (H/2, pitch) with pitch >= Wa, uint8 when ss == 0 and uint16 when
// ss == 8; blurred (2, lh, lw) int32; ts (n,) float; (k, w) the levels.
extern "C" int mfi_pair_blend(const void* f1y, const void* f1uv,
                              const void* f2y, const void* f2uv,
                              const void* blurred, const void* ts, void* out_y,
                              void* out_uv, int n, int H, int Wa, int pitch,
                              int lh, int lw, int rs, int ss, int k, int w,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ss)
    return launch<uint16_t>(f1y, f1uv, f2y, f2uv, blurred, ts, out_y, out_uv,
                            n, H, Wa, pitch, lh, lw, rs, ss, k, w, s);
  return launch<uint8_t>(f1y, f1uv, f2y, f2uv, blurred, ts, out_y, out_uv, n,
                         H, Wa, pitch, lh, lw, rs, ss, k, w, s);
}
