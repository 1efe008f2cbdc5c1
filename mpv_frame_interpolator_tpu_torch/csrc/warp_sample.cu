// K5: the raw nearest samples of ONE direction -- a luma plane and an
// interleaved chroma plane -- at ONE blend position, for Hopper (sm_90a).
//
// Replaces the TPU kernel mpv_frame_interpolator_tpu/ops/pallas/
// warp_sample.py:shift_sample_pallas, the luma sampler of the JAX
// package's shift decomposition (ops/warp._sample_all_planes) under
// warp_sampling="pallas", which modes 0 (warp12), 1 (warp21), 3 (hsv) and
// the "pallas" sampler of mode 2 compose.  Per output pixel p, direction 12
// reads f1 at mirror_edge2(p + iround(flow12 * t)) and direction 21 reads
// f2 at mirror_edge2(p - iround(flow21 * (1 - t))) (warp_common.cuh,
// sample_dir_pixel).  The caller blends, recolours and maps levels.
//
// The TPU kernel reaches those pixels through a distinct-value table of
// displacements, a per-pixel index field, a 512-tile grid with per-tile
// presence bitmasks, (32, 128)-aligned DMA windows fixed up with rolls, a
// 96-value budget and a gather fallback when the flow exceeds it.  None of
// that is carried over: the function both the kernel and its fallback
// compute is "read the pixel at its mirrored coordinate", and this kernel
// does just that, one thread per output sample.
//
// t is one float in device memory (the engine folds the scene cut into it
// on the card), so no host sync decides it; the direction is an argument.
//
// What bounds it: bytes.  Per launch at 4K it writes one plane pair (12.4
// MB NV12, 24.9 MB P010), reads at most as many source samples, and the
// ~1 MB flow field: ~26 MB, ~7.7 us at 3.35 TB/s (~15 us at P010).  One
// launch covers both planes (blocks of the first ceil(H / 8) rows of the
// grid do luma, the rest chroma, a branch uniform per block), as K4 does.
// Each thread moves one sample per access, so like K4 it is bound by the
// count of those accesses before the bytes.

#include "warp_common.cuh"

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

template <typename T>
__global__ void sample_dir_kernel(const T* __restrict__ src_y,
                                  const T* __restrict__ src_uv,
                                  const int* __restrict__ blurred,
                                  const float* __restrict__ t,
                                  T* __restrict__ out_y,
                                  T* __restrict__ out_uv, int H, int Wa,
                                  int pitch, int lh, int lw, int rs,
                                  int luma_blocks, bool dir21) {
  const int cx = blockIdx.x * kBX + threadIdx.x;
  const bool chroma = (int)blockIdx.y >= luma_blocks;
  const int cy = (chroma ? blockIdx.y - luma_blocks : blockIdx.y) * kBY +
                 threadIdx.y;
  const int rows = chroma ? H / 2 : H;
  if (cx >= Wa || cy >= rows) return;
  const float t12 = *t;
  if (chroma)
    out_uv[(size_t)cy * Wa + cx] = mfi::sample_dir_pixel<T, true>(
        blurred, src_uv, pitch, rows, Wa, cx, cy, lh, lw, rs, t12, dir21);
  else
    out_y[(size_t)cy * Wa + cx] = mfi::sample_dir_pixel<T, false>(
        blurred, src_y, pitch, rows, Wa, cx, cy, lh, lw, rs, t12, dir21);
}

template <typename T>
int launch(const void* src_y, const void* src_uv, const void* blurred,
           const void* t, void* out_y, void* out_uv, int H, int Wa,
           int pitch, int lh, int lw, int rs, bool dir21, cudaStream_t s) {
  const int luma_blocks = (H + kBY - 1) / kBY;
  const int chroma_blocks = (H / 2 + kBY - 1) / kBY;
  const dim3 grid((Wa + kBX - 1) / kBX, luma_blocks + chroma_blocks);
  sample_dir_kernel<T><<<grid, dim3(kBX, kBY), 0, s>>>(
      static_cast<const T*>(src_y), static_cast<const T*>(src_uv),
      static_cast<const int*>(blurred), static_cast<const float*>(t),
      static_cast<T*>(out_y), static_cast<T*>(out_uv), H, Wa, pitch, lh, lw,
      rs, luma_blocks, dir21);
  return (int)cudaGetLastError();
}

}  // namespace

// out_y (H, Wa), out_uv (H/2, Wa); src_y (H, pitch) and src_uv (H/2, pitch)
// of the direction's source frame (f1 for 12, f2 for 21), pitch >= Wa,
// uint8 (sample_bytes 1) or uint16 (2); blurred (2, lh, lw) int32; t one
// float on the device; direction 12 or 21.
extern "C" int mfi_sample_dir(const void* src_y, const void* src_uv,
                              const void* blurred, const void* t, void* out_y,
                              void* out_uv, int H, int Wa, int pitch, int lh,
                              int lw, int rs, int direction, int sample_bytes,
                              void* stream) {
  if (direction != 12 && direction != 21) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dir21 = direction == 21;
  if (sample_bytes == 2)
    return launch<uint16_t>(src_y, src_uv, blurred, t, out_y, out_uv, H, Wa,
                            pitch, lh, lw, rs, dir21, s);
  if (sample_bytes == 1)
    return launch<uint8_t>(src_y, src_uv, blurred, t, out_y, out_uv, H, Wa,
                           pitch, lh, lw, rs, dir21, s);
  return (int)cudaErrorInvalidValue;
}
