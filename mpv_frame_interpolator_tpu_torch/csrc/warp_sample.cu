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
// flow_dir, dir_displacement and sample_dir_pixel).  The caller blends,
// recolours and maps levels.
//
// The TPU kernel reaches those pixels through a distinct-value table of
// displacements, a per-pixel index field, a 512-tile grid with per-tile
// presence bitmasks, (32, 128)-aligned DMA windows fixed up with rolls, a
// 96-value budget and a gather fallback when the flow exceeds it.  None of
// that is carried over: the function both the kernel and its fallback
// compute is "read the pixel at its mirrored coordinate".
//
// t is one float in device memory (the engine folds the scene cut into it
// on the card), so no host sync decides it; the direction is an argument.
//
// What bounds it: bytes.  Per launch at 4K it writes one plane pair (12.4
// MB NV12, 24.9 MB P010), reads at most as many source samples, and the
// ~1 MB flow field: ~26 MB, ~7.7 us at 3.35 TB/s (~15 us at P010).  A
// thread per output sample, with one- or two-byte accesses and up to four
// dependent flow loads per sample, was bound by the count of accesses and
// instructions.  The design is the runs of warp_runs.cuh (sample_run): one
// thread per 16-byte output run of a row; per flow cell the run covers, one
// lookup (the forward flow for direction 12; for 21 the forward flow, then
// the reverse flow through it) and one rounded displacement; an interior
// segment's window, read with aligned 16-byte loads, goes word by word into
// the output (for chroma at an odd displacement, u from one window and v
// from another); one 16-byte store a run; edge runs per sample
// (mfi::sample_dir_pixel).  One launch covers both planes: the first
// ceil(H / 32) block rows do luma, the rest chroma (a branch uniform per
// block), with both segment lengths fixed at compile time.

#include "warp_runs.cuh"

namespace {

using mfi::kBX;
using mfi::kBY;

template <typename T, int kLogSegY, int kLogSegC>
__global__ void __launch_bounds__(kBX * kBY) sample_dir_kernel(
    const T* __restrict__ src_y, const T* __restrict__ src_uv,
    const int* __restrict__ blurred, const float* __restrict__ t,
    T* __restrict__ out_y, T* __restrict__ out_uv, int H, int Wa, int pitch,
    int lh, int lw, int rs, int luma_blocks, bool dir21, int vec) {
  constexpr int kE = 16 / sizeof(T);
  const bool chroma = (int)blockIdx.y >= luma_blocks;
  const int x0 = (blockIdx.x * kBX + threadIdx.x) * kE;
  const int cy = (chroma ? blockIdx.y - luma_blocks : blockIdx.y) * kBY +
                 threadIdx.y;
  const int rows = chroma ? H / 2 : H;
  if (x0 >= Wa || cy >= rows) return;
  const float t12 = *t;
  if (chroma)
    mfi::sample_run<T, true, kLogSegC>(src_uv, blurred, t12, dir21,
                                       out_uv + (size_t)cy * Wa + x0, x0, cy,
                                       rows, Wa, pitch, lh, lw, rs, vec);
  else
    mfi::sample_run<T, false, kLogSegY>(src_y, blurred, t12, dir21,
                                        out_y + (size_t)cy * Wa + x0, x0, cy,
                                        rows, Wa, pitch, lh, lw, rs, vec);
}

template <typename T, int kLogSegY, int kLogSegC>
struct Launch {
  static int run(const void* src_y, const void* src_uv, const void* blurred,
                 const void* t, void* out_y, void* out_uv, int H, int Wa,
                 int pitch, int lh, int lw, int rs, bool dir21, int vec,
                 cudaStream_t s) {
    int luma_blocks;
    const dim3 grid = mfi::two_plane_grid<T>(H, Wa, &luma_blocks);
    sample_dir_kernel<T, kLogSegY, kLogSegC><<<grid, dim3(kBX, kBY), 0, s>>>(
        static_cast<const T*>(src_y), static_cast<const T*>(src_uv),
        static_cast<const int*>(blurred), static_cast<const float*>(t),
        static_cast<T*>(out_y), static_cast<T*>(out_uv), H, Wa, pitch, lh, lw,
        rs, luma_blocks, dir21, vec);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int launch(const void* src_y, const void* src_uv, const void* blurred,
           const void* t, void* out_y, void* out_uv, int H, int Wa,
           int pitch, int lh, int lw, int rs, bool dir21, int vec,
           cudaStream_t s) {
  const int item = (int)sizeof(T);
  const void* planes[] = {src_y, src_uv, out_y, out_uv};
  if (vec && !mfi::vector_ok(planes, 4, pitch * item, Wa * item))
    return (int)cudaErrorMisalignedAddress;
  return mfi::dispatch_segments<T, Launch>(rs, src_y, src_uv, blurred, t,
                                           out_y, out_uv, H, Wa, pitch, lh,
                                           lw, rs, dir21, vec, s);
}

}  // namespace

// out_y (H, Wa), out_uv (H/2, Wa); src_y (H, pitch) and src_uv (H/2, pitch)
// of the direction's source frame (f1 for 12, f2 for 21), pitch >= Wa,
// uint8 (sample_bytes 1) or uint16 (2); blurred (2, lh, lw) int32; t one
// float on the device; direction 12 or 21; vec: 1 for the 16-byte path
// (refused unless every plane pointer is 16-byte aligned and pitch and Wa
// are rows of a multiple of 16 bytes).
extern "C" int mfi_sample_dir(const void* src_y, const void* src_uv,
                              const void* blurred, const void* t, void* out_y,
                              void* out_uv, int H, int Wa, int pitch, int lh,
                              int lw, int rs, int direction, int sample_bytes,
                              int vec, void* stream) {
  if (direction != 12 && direction != 21) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dir21 = direction == 21;
  if (sample_bytes == 2)
    return launch<uint16_t>(src_y, src_uv, blurred, t, out_y, out_uv, H, Wa,
                            pitch, lh, lw, rs, dir21, vec, s);
  if (sample_bytes == 1)
    return launch<uint8_t>(src_y, src_uv, blurred, t, out_y, out_uv, H, Wa,
                           pitch, lh, lw, rs, dir21, vec, s);
  return (int)cudaErrorInvalidValue;
}
