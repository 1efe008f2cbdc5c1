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
// at the card's 3.35 TB/s (twice that under P010).  A thread per sample
// with byte loads and stores was bound by the count of those accesses, and
// redid per sample the displacement work that only depends on the flow
// cell.  The design (the runs of warp_runs.cuh, shared with K4 and K5):
//   * one thread per 16-byte output run of one row (16 samples at 8 bits,
//     8 under P010) -- and at 8 bits per position, while under P010 it
//     loops over the N positions -- reading the flow and the reverse flow
//     once per cell the run covers;
//   * per position and cell, the four rounded displacements once
//     (mfi::dir_displacement), and the blend weights T and 2^F - T once;
//   * an interior run reads each source segment with aligned 16-byte loads
//     and assembles the unaligned window in registers (two windows and a
//     u/v select for an odd chroma displacement), then blends and
//     level-maps per sample and writes one 16-byte store a position;
//   * an edge run (any sample mirrored, which includes column 0, column
//     Wa - 1, row 0 and row rows - 1 at any flow) takes the per-sample step
//     mfi::blend_pixel, shared with K4.
// The vector path needs 16-byte aligned plane pointers and rows of a
// multiple of 16 bytes (pitch and Wa); otherwise the whole launch takes the
// per-sample path.

#include "warp_runs.cuh"

namespace {

using mfi::kBX;
using mfi::kBY;

// The run at (x0, cy), kSeg samples a segment (one flow cell, or the whole
// run when a cell is wider), at positions blockIdx.z, blockIdx.z +
// gridDim.z, ...
template <typename T, bool kChroma, int kLogSeg>
__global__ void __launch_bounds__(kBX * kBY) pair_blend_kernel(
    const T* __restrict__ f1, const T* __restrict__ f2,
    const int* __restrict__ blurred, const float* __restrict__ ts,
    T* __restrict__ out, int n_out, int rows, int Wa, int pitch, int lh,
    int lw, int rs, int ss, int k, int w, int vec) {
  constexpr int kE = 16 / sizeof(T);  // samples a run
  constexpr int kSeg = 1 << kLogSeg;
  constexpr int kNSeg = kE / kSeg;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kE;
  const int cy = blockIdx.y * blockDim.y + threadIdx.y;
  if (x0 >= Wa || cy >= rows) return;
  float fx12[kNSeg], fy12[kNSeg], fx21[kNSeg], fy21[kNSeg];
  mfi::run_flows<kChroma, kSeg, kNSeg>(blurred, x0, cy, lh, lw, rs, fx12,
                                       fy12, fx21, fy21);
  const size_t plane = (size_t)rows * Wa;
  for (int n = blockIdx.z; n < n_out; n += gridDim.z)
    mfi::blend_run<T, kChroma, kLogSeg>(
        f1, f2, fx12, fy12, fx21, fy21, ts[n],
        out + n * plane + (size_t)cy * Wa + x0, x0, cy, rows, Wa, pitch, ss,
        k, w, vec);
}

// at 8 bits each position gets its own threads (grid.z), which hides more
// latency than a loop over positions, while under P010 (half the samples a
// run) the loop amortises the flow lookups better: each shape measured the
// faster on the H100 (PERF.md)
template <typename T, bool kChroma, int kLogSeg>
int launch_plane(const void* f1, const void* f2, const void* blurred,
                 const void* ts, void* out, int n, int rows, int Wa,
                 int pitch, int lh, int lw, int rs, int ss, int k, int w,
                 int vec, cudaStream_t s) {
  const dim3 grid =
      mfi::run_grid<T>(rows, Wa, sizeof(T) == 1 && n > 1 ? n : 1);
  pair_blend_kernel<T, kChroma, kLogSeg><<<grid, dim3(kBX, kBY), 0, s>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const int*>(blurred), static_cast<const float*>(ts),
      static_cast<T*>(out), n, rows, Wa, pitch, lh, lw, rs, ss, k, w, vec);
  return (int)cudaGetLastError();
}

// the luma kernel, then the chroma kernel
template <typename T, int kLogSegY, int kLogSegC>
struct Launch {
  static int run(const void* f1y, const void* f1uv, const void* f2y,
                 const void* f2uv, const void* blurred, const void* ts,
                 void* out_y, void* out_uv, int n, int H, int Wa, int pitch,
                 int lh, int lw, int rs, int ss, int k, int w, int vec,
                 cudaStream_t s) {
    const int e = launch_plane<T, false, kLogSegY>(
        f1y, f2y, blurred, ts, out_y, n, H, Wa, pitch, lh, lw, rs, ss, k, w,
        vec, s);
    if (e != 0) return e;
    return launch_plane<T, true, kLogSegC>(f1uv, f2uv, blurred, ts, out_uv,
                                           n, H / 2, Wa, pitch, lh, lw, rs,
                                           ss, k, w, vec, s);
  }
};

template <typename T>
int launch(const void* f1y, const void* f1uv, const void* f2y,
           const void* f2uv, const void* blurred, const void* ts, void* out_y,
           void* out_uv, int n, int H, int Wa, int pitch, int lh, int lw,
           int rs, int ss, int k, int w, int vec, cudaStream_t s) {
  const int item = (int)sizeof(T);
  const void* planes[] = {f1y, f1uv, f2y, f2uv, out_y, out_uv};
  if (vec && !mfi::vector_ok(planes, 6, pitch * item, Wa * item))
    return (int)cudaErrorMisalignedAddress;
  return mfi::dispatch_segments<T, Launch>(rs, f1y, f1uv, f2y, f2uv, blurred,
                                           ts, out_y, out_uv, n, H, Wa, pitch,
                                           lh, lw, rs, ss, k, w, vec, s);
}

// The row band: pair_blend_kernel's output for rows [row0, row1) of a
// plane of `rows` rows, into a band buffer of row1 - row0 rows a position.
// The sources are read whole, at mirrored coordinates, as above: a band's
// edge rows are interior rows of the frame.  It replaces the GSPMD row
// sharding of mpv_frame_interpolator_tpu/parallel/sharding.py:165-176
// (row_sharded_warp_fn): each rank of the row-sharded warp runs its band
// (parallel/sharding.py).  A kernel of its own, so that the shipped
// pair_blend_kernel's code and launches stay as they are.
template <typename T, bool kChroma, int kLogSeg>
__global__ void __launch_bounds__(kBX * kBY) pair_blend_rows_kernel(
    const T* __restrict__ f1, const T* __restrict__ f2,
    const int* __restrict__ blurred, const float* __restrict__ ts,
    T* __restrict__ out, int n_out, int rows, int row0, int row1, int Wa,
    int pitch, int lh, int lw, int rs, int ss, int k, int w, int vec) {
  constexpr int kE = 16 / sizeof(T);
  constexpr int kSeg = 1 << kLogSeg;
  constexpr int kNSeg = kE / kSeg;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kE;
  const int cy = row0 + blockIdx.y * blockDim.y + threadIdx.y;
  if (x0 >= Wa || cy >= row1) return;
  float fx12[kNSeg], fy12[kNSeg], fx21[kNSeg], fy21[kNSeg];
  mfi::run_flows<kChroma, kSeg, kNSeg>(blurred, x0, cy, lh, lw, rs, fx12,
                                       fy12, fx21, fy21);
  const size_t plane = (size_t)(row1 - row0) * Wa;
  for (int n = blockIdx.z; n < n_out; n += gridDim.z)
    mfi::blend_run<T, kChroma, kLogSeg>(
        f1, f2, fx12, fy12, fx21, fy21, ts[n],
        out + n * plane + (size_t)(cy - row0) * Wa + x0, x0, cy, rows, Wa,
        pitch, ss, k, w, vec);
}

template <typename T, int kLogSegY, int kLogSegC>
struct LaunchRows {
  static int run(const void* f1y, const void* f1uv, const void* f2y,
                 const void* f2uv, const void* blurred, const void* ts,
                 void* out_y, void* out_uv, int n, int H, int Wa, int pitch,
                 int lh, int lw, int rs, int ss, int k, int w, int vec,
                 int r0, int r1, cudaStream_t s) {
    const int depth = sizeof(T) == 1 && n > 1 ? n : 1;
    const dim3 gy = mfi::run_grid<T>(r1 - r0, Wa, depth);
    pair_blend_rows_kernel<T, false, kLogSegY><<<gy, dim3(kBX, kBY), 0, s>>>(
        static_cast<const T*>(f1y), static_cast<const T*>(f2y),
        static_cast<const int*>(blurred), static_cast<const float*>(ts),
        static_cast<T*>(out_y), n, H, r0, r1, Wa, pitch, lh, lw, rs, ss, k, w,
        vec);
    const int e = (int)cudaGetLastError();
    if (e != 0) return e;
    const dim3 gc = mfi::run_grid<T>((r1 - r0) / 2, Wa, depth);
    pair_blend_rows_kernel<T, true, kLogSegC><<<gc, dim3(kBX, kBY), 0, s>>>(
        static_cast<const T*>(f1uv), static_cast<const T*>(f2uv),
        static_cast<const int*>(blurred), static_cast<const float*>(ts),
        static_cast<T*>(out_uv), n, H / 2, r0 / 2, r1 / 2, Wa, pitch, lh, lw,
        rs, ss, k, w, vec);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int launch_rows(const void* f1y, const void* f1uv, const void* f2y,
                const void* f2uv, const void* blurred, const void* ts,
                void* out_y, void* out_uv, int n, int H, int Wa, int pitch,
                int lh, int lw, int rs, int ss, int k, int w, int vec, int r0,
                int r1, cudaStream_t s) {
  const int item = (int)sizeof(T);
  const void* planes[] = {f1y, f1uv, f2y, f2uv, out_y, out_uv};
  if (vec && !mfi::vector_ok(planes, 6, pitch * item, Wa * item))
    return (int)cudaErrorMisalignedAddress;
  return mfi::dispatch_segments<T, LaunchRows>(
      rs, f1y, f1uv, f2y, f2uv, blurred, ts, out_y, out_uv, n, H, Wa, pitch,
      lh, lw, rs, ss, k, w, vec, r0, r1, s);
}

}  // namespace

// out_y (n, H, Wa), out_uv (n, H/2, Wa); sources (H, pitch) and
// (H/2, pitch) with pitch >= Wa, uint8 when ss == 0 and uint16 when
// ss == 8; blurred (2, lh, lw) int32; ts (n,) float; (k, w) the levels;
// vec: 1 for the 16-byte path (refused unless every plane pointer is
// 16-byte aligned and pitch and Wa are rows of a multiple of 16 bytes).
extern "C" int mfi_pair_blend(const void* f1y, const void* f1uv,
                              const void* f2y, const void* f2uv,
                              const void* blurred, const void* ts, void* out_y,
                              void* out_uv, int n, int H, int Wa, int pitch,
                              int lh, int lw, int rs, int ss, int k, int w,
                              int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ss)
    return launch<uint16_t>(f1y, f1uv, f2y, f2uv, blurred, ts, out_y, out_uv,
                            n, H, Wa, pitch, lh, lw, rs, ss, k, w, vec, s);
  return launch<uint8_t>(f1y, f1uv, f2y, f2uv, blurred, ts, out_y, out_uv, n,
                         H, Wa, pitch, lh, lw, rs, ss, k, w, vec, s);
}

// The row band [r0, r1) of mfi_pair_blend's outputs: out_y (n, r1 - r0,
// Wa) holds luma rows [r0, r1), out_uv (n, (r1 - r0) / 2, Wa) chroma rows
// [r0 / 2, r1 / 2); r0 and r1 even, 0 <= r0 < r1 <= H.  Other arguments
// as for mfi_pair_blend.
extern "C" int mfi_pair_blend_rows(const void* f1y, const void* f1uv,
                                   const void* f2y, const void* f2uv,
                                   const void* blurred, const void* ts,
                                   void* out_y, void* out_uv, int n, int H,
                                   int Wa, int pitch, int lh, int lw, int rs,
                                   int ss, int k, int w, int vec, int r0,
                                   int r1, void* stream) {
  if (r0 < 0 || r1 > H || r0 >= r1 || (r0 & 1) || (r1 & 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ss)
    return launch_rows<uint16_t>(f1y, f1uv, f2y, f2uv, blurred, ts, out_y,
                                 out_uv, n, H, Wa, pitch, lh, lw, rs, ss, k,
                                 w, vec, r0, r1, s);
  return launch_rows<uint8_t>(f1y, f1uv, f2y, f2uv, blurred, ts, out_y,
                              out_uv, n, H, Wa, pitch, lh, lw, rs, ss, k, w,
                              vec, r0, r1, s);
}
