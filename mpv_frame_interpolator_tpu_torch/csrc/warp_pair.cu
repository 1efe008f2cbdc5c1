// K2: every blended output of one source pair, for Hopper (sm_90a), and its
// row band.
//
// Replaces the TPU kernel mpv_frame_interpolator_tpu/ops/pallas/
// warp_pair.py:pair_blend_plane (reached through blended_pair_from_prep),
// and, as the row band [r0, r1), the GSPMD row sharding of
// mpv_frame_interpolator_tpu/parallel/sharding.py:165-176
// (row_sharded_warp_fn): each rank of the row-sharded warp runs its band
// (parallel/sharding.py).  The per-pixel semantics are in warp_common.cuh:
// two mirrored nearest samples, the fixed-point blend and the black/white
// level maps, for uint8 NV12 (scale_shift 0) and uint16 P010 (scale_shift 8)
// planes.  The TPU kernel serves only 8-bit NV12 at the default levels; this
// one serves every case.
//
// What bounds it: at 4K with five positions a pair writes 5 x 12.4 MB and
// reads the two source frames, 24.9 MB -- about 87 MB, ~26 us at the card's
// 3.35 TB/s (twice that under P010).  Measured on the H100 (PERF.md) it is
// bound by instructions, not bytes: a variant that read no source at all
// took ~92% of its time, one without its flow reads ~86%; a 16-byte run of
// two directions costs some 250 instructions, a third of them the
// per-sample blend.  The design (the runs of warp_runs.cuh, shared with
// K4) spends as few of them a run as it can:
//   * one launch covers the band's luma rows and its chroma rows [r0 / 2,
//     r1 / 2): the first luma_blocks block rows do luma, the rest chroma,
//     a branch uniform per block (as K4 and K5);
//   * one thread per 16-byte output run of one row, for every position of
//     the pair: it reads the flow and the reverse flow once per cell the
//     run covers, for all of them (a block a position read them once a
//     position, 8% slower); per position and cell, the four rounded
//     displacements once (mfi::dir_displacement, without a branch), and
//     the blend weights T and 2^F - T once;
//   * an interior run reads each source segment with aligned 16-byte loads
//     and assembles the unaligned window in registers (a chroma segment
//     one window two samples longer, v two samples on from u), then blends
//     and level-maps per sample (the levels' quotient a multiply and a
//     shift, mfi::Divider) and writes one 16-byte streaming store a
//     position (evict-first: the outputs do not push the sources out of
//     L2);
//   * an edge run (any sample mirrored, which includes column 0, column
//     Wa - 1, row 0 and row rows - 1 at any flow) takes the per-sample step
//     mfi::blend_pixel, shared with K4.
// The sources are read whole, at mirrored coordinates: a band's edge rows
// are interior rows of the frame, and the bands of a split stacked give the
// whole frame, which is the band [0, H).  The vector path needs 16-byte
// aligned plane pointers and rows of a multiple of 16 bytes (pitch and Wa);
// otherwise the whole launch takes the per-sample path.

#include "warp_runs.cuh"

namespace {

using mfi::kBX;
using mfi::kBY;

// One plane's run (x0, cy) of block row `by` of the band [row0, row1) of a
// plane of `rows` rows, kSeg samples a segment (one flow cell, or the whole
// run when a cell is wider), at every position: the run's flows are read
// once for all of them; `out` holds row1 - row0 rows a position.
template <typename T, bool kChroma, int kLogSeg>
__device__ __forceinline__ void pair_plane(
    const T* __restrict__ f1, const T* __restrict__ f2,
    const int* __restrict__ blurred, const float* __restrict__ ts,
    T* __restrict__ out, int n_out, int by, int rows, int row0, int row1,
    int Wa, int pitch, int lh, int lw, int rs, int ss, const mfi::Levels& lv,
    int vec) {
  constexpr int kE = 16 / sizeof(T);  // samples a run
  constexpr int kSeg = 1 << kLogSeg;
  constexpr int kNSeg = kE / kSeg;
  const int x0 = (blockIdx.x * kBX + threadIdx.x) * kE;
  const int cy = row0 + by * kBY + threadIdx.y;
  if (x0 >= Wa || cy >= row1) return;
  float fx12[kNSeg], fy12[kNSeg], fx21[kNSeg], fy21[kNSeg];
  mfi::run_flows<kChroma, kSeg, kNSeg>(blurred, x0, cy, lh, lw, rs, fx12,
                                       fy12, fx21, fy21);
  const size_t plane = (size_t)(row1 - row0) * Wa;
  T* o = out + (size_t)(cy - row0) * Wa + x0;
  for (int n = 0; n < n_out; ++n)
    mfi::blend_run<T, kChroma, kLogSeg>(f1, f2, fx12, fy12, fx21, fy21,
                                        ts[n], o + n * plane, x0, cy, rows,
                                        Wa, pitch, ss, lv, vec);
}

// The band [r0, r1) of a frame of H luma rows: luma rows [r0, r1) in the
// first luma_blocks block rows, chroma rows [r0 / 2, r1 / 2) in the rest.
// At 8 bits with a luma segment of the whole run (res scalar 4 and up)
// five blocks an SM: left to itself ptxas gives that instantiation 40
// registers and a spill, and 48 none.
template <typename T, int kLogSegY, int kLogSegC>
__global__ void __launch_bounds__(kBX * kBY,
                                  sizeof(T) == 1 && kLogSegY == 4 ? 5 : 1)
pair_blend_kernel(
    const T* __restrict__ f1y, const T* __restrict__ f1uv,
    const T* __restrict__ f2y, const T* __restrict__ f2uv,
    const int* __restrict__ blurred, const float* __restrict__ ts,
    T* __restrict__ out_y, T* __restrict__ out_uv, int n_out, int H, int r0,
    int r1, int Wa, int pitch, int lh, int lw, int rs, int luma_blocks,
    int ss, mfi::Levels lv, int vec) {
  if ((int)blockIdx.y >= luma_blocks)
    pair_plane<T, true, kLogSegC>(f1uv, f2uv, blurred, ts, out_uv, n_out,
                                  blockIdx.y - luma_blocks, H / 2, r0 / 2,
                                  r1 / 2, Wa, pitch, lh, lw, rs, ss, lv,
                                  vec);
  else
    pair_plane<T, false, kLogSegY>(f1y, f2y, blurred, ts, out_y, n_out,
                                   blockIdx.y, H, r0, r1, Wa, pitch, lh, lw,
                                   rs, ss, lv, vec);
}

// one launch over the band's luma and chroma block rows
template <typename T, int kLogSegY, int kLogSegC>
struct Launch {
  static int run(const void* f1y, const void* f1uv, const void* f2y,
                 const void* f2uv, const void* blurred, const void* ts,
                 void* out_y, void* out_uv, int n, int H, int Wa, int pitch,
                 int lh, int lw, int rs, int ss, int k, int w, int vec,
                 int r0, int r1, cudaStream_t s) {
    int luma_blocks;
    const dim3 grid = mfi::two_plane_grid<T>(r1 - r0, Wa, &luma_blocks);
    pair_blend_kernel<T, kLogSegY, kLogSegC><<<grid, dim3(kBX, kBY), 0, s>>>(
        static_cast<const T*>(f1y), static_cast<const T*>(f1uv),
        static_cast<const T*>(f2y), static_cast<const T*>(f2uv),
        static_cast<const int*>(blurred), static_cast<const float*>(ts),
        static_cast<T*>(out_y), static_cast<T*>(out_uv), n, H, r0, r1, Wa,
        pitch, lh, lw, rs, luma_blocks, ss, mfi::levels(k, w), vec);
    return (int)cudaGetLastError();
  }
};

template <typename T>
int launch(const void* f1y, const void* f1uv, const void* f2y,
           const void* f2uv, const void* blurred, const void* ts, void* out_y,
           void* out_uv, int n, int H, int Wa, int pitch, int lh, int lw,
           int rs, int ss, int k, int w, int vec, int r0, int r1,
           cudaStream_t s) {
  const int item = (int)sizeof(T);
  const void* planes[] = {f1y, f1uv, f2y, f2uv, out_y, out_uv};
  if (vec && !mfi::vector_ok(planes, 6, pitch * item, Wa * item))
    return (int)cudaErrorMisalignedAddress;
  return mfi::dispatch_segments<T, Launch>(rs, f1y, f1uv, f2y, f2uv, blurred,
                                           ts, out_y, out_uv, n, H, Wa, pitch,
                                           lh, lw, rs, ss, k, w, vec, r0, r1,
                                           s);
}

int pair_blend(const void* f1y, const void* f1uv, const void* f2y,
               const void* f2uv, const void* blurred, const void* ts,
               void* out_y, void* out_uv, int n, int H, int Wa, int pitch,
               int lh, int lw, int rs, int ss, int k, int w, int vec, int r0,
               int r1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ss)
    return launch<uint16_t>(f1y, f1uv, f2y, f2uv, blurred, ts, out_y, out_uv,
                            n, H, Wa, pitch, lh, lw, rs, ss, k, w, vec, r0,
                            r1, s);
  return launch<uint8_t>(f1y, f1uv, f2y, f2uv, blurred, ts, out_y, out_uv, n,
                         H, Wa, pitch, lh, lw, rs, ss, k, w, vec, r0, r1, s);
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
  return pair_blend(f1y, f1uv, f2y, f2uv, blurred, ts, out_y, out_uv, n, H,
                    Wa, pitch, lh, lw, rs, ss, k, w, vec, 0, H, stream);
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
  return pair_blend(f1y, f1uv, f2y, f2uv, blurred, ts, out_y, out_uv, n, H,
                    Wa, pitch, lh, lw, rs, ss, k, w, vec, r0, r1, stream);
}
