// The 8x8 box blur of one 32 x 8 tile of the flow field, shared by K3's
// standalone kernel (blur.cu, one block a tile) and the blur phase at the
// end of K1's cooperative launch (flow_step.cu, a loop over K1's own
// tiles).  Its row and column passes (box_rows, box_col) also serve S1
// (subpel.cu), which sums nine planes of SAD probes over the same 8 x 8
// windows.
//
// The semantics are those of the TPU kernel mpv_frame_interpolator_tpu/
// ops/pallas/blur.py:blur_flow_pallas and its XLA twin ops/flow.blur_flow,
// i.e. the reference's blurFlowKernel.cl: for both planes of a (2, lh, lw)
// int32 field, taps [-4, 3] on each axis, symmetric edges (index -1 reads
// 0, index n reads n - 1, reflecting again when a dimension is below 4, as
// numpy's "symmetric" pad does), a sum that wraps mod 2^32, and a division
// by 64 truncated toward zero.
//
// A block of 256 threads blurs a tile in three passes over shared memory:
//   * the (8 + 7) x (32 + 7) input window of both planes is loaded once,
//     the symmetric index computed once a loaded element and only in a tile
//     that touches an edge (the periodic reflection takes an integer %);
//   * each of the 2 x 15 window rows gets its 32 sums of 8 taps along the
//     row, written back over the row's first 32 words;
//   * each output sums 8 of those down its column.
// Sums mod 2^32 may be taken in any order, so the result is exact.  The
// field is read with ld.global.cg (L2), since in K1 it was written during
// the same launch.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mfi {

constexpr int kBlurR = 4;                      // blurFlowKernel.cl radius
constexpr int kBlurTX = 32, kBlurTY = 8;       // K1's tile
constexpr int kBlurThreads = kBlurTX * kBlurTY;
constexpr int kBlurWX = kBlurTX + 2 * kBlurR - 1;  // 39
constexpr int kBlurWY = kBlurTY + 2 * kBlurR - 1;  // 15
// shared words a block needs: the window of both planes
constexpr int kBlurWindowWords = 2 * kBlurWY * kBlurWX;

// periodic reflection with period 2n: numpy's "symmetric" padding
__device__ __forceinline__ int symmetric(int i, int n) {
  const int p = 2 * n;
  int j = i % p;
  if (j < 0) j += p;
  return j >= n ? p - 1 - j : j;
}

// Whether the window of the tile at (x0, y0) leaves the lh x lw field, so
// that its indices need the symmetric reflection.
__device__ __forceinline__ bool window_at_edge(int x0, int y0, int lh,
                                               int lw) {
  return x0 < kBlurR || y0 < kBlurR || x0 + kBlurWX - kBlurR > lw ||
         y0 + kBlurWY - kBlurR > lh;
}

// The row pass over the windows of kPlanes planes loaded into win (plane
// p's (8 + 7) x (32 + 7) window at p * kBlurWY * kBlurWX words, row-major):
// each window row's 32 sums of 8 taps are written back over its first 32
// words.  Thread (tx, ty) takes rows ty, ty + 8, ...  Every thread of the
// block calls it once the windows are loaded (after a barrier); it ends
// with a barrier.
template <int kPlanes>
__device__ __forceinline__ void box_rows(unsigned* win, int tid) {
  constexpr int kRows = kPlanes * kBlurWY;
  constexpr int kPer = (kRows + kBlurTY - 1) / kBlurTY;
  const int tx = tid & (kBlurTX - 1), ty = tid / kBlurTX;
  unsigned h[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + i * kBlurTY;
    h[i] = 0;
    if (r < kRows) {
#pragma unroll
      for (int k = 0; k < 2 * kBlurR; ++k) h[i] += win[r * kBlurWX + tx + k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + i * kBlurTY;
    if (r < kRows) win[r * kBlurWX + tx] = h[i];
  }
  __syncthreads();
}

// After box_rows: plane p's 8 x 8 window sum (mod 2^32) at the tile's
// output (tx, ty), the 8 row sums down its column.
__device__ __forceinline__ unsigned box_col(const unsigned* win, int p,
                                            int tx, int ty) {
  unsigned acc = 0;
#pragma unroll
  for (int k = 0; k < 2 * kBlurR; ++k)
    acc += win[(p * kBlurWY + ty + k) * kBlurWX + tx];
  return acc;
}

// Blur the tile whose top-left output is (x0, y0) of both planes of `in`
// into `out`.  Every thread of the block (kBlurThreads, tid its index)
// calls it; win is kBlurWindowWords of shared memory.  Ends with a
// barrier, so the block may call it again at once.
__device__ __forceinline__ void blur_tile(const int* in, int* out, int lh,
                                          int lw, int x0, int y0,
                                          unsigned* win, int tid) {
  const size_t plane = (size_t)lh * lw;
  const bool edge = window_at_edge(x0, y0, lh, lw);
  for (int j = tid; j < kBlurWindowWords; j += kBlurThreads) {
    const int row = j / kBlurWX;              // plane * kBlurWY + window row
    const int p = row >= kBlurWY;
    int gy = y0 - kBlurR + row - p * kBlurWY;
    int gx = x0 - kBlurR + (j - row * kBlurWX);
    if (edge) {
      gy = symmetric(gy, lh);
      gx = symmetric(gx, lw);
    }
    win[j] = (unsigned)__ldcg(in + p * plane + (size_t)gy * lw + gx);
  }
  __syncthreads();
  box_rows<2>(win, tid);
  // down the columns
  const int tx = tid & (kBlurTX - 1), ty = tid / kBlurTX;
  const int x = x0 + tx, y = y0 + ty;
  if (x < lw && y < lh) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
      out[p * plane + (size_t)y * lw + x] = (int)box_col(win, p, tx, ty) / 64;
  }
  __syncthreads();
}

}  // namespace mfi
