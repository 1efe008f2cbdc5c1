// S1: the measured sub-pel refinement of the flow (the subpel_flow option)
// for Hopper (sm_90a), as two phases of K1's cooperative launch
// (flow_step.cu, pyramid_kernel<..., kSubpel>).
//
// Not a TPU kernel: it replaces the JAX package's XLA function
// mpv_frame_interpolator_tpu/ops/flow.py:833 subpel_refine, and writes its
// result already combined with the integer offset, (offset << 6) + frac,
// the field the sub-pel path blurs next (JAX pipeline/engine.py:486-515).
// Per low-res pixel c of the UNBLURRED committed offset (ox, oy):
//   * the 9 probe SADs d_p = |y1 - y2| + |u1 - u2| + |v1 - v2|, f1 read at
//     mirror_inside((c << rs) + (ox, oy) + PROBES[p]), f2 the probe, PROBES
//     = (0,0) (-1,0) (1,0) (0,-1) (0,1) (-1,-1) (1,1) (-1,1) (1,-1) as
//     (dx, dy); under P010 each d_p >> luma_shift (8);
//   * each probe's 8 x 8 window sum, taps [-4, 3] with symmetric edges,
//     >> 6 (K3's row and column passes, blur_tile.cuh: the sums are
//     positive, so the blur's truncating division is the shift);
//   * the finite-difference gradient and Hessian, gx2 = dxp - dxm, hxx =
//     dxp + dxm - 2 d0, hxy4 = dpp + dmm - dmp - dpm (and the y twins), the
//     Newton step fx = -2 * ((hyy gx2 4 - hxy4 gy2) * 64 / max(det16, 1))
//     with det16 = 16 hxx hyy - hxy4^2, C's int division truncating toward
//     zero as jax.lax.div does, clipped to +-32 and zeroed unless d0 > 0,
//     hxx > 0, hyy > 0 and det16 > 0.
// At the 8-bit scale (a windowed cost is at most 767) every product stays
// inside int32 (the JAX comments reckon |numx * 64| < 1.6e9), so the fit is
// plain int arithmetic.
//
// What bounds it: bytes, and few of them.  A 4K field is 270 x 480
// pixels; each needs 27 gathers from the L2-resident f1 (about 9 x 3 x
// 130 K samples, ~3.5 MB) and ~360 integer operations (the mirrors and
// addresses, 9 SADs, 9 x 16 window adds, the fit): ~1 us of operations and
// ~2 us of bytes on the card.  The first design was a kernel of its own,
// one block a 32 x 8 tile that recomputed the nine SADs of its 15 x 39
// halo window (2.3x the tile's probes) in a grid under one wave, after K1
// and before a standalone blur: three launches a pair for the flow.  Now
// both are phases at the end of K1's launch, after the last step's
// barrier:
//   * phase S: each pixel's nine probe SADs, once each, into a scratch of
//     9 x lh x lw words (K1's sums buffers, free once the last step has
//     read them);
//   * barrier; phase F: per 32 x 8 tile, the nine planes' 15 x 39 windows
//     loaded into shared memory in one round, a thread's loads seven at a
//     time ahead of their stores, the window's reflected rows and columns
//     computed once a tile; then K3's 8 x 8 box as two sliding passes (a
//     thread a window row adds the word entering the window and takes off
//     the one leaving it, then a thread a column of a plane does the same
//     down it: 71 and 23 shared-memory accesses a thread where K3's
//     row and column passes take 8 reads an output), then the integer fit,
//     writing (offset << 6) + frac.  At 4K: one plane at a time through the
//     blur window's 585 words, reflecting each word in edge tiles, took 17
//     us; this 8.9.  The 21 KB window lives only in the instantiations with
//     these phases and still leaves 4 blocks an SM;
//   * barrier; K1's blur phase blurs that field.
// The standalone entry (mfi_subpel_refine) is the same launch with an
// empty schedule: the offset as the starting field, these two phases, no
// blur.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "blur_tile.cuh"
#include "flow_tile.cuh"

namespace mfi {

constexpr int kProbes = 9;
constexpr int kProbePlaneWords = kBlurWY * kBlurWX;  // 585

// PROBES[p] as (dx, dy), in the order of the JAX function
__device__ __forceinline__ int probe_dx(int p) {
  return (p == 1 || p == 5 || p == 7) ? -1 : (p == 2 || p == 6 || p == 8);
}
__device__ __forceinline__ int probe_dy(int p) {
  return (p == 3 || p == 5 || p == 8) ? -1 : (p == 4 || p == 6 || p == 7);
}

// Phase S at pixel (x, y): the nine probe SADs of the committed field
// (read with ld.global.cg: written during the launch), each >> luma_shift,
// into sads (9 planes of lh x lw words).
template <typename T>
__device__ __forceinline__ void probe_sads(
    const int* field, const T* __restrict__ f1y, const T* __restrict__ f1u,
    const T* __restrict__ f1v, const T* __restrict__ y2,
    const T* __restrict__ u2, const T* __restrict__ v2, unsigned* sads,
    int x, int y, int lh, int lw, int rs, int H, int W, int ypitch,
    int cpitch, int luma_shift) {
  if (x >= lw || y >= lh) return;
  const size_t plane = (size_t)lh * lw;
  const size_t i = (size_t)y * lw + x;
  const int bx = (x << rs) + __ldcg(field + i);
  const int by = (y << rs) + __ldcg(field + plane + i);
  const int py = y2[i], pu = u2[i], pv = v2[i];
#pragma unroll
  for (int p = 0; p < kProbes; ++p) {
    const int cx = mirror_inside(bx + probe_dx(p), W);
    const int cy = mirror_inside(by + probe_dy(p), H);
    const size_t oc = (size_t)(cy >> 1) * cpitch + (cx >> 1);
    const unsigned sad = __sad(
        (int)f1y[(size_t)cy * ypitch + cx], py,
        __sad((int)f1u[oc], pu, __sad((int)f1v[oc], pv, 0u)));
    sads[p * plane + i] = sad >> luma_shift;
  }
}

// shared words phase F needs: the nine planes' windows, then the tile's
// reflected window rows and columns
constexpr int kSubpelWindowWords = kProbes * kProbePlaneWords;  // 5265
constexpr int kSubpelSharedWords = kSubpelWindowWords + kBlurWY + kBlurWX;
// a thread's loads issued together before their stores
constexpr int kFitBatch = 7;

// Phase F for the tile whose top-left pixel is (x0, y0): the nine planes'
// windows loaded into `win` (kSubpelSharedWords of shared memory) in one
// round, a thread's loads kFitBatch at a time ahead of their stores, the
// symmetric reflection of the window's 15 rows and 39 columns computed once
// a tile (an integer % each, where each word took two); then the sliding
// row and column passes of the 8 x 8 box, then the fit; fine[i] =
// field[i] * 64 + frac on both planes.
// Every thread of the block (kBlurThreads) calls it; it ends with a
// barrier, so the block may call it again at once.
__device__ __forceinline__ void subpel_fit_tile(const unsigned* sads,
                                                const int* field, int* fine,
                                                int lh, int lw, int x0,
                                                int y0, unsigned* win,
                                                int tid) {
  const size_t plane = (size_t)lh * lw;
  const int tx = tid & (kBlurTX - 1), ty = tid / kBlurTX;
  int* rows = reinterpret_cast<int*>(win + kSubpelWindowWords);
  int* cols = rows + kBlurWY;
  if (tid < kBlurWY) {
    const int gy = y0 - kBlurR + tid;
    rows[tid] = (gy < 0 || gy >= lh) ? symmetric(gy, lh) : gy;
  } else if (tid >= kBlurTX && tid < kBlurTX + kBlurWX) {
    const int gx = x0 - kBlurR + tid - kBlurTX;
    cols[tid - kBlurTX] = (gx < 0 || gx >= lw) ? symmetric(gx, lw) : gx;
  }
  __syncthreads();
  for (int j0 = tid; j0 < kSubpelWindowWords;
       j0 += kFitBatch * kBlurThreads) {
    unsigned v[kFitBatch];
#pragma unroll
    for (int t = 0; t < kFitBatch; ++t) {
      const int j = j0 + t * kBlurThreads;
      if (j < kSubpelWindowWords) {
        const int p = j / kProbePlaneWords;
        const int k = j - p * kProbePlaneWords;
        const int row = k / kBlurWX;
        v[t] = __ldcg(sads + p * plane + (size_t)rows[row] * lw +
                      cols[k - row * kBlurWX]);
      }
    }
#pragma unroll
    for (int t = 0; t < kFitBatch; ++t) {
      const int j = j0 + t * kBlurThreads;
      if (j < kSubpelWindowWords) win[j] = v[t];
    }
  }
  __syncthreads();
  // rows: thread t < 135 slides an 8-tap sum along window row t, writing
  // each sum over the word it starts at (the word is read first)
  if (tid < kProbes * kBlurWY) {
    unsigned* r = win + tid * kBlurWX;
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < 2 * kBlurR; ++k) acc += r[k];
#pragma unroll
    for (int c = 0; c < kBlurTX; ++c) {
      const unsigned first = r[c];
      const unsigned next = c + 2 * kBlurR < kBlurWX ? r[c + 2 * kBlurR] : 0u;
      r[c] = acc;
      acc += next - first;
    }
  }
  __syncthreads();
  // columns: thread (p, c) slides down plane p's column c
  for (int q = tid; q < kProbes * kBlurTX; q += kBlurThreads) {
    unsigned* col = win + (q / kBlurTX) * kProbePlaneWords + (q % kBlurTX);
    unsigned acc = 0;
#pragma unroll
    for (int k = 0; k < 2 * kBlurR; ++k) acc += col[k * kBlurWX];
#pragma unroll
    for (int r = 0; r < kBlurTY; ++r) {
      const unsigned first = col[r * kBlurWX];
      const unsigned next = r + 2 * kBlurR < kBlurWY
                                ? col[(r + 2 * kBlurR) * kBlurWX] : 0u;
      col[r * kBlurWX] = acc;
      acc += next - first;
    }
  }
  __syncthreads();
  int c[kProbes];  // d0 dxm dxp dym dyp dmm dpp dmp dpm, windowed
#pragma unroll
  for (int p = 0; p < kProbes; ++p)
    c[p] = (int)(win[p * kProbePlaneWords + ty * kBlurWX + tx] >> 6);
  __syncthreads();  // win is reused by the block's next tile
  const int x = x0 + tx, y = y0 + ty;
  if (x >= lw || y >= lh) return;
  const int gx2 = c[2] - c[1], gy2 = c[4] - c[3];
  const int hxx = c[2] + c[1] - 2 * c[0];
  const int hyy = c[4] + c[3] - 2 * c[0];
  const int hxy4 = c[6] + c[5] - c[7] - c[8];
  const int det16 = 16 * hxx * hyy - hxy4 * hxy4;
  const int numx = hyy * gx2 * 4 - hxy4 * gy2;
  const int numy = hxx * gy2 * 4 - hxy4 * gx2;
  const int den = max(det16, 1);
  const bool valid = c[0] > 0 && hxx > 0 && hyy > 0 && det16 > 0;
  const int fx = valid ? min(max(-2 * (numx * 64 / den), -32), 32) : 0;
  const int fy = valid ? min(max(-2 * (numy * 64 / den), -32), 32) : 0;
  const size_t i = (size_t)y * lw + x;
  fine[i] = __ldcg(field + i) * 64 + fx;
  fine[plane + i] = __ldcg(field + plane + i) * 64 + fy;
}

}  // namespace mfi
