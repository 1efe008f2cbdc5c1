// S1: the measured sub-pel refinement of the flow (the subpel_flow option)
// for Hopper (sm_90a).
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
//     >> 6 (K3's tile body, blur_tile.cuh: the sums are positive, so the
//     blur's truncating division is the shift);
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
// What bounds it: operations, and few of them.  A 4K field is 270 x 480
// pixels; each needs 27 gathers from the L2-resident f1 (about 9 x 3 x
// 130 K samples, ~3.5 MB) and ~360 integer operations (the mirrors and
// addresses, 9 SADs, 9 x 16 window adds, the fit): ~1 us of operations and
// ~2 us of bytes on the card.  This first design is one block a 32 x 8
// tile: the 9 SAD planes of the tile and its 7-sample halo (15 x 39
// positions, each thread computing all nine probes of a position) go into
// shared memory, K3's row and column passes sum the windows, and each
// thread fits its pixel.  The halo costs 2.3x the tile's probes; a faster
// design would share the halo between tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blur_tile.cuh"

namespace {

constexpr int kProbes = 9;
constexpr int kPlaneWords = mfi::kBlurWY * mfi::kBlurWX;  // 585

__device__ __forceinline__ int mirror_inside(int pos, int dim) {
  if (pos >= dim) pos = dim - (pos - dim + 1);
  if (pos < 0) pos = -pos - 1;
  return min(max(pos, 0), dim - 1);
}

// PROBES[p] as (dx, dy), in the order of the JAX function
__device__ __forceinline__ int probe_dx(int p) {
  return (p == 1 || p == 5 || p == 7) ? -1 : (p == 2 || p == 6 || p == 8);
}
__device__ __forceinline__ int probe_dy(int p) {
  return (p == 3 || p == 5 || p == 8) ? -1 : (p == 4 || p == 6 || p == 7);
}

template <typename T>
__global__ void __launch_bounds__(mfi::kBlurThreads) subpel_kernel(
    const int* __restrict__ offset, const T* __restrict__ f1y,
    const T* __restrict__ f1u, const T* __restrict__ f1v,
    const T* __restrict__ y2, const T* __restrict__ u2,
    const T* __restrict__ v2, int* __restrict__ out, int lh, int lw, int rs,
    int H, int W, int ypitch, int cpitch, int luma_shift) {
  __shared__ unsigned win[kProbes * kPlaneWords];
  const int tid = threadIdx.x;
  const int ntx = (lw + mfi::kBlurTX - 1) / mfi::kBlurTX;
  const int x0 = (blockIdx.x % ntx) * mfi::kBlurTX;
  const int y0 = (blockIdx.x / ntx) * mfi::kBlurTY;
  const size_t plane = (size_t)lh * lw;
  const bool edge = mfi::window_at_edge(x0, y0, lh, lw);

  // the nine SAD planes over the tile's window, one position a thread
  for (int j = tid; j < kPlaneWords; j += mfi::kBlurThreads) {
    const int row = j / mfi::kBlurWX;
    int gy = y0 - mfi::kBlurR + row;
    int gx = x0 - mfi::kBlurR + (j - row * mfi::kBlurWX);
    if (edge) {
      gy = mfi::symmetric(gy, lh);
      gx = mfi::symmetric(gx, lw);
    }
    const size_t i = (size_t)gy * lw + gx;
    const int bx = (gx << rs) + offset[i];
    const int by = (gy << rs) + offset[plane + i];
    const int py = y2[i], pu = u2[i], pv = v2[i];
#pragma unroll
    for (int p = 0; p < kProbes; ++p) {
      const int cx = mirror_inside(bx + probe_dx(p), W);
      const int cy = mirror_inside(by + probe_dy(p), H);
      const size_t oc = (size_t)(cy >> 1) * cpitch + (cx >> 1);
      const unsigned sad = __sad(
          (int)f1y[(size_t)cy * ypitch + cx], py,
          __sad((int)f1u[oc], pu, __sad((int)f1v[oc], pv, 0u)));
      win[p * kPlaneWords + j] = sad >> luma_shift;
    }
  }
  __syncthreads();
  mfi::box_rows<kProbes>(win, tid);

  const int tx = tid & (mfi::kBlurTX - 1), ty = tid / mfi::kBlurTX;
  const int x = x0 + tx, y = y0 + ty;
  if (x >= lw || y >= lh) return;
  int c[kProbes];  // d0 dxm dxp dym dyp dmm dpp dmp dpm, windowed
#pragma unroll
  for (int p = 0; p < kProbes; ++p)
    c[p] = (int)(mfi::box_col(win, p, tx, ty) >> 6);
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
  out[i] = offset[i] * 64 + fx;
  out[plane + i] = offset[plane + i] * 64 + fy;
}

}  // namespace

// offset: (2, lh, lw) int32, the unblurred committed flow; f1y (>= H rows,
// ypitch) and f1u, f1v (>= H / 2 rows, cpitch) the older frame's planes;
// y2, u2, v2 (lh, lw) the newer frame's probe; all planes uint8
// (sample_bytes 1) or uint16 (2).  out: (2, lh, lw) int32, (offset << 6)
// + frac in 1/64 pel.  H and W are the frame height and stride, against
// which the probes mirror.
extern "C" int mfi_subpel_refine(const void* offset, const void* f1y,
                                 const void* f1u, const void* f1v,
                                 const void* y2, const void* u2,
                                 const void* v2, void* out, int lh, int lw,
                                 int rs, int H, int W, int ypitch,
                                 int cpitch, int sample_bytes,
                                 int luma_shift, void* stream) {
  if (lh < 1 || lw < 1 || H < 2 || W < 2 || luma_shift < 0 ||
      luma_shift > 31 || (sample_bytes != 1 && sample_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const int tiles = ((lw + mfi::kBlurTX - 1) / mfi::kBlurTX) *
                    ((lh + mfi::kBlurTY - 1) / mfi::kBlurTY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(offset);
  int* r = static_cast<int*>(out);
  if (sample_bytes == 2)
    subpel_kernel<uint16_t><<<tiles, mfi::kBlurThreads, 0, s>>>(
        o, static_cast<const uint16_t*>(f1y),
        static_cast<const uint16_t*>(f1u), static_cast<const uint16_t*>(f1v),
        static_cast<const uint16_t*>(y2), static_cast<const uint16_t*>(u2),
        static_cast<const uint16_t*>(v2), r, lh, lw, rs, H, W, ypitch, cpitch,
        luma_shift);
  else
    subpel_kernel<uint8_t><<<tiles, mfi::kBlurThreads, 0, s>>>(
        o, static_cast<const uint8_t*>(f1y), static_cast<const uint8_t*>(f1u),
        static_cast<const uint8_t*>(f1v), static_cast<const uint8_t*>(y2),
        static_cast<const uint8_t*>(u2), static_cast<const uint8_t*>(v2), r,
        lh, lw, rs, H, W, ypitch, cpitch, luma_shift);
  return (int)cudaGetLastError();
}
