// K1's tile geometry and per-pixel step, shared by the flow pyramid's
// cooperative launch (flow_step.cu), the layer slice of the layer-sharded
// flow (flow_slice.cu) and the sub-pel phases (subpel_tile.cuh).
//
// One block of 256 threads takes a 32 x 8 tile of the low-res field, one
// thread a pixel.  A candidate layer l of radius R offsets the stepped axis
// by signed_square(l - R/2); layer_partials gives one pixel's biased SAD of
// a chunk of layers (see the header of flow_step.cu for the step's
// semantics).  Both launches are cooperative: every block resident, grid-
// wide barriers between their phases (cooperative_launch sizes the grid).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mfi {

constexpr int kLogTX = 5;  // tile: one warp wide, eight rows
constexpr int kLogTY = 3;
constexpr int kTX = 1 << kLogTX;
constexpr int kTY = 1 << kLogTY;
constexpr int kThreads = kTX * kTY;
constexpr int kChunk = 16;         // the widest instantiation's layers
constexpr int kMaxRadius = 256;    // the engine's largest search radius
// windows of one tile: at most (32 / 2) x (8 / 2), at window 2
constexpr int kMaxLocal = (kTX / 2) * (kTY / 2);

__device__ __forceinline__ int mirror_inside(int pos, int dim) {
  if (pos >= dim) pos = dim - (pos - dim + 1);
  if (pos < 0) pos = -pos - 1;
  return min(max(pos, 0), dim - 1);
}

__device__ __forceinline__ int signed_square(int v) {
  return v > 0 ? v * v : -(v * v);
}

// a window wider than the tile spans tiles, so its sums take atomics and
// start from zero
__device__ __forceinline__ bool spans_tiles(int lg) { return lg > kLogTY; }

// One pixel's partial of each layer base .. base + kL - 1 on the stepped
// axis (kIsY: y); layers at or past `end` give 0.  The axis not stepped
// gives a fixed row (x step) or column (y step), so each layer mirrors one
// coordinate and gathers three samples; __sad is |a - b| + c in one
// instruction.  (bx, by): the pixel's full-resolution position plus its
// offset; (py, pu, pv): the probe; n[4]: the stepped axis of the four
// neighbours (nb only).
template <typename T, bool kIsY, int kL>
__device__ __forceinline__ void layer_partials(
    const T* __restrict__ f1y, const T* __restrict__ f1u,
    const T* __restrict__ f1v, int bx, int by, int own, int py, int pu,
    int pv, const int n[4], bool nb, int base, int end, int radius, int ds,
    int nbs, int luma_shift, int H, int W, int ypitch, int cpitch,
    unsigned part[kL]) {
  const int half = radius / 2;
  const int fixed = kIsY ? mirror_inside(bx, W) : mirror_inside(by, H);
  const T* ry = f1y + (kIsY ? fixed : fixed * ypitch);
  const T* ru = f1u + (kIsY ? (fixed >> 1) : (fixed >> 1) * cpitch);
  const T* rv = f1v + (kIsY ? (fixed >> 1) : (fixed >> 1) * cpitch);
  // the gathers of every layer of the chunk are issued without a branch
  // (layers past the end re-read the last one's samples), so the loads of
  // many layers are in flight at once; a layer costs one L2 round trip
  // when each waits for the last
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    const int g = base + l;
    const int adj = signed_square(min(g, end - 1) - half);
    const int probe = own + adj;
    const int c = kIsY ? mirror_inside(by + adj, H)
                       : mirror_inside(bx + adj, W);
    const int oy = kIsY ? c * ypitch : c;
    const int oc = kIsY ? (c >> 1) * cpitch : (c >> 1);
    const unsigned sad =
        __sad((int)ry[oy], py, __sad((int)ru[oc], pu,
                                     __sad((int)rv[oc], pv, 0u)));
    unsigned p = ((sad >> luma_shift) << ds) + (unsigned)abs(probe);
    if (nb)
      p += __sad(n[0], probe, __sad(n[1], probe, __sad(n[2], probe,
                 __sad(n[3], probe, 0u)))) << nbs;
    part[l] = g < end ? p : 0u;
  }
}

// where a launch's time goes: block 0 writes %globaltimer (ns) at the start
// and after each barrier, into an optional buffer
__device__ __forceinline__ void stamp(unsigned long long* timeline, int k) {
  if (timeline != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    timeline[k] = t;
  }
}

// zero n words, spread over the whole grid
__device__ __forceinline__ void zero(unsigned* p, size_t n) {
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    p[i] = 0;
}

// Launch `kernel` cooperatively on the current device with every block
// resident (the grid barriers need it) and at most one block per tile of
// the lh x lw field.  The grid follows the occupancy API; a card or kernel
// that cannot hold one block an SM is refused, never launched otherwise.
inline cudaError_t cooperative_launch(const void* kernel, int lh, int lw,
                                      void** args, cudaStream_t s) {
  int dev, sms, per_sm, coop;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int ntiles = ((lw + kTX - 1) / kTX) * ((lh + kTY - 1) / kTY);
  const int blocks = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                  0, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace mfi
