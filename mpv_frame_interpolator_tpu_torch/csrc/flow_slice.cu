// K1's layer slice for the layer-sharded flow, for Hopper (sm_90a): one
// cooperative launch a pyramid step and rank, which first commits the
// previous step's winner.
//
// It replaces the XLA function mpv_frame_interpolator_tpu/parallel/
// sharding.py:60 layer_slice_sums and the local argmin / min after it
// (:129-130), and K1's commit tail (ops/pallas/flow_step.py:415
// flow_step_commit) on the gathered winners.  Rank d of D owns the layers
// [z0, z0 + n) of radius R; a launch of step s+1 does:
//   1. commit: step s's (min, layer) pairs of every rank, gathered as
//      (D, 2, nwy, nwx) int32, give each window the layer of the first rank
//      whose minimum is least in unsigned order (the blocks of layers
//      ascend with the rank, so that is the single-device first minimum);
//      its signed_square(layer - R/2) is added to the stepped axis of the
//      rank's copy of the field, in place.  Every rank commits the same
//      winners, so the field stays replicated.  Each thread of phase 2
//      commits its own pixel as it reads it, with no barrier, since phase 2
//      reads no other pixel of that axis (the neighbour bias reads the axis
//      this step steps, and the pyramid alternates the axes; a step with
//      the bias on the axis the previous step stepped is refused).  The
//      first step has nothing to commit; a launch with no step to sum
//      (pairs null) is the commit that ends the pyramid.
//   2. sums: K1's phase A (flow_step.cu) over the slice's layers: per pixel
//      of a 32 x 8 tile its inputs read once, layer_partials with base z0
//      and the gathers of a chunk of kL layers in flight together, the
//      partials summed per window with shuffles, then in shared memory.
//      The field is read with ld.global.cg (written in the launch).
//   3. minimum: per window the first unsigned minimum over the slice and
//      the global layer that reaches it, into `pairs` (the tensor the ranks
//      gather).  Windows up to 8 fit in a tile, so the block takes it from
//      shared memory (window 1: each pixel its own), with no barrier;
//      windows of 16 and up span tiles, so phase 2 adds each tile's sums
//      into a global sums buffer with atomics, and after a barrier a thread
//      a window reads them back.  The caller alternates two sums buffers:
//      a launch's buffer is zero on entry, and it zeroes the other for the
//      next step (K1's ping-pong, flow_step.cu), so no memset is launched.
// Instantiated, as K1, on 5, 8 and 16 layers a chunk (the smallest that
// holds the slice), and on a 16-layer chunk loop for slices above 16
// (radius up to 256 at one rank).  Sums wrap mod 2^32 in any order, so the
// result is exact.
//
// What bounds it: the same work as K1's phase A for n of the radius'
// layers (a few MB touched, ~n x 4.4 M scalar operations at 4K): 0.0043
// ms at 4 layers by bytes, 0.0173 at 16 by operations, for the 16 steps of
// a 4K pair.  The first design launched a memset, a sums kernel (one layer
// at a time, one global atomic per warp segment and layer) and a minimum
// kernel a step, and the host then stacked, gathered, took the winner and
// committed with a dozen tensor operations; this one is one launch a step
// beside the gather, with no barrier at windows up to 8 and one above.
// What is left is the sums (K1's phase A), a barrier and the minima at the
// wide windows, and the launch itself.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flow_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using mfi::kChunk;
using mfi::kLogTX;
using mfi::kLogTY;
using mfi::kMaxLocal;
using mfi::kMaxRadius;
using mfi::kThreads;
using mfi::kTX;
using mfi::kTY;
using mfi::layer_partials;
using mfi::signed_square;
using mfi::spans_tiles;

// The previous step's commit at pixel (x, y): the winner of its window (of
// 2^plg) is the layer of the first rank whose minimum is least in unsigned
// order; its signed square is what the pixel's stepped axis gains.
__device__ __forceinline__ int commit_of(const int* __restrict__ gathered,
                                         int ranks, int pw, int pnwx,
                                         int plg, int x, int y, int half) {
  const int wi = (y >> plg) * pnwx + (x >> plg);
  unsigned best = (unsigned)gathered[wi];
  int layer = gathered[pw + wi];
  for (int d = 1; d < ranks; ++d) {
    const unsigned v = (unsigned)gathered[2 * d * pw + wi];
    if (v < best) {
      best = v;
      layer = gathered[(2 * d + 1) * pw + wi];
    }
  }
  return signed_square(layer - half);
}

// code: log2(window) | is_y << 8 | nb_enabled << 9, as K1's schedule
template <typename T, int kL, bool kChunked>
__global__ void __launch_bounds__(kThreads, 4) slice_kernel(
    const T* __restrict__ f1y, const T* __restrict__ f1u,
    const T* __restrict__ f1v, const T* __restrict__ y2,
    const T* __restrict__ u2, const T* __restrict__ v2, int* field,
    const int* __restrict__ gathered, int ranks, int prev_code, int* pairs,
    unsigned* sums, unsigned* next_sums, int next_words, int code, int z0,
    int n, int radius, int ds, int nbs, int rs, int H, int W, int lh,
    int lw, int ypitch, int cpitch, int luma_shift,
    unsigned long long* timeline) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned s_sums[kL * kMaxLocal];
  mfi::stamp(timeline, 0);
  const int tid = threadIdx.x;
  const int tx = tid & (kTX - 1), ty = tid >> kLogTX;
  const int ntx = (lw + kTX - 1) >> kLogTX;
  const int ntiles = ntx * ((lh + kTY - 1) >> kLogTY);
  const int plane = lh * lw;
  const int first = blockIdx.x * kThreads + tid;
  const int stride = gridDim.x * kThreads;
  int* fx = field;
  int* fy = field + plane;
  const int half = radius / 2;
  const int lg = code & 31;
  const bool is_y = (code >> 8) & 1;
  const bool nb = (code >> 9) & 1;
  const int plg = prev_code & 31;
  const bool prev_y = (prev_code >> 8) & 1;
  const int pnwx = ((lw - 1) >> plg) + 1;
  const int pw = (((lh - 1) >> plg) + 1) * pnwx;

  // phase 1, the previous step's commit: inside phase 2, each thread its
  // own pixel; the commit that ends the pyramid (no pairs) is this loop
  if (pairs == nullptr) {
    if (gathered != nullptr) {
      int* paxis = prev_y ? fy : fx;
      for (int i = first; i < plane; i += stride) {
        const int y = i / lw;
        paxis[i] += commit_of(gathered, ranks, pw, pnwx, plg, i - y * lw, y,
                              half);
      }
    }
    if (timeline != nullptr) grid.sync();
    mfi::stamp(timeline, 1);
    return;
  }
  mfi::stamp(timeline, 1);
  // this step's sums start from zero, which the previous launch left them;
  // the next step's are zeroed here (K1's ping-pong buffers)
  if (next_sums != nullptr) mfi::zero(next_sums, (size_t)next_words);
  const int nwy = ((lh - 1) >> lg) + 1, nwx = ((lw - 1) >> lg) + 1;
  const int wplane = nwy * nwx;

  // phase 2: the window sums of the slice's layers, a chunk of kL at a time
  // (one chunk unless kChunked); windows within a tile keep a running
  // first minimum (thread tid < nloc: window tid of the tile; window 1:
  // each pixel)
  int* axis = is_y ? fy : fx;
  const int end = z0 + n;
  const int lgx = min(lg, kLogTX), lgy = min(lg, kLogTY);
  const int nlx = kTX >> lgx;
  const int nloc = nlx * (kTY >> lgy);
  const int seg = 1 << lgx;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int x0 = (tile % ntx) << kLogTX, y0 = (tile / ntx) << kLogTY;
    const int x = x0 + tx, y = y0 + ty;
    const bool in = x < lw && y < lh;
    const int i = y * lw + x;
    // the pixel's inputs, read once for every chunk
    int ox = 0, oy = 0, bx = 0, by = 0, py = 0, pu = 0, pv = 0;
    int nv[4] = {0, 0, 0, 0};
    if (in) {
      ox = __ldcg(fx + i);
      oy = __ldcg(fy + i);
      if (gathered != nullptr) {  // the pixel's share of the commit
        const int d = commit_of(gathered, ranks, pw, pnwx, plg, x, y, half);
        if (prev_y) {
          oy += d;
          fy[i] = oy;
        } else {
          ox += d;
          fx[i] = ox;
        }
      }
      if (nb) {  // the neighbour bias at +-2*window, clamped
        const int w2 = 2 * min(1 << lg, 1 << 29);
        nv[0] = __ldcg(axis + y * lw + min(x + w2, lw - 1));
        nv[1] = __ldcg(axis + y * lw + max(x - w2, 0));
        nv[2] = __ldcg(axis + min(y + w2, lh - 1) * lw + x);
        nv[3] = __ldcg(axis + max(y - w2, 0) * lw + x);
      }
      bx = (x << rs) + ox;
      by = (y << rs) + oy;
      py = y2[i];
      pu = u2[i];
      pv = v2[i];
    }
    unsigned best = 0;
    int best_l = z0;
    for (int c0 = z0; c0 < (kChunked ? end : z0 + 1); c0 += kL) {
      unsigned part[kL];
#pragma unroll
      for (int l = 0; l < kL; ++l) part[l] = 0;
      if (in) {
        if (is_y)
          layer_partials<T, true, kL>(f1y, f1u, f1v, bx, by, oy, py, pu, pv,
                                      nv, nb, c0, end, radius, ds, nbs,
                                      luma_shift, H, W, ypitch, cpitch, part);
        else
          layer_partials<T, false, kL>(f1y, f1u, f1v, bx, by, ox, py, pu, pv,
                                       nv, nb, c0, end, radius, ds, nbs,
                                       luma_shift, H, W, ypitch, cpitch,
                                       part);
      }
      if (lg == 0) {  // window 1: the pixel's own first minimum
        if (in) {
#pragma unroll
          for (int l = 0; l < kL; ++l) {
            const int g = c0 + l;  // a later layer wins only on <
            if (g < end && (g == z0 || part[l] < best)) {
              best = part[l];
              best_l = g;
            }
          }
        }
        continue;  // lg is the same in every thread of the block
      }
      const int nl = min(kL, end - c0);  // the chunk's live layers
      for (int j = tid; j < nl * nloc; j += kThreads) s_sums[j] = 0;
      __syncthreads();
      const int loc = (ty >> lgy) * nlx + (tx >> lgx);
      // the shuffles of every layer at one distance are independent, so
      // they are issued together rather than layer after layer
      for (int off = kTX >> 1; off > 0; off >>= 1) {
        if (off < seg) {
#pragma unroll
          for (int l = 0; l < kL; ++l)
            if (l < nl)
              part[l] += __shfl_down_sync(0xffffffffu, part[l], off);
        }
      }
      if ((tx & (seg - 1)) == 0) {
#pragma unroll
        for (int l = 0; l < kL; ++l)
          if (l < nl) atomicAdd(&s_sums[l * nloc + loc], part[l]);
      }
      __syncthreads();
      if (spans_tiles(lg)) {
        for (int j = tid; j < nl * nloc; j += kThreads) {
          const int l = j / nloc, k = j - l * nloc;
          const int gy = (y0 >> lg) + k / nlx, gx = (x0 >> lg) + k % nlx;
          if (gy < nwy && gx < nwx)
            atomicAdd(sums + (c0 - z0 + l) * wplane + gy * nwx + gx,
                      s_sums[j]);
        }
      } else if (tid < nloc) {
        for (int l = 0; l < nl; ++l) {
          const unsigned v = s_sums[l * nloc + tid];
          if (c0 + l == z0 || v < best) {
            best = v;
            best_l = c0 + l;
          }
        }
      }
      __syncthreads();  // s_sums is reused by the next chunk or tile
    }
    if (lg == 0) {
      if (in) {  // window 1: the windows are the pixels
        pairs[i] = (int)best;
        pairs[plane + i] = best_l;
      }
    } else if (!spans_tiles(lg) && tid < nloc) {
      const int gy = (y0 >> lg) + tid / nlx, gx = (x0 >> lg) + tid % nlx;
      if (gy < nwy && gx < nwx) {
        const int wi = gy * nwx + gx;
        pairs[wi] = (int)best;
        pairs[wplane + wi] = best_l;
      }
    }
  }
  if (!spans_tiles(lg)) {
    if (timeline != nullptr) grid.sync();
    mfi::stamp(timeline, 2);
    return;
  }

  // phase 3: windows that span tiles, from the global sums
  grid.sync();
  mfi::stamp(timeline, 2);
  for (int wi = first; wi < wplane; wi += stride) {
    unsigned best = __ldcg(sums + wi);
    int best_l = 0;
    for (int l = 1; l < n; ++l) {
      const unsigned v = __ldcg(sums + l * wplane + wi);
      if (v < best) {
        best = v;
        best_l = l;
      }
    }
    pairs[wi] = (int)best;
    pairs[wplane + wi] = z0 + best_l;
  }
  if (timeline != nullptr) grid.sync();
  mfi::stamp(timeline, 3);
}

// the instantiation of a slice of n layers: the smallest chunk of K1's
// buckets that holds it, or 16-layer chunks above 16
template <typename T>
const void* slice_for(int n) {
  if (n > kChunk) return (const void*)slice_kernel<T, kChunk, true>;
  if (n <= 5) return (const void*)slice_kernel<T, 5, false>;
  if (n <= 8) return (const void*)slice_kernel<T, 8, false>;
  return (const void*)slice_kernel<T, kChunk, false>;
}

template <typename T>
int launch_slice(const void* f1y, const void* f1u, const void* f1v,
                 const void* y2, const void* u2, const void* v2, void* field,
                 const void* gathered, int ranks, int prev_code, void* pairs,
                 void* sums, void* next_sums, int next_words, int code,
                 int z0, int n, int radius, int ds,
                 int nbs, int rs, int H, int W, int lh, int lw, int ypitch,
                 int cpitch, int luma_shift, void* timeline,
                 cudaStream_t s) {
  const T* a1y = static_cast<const T*>(f1y);
  const T* a1u = static_cast<const T*>(f1u);
  const T* a1v = static_cast<const T*>(f1v);
  const T* a2y = static_cast<const T*>(y2);
  const T* a2u = static_cast<const T*>(u2);
  const T* a2v = static_cast<const T*>(v2);
  int* fl = static_cast<int*>(field);
  const int* ga = static_cast<const int*>(gathered);
  int* pr = static_cast<int*>(pairs);
  unsigned* sm = static_cast<unsigned*>(sums);
  unsigned* nx = static_cast<unsigned*>(next_sums);
  unsigned long long* tl = static_cast<unsigned long long*>(timeline);
  void* args[] = {&a1y, &a1u,    &a1v, &a2y,       &a2u,   &a2v,
                  &fl,  &ga,     &ranks, &prev_code, &pr,  &sm,
                  &nx,  &next_words, &code, &z0,     &n,    &radius,
                  &ds,  &nbs,    &rs,  &H,         &W,     &lh,
                  &lw,  &ypitch, &cpitch, &luma_shift, &tl};
  return (int)mfi::cooperative_launch(slice_for<T>(pairs ? n : 1), lh, lw,
                                      args, s);
}

bool valid_code(int code) {
  return (code & 31) <= 30 && (code & ~(31 | 1 << 8 | 1 << 9)) == 0;
}

// the neighbour bias reads other pixels of the axis it steps, which the
// inline commit of the previous step must not have changed
bool bias_reads_the_commit(int prev_code, int code) {
  return ((code >> 9) & 1) && ((code >> 8) & 1) == ((prev_code >> 8) & 1);
}

}  // namespace

// One rank's launch of a pyramid step of the layer-sharded flow.
// field: (2, lh, lw) int32, the rank's copy of the committed field,
// updated in place; gathered: null (nothing to commit) or (ranks, 2,
// ceil(lh / w'), ceil(lw / w')) int32, every rank's (min, layer) pairs of
// the previous step, whose code is prev_code (window w'); pairs: null (the
// commit alone) or (2, ceil(lh / w), ceil(lw / w)) int32 out, this rank's
// first unsigned minimum (its 32 bits) over the layers [z0, z0 + n) of
// `radius` and the global layer that reaches it, for the step `code`
// (window w; with both, `code` may not take the neighbour bias on the
// axis of prev_code); sums: n x ceil(lh / w) x ceil(lw / w) uint32
// scratch when w >= 16, ZERO on entry (else unused); next_sums: null or
// next_words uint32
// that the launch zeroes for the next step (the caller alternates two
// buffers, as K1 does inside its launch).  1 <= n, 0 <= z0, z0 + n <=
// radius <= 256.  Planes, pitches, H and W as for mfi_flow_pyramid.
// timeline: null, or 4 uint64 that receive %globaltimer (ns) at the start
// and after each phase (a commit-only launch writes the first two), with a
// barrier after the last.
extern "C" int mfi_flow_layer_slice(
    const void* f1y, const void* f1u, const void* f1v, const void* y2,
    const void* u2, const void* v2, void* field, const void* gathered,
    void* pairs, void* sums, void* next_sums, int next_words, int ranks,
    int prev_code, int code, int z0, int n, int radius, int ds, int nbs,
    int rs, int H, int W, int lh, int lw, int ypitch, int cpitch,
    int sample_bytes, int luma_shift, void* timeline, void* stream) {
  if (radius < 1 || radius > kMaxRadius || lh < 1 || lw < 1 ||
      next_words < 0 ||
      (gathered != nullptr && (ranks < 1 || !valid_code(prev_code))) ||
      (pairs != nullptr && (n < 1 || z0 < 0 || z0 + n > radius ||
                            !valid_code(code))) ||
      (gathered != nullptr && pairs != nullptr &&
       bias_reads_the_commit(prev_code, code)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sample_bytes == 2)
    return launch_slice<uint16_t>(f1y, f1u, f1v, y2, u2, v2, field, gathered,
                                  ranks, prev_code, pairs, sums, next_sums,
                                  next_words, code, z0, n, radius, ds, nbs,
                                  rs, H, W, lh, lw, ypitch, cpitch,
                                  luma_shift, timeline, s);
  return launch_slice<uint8_t>(f1y, f1u, f1v, y2, u2, v2, field, gathered,
                               ranks, prev_code, pairs, sums, next_sums,
                               next_words, code, z0, n, radius, ds, nbs, rs,
                               H, W, lh, lw, ypitch, cpitch, luma_shift,
                               timeline, s);
}
