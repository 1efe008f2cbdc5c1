// K1: the block-matching flow pyramid -- every step of a pair in one
// persistent, cooperative launch -- for Hopper (sm_90a).
//
// Replaces the TPU kernel mpv_frame_interpolator_tpu/ops/pallas/
// flow_step.py:flow_step_pallas (with its XLA tail flow_step_commit) and
// the lax.scan over it (ops/flow.py); the semantics of one step are those
// of the JAX step branch ops/flow._make_step_branch, i.e. of the
// reference's calcDeltaSumsKernel.cl + determineLowestLayerKernel.cl +
// adjustOffsetArrayKernel.cl.
//
// One step on axis is_y: for each layer l < radius the candidate offset on
// the stepped axis is adj = signed_square(l - radius/2).  Per low-res
// pixel c:
//   sad     = |y1 - y2| + |u1 - u2| + |v1 - v2|, f1 read at
//             mirror_inside((c << rs) + offset + adj), f2 the probe
//   partial = ((sad >> luma_shift) << ds) + |probe|
//             + (neighbour bias << nbs)                         (uint32)
// summed over window x window blocks mod 2^32; the first minimum over the
// layers in unsigned order wins and its signed square is committed to the
// stepped axis of every pixel of the block.  The neighbour bias reads the
// stepped axis at +-2*window, clamped to the field, as the previous step
// committed it.
//
// What bounds it: at 4K the low-res field is 270 x 480 and a step has
// radius x 129,600 candidates, each three byte gathers from an L2-resident
// frame plus a 32-bit add: a few MB and ~70 M scalar operations a step,
// ~1.1 us at the card's scalar rate.  What cost the time was around that
// work: three launches a step from a Python loop (a memset, the sums, the
// commit), one thread per (layer, pixel) that re-read the pixel's inputs
// per layer, and ~1,000 same-address atomics per window sum.  The design:
//   * one launch per pyramid: cudaLaunchCooperativeKernel with every
//     block resident, grid-wide barriers between the phases of a step,
//     the schedule (window, axis, neighbour bias per step) a kernel
//     argument; a single step is a schedule of one;
//   * one thread per pixel of a 32 x 8 tile, reading its inputs once and
//     looping over the layers with the partials in registers;
//   * phase A: each layer's partials are summed per window within the warp
//     (shuffles), then per window within the tile (shared-memory atomics),
//     and one value per (tile, layer, window) reaches global memory: a
//     plain store when the window fits in the tile (window <= 8), else an
//     atomicAdd (window >= 16: one per tile the window covers, 256 at
//     window 256);
//   * barrier; phase B: each pixel takes its window's first unsigned
//     minimum and commits its stepped axis in place; the same phase zeroes
//     the other of two ping-pong sums buffers for the next step (last read
//     before the previous barrier), so no memset is launched;
//   * window 1 needs no reduction: phase A keeps each pixel's winner;
//   * last, when the caller asks for it, the 8x8 flow blur (K3's tile body,
//     blur_tile.cuh) after one more barrier, over the same 32 x 8 tiles,
//     into a second output: the pair's flow and its blur in one launch,
//     where the blur took a launch and a Python wrapper of its own.
// Window sums are unsigned additions mod 2^32, so any order of adds gives
// the same bits: the result is exact.  Field and sums written during the
// launch are read with ld.global.cg (L2), never through the read-only or
// L1 path.  Windows are powers of two, so window indices are shifts.
//
// The layer count follows the search radius.  The kernel is instantiated
// on a chunk of kL layers, the engine's layer buckets 5, 8 and 16, and a
// thread issues the gathers, partials, shuffles and shared-memory adds of
// kL layers: at radius 5 a third of the work of radius 16, where one
// 16-layer kernel re-read the last layer's samples past the radius.  Radii
// above 16 (up to 256) take the 16-layer chunk in a loop (kChunked):
// phase A sums one chunk of layers at a time into the global sums, which
// hold every layer (radius x windows words), with the shared sums one
// chunk wide; phase B and window 1 keep a running first unsigned minimum
// across the chunks, a later chunk winning only on a strict <, so the
// winner is the first minimum over all layers as in one pass.  The chunk
// loop is a code path of its own (if constexpr), and the instantiations of
// one chunk run phase A and B as one pass over their kL layers: with the
// loop in their code, the pixel's inputs, live across it, made them spill
// (4-12 bytes a thread), where one pass needs no local memory.
//
// The kernel is templated on the sample type: uint8_t for NV12, uint16_t
// for P010.  Under P010 three 16-bit differences reach ~2^17.6, so the SAD
// is shifted right by luma_shift (8) before << ds, in the order of the TPU
// kernel (flow_step.py:310-315); shifting after would wrap the window sums
// differently.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blur_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kLogTX = 5;  // tile: one warp wide, eight rows
constexpr int kLogTY = 3;
constexpr int kTX = 1 << kLogTX;
constexpr int kTY = 1 << kLogTY;
constexpr int kThreads = kTX * kTY;
constexpr int kChunk = 16;         // the widest instantiation's layers
constexpr int kMaxRadius = 256;    // the engine's largest search radius
constexpr int kMaxSteps = 64;
// windows of one tile: at most (32 / 2) x (8 / 2), at window 2
constexpr int kMaxLocal = (kTX / 2) * (kTY / 2);
// shared words of phase A's sums (one chunk of layers), which the blur
// phase reuses as its window
constexpr int kSharedWords = kChunk * kMaxLocal > mfi::kBlurWindowWords
                                 ? kChunk * kMaxLocal
                                 : mfi::kBlurWindowWords;
static_assert(kTX == mfi::kBlurTX && kTY == mfi::kBlurTY,
              "the blur phase runs on K1's tiles");

// step code: log2(window) | is_y << 8 | nb_enabled << 9
struct Schedule {
  int n;
  int code[kMaxSteps];
};

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

__device__ __forceinline__ size_t sums_of(int lg, int radius, int lh,
                                          int lw) {
  return (size_t)radius * (((lh - 1) >> lg) + 1) * (((lw - 1) >> lg) + 1);
}

// One pixel's partial of each layer base .. base + kL - 1 on the stepped
// axis (kIsY: y).  The axis not stepped gives a fixed row (x step) or
// column (y step), so each layer mirrors one coordinate and gathers three
// samples; __sad is |a - b| + c in one instruction.  (bx, by): the
// pixel's full-resolution position plus its offset; (py, pu, pv): the
// probe; n[4]: the stepped axis of the four neighbours (nb only).
template <typename T, bool kIsY, int kL>
__device__ __forceinline__ void layer_partials(
    const T* __restrict__ f1y, const T* __restrict__ f1u,
    const T* __restrict__ f1v, int bx, int by, int own, int py, int pu,
    int pv, const int n[4], bool nb, int base, int radius, int ds, int nbs,
    int luma_shift, int H, int W, int ypitch, int cpitch,
    unsigned part[kL]) {
  const int half = radius / 2;
  const int fixed = kIsY ? mirror_inside(bx, W) : mirror_inside(by, H);
  const T* ry = f1y + (kIsY ? fixed : fixed * ypitch);
  const T* ru = f1u + (kIsY ? (fixed >> 1) : (fixed >> 1) * cpitch);
  const T* rv = f1v + (kIsY ? (fixed >> 1) : (fixed >> 1) * cpitch);
  // the gathers of every layer of the chunk are issued without a branch
  // (layers past the radius re-read the last one's samples), so the loads
  // of many layers are in flight at once; a layer costs one L2 round trip
  // when each waits for the last
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    const int g = base + l;
    const int adj = signed_square(min(g, radius - 1) - half);
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
    part[l] = g < radius ? p : 0u;
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

__device__ void zero(unsigned* p, size_t n) {
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    p[i] = 0;
}

// kL: the layers of one chunk; kChunked: radius > kL, the layers taken a
// chunk at a time (kL = 16), else one chunk holds every layer
template <typename T, int kL, bool kChunked>
__global__ void __launch_bounds__(kThreads, 4) pyramid_kernel(
    const T* __restrict__ f1y, const T* __restrict__ f1u,
    const T* __restrict__ f1v, const T* __restrict__ y2,
    const T* __restrict__ u2, const T* __restrict__ v2, const int* in_x,
    const int* in_y, int* field, int* blurred, unsigned* sums,
    size_t sums_words,
    Schedule sched, int radius, int ds, int nbs, int rs, int H, int W,
    int lh, int lw, int ypitch, int cpitch, int luma_shift,
    unsigned long long* timeline) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned s_sums[kSharedWords];
  __shared__ int s_best[kMaxLocal];
  stamp(timeline, 0);
  const int tid = threadIdx.x;
  const int tx = tid & (kTX - 1), ty = tid >> kLogTX;
  const int ntx = (lw + kTX - 1) >> kLogTX;
  const int ntiles = ntx * ((lh + kTY - 1) >> kLogTY);
  const size_t plane = (size_t)lh * lw;
  int* fx = field;
  int* fy = field + plane;
  const int half = radius / 2;

  // prologue: the starting field (zero without one), the first sums
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < plane;
       i += stride) {
    fx[i] = in_x ? in_x[i] : 0;
    fy[i] = in_y ? in_y[i] : 0;
  }
  if (sched.n > 0 && spans_tiles(sched.code[0] & 31))
    zero(sums, sums_of(sched.code[0] & 31, radius, lh, lw));
  grid.sync();
  stamp(timeline, 1);

  for (int s = 0; s < sched.n; ++s) {
    const int code = sched.code[s];
    const int lg = code & 31;
    const bool is_y = (code >> 8) & 1;
    const bool nb = (code >> 9) & 1;
    const int nwy = ((lh - 1) >> lg) + 1, nwx = ((lw - 1) >> lg) + 1;
    const size_t wplane = (size_t)nwy * nwx;
    unsigned* cur = sums + (s & 1) * sums_words;
    int* axis = is_y ? fy : fx;

    // phase A: the window sums of every layer (one chunk of kL, as
    // one pass over the layers; chunked: a chunk of kL at a time)
    if constexpr (!kChunked) {
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int x0 = (tile % ntx) << kLogTX, y0 = (tile / ntx) << kLogTY;
        const int x = x0 + tx, y = y0 + ty;
        const bool in = x < lw && y < lh;
        unsigned part[kL];
#pragma unroll
        for (int l = 0; l < kL; ++l) part[l] = 0;
        if (in) {
          const int i = y * lw + x;
          const int ox = __ldcg(fx + i), oy = __ldcg(fy + i);
          int n[4] = {0, 0, 0, 0};
          if (nb) {  // the neighbour bias at +-2*window, clamped
            const int w2 = 2 * min(1 << lg, 1 << 29);
            n[0] = __ldcg(axis + y * lw + min(x + w2, lw - 1));
            n[1] = __ldcg(axis + y * lw + max(x - w2, 0));
            n[2] = __ldcg(axis + min(y + w2, lh - 1) * lw + x);
            n[3] = __ldcg(axis + max(y - w2, 0) * lw + x);
          }
          const int bx = (x << rs) + ox, by = (y << rs) + oy;
          if (is_y)
            layer_partials<T, true, kL>(f1y, f1u, f1v, bx, by, oy, y2[i],
                                        u2[i], v2[i], n, nb, 0, radius, ds,
                                        nbs, luma_shift, H, W, ypitch, cpitch,
                                        part);
          else
            layer_partials<T, false, kL>(f1y, f1u, f1v, bx, by, ox, y2[i],
                                         u2[i], v2[i], n, nb, 0, radius, ds,
                                         nbs, luma_shift, H, W, ypitch,
                                         cpitch, part);
        }
        if (lg == 0) {  // window 1: the pixel's own first minimum
          if (in) {
            unsigned best = part[0];
            int best_l = 0;
#pragma unroll
            for (int l = 1; l < kL; ++l)
              if (l < radius && part[l] < best) {
                best = part[l];
                best_l = l;
              }
            __stcg(cur + y * lw + x, (unsigned)best_l);
          }
          continue;  // lg is the same in every thread of the block
        }
        const int lgx = min(lg, kLogTX), lgy = min(lg, kLogTY);
        const int nlx = kTX >> lgx;
        const int nloc = nlx * (kTY >> lgy);
        for (int j = tid; j < radius * nloc; j += kThreads) s_sums[j] = 0;
        __syncthreads();
        const int seg = 1 << lgx;
        const int loc = (ty >> lgy) * nlx + (tx >> lgx);
        // the shuffles of every layer at one distance are independent, so
        // they are issued together rather than layer after layer
        for (int off = kTX >> 1; off > 0; off >>= 1) {
          if (off < seg) {
#pragma unroll
            for (int l = 0; l < kL; ++l)
              if (l < radius)
                part[l] += __shfl_down_sync(0xffffffffu, part[l], off);
          }
        }
        if ((tx & (seg - 1)) == 0) {
#pragma unroll
          for (int l = 0; l < kL; ++l)
            if (l < radius) atomicAdd(&s_sums[l * nloc + loc], part[l]);
        }
        __syncthreads();
        for (int j = tid; j < radius * nloc; j += kThreads) {
          const int l = j / nloc, k = j - l * nloc;
          const int gy = (y0 >> lg) + k / nlx, gx = (x0 >> lg) + k % nlx;
          if (gy < nwy && gx < nwx) {
            unsigned* dst = cur + l * wplane + (size_t)gy * nwx + gx;
            if (spans_tiles(lg))
              atomicAdd(dst, s_sums[j]);
            else
              __stcg(dst, s_sums[j]);
          }
        }
        __syncthreads();  // s_sums is reused by the block's next tile
      }
    } else {
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int x0 = (tile % ntx) << kLogTX, y0 = (tile / ntx) << kLogTY;
        const int x = x0 + tx, y = y0 + ty;
        const bool in = x < lw && y < lh;
        // the pixel's inputs, read once for every chunk
        int ox = 0, oy = 0, bx = 0, by = 0, py = 0, pu = 0, pv = 0;
        int n[4] = {0, 0, 0, 0};
        if (in) {
          const int i = y * lw + x;
          ox = __ldcg(fx + i);
          oy = __ldcg(fy + i);
          if (nb) {  // the neighbour bias at +-2*window, clamped
            const int w2 = 2 * min(1 << lg, 1 << 29);
            n[0] = __ldcg(axis + y * lw + min(x + w2, lw - 1));
            n[1] = __ldcg(axis + y * lw + max(x - w2, 0));
            n[2] = __ldcg(axis + min(y + w2, lh - 1) * lw + x);
            n[3] = __ldcg(axis + max(y - w2, 0) * lw + x);
          }
          bx = (x << rs) + ox;
          by = (y << rs) + oy;
          py = y2[i];
          pu = u2[i];
          pv = v2[i];
        }
        unsigned best = 0;  // window 1: the pixel's running first minimum
        int best_l = 0;
        for (int c0 = 0; c0 < radius; c0 += kL) {
          unsigned part[kL];
#pragma unroll
          for (int l = 0; l < kL; ++l) part[l] = 0;
          if (in) {
            if (is_y)
              layer_partials<T, true, kL>(f1y, f1u, f1v, bx, by, oy, py, pu,
                                          pv, n, nb, c0, radius, ds, nbs,
                                          luma_shift, H, W, ypitch, cpitch,
                                          part);
            else
              layer_partials<T, false, kL>(f1y, f1u, f1v, bx, by, ox, py, pu,
                                           pv, n, nb, c0, radius, ds, nbs,
                                           luma_shift, H, W, ypitch, cpitch,
                                           part);
          }
          if (lg == 0) {  // window 1: the pixel's own first minimum
            if (in) {
              if (c0 == 0) best = part[0];
#pragma unroll
              for (int l = 0; l < kL; ++l) {
                const int g = c0 + l;  // a later chunk wins only on <
                if (g > 0 && g < radius && part[l] < best) {
                  best = part[l];
                  best_l = g;
                }
              }
            }
            continue;  // lg is the same in every thread of the block
          }
          // the chunk's live layers
          const int nl = min(kL, radius - c0);
          const int lgx = min(lg, kLogTX), lgy = min(lg, kLogTY);
          const int nlx = kTX >> lgx;
          const int nloc = nlx * (kTY >> lgy);
          for (int j = tid; j < nl * nloc; j += kThreads) s_sums[j] = 0;
          __syncthreads();
          const int seg = 1 << lgx;
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
          for (int j = tid; j < nl * nloc; j += kThreads) {
            const int l = j / nloc, k = j - l * nloc;
            const int gy = (y0 >> lg) + k / nlx, gx = (x0 >> lg) + k % nlx;
            if (gy < nwy && gx < nwx) {
              unsigned* dst = cur + (c0 + l) * wplane + (size_t)gy * nwx + gx;
              if (spans_tiles(lg))
                atomicAdd(dst, s_sums[j]);
              else
                __stcg(dst, s_sums[j]);
            }
          }
          __syncthreads();  // s_sums is reused by the next chunk or tile
        }
        if (lg == 0 && in) __stcg(cur + y * lw + x, (unsigned)best_l);
      }
    }
    grid.sync();
    stamp(timeline, 2 + 2 * s);

    // phase B: one thread per window of the tile takes its first minimum
    // (so a large window's sums are read once a tile, not once a pixel),
    // then every pixel commits its window's winner; zero the next sums
    // (chunked: a running first minimum over the chunks)
    if constexpr (!kChunked) {
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int x0 = (tile % ntx) << kLogTX, y0 = (tile / ntx) << kLogTY;
        const int x = x0 + tx, y = y0 + ty;
        const int lgx = min(lg, kLogTX), lgy = min(lg, kLogTY);
        const int nlx = kTX >> lgx;
        if (lg > 0) {
          if (tid < nlx * (kTY >> lgy)) {
            const int gy = (y0 >> lg) + tid / nlx, gx = (x0 >> lg) + tid % nlx;
            int best_l = 0;
            if (gy < nwy && gx < nwx) {
              const size_t wi = (size_t)gy * nwx + gx;
              unsigned v[kL];  // all loads in flight at once
#pragma unroll
              for (int l = 0; l < kL; ++l)
                v[l] = l < radius ? __ldcg(cur + l * wplane + wi) : 0u;
              unsigned best = v[0];
#pragma unroll
              for (int l = 1; l < kL; ++l)  // first minimum, unsigned
                if (l < radius && v[l] < best) {
                  best = v[l];
                  best_l = l;
                }
            }
            s_best[tid] = best_l;
          }
          __syncthreads();
        }
        if (x < lw && y < lh) {
          const int best_l =
              lg == 0 ? (int)__ldcg(cur + y * lw + x)
                      : s_best[(ty >> lgy) * nlx + (tx >> lgx)];
          const int i = y * lw + x;
          axis[i] = __ldcg(axis + i) + signed_square(best_l - half);
        }
        if (lg > 0) __syncthreads();  // s_best is reused by the next tile
      }
    } else {
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int x0 = (tile % ntx) << kLogTX, y0 = (tile / ntx) << kLogTY;
        const int x = x0 + tx, y = y0 + ty;
        const int lgx = min(lg, kLogTX), lgy = min(lg, kLogTY);
        const int nlx = kTX >> lgx;
        if (lg > 0) {
          if (tid < nlx * (kTY >> lgy)) {
            const int gy = (y0 >> lg) + tid / nlx, gx = (x0 >> lg) + tid % nlx;
            int best_l = 0;
            if (gy < nwy && gx < nwx) {
              const size_t wi = (size_t)gy * nwx + gx;
              unsigned best = 0;
              for (int c0 = 0; c0 < radius; c0 += kL) {
                unsigned v[kL];  // the chunk's loads in flight at once
#pragma unroll
                for (int l = 0; l < kL; ++l)
                  v[l] = c0 + l < radius ? __ldcg(cur + (c0 + l) * wplane + wi)
                                         : 0u;
                if (c0 == 0) best = v[0];
#pragma unroll
                for (int l = 0; l < kL; ++l) {  // first minimum, unsigned
                  const int g = c0 + l;  // a later chunk wins only on <
                  if (g > 0 && g < radius && v[l] < best) {
                    best = v[l];
                    best_l = g;
                  }
                }
              }
            }
            s_best[tid] = best_l;
          }
          __syncthreads();
        }
        if (x < lw && y < lh) {
          const int best_l =
              lg == 0 ? (int)__ldcg(cur + y * lw + x)
                      : s_best[(ty >> lgy) * nlx + (tx >> lgx)];
          const int i = y * lw + x;
          axis[i] = __ldcg(axis + i) + signed_square(best_l - half);
        }
        if (lg > 0) __syncthreads();  // s_best is reused by the next tile
      }
    }
    if (s + 1 < sched.n) {
      const int next = sched.code[s + 1] & 31;
      if (spans_tiles(next))
        zero(sums + ((s + 1) & 1) * sums_words,
             sums_of(next, radius, lh, lw));
    }
    if (s + 1 < sched.n || timeline != nullptr || blurred != nullptr)
      grid.sync();
    stamp(timeline, 3 + 2 * s);
  }

  // the blur phase: every tile's window reads the final field
  if (blurred != nullptr) {
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
      mfi::blur_tile(field, blurred, lh, lw, (tile % ntx) << kLogTX,
                     (tile / ntx) << kLogTY, s_sums, tid);
    if (timeline != nullptr) grid.sync();
    stamp(timeline, 2 + 2 * sched.n);
  }
}

// the instantiation serving `layers` (5, 8 or 16) at `radius`: the first
// chunk of layers that holds the radius, or 16-layer chunks above 16
template <typename T>
const void* pyramid_for(int layers, int radius) {
  if (radius > kChunk) return (const void*)pyramid_kernel<T, kChunk, true>;
  if (layers == 5) return (const void*)pyramid_kernel<T, 5, false>;
  if (layers == 8) return (const void*)pyramid_kernel<T, 8, false>;
  return (const void*)pyramid_kernel<T, kChunk, false>;
}

template <typename T>
int launch(const void* f1y, const void* f1u, const void* f1v, const void* y2,
           const void* u2, const void* v2, const void* in_x,
           const void* in_y, void* field, void* blurred, void* sums,
           size_t sums_words, const Schedule& sched, int layers, int radius,
           int ds, int nbs, int rs, int H, int W, int lh, int lw, int ypitch,
           int cpitch, int luma_shift, void* timeline, cudaStream_t s) {
  const void* kernel = pyramid_for<T>(layers, radius);
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
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // every block resident (the barriers need it), at most one per tile
  const int ntiles = ((lw + kTX - 1) / kTX) * ((lh + kTY - 1) / kTY);
  const int blocks = ntiles < per_sm * sms ? ntiles : per_sm * sms;
  const T* a1y = static_cast<const T*>(f1y);
  const T* a1u = static_cast<const T*>(f1u);
  const T* a1v = static_cast<const T*>(f1v);
  const T* a2y = static_cast<const T*>(y2);
  const T* a2u = static_cast<const T*>(u2);
  const T* a2v = static_cast<const T*>(v2);
  const int* ix = static_cast<const int*>(in_x);
  const int* iy = static_cast<const int*>(in_y);
  int* out = static_cast<int*>(field);
  int* blur = static_cast<int*>(blurred);
  unsigned* sm = static_cast<unsigned*>(sums);
  unsigned long long* tl = static_cast<unsigned long long*>(timeline);
  Schedule sc = sched;
  void* args[] = {&a1y, &a1u, &a1v, &a2y, &a2u, &a2v, &ix, &iy,
                  &out, &blur, &sm, &sums_words, &sc, &radius, &ds,
                  &nbs, &rs, &H, &W, &lh, &lw, &ypitch, &cpitch,
                  &luma_shift, &tl};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                  0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The layer slice: one pyramid step's window sums over the layers
// [z0, z0 + n) of radius `radius`, and per window their first unsigned
// minimum and the global layer that reaches it; no commit.  It replaces the
// XLA function mpv_frame_interpolator_tpu/parallel/sharding.py:60
// layer_slice_sums and the local argmin / min after it (:137-138): each rank
// of the layer-sharded flow runs its slice, and the ranks' (min, layer)
// pairs decide the winner (parallel/sharding.py).  The partials are those of
// layer_partials above (the same mirrors, biases and order of the shift and
// the delta scalar), so the sums are pyramid_kernel's phase A restricted to
// the slice.
//
// What bounds it: the same work as phase A for n of the radius' layers (a
// few MB touched, ~n x 4.4 M scalar operations at 4K); the design is the
// simple one, not phase A's: a 32 x 8 tile of pixels a block and a chunk of
// kSliceL layers a grid row, one layer at a time, each partial reduced over
// its window's span of the warp with shuffles, and one atomicAdd a
// (warp-row segment, layer) into sums zeroed by the entry; then one thread
// a window takes the minimum over the slice.  Sums wrap mod 2^32 in any
// order, so the result is exact.
constexpr int kSliceL = 16;

template <typename T, bool kIsY>
__global__ void __launch_bounds__(kThreads) slice_sums_kernel(
    const T* __restrict__ f1y, const T* __restrict__ f1u,
    const T* __restrict__ f1v, const T* __restrict__ y2,
    const T* __restrict__ u2, const T* __restrict__ v2,
    const int* __restrict__ fx, const int* __restrict__ fy,
    unsigned* __restrict__ sums, int z0, int n, int radius, int lg, int nb,
    int ds, int nbs, int rs, int H, int W, int lh, int lw, int ypitch,
    int cpitch, int luma_shift) {
  const int tid = threadIdx.x;
  const int tx = tid & (kTX - 1), ty = tid >> kLogTX;
  const int ntx = (lw + kTX - 1) >> kLogTX;
  const int x = ((blockIdx.x % ntx) << kLogTX) + tx;
  const int y = ((blockIdx.x / ntx) << kLogTY) + ty;
  const bool in = x < lw && y < lh;
  const int nwx = ((lw - 1) >> lg) + 1;
  const size_t wplane = (size_t)(((lh - 1) >> lg) + 1) * nwx;
  const int half = radius / 2;
  int own = 0, bx = 0, by = 0, py = 0, pu = 0, pv = 0;
  int nv[4] = {0, 0, 0, 0};
  const T* ry = f1y;
  const T* ru = f1u;
  const T* rv = f1v;
  if (in) {
    const int i = y * lw + x;
    const int* axis = kIsY ? fy : fx;
    own = axis[i];
    if (nb) {  // the neighbour bias at +-2*window, clamped
      const int w2 = 2 * min(1 << lg, 1 << 29);
      nv[0] = axis[y * lw + min(x + w2, lw - 1)];
      nv[1] = axis[y * lw + max(x - w2, 0)];
      nv[2] = axis[min(y + w2, lh - 1) * lw + x];
      nv[3] = axis[max(y - w2, 0) * lw + x];
    }
    bx = (x << rs) + fx[i];
    by = (y << rs) + fy[i];
    py = y2[i];
    pu = u2[i];
    pv = v2[i];
    // the axis not stepped gives a fixed row (x step) or column (y step)
    const int fixed = kIsY ? mirror_inside(bx, W) : mirror_inside(by, H);
    ry += kIsY ? fixed : (size_t)fixed * ypitch;
    ru += kIsY ? (fixed >> 1) : (size_t)(fixed >> 1) * cpitch;
    rv += kIsY ? (fixed >> 1) : (size_t)(fixed >> 1) * cpitch;
  }
  const int seg = 1 << min(lg, kLogTX);
  const int l0 = blockIdx.y * kSliceL;
  const int l1 = min(l0 + kSliceL, n);
  for (int l = l0; l < l1; ++l) {
    unsigned p = 0u;
    if (in) {
      const int adj = signed_square(z0 + l - half);
      const int probe = own + adj;
      const int c = kIsY ? mirror_inside(by + adj, H)
                         : mirror_inside(bx + adj, W);
      const size_t oy = kIsY ? (size_t)c * ypitch : c;
      const size_t oc = kIsY ? (size_t)(c >> 1) * cpitch : (c >> 1);
      const unsigned sad =
          __sad((int)ry[oy], py, __sad((int)ru[oc], pu,
                                       __sad((int)rv[oc], pv, 0u)));
      p = ((sad >> luma_shift) << ds) + (unsigned)abs(probe);
      if (nb)
        p += __sad(nv[0], probe, __sad(nv[1], probe, __sad(nv[2], probe,
                   __sad(nv[3], probe, 0u)))) << nbs;
    }
    unsigned* plane = sums + (size_t)l * wplane;
    if (lg == 0) {  // window 1: the pixel's own sum
      if (in) plane[(size_t)y * lw + x] = p;
      continue;
    }
    for (int off = seg >> 1; off > 0; off >>= 1)
      p += __shfl_down_sync(0xffffffffu, p, off);
    if (in && (tx & (seg - 1)) == 0)
      atomicAdd(plane + (size_t)(y >> lg) * nwx + (x >> lg), p);
  }
}

// per window: the first unsigned minimum over the slice's n layers and the
// global layer z0 + l that reaches it
__global__ void slice_min_kernel(const unsigned* __restrict__ sums,
                                 unsigned* __restrict__ out_min,
                                 int* __restrict__ out_arg, int n, int z0,
                                 int wplane) {
  const int wi = blockIdx.x * blockDim.x + threadIdx.x;
  if (wi >= wplane) return;
  unsigned best = sums[wi];
  int best_l = 0;
  for (int l = 1; l < n; ++l) {
    const unsigned v = sums[(size_t)l * wplane + wi];
    if (v < best) {
      best = v;
      best_l = l;
    }
  }
  out_min[wi] = best;
  out_arg[wi] = z0 + best_l;
}

template <typename T>
int launch_slice(const void* f1y, const void* f1u, const void* f1v,
                 const void* y2, const void* u2, const void* v2,
                 const void* fx, const void* fy, void* sums, void* out_min,
                 void* out_arg, int z0, int n, int radius, int lg, int is_y,
                 int nb, int ds, int nbs, int rs, int H, int W, int lh,
                 int lw, int ypitch, int cpitch, int luma_shift,
                 cudaStream_t s) {
  const size_t wplane = (size_t)(((lh - 1) >> lg) + 1) * (((lw - 1) >> lg) + 1);
  cudaError_t e = cudaSuccess;
  if (lg > 0)  // window sums take atomics from zero
    e = cudaMemsetAsync(sums, 0, (size_t)n * wplane * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = ((lw + kTX - 1) / kTX) * ((lh + kTY - 1) / kTY);
  const dim3 grid(ntiles, (n + kSliceL - 1) / kSliceL);
  const T* a1y = static_cast<const T*>(f1y);
  const T* a1u = static_cast<const T*>(f1u);
  const T* a1v = static_cast<const T*>(f1v);
  const T* a2y = static_cast<const T*>(y2);
  const T* a2u = static_cast<const T*>(u2);
  const T* a2v = static_cast<const T*>(v2);
  const int* ix = static_cast<const int*>(fx);
  const int* iy = static_cast<const int*>(fy);
  unsigned* sm = static_cast<unsigned*>(sums);
  if (is_y)
    slice_sums_kernel<T, true><<<grid, kThreads, 0, s>>>(
        a1y, a1u, a1v, a2y, a2u, a2v, ix, iy, sm, z0, n, radius, lg, nb, ds,
        nbs, rs, H, W, lh, lw, ypitch, cpitch, luma_shift);
  else
    slice_sums_kernel<T, false><<<grid, kThreads, 0, s>>>(
        a1y, a1u, a1v, a2y, a2u, a2v, ix, iy, sm, z0, n, radius, lg, nb, ds,
        nbs, rs, H, W, lh, lw, ypitch, cpitch, luma_shift);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  slice_min_kernel<<<(unsigned)((wplane + 255) / 256), 256, 0, s>>>(
      sm, static_cast<unsigned*>(out_min), static_cast<int*>(out_arg), n, z0,
      (int)wplane);
  return (int)cudaGetLastError();
}

// layers 5, 8 or 16 (the instantiation) and radius in [1, layers], or
// layers 16 and radius in [17, 256] (chunks of 16 layers)
bool valid_layers(int layers, int radius) {
  if (layers != 5 && layers != 8 && layers != kChunk) return false;
  return radius >= 1 &&
         (radius <= layers || (layers == kChunk && radius <= kMaxRadius));
}

}  // namespace

// field: (2, lh, lw) int32 out, plane 0 the x offsets and plane 1 the y
// offsets, started from (in_x, in_y) or from zero when both are null;
// blurred: null, or (2, lh, lw) int32 out that receives the final field's
// 8x8 blur (not overlapping field);
// sums: two buffers of sums_words uint32 each (the wrapper sizes them:
// radius x windows for the largest step, lh x lw for a window-1 step);
// steps: n_steps host ints, log2(window) | is_y << 8 | nb_enabled << 9.
// layers: the instantiation's layers a chunk, 5, 8 or 16 (valid_layers);
// radius 1..256.
// sample_bytes: 1 (uint8 planes) or 2 (uint16); pitches in samples.
// timeline: null, or 2 + 2 n_steps uint64 (3 + 2 n_steps with blurred)
// that receive %globaltimer (ns) at the start, after the prologue, after
// each phase of each step and after the blur phase.
extern "C" int mfi_flow_pyramid(
    const void* f1y, const void* f1u, const void* f1v, const void* y2,
    const void* u2, const void* v2, const void* in_x, const void* in_y,
    void* field, void* blurred, void* sums, const int* steps, int n_steps,
    int sums_words, int layers, int radius, int ds, int nbs, int rs, int H,
    int W, int lh, int lw, int ypitch, int cpitch, int sample_bytes,
    int luma_shift, void* timeline, void* stream) {
  if (n_steps < 0 || n_steps > kMaxSteps || !valid_layers(layers, radius) ||
      (in_x == nullptr) != (in_y == nullptr))
    return (int)cudaErrorInvalidValue;
  Schedule sched;
  sched.n = n_steps;
  for (int i = 0; i < n_steps; ++i) sched.code[i] = steps[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sample_bytes == 2)
    return launch<uint16_t>(f1y, f1u, f1v, y2, u2, v2, in_x, in_y, field,
                            blurred, sums, (size_t)sums_words, sched, layers,
                            radius, ds, nbs, rs, H, W, lh, lw, ypitch,
                            cpitch, luma_shift, timeline, s);
  return launch<uint8_t>(f1y, f1u, f1v, y2, u2, v2, in_x, in_y, field,
                         blurred, sums, (size_t)sums_words, sched, layers,
                         radius, ds, nbs, rs, H, W, lh, lw, ypitch, cpitch,
                         luma_shift, timeline, s);
}

// *per_sm: the resident blocks an SM of the pyramid kernel that serves
// (layers, radius), as its cooperative launch sizes the grid (sample_bytes
// 1 or 2).
extern "C" int mfi_flow_pyramid_occupancy(int sample_bytes, int layers,
                                          int radius, int* per_sm) {
  if (!valid_layers(layers, radius)) return (int)cudaErrorInvalidValue;
  const void* kernel = sample_bytes == 2
                           ? pyramid_for<uint16_t>(layers, radius)
                           : pyramid_for<uint8_t>(layers, radius);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                            kThreads, 0);
}

// The layer slice of one step on axis is_y: layers [z0, z0 + n) of radius
// (1 <= n, z0 + n <= radius <= 256), window 2^lg, the neighbour bias when
// nb; fx, fy: the committed (lh, lw) int32 field, read only; sums: n x
// windows uint32 scratch; out_min (uint32) and out_arg (int32): one word a
// window, (ceil(lh / 2^lg), ceil(lw / 2^lg)).  Planes and pitches as for
// mfi_flow_pyramid.
extern "C" int mfi_flow_layer_slice(
    const void* f1y, const void* f1u, const void* f1v, const void* y2,
    const void* u2, const void* v2, const void* fx, const void* fy,
    void* sums, void* out_min, void* out_arg, int z0, int n, int radius,
    int lg, int is_y, int nb, int ds, int nbs, int rs, int H, int W, int lh,
    int lw, int ypitch, int cpitch, int sample_bytes, int luma_shift,
    void* stream) {
  if (n < 1 || z0 < 0 || z0 + n > radius || radius > kMaxRadius || lg < 0 ||
      lg > 30)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sample_bytes == 2)
    return launch_slice<uint16_t>(f1y, f1u, f1v, y2, u2, v2, fx, fy, sums,
                                  out_min, out_arg, z0, n, radius, lg, is_y,
                                  nb, ds, nbs, rs, H, W, lh, lw, ypitch,
                                  cpitch, luma_shift, s);
  return launch_slice<uint8_t>(f1y, f1u, f1v, y2, u2, v2, fx, fy, sums,
                               out_min, out_arg, z0, n, radius, lg, is_y, nb,
                               ds, nbs, rs, H, W, lh, lw, ypitch, cpitch,
                               luma_shift, s);
}
