// One pyramid step of the block-matching flow search, for Hopper (sm_90a).
//
// Replaces the TPU kernel mpv_frame_interpolator_tpu/ops/pallas/
// flow_step.py:flow_step_pallas (with its XLA tail flow_step_commit); the
// semantics are those of the JAX step branch ops/flow._make_step_branch,
// i.e. of the reference's calcDeltaSumsKernel.cl +
// determineLowestLayerKernel.cl + adjustOffsetArrayKernel.cl.
//
// For each layer l < radius the candidate offset on the stepped axis is
// adj = signed_square(l - radius/2).  Per low-res pixel c:
//   sad     = |y1 - y2| + |u1 - u2| + |v1 - v2|, f1 read at
//             mirror_inside((c << rs) + offset + adj), f2 the probe
//   partial = (sad << ds) + |probe| + (neighbour bias << nbs)   (uint32)
// summed over window x window blocks mod 2^32; the first minimum over the
// layers in unsigned order wins and its signed square is committed to the
// stepped axis of every pixel of the block.
//
// What bounds it: at 4K the low-res field is 270 x 480 and a step has
// radius x 129,600 candidates, each three byte gathers at mirrored
// coordinates (mostly coherent: neighbouring pixels share their offset)
// plus a 32-bit add into a window sum.  That is a few MB of traffic per
// step, so the step is bound by launch latency and by the atomics of the
// window sums, not by bandwidth or arithmetic.  The design: one thread per
// (layer, pixel); each warp covers 32 consecutive pixels of one row and
// pre-reduces its partials per window with shuffles (windows are powers of
// two, so a window never straddles a warp unevenly), so only one atomicAdd
// per window and warp reaches memory.  Unsigned addition mod 2^32 is
// order-independent, so the atomics are bit-exact.  A second launch takes
// each pixel's window argmin (radius reads of an L2-resident array) and
// writes the committed axis.
//
// None of the TPU kernel's machinery is needed here: no phase stacks, no
// distinct-offset budget, no `valid` flag and fallback -- f1 is read at
// the mirrored coordinates directly, as the reference's OpenCL did.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;  // one warp per row segment
constexpr int kBY = 8;

__device__ __forceinline__ int mirror_inside(int pos, int dim) {
  if (pos >= dim) pos = dim - (pos - dim + 1);
  if (pos < 0) pos = -pos - 1;
  return min(max(pos, 0), dim - 1);
}

__device__ __forceinline__ int signed_square(int v) {
  return v > 0 ? v * v : -(v * v);
}

__global__ void delta_sums_kernel(
    const uint8_t* __restrict__ f1y, const uint8_t* __restrict__ f1u,
    const uint8_t* __restrict__ f1v, const uint8_t* __restrict__ y2,
    const uint8_t* __restrict__ u2, const uint8_t* __restrict__ v2,
    const int* __restrict__ off_x, const int* __restrict__ off_y,
    unsigned* __restrict__ sums, int is_y, int radius, int ds, int nbs,
    int window, int nb_enabled, int rs, int H, int W, int lh, int lw,
    int ypitch, int cpitch, int nwy, int nwx) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const int l = blockIdx.z;
  const bool in = x < lw && y < lh;
  unsigned partial = 0;
  if (in) {
    const int adj = signed_square(l - radius / 2);
    const int i = y * lw + x;
    const int cand_x = off_x[i] + (is_y ? 0 : adj);
    const int cand_y = off_y[i] + (is_y ? adj : 0);
    const int probe = is_y ? cand_y : cand_x;
    const int ncx = mirror_inside((x << rs) + cand_x, W);
    const int ncy = mirror_inside((y << rs) + cand_y, H);
    const size_t ci = (size_t)(ncy >> 1) * cpitch + (ncx >> 1);
    const int sad = abs((int)f1y[(size_t)ncy * ypitch + ncx] - (int)y2[i]) +
                    abs((int)f1u[ci] - (int)u2[i]) +
                    abs((int)f1v[ci] - (int)v2[i]);
    partial = ((unsigned)sad << ds) + (unsigned)abs(probe);
    if (nb_enabled) {
      // neighbour bias at +-2*window, clamped to the field
      const int* prev = is_y ? off_y : off_x;
      const int w2 = 2 * window;
      unsigned nb = (unsigned)abs(prev[y * lw + min(x + w2, lw - 1)] - probe);
      nb += (unsigned)abs(prev[y * lw + max(x - w2, 0)] - probe);
      nb += (unsigned)abs(prev[min(y + w2, lh - 1) * lw + x] - probe);
      nb += (unsigned)abs(prev[max(y - w2, 0) * lw + x] - probe);
      partial += nb << nbs;
    }
  }
  const size_t plane = (size_t)nwy * nwx;
  if (window == 1) {
    if (in) sums[l * plane + (size_t)y * nwx + x] = partial;
    return;
  }
  // segmented warp sum: lane k*seg ends up holding its segment's sum
  const int seg = window < kBX ? window : kBX;
  for (int off = seg >> 1; off > 0; off >>= 1)
    partial += __shfl_down_sync(0xffffffffu, partial, off);
  if (in && (threadIdx.x & (seg - 1)) == 0)
    atomicAdd(&sums[l * plane + (size_t)(y / window) * nwx + x / window],
              partial);
}

__global__ void commit_kernel(const unsigned* __restrict__ sums,
                              const int* __restrict__ plane_in,
                              int* __restrict__ plane_out, int radius,
                              int window, int lh, int lw, int nwy, int nwx) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= lw || y >= lh) return;
  const size_t plane = (size_t)nwy * nwx;
  const size_t wi = (size_t)(y / window) * nwx + x / window;
  unsigned best = sums[wi];
  int best_l = 0;
  for (int l = 1; l < radius; ++l) {  // first minimum, unsigned order
    const unsigned s = sums[l * plane + wi];
    if (s < best) {
      best = s;
      best_l = l;
    }
  }
  const int i = y * lw + x;
  plane_out[i] = plane_in[i] + signed_square(best_l - radius / 2);
}

}  // namespace

// sums: (radius, nwy, nwx) uint32 scratch; out: the stepped axis' new plane.
extern "C" int mfi_flow_step(const void* f1y, const void* f1u, const void* f1v,
                             const void* y2, const void* u2, const void* v2,
                             const void* off_x, const void* off_y, void* out,
                             void* sums, int is_y, int radius, int ds, int nbs,
                             int window, int nb_enabled, int rs, int H, int W,
                             int lh, int lw, int ypitch, int cpitch,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nwy = (lh + window - 1) / window;
  const int nwx = (lw + window - 1) / window;
  if (window > 1) {
    cudaError_t e = cudaMemsetAsync(
        sums, 0, sizeof(unsigned) * (size_t)radius * nwy * nwx, s);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 block(kBX, kBY);
  const dim3 grid((lw + kBX - 1) / kBX, (lh + kBY - 1) / kBY, radius);
  delta_sums_kernel<<<grid, block, 0, s>>>(
      static_cast<const uint8_t*>(f1y), static_cast<const uint8_t*>(f1u),
      static_cast<const uint8_t*>(f1v), static_cast<const uint8_t*>(y2),
      static_cast<const uint8_t*>(u2), static_cast<const uint8_t*>(v2),
      static_cast<const int*>(off_x), static_cast<const int*>(off_y),
      static_cast<unsigned*>(sums), is_y, radius, ds, nbs, window,
      nb_enabled, rs, H, W, lh, lw, ypitch, cpitch, nwy, nwx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid2((lw + kBX - 1) / kBX, (lh + kBY - 1) / kBY);
  commit_kernel<<<grid2, block, 0, s>>>(
      static_cast<const unsigned*>(sums),
      static_cast<const int*>(is_y ? off_y : off_x), static_cast<int*>(out),
      radius, window, lh, lw, nwy, nwx);
  return (int)cudaGetLastError();
}
