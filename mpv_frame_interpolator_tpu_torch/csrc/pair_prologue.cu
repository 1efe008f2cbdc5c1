// C1: the pair's prologue -- the scene-cut score, the cut, the folded blend
// positions and the f2 probe -- in one cooperative launch, for Hopper
// (sm_90a).
//
// Not a TPU kernel: it replaces the XLA code of the JAX source step
// (pipeline/engine.py:683 _make_source_step) around the flow, which the
// port ran as ~18 tensor ops a pair:
//   * the cut score, pipeline/scene.py:19 cut_score: the sum over the
//     stride-2^rs grid of two (H, stride) luma planes of |y1 - y2| >>
//     bit_shift (8 under P010), exact in 64-bit integers, rounded to float32
//     (__ll2float_rn) and multiplied by the float32 reciprocal of the grid's
//     element count (__frcp_rn, __fmul_rn): XLA compiles the JAX package's
//     float32 mean into that multiply, which can differ from a true
//     division (__fdiv_rn) in the last bit, and the plain version does the
//     same;
//   * the cut, score > threshold compared in float32 (the caller rounds the
//     threshold to float32, as a Python float against a float32 tensor
//     does in both packages), written as an int32 flag and added to the
//     engine's count of cuts; K1's blur phase reads the flag and zeroes the
//     blurred field (flow_step.cu), the masked_fill of JAX engine.py:543;
//   * the folded blend positions (JAX engine.py:538-554), into a new (N,)
//     float32 tensor -- the engine caches its unfolded positions and hands
//     the same tensor to later pairs, so they are never folded in place:
//     under a cut "nearest" gives t >= 0.5 ? 1 : 0 and "hold" 0, then model
//     "repeat" gives t >= 0.5 ? 1 : 0 at every position;
//   * the probe of ops/flow.subsampled_f2 (JAX ops/flow._subsampled_f2),
//     the three (lh, lw) planes K1 reads: y2[cy, cx] = f2y[cy << rs, cx <<
//     rs] and u2/v2[cy, cx] = f2u/v[(cy << rs) >> 1, (cx << rs) >> 1],
//     which covers rs == 0.
// The score's grid is ceil(H / 2^rs) x ceil(stride / 2^rs) of the planes
// as given (their padding columns count, as in y1[::s, ::s]); the probe's
// is the geometry's lh x lw and is written only there.
//
// What bounds it: bytes, and far below a launch.  At 4K (rs = 3) the grids
// are 270 x 480: the function reads 0.5 MB of samples and writes 0.4 MB of
// probe, ~0.3 us at 3.35 TB/s (the kernel moves more: a strided sample
// costs its 32-byte sector, ~3.5 MB).  So the design is the simplest that
// fills the card: one thread a low-res cell in a grid-stride loop, at most
// two blocks an SM.
//
// The reduction across blocks keeps no state between launches: the pair
// body is captured into CUDA graphs and replayed, and several engines run
// their pair bodies on several streams at once, so there is no static
// accumulator and no "last block" ticket that a later launch would have to
// reset.  The launch is cooperative (every block resident): each block
// writes its partial sum to the caller's scratch (torch.empty), a grid
// barrier follows, and block 0 sums the partials in a fixed order.  The
// sums are of unsigned 64-bit integers, exact in any order, so the score
// does not depend on which block ran first or on the grid's size.
//
// With scene detection off there is no score and no barrier: the flag is
// 0 and block 0 folds the positions at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the length of the partials' scratch (ops/cuda/prologue.py MAX_BLOCKS)
constexpr int kMaxBlocks = 1024;
constexpr int kBlocksPerSm = 2;

// what the pair folds: scene detection, the cut policy and model "repeat"
struct Fold {
  int scene;
  int nearest;
  int repeat;
  float threshold;
};

// The sum of one value a thread over the block, in thread 0.  Every thread
// of the block calls it; it begins with a barrier, so that the block may
// call it again at once.
__device__ __forceinline__ unsigned long long block_sum(
    unsigned long long v, unsigned long long* s_warp) {
  __syncthreads();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__device__ __forceinline__ float snap(float t) {
  return t >= 0.5f ? 1.0f : 0.0f;
}

// y1, y2: the two luma planes, rows x cols samples at pitch ypitch; f2u,
// f2v: f2's planar chroma at pitch cpitch; py, pu, pv: the (lh, lw) probe,
// null when the family searches no flow.
template <typename T>
__global__ void __launch_bounds__(kThreads) pair_prologue_kernel(
    const T* __restrict__ y1, const T* __restrict__ y2, int rows, int cols,
    int ypitch, const T* __restrict__ f2u, const T* __restrict__ f2v,
    int cpitch, T* __restrict__ py, T* __restrict__ pu, T* __restrict__ pv,
    int lh, int lw, int rs, int bit_shift, const float* __restrict__ ts_in,
    float* __restrict__ ts_out, int n, float* score, int* cut, int* cuts,
    unsigned long long* partials, Fold fold) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ int s_cut;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;

  if (py != nullptr) {
    const int cells = lh * lw;
    for (int i = first; i < cells; i += stride) {
      const int cy = i / lw, cx = i - cy * lw;
      const int y = cy << rs, x = cx << rs;
      py[i] = y2[(size_t)y * ypitch + x];
      const size_t c = (size_t)(y >> 1) * cpitch + (x >> 1);
      pu[i] = f2u[c];
      pv[i] = f2v[c];
    }
  }

  const int sh = ((rows - 1) >> rs) + 1, sw = ((cols - 1) >> rs) + 1;
  if (fold.scene) {
    unsigned long long acc = 0;
#pragma unroll 4
    for (int i = first; i < sh * sw; i += stride) {
      const int r = i / sw, c = i - r * sw;
      const size_t at = ((size_t)r << rs) * ypitch + ((size_t)c << rs);
      acc += (unsigned)(abs((int)y1[at] - (int)y2[at]) >> bit_shift);
    }
    acc = block_sum(acc, s_warp);
    if (threadIdx.x == 0) partials[blockIdx.x] = acc;
    grid.sync();
  }
  if (blockIdx.x != 0) return;

  if (fold.scene) {
    // block 0 sums the partials, thread k taking blocks k, k + 256, ...,
    // then the warps in order: a fixed order, and exact in any order
    unsigned long long acc = 0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads)
      acc += __ldcg(partials + b);
    acc = block_sum(acc, s_warp);
    if (threadIdx.x == 0) {
      const float s = __fmul_rn(__ll2float_rn((long long)acc),
                                __frcp_rn(__int2float_rn(sh * sw)));
      const int c = s > fold.threshold;
      *score = s;
      *cut = c;
      if (c) atomicAdd(cuts, 1);
      s_cut = c;
    }
  } else if (threadIdx.x == 0) {
    *cut = 0;
    s_cut = 0;
  }
  __syncthreads();
  const int c = s_cut;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float t = ts_in[i];
    if (c) t = fold.nearest ? snap(t) : 0.0f;
    if (fold.repeat) t = snap(t);
    ts_out[i] = t;
  }
}

// The blocks a launch of pair_prologue_kernel<T> may use on the current
// device: kBlocksPerSm an SM, or fewer where fewer are resident.  Each host
// thread asks the runtime once a device and keeps the answer (host state
// only, which a launch neither reads on the card nor changes).
template <typename T>
cudaError_t resident_blocks(int* most) {
  static thread_local int seen_dev = -1, seen_most = 0;
  int dev, sms, per_sm, coop;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev == seen_dev) {
    *most = seen_most;
    return e;
  }
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pair_prologue_kernel<T>, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  seen_most = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
  seen_dev = dev;
  *most = seen_most;
  return cudaSuccess;
}

template <typename T>
int launch(const void* y1, const void* y2, int rows, int cols, int ypitch,
           const void* f2u, const void* f2v, int cpitch, void* py, void* pu,
           void* pv, int lh, int lw, int rs, int bit_shift, const void* ts_in,
           void* ts_out, int n, void* score, void* cut, void* cuts,
           void* partials, Fold fold, cudaStream_t s) {
  const void* kernel = (const void*)pair_prologue_kernel<T>;
  int most;
  cudaError_t e = resident_blocks<T>(&most);
  if (e != cudaSuccess) return (int)e;
  // enough blocks for one cell a thread, at most two an SM (and what can
  // be resident), at most kMaxBlocks
  const int sh = ((rows - 1) >> rs) + 1, sw = ((cols - 1) >> rs) + 1;
  int cells = py != nullptr && lh * lw > 0 ? lh * lw : 1;
  if (fold.scene && sh * sw > cells) cells = sh * sw;
  int blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > most) blocks = most;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* a1 = static_cast<const T*>(y1);
  const T* a2 = static_cast<const T*>(y2);
  const T* u = static_cast<const T*>(f2u);
  const T* v = static_cast<const T*>(f2v);
  T* oy = static_cast<T*>(py);
  T* ou = static_cast<T*>(pu);
  T* ov = static_cast<T*>(pv);
  const float* ti = static_cast<const float*>(ts_in);
  float* to = static_cast<float*>(ts_out);
  float* sc = static_cast<float*>(score);
  int* ct = static_cast<int*>(cut);
  int* cs = static_cast<int*>(cuts);
  unsigned long long* pa = static_cast<unsigned long long*>(partials);
  void* args[] = {&a1, &a2, &rows, &cols, &ypitch, &u, &v, &cpitch,
                  &oy, &ou, &ov, &lh, &lw, &rs, &bit_shift, &ti, &to, &n,
                  &sc, &ct, &cs, &pa, &fold};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args,
                                  0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// y1, y2: the pair's luma planes, (rows, cols) samples at pitch ypitch;
// f2u, f2v: f2's planar chroma at pitch cpitch; py, pu, pv: null (no
// probe), or (lh, lw) outputs with (lh - 1) << rs < rows and (lw - 1) <<
// rs < cols; ts_in, ts_out: n floats, not overlapping; score: one float
// out (null without scene detection); cut: one int32 out; cuts: the int32
// count of cuts, added to; partials: kMaxBlocks uint64 scratch; sample_bytes
// 1 (uint8) or 2 (uint16); scene, nearest, repeat: 0 or 1; threshold the
// float32 threshold.
extern "C" int mfi_pair_prologue(
    const void* y1, const void* y2, const void* f2u, const void* f2v,
    const void* ts_in, void* ts_out, void* py, void* pu, void* pv,
    void* score, void* cut, void* cuts, void* partials, int n, int rows,
    int cols, int ypitch, int cpitch, int rs, int lh, int lw,
    int sample_bytes, int bit_shift, int scene, int nearest, int repeat,
    float threshold, void* stream) {
  const bool probe = py != nullptr;
  if (rows < 1 || cols < 1 || ypitch < cols || n < 0 || rs < 0 || rs > 30 ||
      bit_shift < 0 || bit_shift > 15 ||
      (sample_bytes != 1 && sample_bytes != 2) ||
      (scene && score == nullptr) || cut == nullptr || cuts == nullptr ||
      partials == nullptr ||
      (probe && (pu == nullptr || pv == nullptr || lh < 1 || lw < 1 ||
                 (size_t)(lh - 1) << rs >= (size_t)rows ||
                 (size_t)(lw - 1) << rs >= (size_t)cols)))
    return (int)cudaErrorInvalidValue;
  Fold fold{scene != 0, nearest != 0, repeat != 0, threshold};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = sample_bytes == 2 ? &launch<uint16_t> : &launch<uint8_t>;
  return go(y1, y2, rows, cols, ypitch, f2u, f2v, cpitch, py, pu, pv, lh, lw,
            rs, bit_shift, ts_in, ts_out, n, score, cut, cuts, partials, fold,
            s);
}
