// 8x8 box blur of the flow field, for Hopper (sm_90a).
//
// Replaces the TPU kernel mpv_frame_interpolator_tpu/ops/pallas/blur.py:
// blur_flow_pallas (and its bit-identical XLA twin ops/flow.blur_flow),
// i.e. the reference's blurFlowKernel.cl: taps [-4, 3] on each axis,
// symmetric edges (index -1 reads 0, index n reads n-1, reflecting again
// when the plane is smaller than the tap reach, as numpy's "symmetric"
// pad does), an int32 sum that wraps like the reference's, and a division
// by 64 truncated toward zero.
//
// What bounds it: the field is (2, 270, 480) int32 at 4K, 1 MB in and
// 1 MB out, and each output reads 64 inputs that all sit in L1/L2 -- the
// kernel is a few microseconds of launch latency.  The design is the
// simplest that is right: one thread per output element, 64 taps, the
// mirrored index computed per tap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 4;  // blurFlowKernel.cl KERNEL_RADIUS

// periodic reflection with period 2n: numpy's "symmetric" padding
__device__ __forceinline__ int symmetric(int i, int n) {
  const int p = 2 * n;
  int j = i % p;
  if (j < 0) j += p;
  return j >= n ? p - 1 - j : j;
}

__global__ void blur_kernel(const int* __restrict__ in, int* __restrict__ out,
                            int lh, int lw) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= lw || y >= lh) return;
  const int* p = in + (size_t)blockIdx.z * lh * lw;
  unsigned acc = 0;  // wraps mod 2^32 like the reference's int sum
  for (int ky = -kR; ky < kR; ++ky) {
    const int* row = p + (size_t)symmetric(y + ky, lh) * lw;
    for (int kx = -kR; kx < kR; ++kx) acc += (unsigned)row[symmetric(x + kx, lw)];
  }
  out[((size_t)blockIdx.z * lh + y) * lw + x] = (int)acc / 64;
}

}  // namespace

extern "C" int mfi_blur_flow(const void* in, void* out, int planes, int lh,
                             int lw, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((lw + 31) / 32, (lh + 7) / 8, planes);
  blur_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(in), static_cast<int*>(out), lh, lw);
  return (int)cudaGetLastError();
}
