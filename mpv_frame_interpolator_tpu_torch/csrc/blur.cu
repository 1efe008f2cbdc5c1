// K3: the 8x8 box blur of the flow field, standalone, for Hopper (sm_90a).
//
// Replaces the TPU kernel mpv_frame_interpolator_tpu/ops/pallas/blur.py:
// blur_flow_pallas (and its bit-identical XLA twin ops/flow.blur_flow),
// i.e. the reference's blurFlowKernel.cl: taps [-4, 3] on each axis,
// symmetric edges, an int32 sum that wraps like the reference's, and a
// division by 64 truncated toward zero (blur_tile.cuh).
//
// What bounds it: the field is (2, 270, 480) int32 at 4K, 1 MB in and
// 1 MB out, ~0.6 us of bytes at 3.35 TB/s; a launch of its own costs more
// than that.  So the engine's path blurs inside K1's launch, as the last
// phase after the pyramid's last barrier (flow_step.cu); this kernel is
// the same tile body at one block a 32 x 8 tile, behind the port's public
// ops/flow.blur_flow.  The body loads each tile's window once, reflects
// only in edge tiles, and sums along rows and then columns in shared
// memory, where the first port took 64 loads and 72 integer % an output.

#include "blur_tile.cuh"

namespace {

__global__ void __launch_bounds__(mfi::kBlurThreads) blur_kernel(
    const int* __restrict__ in, int* __restrict__ out, int lh, int lw) {
  __shared__ unsigned win[mfi::kBlurWindowWords];
  const int ntx = (lw + mfi::kBlurTX - 1) / mfi::kBlurTX;
  const int x0 = (blockIdx.x % ntx) * mfi::kBlurTX;
  const int y0 = (blockIdx.x / ntx) * mfi::kBlurTY;
  mfi::blur_tile(in, out, lh, lw, x0, y0, win, threadIdx.x);
}

}  // namespace

// in, out: (2, lh, lw) int32 on the device, not overlapping.
extern "C" int mfi_blur_flow(const void* in, void* out, int lh, int lw,
                             void* stream) {
  if (lh < 1 || lw < 1) return (int)cudaErrorInvalidValue;
  const int tiles = ((lw + mfi::kBlurTX - 1) / mfi::kBlurTX) *
                    ((lh + mfi::kBlurTY - 1) / mfi::kBlurTY);
  blur_kernel<<<tiles, mfi::kBlurThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(in), static_cast<int*>(out), lh, lw);
  return (int)cudaGetLastError();
}
