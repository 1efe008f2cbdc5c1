// P1: probes of the packed-byte primitives a redesigned warp kernel would
// use on Hopper (sm_90a).
//
// Replaces the TPU probe tools/pallas_pack_probe.py:run_kernel, which asks
// whether Mosaic packs four uint8 ROWS into one int32 word of a (8, 128)
// tile and whether shifts and selects work in that packed domain.  On the
// card the packing is the memory's: a row-major uint8 plane read as uint32
// packs four consecutive COLUMNS, little-endian, and 16-byte vector access
// moves sixteen of them.  The probes, each held bit-exact against its
// plain version by mpv_frame_interpolator_tpu_torch/tools/pack_probe.py:
//
//   b32      uint8 plane read as uint32 words (the packing itself);
//   vec16    16-byte (uint4) loads and stores of uint8 rows: at a column
//            offset that is a multiple of 16 one aligned load per 16
//            outputs; at another offset two aligned loads, the row
//            assembled with __byte_perm or with __funnelshift_r;
//   bytesel  the packed select where(idx == 1, val, acc), four bytes a
//            word, with __vcmpeq4 or with the carry-free zero-byte trick
//            of the TPU probe;
//   rep8     a x8 nearest upsample of a (16, 32) tile through shared
//            memory.
//
// What bounds them: bytes (each moves a few hundred KB at most); they are
// probes of mechanism, not of speed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void b32_kernel(const uint32_t* __restrict__ in,
                           uint32_t* __restrict__ out, int n_words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n_words) out[i] = in[i];
}

// out (R, C - 16): out[r, c] = in[r, c + shift], 16 outputs a thread
__global__ void vec16_kernel(const uint8_t* __restrict__ in,
                             uint8_t* __restrict__ out, int R, int C,
                             int shift, int method) {
  const int chunks = (C - 16) / 16;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * chunks) return;
  const int r = i / chunks;
  const int c0 = (i - r * chunks) * 16;
  const uint8_t* row = in + (size_t)r * C;
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)r * (C - 16) + c0);
  if (method == 0) {  // the offset is a multiple of 16: one aligned load
    *dst = *reinterpret_cast<const uint4*>(row + c0 + shift);
    return;
  }
  const int a = c0 + (shift & ~15);
  const int o = shift & 15;
  const uint4 A = *reinterpret_cast<const uint4*>(row + a);
  const uint4 B = o ? *reinterpret_cast<const uint4*>(row + a + 16) : A;
  const uint32_t w[8] = {A.x, A.y, A.z, A.w, B.x, B.y, B.z, B.w};
  const int q = o >> 2;
  const int rb = o & 3;
  uint32_t res[4];
  if (method == 1) {
    const uint32_t sel = rb | (rb + 1) << 4 | (rb + 2) << 8 | (rb + 3) << 12;
#pragma unroll
    for (int k = 0; k < 4; ++k) res[k] = __byte_perm(w[q + k], w[q + k + 1], sel);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      res[k] = __funnelshift_r(w[q + k], w[q + k + 1], 8 * rb);
  }
  *dst = make_uint4(res[0], res[1], res[2], res[3]);
}

__global__ void bytesel_kernel(const uint32_t* __restrict__ idx,
                               const uint32_t* __restrict__ val,
                               const uint32_t* __restrict__ acc,
                               uint32_t* __restrict__ out, int n_words,
                               int method) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_words) return;
  const uint32_t ip = idx[i], vp = val[i], ap = acc[i];
  uint32_t bm;
  if (method == 0) {
    bm = __vcmpeq4(ip, 0x01010101u);  // 0xff in each byte equal to 1
  } else {
    // 0x80 in each zero byte of x, without carries across bytes
    const uint32_t x = ip ^ 0x01010101u;
    const uint32_t seven = 0x7F7F7F7Fu;
    const uint32_t m = ~(((x & seven) + seven) | x | seven);
    bm = (m >> 7) * 0xFFu;
  }
  out[i] = (ap & ~bm) | (vp & bm);
}

// lo (16, 32) -> out (128, 256), one block of 256 threads
__global__ void rep8_kernel(const uint8_t* __restrict__ lo,
                            uint8_t* __restrict__ out) {
  __shared__ uint8_t tile[16][32];
  for (int i = threadIdx.x; i < 16 * 32; i += blockDim.x)
    tile[i / 32][i % 32] = lo[i];
  __syncthreads();
  const int x = threadIdx.x;
  for (int y = 0; y < 128; ++y) out[y * 256 + x] = tile[y >> 3][x >> 3];
}

int blocks(int n, int per) { return (n + per - 1) / per; }

}  // namespace

// in, out: n_words uint32 words (4 * n_words uint8 samples)
extern "C" int mfi_probe_b32(const void* in, void* out, int n_words,
                             void* stream) {
  b32_kernel<<<blocks(n_words, 256), 256, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n_words);
  return (int)cudaGetLastError();
}

// in (R, C) uint8, out (R, C - 16); C a multiple of 16, 0 <= shift <= 16,
// method 0 (direct, shift a multiple of 16), 1 (__byte_perm) or 2
// (__funnelshift_r)
extern "C" int mfi_probe_vec16(const void* in, void* out, int R, int C,
                               int shift, int method, void* stream) {
  if (C % 16 || C < 32 || shift < 0 || shift > 16 || method < 0 ||
      method > 2 || (method == 0 && shift % 16))
    return (int)cudaErrorInvalidValue;
  const int n = R * ((C - 16) / 16);
  vec16_kernel<<<blocks(n, 128), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), R, C, shift,
      method);
  return (int)cudaGetLastError();
}

// idx, val, acc, out: n_words uint32 words; method 0 (__vcmpeq4) or 1 (the
// zero-byte bit trick)
extern "C" int mfi_probe_bytesel(const void* idx, const void* val,
                                 const void* acc, void* out, int n_words,
                                 int method, void* stream) {
  if (method < 0 || method > 1) return (int)cudaErrorInvalidValue;
  bytesel_kernel<<<blocks(n_words, 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(idx), static_cast<const uint32_t*>(val),
      static_cast<const uint32_t*>(acc), static_cast<uint32_t*>(out), n_words,
      method);
  return (int)cudaGetLastError();
}

// lo (16, 32) uint8 -> out (128, 256) uint8
extern "C" int mfi_probe_rep8(const void* lo, void* out, void* stream) {
  rep8_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lo), static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
