// K2: every blended output of one source pair, for Hopper (sm_90a).
//
// Replaces the TPU kernel mpv_frame_interpolator_tpu/ops/pallas/
// warp_pair.py:pair_blend_plane (reached through blended_pair_from_prep).
// The per-pixel semantics are in warp_common.cuh: two mirrored nearest
// samples, the fixed-point blend and the black/white level maps, for
// uint8 NV12 (scale_shift 0) and uint16 P010 (scale_shift 8) planes.  The
// TPU kernel serves only 8-bit NV12 at the default levels; this one serves
// every case.
//
// What bounds it: at 4K with five positions a pair writes 5 x 12.4 MB and
// reads two nearest samples per output sample from sources that stay in
// the 50 MB L2 -- about 62 MB written and ~25 MB of distinct reads, ~26 us
// at the card's 3.35 TB/s (twice that under P010).  A thread per sample
// with byte loads and stores was bound by the count of those accesses, and
// redid per sample the displacement work that only depends on the flow
// cell.  The design:
//   * one thread per 16-byte output run of one row (16 samples at 8 bits,
//     8 under P010) -- and at 8 bits per position, while under P010 it
//     loops over the N positions -- reading the flow and the reverse flow
//     once per cell the run covers;
//   * per position and cell, the four rounded displacements once (the
//     products and roundings of blend_pixel), and the blend weights T and
//     2^F - T once;
//   * an interior run -- one where mirror_edge2 is the identity for every
//     sample in both directions, i.e. every warped coordinate lies in
//     [1, dim - 2] -- reads each source segment with aligned 16-byte loads
//     (ld.global.nc; the sources stay in L2) and assembles the unaligned
//     window in registers (a word select and __funnelshift_r), then blends
//     and level-maps per sample and writes one 16-byte store a position;
//   * interleaved chroma addresses (x' & ~1) + (x & 1): for an odd
//     displacement dx the even (u) samples read x + dx - 1 and the odd (v)
//     ones x + dx + 1, so the run assembles two windows, at s - 1 and
//     s + 1, and takes u from one and v from the other;
//   * an edge run (any sample mirrored, which includes column 0, column
//     Wa - 1, row 0 and row rows - 1 at any flow) takes the per-sample step
//     mfi::blend_pixel, shared with K4.
// The vector path needs 16-byte aligned plane pointers and rows of a
// multiple of 16 bytes (pitch and Wa); otherwise the whole launch takes the
// per-sample path.  No load starts at an unaligned address: the window is
// built from the aligned chunks around it (a TMA box or cp.async at an
// unaligned column is exactly what the card refuses, PERF.md P2), and the
// second chunk is read only when the window reaches into it, so no read
// leaves the source row.

#include "warp_common.cuh"

namespace {

// 16 bytes of `row` from byte `sb` on; `need` bytes of them are used, and
// only the aligned chunks that hold those are read (rows start 16-byte
// aligned)
__device__ __forceinline__ void window16(const unsigned char* row, int sb,
                                         int need, unsigned w[4]) {
  const int a = sb & ~15, o = sb & 15;
  const uint4 c0 = __ldg(reinterpret_cast<const uint4*>(row + a));
  uint4 c1 = make_uint4(0u, 0u, 0u, 0u);
  if (o + need > 16) c1 = __ldg(reinterpret_cast<const uint4*>(row + a + 16));
  const unsigned v[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const int q = o >> 2;
  unsigned u[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    u[k] = q == 0 ? v[k] : (q == 1 ? v[k + 1] : (q == 2 ? v[k + 2] : v[k + 3]));
  const unsigned sh = (unsigned)(o & 3) * 8u;
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = __funnelshift_r(u[k], u[k + 1], sh);
}

// sample j of a 16-byte window of T samples
template <typename T>
__device__ __forceinline__ unsigned sample_of(const unsigned w[4], int j) {
  if (sizeof(T) == 1) return __byte_perm(w[j >> 2], 0u, 0x4440u | (j & 3));
  return (w[j >> 1] >> (16 * (j & 1))) & 0xffffu;
}

// one 32-bit word of the run from its samples v[0..4/sizeof(T))
template <typename T>
__device__ __forceinline__ unsigned pack_word(const unsigned* v) {
  if (sizeof(T) == 1)
    return __byte_perm(__byte_perm(v[0], v[1], 0x0040u),
                       __byte_perm(v[2], v[3], 0x0040u), 0x5410u);
  return __byte_perm(v[0], v[1], 0x5410u);
}

// The run at (x0, cy), kSeg samples a segment (one flow cell, or the whole
// run when a cell is wider), at positions blockIdx.z, blockIdx.z +
// gridDim.z, ...
template <typename T, bool kChroma, int kLogSeg>
__global__ void __launch_bounds__(256) pair_blend_kernel(
    const T* __restrict__ f1, const T* __restrict__ f2,
    const int* __restrict__ blurred, const float* __restrict__ ts,
    T* __restrict__ out, int n_out, int rows, int Wa, int pitch, int lh,
    int lw, int rs, int ss, int k, int w, int vec) {
  constexpr int kE = 16 / sizeof(T);  // samples a run
  constexpr int kSeg = 1 << kLogSeg;
  constexpr int kNSeg = kE / kSeg;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kE;
  const int cy = blockIdx.y * blockDim.y + threadIdx.y;
  if (x0 >= Wa || cy >= rows) return;
  float fx12[kNSeg], fy12[kNSeg], fx21[kNSeg], fy21[kNSeg];
#pragma unroll
  for (int g = 0; g < kNSeg; ++g)
    mfi::flow_at<kChroma>(blurred, x0 + g * kSeg, cy, lh, lw, rs, &fx12[g],
                          &fy12[g], &fx21[g], &fy21[g]);
  const size_t plane = (size_t)rows * Wa;
  const int frac = ss ? 16 : 24;
  constexpr int item = sizeof(T);
  const bool identity = item == 1 && w == 255 && (kChroma || k == 0);
  for (int n = blockIdx.z; n < n_out; n += gridDim.z) {
    const float t12 = ts[n];
    const float t21 = __fsub_rn(1.0f, t12);
    T* o = out + n * plane + (size_t)cy * Wa + x0;
    unsigned r[4] = {0u, 0u, 0u, 0u};
    bool interior = vec != 0;
    int dx12[kNSeg], dy12[kNSeg], dx21[kNSeg], dy21[kNSeg];
#pragma unroll
    for (int g = 0; g < kNSeg; ++g) {
      float a = __fmul_rn(fy12[g], t12), b = __fmul_rn(fy21[g], t21);
      if (kChroma) {
        a = __fmul_rn(a, 0.5f);
        b = __fmul_rn(b, 0.5f);
      }
      dx12[g] = mfi::iround(__fmul_rn(fx12[g], t12));
      dx21[g] = -mfi::iround(__fmul_rn(fx21[g], t21));
      dy12[g] = mfi::iround(a);
      dy21[g] = -mfi::iround(b);
      const int xs = x0 + g * kSeg;
      interior = interior && xs + min(dx12[g], dx21[g]) >= 1 &&
                 xs + kSeg - 1 + max(dx12[g], dx21[g]) <= Wa - 2 &&
                 cy + min(dy12[g], dy21[g]) >= 1 &&
                 cy + max(dy12[g], dy21[g]) <= rows - 2;
    }
    if (interior) {
      const unsigned tw = mfi::blend_weight(t12, frac);
      const unsigned w1 = (1u << frac) - tw;
      unsigned vals[kE];
#pragma unroll
      for (int g = 0; g < kNSeg; ++g) {
        // windows A (even samples) and B (odd samples) of each direction;
        // they differ only for chroma at an odd displacement
        unsigned a12[4], b12[4], a21[4], b21[4];
        const int xs = x0 + g * kSeg;
        const unsigned char* r12 =
            reinterpret_cast<const unsigned char*>(f1 + (size_t)(cy + dy12[g]) * pitch);
        const unsigned char* r21 =
            reinterpret_cast<const unsigned char*>(f2 + (size_t)(cy + dy21[g]) * pitch);
        const int odd12 = kChroma ? (dx12[g] & 1) : 0;
        const int odd21 = kChroma ? (dx21[g] & 1) : 0;
        window16(r12, (xs + dx12[g] - odd12) * item, kSeg * item, a12);
        window16(r21, (xs + dx21[g] - odd21) * item, kSeg * item, a21);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          b12[q] = a12[q];
          b21[q] = a21[q];
        }
        if (odd12) window16(r12, (xs + dx12[g] + 1) * item, kSeg * item, b12);
        if (odd21) window16(r21, (xs + dx21[g] + 1) * item, kSeg * item, b21);
#pragma unroll
        for (int j = 0; j < kSeg; ++j) {
          const unsigned s12 = sample_of<T>((j & 1) ? b12 : a12, j);
          const unsigned s21 = sample_of<T>((j & 1) ? b21 : a21, j);
          const unsigned bl = (s12 * w1 + s21 * tw) >> frac;
          // an 8-bit blend never exceeds 255, so at the default levels its
          // level map is the identity
          vals[g * kSeg + j] =
              identity ? bl
                       : (kChroma ? mfi::levels_uv(bl, ss, w)
                                  : mfi::levels_y(bl, ss, k, w));
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = pack_word<T>(vals + q * (4 / item));
      *reinterpret_cast<uint4*>(o) = make_uint4(r[0], r[1], r[2], r[3]);
      continue;
    }
    // edge run (or no vector path): the per-sample step
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int g = j / kSeg;
      const int cx = x0 + j;
      if (!vec && cx >= Wa) break;
      const unsigned v = mfi::blend_pixel<T, kChroma>(
          f1, f2, pitch, rows, Wa, cx, cy, fx12[g], fy12[g], fx21[g],
          fy21[g], t12, ss, k, w);
      if (vec)
        r[j / (4 / item)] |= v << (8 * item * (j % (4 / item)));
      else
        o[j] = (T)v;
    }
    if (vec) *reinterpret_cast<uint4*>(o) = make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// a warp covers four rows of 128 bytes; at 8 bits each position gets its own
// threads (grid.z), which hides more latency than a loop over positions,
// while under P010 (half the samples a run) the loop amortises the flow
// lookups better: each shape measured the faster on the H100 (PERF.md)
constexpr int kBX = 8, kBY = 32;

template <typename T, bool kChroma, int kLogSeg>
int launch_plane(const void* f1, const void* f2, const void* blurred,
                 const void* ts, void* out, int n, int rows, int Wa,
                 int pitch, int lh, int lw, int rs, int ss, int k, int w,
                 int vec, cudaStream_t s) {
  constexpr int kE = 16 / sizeof(T);
  const dim3 block(kBX, kBY);
  const dim3 grid(((Wa + kE - 1) / kE + kBX - 1) / kBX, (rows + kBY - 1) / kBY,
                  sizeof(T) == 1 && n > 1 ? n : 1);
  pair_blend_kernel<T, kChroma, kLogSeg><<<grid, block, 0, s>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const int*>(blurred), static_cast<const float*>(ts),
      static_cast<T*>(out), n, rows, Wa, pitch, lh, lw, rs, ss, k, w, vec);
  return (int)cudaGetLastError();
}

// log2 of the segment: a flow cell is 2^rs luma samples or 2^(rs+1)
// interleaved chroma samples, capped at the run
template <typename T, bool kChroma>
int dispatch(int log_seg, const void* f1, const void* f2, const void* blurred,
             const void* ts, void* out, int n, int rows, int Wa, int pitch,
             int lh, int lw, int rs, int ss, int k, int w, int vec,
             cudaStream_t s) {
  constexpr int kLogE = sizeof(T) == 1 ? 4 : 3;
  const int lg = log_seg < kLogE ? log_seg : kLogE;
#define MFI_SEG(L)                                                         \
  case L:                                                                  \
    return launch_plane<T, kChroma, (L < kLogE ? L : kLogE)>(              \
        f1, f2, blurred, ts, out, n, rows, Wa, pitch, lh, lw, rs, ss, k, w, \
        vec, s);
  switch (lg) {
    MFI_SEG(0)
    MFI_SEG(1)
    MFI_SEG(2)
    MFI_SEG(3)
    MFI_SEG(4)
  }
#undef MFI_SEG
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* f1y, const void* f1uv, const void* f2y,
           const void* f2uv, const void* blurred, const void* ts, void* out_y,
           void* out_uv, int n, int H, int Wa, int pitch, int lh, int lw,
           int rs, int ss, int k, int w, int vec, cudaStream_t s) {
  const int item = (int)sizeof(T);
  if (vec && !((pitch * item) % 16 == 0 && (Wa * item) % 16 == 0 &&
               aligned16(f1y) && aligned16(f1uv) && aligned16(f2y) &&
               aligned16(f2uv) && aligned16(out_y) && aligned16(out_uv)))
    return (int)cudaErrorMisalignedAddress;
  int e = dispatch<T, false>(rs, f1y, f2y, blurred, ts, out_y, n, H, Wa,
                             pitch, lh, lw, rs, ss, k, w, vec, s);
  if (e != 0) return e;
  return dispatch<T, true>(rs + 1, f1uv, f2uv, blurred, ts, out_uv, n, H / 2,
                           Wa, pitch, lh, lw, rs, ss, k, w, vec, s);
}

}  // namespace

// out_y (n, H, Wa), out_uv (n, H/2, Wa); sources (H, pitch) and
// (H/2, pitch) with pitch >= Wa, uint8 when ss == 0 and uint16 when
// ss == 8; blurred (2, lh, lw) int32; ts (n,) float; (k, w) the levels;
// vec: 1 for the 16-byte path (refused unless every plane pointer is
// 16-byte aligned and pitch and Wa are rows of a multiple of 16 bytes).
extern "C" int mfi_pair_blend(const void* f1y, const void* f1uv,
                              const void* f2y, const void* f2uv,
                              const void* blurred, const void* ts, void* out_y,
                              void* out_uv, int n, int H, int Wa, int pitch,
                              int lh, int lw, int rs, int ss, int k, int w,
                              int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ss)
    return launch<uint16_t>(f1y, f1uv, f2y, f2uv, blurred, ts, out_y, out_uv,
                            n, H, Wa, pitch, lh, lw, rs, ss, k, w, vec, s);
  return launch<uint8_t>(f1y, f1uv, f2y, f2uv, blurred, ts, out_y, out_uv, n,
                         H, Wa, pitch, lh, lw, rs, ss, k, w, vec, s);
}
