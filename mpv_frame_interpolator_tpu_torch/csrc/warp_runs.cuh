// The 16-byte output runs shared by K2 (warp_pair.cu, every blend position
// of a pair), K4 (warp_fused.cu, one position) and K5 (warp_sample.cu, one
// direction at one position).
//
// A thread owns one 16-byte output run of one row: 16 samples at 8 bits, 8
// under P010.  The run is cut into segments of one flow cell -- 2^rs luma
// samples or 2^(rs+1) interleaved chroma samples, capped at the run -- and
// each segment's rounded displacement is computed once from the cell's flow
// (warp_common.cuh's products).  A segment is interior when every warped
// coordinate of it lies in [1, dim - 2], where mirror_edge2 is the identity;
// a run whose segments are all interior (and whose launch may take the
// vector path) reads each segment's source with aligned 16-byte loads
// (ld.global.nc; the sources stay in L2), assembles the unaligned window in
// registers (a word select and __funnelshift_r) and writes one 16-byte
// store.  Interleaved chroma addresses (x' & ~1) + (x & 1): for an odd
// displacement dx the even (u) samples read x + dx - 1 and the odd (v) ones
// x + dx + 1 ("the chroma trap"), so a chroma segment assembles one window
// two samples longer from x + dx - odd and takes u from its start and v two
// samples on.  Every other run takes the per-sample step of
// warp_common.cuh.
//
// No load starts at an unaligned address: the window is built from the
// aligned chunks around it (a TMA box or cp.async at an unaligned column is
// what the card refuses, PERF.md P2), and a later chunk is read only when
// the window reaches into it, so no read leaves the source row.  The
// vector path needs 16-byte aligned plane pointers and rows of a multiple
// of 16 bytes (the source pitch and the output width); each C entry refuses
// a vector launch on planes that do not qualify.
//
// Q1 (warp_bilinear.cu) reads its windows -- both tap rows of both sources
// -- with the same window_words.  The CPU models of these runs are
// tests/test_torch_warp_runs.py (K2), tests/test_torch_sample_runs.py (K4
// and K5) and tests/test_torch_bilinear_runs.py (Q1).

#pragma once

#include "warp_common.cuh"

namespace mfi {

// Host: whether a launch may take the vector path -- every plane pointer
// 16-byte aligned, the source rows (src_row_bytes) and the output rows
// (out_row_bytes) a multiple of 16 bytes.
inline bool vector_ok(const void* const* planes, int n, int src_row_bytes,
                      int out_row_bytes) {
  if (src_row_bytes % 16 != 0 || out_row_bytes % 16 != 0) return false;
  for (int i = 0; i < n; ++i)
    if ((reinterpret_cast<uintptr_t>(planes[i]) & 15) != 0) return false;
  return true;
}

// log2 of the samples of a 16-byte run of T
template <typename T>
constexpr int log_run() {
  return sizeof(T) == 1 ? 4 : 3;
}

// The thread block of every run kernel: a warp covers four rows of 128
// bytes.
constexpr int kBX = 8, kBY = 32;

// Host: the grid of 16-byte runs over `rows` x Wa samples of T.
template <typename T>
inline dim3 run_grid(int rows, int Wa) {
  constexpr int kE = 16 / sizeof(T);
  return dim3(((Wa + kE - 1) / kE + kBX - 1) / kBX, (rows + kBY - 1) / kBY);
}

// Host: the grid of one launch over a luma plane (or band) of H rows and
// its chroma plane of H / 2, the luma block rows first (*luma_blocks of
// them), so that the branch on the plane is uniform per block (K2, K4,
// K5).
template <typename T>
inline dim3 two_plane_grid(int H, int Wa, int* luma_blocks) {
  const dim3 y = run_grid<T>(H, Wa), c = run_grid<T>(H / 2, Wa);
  *luma_blocks = (int)y.y;
  return dim3(y.x, y.y + c.y);
}

// Host: Launch<T, lg_y, lg_c>::run(args...) with the log2 segment lengths
// of res scalar rs -- a luma flow cell is 2^rs samples, an interleaved
// chroma cell 2^(rs+1) -- each capped at the run, so that both lengths are
// fixed at compile time (K2, K4, K5).
template <typename T, template <typename, int, int> class Launch,
          typename... A>
int dispatch_segments(int rs, A... args) {
  constexpr int e = log_run<T>();
#define MFI_SEGS(L) \
  case L:           \
    return Launch<T, (L < e ? L : e), (L + 1 < e ? L + 1 : e)>::run(args...);
  switch (rs < e ? rs : e) {
    MFI_SEGS(0)
    MFI_SEGS(1)
    MFI_SEGS(2)
    MFI_SEGS(3)
    MFI_SEGS(4)
  }
#undef MFI_SEGS
  return (int)cudaErrorInvalidValue;
}

// kW words of `row` from byte sb on, of which the first kNeed bytes are
// used: only the aligned 16-byte chunks that hold those are read (rows
// start 16-byte aligned; a window of up to 20 bytes spans up to 3), then a
// word select and __funnelshift_r.
template <int kW, int kNeed>
__device__ __forceinline__ void window_words(const unsigned char* row, int sb,
                                             unsigned w[kW]) {
  constexpr int kChunks = (kNeed + 30) / 16;  // the most a window spans
  constexpr int kV = 4 * kChunks > kW + 4 ? 4 * kChunks : kW + 4;
  const int a = sb & ~15, o = sb & 15;
  unsigned v[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) v[i] = 0u;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c == 0 || o + kNeed > 16 * c) {
      const uint4 chunk =
          __ldg(reinterpret_cast<const uint4*>(row + a + 16 * c));
      v[4 * c] = chunk.x;
      v[4 * c + 1] = chunk.y;
      v[4 * c + 2] = chunk.z;
      v[4 * c + 3] = chunk.w;
    }
  }
  // words q = o >> 2 on, selected in two levels (q's bit 1, then bit 0)
  const int q = o >> 2;
  unsigned h[kW + 2], u[kW + 1];
#pragma unroll
  for (int i = 0; i <= kW + 1; ++i) h[i] = (q & 2) ? v[i + 2] : v[i];
#pragma unroll
  for (int i = 0; i <= kW; ++i) u[i] = (q & 1) ? h[i + 1] : h[i];
  const unsigned sh = (unsigned)(o & 3) * 8u;
#pragma unroll
  for (int i = 0; i < kW; ++i) w[i] = __funnelshift_r(u[i], u[i + 1], sh);
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

// The windows of one segment of kSeg samples from column xs of `row`,
// displaced by dx: a for the even samples, b for the odd ones.  They differ
// only for chroma at an odd displacement (u from xs + dx - 1, v from
// xs + dx + 1): chroma reads one window of kSeg + 2 samples from
// xs + dx - odd, and b is that window two samples on (a funnel shift by
// 0 or 2 samples, so no branch and no second read).
template <typename T, bool kChroma, int kSeg>
__device__ __forceinline__ void segment_windows(const T* row, int xs, int dx,
                                                unsigned a[4], unsigned b[4]) {
  constexpr int item = sizeof(T);
  const unsigned char* r = reinterpret_cast<const unsigned char*>(row);
  if (!kChroma) {
    window_words<4, kSeg * item>(r, (xs + dx) * item, a);
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = a[q];
    return;
  }
  const int odd = dx & 1;
  unsigned v[5];
  window_words<5, (kSeg + 2) * item>(r, (xs + dx - odd) * item, v);
  const unsigned sh = (unsigned)(odd * 16 * item);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    a[q] = v[q];
    b[q] = __funnelshift_rc(v[q], v[q + 1], sh);
  }
}

// Whether every warped coordinate of the segment [xs, xs + seg) of row cy,
// displaced by dx in [dx_lo, dx_hi] and dy in [dy_lo, dy_hi], lies in
// [1, dim - 2], where mirror_edge2 is the identity.
__device__ __forceinline__ bool segment_interior(int xs, int seg, int cy,
                                                 int dx_lo, int dx_hi,
                                                 int dy_lo, int dy_hi, int Wa,
                                                 int rows) {
  return xs + dx_lo >= 1 && xs + seg - 1 + dx_hi <= Wa - 2 &&
         cy + dy_lo >= 1 && cy + dy_hi <= rows - 2;
}

// The forward and reverse flow of each segment of the run at (x0, cy).
template <bool kChroma, int kSeg, int kNSeg>
__device__ __forceinline__ void run_flows(const int* __restrict__ blurred,
                                          int x0, int cy, int lh, int lw,
                                          int rs, float fx12[kNSeg],
                                          float fy12[kNSeg],
                                          float fx21[kNSeg],
                                          float fy21[kNSeg]) {
#pragma unroll
  for (int g = 0; g < kNSeg; ++g)
    flow_at<kChroma>(blurred, x0 + g * kSeg, cy, lh, lw, rs, &fx12[g],
                     &fy12[g], &fx21[g], &fy21[g]);
}

// The blended run at (x0, cy) of one position t12, written to `o` (the
// run's first output sample), given each segment's flows (run_flows).
// Interior runs blend and level-map per sample from the windows; edge runs
// (or a launch without the vector path, vec == 0) take blend_pixel.  A
// 16-byte run is written with a streaming store (st.global.cs,
// evict-first): an output is not read again by the launch, and the sources
// that the next runs read stay in L2.
template <typename T, bool kChroma, int kLogSeg>
__device__ __forceinline__ void blend_run(
    const T* __restrict__ f1, const T* __restrict__ f2, const float* fx12,
    const float* fy12, const float* fx21, const float* fy21, float t12,
    T* __restrict__ o, int x0, int cy, int rows, int Wa, int pitch, int ss,
    const Levels& lv, int vec) {
  constexpr int item = sizeof(T);
  constexpr int kE = 16 / item;  // samples a run
  constexpr int kSeg = 1 << kLogSeg;
  constexpr int kNSeg = kE / kSeg;
  const int frac = ss ? 16 : 24;
  // an 8-bit blend never exceeds 255, so at the default levels its level
  // map is the identity
  const bool identity = item == 1 && lv.w == 255 && (kChroma || lv.k == 0);
  const float t21 = __fsub_rn(1.0f, t12);
  unsigned r[4] = {0u, 0u, 0u, 0u};
  bool interior = vec != 0;
  int dx12[kNSeg], dy12[kNSeg], dx21[kNSeg], dy21[kNSeg];
#pragma unroll
  for (int g = 0; g < kNSeg; ++g) {
    dir_displacement<kChroma>(fx12[g], fy12[g], t12, false, &dx12[g],
                              &dy12[g]);
    dir_displacement<kChroma>(fx21[g], fy21[g], t21, true, &dx21[g],
                              &dy21[g]);
    interior = interior &&
               segment_interior(x0 + g * kSeg, kSeg, cy, min(dx12[g], dx21[g]),
                                max(dx12[g], dx21[g]), min(dy12[g], dy21[g]),
                                max(dy12[g], dy21[g]), Wa, rows);
  }
  if (interior) {
    const unsigned tw = blend_weight(t12, frac);
    const unsigned w1 = (1u << frac) - tw;
    unsigned vals[kE];
#pragma unroll
    for (int g = 0; g < kNSeg; ++g) {
      unsigned a12[4], b12[4], a21[4], b21[4];
      const int xs = x0 + g * kSeg;
      segment_windows<T, kChroma, kSeg>(f1 + (size_t)(cy + dy12[g]) * pitch,
                                        xs, dx12[g], a12, b12);
      segment_windows<T, kChroma, kSeg>(f2 + (size_t)(cy + dy21[g]) * pitch,
                                        xs, dx21[g], a21, b21);
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        const unsigned s12 = sample_of<T>((j & 1) ? b12 : a12, j);
        const unsigned s21 = sample_of<T>((j & 1) ? b21 : a21, j);
        const unsigned bl = (s12 * w1 + s21 * tw) >> frac;
        vals[g * kSeg + j] = identity ? bl
                             : kChroma ? levels_uv(bl, ss, lv)
                                       : levels_y(bl, ss, lv);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) r[q] = pack_word<T>(vals + q * (4 / item));
    __stcs(reinterpret_cast<uint4*>(o), make_uint4(r[0], r[1], r[2], r[3]));
    return;
  }
  // edge run (or no vector path): the per-sample step
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int g = j / kSeg;
    const int cx = x0 + j;
    if (!vec && cx >= Wa) break;
    const unsigned v = blend_pixel<T, kChroma>(f1, f2, pitch, rows, Wa, cx, cy,
                                               dx12[g], dy12[g], dx21[g],
                                               dy21[g], t12, ss, lv);
    if (vec)
      r[j / (4 / item)] |= v << (8 * item * (j % (4 / item)));
    else
      o[j] = (T)v;
  }
  if (vec)
    __stcs(reinterpret_cast<uint4*>(o), make_uint4(r[0], r[1], r[2], r[3]));
}

// The raw run of ONE direction at (x0, cy), written to `o`: direction 12
// samples f1 (src) along the flow at t12, direction 21 samples f2 against
// the reverse flow at 1 - t12.  Per segment, one flow lookup (the forward
// flow only for direction 12) and one displacement.  An interior segment's
// bytes are its window's first kSeg * sizeof(T) bytes, so where a segment
// holds whole 32-bit words they go straight into the output words (the u/v
// select a byte mask); shorter segments go sample by sample.
template <typename T, bool kChroma, int kLogSeg>
__device__ __forceinline__ void sample_run(
    const T* __restrict__ src, const int* __restrict__ blurred, float t12,
    bool dir21, T* __restrict__ o, int x0, int cy, int rows, int Wa,
    int pitch, int lh, int lw, int rs, int vec) {
  constexpr int item = sizeof(T);
  constexpr int kE = 16 / item;
  constexpr int kSeg = 1 << kLogSeg;
  constexpr int kNSeg = kE / kSeg;
  constexpr int kWords = kSeg * item / 4;  // whole words a segment
  const float s = dir21 ? __fsub_rn(1.0f, t12) : t12;
  int dx[kNSeg], dy[kNSeg];
  bool interior = vec != 0;
#pragma unroll
  for (int g = 0; g < kNSeg; ++g) {
    float fx, fy;
    flow_dir<kChroma>(blurred, x0 + g * kSeg, cy, lh, lw, rs, dir21, &fx,
                      &fy);
    dir_displacement<kChroma>(fx, fy, s, dir21, &dx[g], &dy[g]);
    interior = interior && segment_interior(x0 + g * kSeg, kSeg, cy, dx[g],
                                            dx[g], dy[g], dy[g], Wa, rows);
  }
  unsigned r[4] = {0u, 0u, 0u, 0u};
  if (interior) {
    // the even samples' bytes of a word (u in chroma)
    constexpr unsigned kEven = item == 1 ? 0x00ff00ffu : 0x0000ffffu;
    unsigned vals[kE];
#pragma unroll
    for (int g = 0; g < kNSeg; ++g) {
      unsigned a[4], b[4];
      segment_windows<T, kChroma, kSeg>(src + (size_t)(cy + dy[g]) * pitch,
                                        x0 + g * kSeg, dx[g], a, b);
      if constexpr (kWords > 0) {
#pragma unroll
        for (int q = 0; q < kWords; ++q)
          r[g * kWords + q] = (a[q] & kEven) | (b[q] & ~kEven);
      } else {
#pragma unroll
        for (int j = 0; j < kSeg; ++j)
          vals[g * kSeg + j] = sample_of<T>((j & 1) ? b : a, j);
      }
    }
    if constexpr (kWords == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] = pack_word<T>(vals + q * (4 / item));
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(r[0], r[1], r[2], r[3]);
    return;
  }
  // edge run (or no vector path): the per-sample step
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int g = j / kSeg;
    const int cx = x0 + j;
    if (!vec && cx >= Wa) break;
    const unsigned v = sample_dir_pixel<T, kChroma>(src, pitch, rows, Wa, cx,
                                                    cy, dx[g], dy[g]);
    if (vec)
      r[j / (4 / item)] |= v << (8 * item * (j % (4 / item)));
    else
      o[j] = (T)v;
  }
  if (vec) *reinterpret_cast<uint4*>(o) = make_uint4(r[0], r[1], r[2], r[3]);
}

}  // namespace mfi
