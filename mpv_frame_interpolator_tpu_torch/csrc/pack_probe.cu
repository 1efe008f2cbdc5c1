// P1: the TPU probe's packed-byte primitives on Hopper (sm_90a), every
// probe in one launch.
//
// Replaces the TPU probe tools/pallas_pack_probe.py:run_kernel and its five
// kernels, which ask whether Mosaic packs four uint8 ROWS into one int32
// word and whether shifts and selects work in that packed domain.  The
// first five probes return the JAX kernels' arrays exactly (int32; word
// (r, c) holds rows 4r..4r+3 of column c, little-endian):
//
//   b32       the row-quad packing of the (128, 256) plane a;
//   colroll   the packing of np.roll(a, s, axis=1), s given at run time;
//   rowroll   the packing of np.roll(a, -s, axis=0), s given at run time;
//   bytesel   the packing of where(idx == 1, val, acc), the select done
//             with the TPU probe's carry-free zero-byte trick;
//   rep8      the x8 nearest upsample of the (16, 32) tile lo, (128, 256).
//
// The rest probe the card's own packing, which the warp kernels rest on:
// a row-major uint8 plane read as uint32 packs four COLUMNS, little-endian,
// and a 16-byte load moves sixteen of them:
//
//   b32 words   the plane's own words, (128, 64) int32;
//   vec16       out[r, c] = a[r, c + shift], (128, 240) uint8: at shift 16
//               one aligned load per 16 outputs; at shift 5 two aligned
//               loads, the window assembled with __byte_perm or with
//               __funnelshift_r (K2/K4/K5/Q1's window_words);
//   bytesel     the row-quad select with __vcmpeq4.
//
// Each is held bit-exact against its plain version in
// mpv_frame_interpolator_tpu_torch/tools/pack_probe.py, whose PROBES lists
// them in the order of the Probe numbers below.
//
// Design: one kernel and one entry.  The host lays the grid out as ranges
// of blocks, one range per probe of the mask, and passes the ranges by
// value; a block finds its range with constant indices (no local memory).
// Every thread loads and stores 16 bytes at a time: a row-quad thread
// takes 16 columns of four source rows (four aligned uint4 loads, or two a
// row for colroll's window), transposes them 4 x 4 bytes at a time with
// __byte_perm and writes four uint4 into row r of the output.
//
// What bounds it: the probes move ~0.55 MB in all (0.00016 ms at
// 3.35 TB/s), far below one launch's fixed cost, so the design is one
// launch for every probe instead of a launch each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 128, kC = 256;        // the probed plane
constexpr int kLoH = 16, kLoW = 32;      // rep8's low-res tile
constexpr int kVecShift = 5;             // vec16's unaligned column offset
constexpr int kThreads = 128;

// bit p of the mask, entry p of PROBES in tools/pack_probe.py
enum Probe {
  kB32,            // row quads of a
  kColroll,        // row quads of np.roll(a, col_shift, axis=1)
  kRowroll,        // row quads of np.roll(a, -row_shift, axis=0)
  kByteselTrick,   // row quads of where(idx == 1, val, acc), zero-byte trick
  kRep8,           // int32 x8 nearest upsample of lo
  kB32Words,       // a's own words: four columns, little-endian
  kVec16Aligned,   // out[r, c] = a[r, c + 16], one aligned load
  kVec16Perm,      // out[r, c] = a[r, c + 5], __byte_perm
  kVec16Funnel,    // the same, __funnelshift_r
  kByteselVcmp,    // as kByteselTrick, with __vcmpeq4
  kProbes
};

// the 4 x 4 byte transpose's selectors: interleave the low / high byte
// pairs of two words, then take the low / high halves of two words
constexpr uint32_t kPairLo = 0x5140, kPairHi = 0x7362;
constexpr uint32_t kHalfLo = 0x5410, kHalfHi = 0x7632;

constexpr int kChunks = kC / 16;         // 16-byte chunks a row

__host__ __device__ constexpr int probe_threads(int p) {
  return p <= kByteselTrick || p == kByteselVcmp ? (kR / 4) * kChunks
         : p == kRep8                            ? kLoH * 8 * kLoW * 8 / 4
         : p == kB32Words                        ? kR * kChunks
                                                 : kR * (kChunks - 1);
}

// The launch's plan, by value: range n is blocks [start[n], start[n + 1])
// running probe[n] into out[n].
struct Plan {
  const uint8_t* a;
  const uint8_t* idx;
  const uint8_t* val;
  const uint8_t* acc;
  const uint8_t* lo;
  void* out[kProbes];
  int start[kProbes + 1];
  int probe[kProbes];
  int n;
  int col_shift, row_shift;
};

__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t w[4]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// v[i] for a run-time i in [0, 8), by selects (no local memory)
__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[8], int i) {
  uint32_t r = v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) r = i == j ? v[j] : r;
  return r;
}

// 16 bytes of a row from column (c0 - s) mod kC, c0 a multiple of 16: the
// aligned chunk hi at (c0 - 16 (s / 16)) mod kC and, unless s is a
// multiple of 16, the chunk before it (at the row's first chunk, the one
// at kC - 16); the window is bytes 16 - s % 16 .. of the two, funnel
// shifted out of the pair's words
__device__ __forceinline__ void rolled_window(const uint8_t* row, int c0,
                                              int s, uint32_t w[4]) {
  const int hi = (c0 - 16 * (s >> 4) + kC) % kC;
  const int o = s & 15;
  uint32_t h[4];
  load_words(row + hi, h);
  if (o == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = h[k];
    return;
  }
  uint32_t l[4];
  load_words(row + (hi - 16 + kC) % kC, l);
  const uint32_t cat[8] = {l[0], l[1], l[2], l[3], h[0], h[1], h[2], h[3]};
  const int b = 16 - o;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = __funnelshift_r(pick(cat, (b >> 2) + k), pick(cat, (b >> 2) + k + 1),
                           8 * (b & 3));
}

// where(idx == 1, val, acc) on four bytes of each
__device__ __forceinline__ uint32_t select_word(uint32_t ip, uint32_t vp,
                                                uint32_t ap, bool vcmp) {
  uint32_t bm;
  if (vcmp) {
    bm = __vcmpeq4(ip, 0x01010101u);  // 0xff in each byte equal to 1
  } else {
    // 0x80 in each zero byte of x, without carries across bytes, widened
    const uint32_t x = ip ^ 0x01010101u;
    const uint32_t seven = 0x7F7F7F7Fu;
    const uint32_t m = ~(((x & seven) + seven) | x | seven);
    bm = (m >> 7) * 0xFFu;
  }
  return (ap & ~bm) | (vp & bm);
}

// byte k of o[i] is byte i of wk
__device__ __forceinline__ uint4 transpose4(uint32_t w0, uint32_t w1,
                                            uint32_t w2, uint32_t w3) {
  const uint32_t t0 = __byte_perm(w0, w1, kPairLo);
  const uint32_t t1 = __byte_perm(w0, w1, kPairHi);
  const uint32_t t2 = __byte_perm(w2, w3, kPairLo);
  const uint32_t t3 = __byte_perm(w2, w3, kPairHi);
  return make_uint4(__byte_perm(t0, t2, kHalfLo), __byte_perm(t0, t2, kHalfHi),
                    __byte_perm(t1, t3, kHalfLo), __byte_perm(t1, t3, kHalfHi));
}

// b32, colroll, rowroll, bytesel: thread i writes words c0..c0+15 of row r
// of the (kR / 4, kC) int32 output from rows 4r..4r+3 of its source
__device__ __forceinline__ void row_quads(const Plan& plan, int p, void* out,
                                          int i) {
  const int r = i / kChunks, c0 = (i % kChunks) * 16;
  uint32_t w[4][4];  // [source row k][word j]: columns c0 + 4j .. c0 + 4j + 3
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int y = p == kRowroll ? (4 * r + k + plan.row_shift) % kR : 4 * r + k;
    const size_t row = (size_t)y * kC;
    if (p == kColroll) {
      rolled_window(plan.a + row, c0, plan.col_shift, w[k]);
    } else if (p == kByteselTrick || p == kByteselVcmp) {
      uint32_t ip[4], vp[4], ap[4];
      load_words(plan.idx + row + c0, ip);
      load_words(plan.val + row + c0, vp);
      load_words(plan.acc + row + c0, ap);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[k][j] = select_word(ip[j], vp[j], ap[j], p == kByteselVcmp);
    } else {
      load_words(plan.a + row + c0, w[k]);
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(static_cast<uint32_t*>(out) +
                                        (size_t)r * kC + c0);
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = transpose4(w[0][j], w[1][j], w[2][j], w[3][j]);
}

// out (kR, kC - 16): 16 outputs of row r from column c0 + shift
__device__ __forceinline__ void vec16(const uint8_t* a, int p, void* out,
                                      int i) {
  const int r = i / (kChunks - 1);
  const int c0 = (i % (kChunks - 1)) * 16;
  const uint8_t* row = a + (size_t)r * kC;
  uint4* dst = reinterpret_cast<uint4*>(static_cast<uint8_t*>(out) +
                                        (size_t)r * (kC - 16) + c0);
  if (p == kVec16Aligned) {  // a multiple of 16: one aligned load
    *dst = __ldg(reinterpret_cast<const uint4*>(row + c0 + 16));
    return;
  }
  uint32_t lo[4], hi[4];
  load_words(row + c0, lo);
  load_words(row + c0 + 16, hi);
  const uint32_t cat[8] = {lo[0], lo[1], lo[2], lo[3], hi[0], hi[1], hi[2], hi[3]};
  constexpr int q = kVecShift >> 2, rb = kVecShift & 3;
  uint32_t res[4];
  if (p == kVec16Perm) {
    constexpr uint32_t sel = rb | (rb + 1) << 4 | (rb + 2) << 8 | (rb + 3) << 12;
#pragma unroll
    for (int k = 0; k < 4; ++k) res[k] = __byte_perm(cat[q + k], cat[q + k + 1], sel);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      res[k] = __funnelshift_r(cat[q + k], cat[q + k + 1], 8 * rb);
  }
  *dst = make_uint4(res[0], res[1], res[2], res[3]);
}

__global__ void __launch_bounds__(kThreads) probe_kernel(const Plan plan) {
  // this block's range, read with constant indices only
  int p = plan.probe[0], first = 0;
  void* out = plan.out[0];
#pragma unroll
  for (int k = 1; k < kProbes; ++k) {
    if (k < plan.n && (int)blockIdx.x >= plan.start[k]) {
      p = plan.probe[k];
      first = plan.start[k];
      out = plan.out[k];
    }
  }
  const int i = ((int)blockIdx.x - first) * kThreads + (int)threadIdx.x;
  if (i >= probe_threads(p)) return;
  if (p <= kByteselTrick || p == kByteselVcmp) {
    row_quads(plan, p, out, i);
  } else if (p == kRep8) {
    // one uint4 of the (kLoH * 8, kLoW * 8) output: four columns of one
    // low-res sample
    const int y = i / (kLoW * 2), x4 = i % (kLoW * 2);
    const int v = __ldg(plan.lo + (y >> 3) * kLoW + (x4 >> 1));
    reinterpret_cast<int4*>(out)[i] = make_int4(v, v, v, v);
  } else if (p == kB32Words) {
    reinterpret_cast<uint4*>(out)[i] =
        __ldg(reinterpret_cast<const uint4*>(plan.a) + i);
  } else {
    vec16(plan.a, p, out, i);
  }
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

}  // namespace

// a, idx, val, acc (128, 256) uint8 and lo (16, 32) uint8; outs[p] the
// output of probe p (its shape and type as PROBES gives them) for each bit
// p of mask, the others not read; 0 <= col_shift < 256, 0 <= row_shift <
// 128.  One launch runs every probe of the mask.
extern "C" int mfi_probe_run(const void* a, const void* idx, const void* val,
                             const void* acc, const void* lo,
                             void* const* outs, int mask, int col_shift,
                             int row_shift, void* stream) {
  if (mask <= 0 || mask >> kProbes || outs == nullptr || col_shift < 0 ||
      col_shift >= kC || row_shift < 0 || row_shift >= kR || !a || !idx ||
      !val || !acc || !lo || misaligned(a) || misaligned(idx) ||
      misaligned(val) || misaligned(acc) || misaligned(lo))
    return (int)cudaErrorInvalidValue;
  Plan plan = {};
  plan.a = static_cast<const uint8_t*>(a);
  plan.idx = static_cast<const uint8_t*>(idx);
  plan.val = static_cast<const uint8_t*>(val);
  plan.acc = static_cast<const uint8_t*>(acc);
  plan.lo = static_cast<const uint8_t*>(lo);
  plan.col_shift = col_shift;
  plan.row_shift = row_shift;
  int blocks = 0;
  for (int p = 0; p < kProbes; ++p) {
    if (!(mask >> p & 1)) continue;
    if (!outs[p] || misaligned(outs[p])) return (int)cudaErrorInvalidValue;
    plan.start[plan.n] = blocks;
    plan.probe[plan.n] = p;
    plan.out[plan.n] = outs[p];
    blocks += (probe_threads(p) + kThreads - 1) / kThreads;
    ++plan.n;
  }
  plan.start[plan.n] = blocks;
  probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(plan);
  return (int)cudaGetLastError();
}
