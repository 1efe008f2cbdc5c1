// V1, V2 and V3: the debug views of output modes 5/6 (side by side), 3 (the
// HSV flow view) and 4 (the grey flow view), for Hopper (sm_90a): V1 and V2
// one launch a blend position, V3 one launch a pair, each covering luma and
// interleaved chroma.
//
// Not TPU kernels: they replace XLA code of the JAX package, which the port
// ran as tensor ops (~1,450 launches and 29-32 ms a 4K pair in modes 5/6,
// ~25 ms of float colour passes in mode 3).
//
// V1 (mfi_warp_sbs) computes ops/warp.warp_sbs of the port, JAX ops/warp.py
// :1178 _warp_sbs (the reference's warpFrameKernel.cl:131-148).  Per output
// sample (cx, cy) of a plane (cz = 0 luma, 1 chroma; rows = H >> cz; W the
// source pitch, Wa the picture's width):
//   * mode 5: columns below Wa >> 1 copy f1 at (cy, cx);
//   * mode 6: with top = (H >> 2) >> cz and the band of rows [top, top +
//     (H >> (1 + cz))), the band's left part (cx < W >> 1: the STRIDE)
//     copies f1 at (clip(2 (cy - top)), clip(2 cx + (cx & 1 if chroma)))
//     (chroma's column then (x & ~1) + (cx & 1)), the band's right part
//     (W >> 1 <= cx < W) is warped at the adjusted coordinate (2 (cx - (Wa
//     >> 1)), 2 (cy - top)), and outside the band luma is 0 and chroma 128
//     << ss; copied and filled samples take no level map;
//   * every other sample is the nearest blend of mode 2 at the adjusted
//     coordinate (cx', cy'): the flow at cx', cy''s low-res cell and the
//     reverse flow read back through it (flow_at), the two rounded
//     displacements (dir_displacement; chroma's vertical one halved), the
//     sources at mirror_edge2 of cx' + dx over Wa and of cy' + dy over rows,
//     chroma's u/v column taking the parity of the OUTPUT column, (x' & ~1)
//     + (cx & 1) -- in mode 6 cx' is always even, so sample_dir_pixel, which
//     takes both from one column, does not serve -- then blend_fix and the
//     level maps.
//
// V2 (mfi_warp_hsv) is all of mode 3 at one position, JAX ops/warp.py:785
// _visualize_flow inside the HSV branches of _warp_sample (:1054-1058,
// :1164-1173): per output sample the two raw nearest samples of mode 2
// (flow_at, dir_displacement, sample_dir_pixel), their blend_fix with no
// level map, then the colours of the negated flow at the sample's own cell
// (the forward flow flow_cell reads) on the blend >> ss, channel 0 for luma
// and 1 + (cx & 1) for chroma, the magnitude gain 4 at rs <= 2 (else 1),
// << ss, and the configured level maps.  The colours are float32 in the JAX
// op order, each operation rounded once (__fmul_rn, __fadd_rn, __fdiv_rn,
// and the library is built with --fmad=false); atan2f is the one function
// whose last bit may differ from the CPU's, so V2 is held to DEVIATIONS
// #11's HSV tolerance and the rest of it is exact.  The blend is not capped
// before the colours: they read it >> ss, where the cap at 255 << ss the
// default levels apply cannot be seen (a P010 blend of 65535 reads 255
// either way).
//
// V3 (mfi_warp_grey) is mode 4, ops/warp.grey_planes of the port, JAX
// ops/warp.py:945-951 (GREY_FLOW in _warp_sample): it samples nothing and
// reads no blend position, so one launch serves every output of the pair
// (the engine hands the same planes to each).  Luma is min((|ox| + |oy|)
// << 2, 255) << ss with (ox, oy) the flow at the sample's low-res cell
// (cy >> rs, cx >> rs), clamped to the field (upsample_y); chroma is 128
// << ss; no level map.  The int32 arithmetic wraps as the plain version's
// does (unsigned adds and shifts, a signed clamp, a truncating store).
// What bounds it: its writes, a plane pair of (H + H / 2) x Wa samples
// (12.4 MB at 4K, 8 bits) against ~1 MB of flow read: ~3.7 us at 3.35
// TB/s.  Each thread writes one 16-byte run of the flat output (16 uint8
// or 8 uint16 samples; the planes come from torch.empty, so their base is
// aligned), with a streaming store; the last run of a plane, when the
// plane's bytes are not a multiple of 16, is written a sample at a time.
//
// One thread an output sample: a block of 64 x 4 threads, the luma block
// rows first and then the chroma ones, so that the branch on the plane is
// uniform per block (as warp_runs.cuh's two_plane_grid).  t is read on the
// device, so a launch can be captured in a CUDA graph.  What bounds them:
// bytes (one output plane pair written, up to two source reads a sample and
// the flow), ~11 us at 8 bits at 4K; V2's colours are ~100 scalar
// operations a sample with atan2f.

#include "warp_common.cuh"

namespace {

constexpr int kVX = 64, kVY = 4;

// Host: the grid of one launch over H luma rows and H / 2 chroma rows of
// Wa samples, the luma block rows first (*luma_blocks of them).
dim3 view_grid(int H, int Wa, int* luma_blocks) {
  *luma_blocks = (H + kVY - 1) / kVY;
  return dim3((Wa + kVX - 1) / kVX, *luma_blocks + (H / 2 + kVY - 1) / kVY);
}

// One source sample at mirror_edge2 of (y + dy, x + dx); chroma's column
// addressed as (x' & ~1) + (cx & 1), with the parity of the OUTPUT column
// cx.
template <typename T, bool kChroma>
__device__ __forceinline__ unsigned sample_at(const T* __restrict__ src,
                                              int pitch, int rows, int Wa,
                                              int x, int y, int cx, int dx,
                                              int dy) {
  int xs = mfi::mirror_edge2(x + dx, Wa);
  const int ys = mfi::mirror_edge2(y + dy, rows);
  if (kChroma) xs = (xs & ~1) + (cx & 1);
  return src[(size_t)ys * pitch + xs];
}

template <typename T, int kMode, bool kChroma>
__device__ __forceinline__ T sbs_sample(const T* __restrict__ f1,
                                        const T* __restrict__ f2,
                                        const int* __restrict__ blurred,
                                        int H, int Wa, int pitch, int lh,
                                        int lw, int rs, int cx, int cy,
                                        float t, float fs21, unsigned tw,
                                        int ss, const mfi::Levels& lv) {
  constexpr int cz = kChroma ? 1 : 0;
  const int rows = H >> cz;
  int ax = cx, ay = cy;
  if (kMode == 5) {
    if (cx < (Wa >> 1)) return f1[(size_t)cy * pitch + cx];
  } else {
    const int top = (H >> 2) >> cz;
    const bool in_rows = cy >= top && cy < top + (H >> (1 + cz));
    const int half = pitch >> 1;
    if (!(in_rows && cx >= half && cx < pitch)) {
      if (!(in_rows && cx < half)) return (T)(kChroma ? 128 << ss : 0);
      const int ly = min(max((cy - top) * 2, 0), rows - 1);
      int lx = min(max(cx * 2 + (kChroma ? (cx & 1) : 0), 0), pitch - 1);
      if (kChroma) lx = (lx & ~1) + (cx & 1);
      return f1[(size_t)ly * pitch + lx];
    }
    ax = (cx - (Wa >> 1)) * 2;
    ay = (cy - top) * 2;
  }
  float fx12, fy12, fx21, fy21;
  mfi::flow_at<kChroma>(blurred, ax, ay, lh, lw, rs, &fx12, &fy12, &fx21,
                        &fy21);
  int dx12, dy12, dx21, dy21;
  mfi::dir_displacement<kChroma>(fx12, fy12, t, false, &dx12, &dy12);
  mfi::dir_displacement<kChroma>(fx21, fy21, fs21, true, &dx21, &dy21);
  const unsigned s12 =
      sample_at<T, kChroma>(f1, pitch, rows, Wa, ax, ay, cx, dx12, dy12);
  const unsigned s21 =
      sample_at<T, kChroma>(f2, pitch, rows, Wa, ax, ay, cx, dx21, dy21);
  const unsigned b = mfi::blend_fix(s12, s21, tw, ss ? 16 : 24);
  return (T)(kChroma ? mfi::levels_uv(b, ss, lv) : mfi::levels_y(b, ss, lv));
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kVX * kVY) warp_sbs_kernel(
    const T* __restrict__ f1y, const T* __restrict__ f1uv,
    const T* __restrict__ f2y, const T* __restrict__ f2uv,
    const int* __restrict__ blurred, const float* __restrict__ t,
    T* __restrict__ out_y, T* __restrict__ out_uv, int H, int Wa, int pitch,
    int lh, int lw, int rs, int luma_blocks, int ss, mfi::Levels lv) {
  const bool chroma = (int)blockIdx.y >= luma_blocks;
  const int cx = blockIdx.x * kVX + threadIdx.x;
  const int cy = (chroma ? blockIdx.y - luma_blocks : blockIdx.y) * kVY +
                 threadIdx.y;
  if (cx >= Wa || cy >= (chroma ? H / 2 : H)) return;
  const float t12 = *t;
  const float fs21 = __fsub_rn(1.0f, t12);
  const unsigned tw = mfi::blend_weight(t12, ss ? 16 : 24);
  if (chroma)
    out_uv[(size_t)cy * Wa + cx] = sbs_sample<T, kMode, true>(
        f1uv, f2uv, blurred, H, Wa, pitch, lh, lw, rs, cx, cy, t12, fs21, tw,
        ss, lv);
  else
    out_y[(size_t)cy * Wa + cx] = sbs_sample<T, kMode, false>(
        f1y, f2y, blurred, H, Wa, pitch, lh, lw, rs, cx, cy, t12, fs21, tw,
        ss, lv);
}

// visualize_flow (ops/warp.py of the port): the colour of channel `channel`
// (0 Y, 1 U, 2 V) of the flow (off_x, off_y) over the blended sample curr8
// on the 8-bit scale, in [0, 255].
__device__ __forceinline__ int hsv_colour(int off_x, int off_y, int curr8,
                                          int channel, float gain) {
  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (off_x != 0 || off_y != 0) {
    const float fx = (float)off_x, fy = (float)off_y;
    constexpr float kDeg = (float)(180.0 / 3.14159265358979323846);
    float angle = __fmul_rn(atan2f(fy, fx), kDeg);
    if (angle < 0.0f) angle = __fadd_rn(angle, 360.0f);
    if (angle >= 360.0f) angle = __fsub_rn(angle, 360.0f);
    const float h6 = __fmul_rn(__fdiv_rn(angle, 360.0f), 6.0f);
    const int h_i = (int)h6;  // toward zero, as the JAX int32 cast
    const float f = __fsub_rn(h6, (float)h_i);
    const float f255 = truncf(__fmul_rn(f, 255.0f));
    const float q255 = truncf(__fmul_rn(__fsub_rn(1.0f, f), 255.0f));
    switch (((h_i % 6) + 6) % 6) {
      case 0: r = 255.0f; g = f255;   b = 0.0f;   break;
      case 1: r = q255;   g = 255.0f; b = 0.0f;   break;
      case 2: r = 0.0f;   g = 255.0f; b = f255;   break;
      case 3: r = 0.0f;   g = q255;   b = 255.0f; break;
      case 4: r = f255;   g = 0.0f;   b = 255.0f; break;
      default: r = 255.0f; g = 0.0f;  b = q255;   break;
    }
    const float ay = fabsf(fy);
    const float mag = __fmul_rn(__fadd_rn(fabsf(fx), ay), gain);
    r = truncf(fminf(fmaxf(__fmul_rn(__fdiv_rn(r, 255.0f), mag), 0.0f),
                     255.0f));
    g = truncf(fminf(fmaxf(__fmul_rn(__fmul_rn(__fmul_rn(
                                         __fdiv_rn(g, 255.0f), ay), 2.0f),
                                     gain), 0.0f), 255.0f));
    b = truncf(fminf(fmaxf(__fmul_rn(__fdiv_rn(b, 255.0f), mag), 0.0f),
                     255.0f));
  }
  float c;
  if (channel == 0)
    c = __fadd_rn(__fadd_rn(__fmul_rn(r, 0.299f), __fmul_rn(g, 0.587f)),
                  __fmul_rn(b, 0.114f));
  else if (channel == 1)
    c = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r, -0.168736f),
                                      __fmul_rn(g, -0.331264f)),
                            __fmul_rn(b, 0.5f)), 128.0f);
  else
    c = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r, 0.5f),
                                      __fmul_rn(g, -0.418688f)),
                            __fmul_rn(b, -0.081312f)), 128.0f);
  const int v = (int)truncf(fminf(fmaxf(c, 0.0f), 255.0f));
  return channel == 0 ? (v >> 1) + (curr8 >> 1) : v;
}

template <typename T, bool kChroma>
__device__ __forceinline__ T hsv_sample(const T* __restrict__ f1,
                                        const T* __restrict__ f2,
                                        const int* __restrict__ blurred,
                                        int rows, int Wa, int pitch, int lh,
                                        int lw, int rs, int cx, int cy,
                                        float t, float fs21, unsigned tw,
                                        int ss, const mfi::Levels& lv) {
  float fx12, fy12, fx21, fy21;
  mfi::flow_at<kChroma>(blurred, cx, cy, lh, lw, rs, &fx12, &fy12, &fx21,
                        &fy21);
  int dx12, dy12, dx21, dy21;
  mfi::dir_displacement<kChroma>(fx12, fy12, t, false, &dx12, &dy12);
  mfi::dir_displacement<kChroma>(fx21, fy21, fs21, true, &dx21, &dy21);
  const unsigned s12 = mfi::sample_dir_pixel<T, kChroma>(f1, pitch, rows, Wa,
                                                         cx, cy, dx12, dy12);
  const unsigned s21 = mfi::sample_dir_pixel<T, kChroma>(f2, pitch, rows, Wa,
                                                         cx, cy, dx21, dy21);
  const unsigned b = mfi::blend_fix(s12, s21, tw, ss ? 16 : 24);
  // the flow is an int32 field, exact in float: negate it as an int, so
  // that a zero component is +0 for atan2f
  const int c = hsv_colour(-(int)fx12, -(int)fy12, (int)(b >> ss),
                           kChroma ? 1 + (cx & 1) : 0, rs <= 2 ? 4.0f : 1.0f);
  const unsigned v = (unsigned)c << ss;
  return (T)(kChroma ? mfi::levels_uv(v, ss, lv) : mfi::levels_y(v, ss, lv));
}

template <typename T>
__global__ void __launch_bounds__(kVX * kVY) warp_hsv_kernel(
    const T* __restrict__ f1y, const T* __restrict__ f1uv,
    const T* __restrict__ f2y, const T* __restrict__ f2uv,
    const int* __restrict__ blurred, const float* __restrict__ t,
    T* __restrict__ out_y, T* __restrict__ out_uv, int H, int Wa, int pitch,
    int lh, int lw, int rs, int luma_blocks, int ss, mfi::Levels lv) {
  const bool chroma = (int)blockIdx.y >= luma_blocks;
  const int cx = blockIdx.x * kVX + threadIdx.x;
  const int cy = (chroma ? blockIdx.y - luma_blocks : blockIdx.y) * kVY +
                 threadIdx.y;
  const int rows = chroma ? H / 2 : H;
  if (cx >= Wa || cy >= rows) return;
  const float t12 = *t;
  const float fs21 = __fsub_rn(1.0f, t12);
  const unsigned tw = mfi::blend_weight(t12, ss ? 16 : 24);
  if (chroma)
    out_uv[(size_t)cy * Wa + cx] = hsv_sample<T, true>(
        f1uv, f2uv, blurred, rows, Wa, pitch, lh, lw, rs, cx, cy, t12, fs21,
        tw, ss, lv);
  else
    out_y[(size_t)cy * Wa + cx] = hsv_sample<T, false>(
        f1y, f2y, blurred, rows, Wa, pitch, lh, lw, rs, cx, cy, t12, fs21,
        tw, ss, lv);
}

template <typename T>
int launch_sbs(int mode, const void* f1y, const void* f1uv, const void* f2y,
               const void* f2uv, const void* blurred, const void* t,
               void* out_y, void* out_uv, int H, int Wa, int pitch, int lh,
               int lw, int rs, int ss, int k, int w, cudaStream_t s) {
  int luma_blocks;
  const dim3 grid = view_grid(H, Wa, &luma_blocks);
  const auto kernel =
      mode == 5 ? &warp_sbs_kernel<T, 5> : &warp_sbs_kernel<T, 6>;
  kernel<<<grid, dim3(kVX, kVY), 0, s>>>(
      static_cast<const T*>(f1y), static_cast<const T*>(f1uv),
      static_cast<const T*>(f2y), static_cast<const T*>(f2uv),
      static_cast<const int*>(blurred), static_cast<const float*>(t),
      static_cast<T*>(out_y), static_cast<T*>(out_uv), H, Wa, pitch, lh, lw,
      rs, luma_blocks, ss, mfi::levels(k, w));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hsv(const void* f1y, const void* f1uv, const void* f2y,
               const void* f2uv, const void* blurred, const void* t,
               void* out_y, void* out_uv, int H, int Wa, int pitch, int lh,
               int lw, int rs, int ss, int k, int w, cudaStream_t s) {
  int luma_blocks;
  const dim3 grid = view_grid(H, Wa, &luma_blocks);
  warp_hsv_kernel<T><<<grid, dim3(kVX, kVY), 0, s>>>(
      static_cast<const T*>(f1y), static_cast<const T*>(f1uv),
      static_cast<const T*>(f2y), static_cast<const T*>(f2uv),
      static_cast<const int*>(blurred), static_cast<const float*>(t),
      static_cast<T*>(out_y), static_cast<T*>(out_uv), H, Wa, pitch, lh, lw,
      rs, luma_blocks, ss, mfi::levels(k, w));
  return (int)cudaGetLastError();
}

constexpr int kGreyThreads = 256;

// The grey value of the flow at low-res cell `at`: its magnitude, in int32
// arithmetic as the plain version's.
template <typename T>
__device__ __forceinline__ T grey_at(const int* __restrict__ blurred,
                                     size_t plane, size_t at, int ss) {
  const int ox = __ldg(blurred + at), oy = __ldg(blurred + plane + at);
  const unsigned ax = ox < 0 ? 0u - (unsigned)ox : (unsigned)ox;
  const unsigned ay = oy < 0 ? 0u - (unsigned)oy : (unsigned)oy;
  const int g = min((int)((ax + ay) << 2), 255);
  return (T)((unsigned)g << ss);
}

// Thread j writes run j of the luma plane's (H x Wa samples, flat) runs of
// kPer samples, then, past them, of the chroma plane's ((H / 2) x Wa).
template <typename T>
__global__ void __launch_bounds__(kGreyThreads) warp_grey_kernel(
    const int* __restrict__ blurred, T* __restrict__ out_y,
    T* __restrict__ out_uv, int H, int Wa, int lh, int lw, int rs, int ss,
    long long luma_runs, long long runs) {
  constexpr int kPer = 16 / sizeof(T);
  const long long j = (long long)blockIdx.x * kGreyThreads + threadIdx.x;
  if (j >= runs) return;
  const bool chroma = j >= luma_runs;
  const long long total = (long long)(chroma ? H / 2 : H) * Wa;
  const long long first = (chroma ? j - luma_runs : j) * kPer;
  const int count = (int)min((long long)kPer, total - first);
  T* out = (chroma ? out_uv : out_y) + first;
  __align__(16) T vals[kPer];
  if (chroma) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) vals[k] = (T)(128u << ss);
  } else {
    // a run spans a few cells (2 at 4K, 8 bits): each cell's flow is read
    // once
    const size_t plane = (size_t)lh * lw;
    int cy = (int)(first / Wa), cx = (int)(first - (long long)cy * Wa);
    size_t last = ~(size_t)0;
    T g = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const size_t at =
          (size_t)min(cy >> rs, lh - 1) * lw + min(cx >> rs, lw - 1);
      if (at != last) {
        g = grey_at<T>(blurred, plane, at, ss);
        last = at;
      }
      vals[k] = g;
      if (++cx == Wa) {
        cx = 0;
        ++cy;
      }
    }
  }
  if (count == kPer) {
    __stcs(reinterpret_cast<uint4*>(out),
           *reinterpret_cast<const uint4*>(vals));
  } else {
    for (int k = 0; k < count; ++k) out[k] = vals[k];
  }
}

template <typename T>
int launch_grey(const void* blurred, void* out_y, void* out_uv, int H,
                int Wa, int lh, int lw, int rs, int ss, cudaStream_t s) {
  constexpr int kPer = 16 / sizeof(T);
  const long long luma_runs = ((long long)H * Wa + kPer - 1) / kPer;
  const long long runs =
      luma_runs + ((long long)(H / 2) * Wa + kPer - 1) / kPer;
  const long long blocks = (runs + kGreyThreads - 1) / kGreyThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  warp_grey_kernel<T><<<(unsigned)blocks, kGreyThreads, 0, s>>>(
      static_cast<const int*>(blurred), static_cast<T*>(out_y),
      static_cast<T*>(out_uv), H, Wa, lh, lw, rs, ss, luma_runs, runs);
  return (int)cudaGetLastError();
}

bool bad_shape(int H, int Wa, int pitch, int lh, int lw, int ss) {
  return H < 2 || Wa < 3 || pitch < Wa || lh < 1 || lw < 1 ||
         (ss != 0 && ss != 8);
}

}  // namespace

// f1y, f2y (H, pitch) and f1uv, f2uv (H/2, pitch) interleaved, uint8 when
// ss == 0 and uint16 when ss == 8; blurred (2, lh, lw) int32; t one float on
// the device; out_y (H, Wa), out_uv (H/2, Wa); mode 5 or 6; (k, w) the
// levels.
extern "C" int mfi_warp_sbs(const void* f1y, const void* f1uv,
                            const void* f2y, const void* f2uv,
                            const void* blurred, const void* t, void* out_y,
                            void* out_uv, int mode, int H, int Wa, int pitch,
                            int lh, int lw, int rs, int ss, int k, int w,
                            void* stream) {
  if ((mode != 5 && mode != 6) || bad_shape(H, Wa, pitch, lh, lw, ss))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = ss ? &launch_sbs<uint16_t> : &launch_sbs<uint8_t>;
  return go(mode, f1y, f1uv, f2y, f2uv, blurred, t, out_y, out_uv, H, Wa,
            pitch, lh, lw, rs, ss, k, w, s);
}

// As mfi_warp_sbs, for mode 3 (no mode argument).
extern "C" int mfi_warp_hsv(const void* f1y, const void* f1uv,
                            const void* f2y, const void* f2uv,
                            const void* blurred, const void* t, void* out_y,
                            void* out_uv, int H, int Wa, int pitch, int lh,
                            int lw, int rs, int ss, int k, int w,
                            void* stream) {
  if (bad_shape(H, Wa, pitch, lh, lw, ss)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = ss ? &launch_hsv<uint16_t> : &launch_hsv<uint8_t>;
  return go(f1y, f1uv, f2y, f2uv, blurred, t, out_y, out_uv, H, Wa, pitch,
            lh, lw, rs, ss, k, w, s);
}

// blurred (2, lh, lw) int32; out_y (H, Wa) and out_uv (H/2, Wa), uint8 when
// ss == 0 and uint16 when ss == 8, each 16-byte aligned (torch.empty); rs
// the res scalar.
extern "C" int mfi_warp_grey(const void* blurred, void* out_y, void* out_uv,
                             int H, int Wa, int lh, int lw, int rs, int ss,
                             void* stream) {
  if (H < 2 || Wa < 1 || lh < 1 || lw < 1 || rs < 0 || rs > 30 ||
      (ss != 0 && ss != 8) ||
      (reinterpret_cast<uintptr_t>(out_y) |
       reinterpret_cast<uintptr_t>(out_uv)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = ss ? &launch_grey<uint16_t> : &launch_grey<uint8_t>;
  return go(blurred, out_y, out_uv, H, Wa, lh, lw, rs, ss, s);
}
