// Baseline JPEG (ITU-T T.81) decoder -> planar I420.  Self-contained.
//
// The reference delegates every compressed codec to libavcodec inside the
// player process (mpv's video/decode/vd_lavc.c:1157-1388); this
// image ships no ffmpeg, so the rebuild carries its own decoder for the
// one compressed family that is both tractable and ubiquitous in the
// capture/ingest world: Motion-JPEG (baseline DCT, Huffman, 8-bit).
//
// Supported: SOF0/SOF1 frames, interleaved and single-component scans,
// restart intervals (DRI/RSTn), 4:2:0 / 4:2:2 / 4:4:4 / 4:1:1 / grayscale
// sampling, 8- and 16-bit DQT entries, and the table-less AVI "MJPG"
// convention (T.81 Annex K typical Huffman tables are installed when a
// scan references an undefined table -- the same convention libavcodec
// applies).  Progressive (SOF2) and arithmetic coding are rejected with a
// clear error.  Output is always I420 (chroma resampled with box
// averages when the source sampling is not 4:2:0).
//
// All input is treated as hostile: every read is bounds-checked, header
// fields are range-limited, and truncated entropy data pads with zero
// bits (decoded image stays defined; no OOB access).  Fuzzed by
// tests/test_fuzz_parsers.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// T.81 Annex K "typical" Huffman tables (the convention for AVI MJPG
// streams that omit DHT; also what common encoders emit by default).
const uint8_t kBitsDcLum[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0,
                                0, 0, 0};
const uint8_t kValDcLum[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsDcChr[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0,
                                0, 0, 0};
const uint8_t kValDcChr[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsAcLum[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0,
                                0, 1, 0x7d};
const uint8_t kValAcLum[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7,
    0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kBitsAcChr[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0,
                                1, 2, 0x77};
const uint8_t kValAcChr[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15,
    0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
    0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
    0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9,
    0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct JpegError {
  std::string msg;
};

struct HuffTable {
  bool present = false;
  // canonical decode state (T.81 F.2.2.3)
  int32_t mincode[17];
  int32_t maxcode[18];
  int32_t valptr[17];
  uint8_t values[256];
  // single-level fast path: codes of <= 8 bits resolve in one lookup
  int16_t fast[256];  // (len << 8) | value, or -1

  void build(const uint8_t bits[17], const uint8_t* vals, int nvals) {
    if (nvals > 256) throw JpegError{"huffman table overflow"};
    std::memcpy(values, vals, nvals);
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += bits[l];
      k += bits[l];
      maxcode[l] = bits[l] ? code - 1 : -1;
      if (code > (1 << l)) throw JpegError{"overlong huffman code set"};
      code <<= 1;
    }
    if (k != nvals) throw JpegError{"huffman count mismatch"};
    maxcode[17] = 0x7fffffff;
    for (int i = 0; i < 256; ++i) fast[i] = -1;
    code = 0;
    k = 0;
    for (int l = 1; l <= 8; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        int lo = code << (8 - l);
        for (int j = 0; j < (1 << (8 - l)); ++j)
          fast[lo + j] = (int16_t)((l << 8) | values[k]);
      }
      code <<= 1;
    }
    present = true;
  }
};

// Entropy-segment bit reader.  0xFF 0x00 unstuffs to a data 0xFF; any
// other 0xFF <marker> stops the bit stream (the cursor stays ON the
// 0xFF so the caller can consume the marker).  Reads past the end pad
// zero bits -- truncated frames decode to defined values.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t acc = 0;
  int nbits = 0;
  bool at_marker = false;

  BitReader(const uint8_t* p_, const uint8_t* end_) : p(p_), end(end_) {}

  void refill() {
    while (nbits <= 24) {
      if (at_marker || p >= end) {
        acc |= 0;  // zero-pad
        nbits += 8;
        continue;
      }
      uint8_t b = *p;
      if (b == 0xFF) {
        if (p + 1 < end && p[1] == 0x00) {
          p += 2;
        } else {
          at_marker = true;
          continue;  // pad from now on
        }
      } else {
        ++p;
      }
      acc |= (uint32_t)b << (24 - nbits);
      nbits += 8;
    }
  }

  int get(int n) {  // n in [0, 16]
    if (n == 0) return 0;
    if (nbits < n) refill();
    int v = (int)(acc >> (32 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }

  int peek8() {
    if (nbits < 8) refill();
    return (int)(acc >> 24);
  }

  void skip(int n) {
    acc <<= n;
    nbits -= n;
  }

  // position the cursor after a restart marker; returns false if the
  // expected RSTn is absent (stream damage -- caller resyncs blindly)
  bool restart() {
    acc = 0;
    nbits = 0;
    at_marker = false;
    if (p + 1 < end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
      p += 2;
      return true;
    }
    return false;
  }
};

inline int extend(int v, int n) {
  // T.81 F.2.2.1 EXTEND: map the n-bit magnitude to its signed value
  return (n && v < (1 << (n - 1))) ? v - (1 << n) + 1 : v;
}

int decode_huff(BitReader& r, const HuffTable& t) {
  int look = r.peek8();
  int16_t f = t.fast[look];
  if (f >= 0) {
    r.skip(f >> 8);
    return f & 0xff;
  }
  int code = r.get(8);
  for (int l = 9; l <= 16; ++l) {
    code = (code << 1) | r.get(1);
    if (code <= t.maxcode[l])
      return t.values[t.valptr[l] + code - t.mincode[l]];
  }
  throw JpegError{"invalid huffman code"};
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
  int w = 0, hgt = 0;          // true sample dims
  int stride = 0, rows = 0;    // MCU-padded plane dims
  std::vector<uint8_t> plane;
};

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;

  int width = 0, height = 0;
  int ncomp = 0;
  Component comp[4];
  int hmax = 1, vmax = 1;
  uint16_t qtab[4][64] = {};
  bool qtab_ok[4] = {};
  HuffTable hdc[4], hac[4];
  int restart_interval = 0;
  bool frame_seen = false;
  bool scan_done = false;
  float idct_basis[8][8];  // basis[u][x] = C(u)/2 * cos((2x+1) u pi / 16)

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {
    for (int u = 0; u < 8; ++u) {
      double cu = (u == 0) ? std::sqrt(0.5) : 1.0;
      for (int x = 0; x < 8; ++x)
        idct_basis[u][x] =
            (float)(0.5 * cu * std::cos((2 * x + 1) * u * M_PI / 16.0));
    }
  }

  uint8_t u8() {
    if (pos >= len) throw JpegError{"truncated header"};
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  void run() {
    if (len < 2 || u8() != 0xFF || u8() != 0xD8)
      throw JpegError{"not a JPEG (no SOI)"};
    while (pos < len) {
      int b = u8();
      if (b != 0xFF) continue;  // tolerate garbage between segments
      int m;
      do {
        m = u8();
      } while (m == 0xFF && pos < len);
      if (m == 0xD9) break;                      // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM/RSTn
      int seg_len = u16();
      if (seg_len < 2) throw JpegError{"bad segment length"};
      size_t seg_end = pos + (size_t)seg_len - 2;
      if (seg_end > len) throw JpegError{"segment past end of data"};
      switch (m) {
        case 0xC0:
        case 0xC1:
          parse_sof();
          break;
        case 0xC2:
          throw JpegError{"progressive JPEG not supported (baseline only)"};
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          throw JpegError{"unsupported SOF type"};
        case 0xC4:
          parse_dht(seg_end);
          break;
        case 0xDB:
          parse_dqt(seg_end);
          break;
        case 0xDD:
          restart_interval = u16();
          break;
        case 0xDA:
          parse_sos_and_decode();
          if (scan_done) return;  // all components decoded
          break;
        default:
          break;  // APPn / COM / DNL etc.
      }
      if (pos < seg_end) pos = seg_end;
    }
    if (!scan_done) throw JpegError{"no complete scan before EOI"};
  }

  void parse_sof() {
    int prec = u8();
    if (prec != 8) throw JpegError{"only 8-bit samples supported"};
    height = u16();
    width = u16();
    ncomp = u8();
    if (width <= 0 || height <= 0 || width > 32768 || height > 32768)
      throw JpegError{"unreasonable frame dimensions"};
    if (ncomp != 1 && ncomp != 3) throw JpegError{"need 1 or 3 components"};
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = u8();
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4 ||
          comp[i].tq > 3)
        throw JpegError{"bad component sampling/quant spec"};
      hmax = std::max(hmax, comp[i].h);
      vmax = std::max(vmax, comp[i].v);
    }
    // the output copies component 0 as the W x H luma plane: it must be
    // sampled at the frame's full rate (else its plane is smaller)
    if (comp[0].h != hmax || comp[0].v != vmax)
      throw JpegError{"luma is not at the largest sampling factors"};
    // plane allocation (padded to whole MCUs)
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    size_t total = 0;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.w = (width * c.h + hmax - 1) / hmax;
      c.hgt = (height * c.v + vmax - 1) / vmax;
      c.stride = mcux * c.h * 8;
      c.rows = mcuy * c.v * 8;
      total += (size_t)c.stride * c.rows;
      if (total > (size_t)1 << 31) throw JpegError{"frame too large"};
      c.plane.assign((size_t)c.stride * c.rows, 0);
    }
    frame_seen = true;
  }

  void parse_dqt(size_t seg_end) {
    while (pos < seg_end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw JpegError{"bad DQT header"};
      for (int k = 0; k < 64; ++k)
        qtab[tq][k] = pq ? (uint16_t)u16() : u8();
      qtab_ok[tq] = true;
    }
  }

  void parse_dht(size_t seg_end) {
    while (pos < seg_end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw JpegError{"bad DHT header"};
      uint8_t bits[17] = {};
      int nvals = 0;
      for (int l = 1; l <= 16; ++l) {
        bits[l] = u8();
        nvals += bits[l];
      }
      if (nvals > 256 || pos + (size_t)nvals > seg_end)
        throw JpegError{"bad DHT counts"};
      (tc ? hac : hdc)[th].build(bits, data + pos, nvals);
      pos += nvals;
    }
  }

  void ensure_default_tables(int dc_id, int ac_id, bool is_luma) {
    // AVI "MJPG" convention: frames carry no DHT; decoders install the
    // T.81 Annex K typical tables (ff_mjpeg_* in libavcodec does the
    // same).  Installed per referenced id, only when undefined.
    if (!hdc[dc_id].present)
      hdc[dc_id].build(is_luma ? kBitsDcLum : kBitsDcChr,
                       is_luma ? kValDcLum : kValDcChr, 12);
    if (!hac[ac_id].present)
      hac[ac_id].build(is_luma ? kBitsAcLum : kBitsAcChr,
                       is_luma ? kValAcLum : kValAcChr, 162);
  }

  void decode_block(BitReader& r, Component& c, int bx, int by) {
    const uint16_t* qt = qtab[c.tq];
    float blk[64] = {};
    int t = decode_huff(r, hdc[c.dc_tbl]);
    if (t > 15) throw JpegError{"bad DC magnitude"};
    c.pred += extend(r.get(t), t);
    blk[0] = (float)(c.pred * (int)qt[0]);
    const HuffTable& ac = hac[c.ac_tbl];
    uint8_t rowmask = 1;  // bit y set = coefficient row y has nonzeros
    for (int k = 1; k < 64;) {
      int rs = decode_huff(r, ac);
      int run = rs >> 4, s = rs & 15;
      if (s == 0) {
        if (run != 15) break;  // EOB
        k += 16;
        continue;
      }
      k += run;
      if (k > 63) throw JpegError{"AC run past block end"};
      int nat = kZigzag[k];
      blk[nat] = (float)(extend(r.get(s), s) * (int)qt[k]);
      rowmask |= (uint8_t)(1 << (nat >> 3));
      ++k;
    }
    uint8_t* out = c.plane.data() + (size_t)(by * 8) * c.stride + bx * 8;
    if (rowmask == 1 && blk[1] == 0 && blk[2] == 0 && blk[3] == 0 &&
        blk[4] == 0 && blk[5] == 0 && blk[6] == 0 && blk[7] == 0) {
      // DC-only block (very common after quantization): flat output
      int v = (int)std::lrintf(blk[0] * 0.125f) + 128;
      uint8_t q8 = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
      for (int y = 0; y < 8; ++y)
        std::memset(out + (size_t)y * c.stride, q8, 8);
      return;
    }
    // separable 2-D IDCT: rows then columns against the cosine basis,
    // skipping all-zero coefficient rows (most of a quantized block)
    float tmp[64];
    float acc[64] = {};
    for (int u = 0; u < 8; ++u) {
      if (!(rowmask & (1 << u))) continue;
      const float* in = blk + u * 8;
      float* trow = tmp + u * 8;
      for (int x = 0; x < 8; ++x) {
        float s2 = 0;
        for (int k = 0; k < 8; ++k) s2 += idct_basis[k][x] * in[k];
        trow[x] = s2;
      }
      // fold this coefficient row into every output row (linear access)
      const float* brow = idct_basis[u];
      for (int y = 0; y < 8; ++y) {
        float b = brow[y];
        float* arow = acc + y * 8;
        for (int x = 0; x < 8; ++x) arow[x] += b * trow[x];
      }
    }
    for (int y = 0; y < 8; ++y) {
      uint8_t* orow = out + (size_t)y * c.stride;
      const float* arow = acc + y * 8;
      for (int x = 0; x < 8; ++x) {
        int v = (int)std::lrintf(arow[x]) + 128;
        orow[x] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
      }
    }
  }

  void parse_sos_and_decode() {
    if (!frame_seen) throw JpegError{"SOS before SOF"};
    int ns = u8();
    if (ns < 1 || ns > ncomp) throw JpegError{"bad scan component count"};
    int scomp[4];
    for (int i = 0; i < ns; ++i) {
      int cs = u8();
      int tables = u8();
      int found = -1;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cs) found = j;
      if (found < 0) throw JpegError{"scan names unknown component"};
      scomp[i] = found;
      comp[found].dc_tbl = tables >> 4;
      comp[found].ac_tbl = tables & 15;
      if (comp[found].dc_tbl > 3 || comp[found].ac_tbl > 3)
        throw JpegError{"bad scan table ids"};
      if (!qtab_ok[comp[found].tq])
        throw JpegError{"component references undefined quant table"};
      ensure_default_tables(comp[found].dc_tbl, comp[found].ac_tbl,
                            found == 0);
    }
    u8();  // Ss
    u8();  // Se
    u8();  // Ah/Al
    for (int i = 0; i < ns; ++i) comp[scomp[i]].pred = 0;

    BitReader r(data + pos, data + len);
    int mcux, mcuy;
    if (ns == 1) {
      // non-interleaved: MCU = one block of that component
      Component& c = comp[scomp[0]];
      mcux = (c.w + 7) / 8;
      mcuy = (c.hgt + 7) / 8;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    }
    int togo = restart_interval;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart_interval && togo == 0) {
          if (!r.restart()) {
            // damaged stream: resync by scanning forward for any RSTn
            while (r.p + 1 < r.end &&
                   !(r.p[0] == 0xFF && r.p[1] >= 0xD0 && r.p[1] <= 0xD7))
              ++r.p;
            r.restart();
          }
          for (int i = 0; i < ns; ++i) comp[scomp[i]].pred = 0;
          togo = restart_interval;
        }
        if (restart_interval) --togo;
        if (ns == 1) {
          decode_block(r, comp[scomp[0]], mx, my);
        } else {
          for (int i = 0; i < ns; ++i) {
            Component& c = comp[scomp[i]];
            for (int by = 0; by < c.v; ++by)
              for (int bx = 0; bx < c.h; ++bx)
                decode_block(r, c, mx * c.h + bx, my * c.v + by);
          }
        }
      }
    }
    // advance the header cursor past the entropy data
    pos = (size_t)(r.p - data);
    if (r.at_marker && pos + 1 < len && data[pos] == 0xFF &&
        data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)
      pos += 2;  // trailing restart marker
    if (ns == ncomp) scan_done = true;
  }
};

// Box-resample an arbitrary-sampled chroma plane to the I420 grid
// (ceil(w/2) x ceil(h/2)).  Integer source boxes; exact for the common
// 4:2:0 (copy), 4:2:2 (vertical pair average), and 4:4:4 (2x2 average).
void resample_chroma(const Component& c, int W, int H, uint8_t* out) {
  int dw = (W + 1) / 2, dh = (H + 1) / 2;
  // source region covering each dest sample, in c-plane coordinates:
  // dest grid is the full-res grid downsampled by 2
  for (int dy = 0; dy < dh; ++dy) {
    // full-res rows [2dy, 2dy+2) -> c rows scaled by c.hgt / H
    int y0 = (int)((int64_t)(2 * dy) * c.hgt / H);
    int y1 = (int)(((int64_t)(2 * dy + 2) * c.hgt + H - 1) / H);
    if (y1 <= y0) y1 = y0 + 1;
    if (y1 > c.hgt) y1 = c.hgt;
    if (y0 >= c.hgt) y0 = c.hgt - 1;
    for (int dx = 0; dx < dw; ++dx) {
      int x0 = (int)((int64_t)(2 * dx) * c.w / W);
      int x1 = (int)(((int64_t)(2 * dx + 2) * c.w + W - 1) / W);
      if (x1 <= x0) x1 = x0 + 1;
      if (x1 > c.w) x1 = c.w;
      if (x0 >= c.w) x0 = c.w - 1;
      int sum = 0, n = 0;
      for (int y = y0; y < y1 && y >= 0; ++y)
        for (int x = x0; x < x1 && x >= 0; ++x, ++n)
          sum += c.plane[(size_t)y * c.stride + x];
      out[(size_t)dy * dw + dx] = (uint8_t)(n ? (sum + n / 2) / n : 128);
    }
  }
}

}  // namespace

// decode_jpeg(data: bytes) -> (width, height, y: bytes, u: bytes, v: bytes)
// I420 output: y is width*height, u/v are ceil(w/2)*ceil(h/2).
extern "C" PyObject* mfi_decode_jpeg(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  std::string err;
  int W = 0, H = 0;
  std::vector<uint8_t> yout, uout, vout;
  Py_BEGIN_ALLOW_THREADS;
  try {
    Decoder d((const uint8_t*)buf.buf, (size_t)buf.len);
    d.run();
    W = d.width;
    H = d.height;
    yout.resize((size_t)W * H);
    const Component& cy = d.comp[0];
    for (int y = 0; y < H; ++y)
      std::memcpy(yout.data() + (size_t)y * W,
                  cy.plane.data() + (size_t)y * cy.stride, W);
    int dw = (W + 1) / 2, dh = (H + 1) / 2;
    uout.resize((size_t)dw * dh, 128);
    vout.resize((size_t)dw * dh, 128);
    if (d.ncomp == 3) {
      resample_chroma(d.comp[1], W, H, uout.data());
      resample_chroma(d.comp[2], W, H, vout.data());
    }
  } catch (const JpegError& e) {
    err = e.msg;
  } catch (const std::bad_alloc&) {
    err = "out of memory";
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  if (!err.empty()) {
    PyErr_SetString(PyExc_ValueError, err.c_str());
    return nullptr;
  }
  return Py_BuildValue("iiy#y#y#", W, H, (const char*)yout.data(),
                       (Py_ssize_t)yout.size(), (const char*)uout.data(),
                       (Py_ssize_t)uout.size(), (const char*)vout.data(),
                       (Py_ssize_t)vout.size());
}
