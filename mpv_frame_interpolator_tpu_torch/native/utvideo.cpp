// Ut Video (lossless YUV) decoder -- native hot path for the ingest
// thread.  Format layout + semantics documented in io/utvideo.py (the
// pure-Python oracle this file is tested bit-exact against,
// tests/test_utvideo.py).  The reference plays Ut Video via libavcodec
// (video/decode/vd_lavc.c:1157-1388); this is a from-scratch
// implementation: canonical Huffman per plane (lengths table, codes
// assigned longest-first), per-plane slice offset tables, MSB-first
// bits in 32-bit little-endian words, left/gradient/median prediction
// restored per slice, frame_info dword at the packet tail.
//
// Exposed as _mfi_native.decode_utvideo(data, fourcc, width, height,
// slices) -> (y, u, v) bytes (I420/I422 planes).  Raises ValueError on
// any malformed input; fuzz-driven in tests/test_utvideo.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct UtError : std::runtime_error {
  explicit UtError(const std::string& m) : std::runtime_error(m) {}
};

// ------------------------------------------------------------------ //
// canonical Huffman table (mirrors io/utvideo.py:_huff_assign)

struct Huff {
  int fsym = -1;                     // single-symbol plane marker
  // per length L (1..32): first canonical code value and symbol range
  uint32_t first_code[33] = {0};
  int first_index[33] = {0};
  int count[33] = {0};
  uint8_t syms[256] = {0};           // in assignment order
  int max_len = 0;
  // fast path: 12-bit prefix LUT for codes with len <= 12
  static constexpr int kLut = 12;
  uint16_t lut_sym[1 << kLut];
  uint8_t lut_len[1 << kLut];        // 0 = miss (long code)

  void build(const uint8_t* lens) {
    int order[256];
    for (int i = 0; i < 256; i++) order[i] = i;
    std::stable_sort(order, order + 256, [&](int a, int b) {
      return lens[a] != lens[b] ? lens[a] < lens[b] : a < b;
    });
    if (lens[order[0]] == 0) {
      fsym = order[0];
      return;
    }
    int last = 255;
    while (last > 0 && lens[order[last]] == 255) last--;
    uint64_t code = 0;
    // assignment order: longest codes first (reverse of sorted order)
    int n = 0;
    for (int k = last; k >= 0; k--) {
      int s = order[k];
      int ln = lens[s];
      if (ln < 1 || ln > 32) throw UtError("invalid Huffman length");
      syms[n] = (uint8_t)s;
      uint32_t c = (uint32_t)(code >> (32 - ln));
      if (count[ln] == 0) {
        first_code[ln] = c;
        first_index[ln] = n;
      }
      count[ln]++;
      max_len = std::max(max_len, ln);
      code += 0x80000000ull >> (ln - 1);
      if (code > 0x100000000ull) throw UtError("oversubscribed table");
      n++;
    }
    std::memset(lut_len, 0, sizeof(lut_len));
    for (int ln = 1; ln <= std::min(max_len, kLut); ln++) {
      for (int i = 0; i < count[ln]; i++) {
        uint32_t c = first_code[ln] + i;
        uint32_t lo = c << (kLut - ln);
        uint32_t hi = (c + 1) << (kLut - ln);
        for (uint32_t p = lo; p < hi; p++) {
          lut_sym[p] = syms[first_index[ln] + i];
          lut_len[p] = (uint8_t)ln;
        }
      }
    }
  }
};

// ------------------------------------------------------------------ //
// bit reader: MSB-first within 32-bit little-endian words

struct BitReader {
  std::vector<uint32_t> words;       // already byteswapped to host-msb
  size_t pos = 0;                    // bit position
  size_t limit = 0;

  void init(const uint8_t* data, size_t len) {
    size_t nwords = (len + 3) / 4;
    words.assign(nwords + 1, 0);     // +1 pad word for 64-bit peeks
    for (size_t i = 0; i < nwords; i++) {
      uint32_t w = 0;
      size_t base = i * 4;
      for (size_t b = 0; b < 4; b++) {
        uint8_t v = base + b < len ? data[base + b] : 0;
        w |= (uint32_t)v << (8 * b);  // little-endian load
      }
      words[i] = w;
    }
    pos = 0;
    limit = nwords * 32;
  }

  inline uint32_t peek32() const {
    size_t w = pos >> 5, off = pos & 31;
    uint64_t v = ((uint64_t)words[w] << 32) |
                 (w + 1 < words.size() ? words[w + 1] : 0);
    return (uint32_t)(v >> (32 - off));
  }

  inline void skip(int n) { pos += n; }
  inline bool overrun() const { return pos > limit; }
};

// ------------------------------------------------------------------ //

inline int mid_pred(int a, int b, int c) {
  int mn = std::min(a, b), mx = std::max(a, b);
  return std::min(std::max(mn, c), mx);
}

struct SliceRows {
  int sstart, send;
};

std::vector<SliceRows> slice_rows(int height, int slices) {
  std::vector<SliceRows> out;
  int send = 0;
  for (int s = 0; s < slices; s++) {
    int sstart = send;
    send = (int)(((int64_t)height * (s + 1)) / slices);
    out.push_back({sstart, send});
  }
  return out;
}

// decode one plane into dst (w*h), advancing *pos through the packet
void decode_plane(const uint8_t* body, size_t body_len, size_t* pos,
                  uint8_t* dst, int w, int h, int slices, int pred) {
  if (*pos + 256 > body_len) throw UtError("truncated length table");
  Huff hf;
  hf.build(body + *pos);
  *pos += 256;

  auto rows = slice_rows(h, slices);
  std::vector<uint8_t> res((size_t)w * h);

  if (hf.fsym >= 0) {
    std::memset(res.data(), hf.fsym, res.size());
  } else {
    if (*pos + 4ull * slices > body_len)
      throw UtError("truncated slice table");
    std::vector<uint32_t> ends(slices);
    for (int s = 0; s < slices; s++) {
      uint32_t e;
      std::memcpy(&e, body + *pos + 4ull * s, 4);
      ends[s] = e;                   // little-endian hosts only (x86/arm)
    }
    *pos += 4ull * slices;
    size_t dstart = *pos;
    uint32_t prevend = 0;
    BitReader br;
    for (int s = 0; s < slices; s++) {
      if (ends[s] < prevend || dstart + ends[s] > body_len)
        throw UtError("bad slice offsets");
      br.init(body + dstart + prevend, ends[s] - prevend);
      prevend = ends[s];
      size_t n = (size_t)(rows[s].send - rows[s].sstart) * w;
      uint8_t* out = res.data() + (size_t)rows[s].sstart * w;
      for (size_t i = 0; i < n; i++) {
        uint32_t peek = br.peek32();
        uint32_t p12 = peek >> (32 - Huff::kLut);
        int ln = hf.lut_len[p12];
        int sym;
        if (ln) {
          sym = hf.lut_sym[p12];
        } else {
          // long code: per-length canonical ranges
          sym = -1;
          for (int L = Huff::kLut + 1; L <= hf.max_len; L++) {
            if (!hf.count[L]) continue;
            uint32_t c = peek >> (32 - L);
            uint32_t off = c - hf.first_code[L];
            if (c >= hf.first_code[L] && off < (uint32_t)hf.count[L]) {
              sym = hf.syms[hf.first_index[L] + off];
              ln = L;
              break;
            }
          }
          if (sym < 0) throw UtError("invalid code in bitstream");
        }
        br.skip(ln);
        if (br.overrun()) throw UtError("bitstream overrun");
        out[i] = (uint8_t)sym;
      }
    }
    *pos = dstart + prevend;
  }

  // prediction restore, per slice
  for (auto& r : rows) {
    int sh = r.send - r.sstart;
    if (sh <= 0) continue;
    const uint8_t* rp = res.data() + (size_t)r.sstart * w;
    uint8_t* dp = dst + (size_t)r.sstart * w;
    switch (pred) {
      case 0:                        // none
        std::memcpy(dp, rp, (size_t)sh * w);
        break;
      case 1: {                      // left, raster across the slice
        uint8_t acc = 0x80;
        size_t n = (size_t)sh * w;
        for (size_t i = 0; i < n; i++) {
          acc = (uint8_t)(acc + rp[i]);
          dp[i] = acc;
        }
        break;
      }
      case 2: {                      // gradient
        uint8_t acc = 0x80;
        for (int i = 0; i < w; i++) {
          acc = (uint8_t)(acc + rp[i]);
          dp[i] = acc;
        }
        for (int j = 1; j < sh; j++) {
          const uint8_t* rr = rp + (size_t)j * w;
          uint8_t* dd = dp + (size_t)j * w;
          const uint8_t* up = dd - w;
          dd[0] = (uint8_t)(rr[0] + up[0]);
          for (int i = 1; i < w; i++) {
            int predv = (dd[i - 1] + up[i] - up[i - 1]) & 0xFF;
            dd[i] = (uint8_t)(rr[i] + predv);
          }
        }
        break;
      }
      case 3: {                      // median
        uint8_t acc = 0x80;
        for (int i = 0; i < w; i++) {
          acc = (uint8_t)(acc + rp[i]);
          dp[i] = acc;
        }
        for (int j = 1; j < sh; j++) {
          const uint8_t* rr = rp + (size_t)j * w;
          uint8_t* dd = dp + (size_t)j * w;
          const uint8_t* up = dd - w;
          dd[0] = (uint8_t)(rr[0] + up[0]);
          for (int i = 1; i < w; i++) {
            int a = dd[i - 1], b = up[i], c = up[i - 1];
            int predv = mid_pred(a, b, (a + b - c) & 0xFF);
            dd[i] = (uint8_t)(rr[i] + predv);
          }
        }
        break;
      }
      default:
        throw UtError("bad prediction mode");
    }
  }
}

}  // namespace

// decode_utvideo(data, fourcc, width, height, slices)
//   -> (y: bytes, u: bytes, v: bytes)
extern "C" PyObject* mfi_decode_utvideo(PyObject*, PyObject* args) {
  Py_buffer buf;
  const char* fourcc;
  int width, height, slices;
  if (!PyArg_ParseTuple(args, "y*siii", &buf, &fourcc, &width, &height,
                        &slices))
    return nullptr;
  std::string err;
  std::vector<uint8_t> planes[3];
  int pw[3], ph[3];
  Py_BEGIN_ALLOW_THREADS;
  try {
    std::string fc(fourcc);
    bool is420 = fc == "ULY0" || fc == "ULH0";
    bool is422 = fc == "ULY2" || fc == "ULH2";
    if (!is420 && !is422) throw UtError("unsupported fourcc " + fc);
    if (width < 2 || height < 1 || width > 1 << 16 || height > 1 << 16)
      throw UtError("bad dimensions");
    if (width % 2 || (is420 && height % 2))
      throw UtError("dimensions not even");
    if (slices < 1 || slices > 256) throw UtError("bad slice count");
    pw[0] = width; ph[0] = height;
    pw[1] = pw[2] = width / 2;
    ph[1] = ph[2] = is420 ? height / 2 : height;

    const uint8_t* data = (const uint8_t*)buf.buf;
    size_t len = (size_t)buf.len;
    if (len < 4) throw UtError("packet too short");
    uint32_t frame_info;
    std::memcpy(&frame_info, data + len - 4, 4);
    int pred = (frame_info >> 8) & 3;
    size_t body_len = len - 4;
    size_t pos = 0;
    for (int p = 0; p < 3; p++) {
      planes[p].resize((size_t)pw[p] * ph[p]);
      decode_plane(data, body_len, &pos, planes[p].data(), pw[p], ph[p],
                   slices, pred);
    }
  } catch (const UtError& e) {
    err = e.what();
  } catch (const std::bad_alloc&) {
    err = "out of memory";
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  if (!err.empty()) {
    PyErr_SetString(PyExc_ValueError, err.c_str());
    return nullptr;
  }
  return Py_BuildValue(
      "y#y#y#", (const char*)planes[0].data(), (Py_ssize_t)planes[0].size(),
      (const char*)planes[1].data(), (Py_ssize_t)planes[1].size(),
      (const char*)planes[2].data(), (Py_ssize_t)planes[2].size());
}
