// FFV1 (RFC 9043 v0/1) native decoder: the hot path under the ingest
// thread.  Format layout + semantics documented in io/ffv1.py (the
// pure-Python oracle this is tested bit-exactly against in
// tests/test_ffv1.py).  The reference plays FFV1 via libavcodec
// (video/decode/vd_lavc.c:1157-1388); this is a from-spec C++
// implementation of the adaptive binary range coder, the
// quantization-table context model, and median-predicted plane
// reconstruction, with persistent per-stream context state so inter
// frames (keyframe bit clear) chain correctly.
//
// Exposed as:
//   _mfi_native.ffv1_create(width, height) -> capsule
//   _mfi_native.ffv1_reset(capsule)                 (after seeks)
//   _mfi_native.ffv1_decode(capsule, data)
//       -> (bits, ((y_bytes, w, h), [(u_bytes, cw, ch), ...]))
//       plane bytes are uint8 for bits<=8, little-endian uint16 above
// Every read is bounds-checked; raises ValueError on any malformed
// input; fuzz-driven in tests/test_ffv1.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct FFV1Err : std::runtime_error {
  explicit FFV1Err(const std::string& m) : std::runtime_error(m) {}
};

constexpr int kContextSize = 32;
constexpr int kMaxContexts = 32768;

// -- default probability state-transition tables (io/ffv1.py
//    _build_rac_tables: the published geometric-adaptation recurrence)
struct RacTables {
  uint8_t one[256];
  uint8_t zero[256];
  RacTables() {
    const int64_t kOne = 1LL << 32;
    const int64_t factor = (int64_t)(0.05 * (double)kOne);
    const int max_p = 256 - 8;
    int32_t one32[256] = {0};
    int last_p8 = 0;
    int64_t p = kOne / 2;
    for (int i = 0; i < 128; i++) {
      int p8 = (int)((256 * p + kOne / 2) >> 32);
      if (p8 <= last_p8) p8 = last_p8 + 1;
      if (last_p8 && last_p8 < 256 && p8 <= max_p) one32[last_p8] = p8;
      p += ((kOne - p) * factor + kOne / 2) >> 32;
      last_p8 = p8;
    }
    for (int i = 256 - max_p; i <= max_p; i++) {
      if (one32[i]) continue;
      int64_t q = ((int64_t)i * kOne + 128) >> 8;
      q += ((kOne - q) * factor + kOne / 2) >> 32;
      int p8 = (int)((256 * q + kOne / 2) >> 32);
      if (p8 <= i) p8 = i + 1;
      if (p8 > max_p) p8 = max_p;
      one32[i] = p8;
    }
    std::memset(one, 0, sizeof(one));
    std::memset(zero, 0, sizeof(zero));
    for (int i = 0; i < 256; i++) one[i] = (uint8_t)one32[i];
    for (int i = 1; i < 255; i++) zero[i] = (uint8_t)(256 - one32[256 - i]);
  }
};
const RacTables kDefaultTables;

// -- range decoder (io/ffv1.py RangeDecoder) ------------------------------
struct RangeDec {
  const uint8_t* data;
  size_t len, pos;
  uint32_t low, range;
  const uint8_t* one;
  const uint8_t* zero;

  void init(const uint8_t* d, size_t n) {
    if (n < 2) throw FFV1Err("packet too short for range coder priming");
    data = d;
    len = n;
    pos = 2;
    low = ((uint32_t)d[0] << 8) | d[1];
    range = 0xFF00;
    one = kDefaultTables.one;
    zero = kDefaultTables.zero;
  }
  inline void refill() {
    if (range < 0x100) {
      range <<= 8;
      low <<= 8;
      if (pos < len) low += data[pos];
      pos++;
      if (pos > len + 8) throw FFV1Err("bitstream overrun");
    }
  }
  inline int get(uint8_t* state) {
    uint32_t s = *state;
    uint32_t r1 = (range * s) >> 8;
    range -= r1;
    if (low < range) {
      *state = zero[s];
      refill();
      return 0;
    }
    low -= range;
    range = r1;
    *state = one[s];
    refill();
    return 1;
  }
};

// io/ffv1.py _get_symbol
static int64_t get_symbol(RangeDec& c, uint8_t* st, bool is_signed) {
  if (c.get(st + 0)) return 0;
  int e = 0;
  while (c.get(st + 1 + (e < 9 ? e : 9))) {
    e++;
    if (e > 31) throw FFV1Err("symbol exponent overflow");
  }
  int64_t a = 1;
  for (int i = e - 1; i >= 0; i--)
    a += a + c.get(st + 22 + (i < 9 ? i : 9));
  if (is_signed && c.get(st + 11 + (e < 10 ? e : 10))) return -a;
  return a;
}

// -- stream state ----------------------------------------------------------
struct FFV1State {
  int width = 0, height = 0;
  bool has_params = false;
  int bits = 8;
  int version = 0, coder_type = 1, h_shift = 1, v_shift = 1;
  bool chroma = true;
  bool has_custom = false;
  uint8_t custom_one[256], custom_zero[256];
  int32_t scaled[5][256];
  bool five = false;
  int context_count = 0;
  std::vector<uint8_t> states[2];  // luma / shared-chroma context states
};

// io/ffv1.py _read_quant_table (unscaled; runs carry implicit 0,1,2,...)
static int read_quant_table(RangeDec& c, int16_t qt[256]) {
  uint8_t st[kContextSize];
  std::memset(st, 128, sizeof(st));
  std::memset(qt, 0, 256 * sizeof(int16_t));
  int i = 0, v = 0;
  while (i < 128) {
    int64_t run = get_symbol(c, st, false) + 1;
    if (run > 128 - i) throw FFV1Err("quant table run overflow");
    for (int k = 0; k < run; k++) qt[i++] = (int16_t)v;
    v++;
    if (v > 128) throw FFV1Err("quant table value overflow");
  }
  for (int j = 1; j < 128; j++) qt[256 - j] = (int16_t)-qt[j];
  qt[128] = (int16_t)-qt[127];
  return v;
}

// io/ffv1.py _read_params
static void read_params(RangeDec& c, FFV1State& s) {
  uint8_t st[kContextSize];
  std::memset(st, 128, sizeof(st));
  int64_t version = get_symbol(c, st, false);
  if (version > 1)
    throw FFV1Err("FFV1 version " + std::to_string((long long)version) +
                  " inline parameters are invalid (only v0/1 supported)");
  int64_t coder = get_symbol(c, st, false);
  s.has_custom = false;
  if (coder == 2) {
    int32_t one[256] = {0};
    for (int i = 1; i < 256; i++) {
      one[i] = (int32_t)(get_symbol(c, st, true) + kDefaultTables.one[i]);
      if (one[i] < 1 || one[i] > 255)
        throw FFV1Err("bad custom state transition");
    }
    std::memset(s.custom_one, 0, 256);
    std::memset(s.custom_zero, 0, 256);
    for (int i = 0; i < 256; i++) s.custom_one[i] = (uint8_t)one[i];
    for (int i = 1; i < 256; i++)
      s.custom_zero[256 - i] = (uint8_t)(256 - one[i]);
    s.has_custom = true;
  } else if (coder != 1) {
    throw FFV1Err("coder_type " + std::to_string((long long)coder) +
                  " unsupported (0 = Golomb-Rice not implemented)");
  }
  int64_t colorspace = get_symbol(c, st, false);
  if (colorspace != 0) throw FFV1Err("colorspace unsupported");
  int64_t bits = version > 0 ? get_symbol(c, st, false) : 8;
  if (bits == 0) bits = 8;
  if (bits < 8 || bits > 16)
    throw FFV1Err("only 8..16-bit FFV1 supported");
  s.chroma = c.get(st) != 0;
  int64_t hs = get_symbol(c, st, false);
  int64_t vs = get_symbol(c, st, false);
  if (hs > 2 || vs > 2) throw FFV1Err("chroma subsampling out of range");
  bool transparency = c.get(st) != 0;
  if (transparency) throw FFV1Err("transparency plane unsupported");
  int64_t scale = 1;
  for (int t = 0; t < 5; t++) {
    int16_t qt[256];
    int nvals = read_quant_table(c, qt);
    for (int j = 0; j < 256; j++)
      s.scaled[t][j] = (int32_t)(qt[j] * scale);
    scale *= 2 * (int64_t)(nvals - 1) + 1;
    if ((scale + 1) / 2 > kMaxContexts)
      throw FFV1Err("context space too large");
  }
  s.version = (int)version;
  s.bits = (int)bits;
  s.coder_type = (int)coder;
  s.h_shift = (int)hs;
  s.v_shift = (int)vs;
  s.context_count = (int)((scale + 1) / 2);
  s.five = s.scaled[3][127] != 0 || s.scaled[4][127] != 0;
}

// io/ffv1.py _decode_plane: two-row ring, padded by 3 left / 3 right.
// Samples store as uint8 (bits<=8) or little-endian uint16 in `out`.
static void decode_plane(RangeDec& c, uint8_t* ctx_states,
                         const FFV1State& s, int w, int h, uint8_t* out) {
  std::vector<int32_t> buf(2 * (size_t)(w + 6), 0);
  const int32_t mask = (int32_t)((1u << s.bits) - 1);
  const bool wide = s.bits > 8;
  int cur = 1;
  const int32_t* q0 = s.scaled[0];
  const int32_t* q1 = s.scaled[1];
  const int32_t* q2 = s.scaled[2];
  const int32_t* q3 = s.scaled[3];
  const int32_t* q4 = s.scaled[4];
  for (int y = 0; y < h; y++) {
    cur ^= 1;
    int32_t* line = buf.data() + (size_t)cur * (w + 6) + 3;
    int32_t* prev = buf.data() + (size_t)(cur ^ 1) * (w + 6) + 3;
    line[-1] = prev[0];       // left-of-first = top
    prev[w] = prev[w - 1];    // top-right clamp
    for (int x = 0; x < w; x++) {
      int32_t L = line[x - 1], LT = prev[x - 1], T = prev[x],
              RT = prev[x + 1];
      int32_t ctx = q0[(L - LT) & 0xFF] + q1[(LT - T) & 0xFF] +
                    q2[(T - RT) & 0xFF];
      if (s.five) {
        int32_t LL = line[x - 2], TT = line[x];  // line[x] holds y-2
        ctx += q3[(LL - L) & 0xFF] + q4[(TT - T) & 0xFF];
      }
      int sign = 1;
      if (ctx < 0) {
        ctx = -ctx;
        sign = -1;
      }
      int64_t diff =
          sign * get_symbol(c, ctx_states + (size_t)ctx * kContextSize,
                            true);
      // median predictor
      int32_t grad = L + T - LT;
      int32_t lo = L < T ? L : T, hi = L < T ? T : L;
      int32_t pred = grad < lo ? lo : (grad > hi ? hi : grad);
      line[x] = (int32_t)((pred + diff) & mask);
      if (wide) {
        out[2 * ((size_t)y * w + x)] = (uint8_t)(line[x] & 0xFF);
        out[2 * ((size_t)y * w + x) + 1] = (uint8_t)(line[x] >> 8);
      } else {
        out[(size_t)y * w + x] = (uint8_t)line[x];
      }
    }
  }
}

static void decode_packet(FFV1State& s, const uint8_t* data, size_t len,
                          std::vector<uint8_t> planes[3], int pw[3],
                          int ph[3], int* nplanes) {
  RangeDec c;
  c.init(data, len);
  uint8_t keystate[kContextSize];
  std::memset(keystate, 128, sizeof(keystate));
  int keyframe = c.get(keystate);
  if (keyframe) {
    read_params(c, s);
    s.has_params = true;
    int nsets = s.chroma ? 2 : 1;
    for (int i = 0; i < nsets; i++) {
      s.states[i].assign((size_t)s.context_count * kContextSize, 128);
    }
  } else if (!s.has_params) {
    throw FFV1Err(
        "inter frame without a prior keyframe (stream must be entered "
        "at a keyframe; FFV1 context states chain)");
  }
  if (s.has_custom) {
    c.one = s.custom_one;
    c.zero = s.custom_zero;
  }
  pw[0] = s.width;
  ph[0] = s.height;
  *nplanes = 1;
  if (s.chroma) {
    int cw = (s.width + (1 << s.h_shift) - 1) >> s.h_shift;
    int ch = (s.height + (1 << s.v_shift) - 1) >> s.v_shift;
    pw[1] = pw[2] = cw;
    ph[1] = ph[2] = ch;
    *nplanes = 3;
  }
  size_t itemsize = s.bits > 8 ? 2 : 1;
  for (int p = 0; p < *nplanes; p++) {
    int si = p == 0 ? 0 : 1;  // Cb and Cr share one state set
    planes[p].resize((size_t)pw[p] * ph[p] * itemsize);
    decode_plane(c, s.states[si].data(), s, pw[p], ph[p],
                 planes[p].data());
  }
}

// -- encoder (mirrors io/ffv1.py FFV1Encoder byte-for-byte) ----------------

struct RangeEnc {
  std::vector<uint8_t> out;
  uint32_t low = 0, range = 0xFF00;
  int outstanding_byte = -1;
  size_t outstanding_count = 0;
  const uint8_t* one = kDefaultTables.one;
  const uint8_t* zero = kDefaultTables.zero;

  void renorm() {
    while (range < 0x100) {
      if (outstanding_byte < 0) {
        outstanding_byte = (low >> 8) & 0xFF;
      } else if (low <= 0xFF00) {
        out.push_back((uint8_t)outstanding_byte);
        out.insert(out.end(), outstanding_count, 0xFF);
        outstanding_count = 0;
        outstanding_byte = (low >> 8) & 0xFF;
      } else if (low >= 0x10000) {  // carry: propagate into the queue
        out.push_back((uint8_t)(outstanding_byte + 1));
        out.insert(out.end(), outstanding_count, 0x00);
        outstanding_count = 0;
        outstanding_byte = (low >> 8) & 0xFF;
      } else {
        outstanding_count++;
      }
      low = (low & 0xFF) << 8;
      range <<= 8;
    }
  }
  inline void put(uint8_t* state, int bit) {
    uint32_t s = *state;
    uint32_t r1 = (range * s) >> 8;
    if (bit) {
      low += range - r1;
      range = r1;
      *state = one[s];
    } else {
      range -= r1;
      *state = zero[s];
    }
    renorm();
  }
  void finish() {
    range = 0xFF;
    low += 0xFF;
    renorm();
    range = 0xFF;
    renorm();
    if (outstanding_byte >= 0) {
      out.push_back((uint8_t)outstanding_byte);
      out.insert(out.end(), outstanding_count, 0xFF);
    }
  }
};

static void put_symbol(RangeEnc& c, uint8_t* st, int64_t v,
                       bool is_signed) {
  if (v == 0) {
    c.put(st + 0, 1);
    return;
  }
  uint64_t a = v < 0 ? (uint64_t)(-v) : (uint64_t)v;
  int e = 63 - __builtin_clzll(a);
  c.put(st + 0, 0);
  for (int i = 0; i < e; i++) c.put(st + 1 + (i < 9 ? i : 9), 1);
  c.put(st + 1 + (e < 9 ? e : 9), 0);
  for (int i = e - 1; i >= 0; i--)
    c.put(st + 22 + (i < 9 ? i : 9), (int)((a >> i) & 1));
  if (is_signed) c.put(st + 11 + (e < 10 ? e : 10), v < 0 ? 1 : 0);
}

// io/ffv1.py default_quant_table(6): |d| thresholds 1,2,4,8,16
static void default_quant6(int16_t qt[256]) {
  std::memset(qt, 0, 256 * sizeof(int16_t));
  for (int d = 1; d < 128; d++) {
    int v = 0;
    for (int b : {1, 2, 4, 8, 16})
      if (d >= b) v++;
    qt[d] = (int16_t)(v < 5 ? v : 5);
  }
  for (int d = 1; d < 128; d++) qt[256 - d] = (int16_t)-qt[d];
  qt[128] = (int16_t)-qt[127];
}

static void write_quant_table(RangeEnc& c, const int16_t qt[256]) {
  uint8_t st[kContextSize];
  std::memset(st, 128, sizeof(st));
  int last = 0;
  for (int i = 1; i < 128; i++)
    if (qt[i] != qt[i - 1]) {
      put_symbol(c, st, i - last - 1, false);
      last = i;
    }
  put_symbol(c, st, 128 - last - 1, false);
}

struct FFV1EncState {
  int width = 0, height = 0, bits = 8;
  int16_t quant[5][256];
  int32_t scaled[5][256];
  int context_count = 0;
  std::vector<uint8_t> states[2];
  bool primed = false;

  void setup() {
    int16_t q6[256], zero[256];
    default_quant6(q6);
    std::memset(zero, 0, sizeof(zero));
    const int16_t* src[5] = {q6, q6, q6, zero, zero};
    int64_t scale = 1;
    for (int t = 0; t < 5; t++) {
      std::memcpy(quant[t], src[t], sizeof(q6));
      int mx = 0;
      for (int j = 1; j < 128; j++)
        if (src[t][j] > mx) mx = src[t][j];
      for (int j = 0; j < 256; j++)
        scaled[t][j] = (int32_t)(src[t][j] * scale);
      scale *= 2 * mx + 1;
    }
    context_count = (int)((scale + 1) / 2);
  }
};

static void write_params(RangeEnc& c, const FFV1EncState& s) {
  uint8_t st[kContextSize];
  std::memset(st, 128, sizeof(st));
  put_symbol(c, st, 1, false);       // version
  put_symbol(c, st, 1, false);       // coder_type: range, default table
  put_symbol(c, st, 0, false);       // colorspace YCbCr
  put_symbol(c, st, s.bits, false);
  c.put(st, 1);                      // chroma_planes
  put_symbol(c, st, 1, false);       // h_shift (4:2:0)
  put_symbol(c, st, 1, false);       // v_shift
  c.put(st, 0);                      // transparency
  for (int t = 0; t < 5; t++) write_quant_table(c, s.quant[t]);
}

static void encode_plane(RangeEnc& c, uint8_t* ctx_states,
                         const FFV1EncState& s, int w, int h,
                         const uint8_t* src) {
  std::vector<int32_t> buf(2 * (size_t)(w + 6), 0);
  const int32_t mask = (int32_t)((1u << s.bits) - 1);
  const int32_t half = 1 << (s.bits - 1);
  const bool wide = s.bits > 8;
  const int32_t* q0 = s.scaled[0];
  const int32_t* q1 = s.scaled[1];
  const int32_t* q2 = s.scaled[2];
  int cur = 1;
  for (int y = 0; y < h; y++) {
    cur ^= 1;
    int32_t* line = buf.data() + (size_t)cur * (w + 6) + 3;
    int32_t* prev = buf.data() + (size_t)(cur ^ 1) * (w + 6) + 3;
    line[-1] = prev[0];
    prev[w] = prev[w - 1];
    for (int x = 0; x < w; x++) {
      int32_t L = line[x - 1], LT = prev[x - 1], T = prev[x],
              RT = prev[x + 1];
      int32_t ctx = q0[(L - LT) & 0xFF] + q1[(LT - T) & 0xFF] +
                    q2[(T - RT) & 0xFF];
      int sign = 1;
      if (ctx < 0) {
        ctx = -ctx;
        sign = -1;
      }
      int32_t sample;
      if (wide) {
        size_t i = 2 * ((size_t)y * w + x);
        sample = (int32_t)(src[i] | ((int32_t)src[i + 1] << 8)) & mask;
      } else {
        sample = src[(size_t)y * w + x];
      }
      int32_t grad = L + T - LT;
      int32_t lo = L < T ? L : T, hi = L < T ? T : L;
      int32_t pred = grad < lo ? lo : (grad > hi ? hi : grad);
      int32_t diff = (((sample - pred) + half) & mask) - half;
      put_symbol(c, ctx_states + (size_t)ctx * kContextSize,
                 (int64_t)sign * diff, true);
      line[x] = sample;
    }
  }
}

// -- Python boundary -------------------------------------------------------

void ffv1_capsule_free(PyObject* cap) {
  delete (FFV1State*)PyCapsule_GetPointer(cap, "mfi.ffv1");
}

void ffv1_enc_capsule_free(PyObject* cap) {
  delete (FFV1EncState*)PyCapsule_GetPointer(cap, "mfi.ffv1enc");
}

}  // namespace

extern "C" PyObject* mfi_ffv1_create(PyObject*, PyObject* args) {
  int width, height;
  if (!PyArg_ParseTuple(args, "ii", &width, &height)) return nullptr;
  if (width < 1 || height < 1 || width > 16384 || height > 16384) {
    PyErr_SetString(PyExc_ValueError, "bad dimensions");
    return nullptr;
  }
  FFV1State* s = new FFV1State();
  s->width = width;
  s->height = height;
  return PyCapsule_New(s, "mfi.ffv1", ffv1_capsule_free);
}

extern "C" PyObject* mfi_ffv1_reset(PyObject*, PyObject* args) {
  PyObject* cap;
  if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
  FFV1State* s = (FFV1State*)PyCapsule_GetPointer(cap, "mfi.ffv1");
  if (!s) return nullptr;
  s->has_params = false;
  s->states[0].clear();
  s->states[1].clear();
  Py_RETURN_NONE;
}

extern "C" PyObject* mfi_ffv1_enc_create(PyObject*, PyObject* args) {
  int width, height, bits;
  if (!PyArg_ParseTuple(args, "iii", &width, &height, &bits))
    return nullptr;
  if (width < 2 || height < 2 || width > 16384 || height > 16384 ||
      width % 2 || height % 2 || bits < 8 || bits > 16) {
    PyErr_SetString(PyExc_ValueError,
                    "bad dimensions (even, >=2) or bits (8..16)");
    return nullptr;
  }
  FFV1EncState* s = new FFV1EncState();
  s->width = width;
  s->height = height;
  s->bits = bits;
  s->setup();
  return PyCapsule_New(s, "mfi.ffv1enc", ffv1_enc_capsule_free);
}

extern "C" PyObject* mfi_ffv1_encode(PyObject*, PyObject* args) {
  PyObject* cap;
  Py_buffer yb, ub, vb;
  int keyframe;
  if (!PyArg_ParseTuple(args, "Oy*y*y*p", &cap, &yb, &ub, &vb,
                        &keyframe))
    return nullptr;
  FFV1EncState* s =
      (FFV1EncState*)PyCapsule_GetPointer(cap, "mfi.ffv1enc");
  std::string err;
  RangeEnc c;
  if (s) {
    size_t item = s->bits > 8 ? 2 : 1;
    size_t yn = (size_t)s->width * s->height * item;
    size_t cn = (size_t)(s->width / 2) * (s->height / 2) * item;
    if ((size_t)yb.len != yn || (size_t)ub.len != cn ||
        (size_t)vb.len != cn) {
      err = "plane buffer sizes do not match geometry/bits";
    } else if (!keyframe && !s->primed) {
      err = "first frame must be a keyframe";
    } else {
      Py_BEGIN_ALLOW_THREADS;
      try {
        uint8_t keystate[kContextSize];
        std::memset(keystate, 128, sizeof(keystate));
        c.put(keystate, keyframe ? 1 : 0);
        if (keyframe) {
          write_params(c, *s);
          for (int i = 0; i < 2; i++)
            s->states[i].assign(
                (size_t)s->context_count * kContextSize, 128);
          s->primed = true;
        }
        encode_plane(c, s->states[0].data(), *s, s->width, s->height,
                     (const uint8_t*)yb.buf);
        encode_plane(c, s->states[1].data(), *s, s->width / 2,
                     s->height / 2, (const uint8_t*)ub.buf);
        encode_plane(c, s->states[1].data(), *s, s->width / 2,
                     s->height / 2, (const uint8_t*)vb.buf);
        c.finish();
      } catch (const std::bad_alloc&) {
        err = "out of memory";
      }
      Py_END_ALLOW_THREADS;
    }
  }
  PyBuffer_Release(&yb);
  PyBuffer_Release(&ub);
  PyBuffer_Release(&vb);
  if (!s) return nullptr;
  if (!err.empty()) {
    PyErr_SetString(PyExc_ValueError, err.c_str());
    return nullptr;
  }
  return PyBytes_FromStringAndSize((const char*)c.out.data(),
                                   (Py_ssize_t)c.out.size());
}

extern "C" PyObject* mfi_ffv1_decode(PyObject*, PyObject* args) {
  PyObject* cap;
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "Oy*", &cap, &buf)) return nullptr;
  FFV1State* s = (FFV1State*)PyCapsule_GetPointer(cap, "mfi.ffv1");
  if (!s) {
    PyBuffer_Release(&buf);
    return nullptr;
  }
  std::string err;
  std::vector<uint8_t> planes[3];
  int pw[3] = {0}, ph[3] = {0}, nplanes = 0;
  // snapshot for rollback: a failed decode must not corrupt chain state
  FFV1State backup = *s;
  Py_BEGIN_ALLOW_THREADS;
  try {
    decode_packet(*s, (const uint8_t*)buf.buf, (size_t)buf.len, planes,
                  pw, ph, &nplanes);
  } catch (const FFV1Err& e) {
    err = e.what();
  } catch (const std::bad_alloc&) {
    err = "out of memory";
  }
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&buf);
  if (!err.empty()) {
    *s = backup;  // restore pre-packet context state
    PyErr_SetString(PyExc_ValueError, err.c_str());
    return nullptr;
  }
  PyObject* out = PyTuple_New(nplanes);
  if (!out) return nullptr;
  for (int p = 0; p < nplanes; p++) {
    PyObject* item =
        Py_BuildValue("(y#ii)", (const char*)planes[p].data(),
                      (Py_ssize_t)planes[p].size(), pw[p], ph[p]);
    if (!item) {
      Py_DECREF(out);
      return nullptr;
    }
    PyTuple_SET_ITEM(out, p, item);
  }
  return Py_BuildValue("(iN)", s->bits, out);
}
