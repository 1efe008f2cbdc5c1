"""FFV1 (RFC 9043, versions 0/1): pure-Python reference decoder + encoder.

The reference plays FFV1 through libavcodec
(video/decode/vd_lavc.c:1157-1388, codec id AV_CODEC_ID_FFV1); this
rebuild carries its own implementation so range-coded lossless archival
media (`V_FFV1` in MKV, fourcc `FFV1` in AVI) plays without ffmpeg.
Like io/utvideo.py, this module is the format oracle (the plain version
of the native decoder, run where the caller asks for it with
use_native=False), and the encoder used to author test
vectors (no reference encoder exists in this environment -- compliance
follows RFC 9043's bitstream: the carry-based binary range coder with
256 adaptive probability states, the quantization-table context model
over the {L, T, TL, TR[, LL, TT]} neighbourhood, median prediction, and
exp-Golomb-style symbol coding with per-context 32-byte state sets).

Scope: version 0/1 (parameters inline in every keyframe -- the layout
archival 4:2:0 content actually uses), coder_type 1 (range coder,
default state transition) and 2 (custom transition table), colorspace 0
(transformed YCbCr is rejected), 8-bit samples, no transparency plane.
Single slice per frame (v0/1 has no slice structure).  Inter frames
(keyframe bit clear: context states persist from the previous frame)
decode sequentially; seeking must land on keyframes, which re-carry the
full parameter set.

One frame packet:

    keyframe bit (one binary event, fresh state 128)
    [keyframe only] parameters:
        version, coder_type, [custom state-transition deltas,]
        colorspace, bits_per_raw_sample (v1), chroma flag, log2 chroma
        h/v subsampling, transparency flag, then the five quantization
        tables, each run-length coded over its positive half (runs carry
        implicit values 0,1,2,...; the negative half mirrors by sign)
    plane payloads: Y, then Cb, Cr (both chroma planes SHARE one
        context-state set), each line context-coded with the shared
        range coder; no byte alignment anywhere

The port's copy of the JAX package's ``io/ffv1.py``; the native decoder
and encoder are the port's own library (``native/``, built at first
use).  tests/test_torch_io.py holds both decoders against the original.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from mpv_frame_interpolator_tpu_torch import native
from mpv_frame_interpolator_tpu_torch.frame import interleave_chroma

CONTEXT_SIZE = 32          # adaptive states per context
MAX_CONTEXT_INPUTS = 5
MAX_CONTEXT_COUNT = 32768  # RFC 9043 bound on the folded context space


class FFV1Error(ValueError):
    pass


# -- adaptive binary range coder (RFC 9043 §4.1) --------------------------

def _build_rac_tables(factor: int = int(0.05 * (1 << 32)),
                      max_p: int = 256 - 8
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Default probability state-transition tables (one_state/zero_state).

    Generated by the published geometric-adaptation recurrence; the
    custom-table coder (coder_type 2) transmits deltas against
    one_state, so both directions need it.
    """
    one = 1 << 32
    one_state = np.zeros(256, np.int32)
    last_p8 = 0
    p = one // 2
    for _ in range(128):
        p8 = (256 * p + one // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one_state[last_p8] = p8
        p += ((one - p) * factor + one // 2) >> 32
        last_p8 = p8
    for i in range(256 - max_p, max_p + 1):
        if one_state[i]:
            continue
        p = (i * one + 128) >> 8
        p += ((one - p) * factor + one // 2) >> 32
        p8 = (256 * p + one // 2) >> 32
        if p8 <= i:
            p8 = i + 1
        if p8 > max_p:
            p8 = max_p
        one_state[i] = p8
    zero_state = np.zeros(256, np.int32)
    for i in range(1, 255):
        zero_state[i] = 256 - one_state[256 - i]
    return (one_state.astype(np.uint8), zero_state.astype(np.uint8))


_ONE_STATE, _ZERO_STATE = _build_rac_tables()


class RangeEncoder:
    """Carry-based byte-oriented range encoder (low/range renorm)."""

    def __init__(self, one_state=None, zero_state=None):
        self.low = 0
        self.range = 0xFF00
        self.out = bytearray()
        self.outstanding_byte = -1
        self.outstanding_count = 0
        self.one = _ONE_STATE if one_state is None else one_state
        self.zero = _ZERO_STATE if zero_state is None else zero_state

    def _renorm(self):
        while self.range < 0x100:
            if self.outstanding_byte < 0:
                self.outstanding_byte = (self.low >> 8) & 0xFF
            elif self.low <= 0xFF00:
                self.out.append(self.outstanding_byte)
                self.out.extend(b"\xff" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = (self.low >> 8) & 0xFF
            elif self.low >= 0x10000:  # carry: propagate into the queue
                self.out.append((self.outstanding_byte + 1) & 0xFF)
                self.out.extend(b"\x00" * self.outstanding_count)
                self.outstanding_count = 0
                self.outstanding_byte = (self.low >> 8) & 0xFF
            else:
                self.outstanding_count += 1
            self.low = (self.low & 0xFF) << 8
            self.range <<= 8

    def put(self, states: bytearray, idx: int, bit: int):
        s = states[idx]
        r1 = (self.range * s) >> 8
        if bit:
            self.low += self.range - r1
            self.range = r1
            states[idx] = self.one[s]
        else:
            self.range -= r1
            states[idx] = self.zero[s]
        self._renorm()

    def finish(self) -> bytes:
        # terminate: squeeze range so the 16 low bits flush deterministically
        self.range = 0xFF
        self.low += 0xFF
        self._renorm()
        self.range = 0xFF
        self._renorm()
        if self.outstanding_byte >= 0:
            self.out.append(self.outstanding_byte)
            self.out.extend(b"\xff" * self.outstanding_count)
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, data: bytes, one_state=None, zero_state=None):
        if len(data) < 2:
            raise FFV1Error("packet too short for range coder priming")
        self.data = data
        self.pos = 2
        self.low = (data[0] << 8) | data[1]
        self.range = 0xFF00
        self.one = _ONE_STATE if one_state is None else one_state
        self.zero = _ZERO_STATE if zero_state is None else zero_state

    def _refill(self):
        if self.range < 0x100:
            self.range <<= 8
            self.low <<= 8
            if self.pos < len(self.data):
                self.low += self.data[self.pos]
            self.pos += 1
            if self.pos > len(self.data) + 8:
                raise FFV1Error("bitstream overrun")

    def get(self, states: bytearray, idx: int) -> int:
        s = states[idx]
        r1 = (self.range * s) >> 8
        self.range -= r1
        if self.low < self.range:
            states[idx] = self.zero[s]
            self._refill()
            return 0
        self.low -= self.range
        self.range = r1
        states[idx] = self.one[s]
        self._refill()
        return 1


def _put_symbol(c: RangeEncoder, states: bytearray, base: int, v: int,
                signed: bool):
    """Exp-Golomb-style adaptive symbol (RFC 9043 §4.1.3)."""
    if v == 0:
        c.put(states, base + 0, 1)
        return
    a = abs(v)
    e = a.bit_length() - 1
    c.put(states, base + 0, 0)
    for i in range(e):
        c.put(states, base + 1 + min(i, 9), 1)
    c.put(states, base + 1 + min(e, 9), 0)
    for i in range(e - 1, -1, -1):
        c.put(states, base + 22 + min(i, 9), (a >> i) & 1)
    if signed:
        c.put(states, base + 11 + min(e, 10), 1 if v < 0 else 0)


def _get_symbol(c: RangeDecoder, states: bytearray, base: int,
                signed: bool) -> int:
    if c.get(states, base + 0):
        return 0
    e = 0
    while c.get(states, base + 1 + min(e, 9)):
        e += 1
        if e > 31:
            raise FFV1Error("symbol exponent overflow")
    a = 1
    for i in range(e - 1, -1, -1):
        a += a + c.get(states, base + 22 + min(i, 9))
    if signed and c.get(states, base + 11 + min(e, 10)):
        return -a
    return a


def _fresh_states(n: int = CONTEXT_SIZE) -> bytearray:
    return bytearray([128] * n)


# -- quantization tables (the context model) ------------------------------

def default_quant_table(levels: int = 6) -> np.ndarray:
    """Symmetric int16[256] quantizer: |d| thresholds 0,1,2,4,8,16 ->
    values 0..levels-1; negative half mirrors with negated values
    (the classic quant11 shape; any monotone +1-step table is legal --
    the table rides the bitstream)."""
    if not 2 <= levels <= 9:
        raise FFV1Error("quant levels out of range")
    bounds = [1 << i for i in range(levels - 1)]        # 1,2,4,8,...
    qt = np.zeros(256, np.int16)
    for d in range(1, 128):
        v = sum(1 for b in bounds if d >= b)
        qt[d] = min(v, levels - 1)
    for d in range(1, 128):
        qt[256 - d] = -qt[d]
    qt[128] = -qt[127]
    return qt


def _write_quant_table(c: RangeEncoder, qt: np.ndarray):
    states = _fresh_states(CONTEXT_SIZE)
    last = 0
    for i in range(1, 128):
        if qt[i] != qt[i - 1]:
            if qt[i] != qt[i - 1] + 1:
                # runs carry implicit values 0,1,2,... on the wire
                raise FFV1Error("quant table must step by exactly +1")
            _put_symbol(c, states, 0, i - last - 1, False)
            last = i
    _put_symbol(c, states, 0, 128 - last - 1, False)


def _read_quant_table(c: RangeDecoder) -> np.ndarray:
    """-> unscaled int16[256] table.  Runs over the positive half carry
    implicit values 0,1,2,...; the negative half mirrors by sign."""
    states = _fresh_states(CONTEXT_SIZE)
    qt = np.zeros(256, np.int16)
    i, v = 0, 0
    while i < 128:
        run = _get_symbol(c, states, 0, False) + 1
        if run > 128 - i:
            raise FFV1Error("quant table run overflow")
        qt[i:i + run] = v
        i += run
        v += 1
        if v > 128:
            raise FFV1Error("quant table value overflow")
    for j in range(1, 128):
        qt[256 - j] = -qt[j]
    qt[128] = -qt[127]
    return qt


# -- parameters (RFC 9043 §4.2, v0/1 inline layout) -----------------------

class FFV1Params:
    def __init__(self, version=1, coder_type=1, colorspace=0, bits=8,
                 chroma_planes=True, h_shift=1, v_shift=1,
                 transparency=False, quant_tables=None,
                 state_transition=None):
        self.version = version
        self.coder_type = coder_type
        self.colorspace = colorspace
        if not 8 <= bits <= 16:
            raise FFV1Error("bits_per_raw_sample out of range")
        self.bits = bits
        self.chroma_planes = chroma_planes
        self.h_shift = h_shift
        self.v_shift = v_shift
        self.transparency = transparency
        if quant_tables is None:
            qt = default_quant_table(6)
            zero = np.zeros(256, np.int16)
            quant_tables = [qt, qt, qt, zero, zero]
        self.quant_tables = quant_tables        # unscaled, as transmitted
        self.state_transition = state_transition  # (one, zero) or None
        # mixed-radix flattening: input i's table is scaled by the
        # product of the ranges of inputs 0..i-1, so the 3/5 quantized
        # differences sum to a unique signed context index
        self.scaled_tables = []
        scale = 1
        for qt in self.quant_tables:
            self.scaled_tables.append(qt.astype(np.int32) * scale)
            scale *= 2 * int(qt[1:128].max(initial=0)) + 1
            if (scale + 1) // 2 > MAX_CONTEXT_COUNT:
                raise FFV1Error("context space too large")
        self.context_count = (scale + 1) // 2

    @property
    def five_context(self) -> bool:
        return bool(self.quant_tables[3][127] or self.quant_tables[4][127])


def _write_params(c: RangeEncoder, p: FFV1Params):
    states = _fresh_states(CONTEXT_SIZE)
    _put_symbol(c, states, 0, p.version, False)
    _put_symbol(c, states, 0, p.coder_type, False)
    if p.coder_type > 2:
        raise FFV1Error("unsupported coder type")
    if p.coder_type == 2:
        one, _ = p.state_transition or (_ONE_STATE, _ZERO_STATE)
        for i in range(1, 256):
            _put_symbol(c, states, 0, int(one[i]) - int(_ONE_STATE[i]),
                        True)
    _put_symbol(c, states, 0, p.colorspace, False)
    if p.version > 0:
        _put_symbol(c, states, 0, p.bits, False)
    c.put(states, 0, 1 if p.chroma_planes else 0)
    _put_symbol(c, states, 0, p.h_shift, False)
    _put_symbol(c, states, 0, p.v_shift, False)
    c.put(states, 0, 1 if p.transparency else 0)
    for qt in p.quant_tables:
        _write_quant_table(c, qt)


def _read_params(c: RangeDecoder) -> FFV1Params:
    states = _fresh_states(CONTEXT_SIZE)
    version = _get_symbol(c, states, 0, False)
    if version > 1:
        raise FFV1Error(
            f"FFV1 version {version} inline parameters are invalid "
            f"(v2+ rides a ConfigurationRecord; only v0/1 supported)")
    coder_type = _get_symbol(c, states, 0, False)
    transition = None
    if coder_type == 2:
        one = np.zeros(256, np.int32)
        for i in range(1, 256):
            one[i] = _get_symbol(c, states, 0, True) + int(_ONE_STATE[i])
            if not 1 <= one[i] <= 255:
                raise FFV1Error("bad custom state transition")
        zero = np.zeros(256, np.int32)
        for i in range(1, 256):
            zero[256 - i] = 256 - one[i]
        transition = (one.astype(np.uint8), zero.astype(np.uint8))
    elif coder_type != 1:
        raise FFV1Error(f"coder_type {coder_type} unsupported "
                        f"(0 = Golomb-Rice not implemented)")
    colorspace = _get_symbol(c, states, 0, False)
    if colorspace != 0:
        raise FFV1Error(f"colorspace {colorspace} unsupported "
                        f"(only planar YCbCr)")
    bits = _get_symbol(c, states, 0, False) if version > 0 else 8
    if bits == 0:
        bits = 8
    if not 8 <= bits <= 16:
        raise FFV1Error(f"{bits}-bit FFV1 unsupported (8..16-bit only)")
    chroma_planes = bool(c.get(states, 0))
    h_shift = _get_symbol(c, states, 0, False)
    v_shift = _get_symbol(c, states, 0, False)
    if h_shift > 2 or v_shift > 2:
        raise FFV1Error("chroma subsampling out of range")
    transparency = bool(c.get(states, 0))
    if transparency:
        raise FFV1Error("transparency plane unsupported")
    quant_tables = [_read_quant_table(c)
                    for _ in range(MAX_CONTEXT_INPUTS)]
    return FFV1Params(version=version, coder_type=coder_type,
                      colorspace=colorspace, bits=bits,
                      chroma_planes=chroma_planes, h_shift=h_shift,
                      v_shift=v_shift, transparency=transparency,
                      quant_tables=quant_tables,
                      state_transition=transition)


# -- plane codec (RFC 9043 §3: median predict + context model) ------------

def _median3(a: int, b: int, c: int) -> int:
    if a > b:
        a, b = b, a
    return min(b, max(a, c))


class _PlaneCoder:
    """Shared line walker: two persistent padded line buffers (ring of
    two suffices -- TT is read from the current-line buffer before the
    store overwrites it, LL behind the write cursor)."""

    def __init__(self, params: FFV1Params, w: int):
        self.p = params
        self.w = w
        self.qt = params.scaled_tables
        # padded rows: [pad2, x0..x_{w-1}, pad_right]
        self.buf = np.zeros((2, w + 6), np.int32)

    def start_plane(self):
        self.buf[:] = 0
        self.cur = 1  # index into buf of the line being coded

    def begin_line(self):
        self.cur ^= 1
        prev = self.buf[self.cur ^ 1]
        line = self.buf[self.cur]
        line[3 - 1] = prev[3]          # left-of-first = top
        prev[3 + self.w] = prev[3 + self.w - 1]  # top-right clamp
        return prev, line

    def context(self, prev, line, x: int) -> int:
        i = 3 + x
        L, LT, T, RT = line[i - 1], prev[i - 1], prev[i], prev[i + 1]
        ctx = (int(self.qt[0][(L - LT) & 0xFF])
               + int(self.qt[1][(LT - T) & 0xFF])
               + int(self.qt[2][(T - RT) & 0xFF]))
        if self.p.five_context:
            LL, TT = line[i - 2], line[i]  # line[i] still holds y-2
            ctx += (int(self.qt[3][(LL - L) & 0xFF])
                    + int(self.qt[4][(TT - T) & 0xFF]))
        return ctx

    def predict(self, prev, line, x: int) -> int:
        i = 3 + x
        return _median3(int(line[i - 1]), int(prev[i]),
                        int(line[i - 1]) + int(prev[i]) - int(prev[i - 1]))


def _decode_plane(c: RangeDecoder, states: bytearray, params: FFV1Params,
                  w: int, h: int) -> np.ndarray:
    pc = _PlaneCoder(params, w)
    pc.start_plane()
    mask = (1 << params.bits) - 1
    out = np.empty((h, w), np.uint8 if params.bits <= 8 else np.uint16)
    for y in range(h):
        prev, line = pc.begin_line()
        for x in range(w):
            ctx = pc.context(prev, line, x)
            if ctx < 0:
                ctx, sign = -ctx, -1
            else:
                sign = 1
            diff = sign * _get_symbol(c, states, ctx * CONTEXT_SIZE, True)
            line[3 + x] = (pc.predict(prev, line, x) + diff) & mask
        out[y] = line[3:3 + w]
    return out


def _encode_plane(c: RangeEncoder, states: bytearray, params: FFV1Params,
                  plane: np.ndarray):
    h, w = plane.shape
    pc = _PlaneCoder(params, w)
    pc.start_plane()
    mask = (1 << params.bits) - 1
    half = 1 << (params.bits - 1)
    for y in range(h):
        prev, line = pc.begin_line()
        row = plane[y]
        for x in range(w):
            ctx = pc.context(prev, line, x)
            sign = 1
            if ctx < 0:
                ctx, sign = -ctx, -1
            diff = (int(row[x]) - pc.predict(prev, line, x))
            # wrap to the signed bits-wide residual ring
            diff = ((diff + half) & mask) - half
            _put_symbol(c, states, ctx * CONTEXT_SIZE, sign * diff, True)
            line[3 + x] = row[x] & mask


# -- frame codec ----------------------------------------------------------

def _plane_dims(params: FFV1Params, w: int, h: int
                ) -> List[Tuple[int, int, int]]:
    """[(w, h, state_set_index)] in coding order."""
    dims = [(w, h, 0)]
    if params.chroma_planes:
        cw = (w + (1 << params.h_shift) - 1) >> params.h_shift
        ch = (h + (1 << params.v_shift) - 1) >> params.v_shift
        dims += [(cw, ch, 1), (cw, ch, 1)]  # Cb, Cr share states
    return dims


class FFV1Decoder:
    """Stateful: params + context states persist across inter frames.

    Decodes through the native C++ implementation (native/ffv1.cpp,
    built at first use); use_native=False runs this module's Python range
    decoder, the plain version (the parity tests do)."""

    def __init__(self, width: int, height: int, use_native: bool = True):
        if not (0 < width <= 16384 and 0 < height <= 16384):
            raise FFV1Error("bad dimensions")
        self.width = width
        self.height = height
        self.params: Optional[FFV1Params] = None
        self.states: List[bytearray] = []
        self._native = None
        if use_native:
            self._native = native.load().ffv1_create(width, height)

    def reset(self):
        """After a seek: drop all inter-frame state; the next frame must
        be a keyframe (which re-carries the parameter set)."""
        if self._native is not None:
            native.load().ffv1_reset(self._native)
            return
        self.params = None
        self.states = []

    def decode(self, data: bytes) -> List[np.ndarray]:
        """One packet -> [Y, Cb, Cr] uint8 planes (or [Y] when gray).

        The keyframe bit and parameter set always ride the default
        state-transition tables; a custom table (coder_type 2) governs
        only the plane payload.  Sets self.h_shift/self.v_shift to the
        stream's chroma geometry as a side effect."""
        if self._native is not None:
            try:
                bits, raw = native.load().ffv1_decode(self._native, data)
            except ValueError as e:
                raise FFV1Error(str(e)) from None
            dtype = np.uint8 if bits <= 8 else np.dtype("<u2")
            planes = [np.frombuffer(b, dtype).reshape(ph, pw)
                      for (b, pw, ph) in raw]
            self.bits = bits
            self._note_shifts(planes)
            return planes
        c = RangeDecoder(data)
        keystate = _fresh_states(CONTEXT_SIZE)
        keyframe = c.get(keystate, 0)
        if keyframe:
            p = _read_params(c)
            self.params = p
            nsets = 2 if p.chroma_planes else 1
            self.states = [
                bytearray([128] * (p.context_count * CONTEXT_SIZE))
                for _ in range(nsets)]
        elif self.params is None:
            raise FFV1Error(
                "inter frame without a prior keyframe (stream must be "
                "entered at a keyframe; FFV1 context states chain)")
        p = self.params
        if p.state_transition is not None:
            c.one, c.zero = p.state_transition
        planes = []
        for (pw, ph, si) in _plane_dims(p, self.width, self.height):
            planes.append(_decode_plane(c, self.states[si], p, pw, ph))
        self.h_shift, self.v_shift = p.h_shift, p.v_shift
        self.bits = p.bits
        return planes

    def _note_shifts(self, planes: List[np.ndarray]):
        """Recover the stream's chroma shifts from decoded plane dims
        (the native path keeps the parameters on its side)."""
        self.h_shift = self.v_shift = 1
        if len(planes) > 1:
            ch, cw = planes[1].shape
            for s in (0, 1, 2):
                if (self.width + (1 << s) - 1) >> s == cw:
                    self.h_shift = s
                    break
            for s in (0, 1, 2):
                if (self.height + (1 << s) - 1) >> s == ch:
                    self.v_shift = s
                    break


class FFV1Encoder:
    """Test-vector authoring encoder (all frame types; keyframes default)."""

    def __init__(self, width: int, height: int,
                 params: Optional[FFV1Params] = None):
        self.width = width
        self.height = height
        self.params = params or FFV1Params()
        self.states: List[bytearray] = []

    def encode(self, planes: List[np.ndarray], keyframe: bool = True
               ) -> bytes:
        p = self.params
        expect = _plane_dims(p, self.width, self.height)
        if len(planes) != len(expect):
            raise FFV1Error(f"need {len(expect)} planes")
        c = RangeEncoder()
        keystate = _fresh_states(CONTEXT_SIZE)
        c.put(keystate, 0, 1 if keyframe else 0)
        if keyframe:
            _write_params(c, p)
            nsets = 2 if p.chroma_planes else 1
            self.states = [
                bytearray([128] * (p.context_count * CONTEXT_SIZE))
                for _ in range(nsets)]
        elif not self.states:
            raise FFV1Error("first frame must be a keyframe")
        if p.state_transition is not None:
            c.one, c.zero = p.state_transition
        dtype = np.uint8 if p.bits <= 8 else np.uint16
        for plane, (pw, ph, si) in zip(planes, expect):
            if plane.shape != (ph, pw):
                raise FFV1Error(
                    f"plane shape {plane.shape} != expected {(ph, pw)}")
            _encode_plane(c, self.states[si], p, plane.astype(dtype))
        return c.finish()


# -- pipeline glue --------------------------------------------------------

def probe_params(data: bytes) -> FFV1Params:
    """Parse only the keyframe bit + parameter set of a packet (cheap:
    a few hundred coder events) so demuxers can pick NV12 vs P010 and
    validate the stream before full decode.  Raises FFV1Error on inter
    frames and malformed headers."""
    c = RangeDecoder(data)
    if not c.get(_fresh_states(), 0):
        raise FFV1Error("stream does not start at a keyframe")
    return _read_params(c)


def _to_biplanar(dec: FFV1Decoder, planes: List[np.ndarray], shift_up: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Decoded planes -> (y, uv) padded to even geometry, payload
    shifted up by `shift_up` bits (0 for NV12, 16-bits for P010).
    4:2:2 and 4:4:4 chroma box-average down to the 4:2:0 grid (what the
    pipeline's autoconvert does for uncompressed sources); gray synthe-
    sizes neutral chroma."""
    dtype = np.uint16 if shift_up or planes[0].dtype != np.uint8 \
        else np.uint8
    yp = planes[0].astype(dtype) << shift_up
    h, w = yp.shape
    if h % 2:
        yp = np.concatenate([yp, yp[-1:]], axis=0)
        h += 1
    if w % 2:
        yp = np.concatenate([yp, yp[:, -1:]], axis=1)
        w += 1
    if len(planes) == 1:
        neutral = 128 << shift_up if dtype == np.uint16 else 128
        up = np.full((h // 2, w // 2), neutral, dtype)
        return np.ascontiguousarray(yp), interleave_chroma(up, up)
    up = planes[1].astype(dtype) << shift_up
    vp = planes[2].astype(dtype) << shift_up
    h_shift, v_shift = dec.h_shift, dec.v_shift

    def half(cp: np.ndarray, axis: int) -> np.ndarray:
        if cp.shape[axis] % 2:
            pad = [(0, 0), (0, 0)]
            pad[axis] = (0, 1)
            cp = np.pad(cp, pad, mode="edge")
        a = cp[0::2] if axis == 0 else cp[:, 0::2]
        b = cp[1::2] if axis == 0 else cp[:, 1::2]
        return ((a.astype(np.uint32) + b + 1) >> 1).astype(dtype)

    def to420(cp: np.ndarray) -> np.ndarray:
        for axis, shift in ((1, h_shift), (0, v_shift)):
            if shift == 0:
                cp = half(cp, axis)
            elif shift == 2:
                cp = np.repeat(cp, 2, axis=axis)
        target = (h // 2, w // 2)
        cp = cp[:target[0], :target[1]]
        if cp.shape != target:
            cp = np.pad(cp, ((0, target[0] - cp.shape[0]),
                             (0, target[1] - cp.shape[1])), mode="edge")
        return cp

    return (np.ascontiguousarray(yp),
            interleave_chroma(to420(up), to420(vp)))


def decode_to_nv12(dec: FFV1Decoder, data: bytes
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One packet -> (y, uv) 8-bit NV12 arrays (deep streams round to
    8 bits; use decode_to_p010 to keep the payload)."""
    planes = dec.decode(data)
    if dec.bits > 8:
        sh = dec.bits - 8
        rnd = 1 << (sh - 1)
        top = (1 << dec.bits) - 1
        planes = [((p.astype(np.uint32) + rnd).clip(max=top) >> sh
                   ).astype(np.uint8) for p in planes]
    return _to_biplanar(dec, planes, 0)


def decode_to_p010(dec: FFV1Decoder, data: bytes
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One packet -> (y, uv) P010-style uint16 arrays: payload in the
    top `dec.bits` bits (8-bit streams upshift by 8, 10-bit by 6)."""
    planes = dec.decode(data)
    return _to_biplanar(dec, planes, 16 - dec.bits)


def encode_frames_i420(frames, width: int, height: int,
                       all_keyframes: bool = True) -> List[bytes]:
    """Author test vectors: iterable of (y, u, v) planes -> packets."""
    enc = FFV1Encoder(width, height)
    out = []
    for i, (y, u, v) in enumerate(frames):
        out.append(enc.encode([y, u, v],
                              keyframe=all_keyframes or i == 0))
    return out
