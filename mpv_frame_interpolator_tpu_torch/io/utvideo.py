"""Ut Video (lossless YUV) codec: pure-Python reference decoder + encoder.

The reference plays Ut Video through libavcodec
(video/decode/vd_lavc.c:1157-1388, codec id AV_CODEC_ID_UTVIDEO); this
rebuild carries its own implementation so lossless capture/archival
media (`ULY0`/`ULY2`/`ULH0`/`ULH2` in AVI or MKV V_MS/VFW) plays without
ffmpeg.  The hot path is native C++ (native/utvideo.cpp, the port's own
library, built at first use); this module is the format oracle the
native decoder is tested against (the plain version, run where the
caller asks with use_native=False), and the encoder used to author test
vectors (no reference encoder exists in this environment -- compliance
follows the public bitstream layout as implemented by every shipping
decoder: canonical Huffman per plane built longest-code-first from a
256-byte length table, per-plane slice offset tables, MSB-first bits in
32-bit little-endian words, left/gradient/median prediction restored
per slice, and the frame-info dword at the END of each packet).

Layout of one frame packet (planar YUV, `planes` = 3):

    plane 0 .. plane N-1, then frame_info (LE32; bits 9:8 = prediction)

Each plane:
    256 bytes   Huffman code lengths per symbol (0 on the shortest
                entry = whole plane is that single symbol and the plane
                ends here; 255 = symbol unused)
    4*slices    cumulative little-endian end offsets of each slice's
                compressed data, relative to the end of this table
    data        concatenated slice bitstreams

Stream configuration rides 16+ bytes of codec private data ("extradata"):
    bytes 0-3   encoder version (opaque)
    bytes 4-7   frame_info_size (LE32; bytes of frame_info, normally 4)
    bytes 8-11  flags (LE32): bits 31-24 = slices-1, bit 11 = interlaced
    bytes 12-15 reserved

Supported fourccs: ULY0/ULH0 (planar 4:2:0) and ULY2/ULH2 (planar
4:2:2); the H variants only signal BT.709 colorimetry.  Interlaced
streams are rejected explicitly.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from mpv_frame_interpolator_tpu_torch import native
from mpv_frame_interpolator_tpu_torch.frame import interleave_chroma

PRED_NONE = 0
PRED_LEFT = 1
PRED_GRADIENT = 2
PRED_MEDIAN = 3

FOURCCS = ("ULY0", "ULY2", "ULH0", "ULH2")


class UtVideoError(ValueError):
    pass


def plane_dims(fourcc: str, width: int, height: int
               ) -> List[Tuple[int, int]]:
    """(w, h) of each plane, Y first."""
    if fourcc in ("ULY0", "ULH0"):
        if width % 2 or height % 2:
            raise UtVideoError("ULY0 needs even dimensions")
        return [(width, height), (width // 2, height // 2),
                (width // 2, height // 2)]
    if fourcc in ("ULY2", "ULH2"):
        if width % 2:
            raise UtVideoError("ULY2 needs even width")
        return [(width, height), (width // 2, height),
                (width // 2, height)]
    raise UtVideoError(f"unsupported Ut Video fourcc {fourcc!r}")


def parse_extradata(extradata: bytes) -> Tuple[int, bool]:
    """-> (slices, interlaced).  Raises UtVideoError on malformed data."""
    if len(extradata) < 16:
        raise UtVideoError("Ut Video extradata must be >= 16 bytes")
    frame_info_size = struct.unpack_from("<I", extradata, 4)[0]
    if frame_info_size != 4:
        raise UtVideoError(f"unsupported frame_info_size "
                           f"{frame_info_size}")
    flags = struct.unpack_from("<I", extradata, 8)[0]
    slices = (flags >> 24) + 1
    interlaced = bool(flags & 0x800)
    return slices, interlaced


def make_extradata(slices: int, version: bytes = b"\x01\x00\x02\x00"
                   ) -> bytes:
    if not 1 <= slices <= 256:
        raise UtVideoError("slices must be in [1, 256]")
    flags = (slices - 1) << 24
    return version + struct.pack("<I", 4) + struct.pack("<I", flags) \
        + b"\x00\x00\x00\x00"


# --------------------------------------------------------------------- #
# canonical Huffman (huffyuv-family construction: sort symbols by
# (length asc, symbol asc), strip 255-length unused entries, then assign
# code values from the LONGEST entry upward)

def _huff_assign(lens: np.ndarray):
    """lens: 256 uint8 -> (order, codes, lengths) arrays over used
    symbols, in assignment order (longest first); or an int symbol for
    the single-symbol plane."""
    order = sorted(range(256), key=lambda s: (lens[s], s))
    if lens[order[0]] == 0:
        return int(order[0])
    last = 255
    while last > 0 and lens[order[last]] == 255:
        last -= 1
    used = order[:last + 1]
    if any(lens[s] == 0 or lens[s] > 32 for s in used):
        raise UtVideoError("invalid Huffman length table")
    code = 0
    syms, codes, lengths = [], [], []
    for s in reversed(used):          # longest codes first
        ln = int(lens[s])
        codes.append(code >> (32 - ln))
        lengths.append(ln)
        syms.append(s)
        nxt = code + (0x80000000 >> (ln - 1))
        if nxt > 0x100000000:
            raise UtVideoError("over-subscribed Huffman table")
        code = nxt
    if code != 0x100000000 and len(used) > 1:
        # under-subscribed tables leave undecodable bit patterns; real
        # encoders always emit complete codes.  Tolerate (decode checks
        # ranges) but a strict encoder never produces this.
        pass
    return np.array(syms), np.array(codes, np.uint64), \
        np.array(lengths, np.int32)


def build_lengths(hist: np.ndarray) -> np.ndarray:
    """Length-limited (<=32) Huffman code lengths for a 256-bin
    histogram, encoder side: unused symbols get 255; a single used
    symbol gets 0."""
    used = np.nonzero(hist)[0]
    lens = np.full(256, 255, np.uint8)
    if len(used) == 0:
        lens[0] = 0
        return lens
    if len(used) == 1:
        lens[used[0]] = 0
        return lens
    # package-merge is overkill here: plain Huffman over <=256 symbols
    # of a uint histogram cannot exceed depth ~40 only with pathological
    # Fibonacci-like counts; clamp by flattening the histogram until the
    # tree fits 32 levels (lossless -- lengths only steer compression).
    counts = hist.astype(np.float64)
    while True:
        import heapq
        heap = [(counts[s], int(s), ("leaf", int(s))) for s in used]
        heapq.heapify(heap)
        tie = 256
        while len(heap) > 1:
            c1, _, n1 = heapq.heappop(heap)
            c2, _, n2 = heapq.heappop(heap)
            heapq.heappush(heap, (c1 + c2, tie, ("node", n1, n2)))
            tie += 1
        depths = {}

        def walk(node, d):
            if node[0] == "leaf":
                depths[node[1]] = max(d, 1)
            else:
                walk(node[1], d + 1)
                walk(node[2], d + 1)
        walk(heap[0][2], 0)
        if max(depths.values()) <= 32:
            for s, d in depths.items():
                lens[s] = d
            return lens
        counts = np.ceil(counts / 2.0)


# --------------------------------------------------------------------- #
# bit IO: MSB-first within 32-bit little-endian words

class _BitWriter:
    def __init__(self):
        self.words: List[int] = []
        self.acc = 0
        self.nbits = 0

    def put(self, code: int, nbits: int):
        self.acc = (self.acc << nbits) | code
        self.nbits += nbits
        while self.nbits >= 32:
            self.nbits -= 32
            self.words.append((self.acc >> self.nbits) & 0xFFFFFFFF)

    def bytes_le(self) -> bytes:
        words = list(self.words)
        if self.nbits:
            words.append((self.acc << (32 - self.nbits)) & 0xFFFFFFFF)
        self.acc = 0
        return b"".join(struct.pack("<I", w) for w in words)


class _BitReader:
    def __init__(self, data: bytes):
        pad = (-len(data)) % 4
        data = data + b"\x00" * pad
        # byteswap LE words -> big-endian bit order
        self.be = np.frombuffer(data, "<u4").astype(">u4").tobytes()
        self.pos = 0
        self.limit = len(self.be) * 8

    def get(self, n: int) -> int:
        if self.pos + n > self.limit:
            raise UtVideoError("bitstream overrun")
        end = self.pos + n
        first = self.pos // 8
        lastb = (end + 7) // 8
        chunk = int.from_bytes(self.be[first:lastb], "big")
        chunk >>= (lastb * 8 - end)
        self.pos = end
        return chunk & ((1 << n) - 1)


# --------------------------------------------------------------------- #
# prediction (per slice, byte wraparound)

def _pred_left_encode(plane: np.ndarray, sstart: int, send: int
                      ) -> np.ndarray:
    rows = plane[sstart:send].astype(np.int16)
    flat = rows.reshape(-1)
    prev = np.concatenate(([0x80], flat[:-1]))
    return ((flat - prev) & 0xFF).astype(np.uint8)


def _pred_left_decode(res: np.ndarray, width: int) -> np.ndarray:
    flat = res.astype(np.uint8)
    # cumulative sum mod 256, seeded 0x80
    out = (np.cumsum(flat.astype(np.uint64)) + 0x80) & 0xFF
    return out.astype(np.uint8).reshape(-1, width)


def _pred_gradient_encode(plane, sstart, send):
    rows = plane[sstart:send].astype(np.int16)
    h, w = rows.shape
    res = np.empty_like(rows)
    # first row: left with 0x80 seed
    res[0, 0] = rows[0, 0] - 0x80
    res[0, 1:] = rows[0, 1:] - rows[0, :-1]
    if h > 1:
        a = rows[1:, :-1]            # left
        b = rows[:-1, :]             # above
        c = rows[:-1, :-1]           # above-left
        res[1:, 0] = rows[1:, 0] - b[:, 0]
        res[1:, 1:] = rows[1:, 1:] - ((a + b[:, 1:] - c) & 0xFF)
    return (res & 0xFF).astype(np.uint8).reshape(-1)


def _pred_gradient_decode(res, width):
    rows = res.reshape(-1, width).astype(np.int16)
    h, w = rows.shape
    out = np.empty((h, w), np.int16)
    acc = 0x80
    for i in range(w):               # first row: left pred
        acc = (acc + rows[0, i]) & 0xFF
        out[0, i] = acc
    for j in range(1, h):
        out[j, 0] = (rows[j, 0] + out[j - 1, 0]) & 0xFF
        for i in range(1, w):
            pred = (out[j, i - 1] + out[j - 1, i]
                    - out[j - 1, i - 1]) & 0xFF
            out[j, i] = (rows[j, i] + pred) & 0xFF
    return out.astype(np.uint8)


def _mid_pred(a, b, c):
    return np.minimum(np.maximum(np.minimum(a, b), c), np.maximum(a, b))


def _pred_median_encode(plane, sstart, send):
    rows = plane[sstart:send].astype(np.int16)
    h, w = rows.shape
    res = np.empty_like(rows)
    res[0, 0] = rows[0, 0] - 0x80
    res[0, 1:] = rows[0, 1:] - rows[0, :-1]
    if h > 1:
        res[1:, 0] = rows[1:, 0] - rows[:-1, 0]
        a = rows[1:, :-1]
        b = rows[:-1, 1:]
        c = rows[:-1, :-1]
        res[1:, 1:] = rows[1:, 1:] - _mid_pred(a, b, (a + b - c) & 0xFF)
    return (res & 0xFF).astype(np.uint8).reshape(-1)


def _pred_median_decode(res, width):
    rows = res.reshape(-1, width).astype(np.int16)
    h, w = rows.shape
    out = np.empty((h, w), np.int16)
    acc = 0x80
    for i in range(w):
        acc = (acc + rows[0, i]) & 0xFF
        out[0, i] = acc
    for j in range(1, h):
        out[j, 0] = (rows[j, 0] + out[j - 1, 0]) & 0xFF
        for i in range(1, w):
            a = out[j, i - 1]
            b = out[j - 1, i]
            c = out[j - 1, i - 1]
            pred = _mid_pred(a, b, (a + b - c) & 0xFF)
            out[j, i] = (rows[j, i] + pred) & 0xFF
    return out.astype(np.uint8)


# --------------------------------------------------------------------- #

def _slice_rows(height: int, slices: int):
    out = []
    send = 0
    for s in range(slices):
        sstart = send
        send = (height * (s + 1)) // slices
        out.append((sstart, send))
    return out


def encode_frame(planes: List[np.ndarray], slices: int = 1,
                 pred: int = PRED_MEDIAN) -> bytes:
    """planes: uint8 2-D arrays (Y, U, V) -> one Ut Video packet."""
    chunks = []
    for plane in planes:
        plane = np.ascontiguousarray(plane, np.uint8)
        h, w = plane.shape
        # residuals per slice
        res_slices = []
        for sstart, send in _slice_rows(h, slices):
            if pred == PRED_LEFT:
                r = _pred_left_encode(plane, sstart, send)
            elif pred == PRED_GRADIENT:
                r = _pred_gradient_encode(plane, sstart, send)
            elif pred == PRED_MEDIAN:
                r = _pred_median_encode(plane, sstart, send)
            elif pred == PRED_NONE:
                r = plane[sstart:send].reshape(-1).copy()
            else:
                raise UtVideoError(f"bad prediction {pred}")
            res_slices.append(r)
        all_res = np.concatenate(res_slices)
        hist = np.bincount(all_res, minlength=256)
        lens = build_lengths(hist)
        assign = _huff_assign(lens)
        chunks.append(lens.tobytes())
        if isinstance(assign, int):     # single-symbol plane: ends here
            continue
        syms, codes, lengths = assign
        code_of = np.zeros(256, np.uint64)
        len_of = np.zeros(256, np.int32)
        code_of[syms] = codes
        len_of[syms] = lengths
        offsets = []
        datas = []
        total = 0
        for r in res_slices:
            bw = _BitWriter()
            for v in r.tolist():
                bw.put(int(code_of[v]), int(len_of[v]))
            d = bw.bytes_le()
            total += len(d)
            offsets.append(total)
            datas.append(d)
        chunks.append(b"".join(struct.pack("<I", o) for o in offsets))
        chunks.extend(datas)
    frame_info = (pred & 3) << 8
    chunks.append(struct.pack("<I", frame_info))
    return b"".join(chunks)


def decode_frame(data: bytes, fourcc: str, width: int, height: int,
                 slices: int) -> List[np.ndarray]:
    """One packet -> uint8 planes (Y, U, V).  Raises UtVideoError on any
    malformed input (fuzz-safe)."""
    if len(data) < 4:
        raise UtVideoError("packet too short")
    frame_info = struct.unpack_from("<I", data, len(data) - 4)[0]
    pred = (frame_info >> 8) & 3
    body = memoryview(data)[:len(data) - 4]
    planes = []
    pos = 0
    for (w, h) in plane_dims(fourcc, width, height):
        if pos + 256 > len(body):
            raise UtVideoError("truncated length table")
        lens = np.frombuffer(body[pos:pos + 256], np.uint8)
        pos += 256
        assign = _huff_assign(lens)
        rows = _slice_rows(h, slices)
        if isinstance(assign, int):
            res_slices = [np.full((send - sstart) * w, assign, np.uint8)
                          for sstart, send in rows]
        else:
            syms, codes, lengths = assign
            if pos + 4 * slices > len(body):
                raise UtVideoError("truncated slice table")
            ends = struct.unpack_from(f"<{slices}I", body, pos)
            pos += 4 * slices
            dstart = pos
            prevend = 0
            res_slices = []
            # per-length first-code table for canonical decode
            bylen = {}
            for s, c, ln in zip(syms.tolist(), codes.tolist(),
                                lengths.tolist()):
                bylen.setdefault(int(ln), []).append((int(c), int(s)))
            tables = {}
            for ln, items in bylen.items():
                items.sort()
                cs = [c for c, _ in items]
                if cs != list(range(cs[0], cs[0] + len(cs))):
                    raise UtVideoError("non-contiguous canonical codes")
                tables[ln] = (cs[0], [s for _, s in items])
            maxlen = max(tables)
            for (sstart, send), end in zip(rows, ends):
                if end < prevend or dstart + end > len(body):
                    raise UtVideoError("bad slice offsets")
                sl = bytes(body[dstart + prevend:dstart + end])
                prevend = end
                br = _BitReader(sl)
                n = (send - sstart) * w
                out = np.empty(n, np.uint8)
                cur = 0
                ln = 0
                filled = 0
                while filled < n:
                    cur = (cur << 1) | br.get(1)
                    ln += 1
                    if ln > maxlen:
                        raise UtVideoError("invalid code in bitstream")
                    t = tables.get(ln)
                    if t is not None and t[0] <= cur < t[0] + len(t[1]):
                        out[filled] = t[1][cur - t[0]]
                        filled += 1
                        cur = 0
                        ln = 0
                res_slices.append(out)
            pos = dstart + prevend
        parts = []
        for (sstart, send), res in zip(rows, res_slices):
            if send == sstart:
                continue
            if pred == PRED_LEFT:
                parts.append(_pred_left_decode(res, w))
            elif pred == PRED_GRADIENT:
                parts.append(_pred_gradient_decode(res, w))
            elif pred == PRED_MEDIAN:
                parts.append(_pred_median_decode(res, w))
            else:
                parts.append(res.reshape(-1, w))
        planes.append(np.concatenate(parts, axis=0) if parts
                      else np.zeros((h, w), np.uint8))
    return planes


def decode_planes(data: bytes, fourcc: str, width: int, height: int,
                  slices: int, use_native: bool = True) -> List[np.ndarray]:
    """The native C++ decoder, or with use_native=False this module's
    Python decoder (the plain version)."""
    if use_native:
        dims = plane_dims(fourcc, width, height)
        y, u, v = native.load().decode_utvideo(data, fourcc, width, height,
                                               slices)
        return [np.frombuffer(b, np.uint8).reshape(ph, pw)
                for b, (pw, ph) in zip((y, u, v), dims)]
    return decode_frame(data, fourcc, width, height, slices)


def decode_to_nv12(data: bytes, fourcc: str, width: int, height: int,
                   slices: int, use_native: bool = True):
    """One packet -> (y, uv) NV12 arrays padded to even height.  4:2:2
    sources box-average vertical chroma pairs down to the 4:2:0 grid
    (what the pipeline's autoconvert does for uncompressed 4:2:2)."""
    yp, up, vp = decode_planes(data, fourcc, width, height, slices,
                               use_native)
    if height % 2:                    # pad to the NV12 grid
        yp = np.concatenate([yp, yp[-1:]], axis=0)
        height += 1
    if fourcc in ("ULY2", "ULH2"):
        if up.shape[0] % 2:
            up = np.concatenate([up, up[-1:]], axis=0)
            vp = np.concatenate([vp, vp[-1:]], axis=0)
        up = ((up[0::2].astype(np.uint16) + up[1::2] + 1) >> 1
              ).astype(np.uint8)
        vp = ((vp[0::2].astype(np.uint16) + vp[1::2] + 1) >> 1
              ).astype(np.uint8)
    return np.ascontiguousarray(yp), interleave_chroma(up, vp)
