"""Minimal dependency-free PNG writer (stdlib zlib only).

The reference's screenshot subsystem encodes PNG/JPEG via FFmpeg
(player/screenshot.c -> image_writer.c); this image has no FFmpeg, and
PNG is 30 lines of chunk framing over zlib, so the rebuild carries its
own: 8-bit grayscale or RGB, filter type 0 (None) per scanline, one
IDAT.  Enough for screenshots and dumps; not a general codec.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray, compress_level: int = 6) -> bytes:
    """(H, W) uint8 grayscale or (H, W, 3) uint8 RGB -> PNG bytes."""
    if arr.dtype != np.uint8:
        raise ValueError("encode_png wants uint8 (convert/shift first)")
    if arr.ndim == 2:
        color_type = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"unsupported array shape {arr.shape}")
    h, w = arr.shape[:2]
    raw = np.ascontiguousarray(arr).reshape(h, -1)
    # filter byte 0 (None) prepended to each scanline
    scanlines = np.concatenate(
        [np.zeros((h, 1), np.uint8), raw], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(scanlines, compress_level))
            + _chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray, compress_level: int = 6) -> str:
    with open(path, "wb") as fh:
        fh.write(encode_png(arr, compress_level))
    return path


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse PNG scanline filtering (spec §6: None/Sub/Up/Average/Paeth).

    Row-vectorized for filters 0-2; Average/Paeth carry a true 2-D
    recurrence (left + up) and fall back to a per-byte loop -- fine for
    the image-sequence/screenshot sizes this module serves."""
    rows = raw.reshape(h, 1 + stride)
    filt = rows[:, 0]
    if np.any(filt > 4):
        raise ValueError(f"bad scanline filter {int(filt.max())}")
    out = np.empty((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        f = int(filt[r])
        cur = rows[r, 1:].astype(np.int32)
        if f == 0:
            line = cur
        elif f == 1:  # Sub: x += left  ->  per-lane cumsum mod 256
            line = np.cumsum(cur.reshape(-1, bpp), axis=0,
                             dtype=np.int64).reshape(-1) & 255
            line = line.astype(np.int32)
        elif f == 2:  # Up
            line = (cur + prev) & 255
        else:  # Average (3) / Paeth (4): left-dependency forces a scan
            line = np.empty(stride, np.int32)
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                b = prev[i]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                line[i] = (cur[i] + pred) & 255
        out[r] = line
        prev = line
    return out.astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG to (H, W) gray or (H, W, 3) RGB.

    Reads everything the common encoders write at depth 8: color types
    0/2/3/4/6 (gray, RGB, palette, gray+alpha, RGBA; alpha is dropped),
    all five scanline filters, multiple IDAT chunks.  Adam7 interlace and
    16-bit depth are rejected (rare for frame sources; the reference
    decodes them through FFmpeg which this image lacks).  Raises
    ValueError on malformed input (fuzz-safe)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, meta, plte = 8, [], None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if length > len(data) - pos - 8:
            raise ValueError("truncated PNG chunk")
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            if length != 13:
                raise ValueError("bad IHDR")
            meta = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            plte = np.frombuffer(payload[:(length // 3) * 3],
                                 np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if meta is None or not idat:
        raise ValueError("missing IHDR/IDAT")
    w, h, depth, color_type, _, _, interlace = meta
    if depth != 8:
        raise ValueError(f"unsupported PNG bit depth {depth}")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG not supported")
    ch = _CHANNELS.get(color_type)
    if ch is None:
        raise ValueError(f"bad PNG color type {color_type}")
    if not (0 < w <= 1 << 16 and 0 < h <= 1 << 16):
        raise ValueError("bad PNG geometry")
    stride = w * ch
    expect = h * (1 + stride)
    # cap the inflation at the IHDR-implied size BEFORE allocating: a
    # crafted tiny-header/huge-stream PNG must not balloon memory (the
    # uncapped zlib.decompress of an earlier revision allocated ~870MB
    # from a 400KB input; ADVICE r3)
    dec = zlib.decompressobj()
    try:
        buf = dec.decompress(b"".join(idat), expect + 1)
        while dec.unconsumed_tail and len(buf) <= expect:
            buf += dec.decompress(dec.unconsumed_tail,
                                  expect + 1 - len(buf))
    except zlib.error as e:
        raise ValueError(f"bad PNG zlib stream: {e}") from None
    raw = np.frombuffer(buf, np.uint8)
    if raw.size != expect:
        raise ValueError("PNG pixel data size mismatch")
    px = _unfilter(raw, h, stride, ch).reshape(h, w, ch)
    if color_type == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        idx = px[:, :, 0]
        if int(idx.max(initial=0)) >= len(plte):
            raise ValueError("palette index out of range")
        return plte[idx]
    if color_type in (4, 6):  # drop alpha
        px = px[:, :, :-1]
    return px[:, :, 0] if px.shape[2] == 1 else px
