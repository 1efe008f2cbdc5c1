"""Minimal Matroska (MKV/WebM container) demuxer for uncompressed video.

The reference demuxes containers through demux_mkv.c (a full EBML parser)
and demux_lavf.c.  This build image has no FFmpeg, so the rebuild ships
its own small EBML/Matroska reader covering the codec-free path:
`V_UNCOMPRESSED` video tracks (raw I420 / NV12 planes in SimpleBlocks),
the format `ffmpeg -c:v rawvideo -f matroska` produces, plus the codecs
the port decodes itself (FFV1, Ut Video through the VfW id, MJPEG).
Other codecs require an external decoder (io/decode.py); trying to open
one here fails with a clear error naming the codec.  The port's copy of
the JAX package's ``io/mkv.py``.

Design: one linear header+cluster scan at open builds a complete frame
index (byte offset, pts) -- the payloads are skipped via their declared
sizes, so indexing a multi-GB file touches only element headers.  After
that, reads and seeks are O(1) pread-style accesses, which also makes the
source trivially compatible with the pipeline's seek path.

Format references (public Matroska/EBML spec, matroska.org):
  EBML header 0x1A45DFA3; Segment 0x18538067; Info 0x1549A966
  (TimestampScale 0x2AD7B1); Tracks 0x1654AE6B (TrackEntry 0xAE,
  TrackNumber 0xD7, CodecID 0x86, Video 0xE0, PixelWidth 0xB0,
  PixelHeight 0xBA, ColourSpace 0x2EB524); Cluster 0x1F43B675
  (Timestamp 0xE7, SimpleBlock 0xA3, BlockGroup 0xA0 / Block 0xA1).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from mpv_frame_interpolator_tpu_torch.frame import (
    FrameFormat, NV12, P010, VideoFrame)
from mpv_frame_interpolator_tpu_torch.io import corrupt_as
from mpv_frame_interpolator_tpu_torch.native import interleave_chroma_into
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("mkv")


class MKVError(ValueError):
    pass


# element IDs (class IDs with the marker bits, as stored)
EBML_HEADER = 0x1A45DFA3
SEGMENT = 0x18538067
SEGMENT_INFO = 0x1549A966
TIMESTAMP_SCALE = 0x2AD7B1
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_TYPE = 0x83
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
DEFAULT_DURATION = 0x23E383
VIDEO = 0xE0
PIXEL_WIDTH = 0xB0
PIXEL_HEIGHT = 0xBA
COLOUR_SPACE = 0x2EB524
CLUSTER = 0x1F43B675
CLUSTER_TIMESTAMP = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1
BLOCK_TIMESTAMP_REL = None  # relative ts lives inside the block header

_MAX_DIM = 16384
_MAX_PIXELS = 1 << 27


def _read_vint(fh: BinaryIO, keep_marker: bool) -> Tuple[Optional[int], int]:
    """EBML variable-length integer -> (value, total length).

    keep_marker=True returns the raw bytes as stored (element IDs);
    False strips the length-marker bit (sizes / track numbers).
    Returns (None, 0) at clean EOF."""
    first = fh.read(1)
    if not first:
        return None, 0
    b0 = first[0]
    if b0 == 0:
        raise MKVError("invalid EBML vint (zero leading byte)")
    length = 1
    mask = 0x80
    while not (b0 & mask):
        length += 1
        mask >>= 1
        if length > 8:
            raise MKVError("EBML vint longer than 8 bytes")
    rest = fh.read(length - 1)
    if len(rest) < length - 1:
        raise MKVError("truncated EBML vint")
    val = b0 if keep_marker else (b0 & (mask - 1))
    for byte in rest:
        val = (val << 8) | byte
    return val, length


def _read_uint(data: bytes) -> int:
    val = 0
    for b in data:
        val = (val << 8) | b
    return val


@dataclasses.dataclass
class _Track:
    number: int = 0
    codec_id: str = ""
    codec_private: bytes = b""
    width: int = 0
    height: int = 0
    colour_space: bytes = b""
    default_duration_ns: int = 0
    is_video: bool = False


class MKVReader:
    """Matroska demuxer for V_UNCOMPRESSED video -> VideoFrame.

    Raises MKVError with the codec name for compressed tracks (those need
    an external decoder, io/decode.py)."""

    def __init__(self, path, start_pts: float = 0.0,
                 use_native: bool = True):
        # path or any seekable binary file-like (e.g. stream.HttpFile)
        self._fh = open(path, "rb") if isinstance(path, str) else path
        self._start_pts = start_pts
        self._use_native = use_native
        self.timestamp_scale = 1000000          # ns per tick (default 1ms)
        self.track: Optional[_Track] = None
        # frame index: (byte offset of payload, payload size, pts seconds)
        self._index: List[Tuple[int, int, float]] = []
        self._pos = 0                           # next frame to read
        with corrupt_as(MKVError):
            self._parse()
        if self.track is None:
            raise MKVError("no video track found")
        t = self.track
        if t.codec_id == "V_MJPEG":
            # in-process baseline-JPEG decode (io/jpeg.py); every other
            # compressed codec still needs the external decoder
            self._layout = "mjpeg"
        elif t.codec_id == "V_MS/VFW/FOURCC" and len(t.codec_private) >= 40:
            # VfW shim: CodecPrivate = BITMAPINFOHEADER + codec extradata
            # (how Ut Video rides Matroska)
            from mpv_frame_interpolator_tpu_torch.io import utvideo as _ut
            vfw_fourcc = t.codec_private[16:20].decode("latin1")
            if vfw_fourcc not in _ut.FOURCCS:
                raise MKVError(
                    f"VfW codec {vfw_fourcc!r} needs an external decoder")
            self._layout = "utvideo"
            self._ut_fourcc = vfw_fourcc
            try:
                self._ut_slices, interlaced = _ut.parse_extradata(
                    t.codec_private[40:])
            except _ut.UtVideoError as e:
                raise MKVError(f"bad Ut Video stream header: {e}") \
                    from None
            if interlaced:
                raise MKVError("interlaced Ut Video is not supported")
        elif t.codec_id == "V_FFV1":
            from mpv_frame_interpolator_tpu_torch.io import ffv1 as _ffv1
            if t.codec_private:
                # v3+ carries a range-coded ConfigurationRecord whose
                # first symbol is the version; v0/1 CodecPrivate is empty
                try:
                    pc = _ffv1.RangeDecoder(t.codec_private)
                    ver = _ffv1._get_symbol(
                        pc, _ffv1._fresh_states(), 0, False)
                except _ffv1.FFV1Error:
                    ver = 0
                if ver >= 2:
                    raise MKVError(
                        f"FFV1 version {ver} (sliced, ConfigurationRecord"
                        f") needs an external decoder; v0/1 decode "
                        f"natively")
            self._layout = "ffv1"
            self._ffv1 = None
            self._ffv1_expect = -1
            self._ffv1_bits = 8
            if self._index:      # probe depth: params ride keyframe 0
                off, size, _ = self._index[0]
                self._fh.seek(off)
                try:
                    self._ffv1_bits = _ffv1.probe_params(
                        self._fh.read(min(size, 4096))).bits
                except _ffv1.FFV1Error as e:
                    raise MKVError(f"bad FFV1 stream: {e}") from None
        elif t.codec_id != "V_UNCOMPRESSED":
            raise MKVError(
                f"track codec {t.codec_id!r} needs an external decoder "
                f"(V_UNCOMPRESSED, V_MJPEG, V_FFV1 and VfW Ut Video are "
                f"demuxed+decoded natively; see io/decode.py)")
        else:
            fourcc = t.colour_space.decode("ascii", "replace").strip("\0 ")
            if fourcc in ("I420", "IYUV", ""):
                self._layout = "i420"
            elif fourcc == "NV12":
                self._layout = "nv12"
            else:
                raise MKVError(f"unsupported uncompressed layout {fourcc!r}")
        if not (0 < t.width <= _MAX_DIM and 0 < t.height <= _MAX_DIM
                and t.width * t.height <= _MAX_PIXELS):
            raise MKVError(f"bad video dimensions {t.width}x{t.height}")
        if (t.width % 2 or t.height % 2) \
                and self._layout not in ("mjpeg", "utvideo", "ffv1"):
            raise MKVError("4:2:0 requires even dimensions")
        self.width, self.height = t.width, t.height
        self.fps = (1e9 / t.default_duration_ns
                    if t.default_duration_ns else self._infer_fps())
        # DefaultDuration is ns-rounded: 1/24 s stores as 41666667 ns =
        # 23.999999808 fps, which makes cadence math emit spurious
        # repeats.  Snap to the exact standard rate when within rounding
        # distance (mpv's mp_get_playback_fps container-fps fixing).
        for cand in (round(self.fps),                       # integer fps
                     round(self.fps * 1001 / 1000) * 1000 / 1001):  # NTSC
            if cand > 0 and abs(self.fps - cand) < 1e-4 * cand:
                self.fps = float(cand)
                break
        if t.default_duration_ns and self.fps > 0:
            # CFR pts snap (mpv's demux pts fixing analog): container
            # ticks quantize timestamps; when a block timestamp is
            # within 1.5 ticks of the (corrected-fps) frame grid,
            # restore the exact rational pts so cadence math
            # round-trips losslessly
            tol = 1.5 * self.timestamp_scale / 1e9
            snapped = []
            for off, size, ts in self._index:
                n = round(ts * self.fps)
                snapped.append((off, size, n / self.fps)
                               if abs(ts - n / self.fps) <= tol
                               else (off, size, ts))
            self._index = snapped
        pixfmt = P010 if getattr(self, "_ffv1_bits", 8) > 8 else NV12
        self.fmt = FrameFormat(self.width + self.width % 2,
                               self.height + self.height % 2, pixfmt)
        self._expected = self.width * self.height * 3 // 2

    # -- parsing ----------------------------------------------------------

    def _parse(self):
        fh = self._fh
        eid, _ = _read_vint(fh, True)
        if eid != EBML_HEADER:
            raise MKVError("not an EBML/Matroska file")
        size, _ = _read_vint(fh, False)
        fh.seek(size, 1)
        eid, _ = _read_vint(fh, True)
        if eid != SEGMENT:
            raise MKVError("no Segment element")
        seg_size, _ = _read_vint(fh, False)
        seg_end = None
        if seg_size != (1 << 56) - 1:           # "unknown size" sentinel
            seg_end = fh.tell() + seg_size
        while True:
            if seg_end is not None and fh.tell() >= seg_end:
                break
            eid, n = _read_vint(fh, True)
            if eid is None:
                break
            size, _ = _read_vint(fh, False)
            start = fh.tell()
            if eid == SEGMENT_INFO:
                self._parse_info(start, size)
            elif eid == TRACKS:
                self._parse_tracks(start, size)
            elif eid == CLUSTER:
                self._parse_cluster(start, size)
            fh.seek(start + size)

    def _children(self, start: int, size: int):
        """Iterate (id, payload offset, payload size) of a master element."""
        fh = self._fh
        fh.seek(start)
        end = start + size
        while fh.tell() < end:
            eid, _ = _read_vint(fh, True)
            if eid is None:
                return
            esize, _ = _read_vint(fh, False)
            pos = fh.tell()
            yield eid, pos, esize
            fh.seek(pos + esize)

    def _parse_info(self, start: int, size: int):
        for eid, pos, esize in self._children(start, size):
            if eid == TIMESTAMP_SCALE:
                self._fh.seek(pos)
                self.timestamp_scale = _read_uint(self._fh.read(esize))

    def _parse_tracks(self, start: int, size: int):
        for eid, pos, esize in self._children(start, size):
            if eid != TRACK_ENTRY:
                continue
            t = _Track()
            for cid, cpos, csize in list(self._children(pos, esize)):
                self._fh.seek(cpos)
                data = self._fh.read(csize)
                if cid == TRACK_NUMBER:
                    t.number = _read_uint(data)
                elif cid == TRACK_TYPE:
                    t.is_video = _read_uint(data) == 1
                elif cid == CODEC_ID:
                    t.codec_id = data.decode("ascii", "replace")
                elif cid == CODEC_PRIVATE:
                    t.codec_private = data
                elif cid == DEFAULT_DURATION:
                    t.default_duration_ns = _read_uint(data)
                elif cid == VIDEO:
                    for vid, vpos, vsize in list(self._children(cpos, csize)):
                        self._fh.seek(vpos)
                        vdata = self._fh.read(vsize)
                        if vid == PIXEL_WIDTH:
                            t.width = _read_uint(vdata)
                        elif vid == PIXEL_HEIGHT:
                            t.height = _read_uint(vdata)
                        elif vid == COLOUR_SPACE:
                            t.colour_space = vdata
            if t.is_video and self.track is None:
                self.track = t

    def _parse_cluster(self, start: int, size: int):
        cluster_ts = 0
        for eid, pos, esize in self._children(start, size):
            if eid == CLUSTER_TIMESTAMP:
                self._fh.seek(pos)
                cluster_ts = _read_uint(self._fh.read(esize))
            elif eid in (SIMPLE_BLOCK, BLOCK):
                self._index_block(pos, esize, cluster_ts)
            elif eid == BLOCK_GROUP:
                for gid, gpos, gsize in list(self._children(pos, esize)):
                    if gid == BLOCK:
                        self._index_block(gpos, gsize, cluster_ts)

    def _index_block(self, pos: int, size: int, cluster_ts: int):
        fh = self._fh
        fh.seek(pos)
        tracknum, n = _read_vint(fh, False)
        rel = struct.unpack(">h", fh.read(2))[0]
        flags = fh.read(1)[0]
        if self.track is not None and tracknum != self.track.number:
            return
        lacing = (flags >> 1) & 3
        if lacing != 0:
            raise MKVError("laced blocks are not supported for raw video")
        header = n + 3
        ts_ns = (cluster_ts + rel) * self.timestamp_scale
        self._index.append((pos + header, size - header, ts_ns / 1e9))

    def _infer_fps(self) -> float:
        if len(self._index) >= 2:
            dts = [b[2] - a[2] for a, b in zip(self._index, self._index[1:])]
            dt = float(np.median(dts))
            if dt > 0:
                return 1.0 / dt
        return 0.0

    # -- reading ----------------------------------------------------------

    def n_frames(self) -> int:
        return len(self._index)

    def seekable(self) -> bool:
        return True

    def seek_frame(self, n: int):
        self._pos = max(min(int(n), len(self._index)), 0)

    def seek_pts(self, pts: float) -> float:
        target = pts - self._start_pts
        lo = 0
        for i, (_, _, t) in enumerate(self._index):
            if t <= target + 1e-9:
                lo = i
            else:
                break
        self._pos = lo
        return self._start_pts + self._index[lo][2] if self._index else 0.0

    def _decode_payload(self, data: bytes) -> VideoFrame:
        w, h = self.width, self.height
        if self._layout == "mjpeg":
            from mpv_frame_interpolator_tpu_torch.io.jpeg import (
                decode_jpeg_frame)
            try:
                frame = decode_jpeg_frame(data, nominal_fps=self.fps,
                                          use_native=self._use_native)
            except ValueError as e:
                raise MKVError(f"bad MJPEG frame: {e}") from None
            if (frame.fmt.width, frame.fmt.height) != (self.fmt.width,
                                                       self.fmt.height):
                raise MKVError(
                    f"MJPEG frame geometry {frame.fmt.width}x"
                    f"{frame.fmt.height} != track {w}x{h}")
            return frame
        if self._layout == "utvideo":
            from mpv_frame_interpolator_tpu_torch.io import utvideo as _ut
            try:
                y, uv = _ut.decode_to_nv12(data, self._ut_fourcc, w, h,
                                           self._ut_slices,
                                           self._use_native)
            except ValueError as e:
                raise MKVError(f"bad Ut Video frame: {e}") from None
            return VideoFrame(y, uv, self.fmt, nominal_fps=self.fps)
        if self._layout == "ffv1":
            from mpv_frame_interpolator_tpu_torch.io import ffv1 as _ffv1
            if self._ffv1 is None:
                self._ffv1 = _ffv1.FFV1Decoder(w, h, self._use_native)
            if self._pos - 1 != self._ffv1_expect:
                self._ffv1.reset()     # seek: re-enter at a keyframe
            deep = self.fmt.pixfmt == P010
            try:
                y, uv = (_ffv1.decode_to_p010 if deep
                         else _ffv1.decode_to_nv12)(self._ffv1, data)
            except ValueError as e:
                raise MKVError(f"bad FFV1 frame: {e}") from None
            self._ffv1_expect = self._pos
            return VideoFrame(y, uv, self.fmt, nominal_fps=self.fps)
        if len(data) < self._expected:
            raise MKVError(f"short frame payload ({len(data)} bytes, "
                           f"need {self._expected})")
        y = np.frombuffer(data, np.uint8, w * h).reshape(h, w)
        if self._layout == "nv12":
            uv = np.frombuffer(data, np.uint8, (h // 2) * w,
                               w * h).reshape(h // 2, w)
            uv = np.ascontiguousarray(uv)
        else:
            csz = (w // 2) * (h // 2)
            u = np.frombuffer(data, np.uint8, csz,
                              w * h).reshape(h // 2, w // 2)
            v = np.frombuffer(data, np.uint8, csz,
                              w * h + csz).reshape(h // 2, w // 2)
            uv = np.empty((h // 2, w), np.uint8)
            if self._use_native:
                interleave_chroma_into(u, v, uv)
            else:
                uv[:, 0::2], uv[:, 1::2] = u, v
        return VideoFrame(np.ascontiguousarray(y), uv, self.fmt,
                          nominal_fps=self.fps)

    def __iter__(self) -> Iterator[VideoFrame]:
        while self._pos < len(self._index):
            off, size, ts = self._index[self._pos]
            self._pos += 1
            self._fh.seek(off)
            frame = self._decode_payload(self._fh.read(size))
            frame.pts = self._start_pts + ts
            yield frame

    def close(self):
        self._fh.close()


# -- muxer ----------------------------------------------------------------

def _w_vint_id(eid: int) -> bytes:
    out = []
    while eid:
        out.append(eid & 0xFF)
        eid >>= 8
    return bytes(reversed(out))


def _w_vint_size(n: int, width: int = 0) -> bytes:
    for length in range(width or 1, 9):
        if n < (1 << (7 * length)) - 1 and (not width or length == width):
            return (n | (1 << (7 * length))).to_bytes(length, "big")
    raise ValueError(f"size {n} does not fit")


def _w_elem(eid: int, payload: bytes) -> bytes:
    return _w_vint_id(eid) + _w_vint_size(len(payload)) + payload


def _w_uint(eid: int, v: int) -> bytes:
    return _w_elem(eid, v.to_bytes((v.bit_length() + 7) // 8 or 1, "big"))


class MKVWriter:
    """Streaming Matroska muxer for one video track (the encode sink's
    container, vo_lavc/encode_lavc.c analog).  Payload-agnostic: pass
    the codec id + ready packets (V_FFV1 from io/ffv1, or
    V_UNCOMPRESSED planes).  Clusters hold `cluster_frames` SimpleBlocks
    with honest keyframe flags; the Segment is written with the
    unknown-size sentinel and patched to the real size on close when
    the file is seekable (both forms are spec-legal and round-trip
    through MKVReader)."""

    TS_SCALE = 100000                   # 0.1 ms ticks (finer than the
                                        # 1 ms default: CFR pts survive)

    def __init__(self, fh, width: int, height: int, fps: float,
                 codec_id: str = "V_FFV1", codec_private: bytes = b"",
                 cluster_frames: int = 24):
        self._fh = fh
        self.fps = fps if fps > 0 else 24.0
        self._cluster_frames = max(1, cluster_frames)
        self._pending = []              # [(rel_ticks, keyframe, data)]
        self._cluster_ts = None         # ticks of first frame in cluster
        self._n = 0
        fh.write(_w_elem(EBML_HEADER, _w_uint(0x4286, 1)
                         + _w_elem(0x4282, b"matroska")))
        fh.write(_w_vint_id(SEGMENT))
        self._seg_size_off = fh.tell()
        fh.write(b"\x01" + b"\xff" * 7)     # unknown size (patched)
        self._seg_start = fh.tell()
        info = _w_uint(0x2AD7B1, self.TS_SCALE)
        fh.write(_w_elem(0x1549A966, info))
        video = _w_elem(0xE0, _w_uint(0xB0, width) + _w_uint(0xBA, height))
        track = _w_elem(0xAE, _w_uint(0xD7, 1) + _w_uint(0x83, 1)
                        + _w_elem(0x86, codec_id.encode("ascii"))
                        + (_w_elem(0x63A2, codec_private)
                           if codec_private else b"")
                        + _w_uint(0x23E383, int(round(1e9 / self.fps)))
                        + video)
        fh.write(_w_elem(0x1654AE6B, track))

    def add(self, data: bytes, keyframe: bool = True,
            pts: float = None):
        ticks = int(round((pts if pts is not None
                           else self._n / self.fps)
                          * 1e9 / self.TS_SCALE))
        if self._cluster_ts is None:
            self._cluster_ts = ticks
        self._pending.append((ticks - self._cluster_ts, keyframe, data))
        self._n += 1
        # relative block timestamps are int16 ticks: flush on range, too
        if (len(self._pending) >= self._cluster_frames
                or self._pending[-1][0] > 30000):
            self._flush_cluster()

    def _flush_cluster(self):
        if not self._pending:
            return
        body = _w_uint(0xE7, self._cluster_ts)
        for rel, key, data in self._pending:
            hdr = (_w_vint_size(1) + int(rel).to_bytes(2, "big", signed=True)
                   + (b"\x80" if key else b"\x00"))
            body += _w_elem(0xA3, hdr + data)
        self._fh.write(_w_elem(0x1F43B675, body))
        self._pending = []
        self._cluster_ts = None

    def close(self):
        self._flush_cluster()
        if self._fh.seekable():
            end = self._fh.tell()
            self._fh.seek(self._seg_size_off)
            self._fh.write(_w_vint_size(end - self._seg_start, width=8))
            self._fh.seek(end)
        self._fh.flush()
