"""The port's host IO modules against their originals in the JAX package
(io/mkv, io/avi, io/mp4, io/ffv1, io/utvideo, io/jpeg, utils/png, io/mf,
io/playlist, io/cache, io/reverse, io/filters, io/ingest, the sinks):
the same inputs, made from a numpy seed at small sizes, through both.

The JAX package runs its Python codecs here (its own extension is not
built); the port runs its native library (built at first use by g++)
and, with ``use_native=False``, its Python codecs.  FFV1 and Ut Video
decode bit for bit; the port's Pillow JPEG path equals the JAX Pillow
path bit for bit, and its native JPEG decoder stays within the JAX
package's own bounds for two independent IDCTs
(tests/test_jpeg.py::test_pil_fallback_close_to_native)."""

import dataclasses
import io
import struct

import numpy as np
import pytest

from mpv_frame_interpolator_tpu.io import avi as jax_avi
from mpv_frame_interpolator_tpu.io import cache as jax_cache
from mpv_frame_interpolator_tpu.io import ffv1 as jax_ffv1
from mpv_frame_interpolator_tpu.io import filters as jax_filters
from mpv_frame_interpolator_tpu.io import jpeg as jax_jpeg
from mpv_frame_interpolator_tpu.io import mf as jax_mf
from mpv_frame_interpolator_tpu.io import mkv as jax_mkv
from mpv_frame_interpolator_tpu.io import mp4 as jax_mp4
from mpv_frame_interpolator_tpu.io import playlist as jax_playlist
from mpv_frame_interpolator_tpu.io import reverse as jax_reverse
from mpv_frame_interpolator_tpu.io import synthetic as jax_synthetic
from mpv_frame_interpolator_tpu.io import utvideo as jax_ut
from mpv_frame_interpolator_tpu.utils import osd as jax_osd
from mpv_frame_interpolator_tpu.utils import png as jax_png
from mpv_frame_interpolator_tpu_torch import frame as port_frame
from mpv_frame_interpolator_tpu_torch import native
from mpv_frame_interpolator_tpu_torch.io import avi as port_avi
from mpv_frame_interpolator_tpu_torch.io import cache as port_cache
from mpv_frame_interpolator_tpu_torch.io import ffv1 as port_ffv1
from mpv_frame_interpolator_tpu_torch.io import filters as port_filters
from mpv_frame_interpolator_tpu_torch.io import ingest as port_ingest
from mpv_frame_interpolator_tpu_torch.io import jpeg as port_jpeg
from mpv_frame_interpolator_tpu_torch.io import mf as port_mf
from mpv_frame_interpolator_tpu_torch.io import mkv as port_mkv
from mpv_frame_interpolator_tpu_torch.io import mp4 as port_mp4
from mpv_frame_interpolator_tpu_torch.io import playlist as port_playlist
from mpv_frame_interpolator_tpu_torch.io import reverse as port_reverse
from mpv_frame_interpolator_tpu_torch.io import sinks as port_sinks
from mpv_frame_interpolator_tpu_torch.io import utvideo as port_ut
from mpv_frame_interpolator_tpu_torch.io.pinned import PinnedPool
from mpv_frame_interpolator_tpu_torch.pipeline.engine import OutputFrame
from mpv_frame_interpolator_tpu_torch.utils import osd as port_osd
from mpv_frame_interpolator_tpu_torch.utils import png as port_png
from test_jpeg import build_avi, pil_jpeg, raw_i420, smooth_rgb
from test_mkv import build_mkv
from test_mp4 import build_mp4

W, H = 64, 48


@pytest.fixture(scope="module")
def lib():
    """The port's native library; skips only where it cannot be built
    (no C++ compiler or no Python.h), as card tests skip without a card."""
    missing = native.toolchain_missing()
    if missing:
        pytest.skip(f"the native library cannot be built here: {missing}")
    return native.load()


def clip(n=6, w=W, h=H, name="moving_box"):
    cfg = jax_synthetic.SyntheticConfig(width=w, height=h, fps=24.0)
    return list(getattr(jax_synthetic, name)(cfg, n))


def same_frames(a, b, pts=True):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert (x.fmt.width, x.fmt.height, x.fmt.pixfmt) == (
            y.fmt.width, y.fmt.height, y.fmt.pixfmt)
        np.testing.assert_array_equal(x.y, y.y)
        np.testing.assert_array_equal(x.uv, y.uv)
        if pts:
            assert x.pts == y.pts


def ffv1_payloads(frames, bits=8):
    enc = jax_ffv1.FFV1Encoder(W, H, jax_ffv1.FFV1Params(bits=bits))
    out = []
    for f in frames:
        y, u, v = f.y, f.uv[:, 0::2], f.uv[:, 1::2]
        if bits > 8:
            y, u, v = (p.astype(np.uint16) << 2 for p in (y, u, v))
        out.append(enc.encode([y, np.ascontiguousarray(u),
                               np.ascontiguousarray(v)]))
    return out


def ut_payload(f, slices=2):
    u, v = f.uv[:, 0::2], f.uv[:, 1::2]
    return jax_ut.encode_frame([f.y, np.ascontiguousarray(u),
                                np.ascontiguousarray(v)], slices=slices,
                               pred=jax_ut.PRED_MEDIAN)


def vfw_private(fourcc=b"ULY0", slices=3):
    bih = struct.pack("<iiiHH4sIiiII", 40 + 16, W, H, 1, 24, fourcc,
                      W * H * 3, 0, 0, 0, 0)
    return bih + jax_ut.make_extradata(slices)


def container_bytes(kind: str, frames):
    if kind == "mkv-i420":
        return build_mkv(frames, W, H), ".mkv"
    if kind == "mkv-nv12":
        return build_mkv(frames, W, H, colour=b"NV12", layout="nv12"), ".mkv"
    if kind == "mkv-ffv1":
        return build_mkv(None, W, H, codec=b"V_FFV1",
                         payloads=ffv1_payloads(frames)), ".mkv"
    if kind == "mkv-ffv1-10bit":
        return build_mkv(None, W, H, codec=b"V_FFV1",
                         payloads=ffv1_payloads(frames, 10)), ".mkv"
    if kind == "mkv-utvideo":
        return build_mkv(None, W, H, codec=b"V_MS/VFW/FOURCC",
                         payloads=[ut_payload(f, 3) for f in frames],
                         codec_private=vfw_private()), ".mkv"
    if kind == "mkv-mjpeg":
        return build_mkv(None, W, H, codec=b"V_MJPEG",
                         payloads=jpegs(len(frames))), ".mkv"
    if kind == "avi-mjpeg":
        return build_avi(jpegs(len(frames)), W, H), ".avi"
    if kind == "mp4-mjpeg":
        return build_mp4(None, W, H, fourcc=b"jpeg",
                         payloads=jpegs(len(frames))), ".mp4"
    if kind == "avi-i420":
        return build_avi([raw_i420(f) for f in frames], W, H,
                         fourcc=b"I420"), ".avi"
    if kind == "avi-utvideo":
        return build_avi([ut_payload(f) for f in frames], W, H,
                         fourcc=b"ULY0",
                         extradata=jax_ut.make_extradata(2)), ".avi"
    if kind == "avi-ffv1":
        return build_avi(ffv1_payloads(frames), W, H, fourcc=b"FFV1"), ".avi"
    if kind == "mp4-i420":
        return build_mp4(frames, W, H), ".mp4"
    if kind == "mp4-nv12":
        return build_mp4(frames, W, H, fourcc=b"NV12", layout="nv12"), ".mp4"
    raise KeyError(kind)


def jpegs(n):
    return [pil_jpeg(smooth_rgb(W, H, s), quality=90) for s in range(n)]


_READERS = {".mkv": (jax_mkv.MKVReader, port_mkv.MKVReader),
            ".avi": (jax_avi.AVIReader, port_avi.AVIReader),
            ".mp4": (jax_mp4.MP4Reader, port_mp4.MP4Reader)}

_KINDS = ["mkv-i420", "mkv-nv12", "mkv-ffv1", "mkv-ffv1-10bit",
          "mkv-utvideo", "avi-i420", "avi-utvideo", "avi-ffv1", "mp4-i420",
          "mp4-nv12"]


# --- the container readers ---------------------------------------------------

@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("kind", _KINDS)
def test_container_reader_yields_the_original_frames(tmp_path, lib, kind,
                                                     use_native):
    data, suffix = container_bytes(kind, clip())
    path = tmp_path / ("c" + suffix)
    path.write_bytes(data)
    jax_cls, port_cls = _READERS[suffix]
    want = list(jax_cls(str(path)))
    rdr = port_cls(str(path), use_native=use_native)
    assert (rdr.width, rdr.height, rdr.fps) == (W, H, want[0].nominal_fps)
    same_frames(want, rdr)
    # seek back into the middle (FFV1 re-enters at a keyframe)
    rdr.seek_pts(want[3].pts)
    same_frames(want[3:], rdr)
    rdr.close()


@pytest.mark.parametrize("kind", ["mkv-mjpeg", "avi-mjpeg", "mp4-mjpeg"])
def test_mjpeg_tracks_as_the_original(tmp_path, lib, kind):
    """MJPEG tracks: the Pillow path bit for bit, the native decoder
    within the luma bound of two independent IDCTs."""
    data, suffix = container_bytes(kind, clip(4))
    path = tmp_path / ("c" + suffix)
    path.write_bytes(data)
    jax_cls, port_cls = _READERS[suffix]
    want = list(jax_cls(str(path)))
    same_frames(want, port_cls(str(path), use_native=False))
    got = list(port_cls(str(path)))
    assert [f.pts for f in got] == [f.pts for f in want]
    for a, b in zip(want, got):
        assert np.abs(a.y.astype(int) - b.y.astype(int)).max() <= 3


@pytest.mark.parametrize("kind", ["mkv-i420", "mkv-nv12", "avi-i420",
                                  "mp4-i420", "mkv-ffv1", "mkv-utvideo"])
def test_native_ingest_yields_the_original_frames(tmp_path, lib, kind):
    """``open_container``: raw video through the C++ indexed ring into
    pooled buffers (recycled as they go), compressed video through the
    reader's native decoders; and the native y4m ring."""
    data, suffix = container_bytes(kind, clip(7))
    path = tmp_path / ("c" + suffix)
    path.write_bytes(data)
    want = list(_READERS[suffix][0](str(path)))
    src = port_ingest.open_container(str(path), device="cpu")
    raw = kind.split("-")[1] in ("i420", "nv12")
    assert isinstance(src, port_ingest.NativeIndexedSource) == raw
    got = []
    for f in src:
        got.append(f.copy())
        got[-1].pts = f.pts
        if f.recycle is not None:
            f.recycle()
    same_frames(want, got)
    src.seek_frame(2)
    same_frames(want[2:], [f.copy() for f in src], pts=False)
    if raw:
        assert src.stats()["recycled"] == len(want)
    src.close()


def test_native_y4m_ring_reads_what_the_python_reader_reads(tmp_path, lib):
    from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MReader, Y4MWriter
    frames = clip(9)
    path = tmp_path / "c.y4m"
    with open(path, "wb") as fh:
        w = Y4MWriter(fh, W, H, 24.0)
        for f in frames:
            w.write(f)
    want = [f.copy() for f in Y4MReader(open(path, "rb"))]
    pool = PinnedPool(8, device="cpu")
    src = port_ingest.NativeY4MSource(str(path), pool=pool)
    held = list(src)        # never recycled: the ring grows, no deadlock
    same_frames(want, held, pts=False)
    assert [f.pts for f in held] == pytest.approx(
        [i / 24.0 for i in range(9)])
    for f in held:
        f.recycle()
    src.seek_pts(5 / 24.0)
    same_frames(want[5:], [f.copy() for f in src], pts=False)
    assert src.stats()["pinned"] is False
    src.close()


def test_open_y4m_takes_the_python_reader_for_odd_sizes(tmp_path, lib):
    """(The JAX package's Python reader raises on odd sizes: the port's
    crops them to even.)"""
    from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MReader
    path = tmp_path / "odd.y4m"
    rng = np.random.default_rng(2)
    path.write_bytes(b"YUV4MPEG2 W63 H47 F24:1 C420jpeg\n" + b"".join(
        b"FRAME\n" + rng.integers(0, 256, 63 * 47 + 2 * 31 * 23,
                                   dtype=np.uint8).tobytes()
        for _ in range(3)))
    src = port_ingest.open_y4m(str(path), device="cpu")
    assert isinstance(src, Y4MReader) and (src.fmt.width,
                                           src.fmt.height) == (62, 46)
    with open(path, "rb") as fh:
        same_frames([f.copy() for f in Y4MReader(fh)],
                    [f.copy() for f in src], pts=False)
    with pytest.raises(ValueError, match="even dimensions"):
        port_ingest.NativeY4MSource(str(path))


# --- the codecs -------------------------------------------------------------

def _ffv1_planes(w, h, hs, vs, bits, seed):
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    dt = np.uint8 if bits == 8 else np.uint16
    y = ((np.add.outer(np.arange(h) * 3, np.arange(w) * 2)
          + rng.integers(0, 40, (h, w))) % (top + 1)).astype(dt)
    cw, ch = (w + (1 << hs) - 1) >> hs, (h + (1 << vs) - 1) >> vs
    u = rng.integers(0, top + 1, (ch, cw)).astype(dt)
    v = rng.integers(0, top + 1, (ch, cw)).astype(dt)
    return [y, u, v]


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("w,h,hs,vs", [(40, 24, 1, 1), (33, 21, 1, 0)])
def test_ffv1_decoders_equal_the_original(lib, bits, w, h, hs, vs):
    params = jax_ffv1.FFV1Params(bits=bits, h_shift=hs, v_shift=vs)
    enc = jax_ffv1.FFV1Encoder(w, h, params)
    frames = [_ffv1_planes(w, h, hs, vs, bits, s) for s in range(3)]
    pkts = [enc.encode(frames[0]), enc.encode(frames[1], keyframe=False),
            enc.encode(frames[2], keyframe=False)]
    ref = jax_ffv1.FFV1Decoder(w, h, use_native=False)
    decoders = {"native": port_ffv1.FFV1Decoder(w, h),
                "python": port_ffv1.FFV1Decoder(w, h, use_native=False)}
    for planes, pkt in zip(frames, pkts):
        want = ref.decode(pkt)
        for name, dec in decoders.items():
            got = dec.decode(pkt)
            assert len(got) == 3, name
            for g, r, p in zip(got, want, planes):
                np.testing.assert_array_equal(g, r, err_msg=name)
                np.testing.assert_array_equal(g, p, err_msg=name)
            assert (dec.bits, dec.h_shift, dec.v_shift) == (bits, hs, vs)
    # the biplanar glue (P010 upshift, 4:2:2 -> 4:2:0 averaging)
    for fn in ("decode_to_nv12", "decode_to_p010"):
        a = getattr(jax_ffv1, fn)(jax_ffv1.FFV1Decoder(w, h, False), pkts[0])
        b = getattr(port_ffv1, fn)(port_ffv1.FFV1Decoder(w, h), pkts[0])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bits", [8, 10])
def test_native_ffv1_encoder_round_trips(lib, bits):
    planes = _ffv1_planes(W, H, 1, 1, bits, 4)
    enc = lib.ffv1_enc_create(W, H, bits)
    pkt = lib.ffv1_encode(enc, *(p.tobytes() for p in planes), True)
    for dec in (port_ffv1.FFV1Decoder(W, H),
                port_ffv1.FFV1Decoder(W, H, use_native=False),
                jax_ffv1.FFV1Decoder(W, H, use_native=False)):
        for g, p in zip(dec.decode(pkt), planes):
            np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("fourcc,w,h", [("ULY0", 64, 48), ("ULY2", 62, 47),
                                        ("ULH0", 32, 32)])
def test_utvideo_native_decoder_equals_the_original(lib, fourcc, w, h):
    rng = np.random.default_rng(3)
    planes = [rng.integers(0, 256, (ph, pw)).astype(np.uint8)
              for pw, ph in jax_ut.plane_dims(fourcc, w, h)]
    planes[0] = (np.add.outer(np.arange(h), np.arange(w)) % 256
                 ).astype(np.uint8)
    for pred in (jax_ut.PRED_LEFT, jax_ut.PRED_MEDIAN):
        pkt = jax_ut.encode_frame(planes, slices=3, pred=pred)
        want = jax_ut.decode_frame(pkt, fourcc, w, h, 3)
        for use_native in (True, False):
            got = port_ut.decode_planes(pkt, fourcc, w, h, 3, use_native)
            for g, r in zip(got, want):
                np.testing.assert_array_equal(g, r)
        for x, y in zip(jax_ut.decode_to_nv12(pkt, fourcc, w, h, 3),
                        port_ut.decode_to_nv12(pkt, fourcc, w, h, 3)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("w,h,subs", [(64, 48, 2), (65, 47, 2), (32, 32, 1),
                                      (48, 32, 0)])
def test_jpeg_paths(lib, w, h, subs):
    data = pil_jpeg(smooth_rgb(w, h, 5), quality=90, subsampling=subs)
    want = jax_jpeg.decode_jpeg_frame(data, pts=0.5, nominal_fps=24.0)
    pil = port_jpeg.decode_jpeg_frame(data, pts=0.5, nominal_fps=24.0,
                                      use_native=False)
    same_frames([want], [pil])
    y_n, u_n, v_n = port_jpeg.decode_jpeg_planes(data)
    y_p, u_p, v_p = jax_jpeg.decode_jpeg_planes(data)
    # the JAX package's bounds for two independent IDCTs: luma at every
    # geometry (test_luma_matches_libjpeg, q 90), chroma on the 4:2:0
    # clip it bounds (test_pil_fallback_close_to_native)
    dy = np.abs(y_n.astype(int) - y_p.astype(int))
    assert dy.max() <= 3 and dy.mean() < 1.0 and np.percentile(dy, 99) <= 2
    if (w, h, subs) == (64, 48, 2):
        assert np.abs(u_n.astype(int) - u_p.astype(int)).mean() < 4
        assert np.abs(v_n.astype(int) - v_p.astype(int)).mean() < 4


def test_mjpeg_stream_and_mf_sequences(tmp_path, lib):
    blob = b"".join(jpegs(4))
    (tmp_path / "cam.mjpeg").write_bytes(blob)
    path = str(tmp_path / "cam.mjpeg")
    same_frames(jax_jpeg.mjpeg_source(path, fps=10.0),
                port_jpeg.mjpeg_source(path, fps=10.0, use_native=False))
    # mf://: PNG (the stdlib codec), PGM and JPEG images
    rng = np.random.default_rng(9)
    for i in range(4):
        rgb = rng.integers(0, 256, (H + 1, W - 1, 3)).astype(np.uint8)
        jax_png.write_png(str(tmp_path / f"s{i:02d}.png"), rgb)
        (tmp_path / f"g{i:02d}.pgm").write_bytes(
            f"P5\n{W} {H}\n255\n".encode() + rgb[:H, :W - 2, 0].tobytes()
            + rgb[:H, :2, 1].tobytes())
    (tmp_path / "j00.jpg").write_bytes(jpegs(1)[0])
    for spec in ("mf://" + str(tmp_path / "s*.png"),
                 "mf://" + str(tmp_path / "g*.pgm"),
                 str(tmp_path / "j00.jpg")):
        for pixfmt in ("nv12", "p010"):
            same_frames(jax_mf.MFReader(spec, fps=12.0, pixfmt=pixfmt),
                        port_mf.MFReader(spec, fps=12.0, pixfmt=pixfmt,
                                         use_native=False))
    png = (tmp_path / "s01.png").read_bytes()
    np.testing.assert_array_equal(jax_png.decode_png(png),
                                  port_png.decode_png(png))


# --- playlists, cache, reverse, filters --------------------------------------

_EDL = """# mpv EDL v0
a.y4m,0.1,0.2
%5%b.mkv,start=0.05
file=c.y4m,length=0.5
"""


def test_playlists_parse_as_the_original(tmp_path):
    (tmp_path / "t.edl").write_text(_EDL)
    (tmp_path / "t.m3u").write_text("#EXTM3U\n#EXTINF:1,x\na.y4m\n"
                                    "http://h/b.mkv\nsynthetic:noise\n")
    (tmp_path / "t.pls").write_text("[playlist]\nFile2=b.y4m\nFile1=a.y4m\n")
    for name in ("t.edl", "t.m3u", "t.pls"):
        want = jax_playlist.parse_playlist(str(tmp_path / name))
        got = port_playlist.parse_playlist(str(tmp_path / name))
        assert [dataclasses.astuple(e) if dataclasses.is_dataclass(e)
                else e for e in got] == [
            dataclasses.astuple(e) if dataclasses.is_dataclass(e) else e
            for e in want]
    for bad in ("!no_clip\na.y4m", "a.y4m,x", ",1,2", "a.y4m,-1"):
        with pytest.raises(ValueError):
            jax_playlist.parse_edl(bad.splitlines(), str)
        with pytest.raises(ValueError):
            port_playlist.parse_edl(bad.splitlines(), str)


def test_chained_clipped_playlist_as_the_original():
    a, b = clip(8), clip(6, name="gradient_pan")
    scaled = clip(5, w=32, h=24)

    def run(mod):
        sources = {"a": a, "b": b, "s": scaled}

        def open_fn(e):
            if isinstance(e, mod.EDLEntry):
                return mod.ClipSource(iter(sources[e.path]), e.start,
                                      e.length)
            return iter(sources[e])
        entries = ["a", mod.EDLEntry("b", 1 / 24, 3 / 24), "s"]
        src = mod.ChainedSource(entries, open_fn)
        src.width, src.height, src.pixfmt = W, H, "nv12"
        return list(src)

    same_frames(run(jax_playlist), run(port_playlist))


def test_cache_and_reverse_as_the_original():
    frames = clip(11)

    def run(cache_mod, reverse_mod):
        src = cache_mod.CachedSource(iter(frames), max_frames=0)
        head = [next(iter(src)) for _ in range(3)]
        src.seek_pts(1 / 24.0)
        replay = list(src)
        back = list(reverse_mod.ReversedSource(src, chunk=4))
        return head + replay + back

    same_frames(run(jax_cache, jax_reverse), run(port_cache, port_reverse))
    with pytest.raises(port_reverse.ReverseError):
        port_reverse.ReversedSource(iter(frames))
    with pytest.raises(jax_reverse.ReverseError):
        jax_reverse.ReversedSource(iter(frames))


@pytest.mark.parametrize("chain", [
    "crop=32:24:8:4,vflip", "hflip,rotate=180", "scale=48:36",
    "fps=12,setpts=0.5", "deinterlace=bob", "rotate=90"])
def test_filter_chain_as_the_original(chain):
    frames = clip(6)
    want = list(jax_filters.apply_chain(jax_filters.parse_chain(chain),
                                        iter(frames)))
    got = list(port_filters.apply_chain(port_filters.parse_chain(chain),
                                        iter(frames)))
    same_frames(want, got)


# --- malformed inputs -------------------------------------------------------

def _mutations(data: bytes):
    rng = np.random.default_rng(11)
    yield data[:40]
    yield data[: len(data) // 2]
    b = bytearray(data)
    for i in rng.integers(0, len(b), 40):
        b[i] ^= 0xFF
    yield bytes(b)
    yield b"\x00" * 64


@pytest.mark.parametrize("kind", ["mkv-i420", "mkv-ffv1", "avi-utvideo",
                                  "mp4-i420"])
def test_malformed_containers_raise_as_the_original(tmp_path, lib, kind):
    data, suffix = container_bytes(kind, clip(3))
    jax_cls, port_cls = _READERS[suffix]
    for i, bad in enumerate(_mutations(data)):
        path = tmp_path / f"bad{i}{suffix}"
        path.write_bytes(bad)
        outcome = []
        for cls, kw in ((jax_cls, {}), (port_cls, {"use_native": False}),
                        (port_cls, {})):
            try:
                n = len(list(cls(str(path), **kw)))
                outcome.append(("ok", n))
            except Exception as e:        # noqa: BLE001 -- compared below
                outcome.append((type(e).__name__, None))
        assert outcome[0] == outcome[1], (i, outcome)
        # the native decoders raise where the Python ones do
        assert outcome[2][0] == outcome[0][0], (i, outcome)


def test_malformed_codec_payloads_raise_value_errors(lib):
    pkt = ffv1_payloads(clip(1))[0]
    for bad in _mutations(pkt):
        for dec in (port_ffv1.FFV1Decoder(W, H),
                    port_ffv1.FFV1Decoder(W, H, use_native=False)):
            try:
                dec.decode(bad)
            except ValueError:
                pass
    with pytest.raises(ValueError):
        port_jpeg.decode_jpeg_planes(b"\xff\xd8garbage")
    with pytest.raises(ValueError):
        jax_jpeg.decode_jpeg_planes(b"\xff\xd8garbage")
    with pytest.raises(ValueError):
        port_ut.decode_planes(b"\x01" * 20, "ULY0", W, H, 2)


# --- the sinks --------------------------------------------------------------

def test_dump_sinks_write_the_original_files(tmp_path):
    from mpv_frame_interpolator_tpu.io import sinks as jax_sinks
    from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
    frames = clip(3)
    for name in ("PgmDumpSink", "PngDumpSink"):
        outs = {}
        for tag, mod, out_cls in (
                ("jax", jax_sinks, lambda f: jax_engine.OutputFrame(
                    f.pts, f.fmt, f.y, f.uv, host=True)),
                ("port", port_sinks, lambda f: OutputFrame(
                    f.pts, f.fmt, f.y, f.uv))):
            d = tmp_path / f"{name}-{tag}"
            sink = getattr(mod, name)(str(d))
            for f in frames:
                sink.write(out_cls(f))
            sink.close()
            outs[tag] = {p.name: p.read_bytes() for p in d.iterdir()}
        assert outs["jax"] == outs["port"] and len(outs["port"]) == 3
    # the OSD sink on writable planes, without an engine (its line is
    # then the pts alone)
    wide = clip(2, w=400)
    outs = {}
    for tag, mod, out_cls in (
            ("jax", jax_sinks, lambda f: jax_engine.OutputFrame(
                f.pts, f.fmt, np.array(f.y), f.uv, host=True)),
            ("port", port_sinks, lambda f: OutputFrame(
                f.pts, f.fmt, f.y, f.uv))):
        buf = io.BytesIO()
        sink = mod.OsdSink(_BytesSink(buf))
        for f in wide:
            sink.write(out_cls(f))
        outs[tag] = buf.getvalue()
    assert outs["jax"] == outs["port"] and len(outs["port"]) > 0
    y = np.full((40, 400), 100, np.uint8)
    want = jax_osd.draw_text(y.copy(), "12.50s r5 INTERP 1.25ms", scale=2)
    got = port_osd.draw_text(y.copy(), "12.50s r5 INTERP 1.25ms", scale=2)
    np.testing.assert_array_equal(want, got)


class _BytesSink:
    def __init__(self, buf):
        self.buf = buf

    def write(self, frame):
        vf = frame.to_video_frame()
        self.buf.write(np.ascontiguousarray(vf.y).tobytes()
                       + np.ascontiguousarray(vf.uv).tobytes())

    def close(self):
        pass


@pytest.mark.parametrize("pixfmt", ["nv12", "p010"])
def test_ffv1_mkv_sink_round_trips(tmp_path, lib, pixfmt):
    frames = clip(3)
    if pixfmt == "p010":
        frames = [port_frame.VideoFrame(
            f.y.astype(np.uint16) << 8, f.uv.astype(np.uint16) << 8,
            port_frame.FrameFormat(W, H, "p010"), f.pts) for f in frames]
    path = tmp_path / "o.mkv"
    sink = port_sinks.FFV1MKVSink(str(path), W, H, 24.0, pixfmt)
    for f in frames:
        sink.write(OutputFrame(f.pts, f.fmt, f.y, f.uv))
    sink.close()
    assert sink.count == 3 and sink.write_time > 0
    same_frames(frames, port_mkv.MKVReader(str(path)), pts=False)
    same_frames(frames, jax_mkv.MKVReader(str(path)), pts=False)


def test_psnr_as_the_original():
    a, b = clip(2)
    jax_a, jax_b = clip(2)
    assert port_frame.psnr(a, b) == pytest.approx(
        __import__("mpv_frame_interpolator_tpu.frame",
                   fromlist=["psnr"]).psnr(jax_a, jax_b))
    assert port_frame.psnr(a, a) == float("inf")
    psnr = port_sinks.PsnrSink(lambda i, pts: a)
    psnr.write(OutputFrame(b.pts, b.fmt, b.y, b.uv))
    assert psnr.values == [port_frame.psnr(b, a)]


def test_byte_streams():
    """The mjpeg splitter on a stream with garbage between frames."""
    datas = jpegs(3)
    blob = b"junk" + datas[0] + b"\x00\x00" + datas[1] + datas[2]
    assert list(port_jpeg.split_jpeg_stream(io.BytesIO(blob).read, 7)) \
        == list(jax_jpeg.split_jpeg_stream(io.BytesIO(blob).read, 7))


def test_ring_recycles_from_many_threads(tmp_path, lib):
    """Frames of the native y4m ring checked and recycled by 6 threads
    at once (a short switch interval): no frame is overwritten before
    its hook fires, every frame is recycled once, and the ring does not
    grow past what the consumers hold."""
    import sys
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MWriter
    n = 60
    path = tmp_path / "c.y4m"
    with open(path, "wb") as fh:
        w = Y4MWriter(fh, W, H, 24.0)
        for i in range(n):
            y = np.full((H, W), i, np.uint8)
            uv = np.full((H // 2, W), 255 - i, np.uint8)
            w.write(port_frame.VideoFrame(y, uv, port_frame.FrameFormat(
                W, H), i / 24.0))
    src = port_ingest.NativeY4MSource(str(path), pool=PinnedPool(8, "cpu"))
    bad = []
    lock = threading.Lock()
    in_flight = threading.BoundedSemaphore(6)

    def check_and_recycle(i, f):
        if not ((f.y == i).all() and (f.uv == 255 - i).all()):
            with lock:
                bad.append(i)
        f.recycle()
        in_flight.release()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(6) as pool:
            futures = []
            for i, f in enumerate(src):
                assert in_flight.acquire(timeout=60)
                futures.append(pool.submit(check_and_recycle, i, f))
            for fut in futures:
                fut.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    stats = src.stats()
    src.close()
    assert len(futures) == n and bad == []
    assert stats["recycled"] == n and stats["outstanding"] == 0
    # the ring's 4, the 6 in flight and the one popped before a slot
    assert stats["pairs"] <= 4 + 6 + 1
