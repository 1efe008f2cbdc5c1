"""The port's decoders and container readers under the JAX repository's
seeded decoder fuzz (tests/test_ffv1.py native mutation and truncation,
tests/test_utvideo.py, tests/test_jpeg.py, tests/test_mkv.py and
tests/test_mp4.py), each through the native library and through the
Python codecs (``use_native=False``; Pillow for JPEG).  The containers
also go through ``ingest.open_container`` (the indexed ring for raw
video, the native decoders for FFV1, Ut Video and MJPEG).

Contract: a ``ValueError`` subclass or a clean result -- never a crash,
a hang or another exception (the ring's reader thread reports a bad
read as ``RuntimeError``, its typed error, as in tests/test_torch_fuzz.py).
The inputs that once broke the port -- a read past a plane in the native
JPEG decoder, untyped errors from the Python Matroska reader -- are
pinned as cases of the ``test_pinned_*`` tests."""

import random

import numpy as np
import pytest

from mpv_frame_interpolator_tpu_torch import native
from mpv_frame_interpolator_tpu_torch.io import avi as port_avi
from mpv_frame_interpolator_tpu_torch.io import ffv1 as port_ffv1
from mpv_frame_interpolator_tpu_torch.io import ingest as port_ingest
from mpv_frame_interpolator_tpu_torch.io import jpeg as port_jpeg
from mpv_frame_interpolator_tpu_torch.io import mkv as port_mkv
from mpv_frame_interpolator_tpu_torch.io import mp4 as port_mp4
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.io import utvideo as port_ut
from test_ffv1 import _planes as ffv1_planes
from test_jpeg import build_avi, pil_jpeg, raw_i420, smooth_rgb
from test_mkv import build_mkv
from test_mp4 import build_mp4
from test_utvideo import _planes as ut_planes

ROUTES = pytest.mark.parametrize("use_native", [True, False],
                                 ids=["native", "python"])


@pytest.fixture(scope="module")
def lib():
    """The port's native library; skips only where it cannot be built
    (no C++ compiler or no Python.h)."""
    missing = native.toolchain_missing()
    if missing:
        pytest.skip(f"the native library cannot be built here: {missing}")
    return native.load()


def decodes_or_raises(fn, *args, allowed=(ValueError,)):
    """fn(*args) returns, or raises one of `allowed`; anything else
    fails the test."""
    try:
        fn(*args)
    except allowed:
        pass


# --- codecs -----------------------------------------------------------------

def _ffv1(w, h, use_native):
    return port_ffv1.FFV1Decoder(w, h, use_native=use_native)


@ROUTES
def test_ffv1_mutations(lib, use_native):
    w, h = 32, 16
    base = port_ffv1.FFV1Encoder(w, h).encode(list(ffv1_planes(w, h, 9)))
    rng = np.random.default_rng(21)
    for _ in range(300):
        ba = bytearray(base)
        for _ in range(int(rng.integers(1, 8))):
            ba[int(rng.integers(0, len(ba)))] = int(rng.integers(0, 256))
        decodes_or_raises(_ffv1(w, h, use_native).decode, bytes(ba))


@ROUTES
def test_ffv1_truncations(lib, use_native):
    w, h = 32, 16
    base = port_ffv1.FFV1Encoder(w, h).encode(list(ffv1_planes(w, h, 10)))
    for cut in range(0, len(base), max(1, len(base) // 60)):
        decodes_or_raises(_ffv1(w, h, use_native).decode, base[:cut])


@ROUTES
def test_utvideo_mutations_and_truncations(lib, use_native):
    pkt = bytearray(port_ut.encode_frame(ut_planes("ULY0", 64, 48, seed=9),
                                         slices=3, pred=port_ut.PRED_MEDIAN))
    rng = random.Random(4)
    for _ in range(1500 if use_native else 150):
        b = bytearray(pkt)
        if rng.random() < 0.5:
            b = b[:rng.randrange(len(b))]
        else:
            for _ in range(rng.randrange(1, 6)):
                b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        decodes_or_raises(port_ut.decode_planes, bytes(b), "ULY0", 64, 48, 3,
                          use_native)


@ROUTES
def test_jpeg_garbage(lib, use_native):
    rng = np.random.default_rng(7)
    good = pil_jpeg(smooth_rgb(32, 24), quality=80)
    for _ in range(300):
        b = bytearray(good[: rng.integers(4, len(good))])
        for _ in range(rng.integers(0, 5)):
            b[rng.integers(0, len(b))] = rng.integers(0, 256)
        decodes_or_raises(port_jpeg.decode_jpeg_planes, bytes(b),
                          use_native)


# --- containers -------------------------------------------------------------

W, H = 64, 48


def _frames(n=3):
    cfg = synthetic.SyntheticConfig(width=W, height=H, fps=24.0)
    return list(synthetic.moving_box(cfg, n))


def _ffv1_payloads(frames):
    enc = port_ffv1.FFV1Encoder(W, H)
    return [enc.encode([f.y, np.ascontiguousarray(f.uv[:, 0::2]),
                        np.ascontiguousarray(f.uv[:, 1::2])])
            for f in frames]


def _ut_payloads(frames):
    return [port_ut.encode_frame(
        [f.y, np.ascontiguousarray(f.uv[:, 0::2]),
         np.ascontiguousarray(f.uv[:, 1::2])], slices=2,
        pred=port_ut.PRED_MEDIAN) for f in frames]


def _jpegs(n):
    return [pil_jpeg(smooth_rgb(W, H, s), quality=90) for s in range(n)]


# kind -> (bytes of 3 frames, suffix, reader, seed, cut step divisor); the
# MKV and MP4 seeds and steps are the JAX suites', the others new
_CONTAINERS = {
    "mkv-i420": (lambda f: build_mkv(f, W, H), ".mkv", port_mkv.MKVReader,
                 11, 60),
    "mkv-ffv1": (lambda f: build_mkv(None, W, H, codec=b"V_FFV1",
                                     payloads=_ffv1_payloads(f)), ".mkv",
                 port_mkv.MKVReader, 12, 60),
    "mp4-i420": (lambda f: build_mp4(f, W, H), ".mp4", port_mp4.MP4Reader,
                 13, 50),
    "mp4-mjpeg": (lambda f: build_mp4(None, W, H, fourcc=b"jpeg",
                                      payloads=_jpegs(len(f))), ".mp4",
                  port_mp4.MP4Reader, 14, 50),
    "avi-i420": (lambda f: build_avi([raw_i420(x) for x in f], W, H,
                                     fourcc=b"I420"), ".avi",
                 port_avi.AVIReader, 15, 60),
    "avi-utvideo": (lambda f: build_avi(
        _ut_payloads(f), W, H, fourcc=b"ULY0",
        extradata=port_ut.make_extradata(2)), ".avi", port_avi.AVIReader,
        16, 60),
    "avi-mjpeg": (lambda f: build_avi(_jpegs(len(f)), W, H), ".avi",
                  port_avi.AVIReader, 17, 60),
}


def _read_all(route: str, reader, path: str) -> int:
    """Frames read from `path` along `route`: "python" the reader with
    the Python codecs, "native" ``open_container`` (the indexed ring for
    raw video, the reader with the native decoders otherwise)."""
    if route == "python":
        src = reader(path, use_native=False)
    else:
        src = port_ingest.open_container(path, device="cpu")
    n = 0
    try:
        for f in src:
            n += 1
            if f.recycle:
                f.recycle()
    finally:
        src.close()
    return n


def _survives(route, reader, path) -> None:
    allowed = (ValueError, RuntimeError) if route == "native" \
        else (ValueError,)
    try:
        assert _read_all(route, reader, path) <= 3
    except allowed:
        pass


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("kind", list(_CONTAINERS))
def test_container_truncations_and_mutations(lib, tmp_path, kind, route):
    build, suffix, reader, seed, steps = _CONTAINERS[kind]
    data = build(_frames())
    assert _read_all(route, reader, _write(tmp_path, data, suffix)) == 3
    for cut in range(0, len(data), max(len(data) // steps, 1)):
        _survives(route, reader, _write(tmp_path, data[:cut], suffix))
    r = random.Random(seed)
    for _ in range(300 if route == "native" else 100):
        mutated = bytearray(data)
        for _ in range(r.randint(1, 8)):
            mutated[r.randrange(len(mutated))] = r.randrange(256)
        _survives(route, reader, _write(tmp_path, bytes(mutated), suffix))


def _write(tmp_path, data: bytes, suffix: str) -> str:
    p = tmp_path / f"fz{suffix}"
    p.write_bytes(data)
    return str(p)


# --- inputs that once broke the port ----------------------------------------

def _jpeg_luma_below_max_sampling() -> bytes:
    """A 4:2:0 JPEG whose third component claims 1x3 sampling, so that
    luma (2x2) is no longer at the largest factors and its plane is
    smaller than the frame: the native decoder copied the W x H luma out
    of it, a read past the plane's end (seen under AddressSanitizer)."""
    b = bytearray(pil_jpeg(smooth_rgb(32, 24), quality=80))
    sof = b.index(b"\xff\xc0")
    b[sof + 10 + 2 * 3 + 1] = 0x13
    return bytes(b)


def _mkv_ffv1(edit) -> bytes:
    data = bytearray(_CONTAINERS["mkv-ffv1"][0](_frames()))
    return bytes(edit(data))


def _set(pos, value):
    def edit(b):
        b[pos] = value
        return b
    return edit


# name -> (input, the error the Python reader met before it was typed)
_PINNED = {
    # a SimpleBlock header cut short by the file's end: struct.error
    "mkv-block-header-cut-short": (lambda: _mkv_ffv1(lambda b: b[:232]),
                                   "error"),
    # an element size no file can hold: the seek past it failed (EINVAL)
    "mkv-element-past-any-file": (lambda: _mkv_ffv1(_set(31, 0x13)),
                                  "OSError"),
    # a segment size too large to convert to a float: OverflowError
    "mkv-size-past-a-float": (lambda: _mkv_ffv1(_set(23, 0x23)),
                              "OverflowError"),
}


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "pillow"])
def test_pinned_jpeg_luma_below_max_sampling(lib, use_native):
    data = _jpeg_luma_below_max_sampling()
    if use_native:
        with pytest.raises(ValueError, match="luma"):
            port_jpeg.decode_jpeg_planes(data)
    else:
        decodes_or_raises(port_jpeg.decode_jpeg_planes, data, False)


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("name", list(_PINNED))
def test_pinned_container_inputs(lib, tmp_path, name, route):
    make, cause = _PINNED[name]
    path = _write(tmp_path, make(), ".mkv")
    with pytest.raises(port_mkv.MKVError) as info:
        _read_all(route, port_mkv.MKVReader, path)
    assert type(info.value.__cause__).__name__ == cause
