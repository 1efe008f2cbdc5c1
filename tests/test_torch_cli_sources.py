"""The port's CLI with ``--device cpu`` against the JAX CLI on every
source and sink the JAX CLI opens without ffmpeg: raw MKV, FFV1 MKV,
Ut Video AVI, raw MP4, a Pillow-made MJPEG dump, an ``mf://`` PNG
sequence, a playlist and an EDL, ``--cache yes``, ``--play-direction
backward``, ``--start``, ``--vf``, a container piped on stdin with y4m on
stdout, and the ``.mkv`` (FFV1), ``--dump-pgm``, ``--dump-png`` and
``--osd`` sinks.  Each case writes the JAX CLI's bytes (for FFV1 output,
the same decoded frames: the two encoders need not write the same
packets; ``--osd`` against the port's own run without it).  The port
reads through its native library (``--ingest auto``, and ``--ingest
native`` where it is asked for) and through its Python readers
(``--ingest python``); the JAX package reads through its Python readers
here.  Synthetic clips under ``--cache auto`` and a playlist of them are
held against the JAX CLI too (``tests/test_torch_options.py`` holds the
port's parser against every option of the JAX CLI's).

Every JAX run is at 24 -> 60 fps on one 64x48 geometry, so the JAX
engine compiles once a worker."""

import io
import os
import struct
import sys

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu import cli as jax_cli
from mpv_frame_interpolator_tpu.io import ffv1 as jax_ffv1
from mpv_frame_interpolator_tpu.io import synthetic
from mpv_frame_interpolator_tpu.io import utvideo as jax_ut
from mpv_frame_interpolator_tpu.io.y4m import Y4MWriter
from mpv_frame_interpolator_tpu.utils.png import write_png
from mpv_frame_interpolator_tpu_torch import cli as port_cli
from mpv_frame_interpolator_tpu_torch import native
from mpv_frame_interpolator_tpu_torch.io.mkv import MKVReader
from test_jpeg import build_avi, pil_jpeg, smooth_rgb
from test_mkv import build_mkv
from test_mp4 import build_mp4

torch.set_num_threads(1)

W, H, N = 64, 48, 5
COMMON = ["--untimed", "--no-auto-quality", "--display-fps", "60",
          "--frames", "0"]


@pytest.fixture(scope="module", autouse=True)
def _native_library():
    missing = native.toolchain_missing()
    if missing:
        pytest.skip(f"the native library cannot be built here: {missing}")
    native.load()


def frames(n=N, w=W, h=H, name="moving_box", fps=24.0):
    cfg = synthetic.SyntheticConfig(width=w, height=h, fps=fps)
    return list(getattr(synthetic, name)(cfg, n))


def write_y4m(path, fs, fps=24.0):
    w, h = fs[0].fmt.width, fs[0].fmt.height
    with open(path, "wb") as fh:
        wr = Y4MWriter(fh, w, h, fps)
        for f in fs:
            wr.write(f)
    return str(path)


def ffv1_mkv(path, fs):
    enc = jax_ffv1.FFV1Encoder(W, H)
    pkts = [enc.encode([f.y, np.ascontiguousarray(f.uv[:, 0::2]),
                        np.ascontiguousarray(f.uv[:, 1::2])]) for f in fs]
    path.write_bytes(build_mkv(None, W, H, codec=b"V_FFV1", payloads=pkts))
    return str(path)


def ut_avi(path, fs):
    pkts = [jax_ut.encode_frame([f.y, np.ascontiguousarray(f.uv[:, 0::2]),
                                 np.ascontiguousarray(f.uv[:, 1::2])],
                                slices=2, pred=jax_ut.PRED_MEDIAN)
            for f in fs]
    path.write_bytes(build_avi(pkts, W, H, fourcc=b"ULY0",
                               extradata=jax_ut.make_extradata(2)))
    return str(path)


def run_both(tmp_path, inputs, extra=(), out="out.y4m", port_extra=()):
    """Run both CLIs on the same arguments; (JAX output, port output)."""
    paths = []
    for tag, main, own in (("jax", jax_cli.main, ["--no-resume"]),
                           ("port", port_cli.main,
                            ["--device", "cpu", *port_extra])):
        target = tmp_path / f"{tag}-{out}"
        argv = [*inputs, *COMMON, *extra, *own]
        if out.startswith("dump-"):
            argv += [f"--{out}", str(target)]
        else:
            argv += ["-o", str(target)]
        assert main(argv) == 0, (tag, argv)
        paths.append(target)
    return paths


def assert_same_bytes(a, b):
    da, db = a.read_bytes(), b.read_bytes()
    assert da.count(b"FRAME") > 0
    assert da == db


@pytest.mark.parametrize("ingest", ["auto", "native", "python"])
@pytest.mark.parametrize("kind", ["mkv-raw", "mkv-ffv1", "avi-utvideo",
                                  "mp4-raw"])
def test_containers(tmp_path, kind, ingest):
    fs = frames()
    if kind == "mkv-raw":
        src = tmp_path / "in.mkv"
        src.write_bytes(build_mkv(fs, W, H))
    elif kind == "mkv-ffv1":
        src = ffv1_mkv(tmp_path / "in.mkv", fs)
    elif kind == "avi-utvideo":
        src = ut_avi(tmp_path / "in.avi", fs)
    else:
        src = tmp_path / "in.mp4"
        src.write_bytes(build_mp4(fs, W, H))
    assert_same_bytes(*run_both(tmp_path, [str(src)],
                                port_extra=["--ingest", ingest]))


def test_pillow_mjpeg_dump(tmp_path):
    """A raw .mjpeg dump (concatenated JPEGs made by Pillow): both decode
    through Pillow, the port under --ingest python; the native decoder
    gives the same frame count."""
    src = tmp_path / "cam.mjpeg"
    src.write_bytes(b"".join(pil_jpeg(smooth_rgb(W, H, s), quality=90)
                             for s in range(N)))
    a, b = run_both(tmp_path, [str(src)], ["--fps", "24"],
                    port_extra=["--ingest", "python"])
    assert_same_bytes(a, b)
    out = tmp_path / "native.y4m"
    assert port_cli.main([str(src), *COMMON, "--fps", "24", "--device",
                          "cpu", "-o", str(out)]) == 0
    assert out.read_bytes().count(b"FRAME") == a.read_bytes().count(b"FRAME")


def test_mf_png_sequence(tmp_path):
    d = tmp_path / "shots"
    d.mkdir()
    for i, f in enumerate(frames(name="gradient_pan")):
        rgb = np.stack([f.y, np.roll(f.y, 3, 1), f.y[::-1]], -1)
        write_png(str(d / f"{i:03d}.png"), rgb)
    assert_same_bytes(*run_both(tmp_path, ["mf://" + str(d / "*.png")],
                                ["--mf-fps", "24"]))


def test_playlist_of_two_files(tmp_path):
    a = write_y4m(tmp_path / "a.y4m", frames())
    b = ffv1_mkv(tmp_path / "b.mkv", frames(4, name="gradient_pan"))
    assert_same_bytes(*run_both(tmp_path, [a, b]))
    lst = tmp_path / "list.m3u"
    lst.write_text("#EXTM3U\nb.mkv\n")
    assert_same_bytes(*run_both(tmp_path, [a], ["--playlist", str(lst)],
                                out="list.y4m"))


def test_edl_timeline(tmp_path):
    write_y4m(tmp_path / "a.y4m", frames(8))
    ffv1_mkv(tmp_path / "b.mkv", frames(6, name="gradient_pan"))
    edl = tmp_path / "t.edl"
    edl.write_text("# mpv EDL v0\na.y4m,0.08,0.15\nb.mkv,start=0.04\n"
                   "a.y4m,length=0.1\n")
    assert_same_bytes(*run_both(tmp_path, [str(edl)]))


@pytest.mark.parametrize("options", [
    ["--cache", "yes"],
    ["--play-direction", "backward"],
    ["--cache", "yes", "--play-direction", "backward"],
    ["--start", str(2 / 24.0)],
    ["--vf", "crop=64:48:0:8,vflip"],
], ids=["cache", "backward", "cache-backward", "start", "vf"])
def test_source_options(tmp_path, options):
    h = 64 if "--vf" in options else H
    src = write_y4m(tmp_path / "in.y4m", frames(7, h=h))
    assert_same_bytes(*run_both(tmp_path, [src], options))


def test_start_on_an_unseekable_pipe_skips(tmp_path, monkeypatch):
    """--start on y4m piped on stdin, no cache: frames before it are
    skipped (both CLIs)."""
    src = write_y4m(tmp_path / "in.y4m", frames(7))
    outs = []
    for tag, main, own in (("jax", jax_cli.main, ["--no-resume"]),
                           ("port", port_cli.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(
            io.BufferedReader(io.FileIO(src, "rb"))))
        out = tmp_path / f"{tag}.y4m"
        assert main(["-", *COMMON, "--cache", "no", "--start",
                     str(2 / 24.0), "-o", str(out), *own]) == 0
        outs.append(out)
    assert_same_bytes(*outs)


def test_piped_mkv_to_stdout(tmp_path, monkeypatch):
    """A container on stdin (spooled, then the indexed readers) and y4m
    on stdout (-o -)."""
    src = tmp_path / "in.mkv"
    src.write_bytes(build_mkv(frames(), W, H))
    outs = []
    for main, own in ((jax_cli.main, ["--no-resume"]),
                      (port_cli.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(
            io.BufferedReader(io.FileIO(str(src), "rb"))))
        buf = io.BytesIO()
        monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(buf))
        assert main(["-", *COMMON, "-o", "-", *own]) == 0
        sys.stdout.flush()
        outs.append(buf.getvalue())
    assert outs[0].count(b"FRAME") > 0 and outs[0] == outs[1]


def test_raw_yuv_file(tmp_path):
    src = tmp_path / "in.yuv"
    with open(src, "wb") as fh:
        for f in frames():
            fh.write(f.y.tobytes()
                     + np.ascontiguousarray(f.uv[:, 0::2]).tobytes()
                     + np.ascontiguousarray(f.uv[:, 1::2]).tobytes())
    assert_same_bytes(*run_both(tmp_path, [str(src)],
                                ["--width", str(W), "--height", str(H)]))


def test_y4m_over_a_unix_socket(tmp_path):
    """A y4m stream from a local socket (unseekable: `--cache auto`
    spools it), served once to each CLI."""
    import socket
    import threading
    data = open(write_y4m(tmp_path / "in.y4m", frames()), "rb").read()
    path = str(tmp_path / "s.sock")
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server.bind(path)
    server.listen(2)
    server.settimeout(60)

    def serve():
        for _ in range(2):
            conn, _ = server.accept()
            with conn:
                conn.sendall(data)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        assert_same_bytes(*run_both(tmp_path, [f"unix://{path}"]))
    finally:
        t.join(timeout=60)
        server.close()
    assert not t.is_alive()


def test_ffv1_mkv_output(tmp_path):
    src = write_y4m(tmp_path / "in.y4m", frames())
    a, b = run_both(tmp_path, [src], out="out.mkv")
    got = [list(MKVReader(str(p))) for p in (a, b)]
    assert len(got[0]) == len(got[1]) > N
    for x, y in zip(*got):
        np.testing.assert_array_equal(x.y, y.y)
        np.testing.assert_array_equal(x.uv, y.uv)
        assert x.pts == pytest.approx(y.pts, abs=1e-4)


@pytest.mark.parametrize("dump", ["dump-pgm", "dump-png"])
def test_dump_sinks(tmp_path, dump):
    src = write_y4m(tmp_path / "in.y4m", frames(4))
    a, b = run_both(tmp_path, [src], out=dump)
    files = sorted(os.listdir(a))
    assert len(files) > 4 and files == sorted(os.listdir(b))
    for name in files:
        assert (a / name).read_bytes() == (b / name).read_bytes()


@pytest.mark.parametrize("fps", [24.0, 60.0], ids=["24-60", "passthrough"])
def test_osd(tmp_path, fps):
    """--osd burns the stats line (pts, radius, state, the last pair's
    calc ms) into the luma at (8, 8): the same bytes as without it
    outside the line's box, the box's two levels inside.  (The JAX CLI's
    --osd raises on its first output here: the planes it gets from its
    reader are read-only.  tests/test_torch_io.py holds the port's sink
    against the JAX sink on writable planes.)"""
    src = write_y4m(tmp_path / "in.y4m", frames(4, w=400), fps=fps)
    outs = []
    for extra in ([], ["--osd"]):
        out = tmp_path / f"out{len(outs)}.y4m"
        assert port_cli.main([src, *COMMON, *extra, "--device", "cpu",
                              "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    da, db = outs
    assert len(da) == len(db) and da.count(b"FRAME") >= 4
    header = da.index(b"\n") + 1
    luma = 400 * 48
    rec = len(b"FRAME\n") + luma * 3 // 2
    box = np.zeros((48, 400), bool)
    box[8:28, 8:392] = True
    for k in range(da.count(b"FRAME")):
        off = header + k * rec + len(b"FRAME\n")
        ya, yb = (np.frombuffer(d, np.uint8, luma, off).reshape(48, 400)
                  for d in (da, db))
        np.testing.assert_array_equal(ya[~box], yb[~box])
        levels = set(np.unique(yb[box]).tolist())
        assert 235 in levels and levels <= {16, 235} | set(
            np.unique(ya[box]).tolist())
        assert da[off + luma:off + luma * 3 // 2] == \
            db[off + luma:off + luma * 3 // 2]


SYNTH = ["--width", str(W), "--height", str(H), "--frames", "6"]


@pytest.mark.parametrize("options", [
    ["--play-direction", "backward"],
    ["--start", "0.1"],
], ids=["backward", "start"])
def test_cache_auto_spools_a_synthetic_clip(tmp_path, options):
    """`--cache auto` caches any source that cannot seek by itself, a
    synthetic clip included (the JAX CLI's rule): backward play works and
    --start seeks the cache (to the last frame at or before it)."""
    assert_same_bytes(*run_both(tmp_path, ["synthetic:moving_box"],
                                [*SYNTH, *options]))


def test_a_playlist_of_synthetic_clips(tmp_path):
    """Two synthetic clips play as one playlist: the bytes of the same
    clips written to y4m and played as a y4m playlist (the JAX CLI runs
    that route; its own synthetic playlist fails on the first entry's
    missing width)."""
    ref = tmp_path / "ref.y4m"
    clips = [write_y4m(tmp_path / f"{name}.y4m", frames(6, name=name))
             for name in ("moving_box", "gradient_pan")]
    assert jax_cli.main([*clips, *COMMON, "--frames", "6", "--no-resume",
                         "-o", str(ref)]) == 0
    out = tmp_path / "port.y4m"
    assert port_cli.main(["synthetic:moving_box", "synthetic:gradient_pan",
                          *COMMON, *SYNTH, "--device", "cpu",
                          "-o", str(out)]) == 0
    assert_same_bytes(ref, out)


def test_an_unreadable_input_fails_with_a_message(tmp_path, monkeypatch):
    from mpv_frame_interpolator_tpu_torch.io import decode
    monkeypatch.setattr(decode, "have_ffmpeg", lambda: False)
    clip = tmp_path / "clip.webm"
    clip.write_bytes(build_mkv(None, W, H, codec=b"V_VP9",
                               payloads=[b"\x00" * 16]))
    other = tmp_path / "clip.flv"
    other.write_bytes(b"FLV\x01")
    for path, msg in ((clip, "V_VP9"), (other, "needs ffmpeg")):
        with pytest.raises(SystemExit, match=msg):
            port_cli.main([str(path), "--device", "cpu"])


def test_vfw_utvideo_in_mkv_plays_like_avi(tmp_path):
    """Ut Video in Matroska through the VfW codec id (the layout
    tests/test_utvideo.py authors) plays as the AVI does."""
    fs = frames()
    pkts = [jax_ut.encode_frame([f.y, np.ascontiguousarray(f.uv[:, 0::2]),
                                 np.ascontiguousarray(f.uv[:, 1::2])],
                                slices=3, pred=jax_ut.PRED_MEDIAN)
            for f in fs]
    bih = struct.pack("<iiiHH4sIiiII", 40 + 16, W, H, 1, 24, b"ULY0",
                      W * H * 3, 0, 0, 0, 0)
    src = tmp_path / "ut.mkv"
    src.write_bytes(build_mkv(None, W, H, codec=b"V_MS/VFW/FOURCC",
                              payloads=pkts,
                              codec_private=bih + jax_ut.make_extradata(3)))
    avi = ut_avi(tmp_path / "ut.avi", fs)
    outs = []
    for inp in (str(src), avi):
        out = tmp_path / f"{os.path.basename(inp)}.y4m"
        assert port_cli.main([inp, *COMMON, "--device", "cpu", "-o",
                              str(out)]) == 0
        outs.append(out)
    assert_same_bytes(*outs)
