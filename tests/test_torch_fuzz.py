"""The JAX repository's hostile-input suites (tests/test_fuzz_parsers.py
and tests/test_fuzz_native_rings.py) on the port: every untrusted-input
parser -- y4m headers and frames, the JSON IPC protocol, applet codes,
the config and watch-later files -- and the port's C++ ring readers
(``native/repack.cpp``: ``Y4MRing`` parses FRAME markers from untrusted
bytes, ``IndexedRing`` preads attacker-influenced (offset, size)
records), driven with seeded hostile inputs.  Contract: a typed error or
a clean result, never an unhandled exception, crash, hang or allocation
bomb.  Seeds are fixed so failures reproduce.  Engines run on the CPU;
the native library is built at first use (g++)."""

import io
import json
import random
import string
import tempfile

import numpy as np
import pytest

from mpv_frame_interpolator_tpu_torch import native
from mpv_frame_interpolator_tpu_torch.io import ingest
from mpv_frame_interpolator_tpu_torch.io.y4m import (
    MAX_DIMENSION, MAX_PIXELS, Y4MError, Y4MReader, parse_header)

_native = None


@pytest.fixture(scope="module")
def lib():
    """The port's native library; skips only where it cannot be built
    (no C++ compiler or no Python.h)."""
    global _native
    missing = native.toolchain_missing()
    if missing:
        pytest.skip(f"the native library cannot be built here: {missing}")
    _native = native.load()
    return _native


def rng(seed):
    return random.Random(seed)


# ---------------------------------------------------------------------
# y4m stream header
# ---------------------------------------------------------------------

class TestFuzzY4MHeader:
    def test_random_ascii_headers(self):
        r = rng(1234)
        chars = string.printable
        for _ in range(4000):
            s = "".join(r.choice(chars) for _ in range(r.randint(0, 80)))
            try:
                w, h, fps, pix = parse_header(s)
                assert 0 < w <= MAX_DIMENSION and 0 < h <= MAX_DIMENSION
                assert w * h <= MAX_PIXELS and 0 <= fps
            except Y4MError:
                pass

    def test_mutated_valid_headers(self):
        r = rng(99)
        base = "YUV4MPEG2 W1920 H1080 F24:1 Ip A1:1 C420mpeg2"
        for _ in range(4000):
            s = list(base)
            for _ in range(r.randint(1, 6)):
                i = r.randrange(len(s))
                s[i] = r.choice(string.printable)
            try:
                parse_header("".join(s))
            except Y4MError:
                pass

    def test_hostile_numbers(self):
        cases = ["W99999999999 H2", "W-5 H5", "W8 H1e30", "F1:0", "F-2:1",
                 "W16384 H16384", "W0 H0", "F999999999999999:1",
                 "W2 H2 F24:1 C999", "W" + "9" * 500 + " H2"]
        for c in cases:
            try:
                w, h, fps, _ = parse_header("YUV4MPEG2 " + c)
                assert w * h <= MAX_PIXELS and fps <= 1e5
            except Y4MError:
                pass

    def test_frame_stream_random_bytes(self):
        """Random bytes after a valid header: typed error or clean EOF."""
        r = rng(7)
        for _ in range(300):
            junk = bytes(r.randrange(256)
                         for _ in range(r.randint(0, 400)))
            fh = io.BytesIO(b"YUV4MPEG2 W8 H8 F24:1 C420\n" + junk)
            try:
                frames = list(Y4MReader(fh))
                assert len(frames) <= 4
            except Y4MError:
                pass

    def test_truncated_frames(self):
        payload = bytes(range(8 * 8)) + b"\x80" * 32
        stream = b"YUV4MPEG2 W8 H8 F24:1 C420\n"
        stream += (b"FRAME\n" + payload) * 3
        for cut in range(0, len(stream), 7):
            fh = io.BytesIO(stream[:cut])
            try:
                frames = list(Y4MReader(fh))
                assert len(frames) <= 3
            except Y4MError:
                pass


# ---------------------------------------------------------------------
# JSON IPC protocol
# ---------------------------------------------------------------------

class TestFuzzIPC:
    @pytest.fixture()
    def server(self, tmp_path):
        from mpv_frame_interpolator_tpu_torch.api import Player
        from mpv_frame_interpolator_tpu_torch.control.ipc import IPCServer
        from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        player = Player(engine=InterpolationEngine(EngineConfig(
            scene_detection=False, auto_quality=False,
            measure_timing=False, device="cpu")))
        return IPCServer(str(tmp_path / "sock"), player)

    def test_random_bytes(self, server):
        r = rng(42)
        replies = []
        for _ in range(3000):
            line = bytes(r.randrange(256) for _ in range(r.randint(0, 120)))
            server.handle_line(line, replies.append)
        for rep in replies:
            json.dumps(rep)      # every reply is serializable

    def test_valid_json_wrong_shapes(self, server):
        r = rng(43)
        shapes = [
            {}, [], 42, None, True, "x",
            {"command": None}, {"command": []}, {"command": 5},
            {"command": [None]}, {"command": [[]]},
            {"command": ["set_property"]},
            {"command": ["set_property", "speed"]},
            {"command": ["set_property", "speed", "NaN"]},
            {"command": ["set_property", "display-fps", -1]},
            {"command": ["set_property", "search-radius", 1e308]},
            {"command": ["get_property", {"a": 1}]},
            {"command": ["get_property", ["speed"]]},
            {"command": ["observe_property"]},
            {"command": ["observe_property", {}, 3]},
            {"command": ["seek", "notanumber"]},
            {"command": ["seek"]},
            {"request_id": {"un": "hashable"}, "command": ["x"]},
            {"command": ["x" * 10000]},
        ]
        replies = []
        for shape in shapes:
            server.handle_line(json.dumps(shape).encode(), replies.append)
        # random property/command names
        for _ in range(2000):
            name = "".join(r.choice(string.printable)
                           for _ in range(r.randint(0, 30)))
            server.handle_line(
                json.dumps({"command": [name, name]}).encode(),
                replies.append)
        for rep in replies:
            json.dumps(rep)

    def test_engine_still_sane_after_fuzzing(self, server):
        r = rng(44)
        for _ in range(1000):
            cmd = [r.choice(["set_property", "get_property", "seek-reset"])]
            cmd += [r.choice(["speed", "search-radius", "display-fps",
                              "frame-output-mode", "zzz"]),
                    r.choice([0, 1, 5.5, -3, "9", None, 1e10])]
            server.handle_line(json.dumps({"command": cmd}).encode(),
                               lambda _: None)
        e = server.player.engine
        # invariants the fuzz must not have broken
        assert e.quality.min_radius <= e.quality.search_radius \
            <= e.quality.max_radius
        assert e.cadence.target_frame_time > 0


# ---------------------------------------------------------------------
# applet code protocol
# ---------------------------------------------------------------------

class TestFuzzApplet:
    def test_code_line_parser(self):
        from mpv_frame_interpolator_tpu_torch.control.applet import (
            parse_code_line)
        r = rng(5)
        for _ in range(5000):
            line = "".join(r.choice(string.printable)
                           for _ in range(r.randint(0, 40)))
            code = parse_code_line(line)
            assert code is None or isinstance(code, int)

    def test_apply_any_int_code(self):
        from mpv_frame_interpolator_tpu_torch.control.applet import (
            apply_command_code)
        from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
            EngineConfig, InterpolationEngine)
        eng = InterpolationEngine(EngineConfig(
            scene_detection=False, auto_quality=False,
            measure_timing=False, device="cpu"))
        r = rng(6)
        for _ in range(5000):
            code = r.choice([r.randint(-10, 900), r.randint(-2**62, 2**62)])
            apply_command_code(eng, code)     # must never raise
        assert 0.0 <= eng.black_level <= 255.0
        assert 0.0 <= eng.white_level <= 255.0


# ---------------------------------------------------------------------
# config file + watch-later parsers
# ---------------------------------------------------------------------

class TestFuzzConfig:
    def test_random_config_text(self):
        from mpv_frame_interpolator_tpu_torch.options import (
            ConfigError, parse_config_text)
        r = rng(8)
        chars = string.printable
        for _ in range(4000):
            text = "".join(r.choice(chars) for _ in range(r.randint(0, 200)))
            try:
                parse_config_text(text)
            except ConfigError:
                pass

    def test_random_watch_later_files(self, tmp_path):
        from mpv_frame_interpolator_tpu_torch.pipeline import resume
        r = rng(9)
        for i in range(500):
            text = "".join(r.choice(string.printable)
                           for _ in range(r.randint(0, 150)))
            d = tmp_path / "wl"
            d.mkdir(exist_ok=True)
            key = resume._key(f"media{i}")
            (d / key).write_text(text)
            state = resume.load(f"media{i}", directory=str(d))
            assert state is None or isinstance(state, dict)


# ---------------------------------------------------------------------
# the C++ ring readers
# ---------------------------------------------------------------------

W, H = 16, 16
HDR = b"YUV4MPEG2 W16 H16 F24:1 Ip A1:1 C420mpeg2\n"
PAYLOAD = W * H * 3 // 2


def frame_rec(seed=0, marker=b"FRAME\n"):
    body = bytes((seed + i) & 0xFF for i in range(PAYLOAD))
    return marker + body


def drain(data: bytes, max_frames=64):
    """Feed bytes to NativeY4MSource via a real file; returns
    ('ok', n) or ('err', msg).  Never crashes, never hangs (file EOF
    terminates every native read)."""
    with tempfile.NamedTemporaryFile() as tf:
        tf.write(data)
        tf.flush()
        try:
            src = ingest.NativeY4MSource(tf.name, ring_depth=2)
        except Exception as e:  # noqa: BLE001 - header reject is fine
            return ("err", f"open: {e}")
        n = 0
        try:
            for f in src:
                assert f.y.shape == (H, W)
                n += 1
                if f.recycle:
                    f.recycle()
                if n >= max_frames:
                    break
            return ("ok", n)
        except RuntimeError as e:
            return ("err", str(e))
        finally:
            src.close()


@pytest.mark.usefixtures("lib")
class TestFuzzY4MRing:
    def test_valid_stream_baseline(self):
        data = HDR + b"".join(frame_rec(i) for i in range(5))
        assert drain(data) == ("ok", 5)

    def test_truncations(self):
        base = HDR + b"".join(frame_rec(i) for i in range(4))
        for cut in range(len(HDR), len(base), 7):
            kind, info = drain(base[:cut])
            # whole frames parse, a partial tail is corrupt or EOF
            assert kind in ("ok", "err"), info

    def test_mutated_bytes(self):
        r = random.Random(77)
        base = bytearray(HDR + b"".join(frame_rec(i) for i in range(4)))
        for _ in range(4000):
            data = bytearray(base)
            for _ in range(r.randint(1, 8)):
                data[r.randrange(len(data))] = r.randrange(256)
            drain(bytes(data))           # contract: no crash/hang

    def test_hostile_markers(self):
        r = random.Random(1234)
        cases = [
            b"FRAME",                        # no newline, EOF
            b"FRAME " + b"X" * 10_000,       # giant marker line
            b"FRAME\xff\xfe\n",              # binary params
            b"FRAME" + b"\x00" * 300 + b"\n",
            b"NOTFRAME\n",
            b"\n" * 500,
            b"FRAME\n",                      # marker, no payload
        ]
        for _ in range(3000):
            n_pre = r.randint(0, 2)
            data = HDR + b"".join(frame_rec(i) for i in range(n_pre))
            data += cases[r.randrange(len(cases))]
            if r.random() < 0.5:
                data += frame_rec(9)[r.randint(0, PAYLOAD):]
            kind, info = drain(data)
            if kind == "ok":
                assert info >= n_pre or info == 0

    def test_random_garbage_bodies(self):
        r = random.Random(555)
        for _ in range(3000):
            body = bytes(r.getrandbits(8)
                         for _ in range(r.randint(0, 2000)))
            drain(HDR + body)


@pytest.mark.usefixtures("lib")
class TestFuzzIndexedRing:
    """Drives _native.IndexedRing directly with hostile offset tables."""

    def run_ring(self, payload: bytes, offsets):
        with tempfile.NamedTemporaryFile() as tf:
            tf.write(payload)
            tf.flush()
            ring = _native.IndexedRing(
                tf.file.fileno(), W, H, "i420",
                np.ascontiguousarray(offsets, np.int64))
            bufs = {t: (np.empty((H, W), np.uint8),
                        np.empty((H // 2, W), np.uint8)) for t in range(2)}
            for t, (y, uv) in bufs.items():
                ring.push_free(t, y, uv)
            n = 0
            try:
                while n < 64:
                    tag = ring.pop()
                    if tag is None:
                        return ("ok", n)
                    n += 1
                    ring.push_free(tag, *bufs[tag])
                return ("ok", n)
            except RuntimeError as e:
                return ("err", str(e))
            finally:
                ring.stop()

    def test_valid_baseline(self):
        payload = bytes(PAYLOAD * 3)
        assert self.run_ring(payload, [0, PAYLOAD, 2 * PAYLOAD]) == ("ok", 3)

    def test_hostile_offsets(self):
        r = random.Random(4242)
        payload = bytes(range(256)) * 8          # 2048 bytes < 3 frames
        for _ in range(10_000):
            n_off = r.randint(0, 6)
            offs = []
            for _ in range(n_off):
                roll = r.random()
                if roll < 0.3:
                    offs.append(r.randint(-(1 << 40), 0))      # negative
                elif roll < 0.6:
                    offs.append(r.randint(0, 1 << 41))         # beyond EOF
                else:
                    offs.append(r.randint(0, len(payload)))    # short tail
            kind, info = self.run_ring(payload, offs)
            assert kind in ("ok", "err")

    def test_file_shrunk_mid_stream(self):
        # index promises 8 frames, the file holds 1.5
        payload = bytes(PAYLOAD + PAYLOAD // 2)
        kind, info = self.run_ring(payload,
                                   [i * PAYLOAD for i in range(8)])
        assert kind == "err" or info <= 1
