"""The port's control surfaces on the CPU: the analogs of the JAX
package's ``tests/test_input.py`` (input.conf parsing, key decoding, the
dispatcher against a live pipeline, the terminal reader thread),
``test_applet_client.py`` and ``test_api_ipc.py::TestAppletServerFifo``
(the applet protocol over real FIFOs), ``test_trace.py`` (the profiler
hooks, here on ``torch.profiler``), and each copied parser held against
its original on the same inputs: ``parse_input_conf``, ``decode_keys``,
``parse_code_line`` and ``apply_command_code``.  Engines run on the CPU
(``device="cpu"``) at 64x48; no JAX engine runs here."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu.control import applet as jax_applet
from mpv_frame_interpolator_tpu.control import input as jax_input
from mpv_frame_interpolator_tpu.pipeline import cadence as jax_cadence
from mpv_frame_interpolator_tpu_torch.api import Player
from mpv_frame_interpolator_tpu_torch.control import applet
from mpv_frame_interpolator_tpu_torch.control.applet import AppletServer
from mpv_frame_interpolator_tpu_torch.control.applet_client import (
    main as client_main, read_status, send_code)
from mpv_frame_interpolator_tpu_torch.control.input import (
    DEFAULT_BINDINGS, KeyDispatcher, TerminalInput, decode_keys,
    parse_input_conf)
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.io.cache import CachedSource
from mpv_frame_interpolator_tpu_torch.io.sinks import NullSink
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator_tpu_torch.pipeline.player import Pipeline
from mpv_frame_interpolator_tpu_torch.utils.trace import (
    annotate, device_trace)

torch.set_num_threads(1)

JOIN_S = 60.0
CFG = synthetic.SyntheticConfig(width=64, height=48)


def engine(**kw):
    return InterpolationEngine(EngineConfig(measure_timing=False,
                                            device="cpu", **kw))


def pipeline(n=40, source=None):
    e = engine()
    pipe = Pipeline(source if source is not None
                    else synthetic.moving_box(CFG, n), e, NullSink(),
                    present=None)
    player = Player(engine=e)
    player.bind_pipeline(pipe)
    return player, pipe


def wait_for(cond, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


# --- input.conf and keys ------------------------------------------------------

class TestParseInputConf:
    def test_basic_lines(self):
        conf = """
        # a comment
        RIGHT seek 10
        SPACE cycle pause   # trailing comment
        SHARP screenshot
        q quit
        """
        b = parse_input_conf(conf)
        assert b["RIGHT"] == "seek 10"
        assert b["SPACE"] == "cycle pause"
        assert b["#"] == "screenshot"
        assert b["q"] == "quit"

    def test_ignore_unbinds(self):
        assert parse_input_conf("q ignore\n")["q"] == "ignore"

    def test_malformed_skipped(self):
        assert parse_input_conf("justakey\n\n") == {}


INPUT_CONFS = [
    "RIGHT seek 10\nSPACE cycle pause  # c\nSHARP screenshot\nq quit\n",
    "justakey\n\n# only a comment\n  x   set speed 2 # y\n",
    "UP add speed 0.1\nDOWN add speed -0.1\n] multiply speed 1.1\n"
    "Q quit-watch-later\nq ignore\n\tTAB  frame-step\n",
]


@pytest.mark.parametrize("conf", INPUT_CONFS)
def test_parse_input_conf_copy_equals_the_original(conf):
    assert parse_input_conf(conf) == jax_input.parse_input_conf(conf)
    assert DEFAULT_BINDINGS == jax_input.DEFAULT_BINDINGS


KEY_STREAMS = [b"q. s", b"\x1b[A\x1b[D\x1b[C\x1b[B", b"q\x1b", b"\x03",
               b"\x1bOA\x1b[5~\x1b[6~\x1b[H\x1b[F\r\n\t", b"\x1b[", b"\x1bx",
               bytes(range(0, 128, 3))]


@pytest.mark.parametrize("data", KEY_STREAMS)
def test_decode_keys_copy_equals_the_original(data):
    assert decode_keys(data) == jax_input.decode_keys(data)


class TestDecodeKeys:
    def test_plain_and_special(self):
        assert decode_keys(b"q. s") == (["q", ".", "SPACE", "s"], b"")

    def test_arrows(self):
        keys, rest = decode_keys(b"\x1b[A\x1b[D\x1b[C\x1b[B")
        assert keys == ["UP", "LEFT", "RIGHT", "DOWN"] and rest == b""

    def test_incomplete_escape_kept(self):
        assert decode_keys(b"q\x1b") == (["q"], b"\x1b")

    def test_ctrl(self):
        assert decode_keys(b"\x03")[0] == ["Ctrl+c"]


class TestKeyDispatcher:
    def test_speed_multiply(self):
        player, pipe = pipeline(4)
        d = KeyDispatcher(player, pipe)
        assert d.on_key("]")
        assert float(player.get_property("speed")) == pytest.approx(1.1)
        d.on_key("[")
        assert float(player.get_property("speed")) == pytest.approx(1.0)

    def test_pause_cycle_and_quit(self):
        player, pipe = pipeline(4)
        d = KeyDispatcher(player, pipe)
        d.on_key("SPACE")
        assert pipe.paused
        d.on_key("SPACE")
        assert not pipe.paused
        d.on_key("q")
        assert pipe._quit

    def test_quit_watch_later_hook(self):
        player, pipe = pipeline(4)
        calls = []
        d = KeyDispatcher(player, pipe, on_quit=lambda wl: calls.append(wl))
        d.on_key("Q")
        assert calls == [True]

    def test_unbound_key(self):
        player, pipe = pipeline(4)
        d = KeyDispatcher(player, pipe, default_bindings=False)
        assert not d.on_key("q")
        assert not pipe._quit

    def test_user_override(self):
        player, pipe = pipeline(4)
        d = KeyDispatcher(player, pipe, bindings={"q": "ignore"})
        assert d.on_key("q")
        assert not pipe._quit

    def test_a_failed_command_is_counted(self):
        player, pipe = pipeline(4)
        d = KeyDispatcher(player, pipe, bindings={"x": "seek ahead"})
        assert d.on_key("x")
        assert player.engine.stats.count("control_failures") == 1
        assert pipe.seeks == 0

    def test_defaults_mirror_reference(self):
        for key in ("RIGHT", "LEFT", "UP", "DOWN", "SPACE", ".", "s",
                    "q", "Q", "[", "]"):
            assert key in DEFAULT_BINDINGS

    def test_seek_during_playback(self):
        """RIGHT during a run lands a real source seek."""
        player, pipe = pipeline(
            source=CachedSource(synthetic.moving_box(CFG, 200000)))
        d = KeyDispatcher(player, pipe)
        runner = threading.Thread(target=pipe.run)
        runner.start()
        try:
            assert wait_for(lambda: pipe.frames_in > 2, JOIN_S)
            d.on_key("RIGHT")           # +5 s
            assert wait_for(lambda: pipe.seeks >= 1, JOIN_S)
        finally:
            d.on_key("q")
            runner.join(timeout=JOIN_S)
        assert not runner.is_alive()
        assert pipe.seeks >= 1


class TestTerminalInput:
    def test_pipe_fd_reader(self):
        """Keys through a pipe (raw mode is silently unavailable)."""
        player, pipe = pipeline(4)
        d = KeyDispatcher(player, pipe)
        r, w = os.pipe()
        ti = TerminalInput(d, fd=r)
        ti.start()
        try:
            os.write(w, b"]")
            assert wait_for(lambda: d.dispatched >= 1)
            os.write(w, b"\x1b[A")      # UP -> seek 60 (queued)
            assert wait_for(lambda: d.dispatched >= 2)
        finally:
            ti.stop()
            os.close(w)
            os.close(r)
        assert not ti._thread.is_alive()
        assert float(player.get_property("speed")) == pytest.approx(1.1)


# --- the settings applet --------------------------------------------------------

CODE_LINES = ["5", " 7 \n", "-3", "", "x1", "1" * 40, "٣", "+4", "12a",
              "0", "355", "\x00", "-"]


@pytest.mark.parametrize("line", CODE_LINES)
def test_parse_code_line_copy_equals_the_original(line):
    assert applet.parse_code_line(line) == jax_applet.parse_code_line(line)


def test_apply_command_code_copy_equals_the_original():
    """Every code from -2 to 900 on the port's engine and on a stand-in
    with the JAX cadence: the same verdict and the same state after."""
    from mpv_frame_interpolator_tpu_torch.pipeline.cadence import (
        CadenceEngine)

    class JaxSide:
        def __init__(self):
            self.cadence = jax_cadence.CadenceEngine(60.0)
            self.frame_output_mode = 2
            self.black_level, self.white_level = 0.0, 255.0
            self.delta_scalar, self.neighbor_bias_scalar = 8, 6

    def state(e):
        return (e.cadence.state.name, e.cadence.source_frame_num,
                e.cadence.blending_scalar, e.frame_output_mode,
                e.black_level, e.white_level, e.delta_scalar,
                e.neighbor_bias_scalar)

    port, ref = engine(), JaxSide()
    assert isinstance(port.cadence, CadenceEngine)
    for code in range(-2, 901):
        assert applet.apply_command_code(port, code) == \
            jax_applet.apply_command_code(ref, code), code
        assert state(port) == state(ref), code


@pytest.fixture()
def served_engine(tmp_path):
    e = engine(scene_detection=False, auto_quality=False)
    fifo = str(tmp_path / "hr")
    server = AppletServer(fifo, e, period=0.05)
    server.start()
    yield e, fifo
    server.stop()
    assert not any(t.is_alive() for t in server._threads)


class TestAppletServerFifo:
    def test_fifo_roundtrip(self, served_engine):
        """Drive the protocol over real FIFOs as the widget does (512-byte
        status blocks)."""
        e, fifo = served_engine
        with open(fifo + ".cmd", "w") as cmd:
            cmd.write("5\n")   # HSVFlow
        status = b""

        def read():
            nonlocal status
            with open(fifo, "rb") as fh:
                status = fh.read(512)

        t = threading.Thread(target=read)
        t.start()
        t.join(timeout=5.0)
        assert not t.is_alive()
        assert len(status) == 512
        assert status.rstrip(b"\0").decode().startswith("Search Radius: ")
        assert wait_for(lambda: e.frame_output_mode == 3)

    def test_stop_without_a_widget(self, tmp_path):
        """stop() joins both threads though no widget ever opened a FIFO."""
        server = AppletServer(str(tmp_path / "hr"), engine(), period=0.05)
        server.start()
        server.stop()
        assert not any(t.is_alive() for t in server._threads)


class TestClientRoundTrip:
    def test_read_status_block(self, served_engine):
        _, fifo = served_engine
        text = read_status(fifo, timeout=5.0)
        assert "Search Radius: 5" in text
        assert "Target Time:" in text and "OFC Time:" in text

    def test_send_codes_mutate_engine(self, served_engine):
        e, fifo = served_engine
        send_code(fifo, 4)            # frame output mode -> 2 (blend)
        send_code(fifo, 10)           # levels preset 10/219
        assert wait_for(lambda: e.white_level == 219.0)
        assert e.frame_output_mode == 2
        assert (e.black_level, e.white_level) == (10.0, 219.0)
        assert e.levels == (10, 219)

    def test_cli_once_and_send(self, served_engine, capsys):
        e, fifo = served_engine
        assert client_main([fifo, "--send", "7"]) == 0
        assert client_main([fifo, "--once"]) == 0
        assert "Search Radius" in capsys.readouterr().out
        assert wait_for(lambda: e.frame_output_mode == 5)

    def test_read_status_without_a_server_times_out(self, tmp_path):
        """A FIFO nobody writes reads as at its end: the client waits out
        its timeout and raises, it does not spin for ever."""
        fifo = str(tmp_path / "hr")
        os.mkfifo(fifo)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            read_status(fifo, timeout=0.2)
        assert time.monotonic() - t0 < 5.0

    def test_rapid_codes_are_all_applied(self, served_engine):
        """Codes sent back to back all land (the command FIFO never closes
        under a client between two of them)."""
        e, fifo = served_engine
        for white in range(200, 256):
            send_code(fifo, 400 + white)
        assert wait_for(lambda: e.white_level == 255.0)
        assert e.stats.count("control_failures") == 0


# --- the profiler hooks ----------------------------------------------------------

def test_annotate_and_timed_block():
    """A span with no profiler is a no-op around the work."""
    with annotate("test-region"):
        x = torch.arange(16) * 2
    assert int(x[1]) == 2


def test_device_trace_writes_a_trace(tmp_path):
    """The trace of a pair on the CPU holds the annotated region and the
    engine's tensor ops (on a card also every kernel: chip_smoke.py)."""
    e = engine()
    frames = list(synthetic.moving_box(CFG, 3))
    e.push(frames[0])
    with device_trace(str(tmp_path / "prof")):
        with annotate("two-pairs"):
            outs = e.push(frames[1]) + e.push(frames[2])
    assert len(outs) == 3 + 2       # 24 -> 60
    with open(tmp_path / "prof" / "trace.json") as fh:
        names = {ev.get("name") for ev in json.load(fh)["traceEvents"]}
    assert "two-pairs" in names
    assert any(n and n.startswith("aten::") for n in names)
    np.testing.assert_array_equal(outs[0].to_video_frame().y.shape, (48, 64))
