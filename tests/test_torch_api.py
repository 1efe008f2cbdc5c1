"""The port's embedding API (``api.Player``) and JSON IPC on the CPU: the
analogs of the JAX package's ``tests/test_api_ipc.py`` (properties,
observers and events, commands, the IPC protocol, the playlist and quit
surface, runtime model / display-fps / max-calc-res changes, telemetry
properties) and of ``test_screenshot.py``'s ``TestScreenshotCommand``;
the port's Player against the JAX Player under one property script
(output bytes, property values and events equal); ``telemetry_text``
against the JAX applet's; and a bounded analog of
``test_concurrency.py::test_control_surfaces_under_playback``.

Every engine runs on the CPU (``device="cpu"``), at 64x48 unless named;
the tolerance is byte-equal throughout.  One JAX engine runs here (the
property script)."""

import json
import os
import random
import re
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mpv_frame_interpolator_tpu import api as jax_api
from mpv_frame_interpolator_tpu.control import applet as jax_applet
from mpv_frame_interpolator_tpu.io import synthetic as jax_synthetic
from mpv_frame_interpolator_tpu.pipeline import engine as jax_engine
from mpv_frame_interpolator_tpu_torch.api import (
    EventType, Player, PropertyError)
from mpv_frame_interpolator_tpu_torch.control import applet
from mpv_frame_interpolator_tpu_torch.control.ipc import IPCServer
from mpv_frame_interpolator_tpu_torch.io import synthetic
from mpv_frame_interpolator_tpu_torch.io.playlist import ChainedSource
from mpv_frame_interpolator_tpu_torch.io.sinks import NullSink
from mpv_frame_interpolator_tpu_torch.io.y4m import Y4MReader, Y4MWriter
from mpv_frame_interpolator_tpu_torch.pipeline.engine import (
    EngineConfig, InterpolationEngine)
from mpv_frame_interpolator_tpu_torch.pipeline.player import Pipeline
from mpv_frame_interpolator_tpu_torch.utils.png import decode_png
from test_torch_cuda import GROUP_SCRIPT, property_script_groups

torch.set_num_threads(1)

JOIN_S = 60.0
CFG = synthetic.SyntheticConfig(width=64, height=48, fps=24.0)


def make_player(**kw):
    return Player(EngineConfig(scene_detection=False, auto_quality=False,
                               measure_timing=False, device="cpu", **kw))


def clip(n, cfg=CFG, name="moving_box"):
    return list(getattr(synthetic, name)(cfg, n))


def later(frames, dt=1.0):
    """The frames again, `dt` seconds later on the same timeline."""
    out = [f.with_pts(f.pts + dt) for f in frames]
    for f in out:
        f.nominal_fps = 24.0
    return out


def rpc_client(path):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(path)
    f = c.makefile("rwb")

    def rpc(obj):
        f.write((json.dumps(obj) + "\n").encode())
        f.flush()
        return json.loads(f.readline())
    return c, f, rpc


class TestPlayerAPI:
    def test_properties(self):
        p = make_player()
        assert p.get_property("speed") == 1.0
        p.set_property("speed", 2.0)
        assert p.get_property("speed") == 2.0
        assert p.engine.cadence.playback_speed == 2.0
        p.set_property("frame-output-mode", 3)
        assert p.engine.frame_output_mode == 3
        with pytest.raises(PropertyError):
            p.get_property("nope")
        with pytest.raises(PropertyError):
            p.set_property("interpolation-state", "ACTIVE")
        for name, bad in (("frame-output-mode", 7), ("delta-scalar", 32),
                          ("neighbor-bias-scalar", -1), ("model", "bogus")):
            with pytest.raises(ValueError):
                p.set_property(name, bad)

    def test_radius_clamped(self):
        p = make_player()
        p.set_property("search-radius", 99)
        assert p.get_property("search-radius") == 16
        p.set_property("search-radius", 1)
        assert p.get_property("search-radius") == 5

    def test_observers_and_events(self):
        p = make_player()
        seen = []
        p.observe_property("speed", lambda n, v: seen.append(v))
        p.set_property("speed", 0.5)
        assert seen == [1.0, 0.5]
        # 0.5x speed halves the effective source rate: 5 outputs a source
        outs = list(p.feed_all(clip(3)))
        assert len(outs) == 1 + 5 + 5
        types = set()
        while True:
            ev = p.wait_event()
            if ev is None:
                break
            types.add(ev.type)
        assert EventType.FRAMES_OUT in types
        assert EventType.END_OF_STREAM in types

    def test_applet_code_command(self):
        p = make_player()
        p.command("applet-code", 5)   # HSVFlow
        assert p.get_property("frame-output-mode") == 3

    def test_property_names_are_the_jax_players(self):
        jp = jax_api.Player(jax_engine.EngineConfig(
            background_precompile=False))
        assert make_player().property_names() == jp.property_names()


class TestIPC:
    def test_json_protocol(self, tmp_path):
        p = make_player()
        sock_path = str(tmp_path / "ipc.sock")
        srv = IPCServer(sock_path, p)
        srv.start()
        try:
            c, f, rpc = rpc_client(sock_path)
            r = rpc({"command": ["get_property", "speed"]})
            assert r == {"error": "success", "data": 1.0}
            r = rpc({"command": ["set_property", "speed", 2.5],
                     "request_id": 7})
            assert r["error"] == "success" and r["request_id"] == 7
            assert p.get_property("speed") == 2.5
            r = rpc({"command": ["observe_property", 1, "search-radius"]})
            assert r["error"] == "success"
            # initial observer push arrives as an event line
            ev = json.loads(f.readline())
            assert ev["event"] == "property-change"
            assert ev["name"] == "search-radius"
            r = rpc({"command": ["get_property", "bogus"]})
            assert r["error"] != "success"
            r = rpc({"command": ["set_property", "frame-output-mode", 9]})
            assert r["error"].startswith("ValueError")
            c.close()
        finally:
            srv.stop()
        assert not os.path.exists(sock_path)

    def test_property_list(self, tmp_path):
        p = make_player()
        sock_path = str(tmp_path / "pl.sock")
        srv = IPCServer(sock_path, p)
        srv.start()
        try:
            c, f, rpc = rpc_client(sock_path)
            r = rpc({"command": ["property-list"]})
            assert r["error"] == "success"
            assert r["data"] == p.property_names()
            c.close()
        finally:
            srv.stop()

    def test_stop_closes_connected_clients(self, tmp_path):
        """stop() with a client still connected joins every thread."""
        sock_path = str(tmp_path / "s.sock")
        srv = IPCServer(sock_path, make_player())
        srv.start()
        c, f, rpc = rpc_client(sock_path)
        assert rpc({"command": ["get_property", "pause"]})["data"] is False
        srv.stop()
        assert not srv._thread.is_alive()
        assert not any(t.is_alive() for t in srv._client_threads)
        c.close()


class TestPlaylistQuitSurface:
    def test_playlist_props_single_file(self):
        p = make_player()
        assert p.get_property("playlist-pos") == 0
        assert p.get_property("playlist-count") == 1

    def test_playlist_props_chained(self, tmp_path):
        cfg = synthetic.SyntheticConfig(width=32, height=32)
        for name in ("a", "b", "c"):
            with open(tmp_path / f"{name}.y4m", "wb") as fh:
                w = Y4MWriter(fh, 32, 32, 24.0)
                for f in synthetic.moving_box(cfg, 2):
                    w.write(f)
        src = ChainedSource([str(tmp_path / f"{n}.y4m")
                             for n in ("a", "b", "c")],
                            lambda path: Y4MReader(open(path, "rb")))
        p = make_player()
        pipe = Pipeline(src, p.engine, NullSink(), present=None)
        p.bind_pipeline(pipe)
        assert p.get_property("playlist-count") == 3
        pipe.run()
        assert p.get_property("playlist-pos") == 2

    def test_quit_command(self):
        p = make_player()
        pipe = Pipeline(synthetic.moving_box(
            synthetic.SyntheticConfig(width=32, height=32), 100000),
            p.engine, NullSink(), present=None)
        p.bind_pipeline(pipe)
        runner = threading.Thread(target=pipe.run)
        runner.start()
        time.sleep(0.3)
        p.command("quit")
        runner.join(timeout=JOIN_S)
        assert not runner.is_alive()

    def test_quit_without_pipeline(self):
        with pytest.raises(PropertyError):
            make_player().command("quit")


class TestModelSwitch:
    def test_runtime_model_switch(self):
        """A switch reaches the next pair: the outputs after it equal a
        static engine of the new model on the same frames."""
        frames = clip(6)
        p = make_player()
        for f in frames[:3]:
            p.feed(f)
        assert p.get_property("model") == "hopper"
        p.set_property("model", "blend")
        got = [o for f in frames[3:] for o in p.feed(f)]
        static = make_player(model="blend")
        want = [o for f in frames for o in static.feed(f)][-len(got):]
        assert len(got) >= 2
        for a, b in zip(got, want):
            a, b = a.to_video_frame(), b.to_video_frame()
            assert a.pts == b.pts
            np.testing.assert_array_equal(a.y, b.y)
            np.testing.assert_array_equal(a.uv, b.uv)
        with pytest.raises(Exception):
            p.set_property("model", "bogus")


class TestDisplayFpsRetarget:
    def test_display_fps_change_retargets_cadence(self):
        p = make_player()
        outs = list(p.feed_all(clip(3)))
        assert len(outs) == 1 + 3 + 2        # 24->60
        p.set_property("display-fps", 120.0)
        assert p.get_property("display-fps") == pytest.approx(120.0)
        outs2 = []
        for f in later(clip(2)):
            outs2.extend(p.feed(f))
        # 24->120: 5 outputs per source pair
        assert len(outs2) == 10
        with pytest.raises(ValueError):
            p.set_property("display-fps", 0)


class TestTelemetryProperties:
    def test_telemetry_props(self):
        p = make_player()
        list(p.feed_all(clip(3)))
        assert p.get_property("calc-res") == "64x48"
        assert p.get_property("scene-cut-score") >= 0.0
        assert p.get_property("ofc-time") >= 0.0
        for name in ("warp-time", "total-time"):
            assert isinstance(p.get_property(name), float)

    def test_split_timing_after_a_read(self):
        """Reading ofc-time turns on the split measurement: the next timed
        pairs publish flow and warp times."""
        p = Player(EngineConfig(auto_quality=False, device="cpu"))
        frames = clip(5)
        for f in frames[:2]:
            p.feed(f)
        assert p.get_property("ofc-time") == 0.0
        for f in frames[2:]:
            p.feed(f)
        assert p.get_property("ofc-time") > 0.0
        assert p.get_property("warp-time") > 0.0
        assert p.get_property("total-time") > 0.0


class TestMaxCalcRes:
    def test_runtime_flow_resolution_change(self):
        cfg = synthetic.SyntheticConfig(width=256, height=544, fps=24.0)
        p = make_player()
        for f in synthetic.gradient_pan(cfg, 3):
            p.feed(f)
        assert p.get_property("calc-res") == "64x136"   # 544>>2
        p.set_property("max-calc-res", 544)
        for f in later(list(synthetic.gradient_pan(cfg, 2))):
            p.feed(f)
        assert p.get_property("calc-res") == "256x544"  # full res flow
        with pytest.raises(ValueError):
            p.set_property("max-calc-res", 8)


class TestScreenshotCommand:
    def _run_pipeline(self, n=6):
        engine = InterpolationEngine(EngineConfig(measure_timing=False,
                                                  device="cpu"))
        pipe = Pipeline(synthetic.moving_box(CFG, n), engine, NullSink(),
                        present=None)
        player = Player(engine=engine)
        player.bind_pipeline(pipe)
        pipe.run()
        return player, pipe

    def test_screenshot_writes_png(self, tmp_path):
        from mpv_frame_interpolator_tpu_torch.io.convert import frame_to_rgb
        player, pipe = self._run_pipeline()
        path = str(tmp_path / "shot.png")
        assert player.command("screenshot", path) == path
        img = decode_png(open(path, "rb").read())
        assert img.shape == (48, 64, 3)
        np.testing.assert_array_equal(
            img, frame_to_rgb(pipe.last_output.to_video_frame()))

    def test_screenshot_before_any_frame(self):
        player = Player(engine=InterpolationEngine(EngineConfig(
            device="cpu")))
        with pytest.raises(PropertyError):
            player.command("screenshot")


# --- the port's Player against the JAX Player --------------------------------

# (source-frame index: properties set just before it is fed), the chip
# smoke test's property script at 64x48.  A model switch rides with a
# max-calc-res change: the JAX engine reads its model when it derives its
# geometry (engine.py:873) and so ignores a switch until then, while the
# port takes it at the next pair (TestModelSwitch, and the static-engine
# check on the card); at 48 rows both max-calc-res values give the same
# geometry, and both engines derive it again and restart the cadence.
SCRIPT = {
    3: [("frame-output-mode", 0)],
    5: [("frame-output-mode", 3)],
    7: [("frame-output-mode", 2)],
    8: [("black-level", 16), ("white-level", 235)],
    10: [("delta-scalar", 4), ("neighbor-bias-scalar", 2)],
    12: [("search-radius", 5)],
    14: [("search-radius", 16)],
    15: [("model", "hopperx"), ("max-calc-res", 135)],
    18: [("model", "hopper"), ("max-calc-res", 270)],
    20: [("scene-threshold", 3.0)],
}
SCRIPT_FRAMES = 24
TIMING = ("stats", "ofc-time", "warp-time", "total-time")


def _run_script(player, frames):
    outs, props = [], []
    for i, f in enumerate(frames):
        for name, value in SCRIPT.get(i, []):
            player.set_property(name, value)
        outs.append([o.to_video_frame() for o in player.feed(f)])
        props.append({n: player.get_property(n)
                      for n in player.property_names() if n not in TIMING})
    list(player.feed_all([]))           # the end-of-stream event
    events = []
    while True:
        ev = player.wait_event()
        if ev is None:
            break
        events.append((ev.type.value, ev.name, ev.data))
    return outs, props, events


@pytest.fixture(scope="module")
def script_runs():
    kw = dict(display_fps=120.0, auto_quality=False,
              initial_search_radius=16, measure_timing=False)
    jp = jax_api.Player(jax_engine.EngineConfig(
        background_precompile=False, **kw))
    pp = Player(EngineConfig(device="cpu", **kw))
    jcfg = jax_synthetic.SyntheticConfig(width=64, height=48)
    ref = _run_script(jp, list(jax_synthetic.moving_box(jcfg,
                                                        SCRIPT_FRAMES)))
    got = _run_script(pp, clip(SCRIPT_FRAMES))
    return jp, pp, ref, got


def test_property_script_outputs_equal_the_jax_player(script_runs):
    _, _, (ref, _, _), (got, _, _) = script_runs
    assert sum(map(len, got)) > SCRIPT_FRAMES * 3
    for i, (want, have) in enumerate(zip(ref, got)):
        assert len(want) == len(have), i
        for a, b in zip(want, have):
            assert a.pts == b.pts, i
            assert a.y.tobytes() == b.y.tobytes(), i
            assert a.uv.tobytes() == b.uv.tobytes(), i


def test_property_script_values_and_events_equal_the_jax_player(
        script_runs):
    _, _, (_, ref_props, ref_events), (_, props, events) = script_runs
    assert props == ref_props
    assert events == ref_events
    kinds = {t for t, _, _ in events}
    assert {"property-change", "frames-out", "end-of-stream"} <= kinds
    # the script's changes show in the values read after them
    assert props[9]["black-level"] == 16.0
    assert props[13]["search-radius"] == 5
    assert props[16]["model"] == "hopperx"
    assert props[21]["scene-threshold"] == 3.0


def _untimed(text):
    """The status block without its timing fields."""
    out = []
    for line in text.split("\n"):
        if line.startswith(("Total Time", "OFC Time", "Warp")):
            line = re.sub(r"[0-9.]+", "#", line)
        out.append(line)
    return "\n".join(out)


def test_telemetry_text_equals_the_jax_applet_but_for_timings(script_runs):
    jp, pp, _, _ = script_runs
    want = jax_applet.telemetry_text(jp.engine)
    have = applet.telemetry_text(pp.engine)
    assert have.split("\n")[0] == "Search Radius: 16"
    assert _untimed(have) == _untimed(want)


def test_property_changes_between_push_many_groups_equal_push():
    """On the CPU (the body run eagerly): each property change between two
    push_many calls reaches the next pair as it does under push
    (tests/test_torch_cuda.py runs the same script through captured
    graphs on a card)."""
    ref, got, e = property_script_groups("cpu")
    assert len(got) == len(ref) > 100
    for a, b in zip(ref, got):
        fa, fb = a.to_video_frame(), b.to_video_frame()
        assert a.pts == b.pts
        assert fa.y.tobytes() == fb.y.tobytes()
        assert fa.uv.tobytes() == fb.uv.tobytes()
    assert e.group_stats["groups"] > len(GROUP_SCRIPT)


# --- control surfaces under playback -----------------------------------------

class _Sink:
    def __init__(self):
        self.count = 0

    def write(self, out):
        self.count += 1

    def close(self):
        pass


def test_control_surfaces_under_playback(tmp_path):
    """Two property threads, an IPC client, the applet's FIFO client and
    a transport thread (seek, pause, frame-step, seek-reset) against a
    120-frame y4m clip playing on the CPU, for at most LIMIT seconds: no
    error, no deadlock, no failure counted, the invariants hold."""
    from mpv_frame_interpolator_tpu_torch.control.applet_client import (
        read_status, send_code)
    limit = 15.0
    path = tmp_path / "in.y4m"
    with open(path, "wb") as fh:
        w = Y4MWriter(fh, 64, 48, 24.0)
        for f in clip(120):
            w.write(f)
    engine = InterpolationEngine(EngineConfig(
        scene_detection=True, auto_quality=True, measure_timing=True,
        device="cpu"))
    sink = _Sink()
    pipe = Pipeline(Y4MReader(open(path, "rb")), engine, sink,
                    present=None)
    player = Player(engine=engine)
    player.bind_pipeline(pipe)
    sock = str(tmp_path / "ipc.sock")
    fifo = str(tmp_path / "hr")
    ipc = IPCServer(sock, player)
    ipc.start()
    applet_srv = applet.AppletServer(fifo, engine, period=0.01)
    applet_srv.start()

    stop = threading.Event()
    errors = []

    def guarded(fn):
        # each hammer sleeps 1 ms a round: the plain versions are many
        # small tensor ops on the engine's thread, each of which waits for
        # the interpreter lock again when it returns
        def run(seed):
            r = random.Random(seed)
            try:
                while not stop.is_set():
                    fn(r)
                    time.sleep(0.001)
            except Exception as e:     # noqa: BLE001 - the test's point
                errors.append(e)
        return run

    @guarded
    def properties(r):
        name = r.choice(player.property_names())
        try:
            player.get_property(name)
            if r.random() < 0.3:
                player.set_property("speed", r.choice([1.0, 1.5, 2.0]))
            if r.random() < 0.2:
                player.set_property("search-radius", r.randint(5, 16))
            if r.random() < 0.1:
                player.set_property("frame-output-mode", r.randint(0, 4))
        except PropertyError:
            pass

    c, f, rpc = rpc_client(sock)

    @guarded
    def ipc_client(r):
        name = r.choice(["ofc-time", "calc-res", "scene-cut-score",
                         "search-radius", "pause"])
        assert rpc({"command": ["get_property", name]})["error"] == \
            "success"
        assert rpc({"command": ["set_property", "black-level",
                                r.choice([0, 16])]})["error"] == "success"

    @guarded
    def applet_client(r):
        send_code(fifo, r.randint(-5, 900))
        assert read_status(fifo, timeout=5.0).startswith("Search Radius")

    @guarded
    def transport(r):
        act = r.random()
        if act < 0.3:
            pipe.seek(r.uniform(0.0, 4.0))
        elif act < 0.6:
            pipe.set_pause(True)
            time.sleep(0.01)
            pipe.frame_step()
            pipe.set_pause(False)
        else:
            player.command("seek-reset")
        time.sleep(0.02)

    threads = [threading.Thread(target=properties, args=(1,)),
               threading.Thread(target=properties, args=(2,)),
               threading.Thread(target=ipc_client, args=(3,)),
               threading.Thread(target=applet_client, args=(4,)),
               threading.Thread(target=transport, args=(5,))]
    runner = threading.Thread(target=pipe.run)
    # a short switch interval: the engine's thread gets the interpreter
    # lock back soon after each tensor op, and the threads interleave
    # more finely (more chances for a lost update)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        t0 = time.monotonic()
        for t in threads:
            t.start()
        runner.start()
        runner.join(timeout=limit)
        pipe.quit()          # the limit: playback stops at the next frame
        stop.set()
        runner.join(timeout=JOIN_S)
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        sys.setswitchinterval(interval)
        stop.set()
        pipe.quit()
        c.close()
        ipc.stop()
        applet_srv.stop()
    assert not runner.is_alive(), "pipeline deadlocked under concurrency"
    assert not any(t.is_alive() for t in threads)
    assert not any(t.is_alive() for t in applet_srv._threads)
    assert time.monotonic() - t0 < limit + 10.0
    assert not errors, f"control-surface errors: {errors[:3]}"
    assert engine.stats.count("control_failures") == 0
    assert pipe.engine_failures() == 0
    assert sink.count > 20
    q = engine.quality
    assert q.min_radius <= q.search_radius <= q.max_radius
    assert 0.0 <= engine.black_level <= 255.0
    assert engine.cadence.target_frame_time > 0
