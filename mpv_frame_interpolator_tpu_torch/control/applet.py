"""Settings-applet control protocol (FIFO/pipe IPC); the port's copy of
the JAX package's ``control/applet.py``.

Wire-compatible with the reference's AppIndicator widget
(HopperRenderSettingsApplet.py): the widget writes integer command codes on
a pipe and reads a status text block from the FIFO /tmp/hopperrender
(HopperRenderSettingsApplet.py:9,21,253-263).

Command codes (decoded exactly as vf_HopperRender.c:126-183):
      0  deactivate (resets counters + blending scalar)
      1  activate
    2-8  frame output mode (WarpedFrame12 .. SideBySide2)
      9  levels 0/255    10  levels 10/219    11  levels 16/219
 100-355 black level = code-100
 400-655 white level = code-400
 700-731 delta scalar = code-700
 800-831 neighbor bias scalar = code-800

The rebuild runs the protocol over two FIFOs: `<path>` carries status
toward the widget, `<path>.cmd` carries command codes toward the engine
(the reference uses the forked child's stdout pipe for commands,
vf_HopperRender.c:223-276; a standalone server has no child to fork).

Telemetry text layout mirrors vf_HopperRender_update_AppIndicator_widget
(vf_HopperRender.c:191-216): search radius, calc res, target/source/total/
OFC/warp timings, then up to 10 per-warp durations.
"""

from __future__ import annotations

import errno
import os
import select
import threading

from mpv_frame_interpolator_tpu_torch.control import count_failure
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("applet")


def parse_code_line(line: str):
    """One line of the command FIFO -> int code, or None if not a code.
    Tolerates arbitrary hostile text (the FIFO is world-writable)."""
    line = line.strip()
    if not line or len(line) > 32:
        return None
    body = line[1:] if line[0] == "-" else line
    if not body.isdigit() or not body.isascii():
        return None
    try:
        return int(line)
    except ValueError:  # pragma: no cover - isdigit already filtered
        return None


def apply_command_code(engine, code: int) -> bool:
    """Apply one integer command code; returns False if unknown."""
    cadence = engine.cadence
    if code == 0:
        cadence.set_active(False)
    elif code == 1:
        cadence.set_active(True)
    elif 2 <= code <= 8:
        engine.frame_output_mode = code - 2
    elif code == 9:
        engine.black_level, engine.white_level = 0.0, 255.0
    elif code == 10:
        engine.black_level, engine.white_level = 10.0, 219.0
    elif code == 11:
        engine.black_level, engine.white_level = 16.0, 219.0
    elif 100 <= code <= 355:
        engine.black_level = float(code - 100)
    elif 400 <= code <= 655:
        engine.white_level = float(code - 400)
    elif 700 <= code <= 731:
        engine.delta_scalar = code - 700
    elif 800 <= code <= 831:
        engine.neighbor_bias_scalar = code - 800
    else:
        return False
    return True


def telemetry_text(engine) -> str:
    """Status block in the reference widget's format
    (vf_HopperRender.c:194-210)."""
    cad = engine.cadence
    geom = engine.geom
    stats = engine.stats
    # a status consumer exists: enable the real flow/warp split measurement
    engine.request_split_timing()
    sft = cad.source_frame_time
    tft = cad.target_frame_time
    ofc = stats.last("flow_time")
    warp_total = stats.last("warp_total")
    total = ofc + warp_total
    radius = engine.quality.search_radius
    if geom is not None:
        calc_w = geom.stride >> geom.res_scalar
        calc_h = geom.height >> geom.res_scalar
    else:
        calc_w = calc_h = 0

    def inv(x):
        return 1.0 / x if x > 0 else 0.0

    lines = [
        f"Search Radius: {radius}",
        f"Calc Res: {calc_w}x{calc_h}",
        f"Target Time: {tft * 1e3:06.2f} ms ({inv(tft):.1f} fps)",
        f"Frame Time: {sft * 1e3:06.2f} ms ({inv(sft):.3f} fps | "
        f"{cad.playback_speed:.2f}x)",
        f"Total Time: {total * 1e3:06.2f} ms ({inv(total):.0f} fps > "
        f"{inv(sft):.3f} fps)",
        f"OFC Time: {ofc * 1e3:06.2f} ms ({inv(ofc):.0f} fps > "
        f"{inv(sft):.3f} fps)",
        f"Warp Time: {warp_total * 1e3:06.2f} ms ({inv(warp_total):.0f} fps > "
        f"{inv(sft):.3f} fps)",
    ]
    warps = list(stats.series("warp_time").window)[-10:]
    for i in range(10):
        if i < min(len(warps), cad.num_int_frames, 10):
            lines.append(f"Warp{i}: {warps[i] * 1e3:06.2f} ms")
        else:
            lines.append("")
    return "\n".join(lines)


class AppletServer:
    """Serves the applet protocol on a pair of FIFOs in background threads."""

    def __init__(self, fifo_path: str, engine, period: float = 0.5):
        self.fifo_path = fifo_path
        self.cmd_path = fifo_path + ".cmd"
        self.engine = engine
        self.period = period
        self._stop = threading.Event()
        self._threads = []

    def start(self):
        for path in (self.fifo_path, self.cmd_path):
            try:
                os.mkfifo(path, 0o666)
            except OSError as e:
                if e.errno != errno.EEXIST:
                    raise
        t1 = threading.Thread(target=self._serve_status, daemon=True)
        t2 = threading.Thread(target=self._serve_commands, daemon=True)
        self._threads = [t1, t2]
        t1.start()
        t2.start()
        log.info("applet protocol on %s (status) / %s (commands)",
                 self.fifo_path, self.cmd_path)

    def stop(self, timeout: float = 2.0):
        """Stop both threads and join them (neither blocks in an open or
        a read: each polls its FIFO)."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout)

    def _serve_status(self):
        while not self._stop.is_set():
            try:
                # an open that does not block: ENXIO until a widget opens
                # the reading end, polled each period
                fd = os.open(self.fifo_path, os.O_WRONLY | os.O_NONBLOCK)
            except OSError as e:
                if e.errno != errno.ENXIO:
                    return
                self._stop.wait(self.period)
                continue
            try:
                while not self._stop.is_set():
                    text = telemetry_text(self.engine)
                    buf = text.encode().ljust(512, b"\0")[:512]
                    # 512 bytes go into a pipe whole or not at all; a
                    # widget that stopped reading (a full pipe) or went
                    # away ends this connection
                    os.write(fd, buf)
                    self._stop.wait(self.period)
            except OSError:
                continue
            except Exception:   # noqa: BLE001 - a control thread's boundary
                count_failure(self.engine, "applet status thread")
                return
            finally:
                os.close(fd)

    def _serve_commands(self):
        # opened for reading and writing: the FIFO always has a writer
        # (this one), so the reader never sees an end of file and never
        # closes under a client that opened it meanwhile (whose write
        # would then break the pipe); a code is a line
        try:
            fd = os.open(self.cmd_path, os.O_RDWR | os.O_NONBLOCK)
        except OSError:
            return
        pending = b""
        try:
            while not self._stop.is_set():
                if not select.select([fd], [], [], 0.1)[0]:
                    continue
                try:
                    pending += os.read(fd, 4096)
                except BlockingIOError:
                    continue
                *lines, pending = pending.split(b"\n")
                pending = pending[-64:]     # no line is longer than this
                for raw in lines:
                    code = parse_code_line(raw.decode(errors="replace"))
                    if code is None:
                        continue
                    try:
                        if apply_command_code(self.engine, code):
                            log.debug("applet command %d applied", code)
                    except Exception:   # noqa: BLE001 - it serves on
                        count_failure(self.engine, f"applet command {code}")
        finally:
            os.close(fd)
