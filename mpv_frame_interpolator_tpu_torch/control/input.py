"""Input layer: key bindings, input.conf, terminal keyboard control (the
port's copy of the JAX package's ``control/input.py``).

The reference's input core (input/input.c) maps keys to command strings
through a bindings table assembled from built-in defaults
(etc/input.conf baked in at build time) and the user's
~/.config/mpv/input.conf.  This module is that shape for the rebuild:

* `parse_input_conf` reads the same `KEY command args  # comment` line
  format (subset: no sections, no multi-key sequences);
* `DEFAULT_BINDINGS` mirrors the reference defaults for every command
  this player supports (etc/input.conf: RIGHT/LEFT/UP/DOWN seek,
  [ ] multiply speed, SPACE/p cycle pause, . frame-step, s screenshot,
  q quit, Q quit-watch-later);
* `KeyDispatcher` interprets the command strings against the Player /
  Pipeline surface (the input.c -> command.c hop);
* `TerminalInput` is the terminal driver: raw-mode tty reader thread
  decoding arrow-key escape sequences (osdep/terminal-unix.c analog).

Unbound keys and unsupported commands are ignored with a log line, like
the reference's "no key binding" message; a command that fails is logged
and counted (``control_failures`` in the engine's stats).
"""

from __future__ import annotations

import os
import select
import threading
from typing import Callable, Dict, Optional

from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("input")

# reference defaults (etc/input.conf) restricted to supported commands
DEFAULT_BINDINGS: Dict[str, str] = {
    "RIGHT": "seek 5",
    "LEFT": "seek -5",
    "UP": "seek 60",
    "DOWN": "seek -60",
    "[": "multiply speed 1/1.1",
    "]": "multiply speed 1.1",
    "{": "multiply speed 0.5",
    "}": "multiply speed 2.0",
    "SPACE": "cycle pause",
    "p": "cycle pause",
    ".": "frame-step",
    "s": "screenshot",
    "q": "quit",
    "Q": "quit-watch-later",
}


def parse_input_conf(text: str) -> Dict[str, str]:
    """`KEY command args  # comment` lines -> {key: command string}.
    `SHARP` names the # key (input.conf convention); `ignore` unbinds."""
    out: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        # trailing comment: ' #' starts one unless inside quotes (the
        # subset we accept has no quoted strings)
        cut = line.find(" #")
        if cut != -1:
            line = line[:cut].rstrip()
        parts = line.split(None, 1)
        if len(parts) != 2:
            log.warning("input.conf: ignoring malformed line %r", raw)
            continue
        key, cmd = parts
        if key == "SHARP":
            key = "#"
        out[key] = cmd.strip()
    return out


class KeyDispatcher:
    """Execute input.conf command strings against the player surface
    (the input.c -> command.c dispatch)."""

    def __init__(self, player, pipeline=None,
                 on_quit: Optional[Callable[[bool], None]] = None,
                 bindings: Optional[Dict[str, str]] = None,
                 default_bindings: bool = True):
        self.player = player
        self.pipeline = pipeline if pipeline is not None \
            else getattr(player, "pipeline", None)
        self.on_quit = on_quit
        self.bindings = dict(DEFAULT_BINDINGS) if default_bindings else {}
        if bindings:
            self.bindings.update(bindings)
        self.dispatched = 0

    # -- command interpreter ----------------------------------------------

    @staticmethod
    def _num(tok: str) -> float:
        if "/" in tok:
            a, b = tok.split("/", 1)
            return float(a) / float(b)
        return float(tok)

    def run_command(self, cmd: str) -> bool:
        """True if the command was understood (regardless of effect)."""
        parts = cmd.split()
        if not parts or parts[0] == "ignore":
            return True
        name, args = parts[0], parts[1:]
        try:
            if name == "seek" and args:
                cur = self.player.engine.cadence.current_output_pts
                self.pipeline.seek(max(cur + self._num(args[0]), 0.0))
            elif name == "multiply" and len(args) == 2:
                cur = float(self.player.get_property(args[0]))
                self.player.set_property(args[0], cur * self._num(args[1]))
            elif name == "set" and len(args) == 2:
                self.player.set_property(args[0], args[1])
            elif name == "add" and len(args) == 2:
                cur = float(self.player.get_property(args[0]))
                self.player.set_property(args[0], cur + self._num(args[1]))
            elif name == "cycle" and args and args[0] == "pause":
                self.pipeline.set_pause(not self.pipeline.paused)
            elif name == "frame-step":
                if self.pipeline.paused:
                    self.pipeline.frame_step()
                else:
                    self.pipeline.set_pause(True)
            elif name == "screenshot":
                path = self.player.command("screenshot")
                log.info("screenshot written to %s", path)
            elif name == "quit":
                if self.on_quit:
                    self.on_quit(False)
                elif self.pipeline is not None:
                    self.pipeline.quit()
            elif name == "quit-watch-later":
                if self.on_quit:
                    self.on_quit(True)
                elif self.pipeline is not None:
                    self.pipeline.quit()
            else:
                log.info("unsupported command %r", cmd)
                return False
        except Exception as e:  # noqa: BLE001 - a bad key must not kill play
            log.warning("command %r failed: %s", cmd, e)
            self.player.engine.stats.add("control_failures", 1.0)
        return True

    def on_key(self, key: str) -> bool:
        cmd = self.bindings.get(key)
        if cmd is None:
            log.debug("no key binding for %r", key)
            return False
        self.dispatched += 1
        return self.run_command(cmd)


# escape sequences -> input.conf key names (osdep/terminal-unix.c table)
_ESC_KEYS = {
    b"[A": "UP", b"[B": "DOWN", b"[C": "RIGHT", b"[D": "LEFT",
    b"OA": "UP", b"OB": "DOWN", b"OC": "RIGHT", b"OD": "LEFT",
    b"[H": "HOME", b"[F": "END",
    b"[5~": "PGUP", b"[6~": "PGDWN",
}


def decode_keys(data: bytes):
    """Incremental byte stream -> input.conf key names.  Returns
    (keys, remainder) where remainder is an incomplete escape prefix."""
    keys = []
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if b == 0x1B:                     # ESC ...
            seq = data[i + 1:i + 5]
            matched = None
            for pat, name in _ESC_KEYS.items():
                if seq.startswith(pat):
                    matched = (name, 1 + len(pat))
                    break
            if matched:
                keys.append(matched[0])
                i += matched[1]
                continue
            if i + 1 >= n or (n - i) < 5 and data[i + 1:i + 2] in (b"[", b"O"):
                return keys, data[i:]     # maybe incomplete sequence
            keys.append("ESC")
            i += 1
        elif b == 0x20:
            keys.append("SPACE")
            i += 1
        elif b in (0x0A, 0x0D):
            keys.append("ENTER")
            i += 1
        elif b == 0x09:
            keys.append("TAB")
            i += 1
        elif b < 0x20:
            keys.append(f"Ctrl+{chr(b + 0x60)}")
            i += 1
        else:
            keys.append(chr(b))
            i += 1
    return keys, b""


class TerminalInput:
    """Raw-mode tty reader thread feeding a KeyDispatcher (the terminal
    half of input.c + osdep/terminal-unix.c)."""

    def __init__(self, dispatcher: KeyDispatcher, fd: Optional[int] = None):
        self.dispatcher = dispatcher
        self._own_fd = fd is None
        if fd is None:
            fd = os.open("/dev/tty", os.O_RDONLY)
        self.fd = fd
        self._stop = threading.Event()
        self._saved = None
        self._thread = None

    def start(self):
        try:
            import termios
            import tty
            self._saved = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
        except Exception as e:  # noqa: BLE001 - not a tty (tests/pipes)
            log.debug("raw mode unavailable on fd %d: %s", self.fd, e)
        self._thread = threading.Thread(target=self._work,
                                        name="mfi-input", daemon=True)
        self._thread.start()
        return self

    def _work(self):
        pending = b""
        while not self._stop.is_set():
            r, _, _ = select.select([self.fd], [], [], 0.1)
            if not r:
                if pending == b"\x1b":           # lone ESC, no sequence
                    self.dispatcher.on_key("ESC")
                    pending = b""
                continue
            try:
                data = os.read(self.fd, 64)
            except OSError:
                return
            if not data:
                return
            keys, pending = decode_keys(pending + data)
            for k in keys:
                self.dispatcher.on_key(k)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._saved is not None:
            try:
                import termios
                termios.tcsetattr(self.fd, termios.TCSANOW, self._saved)
            except Exception:  # noqa: BLE001
                pass
        if self._own_fd:
            try:
                os.close(self.fd)
            except OSError:
                pass
