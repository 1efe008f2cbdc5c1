"""JSON IPC server over a unix socket (input/ipc-unix analog); the port's
copy of the JAX package's ``control/ipc.py``.

Speaks the same line-oriented JSON protocol shape as mpv's --input-ipc-server
(DOCS/man/ipc.rst in upstream mpv): one JSON object per line with a
"command" array, replies {"error": "success", "data": ...}; property-change
events are pushed to clients that subscribed with observe_property.

    {"command": ["get_property", "speed"]}
    {"command": ["set_property", "speed", 2.0]}
    {"command": ["observe_property", 1, "search-radius"]}
    {"command": ["seek-reset"]}
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Optional

from mpv_frame_interpolator_tpu_torch.api import Player, PropertyError
from mpv_frame_interpolator_tpu_torch.control import count_failure
from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("ipc")


class IPCServer:
    def __init__(self, path: str, player: Player):
        self.path = path
        self.player = player
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._clients = []
        self._client_threads = []
        self._lock = threading.Lock()

    def start(self):
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(4)
        self._sock.settimeout(0.25)
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        log.info("JSON IPC listening on %s", self.path)

    def stop(self, timeout: float = 2.0):
        """Close the socket and every client connection, join the
        threads, remove the socket file."""
        self._stop.set()
        if self._sock:
            self._sock.close()
        with self._lock:
            for c in self._clients:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                    c.close()
                except OSError:
                    pass
            threads = list(self._client_threads)
        for t in [self._thread, *threads]:
            if t is not None:
                t.join(timeout)
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_client, args=(conn,),
                                 daemon=True)
            with self._lock:
                self._clients.append(conn)
                self._client_threads = [c for c in self._client_threads
                                        if c.is_alive()] + [t]
            t.start()

    def _serve_client(self, conn: socket.socket):
        file = conn.makefile("rwb")
        wlock = threading.Lock()

        def send(obj: dict):
            with wlock:
                file.write((json.dumps(obj) + "\n").encode())
                file.flush()

        try:
            while not self._stop.is_set():
                line = file.readline(1 << 20)
                if not line:
                    return
                self.handle_line(line, send)
        except (OSError, BrokenPipeError, ValueError):
            pass        # the client went away, or stop() closed the socket
        except Exception:   # noqa: BLE001 - a control thread's boundary
            count_failure(self.player.engine, "IPC client thread")
        finally:
            with self._lock:
                if conn in self._clients:
                    self._clients.remove(conn)

    def handle_line(self, line: bytes, send) -> None:
        """Process one request line (the fuzzable protocol entry point):
        any malformed input produces an error reply, never an exception."""
        req = None
        try:
            req = json.loads(line)
            self._handle(req, send)
        except (ValueError, KeyError, TypeError, IndexError,
                AttributeError, OverflowError, RecursionError) as e:
            reply = {"error": f"{type(e).__name__}: {e}"}
            if isinstance(req, dict) and "request_id" in req:
                rid = req["request_id"]
                if isinstance(rid, (str, int, float, bool)) or rid is None:
                    reply["request_id"] = rid
            send(reply)

    def _handle(self, req: dict, send) -> None:
        cmd = req["command"]
        name, args = cmd[0], cmd[1:]

        def reply(obj: dict):
            if "request_id" in req:
                obj = dict(obj, request_id=req["request_id"])
            send(obj)

        try:
            if name == "get_property":
                reply({"error": "success",
                       "data": self.player.get_property(args[0])})
            elif name == "set_property":
                self.player.set_property(args[0], args[1])
                reply({"error": "success"})
            elif name == "observe_property":
                obs_id, prop = args[0], args[1]

                def push(pname, value, _id=obs_id):
                    try:
                        send({"event": "property-change", "id": _id,
                              "name": pname, "data": value})
                    except (OSError, BrokenPipeError):
                        pass
                # reply BEFORE the initial property-change event, matching
                # mpv's IPC ordering
                reply({"error": "success"})
                self.player.observe_property(prop, push)
            elif name == "property-list":
                reply({"error": "success",
                       "data": self.player.property_names()})
            else:
                # generic commands (seek-reset, applet-code, ...)
                data = self.player.command(name, *args)
                reply({"error": "success", "data": data})
        except PropertyError as e:
            reply({"error": str(e)})
