"""Runtime control surfaces of the port (counterparts of the JAX
package's ``control/``): the settings-applet FIFO protocol and its
terminal client, key bindings and the terminal reader, and the JSON IPC
server.  Every surface sets host state of the engine between pairs
(``api.Player``, ``pipeline/engine.PairKnobs``) and never moves it off
its device."""

from __future__ import annotations

from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("control")


def count_failure(engine, what: str):
    """A control thread's failure: logged with its traceback and counted
    in the engine's stats (``control_failures``); playback goes on, on
    the engine's device.  Call from an ``except`` block."""
    log.exception("%s failed", what)
    engine.stats.add("control_failures", 1.0)
