"""Watch-later checkpoint and resume (the port's copy of the JAX package's
``pipeline/resume.py``; same key, same file format and the same default
directory, so a position saved by either CLI resumes in the other).

Reference behavior (player/configfiles.c): on quit (or periodically) mpv
writes playback position + a configurable option subset into a per-file
hashed config under watch_later/ (:211-233 hashing, :308 writing) and
reapplies it when the file is opened again.  The interpolator's own state
is deliberately unpersisted -- the reference rebuilds flow state from
scratch after any seek (vf_HopperRender.c:562-567) -- so a checkpoint is
exactly {position, runtime options}, stored as flat key=value text, one
file per media path.

`directory` defaults to the module's DEFAULT_DIR as it is when the call
is made.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, Optional

from mpv_frame_interpolator_tpu_torch.utils import get_logger

log = get_logger("resume")

DEFAULT_DIR = os.path.expanduser("~/.config/mfi_tpu/watch_later")

# runtime options worth carrying across sessions (mpv's default set is
# position+volume-ish; ours is position + the interpolation knobs)
SAVED_PROPS = ("speed", "frame-output-mode", "search-radius", "black-level",
               "white-level", "scene-threshold")


def _key(media_path: str) -> str:
    return hashlib.md5(os.path.abspath(media_path).encode()).hexdigest().upper()


def _path(media_path: str, directory: Optional[str]) -> str:
    return os.path.join(directory or DEFAULT_DIR, _key(media_path))


def save(media_path: str, position: float, props: Dict[str, object],
         directory: Optional[str] = None) -> str:
    path = _path(media_path, directory)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lines = [f"# {media_path}", f"# saved {time.strftime('%F %T')}",
             f"start={position:.6f}"]
    for k in SAVED_PROPS:
        if k in props:
            lines.append(f"{k}={props[k]}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def load(media_path: str, directory: Optional[str] = None) -> Optional[dict]:
    path = _path(media_path, directory)
    if not os.path.exists(path):
        return None
    out: Dict[str, object] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            try:
                out[k] = int(v) if v.lstrip("-").isdigit() else float(v)
            except ValueError:
                out[k] = v
    return out


def forget(media_path: str, directory: Optional[str] = None):
    try:
        os.unlink(_path(media_path, directory))
    except FileNotFoundError:
        pass


def apply_to_player(player, state: dict):
    """Reapply a loaded checkpoint to a Player (api.Player); a key the
    player refuses (unknown, read-only or out of range) is skipped, as in
    the original."""
    for k, v in state.items():
        if k == "start":
            continue
        try:
            player.set_property(k, v)
        except (KeyError, ValueError, TypeError) as e:
            log.debug("watch-later key %r=%r skipped: %s", k, v, e)
    return float(state.get("start", 0.0))
