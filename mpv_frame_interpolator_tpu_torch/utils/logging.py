"""Hierarchical component logging (the port's copy of the JAX package's
``utils/logging.py``).

Every component logs under 'mfi.<component>' so verbosity is controllable
per subtree, and a STATS level below DEBUG mirrors the reference's
MSGL_STATS."""

from __future__ import annotations

import logging

STATS = 5  # below DEBUG, like MSGL_STATS (common/msg.h:49)
logging.addLevelName(STATS, "STATS")

_ROOT = "mfi"
_configured = False


def get_logger(component: str) -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(name)s] %(levelname)s: %(message)s"))
        root = logging.getLogger(_ROOT)
        if not root.handlers:
            root.addHandler(handler)
        root.setLevel(logging.INFO)
        _configured = True
    return logging.getLogger(f"{_ROOT}.{component}")


def set_verbosity(level: int, component: str = ""):
    name = f"{_ROOT}.{component}" if component else _ROOT
    logging.getLogger(name).setLevel(level)
