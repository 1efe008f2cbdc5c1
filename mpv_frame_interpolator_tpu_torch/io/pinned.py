"""A pool of page-locked host frame buffers (the port's counterpart of the
JAX package's ``native.FramePool``, the reference's mp_image_pool).

A reader fills a frame's planes in buffers from the pool and hands them
back (``give_back``) once the engine's copy of them to the card has
completed, so steady-state reading allocates nothing.  On a card the
buffers are page-locked (``torch.empty(..., pin_memory=True)``), so the
engine's uploads from them are DMA copies that do not block the thread
that enqueues them; each is seen through ``.numpy()`` as an ordinary numpy
array.  Where the caller runs on the CPU there is no card to pin memory
for, and the pool hands out ordinary buffers.

A buffer that is never given back is freed with its last array: it costs
an allocation, never a corrupted frame.
"""

from __future__ import annotations

import threading
import weakref
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch


def _root(arr: np.ndarray) -> np.ndarray:
    while isinstance(arr.base, np.ndarray):
        arr = arr.base
    return arr


class PinnedPool:
    """Recycling pool of host buffers, page-locked when the caller runs on
    a card.

    `device`: where the frames go.  "cuda..." pins (and raises if there is
    no card); "cpu" does not; None pins when a card is present.  At most
    `max_entries` free buffers are kept; a buffer given back beyond that
    is freed.  A buffer lent out is kept alive by its arrays alone (the
    array's base is the tensor), so one never given back is freed with
    them (a page-locked one into PyTorch's own host cache)."""

    def __init__(self, max_entries: int = 8, device=None):
        if device is None:
            self.pinned = torch.cuda.is_available()
        else:
            self.pinned = torch.device(device).type == "cuda"
        self.max_entries = max_entries
        self._free: Dict[int, List[torch.Tensor]] = defaultdict(list)
        # the tensor behind every buffer lent out, by its address
        self._lent = weakref.WeakValueDictionary()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, shape, dtype) -> np.ndarray:
        """A buffer of `shape` and `dtype`, contents undefined."""
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        with self._lock:
            free = self._free[nbytes]
            buf: Optional[torch.Tensor] = free.pop() if free else None
            if buf is None:
                self.misses += 1
            else:
                self.hits += 1
        if buf is None:
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              pin_memory=self.pinned)
        arr = buf.numpy()
        # the tensor that keeps the array's memory alive (not `buf` itself)
        holder = arr.base
        with self._lock:
            self._lent[holder.data_ptr()] = holder
        return arr.view(dtype).reshape(shape)

    def give_back(self, arr: np.ndarray):
        """Return a buffer from ``get`` (or any view of it) to the pool.
        The caller must not touch its planes afterwards."""
        addr = _root(arr).__array_interface__["data"][0]
        with self._lock:
            buf = self._lent.pop(addr, None)
            if buf is None:
                return
            if sum(map(len, self._free.values())) < self.max_entries:
                self._free[buf.numel()].append(buf)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "free": sum(map(len, self._free.values())),
                    "lent": len(self._lent), "pinned": self.pinned}
