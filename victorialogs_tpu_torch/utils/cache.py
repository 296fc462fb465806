"""Two-generation rotating cache (reference lib/logstorage/cache.go:13-58).

Entries live in the current generation; a hit in the previous generation
promotes the entry forward.  Rotation every ~3 minutes (jittered) bounds
both staleness and memory without tracking per-entry ages; a cache idle
for a whole extra period is cleared.  Thread-safe.  The JAX package's
victorialogs_tpu/utils/cache.py, copied.
"""

from __future__ import annotations

import random
import threading
import time

ROTATE_SECONDS = 3 * 60


class TwoGenCache:
    def __init__(self, rotate_seconds: float = ROTATE_SECONDS):
        self._lock = threading.Lock()
        self._curr: dict = {}
        self._prev: dict = {}
        self._rotate_every = rotate_seconds
        self._next_rotate = time.monotonic() + \
            rotate_seconds * (0.9 + 0.2 * random.random())
        self.hits = 0
        self.misses = 0

    def _maybe_rotate_locked(self) -> None:
        now = time.monotonic()
        if now >= self._next_rotate:
            if now - self._next_rotate >= self._rotate_every:
                # idle past a full extra period: everything is stale
                self._prev = {}
                self._curr = {}
            else:
                self._prev = self._curr
                self._curr = {}
            self._next_rotate = now + self._rotate_every * \
                (0.9 + 0.2 * random.random())

    def get(self, key):
        with self._lock:
            self._maybe_rotate_locked()
            v = self._curr.get(key)
            if v is not None:
                self.hits += 1
                return v
            v = self._prev.get(key)
            if v is not None:
                # promote-on-hit from the previous generation
                self._curr[key] = v
                self.hits += 1
                return v
            self.misses += 1
            return None

    def put(self, key, value) -> None:
        with self._lock:
            self._maybe_rotate_locked()
            self._curr[key] = value

    def clear(self) -> None:
        with self._lock:
            self._curr = {}
            self._prev = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._curr) + len(self._prev)
