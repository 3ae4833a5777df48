"""Key cache: partition-key -> partition location, shared by readers.

Reference counterpart: cache/KeyCacheKey.java + the key cache in
CacheService.java:108 — avoids the partition-index walk on repeat point
reads. Matters most for summary-mode sstables (large partition
directories kept downsampled in memory, storage/sstable/reader.py):
a hit skips the on-disk directory bracket scan entirely.

Entries key on (directory, generation, pk) — generation-scoped like the
chunk cache, so stale entries can never serve a new sstable. Persisted
across restarts by storage/saved_caches.py (AutoSavingCache role).
"""
from __future__ import annotations

import threading
from ..utils import lockwitness
from collections import OrderedDict


class KeyCache:
    def __init__(self, capacity: int = 100_000):
        self.capacity = capacity
        self._lru: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._lock = lockwitness.make_lock("storage.key_cache")
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple):
        with self._lock:
            v = self._lru.get(key)
            if v is None:
                self.misses += 1
                return None
            self._lru.move_to_end(key)
            self.hits += 1
            return v

    def put(self, key: tuple, value: tuple) -> None:
        with self._lock:
            self._lru[key] = value
            self._lru.move_to_end(key)
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)

    # rough per-entry footprint: the (directory, generation, pk) key
    # strings/ints plus the location tuple. The byte-denominated
    # `key_cache_size` knob maps onto entry capacity through this.
    APPROX_ENTRY_BYTES = 512

    def set_capacity_bytes(self, nbytes) -> None:
        """Hot-resize from the `key_cache_size` knob (bytes); shrinking
        evicts LRU-first immediately. 0 DISABLES the cache (the repo's
        cache-size knob convention: puts evict instantly, every get
        misses); positive sizes floor at 1024 entries."""
        with self._lock:
            self.capacity = 0 if int(nbytes) <= 0 else max(
                1024, int(nbytes) // self.APPROX_ENTRY_BYTES)
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()

    def invalidate_generation(self, directory: str, generation: int):
        """Drop a dead sstable's entries eagerly (truncate path — the
        generation number can be REUSED by a store recreated over the
        same directory)."""
        with self._lock:
            dead = [k for k in self._lru
                    if k[0] == directory and k[1] == generation]
            for k in dead:
                del self._lru[k]

    def keys(self) -> list[tuple]:
        with self._lock:
            return list(self._lru)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._lru), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses}


GLOBAL = KeyCache()
