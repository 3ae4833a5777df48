"""Chunk cache: decoded-segment LRU shared by every reader.

Reference counterpart: cache/ChunkCache.java:46 (the off-heap cache in
front of chunk decompression). Here the cached unit is a DECODED segment
CellBatch — caching after decompression+decode saves both the pread and
the codec pass, which profiling showed dominate point-read latency.

Entries key on (sstable path, generation, segment). Cached batches are
treated as immutable by every consumer (merge paths concat/permute into
fresh arrays before any mutation); `flags.setflags(write=False)` guards
the contract in debug use.

Capacity is bytes-bounded with LRU eviction; a table-dropping truncate or
compaction leaves stale entries that simply age out (keys are
generation-scoped so they can never be served for new data).
"""
from __future__ import annotations

import threading
from collections import OrderedDict

DEFAULT_CAPACITY = 128 << 20    # 128 MiB, cassandra.yaml file_cache_size


class ChunkCache:
    def __init__(self, capacity_bytes: int = DEFAULT_CAPACITY):
        self.capacity = capacity_bytes
        self._lru: OrderedDict = OrderedDict()
        self._sizes: dict = {}
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _size_of(batch) -> int:
        return int(batch.lanes.nbytes + batch.ts.nbytes + batch.ldt.nbytes
                   + batch.ttl.nbytes + batch.flags.nbytes
                   + batch.off.nbytes + batch.val_start.nbytes
                   + batch.payload.nbytes)

    def get(self, key):
        with self._lock:
            batch = self._lru.get(key)
            if batch is None:
                self.misses += 1
                return None
            self._lru.move_to_end(key)
            self.hits += 1
            return batch

    def put(self, key, batch) -> None:
        size = self._size_of(batch)
        if size > self.capacity:
            return
        with self._lock:
            if key in self._lru:
                # replace: an existing entry may be getting swapped for
                # a repaired copy (reader ck_comp fix-up) — the atomic
                # reference swap is safe for concurrent readers holding
                # the old object
                self._bytes -= self._sizes[key]
            self._lru[key] = batch
            self._lru.move_to_end(key)
            self._sizes[key] = size
            self._bytes += size
            while self._bytes > self.capacity and self._lru:
                k, _ = self._lru.popitem(last=False)
                self._bytes -= self._sizes.pop(k)

    def invalidate_generation(self, directory: str, generation: int):
        """Drop a dead sstable's entries eagerly (truncate path)."""
        with self._lock:
            dead = [k for k in self._lru
                    if k[0] == directory and k[1] == generation]
            for k in dead:
                del self._lru[k]
                self._bytes -= self._sizes.pop(k)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._lru), "bytes": self._bytes,
                    "capacity": self.capacity, "hits": self.hits,
                    "misses": self.misses}

    def clear(self) -> None:
        """nodetool invalidatechunkcache."""
        with self._lock:
            self._lru.clear()
            self._sizes.clear()
            self._bytes = 0


GLOBAL = ChunkCache()
