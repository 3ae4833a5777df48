"""Row cache: merged-partition LRU shared by every table store.

Reference counterpart: cache/RowCacheKey.java + the row cache in
CacheService.java:160 — caches the MERGED partition at the replica so a
repeat point read skips the memtable+sstable collation entirely.

One process-global byte-bounded LRU (`RowCacheService`) holds every
table's entries keyed by `(store key, partition key)`; each
ColumnFamilyStore talks to it through a thin per-table `RowCache`
handle. The store key is the table's data directory — unique per store,
so in-process multi-node clusters can never serve each other's
partitions. Capacity comes from `row_cache_size_mib` (falling back to
`row_cache_size`, then a built-in default — see resolve_capacity);
tables opt in via `WITH caching = {'rows_per_partition': 'ALL'}`.

Invalidation (the tentpole read-fastpath contract): a write to the key
drops the entry and bumps the table's generation; flush and any
sstable-set change (compaction, scrub, cleanup, bulk load) clear the
whole table's entries — a cached merge must never outlive the sstable
generation it was computed from, so the fastpath's timestamp-skip
collation and the cache can be A/B'd against the naive path
bit-for-bit. Partitions holding TTL cells are never cached: their
liveness depends on the read clock.

The generation counter doubles as the put-race sentinel (the reference
row cache's sentinel protocol): a reader captures it BEFORE
snapshotting its sources and put() refuses the entry if it moved —
otherwise a read racing a write could re-cache its pre-write merge
AFTER the writer's invalidate and serve stale data forever.

Keys (never values) are persisted across restarts by
storage/saved_caches.py (AutoSavingCache role) alongside the key cache.
"""
from __future__ import annotations

import threading
from ..utils import lockwitness
from collections import OrderedDict

DEFAULT_CAPACITY = 64 << 20     # bytes; used until config wires a size


def resolve_capacity(settings) -> int:
    """Capacity in bytes under the documented precedence: an explicit
    `row_cache_size_mib` (>= 0; 0 disables) wins, else a non-zero legacy
    `row_cache_size` (bytes), else the built-in default."""
    mib = settings.get("row_cache_size_mib")
    if mib >= 0:
        return int(mib) << 20
    legacy = settings.get("row_cache_size")
    if legacy > 0:
        return int(legacy)
    return DEFAULT_CAPACITY


def _size_of(batch) -> int:
    return int(batch.lanes.nbytes + batch.ts.nbytes + batch.ldt.nbytes
               + batch.ttl.nbytes + batch.flags.nbytes + batch.off.nbytes
               + batch.val_start.nbytes + batch.payload.nbytes)


class RowCacheService:
    """The shared LRU. All mutation happens under one lock; per-table
    views (keys/len/clear) filter by store key."""

    def __init__(self, capacity_bytes: int = DEFAULT_CAPACITY):
        self.capacity = capacity_bytes
        self._lru: "OrderedDict[tuple, object]" = OrderedDict()
        self._sizes: dict = {}
        self._counts: dict = {}       # store key -> live entry count
        self._gens: dict = {}         # store key -> generation
        self._bytes = 0
        self._lock = lockwitness.make_lock("storage.row_cache")
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ------------------------------------------------------------- lookup

    def generation(self, tkey) -> int:
        with self._lock:
            return self._gens.get(tkey, 0)

    def get(self, tkey, pk: bytes):
        with self._lock:
            batch = self._lru.get((tkey, pk))
            if batch is None:
                self.misses += 1
                return None
            self._lru.move_to_end((tkey, pk))
            self.hits += 1
            return batch

    def put(self, tkey, pk: bytes, batch, read_generation: int,
            table_capacity: int | None = None) -> None:
        from .cellbatch import FLAG_EXPIRING
        if len(batch) and (batch.flags & FLAG_EXPIRING).any():
            return    # liveness depends on the read clock: never cache
        size = _size_of(batch)
        if size > self.capacity:
            return
        with self._lock:
            if self._gens.get(tkey, 0) != read_generation:
                return    # an invalidation raced this read: don't cache
            key = (tkey, pk)
            if key not in self._lru:
                self._counts[tkey] = self._counts.get(tkey, 0) + 1
            else:
                self._bytes -= self._sizes[key]
            self._lru[key] = batch
            self._sizes[key] = size
            self._bytes += size
            self._lru.move_to_end(key)
            while self._bytes > self.capacity and self._lru:
                self._evict_oldest_locked()
            if table_capacity is not None:
                while self._counts.get(tkey, 0) > table_capacity:
                    self._evict_oldest_of_locked(tkey)

    def _evict_oldest_locked(self) -> None:
        k, _ = self._lru.popitem(last=False)
        self._bytes -= self._sizes.pop(k)
        self._counts[k[0]] -= 1
        self.evictions += 1

    def _evict_oldest_of_locked(self, tkey) -> None:
        for k in self._lru:
            if k[0] == tkey:
                del self._lru[k]
                self._bytes -= self._sizes.pop(k)
                self._counts[tkey] -= 1
                self.evictions += 1
                return

    # -------------------------------------------------------- invalidate

    def invalidate(self, tkey, pk: bytes) -> None:
        with self._lock:
            self._gens[tkey] = self._gens.get(tkey, 0) + 1
            if self._lru.pop((tkey, pk), None) is not None:
                self._bytes -= self._sizes.pop((tkey, pk))
                self._counts[tkey] -= 1

    def clear_table(self, tkey) -> None:
        with self._lock:
            self._gens[tkey] = self._gens.get(tkey, 0) + 1
            dead = [k for k in self._lru if k[0] == tkey]
            for k in dead:
                del self._lru[k]
                self._bytes -= self._sizes.pop(k)
            self._counts[tkey] = 0

    def clear(self) -> None:
        """nodetool invalidaterowcache."""
        with self._lock:
            for tkey in self._gens:
                self._gens[tkey] += 1
            self._lru.clear()
            self._sizes.clear()
            self._counts.clear()
            self._bytes = 0

    # -------------------------------------------------------------- misc

    def set_capacity(self, capacity_bytes: int) -> None:
        with self._lock:
            self.capacity = int(capacity_bytes)
            while self._bytes > self.capacity and self._lru:
                self._evict_oldest_locked()

    def table_len(self, tkey) -> int:
        with self._lock:
            return self._counts.get(tkey, 0)

    def table_keys(self, tkey) -> list[bytes]:
        """LRU-ordered pks (oldest first) — AutoSavingCache snapshot."""
        with self._lock:
            return [k[1] for k in self._lru if k[0] == tkey]

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._lru), "bytes": self._bytes,
                    "capacity": self.capacity, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}


GLOBAL = RowCacheService()


class RowCache:
    """Per-table handle over the shared service (the surface the store,
    nodetool and saved_caches talk to). Counts its own hits/misses so
    per-table ratios survive alongside the service totals."""

    def __init__(self, tkey, capacity: int = 1024,
                 service: RowCacheService | None = None):
        self.tkey = tkey
        self.capacity = capacity          # per-table entry bound
        self.service = service or GLOBAL
        self.hits = 0
        self.misses = 0

    @property
    def generation(self) -> int:
        return self.service.generation(self.tkey)

    def __len__(self) -> int:
        return self.service.table_len(self.tkey)

    def keys(self) -> list[bytes]:
        return self.service.table_keys(self.tkey)

    def get(self, pk: bytes):
        batch = self.service.get(self.tkey, pk)
        if batch is None:
            self.misses += 1
        else:
            self.hits += 1
        return batch

    def put(self, pk: bytes, batch, read_generation: int) -> None:
        self.service.put(self.tkey, pk, batch, read_generation,
                         table_capacity=self.capacity)

    def invalidate(self, pk: bytes) -> None:
        self.service.invalidate(self.tkey, pk)

    def clear(self) -> None:
        self.service.clear_table(self.tkey)
