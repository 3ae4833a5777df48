"""Memtable: append-only columnar write buffer, sharded by token range.

Reference counterpart: db/memtable/Memtable.java:55 (pluggable interface;
put:193, getFlushSet:299) and TrieMemtable (whose core trick is the same
one used here: MEMTABLE SHARDS — TrieMemtable partitions its write state
into token-range shards so concurrent writers contend on a shard lock,
not a global one). The reference maintains a sorted structure per write;
the TPU-native design appends O(1) to columnar arrays and defers ALL
ordering to the batch sort at read/flush time — sorting is what the
device does best, and flush-time batch sort replaces per-write
comparisons entirely.

Sharding (the write fast lane, CTPU_WRITE_FASTPATH): each shard owns a
lock, a CellBatchBuilder and a per-partition hash index over a fixed
slice of the biased-token space, so N writers on different shards never
serialize. A partition's cells always land in exactly one shard (shard =
top bits of the biased token), and shard index order IS identity-lane
order — per-shard sorted batches concatenate into a globally sorted
batch, which is what the pipelined flush streams to the SSTableWriter
shard by shard. `apply_batch` takes each shard lock once per batch
instead of once per mutation. With the fast lane off the memtable
degrades to one shard — the exact serial structure it had before.
"""
from __future__ import annotations

import os
import threading

from ..schema import TableMetadata
from .cellbatch import (CellBatch, CellBatchBuilder, lanes_for_table,
                        merge_sorted, pk_lane_key)
from .commitlog import write_fastpath_enabled
from .mutation import Mutation

_BIAS = 1 << 63


def default_shard_count() -> int:
    """Shards for a new memtable: CTPU_MEMTABLE_SHARDS, else 8 with the
    write fast lane on, else 1 (serial reference behavior)."""
    env = os.environ.get("CTPU_MEMTABLE_SHARDS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return 8 if write_fastpath_enabled() else 1


class _Shard:
    """One token-range slice of the write state. All fields are guarded
    by `lock`; `version` increments per applied mutation so scan() can
    cache the shard's sorted view until it changes."""

    __slots__ = ("lock", "builder", "partitions", "live_bytes", "ops",
                 "version", "sorted_cache", "sorted_version")

    def __init__(self, table: TableMetadata):
        self.lock = threading.RLock()
        self.builder = CellBatchBuilder(table)
        self.partitions: dict[bytes, list[int]] = {}
        self.live_bytes = 0
        self.ops = 0
        self.version = 0
        self.sorted_cache: CellBatch | None = None
        self.sorted_version = -1


class Memtable:
    def __init__(self, table: TableMetadata, shards: int | None = None):
        self.table = table
        n = shards if shards is not None else default_shard_count()
        # power of two so shard selection is a shift of the biased token
        bits = 0
        while (1 << bits) < n:
            bits += 1
        self._shard_bits = bits
        self._shards = [_Shard(table) for _ in range(1 << bits)]
        self._scan_lock = threading.Lock()
        self._sorted_cache: CellBatch | None = None
        self._sorted_versions: tuple | None = None

    @property
    def shard_count(self) -> int:
        return len(self._shards)

    def _shard_index(self, pk: bytes) -> int:
        if not self._shard_bits:
            return 0
        from ..utils import partitioners
        biased = partitioners.token_of(pk) + _BIAS
        return biased >> (64 - self._shard_bits)

    def _shard_of(self, pk: bytes) -> _Shard:
        return self._shards[self._shard_index(pk)]

    def __len__(self):
        return sum(len(sh.builder) for sh in self._shards)

    @property
    def is_empty(self) -> bool:
        return all(len(sh.builder) == 0 for sh in self._shards)

    @property
    def live_bytes(self) -> int:
        return sum(sh.live_bytes for sh in self._shards)

    @property
    def ops(self) -> int:
        return sum(sh.ops for sh in self._shards)

    def partition_count(self) -> int:
        """Distinct partitions buffered (SSTableWriter bloom sizing)."""
        return sum(len(sh.partitions) for sh in self._shards)

    # ------------------------------------------------------------- write --

    @staticmethod
    def _apply_locked(sh: _Shard, mutation: Mutation) -> None:
        start = len(sh.builder)
        mutation.apply_to(sh.builder)
        end = len(sh.builder)
        if end == start:
            return
        lane4 = sh.builder._lanes[start][:4]
        key16 = b"".join(int(x).to_bytes(4, "big") for x in lane4)
        sh.partitions.setdefault(key16, []).extend(range(start, end))
        # note: all ops of one mutation share the partition (one pk)
        sh.live_bytes += mutation.size
        sh.ops += len(mutation.ops)
        sh.version += 1

    def apply(self, mutation: Mutation) -> None:
        sh = self._shard_of(mutation.pk)
        with sh.lock:
            self._apply_locked(sh, mutation)

    def apply_batch(self, mutations: list[Mutation]) -> None:
        """Apply a batch taking each involved shard lock ONCE — the
        memtable half of the batched write fast lane (coordinator /
        messaging / replay batches)."""
        by_shard: dict[int, list[Mutation]] = {}
        for m in mutations:
            by_shard.setdefault(self._shard_index(m.pk), []).append(m)
        # ascending shard order: a fixed acquisition order can never
        # deadlock against another batch (locks are taken one at a time
        # anyway; the order just keeps lock traffic predictable)
        for idx in sorted(by_shard):
            sh = self._shards[idx]
            with sh.lock:
                for m in by_shard[idx]:
                    self._apply_locked(sh, m)

    @staticmethod
    def _copy_rows(b: CellBatchBuilder, idxs, d: CellBatchBuilder) -> int:
        """Append rows `idxs` of builder `b` into builder `d` (the same
        row-copy _subset performs, but landing in another builder).
        Returns the payload bytes copied. Caller holds both shard
        locks."""
        copied = 0
        for i in idxs:
            frame = bytes(b._payload[b._value_off[i]:b._value_off[i + 1]])
            d._lanes.append(b._lanes[i])
            d._ts.append(b._ts[i])
            d._ldt.append(b._ldt[i])
            d._ttl.append(b._ttl[i])
            d._flags.append(b._flags[i])
            d._val_start.append(len(d._payload)
                                + (b._val_start[i] - b._value_off[i]))
            d._payload += frame
            d._value_off.append(len(d._payload))
            copied += len(frame)
        return copied

    def absorb(self, other: "Memtable") -> None:
        """Fold another memtable's buffered cells into this one — the
        flush FAILURE path: when the sstable write dies (EIO), the
        switched-out memtable is reinstated as active and the
        replacement's writes (applied while the doomed flush ran) are
        absorbed back so nothing acked is lost. Reconciliation is
        timestamp-based, so append order does not change read results.
        Caller must have quiesced writers on BOTH memtables (the
        ColumnFamilyStore holds its write barrier exclusively)."""
        for sh in other._shards:
            with sh.lock:
                b = sh.builder
                if not len(b):
                    continue
                for key16, idxs in sh.partitions.items():
                    pk = b.pk_map[key16]
                    dst = self._shard_of(pk)
                    with dst.lock:
                        d = dst.builder
                        start = len(d)
                        nbytes = self._copy_rows(b, idxs, d)
                        d._ck_fits = d._ck_fits and b._ck_fits
                        d.pk_map[key16] = pk
                        dst.partitions.setdefault(key16, []).extend(
                            range(start, len(d)))
                        dst.live_bytes += nbytes
                        dst.ops += len(idxs)
                        dst.version += 1

    # -------------------------------------------------------------- read --

    @staticmethod
    def _subset(sh: _Shard, indices: list[int]) -> CellBatch:
        b = sh.builder
        sub = CellBatchBuilder(b.table)
        for i in indices:
            lanes = b._lanes[i]
            frame = bytes(b._payload[b._value_off[i]:b._value_off[i + 1]])
            sub._lanes.append(lanes)
            sub._ts.append(b._ts[i])
            sub._ldt.append(b._ldt[i])
            sub._ttl.append(b._ttl[i])
            sub._flags.append(b._flags[i])
            sub._val_start.append(len(sub._payload)
                                  + (b._val_start[i] - b._value_off[i]))
            sub._payload += frame
            sub._value_off.append(len(sub._payload))
        sub.pk_map = b.pk_map
        return sub.seal()

    def contains(self, pk: bytes) -> bool:
        """O(1) partition-presence check (compaction purge guard)."""
        sh = self._shard_of(pk)
        with sh.lock:
            return pk_lane_key(pk) in sh.partitions

    def read_partition(self, pk: bytes) -> CellBatch | None:
        """The partition's cells, reconciled (newest versions only) —
        only the owning shard's lock is touched."""
        key16 = pk_lane_key(pk)
        sh = self._shard_of(pk)
        with sh.lock:
            idx = sh.partitions.get(key16)
            if not idx:
                return None
            return merge_sorted([self._subset(sh, idx)])

    def _shard_sorted(self, sh: _Shard) -> CellBatch:
        """Shard's sorted+reconciled view, cached until its next write.
        Caller holds sh.lock."""
        if sh.sorted_version != sh.version:
            sh.sorted_cache = merge_sorted([sh.builder.seal()])
            sh.sorted_version = sh.version
        return sh.sorted_cache

    def scan(self) -> CellBatch:
        """Whole memtable, sorted + reconciled (cached until next write).
        Shards cover disjoint ascending token ranges, so per-shard
        sorted views CONCATENATE into the global sorted order — no
        re-sort, and reconcile is partition-local so per-shard
        reconcile == global reconcile bit-for-bit."""
        with self._scan_lock:
            parts: list[CellBatch] = []
            versions = []
            for sh in self._shards:
                with sh.lock:
                    versions.append(sh.version)
                    parts.append(self._shard_sorted(sh))
            vt = tuple(versions)
            if self._sorted_cache is not None \
                    and self._sorted_versions == vt:
                return self._sorted_cache
            nonempty = [p for p in parts if len(p)]
            if not nonempty:
                out = CellBatch.empty(lanes_for_table(self.table))
                out.ck_comp = self.table.clustering_comp
            elif len(nonempty) == 1:
                out = nonempty[0]
            else:
                out = CellBatch.concat(nonempty)
                out.sorted = True
            self._sorted_cache = out
            self._sorted_versions = vt
            return out

    def scan_window(self, lo: int, hi: int) -> CellBatch:
        """Cells of partitions with token in (lo, hi] (paging windows)."""
        from .cellbatch import filter_token_range
        return filter_token_range(self.scan(), lo + 1 if lo > -(1 << 63)
                                  else lo, hi)

    # ------------------------------------------------------------- flush --

    def flush_batch(self) -> CellBatch:
        """Sorted, deduplicated cells for the flush writer
        (Memtable.getFlushSet / Flushing.writeSortedContents role)."""
        return self.scan()

    def flush_shards(self):
        """Yield per-shard sorted runs in ascending token order — the
        drain stage of the pipelined flush. LAZY on purpose: the flush
        pipeline runs this generator on a drain thread, so shard k+1's
        sort overlaps shard k's compress (native, GIL-released) and
        shard k-1's disk write (the writer's I/O thread). Call only on
        a RETIRED memtable (after the switch; no concurrent writes)."""
        for sh in self._shards:
            with sh.lock:
                if len(sh.builder):
                    yield self._shard_sorted(sh)
