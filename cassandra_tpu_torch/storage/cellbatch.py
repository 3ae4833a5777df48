"""CellBatch — the columnar cell representation the whole data plane runs on.

This replaces the reference's pull-based row iterators (db/rows/*,
utils/MergeIterator.java) with sorted fixed-width arrays: a batch of N cells
is K uint32 *identity lanes* plus metadata lanes plus a variable-length
payload blob. Lexicographic order over the identity lanes equals storage
order, so k-way merge + reconcile becomes: concatenate runs -> stable sort
-> segmented scans -> boolean keep mask. That formulation runs unchanged on
numpy (host reference implementation, this module) and on TPU via
jax.lax.sort + masks (ops/merge.py).

Identity lanes (uint32, big-endian packing), K = 9 + C:
  0  token_hi      biased partition token (token + 2^63)
  1  token_lo
  2  pkh_hi        murmur3 h2 of the partition key (disambiguates token
  3  pkh_lo        collisions; full pk bytes kept per partition)
  4..4+C-1        clustering prefix: first 4*C bytes of the byte-comparable
                   clustering composite (C = table clustering_prefix_bytes/4)
  4+C  ckh_hi      murmur3 h1 of the FULL clustering composite — exactness
  5+C  ckh_lo      guard when the prefix truncates
  6+C  column      sentinels: 0 partition-deletion, 1 row-deletion,
                   2 row-liveness; real columns from 8 (schema.py)
  7+C  path_prefix first 4 bytes of the multicell path (collections)
  8+C  path_hash   murmur3 h1 low 32 of the path

Merge tie-break lanes (computed at sort time, not identity):
  ~ts (descending), then the Cells.resolveRegular equal-ts ranking
  (reference db/rows/Cells.java:79, CASSANDRA-14592): expiring-or-tombstone
  beats live, pure tombstone beats expiring, larger localDeletionTime,
  larger value bytes (~value-prefix lane + exact host fix-up).

Reconcile semantics mirrored from the reference:
  - newest timestamp wins per cell (Cells.reconcile)
  - deletions shadow anything with ts <= deletion ts
    (DeletionTime.deletes, db/DeletionTime.java)
  - expired TTL cells become tombstones (AbstractCell.purge path)
  - tombstones older than gcBefore whose ts is below the partition's
    max-purgeable timestamp are dropped (CompactionIterator.Purger /
    PurgeFunction, db/partitions/PurgeFunction.java)
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..schema import (COL_PARTITION_DEL, COL_REGULAR_BASE, COL_ROW_DEL,
                      COL_ROW_LIVENESS, TableMetadata)
from ..utils import murmur3
from ..utils.timeutil import (NO_DELETION_TIME, NO_TIMESTAMP,
                              expiration_time as timeutil_expiration)
from ..utils import varint as vi

# flags
FLAG_TOMBSTONE = 1       # cell-level deletion
FLAG_EXPIRING = 2        # has TTL
FLAG_PARTITION_DEL = 4
FLAG_ROW_DEL = 8
FLAG_ROW_LIVENESS = 16
FLAG_COMPLEX_DEL = 32    # whole-collection deletion (column-scoped,
                         # path-less; shadows older path cells — reference
                         # ComplexColumnData complex deletion semantics)
FLAG_RANGE_BOUND = 64    # reserved: range tombstone bound
FLAG_COUNTER = 128       # counter delta cell: reconcile SUMS live versions
                         # instead of newest-wins (db/context/CounterContext
                         # commutative merge, simplified to delta shards)

DEATH_FLAGS = (FLAG_TOMBSTONE | FLAG_PARTITION_DEL | FLAG_ROW_DEL
               | FLAG_COMPLEX_DEL)

_BIAS = 1 << 63
_U32 = 0xFFFFFFFF


def _native_gather(payload: np.ndarray, off: np.ndarray, perm: np.ndarray,
                   new_off: np.ndarray) -> np.ndarray | None:
    """C++ ragged gather (ops/native/codec.cpp gather_frames); None if the
    native lib is unavailable (caller falls back to numpy)."""
    try:
        import ctypes

        from ..ops.native import build as native_build
        lib = native_build.load()
    except Exception:
        return None
    out = np.empty(int(new_off[-1]), dtype=np.uint8)
    payload = np.ascontiguousarray(payload)
    off = np.ascontiguousarray(off, dtype=np.int64)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    new_off = np.ascontiguousarray(new_off, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    r = lib.gather_frames(
        payload.ctypes.data_as(u8p), off.ctypes.data_as(i64p),
        perm.ctypes.data_as(i64p), len(perm),
        new_off.ctypes.data_as(i64p), out.ctypes.data_as(u8p))
    if r != 0:
        return None
    return out


def batch_tokens(batch: "CellBatch") -> np.ndarray:
    """int64 partition tokens per cell (shared token idiom)."""
    with np.errstate(over="ignore"):
        u = (batch.lanes[:, 0].astype(np.uint64) << np.uint64(32)) \
            | batch.lanes[:, 1].astype(np.uint64)
        return (u ^ np.uint64(_BIAS)).astype(np.int64)


def token_range_mask(toks: np.ndarray, ranges) -> np.ndarray:
    """Boolean mask of tokens inside any ring range (lo, hi]. A range
    starting at MIN_TOKEN means 'from the ring start' and is inclusive
    of hi — callers split wrap-around arcs at the ring edge before
    passing them (cleanup and anticompaction share this exact
    boundary semantics; keep them agreeing HERE, not in two copies)."""
    MIN = -(1 << 63)
    mask = np.zeros(len(toks), dtype=bool)
    for lo, hi in ranges:
        if lo == MIN:
            mask |= toks <= hi
        else:
            mask |= (toks > lo) & (toks <= hi)
    return mask


def filter_token_range(batch: "CellBatch", lo: int, hi: int) -> "CellBatch":
    """Cells whose partition token falls in [lo, hi] (sorted input -> the
    result is a contiguous slice)."""
    toks = batch_tokens(batch)
    i0 = int(np.searchsorted(toks, lo, side="left"))
    i1 = int(np.searchsorted(toks, hi, side="right"))
    return batch.slice_range(i0, i1)


def content_digest(batch: "CellBatch") -> bytes:
    """Content digest over every reconcile-significant lane — the ONE
    definition shared by digest reads (DigestResolver role) and merkle
    repair. ldt/ttl are included: replicas can diverge in expiry alone
    (CASSANDRA-14592 makes ldt a reconcile dimension), and a digest blind
    to them would never trigger the repair that fixes it."""
    import hashlib
    h = hashlib.md5()
    h.update(batch.lanes.astype("<u4").tobytes())
    h.update(batch.ts.astype("<i8").tobytes())
    h.update(batch.ldt.astype("<i4").tobytes())
    h.update(batch.ttl.astype("<i4").tobytes())
    h.update(batch.flags.tobytes())
    # cell boundaries too: identical concatenated bytes split into
    # different cells must not collide
    h.update(batch.off.astype("<i8").tobytes())
    h.update(batch.val_start.astype("<i8").tobytes())
    h.update(batch.payload.tobytes())
    return h.digest()


@dataclass(frozen=True)
class DataLimits:
    """Per-replica row limits shipped WITH the read command so replicas
    truncate at the source instead of the coordinator post-merge
    (db/filter/DataLimits.java:44 CQLLimits). `row_limit` bounds live
    rows across the response; `per_partition` bounds live rows within
    each partition. None = unlimited on that axis."""
    row_limit: int | None = None
    per_partition: int | None = None

    def target(self) -> int | None:
        """The merged-result live-row count that satisfies this limit
        for a single partition (short-read stop condition)."""
        vals = [v for v in (self.row_limit, self.per_partition)
                if v is not None]
        return min(vals) if vals else None

    def doubled(self) -> "DataLimits":
        """Short-read protection growth step: each re-query fetches
        geometrically more so convergence needs O(log n) rounds
        (ShortReadRowsProtection multiplies its fetch size too)."""
        return DataLimits(
            None if self.row_limit is None else self.row_limit * 2,
            None if self.per_partition is None
            else self.per_partition * 2)

    def to_wire(self) -> tuple:
        return (self.row_limit, self.per_partition)

    @staticmethod
    def from_wire(t) -> "DataLimits | None":
        return None if t is None else DataLimits(t[0], t[1])


def live_row_count(batch: "CellBatch") -> int:
    """Number of LIVE rows (>= 1 non-death cell) in a sorted+reconciled
    batch — the unit DataLimits counts."""
    if len(batch) == 0:
        return 0
    _, row_new, _ = batch.boundaries()
    row_id = np.cumsum(row_new) - 1
    live_cell = (batch.flags & DEATH_FLAGS) == 0
    if not live_cell.any():
        return 0
    return len(np.unique(row_id[live_cell]))


def row_frontier(batch: "CellBatch") -> bytes | None:
    """Identity-lane key (big-endian bytes, ordered like the sort) of
    the LAST row in a sorted batch — the position up to which a
    truncated response VOUCHES for its replica's view. Rows beyond a
    truncated replica's frontier may be shadowed by tombstones it never
    shipped, so the coordinator must not serve them from this round
    (short-read protection's per-source exhaustion check)."""
    if len(batch) == 0:
        return None
    C = batch.n_lanes - 9
    return batch.lanes[-1, :6 + C].astype(">u4").tobytes()


def covered_prefix(batch: "CellBatch", frontier: bytes) -> int:
    """Number of leading cells whose row identity is <= `frontier`
    (from row_frontier) — binary search over the sorted identity
    lanes."""
    n = len(batch)
    if n == 0:
        return 0
    C = batch.n_lanes - 9

    def key(i: int) -> bytes:
        return batch.lanes[i, :6 + C].astype(">u4").tobytes()

    lo, hi = 0, n       # first index with key > frontier
    while lo < hi:
        mid = (lo + hi) // 2
        if key(mid) <= frontier:
            lo = mid + 1
        else:
            hi = mid
    return lo


def truncate_live_rows(batch: "CellBatch",
                       limits: "DataLimits | None"
                       ) -> tuple["CellBatch", bool]:
    """DataLimits enforcement on a sorted+reconciled batch: keep cells
    up to the row_limit-th LIVE row overall and the per_partition-th
    live row within each partition; everything after is dropped, the
    way the reference's counting iterator stops consuming its source
    (db/filter/DataLimits.java:44). Dead rows (tombstone-only) BEFORE
    the cutoff ship with the response — the coordinator merge needs
    them to shadow other replicas' stale rows. Returns
    (batch, truncated): truncated=True means this replica may hold
    more rows past the cut (short-read protection input)."""
    n = len(batch)
    if n == 0 or limits is None or \
            (limits.row_limit is None and limits.per_partition is None):
        return batch, False
    part_new, row_new, _ = batch.boundaries()
    row_id = np.cumsum(row_new) - 1                     # per cell
    nrows = int(row_id[-1]) + 1
    live_cell = (batch.flags & DEATH_FLAGS) == 0
    row_live = np.zeros(nrows, dtype=bool)
    row_live[row_id[live_cell]] = True
    # global live rank: at a live row, how many live rows up to and
    # including it; at a dead row, how many live rows precede it
    glr = np.cumsum(row_live)
    keep_row = np.ones(nrows, dtype=bool)
    if limits.row_limit is not None:
        L = limits.row_limit
        keep_row &= np.where(row_live, glr <= L, glr < L)
    if limits.per_partition is not None:
        P = limits.per_partition
        first_cell_of_row = np.flatnonzero(row_new)
        row_part_new = part_new[first_cell_of_row]
        part_of_row = np.cumsum(row_part_new) - 1
        before = glr - row_live                 # live rows strictly before
        part_base = before[np.flatnonzero(row_part_new)]
        pplr = glr - part_base[part_of_row]
        keep_row &= np.where(row_live, pplr <= P, pplr < P)
    if keep_row.all():
        return batch, False
    keep_cell = keep_row[row_id]
    # a pure global limit keeps a prefix: zero-copy slice
    nkeep = int(keep_cell.sum())
    if keep_cell[:nkeep].all():
        return batch.slice_range(0, nkeep), True
    out = batch.apply_permutation(np.flatnonzero(keep_cell))
    out.sorted = True
    return out, True


def lanes_for_table(table: TableMetadata) -> int:
    return 9 + table.clustering_lanes


def pk_lanes(pk: bytes) -> tuple[int, int, int, int]:
    """The four partition lanes of a key: biased token (from the
    CLUSTER partitioner — utils/partitioners) + murmur h2 identity."""
    from ..utils import partitioners
    token = partitioners.token_of(pk)
    _, h2 = murmur3.hash128(pk)
    t = token + _BIAS
    return (t >> 32, t & _U32, h2 >> 32, h2 & _U32)


def pk_lane_key(pk: bytes) -> bytes:
    """16-byte big-endian packing of pk_lanes — the pk_map key."""
    return b"".join(int(x).to_bytes(4, "big") for x in pk_lanes(pk))


def _pack_prefix(data: bytes, nlanes: int) -> list[int]:
    """Big-endian pack of the first 4*nlanes bytes, zero-padded."""
    padded = data[: 4 * nlanes].ljust(4 * nlanes, b"\x00")
    return [int.from_bytes(padded[4 * i: 4 * i + 4], "big")
            for i in range(nlanes)]


@dataclass
class CellBatch:
    """A (possibly sorted) batch of cells for one table."""
    lanes: np.ndarray          # uint32 [N, K]
    ts: np.ndarray             # int64 [N]
    ldt: np.ndarray            # int32 [N]  local deletion / expiry seconds
    ttl: np.ndarray            # int32 [N]
    flags: np.ndarray          # uint8 [N]
    off: np.ndarray            # int64 [N+1] frame offsets into payload
    val_start: np.ndarray      # int64 [N] where the value begins in payload
    payload: np.ndarray        # uint8 blob: per cell [vint ck_len][ck]
                               #   [vint path_len][path][value...]
    pk_map: dict[bytes, bytes] = field(default_factory=dict)
    # maps the 16-byte (token,pkh) lane prefix -> full partition key bytes
    sorted: bool = False

    last_shadowed = None  # set by reconcile(); consumed by counter summing
    # serialized-ck-frame -> byte-comparable composite translator
    # (table.clustering_comp). Set by builders/readers that know the
    # table; needed only when range tombstones are reconciled.
    ck_comp = None
    # True when EVERY cell's clustering composite fits entirely in the
    # prefix lanes: the ckh hash lanes then add no ordering/equality
    # information (byte-comparable composites are prefix-free), so the
    # device merge can skip pushing 8 bytes/cell of incompressible hash.
    # Builders set it from observed composite lengths; it survives the
    # sstable round-trip via Statistics.db. False = safe default.
    ck_fits_prefix = False

    def __len__(self) -> int:
        return len(self.ts)

    @property
    def n_lanes(self) -> int:
        return self.lanes.shape[1]

    # ---------------------------------------------------------- payload ---

    def cell_payload(self, i: int) -> tuple[bytes, bytes, bytes]:
        """(clustering bytes, path bytes, value bytes) of cell i."""
        raw = self.payload[self.off[i]:self.off[i + 1]].tobytes()
        ck_len, pos = vi.read_unsigned_vint(raw, 0)
        ck = raw[pos:pos + ck_len]
        pos += ck_len
        p_len, pos = vi.read_unsigned_vint(raw, pos)
        path = raw[pos:pos + p_len]
        pos += p_len
        return ck, path, raw[pos:]

    def cell_value(self, i: int) -> bytes:
        return self.payload[self.val_start[i]:self.off[i + 1]].tobytes()

    def partition_key(self, i: int) -> bytes:
        return self.pk_map[self.lanes[i, :4].astype(">u4").tobytes()]

    # ------------------------------------------------------------- sort ---

    def sort_permutation(self) -> np.ndarray:
        """Stable sort order: identity lanes asc, then ts desc, then the
        Cells.resolveRegular equal-ts ranking (CASSANDRA-14592): expiring-
        or-tombstone beats live, pure tombstone beats expiring, larger
        localDeletionTime, larger value — clock-independent so replicas
        reconcile identically before and after expiry."""
        # np.lexsort: LAST key is the primary -> least-significant first
        keys = [_U32 - self._value_prefix_lane(),            # value desc
                np.int64(NO_DELETION_TIME) - self.ldt,       # ldt desc
                np.uint8(1) - self._pure_death_lane(),       # tombstone 1st
                np.uint8(1) - self._eot_lane()]              # eot first
        with np.errstate(over="ignore"):
            # two's-complement reinterpret + sign-bit flip = biased unsigned
            uts = self.ts.astype(np.uint64) ^ np.uint64(_BIAS)
            keys.append(np.iinfo(np.uint64).max - uts)       # ts desc
        for k in range(self.n_lanes - 1, -1, -1):
            keys.append(self.lanes[:, k])
        return np.lexsort(keys)

    def _death_lane(self) -> np.ndarray:
        return ((self.flags & DEATH_FLAGS) != 0).astype(np.uint8)

    def _pure_death_lane(self) -> np.ndarray:
        """RANK-grade tombstone bit (Cells.resolveRegular isTombstone —
        a STATIC property: has a deletion time and NO ttl). An expired
        expiring cell that compaction converted to a tombstone keeps
        FLAG_EXPIRING, so its rank is identical before and after the
        conversion — replicas compacting at different times still
        reconcile identically (CASSANDRA-14592). Shadowing/purge use
        death_eff (death | expired), which is separately clock-correct."""
        return (((self.flags & DEATH_FLAGS) != 0)
                & ((self.flags & FLAG_EXPIRING) == 0)).astype(np.uint8)

    def _eot_lane(self) -> np.ndarray:
        """Expiring-or-tombstone: has a localDeletionTime (static property,
        independent of the reconciling clock — CASSANDRA-14592)."""
        return ((self.flags & (DEATH_FLAGS | FLAG_EXPIRING)) != 0) \
            .astype(np.uint8)

    def _value_prefix_lane(self) -> np.ndarray:
        """First 4 bytes of each value, big-endian, zero-padded
        (vectorised gather; bytes past the cell's end read as 0)."""
        n = len(self)
        if n == 0:
            return np.zeros(0, dtype=np.uint32)
        pay = self.payload
        idx = self.val_start[:, None] + np.arange(4)[None, :]
        valid = idx < self.off[1:, None]
        idx = np.minimum(idx, max(len(pay) - 1, 0))
        b = np.where(valid, pay[idx], 0).astype(np.uint32)
        return (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]

    def apply_permutation(self, perm: np.ndarray) -> "CellBatch":
        perm = np.asarray(perm, dtype=np.int64)
        n = len(perm)
        starts = self.off[:-1][perm]
        lens = (self.off[1:] - self.off[:-1])[perm]
        new_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=new_off[1:])
        total = int(new_off[-1])
        # ragged gather of payload frames: C++ memcpy loop (the numpy
        # fancy-index fallback builds a per-byte index array — measurably
        # the compaction host hot spot)
        if total:
            new_payload = _native_gather(self.payload, self.off, perm,
                                         new_off)
            if new_payload is None:
                pos_in_cell = np.arange(total, dtype=np.int64) - \
                    np.repeat(new_off[:-1], lens)
                flat_idx = np.repeat(starts, lens) + pos_in_cell
                new_payload = self.payload[flat_idx]
        else:
            new_payload = np.zeros(0, dtype=np.uint8)
        new_val_start = new_off[:-1] + (self.val_start - self.off[:-1])[perm]
        out = CellBatch(self.lanes[perm], self.ts[perm], self.ldt[perm],
                        self.ttl[perm], self.flags[perm], new_off,
                        new_val_start, new_payload, dict(self.pk_map),
                        sorted=True)
        out.ck_comp = self.ck_comp
        out.ck_fits_prefix = self.ck_fits_prefix
        return out

    # ------------------------------------------------------------ concat --

    def slice_range(self, lo: int, hi: int) -> "CellBatch":
        """Zero-copy contiguous slice [lo, hi) — arrays are VIEWS of this
        batch (callers must not mutate either). The payload offsets are
        rebased (the only small copy)."""
        base = int(self.off[lo])
        out = CellBatch(self.lanes[lo:hi], self.ts[lo:hi], self.ldt[lo:hi],
                        self.ttl[lo:hi], self.flags[lo:hi],
                        self.off[lo:hi + 1] - base,
                        self.val_start[lo:hi] - base,
                        self.payload[base:int(self.off[hi])],
                        self.pk_map, sorted=self.sorted)
        out.ck_comp = self.ck_comp
        out.ck_fits_prefix = self.ck_fits_prefix
        return out

    def drop_values(self, mask: np.ndarray) -> "CellBatch":
        """Rewrite the payload with value bytes removed for masked cells
        (expired-TTL -> tombstone conversion drops the dead value)."""
        if not mask.any():
            return self
        n = len(self)
        lens = self.off[1:] - self.off[:-1]
        vlens = self.off[1:] - self.val_start
        new_lens = np.where(mask, lens - vlens, lens)
        new_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(new_lens, out=new_off[1:])
        total = int(new_off[-1])
        pos_in_cell = np.arange(total, dtype=np.int64) - \
            np.repeat(new_off[:-1], new_lens)
        flat_idx = np.repeat(self.off[:-1], new_lens) + pos_in_cell
        new_payload = self.payload[flat_idx]
        header_lens = self.val_start - self.off[:-1]
        out = CellBatch(self.lanes, self.ts, self.ldt, self.ttl, self.flags,
                        new_off, new_off[:-1] + header_lens,
                        new_payload, dict(self.pk_map), sorted=self.sorted)
        out.ck_comp = self.ck_comp
        out.ck_fits_prefix = self.ck_fits_prefix
        return out

    @staticmethod
    def concat(batches: list["CellBatch"]) -> "CellBatch":
        K = batches[0].n_lanes if batches else 13
        batches = [b for b in batches if len(b)]
        if not batches:
            return CellBatch.empty(K)
        assert all(b.n_lanes == K for b in batches)
        lanes = np.concatenate([b.lanes for b in batches])
        ts = np.concatenate([b.ts for b in batches])
        ldt = np.concatenate([b.ldt for b in batches])
        ttl = np.concatenate([b.ttl for b in batches])
        flags = np.concatenate([b.flags for b in batches])
        payload = np.concatenate([b.payload for b in batches])
        offs = [np.zeros(1, dtype=np.int64)]
        vstarts = []
        base = 0
        for b in batches:
            offs.append(b.off[1:] + base)
            vstarts.append(b.val_start + base)
            base += int(b.off[-1])
        off = np.concatenate(offs)
        val_start = np.concatenate(vstarts)
        pk_map: dict[bytes, bytes] = {}
        seen_maps: set[int] = set()
        for b in batches:
            # slices share their parent's pk_map OBJECT: a many-slice
            # concat (the batched-read shard merge) would re-walk the
            # same full map once per slice — merge each dict once
            if id(b.pk_map) in seen_maps:
                continue
            seen_maps.add(id(b.pk_map))
            for k, v in b.pk_map.items():
                prev = pk_map.get(k)
                if prev is not None and prev != v:
                    raise RuntimeError("128-bit partition-key hash collision")
                pk_map[k] = v
        out = CellBatch(lanes, ts, ldt, ttl, flags, off, val_start, payload,
                        pk_map, sorted=False)
        for b in batches:
            if b.ck_comp is not None:
                out.ck_comp = b.ck_comp
                break
        out.ck_fits_prefix = all(b.ck_fits_prefix for b in batches)
        return out

    @staticmethod
    def empty(n_lanes: int = 13) -> "CellBatch":
        return CellBatch(np.zeros((0, n_lanes), dtype=np.uint32),
                         np.zeros(0, dtype=np.int64),
                         np.zeros(0, dtype=np.int32),
                         np.zeros(0, dtype=np.int32),
                         np.zeros(0, dtype=np.uint8),
                         np.zeros(1, dtype=np.int64),
                         np.zeros(0, dtype=np.int64),
                         np.zeros(0, dtype=np.uint8), {}, sorted=True)

    # --------------------------------------------------------- reconcile --

    def boundaries(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(part_new, row_new, cell_new) boolean arrays; batch must be
        sorted. row identity = partition + clustering lanes (incl. full-ck
        hash); cell identity = row + column + path lanes."""
        part_new, row_new, _, cell_new = self.boundaries4()
        return part_new, row_new, cell_new

    def boundaries4(self):
        """(part_new, row_new, col_new, cell_new); col = row + column lane
        (the complex-deletion scope)."""
        assert self.sorted
        n = len(self)
        if n == 0:
            z = np.zeros(0, dtype=bool)
            return z, z, z, z
        K = self.n_lanes
        C = K - 9
        diff = self.lanes[1:] != self.lanes[:-1]
        part_new = np.ones(n, dtype=bool)
        part_new[1:] = diff[:, :4].any(axis=1)
        row_new = part_new.copy()
        row_new[1:] |= diff[:, 4:6 + C].any(axis=1)
        col_new = row_new.copy()
        col_new[1:] |= diff[:, 6 + C]
        cell_new = col_new.copy()
        cell_new[1:] |= diff[:, 7 + C:].any(axis=1)
        return part_new, row_new, col_new, cell_new

    def reconcile(self, gc_before: int = 0, now: int = 0,
                  purgeable_ts: np.ndarray | None = None) -> np.ndarray:
        """Compute the keep mask over a SORTED batch.

        gc_before: seconds; tombstones with ldt < gc_before are candidates
        for purging. now: seconds, for TTL expiry. purgeable_ts: per-cell
        int64 — a tombstone is only dropped if its ts < purgeable_ts[i]
        (the min timestamp any overlapping non-compacting source could
        contain for that partition; +inf when no overlap). Returns keep
        mask; also rewrites flags/ldt in place for expired cells
        (TTL -> tombstone conversion)."""
        n = len(self)
        if n == 0:
            return np.zeros(0, dtype=bool)
        part_new, row_new, col_new, cell_new = self.boundaries4()
        K = self.n_lanes
        C = K - 9
        col = self.lanes[:, 6 + C]

        # 1. newest-version-wins: the first record of each cell run
        winner = cell_new.copy()

        # 1b. exact value tie-break: the sort separates equal-(identity, ts,
        # eot, death, ldt) records only by a 4-byte value prefix; when full
        # values differ beyond it, pick the lexicographically largest value
        # (Cells.resolveRegular compares whole values last). Host fix-up,
        # rare.
        vp = self._value_prefix_lane()
        death = self._pure_death_lane()   # must mirror the sort keys
        eot = self._eot_lane()
        tie = np.zeros(n, dtype=bool)
        if n > 1:
            tie[1:] = (~cell_new[1:]) & (self.ts[1:] == self.ts[:-1]) & \
                (eot[1:] == eot[:-1]) & (death[1:] == death[:-1]) & \
                (self.ldt[1:] == self.ldt[:-1]) & (vp[1:] == vp[:-1])
        if tie.any():
            idxs = np.flatnonzero(tie)
            run_start = None
            prev = -2
            runs = []
            for i in idxs:
                if i != prev + 1:
                    runs.append([i - 1, i])
                else:
                    runs[-1][1] = i
                prev = i
            for lo, hi in runs:
                if not cell_new[lo]:
                    # the tie run sits below the cell's winner (older
                    # duplicates) — losers stay losers
                    continue
                best = max(range(lo, hi + 1), key=self.cell_value)
                if best != lo:
                    winner[lo] = False
                    winner[best] = True

        # 2. TTL expiry: expired cells act as tombstones from `now` on
        expired = ((self.flags & FLAG_EXPIRING) != 0) & (self.ldt <= now)
        self.flags[expired] |= FLAG_TOMBSTONE

        # 3. deletion shadowing
        part_id = np.cumsum(part_new) - 1
        row_id = np.cumsum(row_new) - 1
        n_part = int(part_id[-1]) + 1
        n_row = int(row_id[-1]) + 1
        pd_ts = np.full(n_part, NO_TIMESTAMP, dtype=np.int64)
        pd_lead = winner & (col == COL_PARTITION_DEL)
        pd_ts[part_id[pd_lead]] = self.ts[pd_lead]
        rd_ts = np.full(n_row, NO_TIMESTAMP, dtype=np.int64)
        rd_lead = winner & (col == COL_ROW_DEL)
        rd_ts[row_id[rd_lead]] = self.ts[rd_lead]

        pd_of = pd_ts[part_id]
        rd_of = np.maximum(rd_ts[row_id], pd_of)
        # complex (collection) deletions: path-less markers at the start of
        # their (row, column) segment shadow older path cells
        col_id = np.cumsum(col_new) - 1
        n_col = int(col_id[-1]) + 1
        cd_ts = np.full(n_col, NO_TIMESTAMP, dtype=np.int64)
        is_cd = (self.flags & FLAG_COMPLEX_DEL) != 0
        cd_lead = winner & is_cd
        cd_ts[col_id[cd_lead]] = self.ts[cd_lead]
        cd_of = np.maximum(cd_ts[col_id], rd_of)

        is_pd = col == COL_PARTITION_DEL
        is_rd = col == COL_ROW_DEL
        is_range = (self.flags & FLAG_RANGE_BOUND) != 0
        shadowed = np.zeros(n, dtype=bool)
        # cells and liveness: deleted if ts <= enclosing deletion ts
        plain = ~is_pd & ~is_rd & ~is_cd & ~is_range
        shadowed[plain] = self.ts[plain] <= cd_of[plain]
        # row deletions superseded by the partition deletion; complex
        # deletions superseded by row/partition deletions
        shadowed[is_rd] = self.ts[is_rd] <= pd_of[is_rd]
        shadowed[is_cd] = self.ts[is_cd] <= rd_of[is_cd]

        # 3b. range tombstones (storage/rangetomb.py): per affected
        # partition, winner slices cover rows by full byte-comparable
        # composite — the marker's stream position is not load-bearing.
        # Zero cost when no FLAG_RANGE_BOUND cell is present.
        if is_range.any():
            from .rangetomb import Slice, covering_ts
            if self.ck_comp is None:
                raise RuntimeError(
                    "range tombstones require batch.ck_comp (open the "
                    "sstable/builder with its table)")
            cover = np.full(n, NO_TIMESTAMP, dtype=np.int64)
            comp_cache: dict[bytes, bytes] = {}
            # part_id is sorted ascending: locate each affected
            # partition's run with searchsorted, not a full rescan —
            # per-partition prefix deletes are a common pattern and a
            # linear scan per marker partition would be O(n * partitions)
            rt_parts = np.unique(part_id[is_range])
            run_bounds = np.searchsorted(part_id, [rt_parts, rt_parts + 1])
            for p, lo_i, hi_i in zip(rt_parts, run_bounds[0],
                                     run_bounds[1]):
                members = np.arange(int(lo_i), int(hi_i))
                slices: list = []
                slice_idx: list[int] = []
                for i in members[is_range[members] & winner[members]]:
                    ck, path, _ = self.cell_payload(int(i))
                    slices.append(Slice.from_cell(
                        ck, path, int(self.ts[i]), int(self.ldt[i])))
                    slice_idx.append(int(i))
                if not slices:
                    continue
                for i in members:
                    if is_range[i]:
                        continue
                    ck = self.cell_payload(int(i))[0]
                    if not ck:
                        continue   # static row is never range-covered
                    compv = comp_cache.get(ck)
                    if compv is None:
                        compv = self.ck_comp(ck)
                        comp_cache[ck] = compv
                    cover[i] = covering_ts(slices, compv)
                # a slice fully contained in a newer (or equal-ts,
                # earlier-seen) slice is redundant — dropped like the
                # reference's RangeTombstoneList normalization
                for j, (sl, i) in enumerate(zip(slices, slice_idx)):
                    for k2, other in enumerate(slices):
                        if k2 == j or not other.contains(sl):
                            continue
                        if other.ts > sl.ts or \
                                (other.ts == sl.ts and k2 < j):
                            shadowed[i] = True
                            break
            shadowed[plain] |= self.ts[plain] <= cover[plain]
            shadowed[is_rd] |= self.ts[is_rd] <= cover[is_rd]
            shadowed[is_cd] |= self.ts[is_cd] <= cover[is_cd]
            # range markers themselves: only the partition deletion (or a
            # containing slice, handled above) supersedes them
            shadowed[is_range] |= self.ts[is_range] <= pd_of[is_range]

        # 4. purge gc-able tombstones (incl. expired-TTL converted ones)
        death = ((self.flags & DEATH_FLAGS) != 0)
        if purgeable_ts is None:
            purgeable = np.ones(n, dtype=bool)
        else:
            purgeable = self.ts < purgeable_ts
        purged = death & (self.ldt < gc_before) & purgeable

        # stash for counter summation (merge_sorted consumes it)
        self.last_shadowed = shadowed
        return winner & ~shadowed & ~purged


class CellBatchBuilder:
    """Append-oriented builder used by the memtable and by decoders.
    Appends are O(1) python-level; `seal()` produces numpy arrays."""

    def __init__(self, table: TableMetadata):
        self.table = table
        self.C = table.clustering_lanes
        self.K = lanes_for_table(table)
        self._lanes: list[tuple] = []
        self._ts: list[int] = []
        self._ldt: list[int] = []
        self._ttl: list[int] = []
        self._flags: list[int] = []
        self._payload = bytearray()
        self._value_off: list[int] = [0]
        self._val_start: list[int] = []
        self.pk_map: dict[bytes, bytes] = {}
        self._comp_cache: dict[bytes, bytes] = {}
        self._ck_fits = True

    def __len__(self):
        return len(self._ts)

    # ------------------------------------------------------------ low level

    def _pk_lanes(self, pk: bytes) -> tuple:
        lanes = pk_lanes(pk)
        key16 = b"".join(int(x).to_bytes(4, "big") for x in lanes)
        existing = self.pk_map.get(key16)
        if existing is None:
            self.pk_map[key16] = pk
        elif existing != pk:
            raise RuntimeError("128-bit partition-key hash collision")
        return lanes

    def _ck_lanes(self, ck_frame: bytes, is_comp: bool = False) -> tuple:
        """ck_frame is the SERIALIZED clustering tuple (payload form);
        lanes come from its byte-comparable composite. is_comp=True means
        the bytes ARE already a composite (range-tombstone bounds)."""
        if not ck_frame:
            return (0,) * (self.C + 2)
        if is_comp:
            comp = ck_frame
        else:
            comp = self._comp_cache.get(ck_frame)
            if comp is None:
                comp = self.table.clustering_comp(ck_frame)
                if len(self._comp_cache) < 65536:
                    self._comp_cache[ck_frame] = comp
        if len(comp) > 4 * self.C:
            self._ck_fits = False
        pref = _pack_prefix(comp, self.C)
        h1, _ = murmur3.hash128(comp)
        return (*pref, h1 >> 32, h1 & _U32)

    def _path_lanes(self, path: bytes) -> tuple:
        if not path:
            return (0, 0)
        pp = int.from_bytes(path[:4].ljust(4, b"\x00"), "big")
        h1, _ = murmur3.hash128(path)
        return (pp, h1 & _U32)

    def append_raw(self, pk: bytes, ck: bytes, column: int, path: bytes,
                   value: bytes, ts: int, ldt: int = NO_DELETION_TIME,
                   ttl: int = 0, flags: int = 0) -> None:
        lanes = (*self._pk_lanes(pk),
                 *self._ck_lanes(ck, is_comp=bool(flags & FLAG_RANGE_BOUND)),
                 column, *self._path_lanes(path))
        assert len(lanes) == self.K
        self._lanes.append(lanes)
        self._ts.append(ts)
        self._ldt.append(ldt)
        self._ttl.append(ttl)
        self._flags.append(flags)
        frame = bytearray()
        vi.write_unsigned_vint(len(ck), frame)
        frame += ck
        vi.write_unsigned_vint(len(path), frame)
        frame += path
        self._val_start.append(len(self._payload) + len(frame))
        frame += value
        self._payload += frame
        self._value_off.append(len(self._payload))

    # ----------------------------------------------------------- high level

    def add_cell(self, pk: bytes, ck: bytes, column_id: int, value: bytes,
                 ts: int, ttl: int = 0, now: int = 0, path: bytes = b"") -> None:
        if ttl > 0:
            self.append_raw(pk, ck, column_id, path, value, ts,
                            ldt=timeutil_expiration(now, ttl), ttl=ttl, flags=FLAG_EXPIRING)
        else:
            self.append_raw(pk, ck, column_id, path, value, ts)

    def add_tombstone(self, pk: bytes, ck: bytes, column_id: int, ts: int,
                      ldt: int, path: bytes = b"") -> None:
        self.append_raw(pk, ck, column_id, path, b"", ts, ldt=ldt,
                        flags=FLAG_TOMBSTONE)

    def add_row_liveness(self, pk: bytes, ck: bytes, ts: int,
                         ttl: int = 0, now: int = 0) -> None:
        if ttl > 0:
            self.append_raw(pk, ck, COL_ROW_LIVENESS, b"", b"", ts,
                            ldt=timeutil_expiration(now, ttl), ttl=ttl,
                            flags=FLAG_ROW_LIVENESS | FLAG_EXPIRING)
        else:
            self.append_raw(pk, ck, COL_ROW_LIVENESS, b"", b"", ts,
                            flags=FLAG_ROW_LIVENESS)

    def add_row_deletion(self, pk: bytes, ck: bytes, ts: int, ldt: int) -> None:
        self.append_raw(pk, ck, COL_ROW_DEL, b"", b"", ts, ldt=ldt,
                        flags=FLAG_ROW_DEL)

    def add_partition_deletion(self, pk: bytes, ts: int, ldt: int) -> None:
        self.append_raw(pk, b"", COL_PARTITION_DEL, b"", b"", ts, ldt=ldt,
                        flags=FLAG_PARTITION_DEL)

    def add_complex_deletion(self, pk: bytes, ck: bytes, column_id: int,
                             ts: int, ldt: int) -> None:
        """Whole-collection deletion (UPDATE SET m = {...} overwrite)."""
        self.append_raw(pk, ck, column_id, b"", b"", ts, ldt=ldt,
                        flags=FLAG_COMPLEX_DEL)

    def add_range_tombstone(self, pk: bytes, slc) -> None:
        """Range tombstone slice (storage/rangetomb.py Slice): one cell at
        COL_RANGE_TOMB whose ck frame is the start bound and whose path
        encodes the kinds + end bound — identical re-writes share an
        identity and reconcile newest-wins like any cell."""
        from ..schema import COL_RANGE_TOMB
        self.append_raw(pk, slc.start, COL_RANGE_TOMB, slc.encode_path(),
                        b"", slc.ts, ldt=slc.ldt,
                        flags=FLAG_RANGE_BOUND | FLAG_TOMBSTONE)

    # --------------------------------------------------------------- seal --

    def seal(self) -> CellBatch:
        n = len(self._ts)
        # fromiter over the flattened tuples beats np.array's per-row
        # type inspection ~1.5x — seal is the flush drain's hot spot
        import itertools
        lanes = np.fromiter(itertools.chain.from_iterable(self._lanes),
                            dtype=np.uint32,
                            count=n * self.K).reshape(n, self.K)
        out = CellBatch(
            lanes,
            np.array(self._ts, dtype=np.int64),
            np.array(self._ldt, dtype=np.int32),
            np.array(self._ttl, dtype=np.int32),
            np.array(self._flags, dtype=np.uint8),
            np.array(self._value_off, dtype=np.int64),
            np.array(self._val_start, dtype=np.int64),
            np.frombuffer(bytes(self._payload), dtype=np.uint8).copy(),
            dict(self.pk_map))
        out.ck_comp = self.table.clustering_comp
        out.ck_fits_prefix = self._ck_fits
        return out


def sum_counter_runs(sorted_batch: "CellBatch", keep: np.ndarray,
                     shadowed: np.ndarray | None = None) -> dict:
    """Counter reconciliation (db/context/CounterContext.java:78 semantics,
    simplified to commutative deltas): for each cell run whose winner is a
    live counter cell, the result value is the SUM of the DISTINCT live,
    unshadowed versions. Distinctness is by timestamp: replicas of the
    same delta share the coordinator's timestamp and must count once
    (the reference's shard (clock, count) pairs serve the same purpose);
    deltas older than an enclosing deletion are excluded (a deleted
    counter restarts from zero). Returns {sorted_position: int64 sum}."""
    flags = sorted_batch.flags
    counters = (flags & FLAG_COUNTER) != 0
    if not counters.any():
        return {}
    _, _, cell_new = sorted_batch.boundaries()
    out: dict[int, int] = {}
    n = len(sorted_batch)
    idxs = np.flatnonzero(cell_new)
    ends = np.append(idxs[1:], n)
    ts = sorted_batch.ts
    for start, end in zip(idxs, ends):
        if not (counters[start] and keep[start]):
            continue
        total = 0
        prev_ts = None
        for j in range(start, end):
            if flags[j] & DEATH_FLAGS:
                break   # ts-descending run: everything older is deleted
            if not counters[j]:
                continue
            if shadowed is not None and shadowed[j]:
                continue
            if prev_ts is not None and ts[j] == prev_ts:
                continue  # replica duplicate of the same delta
            prev_ts = ts[j]
            v = sorted_batch.cell_value(j)
            if len(v) == 8:
                total += int.from_bytes(v, "big", signed=True)
        out[int(start)] = total
    return out


def apply_counter_sums(out_batch: "CellBatch", kept_sorted_pos: np.ndarray,
                       sums: dict) -> "CellBatch":
    """Rewrite summed counter values into the compacted output batch."""
    if not sums:
        return out_batch
    pos_to_out = {int(p): i for i, p in enumerate(kept_sorted_pos)}
    payload = out_batch.payload.copy()
    for p, total in sums.items():
        i = pos_to_out.get(p)
        if i is None:
            continue
        vs = int(out_batch.val_start[i])
        ve = int(out_batch.off[i + 1])
        if ve - vs == 8:
            payload[vs:ve] = np.frombuffer(
                (total & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big"),
                dtype=np.uint8)
    out_batch.payload = payload
    return out_batch


def merge_sorted(batches: list[CellBatch], gc_before: int = 0, now: int = 0,
                 purgeable_ts_fn=None) -> CellBatch:
    """Host (numpy) reference merge: concat -> sort -> reconcile -> compact.
    The device path (ops/merge.py) must produce identical results."""
    cat = CellBatch.concat(batches)
    if len(cat) == 0:
        return cat
    perm = cat.sort_permutation()
    s = cat.apply_permutation(perm)
    if purgeable_ts_fn is not None:
        purgeable_ts = purgeable_ts_fn(s)
    else:
        purgeable_ts = None
    keep = s.reconcile(gc_before=gc_before, now=now, purgeable_ts=purgeable_ts)
    sums = sum_counter_runs(s, keep, s.last_shadowed)
    kept = np.flatnonzero(keep)
    out = s.apply_permutation(kept)
    out.sorted = True
    out = apply_counter_sums(out, kept, sums)
    # expired-TTL cells were converted to tombstones: drop their values
    converted = ((out.flags & FLAG_EXPIRING) != 0) & \
        ((out.flags & FLAG_TOMBSTONE) != 0)
    return out.drop_values(converted)
