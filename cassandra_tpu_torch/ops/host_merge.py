"""Host merge engine binding: C++ k-way streaming merge + inline
reconcile (ops/native/merge.cpp) for sorted CellBatch runs.

This is the host-side counterpart of the TPU kernel (ops/merge.py) —
the CompactionIterator formulation (db/compaction/CompactionIterator.java
:90) in native code. The compaction task picks an engine per the measured
environment: the TPU kernel when the device link sustains it, this engine
when the link is latency/bandwidth-bound (e.g. a tunneled chip), numpy as
the always-available executable spec.

Falls back to the numpy merge when a batch is unsorted, contains counter
cells (commutative-sum reconcile lives in numpy), or the native library
is unavailable.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..storage import cellbatch as cb
from ..storage.cellbatch import (FLAG_COUNTER, FLAG_RANGE_BOUND,
                                 FLAG_TOMBSTONE, CellBatch)


_lib = None
_lib_checked = False


def available() -> bool:
    global _lib, _lib_checked
    if not _lib_checked:
        _lib_checked = True
        try:
            from .native import build as native_build
            _lib = native_build.load()
        except Exception:
            _lib = None
    return _lib is not None


class LazyMergedBatch:
    """A native merge result whose GATHER (permutation materialization
    — the biggest single producer-thread cost after decode) has not run
    yet. The compaction write loop materializes it on the WRITER
    thread, so round k's gather overlaps round k+1's decode + merge —
    a pipeline rebalance, not a semantic change: the wq drains FIFO on
    one thread, so materialization order equals merge order and output
    bytes are untouched."""

    __slots__ = ("cat", "out_idx", "out_exp", "n_out", "prof")

    def __init__(self, cat, out_idx, out_exp, n_out, prof):
        self.cat = cat
        self.out_idx = out_idx
        self.out_exp = out_exp
        self.n_out = n_out
        self.prof = prof

    def __len__(self) -> int:
        return self.n_out

    def materialize(self) -> CellBatch:
        import time as _time
        t0 = _time.perf_counter()
        out = self.cat.apply_permutation(self.out_idx[:self.n_out])
        out.sorted = True
        converted = self.out_exp[:self.n_out].astype(bool)
        if converted.any():
            out.flags[converted] |= FLAG_TOMBSTONE
            out = out.drop_values(converted)
        if self.prof is not None:
            # single-writer key: only the materializing thread bills
            # 'gather' once deferral is on
            self.prof["gather"] = self.prof.get("gather", 0.0) \
                + (_time.perf_counter() - t0)
        self.cat = None   # drop the concat refs as soon as gathered
        return out


def merge_sorted_native(batches: list[CellBatch], gc_before: int = 0,
                        now: int = 0, purgeable_ts_fn=None,
                        prof: dict | None = None,
                        defer_gather: bool = False) -> CellBatch:
    """Drop-in equivalent of storage.cellbatch.merge_sorted running the
    merge/reconcile in C++. Requires every batch sorted; counter tables
    fall back to numpy. defer_gather=True returns a LazyMergedBatch
    (same length) whose materialize() runs the output gather — the
    compaction pipeline calls it from the writer thread."""
    import time as _time

    batches = [b for b in batches if len(b)]
    if not batches:
        return CellBatch.empty()
    if not available() or len(batches) > 64 \
            or not all(b.sorted for b in batches) \
            or any((b.flags & (FLAG_COUNTER | FLAG_RANGE_BOUND)).any()
                   for b in batches):
        return cb.merge_sorted(batches, gc_before=gc_before, now=now,
                               purgeable_ts_fn=purgeable_ts_fn)

    t0 = _time.perf_counter()
    cat = CellBatch.concat(batches)
    n = len(cat)
    run_starts = np.zeros(len(batches) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in batches], out=run_starts[1:])

    pts = None
    t1 = _time.perf_counter()
    if purgeable_ts_fn is not None:
        pts = np.ascontiguousarray(purgeable_ts_fn(cat), dtype=np.int64)
    t2 = _time.perf_counter()

    lanes = np.ascontiguousarray(cat.lanes, dtype=np.uint32)
    ts = np.ascontiguousarray(cat.ts, dtype=np.int64)
    ldt = np.ascontiguousarray(cat.ldt, dtype=np.int32)
    flags = np.ascontiguousarray(cat.flags, dtype=np.uint8)
    off = np.ascontiguousarray(cat.off, dtype=np.int64)
    val_start = np.ascontiguousarray(cat.val_start, dtype=np.int64)
    payload = np.ascontiguousarray(cat.payload, dtype=np.uint8)

    out_idx = np.empty(n, dtype=np.int64)
    out_exp = np.empty(n, dtype=np.uint8)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n_out = _lib.merge_reconcile(
        lanes.ctypes.data_as(u32p), ts.ctypes.data_as(i64p),
        ldt.ctypes.data_as(i32p), flags.ctypes.data_as(u8p),
        off.ctypes.data_as(i64p), val_start.ctypes.data_as(i64p),
        payload.ctypes.data_as(u8p), cat.n_lanes,
        run_starts.ctypes.data_as(i64p), len(batches),
        pts.ctypes.data_as(i64p) if pts is not None else None,
        gc_before, now, out_idx.ctypes.data_as(i64p),
        out_exp.ctypes.data_as(u8p))
    if n_out < 0:
        raise RuntimeError("native merge_reconcile failed")
    t3 = _time.perf_counter()
    if prof is not None:
        prof["purge_fn"] = prof.get("purge_fn", 0.0) + (t2 - t1)
        prof["pack"] = prof.get("pack", 0.0) + (t1 - t0)
        prof["native_merge"] = prof.get("native_merge", 0.0) + (t3 - t2)

    lazy = LazyMergedBatch(cat, out_idx, out_exp, int(n_out), prof)
    if defer_gather:
        return lazy
    return lazy.materialize()
