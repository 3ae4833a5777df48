"""Atomic single-sstable rewrite shared by the maintenance operations.

Reference counterpart: db/compaction/CompactionManager.java's
parallelAllSSTableOperation + the LifecycleTransaction protocol —
cleanup, scrub and anticompaction are all "rewrite one sstable in
place" and share the same commit sequence (track_new, write, obsolete
the original, drop empty outputs, commit, swap in the tracker,
release). Callers must hold the store's compaction lock
(CompactionManager.cfs_lock) so a background compaction never merges
the original of an sstable a maintenance op just replaced.
"""
from __future__ import annotations

from .lifecycle import LifecycleTransaction
from .sstable import Descriptor, SSTableReader, SSTableWriter


def rewrite_sstable(cfs, sst, parts) -> list:
    """Atomically replace `sst` with one new sstable per part.

    parts: [(repaired_at, level, fill)] where fill(writer) appends the
    part's cells. A part producing zero cells leaves no sstable (the
    output is obsoleted inside the same transaction). Returns the new
    live readers, already swapped into the tracker."""
    txn = LifecycleTransaction(cfs.directory)
    writers = []
    new_readers = []
    try:
        for repaired_at, level, fill in parts:
            gen = cfs.next_generation()
            desc = Descriptor(cfs.directory, gen)
            txn.track_new(gen)
            w = SSTableWriter(desc, cfs.table,
                              estimated_partitions=sst.n_partitions)
            w.repaired_at = repaired_at
            w.level = level
            writers.append(w)
            fill(w)
            w.finish()
            new = SSTableReader(desc, cfs.table)
            if new.n_cells > 0:
                new_readers.append(new)
            else:
                new.close()
                txn.track_obsolete(gen)
        txn.track_obsolete(sst.desc.generation)
        txn.commit()
        cfs.tracker.replace([sst], new_readers)
        sst.release()
        if getattr(cfs, "index_build_fn", None) is not None:
            # rewritten outputs are NEW sstables: eager-build their
            # attached-index components like flush/compaction outputs
            for r in new_readers:
                cfs.index_build_fn(r)
        if cfs.row_cache is not None:
            # cleanup/scrub/anticompaction CHANGE logical content (drop
            # foreign ranges / corrupt rows / restamp) — cached merges
            # of the replaced sstable must go
            cfs.row_cache.clear()
        return new_readers
    except BaseException:
        for w in writers:
            try:
                w.abort()
            except Exception:
                pass
        for r in new_readers:
            r.close()
        txn.abort()
        raise
