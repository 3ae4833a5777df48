"""Small multi-segment sstables for the tests of Phase A's batched
masks (tests/test_torch_scan_batch.py against the JAX package on the
CPU, tests/test_torch_cuda.py on the card), and the runs of segments
that the cap and the gate give. Works with either package's modules;
imports no jax."""
from __future__ import annotations

import numpy as np

SEGMENT = 16           # cells a segment
ROWS = 100             # rows an sstable: 6 full segments and one of 4
SOURCES = 3
CAP = 40               # keys a run: two full segments, or two and the 4


def write_sources(eng, session, pkg, seed: int):
    """SOURCES sstables of ROWS rows (overlapping partitions) cut into
    SEGMENT-cell segments, v uniform in [-1000, 1000]."""
    cb, bulk, Descriptor, Writer = pkg
    session.execute("CREATE KEYSPACE ks WITH replication = "
                    "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    session.execute("USE ks")
    session.execute("CREATE TABLE t (k int, c int, v int, "
                    "PRIMARY KEY (k, c))")
    cfs = eng.store("ks", "t")
    table = cfs.table
    col = table.regular_columns[0].column_id
    rng = np.random.default_rng(seed)
    for _ in range(SOURCES):
        pk = rng.integers(0, 60, ROWS)
        ck = rng.permutation(ROWS)
        v = rng.integers(-1000, 1001, ROWS).astype(np.int32)
        batch = cb.merge_sorted([bulk.build_int_batch(
            table, pk, ck, v.astype(">i4").view(np.uint8).reshape(ROWS, 4),
            np.full(ROWS, 1_000_000, np.int64), column_id=col)])
        w = Writer(Descriptor(cfs.directory, cfs.next_generation()), table,
                   estimated_partitions=len(np.unique(pk)),
                   segment_cells=SEGMENT)
        w.append(batch)
        w.finish()
    cfs.reload_sstables()
    return cfs


def segment_keys(cfs, pred, ssi, ds) -> list:
    """(source, keys) of each segment the scan gates, in its order:
    sources in view order, the segments that the zone map keeps in
    order, those with keys."""
    out = []
    for sst in cfs.tracker.view():
        s0, s1 = sst.segment_range_for_tokens(-(1 << 63), (1 << 63) - 1)
        zm = ssi.zonemap_for(sst, cfs.table)
        keep = zm.keep_mask(pred)[s0:s1] if zm is not None \
            else np.ones(s1 - s0, dtype=bool)
        for s in range(s0, s1):
            if not keep[s - s0]:
                continue
            sel, _keys = ds.batch_predicate_cells(
                sst._read_segment(s), pred, reconciled=False)
            if len(sel):
                out.append((sst, len(sel)))
    return out


def runs(segments, answers, cap) -> list:
    """The key counts of the runs that the cap and the gate's answers
    give over `segments` [(source, keys)]."""
    runs, cur, src = [], [], None
    for (sst, n), dev in zip(segments, answers):
        if cur and (not dev or sst is not src or sum(cur) + n > cap):
            runs.append(sum(cur))
            cur = []
        if dev:
            cur.append(n)
        src = sst
    if cur:
        runs.append(sum(cur))
    return runs
