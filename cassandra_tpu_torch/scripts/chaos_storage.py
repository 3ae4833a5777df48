"""CI check (tier-2, like check_writepath_ab.py): storage chaos drill —
a deterministic seeded workload runs under armed fault points (EIO,
bit-flip, torn write) and the node must end in the state its failure
policies mandate.

Drills, in order, each asserting the policy-mandated end state:

  1. bit-flipped Data.db under disk_failure_policy=best_effort:
     a point read of an unaffected partition SUCCEEDS, the corrupt
     sstable appears in system_views.quarantined_sstables,
     storage.corruption_detected increments, and the next compaction
     round plans without it;
  2. loss accounting: after the quarantine, every row NOT covered by
     the injected loss (i.e. every row with a surviving copy in another
     sstable or the commitlog-replayed flush) still reads back exactly;
     a scrub pass leaves the surviving set internally consistent
     (snapshot-before-scrub taken);
  3. EIO on flush mid-pipeline: the flush fails, the live set is
     unchanged, the memtable still serves every acked row, and a retry
     flush after the fault clears recovers durably;
  4. torn sstable write: the partial output never reaches the live set
     (no TOC commit point) and a retry succeeds;
  5. commitlog fsync EIO under commit_failure_policy=stop_commit: the
     in-flight write fails, subsequent writes are REFUSED while reads
     continue serving.

Everything is disarmed at exit — with no fault points armed the
read/write A/B checks (check_readpath_ab.py / check_writepath_ab.py)
must still report zero divergence; CI runs them alongside this drill.

The engines run on `device` (`cuda` by default, which raises without
a card; `cpu` runs the kernels' plain PyTorch versions).

    python -m cassandra_tpu_torch.scripts.chaos_storage [--device cpu]

Exit 0 = clean; exit 1 prints each violation.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


N_PKS = 32
TS0 = 1_000_000


def _build(base_dir, commit_policy="ignore", device=None):
    from cassandra_tpu_torch.config import Config, Settings
    from cassandra_tpu_torch.schema import Schema, make_table
    from cassandra_tpu_torch.storage.engine import StorageEngine
    schema = Schema()
    schema.create_keyspace("chaos")
    t = make_table("chaos", "t", pk=["id"], ck=["c"],
                   cols={"id": "int", "c": "int", "v": "text"})
    schema.add_table(t)
    settings = Settings(Config.load({
        "disk_failure_policy": "best_effort",
        "commit_failure_policy": commit_policy}))
    eng = StorageEngine(base_dir, schema, commitlog_sync="batch",
                        settings=settings, device=device)
    return eng, t


def _put(eng, t, pk, c, v, ts):
    from cassandra_tpu_torch.schema import COL_ROW_LIVENESS
    from cassandra_tpu_torch.storage.mutation import Mutation
    m = Mutation(t.id, t.columns["id"].cql_type.serialize(pk))
    ck = t.serialize_clustering([c])
    m.add(ck, COL_ROW_LIVENESS, b"", b"", ts)
    m.add(ck, t.columns["v"].column_id, b"",
          t.columns["v"].cql_type.serialize(v), ts)
    eng.apply(m)


def _read_values(eng, t, pk):
    """{clustering c: v} of one partition through the live read path."""
    from cassandra_tpu_torch.storage.rows import row_to_dict, rows_from_batch
    cfs = eng.store("chaos", "t")
    batch = cfs.read_partition(t.columns["id"].cql_type.serialize(pk))
    out = {}
    for r in rows_from_batch(t, batch):
        d = row_to_dict(t, r)
        out[d["c"]] = d["v"]
    return out


def run_drill(base_dir: str, device=None) -> list[str]:
    """Run every drill; returns human-readable violations (empty=pass).
    Every fault point is disarmed on the way out, however it ends."""
    from cassandra_tpu_torch.utils import faultfs

    try:
        return _drills(base_dir, device)
    finally:
        faultfs.disarm()


def _drills(base_dir: str, device) -> list[str]:
    from cassandra_tpu_torch.service.metrics import GLOBAL as METRICS
    from cassandra_tpu_torch.tools import nodetool
    from cassandra_tpu_torch.utils import faultfs

    errs: list[str] = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    # ---------------------------------------------- drill 1+2: bit flip
    eng, t = _build(os.path.join(base_dir, "n1"), device=device)
    cfs = eng.store("chaos", "t")
    # round 0: every pk, flushed → sstable A; round 1: half the pks
    # overwritten, flushed → sstable B. Corrupting B loses only the
    # round-1 versions; every pk still has a round-0 copy in A.
    for i in range(N_PKS):
        _put(eng, t, i, 0, f"r0-{i}", TS0 + i)
    cfs.flush()
    for i in range(0, N_PKS, 2):
        _put(eng, t, i, 0, f"r1-{i}", TS0 + 10_000 + i)
    cfs.flush()
    gens = [s.desc.generation for s in cfs.live_sstables()]
    bad = gens[1]
    expected_after_loss = {i: (f"r0-{i}") for i in range(N_PKS)}
    healthy_view = {i: _read_values(eng, t, i) for i in range(N_PKS)}
    need(all(healthy_view[i].get(0) == (f"r1-{i}" if i % 2 == 0
                                        else f"r0-{i}")
             for i in range(N_PKS)), "pre-fault reads wrong")

    from cassandra_tpu_torch.storage.chunk_cache import GLOBAL as chunks
    chunks.clear()   # force the next read back to disk
    c0 = METRICS.counter("storage.corruption_detected")
    faultfs.arm("sstable.read", "bitflip",
                path_substr=f"-{bad}-Data.db")
    # a read touching the corrupt sstable (even pk: bloom-positive in
    # B) trips the fault, quarantines B and STILL succeeds, re-served
    # best-effort from A
    v_even = _read_values(eng, t, 0)
    # an unaffected partition (odd pk: only in sstable A) succeeds too
    v_odd = _read_values(eng, t, 1)
    faultfs.disarm()
    need(v_even.get(0) == "r0-0",
         f"best_effort read of affected partition failed: {v_even}")
    need(v_odd.get(0) == "r0-1",
         f"best_effort read of unaffected partition failed: {v_odd}")
    need(METRICS.counter("storage.corruption_detected") == c0 + 1,
         "storage.corruption_detected did not increment")
    vt = eng.virtual_tables.get("system_views", "quarantined_sstables")
    need([r["generation"] for r in vt.rows()] == [bad],
         "quarantined_sstables vtable missing the corrupt generation")
    need(bad not in [s.desc.generation for s in cfs.live_sstables()],
         "corrupt sstable still in the live set")

    # next compaction round plans without the quarantined input
    from cassandra_tpu_torch.compaction.strategies import get_strategy
    task = get_strategy(cfs).major_task()
    if task is not None:
        need(bad not in {r.desc.generation for r in task.inputs},
             "compaction planned OVER the quarantined sstable")

    # loss accounting: every row not covered by the injected loss reads
    # back (round-1 overwrites regress to their round-0 copies — the
    # documented best_effort obsolete-read trade)
    for i in range(N_PKS):
        got = _read_values(eng, t, i).get(0)
        need(got == expected_after_loss[i],
             f"pk {i}: post-loss read {got!r} != "
             f"{expected_after_loss[i]!r}")

    # scrub (snapshot-before-scrub) + re-read: the surviving set stays
    # internally consistent
    rep = nodetool.scrub(eng, "chaos", "t", quarantine=True)
    need(any(r.get("snapshot") for r in rep), "scrub took no snapshot")
    for i in range(N_PKS):
        got = _read_values(eng, t, i).get(0)
        need(got == expected_after_loss[i],
             f"pk {i}: post-scrub read {got!r} != "
             f"{expected_after_loss[i]!r}")
    eng.close()

    # -------------------------------------------- drill 3: flush EIO
    eng, t = _build(os.path.join(base_dir, "n2"), device=device)
    cfs = eng.store("chaos", "t")
    for i in range(N_PKS):
        _put(eng, t, i, 0, f"m-{i}", TS0 + i)
    d0 = METRICS.counter("storage.disk_failures")
    faultfs.arm("flush.write", "error")
    try:
        cfs.flush()
        need(False, "flush under EIO did not fail")
    except OSError:
        pass
    faultfs.disarm()
    need(METRICS.counter("storage.disk_failures") > d0,
         "storage.disk_failures did not increment on flush EIO")
    need(cfs.live_sstables() == [],
         "failed flush leaked an sstable into the live set")
    need(_read_values(eng, t, 5).get(0) == "m-5",
         "memtable unreadable after failed flush")
    r = cfs.flush()
    need(r is not None and r.n_cells > 0, "retry flush failed")
    need(_read_values(eng, t, 5).get(0) == "m-5",
         "row lost across failed-then-retried flush")

    # -------------------------------------------- drill 4: torn write
    for i in range(N_PKS):
        _put(eng, t, i, 1, f"torn-{i}", TS0 + 50_000 + i)
    live0 = [s.desc.generation for s in cfs.live_sstables()]
    faultfs.arm("flush.write", "torn_write", tear_bytes=128)
    try:
        cfs.flush()
        need(False, "flush under torn write did not fail")
    except OSError:
        pass
    faultfs.disarm()
    need([s.desc.generation for s in cfs.live_sstables()] == live0,
         "torn write changed the live set")
    need(cfs.flush() is not None, "flush retry after tear failed")
    need(_read_values(eng, t, 5).get(1) == "torn-5",
         "row lost across torn-write flush")
    eng.close()

    # ------------------------------- drill 5: commitlog EIO stop_commit
    eng, t = _build(os.path.join(base_dir, "n3"),
                    commit_policy="stop_commit", device=device)
    _put(eng, t, 1, 0, "pre", TS0)
    faultfs.arm("commitlog.fsync", "error", times=1)
    try:
        _put(eng, t, 1, 1, "doomed", TS0 + 1)
        need(False, "write under commitlog EIO did not fail")
    except OSError:
        pass
    faultfs.disarm()
    from cassandra_tpu_torch.storage.failures import CommitLogStoppedError
    need(eng.failures.commits_stopped,
         "stop_commit did not latch after commitlog failure")
    try:
        _put(eng, t, 1, 2, "refused", TS0 + 2)
        need(False, "stop_commit accepted a write")
    except CommitLogStoppedError:
        pass
    need(_read_values(eng, t, 1).get(0) == "pre",
         "reads stopped serving under stop_commit")
    eng.close()

    need(not faultfs.GLOBAL.active,
         "fault points left armed at drill end")
    return errs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.chaos_storage")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engines (default cuda)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="ctpu-chaos-") as d:
        errs = run_drill(d, device=args.device)
    for msg in errs:
        print(msg, file=sys.stderr)
    if errs:
        print(f"FAIL: {len(errs)} violation(s)", file=sys.stderr)
        return 1
    print("storage chaos drill: all policies held (quarantine + "
          "best-effort reads, flush EIO/tear recovery, stop_commit)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
