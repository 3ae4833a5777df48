"""CI check: read-path fast lane A/B — the same fixture workload queried
with CTPU_READ_FASTPATH=0 (naive every-sstable collation) and =1
(timestamp-skip collation + batched multi-partition reads + row cache)
must return IDENTICAL results for every query.

The workload deliberately exercises every case the skip rule must NOT
break: overlapping overwrites across sstables, partition deletions
followed by re-inserts (the skip trigger), row deletions, range
tombstones, TTL cells, static columns, multi-row partitions spread over
4+ flushed sstables plus live memtable writes, and IN (...)
multi-partition reads (the batched gather leg).

The engine runs on `device` (`cuda` by default, which raises without
a card; `cpu` runs the kernels' plain PyTorch versions).

    python -m cassandra_tpu_torch.scripts.check_readpath_ab [--device cpu]

Exit 0 on zero divergence, 1 with a line per divergence.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


N_PKS = 12


def _build(session) -> None:
    s = session
    s.execute("CREATE KEYSPACE ab WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE ab")
    s.execute("CREATE TABLE t (k int, c int, v text, st text static, "
              "PRIMARY KEY (k, c))")
    s.execute("CREATE TABLE cached (k int, c int, v text, "
              "PRIMARY KEY (k, c)) WITH caching = "
              "{'keys': 'ALL', 'rows_per_partition': 'ALL'}")


def _workload(session, engine) -> None:
    """Four flush rounds + trailing memtable writes."""
    s = session
    t_cfs = engine.store("ab", "t")
    c_cfs = engine.store("ab", "cached")
    # round 0: base rows everywhere
    for k in range(N_PKS):
        s.execute(f"UPDATE t SET st = 's{k}' WHERE k = {k}")
        for c in range(6):
            s.execute(f"INSERT INTO t (k, c, v) VALUES ({k}, {c}, "
                      f"'r0-{k}-{c}')")
            s.execute(f"INSERT INTO cached (k, c, v) VALUES ({k}, {c}, "
                      f"'r0-{k}-{c}')")
    t_cfs.flush()
    c_cfs.flush()
    # round 1: overwrite half the rows, delete rows/partitions/ranges
    for k in range(N_PKS):
        for c in range(0, 6, 2):
            s.execute(f"INSERT INTO t (k, c, v) VALUES ({k}, {c}, "
                      f"'r1-{k}-{c}')")
    s.execute("DELETE FROM t WHERE k = 2")            # partition delete
    s.execute("DELETE FROM t WHERE k = 3 AND c = 1")  # row delete
    s.execute("DELETE FROM t WHERE k = 4 AND c > 3")  # range tombstone
    t_cfs.flush()
    # round 2: re-insert over the deleted partition (newer timestamps),
    # TTL cells (long TTL: liveness must not flip between the A/B legs)
    for c in range(3):
        s.execute(f"INSERT INTO t (k, c, v) VALUES (2, {c}, 'r2-2-{c}')")
    s.execute("INSERT INTO t (k, c, v) VALUES (5, 99, 'ttl') "
              "USING TTL 3600")
    t_cfs.flush()
    # round 3: another full partition supersede (delete + rewrite) —
    # the freshest-wins shape the skip rule fires on
    s.execute("DELETE FROM t WHERE k = 6")
    for c in range(4):
        s.execute(f"INSERT INTO t (k, c, v) VALUES (6, {c}, 'r3-6-{c}')")
    t_cfs.flush()
    # memtable-only tail: never flushed
    s.execute("INSERT INTO t (k, c, v) VALUES (7, 50, 'mem')")
    s.execute("DELETE FROM t WHERE k = 8 AND c = 0")


def _queries() -> list[str]:
    in_list = ", ".join(str(k) for k in range(N_PKS))
    qs = []
    for k in range(N_PKS):
        qs.append(f"SELECT k, c, v, st FROM t WHERE k = {k}")
    qs += [
        f"SELECT k, c, v FROM t WHERE k IN ({in_list})",
        "SELECT k, c, v FROM t WHERE k IN (2, 6, 9) AND c < 3",
        "SELECT k, c, v FROM t WHERE k = 1 LIMIT 3",
        "SELECT k, c, v FROM t WHERE k IN (0, 1, 5) LIMIT 7",
        "SELECT k, c, writetime(v) FROM t WHERE k = 9",
        "SELECT count(*) FROM t WHERE k IN (2, 3, 4)",
        f"SELECT k, c, v FROM cached WHERE k IN ({in_list})",
        "SELECT k, c, v FROM cached WHERE k = 3",
    ]
    return qs


def _run_leg(session, engine, fastpath: bool) -> list:
    os.environ["CTPU_READ_FASTPATH"] = "1" if fastpath else "0"
    # results cached by the OTHER leg must not mask a divergence
    from cassandra_tpu_torch.storage.row_cache import GLOBAL as row_cache
    row_cache.clear()
    out = []
    for q in _queries():
        rs = session.execute(q)
        out.append((q, sorted(map(repr, rs.rows))))
    return out


def run_check(base_dir: str, device=None) -> list[str]:
    """Build the fixture once, query it under both modes, return a list
    of human-readable divergences (empty = pass)."""
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine

    prev = os.environ.get("CTPU_READ_FASTPATH")
    engine = StorageEngine(os.path.join(base_dir, "ab"), Schema(),
                           commitlog_sync="batch", device=device)
    try:
        session = Session(engine)
        _build(session)
        _workload(session, engine)
        assert len(engine.store("ab", "t").live_sstables()) >= 4
        naive = _run_leg(session, engine, fastpath=False)
        fast = _run_leg(session, engine, fastpath=True)
        # second fastpath leg WITHOUT clearing the row cache: cached
        # entries must replay the same results
        os.environ["CTPU_READ_FASTPATH"] = "1"
        cached = []
        for q in _queries():
            cached.append((q, sorted(map(repr,
                                         session.execute(q).rows))))
        diverged = []
        for (q, a), (_, b), (_, c) in zip(naive, fast, cached):
            if a != b:
                diverged.append(f"fastpath diverged on {q!r}:\n"
                                f"  naive:    {a}\n  fastpath: {b}")
            elif a != c:
                diverged.append(f"row-cache replay diverged on {q!r}:\n"
                                f"  naive:  {a}\n  cached: {c}")
        return diverged
    finally:
        if prev is None:
            os.environ.pop("CTPU_READ_FASTPATH", None)
        else:
            os.environ["CTPU_READ_FASTPATH"] = prev
        engine.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.check_readpath_ab")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="ctpu-readpath-ab-") as d:
        diverged = run_check(d, device=args.device)
    for msg in diverged:
        print(msg, file=sys.stderr)
    if diverged:
        print(f"FAIL: {len(diverged)} diverging quer"
              f"{'y' if len(diverged) == 1 else 'ies'}", file=sys.stderr)
        return 1
    print("readpath A/B: all queries identical (fastpath == naive)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
