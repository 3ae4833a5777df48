"""CI check: analytical scan A/B — the same mixed fixture queried
through four legs must return IDENTICAL rows for every query:

  naive      the materializing Python scan (pushdown shadowed out —
             the reference semantics)
  device     zone-map pruning + the scan mask and fold kernels (K9)
             on the resolved torch device (`scan_device_filter` on,
             mesh off)
  mesh2      the same lane with Phase-A discovery fanned across two
             mesh shards
  host       the lane with the per-segment numpy reference kernels
             (`scan_device_filter` off — the fallback leg)

The fixture deliberately mixes everything the key-space lane must not
change: tombstones at every scope (cell/row/partition/range), TTL
cells already expired at query time, static columns, text prefixes
(superset keys re-verified by the executor), doubles, booleans, IN
lists and memtable-only rows. Aggregate shapes (count/min/max/sum/avg)
ride the same legs.

The naive leg shadows the store's pushdown entry points with ones
that raise `device_scan.ScanKeyError`, the one error the executor hands
to the Python path (any other error of the lane reaches the caller).
A caller that passes a dict as `launches` gets each leg's launches of
the hand-written kernels in it, by kernel (none on the CPU).

    python -m cassandra_tpu_torch.scripts.check_scan_ab [--device cpu]

Exit 0 on zero divergence, 1 with a line per divergence.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def _build(session) -> None:
    s = session
    s.execute("CREATE KEYSPACE ab WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE ab")
    s.execute("CREATE TABLE t (k int, c int, v int, d double, "
              "b boolean, txt text, st text static, "
              "PRIMARY KEY (k, c))")


def _workload(session, engine) -> None:
    """Three flush rounds + a memtable tail, deletes at every scope."""
    s = session
    cfs = engine.store("ab", "t")
    words = ["alpha", "beta", "gamma", "delta"]
    for k in range(16):
        s.execute(f"UPDATE t SET st = 'g{k % 3}' WHERE k = {k}")
        for c in range(4):
            i = k * 4 + c
            s.execute(
                f"INSERT INTO t (k, c, v, d, b, txt) VALUES "
                f"({k}, {c}, {i % 11}, {i * 0.5}, "
                f"{'true' if i % 3 == 0 else 'false'}, "
                f"'{words[i % 4]}-{i}')")
    cfs.flush()
    # overwrites + deletes at every scope
    for k in range(0, 16, 2):
        s.execute(f"INSERT INTO t (k, c, v) VALUES ({k}, 0, {k})")
    s.execute("DELETE FROM t WHERE k = 2")             # partition
    s.execute("DELETE FROM t WHERE k = 3 AND c = 1")   # row
    s.execute("DELETE v FROM t WHERE k = 4 AND c = 2")  # cell
    s.execute("DELETE FROM t WHERE k = 5 AND c > 1")   # range
    cfs.flush()
    # TTL cells that are ALREADY EXPIRED when the legs run (flushed
    # live, reconciled dead — the zone maps still count them live)
    s.execute("INSERT INTO t (k, c, v) VALUES (6, 9, 3) USING TTL 1")
    s.execute("INSERT INTO t (k, c, v) VALUES (20, 0, 3) USING TTL 1")
    cfs.flush()
    time.sleep(1.2)
    # memtable-only tail: no zone maps, coordinator-scanned
    s.execute("INSERT INTO t (k, c, v, txt) VALUES (17, 0, 3, "
              "'alpha-999')")
    s.execute("DELETE FROM t WHERE k = 7 AND c = 0")


def _queries() -> list[str]:
    return [
        "SELECT k, c, v FROM t WHERE v = 3 ALLOW FILTERING",
        "SELECT k, c, v FROM t WHERE v != 3 ALLOW FILTERING",
        "SELECT k, c, v FROM t WHERE v < 2 ALLOW FILTERING",
        "SELECT k, c, v FROM t WHERE v >= 9 ALLOW FILTERING",
        "SELECT k, c, v FROM t WHERE v IN (1, 5, 10) ALLOW FILTERING",
        "SELECT k, c, d FROM t WHERE d > 25.0 ALLOW FILTERING",
        "SELECT k, c, b FROM t WHERE b = true ALLOW FILTERING",
        "SELECT k, c, txt FROM t WHERE txt = 'alpha-999' "
        "ALLOW FILTERING",
        "SELECT k, c FROM t WHERE st = 'g1' ALLOW FILTERING",
        "SELECT k, c, v FROM t WHERE v = 3 AND c = 0 ALLOW FILTERING",
        "SELECT count(*) FROM t WHERE v = 3 ALLOW FILTERING",
        "SELECT count(v), min(v), max(v), sum(v), avg(v) FROM t "
        "WHERE v IN (2, 7) ALLOW FILTERING",
        "SELECT count(*) FROM t WHERE v = 99 ALLOW FILTERING",
    ]


def _refuse(*_a, **_kw):
    from cassandra_tpu_torch.ops import device_scan as ds
    raise ds.ScanKeyError("naive leg: the lane is shadowed off")


def _run_leg(session, engine, leg: str) -> list:
    cfs = engine.store("ab", "t")
    if leg == "naive":
        # shadow the lane off: the executor's pushdown attempt raises
        # the key error it hands to the Python path, and the
        # materializing Python scan answers
        cfs.scan_filtered = _refuse
        cfs.scan_filtered_aggregate = _refuse
    else:
        cfs.__dict__.pop("scan_filtered", None)
        cfs.__dict__.pop("scan_filtered_aggregate", None)
        engine.settings.set("scan_device_filter", leg != "host")
        engine.settings.set("compaction_mesh_devices",
                            2 if leg == "mesh2" else 0)
    try:
        out = []
        for q in _queries():
            rs = session.execute(q)
            out.append((q, sorted(map(repr, rs.rows))))
        return out
    finally:
        cfs.__dict__.pop("scan_filtered", None)
        cfs.__dict__.pop("scan_filtered_aggregate", None)


LEGS = ("naive", "device", "mesh2", "host")


def run_check(base_dir: str, device=None,
              launches: dict | None = None) -> list[str]:
    """Build the fixture once, run all four legs, return human-readable
    divergences (empty = pass)."""
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.ops import cuda_lib
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine

    engine = StorageEngine(os.path.join(base_dir, "ab"), Schema(),
                           commitlog_sync="batch", device=device)
    prev_dev = engine.settings.get("scan_device_filter")
    prev_mesh = engine.settings.get("compaction_mesh_devices")
    try:
        session = Session(engine)
        _build(session)
        _workload(session, engine)
        assert len(engine.store("ab", "t").live_sstables()) >= 3
        legs = {}
        for leg in LEGS:
            before = cuda_lib.launches()
            legs[leg] = _run_leg(session, engine, leg)
            if launches is not None:
                after = cuda_lib.launches()
                launches[leg] = {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}
        diverged = []
        for i, (q, ref) in enumerate(legs["naive"]):
            for leg in ("device", "mesh2", "host"):
                got = legs[leg][i][1]
                if got != ref:
                    diverged.append(
                        f"{leg} diverged on {q!r}:\n"
                        f"  naive: {ref}\n  {leg}: {got}")
        return diverged
    finally:
        engine.settings.set("scan_device_filter", prev_dev)
        engine.settings.set("compaction_mesh_devices", prev_mesh)
        engine.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.check_scan_ab")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="ctpu-scan-ab-") as d:
        diverged = run_check(d, device=args.device)
    for msg in diverged:
        print(msg, file=sys.stderr)
    if diverged:
        print(f"FAIL: {len(diverged)} diverging leg/quer"
              f"{'y' if len(diverged) == 1 else 'ies'}", file=sys.stderr)
        return 1
    print("scan A/B: all legs identical "
          "(naive == device == mesh2 == host)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
