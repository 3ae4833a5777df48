"""CI check (tier-2): the workload observatory — retained metrics
history, per-table amplification accounting, cluster-wide telemetry
(docs/observability.md layer 5).

Leg 1 (engine): a deterministic engine run (3 flushed generations +
a major compaction, on-demand history samples between phases) must
leave

  - `system_views.metrics_history` populated (raw rows for
    `storage.writes` and the per-table counters, non-negative derived
    rates, coarse rows after enough raw samples);
  - the WA/SA gauges arithmetically reconciled against the run's
    ACTUAL byte counters: write_amplification ==
    (bytes_flushed + bytes_compacted_out) / bytes_ingested from the
    same `cfs.metrics` dict, space_amplification == live partition
    instances / distinct partitions recomputed from the live
    sstables' partition-token directories (1.0 after the major
    compaction);
  - `nodetool tablestats` / `tablehistograms` carrying the new
    blocks, `compaction_history` bounded by its knob (newest kept),
    and an on-demand flight-recorder bundle carrying a non-empty
    `metrics_history` window plus the `pipeline_ledger` table.

Leg 2 (cluster): `nodetool clusterstats` over a 3-node RF=3
LocalCluster returns one row per node with fresh peer snapshots; after
one node goes dark the pull STILL returns within its bound (no hang on
the messaging dispatch worker), the dark node's row carries its last
known snapshot with a staleness stamp, and the coordinator still
serves traffic afterwards.

The engines (the cluster's nodes too) run on `device` (`cuda` by
default, which raises without a card; `cpu` runs the kernels' plain
PyTorch versions).

    python -m cassandra_tpu_torch.scripts.check_observatory [--device cpu]

Exit 0 = clean; exit 1 prints each violation.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np


def _recompute_sa(cfs) -> float:
    live = cfs.live_sstables()
    total = sum(s.n_partitions for s in live)
    if total == 0:
        return 1.0
    toks = np.concatenate([np.asarray(s.partition_tokens)
                           for s in live if s.n_partitions > 0])
    return total / max(len(np.unique(toks)), 1)


def check_engine_leg(base_dir: str, device=None) -> list[str]:
    from cassandra_tpu_torch.config import Config, Settings
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.service import diagnostics
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.tools import nodetool

    errs: list[str] = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    settings = Settings(Config.load({"compaction_history_entries": 2,
                                     "compaction_throughput": 0}))
    eng = StorageEngine(base_dir, Schema(), commitlog_sync="batch",
                        settings=settings, device=device)
    try:
        s = Session(eng)
        s.execute("CREATE KEYSPACE obs WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 1}")
        s.execute("USE obs")
        s.execute("CREATE TABLE t (k int PRIMARY KEY, v text)")
        cfs = eng.store("obs", "t")
        svc = eng.metrics_history
        need(not svc.enabled,
             "sampler thread running with the knob off (zero-cost rule)")
        for gen in range(3):
            for i in range(48):
                s.execute(f"INSERT INTO t (k, v) VALUES ({i}, "
                          f"'g{gen}-{i}')")
            cfs.flush()
            svc.sample()
        # 3 overlapping generations: SA must read the overlap
        sa_overlapped = cfs.amplification()["space_amplification"]
        need(sa_overlapped > 1.5,
             f"3 full-overlap generations read SA {sa_overlapped}")
        stats = eng.compactions.major_compaction(cfs)
        need(stats is not None and stats["inputs"] == 3,
             f"major compaction saw {stats and stats['inputs']} inputs")
        svc.sample()

        # --- WA/SA reconcile EXACTLY against the run's own counters
        m = cfs.metrics
        amp = cfs.amplification()
        need(m["bytes_ingested"] > 0 and m["bytes_flushed"] > 0
             and m["bytes_compacted_in"] > 0
             and m["bytes_compacted_out"] > 0,
             f"byte counters not all populated: {m}")
        need(m["bytes_compacted_in"] == stats["bytes_read"]
             and m["bytes_compacted_out"] == stats["bytes_written"],
             "compaction byte counters diverge from the task stats")
        wa = (m["bytes_flushed"] + m["bytes_compacted_out"]) \
            / m["bytes_ingested"]
        need(amp["write_amplification"] == round(wa, 6),
             f"WA gauge {amp['write_amplification']} != recomputed "
             f"{round(wa, 6)}")
        sa = _recompute_sa(cfs)
        need(amp["space_amplification"] == round(sa, 6),
             f"SA gauge {amp['space_amplification']} != recomputed "
             f"{round(sa, 6)}")
        need(amp["space_amplification"] == 1.0,
             f"post-major-compaction SA {amp['space_amplification']}"
             " != 1.0")

        # --- history vtable populated; rates sane
        vt = eng.virtual_tables.get("system_views", "metrics_history")
        rows = vt.rows()
        need(rows, "metrics_history vtable is empty after samples")
        writes_rows = [r for r in rows
                       if r["name"] == "table.obs.t.writes"
                       and r["resolution"] == "raw"]
        need(len(writes_rows) == 4,
             f"expected 4 raw samples of table.obs.t.writes, got "
             f"{len(writes_rows)}")
        need(all(r["rate_per_s"] >= 0.0 for r in rows),
             "negative derived rate in metrics_history")
        need(writes_rows[-1]["last"] == 144.0,
             f"history last writes sample {writes_rows[-1]['last']}"
             " != 144")

        # --- nodetool surfaces
        ts = nodetool.tablestats(eng)["obs.t"]
        for key in ("write_amplification", "space_amplification",
                    "bytes_ingested", "bytes_compacted_out"):
            need(key in ts, f"tablestats lacks {key}")
        th = nodetool.tablehistograms(eng, "obs", "t")["obs.t"]
        need("read_latency" in th and "sstables_per_read" in th,
             f"tablehistograms lacks the hist block: {sorted(th)}")
        mh = nodetool.metricshistory(eng, name="table.obs.t.writes",
                                     rate=True)
        need(len(mh["buckets"]) == 4,
             "nodetool metricshistory bucket count wrong")

        # --- compaction_history bounded, newest kept
        for i in range(4):
            cfs.compaction_history.append({"marker": i})
        need(len(cfs.compaction_history) == 2
             and list(cfs.compaction_history)[-1]["marker"] == 3,
             "compaction_history not bounded newest-kept at knob=2")
        settings.set("compaction_history_entries", 1)
        need(len(cfs.compaction_history) == 1,
             "compaction_history_entries hot-set did not rebind")

        # --- bundle carries the history window + ledger table
        import json as _json
        path = eng.flight_recorder.dump("observatory_check")
        with open(path) as fh:
            bundle = _json.load(fh)
        win = bundle.get("metrics_history", {})
        need(bool(win) and any(win.values()),
             "bundle metrics_history window empty")
        need("pipeline_ledger" in bundle,
             "bundle lacks pipeline_ledger")
    finally:
        eng.close()
        diagnostics.GLOBAL.reset()
    return errs


def check_cluster_leg(base_dir: str, device=None) -> list[str]:
    from cassandra_tpu_torch.cluster.node import LocalCluster
    from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
    from cassandra_tpu_torch.tools import nodetool

    errs: list[str] = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    c = LocalCluster(3, base_dir, rf=3, device=device)
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        s.execute("CREATE TABLE ks.t (k int PRIMARY KEY, v text)")
        c.node(1).default_cl = ConsistencyLevel.ALL
        s.keyspace = "ks"
        for i in range(24):
            s.execute(f"INSERT INTO ks.t (k, v) VALUES ({i}, 'v{i}')")
        cs = nodetool.clusterstats(c.node(1), timeout=2.0)
        need(len(cs["nodes"]) == 3,
             f"clusterstats rows {len(cs['nodes'])} != 3")
        need(cs["keyspaces"].get("ks", {}).get("rf") == 3,
             "clusterstats not RF-aware for ks")
        by_ep = {r["endpoint"]: r for r in cs["nodes"]}
        need(all(r["fresh"] and r["snapshot"] is not None
                 for r in cs["nodes"]),
             "healthy cluster pull returned stale/absent snapshots")
        need(by_ep["node2"]["snapshot"]["tables"]
             .get("ks.t", {}).get("writes", 0) >= 24,
             "peer snapshot lacks replica write counts")
        # --- dark node: bounded pull, staleness stamp, no hang
        c.stop_node(3)
        t0 = time.monotonic()
        cs2 = nodetool.clusterstats(c.node(1), timeout=1.0)
        took = time.monotonic() - t0
        need(took < 5.0, f"pull with a dark node took {took:.1f}s")
        row3 = {r["endpoint"]: r for r in cs2["nodes"]}["node3"]
        need(row3["fresh"] is False,
             "dark node reported a fresh snapshot")
        need(row3["snapshot"] is not None
             and row3["stale_s"] is not None and row3["stale_s"] > 0,
             "dark node lost its last-known snapshot/staleness stamp")
        # the dispatch worker survived: the coordinator still serves
        # (QUORUM — 2 of 3 replicas are up)
        c.node(1).default_cl = ConsistencyLevel.QUORUM
        rs = s.execute("SELECT v FROM ks.t WHERE k = 1")
        need(len(list(rs)) == 1,
             "coordinator stopped serving after the dark-node pull")
    finally:
        c.shutdown()
    return errs


def run_check(base_dir: str, device=None) -> list[str]:
    errs = check_engine_leg(os.path.join(base_dir, "engine"), device)
    errs += check_cluster_leg(os.path.join(base_dir, "cluster"), device)
    return errs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.check_observatory")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engines (default cuda)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        errs = run_check(d, device=args.device)
    if errs:
        print("check_observatory: FAIL", file=sys.stderr)
        for e in errs:
            print(f"  - {e}", file=sys.stderr)
        return 1
    print("check_observatory: history rings, WA/SA reconciliation and "
          "cluster telemetry OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
