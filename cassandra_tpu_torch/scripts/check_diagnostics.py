"""CI check (tier-2, alongside chaos_storage.py): the flight recorder
produces a well-formed post-incident bundle when a failure policy fires.

Drill: a node with `disk_failure_policy=stop` and the diagnostic event
bus enabled takes writes, flushes, compacts and hot-reloads a knob (the
"seconds before" every real incident has), then an EIO is injected at
the `flush.write` fault point. The policy takes the node out of service
— and the flight recorder must dump a bundle, automatically, that a
post-mortem can actually use:

  - the `failure.policy` diagnostic event for the injected EIO;
  - the PRECEDING diagnostic events (flush / compaction / config
    reload) in publication order before it;
  - a metrics snapshot including the storage.disk_failures count;
  - tpstats rows;
  - the failure handler's recent-error tail and terminal state.

A second leg checks the on-demand path (`nodetool flightrecorder`) and
that the quarantine trigger dumps too.

chaos_storage.py runs beside this check in CI: its drills must still
end in their policy-mandated states — this script only ADDS the
black-box assertion, it changes none of the failure semantics.

The engines run on `device` (`cuda` by default, which raises without
a card; `cpu` runs the kernels' plain PyTorch versions).

    python -m cassandra_tpu_torch.scripts.check_diagnostics [--device cpu]

Exit 0 = clean; exit 1 prints each violation.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


N_PKS = 24
TS0 = 1_000_000


def _build(base_dir: str, device=None):
    from cassandra_tpu_torch.config import Config, Settings
    from cassandra_tpu_torch.schema import Schema, make_table
    from cassandra_tpu_torch.storage.engine import StorageEngine
    schema = Schema()
    schema.create_keyspace("diag")
    t = make_table("diag", "t", pk=["id"], ck=["c"],
                   cols={"id": "int", "c": "int", "v": "text"})
    schema.add_table(t)
    settings = Settings(Config.load({
        "disk_failure_policy": "stop",
        "diagnostic_events_enabled": True}))
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


def run_check(base_dir: str, device=None) -> list[str]:
    """Returns human-readable violations (empty = pass)."""
    from cassandra_tpu_torch.service import diagnostics
    from cassandra_tpu_torch.storage.failures import StorageStoppedError
    from cassandra_tpu_torch.utils import faultfs

    errs: list[str] = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    diagnostics.GLOBAL.clear()
    eng, t = _build(os.path.join(base_dir, "n1"), device)
    cfs = eng.store("diag", "t")
    try:
        # --- the run-up: flushes, a compaction, a hot knob reload —
        # the context the bundle must carry
        for i in range(N_PKS):
            _put(eng, t, i, 0, f"r0-{i}", TS0 + i)
        cfs.flush()
        for i in range(N_PKS):
            _put(eng, t, i, 0, f"r1-{i}", TS0 + 10_000 + i)
        cfs.flush()
        eng.compactions.major_compaction(cfs)
        eng.settings.set("concurrent_compactors", 2)
        pre_types = {e.type for e in diagnostics.GLOBAL.events()}
        for expect in ("flush", "compaction.start", "compaction.finish",
                       "config.reload"):
            need(expect in pre_types,
                 f"run-up did not publish {expect!r} "
                 f"(got {sorted(pre_types)})")

        # --- the incident: EIO at the flush.write checkpoint under
        # disk_failure_policy=stop
        for i in range(N_PKS):
            _put(eng, t, i, 1, f"r2-{i}", TS0 + 20_000 + i)
        faultfs.arm("flush.write", "error", times=1)
        try:
            try:
                cfs.flush()
                errs.append("injected flush EIO did not raise")
            except OSError:
                pass
        finally:
            faultfs.disarm("flush.write")

        need(eng.failures.storage_stopped,
             "disk_failure_policy=stop did not stop storage")
        try:
            _put(eng, t, 0, 9, "post", TS0 + 99_999)
            errs.append("stopped node accepted a write")
        except StorageStoppedError:
            pass

        # --- the bundle
        dumps = list(eng.flight_recorder.dumps)
        need(len(dumps) >= 1,
             "failure policy `stop` produced no flight-recorder dump")
        if not dumps:
            return errs
        path = dumps[-1]
        need(os.path.exists(path), f"bundle path missing: {path}")
        with open(path) as f:
            bundle = json.load(f)   # malformed JSON raises -> violation
        need(bundle["reason"] == "failure_policy_stop",
             f"bundle reason {bundle.get('reason')!r} != "
             f"failure_policy_stop")
        ev_types = [e["type"] for e in bundle.get("events", [])]
        need("failure.policy" in ev_types,
             f"bundle lacks the failure.policy event ({ev_types})")
        if "failure.policy" in ev_types:
            fail_idx = ev_types.index("failure.policy")
            preceding = set(ev_types[:fail_idx])
            for expect in ("flush", "compaction.start",
                           "compaction.finish", "config.reload"):
                need(expect in preceding,
                     f"bundle lacks preceding {expect!r} event "
                     f"before the failure ({sorted(preceding)})")
            fev = bundle["events"][fail_idx]
            need(fev.get("policy") == "stop",
                 f"failure event policy {fev.get('policy')!r}")
        metrics = bundle.get("final", {}).get("metrics", {})
        need(metrics.get("storage.disk_failures", 0) >= 1,
             "bundle metrics snapshot lacks storage.disk_failures")
        need(metrics.get("storage.writes", 0) >= N_PKS,
             "bundle metrics snapshot lacks storage.writes")
        tp = bundle.get("final", {}).get("tpstats", [])
        need(any(p.get("pool") == "CompactionExecutor" for p in tp),
             f"bundle tpstats malformed: {tp}")
        need(any(r.get("kind") == "disk"
                 for r in bundle.get("recent_errors", [])),
             "bundle lacks the recent-error tail")
        need(bundle.get("failure_state", {}).get("storage_stopped")
             is True, "bundle failure_state not terminal")
        need(any(s.get("name") == "disk_failure_policy"
                 and s.get("value") == "stop"
                 for s in bundle.get("settings", [])),
             "bundle settings do not carry disk_failure_policy=stop")
    finally:
        eng.close()

    # --- leg 2: quarantine + on-demand dumps on a healthy node
    from cassandra_tpu_torch.tools import nodetool
    eng2, t2 = _build(os.path.join(base_dir, "n2"), device)
    try:
        eng2.settings.set("disk_failure_policy", "best_effort")
        cfs2 = eng2.store("diag", "t")
        for i in range(N_PKS):
            _put(eng2, t2, i, 0, f"a-{i}", TS0 + i)
        cfs2.flush()
        out = nodetool.flightrecorder(eng2)
        need(os.path.exists(out["bundle"]),
             "on-demand flightrecorder dump missing")
        with open(out["bundle"]) as f:
            b2 = json.load(f)
        need(b2["reason"] == "on_demand", "on-demand reason wrong")
        # corrupt the flushed sstable -> best_effort quarantine ->
        # automatic bundle
        sst = cfs2.live_sstables()[0]
        data = sst.desc.path("Data.db")
        with open(data, "r+b") as f:
            f.seek(64)
            byte = f.read(1)
            f.seek(64)
            f.write(bytes([byte[0] ^ 0xFF]))
        from cassandra_tpu_torch.storage import chunk_cache
        from cassandra_tpu_torch.storage.sstable.reader import \
            CorruptSSTableError
        chunk_cache.GLOBAL.clear()
        try:
            cfs2.read_partition(
                t2.columns["id"].cql_type.serialize(0))
        except (CorruptSSTableError, OSError):
            pass    # the flipped byte may leave no source to serve it
        if cfs2.quarantined:
            need(any("quarantine" in p for p in
                     eng2.flight_recorder.dumps),
                 "quarantine did not dump a flight-recorder bundle")
            qev = [e for e in diagnostics.GLOBAL.events("sstable.quarantine")]
            need(len(qev) >= 1, "no sstable.quarantine event published")
    finally:
        eng2.close()
        diagnostics.GLOBAL.reset()
    return errs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.check_diagnostics")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engines (default cuda)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        errs = run_check(d, device=args.device)
    if errs:
        print("check_diagnostics: FAIL", file=sys.stderr)
        for e in errs:
            print(f"  - {e}", file=sys.stderr)
        return 1
    print("check_diagnostics: flight-recorder bundle OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
