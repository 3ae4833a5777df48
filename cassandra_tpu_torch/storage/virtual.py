"""Virtual tables: in-memory system tables served through the read path.

Reference counterpart: db/virtual/ (AbstractVirtualTable + 40 tables:
settings, clients, caches, sstable_tasks, ...) plus the classic
system.local / system.peers. A virtual table supplies row dicts on demand;
the CQL executor projects them like ordinary rows.
"""
from __future__ import annotations

from ..schema import TableMetadata, make_table


def _snapshot(seq):
    """Copy a concurrently-appended deque/list for safe iteration; an
    append racing the copy raises RuntimeError — retry once, then serve
    what a best-effort copy yields."""
    for _ in range(3):
        try:
            return list(seq)
        except RuntimeError:
            continue
    return []


class VirtualTable:
    def __init__(self, table: TableMetadata, rows_fn):
        self.table = table
        self.rows_fn = rows_fn

    def rows(self) -> list[dict]:
        return list(self.rows_fn())


class VirtualSchema:
    """Registry of virtual keyspaces/tables for one backend."""

    def __init__(self):
        self.tables: dict[tuple[str, str], VirtualTable] = {}

    def register(self, vt: VirtualTable) -> None:
        self.tables[(vt.table.keyspace, vt.table.name)] = vt

    def get(self, keyspace: str, name: str) -> VirtualTable | None:
        return self.tables.get((keyspace, name))


def build_engine_virtuals(engine) -> VirtualSchema:
    """system/system_views tables over a local StorageEngine."""
    vs = VirtualSchema()

    t_local = make_table("system", "local", pk=["key"],
                         cols={"key": "text", "cluster_name": "text",
                               "release_version": "text",
                               "partitioner": "text"})
    vs.register(VirtualTable(t_local, lambda: [{
        "key": "local", "cluster_name": "cassandra_tpu",
        "release_version": "0.1.0",
        "partitioner": "Murmur3Partitioner"}]))

    t_sst = make_table("system_views", "sstables", pk=["keyspace_name"],
                       ck=["table_name", "generation"],
                       cols={"keyspace_name": "text", "table_name": "text",
                             "generation": "int", "cells": "bigint",
                             "partitions": "bigint", "size_bytes": "bigint",
                             "level": "int", "tombstones": "bigint"})

    def sstable_rows():
        for cfs in engine.stores.values():
            for s in cfs.live_sstables():
                yield {"keyspace_name": cfs.table.keyspace,
                       "table_name": cfs.table.name,
                       "generation": s.desc.generation,
                       "cells": s.n_cells, "partitions": s.n_partitions,
                       "size_bytes": s.data_size, "level": s.level,
                       "tombstones": s.n_tombstones}
    vs.register(VirtualTable(t_sst, sstable_rows))

    t_ch = make_table("system_views", "compaction_history", pk=["id"],
                      cols={"id": "int", "keyspace_name": "text",
                            "table_name": "text", "cells_read": "bigint",
                            "cells_written": "bigint",
                            "bytes_read": "bigint",
                            "bytes_written": "bigint", "seconds": "double"})

    def history_rows():
        i = 0
        for cfs in engine.stores.values():
            # deque (bounded ring): a background compaction appending
            # mid-iteration would raise RuntimeError — copy first
            for st in _snapshot(cfs.compaction_history):
                yield {"id": i, "keyspace_name": cfs.table.keyspace,
                       "table_name": cfs.table.name,
                       "cells_read": st["cells_read"],
                       "cells_written": st["cells_written"],
                       "bytes_read": st["bytes_read"],
                       "bytes_written": st["bytes_written"],
                       "seconds": st["seconds"]}
                i += 1
    vs.register(VirtualTable(t_ch, history_rows))

    # --- compactions_in_progress (db/virtual/SSTableTasksTable +
    # ActiveCompactions): live per-task progress while compactor slots
    # run — phase, bytes read/written, % done, ETA
    t_cip = make_table(
        "system_views", "compactions_in_progress", pk=["id"],
        cols={"id": "int", "keyspace_name": "text", "table_name": "text",
              "kind": "text", "phase": "text", "bytes_total": "bigint",
              "bytes_read": "bigint", "bytes_written": "bigint",
              "progress_pct": "double", "active_seconds": "double",
              "eta_seconds": "double"})

    def cip_rows():
        for s in engine.compactions.active.snapshot():
            yield {"id": s["id"], "keyspace_name": s["keyspace"],
                   "table_name": s["table"], "kind": s["kind"],
                   "phase": s["phase"], "bytes_total": s["total_bytes"],
                   "bytes_read": s["bytes_read"],
                   "bytes_written": s["bytes_written"],
                   "progress_pct": s["progress_pct"],
                   "active_seconds": s["active_seconds"],
                   "eta_seconds": (-1.0 if s["eta_seconds"] is None
                                   else s["eta_seconds"])}
    vs.register(VirtualTable(t_cip, cip_rows))

    # --- quarantined_sstables (storage/failures.py quarantine records):
    # corrupt sstables blacklisted out of the live set, with the error
    # that condemned them and where their components went
    t_quar = make_table(
        "system_views", "quarantined_sstables", pk=["keyspace_name"],
        ck=["table_name", "generation"],
        cols={"keyspace_name": "text", "table_name": "text",
              "generation": "int", "reason": "text",
              "quarantined_at": "bigint", "size_bytes": "bigint",
              "path": "text"})

    def quarantine_rows():
        for cfs in engine.stores.values():
            for q in list(getattr(cfs, "quarantined", [])):
                yield {"keyspace_name": cfs.table.keyspace,
                       "table_name": cfs.table.name,
                       "generation": q["generation"],
                       "reason": q.get("reason", "")[:200],
                       "quarantined_at": int(q.get("at", 0) * 1000),
                       "size_bytes": q.get("bytes", 0),
                       "path": q.get("path", "")}
    vs.register(VirtualTable(t_quar, quarantine_rows))

    t_metrics = make_table("system_views", "metrics", pk=["name"],
                           cols={"name": "text", "value": "double"})

    def metric_rows():
        from ..service.metrics import GLOBAL
        for k, v in sorted(GLOBAL.snapshot().items()):
            yield {"name": k, "value": float(v)}
        # engine-scoped compaction gauges (process-global registration
        # would cross-report between in-process nodes)
        for k, v in sorted(engine.compactions.gauges().items()):
            yield {"name": k, "value": float(v)}
        for cfs in engine.stores.values():
            base = f"table.{cfs.table.keyspace}.{cfs.table.name}"
            for k, v in cfs.metrics.items():
                yield {"name": f"{base}.{k}", "value": float(v)}
            # derived amplification gauges (the adaptive-compaction
            # input signals; same-source counters, see
            # ColumnFamilyStore.amplification)
            for k, v in cfs.amplification().items():
                yield {"name": f"{base}.{k}", "value": float(v)}
    vs.register(VirtualTable(t_metrics, metric_rows))

    # --- metrics_history (service/history.py): the retained
    # multi-resolution time series — raw rows are single samples,
    # coarse rows the sealed min/max/last/sum-preserving merge
    # buckets; rate_per_s is the counter rate between consecutive raw
    # samples (0 on the first sample and on coarse rows)
    t_mh = make_table("system_views", "metrics_history", pk=["name"],
                      ck=["resolution", "at_ms"],
                      cols={"name": "text", "resolution": "text",
                            "at_ms": "bigint", "last": "double",
                            "min": "double", "max": "double",
                            "sum": "double", "n": "int",
                            "rate_per_s": "double"})

    def mh_rows():
        svc = getattr(engine, "metrics_history", None)
        if svc is None:
            return
        for name in svc.names():
            prev = None
            for b in svc.query(name, "raw"):
                rate = 0.0
                if prev is not None and b["t1"] > prev["t1"]:
                    rate = max(b["last"] - prev["last"], 0.0) \
                        / (b["t1"] - prev["t1"])
                # at_ms is WALL-clock (epoch ms, via the service's
                # sample-time offset) so rows join against telemetry
                # snapshots and diagnostic-event timestamps
                yield {"name": name, "resolution": "raw",
                       "at_ms": int(svc.to_wall(b["t1"]) * 1000),
                       "last": b["last"], "min": b["min"],
                       "max": b["max"], "sum": b["sum"], "n": b["n"],
                       "rate_per_s": round(rate, 6)}
                prev = b
            for b in svc.query(name, "coarse"):
                yield {"name": name, "resolution": "coarse",
                       "at_ms": int(svc.to_wall(b["t1"]) * 1000),
                       "last": b["last"], "min": b["min"],
                       "max": b["max"], "sum": b["sum"], "n": b["n"],
                       "rate_per_s": 0.0}
    vs.register(VirtualTable(t_mh, mh_rows))

    # --- controller_decisions (control/loop.py): the adaptive
    # compaction controller's bounded decision ledger — every applied
    # strategy/knob change and every hysteresis/cooldown/freeze skip,
    # newest LEDGER_CAPACITY kept. `nodetool autocompaction history`
    # serves the same rows.
    t_ctrl = make_table(
        "system_views", "controller_decisions", pk=["id"],
        cols={"id": "bigint", "at": "bigint", "keyspace_name": "text",
              "table_name": "text", "regime": "text", "action": "text",
              "old": "text", "new": "text", "applied": "boolean",
              "reason": "text"})

    def controller_rows():
        ctrl = getattr(engine, "controller", None)
        for e in (ctrl.decisions() if ctrl else []):
            yield {"id": e["seq"], "at": e["at_ms"],
                   "keyspace_name": e.get("keyspace", ""),
                   "table_name": e.get("table", ""),
                   "regime": e.get("regime") or "",
                   "action": e.get("action", ""),
                   "old": str(e.get("old", "")),
                   "new": str(e.get("new", "")),
                   "applied": bool(e.get("applied")),
                   "reason": e.get("reason", "")}
    vs.register(VirtualTable(t_ctrl, controller_rows))

    t_slow = make_table("system_views", "slow_queries", pk=["id"],
                        cols={"id": "int", "query": "text",
                              "keyspace_name": "text",
                              "duration_ms": "double",
                              "parse_ms": "double",
                              "execute_ms": "double",
                              "serialize_ms": "double",
                              "at": "bigint",
                              "trace_session": "text"})

    def slow_rows():
        mon = getattr(engine, "monitor", None)
        for e in (mon.entries() if mon else []):
            yield {"id": e["id"], "query": e["query"],
                   "keyspace_name": e["keyspace"],
                   "duration_ms": e["duration_ms"],
                   "parse_ms": e.get("parse_ms", 0.0),
                   "execute_ms": e.get("execute_ms", 0.0),
                   "serialize_ms": e.get("serialize_ms", 0.0),
                   "at": e["at"],
                   "trace_session": e.get("trace_session") or ""}
    vs.register(VirtualTable(t_slow, slow_rows))

    # --- diagnostic_events (diag/DiagnosticEventService vtable role):
    # the typed event bus's recent rings, publication-ordered. Empty
    # until the diagnostic_events_enabled knob flips on.
    t_diag = make_table("system_views", "diagnostic_events", pk=["seq"],
                        cols={"seq": "bigint", "at": "bigint",
                              "type": "text", "fields": "text"})

    def diag_rows():
        import json as _json
        from ..service import diagnostics
        for ev in diagnostics.GLOBAL.events():
            # truncate VALUES, never the serialized document — the
            # fields cell must stay parseable JSON however long a
            # reason/path field came in
            fields = {k: (v[:200] if isinstance(v, str) else v)
                      for k, v in ev.fields.items()}
            yield {"seq": ev.seq, "at": int(ev.at * 1000),
                   "type": ev.type,
                   "fields": _json.dumps(fields, default=repr,
                                         sort_keys=True)}
    vs.register(VirtualTable(t_diag, diag_rows))

    # --- slos (service/slo.py): per-objective p99 vs target, error
    # budget remaining, breach/exhaustion tallies. A pure snapshot —
    # SELECTing this table never publishes events or dumps bundles
    # (that's `nodetool slostats`, which runs a real check())
    t_slo = make_table(
        "system_views", "slos", pk=["objective"],
        cols={"objective": "text", "metric": "text",
              "p99_us": "double", "target_us": "double",
              "breaching": "boolean", "breaches": "bigint",
              "budget_s": "double", "budget_remaining_s": "double",
              "exhausted": "boolean", "exhaustions": "bigint"})

    def slo_rows():
        svc = getattr(engine, "slo", None)
        for v in (svc.snapshot() if svc else []):
            yield {"objective": v["objective"], "metric": v["metric"],
                   "p99_us": v["p99_us"], "target_us": v["target_us"],
                   "breaching": v["breaching"],
                   "breaches": v["breaches"],
                   "budget_s": v["budget_s"],
                   "budget_remaining_s": v["budget_remaining_s"],
                   "exhausted": v["exhausted"],
                   "exhaustions": v["exhaustions"]}
    vs.register(VirtualTable(t_slo, slo_rows))

    # --- pipelines (utils/pipeline_ledger.py): per-stage busy/stall/
    # idle accounting for every multi-stage pipeline — the
    # where-did-the-wall-go surface (TPIE-style per-stage profiling)
    t_pipe = make_table("system_views", "pipelines", pk=["pipeline"],
                        ck=["stage"],
                        cols={"pipeline": "text", "stage": "text",
                              "busy_seconds": "double",
                              "stall_seconds": "double",
                              "idle_seconds": "double",
                              "items": "bigint", "bytes": "bigint",
                              "queue_high_water": "int"})

    def pipe_rows():
        from ..utils import pipeline_ledger
        for pname, stages in sorted(pipeline_ledger.snapshot_all()
                                    .items()):
            for sname, s in stages.items():
                yield {"pipeline": pname, "stage": sname,
                       "busy_seconds": s["busy_s"],
                       "stall_seconds": s["stall_s"],
                       "idle_seconds": s["idle_s"],
                       "items": s["items"], "bytes": s["bytes"],
                       "queue_high_water": s["queue_hwm"]}
    vs.register(VirtualTable(t_pipe, pipe_rows))

    # --- system_traces (tracing/TraceKeys role): completed sessions
    # (explicit TRACING ON + trace_probability-sampled) and their merged
    # coordinator+replica event timelines
    t_tsess = make_table("system_traces", "sessions", pk=["session_id"],
                         cols={"session_id": "text", "request": "text",
                               "started_at": "bigint",
                               "duration_us": "bigint",
                               "events": "int"})

    def tsess_rows():
        store = getattr(engine, "trace_store", None)
        for st in (store.sessions() if store else []):
            yield {"session_id": st.session_id, "request": st.request,
                   "started_at": int(st.started_at * 1000),
                   "duration_us": st.duration_us,
                   "events": len(st.events)}
    vs.register(VirtualTable(t_tsess, tsess_rows))

    t_tev = make_table("system_traces", "events", pk=["session_id"],
                       ck=["event_id"],
                       cols={"session_id": "text", "event_id": "int",
                             "activity": "text", "source": "text",
                             "source_elapsed": "bigint"})

    def tev_rows():
        store = getattr(engine, "trace_store", None)
        for st in (store.sessions() if store else []):
            for i, (us, src, activity) in enumerate(list(st.events)):
                yield {"session_id": st.session_id, "event_id": i,
                       "activity": activity, "source": src,
                       "source_elapsed": int(us)}
    vs.register(VirtualTable(t_tev, tev_rows))

    # --- device_profile (the observability layer over ops/merge.py):
    # per-kernel compile/dispatch/execute split + recompiles-by-shape,
    # plus the aggregated compaction phase timings (compress/io_write/
    # seal/...) — one table, `kind` distinguishes the two row families
    t_dp = make_table("system_views", "device_profile", pk=["name"],
                      cols={"name": "text", "kind": "text",
                            "calls": "bigint", "compiles": "bigint",
                            "shapes": "bigint",
                            "compile_seconds": "double",
                            "dispatch_seconds": "double",
                            "execute_seconds": "double"})

    def dp_rows():
        from ..service.profiling import GLOBAL as kprof
        snap = kprof.snapshot()
        for name, k in sorted(snap["kernels"].items()):
            yield {"name": name, "kind": "kernel", "calls": k["calls"],
                   "compiles": k["compiles"], "shapes": k["shapes"],
                   "compile_seconds": k["compile_s"],
                   "dispatch_seconds": k["dispatch_s"],
                   "execute_seconds": k["execute_s"]}
        for phase, secs in sorted(snap["phases"].items()):
            yield {"name": f"phase.{phase}", "kind": "phase",
                   "calls": 0, "compiles": 0, "shapes": 0,
                   "compile_seconds": 0.0, "dispatch_seconds": 0.0,
                   "execute_seconds": secs}
    vs.register(VirtualTable(t_dp, dp_rows))

    # --- device_programs (observability layer 6, the registry view):
    # the full per-program accounting the generalized registry keeps —
    # compile vs warm dispatch vs execute, live tracked shapes +
    # evictions (the bounded-LRU churn signals) and past-budget
    # retraces, and the kernel's least work at its most recent new
    # shape (ops/costs.py: bytes moved once, operations where counted)
    t_dprog = make_table(
        "system_views", "device_programs", pk=["name"],
        cols={"name": "text", "calls": "bigint", "compiles": "bigint",
              "retraces": "bigint", "shape_count": "bigint",
              "shape_evictions": "bigint", "compile_seconds": "double",
              "dispatch_seconds": "double", "execute_seconds": "double",
              "cost_flops": "double", "cost_bytes": "double"})

    def dprog_rows():
        from ..service.profiling import GLOBAL as kprof
        for name, k in sorted(kprof.snapshot()["kernels"].items()):
            yield {"name": name, "calls": k["calls"],
                   "compiles": k["compiles"],
                   "retraces": k["retraces"],
                   "shape_count": k["shape_count"],
                   "shape_evictions": k["shape_evictions"],
                   "compile_seconds": k["compile_s"],
                   "dispatch_seconds": k["dispatch_s"],
                   "execute_seconds": k["execute_s"],
                   "cost_flops": k["cost_flops"],
                   "cost_bytes": k["cost_bytes"]}
    vs.register(VirtualTable(t_dprog, dprog_rows))

    # --- profiles (observability layer 6, the wall-clock half): the
    # sampler's folded stacks — the always-on ring plus every live and
    # retained finished session, hottest stacks first per target
    t_prof = make_table(
        "system_views", "profiles", pk=["target"],
        ck=["stack_id"],
        cols={"target": "text", "stack_id": "int", "state": "text",
              "thread": "text", "stack": "text", "samples": "bigint"})

    def prof_rows():
        from ..service.sampler import GLOBAL as sp
        st = sp.stats()
        targets = ["ring"] + st["sessions"] + st["finished_sessions"]
        for target in targets:
            try:
                lines = sp.collapsed(target)
            except ValueError:
                continue   # session sealed between stats() and here
            for i, line in enumerate(lines):
                body, _, count = line.rpartition(" ")
                state, tname, *frames = body.split(";")
                yield {"target": target, "stack_id": i,
                       "state": state, "thread": tname,
                       "stack": ";".join(frames),
                       "samples": int(count)}
    vs.register(VirtualTable(t_prof, prof_rows))

    # --- settings (db/virtual/SettingsTable.java): the typed config,
    # live values, with mutability flag
    t_settings = make_table("system_views", "settings", pk=["name"],
                           cols={"name": "text", "value": "text",
                                 "mutable": "boolean"})
    vs.register(VirtualTable(t_settings, lambda: (
        {"name": n, "value": v, "mutable": m}
        for n, v, m in engine.settings.all())))

    # --- caches (db/virtual/CachesTable.java): chunk + key + row
    def cache_rows():
        from . import chunk_cache, key_cache, row_cache
        s = chunk_cache.GLOBAL.stats()
        yield {"name": "chunks", "entries": s.get("entries", 0),
               "size_bytes": s.get("bytes", 0),
               "capacity_bytes": s.get("capacity", 0),
               "hits": s.get("hits", 0), "misses": s.get("misses", 0)}
        k = key_cache.GLOBAL.stats()
        yield {"name": "keys", "entries": k.get("entries", 0),
               "size_bytes": 0, "capacity_bytes": 0,
               "hits": k.get("hits", 0), "misses": k.get("misses", 0)}
        # per-table handle hit/miss counters (engine-scoped), shared
        # service bytes/capacity/entry totals (storage/row_cache.py)
        row_hits = row_miss = rows_cached = 0
        for cfs in engine.stores.values():
            rc = cfs.row_cache
            if rc is not None:
                row_hits += rc.hits
                row_miss += rc.misses
                rows_cached += len(rc)
        r = row_cache.GLOBAL.stats()
        yield {"name": "rows", "entries": rows_cached,
               "size_bytes": r.get("bytes", 0),
               "capacity_bytes": r.get("capacity", 0),
               "hits": row_hits, "misses": row_miss}

    t_caches = make_table("system_views", "caches", pk=["name"],
                          cols={"name": "text", "entries": "bigint",
                                "size_bytes": "bigint",
                                "capacity_bytes": "bigint",
                                "hits": "bigint", "misses": "bigint"})
    vs.register(VirtualTable(t_caches, cache_rows))

    # --- disk_usage (db/virtual/DisksTable role, per-table granularity)
    t_disk = make_table("system_views", "disk_usage", pk=["keyspace_name"],
                        ck=["table_name"],
                        cols={"keyspace_name": "text",
                              "table_name": "text", "mebibytes": "double",
                              "sstables": "int"})

    def disk_rows():
        for cfs in engine.stores.values():
            live = cfs.live_sstables()
            yield {"keyspace_name": cfs.table.keyspace,
                   "table_name": cfs.table.name,
                   "mebibytes": round(sum(s.size_bytes for s in live)
                                      / 2**20, 3),
                   "sstables": len(live)}
    vs.register(VirtualTable(t_disk, disk_rows))

    # --- memtables
    t_mem = make_table("system_views", "memtables", pk=["keyspace_name"],
                       ck=["table_name"],
                       cols={"keyspace_name": "text", "table_name": "text",
                             "cells": "bigint", "payload_bytes": "bigint"})

    def mem_rows():
        for cfs in engine.stores.values():
            m = cfs.memtable
            yield {"keyspace_name": cfs.table.keyspace,
                   "table_name": cfs.table.name, "cells": len(m),
                   "payload_bytes": getattr(m, "live_bytes", 0)}
    vs.register(VirtualTable(t_mem, mem_rows))

    # --- thread_pools (db/virtual/ThreadPoolsTable): the executors that
    # exist in this runtime — compaction worker + per-writer syncers
    t_tp = make_table("system_views", "thread_pools", pk=["name"],
                      cols={"name": "text", "active": "int",
                            "pending": "int", "completed": "bigint"})

    def tp_rows():
        from ..tools.nodetool import tpstats
        for p in tpstats(engine):   # single source for nodetool + vtable
            yield {"name": p["pool"], "active": p["active"],
                   "pending": p["pending"], "completed": p["completed"]}
    vs.register(VirtualTable(t_tp, tp_rows))

    # --- indexes (SAI/SASI registry)
    t_idx = make_table("system_views", "indexes", pk=["keyspace_name"],
                       ck=["table_name", "index_name"],
                       cols={"keyspace_name": "text", "table_name": "text",
                             "index_name": "text", "column_name": "text",
                             "kind": "text"})

    def index_rows():
        im = getattr(engine, "indexes", None)
        if im is None:
            return
        for (ks, tbl, name), key in sorted(im.by_name.items()):
            meta = im.meta.get(key, {})
            yield {"keyspace_name": ks, "table_name": tbl,
                   "index_name": name, "column_name": key[2],
                   "kind": meta.get("custom_class") or "SAI"}
    vs.register(VirtualTable(t_idx, index_rows))

    # --- triggers
    t_trig = make_table("system_views", "triggers", pk=["keyspace_name"],
                        ck=["table_name", "trigger_name"],
                        cols={"keyspace_name": "text",
                              "table_name": "text", "trigger_name": "text",
                              "source": "text"})

    def trigger_rows():
        tm = getattr(engine, "triggers", None)
        if tm is None:
            return
        for (ks, tbl), by_name in sorted(tm.triggers.items()):
            for name, source in sorted(by_name.items()):
                yield {"keyspace_name": ks, "table_name": tbl,
                       "trigger_name": name, "source": source[:200]}
    vs.register(VirtualTable(t_trig, trigger_rows))

    # --- snapshots (db/virtual/SnapshotsTable)
    t_snap = make_table("system_views", "snapshots", pk=["tag"],
                        ck=["keyspace_name", "table_name"],
                        cols={"tag": "text", "keyspace_name": "text",
                              "table_name": "text", "files": "int",
                              "created_at": "text"})

    def snap_rows():
        from .snapshot import list_snapshots
        for cfs in engine.stores.values():
            for s in list_snapshots(cfs):
                yield {"tag": s["tag"],
                       "keyspace_name": cfs.table.keyspace,
                       "table_name": cfs.table.name,
                       "files": len(s.get("files", [])),
                       "created_at": str(s.get("created_at", ""))}
    vs.register(VirtualTable(t_snap, snap_rows))

    # --- guardrail thresholds + recent warnings
    t_guard = make_table("system_views", "guardrails", pk=["name"],
                         cols={"name": "text", "value": "bigint"})

    def guard_rows():
        import dataclasses as _dc
        g = engine.guardrails
        for f in _dc.fields(g):
            if f.name == "warnings":
                continue
            yield {"name": f.name, "value": int(getattr(g, f.name))}
    vs.register(VirtualTable(t_guard, guard_rows))

    t_gwarn = make_table("system_views", "guardrail_warnings", pk=["id"],
                         cols={"id": "int", "message": "text"})
    vs.register(VirtualTable(t_gwarn, lambda: (
        {"id": i, "message": w}
        for i, w in enumerate(engine.guardrails.warnings))))

    # --- commitlog: a `<status>` summary row (segment count, oldest
    # dirty segment, writers parked on the group-commit barrier, sync
    # failures — CommitLogMetrics role) plus one row per segment file
    t_cl = make_table("system_views", "commitlog", pk=["name"],
                      cols={"name": "text", "size_bytes": "bigint",
                            "segments": "int", "oldest_dirty": "int",
                            "pending_syncs": "int",
                            "sync_failures": "bigint"})

    def cl_rows():
        cl = engine.commitlog
        if cl is None:
            return
        st = cl.stats()
        od = st["oldest_dirty"]
        yield {"name": "<status>", "size_bytes": st["total_bytes"],
               "segments": st["segments"],
               "oldest_dirty": -1 if od is None else od,
               "pending_syncs": st["pending_syncs"],
               "sync_failures": st["sync_failures"]}
        for fn, sz in st["files"]:
            yield {"name": fn, "size_bytes": sz, "segments": 0,
                   "oldest_dirty": -1, "pending_syncs": 0,
                   "sync_failures": 0}
    vs.register(VirtualTable(t_cl, cl_rows))

    # --- batches on disk (batchlog backlog)
    t_bl = make_table("system_views", "batch_metrics", pk=["name"],
                      cols={"name": "text", "value": "bigint"})

    def bl_rows():
        import os as _os
        bl = getattr(engine, "batchlog", None)
        n = 0
        if bl is not None and _os.path.isdir(bl.directory):
            n = len([f for f in _os.listdir(bl.directory)
                     if f.startswith("batch-")])
        yield {"name": "pending_batches", "value": n}
    vs.register(VirtualTable(t_bl, bl_rows))

    # --- system_properties (db/virtual/SystemPropertiesTable): the
    # environment the node actually runs with
    t_props = make_table("system_views", "system_properties", pk=["name"],
                         cols={"name": "text", "value": "text"})

    def prop_rows():
        import os as _os
        import sys as _sys
        yield {"name": "python_version", "value": _sys.version.split()[0]}
        yield {"name": "platform", "value": _sys.platform}
        yield {"name": "data_dir", "value": engine.data_dir}
        for k in sorted(_os.environ):
            if k.startswith(("CUDA_", "TORCH_", "CTPU_")):
                yield {"name": k, "value": _os.environ[k][:200]}
    vs.register(VirtualTable(t_props, prop_rows))

    # --- cql latency percentiles (db/virtual/QueriesTable +
    # ClientRequestMetrics): served from the global latency histogram
    t_cqlm = make_table("system_views", "cql_metrics", pk=["name"],
                        cols={"name": "text", "p50_us": "double",
                              "p95_us": "double",
                              "p99_us": "double", "max_us": "double",
                              "count": "bigint"})

    def cqlm_rows():
        from ..service.metrics import GLOBAL
        for name in ("cql.request", "request.read", "request.write",
                     "request.range"):
            s = GLOBAL.hist(name).summary()
            yield {"name": name, "p50_us": s["p50_us"],
                   "p95_us": s["p95_us"], "p99_us": s["p99_us"],
                   "max_us": s["max_us"], "count": s["count"]}
    vs.register(VirtualTable(t_cqlm, cqlm_rows))

    return vs


def build_node_virtuals(node) -> VirtualSchema:
    """Cluster-aware virtuals (system.peers etc.) for a Node backend."""
    vs = build_engine_virtuals(node.engine)

    t_peers = make_table("system", "peers", pk=["peer"],
                         cols={"peer": "text", "data_center": "text",
                               "rack": "text", "alive": "boolean",
                               "tokens": "int"})

    def peer_rows():
        for ep, toks in node.ring.endpoints.items():
            if ep == node.endpoint:
                continue
            yield {"peer": ep.name, "data_center": ep.dc, "rack": ep.rack,
                   "alive": node.is_alive(ep), "tokens": len(toks)}
    vs.register(VirtualTable(t_peers, peer_rows))

    # --- gossip_info (db/virtual/GossipInfoTable): per-endpoint state +
    # phi from the accrual detector
    t_gossip = make_table("system_views", "gossip_info", pk=["endpoint"],
                          cols={"endpoint": "text", "generation": "bigint",
                                "heartbeat": "bigint", "alive": "boolean",
                                "phi": "double"})

    def gossip_rows():
        g = node.gossiper
        now = g.clock()
        with g._lock:
            states = dict(g.states)
        for ep, st in states.items():
            phi = 0.0 if ep == g.ep else g.detector.phi(st, now)
            yield {"endpoint": ep.name, "generation": st.generation,
                   "heartbeat": st.version,
                   "alive": ep == g.ep or node.is_alive(ep),
                   "phi": round(float(phi), 3)}
    vs.register(VirtualTable(t_gossip, gossip_rows))

    # --- internode messaging counters (InternodeInbound/OutboundTable)
    t_msg = make_table("system_views", "internode_metrics", pk=["name"],
                       cols={"name": "text", "value": "bigint"})
    vs.register(VirtualTable(t_msg, lambda: (
        {"name": k, "value": int(v)}
        for k, v in sorted(node.messaging.metrics.items()))))

    # --- pending hints per target (PendingHintsTable)
    t_hints = make_table("system_views", "pending_hints", pk=["target"],
                         cols={"target": "text", "bytes_on_disk": "bigint",
                               "written": "bigint", "replayed": "bigint"})

    def hint_rows():
        from ..tools.nodetool import listpendinghints
        m = node.hints.metrics
        for h in listpendinghints(node):   # single source: nodetool+vtable
            yield {"target": h["target"], "bytes_on_disk": h["bytes"],
                   "written": m["written"], "replayed": m["replayed"]}
    vs.register(VirtualTable(t_hints, hint_rows))

    # --- streaming sessions (StreamingVirtualTable)
    t_stream = make_table("system_views", "streaming", pk=["id"],
                          cols={"id": "int", "peer": "text",
                                "direction": "text", "keyspace_name": "text",
                                "table_name": "text", "status": "text",
                                "files": "int", "bytes": "bigint"})

    def stream_rows():
        svc = getattr(node, "streams", None)
        for i, s in enumerate(_snapshot(svc.sessions) if svc else []):
            yield {"id": i, "peer": s["peer"], "direction": s["direction"],
                   "keyspace_name": s["keyspace"],
                   "table_name": s["table"], "status": s["status"],
                   "files": s["files"], "bytes": s["bytes"]}
    vs.register(VirtualTable(t_stream, stream_rows))

    # --- live sessioned transfers (cluster/stream_session.py): chunk
    # and byte progress while a session is IN FLIGHT — the `streaming`
    # table above holds only terminal summaries
    t_streams = make_table("system_views", "streams", pk=["id"],
                           cols={"id": "text", "peer": "text",
                                 "direction": "text",
                                 "keyspace_name": "text",
                                 "table_name": "text", "kind": "text",
                                 "status": "text",
                                 "chunks_total": "bigint",
                                 "chunks_done": "bigint",
                                 "bytes_total": "bigint",
                                 "bytes_done": "bigint"})

    def live_stream_rows():
        svc = getattr(node, "streams", None)
        if svc is None or not hasattr(svc, "progress"):
            return
        for s in svc.progress():
            yield {"id": s["sid"], "peer": s["peer"],
                   "direction": s["direction"],
                   "keyspace_name": s["keyspace"],
                   "table_name": s["table"], "kind": s["kind"],
                   "status": s["status"],
                   "chunks_total": s["chunks_total"],
                   "chunks_done": s["chunks_done"],
                   "bytes_total": s["bytes_total"],
                   "bytes_done": s["bytes_done"]}
    vs.register(VirtualTable(t_streams, live_stream_rows))

    # --- repair sessions
    t_rep = make_table("system_views", "repairs", pk=["id"],
                       cols={"id": "int", "keyspace_name": "text",
                             "table_name": "text", "incremental": "boolean",
                             "replicas": "int", "ranges_synced": "int"})

    def repair_rows():
        svc = getattr(node, "repair", None)
        for i, s in enumerate(_snapshot(svc.history) if svc else []):
            yield {"id": i, "keyspace_name": s["keyspace"],
                   "table_name": s["table"],
                   "incremental": s["incremental"],
                   "replicas": s["replicas"],
                   "ranges_synced": int(s.get("ranges_synced", 0))}
    vs.register(VirtualTable(t_rep, repair_rows))

    # --- connected native-protocol clients (ClientsTable)
    t_cli = make_table("system_views", "clients", pk=["id"],
                       cols={"id": "int", "address": "text",
                             "username": "text", "keyspace_name": "text",
                             "protocol_version": "int",
                             "requests": "bigint",
                             "in_flight": "int",
                             "rate_limited": "bigint"})

    def client_rows():
        from ..tools.nodetool import clientstats
        for c in clientstats(node):   # single source: nodetool + vtable
            yield {"id": c["id"], "address": c["address"],
                   "username": c["user"], "keyspace_name": c["keyspace"],
                   "protocol_version": c["version"],
                   "requests": c["requests"],
                   "in_flight": c["in_flight"],
                   "rate_limited": c["rate_limited"]}
    vs.register(VirtualTable(t_cli, client_rows))

    # --- token ownership (TokensTable / nodetool ring backing)
    t_tok = make_table("system_views", "tokens", pk=["endpoint"],
                       ck=["token"],
                       cols={"endpoint": "text", "token": "bigint"})

    def token_rows():
        for ep, toks in node.ring.endpoints.items():
            for t in sorted(toks):
                yield {"endpoint": ep.name, "token": int(t)}
    vs.register(VirtualTable(t_tok, token_rows))

    # --- coordinator latencies (CoordinatorReadLatency metrics): the
    # dynamic-snitch EWMA per peer
    t_lat = make_table("system_views", "coordinator_read_latency",
                       pk=["endpoint"],
                       cols={"endpoint": "text", "ewma_ms": "double"})

    def lat_rows():
        with node.proxy._lat_lock:
            snap = dict(node.proxy._latency)
        for ep, s in sorted(snap.items(), key=lambda kv: kv[0].name):
            yield {"endpoint": ep.name, "ewma_ms": round(s * 1000.0, 3)}
    vs.register(VirtualTable(t_lat, lat_rows))
    return vs
