"""nodetool: operator commands over a node/engine.

Reference counterpart: tools/nodetool/ (161 JMX subcommands over
NodeProbe). This framework exposes the same operations as direct Python
API on the Node/StorageEngine (the JMX transport is replaced by in-process
calls; a remote admin protocol can wrap these functions); `python -m
cassandra_tpu_torch.tools.nodetool <cmd> --data <dir> [--device cpu]`
drives a local engine (its kernels on `cuda` unless `--device` says
otherwise). Commands that need a module the port does not have yet
(the cluster layer, copyutil, sstableloader, the admin protocol) raise
ImportError at that module's import.

Implemented commands: status, info, flush, compact, compactionstats,
commitlogstats, tablestats, repair, cleanup, gettraces, exportmetrics,
ring, and the breadth registry below (~120 commands).
"""
from __future__ import annotations

import argparse
import json
import sys


def status(node) -> list[dict]:
    """nodetool status: per-endpoint liveness + ownership."""
    out = []
    for ep, toks in node.ring.endpoints.items():
        out.append({"endpoint": ep.name, "dc": ep.dc, "rack": ep.rack,
                    "status": "UN" if node.is_alive(ep) else "DN",
                    "tokens": len(toks)})
    return out


def _cache_line(stats: dict, entries=None, size=None) -> dict:
    hits = int(stats.get("hits", 0))
    misses = int(stats.get("misses", 0))
    total = hits + misses
    return {
        "entries": int(stats.get("entries", 0)
                       if entries is None else entries),
        "size_bytes": int(stats.get("bytes", 0) if size is None else size),
        "capacity_bytes": int(stats.get("capacity", 0)),
        "hits": hits, "misses": misses,
        "hit_ratio": round(hits / total, 3) if total else None,
    }


def info(engine) -> dict:
    """nodetool info: storage totals + key/row/chunk cache hit ratios
    (the reference prints 'Key Cache : entries …, hits …, requests …'
    lines; the caches were invisible outside vtables before)."""
    tables = {}
    for cfs in engine.stores.values():
        tables[cfs.table.full_name()] = {
            "sstables": len(cfs.live_sstables()),
            "memtable_cells": len(cfs.memtable),
            "disk_bytes": sum(s.size_bytes for s in cfs.live_sstables()),
        }
    from ..storage import chunk_cache, key_cache, row_cache
    key = _cache_line(key_cache.GLOBAL.stats(), size=0)
    # the key cache is entry-bounded, not byte-bounded
    key["capacity_entries"] = key.pop("capacity_bytes")
    row = row_cache.GLOBAL.stats()
    # hit/miss per THIS engine's table handles; bytes/capacity are the
    # shared service's (one process-wide row cache)
    row_hits = sum(cfs.row_cache.hits for cfs in engine.stores.values()
                   if cfs.row_cache is not None)
    row_miss = sum(cfs.row_cache.misses for cfs in engine.stores.values()
                   if cfs.row_cache is not None)
    row_entries = sum(len(cfs.row_cache)
                      for cfs in engine.stores.values()
                      if cfs.row_cache is not None)
    row.update({"hits": row_hits, "misses": row_miss})
    # speculative retry visibility (the reference prints 'Speculative
    # Retries' per table in tablestats; here the coordinator-wide
    # fired/won pair): fired = redundant requests issued after the
    # speculative delay, won = those whose response completed the read
    # round (ack rank <= blockFor) — fired >> won means the delay floor
    # is too twitchy, won ~ fired means replicas genuinely straggle
    from ..service.metrics import GLOBAL as _METRICS
    return {"tables": tables, "caches": {
        "key": key,
        "row": _cache_line(row, entries=row_entries),
        "chunk": _cache_line(chunk_cache.GLOBAL.stats()),
    }, "requests": {
        "speculative_retries":
            _METRICS.counter("reads.speculative_retries"),
        "speculative_retries_won":
            _METRICS.counter("reads.speculative_retries_won"),
    }}


def flush(engine, keyspace: str | None = None,
          table: str | None = None) -> int:
    n = 0
    for cfs in list(engine.stores.values()):
        if keyspace and cfs.table.keyspace != keyspace:
            continue
        if table and cfs.table.name != table:
            continue
        if cfs.flush() is not None:
            n += 1
    return n


def compact(engine, keyspace: str | None = None,
            table: str | None = None) -> list[dict]:
    """nodetool compact: major compaction."""
    out = []
    for cfs in list(engine.stores.values()):
        if keyspace and cfs.table.keyspace != keyspace:
            continue
        if table and cfs.table.name != table:
            continue
        stats = engine.compactions.major_compaction(cfs)
        if stats is not None:
            out.append(stats)
    return out


def compactionstats(engine) -> dict:
    """nodetool compactionstats: pending count + per-task live progress
    (ActiveCompactions / CompactionManager.getMetrics in the reference;
    history moved to `compactionhistory`)."""
    cm = engine.compactions
    ex = cm.executor.stats()
    return {
        "pending_tasks": cm.pending_tasks(),
        "active_tasks": ex["active"],
        "concurrent_compactors": ex["concurrent"],
        "throughput_mib_per_sec": cm.limiter.mib_per_s,
        "completed_tasks": len(cm.completed),
        "active_compactions": cm.active.snapshot(),
    }


def commitlogstats(engine) -> dict:
    """nodetool commitlogstats: segment inventory + group-commit health
    (the reference surfaces CommitLogMetrics — waitingOnCommit,
    waitingOnSegmentAllocation, pending/completed tasks — via JMX; here
    the same numbers come from CommitLog.stats() and the
    commitlog.waiting_on_commit / commitlog.sync_latency histograms)."""
    cl = engine.commitlog
    if cl is None:
        return {"enabled": False}
    from ..service.metrics import GLOBAL
    st = cl.stats()
    st.pop("files", None)
    return {
        "enabled": True,
        **st,
        "group_window_ms": cl.group_window_ms,
        "waiting_on_commit_us":
            GLOBAL.hist("commitlog.waiting_on_commit").summary(),
        "sync_latency_us":
            GLOBAL.hist("commitlog.sync_latency").summary(),
    }


def tablestats(engine, keyspace: str | None = None) -> dict:
    """nodetool tablestats: per-table live-set stats plus the
    amplification accounting block — the observed byte counters
    (ingested/flushed/compacted in+out) and the derived
    write/space-amplification gauges the adaptive-compaction loop
    reads (storage/table.py amplification())."""
    out = {}
    for cfs in engine.stores.values():
        t = cfs.table
        if keyspace and t.keyspace != keyspace:
            continue
        live = cfs.live_sstables()
        amp = cfs.amplification()
        out[t.full_name()] = {
            "sstable_count": len(live),
            "space_used_bytes": sum(s.size_bytes for s in live),
            "cells": sum(s.n_cells for s in live),
            "partitions_estimate": sum(s.n_partitions for s in live),
            "tombstones": sum(s.n_tombstones for s in live),
            "memtable_cells": len(cfs.memtable),
            "reads": cfs.metrics["reads"],
            "writes": cfs.metrics["writes"],
            "flushes": cfs.metrics["flushes"],
            "bytes_ingested": cfs.metrics.get("bytes_ingested", 0),
            "bytes_flushed": cfs.metrics.get("bytes_flushed", 0),
            "bytes_compacted_in":
                cfs.metrics.get("bytes_compacted_in", 0),
            "bytes_compacted_out":
                cfs.metrics.get("bytes_compacted_out", 0),
            "write_amplification": amp["write_amplification"],
            "space_amplification": amp["space_amplification"],
            "sstables_per_read_p99":
                cfs.sstables_per_read.percentile(0.99),
            "row_cache": (None if cfs.row_cache is None
                          else {"hits": cfs.row_cache.hits,
                                "misses": cfs.row_cache.misses,
                                "entries": len(cfs.row_cache)}),
        }
    return out


def repair(node, keyspace: str, table: str | None = None,
           full: bool = False, preview: bool = False) -> list[dict]:
    """nodetool repair — incremental by default: validation still covers
    the FULL data set (unrepaired-only trees diverge once repaired
    status differs across replicas), but afterwards the validated
    unrepaired sstables are ANTICOMPACTED and stamped repairedAt so the
    compaction split applies; --full skips the stamping entirely."""
    out = []
    ks = node.schema.keyspaces[keyspace]
    for name in ([table] if table else list(ks.tables)):
        out.append({"table": f"{keyspace}.{name}",
                    **node.repair.repair_table(keyspace, name,
                                               incremental=not full,
                                               preview=preview)})
    return out


def cleanup(node, keyspace: str | None = None,
            table: str | None = None) -> list[dict]:
    """nodetool cleanup: rewrite sstables dropping cells for token
    ranges this node no longer replicates (post-bootstrap/move data
    reclamation — CompactionManager.performCleanup role)."""
    import numpy as np

    from ..cluster.replication import ReplicationStrategy
    from ..storage.cellbatch import (CellBatch, batch_tokens,
                                     token_range_mask)
    from ..storage.rewrite import rewrite_sstable
    out = []
    engine = node.engine
    for cfs in list(engine.stores.values()):
        t = cfs.table
        if keyspace and t.keyspace != keyspace:
            continue
        if table and t.name != table:
            continue
        ksm = node.schema.keyspaces.get(t.keyspace)
        if ksm is None:
            continue
        strat = ReplicationStrategy.create(ksm.params.replication)
        owned = []
        for lo, hi in node.ring.all_ranges():
            if node.endpoint in strat.replicas(node.ring, hi):
                if lo == hi:               # single-token ring: the one
                    owned.append((-(1 << 63), (1 << 63) - 1))  # arc IS
                elif lo <= hi:                         # the full ring
                    owned.append((lo, hi))
                else:                      # wrap arc
                    owned.append((-(1 << 63), hi))
                    owned.append((lo, (1 << 63) - 1))
        with engine.compactions.cfs_lock(cfs):
            for sst in list(cfs.live_sstables()):
                segs = list(sst.scanner())
                if not segs:
                    continue
                cat = CellBatch.concat(segs)
                cat.sorted = True
                keep = token_range_mask(batch_tokens(cat), owned)
                dropped = int((~keep).sum())
                if dropped == 0:
                    continue

                def fill(w, cat=cat, keep=keep):
                    idx = np.flatnonzero(keep)
                    if len(idx):
                        part = cat.apply_permutation(idx)
                        part.sorted = True
                        w.append(part)

                rewrite_sstable(cfs, sst,
                                [(sst.repaired_at, sst.level, fill)])
                out.append({"table": t.full_name(),
                            "generation": sst.desc.generation,
                            "cells_dropped": dropped})
    return out


def getendpoints(node, keyspace: str, table: str, key: str) -> list[str]:
    """nodetool getendpoints: replicas for a partition key. Values are
    converted by the COLUMN TYPE (never guessed from the text — a text
    key '7' must not tokenize as an int), and composite partition keys
    take ':'-separated components so the token matches the write path's
    composite framing."""
    from ..cluster.replication import ReplicationStrategy
    from .copyutil import _parse_value
    t = node.schema.get_table(keyspace, table)
    cols = t.partition_key_columns
    parts = key.split(":") if len(cols) > 1 else [key]
    if len(parts) != len(cols):
        raise ValueError(
            f"partition key of {keyspace}.{table} has {len(cols)} "
            f"components ({', '.join(c.name for c in cols)}); pass them "
            "':'-separated")
    vals = [_parse_value(p, c.cql_type) for p, c in zip(parts, cols)]
    pk = t.serialize_partition_key(vals)
    strat = ReplicationStrategy.create(
        node.schema.keyspaces[keyspace].params.replication)
    return [e.name for e in strat.replicas(node.ring,
                                           node.ring.token_of(pk))]


def gossipinfo(node) -> dict:
    """nodetool gossipinfo."""
    out = {}
    for ep, st in node.gossiper.states.items():
        out[ep.name] = {"generation": st.generation,
                        "version": st.version,
                        "alive": bool(st.alive),
                        "app_states": dict(st.app_states)}
    return out


def version(engine=None) -> dict:
    """nodetool version."""
    return {"release": "cassandra-tpu 2.0", "cql": "3.4.5",
            "sstable_format": "ctpu/ca"}


def describecluster(node) -> dict:
    """nodetool describecluster."""
    return {
        "name": "cassandra_tpu",
        "partitioner": "Murmur3Partitioner",
        "endpoints": [e.name for e in node.ring.endpoints],
        "schema_epoch": getattr(getattr(node, "schema_sync", None),
                                "epoch", None),
        # topology rides the same epoch log (TCM): the metadata epoch IS
        # the schema_sync epoch; kept as a separate key for operators
        "metadata_epoch": getattr(getattr(node, "schema_sync", None),
                                  "epoch", None),
        "pending_joins": [e.name for e in node.ring.pending],
        "replacing": {n.name: d.name
                      for n, d in node.ring.replacing.items()},
    }


def setcompactionthroughput(engine, mib_s: int) -> dict:
    """nodetool setcompactionthroughput (0 = unthrottled). Sets BOTH
    knob spellings so the modern name's precedence can never shadow an
    operator command. Routed through
    the mutable settings surface so the settings vtable, listeners and
    the limiter stay consistent."""
    engine.settings.set("compaction_throughput", float(mib_s))
    engine.settings.set("compaction_throughput_mib_per_sec", float(mib_s))
    return {"compaction_throughput_mib": mib_s}


def getcompactionthroughput(engine) -> dict:
    """nodetool getcompactionthroughput."""
    return {"compaction_throughput_mib":
            int(engine.compactions.limiter.rate // 2**20)}


def setslowquerythreshold(engine, ms: float) -> dict:
    """slow_query_log_timeout_in_ms knob (db/monitoring role)."""
    engine.monitor.threshold_ms = float(ms)
    return {"slow_query_threshold_ms": float(ms)}


def upgradesstables(engine, keyspace: str | None = None,
                    table: str | None = None) -> list[dict]:
    """nodetool upgradesstables: rewrite every sstable in the current
    format (compaction/Upgrader role — after a format revision, old
    generations are re-serialized through the current writer)."""
    from ..storage.rewrite import rewrite_sstable
    out = []
    for cfs in list(engine.stores.values()):
        if keyspace and cfs.table.keyspace != keyspace:
            continue
        if table and cfs.table.name != table:
            continue
        with engine.compactions.cfs_lock(cfs):
            for sst in list(cfs.live_sstables()):
                def fill(w, sst=sst):
                    for i in range(sst.n_segments):
                        w.append(sst._read_segment(i))

                new = rewrite_sstable(
                    cfs, sst, [(sst.repaired_at, sst.level, fill)])
                out.append({"table": cfs.table.full_name(),
                            "from_generation": sst.desc.generation,
                            "to_generation":
                                new[0].desc.generation if new else None})
    return out


def sstablesplit(engine, keyspace: str, table: str,
                 target_mib: int = 50) -> list[dict]:
    """SSTableSplitter role: carve an oversized sstable into ~target
    sized outputs, split at partition boundaries."""
    import numpy as np

    from ..storage.cellbatch import CellBatch
    from ..storage.rewrite import rewrite_sstable
    cfs = engine.store(keyspace, table)
    target = max(1, target_mib * 2**20)
    out = []
    with engine.compactions.cfs_lock(cfs):
        for sst in list(cfs.live_sstables()):
            if sst.data_size <= target:
                continue
            n_parts = min(64, max(2, -(-sst.data_size // target)))
            segs = list(sst.scanner())
            if not segs:
                continue
            cat = CellBatch.concat(segs)
            cat.sorted = True
            # partition boundaries: first cell of each partition (the
            # token+pkh lanes change)
            keys = cat.lanes[:, 0].astype(np.uint64) << np.uint64(32) \
                | cat.lanes[:, 1]
            starts = np.flatnonzero(np.diff(keys) != 0) + 1
            cuts = [0]
            for p in range(1, n_parts):
                want = p * len(cat) // n_parts
                j = int(np.searchsorted(starts, want))
                cut = int(starts[j]) if j < len(starts) else len(cat)
                if cut > cuts[-1]:
                    cuts.append(cut)
            cuts.append(len(cat))

            def fill_for(lo, hi, cat=cat):
                def fill(w):
                    part = cat.slice_range(lo, hi)
                    part.sorted = True
                    w.append(part)
                return fill

            parts = [(sst.repaired_at, sst.level, fill_for(lo, hi))
                     for lo, hi in zip(cuts, cuts[1:]) if hi > lo]
            new = rewrite_sstable(cfs, sst, parts)
            out.append({"table": cfs.table.full_name(),
                        "generation": sst.desc.generation,
                        "outputs": [r.desc.generation for r in new]})
    return out


def ring(node) -> list[dict]:
    out = []
    for ep, toks in sorted(node.ring.endpoints.items(),
                           key=lambda kv: kv[0].name):
        for t in sorted(toks):
            out.append({"token": t, "endpoint": ep.name})
    return out


def snapshot(engine, keyspace: str | None = None,
             table: str | None = None, tag: str | None = None) -> list[str]:
    """nodetool snapshot."""
    from ..storage import snapshot as snap
    out = []
    for cfs in engine.stores.values():
        if keyspace and cfs.table.keyspace != keyspace:
            continue
        if table and cfs.table.name != table:
            continue
        cfs.flush()   # snapshots must include memtable contents
        out.append(f"{cfs.table.full_name()}:{snap.snapshot(cfs, tag)}")
    return out


def listsnapshots(engine) -> list[dict]:
    from ..storage import snapshot as snap
    out = []
    for cfs in engine.stores.values():
        out.extend(snap.list_snapshots(cfs))
    return out


def clearsnapshot(engine, tag: str | None = None) -> int:
    from ..storage import snapshot as snap
    return sum(snap.clear_snapshot(cfs, tag)
               for cfs in engine.stores.values())


def scrub(engine, keyspace: str | None = None,
          table: str | None = None, snapshot_before: bool = True,
          quarantine: bool = False) -> list[dict]:
    """nodetool scrub: rewrite each sstable keeping every readable
    segment, dropping corrupt ones (io/sstable/format/
    SortedTableScrubber role). The unreadable cells are gone either way;
    scrub turns a read-aborting sstable into a clean one.

    snapshot_before: hardlink the whole live set into a
    `pre-scrub-<ts>` snapshot first (the reference's
    snapshot-before-scrub — scrub is lossy by design, so the originals
    stay recoverable). quarantine: an sstable too rotten to rewrite at
    all (index/open-level corruption, I/O errors) moves into the
    quarantine set instead of staying live and aborting the scrub."""
    import time as _time

    from ..storage import snapshot as snap
    from ..storage.rewrite import rewrite_sstable
    from ..storage.sstable.reader import CorruptSSTableError
    out = []
    for cfs in list(engine.stores.values()):
        if keyspace and cfs.table.keyspace != keyspace:
            continue
        if table and cfs.table.name != table:
            continue
        with engine.compactions.cfs_lock(cfs):
            tag = None
            if snapshot_before and cfs.live_sstables():
                tag = f"pre-scrub-{int(_time.time() * 1000)}"
                snap.snapshot(cfs, tag)
            for sst in list(cfs.live_sstables()):
                counts = {"kept": 0, "dropped": 0}

                def fill(w, sst=sst, counts=counts):
                    for i in range(sst.n_segments):
                        try:
                            seg = sst._read_segment(i)
                        except CorruptSSTableError:
                            counts["dropped"] += 1
                            continue
                        w.append(seg)
                        counts["kept"] += 1

                try:
                    rewrite_sstable(cfs, sst,
                                    [(sst.repaired_at, sst.level, fill)])
                except (CorruptSSTableError, OSError) as e:
                    if not quarantine:
                        raise
                    cfs.failures.handle(e, sst.desc.path("Data.db"))
                    cfs.quarantine_sstable(sst, e)
                    out.append({"table": cfs.table.full_name(),
                                "generation": sst.desc.generation,
                                "quarantined": True, "error": str(e),
                                "snapshot": tag})
                    continue
                out.append({"table": cfs.table.full_name(),
                            "generation": sst.desc.generation,
                            "segments_kept": counts["kept"],
                            "segments_dropped": counts["dropped"],
                            "snapshot": tag})
    return out


def garbagecollect(engine, keyspace: str | None = None,
                   table: str | None = None) -> list[dict]:
    """Single-sstable rewrite dropping gc-able tombstones
    (nodetool garbagecollect)."""
    from ..compaction.task import CompactionTask
    out = []
    for cfs in list(engine.stores.values()):
        if keyspace and cfs.table.keyspace != keyspace:
            continue
        if table and cfs.table.name != table:
            continue
        with engine.compactions.cfs_lock(cfs):
            for sst in list(cfs.live_sstables()):
                out.append(CompactionTask(cfs, [sst]).execute())
    return out


# ------------------------------------------------- round-3 command set --

def netstats(node) -> dict:
    """nodetool netstats: live sessioned-transfer progress (chunks and
    bytes, mid-flight), terminal session summaries, internode counters."""
    from ..storage.virtual import _snapshot
    svc = getattr(node, "streams", None)
    live = svc.progress() if svc is not None \
        and hasattr(svc, "progress") else []
    return {"streams": live,
            "streaming": _snapshot(getattr(node.streams, "sessions", [])),
            "messaging": dict(node.messaging.metrics)}


def tpstats(engine) -> list[dict]:
    """nodetool tpstats (thread_pools vtable data)."""
    cm = engine.compactions
    ex = cm.executor.stats()
    return [{"pool": "CompactionExecutor",
             "active": ex["active"],
             "pending": cm.pending_tasks(),
             # compactions actually executed (agrees with
             # compactionstats.completed_tasks), not executor callables
             "completed": len(cm.completed)},
            {"pool": "MemtableFlushWriter", "active": 0, "pending": 0,
             "completed": sum(cfs.metrics.get("flushes", 0)
                              for cfs in engine.stores.values())}]


def proxyhistograms(node) -> dict:
    """nodetool proxyhistograms: coordinator-side latency percentiles."""
    from ..service.metrics import GLOBAL
    s = GLOBAL.hist("cql.request").summary()   # one consistent read
    with node.proxy._lat_lock:
        lat = dict(node.proxy._latency)
    return {"request": {"p50_us": s["p50_us"],
                        "p95_us": s["p95_us"],
                        "p99_us": s["p99_us"],
                        "count": s["count"]},
            "replica_ewma_ms": {ep.name: round(v * 1000, 3)
                                for ep, v in lat.items()}}


def compactionhistory(engine) -> list[dict]:
    """nodetool compactionhistory."""
    from ..storage.virtual import _snapshot
    out = []
    for cfs in engine.stores.values():
        # bounded deque: copy before iterating (a finishing compaction
        # appends concurrently)
        for st in _snapshot(cfs.compaction_history):
            out.append({"table": cfs.table.full_name(), **st})
    return out


def clientstats(node) -> list[dict]:
    """nodetool clientstats: connected native-protocol clients
    (ClientsTable role: address, protocol version, requests served,
    in-flight on the dispatch executor, requests shed by the per-client
    rate limiter)."""
    out = []
    for srv in getattr(node, "cql_servers", []):
        for info in list(srv.clients.values()):
            conn = info["conn"]
            out.append({"id": info["id"], "address": info["address"],
                        "user": conn.user or "anonymous",
                        "keyspace": conn.keyspace or "",
                        "version": conn.version or 0,
                        "requests": info["requests"],
                        "in_flight": conn.in_flight,
                        "rate_limited": conn.rate_limited})
    return out


def gettimeout(node, timeout_type: str = "read") -> dict:
    """nodetool gettimeout <read|write|range>."""
    attr = {"read": "read_timeout", "write": "write_timeout",
            "range": "range_timeout"}[timeout_type]
    return {timeout_type: getattr(node.proxy, attr) * 1000.0}


def settimeout(node, timeout_type: str, ms: float) -> dict:
    """nodetool settimeout <read|write|range> <ms> (through settings)."""
    name = {"read": "read_request_timeout",
            "write": "write_request_timeout",
            "range": "range_request_timeout"}[timeout_type]
    node.engine.settings.set(name, f"{int(ms)}ms")
    return gettimeout(node, timeout_type)


def getstreamthroughput(engine) -> dict:
    return {"stream_throughput_mib":
            engine.settings.get("stream_throughput_outbound")}


def setstreamthroughput(engine, mib_s: float) -> dict:
    engine.settings.set("stream_throughput_outbound", float(mib_s))
    return getstreamthroughput(engine)


def getconcurrentcompactors(engine) -> dict:
    return {"concurrent_compactors":
            engine.settings.get("concurrent_compactors")}


def setconcurrentcompactors(engine, n: int) -> dict:
    """nodetool setconcurrentcompactors: validated here so the settings
    surface can never report a value the executor silently clamps
    (DatabaseDescriptor.setConcurrentCompactors rejects < 1 too)."""
    if int(n) < 1:
        raise ValueError(f"concurrent_compactors must be >= 1, got {n}")
    engine.settings.set("concurrent_compactors", int(n))
    return getconcurrentcompactors(engine)


def gettraceprobability(engine) -> dict:
    return {"trace_probability": engine.settings.get("trace_probability")}


def settraceprobability(engine, p: float) -> dict:
    """nodetool settraceprobability: sample rate for background request
    tracing — Session.execute consults it via tracing.should_sample();
    sampled statements land in the engine's TraceStore
    (system_traces.sessions / `nodetool gettraces`)."""
    if not 0.0 <= float(p) <= 1.0:
        raise ValueError(f"trace probability must be in [0, 1], got {p}")
    engine.settings.set("trace_probability", float(p))
    return gettraceprobability(engine)


def gettraces(engine, limit: int = 20) -> list[dict]:
    """nodetool gettraces: recent completed trace sessions with their
    merged coordinator+replica timelines (system_traces role)."""
    out = []
    for st in engine.trace_store.sessions()[-int(limit):]:
        out.append({
            "session_id": st.session_id,
            "request": st.request,
            "started_at_ms": int(st.started_at * 1000),
            "duration_us": st.duration_us,
            "events": [{"elapsed_us": us, "source": src,
                        "activity": activity}
                       for us, src, activity in list(st.events)],
        })
    return out


def exportmetrics(engine) -> str:
    """nodetool exportmetrics: the full registry in Prometheus
    exposition format (counters, gauges, decayed latency summaries) plus
    this engine's compaction gauges."""
    from ..service.metrics import prometheus_text
    return prometheus_text(extra_gauges=engine.compactions.gauges())


def diagnostics(engine, limit: int = 50,
                event_type: str | None = None) -> dict:
    """nodetool diagnostics: recent typed diagnostic events from the
    bus (diag/DiagnosticEventService role). Empty until the mutable
    `diagnostic_events_enabled` knob flips on."""
    from ..service import diagnostics as diag
    return {"enabled": diag.GLOBAL.enabled,
            "types": diag.GLOBAL.types(),
            "events": [e.to_dict() for e in
                       diag.GLOBAL.events(event_type,
                                          limit=int(limit))]}


def flightrecorder(engine, action: str = "dump") -> dict:
    """nodetool flightrecorder [dump|status]: the black box. `dump`
    writes a self-contained JSON bundle (diagnostic events, metric +
    tpstats snapshot ring, recent traces, failure state, settings)
    under <data_dir>/diagnostics/ — the same bundle a failure policy
    (stop/die/stop_commit) or a quarantine dumps automatically."""
    rec = engine.flight_recorder
    if action == "status":
        return {"events_buffered": len(rec._events),
                "snapshots_buffered": len(rec._snapshots),
                "dumps": list(rec.dumps)}
    if action != "dump":
        raise ValueError(f"unknown flightrecorder action {action!r}")
    path = rec.dump("on_demand")
    return {"bundle": path}


def slostats(engine) -> dict:
    """nodetool slostats: per-objective SLO state — current p99 vs
    target, error budget remaining, breach/exhaustion tallies. Runs a
    REAL `check()` (budgets burn/replenish, a live breach publishes
    `slo.breach` and dumps a deduplicated flight-recorder bundle), so
    the operator asking for slostats gets the current verdict, not the
    last poll's; the `system_views.slos` vtable is the side-effect-free
    view."""
    svc = engine.slo
    return {"objectives": svc.check(),
            "checks": svc.checks,
            "recorder_dumps": list(getattr(svc.recorder, "dumps", []))}


def pipelinestats(engine) -> dict:
    """nodetool pipelinestats: the unified pipeline ledger — per-stage
    busy/stall/idle seconds, items/bytes and queue high-water for every
    multi-stage pipeline (utils/pipeline_ledger.py; the
    system_views.pipelines vtable serves the same rows)."""
    from ..utils import pipeline_ledger
    return pipeline_ledger.snapshot_all()


def metricshistory(engine, name: str | None = None,
                   resolution: str = "raw",
                   limit: int = 50, rate: bool = False) -> dict:
    """nodetool metricshistory [name=<metric>] [resolution=raw|coarse]
    [limit=N] [rate=true]: the retained metrics time series
    (service/history.py). Without `name`, lists the series and the
    sampler state; with it, returns the newest `limit` buckets (and
    the derived per-second counter rate when rate=true). The
    system_views.metrics_history vtable serves the same rows."""
    svc = engine.metrics_history
    if name is None:
        return {**svc.stats(), "series_names": svc.names()}
    out = {"name": name, "resolution": resolution,
           "buckets": svc.query(name, resolution, limit=int(limit))}
    if rate:
        out["rate_per_s"] = svc.rate(name, limit=int(limit))
    return out


def profiler(engine, action: str = "status",
             session: str | None = None, limit: int = 50) -> dict:
    """nodetool profiler [start|stop|dump|status]: the continuous
    wall-clock profiler (service/sampler.py) + device program registry
    (service/profiling.py) — observability layer 6.

    - start [session=<name>]: open an on-demand profiling window (the
      sampler thread boots even with `profiler_enabled` off);
    - stop [session=<id>]: seal a window (newest if unnamed) and
      return its cpu/blocked split;
    - dump [session=<id>] [limit=N]: the collapsed-stack flamegraph
      (hottest first) + split of a session, or of the always-on ring
      when no session is named — feed the lines to flamegraph.pl
      as-is;
    - status: sampler state + the per-program compile/dispatch/execute
      registry (the system_views.profiles / device_programs vtables
      serve the same)."""
    from ..service import profiling as _profiling
    from ..service import sampler as _sampler
    sp = _sampler.GLOBAL
    if action == "start":
        sid = sp.start_session(name=session)
        return {"session": sid, "running": sp.running,
                "interval_s": sp.interval_s}
    if action == "stop":
        return sp.stop_session(session)
    if action == "dump":
        target = session or "ring"
        return {"target": target,
                "split": sp.split(target),
                "flamegraph": sp.collapsed(target, limit=int(limit))}
    if action == "status":
        return {**sp.stats(),
                "retrace_budget": _profiling.GLOBAL.retrace_budget,
                "device_programs":
                    _profiling.GLOBAL.snapshot()["kernels"]}
    raise ValueError(
        f"unknown profiler action {action!r} (start|stop|dump|status)")


def clusterstats(node, timeout: float = 2.0) -> dict:
    """nodetool clusterstats: the one-screen RF-aware cluster view —
    every peer's telemetry snapshot pulled over the METRICS_SNAPSHOT
    verb (local node served directly), with per-node staleness stamps:
    a dark node's row carries its LAST known snapshot and how stale it
    is, never a hang (the pull is bounded by `timeout`)."""
    pulled = node.pull_cluster_telemetry(timeout=float(timeout))
    keyspaces = {}
    for ksname, ks in node.schema.keyspaces.items():
        rep = dict(getattr(ks.params, "replication", {}) or {})
        rf = rep.get("replication_factor")
        keyspaces[ksname] = {
            "replication": rep,
            "rf": int(rf) if rf is not None else None,
        }
    screen = []
    for row in pulled["nodes"]:
        snap = row.get("snapshot") or {}
        tabs = snap.get("tables", {})
        wa = {t: v.get("write_amplification") for t, v in tabs.items()}
        screen.append(
            f"{row['endpoint']:>8} "
            f"{'UP' if row['alive'] else 'DOWN':>4} "
            f"stale={'-' if row['stale_s'] is None else round(row['stale_s'], 2)} "
            f"writes={snap.get('storage_writes', '-')} "
            f"pending_compactions={snap.get('compactions', {}).get('compaction.pending_tasks', '-')} "
            f"wa={wa}")
    return {"nodes": pulled["nodes"], "keyspaces": keyspaces,
            "ring_size": len(node.ring.endpoints),
            "screen": screen}


def disableautocompaction(engine) -> dict:
    """nodetool disableautocompaction (pauses the background worker's
    submissions; running tasks finish)."""
    engine.compactions.paused = True
    return {"auto_compaction": "disabled"}


def enableautocompaction(engine) -> dict:
    engine.compactions.paused = False
    return {"auto_compaction": "enabled"}


def statusautocompaction(engine) -> dict:
    return {"running": not getattr(engine.compactions, "paused", False)}


def autocompaction(engine, action: str = "status",
                   limit: int = 20) -> dict:
    """nodetool autocompaction [status|history|freeze|unfreeze]: the
    adaptive compaction controller surface (control/loop.py).

    - status: loop/frozen state, tick/decision counters and every
      table's current regime + recent-window signals;
    - history: the newest `limit` rows of the bounded decision ledger
      (the system_views.controller_decisions vtable serves the same);
    - freeze / unfreeze: keep the loop ticking but apply NOTHING —
      persisted under the data dir, so the freeze survives an engine
      restart."""
    ctrl = engine.controller
    if action == "status":
        return {**ctrl.stats(), "tables": ctrl.table_regimes()}
    if action == "history":
        return {"decisions": ctrl.decisions(limit=int(limit))}
    if action == "freeze":
        ctrl.freeze()
        return {"controller": "frozen"}
    if action == "unfreeze":
        ctrl.unfreeze()
        return {"controller": "unfrozen"}
    raise ValueError(
        f"unknown autocompaction action {action!r} "
        f"(status|history|freeze|unfreeze)")


def disablehandoff(node) -> dict:
    """nodetool disablehandoff: stop storing new hints."""
    node.hints.enabled = False
    return {"handoff": "disabled"}


def enablehandoff(node) -> dict:
    node.hints.enabled = True
    return {"handoff": "enabled"}


def statushandoff(node) -> dict:
    return {"handoff": "running"
            if getattr(node.hints, "enabled", True) else "disabled"}


def truncatehints(node, endpoint: str | None = None) -> dict:
    """nodetool truncatehints [endpoint] — delegates to
    HintsService.truncate, which holds the service lock so a concurrent
    store()/dispatch() can't race the deletes."""
    return {"truncated_files": node.hints.truncate(endpoint)}


def statusgossip(node) -> dict:
    return {"gossip": "running" if node.gossiper.is_running()
            else "not running"}


def statusbinary(node) -> dict:
    return {"native_transport": "running"
            if getattr(node, "cql_servers", []) else "not running"}


def drain(node) -> dict:
    """nodetool drain: flush everything, stop accepting new compactions;
    the commitlog is synced so restart replays nothing."""
    node.engine.compactions.paused = True
    node.engine.flush_all()
    if node.engine.commitlog is not None:
        node.engine.commitlog.sync()
    return {"drained": True}


def refresh(engine, keyspace: str, table: str) -> dict:
    """nodetool refresh: pick up sstables dropped into the data dir
    out-of-band (bulk load path)."""
    cfs = engine.store(keyspace, table)
    before = len(cfs.live_sstables())
    cfs.reload_sstables()
    return {"sstables_before": before,
            "sstables_after": len(cfs.live_sstables())}


def invalidaterowcache(engine) -> dict:
    n = 0
    for cfs in engine.stores.values():
        if cfs.row_cache is not None:
            cfs.row_cache.clear()
            n += 1
    return {"invalidated_tables": n}


def invalidatechunkcache(engine) -> dict:
    from ..storage import chunk_cache
    chunk_cache.GLOBAL.clear()
    return {"invalidated": True}


def invalidatecountercache(node) -> dict:
    node.counters.invalidate_cache()
    return {"invalidated": True}


def getsstables(engine, keyspace: str, table: str, key: str) -> list[str]:
    """nodetool getsstables: which sstables hold a partition key."""
    from .copyutil import _parse_value
    t = engine.store(keyspace, table).table
    cols = t.partition_key_columns
    parts = key.split(":") if len(cols) > 1 else [key]
    vals = [_parse_value(p, c.cql_type) for p, c in zip(parts, cols)]
    pk = t.serialize_partition_key(vals)
    cfs = engine.store(keyspace, table)
    out = []
    for sst in cfs.live_sstables():
        if sst.might_contain(pk):
            out.append(f"{sst.desc.version}-{sst.desc.generation}")
    return out


def verify(engine, keyspace: str | None = None,
           table: str | None = None,
           quarantine: bool = False) -> list[dict]:
    """nodetool verify: recheck each sstable's digest against its data.
    quarantine=True hands every failing sstable to the quarantine set
    (the --quarantine handoff: a failed verify must not leave a known-
    corrupt file live)."""
    from ..storage.sstable.reader import CorruptSSTableError
    out = []
    for cfs in list(engine.stores.values()):
        t = cfs.table
        if keyspace and t.keyspace != keyspace:
            continue
        if table and t.name != table:
            continue
        for sst in list(cfs.live_sstables()):
            entry = {"sstable": sst.desc.generation,
                     "table": t.full_name()}
            try:
                ok = sst.verify_digest()
            except Exception as e:
                ok = False
                entry["error"] = str(e)
            entry["ok"] = bool(ok)
            if not ok and quarantine:
                err = CorruptSSTableError(
                    f"{sst.desc}: verify failed", descriptor=sst.desc)
                cfs.failures.handle_corruption(
                    err, sst.desc.path("Data.db"))
                cfs.quarantine_sstable(sst, err)
                entry["quarantined"] = True
            out.append(entry)
    return out


def assassinate(node, endpoint: str) -> dict:
    """nodetool assassinate: force-convict an endpoint without waiting
    for phi (Gossiper.assassinateEndpoint role)."""
    for ep in node.ring.endpoints:
        if ep.name == endpoint:
            node.gossiper.force_convict(ep)
            return {"assassinated": endpoint}
    raise ValueError(f"unknown endpoint {endpoint!r}")


def listquarantine(engine, keyspace: str | None = None,
                   table: str | None = None) -> list[dict]:
    """nodetool listquarantine: corrupt sstables blacklisted out of the
    live set (the quarantined_sstables vtable's data, per table)."""
    out = []
    for cfs in engine.stores.values():
        if keyspace and cfs.table.keyspace != keyspace:
            continue
        if table and cfs.table.name != table:
            continue
        for q in list(getattr(cfs, "quarantined", [])):
            out.append({"table": cfs.table.full_name(),
                        "generation": q["generation"],
                        "reason": q.get("reason", ""),
                        "bytes": q.get("bytes", 0),
                        "path": q.get("path", "")})
    return out


def listpendinghints(node) -> list[dict]:
    import os as _os
    out = []
    d = node.hints.directory
    for fn in sorted(_os.listdir(d)):
        if fn.startswith("hints-"):
            out.append({"target": fn[len("hints-"):-3],
                        "bytes": _os.path.getsize(_os.path.join(d, fn))})
    return out


def getlogginglevels() -> dict:
    import logging
    return {name: logging.getLevelName(logging.getLogger(name).level)
            for name in sorted(logging.root.manager.loggerDict)
            if name.startswith("cassandra_tpu")} or \
        {"root": logging.getLevelName(logging.root.level)}


def setlogginglevel(logger: str = "root", level: str = "INFO") -> dict:
    import logging
    lg = logging.root if logger == "root" else logging.getLogger(logger)
    lg.setLevel(level.upper())
    return {logger: level.upper()}


def updatecidrgroup(engine, name: str, cidrs) -> dict:
    """nodetool updatecidrgroup <name> <cidrs> — define/replace a named
    CIDR group (auth/CIDRPermissionsManager)."""
    if isinstance(cidrs, str):
        cidrs = [c.strip() for c in cidrs.split(",") if c.strip()]
    engine.auth.set_cidr_group(name, cidrs)
    return {name: cidrs}


def dropcidrgroup(engine, name: str) -> dict:
    engine.auth.drop_cidr_group(name)
    return {"dropped": name}


def listcidrgroups(engine) -> dict:
    return dict(engine.auth.cidr_groups)


def invalidatecredentialscache(engine) -> dict:
    """nodetool invalidatecredentialscache / invalidatepermissionscache:
    drop all AuthCache verdicts."""
    engine.auth.cache.invalidate_all()
    return {"invalidated": True}


def decommission(node) -> dict:
    """nodetool decommission (streams ranges away, leaves the ring)."""
    node.decommission()
    return {"decommissioned": node.endpoint.name}


def move(node, new_token: int) -> dict:
    """nodetool move <token> (TCM Move sequence)."""
    node.move_tokens([int(new_token)])
    return {"moved_to": int(new_token)}


# Registry: name -> (target kind, callable). Target "node" needs the full
# cluster Node; "engine" works on a bare StorageEngine (offline --data
# mode supports only those); "none" needs neither.
def repair_admin(node, list_all: bool = False) -> list[dict]:
    """nodetool repair_admin — durable repair-session records
    (repair/consistent/LocalSessions role): by default the sessions
    still IN_PROGRESS (including ones orphaned by a coordinator crash,
    read back from the journal after restart); --list_all for the full
    history."""
    store = node.repair.sessions
    return store.sessions() if list_all else store.in_flight()


def bulkload(node, directory: str, keyspace: str, table: str) -> dict:
    """nodetool bulkload — ring-aware streaming of externally-written
    sstables into the cluster (tools/BulkLoader.java role; see
    tools/sstableloader.py for the standalone CLI)."""
    from .sstableloader import load
    return load(directory, node, keyspace, table)


def rebuild(node, keyspace: str | None = None) -> dict:
    """nodetool rebuild — re-stream every range this node replicates
    from a surviving replica (tools/nodetool/Rebuild.java): entire
    in-range sstables land as component files, boundary-straddling data
    as merged batches. Used after disk loss or to fill a node that
    joined without bootstrap."""
    from ..cluster.replication import ReplicationStrategy
    MIN, MAX = -(1 << 63), (1 << 63) - 1
    total_files = 0
    total_cells = 0
    ranges_done = 0
    for ks in list(node.schema.keyspaces.values()):
        if keyspace and ks.name != keyspace:
            continue
        if not ks.tables:
            continue
        strat = ReplicationStrategy.create(ks.params.replication)
        for lo, hi in node.ring.all_ranges():
            replicas = strat.replicas(node.ring, hi)
            if node.endpoint not in replicas:
                continue
            sources = [e for e in replicas
                       if e != node.endpoint and node.is_alive(e)]
            if not sources:
                # RF=1 ranges have no other replica; skip silently only
                # when we are the SOLE replica, else surface the outage
                if len(replicas) > 1:
                    raise RuntimeError(
                        f"rebuild: no live source for range ({lo}, {hi}] "
                        f"of {ks.name} (replicas {replicas})")
                continue
            ranges_done += 1
            for tname in ks.tables:
                arcs = [(MIN, hi), (lo, MAX)] if lo > hi else [(lo, hi)]
                for alo, ahi in arcs:
                    res = node.streams.stream_range(
                        sources[0], ks.name, tname, alo, ahi,
                        timeout=max(node.proxy.timeout, 30.0))
                    total_files += int(res["files"])
                    total_cells += int(res["cells"])
    return {"ranges": ranges_done, "files_streamed": total_files,
            "cells_streamed": total_cells}



COMMANDS: dict = {}
# --------------------------------------------------------------------------
# round-5 breadth: the reference's long tail, each wired to real machinery
# (tools/nodetool/*.java counterparts named per function)


def describering(node, keyspace: str) -> list[dict]:
    """nodetool describering: every token range with its endpoints
    (tools/nodetool/DescribeRing.java)."""
    from ..cluster.replication import ReplicationStrategy
    ks = node.schema.keyspaces[keyspace]
    strat = ReplicationStrategy.create(ks.params.replication)
    out = []
    for lo, hi in node.ring.all_ranges():
        out.append({"start_token": lo, "end_token": hi,
                    "endpoints": [e.name for e in
                                  strat.replicas(node.ring, hi)]})
    return out


def cmsadmin(node) -> dict:
    """nodetool cmsadmin describe: CMS membership + epoch state
    (tools/nodetool/CMSAdmin.java over the Paxos-backed CMS)."""
    sync = getattr(node, "schema_sync", None)
    if sync is None:
        return {"cms": None, "reason": "no metadata log on this node"}
    return {"members": [m.name for m in sync.cms_members()],
            "is_member": sync.cms.is_member(),
            "epoch": sync.epoch,
            "log_tail": [(e[0], e[1][:60]) for e in
                         sync.entries_after(max(0, sync.epoch - 5))]}


def failuredetectorinfo(node) -> list[dict]:
    """nodetool failuredetector: per-endpoint phi
    (tools/nodetool/FailureDetectorInfo.java)."""
    g = node.gossiper
    now = g.clock()
    out = []
    with g._lock:
        for ep, st in g.states.items():
            if ep == g.ep:
                continue
            out.append({"endpoint": ep.name, "alive": st.alive,
                        "phi": round(g.detector.phi(st, now), 3)})
    return out


def gcstats(node=None, engine=None) -> dict:
    """nodetool gcstats — the runtime's collector statistics (for a
    Python runtime: gc generation counts/collections, the JVM GC role)."""
    import gc
    stats = gc.get_stats()
    return {"collections": [s.get("collections", 0) for s in stats],
            "collected": [s.get("collected", 0) for s in stats],
            "uncollectable": [s.get("uncollectable", 0) for s in stats],
            "tracked_objects": len(gc.get_objects())}


def tablehistograms(engine, keyspace: str | None = None,
                    table: str | None = None) -> dict:
    """nodetool tablehistograms [<ks> [<table>]]: per-table
    distributions (tools/nodetool/TableHistograms.java) — reference
    parity: read/write latency and SSTables-per-read percentiles from
    the live decaying histograms, beside the size/cell/partition
    distributions from sstable metadata."""
    out = {}
    for cfs in engine.stores.values():
        t = cfs.table
        if keyspace and t.keyspace != keyspace:
            continue
        if table and t.name != table:
            continue
        live = cfs.live_sstables()
        sizes = sorted(s.data_size for s in live)
        cells = sorted(s.n_cells for s in live)
        parts = sorted(s.n_partitions for s in live)

        def pct(v, p):
            return v[min(len(v) - 1, int(len(v) * p))] if v else 0

        def latency(h):
            s = h.summary()   # one consistent read per hist
            return {"p50_us": s["p50_us"], "p95_us": s["p95_us"],
                    "p99_us": s["p99_us"], "max_us": s["max_us"],
                    "count": s["count"]}
        spr = cfs.sstables_per_read.summary()
        out[t.full_name()] = {
            "sstables": len(live),
            "data_size": {"p50": pct(sizes, 0.5), "max": pct(sizes, 1.0)},
            "cells": {"p50": pct(cells, 0.5), "max": pct(cells, 1.0)},
            "partitions": {"p50": pct(parts, 0.5),
                           "max": pct(parts, 1.0)},
            "read_latency": latency(cfs.read_hist),
            "write_latency": latency(cfs.write_hist),
            # the hist records sstables CONSULTED per point read, so
            # the "_us" summary keys are unit-less counts here
            "sstables_per_read": {"p50": spr["p50_us"],
                                  "p95": spr["p95_us"],
                                  "p99": spr["p99_us"],
                                  "max": spr["max_us"],
                                  "count": spr["count"]},
        }
    return out


def toppartitions(engine, keyspace: str, table: str,
                  k: int = 10) -> list[dict]:
    """nodetool toppartitions: largest partitions by on-disk cells,
    summed across live sstables' partition directories
    (tools/nodetool/TopPartitions.java, size sampler role)."""
    import numpy as np
    cfs = engine.store(keyspace, table)
    totals: dict[bytes, int] = {}
    for sst in cfs.live_sstables():
        # per-partition cell counts: first-cell offsets diffed against
        # the next start (the last partition runs to n_cells)
        c0 = np.append(np.asarray(sst._part_cell0), sst.n_cells)
        for i in range(sst.n_partitions):
            pk = sst.partition_key_at(i)
            totals[pk] = totals.get(pk, 0) + int(c0[i + 1] - c0[i])
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
    return [{"partition_key": pk.hex(), "cells": n} for pk, n in top]


def rangekeysample(engine, keyspace: str, table: str,
                   n: int = 100) -> list[str]:
    """nodetool rangekeysample: sampled partition keys from the
    partition directories (tools/nodetool/RangeKeySample.java)."""
    cfs = engine.store(keyspace, table)
    keys = []
    for sst in cfs.live_sstables():
        step = max(1, sst.n_partitions // max(1, n // max(
            1, len(cfs.live_sstables()))))
        for i in range(0, sst.n_partitions, step):
            keys.append(sst.partition_key_at(i).hex())
    return keys[:n]


def datapaths(engine, keyspace: str | None = None) -> dict:
    """nodetool datapaths (tools/nodetool/DataPaths.java)."""
    return {cfs.table.full_name(): cfs.directory
            for cfs in engine.stores.values()
            if not keyspace or cfs.table.keyspace == keyspace}


def viewbuildstatus(node, keyspace: str | None = None) -> list[dict]:
    """nodetool viewbuildstatus (tools/nodetool/ViewBuildStatus.java):
    registered views and their backfill state (registrations persist;
    backfill runs at CREATE, so a registered view is built)."""
    out = []
    for (ks, name), info in getattr(node.schema, "views", {}).items():
        if keyspace and ks != keyspace:
            continue
        out.append({"keyspace": ks, "view": name,
                    "base": ".".join(info.get("base", ("?", "?"))),
                    "status": "SUCCESS"})
    return out


# ---- gossip / binary / protocol toggles ----------------------------------


def disablegossip(node) -> dict:
    node.gossiper.stop()
    return {"gossip": "stopped"}


def enablegossip(node) -> dict:
    if not node.gossiper.is_running():
        node.gossiper.start()
    return {"gossip": "running"}


def disablebinary(node) -> dict:
    """Refuse NEW native-protocol connections (in-flight ones drain —
    tools/nodetool/DisableBinary.java semantics)."""
    for srv in getattr(node, "cql_servers", []):
        srv.paused = True
    return {"native_transport": "paused"}


def enablebinary(node) -> dict:
    for srv in getattr(node, "cql_servers", []):
        srv.paused = False
    return {"native_transport": "running"}


def disableoldprotocolversions(node) -> dict:
    """Only the NEWEST protocol version may connect
    (tools/nodetool/DisableOldProtocolVersions.java)."""
    out = {}
    for srv in getattr(node, "cql_servers", []):
        from ..transport.frame import SUPPORTED_VERSIONS
        srv.min_version = max(SUPPORTED_VERSIONS)
        out["min_version"] = srv.min_version
    return out or {"min_version": None}


def enableoldprotocolversions(node) -> dict:
    out = {}
    for srv in getattr(node, "cql_servers", []):
        from ..transport.frame import SUPPORTED_VERSIONS
        srv.min_version = min(SUPPORTED_VERSIONS)
        out["min_version"] = srv.min_version
    return out or {"min_version": None}


# ---- hints ---------------------------------------------------------------


def pausehandoff(node) -> dict:
    """Alias pair of disable/enablehandoff the reference also ships."""
    node.hints.enabled = False
    return {"handoff": "paused"}


def resumehandoff(node) -> dict:
    node.hints.enabled = True
    return {"handoff": "running"}


def disablehintsfordc(node, dc: str) -> dict:
    node.hints.disabled_dcs.add(dc)
    return {"hints_disabled_dcs": sorted(node.hints.disabled_dcs)}


def enablehintsfordc(node, dc: str) -> dict:
    node.hints.disabled_dcs.discard(dc)
    return {"hints_disabled_dcs": sorted(node.hints.disabled_dcs)}


def getmaxhintwindow(node) -> dict:
    return {"max_hint_window_ms": node.max_hint_window_ms}


def setmaxhintwindow(node, ms: int) -> dict:
    node.max_hint_window_ms = int(ms)
    return {"max_hint_window_ms": node.max_hint_window_ms}


# ---- seeds / schema / triggers / batchlog --------------------------------


def getseeds(node) -> list[str]:
    return [e.name for e in node.gossiper.seeds]


def reloadseeds(node, seeds: list | None = None) -> list[str]:
    """Re-resolve the seed list (tools/nodetool/ReloadSeeds.java);
    in-process deployments pass the new list directly."""
    if seeds:
        by_name = {e.name: e for e in node.ring.endpoints}
        node.gossiper.seeds = [by_name[s] for s in seeds if s in by_name]
    return getseeds(node)


def resetlocalschema(node) -> dict:
    """Drop to the cluster's schema log state and re-pull
    (tools/nodetool/ResetLocalSchema.java)."""
    sync = getattr(node, "schema_sync", None)
    if sync is None:
        return {"pulled": False, "reason": "no metadata log on this node"}
    ok = sync.pull_from_peers(timeout=5.0)
    return {"pulled": ok, "epoch": sync.epoch}


def reloadlocalschema(node) -> dict:
    """Reload schema from the local epoch log
    (tools/nodetool/ReloadLocalSchema.java)."""
    sync = getattr(node, "schema_sync", None)
    if sync is None:
        return {"epoch": None,
                "reason": "no metadata log on this node",
                "tables": sum(len(k.tables) for k in
                              node.schema.keyspaces.values())}
    return {"epoch": sync.epoch,
            "entries": len(sync.entries_after(0))}


def reloadtriggers(node) -> dict:
    """Re-load trigger code from the triggers directory
    (tools/nodetool/ReloadTriggers.java): drop the compiled-function
    cache so every registered trigger re-imports its file on next
    fire — updated trigger code takes effect without DDL."""
    trg = getattr(node.engine, "triggers", None)
    if trg is None:
        return {"triggers": "no trigger service"}
    n = len(trg._fns)
    trg._fns.clear()
    return {"triggers": "reloaded", "cached_fns_dropped": n}


def replaybatchlog(node) -> dict:
    """Force a batchlog replay pass (tools/nodetool/ReplayBatchlog.java)."""
    n = 0
    for bid, mutations in list(node.batchlog.pending()):
        for m in mutations:
            node.engine.apply(m)
        node.batchlog.remove(bid)
        n += 1
    return {"replayed_batches": n}


# ---- caches --------------------------------------------------------------


def invalidatekeycache(engine) -> dict:
    """The key cache is process-global (storage/key_cache.GLOBAL),
    generation-scoped per sstable — clear it wholesale."""
    from ..storage.key_cache import GLOBAL as key_cache
    n = len(key_cache.keys())
    key_cache.clear()
    return {"cleared": n}


def _invalidate_auth_cache(node) -> dict:
    auth = getattr(node.engine, "auth", None)
    if auth is None:
        return {"invalidated": False}
    auth.cache.invalidate_all()
    return {"invalidated": True}


def invalidatepermissionscache(node) -> dict:
    return _invalidate_auth_cache(node)


def invalidaterolescache(node) -> dict:
    return _invalidate_auth_cache(node)


def invalidatenetworkpermissionscache(node) -> dict:
    return _invalidate_auth_cache(node)


def invalidatecidrpermissionscache(node) -> dict:
    return _invalidate_auth_cache(node)


def setcachecapacity(engine, row_entries: int | None = None,
                     chunk_bytes: int | None = None) -> dict:
    """nodetool setcachecapacity (row-cache entries, chunk-cache bytes)."""
    out = {}
    if row_entries is not None:
        for cfs in engine.stores.values():
            if cfs.row_cache is not None:
                cfs.row_cache.capacity = int(row_entries)
        out["row_entries"] = int(row_entries)
    if chunk_bytes is not None:
        from ..storage import chunk_cache
        chunk_cache.GLOBAL.capacity = int(chunk_bytes)
        out["chunk_bytes"] = int(chunk_bytes)
    return out


# ---- auth / cidr ---------------------------------------------------------


def getauthcacheconfig(node) -> dict:
    auth = getattr(node.engine, "auth", None)
    return {"validity_seconds": auth.cache.validity if auth else None}


def setauthcacheconfig(node, validity_seconds: float) -> dict:
    auth = getattr(node.engine, "auth", None)
    if auth is None:
        raise RuntimeError("auth is not enabled")
    auth.cache.validity = float(validity_seconds)
    auth.cache.invalidate_all()
    return {"validity_seconds": auth.cache.validity}


def getcidrgroupsofip(node, ip: str) -> list[str]:
    """CIDR groups containing an address
    (tools/nodetool/GetCIDRGroupsOfIP.java)."""
    import ipaddress
    auth = getattr(node.engine, "auth", None)
    if auth is None:
        return []
    addr = ipaddress.ip_address(ip)
    return sorted(name for name, cidrs in auth.cidr_groups.items()
                  if any(addr in ipaddress.ip_network(c)
                         for c in cidrs))


def cidrfilteringstats(node) -> dict:
    auth = getattr(node.engine, "auth", None)
    if auth is None:
        return {"groups": 0, "cidrs": 0, "restricted_roles": 0}
    return {"groups": len(auth.cidr_groups),
            "cidrs": sum(len(v) for v in auth.cidr_groups.values()),
            "restricted_roles": sum(
                1 for r in auth.roles.values()
                if r.get("cidr_groups"))}


# ---- audit / FQL ---------------------------------------------------------


def enableauditlog(node, path: str | None = None) -> dict:
    import os as _os

    from ..service.audit import AuditLog
    if node.engine.audit_log is None:
        path = path or _os.path.join(node.engine.data_dir, "audit.jsonl")
        node.engine.audit_log = AuditLog(path)
    return {"audit": "enabled", "path": node.engine.audit_log.path}


def disableauditlog(node) -> dict:
    if node.engine.audit_log is not None:
        node.engine.audit_log.close()
        node.engine.audit_log = None
    return {"audit": "disabled"}


def getauditlog(node) -> dict:
    a = node.engine.audit_log
    return {"enabled": a is not None,
            "path": a.path if a is not None else None}


def enablefullquerylog(node, path: str | None = None) -> dict:
    import os as _os

    from ..service.audit import AuditLog
    if node.engine.fql_log is None:
        path = path or _os.path.join(node.engine.data_dir, "fql.jsonl")
        node.engine.fql_log = AuditLog(path)
    return {"fql": "enabled", "path": node.engine.fql_log.path}


def disablefullquerylog(node) -> dict:
    if node.engine.fql_log is not None:
        node.engine.fql_log.close()
        node.engine.fql_log = None
    return {"fql": "disabled"}


def getfullquerylog(node) -> dict:
    f = node.engine.fql_log
    return {"enabled": f is not None,
            "path": f.path if f is not None else None}


def resetfullquerylog(node) -> dict:
    """Disable AND delete the log file
    (tools/nodetool/ResetFullQueryLog.java)."""
    import os as _os
    f = node.engine.fql_log
    path = f.path if f is not None else None
    disablefullquerylog(node)
    if path and _os.path.exists(path):
        _os.remove(path)
    return {"fql": "reset"}


# ---- compaction / sstables ----------------------------------------------


def getcompactionthreshold(engine, keyspace: str, table: str) -> dict:
    cfs = engine.store(keyspace, table)
    opts = cfs.table.params.compaction
    return {"min_threshold": int(opts.get("min_threshold", 4)),
            "max_threshold": int(opts.get("max_threshold", 32))}


def setcompactionthreshold(engine, keyspace: str, table: str,
                           min_threshold: int,
                           max_threshold: int) -> dict:
    if int(min_threshold) < 2 or int(max_threshold) < int(min_threshold):
        raise ValueError("need 2 <= min_threshold <= max_threshold")
    cfs = engine.store(keyspace, table)
    cfs.table.params.compaction["min_threshold"] = int(min_threshold)
    cfs.table.params.compaction["max_threshold"] = int(max_threshold)
    return getcompactionthreshold(engine, keyspace, table)


def stop(engine, compaction_type: str | None = None) -> dict:
    """nodetool stop: abort in-flight compactions cooperatively — the
    stop request lands on each active task's OWN progress handle, so it
    covers exactly the tasks running NOW (a task starting a moment
    later is unaffected — the reference's semantics) and a task that
    has not polled yet still sees it; every signalled task rolls back
    through its lifecycle transaction (tools/nodetool/Stop.java,
    CompactionInfo.Holder.stop). The shared cfs.compaction_abort event
    remains a programmatic kill switch for tasks driven outside the
    manager; it is deliberately NOT pulsed here — a timed pulse would
    spuriously abort tasks that start inside the window."""
    n = engine.compactions.stop_active()
    return {"stopped": True, "signalled": n}


def stopdaemon(node) -> dict:
    """nodetool stopdaemon: full node shutdown
    (tools/nodetool/StopDaemon.java). In a daemon the process exits via
    its signal handler; in-process callers get a stopped node."""
    node.shutdown()
    return {"daemon": "stopped"}


def forcecompact(engine, keyspace: str, table: str) -> dict:
    """nodetool forcecompact (major on one table, ignoring strategy
    selection — tools/nodetool/ForceCompact.java)."""
    out = engine.compactions.major_compaction(engine.store(keyspace,
                                                           table))
    return out or {"compacted": False}


def recompresssstables(engine, keyspace: str,
                       table: str | None = None) -> list[dict]:
    """nodetool recompress_sstables: rewrite under the CURRENT
    compression params (tools/nodetool/RecompressSSTables.java) — the
    upgradesstables machinery with a forced rewrite."""
    return upgradesstables(engine, keyspace, table)


def rebuildindex(node, keyspace: str, table: str,
                 index_names: str | None = None) -> dict:
    """nodetool rebuild_index: drop the index's per-sstable components
    and rebuild from base data (tools/nodetool/RebuildIndex.java)."""
    registry = getattr(node, "indexes", None) or         getattr(node.engine, "indexes", None)
    if registry is None:
        raise RuntimeError("no index registry")
    rebuilt = []
    for (ks0, tb0, col), idx in list(registry.indexes.items()):
        if ks0 != keyspace or tb0 != table:
            continue
        if hasattr(idx, "rebuild"):
            idx.rebuild()
        rebuilt.append(col)
    return {"rebuilt": rebuilt}


# ---- backups -------------------------------------------------------------


def enablebackup(engine) -> dict:
    engine.incremental_backup = True
    return {"incremental_backup": True}


def disablebackup(engine) -> dict:
    engine.incremental_backup = False
    return {"incremental_backup": False}


def statusbackup(engine) -> dict:
    return {"incremental_backup": bool(engine.incremental_backup)}



def import_sstables(engine, keyspace: str, table: str,
                    directory: str) -> dict:
    """nodetool import (tools/nodetool/Import.java): copy sstables from
    an external directory into the table's data directory under fresh
    generations, then load them — the safer successor to `refresh`
    (files never collide with live generations)."""
    import os as _os
    import shutil as _shutil

    from ..storage.sstable import Descriptor
    cfs = engine.store(keyspace, table)
    descs = Descriptor.list_in(directory)
    if not descs:
        raise FileNotFoundError(f"no sstables under {directory}")
    copied = 0
    for desc in descs:
        gen = cfs.next_generation()
        prefix = f"{desc.version}-{desc.generation}-"
        for fn in sorted(_os.listdir(directory)):
            if fn.startswith(prefix):
                _shutil.copy2(
                    _os.path.join(directory, fn),
                    _os.path.join(cfs.directory,
                                  f"{desc.version}-{gen}-{fn[len(prefix):]}"))
        copied += 1
    cfs.reload_sstables()
    return {"imported_sstables": copied,
            "live_sstables": len(cfs.live_sstables())}


for _name, _target in [
        ("status", "node"), ("info", "engine"), ("ring", "node"),
        ("flush", "engine"), ("compact", "engine"),
        ("compactionstats", "engine"), ("commitlogstats", "engine"),
        ("tablestats", "engine"),
        ("repair", "node"), ("cleanup", "node"),
        ("getendpoints", "node"), ("gossipinfo", "node"),
        ("version", "none"), ("describecluster", "node"),
        ("setcompactionthroughput", "engine"),
        ("getcompactionthroughput", "engine"),
        ("setslowquerythreshold", "engine"),
        ("upgradesstables", "engine"), ("sstablesplit", "engine"),
        ("snapshot", "engine"), ("listsnapshots", "engine"),
        ("clearsnapshot", "engine"), ("scrub", "engine"),
        ("garbagecollect", "engine"),
        ("netstats", "node"), ("tpstats", "engine"),
        ("proxyhistograms", "node"), ("compactionhistory", "engine"),
        ("clientstats", "node"), ("gettimeout", "node"),
        ("settimeout", "node"), ("getstreamthroughput", "engine"),
        ("setstreamthroughput", "engine"),
        ("getconcurrentcompactors", "engine"),
        ("setconcurrentcompactors", "engine"),
        ("gettraceprobability", "engine"),
        ("settraceprobability", "engine"),
        ("gettraces", "engine"), ("exportmetrics", "engine"),
        ("diagnostics", "engine"), ("flightrecorder", "engine"),
        ("pipelinestats", "engine"), ("slostats", "engine"),
        ("metricshistory", "engine"), ("profiler", "engine"),
        ("clusterstats", "node"),
        ("disableautocompaction", "engine"),
        ("enableautocompaction", "engine"),
        ("statusautocompaction", "engine"),
        ("autocompaction", "engine"),
        ("disablehandoff", "node"), ("enablehandoff", "node"),
        ("statushandoff", "node"), ("truncatehints", "node"),
        ("statusgossip", "node"), ("statusbinary", "node"),
        ("drain", "node"), ("refresh", "engine"),
        ("invalidaterowcache", "engine"),
        ("invalidatechunkcache", "engine"),
        ("invalidatecountercache", "node"),
        ("getsstables", "engine"), ("verify", "engine"),
        ("listquarantine", "engine"),
        ("assassinate", "node"), ("listpendinghints", "node"),
        ("getlogginglevels", "none"), ("setlogginglevel", "none"),
        ("updatecidrgroup", "engine"), ("dropcidrgroup", "engine"),
        ("listcidrgroups", "engine"),
        ("invalidatecredentialscache", "engine"),
        ("decommission", "node"), ("move", "node"),
        ("bulkload", "node"), ("rebuild", "node"),
        ("repair_admin", "node"),
        ("describering", "node"), ("cmsadmin", "node"),
        ("failuredetectorinfo", "node"), ("gcstats", "none"),
        ("tablehistograms", "engine"),
        ("toppartitions", "engine"), ("rangekeysample", "engine"),
        ("datapaths", "engine"), ("viewbuildstatus", "node"),
        ("disablegossip", "node"), ("enablegossip", "node"),
        ("disablebinary", "node"), ("enablebinary", "node"),
        ("disableoldprotocolversions", "node"),
        ("enableoldprotocolversions", "node"),
        ("pausehandoff", "node"), ("resumehandoff", "node"),
        ("disablehintsfordc", "node"), ("enablehintsfordc", "node"),
        ("getmaxhintwindow", "node"), ("setmaxhintwindow", "node"),
        ("getseeds", "node"), ("reloadseeds", "node"),
        ("resetlocalschema", "node"), ("reloadlocalschema", "node"),
        ("reloadtriggers", "node"), ("replaybatchlog", "node"),
        ("invalidatekeycache", "engine"),
        ("invalidatepermissionscache", "node"),
        ("invalidaterolescache", "node"),
        ("invalidatenetworkpermissionscache", "node"),
        ("invalidatecidrpermissionscache", "node"),
        ("setcachecapacity", "engine"),
        ("getauthcacheconfig", "node"), ("setauthcacheconfig", "node"),
        ("getcidrgroupsofip", "node"), ("cidrfilteringstats", "node"),
        ("enableauditlog", "node"), ("disableauditlog", "node"),
        ("getauditlog", "node"),
        ("enablefullquerylog", "node"), ("disablefullquerylog", "node"),
        ("getfullquerylog", "node"), ("resetfullquerylog", "node"),
        ("getcompactionthreshold", "engine"),
        ("setcompactionthreshold", "engine"),
        ("stop", "engine"), ("stopdaemon", "node"),
        ("forcecompact", "engine"), ("recompresssstables", "engine"),
        ("rebuildindex", "node"),
        ("enablebackup", "engine"), ("disablebackup", "engine"),
        ("statusbackup", "engine")]:
    COMMANDS[_name] = (_target, globals()[_name])
# reserved word: the function is import_sstables, the command 'import'
COMMANDS["import"] = ("engine", import_sstables)


def run_command(name: str, node=None, engine=None, **kwargs):
    """Dispatch one command against whatever backend is available —
    shared by the CLI local mode and the admin server."""
    if name not in COMMANDS:
        raise ValueError(f"unknown command {name!r}")
    target, fn = COMMANDS[name]
    if target == "node":
        if node is None:
            raise ValueError(f"{name} needs a running node "
                             "(use --host/--port admin mode)")
        return fn(node, **kwargs)
    if target == "engine":
        eng = engine if engine is not None \
            else (node.engine if node is not None else None)
        if eng is None:
            raise ValueError(f"{name} needs an engine")
        return fn(eng, **kwargs)
    return fn(**kwargs)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="nodetool",
        description="Operator commands. --host/--port drives a running "
                    "daemon over the admin protocol (JMX role); --data "
                    "opens a local data directory offline.")
    p.add_argument("command", choices=sorted(COMMANDS))
    p.add_argument("args", nargs="*", help="key=value command arguments")
    p.add_argument("--data", help="offline mode: data directory")
    p.add_argument("--host", help="admin mode: daemon host")
    p.add_argument("--port", type=int, help="admin mode: admin port")
    p.add_argument("--secret", help="admin mode: shared secret "
                   "(or env CTPU_ADMIN_SECRET)")
    p.add_argument("--device", help="offline mode: the torch device of "
                   "the engine's kernels (default cuda)")
    args = p.parse_args(argv)

    kwargs = {}
    for kv in args.args:
        if "=" not in kv:
            p.error(f"arguments are key=value, got {kv!r}")
        k, v = kv.split("=", 1)
        try:
            kwargs[k] = json.loads(v)
        except json.JSONDecodeError:
            kwargs[k] = v

    if args.host and args.port:
        import os as _os

        from ..service.admin import admin_call
        out = admin_call(args.host, args.port, args.command, kwargs,
                         secret=args.secret
                         or _os.environ.get("CTPU_ADMIN_SECRET"))
        print(json.dumps(out, indent=2, default=str))
        return
    if not args.data:
        p.error("need --data DIR (offline) or --host/--port (admin mode)")
    from ..schema import Schema
    from ..storage.engine import StorageEngine
    engine = StorageEngine(args.data, Schema(), device=args.device)
    try:
        print(json.dumps(run_command(args.command, engine=engine,
                                     **kwargs),
                         indent=2, default=str))
    finally:
        engine.close()


if __name__ == "__main__":
    main()
