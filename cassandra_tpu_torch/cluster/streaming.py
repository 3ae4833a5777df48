"""Entire-sstable streaming.

Reference counterpart: db/streaming/CassandraEntireSSTableStreamWriter
+ ComponentManifest (streaming/StreamSession): when a whole sstable's
data falls inside the requested token range, its component FILES ship
verbatim — no partition decode/re-encode on either side, and every
attached component (secondary/SASI/vector index files) rides along.
Only the leftovers (sstables straddling the range boundary) are
re-serialized as cell batches.

The receiver lands each shipped sstable under a FRESH local generation
(component contents never embed the generation — it lives only in the
file names), TOC written last as the commit point, then reloads the
store.

Two transports live here:

  * the SESSIONED plan/chunk/ack protocol in cluster/stream_session.py
    (StreamManager) — what bootstrap, rebuild, decommission and
    repair's range sync actually ride: resumable, throttled, bounded;
  * the legacy one-message STREAM_REQ/STREAM_DATA exchange below —
    kept as a compat path (and pinned by test) but CAPPED: a request
    whose in-range bytes exceed LEGACY_MAX_BYTES fails with a typed
    StreamPayloadTooLarge instead of materializing an unbounded
    response on the shared dispatch worker.
"""
from __future__ import annotations

import os
import threading

from ..storage import cellbatch as cb
from .coordinator import cb_serialize, cb_deserialize
from .messaging import Verb
from .stream_session import StreamManager, filter_token_range \
    as _filter_token_range


MIN_TOKEN = -(1 << 63)

# reserved key in a shipped component dict carrying the sender's sstable
# format version (bytes); never a real component filename
VERSION_KEY = "__format_version__"


class StreamPayloadTooLarge(RuntimeError):
    """A legacy single-message STREAM_REQ asked for more bytes than the
    dispatch worker may materialize at once — use a session instead."""


class StreamService:
    # legacy single-message ceiling: everything bigger must ride a
    # sessioned transfer (chunked, acked, resumable)
    LEGACY_MAX_BYTES = 64 * 1024 * 1024

    def __init__(self, node):
        self.node = node
        # completed/failed session records (system_views.streaming /
        # nodetool netstats; streaming/StreamManager.java state role) —
        # bounded: old sessions age out at constant memory
        from collections import deque
        self.sessions: "deque[dict]" = deque(maxlen=256)
        node.messaging.register_handler(Verb.STREAM_REQ,
                                        self._handle_req)
        self.manager = StreamManager(node, record=self.sessions.append)

    # ------------------------------------------------- sessioned transfers --

    def stream_range(self, owner, keyspace: str, table_name: str,
                     lo: int, hi: int, timeout: float | None = None) -> dict:
        return self.manager.stream_range(owner, keyspace, table_name,
                                         lo, hi, timeout)

    def fetch_batch(self, owner, keyspace: str, table_name: str,
                    lo: int, hi: int, timeout: float | None = None):
        return self.manager.fetch_batch(owner, keyspace, table_name,
                                        lo, hi, timeout)

    def resume_incomplete(self, timeout: float | None = None) -> list[dict]:
        return self.manager.resume_incomplete(timeout)

    def request_pull(self, target, keyspace: str, table_name: str,
                     lo: int, hi: int, timeout: float) -> dict:
        return self.manager.request_pull(target, keyspace, table_name,
                                         lo, hi, timeout)

    def progress(self) -> list[dict]:
        return self.manager.progress()

    def set_throughput(self, mib_per_s: float, inter_dc: bool = False):
        self.manager.set_throughput(mib_per_s, inter_dc)

    def close(self) -> None:
        self.manager.close()

    # -------------------------------------------------------------- source --

    def _handle_req(self, msg):
        """Owner side: (keyspace, table, lo, hi) -> the in-range data as
        (whole_sstables, leftover_batch). Flushes first so the memtable
        is captured by the sstable split."""
        keyspace, table_name, lo, hi = msg.payload
        cfs = self.node.engine.store(keyspace, table_name)
        cfs.flush()
        whole, partial = [], []
        for sst in list(cfs.live_sstables()):
            toks = sst.partition_tokens
            if len(toks) == 0:
                continue
            first, last = int(toks[0]), int(toks[-1])
            if (lo != MIN_TOKEN and last <= lo) or first > hi:
                continue   # zero overlap: never scan it
            if (lo == MIN_TOKEN or lo < first) and last <= hi:
                whole.append(sst)
            else:
                partial.append(sst)
        # size the response BEFORE materializing a byte of it: the
        # legacy path builds the whole payload in dispatch-worker
        # memory, so an oversized ask fails typed instead of OOMing
        est = 0
        prefixes = [f"{s.desc.version}-{s.desc.generation}-"
                    for s in whole + partial]
        for fn in os.listdir(cfs.directory):
            if any(fn.startswith(p) for p in prefixes):
                est += os.path.getsize(os.path.join(cfs.directory, fn))
        if est > self.LEGACY_MAX_BYTES:
            raise StreamPayloadTooLarge(
                f"{keyspace}.{table_name} ({lo}, {hi}] is ~{est} bytes; "
                f"the single-message path caps at "
                f"{self.LEGACY_MAX_BYTES} — use a stream session")
        files = []
        for sst in whole:
            prefix = f"{sst.desc.version}-{sst.desc.generation}-"
            # the FORMAT VERSION must travel with the bytes: since "cc"
            # the version gates the lane-plane unshuffle on read, so a
            # receiver stamping its own version onto shipped components
            # would silently transpose-garble the lane matrix
            comps = {VERSION_KEY: sst.desc.version.encode()}
            for fn in os.listdir(cfs.directory):
                if fn.startswith(prefix):
                    with open(os.path.join(cfs.directory, fn), "rb") as f:
                        comps[fn[len(prefix):]] = f.read()
            files.append(comps)
        if partial:
            # one sorted batch per sstable, MERGED (cross-sstable concat
            # is not token-sorted and must never claim to be)
            per_sst = []
            for sst in partial:
                segs = list(sst.scanner())
                if not segs:
                    continue
                cat = cb.CellBatch.concat(segs)
                cat.sorted = True
                per_sst.append(cat)
            merged = cb.merge_sorted(per_sst) if per_sst else None
            leftover = _filter_token_range(merged, lo, hi) \
                if merged is not None else None
        else:
            leftover = None
        if leftover is None:
            from ..storage.cellbatch import lanes_for_table
            leftover = cb.CellBatch.empty(lanes_for_table(cfs.table))
        return Verb.STREAM_DATA, (files, cb_serialize(leftover))

    # ------------------------------------------------------------ receiver --

    def fetch_range(self, owner, keyspace: str, table_name: str,
                    lo: int, hi: int, timeout: float):
        """(files, leftover_batch) for range (lo, hi] from `owner`."""
        holder: dict = {}
        ev = threading.Event()

        def on_rsp(m):
            holder["p"] = m.payload
            ev.set()

        def on_fail(arg):
            holder["err"] = self.node.messaging.failure_kind(
                getattr(arg, "payload", None))
            ev.set()

        self.node.messaging.send_with_callback(
            Verb.STREAM_REQ, (keyspace, table_name, lo, hi), owner,
            on_response=on_rsp, on_failure=on_fail, timeout=timeout)
        if not ev.wait(timeout) or "err" in holder:
            self.sessions.append(
                {"peer": owner.name, "direction": "in",
                 "keyspace": keyspace, "table": table_name,
                 "status": "failed", "files": 0, "bytes": 0})
            kind = holder.get("err")
            if kind == "StreamPayloadTooLarge":
                raise StreamPayloadTooLarge(
                    f"stream of {keyspace}.{table_name} ({lo}, {hi}] "
                    f"from {owner.name} exceeds the single-message cap")
            raise TimeoutError(
                f"stream of {keyspace}.{table_name} ({lo}, {hi}] from "
                f"{owner.name} {'failed: ' + kind if kind else 'timed out'}")
        files, leftover_b = holder["p"]
        leftover = cb_deserialize(leftover_b)
        self.sessions.append(
            {"peer": owner.name, "direction": "in",
             "keyspace": keyspace, "table": table_name,
             "status": "complete", "files": len(files),
             "bytes": sum(len(d) for c in files for d in c.values())
             + len(leftover_b), "leftover_cells": len(leftover)})
        return files, leftover

    def land_sstable(self, cfs, comps: dict) -> int:
        """Write a shipped sstable's components under a fresh local
        generation; TOC last = commit point (the receiver-side
        CassandraStreamReceiver contract). The sstable lands under the
        SENDER's format version (shipped in VERSION_KEY) — the version
        byte gates layout decode (lane unshuffle since "cc"), so
        re-stamping would corrupt silently."""
        from ..storage.sstable.format import Component
        comps = dict(comps)
        version_b = comps.pop(VERSION_KEY, None)
        if version_b is not None:
            version = version_b.decode()
        else:
            # legacy sender without a version marker: such a sender is by
            # definition running pre-"cc" code (the marker shipped with
            # "cc"), so its lanes are row-major — land as "cb", never as
            # the current version
            version = "cb"
        from ..storage.sstable.writer import SSTableWriter
        gen = cfs.next_generation()
        toc = comps.get(Component.TOC)
        for name, data in comps.items():
            if name == Component.TOC:
                continue
            path = os.path.join(cfs.directory, f"{version}-{gen}-{name}")
            tmp = path + ".stream"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        # component renames must be durable BEFORE the TOC commit point
        # (same discipline as SSTableWriter.finish: a crash must never
        # persist the TOC over missing components), and the TOC rename
        # itself needs a second directory sync
        SSTableWriter._fsync_path(cfs.directory)
        if toc is not None:
            path = os.path.join(cfs.directory,
                                f"{version}-{gen}-{Component.TOC}")
            tmp = path + ".stream"
            with open(tmp, "wb") as f:
                f.write(toc)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            SSTableWriter._fsync_path(cfs.directory)
        return gen
