"""Sessioned, resumable, throttled sstable streaming.

Reference counterpart: streaming/StreamSession + StreamManager and the
entire-sstable CassandraEntireSSTableStreamWriter/Reader pair — a
transfer is a PLAN (per-table, per-token-range file set computed up
front) executed as bounded chunks with acks, not one unbounded message.
TPIE's staged-pipeline framing (PAPERS.md, arXiv 1710.10091) supplies
the execution shape: dedicated sender/receiver stages with bounded
buffers, backpressure billed to the pipeline ledger, and clean fault
unwinding at named checkpoints.

Wire protocol (all payloads are plain dicts; the in-process transport
ships them by reference):

    STREAM_SESSION_REQ   receiver -> sender: open/resume a session.
                         Carries the session id, the (keyspace, table,
                         lo, hi] range, the kind, and `have` — the
                         receiver's persisted acked-chunk watermark, so
                         a resume re-requests ONLY the missing tail.
    STREAM_MANIFEST      sender -> receiver (response): the transfer
                         plan. The sender computes it on a dedicated
                         planner thread (never on the shared dispatch
                         worker), snapshots every in-range component
                         into `<data_dir>/streaming/<sid>/` (hardlinks
                         — immune to compaction, and a RESTARTED sender
                         re-serves the same bytes), and persists it.
    STREAM_CHUNK         sender -> receiver (one-way): one bounded
                         chunk (fid, idx, offset, bytes, crc32).
    STREAM_ACK           receiver -> sender (one-way): chunk landed
                         durably (staged + journaled).
    STREAM_SESSION_DONE  terminal notice, both directions: the receiver
                         reports `complete` after the atomic landing;
                         either side reports `failed`.
    STREAM_PULL_REQ/RSP  "push" modelled as a remote pull: decommission
                         asks each gaining owner to run a receiver
                         session against the leaving node.

Session kinds:

    range   durable: manifest + staging + acked journal persisted under
            `<data_dir>/streaming/<sid>/` on BOTH sides; completion
            lands whole sstables under fresh local generations with
            TOC-written-last as the commit point (bootstrap, rebuild,
            decommission pulls).
    batch   ephemeral: one serialized CellBatch crosses as chunks and
            is handed to the caller (repair's mismatched-range sync).
            No disk state — a failed fetch is simply retried by its
            caller, but chunk CRC/retransmit still applies.

Robustness contract: per-chunk CRC (a corrupt chunk is dropped and
never acked — retransmit recovers), retransmit with exponential backoff
under a bounded in-flight window, a per-session deadline, and RESUME
from the receiver's journaled watermark after either side dies. The
receiver's landing is atomic: a crash before the TOC leaves zero
visible sstables and `storage/lifecycle.replay_directory` sweeps the
orphaned components at restart.

Fault checkpoints (utils/faultfs.py): `stream.read` (snapshot chunk
read), `stream.net` (chunk send — `disconnect` and `latency` modes bind
here), `stream.land` (staging writes and the final component landing).

Throttle: a token-bucket RateLimiter on the sender's net stage, fed by
the `stream_throughput_outbound` knob (`inter_dc_stream_throughput_
outbound` when the peer lives in another DC), hot-reloadable.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
import uuid
import zlib
from collections import deque

from ..service import diagnostics
from ..service.metrics import GLOBAL as METRICS
from ..utils import faultfs, pipeline_ledger
from .messaging import Verb

MIN_TOKEN = -(1 << 63)


class StreamSessionFailed(RuntimeError):
    """Terminal session failure (timeout, fault, peer death)."""


def split_sstables(cfs, lo: int, hi: int):
    """(whole, partial): live sstables fully inside (lo, hi] ship as
    component files; straddlers re-serialize as batches."""
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
    return whole, partial


def filter_token_range(batch, lo: int, hi: int):
    import numpy as np

    from ..storage import cellbatch as cb
    keep = cb.token_range_mask(cb.batch_tokens(batch), [(lo, hi)])
    idx = np.flatnonzero(keep)
    if len(idx) == len(batch):
        return batch
    out = batch.apply_permutation(idx)
    out.sorted = True
    return out


def batch_to_bytes(batch) -> bytes:
    """CellBatch -> one byte blob (the chunked wire/staging format).
    The in-process coordinator serde (cb_serialize) passes array OBJECTS
    by reference — streaming needs actual bytes: chunks are sliced,
    CRC'd and staged to disk. np.savez carries the planes; pk_map rides
    as flat key/value byte planes with length arrays."""
    import io

    import numpy as np
    keys = list(batch.pk_map.keys())
    vals = [batch.pk_map[k] for k in keys]
    bio = io.BytesIO()
    np.savez(
        bio,
        lanes=batch.lanes, ts=batch.ts, ldt=batch.ldt, ttl=batch.ttl,
        flags=batch.flags, off=batch.off, val_start=batch.val_start,
        payload=batch.payload,
        sorted=np.array([bool(batch.sorted)]),
        pk_klen=np.array([len(k) for k in keys], dtype=np.int64),
        pk_vlen=np.array([len(v) for v in vals], dtype=np.int64),
        pk_kbytes=np.frombuffer(b"".join(keys), dtype=np.uint8)
        if keys else np.empty(0, np.uint8),
        pk_vbytes=np.frombuffer(b"".join(vals), dtype=np.uint8)
        if vals else np.empty(0, np.uint8),
    )
    return bio.getvalue()


def batch_from_bytes(blob: bytes):
    import io

    import numpy as np

    from ..storage import cellbatch as cb
    z = np.load(io.BytesIO(blob))
    kb = z["pk_kbytes"].tobytes()
    vb = z["pk_vbytes"].tobytes()
    pk_map = {}
    kp = vp = 0
    for kl, vl in zip(z["pk_klen"], z["pk_vlen"]):
        pk_map[kb[kp:kp + int(kl)]] = vb[vp:vp + int(vl)]
        kp += int(kl)
        vp += int(vl)
    return cb.CellBatch(z["lanes"], z["ts"], z["ldt"], z["ttl"],
                        z["flags"], z["off"], z["val_start"],
                        z["payload"], pk_map, bool(z["sorted"][0]))


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_at(path: str, off: int, data: bytes) -> None:
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        if data:
            os.pwrite(fd, data, off)
        os.fsync(fd)
    finally:
        os.close(fd)


def _read_file(path: str) -> bytes:
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        return f.read()


class StreamManager:
    """Per-node session registry + verb handlers + the shared throttle.

    Tunables are class attributes so tests shrink chunks/windows by
    monkeypatching — they are engine mechanics, not operator knobs (the
    operator surface is the two throughput knobs)."""

    CHUNK_SIZE = 64 * 1024          # bytes per STREAM_CHUNK
    WINDOW = 8                      # unacked chunks in flight
    RETRANSMIT_BASE = 0.25          # s; doubles per attempt
    MAX_ATTEMPTS = 6                # retransmits before the session fails
    RECV_QUEUE = 64                 # receiver chunk queue bound
    SESSION_TIMEOUT = 30.0          # default per-session deadline

    def __init__(self, node, record=None):
        from ..utils.ratelimit import RateLimiter
        self.node = node
        self.record = record if record is not None else (lambda s: None)
        self.dir = os.path.join(node.engine.data_dir, "streaming")
        os.makedirs(self.dir, exist_ok=True)
        self._senders: dict[str, SenderSession] = {}
        self._receivers: dict[str, ReceiverSession] = {}
        self._lock = threading.Lock()
        self.closed = False
        settings = getattr(node.engine, "settings", None)
        rate = float(settings.get("stream_throughput_outbound")) \
            if settings is not None else 24.0
        dc_rate = float(settings.get("inter_dc_stream_throughput_outbound")) \
            if settings is not None else 24.0
        self.limiter = RateLimiter(rate)
        self.inter_dc_limiter = RateLimiter(dc_rate)
        led = pipeline_ledger.ledger("stream")
        self.read_stage = led.stage("read")
        self.net_stage = led.stage("net")
        self.land_stage = led.stage("land")
        m = node.messaging
        m.register_handler(Verb.STREAM_SESSION_REQ, self._handle_session_req)
        m.register_handler(Verb.STREAM_CHUNK, self._handle_chunk)
        m.register_handler(Verb.STREAM_ACK, self._handle_ack)
        m.register_handler(Verb.STREAM_SESSION_DONE, self._handle_done)
        m.register_handler(Verb.STREAM_PULL_REQ, self._handle_pull_req)

    # ----------------------------------------------------------- throttle --

    def set_throughput(self, mib_per_s: float, inter_dc: bool = False):
        """Hot-reload seam for the stream_throughput_outbound /
        inter_dc_stream_throughput_outbound knobs."""
        (self.inter_dc_limiter if inter_dc else self.limiter).set_rate(
            float(mib_per_s))

    def throttle(self, nbytes: int, peer, cancel=None) -> None:
        lim = self.inter_dc_limiter \
            if peer.dc != self.node.endpoint.dc else self.limiter
        lim.acquire(max(nbytes, 1), cancel=cancel)

    # --------------------------------------------------------- public API --

    def stream_range(self, owner, keyspace: str, table: str, lo: int,
                     hi: int, timeout: float | None = None) -> dict:
        """Durable sessioned pull of (lo, hi] from `owner`: whole
        in-range sstables land under fresh local generations (TOC last),
        boundary-straddling cells land as one written batch. Returns
        {"files", "gens", "cells", "bytes"}."""
        sess = ReceiverSession(self, owner, keyspace, table, lo, hi,
                               "range", timeout or self.SESSION_TIMEOUT)
        self._register_receiver(sess)
        sess.start()
        return sess.wait()

    def fetch_batch(self, owner, keyspace: str, table: str, lo: int,
                    hi: int, timeout: float | None = None):
        """Ephemeral sessioned fetch of (lo, hi] as one CellBatch
        (repair's range sync). Chunked, CRC'd and retransmitted like a
        range session, but memory-resident on both sides."""
        sess = ReceiverSession(self, owner, keyspace, table, lo, hi,
                               "batch", timeout or self.SESSION_TIMEOUT)
        self._register_receiver(sess)
        sess.start()
        return sess.wait()["batch"]

    def resume_incomplete(self, timeout: float | None = None) -> list[dict]:
        """Re-drive every persisted-but-incomplete receiver session from
        its journaled watermark (the restart half of the resume
        contract). Missing chunks — and only those — are re-requested;
        a vanished peer fails the session and sweeps its state."""
        out = []
        for sid in sorted(os.listdir(self.dir)):
            d = os.path.join(self.dir, sid)
            meta = self._read_meta(d)
            if meta is None or meta.get("role") != "receiver":
                continue
            with self._lock:
                if sid in self._receivers:
                    continue   # already live in this process
            peer = self._endpoint_by_name(meta["peer"])
            if peer is None:
                self.record({"peer": meta["peer"], "direction": "in",
                             "keyspace": meta["keyspace"],
                             "table": meta["table"], "status": "failed",
                             "files": 0, "bytes": 0})
                shutil.rmtree(d, ignore_errors=True)
                continue
            sess = ReceiverSession.load(self, sid, meta, peer,
                                        timeout or self.SESSION_TIMEOUT)
            self._register_receiver(sess)
            sess.start(resumed=True)
            try:
                out.append(sess.wait())
            except Exception as e:
                # one stuck session must not wedge the rest of the
                # restart sweep; its durable state stays for a retry
                out.append({"sid": sess.sid, "error": repr(e)})
        return out

    def request_pull(self, target, keyspace: str, table: str, lo: int,
                     hi: int, timeout: float) -> dict:
        """Ask `target` to run a receiver session against THIS node for
        (lo, hi] (the decommission push, modelled as a remote pull so
        the mover is always the receiver and the landing is always
        local-atomic). Blocks for the ack."""
        holder: dict = {}
        ev = threading.Event()

        def on_rsp(m):
            holder["rsp"] = m.payload
            ev.set()

        def on_fail(arg):
            holder["err"] = arg
            ev.set()

        self.node.messaging.send_with_callback(
            Verb.STREAM_PULL_REQ,
            {"keyspace": keyspace, "table": table, "lo": lo, "hi": hi},
            target, on_response=on_rsp, on_failure=on_fail,
            timeout=timeout)
        if not ev.wait(timeout):
            raise TimeoutError(
                f"stream pull of {keyspace}.{table} ({lo}, {hi}] by "
                f"{target.name} not acknowledged")
        if "err" in holder:
            err = holder["err"]
            kind = self.node.messaging.failure_kind(
                getattr(err, "payload", None))
            raise StreamSessionFailed(
                f"stream pull by {target.name} failed: {kind or err}")
        return holder["rsp"]

    def progress(self) -> list[dict]:
        """Live per-session progress (system_views.streams / nodetool
        netstats)."""
        with self._lock:
            sessions = list(self._receivers.values()) \
                + list(self._senders.values())
        return [s.progress_row() for s in sessions]

    def close(self) -> None:
        """Abort every live session (node shutdown / simulated crash).
        Durable state stays on disk — that is what resume reads."""
        self.closed = True
        with self._lock:
            sessions = list(self._receivers.values()) \
                + list(self._senders.values())
            self._receivers.clear()
            self._senders.clear()
        for s in sessions:
            s.abort()

    # ----------------------------------------------------------- internal --

    def _register_receiver(self, sess: "ReceiverSession") -> None:
        with self._lock:
            self._receivers[sess.sid] = sess

    def _drop_session(self, sess) -> None:
        with self._lock:
            if isinstance(sess, ReceiverSession):
                if self._receivers.get(sess.sid) is sess:
                    del self._receivers[sess.sid]
            elif self._senders.get(sess.sid) is sess:
                del self._senders[sess.sid]

    def _endpoint_by_name(self, name: str):
        for ep in list(self.node.ring.endpoints):
            if ep.name == name:
                return ep
        return None

    @staticmethod
    def _read_meta(d: str) -> dict | None:
        try:
            with open(os.path.join(d, "meta.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # ----------------------------------------------------- verb handlers --
    # Every handler is O(dict op): the shared dispatch worker must stay
    # responsive (gossip acks and reads ride the same pool), so all real
    # work happens on dedicated session threads.

    def _handle_session_req(self, msg):
        p = msg.payload
        sid = p["sid"]
        with self._lock:
            old = self._senders.pop(sid, None)
        if old is not None:
            old.abort()   # receiver restarted mid-session: re-serve
        sess = SenderSession(self, sid, msg.sender, p)
        with self._lock:
            self._senders[sid] = sess
        threading.Thread(target=sess.run, args=(msg,), daemon=True,
                         name=f"stream-send-{sid[:8]}").start()
        return None   # the planner thread responds with the manifest

    def _handle_chunk(self, msg):
        p = msg.payload
        with self._lock:
            sess = self._receivers.get(p["sid"])
        if sess is None:
            return None   # completed/unknown session: late chunk
        try:
            sess.queue.put_nowait(p)
            self.land_stage.note_queue(sess.queue.qsize())
        except queue.Full:
            pass   # backpressure: dropped, the sender retransmits
        return None

    def _handle_ack(self, msg):
        p = msg.payload
        with self._lock:
            sess = self._senders.get(p["sid"])
        if sess is not None:
            sess.on_ack(p["fid"], p["idx"])
        return None

    def _handle_done(self, msg):
        p = msg.payload
        sid = p["sid"]
        if p["status"] == "complete":
            with self._lock:
                snd = self._senders.pop(sid, None)
            if snd is not None:
                snd.finish()
            else:
                # restarted sender: only its on-disk snapshot remains
                d = os.path.join(self.dir, sid)
                meta = self._read_meta(d)
                if meta is not None and meta.get("role") == "sender":
                    shutil.rmtree(d, ignore_errors=True)
        else:
            with self._lock:
                rcv = self._receivers.get(sid)
            if rcv is not None:
                rcv.abort_remote(p.get("error", "peer failed"))
        return None

    def _handle_pull_req(self, msg):
        p = msg.payload

        def run():
            try:
                res = self.stream_range(msg.sender, p["keyspace"],
                                        p["table"], p["lo"], p["hi"],
                                        timeout=self.SESSION_TIMEOUT)
                self.node.messaging.respond(
                    msg, Verb.STREAM_PULL_RSP,
                    {"files": res["files"], "cells": res["cells"],
                     "bytes": res["bytes"]})
            except Exception as e:
                self.node.messaging.respond_failure(msg, e)

        threading.Thread(target=run, daemon=True,
                         name="stream-pull").start()
        return None


# --------------------------------------------------------------- sender --


class SenderSession:
    """One outbound transfer: plan (snapshot + manifest) on a dedicated
    thread, then pump chunks under the throttle and the in-flight
    window, retransmitting unacked chunks with exponential backoff."""

    def __init__(self, mgr: StreamManager, sid: str, peer, req: dict):
        self.mgr = mgr
        self.sid = sid
        self.peer = peer
        self.keyspace = req["keyspace"]
        self.table = req["table"]
        self.lo = req["lo"]
        self.hi = req["hi"]
        self.kind = req["kind"]
        self.have = {tuple(k) for k in req.get("have", [])}
        self.chunk_size = int(req.get("chunk_size",
                                      StreamManager.CHUNK_SIZE))
        self.dir = os.path.join(mgr.dir, sid) if self.kind == "range" \
            else None
        self.manifest: dict | None = None
        self._blobs: dict[int, bytes] = {}
        self.status = "planning"
        self.dead = threading.Event()
        self._cond = threading.Condition()
        self._pending: deque = deque()
        self._unacked: dict[tuple, list] = {}   # key -> [deadline, tries]
        self.chunks_done = 0
        self.chunks_total = 0
        self.bytes_done = 0

    # ------------------------------------------------------------- plan --

    def run(self, req_msg) -> None:
        node = self.mgr.node
        try:
            if self.dir is not None \
                    and os.path.exists(os.path.join(self.dir,
                                                    "manifest.json")):
                with open(os.path.join(self.dir, "manifest.json")) as f:
                    self.manifest = json.load(f)
            else:
                self.manifest = self._plan()
        except Exception as e:
            self.status = "failed"
            self.mgr._drop_session(self)
            node.messaging.respond_failure(req_msg, e)
            return
        try:
            node.messaging.respond(req_msg, Verb.STREAM_MANIFEST,
                                   self.manifest)
            self.status = "streaming"
            self._pump()
        except Exception as e:
            self.status = "failed"
            self.mgr._drop_session(self)
            self._record("failed")
            try:
                node.messaging.send_one_way(
                    Verb.STREAM_SESSION_DONE,
                    {"sid": self.sid, "status": "failed",
                     "error": repr(e)}, self.peer)
            except Exception:
                pass

    def _plan(self) -> dict:
        """Flush, snapshot every in-range component into the session
        dir (hardlinks: compaction can drop the source generation
        mid-transfer and a restarted sender still re-serves identical
        bytes), and persist the manifest."""
        from ..storage import cellbatch as cb
        node = self.mgr.node
        cfs = node.engine.store(self.keyspace, self.table)
        files: list[dict] = []
        if self.kind == "batch":
            # no flush: scan_all already merges the memtable, and
            # repair's many narrow syncs must not churn tiny sstables
            batch = filter_token_range(cfs.scan_all(), self.lo, self.hi)
            blob = batch_to_bytes(batch)
            self._blobs[0] = blob
            files.append(self._entry(0, -1, "batch.cb", "", len(blob)))
        else:
            cfs.flush()
            os.makedirs(self.dir, exist_ok=True)
            whole, partial = split_sstables(cfs, self.lo, self.hi)
            fid = 0
            for si, sst in enumerate(whole):
                prefix = f"{sst.desc.version}-{sst.desc.generation}-"
                for fn in sorted(os.listdir(cfs.directory)):
                    if not fn.startswith(prefix):
                        continue
                    src = os.path.join(cfs.directory, fn)
                    dst = os.path.join(self.dir,
                                       f"{fid}-{fn[len(prefix):]}")
                    try:
                        os.link(src, dst)
                    except OSError:
                        shutil.copyfile(src, dst)
                    files.append(self._entry(fid, si, fn[len(prefix):],
                                             sst.desc.version,
                                             os.path.getsize(dst)))
                    fid += 1
            per_sst = []
            for sst in partial:
                segs = list(sst.scanner())
                if segs:
                    cat = cb.CellBatch.concat(segs)
                    cat.sorted = True
                    per_sst.append(cat)
            merged = cb.merge_sorted(per_sst) if per_sst else None
            leftover = filter_token_range(merged, self.lo, self.hi) \
                if merged is not None else None
            if leftover is None:
                from ..storage.cellbatch import lanes_for_table
                leftover = cb.CellBatch.empty(lanes_for_table(cfs.table))
            blob = batch_to_bytes(leftover)
            with open(os.path.join(self.dir, f"{fid}-leftover.cb"),
                      "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            files.append(self._entry(fid, -1, "leftover.cb", "",
                                     len(blob)))
        manifest = {"sid": self.sid, "keyspace": self.keyspace,
                    "table": self.table, "lo": self.lo, "hi": self.hi,
                    "kind": self.kind, "chunk_size": self.chunk_size,
                    "files": files}
        if self.dir is not None:
            _write_json(os.path.join(self.dir, "meta.json"),
                        {"role": "sender", "peer": self.peer.name})
            _write_json(os.path.join(self.dir, "manifest.json"), manifest)
        return manifest

    def _entry(self, fid: int, si: int, comp: str, version: str,
               size: int) -> dict:
        return {"fid": fid, "set": si, "comp": comp, "version": version,
                "size": size,
                "chunks": max(1, -(-size // self.chunk_size))}

    # ------------------------------------------------------------- pump --

    def _pump(self) -> None:
        mgr = self.mgr
        deadline = time.monotonic() + mgr.SESSION_TIMEOUT
        all_chunks = [(f["fid"], i) for f in self.manifest["files"]
                      for i in range(f["chunks"])]
        self.chunks_total = len(all_chunks)
        missing = [k for k in all_chunks if k not in self.have]
        self.chunks_done = self.chunks_total - len(missing)
        with self._cond:
            self._pending.extend(missing)
        while True:
            with self._cond:
                if self.dead.is_set():
                    return
                if not self._pending and not self._unacked:
                    break   # everything acked: await the DONE notice
            now = time.monotonic()
            if now > deadline:
                raise StreamSessionFailed(
                    f"session {self.sid} to {self.peer.name} timed out "
                    f"({self.chunks_done}/{self.chunks_total} chunks "
                    f"acked)")
            resend: list[tuple] = []
            key = None
            with self._cond:
                for k, st in self._unacked.items():
                    if now >= st[0]:
                        st[1] += 1
                        if st[1] > mgr.MAX_ATTEMPTS:
                            raise StreamSessionFailed(
                                f"chunk {k} of session {self.sid} "
                                f"unacked after {st[1]} attempts")
                        st[0] = now + mgr.RETRANSMIT_BASE * (2 ** st[1])
                        resend.append(k)
                if len(self._unacked) < mgr.WINDOW and self._pending:
                    key = self._pending.popleft()
                    self._unacked[key] = [now + mgr.RETRANSMIT_BASE, 0]
            for k in resend:
                METRICS.incr("streaming.chunks_retried")
                self._send_chunk(k)
            if key is not None:
                self._send_chunk(key)
                continue
            if not resend:
                with self._cond:
                    self._cond.wait(0.05)
        self.status = "awaiting_done"

    def _chunk_path(self, entry: dict) -> str:
        if self.dir is None:
            return f"{self.sid}/{entry['comp']}"
        return os.path.join(self.dir, f"{entry['fid']}-{entry['comp']}")

    def _send_chunk(self, key: tuple) -> None:
        mgr = self.mgr
        fid, idx = key
        entry = self.manifest["files"][fid]
        path = self._chunk_path(entry)
        off = idx * self.chunk_size
        with mgr.read_stage.busy():
            if fid in self._blobs:
                data = self._blobs[fid][off:off + self.chunk_size]
            else:
                faultfs.check("stream.read", path)
                with open(path, "rb") as f:
                    f.seek(off)
                    data = f.read(self.chunk_size)
        mgr.read_stage.add_items(1, len(data))
        # the throttle's sleep is backpressure paid to the wire: stall
        with mgr.net_stage.stall():
            mgr.throttle(len(data), self.peer, cancel=self.dead)
        if self.dead.is_set():
            return
        with mgr.net_stage.busy():
            if faultfs.GLOBAL.active and faultfs.on_net("stream.net",
                                                        path):
                return   # disconnect: dropped on the floor, no ack
            mgr.node.messaging.send_one_way(
                Verb.STREAM_CHUNK,
                {"sid": self.sid, "fid": fid, "idx": idx, "off": off,
                 "data": data, "crc": zlib.crc32(data) & 0xffffffff},
                self.peer)
        mgr.net_stage.add_items(1, len(data))
        METRICS.incr("streaming.chunks_sent")
        METRICS.incr("streaming.bytes_sent", len(data))

    # ---------------------------------------------------------- inbound --

    def on_ack(self, fid: int, idx: int) -> None:
        entry = self.manifest["files"][fid] if self.manifest else None
        with self._cond:
            if self._unacked.pop((fid, idx), None) is not None:
                self.chunks_done += 1
                if entry is not None:
                    self.bytes_done += min(
                        self.chunk_size,
                        max(entry["size"] - idx * self.chunk_size, 0))
                self._cond.notify()

    def finish(self) -> None:
        """Receiver confirmed the atomic landing: drop the snapshot."""
        self.status = "complete"
        self.dead.set()
        with self._cond:
            self._cond.notify()
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
        self._record("complete")

    def abort(self) -> None:
        self.dead.set()
        with self._cond:
            self._cond.notify()

    def _record(self, status: str) -> None:
        self.mgr.record({"peer": self.peer.name, "direction": "out",
                         "keyspace": self.keyspace, "table": self.table,
                         "status": status,
                         "files": len(self.manifest["files"])
                         if self.manifest else 0,
                         "bytes": self.bytes_done})

    def progress_row(self) -> dict:
        return {"sid": self.sid, "peer": self.peer.name,
                "direction": "out", "keyspace": self.keyspace,
                "table": self.table, "kind": self.kind,
                "status": self.status,
                "chunks_total": self.chunks_total,
                "chunks_done": self.chunks_done,
                "bytes_total": sum(f["size"]
                                   for f in self.manifest["files"])
                if self.manifest else 0,
                "bytes_done": self.bytes_done}


# ------------------------------------------------------------- receiver --


class ReceiverSession:
    """One inbound transfer: initiate (or resume), stage chunks durably
    off a bounded queue on a dedicated landing thread, journal every
    ack, and commit atomically (fresh generation, TOC written last)."""

    def __init__(self, mgr: StreamManager, peer, keyspace: str,
                 table: str, lo: int, hi: int, kind: str,
                 timeout: float, sid: str | None = None):
        self.mgr = mgr
        self.sid = sid or uuid.uuid4().hex[:16]
        self.peer = peer
        self.keyspace = keyspace
        self.table = table
        self.lo = lo
        self.hi = hi
        self.kind = kind
        self.timeout = timeout
        self.dir = os.path.join(mgr.dir, self.sid) if kind == "range" \
            else None
        self.manifest: dict | None = None
        self.acked: set[tuple] = set()
        self._chunks: dict[tuple, bytes] = {}   # batch-kind payloads
        self.queue: queue.Queue = queue.Queue(maxsize=mgr.RECV_QUEUE)
        self.done = threading.Event()
        self.dead = threading.Event()
        self.error: Exception | None = None
        self.result: dict | None = None
        self.status = "init"
        self.bytes_done = 0
        self._resumed = False
        self._restage = False
        self._deadline = 0.0

    @classmethod
    def load(cls, mgr: StreamManager, sid: str, meta: dict, peer,
             timeout: float) -> "ReceiverSession":
        """Rebuild a persisted session: manifest + journaled watermark."""
        sess = cls(mgr, peer, meta["keyspace"], meta["table"],
                   meta["lo"], meta["hi"], "range", timeout, sid=sid)
        mpath = os.path.join(sess.dir, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as f:
                sess.manifest = json.load(f)
        apath = os.path.join(sess.dir, "acked.log")
        if os.path.exists(apath):
            with open(apath) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) == 2:
                        sess.acked.add((int(parts[0]), int(parts[1])))
        return sess

    # ------------------------------------------------------------ start --

    def start(self, resumed: bool = False) -> None:
        self._resumed = resumed
        self._deadline = time.monotonic() + self.timeout
        self.status = "requesting"
        METRICS.incr("streaming.sessions_started")
        if resumed:
            METRICS.incr("streaming.sessions_resumed")
            diagnostics.publish("stream.resumed", sid=self.sid,
                                peer=self.peer.name,
                                keyspace=self.keyspace, table=self.table,
                                acked=len(self.acked))
        diagnostics.publish("stream.start", sid=self.sid,
                            peer=self.peer.name, keyspace=self.keyspace,
                            table=self.table, kind=self.kind,
                            resumed=resumed)
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
            _write_json(os.path.join(self.dir, "meta.json"),
                        {"role": "receiver", "peer": self.peer.name,
                         "keyspace": self.keyspace, "table": self.table,
                         "lo": self.lo, "hi": self.hi})
        self.mgr.node.messaging.send_with_callback(
            Verb.STREAM_SESSION_REQ,
            {"sid": self.sid, "keyspace": self.keyspace,
             "table": self.table, "lo": self.lo, "hi": self.hi,
             "kind": self.kind, "chunk_size": self.mgr.CHUNK_SIZE,
             "have": sorted(self.acked)},
            self.peer, on_response=self._on_manifest,
            on_failure=self._on_req_failure, timeout=self.timeout)

    def _on_manifest(self, msg) -> None:
        """Distributor-thread callback: record the plan, hand the heavy
        lifting to the landing thread."""
        manifest = msg.payload
        if manifest.get("sid") != self.sid:
            return
        if self.manifest is not None \
                and self.manifest["files"] != manifest["files"]:
            # the sender re-planned (snapshot lost): the journaled
            # watermark is void — restage everything (the land thread
            # clears the stale staging files before writing)
            self.acked.clear()
            self._restage = True
        self.manifest = manifest
        self.status = "streaming"
        threading.Thread(target=self._land_loop, daemon=True,
                         name=f"stream-land-{self.sid[:8]}").start()

    def _on_req_failure(self, arg) -> None:
        kind = self.mgr.node.messaging.failure_kind(
            getattr(arg, "payload", None))
        self._fail(StreamSessionFailed(
            f"session {self.sid}: sender {self.peer.name} refused or "
            f"vanished ({kind or 'timeout'})"))

    # ------------------------------------------------------------- land --

    def _land_loop(self) -> None:
        mgr = self.mgr
        try:
            if self.dir is not None:
                if self._restage:
                    for fn in os.listdir(self.dir):
                        if fn.endswith(".part") or fn == "acked.log":
                            os.unlink(os.path.join(self.dir, fn))
                    self._restage = False
                _write_json(os.path.join(self.dir, "manifest.json"),
                            self.manifest)
            expected = {(f["fid"], i) for f in self.manifest["files"]
                        for i in range(f["chunks"])}
            while self.acked != expected:
                if self.dead.is_set():
                    return
                if time.monotonic() > self._deadline:
                    raise StreamSessionFailed(
                        f"session {self.sid} from {self.peer.name} "
                        f"timed out ({len(self.acked)}/{len(expected)} "
                        f"chunks landed)")
                try:
                    with mgr.land_stage.idle():
                        p = self.queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                with mgr.land_stage.busy():
                    self._land_chunk(p)
            self._complete()
        except Exception as e:
            self._fail(e)

    def _land_chunk(self, p: dict) -> None:
        mgr = self.mgr
        fid, idx, data, crc = p["fid"], p["idx"], p["data"], p["crc"]
        key = (fid, idx)
        if self.manifest is None or fid >= len(self.manifest["files"]):
            return
        if key in self.acked:
            self._send_ack(fid, idx)   # our ack was lost: re-ack
            return
        if zlib.crc32(data) & 0xffffffff != crc:
            METRICS.incr("streaming.crc_failures")
            return   # corrupt in flight: never acked, retransmit heals
        if self.dir is not None:
            path = os.path.join(self.dir, f"{fid}.part")
            faultfs.check("stream.land", path)
            _write_at(path, p["off"], data)
            with open(os.path.join(self.dir, "acked.log"), "a") as f:
                f.write(f"{fid} {idx}\n")
                f.flush()
                os.fsync(f.fileno())
        else:
            self._chunks[key] = data
        self.acked.add(key)
        self.bytes_done += len(data)
        mgr.land_stage.add_items(1, len(data))
        METRICS.incr("streaming.chunks_received")
        METRICS.incr("streaming.bytes_received", len(data))
        self._send_ack(fid, idx)

    def _send_ack(self, fid: int, idx: int) -> None:
        self.mgr.node.messaging.send_one_way(
            Verb.STREAM_ACK, {"sid": self.sid, "fid": fid, "idx": idx},
            self.peer)

    # --------------------------------------------------------- terminal --

    def _complete(self) -> None:
        if self.kind == "range":
            self.result = self._land_files()
        else:
            entry = self.manifest["files"][0]
            blob = b"".join(
                self._chunks[(0, i)] for i in range(entry["chunks"]))
            self.result = {"batch": batch_from_bytes(blob), "files": 0,
                           "gens": [], "cells": 0, "bytes": len(blob)}
        self.status = "complete"
        METRICS.incr("streaming.sessions_completed")
        diagnostics.publish("stream.complete", sid=self.sid,
                            peer=self.peer.name, keyspace=self.keyspace,
                            table=self.table,
                            bytes=self.result["bytes"],
                            files=self.result["files"],
                            resumed=self._resumed)
        self.mgr.record({"peer": self.peer.name, "direction": "in",
                         "keyspace": self.keyspace, "table": self.table,
                         "status": "complete",
                         "files": self.result["files"],
                         "bytes": self.result["bytes"]})
        try:
            self.mgr.node.messaging.send_one_way(
                Verb.STREAM_SESSION_DONE,
                {"sid": self.sid, "status": "complete"}, self.peer)
        except Exception:
            pass
        self.mgr._drop_session(self)
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
        self.done.set()

    def _land_files(self) -> dict:
        """Atomic landing: per source file set, write every component
        under a fresh local generation (`.stream` tmp + fsync +
        rename), sync the directory, then the TOC — the commit point.
        A crash anywhere earlier leaves zero visible sstables
        (Descriptor.discover requires the TOC) and replay_directory
        sweeps the orphans at restart."""
        from ..storage.sstable.format import Component
        from ..storage.sstable.writer import SSTableWriter
        node = self.mgr.node
        cfs = node.engine.store(self.keyspace, self.table)
        sets: dict[int, list[dict]] = {}
        leftover_entry = None
        for f in self.manifest["files"]:
            if f["set"] < 0:
                leftover_entry = f
            else:
                sets.setdefault(f["set"], []).append(f)
        gens: list[int] = []
        nbytes = 0
        for si in sorted(sets):
            entries = sets[si]
            gen = cfs.next_generation()
            version = entries[0]["version"]
            toc = next((f for f in entries
                        if f["comp"] == Component.TOC), None)
            for f in entries:
                if f is toc:
                    continue
                nbytes += self._land_component(cfs, version, gen, f)
            SSTableWriter._fsync_path(cfs.directory)
            if toc is not None:
                nbytes += self._land_component(cfs, version, gen, toc)
                SSTableWriter._fsync_path(cfs.directory)
            gens.append(gen)
        cells = 0
        if leftover_entry is not None:
            blob = _read_file(os.path.join(
                self.dir, f"{leftover_entry['fid']}.part"))
            leftover = batch_from_bytes(blob) if blob else None
            if leftover is not None and len(leftover):
                from ..storage.sstable import Descriptor, SSTableWriter
                gen = cfs.next_generation()
                w = SSTableWriter(Descriptor(cfs.directory, gen),
                                  cfs.table)
                w.append(leftover)
                w.finish()
                cells += len(leftover)
                nbytes += len(blob)
        if gens or cells:
            cfs.reload_sstables()
            gset = set(gens)
            cells += sum(s.n_cells for s in cfs.live_sstables()
                         if s.desc.generation in gset)
        return {"files": len(sets), "gens": gens, "cells": cells,
                "bytes": nbytes}

    def _land_component(self, cfs, version: str, gen: int,
                        f: dict) -> int:
        data = _read_file(os.path.join(self.dir, f"{f['fid']}.part"))
        path = os.path.join(cfs.directory,
                            f"{version}-{gen}-{f['comp']}")
        faultfs.check("stream.land", path)
        tmp = path + ".stream"
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return len(data)

    def _fail(self, e: Exception) -> None:
        if self.done.is_set():
            return
        self.status = "failed"
        self.error = e
        METRICS.incr("streaming.sessions_failed")
        diagnostics.publish("stream.failed", sid=self.sid,
                            peer=self.peer.name, keyspace=self.keyspace,
                            table=self.table, reason=repr(e))
        self.mgr.record({"peer": self.peer.name, "direction": "in",
                         "keyspace": self.keyspace, "table": self.table,
                         "status": "failed", "files": 0,
                         "bytes": self.bytes_done})
        try:
            self.mgr.node.messaging.send_one_way(
                Verb.STREAM_SESSION_DONE,
                {"sid": self.sid, "status": "failed",
                 "error": repr(e)}, self.peer)
        except Exception:
            pass
        self.mgr._drop_session(self)
        # durable state stays: resume_incomplete re-requests the tail
        self.done.set()

    def abort(self) -> None:
        """Local crash simulation / shutdown: stop without touching the
        on-disk state (that is what resume reads)."""
        self.dead.set()
        if not self.done.is_set():
            self.status = "aborted"
            self.error = StreamSessionFailed(
                f"session {self.sid} aborted (stream service closed)")
            self.mgr._drop_session(self)
            self.done.set()

    def abort_remote(self, reason) -> None:
        self._fail(StreamSessionFailed(
            f"session {self.sid}: sender reported failure: {reason}"))

    # ------------------------------------------------------------- wait --

    def wait(self) -> dict:
        """Block for the terminal state; raise on failure. Durable
        session state survives a failure for a later resume."""
        if not self.done.wait(self.timeout + 5.0):
            self.abort()
            raise TimeoutError(
                f"stream session {self.sid} from {self.peer.name} made "
                f"no progress within {self.timeout:.1f}s")
        if self.error is not None:
            raise self.error
        return self.result

    def progress_row(self) -> dict:
        total = sum(f["chunks"] for f in self.manifest["files"]) \
            if self.manifest else 0
        return {"sid": self.sid, "peer": self.peer.name,
                "direction": "in", "keyspace": self.keyspace,
                "table": self.table, "kind": self.kind,
                "status": self.status, "chunks_total": total,
                "chunks_done": len(self.acked),
                "bytes_total": sum(f["size"]
                                   for f in self.manifest["files"])
                if self.manifest else 0,
                "bytes_done": self.bytes_done}
