"""Paxos-backed lightweight transactions (compare-and-set).

Reference counterpart: service/paxos/ (Paxos.java / Paxos.md — v2 rounds:
begin(prepare) -> read -> condition -> propose(accept) -> commit;
PaxosState per partition; in-flight proposals from a previous coordinator
are finished by the next prepare). Entry: StorageProxy.cas:305.

Single-decree per (table, partition, ballot): ballots are monotonic
(timestamp, endpoint) pairs; a quorum of promises is required to read the
linearization point, a quorum of accepts to decide, and commit applies the
mutation through the normal write path on all replicas.

PaxosState is PERSISTED per node (the system.paxos role): every promise
and accept is appended to a CRC-framed log and fsynced BEFORE the replica
responds, and reloaded on restart. Without this, a majority restart could
forget an in-flight accepted value and let a later prepare decide a
different value for the same ballot slot — the quorum-intersection
argument requires promises/accepts to survive crashes.
"""
from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field

from ..storage.mutation import Mutation
from ..utils import varint as vi
from .messaging import Verb
from .replication import ConsistencyLevel, ReplicationStrategy


class CasTimeout(Exception):
    pass


class CasContention(Exception):
    pass


@dataclass(order=True, frozen=True)
class Ballot:
    ts: int
    endpoint: str

    def pack(self):
        return (self.ts, self.endpoint)

    @staticmethod
    def unpack(t):
        return Ballot(t[0], t[1]) if t else None


ZERO = Ballot(0, "")


@dataclass
class PaxosState:
    promised: Ballot = ZERO
    accepted_ballot: Ballot | None = None
    accepted_value: bytes | None = None
    committed: Ballot = ZERO
    lock: threading.Lock = field(default_factory=threading.Lock)


class PaxosLog:
    """Durable per-node paxos state (system.paxos role): an append-only
    CRC-framed record log, fsynced per record BEFORE the replica
    responds, snapshot-compacted when it grows. Record body:
    [16B table_id][vint pk_len][pk][kind u8][ballot ts vint]
    [vint ep_len][ep][vint val_len][value]  (kind: 0=promise 1=accept
    2=commit; accept carries the value, commit clears it)."""

    K_PROMISE, K_ACCEPT, K_COMMIT = 0, 1, 2
    COMPACT_EVERY = 4096

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.path = os.path.join(directory, "paxos.log")
        self._lock = threading.Lock()
        self._records = 0
        # single compaction at a time; while one is in flight, appends are
        # mirrored into _pending so the compactor can carry them into the
        # new file before the atomic replace (see compact())
        self._compact_mutex = threading.Lock()
        self._pending: list[bytes] | None = None

    def append(self, table_id, pk: bytes, kind: int, ballot: "Ballot",
               value: bytes | None) -> None:
        frame = self._frame(table_id, pk, kind, ballot, value)
        with self._lock:
            with open(self.path, "ab") as f:
                f.write(frame)
                f.flush()
                os.fsync(f.fileno())
            if self._pending is not None:
                self._pending.append(frame)
            self._records += 1

    def replay(self):
        """Yield (table_id_bytes, pk, kind, Ballot, value) records; a torn
        tail (crash mid-append) stops the replay cleanly."""
        import uuid as uuid_mod
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + 8 <= len(data):
            ln, crc = struct.unpack_from("<II", data, pos)
            body = data[pos + 8:pos + 8 + ln]
            if len(body) < ln or zlib.crc32(body) != crc:
                return                      # torn tail
            pos += 8 + ln
            tid = uuid_mod.UUID(bytes=bytes(body[:16]))
            p = 16
            n, p = vi.read_unsigned_vint(body, p)
            pk = bytes(body[p:p + n])
            p += n
            kind = body[p]
            p += 1
            ts, p = vi.read_signed_vint(body, p)
            n, p = vi.read_unsigned_vint(body, p)
            ep = bytes(body[p:p + n]).decode()
            p += n
            n, p = vi.read_unsigned_vint(body, p)
            value = bytes(body[p:p + n]) if n else None
            self._records += 1
            yield tid, pk, kind, Ballot(ts, ep), value

    @staticmethod
    def _frame(table_id, pk: bytes, kind: int, ballot: "Ballot",
               value: bytes | None) -> bytes:
        body = bytearray()
        body += table_id.bytes
        vi.write_unsigned_vint(len(pk), body)
        body += pk
        body.append(kind)
        vi.write_signed_vint(ballot.ts, body)
        ep = ballot.endpoint.encode()
        vi.write_unsigned_vint(len(ep), body)
        body += ep
        v = value or b""
        vi.write_unsigned_vint(len(v), body)
        body += v
        return struct.pack("<II", len(body), zlib.crc32(bytes(body))) \
            + bytes(body)

    def compact(self, states) -> None:
        """Rewrite the log as a snapshot of live state (old rounds whose
        commit already landed need no history). Frames are built in
        memory — each state copied under ITS lock so a concurrent accept
        cannot be captured torn — then written + fsynced ONCE (never via
        append(): that would retake self._lock and fsync per record).

        Atomic w.r.t. concurrent appends: a promise/accept fsynced between
        a state's snapshot and the os.replace must not be erased from the
        durable log (a crash would then replay pre-promise state and
        re-promise a lower ballot). While this method runs, append()
        mirrors every frame into _pending (still fsyncing to the old file,
        so durability never lapses); before the replace — under the log
        lock, so no new appends race it — the pending frames are appended
        to the new file and fsynced. Replay is idempotent (max-ballot
        semantics), so a frame landing in both snapshot and delta is
        harmless."""
        if not self._compact_mutex.acquire(blocking=False):
            return          # a compaction is already rewriting the log
        try:
            with self._lock:
                self._pending = []
            # snapshot AFTER arming: a state created+appended between a
            # pre-arm snapshot and the arm would be in neither the
            # snapshot nor the pending buffer — callers pass a callable
            # so the copy happens here, inside the mirrored window
            if callable(states):
                states = states()
            frames: list[bytes] = []
            n = 0
            for (tid, pk), st in states.items():
                with st.lock:
                    promised, committed = st.promised, st.committed
                    ab, av = st.accepted_ballot, st.accepted_value
                if promised != ZERO:
                    frames.append(self._frame(tid, pk, self.K_PROMISE,
                                              promised, None))
                    n += 1
                if ab is not None:
                    frames.append(self._frame(tid, pk, self.K_ACCEPT,
                                              ab, av))
                    n += 1
                if committed != ZERO:
                    frames.append(self._frame(tid, pk, self.K_COMMIT,
                                              committed, None))
                    n += 1
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(b"".join(frames))
                f.flush()
                os.fsync(f.fileno())
            with self._lock:
                if self._pending:
                    with open(tmp, "ab") as f:
                        f.write(b"".join(self._pending))
                        f.flush()
                        os.fsync(f.fileno())
                    n += len(self._pending)
                os.replace(tmp, self.path)
                dfd = os.open(self.directory, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
                self._records = n
        finally:
            # a failed compaction (disk full mid-tmp-write) must not
            # leave append-mirroring armed forever; the old log file is
            # still intact and durable
            with self._lock:
                self._pending = None
            self._compact_mutex.release()


class PaxosService:
    def __init__(self, node):
        self.node = node
        self._states: dict[tuple, PaxosState] = {}
        self._lock = threading.Lock()
        data_dir = getattr(getattr(node, "engine", None), "data_dir", None)
        self.log = PaxosLog(os.path.join(data_dir, "paxos")) \
            if data_dir else None
        if self.log is not None:
            self._reload()
        ms = node.messaging
        ms.register_handler("PAXOS_PREPARE", self._handle_prepare)
        ms.register_handler("PAXOS_PROPOSE", self._handle_propose)
        ms.register_handler("PAXOS_COMMIT", self._handle_commit)

    def _reload(self) -> None:
        for tid, pk, kind, ballot, value in self.log.replay():
            st = self._state(tid, pk)
            if kind == PaxosLog.K_PROMISE:
                st.promised = max(st.promised, ballot)
            elif kind == PaxosLog.K_ACCEPT:
                st.promised = max(st.promised, ballot)
                st.accepted_ballot = ballot
                st.accepted_value = value
            else:
                st.committed = max(st.committed, ballot)
                if st.accepted_ballot is not None \
                        and st.accepted_ballot <= ballot:
                    st.accepted_ballot = None
                    st.accepted_value = None

    def _persist(self, table_id, pk, kind, ballot, value=None) -> None:
        """Called UNDER the partition's st.lock (durability must precede
        the response). Append-only here; compaction runs from
        _maybe_compact AFTER the handler releases st.lock (compact takes
        every state lock — inline it would self-deadlock)."""
        if self.log is None:
            return
        self.log.append(table_id, pk, kind, ballot, value)

    def _maybe_compact(self) -> None:
        if self.log is not None \
                and self.log._records >= PaxosLog.COMPACT_EVERY:
            def snapshot():
                with self._lock:
                    return dict(self._states)
            self.log.compact(snapshot)

    def _state(self, table_id, pk: bytes) -> PaxosState:
        key = (table_id, pk)
        with self._lock:
            st = self._states.get(key)
            if st is None:
                st = self._states[key] = PaxosState()
            return st

    # ------------------------------------------------------------ replicas

    def _handle_prepare(self, msg):
        table_id, pk, ballot_t = msg.payload
        ballot = Ballot.unpack(ballot_t)
        st = self._state(table_id, pk)
        with st.lock:
            if ballot > st.promised:
                st.promised = ballot
                # durable BEFORE the response: a promise a crash can
                # forget breaks quorum intersection
                self._persist(table_id, pk, PaxosLog.K_PROMISE, ballot)
                rsp = {
                    "promised": True,
                    "accepted_ballot": st.accepted_ballot.pack()
                    if st.accepted_ballot else None,
                    "accepted_value": st.accepted_value,
                    "committed": st.committed.pack(),
                }
            else:
                rsp = {"promised": False,
                       "promised_ballot": st.promised.pack()}
        self._maybe_compact()
        return "PAXOS_PROMISE", rsp

    def _handle_propose(self, msg):
        table_id, pk, ballot_t, value = msg.payload
        ballot = Ballot.unpack(ballot_t)
        st = self._state(table_id, pk)
        with st.lock:
            if ballot >= st.promised:
                st.promised = ballot
                st.accepted_ballot = ballot
                st.accepted_value = value
                self._persist(table_id, pk, PaxosLog.K_ACCEPT, ballot,
                              value)
                rsp = {"accepted": True}
            else:
                rsp = {"accepted": False}
        self._maybe_compact()
        return "PAXOS_ACCEPTED", rsp

    def _handle_commit(self, msg):
        table_id, pk, ballot_t, value = msg.payload
        ballot = Ballot.unpack(ballot_t)
        st = self._state(table_id, pk)
        with st.lock:
            if ballot > st.committed:
                st.committed = ballot
                if st.accepted_ballot is not None \
                        and st.accepted_ballot <= ballot:
                    st.accepted_ballot = None
                    st.accepted_value = None
                self._persist(table_id, pk, PaxosLog.K_COMMIT, ballot)
        self._maybe_compact()
        if value:
            self.node.engine.apply(Mutation.deserialize(value))
        return "PAXOS_COMMITTED", {}

    # ---------------------------------------------------------- coordinator

    def _quorum_round(self, verb, payload, replicas, timeout, need):
        """Send a round to all live replicas (self included), wait for
        `need` responses (majority of the FULL replica set — partitions
        must not let both sides decide)."""
        node = self.node
        results = []
        lock = threading.Lock()
        ev = threading.Event()

        def collect(res):
            with lock:
                results.append(res)
                if len(results) >= need:
                    ev.set()

        handler = {"PAXOS_PREPARE": self._handle_prepare,
                   "PAXOS_PROPOSE": self._handle_propose,
                   "PAXOS_COMMIT": self._handle_commit}[verb]
        for ep in replicas:
            if ep == node.endpoint:
                from .messaging import Message
                m = Message(verb, payload, ep, ep)
                collect(handler(m)[1])
            else:
                node.messaging.send_with_callback(
                    verb, payload, ep,
                    on_response=lambda m: collect(m.payload),
                    timeout=timeout)
        if not ev.wait(timeout):
            raise CasTimeout(f"{verb}: {len(results)}/{need} responses")
        with lock:
            return list(results)

    def cas(self, keyspace: str, table, pk: bytes, ck: bytes, check_fn,
            mutation_fn, timeout: float = 5.0, attempts: int = 10):
        """Linearizable compare-and-set: check_fn(current_row_dict|None) ->
        bool; mutation_fn() -> Mutation applied iff the check passed.
        Returns (applied, current_row)."""

        def check_and_build(read_row):
            current = read_row(ck)
            if not check_fn(current):
                return None, current
            return mutation_fn(), current

        return self.cas_partition(keyspace, table, pk, check_and_build,
                                  timeout, attempts)

    def cas_partition(self, keyspace: str, table, pk: bytes,
                      check_and_build, timeout: float = 5.0,
                      attempts: int = 10):
        """Partition-scoped CAS — the primitive under single-row LWT and
        CONDITIONAL BATCHES (BatchStatement.executeWithConditions: the
        Paxos instance is keyed by (table, partition), so conditions
        over MULTIPLE rows of one partition serialize in one round).
        check_and_build(read_row) runs at the linearization point with
        read_row(ck) -> row_dict|None (QUORUM reads); it returns
        (Mutation|None, info) — None aborts with applied=False."""
        node = self.node
        ks = node.schema.keyspaces[keyspace]
        strat = ReplicationStrategy.create(ks.params.replication)
        token = node.ring.token_of(pk)
        all_replicas = strat.replicas(node.ring, token) or [node.endpoint]
        # quorum from the CONFIGURED RF: SERIAL on an undersized ring must
        # refuse like QUORUM does, not decide with fewer promises than a
        # real majority of the replication factor (Paxos.java blockFor)
        need = strat.replication_factor() // 2 + 1
        live = [r for r in all_replicas if node.is_alive(r)]
        if len(live) < need:
            from .coordinator import UnavailableException
            raise UnavailableException(
                f"SERIAL requires {need}/{len(all_replicas)} replicas, "
                f"{len(live)} alive")

        last_contention = None
        for attempt in range(attempts):
            ballot = self._next_ballot()
            promises = self._quorum_round(
                "PAXOS_PREPARE", (table.id, pk, ballot.pack()),
                live, timeout, need)
            if not all(p.get("promised") for p in promises):
                last_contention = CasContention("prepare rejected")
                time.sleep(0.01 * (attempt + 1))
                continue
            # finish an in-flight accepted-but-uncommitted proposal first
            inflight = [(Ballot.unpack(p["accepted_ballot"]),
                         p["accepted_value"]) for p in promises
                        if p.get("accepted_ballot") is not None]
            if inflight:
                ib, iv = max(inflight, key=lambda x: x[0])
                acc = self._quorum_round(
                    "PAXOS_PROPOSE", (table.id, pk, ballot.pack(), iv),
                    live, timeout, need)
                if all(a.get("accepted") for a in acc):
                    self._quorum_round(
                        "PAXOS_COMMIT", (table.id, pk, ballot.pack(), iv),
                        live, timeout, need)
                    self._commit_to_pending(strat, token, all_replicas, iv)
                # either way: retry our own round on fresh state
                continue

            # linearization point: reads at QUORUM, conditions, and
            # the mutation build happen under the promised ballot. The
            # partition is read ONCE per attempt and indexed by
            # clustering — N conditions must not cost N quorum reads
            # inside the contention window
            row_cache: dict = {}

            def read_row(ck_):
                if "rows" not in row_cache:
                    row_cache["rows"] = self._read_partition_rows(
                        keyspace, table, pk)
                return row_cache["rows"].get(ck_)

            mutation, info = check_and_build(read_row)
            if mutation is None:
                return False, info
            value = mutation.serialize()
            accepts = self._quorum_round(
                "PAXOS_PROPOSE", (table.id, pk, ballot.pack(), value),
                live, timeout, need)
            if not all(a.get("accepted") for a in accepts):
                last_contention = CasContention("propose rejected")
                time.sleep(0.01 * (attempt + 1))
                continue
            self._quorum_round("PAXOS_COMMIT",
                               (table.id, pk, ballot.pack(), value),
                               live, timeout, need)
            self._commit_to_pending(strat, token, all_replicas, value)
            return True, info
        raise last_contention or CasContention("cas retries exhausted")

    def _commit_to_pending(self, strat, token, natural, value) -> None:
        """Duplicate the decided mutation to pending (joining) replicas
        acquiring this token — an LWT decided mid-bootstrap must exist on
        the new owner after the ownership flip, exactly like plain
        writes (StorageProxy pending targets); hint on failure."""
        if not value:
            return
        for target in self.node.proxy._pending_targets(
                strat, token, natural):
            mutation = Mutation.deserialize(value)
            if target == self.node.endpoint:
                try:
                    self.node.engine.apply(mutation)
                except Exception:
                    self.node.hints.store(target, mutation)
            else:
                self.node.messaging.send_with_callback(
                    Verb.MUTATION_REQ, value, target,
                    on_response=lambda m: None,
                    on_failure=lambda mid, t=target, mm=mutation:
                        self.node.hints.store(t, mm),
                    timeout=self.node.proxy.timeout)

    _last_ballot_ts = 0
    _ballot_lock = threading.Lock()

    def _next_ballot(self) -> Ballot:
        """Wall-clock-derived monotonic ballots: comparable ACROSS
        processes (the reference uses UUID-v1 ballots for the same
        reason; monotonic_ns has a per-process epoch and must not be
        used)."""
        with self._ballot_lock:
            ts = max(time.time_ns(), PaxosService._last_ballot_ts + 1)
            PaxosService._last_ballot_ts = ts
        return Ballot(ts, self.node.endpoint.name)

    def _read_partition_rows(self, keyspace: str, table,
                             pk: bytes) -> dict:
        """One QUORUM partition read, indexed {ck_frame: row_dict} —
        the shared read under multi-condition CAS."""
        from ..storage.rows import row_to_dict, rows_from_batch
        batch = self.node.proxy.read_partition(
            keyspace, table.name, pk, ConsistencyLevel.QUORUM)
        out = {}
        for r in rows_from_batch(table, batch):
            if not r.is_static:
                out[r.ck_frame] = row_to_dict(table, r)
        return out

    def _read_row(self, keyspace, table, pk, ck):
        from ..storage.rows import row_to_dict, rows_from_batch
        batch = self.node.proxy.read_partition(
            keyspace, table.name, pk, ConsistencyLevel.QUORUM)
        for r in rows_from_batch(table, batch):
            if not r.is_static and r.ck_frame == ck:
                return row_to_dict(table, r)
        return None
