"""Node: one database instance (engine + messaging + gossip + coordinator)
and LocalCluster: N nodes in one process with interceptable messaging —
the jvm-dtest harness (reference test/distributed/impl/AbstractCluster.java:
one Instance per classloader, in-memory message routing, MessageFilters).
"""
from __future__ import annotations

import os
import threading
import time

from ..cql.execution import Executor
from ..cql.processor import Session
from ..device import resolve as resolve_device
from ..schema import Schema
from ..storage import cellbatch as cbmod
from ..storage.engine import StorageEngine
from ..storage.mutation import Mutation
from .coordinator import StorageProxy, cb_serialize
from .gossip import Gossiper
from .hints import HintsService
from .messaging import LocalTransport, MessagingService, Verb
from .replication import ConsistencyLevel
from .ring import Endpoint, Ring, even_tokens


class Node:
    def __init__(self, endpoint: Endpoint, data_dir: str, schema: Schema,
                 ring: Ring, transport: LocalTransport,
                 seeds: list[Endpoint], gossip_interval: float = 0.1,
                 engine_opts: dict | None = None):
        self.endpoint = endpoint
        self.schema = schema
        self.ring = ring
        self.engine = StorageEngine(data_dir, schema,
                                    commitlog_sync="batch",
                                    **(engine_opts or {}))
        self.messaging = MessagingService(endpoint, transport)
        self.hints = HintsService(os.path.join(data_dir, "hints"))
        self.gossiper = Gossiper(self.messaging, seeds,
                                 interval=gossip_interval)
        self.gossiper.on_alive = self._on_peer_alive
        self.gossiper.on_dead = self._on_peer_dead
        # runtime knobs for the liveness/hints machinery (ctpulint
        # knob-wiring): phi_convict_threshold drives the failure
        # detector live, max_hint_window (seconds in config) feeds the
        # ms-denominated window below, hinted_handoff_enabled follows
        # the same gate nodetool disablehandoff flips
        self._settings_subs: list = []
        _settings = getattr(self.engine, "settings", None)
        if _settings is not None:
            det = self.gossiper.detector
            det.threshold = float(_settings.get("phi_convict_threshold"))
            self.max_hint_window_ms = \
                float(_settings.get("max_hint_window")) * 1000.0
            self.hints.enabled = bool(
                _settings.get("hinted_handoff_enabled"))
            self.messaging.set_dispatch_workers(
                int(_settings.get("internode_dispatch_threads")))
            for name, cb_ in (
                    ("phi_convict_threshold",
                     lambda v: setattr(det, "threshold", float(v))),
                    ("max_hint_window",
                     lambda v: setattr(self, "max_hint_window_ms",
                                       float(v) * 1000.0)),
                    ("hinted_handoff_enabled",
                     lambda v: setattr(self.hints, "enabled", bool(v))),
                    # attribute re-read at fire time, so a restarted
                    # node's fresh MessagingService picks up later flips
                    ("internode_dispatch_threads",
                     lambda v: self.messaging.set_dispatch_workers(
                         int(v))),
                    # same re-read pattern: restart_node swaps in a
                    # fresh StreamService and later flips must land on
                    # the live one's token bucket
                    ("stream_throughput_outbound",
                     lambda v: self.streams.set_throughput(float(v))),
                    ("inter_dc_stream_throughput_outbound",
                     lambda v: self.streams.set_throughput(
                         float(v), inter_dc=True))):
                _settings.on_change(name, cb_)
                self._settings_subs.append((name, cb_))
        # disk/commit failure policy `stop`/`die`: the engine's failure
        # handler calls back so the node leaves the ring the way the
        # reference's StorageService.stopTransports does. on_stop only:
        # the die path chains into _stop, so registering on both would
        # run the transition (and push the DOWN event) twice
        self.engine.failures.on_stop(self._on_storage_failure)
        # server-push event bus (transport EVENT role): CQL servers and
        # tests subscribe; liveness/topology/schema transitions fan out
        self._event_listeners: list = []
        # last successful telemetry snapshot per peer (clusterstats'
        # staleness source); created HERE, not lazily — two racing
        # first pulls must not each mint a cache and drop the other's
        # last-known snapshots
        self._peer_telemetry: dict = {}
        self.proxy = StorageProxy(self)
        self._register_verbs()
        from .repair import RepairService
        self.repair = RepairService(self)
        from ..storage.virtual import build_node_virtuals
        self.virtual_tables = build_node_virtuals(self)
        from .paxos import PaxosService
        self.paxos = PaxosService(self)
        from .counters import CounterService
        self.counters = CounterService(self)
        from .streaming import StreamService
        self.streams = StreamService(self)
        self.default_cl = ConsistencyLevel.ONE
        # periodic hint dispatch (HintsDispatchExecutor role): hints must
        # flow even when the target was never convicted dead
        self._stop_hints = threading.Event()
        self._hint_thread = threading.Thread(
            target=self._hint_loop, daemon=True,
            name=f"hints-{endpoint.name}")
        self._hint_thread.start()

    def cas(self, keyspace, table, pk, ck, check_fn, mutation_fn):
        """Linearizable conditional write (StorageProxy.cas role)."""
        return self.paxos.cas(keyspace, table, pk, ck, check_fn,
                              mutation_fn, timeout=self.proxy.timeout)

    def cas_partition(self, keyspace, table, pk, check_and_build):
        """Partition-scoped CAS: conditional batches
        (StorageProxy.cas over BatchStatement conditions)."""
        return self.paxos.cas_partition(keyspace, table, pk,
                                        check_and_build,
                                        timeout=self.proxy.timeout)

    @property
    def batchlog(self):
        """Logged batches persist in the coordinator's batchlog before the
        replicated applies (BatchlogManager role)."""
        return self.engine.batchlog

    # reference default: 3h (cassandra.yaml max_hint_window)
    max_hint_window_ms = 3 * 3600 * 1000

    def should_hint(self, target) -> bool:
        """StorageProxy.shouldHint: no new hints for targets in a
        hint-disabled DC, or dead longer than the hint window (their
        backlog would only grow unboundedly — the node needs repair,
        not hints, when it returns)."""
        if not self.hints.enabled:
            # disablehandoff: without this gate a CL.ANY write to dead
            # replicas would ack on a hint store() silently dropped
            return False
        if target.dc in self.hints.disabled_dcs:
            return False
        st = self.gossiper.states.get(target)
        if st is not None and not st.alive and st.last_heartbeat != 0:
            # last_heartbeat == 0 means the peer was never heard from:
            # downtime is UNKNOWN, not "since the epoch" — the reference
            # (Gossiper.getEndpointDowntime) reports 0 there and hints.
            # Without this a replica marked down before its first
            # heartbeat silently lost every hint. (assassinate pushes
            # last_heartbeat far negative, so it still refuses here.)
            dead_s = self.gossiper.clock() - st.last_heartbeat
            if dead_s * 1000.0 > self.max_hint_window_ms:
                return False
        return True

    @property
    def guardrails(self):
        """The executor reads guardrails off its backend; a Node backend
        delegates to the engine's instance (one catalog per node)."""
        return self.engine.guardrails

    @property
    def audit_log(self):
        """Processor reads the audit/FQL streams off its backend —
        delegate so Node-backed sessions audit like engine-backed."""
        return self.engine.audit_log

    @property
    def fql_log(self):
        return self.engine.fql_log

    @property
    def settings(self):
        """Node-backed sessions read runtime settings (trace sampling,
        thresholds) off their backend like engine-backed ones."""
        return self.engine.settings

    @property
    def trace_store(self):
        """Coordinator-side trace sessions persist on this node's own
        engine store (system_traces role)."""
        return self.engine.trace_store

    # ------------------------------------------------------------- verbs --

    def _register_verbs(self):
        ms = self.messaging
        ms.register_handler(Verb.MUTATION_REQ, self._handle_mutation)
        ms.register_handler(Verb.READ_REQ, self._handle_read)
        ms.register_handler(Verb.RANGE_REQ, self._handle_range)
        ms.register_handler(Verb.HINT_REQ, self._handle_mutation)
        ms.register_handler(Verb.TRUNCATE_REQ, self._handle_truncate)
        ms.register_handler(Verb.INDEX_REQ, self._handle_index)
        ms.register_handler(Verb.METRICS_SNAPSHOT_REQ,
                            self._handle_metrics_snapshot)

    def _handle_mutation(self, msg):
        mutation = Mutation.deserialize(msg.payload)
        self.engine.apply(mutation)
        return Verb.MUTATION_RSP, b""

    def _handle_read(self, msg):
        keyspace, table_name, pk, *rest = msg.payload
        digest_only = bool(rest[0]) if rest else False
        limits = cbmod.DataLimits.from_wire(rest[1]) \
            if len(rest) > 1 else None
        batch = self.engine.store(keyspace, table_name).read_partition(pk)
        # DataLimits pushdown: truncate at the source so LIMIT 1 on a
        # huge partition ships bytes proportional to the limit, not the
        # partition (db/filter/DataLimits.java:44); `more` feeds the
        # coordinator's short-read protection
        batch, more = cbmod.truncate_live_rows(batch, limits)
        if digest_only:
            # digest read: 16 bytes back instead of the partition —
            # computed over the SAME limited view every replica produces
            return Verb.READ_RSP, cbmod.content_digest(batch)
        return Verb.READ_RSP, (cb_serialize(batch), more)

    def _handle_range(self, msg):
        keyspace, table_name, *window = msg.payload
        store = self.engine.store(keyspace, table_name)
        if window:
            lo, hi = window[0], window[1]
            batch = store.scan_window(int(lo), int(hi))
            if len(window) > 2 and window[2] is not None:
                # DataLimits pushdown for range reads: truncate the arc
                # response at the source (db/filter/DataLimits over
                # RangeCommands); `more` feeds per-arc short-read
                # protection at the coordinator
                limits = cbmod.DataLimits.from_wire(window[2])
                batch, more = cbmod.truncate_live_rows(batch, limits)
                return Verb.RANGE_RSP, (cb_serialize(batch), more)
        else:
            batch = store.scan_all()
        return Verb.RANGE_RSP, cb_serialize(batch)

    def _handle_index(self, msg):
        """Local index candidates for a distributed filtered read
        (replica side of ReplicaFilteringProtection: each queried
        replica contributes ITS view of matching locators; the
        coordinator re-reads every candidate at the read CL and
        re-checks the predicate, so stale local matches are dropped and
        matches another replica missed are found)."""
        keyspace, table_name, col, op, value = msg.payload
        registry = getattr(self.engine, "indexes", None)
        idx = registry.get(keyspace, table_name, col) \
            if registry is not None else None
        locators: list = []
        if idx is not None:
            if op == "=" and hasattr(idx, "lookup"):
                locators = list(idx.lookup(value))
            elif op == "LIKE" and hasattr(idx, "search"):
                locators = list(idx.search(str(value)) or [])
            elif op == "ANN" and hasattr(idx, "ann"):
                import numpy as np
                q, k = value
                locators = [(pk, ck, float(score)) for pk, ck, score in
                            idx.ann(np.asarray(q, dtype=np.float32),
                                    int(k))]
        return Verb.INDEX_RSP, locators

    def _handle_truncate(self, msg):
        keyspace, table_name = msg.payload
        store = self.engine.store(keyspace, table_name)
        store.truncate()
        self.counters.invalidate_table(store.table.id)
        return Verb.TRUNCATE_RSP, b""

    # ----------------------------------------------------- cluster telemetry

    def telemetry_snapshot(self) -> dict:
        """One node's ENGINE-scoped telemetry — the METRICS_SNAPSHOT_RSP
        payload behind `nodetool clusterstats`: tpstats, compaction
        gauges, per-table counters + amplification, the SLO snapshot
        and messaging counters. Engine-scoped on purpose: in-process
        clusters share the process-global metrics registry, so a
        cluster view built from global counters would show every node
        the same numbers."""
        from ..tools.nodetool import tpstats
        eng = self.engine
        tables = {}
        writes = 0
        for cfs in list(eng.stores.values()):
            live = cfs.live_sstables()
            writes += cfs.metrics.get("writes", 0)
            tables[cfs.table.full_name()] = {
                **{k: int(v) for k, v in cfs.metrics.items()},
                **cfs.amplification(),
                "sstables": len(live),
                "live_bytes": sum(s.size_bytes for s in live),
            }
        return {
            "endpoint": self.endpoint.name,
            "at_ms": int(time.time() * 1000),
            "tpstats": tpstats(eng),
            "compactions": eng.compactions.gauges(),
            "tables": tables,
            "storage_writes": writes,
            "write_stalls": eng.write_stalls,
            "slo": eng.slo.snapshot(),
            "messaging": dict(self.messaging.metrics),
        }

    def _handle_metrics_snapshot(self, msg):
        return Verb.METRICS_SNAPSHOT_RSP, self.telemetry_snapshot()

    def pull_cluster_telemetry(self, timeout: float = 2.0) -> dict:
        """Pull every peer's telemetry snapshot over the
        METRICS_SNAPSHOT verb (the local node serves itself directly).
        Bounded: a peer that does not answer within `timeout` is
        reported with its LAST successfully-pulled snapshot and a
        staleness stamp — or no snapshot at all if it was never heard
        from — so a dark node can never hang the pull. The response
        callbacks only record the payload and signal an event; nothing
        blocking ever runs on the messaging dispatch worker."""
        cache = self._peer_telemetry
        peers = [ep for ep in list(self.ring.endpoints)
                 if ep != self.endpoint]
        done = threading.Event()
        state = {"pending": len(peers)}
        lock = threading.Lock()

        def _one_done():
            with lock:
                state["pending"] -= 1
                if state["pending"] <= 0:
                    done.set()

        t_pull = time.monotonic()
        for ep in peers:
            def on_rsp(msg, _ep=ep):
                cache[_ep.name] = (msg.payload, time.monotonic())
                _one_done()

            def on_fail(_arg, _ep=ep):
                _one_done()

            self.messaging.send_with_callback(
                Verb.METRICS_SNAPSHOT_REQ, b"", ep,
                on_rsp, on_failure=on_fail, timeout=timeout)
        if peers:
            # margin covers the reaper's 100 ms expiry granularity
            done.wait(timeout + 1.0)
        rows = [{"endpoint": self.endpoint.name, "alive": True,
                 "fresh": True, "stale_s": 0.0,
                 "snapshot": self.telemetry_snapshot()}]
        now = time.monotonic()
        for ep in peers:
            entry = cache.get(ep.name)
            rows.append({
                "endpoint": ep.name,
                "alive": self.is_alive(ep),
                "fresh": entry is not None and entry[1] >= t_pull,
                "stale_s": (None if entry is None
                            else round(now - entry[1], 3)),
                "snapshot": entry[0] if entry is not None else None,
            })
        return {"nodes": rows,
                "pulled_at_ms": int(time.time() * 1000)}

    # ---------------------------------------------------------- liveness --

    def is_alive(self, ep: Endpoint) -> bool:
        return ep == self.endpoint or self.gossiper.is_alive(ep)

    def add_event_listener(self, fn) -> None:
        """fn(kind, info): kind in STATUS_CHANGE / TOPOLOGY_CHANGE /
        SCHEMA_CHANGE (the native protocol's registerable events)."""
        self._event_listeners.append(fn)

    def remove_event_listener(self, fn) -> None:
        try:
            self._event_listeners.remove(fn)
        except ValueError:
            pass

    def emit_event(self, kind: str, info: dict) -> None:
        for fn in list(self._event_listeners):
            try:
                fn(kind, info)
            except Exception:
                pass

    def _on_peer_alive(self, ep: Endpoint):
        self.emit_event("STATUS_CHANGE", {"change": "UP", "host": ep.host,
                                          "port": ep.port})
        self._dispatch_hints(ep)

    def _on_peer_dead(self, ep: Endpoint):
        self.emit_event("STATUS_CHANGE", {"change": "DOWN",
                                          "host": ep.host,
                                          "port": ep.port})

    def _on_storage_failure(self, err) -> None:
        """A `stop`/`die` failure policy tripped: transition out of the
        ring. Own gossip status flips to shutdown and the gossiper
        stops speaking — peers convict via phi accrual exactly as they
        would for a dead process (the reference stops gossip and the
        client transports; the admin/CQL servers here check the same
        failure gates on every request)."""
        g = self.gossiper
        with g._lock:
            st = g.states.get(self.endpoint)
            if st is not None:
                st.app_states["status"] = "shutdown"
                st.version += 1
        g.stop()
        self.emit_event("STATUS_CHANGE", {"change": "DOWN",
                                          "host": self.endpoint.host,
                                          "port": self.endpoint.port})

    def _hint_loop(self):
        while not self._stop_hints.wait(0.5):
            try:
                self.hint_round()
            except Exception:
                # replay I/O errors are handled (and counted) inside
                # hint_round per target; anything escaping here is a
                # bug that must not silently end hint dispatch for the
                # node's lifetime (ctpulint worker-loops)
                self.hints.metrics["dispatch_failures"] = \
                    self.hints.metrics.get("dispatch_failures", 0) + 1

    def hint_round(self) -> None:
        """One hint-dispatch pass (extracted so the deterministic
        simulator can drive it as a timer instead of a thread). Self
        included: a failed local apply (e.g. as a pending replica)
        leaves a self-hint that replays through the transport
        loopback."""
        for ep in list(self.ring.endpoints) + [self.endpoint]:
            if self.hints.has_hints(ep) and self.is_alive(ep):
                try:
                    self._dispatch_hints(ep)
                except Exception:
                    pass

    def _dispatch_hints(self, ep: Endpoint):
        """Replay hints with acks: un-acked mutations are re-stored so a
        still-unreachable target keeps its hints."""
        if not self.hints.has_hints(ep):
            return

        def send(m):
            self.messaging.send_with_callback(
                Verb.HINT_REQ, m.serialize(), ep,
                on_response=lambda rsp: None,
                on_failure=lambda mid, mm=m: self.hints.store(
                    ep, mm, redelivery=True),
                timeout=self.proxy.timeout)

        self.hints.dispatch(ep, send)

    # -------------------------------------------------- CQL backend role --

    @property
    def indexes(self):
        return getattr(self.engine, "indexes", None)

    @property
    def triggers(self):
        return getattr(self.engine, "triggers", None)

    @property
    def monitor(self):
        return getattr(self.engine, "monitor", None)

    def apply(self, mutation: Mutation, durable: bool = True) -> None:
        t = self.schema.table_by_id(mutation.table_id)
        if t is None:
            raise KeyError(f"unknown table id {mutation.table_id}")
        from ..storage.cellbatch import FLAG_COUNTER
        if any(op[7] & FLAG_COUNTER for op in mutation.ops):
            # increments are not idempotent: route through the counter
            # leader (cluster/counters.py), never the plain write path
            self.counters.mutate(t.keyspace, mutation, self.default_cl)
        else:
            self.proxy.mutate(t.keyspace, mutation, self.default_cl)

    def store(self, keyspace: str, name: str):
        return _DistributedStore(self, keyspace, name)

    def add_table(self, t):
        # shared-schema round 1: every node opens a store for the table
        # (distributed schema agreement lands with the cluster-metadata log)
        for node in self.cluster_nodes:
            node.engine._open_store(t)
        self.schema.add_table(t)

    def drop_table(self, keyspace: str, name: str):
        t = self.schema.get_table(keyspace, name)
        for node in self.cluster_nodes:
            cfs = node.engine.stores.pop(t.id, None)
            if cfs:
                cfs.truncate()
            node.counters.invalidate_table(t.id)
        self.schema.drop_table(keyspace, name)

    cluster_nodes: list = ()
    schema_sync = None   # TCM-lite DDL replication (cluster/schema_sync)

    def session(self) -> Session:
        return Session(self)

    # ------------------------------------------------- topology changes --

    def topology_commit(self, extra: dict) -> None:
        """Commit one topology transformation. TCP clusters route it
        through the epoch log (every node applies the same entries in
        the same order — tcm/Commit); LocalCluster nodes share one Ring
        object, so the transformation applies directly."""
        from .schema_sync import apply_topology_to_ring, \
            emit_topology_event
        if self.schema_sync is not None:
            self.schema_sync.commit_topology(extra)
        else:
            apply_topology_to_ring(self.ring, extra)
            # in-process path: peers share the ring object, so each node
            # emits its own driver-facing event here
            for n in (self.cluster_nodes or [self]):
                emit_topology_event(n, extra)

    def _ep_dict(self, ep: Endpoint | None = None) -> dict:
        ep = ep or self.endpoint
        return {"name": ep.name, "dc": ep.dc, "rack": ep.rack,
                "host": ep.host, "port": ep.port}

    def join_cluster(self, tokens: list[int]) -> int:
        """Full TCM join sequence (tcm/sequences/BootstrapAndJoin):
        start_join (tokens pending, writes duplicated) -> stream ->
        finish_join (ownership flip). Resumable: a crash between the
        two entries leaves start_join in the log; resume_topology()
        on restart re-streams and commits the finish."""
        self.topology_commit({"op": "start_join", "node": self._ep_dict(),
                              "tokens": [int(t) for t in tokens]})
        try:
            streamed = self.bootstrap()
        except BaseException:
            self.topology_commit({"op": "abort_join",
                                  "node": self._ep_dict()})
            raise
        self.topology_commit({"op": "finish_join",
                              "node": self._ep_dict()})
        return streamed

    def move_tokens(self, new_tokens: list[int]) -> int:
        """nodetool move (tcm/sequences/Move): gained ranges stream IN
        from their current owners (pending-write duplication active
        meanwhile); after the flip, data of surrendered ranges streams
        OUT to its new owners, acked, before this returns."""
        from ..storage.cellbatch import filter_token_range
        from .replication import ReplicationStrategy
        me = self.endpoint
        old_tokens = [int(t) for t in self.ring.endpoints[me]]
        new_tokens = [int(t) for t in new_tokens]
        self.topology_commit({"op": "start_move", "node": self._ep_dict(),
                              "tokens": new_tokens})
        try:
            streamed = self.bootstrap()
            # ranges this node stops replicating once old tokens release
            # (the future ring IS the post-move ring: moving tokens are
            # excluded from it, so racing writes to surrendered ranges
            # are already duplicated to their gaining owners)
            after = self.ring.future_ring()
            outgoing = []
            for ks in list(self.schema.keyspaces.values()):
                strat = ReplicationStrategy.create(ks.params.replication)
                lost_arcs = []
                for lo, hi in self.ring.all_ranges():
                    if me in strat.replicas(self.ring, hi) and \
                            me not in strat.replicas(after, hi):
                        lost_arcs += [(-(1 << 63), hi),
                                      (lo, (1 << 63) - 1)] \
                            if lo > hi else [(lo, hi)]
                if not lost_arcs:
                    continue
                for tname, table in ks.tables.items():
                    allb = self.engine.store(ks.name, tname).scan_all()
                    for alo, ahi in lost_arcs:
                        part = filter_token_range(allb, alo, ahi)
                        if len(part):
                            outgoing.append((ks.name, table, part))
            # push surrendered data BEFORE the flip, routed by the
            # post-move ring: a crash here leaves start_move in the log
            # and the resume re-runs the whole (idempotent) sequence —
            # pushing after the flip would lose the handoff on a crash
            # between the two
            for ksn, table, part in outgoing:
                self.repair.apply_batch_to_owners(ksn, table, part,
                                                  ring=after)
                streamed += len(part)
        except BaseException:
            self.topology_commit({"op": "abort_move",
                                  "node": self._ep_dict()})
            raise
        self.topology_commit({"op": "finish_move", "node": self._ep_dict(),
                              "old_tokens": old_tokens})
        return streamed

    def replace_node(self, dead_name: str) -> int:
        """Replace a DEAD node: this (new, empty) node assumes its
        tokens, streaming every replica range from the survivors
        (reference replace_address flow / tcm/sequences startup
        Replace). The dead node must be convicted down; writes during
        the replace are duplicated here via the future ring."""
        dead = next((e for e in self.ring.endpoints
                     if e.name == dead_name), None)
        if dead is None:
            raise ValueError(f"{dead_name} not in ring")
        # positive evidence of death required: a fresh node has no
        # gossip state at all, and "never heard of it" must not license
        # removing a live member (split-brain); the operator/harness
        # conveys conviction via force_convict or observed heartbeats
        st = self.gossiper.states.get(dead)
        if st is None or st.alive:
            raise ValueError(f"{dead_name} is alive or of unknown "
                             f"liveness; replace requires the failure "
                             f"detector to have convicted it")
        self.topology_commit({"op": "start_replace",
                              "node": self._ep_dict(),
                              "target": dead_name})
        try:
            streamed = self.bootstrap()
        except BaseException:
            self.topology_commit({"op": "abort_replace",
                                  "node": self._ep_dict()})
            raise
        self.topology_commit({"op": "finish_replace",
                              "node": self._ep_dict()})
        return streamed

    def resume_topology(self) -> int | None:
        """Resume a multi-step topology operation this node crashed in
        the middle of (the epoch log holds the start_* entry; the
        finish never committed). Returns cells streamed, or None if
        nothing was pending. Reference: TCM in-progress sequences are
        resumed from the log at startup (tcm/Startup, MultiStepOperation)."""
        me = self.endpoint
        if me in self.ring.pending:
            if me in self.ring.endpoints:    # interrupted token MOVE
                new_tokens = [int(t) for t in self.ring.pending[me]]
                # abort cluster-wide, then re-run the whole sequence at
                # fresh epochs: streaming is idempotent (timestamp
                # reconcile dedups re-streamed cells), so repeating is safe
                self.topology_commit({"op": "abort_move",
                                      "node": self._ep_dict()})
                return self.move_tokens(new_tokens)
            streamed = self.bootstrap()
            self.topology_commit({"op": "finish_join",
                                  "node": self._ep_dict()})
            return streamed
        if me in self.ring.replacing:
            streamed = self.bootstrap()
            self.topology_commit({"op": "finish_replace",
                                  "node": self._ep_dict()})
            return streamed
        return None

    def bootstrap(self) -> int:
        """Pull this node's replica ranges from existing owners and write
        them as local sstables (reference: tcm/sequences/BootstrapAndJoin
        -> RangeStreamer -> entire-sstable streaming). Preferred flow:
        ring.add_pending(me) -> bootstrap() -> ring.promote_pending(me):
        reads keep hitting the old owners while writes are duplicated to
        this node (coordinator pending targets), so nothing is lost OR
        prematurely served. Returns cells streamed. Also supports the
        legacy already-in-ring flow (sources computed from a pre-join
        clone)."""
        from .replication import ReplicationStrategy

        total = 0
        if self.endpoint in self.ring.pending or \
                self.endpoint in self.ring.replacing:
            future = self.ring.future_ring()
            current = self.ring    # the PRE-change ring: stream sources
        else:
            future = self.ring
            current = self.ring.clone_without(self.endpoint)
        for ks in list(self.schema.keyspaces.values()):
            strat = ReplicationStrategy.create(ks.params.replication)
            for lo, hi in future.all_ranges():
                replicas = strat.replicas(future, hi)
                if self.endpoint not in replicas:
                    continue   # we don't replicate this range
                cur_replicas = strat.replicas(current, hi)
                if self.endpoint in cur_replicas:
                    continue   # already a replica (token move keeps it)
                owners = [e for e in cur_replicas
                          if e != self.endpoint and self.is_alive(e)]
                if not owners:
                    if any(e != self.endpoint for e in cur_replicas):
                        # the range HAS owners but none is live: silently
                        # skipping would let the join/replace "complete"
                        # with zero data and serve empty reads — fail the
                        # sequence instead (the caller aborts and the
                        # operator retries when sources are up)
                        raise RuntimeError(
                            f"no live stream source for range "
                            f"({lo}, {hi}] of {ks.name} "
                            f"(owners: {cur_replicas})")
                    continue   # genuinely unowned (empty pre-ring)
                for tname, table in ks.tables.items():
                    arcs = [(-(1 << 63), hi),
                            (lo, (1 << 63) - 1)] if lo > hi else [(lo, hi)]
                    for alo, ahi in arcs:
                        # sessioned entire-sstable streaming: whole
                        # in-range sstables arrive as chunked component
                        # FILES (zero re-serialization, attached indexes
                        # included) and land atomically (TOC last);
                        # only boundary-straddling data re-serializes.
                        # The session is resumable and throttled — a
                        # big join no longer rides one giant message
                        res = self.streams.stream_range(
                            owners[0], ks.name, tname, alo, ahi,
                            timeout=max(self.proxy.timeout, 30.0))
                        total += int(res["cells"])
        return total

    def decommission(self) -> int:
        """Stream every locally-replicated range to the owners that GAIN
        it once this node leaves, then leave the ring (tcm/sequences/
        Leave + unbootstrap streaming role). The "push" is modelled as a
        remote pull (STREAM_PULL_REQ): each gaining owner runs a
        receiver session against this node, so the transfer is chunked,
        throttled and atomically landed like any other session — and
        the mover's landing is local on the gaining side."""
        from .replication import ReplicationStrategy
        me = self.endpoint
        future = self.ring.clone_without(me)
        total = 0
        for ks in list(self.schema.keyspaces.values()):
            strat = ReplicationStrategy.create(ks.params.replication)
            # iterate the CURRENT ring's ranges: each maps into exactly
            # one future range (the future ring merges ours), so the
            # gained-replica set is constant across a current range —
            # the future ring's coarser ranges would NOT give constant
            # current-replica sets and could skip data
            for lo, hi in self.ring.all_ranges():
                cur = strat.replicas(self.ring, hi)
                if me not in cur:
                    continue
                fut = strat.replicas(future, hi)
                gained = [e for e in fut
                          if e not in cur and self.is_alive(e)]
                if not gained:
                    continue
                arcs = [(-(1 << 63), hi),
                        (lo, (1 << 63) - 1)] if lo > hi else [(lo, hi)]
                for tname in ks.tables:
                    for ep in gained:
                        for alo, ahi in arcs:
                            res = self.streams.request_pull(
                                ep, ks.name, tname, alo, ahi,
                                max(self.proxy.timeout, 35.0))
                            total += int(res.get("cells", 0))
        self.ring.remove_node(me)   # new ownership takes effect
        self.shutdown()
        return total

    def shutdown(self):
        self._stop_hints.set()
        self.counters.close()
        self.streams.close()
        self.gossiper.stop()
        self.messaging.close()
        for cfg_name, cb_ in getattr(self.proxy, "_settings_subs", []):
            self.engine.settings.remove_listener(cfg_name, cb_)
        for cfg_name, cb_ in getattr(self, "_settings_subs", []):
            self.engine.settings.remove_listener(cfg_name, cb_)
        self.engine.close()


class _DistributedStore:
    """Read facade the CQL executor uses; routes through the coordinator."""

    def __init__(self, node: Node, keyspace: str, name: str):
        self.node = node
        self.keyspace = keyspace
        self.name = name

    def read_partition(self, pk: bytes, now=None, limits=None):
        return self.node.proxy.read_partition(self.keyspace, self.name, pk,
                                              self.node.default_cl,
                                              limits=limits)

    def scan_all(self, now=None):
        return self.node.proxy.scan_all(self.keyspace, self.name,
                                        self.node.default_cl)

    def scan_window(self, lo: int, hi: int, now=None, limits=None):
        return self.node.proxy.scan_window(self.keyspace, self.name, lo,
                                           hi, self.node.default_cl,
                                           limits=limits)

    def iter_scan(self, now=None, after: int = -(1 << 63),
                  window_parts: int = 64, limits=None):
        """Bounded cluster scan: one vnode arc per window, each fetched
        from that arc's replicas only (paging substrate; window_parts is
        a partition-count hint the arc granularity stands in for)."""
        MIN, MAX = -(1 << 63), (1 << 63) - 1
        bounds = sorted({hi for _, hi in self.node.ring.all_ranges()})
        cuts = [b for b in bounds if b > after] + [MAX]
        pos = after
        for hi in cuts:
            if hi <= pos and not (pos == MIN and hi == MIN):
                continue
            batch = self.scan_window(pos, hi, now, limits=limits)
            if len(batch):
                yield batch
            pos = hi
            if pos == MAX:
                break

    def truncate(self):
        for ep in list(self.node.ring.endpoints):
            if ep == self.node.endpoint:
                store = self.node.engine.store(self.keyspace, self.name)
                store.truncate()
                self.node.counters.invalidate_table(store.table.id)
            else:
                self.node.messaging.send_one_way(
                    Verb.TRUNCATE_REQ, (self.keyspace, self.name), ep)


class LocalCluster:
    """N in-process nodes sharing a transport with fault injection
    (the jvm-dtest Cluster).

    `device` is the torch device of every node's engine (its compaction
    kernels), resolved once here: `cuda` unless the caller asks for
    `cpu`, so without a card the cluster raises. Every node, including
    those made later by add_node and replace_dead_node, runs its engine
    on that one device: with more nodes than cards they share it."""

    def __init__(self, n: int, base_dir: str, rf: int = 3,
                 gossip_interval: float = 0.05,
                 dcs: list[str] | None = None, device=None):
        self.base_dir = base_dir
        self.device = resolve_device(device)
        self.engine_opts = {"device": self.device}
        self.transport = LocalTransport()
        self.schema = Schema()
        self.ring = Ring()
        self.nodes: list[Node] = []
        self._stopped: set[int] = set()
        endpoints = []
        tokens = even_tokens(n, vnodes=4)
        for i in range(n):
            dc = dcs[i] if dcs else "dc1"
            ep = Endpoint(f"node{i + 1}", dc=dc)
            endpoints.append(ep)
            self.ring.add_node(ep, tokens[i])
        for i, ep in enumerate(endpoints):
            node = Node(ep, os.path.join(base_dir, ep.name), self.schema,
                        self.ring, self.transport, seeds=endpoints[:1],
                        gossip_interval=gossip_interval,
                        engine_opts=self.engine_opts)
            self.nodes.append(node)
        from .gossip import EndpointState
        for node in self.nodes:
            node.cluster_nodes = self.nodes
            # seed full liveness so tests don't wait for convergence
            for other in self.nodes:
                if other.endpoint != node.endpoint:
                    st = node.gossiper.states.setdefault(
                        other.endpoint, EndpointState(generation=1))
                    node.gossiper.detector.report(
                        other.endpoint, st, node.gossiper.clock())
        for node in self.nodes:
            node.gossiper.start()

    @property
    def filters(self):
        return self.transport.filters

    def node(self, i: int) -> Node:
        return self.nodes[i - 1]

    def session(self, i: int = 1) -> Session:
        return self.nodes[i - 1].session()

    def add_node(self, dc: str = "dc1", vnodes: int = 4,
                 mid_join_hook=None) -> Node:
        """Grow the cluster: register the new node's tokens as PENDING,
        bootstrap-stream from the pre-join owners (writes arriving
        meanwhile are duplicated to the joining node), then promote to
        full ownership (the jvm-dtest addInstance + BootstrapAndJoin
        flow). mid_join_hook() runs between the pending registration and
        the ownership flip — tests inject concurrent writes there."""
        from .ring import Endpoint, allocate_tokens
        i = len(self.nodes) + 1
        ep = Endpoint(f"node{i}", dc=dc)
        # balanced growth: bisect the widest current ranges
        # (dht/tokenallocator role)
        tokens = allocate_tokens(self.ring, vnodes)
        node = Node(ep, os.path.join(self.base_dir, ep.name), self.schema,
                    self.ring, self.transport,
                    seeds=[self.nodes[0].endpoint],
                    gossip_interval=self.nodes[0].gossiper.interval,
                    engine_opts=self.engine_opts)
        node.cluster_nodes = self.nodes
        from .gossip import EndpointState
        # seed liveness both ways
        for other in self.nodes:
            node.gossiper.states.setdefault(other.endpoint,
                                            EndpointState(generation=1))
            node.gossiper.detector.report(
                other.endpoint,
                node.gossiper.states[other.endpoint],
                node.gossiper.clock())
            other.gossiper.states.setdefault(ep, EndpointState(generation=1))
            other.gossiper.detector.report(
                ep, other.gossiper.states[ep], other.gossiper.clock())
        self.ring.add_pending(ep, tokens)
        try:
            node.bootstrap()
            if mid_join_hook is not None:
                mid_join_hook()
            self.ring.promote_pending(ep)
        except BaseException:
            self.ring.cancel_pending(ep)
            # tear the half-created node down fully: engine/commitlog
            # handles, transport registration, and peers' liveness seeds
            node._stop_hints.set()
            node.gossiper.stop()
            node.messaging.close()
            node.engine.close()
            for other in self.nodes:
                other.gossiper.states.pop(ep, None)
            raise
        self.nodes.append(node)
        node.gossiper.start()
        return node

    def move_node(self, i: int, new_tokens: list[int]) -> int:
        """nodetool move on node i (see Node.move_tokens)."""
        return self.nodes[i - 1].move_tokens(new_tokens)

    def replace_dead_node(self, dead_i: int, dc: str = "dc1") -> Node:
        """Replace a stopped node with a fresh one that assumes its
        tokens (replace_address flow). The dead node must already be
        stopped (stop_node); its Node object stays in self.nodes so
        tests can inspect it, but it is out of the ring afterwards."""
        from .gossip import EndpointState
        dead = self.nodes[dead_i - 1]
        if dead_i not in self._stopped:
            raise ValueError(f"{dead.endpoint.name} is alive; "
                             f"decommission it instead of replacing")
        i = len(self.nodes) + 1
        ep = Endpoint(f"node{i}", dc=dc)
        seeds = [n.endpoint for n in self.nodes
                 if n.endpoint != dead.endpoint][:1]
        node = Node(ep, os.path.join(self.base_dir, ep.name), self.schema,
                    self.ring, self.transport, seeds=seeds,
                    gossip_interval=self.nodes[0].gossiper.interval,
                    engine_opts=self.engine_opts)
        node.cluster_nodes = self.nodes
        # the dead peer must be CONVICTED everywhere before a replace
        # (the reference requires the FD to see it down): pin its known
        # (generation, version) so silent digests can't resurrect it
        dead_st = self.nodes[0].gossiper.states.get(dead.endpoint)
        dgen = dead_st.generation if dead_st else 1
        dver = dead_st.version if dead_st else 0
        node.gossiper.force_convict(dead.endpoint, dgen, dver)
        for other in self.nodes:
            if other.endpoint == dead.endpoint:
                continue
            other.gossiper.force_convict(dead.endpoint)
            node.gossiper.states.setdefault(other.endpoint,
                                            EndpointState(generation=1))
            node.gossiper.detector.report(
                other.endpoint, node.gossiper.states[other.endpoint],
                node.gossiper.clock())
            other.gossiper.states.setdefault(ep, EndpointState(generation=1))
            other.gossiper.detector.report(
                ep, other.gossiper.states[ep], other.gossiper.clock())
        try:
            node.replace_node(dead.endpoint.name)
        except BaseException:
            node._stop_hints.set()
            node.gossiper.stop()
            node.messaging.close()
            node.engine.close()
            raise
        self.nodes.append(node)
        node.gossiper.start()
        return node

    def stop_node(self, i: int) -> None:
        """Simulate a crash: stop gossip + messaging + hint dispatch
        (a crashed process sends nothing; data stays on disk)."""
        n = self.nodes[i - 1]
        self._stopped.add(i)
        n._stop_hints.set()
        n.streams.close()   # in-flight sessions die; durable state stays
        n.gossiper.stop()
        n.messaging.close()

    def restart_node(self, i: int) -> None:
        import threading
        self._stopped.discard(i)
        n = self.nodes[i - 1]
        n.messaging = MessagingService(n.endpoint, self.transport)
        _settings = getattr(n.engine, "settings", None)
        if _settings is not None:
            n.messaging.set_dispatch_workers(
                int(_settings.get("internode_dispatch_threads")))
        n.gossiper = Gossiper(n.messaging, [self.nodes[0].endpoint],
                              interval=n.gossiper.interval)
        n.gossiper.on_alive = n._on_peer_alive
        # re-seed peer liveness into the fresh detector (same both-ways
        # seeding as startup/add_node): without it the restarted node
        # convicts every peer until gossip rounds catch up and refuses
        # to coordinate QUORUM traffic from its still-open CQL server
        from .gossip import EndpointState
        down = {self.nodes[j - 1].endpoint for j in self._stopped}
        for other in self.nodes:
            if other is n or other.endpoint in down:
                continue
            st = n.gossiper.states.setdefault(other.endpoint,
                                              EndpointState(generation=1))
            n.gossiper.detector.report(other.endpoint, st,
                                       n.gossiper.clock())
        n._register_verbs()
        n.proxy = StorageProxy(n)
        # re-register sidecar verb handlers on the fresh MessagingService
        # (paxos state resets too — crash semantics; promises are volatile)
        from .counters import CounterService
        from .paxos import PaxosService
        from .repair import RepairService
        from .streaming import StreamService
        n.paxos = PaxosService(n)
        n.repair = RepairService(n)
        n.counters.close()
        n.counters = CounterService(n)
        n.streams.close()
        n.streams = StreamService(n)
        n.gossiper.start()
        n._stop_hints = threading.Event()
        n._hint_thread = threading.Thread(target=n._hint_loop, daemon=True)
        n._hint_thread.start()

    def shutdown(self):
        for n in self.nodes:
            try:
                n.shutdown()
            except Exception:
                pass
