"""StorageProxy: coordinator-side reads and writes with tunable
consistency, hinted handoff, digest reads, and read repair.

Reference counterpart: service/StorageProxy.java — mutate:875 /
performWrite:1379 / sendToHintedReplicas:1480 (local apply + remote
MUTATION_REQ + hint on failure), read:1819 / fetchRows:2060 with digest
resolution (service/reads/DigestResolver) and blocking read repair
(service/reads/repair/BlockingReadRepair).
"""
from __future__ import annotations

import threading
import time

from ..service import tracing
from ..service.metrics import GLOBAL as METRICS
from ..storage import cellbatch as cb
from ..storage.mutation import Mutation
from .messaging import MessagingService, Verb
from .replication import ConsistencyLevel, ReplicationStrategy
from .ring import Endpoint, Ring

# per-verb coordinator latency group (ClientRequestMetrics role):
# request.read / request.write / request.range decaying histograms
REQUEST = METRICS.group("request")


class UnavailableException(Exception):
    """Not enough live replicas to even attempt the operation."""


class TimeoutException(Exception):
    """Live replicas did not ack within the timeout."""


class _Await:
    """Counts acks toward a blockFor target
    (AbstractWriteResponseHandler / ReadCallback role). With
    fail_fast_total set, the waiter wakes as soon as enough failures
    make block_for unreachable instead of burning the full timeout —
    and add_target() RAISES the reachable total when a redundant
    (speculative) request goes out, so an early failure wake does not
    become a permanently latched false timeout once the spare could
    still complete the round."""

    def __init__(self, block_for: int, fail_fast_total: int | None = None):
        self.block_for = block_for
        self.fail_fast_total = fail_fast_total
        self.responses: list = []
        self.failures = 0
        self._cond = threading.Condition()

    def ack(self, payload=None) -> int:
        """Returns the ack's RANK (1-based arrival order): a response
        with rank <= block_for was load-bearing for the round — the
        speculative-retry 'won' attribution reads exactly this."""
        with self._cond:
            self.responses.append(payload)
            self._cond.notify_all()
            return len(self.responses)

    def fail(self) -> None:
        with self._cond:
            self.failures += 1
            self._cond.notify_all()

    def add_target(self, n: int = 1) -> None:
        """A redundant request was issued: block_for is reachable again
        even with the recorded failures."""
        with self._cond:
            if self.fail_fast_total is not None:
                self.fail_fast_total += n
                self._cond.notify_all()

    def _woken_locked(self) -> bool:
        if len(self.responses) >= self.block_for:
            return True
        return self.fail_fast_total is not None and \
            self.fail_fast_total - self.failures < self.block_for

    def await_(self, timeout: float) -> bool:
        if self.block_for == 0:
            return True
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._woken_locked():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            return len(self.responses) >= self.block_for


class StorageProxy:
    def __init__(self, node):
        self.node = node
        self.messaging: MessagingService = node.messaging
        # per-operation timeouts from the typed config
        # (read/write/range_request_timeout, cassandra.yaml; mutable at
        # runtime — DatabaseDescriptor.setReadRpcTimeout etc.)
        self.read_timeout = 5.0
        self.write_timeout = 2.0
        self.range_timeout = 10.0
        self.counter_write_timeout = 5.0
        self._settings_subs = []
        settings = getattr(node.engine, "settings", None)
        if settings is not None:
            for cfg_name, attr in (("read_request_timeout", "read_timeout"),
                                   ("write_request_timeout",
                                    "write_timeout"),
                                   ("range_request_timeout",
                                    "range_timeout"),
                                   ("counter_write_request_timeout",
                                    "counter_write_timeout")):
                setattr(self, attr, settings.get(cfg_name))
                cb_ = (lambda a: lambda v: setattr(self, a, v))(attr)
                settings.on_change(cfg_name, cb_)
                self._settings_subs.append((cfg_name, cb_))
        # speculative retry: if the read round is still short of blockFor
        # after this delay, a redundant request goes to the next replica
        # (service/reads/AbstractReadExecutor speculate; the reference
        # default is the p99 percentile — a fixed floor stands in)
        self.speculative_delay = 0.05
        # EWMA read latency per endpoint (locator/DynamicEndpointSnitch
        # role): data-replica selection prefers the fastest
        self._latency: dict[Endpoint, float] = {}
        self._lat_lock = threading.Lock()

    @property
    def timeout(self) -> float:
        """Back-compat alias: the general request timeout. Reading gives
        the read timeout; assigning sets all three operation classes
        (tests and control paths that want one blanket budget)."""
        return self.read_timeout

    @timeout.setter
    def timeout(self, v: float) -> None:
        self.read_timeout = v
        self.write_timeout = v
        self.range_timeout = v
        self.counter_write_timeout = v

    def _record_latency(self, ep: Endpoint, seconds: float) -> None:
        with self._lat_lock:
            prev = self._latency.get(ep)
            self._latency[ep] = seconds if prev is None \
                else prev * 0.8 + seconds * 0.2

    def _latency_of(self, ep: Endpoint) -> float:
        with self._lat_lock:
            return self._latency.get(ep, 0.0)

    # --------------------------------------------------------------- plan

    def _plan(self, keyspace: str, pk: bytes):
        """(replicas, strategy, token) — blockFor math needs the
        configured RF from the strategy, not the materialized endpoint
        count."""
        ks = self.node.schema.keyspaces[keyspace]
        strat = ReplicationStrategy.create(ks.params.replication)
        token = self.node.ring.token_of(pk)
        replicas = strat.replicas(self.node.ring, token)
        return (replicas or [self.node.endpoint]), strat, token

    def _split_live(self, replicas):
        live = [r for r in replicas if self.node.is_alive(r)]
        dead = [r for r in replicas if r not in live]
        return live, dead

    @staticmethod
    def _counts_toward(cl: str, replica: Endpoint, local_dc: str) -> bool:
        """LOCAL_* consistency only counts local-DC replicas toward
        blockFor — a remote-DC ack must not satisfy a local quorum
        (db/ConsistencyLevel.java isDatacenterLocal + countLocalEndpoints)."""
        if cl in (ConsistencyLevel.LOCAL_QUORUM, ConsistencyLevel.LOCAL_ONE):
            return replica.dc == local_dc
        return True

    # -------------------------------------------------------------- write

    def _pending_targets(self, strat, token, natural) -> list[Endpoint]:
        """Joining nodes acquiring this token's range: writes are
        DUPLICATED to them (no blockFor credit) so nothing written
        mid-bootstrap is missing when ownership flips
        (locator/ReplicaPlans.forWrite pending replicas)."""
        ring = self.node.ring
        if not ring.pending and not ring.replacing:
            return []
        future = ring.future_ring()
        return [r for r in strat.replicas(future, token)
                if r not in natural]

    def mutate(self, keyspace: str, mutation: Mutation,
               cl: str = ConsistencyLevel.ONE) -> None:
        with REQUEST.timer("write"):
            self._mutate(keyspace, mutation, cl)

    def _mutate(self, keyspace: str, mutation: Mutation,
                cl: str = ConsistencyLevel.ONE) -> None:
        replicas, strat, token = self._plan(keyspace, mutation.pk)
        block_for = ConsistencyLevel.block_for(cl, strat,
                                               self.node.endpoint.dc)
        live, dead = self._split_live(replicas)
        local_dc = self.node.endpoint.dc
        countable = [r for r in live
                     if self._counts_toward(cl, r, local_dc)]
        if cl == ConsistencyLevel.ANY:
            pass  # a hint alone satisfies ANY
        elif len(countable) < block_for:
            raise UnavailableException(
                f"{cl} requires {block_for} replicas, "
                f"{len(countable)} countable alive")
        elif cl == ConsistencyLevel.EACH_QUORUM:
            bad = ConsistencyLevel.each_quorum_unavailable_dcs(strat, live)
            if bad:
                raise UnavailableException(
                    f"EACH_QUORUM: quorum unreachable in {bad}")
        handler = _Await(block_for)
        for target in dead:
            if self.node.should_hint(target):
                self.node.hints.store(target, mutation)
                if cl == ConsistencyLevel.ANY:
                    handler.ack()
        for target in live:
            counts = self._counts_toward(cl, target, local_dc)
            if target == self.node.endpoint:
                try:
                    self.node.engine.apply(mutation)
                    if counts:
                        handler.ack()
                except Exception:
                    handler.fail()
            else:
                self.messaging.send_with_callback(
                    Verb.MUTATION_REQ, mutation.serialize(), target,
                    on_response=(lambda m: handler.ack()) if counts
                    else (lambda m: None),
                    on_failure=lambda mid, t=target: self._write_timeout(
                        handler, t, mutation),
                    timeout=self.write_timeout)
        # pending (joining) replicas get every write too; a failed send
        # leaves a hint so the join still converges
        for target in self._pending_targets(strat, token, replicas):
            if target == self.node.endpoint:
                try:
                    self.node.engine.apply(mutation)
                except Exception:
                    # same contract as a failed remote send: hint so the
                    # join converges (the hint loop replays self-hints)
                    self.node.hints.store(target, mutation)
            else:
                self.messaging.send_with_callback(
                    Verb.MUTATION_REQ, mutation.serialize(), target,
                    on_response=lambda m: None,
                    on_failure=lambda mid, t=target:
                        self.node.hints.store(t, mutation),
                    timeout=self.write_timeout)
        if not handler.await_(self.write_timeout):
            raise TimeoutException(
                f"{len(handler.responses)}/{block_for} acks for {cl}")

    def _write_timeout(self, handler, target, mutation):
        handler.fail()
        self.node.hints.store(target, mutation)

    # --------------------------------------------------------------- read

    _digest = staticmethod(cb.content_digest)

    # short-read protection: doubling rounds before falling back to an
    # unlimited fetch (correctness over boundedness)
    SHORT_READ_MAX_ROUNDS = 8

    def read_partition(self, keyspace: str, table_name: str, pk: bytes,
                       cl: str = ConsistencyLevel.ONE,
                       limits: cb.DataLimits | None = None) -> cb.CellBatch:
        """Single-partition read: full data from ONE replica, digest-only
        responses from the rest of the blockFor set — the digest round
        ships 16 bytes per replica, not the partition. A mismatch triggers
        a full-data round to every target plus blocking read repair
        (AbstractReadExecutor + DigestResolver + DataResolver).

        `limits` pushes the row limit to every replica (DataLimits.java
        role) so responses are bounded by the LIMIT, not the partition.
        Because each replica truncates on its OWN view, the merged result
        can come up short when one replica's tombstones shadow another's
        contributions: short-read protection re-queries with doubled
        limits until the merged live-row count reaches the target or no
        replica was truncated
        (service/reads/ShortReadPartitionsProtection.java:40)."""
        with REQUEST.timer("read"):
            return self._read_partition(keyspace, table_name, pk, cl,
                                        limits)

    def _read_partition(self, keyspace, table_name, pk, cl,
                        limits=None) -> cb.CellBatch:
        if cl == ConsistencyLevel.EACH_QUORUM:
            raise ValueError(
                "EACH_QUORUM ConsistencyLevel is only supported for writes")
        replicas, strat, _token = self._plan(keyspace, pk)
        block_for = ConsistencyLevel.block_for(cl, strat,
                                               self.node.endpoint.dc)
        live, _ = self._split_live(replicas)
        local_dc = self.node.endpoint.dc
        countable = [r for r in live
                     if self._counts_toward(cl, r, local_dc)]
        if len(countable) < block_for:
            raise UnavailableException(
                f"{cl} requires {block_for} replicas, "
                f"{len(countable)} countable alive")
        # replica ordering: self first, then fastest by EWMA latency
        # (dynamic snitch role); only countable replicas serve the
        # blockFor set (LOCAL_* never reads across DCs for the quorum)
        countable.sort(key=lambda r: (r != self.node.endpoint,
                                      self._latency_of(r)))
        targets = countable[:block_for]
        spares = countable[block_for:]
        target_rows = limits.target() if limits is not None else None
        effective = limits
        rounds = self.SHORT_READ_MAX_ROUNDS if target_rows is not None \
            else 0
        for rnd in range(rounds + 1):
            if rnd == rounds:
                effective = None        # final round: no truncation
            merged, results = self._read_round(
                keyspace, table_name, pk, targets, spares, block_for,
                effective)
            if effective is None or target_rows is None:
                return merged
            truncated = [b for _, b, more in results if more]
            if not truncated:
                # every source shipped its complete view: merged IS the
                # partition's truth
                return merged
            # a truncated source vouches only for rows up to its LAST
            # shipped row; merged rows beyond the earliest such frontier
            # may be shadowed by tombstones that source never shipped —
            # count (and serve) only the covered prefix
            frontiers = [cb.row_frontier(b) for b in truncated]
            if all(f is not None for f in frontiers):
                fmin = min(frontiers)
                covered = merged.slice_range(
                    0, cb.covered_prefix(merged, fmin))
                if cb.live_row_count(covered) >= target_rows:
                    return covered
            # covered shortfall: the truncated tails may hold the rows
            # (or the tombstones) the merge needs — re-query doubled
            from ..service.metrics import GLOBAL
            GLOBAL.incr("reads.short_read_retries")
            effective = effective.doubled()
        return merged

    def _read_round(self, keyspace, table_name, pk, targets, spares,
                    block_for, limits):
        """One digest-checked read round at the given limits. Returns
        (merged, results) with results = [(ep, batch, more)]."""
        results, digests = self._fetch(keyspace, table_name, pk,
                                       targets[:1], targets[1:],
                                       spares=spares, limits=limits)
        if len(results) + len(digests) < block_for:
            raise TimeoutException(
                f"{len(results) + len(digests)}/{block_for} read responses")
        want = {self._digest(b) for _, b, _ in results} | \
            {d for _, d in digests}
        if len(want) > 1:
            # digest mismatch: full-data second round from every target
            tracing.trace("Digest mismatch: full data round + read repair")
            results, _ = self._fetch(keyspace, table_name, pk, targets,
                                     [], limits=limits)
            if len(results) < block_for:
                raise TimeoutException(
                    f"{len(results)}/{block_for} data responses")
            self._read_repair(keyspace, table_name,
                              [(ep, b) for ep, b, _ in results])
        merged = cb.merge_sorted([b for _, b, _ in results])
        return merged, results

    def _fetch(self, keyspace, table_name, pk, data_targets,
               digest_targets, spares=(), limits=None):
        """One round: full READ_REQ to data_targets, digest-only READ_REQ
        to digest_targets. If the round is still short of blockFor after
        the speculative delay, ONE spare replica gets a redundant
        full-data request (speculative retry —
        service/reads/AbstractReadExecutor). Returns
        ([(ep, batch, more)], [(ep, digest)]) — `more` is the replica's
        truncated-by-limits flag (short-read protection input)."""
        ck_comp = self.node.schema.get_table(
            keyspace, table_name).clustering_comp
        # fail-fast: a replica answering with an ERROR (corrupt sstable,
        # stopped storage) wakes the wait immediately so the speculative
        # retry below fails over to a spare instead of burning the full
        # speculative delay / read timeout
        handler = _Await(len(data_targets) + len(digest_targets),
                         fail_fast_total=len(data_targets)
                         + len(digest_targets))
        results: list = []
        digests: list = []
        lock = threading.Lock()
        t0 = time.monotonic()
        wire_limits = limits.to_wire() if limits is not None else None

        def _tally(rank: int, speculative: bool) -> None:
            # the redundant request WON if its response arrived while
            # the round was still short of blockFor — rank beyond
            # block_for means the original straggler beat it after all
            if speculative and rank <= handler.block_for:
                METRICS.incr("reads.speculative_retries_won")

        def send_to(target, digest_only, speculative=False):
            sent = time.monotonic()
            if target == self.node.endpoint:
                try:
                    batch = self.node.engine.store(
                        keyspace, table_name).read_partition(pk)
                except Exception:
                    # a LOCAL replica read error (corrupt sstable under
                    # ignore/stop, stopped storage) is a failed
                    # RESPONSE, not a coordinator crash: count it so
                    # the fail-fast wait fails over to another replica
                    # — the same contract a remote FAILURE_RSP gets
                    METRICS.incr("reads.local_read_failures")
                    self._record_latency(target, self.read_timeout)
                    handler.fail()
                    return
                batch, more = cb.truncate_live_rows(batch, limits)
                with lock:
                    if digest_only:
                        digests.append((target, cb.content_digest(batch)))
                    else:
                        results.append((target, batch, more))
                self._record_latency(target, time.monotonic() - sent)
                _tally(handler.ack(), speculative)
            else:
                def on_rsp(m, t=target, dg=digest_only, ts=sent,
                           spec=speculative):
                    with lock:
                        if dg:
                            digests.append((t, m.payload))
                        else:
                            payload, more = m.payload
                            b = cb_deserialize(payload)
                            b.ck_comp = ck_comp
                            results.append((t, b, bool(more)))
                    self._record_latency(t, time.monotonic() - ts)
                    _tally(handler.ack(), spec)

                def on_fail(mid, t=target):
                    # timeouts/failures must poison the snitch ranking —
                    # otherwise a blackholed replica keeps looking fast
                    self._record_latency(t, self.read_timeout)
                    handler.fail()
                self.messaging.send_with_callback(
                    Verb.READ_REQ,
                    (keyspace, table_name, pk, digest_only, wire_limits),
                    target,
                    on_response=on_rsp, on_failure=on_fail,
                    timeout=self.read_timeout)

        for target in data_targets + digest_targets:
            send_to(target, target in digest_targets)
        done = handler.await_(min(self.speculative_delay, self.read_timeout))
        if not done and spares:
            from ..service.metrics import GLOBAL
            GLOBAL.incr("reads.speculative_retries")
            tracing.trace(f"Speculative retry to {spares[0].name}")
            # a redundant data read: its full payload can substitute for
            # a straggling digest (ack tallies are read-resolver inputs).
            # Raise the reachable-total FIRST so an error-triggered
            # fail-fast wake does not latch the final wait shut while
            # the spare's response is in flight
            handler.add_target()
            send_to(spares[0], False, speculative=True)
        # the read budget is self.read_timeout TOTAL, not per wait
        handler.await_(max(self.read_timeout - (time.monotonic() - t0), 0.0))
        with lock:
            return list(results), list(digests)

    def _read_repair(self, keyspace, table_name, results) -> None:
        """Blocking read repair: compute the merged truth and push it as a
        mutation to replicas whose copy differed
        (service/reads/repair/BlockingReadRepair)."""
        merged = cb.merge_sorted([b for _, b in results])
        want = self._digest(merged)
        t = self.node.schema.get_table(keyspace, table_name)
        for ep, batch in results:
            if self._digest(batch) == want:
                continue
            tracing.trace(f"Read repair: pushing merged row to {ep.name}")
            m = batch_to_mutation(t, merged)
            if m is None:
                continue
            if ep == self.node.endpoint:
                self.node.engine.apply(m)
            else:
                self.messaging.send_one_way(
                    Verb.MUTATION_REQ, m.serialize(), ep)

    # ----------------------------------------------------- filtered read

    def index_candidates(self, keyspace: str, table_name: str, col: str,
                         op: str, value, cl: str) -> list:
        """Distributed index-candidate discovery with replica filtering
        protection semantics (service/reads/ReplicaFilteringProtection.
        java:66): every vnode range is covered by blockFor live replicas,
        each contributing its LOCAL index matches; the union goes back to
        the caller, which re-reads each candidate at the read CL and
        re-checks the predicate post-merge. Union-over-quorum gives
        completeness (a match a stale replica missed is found); the CL
        re-read + re-check gives soundness (a stale local match is
        dropped). Short-read protection is structural in this design:
        replicas never truncate (LIMIT applies post-merge at the
        coordinator), so there is no per-replica cut to read past."""
        ks = self.node.schema.keyspaces[keyspace]
        strat = ReplicationStrategy.create(ks.params.replication)
        block_for = max(ConsistencyLevel.block_for(
            cl, strat, self.node.endpoint.dc), 1)
        targets: set[Endpoint] = set()
        for _lo, hi in self.node.ring.all_ranges() or [(0, 0)]:
            replicas = strat.replicas(self.node.ring, hi) \
                or [self.node.endpoint]
            live = [r for r in replicas if self.node.is_alive(r)]
            # the same availability contract as the plain read path: a
            # QUORUM filtered read must not quietly succeed with fewer
            # live replicas than block_for
            if len(live) < block_for:
                raise UnavailableException(
                    f"filtered read at {cl}: range (..., {hi}] has "
                    f"{len(live)} live replicas < {block_for}")
            live.sort(key=lambda r: (r != self.node.endpoint,
                                     self._latency_of(r)))
            targets.update(live[:block_for])
        # every target must answer (its candidates are load-bearing for
        # completeness); fail fast when one failure makes that impossible
        handler = _Await(len(targets), fail_fast_total=len(targets))
        out: list = []
        lock = threading.Lock()
        for target in sorted(targets, key=lambda e: e.name):
            if target == self.node.endpoint:
                registry = getattr(self.node.engine, "indexes", None)
                idx = registry.get(keyspace, table_name, col) \
                    if registry is not None else None
                loc = []
                if idx is not None:
                    if op == "=" and hasattr(idx, "lookup"):
                        loc = list(idx.lookup(value))
                    elif op == "LIKE" and hasattr(idx, "search"):
                        loc = list(idx.search(str(value)) or [])
                    elif op == "ANN" and hasattr(idx, "ann"):
                        import numpy as np
                        q, k = value
                        loc = [(pk, ck, float(s)) for pk, ck, s in
                               idx.ann(np.asarray(q, dtype=np.float32),
                                       int(k))]
                with lock:
                    out.extend(loc)
                handler.ack()
            else:
                def on_rsp(m):
                    with lock:
                        out.extend(m.payload)
                    handler.ack()
                self.messaging.send_with_callback(
                    Verb.INDEX_REQ,
                    (keyspace, table_name, col, op, value), target,
                    on_response=on_rsp,
                    on_failure=lambda mid: handler.fail(),
                    timeout=self.read_timeout)
        if not handler.await_(self.read_timeout):
            raise TimeoutException(
                f"index candidates: {len(handler.responses)}/"
                f"{len(targets)} responses")
        with lock:
            # dedupe locators by (pk, ck); the caller re-reads and
            # re-checks every candidate anyway, so which replica's copy
            # of the locator survives is irrelevant
            seen: dict = {}
            for item in out:
                seen.setdefault((bytes(item[0]), bytes(item[1])), item)
            return list(seen.values())

    # --------------------------------------------------------- range read

    def scan_window(self, keyspace: str, table_name: str, lo: int, hi: int,
                    cl: str = ConsistencyLevel.ONE,
                    limits: cb.DataLimits | None = None) -> cb.CellBatch:
        """Bounded range read: partitions with token in (lo, hi], fetched
        from the replicas that OWN each intersecting vnode arc — not a
        full-ring scatter (RangeCommands per-range replica plans). Data
        responses from blockFor replicas per arc are merged.

        `limits` pushes a live-row bound to each arc's replicas
        (DataLimits.java over RangeCommands): responses are bounded by
        the LIMIT, not the arc. Short-read protection runs PER ARC with
        the same frontier rule as read_partition — a truncated source
        vouches only for rows up to its last shipped row, so the arc's
        merged result is cut at the earliest frontier and re-queried
        doubled on shortfall."""
        with REQUEST.timer("range"):
            return self._scan_window(keyspace, table_name, lo, hi, cl,
                                     limits)

    def _scan_window(self, keyspace, table_name, lo, hi, cl,
                     limits=None) -> cb.CellBatch:
        if cl == ConsistencyLevel.EACH_QUORUM:
            raise ValueError(
                "EACH_QUORUM ConsistencyLevel is only supported for writes")
        ks = self.node.schema.keyspaces[keyspace]
        strat = ReplicationStrategy.create(ks.params.replication)
        block_for = ConsistencyLevel.block_for(cl, strat,
                                               self.node.endpoint.dc)
        ck_comp = self.node.schema.get_table(
            keyspace, table_name).clustering_comp
        MIN, MAX = -(1 << 63), (1 << 63) - 1

        # vnode arcs intersecting (lo, hi], wrap arc split in two
        spans = []
        for rlo, rhi in self.node.ring.all_ranges() or [(MIN, MAX)]:
            if rlo == rhi:
                # single-token ring: the one arc IS the full ring
                arcs = [(MIN, MAX)]
            elif rlo < rhi:
                arcs = [(rlo, rhi)]
            else:
                # wrap arc: (rlo, MAX] plus [MIN, rhi] (MIN-exclusive lo
                # means inclusive-from-start throughout the scan stack)
                arcs = [(MIN, rhi), (rlo, MAX)]
            for alo, ahi in arcs:
                s_lo, s_hi = max(lo, alo), min(hi, ahi)
                if s_lo < s_hi:
                    spans.append((s_lo, s_hi, rhi))
        results: list[cb.CellBatch] = []
        if limits is not None and limits.per_partition is not None:
            # the arc stop-rule below counts live rows ACROSS partitions;
            # a per-partition bound needs per-partition accounting the
            # range layer doesn't do — callers keep it coordinator-side
            raise ValueError(
                "per_partition limits are not pushable to range reads")
        target_rows = limits.row_limit if limits is not None else None
        for s_lo, s_hi, owner_tok in spans:
            replicas = strat.replicas(self.node.ring, owner_tok) \
                or [self.node.endpoint]
            live = [r for r in replicas if self.node.is_alive(r)]
            if len(live) < max(block_for, 1):
                raise UnavailableException(
                    f"range ({s_lo}, {s_hi}]: {len(live)} live replicas "
                    f"< {block_for}")
            live.sort(key=lambda r: r != self.node.endpoint)
            targets = live[:max(block_for, 1)]
            effective = limits
            rounds = self.SHORT_READ_MAX_ROUNDS if target_rows is not None \
                else 0
            for rnd in range(rounds + 1):
                if rnd == rounds:
                    effective = None    # final round: no truncation
                arc_res = self._arc_round(keyspace, table_name, s_lo,
                                          s_hi, targets, ck_comp,
                                          effective)
                merged = cb.merge_sorted(
                    [b for _, b, _ in arc_res if len(b)]) \
                    if any(len(b) for _, b, _ in arc_res) \
                    else cb.CellBatch.empty()
                if effective is None and len(targets) > 1:
                    # blocking range read repair (the DataResolver role
                    # single-partition reads already have): unlimited
                    # arcs repair divergent replicas partition by
                    # partition — limited views are partial, so they
                    # never drive repairs
                    self._range_read_repair(
                        keyspace, table_name, merged,
                        [(ep, b) for ep, b, _ in arc_res])
                if effective is None or target_rows is None:
                    break
                truncated = [b for _, b, more in arc_res if more]
                if not truncated:
                    break
                frontiers = [cb.row_frontier(b) for b in truncated]
                if all(f is not None for f in frontiers):
                    fmin = min(frontiers)
                    covered = merged.slice_range(
                        0, cb.covered_prefix(merged, fmin))
                    if cb.live_row_count(covered) >= target_rows:
                        merged = covered
                        break
                from ..service.metrics import GLOBAL
                GLOBAL.incr("reads.short_read_retries")
                effective = effective.doubled()
            if len(merged):
                results.append(merged)
        return cb.merge_sorted(results) if results \
            else cb.CellBatch.empty()


    def _range_read_repair(self, keyspace, table_name, merged,
                           replica_batches) -> None:
        """Push the merged truth for every partition a replica's copy
        diverges on (service/reads/repair for RangeCommands). Whole-arc
        digests gate the per-partition work; repairs are one-way
        mutations like the single-partition path."""
        want = self._digest(merged)
        divergent = [(ep, b) for ep, b in replica_batches
                     if self._digest(b) != want]
        if not divergent:
            return
        from .repair import iter_partitions
        t = self.node.schema.get_table(keyspace, table_name)
        # per-partition digests of each DIVERGENT replica's view (a
        # replica whose whole-arc digest matches cannot differ on any
        # partition), keyed by the 16-byte partition lane prefix
        def part_map(batch):
            out = {}
            for s, e, _tok in iter_partitions(batch):
                part = batch.slice_range(s, e)
                key = batch.lanes[s, :4].astype(">u4").tobytes()
                out[key] = part
            return out
        replica_parts = [(ep, part_map(b)) for ep, b in divergent]
        from ..service.metrics import GLOBAL
        for s, e, _tok in iter_partitions(merged):
            truth = merged.slice_range(s, e)
            key = merged.lanes[s, :4].astype(">u4").tobytes()
            tdig = self._digest(truth)
            m = None
            for ep, parts in replica_parts:
                have = parts.get(key)
                if have is not None and self._digest(have) == tdig:
                    continue
                if m is None:
                    m = batch_to_mutation(t, truth)
                    if m is None:
                        break
                GLOBAL.incr("reads.range_repairs")
                if ep == self.node.endpoint:
                    self.node.engine.apply(m)
                else:
                    self.messaging.send_one_way(
                        Verb.MUTATION_REQ, m.serialize(), ep)

    def _arc_round(self, keyspace, table_name, s_lo, s_hi, targets,
                   ck_comp, limits):
        """One fetch of an arc from its targets at the given limits.
        Returns [(batch, more)]."""
        wire_limits = limits.to_wire() if limits is not None else None
        handler = _Await(len(targets))
        got: list = []
        lock = threading.Lock()
        for target in targets:
            if target == self.node.endpoint:
                b = self.node.engine.store(
                    keyspace, table_name).scan_window(s_lo, s_hi)
                b, more = cb.truncate_live_rows(b, limits)
                with lock:
                    got.append((target, b, more))
                handler.ack()
            else:
                def on_rsp(m, t=target):
                    # responses carry their ENDPOINT: callbacks append
                    # in arrival order, and read repair must attribute
                    # each batch to the replica that sent it
                    with lock:
                        payload = m.payload
                        if isinstance(payload, tuple):
                            pdict, more = payload
                        else:       # unlimited responses ship bare
                            pdict, more = payload, False
                        b = cb_deserialize(pdict)
                        b.ck_comp = ck_comp
                        got.append((t, b, bool(more)))
                    handler.ack()
                self.messaging.send_with_callback(
                    Verb.RANGE_REQ,
                    (keyspace, table_name, s_lo, s_hi, wire_limits),
                    target,
                    on_response=on_rsp,
                    on_failure=lambda mid: handler.fail(),
                    timeout=self.range_timeout)
        if not handler.await_(self.range_timeout):
            raise TimeoutException(
                f"range ({s_lo}, {s_hi}]: "
                f"{len(handler.responses)}/{len(targets)} responses")
        with lock:
            return list(got)

    def scan_all(self, keyspace: str, table_name: str,
                 cl: str = ConsistencyLevel.ONE) -> cb.CellBatch:
        """Full-range read across the cluster: every live node contributes
        its local view; coordinator merges (RangeCommands.partitions,
        simplified to a full-ring scan). Every targeted peer must respond —
        a silent partial result would drop rows owned only by the missing
        peer; dead peers are only tolerable when surviving replicas can
        still cover the ring (approximated here by requiring all-live for
        CL above ONE)."""
        ck_comp = self.node.schema.get_table(
            keyspace, table_name).clustering_comp
        all_eps = list(self.node.ring.endpoints)
        peers = [e for e in all_eps if self.node.is_alive(e)]
        if len(peers) < len(all_eps) and cl not in (ConsistencyLevel.ONE,
                                                    ConsistencyLevel.ANY,
                                                    ConsistencyLevel.LOCAL_ONE):
            raise UnavailableException(
                f"range read at {cl} with {len(all_eps) - len(peers)} "
                "endpoints down")
        handler = _Await(len(peers))
        results = []
        lock = threading.Lock()
        for target in peers:
            if target == self.node.endpoint:
                batch = self.node.engine.store(
                    keyspace, table_name).scan_all()
                with lock:
                    results.append(batch)
                handler.ack()
            else:
                def on_rsp(m):
                    with lock:
                        b = cb_deserialize(m.payload)
                        b.ck_comp = ck_comp
                        results.append(b)
                    handler.ack()
                self.messaging.send_with_callback(
                    Verb.RANGE_REQ, (keyspace, table_name), target,
                    on_response=on_rsp,
                    on_failure=lambda mid: handler.fail(),
                    timeout=self.range_timeout)
        if not handler.await_(self.range_timeout):
            raise TimeoutException(
                f"range read: {len(handler.responses)}/{len(peers)} "
                "responses")
        with lock:
            return cb.merge_sorted(results) if results else cb.CellBatch.empty()


# -------------------------------------------------------------- serde -----



def cb_serialize(batch: cb.CellBatch) -> dict:
    """CellBatch as a plain dict (LocalTransport passes objects; a socket
    transport would pack these arrays directly — they're already columnar)."""
    return {
        "lanes": batch.lanes, "ts": batch.ts, "ldt": batch.ldt,
        "ttl": batch.ttl, "flags": batch.flags, "off": batch.off,
        "val_start": batch.val_start, "payload": batch.payload,
        "pk_map": dict(batch.pk_map), "sorted": batch.sorted,
    }


def cb_deserialize(d: dict) -> cb.CellBatch:
    return cb.CellBatch(d["lanes"], d["ts"], d["ldt"], d["ttl"], d["flags"],
                        d["off"], d["val_start"], d["payload"], d["pk_map"],
                        d["sorted"])


def batch_to_mutation(table, batch: cb.CellBatch) -> Mutation | None:
    """Rebuild a mutation from a reconciled batch (read-repair payload).
    Assumes a single partition."""
    if len(batch) == 0:
        return None
    m = Mutation(table.id, batch.partition_key(0))
    for i in range(len(batch)):
        ck, path, value = batch.cell_payload(i)
        C = batch.n_lanes - 9
        m.add(ck, int(batch.lanes[i, 6 + C]), path, value,
              int(batch.ts[i]), int(batch.ldt[i]), int(batch.ttl[i]),
              int(batch.flags[i]))
    return m
