"""Distributed schema agreement — the Paxos-backed epoch log (TCM).

Reference counterpart: tcm/ClusterMetadata.java:81 + the log-based
transformation model (every metadata change is an ordered log entry;
replicas converge by applying the same entries in the same order),
committed through a Paxos-backed processor on a CMS replica group
(tcm/PaxosBackedProcessor.java:57, tcm/Commit.java). Scaled to this
framework: the replicated unit is the DDL STATEMENT TEXT (or a
#topology transformation), ordered by a per-cluster epoch counter.

Commit model (cluster/cms.py): every epoch slot is decided by
single-decree Paxos over the CMS replica set (the min(3) lowest-named
endpoints). A CMS member coordinates directly; any other node forwards
(SCHEMA_FORWARD) to a live CMS member and applies the acked entry, so
the statement is visible locally when execute() returns. A minority
partition CANNOT commit (MetadataUnavailable) — no fork is possible;
a proposer that loses a slot to a concurrent commit applies the winner
and retries its own statement at the next slot.

  - Learn paths: CMS members apply at Paxos-commit time; all peers get
    SCHEMA_PUSH(epoch, entry); a node seeing a future epoch pulls the
    gap (SCHEMA_PULL, async — the response callback runs on the same
    dispatch thread later; nothing here may block on a response).
  - A (re)starting node replays its persisted log, then pulls anything
    newer from the first live peer.
  - Same-epoch conflicts cannot be produced by CMS commits; the
    deterministic winner rule below survives only as tolerance for
    logs predating the CMS (and screams into stderr if it ever fires).

Enabled for per-process schemas (TCP deployments and per-node-schema
test rigs); LocalCluster shares one Schema object in-process and needs
no sync.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

from .messaging import Verb


DDL_STATEMENTS = {
    "CreateKeyspaceStatement", "CreateTableStatement",
    "CreateIndexStatement", "CreateTypeStatement", "CreateViewStatement",
    "CreateFunctionStatement", "CreateAggregateStatement",
    "CreateTriggerStatement", "DropTriggerStatement",
    "DropStatement", "AlterTableStatement",
    # NOT TruncateStatement: truncation is a DATA operation with its own
    # cluster fan-out (TRUNCATE_REQ); replaying it from the schema log on
    # a late-joining node would wipe rows written after the original
}


class SchemaForwardError(ValueError):
    """The designated coordinator rejected the DDL (e.g. parse or
    execution error there) — surfaced to the issuing session."""


TOPOLOGY_PREFIX = "#topology "


def apply_topology_to_ring(ring, extra: dict) -> None:
    """Apply one topology transformation to a Ring. The single
    definition both the epoch-log path (TCP clusters) and the shared-ring
    path (LocalCluster) go through — reference
    tcm/transformations/* applied to ClusterMetadata's tokenMap."""
    from .ring import Endpoint

    op = extra["op"]
    nd = extra.get("node") or {}
    ep = Endpoint(nd["name"], nd.get("dc", "dc1"), nd.get("rack", "rack1"),
                  nd.get("host", "127.0.0.1"), int(nd.get("port", 0)))

    def existing(name: str):
        for e in ring.endpoints:
            if e.name == name:
                return e
        raise ValueError(f"endpoint {name} not in ring")

    tokens = [int(t) for t in extra.get("tokens") or []]
    if op == "register":
        ring.add_node(ep, tokens)
    elif op == "start_join":
        ring.add_pending(ep, tokens)
    elif op == "finish_join":
        ring.promote_pending(ep)
    elif op == "abort_join":
        ring.cancel_pending(ep)
    elif op == "leave":
        ring.remove_node(existing(nd["name"]))
    elif op == "start_move":
        ring.start_move(existing(nd["name"]), tokens)
    elif op == "finish_move":
        ring.finish_move(existing(nd["name"]),
                         [int(t) for t in extra["old_tokens"]])
    elif op == "abort_move":
        ring.abort_move(existing(nd["name"]))
    elif op == "start_replace":
        ring.start_replace(ep, existing(extra["target"]))
    elif op == "finish_replace":
        ring.finish_replace(ep)
    elif op == "abort_replace":
        ring.cancel_replace(ep)
    else:
        raise ValueError(f"unknown topology op {op!r}")


def emit_topology_event(node, extra: dict) -> None:
    """Driver-facing TOPOLOGY_CHANGE for a committed transformation
    (transport Event.TopologyChange role). Only the COMMIT points of
    multi-step sequences emit — drivers see the ownership flip, not the
    intermediate pending states."""
    op = extra["op"]
    nd = extra.get("node") or {}
    info = {"host": nd.get("host", "127.0.0.1"),
            "port": int(nd.get("port", 0))}
    change = {"register": "NEW_NODE", "finish_join": "NEW_NODE",
              "finish_replace": "NEW_NODE", "leave": "REMOVED_NODE",
              "finish_move": "MOVED_NODE"}.get(op)
    if change is None:
        return
    emit = getattr(node, "emit_event", None)
    if emit is not None:
        emit("TOPOLOGY_CHANGE", {"change": change, **info})


class SchemaSync:
    FORWARD_TIMEOUT = 5.0
    # pulls re-fetch a window of already-seen epochs so a conflict
    # winner whose one-way push was lost still reconciles on the next
    # pull (startup catch-up or any gap pull) via the winner rule
    PULL_OVERLAP = 8

    def __init__(self, node, directory: str):
        self.node = node
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "schema_log.jsonl")
        self.epoch = 0
        self._lock = threading.RLock()
        self._load()
        # epoch -> exception raised applying that entry locally; the
        # coordinator pops its own slot to surface the error to the
        # client (commit-then-apply: application happens after the
        # Paxos decision, so errors can no longer surface from a
        # pre-commit local execution). Bounded — see _apply_entry.
        self._apply_errors: dict[int, Exception] = {}
        from .cms import CMSService
        self.cms = CMSService(node, self, directory)
        ms = node.messaging
        ms.register_handler(Verb.SCHEMA_PUSH, self._handle_push)
        ms.register_handler(Verb.SCHEMA_PULL, self._handle_pull)
        ms.register_handler(Verb.SCHEMA_FORWARD, self._handle_forward)
        # epoch anti-entropy (tcm PeerLogFetcher role): the epoch rides
        # gossip app-state; a node seeing a peer ahead pulls the gap —
        # so a straggler that missed a push AND had its one gap-pull
        # time out still converges within a gossip round
        self._pulling = False
        g = getattr(node, "gossiper", None)
        if g is not None:
            g.on_app_state = self._on_peer_app_state
            self._publish_epoch()

    # ------------------------------------------------------------- log --

    def _load(self) -> None:
        # the file is durability; _entries (epoch -> LAST record at that
        # epoch, i.e. the conflict winner) is the read path — handlers
        # consult it under _lock, so lookups must not re-read the file
        self._entries: dict[int, tuple] = {}
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    break               # torn tail
                e = int(rec["epoch"])
                self._entries[e] = (e, rec["query"], rec.get("keyspace"),
                                    rec.get("extra") or {},
                                    rec.get("coord"))
                self.epoch = max(self.epoch, e)

    def _append(self, epoch: int, query: str, keyspace, extra,
                coord: str | None = None) -> None:
        coord = coord or self.node.endpoint.name
        with open(self.path, "a") as f:
            f.write(json.dumps({"epoch": epoch, "query": query,
                                "keyspace": keyspace, "extra": extra,
                                "coord": coord}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._entries[epoch] = (epoch, query, keyspace, extra or {},
                                coord)

    def _publish_epoch(self) -> None:
        """Advertise the applied epoch in gossip app-state (catch-up
        signal for _on_peer_app_state on peers)."""
        g = getattr(self.node, "gossiper", None)
        if g is None:
            return
        with g._lock:
            g.states[g.ep].app_states["schema_epoch"] = self.epoch

    def _on_peer_app_state(self, ep, apps: dict) -> None:
        """Gossip says `ep` has applied a newer epoch than ours: pull
        the gap on a worker thread (this callback runs on the dispatch
        thread and must not block). One pull in flight at a time."""
        pe = apps.get("schema_epoch")
        if pe is None or int(pe) <= self.epoch or self._pulling:
            return
        self._pulling = True

        def run():
            try:
                self.pull_from_peers(timeout=5.0, prefer=ep)
            finally:
                self._pulling = False

        threading.Thread(target=run, daemon=True,
                         name="schema-antientropy").start()

    def entries_after(self, epoch: int) -> list[tuple]:
        """Entries newer than `epoch`, ONE record per epoch: an epoch
        rewritten by conflict resolution keeps only its LAST (winning)
        record, so pullers apply exactly what push-path nodes applied."""
        with self._lock:
            return [self._entries[e] for e in sorted(self._entries)
                    if e > epoch]

    def _entry_at(self, epoch: int):
        """Last (i.e. winning) record logged at `epoch`, or None."""
        return self._entries.get(epoch)

    def entry_at(self, epoch: int):
        """Thread-safe committed-entry lookup (CMS prepare fast path)."""
        with self._lock:
            return self._entries.get(epoch)

    def learn(self, slot: int, ddict: dict) -> None:
        """Apply a Paxos-DECIDED entry if it is next in sequence.
        COMMIT-THEN-APPLY: this is the ONLY place CMS-committed entries
        execute, for the proposer and replicas alike — nothing runs
        locally before the decision (reference
        tcm/ClusterMetadataService.java commit-then-apply). A stale
        slot is a no-op; a gap is left for push/pull catch-up (the
        decided value will arrive again there)."""
        with self._lock:
            if slot != self.epoch + 1:
                return
            self._apply_entry(slot, ddict["q"], ddict["k"],
                              ddict.get("x") or {},
                              coord=ddict.get("c"))

    # ------------------------------------------------- CMS membership --

    def cms_members(self) -> list:
        """CMS replica set as-of THIS node's applied log prefix."""
        with self._lock:
            return self._cms_members_locked()

    def _cms_members_locked(self) -> list:
        """The min(CMS_SIZE) lowest-named FULLY-JOINED endpoints of the
        log-materialized ring. Pending joiners/replacements are NOT
        eligible until their finish_join/finish_replace entry commits,
        so the set changes only at a committed log entry and the OLD
        set decides the slot that admits the newcomer — the reference's
        explicit logged CMS reconfiguration (tcm/membership/, the old
        set votes the handover). Caller holds _lock (ring mutations
        happen under it, via _apply_entry)."""
        from .cms import CMS_SIZE
        eps = sorted(self.node.ring.endpoints, key=lambda e: e.name)
        if not eps:
            return [self.node.endpoint]
        return eps[:CMS_SIZE]

    def snapshot_for_commit(self) -> tuple:
        """(next slot, CMS member set) captured atomically under the
        log lock: slot N is ALWAYS decided by the member set the log
        prefix N-1 materializes. Two proposers of the same slot hold
        the same prefix, hence the same set — their quorums intersect
        even across a membership change (the non-intersecting-quorum
        hazard of reading the live ring mid-flight)."""
        with self._lock:
            return self.epoch + 1, self._cms_members_locked()

    # ------------------------------------------------------- application --

    def _apply_local(self, query: str, keyspace, extra: dict) -> None:
        """Execute the DDL against the local node WITHOUT re-entering
        the coordination path. Object ids the coordinator assigned ride
        in `extra` so every node agrees (mutations route by table id)."""
        if query.startswith(TOPOLOGY_PREFIX):
            apply_topology_to_ring(self.node.ring, extra)
            emit_topology_event(self.node, extra)
            return
        from ..cql.parser import parse
        from ..cql.execution import Executor
        stmt = parse(query)
        tid = extra.get("table_id")
        if tid is not None:
            name = type(stmt).__name__
            if name == "CreateTableStatement":
                stmt.options = dict(stmt.options or {})
                stmt.options["id"] = tid
            elif name == "CreateViewStatement":
                stmt.view_id = tid
        # NODE-LOCAL application: replayed entries must never re-enter
        # any distributed fan-out path
        Executor(self.node.engine).execute(stmt, keyspace=keyspace)

    def _preassign_extra(self, stmt, keyspace) -> dict:
        """Object ids assigned BEFORE the Paxos commit, so the decided
        entry carries them and every node — including the coordinator,
        which applies only after the decision — creates the object with
        the same id (mutations route by table id). Reference: tcm
        transformations carry the ids they assign."""
        if stmt is None:
            return {}
        name = type(stmt).__name__
        if name not in ("CreateTableStatement", "CreateViewStatement"):
            return {}
        ks = stmt.keyspace or keyspace
        try:
            # IF NOT EXISTS over an existing object keeps its id
            return {"table_id":
                    str(self.node.schema.get_table(ks, stmt.name).id)}
        except Exception:
            pass
        if name == "CreateTableStatement" and "id" in (stmt.options or {}):
            return {"table_id": str(stmt.options["id"])}
        import uuid
        return {"table_id": str(uuid.uuid4())}

    def _validate_ddl(self, stmt, keyspace) -> None:
        """Semantic pre-checks run BEFORE the Paxos commit. Under
        commit-then-apply nothing executes locally until the slot is
        decided, so errors the old flow surfaced from its pre-commit
        local execution must be caught here or they would pollute the
        committed log. Mirrors the _exec_* guard prefixes
        (cql/execution.py) for the common cases; anything subtler
        surfaces from the post-commit application — deterministically,
        on every node — via _apply_errors."""
        if stmt is None:
            return
        from ..cql.execution import InvalidRequest
        schema = self.node.schema
        name = type(stmt).__name__
        if name == "CreateKeyspaceStatement":
            if stmt.name in schema.keyspaces and not stmt.if_not_exists:
                raise InvalidRequest(f"keyspace {stmt.name} exists")
        elif name == "CreateTableStatement":
            ks = stmt.keyspace or keyspace
            if ks is None:
                raise InvalidRequest("no keyspace for CREATE TABLE")
            if ks not in schema.keyspaces:
                raise InvalidRequest(f"unknown keyspace {ks}")
            if stmt.name in schema.keyspaces[ks].tables \
                    and not stmt.if_not_exists:
                raise InvalidRequest(f"table {ks}.{stmt.name} exists")
            if not stmt.partition_key:
                raise InvalidRequest("missing PRIMARY KEY")
        elif name == "CreateViewStatement":
            ks = stmt.keyspace or keyspace
            bks = stmt.base_keyspace or keyspace
            if ks is None or bks is None:
                raise InvalidRequest(
                    "no keyspace for CREATE MATERIALIZED VIEW")
            if (ks, stmt.name) in getattr(schema, "views", {}) \
                    and not stmt.if_not_exists:
                raise InvalidRequest(f"view {ks}.{stmt.name} exists")
            try:
                schema.get_table(bks, stmt.base_table)
            except KeyError as e:
                raise InvalidRequest(str(e))
        elif name == "AlterTableStatement":
            ks = stmt.keyspace or keyspace
            if ks is None:
                raise InvalidRequest("no keyspace specified")
            try:
                schema.get_table(ks, stmt.name)
            except KeyError as e:
                raise InvalidRequest(str(e))
        elif name == "CreateIndexStatement":
            ks = stmt.keyspace or keyspace
            if ks is None:
                raise InvalidRequest("no keyspace specified")
            try:
                schema.get_table(ks, stmt.table)
            except KeyError as e:
                raise InvalidRequest(str(e))
        elif name == "DropStatement" and not stmt.if_exists:
            ks = stmt.keyspace or keyspace
            if stmt.what == "keyspace":
                if stmt.name not in schema.keyspaces:
                    raise InvalidRequest(f"unknown keyspace {stmt.name}")
            elif stmt.what == "table" and ks is not None:
                try:
                    schema.get_table(ks, stmt.name)
                except KeyError as e:
                    raise InvalidRequest(str(e))

    # ----------------------------------------------------- coordination --

    def coordinate(self, query: str, keyspace, stmt,
                   extra_override: dict | None = None):
        """Entry point from the CQL processor. Runs on a client/session
        thread (never the messaging dispatch thread), so it MAY block
        on responses. A CMS member commits through Paxos directly; any
        other node forwards to a live CMS member and applies the acked
        entry. NO local-commit fallback exists: if no CMS quorum is
        reachable the statement FAILS (MetadataUnavailable) — a
        minority partition must not fork the log."""
        from .cms import MetadataUnavailable
        members = self.cms.members()
        if self.node.endpoint in members:
            return self._coordinate_cms(query, keyspace, stmt,
                                        extra_override)
        pre_epoch = self.epoch
        targets = [m for m in members if self.node.is_alive(m)]
        if not targets:
            raise MetadataUnavailable(
                f"no CMS member reachable "
                f"({[m.name for m in members]} all down)")
        ambiguous = False
        for des in targets:
            ack = self._forward(des, query, keyspace, extra_override)
            if ack is None:
                ambiguous = True
                continue     # this member unreachable: try the next
            epoch, extra = ack
            with self._lock:
                behind = epoch > self.epoch + 1
            if behind:
                # missed entries: the CMS member has them all (it just
                # committed `epoch`). Pull OUTSIDE the lock: the
                # response is processed on the dispatch thread, and
                # _on_pull_response needs this same lock — a pull
                # under the lock would deadlock-till-timeout and stall
                # every message on the node.
                self.pull_from_peers(timeout=self.FORWARD_TIMEOUT,
                                     prefer=des)
            with self._lock:
                if epoch == self.epoch + 1:
                    self._apply_entry(epoch, query, keyspace,
                                      extra or {}, coord=des.name)
                if self.epoch < epoch:
                    # committed cluster-wide, but this node could not
                    # catch up (peers unreachable mid-pull) — surface
                    # that rather than return success for a table this
                    # node does not have yet
                    raise SchemaForwardError(
                        f"DDL committed at epoch {epoch} but local "
                        f"catch-up failed (local epoch "
                        f"{self.epoch}); retry")
            from ..cql.execution import ResultSet
            return ResultSet([], [])   # DDL result shape
        if ambiguous:
            # a forward may have committed with only the ack lost.
            # Re-issuing a committed CREATE would fork its table id —
            # pull first; if our exact statement now appears, it
            # committed: done.
            self.pull_from_peers(timeout=self.FORWARD_TIMEOUT)
            if any(rec[1] == query
                   for rec in self.entries_after(pre_epoch)):
                from ..cql.execution import ResultSet
                return ResultSet([], [])
        raise MetadataUnavailable(
            f"no CMS member answered the DDL forward "
            f"({[m.name for m in members]})")

    def _coordinate_cms(self, query: str, keyspace, stmt,
                        extra_override: dict | None):
        """CMS-member commit — COMMIT-THEN-APPLY (reference
        tcm/ClusterMetadataService.java: transformations apply only
        after the log commit). The statement is validated and its
        object ids assigned up front, but NOTHING executes locally
        until the Paxos decision: local application happens as this
        node's own COMMIT self-delivery inside commit_entry
        (cms._handle_commit -> learn). A member dying mid-round
        therefore strands no locally-applied residue. A liveness
        quorum check fails fast so a minority-side statement is
        refused before any Paxos traffic."""
        from .cms import MetadataUnavailable
        _slot, members = self.snapshot_for_commit()
        need = len(members) // 2 + 1
        live = [m for m in members
                if m == self.node.endpoint or self.node.is_alive(m)]
        if len(live) < need:
            raise MetadataUnavailable(
                f"metadata commit needs {need}/{len(members)} CMS "
                f"members ({[m.name for m in members]}), "
                f"{len(live)} reachable")
        self._validate_ddl(stmt, keyspace)
        extra = extra_override if extra_override is not None \
            else self._preassign_extra(stmt, keyspace)
        epoch = self.cms.commit_entry(
            query, keyspace, extra,
            revalidate=(None if stmt is None
                        else lambda: self._validate_ddl(stmt, keyspace)))
        with self._lock:
            err = self._apply_errors.pop(epoch, None)
        if err is not None:
            raise err
        from ..cql.execution import ResultSet
        return ResultSet([], [])   # DDL result shape

    def _forward(self, des, query: str, keyspace, extra_override):
        """Send the DDL to the designated node; block for its ack.
        Returns (epoch, extra) on success, None if unreachable; raises
        SchemaForwardError if the designated node rejected the DDL."""
        done = threading.Event()
        box: dict = {}

        def on_rsp(msg):
            box["payload"] = msg.payload
            done.set()

        def on_fail(_msg_id):
            done.set()

        self.node.messaging.send_with_callback(
            Verb.SCHEMA_FORWARD, (query, keyspace, extra_override or {}),
            des, on_response=on_rsp, on_failure=on_fail,
            timeout=self.FORWARD_TIMEOUT)
        if not done.wait(self.FORWARD_TIMEOUT) or "payload" not in box:
            return None
        payload = box["payload"]
        if payload[0] == "err":
            raise SchemaForwardError(
                f"DDL rejected by designated coordinator "
                f"{des.name}: {payload[1]}")
        return int(payload[1]), payload[2] or {}

    # ---------------------------------------------------------- handlers --

    def _handle_forward(self, msg):
        """CMS-member side of a forwarded DDL. The Paxos commit BLOCKS
        on quorum responses, so the work runs on a worker thread and
        the ack is sent asynchronously (messaging.respond) — the
        dispatch thread must stay free to process the very promise/
        accept responses the commit is waiting for."""
        query, keyspace, fwd_extra = msg.payload

        def run():
            from ..cql.parser import parse
            try:
                if not self.cms.is_member():
                    raise SchemaForwardError(
                        f"{self.node.endpoint.name} is not a CMS "
                        f"member")
                extra = fwd_extra or {}
                # commit-then-apply, same as _coordinate_cms: validate
                # + pre-assign ids, commit via Paxos, let the COMMIT
                # self-delivery apply — no pre-decision local residue
                revalidate = None
                if not query.startswith(TOPOLOGY_PREFIX):
                    stmt = parse(query)
                    self._validate_ddl(stmt, keyspace)
                    if not extra:
                        extra = self._preassign_extra(stmt, keyspace)
                    revalidate = \
                        lambda: self._validate_ddl(stmt, keyspace)
                epoch = self.cms.commit_entry(query, keyspace, extra,
                                              revalidate=revalidate)
                with self._lock:
                    err = self._apply_errors.pop(epoch, None)
                if err is not None:
                    raise err
            except Exception as e:
                self.node.messaging.respond(
                    msg, Verb.SCHEMA_FORWARD, ("err", repr(e), None))
                return
            self.node.messaging.respond(
                msg, Verb.SCHEMA_FORWARD, ("ok", epoch, extra))

        threading.Thread(target=run, daemon=True,
                         name="schema-forward").start()
        return None

    def _handle_push(self, msg):
        epoch, query, keyspace, extra = msg.payload
        displaced = None
        with self._lock:
            if epoch == self.epoch + 1:
                self._apply_entry(epoch, query, keyspace, extra or {},
                                  coord=msg.sender.name)
                return None
            if epoch <= self.epoch:
                displaced = self._adopt_winner_locked(
                    epoch, query, keyspace, extra, msg.sender.name)
        if epoch > self.epoch + 1:
            # gap: pull the missing prefix from the sender. Async on
            # purpose — this handler runs on the single dispatch thread,
            # and the pull response can only be processed by that same
            # thread, so blocking here would deadlock the node.
            self.node.messaging.send_with_callback(
                Verb.SCHEMA_PULL,
                max(0, self.epoch - self.PULL_OVERLAP), msg.sender,
                on_response=self._on_pull_response,
                timeout=self.node.proxy.timeout)
        elif displaced is not None:
            self._recoordinate_async(displaced)
        return None

    def _adopt_winner_locked(self, epoch, query, keyspace, extra,
                             coord: str):
        """Same-epoch conflict resolution. With the CMS (cluster/cms.py)
        every epoch is Paxos-decided, so two nodes holding DIFFERENT
        entries at one epoch is impossible for CMS-committed logs —
        this path survives only as tolerance for logs predating the CMS
        and is LOUD when it fires (it would indicate log corruption or
        a mixed-version cluster). The entry whose coordinator has the
        HIGHER name wins deterministically; returns our displaced entry
        (for re-coordination) or None. Caller holds _lock."""
        mine = self._entry_at(epoch)
        if mine is None or mine[1] == query \
                or (coord or "") <= (mine[4] or ""):
            return None
        print(f"[schema-sync] {self.node.endpoint.name}: SAME-EPOCH "
              f"CONFLICT at {epoch} ({mine[1]!r} vs {query!r}) — "
              f"impossible for CMS-committed logs; adopting "
              f"deterministic winner. Investigate log integrity.",
              file=sys.stderr)
        self._apply_entry(epoch, query, keyspace, extra or {},
                          coord=coord)
        return mine

    def _recoordinate_async(self, displaced) -> None:
        """A displaced statement re-coordinates at a fresh epoch,
        keeping its assigned object ids. Runs on a separate thread:
        coordinate() blocks on responses, and callers here are on the
        dispatch thread."""
        _e, q, k, x, _c = displaced

        def run():
            try:
                self.coordinate(q, k, None, extra_override=x)
            except Exception as e:
                # the statement's local side effects exist but it lost
                # its epoch and could not be re-committed — tell the
                # operator to re-issue it instead of losing it silently
                print(f"[schema-sync] {self.node.endpoint.name}: "
                      f"re-coordination of displaced DDL failed "
                      f"({q!r}): {e!r} — re-issue it manually",
                      file=sys.stderr)

        threading.Thread(target=run, daemon=True,
                         name="schema-recoordinate").start()

    def _handle_pull(self, msg):
        after = int(msg.payload)
        return Verb.SCHEMA_PUSH, ("entries", self.entries_after(after))

    def _on_pull_response(self, msg):
        tag, entries = msg.payload
        displaced_all = []
        with self._lock:
            for epoch, query, keyspace, extra, coord in entries:
                if epoch == self.epoch + 1:
                    self._apply_entry(epoch, query, keyspace,
                                      extra or {}, coord=coord)
                elif epoch <= self.epoch:
                    # overlap window: adopt a conflict winner this node
                    # missed (same deterministic rule as _handle_push) —
                    # and our displaced entry re-commits at a fresh
                    # epoch, exactly as if the push had arrived
                    d = self._adopt_winner_locked(epoch, query, keyspace,
                                                  extra, coord)
                    if d is not None:
                        displaced_all.append(d)
        for d in displaced_all:
            self._recoordinate_async(d)

    def _apply_entry(self, epoch: int, query: str, keyspace,
                     extra: dict, coord: str | None = None) -> None:
        """Apply + log a received entry. The coordinator NAME is
        recorded as received (never this node's own), because the
        same-epoch conflict rule compares against it — every node must
        store the same name or different nodes pick different winners."""
        try:
            self._apply_local(query, keyspace, extra)
        except Exception as e:
            # an entry that fails locally (e.g. already-applied effect)
            # still advances the epoch — convergence over strictness,
            # matching pre-TCM schema-merge behaviour. But NOT silently:
            # e.g. CREATE TRIGGER fails on a node missing the trigger
            # file, and the operator must learn this node diverged. The
            # coordinator additionally pops its own slot's error to
            # surface it to the client (commit-then-apply).
            print(f"[schema-sync] {self.node.endpoint.name}: replicated "
                  f"DDL failed locally at epoch {epoch} ({query!r}): "
                  f"{e!r}", file=sys.stderr)
            # bounded, OLDEST-first: a blanket clear() could wipe an
            # in-flight coordinator's error before its pop, acking a
            # failed DDL as success
            while len(self._apply_errors) > 64:
                del self._apply_errors[min(self._apply_errors)]
            self._apply_errors[epoch] = e
        # entry durable + readable BEFORE the epoch advances: any
        # reader observing epoch >= N is guaranteed entries 1..N are
        # present (the fsync can take milliseconds under load — an
        # epoch-first order lets epoch polls race past a missing entry)
        self._append(epoch, query, keyspace, extra, coord=coord)
        self.epoch = max(self.epoch, epoch)
        self._publish_epoch()

    def commit_topology(self, extra: dict) -> None:
        """Commit a topology transformation as an epoch-log entry —
        membership/placement rides the SAME ordered log as DDL (the
        reference's ClusterMetadata holds schema AND tokenMap/placements,
        all changed through one log). The entry text embeds the op so
        the same-epoch conflict rule dedups identical retries."""
        query = TOPOLOGY_PREFIX + json.dumps(extra, sort_keys=True)
        self.coordinate(query, None, None, extra_override=extra)

    def replay_all(self) -> None:
        """Re-apply every logged entry in epoch order (daemon restart).
        The ring is the log's materialization, so topology entries MUST
        replay; DDL that already exists fails benignly (warned)."""
        for e in sorted(self._entries):
            _epoch, query, keyspace, extra, _coord = self._entries[e]
            try:
                self._apply_local(query, keyspace, extra or {})
            except Exception as ex:
                print(f"[schema-sync] {self.node.endpoint.name}: replay "
                      f"of epoch {e} ({query[:60]!r}) failed: {ex!r}",
                      file=sys.stderr)

    def pull_from_peers(self, timeout: float = 5.0, prefer=None,
                        peers=None) -> bool:
        """Catch-up: ask a peer (preferring `prefer`) for newer
        entries, RETRYING within `timeout` until one answers — a node
        that just healed from a partition must converge on its own,
        not wait for external help. Liveness is re-read every attempt,
        and if gossip still convicts every peer (heartbeats lag a heal
        by up to a gossip round) the convicted peers are contacted
        optimistically — a dead one simply doesn't answer. Blocks on
        responses — callers must be off the dispatch thread (startup
        threads, session threads). `peers` overrides discovery — a
        FRESH node joining has an empty ring and only knows its
        configured seed addresses (tcm/Discovery role). Returns True
        if any peer answered (callers that REQUIRE the cluster's log —
        auto-join discovery — must treat False as fatal, not as 'I am
        the first node')."""
        deadline = time.monotonic() + timeout
        while True:
            if peers is not None:
                cand = [ep for ep in peers if ep != self.node.endpoint]
            else:
                ring_eps = [ep for ep in self.node.ring.endpoints
                            if ep != self.node.endpoint]
                live = [ep for ep in ring_eps
                        if self.node.is_alive(ep)]
                cand = live or ring_eps
            if prefer is not None and prefer in cand:
                cand.remove(prefer)
                cand.insert(0, prefer)
            for ep in cand:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                # bound each attempt so one silent peer can't eat the
                # whole deadline when others might answer
                per_try = remaining if len(cand) == 1 \
                    else min(remaining, max(1.0, timeout / len(cand)))
                done = threading.Event()

                def on_rsp(msg, _done=done):
                    self._on_pull_response(msg)
                    _done.set()

                self.node.messaging.send_with_callback(
                    Verb.SCHEMA_PULL,
                    max(0, self.epoch - self.PULL_OVERLAP), ep,
                    on_response=on_rsp, timeout=per_try)
                if done.wait(per_try):
                    return True
            if deadline - time.monotonic() <= 0.05:
                return False
            time.sleep(0.05)
