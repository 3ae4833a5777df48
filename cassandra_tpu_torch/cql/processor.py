"""QueryProcessor: parse -> prepare cache -> execute; plus the Session
facade users interact with.

Reference counterpart: cql3/QueryProcessor.java:109 (processStatement:276,
parseStatement:382, MD5-keyed prepared cache) and the driver Session
surface.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

from .execution import Executor, InvalidRequest, ResultSet
from .parser import parse

# registry bound when the backend carries no settings (the
# prepared_statements_cache_size knob overrides; <= 0 = unbounded)
DEFAULT_PREPARED_CACHE_SIZE = 1024


class Prepared:
    def __init__(self, statement, query: str):
        self.statement = statement
        self.query = query


class QueryProcessor:
    def __init__(self, backend):
        self.executor = Executor(backend)
        # LRU, bounded by prepared_statements_cache_size: a PREPARE storm
        # (or a client generating unique statements) can no longer grow
        # the registry without limit. Eviction counts
        # `prepared_statements.evicted`; executing an evicted id raises
        # here and maps to the wire UNPREPARED error in the transport so
        # drivers transparently re-prepare (QueryProcessor.java's
        # capacity-bounded preparedStatements cache).
        self._prepared: "OrderedDict[bytes, Prepared]" = OrderedDict()
        self._lock = threading.Lock()

    def parse(self, query: str):
        return parse(query)

    def _prepared_cap(self) -> int:
        settings = getattr(self.executor.backend, "settings", None)
        if settings is None:
            return DEFAULT_PREPARED_CACHE_SIZE
        try:
            return int(settings.get("prepared_statements_cache_size"))
        except Exception:
            return DEFAULT_PREPARED_CACHE_SIZE

    def prepare(self, query: str) -> bytes:
        """Returns the statement id (MD5 of the query, like the reference)."""
        return self.prepare_full(query)[0]

    def prepare_full(self, query: str) -> tuple[bytes, Prepared]:
        """(qid, Prepared) — the object is returned from UNDER the
        registry lock so a concurrent PREPARE storm evicting this very
        entry can't leave the caller describing a statement it can no
        longer see (the transport builds the bind metadata from it)."""
        qid = hashlib.md5(query.encode()).digest()
        evicted = 0
        with self._lock:
            prep = self._prepared.get(qid)
            if prep is None:
                prep = self._prepared[qid] = Prepared(parse(query), query)
            else:
                self._prepared.move_to_end(qid)
            cap = self._prepared_cap()
            while cap > 0 and len(self._prepared) > cap:
                self._prepared.popitem(last=False)
                evicted += 1
        if evicted:
            from ..service.metrics import GLOBAL
            GLOBAL.incr("prepared_statements.evicted", evicted)
        return qid, prep

    def get_prepared(self, qid: bytes) -> Prepared | None:
        """LRU-touching lookup (None = never prepared OR evicted; the
        caller decides between InvalidRequest and wire UNPREPARED)."""
        with self._lock:
            prep = self._prepared.get(qid)
            if prep is not None:
                self._prepared.move_to_end(qid)
            return prep

    def execute_prepared(self, qid: bytes, params=(),
                         keyspace: str | None = None,
                         user: str | None = None,
                         page_size: int | None = None,
                         paging_state: bytes | None = None) -> ResultSet:
        prep = self.get_prepared(qid)
        if prep is None:
            raise InvalidRequest("unknown prepared statement")
        return self.execute_statement(prep, params, keyspace, user=user,
                                      page_size=page_size,
                                      paging_state=paging_state)

    def execute_statement(self, prep: Prepared, params=(),
                          keyspace: str | None = None,
                          user: str | None = None,
                          page_size: int | None = None,
                          paging_state: bytes | None = None) -> ResultSet:
        """Execute an already-resolved Prepared. The transport fetches
        the Prepared ONCE (for the UNPREPARED check and verb
        classification) and executes that same object — no second
        lookup that could race LRU eviction into the wrong error."""
        audit = getattr(self.executor.backend, "audit_log", None)
        if audit is not None:
            audit.log(type(prep.statement).__name__, prep.query, user,
                      keyspace, params=params)
        fql = getattr(self.executor.backend, "fql_log", None)
        if fql is not None:
            fql.log(type(prep.statement).__name__, prep.query, user,
                    keyspace, params=params)
        sync = self._ddl_sync_for(prep.statement)
        if sync is not None:
            # prepared DDL replicates exactly like direct DDL — a
            # bypass here would apply locally only, with no epoch
            self._check_ddl_auth(prep.statement, keyspace, user)
            from ..service.metrics import GLOBAL
            with GLOBAL.timer("cql.request"):
                return sync.coordinate(prep.query, keyspace,
                                       prep.statement)
        return self.executor.execute(prep.statement, params, keyspace,
                                     user=user, page_size=page_size,
                                     paging_state=paging_state)

    def _ddl_sync_for(self, stmt):
        """The schema-sync service, iff `stmt` is DDL that must
        replicate through the epoch log (TCM-lite); else None."""
        sync = getattr(self.executor.backend, "schema_sync", None)
        if sync is None:
            return None
        from ..cluster.schema_sync import DDL_STATEMENTS
        return sync if type(stmt).__name__ in DDL_STATEMENTS else None

    def _check_ddl_auth(self, stmt, keyspace, user) -> None:
        """Permission check for log-replicated DDL. Under
        commit-then-apply the coordinator no longer executes the
        statement through Executor.execute (whose auth gate covers the
        non-replicated path), so the same check runs here BEFORE the
        statement reaches the metadata log."""
        auth = getattr(self.executor.backend, "auth", None)
        if auth is None or not auth.enabled:
            return
        perm = Executor.PERMISSION_OF.get(type(stmt).__name__)
        if perm is not None:
            ks = getattr(stmt, "keyspace", None) or keyspace
            auth.check(user, perm, ks)

    def process(self, query: str, params=(),
                keyspace: str | None = None,
                user: str | None = None, page_size: int | None = None,
                paging_state: bytes | None = None) -> ResultSet:
        import time as time_mod

        from ..service.metrics import GLOBAL
        # per-phase walls for the slow-query log: parse / execute /
        # serialize (result assembly after the executor returns) — a
        # slow entry says WHERE it was slow, not just how slow
        t0 = time_mod.perf_counter()
        phases: dict = {}
        stmt = parse(query)
        phases["parse"] = time_mod.perf_counter() - t0
        kind = type(stmt).__name__.removesuffix("Statement").lower()
        GLOBAL.incr(f"cql.{kind}")
        audit = getattr(self.executor.backend, "audit_log", None)
        if audit is not None:
            audit.log(type(stmt).__name__, query, user, keyspace,
                      params=params)
        fql = getattr(self.executor.backend, "fql_log", None)
        if fql is not None:
            fql.log(type(stmt).__name__, query, user, keyspace,
                    params=params)
        try:
            t_exec = time_mod.perf_counter()
            sync = self._ddl_sync_for(stmt)
            if sync is not None:
                self._check_ddl_auth(stmt, keyspace, user)
                with GLOBAL.timer("cql.request"):
                    try:
                        return sync.coordinate(query, keyspace, stmt)
                    finally:
                        # recorded on the raise path too: a timed-out
                        # statement must attribute its wall to execute
                        phases["execute"] = \
                            time_mod.perf_counter() - t_exec
            with GLOBAL.timer("cql.request"):
                try:
                    rs = self.executor.execute(
                        stmt, params, keyspace, user=user,
                        page_size=page_size,
                        paging_state=paging_state)
                finally:
                    t_ser = time_mod.perf_counter()
                    phases["execute"] = t_ser - t_exec
                # result materialization cost (rows already decoded by
                # the executor; anything lazy the ResultSet does to
                # render row tuples lands here)
                _ = getattr(rs, "rows", None)
                phases["serialize"] = time_mod.perf_counter() - t_ser
                return rs
        finally:
            mon = getattr(self.executor.backend, "monitor", None)
            if mon is not None:
                from ..service import tracing
                # a slow statement that was traced links to its timeline
                # (system_views.slow_queries.trace_session)
                mon.record(query, time_mod.perf_counter() - t0,
                           keyspace,
                           trace_session=tracing.current_id(),
                           phases=phases)


class Session:
    """User-facing session: execute CQL strings against a backend
    (StorageEngine locally; a coordinator in a cluster)."""

    def __init__(self, backend, keyspace: str | None = None,
                 user: str | None = None, password: str | None = None):
        self.processor = QueryProcessor(backend)
        self.keyspace = keyspace
        self.user = None
        auth = getattr(backend, "auth", None)
        if auth is not None and auth.enabled:
            if user is None:
                raise ValueError("this backend requires authentication")
            self.user = auth.authenticate(user, password or "")

    def execute(self, query: str, params=(), trace: bool = False,
                fetch_size: int | None = None,
                paging_state: bytes | None = None) -> ResultSet:
        """fetch_size pages large scans: the ResultSet carries at most
        fetch_size rows plus .paging_state to pass back for the next page
        (driver-style paging).

        Tracing: trace=True opens an explicit session (cqlsh TRACING ON)
        and attaches it to the result. Otherwise the backend's mutable
        `trace_probability` setting (nodetool settraceprobability) is
        consulted: sampled statements trace in the background, landing in
        the backend's TraceStore only — the result set stays untouched.
        Either way the session persists to the store even when the
        statement RAISES (a timed-out read still renders its timeline)."""
        from ..service import tracing
        backend = self.processor.executor.backend
        st = None
        if trace:
            st = tracing.begin(request=query[:200])
            tracing.trace(f"Parsing {query[:60]}")
        else:
            settings = getattr(backend, "settings", None)
            if settings is not None and tracing.should_sample(
                    settings.get("trace_probability")):
                st = tracing.begin(request=query[:200])
                tracing.trace(
                    f"Sampled by trace_probability: {query[:60]}")
        try:
            rs = self.processor.process(query, params, self.keyspace,
                                        user=self.user,
                                        page_size=fetch_size,
                                        paging_state=paging_state)
        finally:
            if st is not None:
                tracing.end()
                store = getattr(backend, "trace_store", None)
                if store is not None:
                    store.save(st)
        if trace:
            rs.trace = st
        if hasattr(rs, "keyspace"):
            self.keyspace = rs.keyspace
        return rs

    def prepare(self, query: str) -> bytes:
        return self.processor.prepare(query)

    def execute_prepared(self, qid: bytes, params=()) -> ResultSet:
        return self.processor.execute_prepared(qid, params, self.keyspace,
                                               user=self.user)
