"""Slow-query reporting (db/monitoring role).

Reference counterpart: db/monitoring/MonitoringTask.java — operations
exceeding slow_query_log_timeout are collected and periodically
reported. Here the QueryProcessor times every statement; anything over
the threshold lands in a bounded ring surfaced through the
`system_views.slow_queries` virtual table and the
`cql.slow_queries` metric. Threshold is mutable at runtime
(nodetool setslowquerythreshold role), and the ring capacity follows
the mutable `slow_query_log_entries` setting (set_capacity) instead of
being fixed at construction.

Entries carry the processor's per-phase breakdown — parse / execute /
serialize milliseconds — so a slow statement says WHERE it was slow
(a 2s parse is a pathological statement; a 2s execute is the data
path; a large serialize is a result-shape problem)."""
from __future__ import annotations

import threading
from collections import deque

from ..utils import timeutil


class QueryMonitor:
    def __init__(self, threshold_ms: float = 500.0, capacity: int = 100):
        self.threshold_ms = threshold_ms
        self._entries: deque = deque(maxlen=max(int(capacity), 1))
        self._lock = threading.Lock()
        self._ids = 0

    @property
    def capacity(self) -> int:
        return self._entries.maxlen

    def set_capacity(self, capacity: int) -> None:
        """Hot-resize the ring (slow_query_log_entries listener): the
        newest entries survive a shrink, like any bounded tail."""
        capacity = max(int(capacity), 1)
        with self._lock:
            if capacity == self._entries.maxlen:
                return
            self._entries = deque(self._entries, maxlen=capacity)

    def record(self, query: str, seconds: float,
               keyspace: str | None = None,
               trace_session: str | None = None,
               phases: dict | None = None) -> None:
        """phases: per-phase wall seconds from the processor
        ({'parse': s, 'execute': s, 'serialize': s}); stored as
        milliseconds alongside the total."""
        ms = seconds * 1000.0
        if ms < self.threshold_ms:
            return
        from .metrics import GLOBAL
        GLOBAL.incr("cql.slow_queries")
        phases = phases or {}
        with self._lock:
            self._ids += 1
            self._entries.append({
                "id": self._ids,
                "query": query[:500],
                "keyspace": keyspace,
                "duration_ms": round(ms, 3),
                "parse_ms": round(phases.get("parse", 0.0) * 1000.0, 3),
                "execute_ms": round(
                    phases.get("execute", 0.0) * 1000.0, 3),
                "serialize_ms": round(
                    phases.get("serialize", 0.0) * 1000.0, 3),
                "at": timeutil.now_micros() // 1000,
                # set when the slow statement ran traced/sampled — links
                # the entry to its system_traces timeline
                "trace_session": trace_session,
            })

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._entries)
