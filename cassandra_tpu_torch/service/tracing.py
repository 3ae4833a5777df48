"""Request tracing: per-query event timelines, end to end.

Reference counterpart: tracing/Tracing.java:52 — newSession() mints a
session id that travels as a message header; every replica touched by the
request records events under it (TraceStateImpl), events land in
system_traces, and cqlsh's TRACING ON renders the merged timeline.

Shape here:

  TraceState   one session: id + (elapsed_us, source, activity) events.
               A contextvar carries the active state on the executing
               thread; subsystems call trace("...") — zero-cost when
               no trace is active.
  registry     module-level id -> TraceState map of LIVE sessions plus a
               bounded RECENT tail. Needed because replica responses and
               timeout expirations arrive on messaging/reaper threads
               that do not share the coordinator's contextvar: they merge
               events by session id (record_remote / record). The recent
               tail lets a failure event that fires just after the
               coordinator finished (a reaped callback) still land on
               the timeline instead of vanishing.
  TraceStore   per-engine bounded store of completed sessions — the
               system_traces role. Surfaced via the
               system_traces.sessions / system_traces.events virtual
               tables and `nodetool gettraces`.

Sampling: `nodetool settraceprobability p` sets the mutable
`trace_probability` setting; Session.execute consults it (should_sample)
and background-samples untraced statements straight into the store.
"""
from __future__ import annotations

import contextvars
import random
import threading
import time
import uuid as uuid_mod
from collections import OrderedDict, deque
from dataclasses import dataclass, field

_current: contextvars.ContextVar = contextvars.ContextVar(
    "trace_state", default=None)


@dataclass
class TraceState:
    session_id: str = field(
        default_factory=lambda: str(uuid_mod.uuid4()))
    started: float = field(default_factory=time.perf_counter)
    started_at: float = field(default_factory=time.time)
    events: list = field(default_factory=list)
    # default event source: "local" on the coordinator, the endpoint
    # name on a replica recording under a propagated session id
    source: str = "local"
    request: str = ""

    def add(self, activity: str, source: str | None = None) -> None:
        self.events.append(
            (round((time.perf_counter() - self.started) * 1e6),
             source if source is not None else self.source, activity))

    def merge_remote(self, events: list, source: str) -> None:
        """Land replica-side events on this timeline. Remote offsets are
        relative to the replica handler's start; they are re-based so
        the run ends at the merge instant (response arrival) while
        keeping its internal spacing — close enough without clock sync,
        which the reference sidesteps the same way (replica events carry
        source_elapsed, not absolute wall offsets)."""
        if not events:
            return
        now_us = round((time.perf_counter() - self.started) * 1e6)
        tail = max(int(us) for us, _s, _a in events)
        base = max(now_us - tail, 0)
        for us, _src, activity in events:
            self.events.append((base + int(us), source, activity))

    @property
    def duration_us(self) -> int:
        return max((us for us, _s, _a in self.events), default=0)


# ------------------------------------------------------------- registry --

_reg_lock = threading.Lock()
_live: dict[str, TraceState] = {}
_RECENT_MAX = 256
_recent: OrderedDict[str, TraceState] = OrderedDict()


def _lookup(session_id: str) -> TraceState | None:
    with _reg_lock:
        st = _live.get(session_id)
        if st is None:
            st = _recent.get(session_id)
        return st


def begin(session_id: str | None = None,
          request: str = "") -> TraceState:
    st = TraceState(request=request)
    if session_id is not None:
        st.session_id = session_id
    _current.set(st)
    with _reg_lock:
        _live[st.session_id] = st
    return st


def end() -> TraceState | None:
    """Deactivate the current trace. The state moves to the bounded
    recent tail so straggler events (reaped timeouts, late responses)
    still merge; returns it for the caller to persist."""
    st = _current.get()
    _current.set(None)
    if st is not None:
        with _reg_lock:
            _live.pop(st.session_id, None)
            _recent[st.session_id] = st
            while len(_recent) > _RECENT_MAX:
                _recent.popitem(last=False)
    return st


def trace(activity: str, source: str | None = None) -> None:
    st = _current.get()
    if st is not None:
        st.add(activity, source)


def active() -> TraceState | None:
    return _current.get()


def activate(st: TraceState):
    """Install `st` as the thread's active trace; returns a token for
    deactivate(). Used by the replica-side message handler wrapper —
    reset-on-token semantics keep a sim-mode inline delivery from
    clobbering the coordinator's own active trace on the same thread."""
    return _current.set(st)


def deactivate(token) -> None:
    _current.reset(token)


def current_id() -> str | None:
    st = _current.get()
    return st.session_id if st is not None else None


def record(session_id: str, activity: str, source: str = "local") -> None:
    """Append an event to a session by id — for threads without the
    contextvar (messaging callbacks, the timeout reaper). No-op when the
    session has aged out of the recent tail."""
    st = _lookup(session_id)
    if st is not None:
        st.add(activity, source)


def record_remote(session_id: str, events: list, source: str) -> None:
    """Merge replica-shipped events into the coordinator's session."""
    st = _lookup(session_id)
    if st is not None:
        st.merge_remote(events, source)


def should_sample(probability: float, rng=random.random) -> bool:
    """One sampling decision for `trace_probability` (Tracing.java
    newSession under traceProbability). 0.0 never, 1.0 always."""
    if probability <= 0.0:
        return False
    if probability >= 1.0:
        return True
    return rng() < probability


# ---------------------------------------------------------------- store --


class TraceStore:
    """Bounded per-engine store of completed trace sessions — the
    system_traces keyspace role. Explicitly-traced and
    probability-sampled sessions both land here."""

    def __init__(self, capacity: int = 128):
        self._sessions: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def save(self, st: TraceState) -> None:
        if st is None:
            return
        with self._lock:
            self._sessions.append(st)

    def sessions(self) -> list[TraceState]:
        with self._lock:
            return list(self._sessions)

    def get(self, session_id: str) -> TraceState | None:
        with self._lock:
            for st in self._sessions:
                if st.session_id == str(session_id):
                    return st
        return None
