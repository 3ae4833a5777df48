"""Diagnostic event bus + flight recorder: the black box.

Reference counterparts: diag/DiagnosticEventService.java (typed events,
per-type subscription, in-memory persistence surfaced through a virtual
table) and the operational practice it exists for — answering "what
happened in the seconds before this node died" AFTER the node died.

Two pieces:

`DiagnosticEventService`
    A typed event bus with one bounded ring buffer per event type.
    Publishing is gated by the mutable `diagnostic_events_enabled`
    config knob (default OFF, like the reference's
    diagnostic_events_enabled) — a disabled bus costs publishers one
    attribute read and a branch, nothing else, so publish sites can
    live on operational paths (compaction start/finish/abort, flush,
    quarantine, failure-policy trigger, overload shed, slow-consumer
    disconnect, gossip status change, schema change, hot knob reload).
    Surfaced through `system_views.diagnostic_events` and
    `nodetool diagnostics`.

`FlightRecorder`
    Continuously folds published events + periodic metric/tpstats
    snapshots into a small in-memory ring, and dumps a SELF-CONTAINED
    JSON bundle (events, snapshots, final metrics, tpstats, recent
    trace tails, the failure handler's recent-error tail, settings)
    when a failure policy fires (stop / die / stop_commit), when an
    sstable is quarantined, or on demand via
    `nodetool flightrecorder`. The bundle is the post-incident
    artifact scripts/check_diagnostics.py asserts on.

Both are engine-wired (storage/engine.py) but the bus itself is
process-global like the metrics registry: in-process multi-node
clusters share one ring, with each event carrying enough fields
(keyspace/table/path/endpoint) to attribute it.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

# ring capacity per event type: enough context to reconstruct the
# run-up to an incident without holding the process's history hostage
RING_PER_TYPE = 128


class DiagnosticEvent:
    __slots__ = ("type", "at", "seq", "fields")

    def __init__(self, etype: str, at: float, seq: int, fields: dict):
        self.type = etype
        self.at = at          # wall seconds (time.time)
        self.seq = seq        # process-wide publication order
        self.fields = fields

    def to_dict(self) -> dict:
        return {"type": self.type, "at_ms": int(self.at * 1000),
                "seq": self.seq, **self.fields}


class DiagnosticEventService:
    """Per-type bounded rings + subscriber fan-out. `enabled` is the
    zero-cost gate: module-level publish() reads it before building
    anything."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._rings: dict[str, deque] = {}
        self._seq = 0
        self._subscribers: list = []
        # per-owner enable demands (the compaction_mesh_devices demand
        # pattern): the bus is process-global but the knob is
        # engine-scoped — one co-hosted engine hot-reloading its knob
        # to false must not silence a peer whose knob is still true.
        # The bus runs enabled while ANY demand stands.
        self._demands: set = set()

    # ------------------------------------------------------------ config --

    def set_demand(self, owner, on) -> None:
        """Register/withdraw one owner's enable demand (engines pass
        their own identity; set_enabled is the anonymous demand)."""
        with self._lock:
            if on:
                self._demands.add(owner)
            else:
                self._demands.discard(owner)
            self.enabled = bool(self._demands)

    def set_enabled(self, v) -> None:
        self.set_demand(None, bool(v))

    def subscribe(self, cb) -> None:
        """cb(event) on every published event (the flight recorder's
        feed). Subscribers must not raise; a raise is swallowed so one
        bad consumer cannot lose the event for the rings."""
        with self._lock:
            if cb not in self._subscribers:
                self._subscribers.append(cb)

    def unsubscribe(self, cb) -> None:
        with self._lock:
            if cb in self._subscribers:
                self._subscribers.remove(cb)

    # ----------------------------------------------------------- publish --

    def publish(self, etype: str, fields: dict) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._seq += 1
            ev = DiagnosticEvent(etype, time.time(), self._seq, fields)
            ring = self._rings.get(etype)
            if ring is None:
                ring = self._rings[etype] = deque(maxlen=RING_PER_TYPE)
            ring.append(ev)
            subs = list(self._subscribers)
        for cb in subs:
            try:
                cb(ev)
            except Exception:
                pass

    # -------------------------------------------------------------- read --

    def events(self, etype: str | None = None,
               limit: int | None = None) -> list[DiagnosticEvent]:
        """Recent events (publication order), optionally one type."""
        with self._lock:
            if etype is not None:
                evs = list(self._rings.get(etype, ()))
            else:
                evs = [e for ring in self._rings.values() for e in ring]
        evs.sort(key=lambda e: e.seq)
        return evs[-limit:] if limit else evs

    def types(self) -> list[str]:
        with self._lock:
            return sorted(self._rings)

    def clear(self) -> None:
        """Drop all rings (test isolation); leaves enabled untouched."""
        with self._lock:
            self._rings.clear()

    def reset(self) -> None:
        """Full test/script isolation: drop every ring AND every enable
        demand (a leaked engine demand must not bleed into the next
        test)."""
        with self._lock:
            self._rings.clear()
            self._demands.clear()
            self.enabled = False


GLOBAL = DiagnosticEventService()


def publish(etype: str, **fields) -> None:
    """Module-level publish — the one call every publish site makes.
    With the bus disabled (the default) this is an attribute read and a
    return; fields are only materialized into an event when enabled."""
    svc = GLOBAL
    if not svc.enabled:
        return
    svc.publish(etype, fields)


def enabled() -> bool:
    return GLOBAL.enabled


# ------------------------------------------------------ flight recorder --


class FlightRecorder:
    """In-memory black box for one engine. Folds the diagnostic event
    stream and time-gated metric/tpstats snapshots into bounded rings;
    `dump()` writes the whole state as one self-contained JSON bundle
    under <data_dir>/diagnostics/.

    Automatic dump triggers (wired by StorageEngine):
      - a failure policy going terminal (stop / die / stop_commit),
        via FailureHandler.flight_recorder
      - an sstable quarantine (FailureHandler.notify_quarantine)
      - `nodetool flightrecorder` on demand

    Snapshots are taken opportunistically as events flow (time-gated by
    SNAPSHOT_PERIOD_S — no background thread to leak) and always once
    more at dump time, so the bundle has both "a while before" and "the
    instant of" views of the metrics."""

    SNAPSHOT_PERIOD_S = 10.0
    RING_EVENTS = 256
    RING_SNAPSHOTS = 12
    # automatic triggers of the same reason within this window coalesce
    # into one bundle (a die fires the stop listeners too)
    DEDUP_WINDOW_S = 5.0

    def __init__(self, engine=None, clock=time.monotonic):
        self.engine = engine
        self.clock = clock
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.RING_EVENTS)
        self._snapshots: deque = deque(maxlen=self.RING_SNAPSHOTS)
        self._last_snapshot = 0.0
        self._snapshotting = False
        self._last_dump: dict[str, float] = {}
        self.dumps: list[str] = []   # bundle paths written, oldest first
        GLOBAL.subscribe(self._on_event)

    def close(self) -> None:
        GLOBAL.unsubscribe(self._on_event)

    # ------------------------------------------------------------- folds --

    def _on_event(self, ev: DiagnosticEvent) -> None:
        with self._lock:
            self._events.append(ev)
        self.maybe_snapshot()

    def fold(self, etype: str, fields: dict) -> None:
        """Fold one event into THIS recorder's ring directly, bypassing
        the (possibly disabled) bus: a publisher whose event must reach
        its own black box regardless of the diagnostic_events_enabled
        knob (the SLO breach path) records it here. seq 0 marks it as
        bus-bypassing."""
        self._on_event(DiagnosticEvent(etype, time.time(), 0,
                                       dict(fields)))

    def maybe_snapshot(self) -> None:
        """Time-gated snapshot, taken on a short-lived helper thread:
        publish sites run on latency-critical threads (the transport
        event loop publishes sheds; gossip publishes under its lock) —
        polling every registered gauge + tpstats there would stall the
        very paths being observed. At most one capture is in flight."""
        now = self.clock()
        with self._lock:
            if now - self._last_snapshot < self.SNAPSHOT_PERIOD_S \
                    or self._snapshotting:
                return
            self._last_snapshot = now
            self._snapshotting = True

        def _run():
            try:
                snap = self._capture()
                with self._lock:
                    self._snapshots.append(snap)
            finally:
                with self._lock:
                    self._snapshotting = False

        threading.Thread(target=_run, name="flightrec-snapshot",
                         daemon=True).start()

    def _capture(self) -> dict:
        """One metrics + tpstats view, stamped. Capture failures leave a
        partial snapshot rather than raising into a publish site."""
        from .metrics import GLOBAL as METRICS
        snap: dict = {"at_ms": int(time.time() * 1000)}
        try:
            snap["metrics"] = METRICS.snapshot()
        except Exception:
            snap["metrics"] = {}
        try:
            # the one busy/stall/idle primitive — the black box was
            # the only bundle surface missing it
            from ..utils import pipeline_ledger
            snap["pipelines"] = pipeline_ledger.snapshot_all()
        except Exception:
            snap["pipelines"] = {}
        eng = self.engine
        if eng is not None:
            try:
                from ..tools.nodetool import tpstats
                snap["tpstats"] = tpstats(eng)
            except Exception:
                snap["tpstats"] = []
            try:
                snap["compaction_gauges"] = eng.compactions.gauges()
            except Exception:
                pass
        return snap

    # -------------------------------------------------------------- dump --

    def trigger(self, reason: str, **fields) -> str | None:
        """Automatic-trigger entry (failure policy / quarantine): dumps
        unless the same reason dumped inside the dedup window. Never
        raises — a broken dump must not mask the failure being
        recorded."""
        now = self.clock()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.DEDUP_WINDOW_S:
                return None
            self._last_dump[reason] = now
        try:
            return self.dump(reason, trigger=fields)
        except Exception:
            return None

    def dump(self, reason: str = "on_demand",
             trigger: dict | None = None,
             path: str | None = None) -> str:
        """Write the bundle; returns its path. Self-contained: events,
        snapshot ring, a final metrics/tpstats capture, recent trace
        tails, the failure handler's recent errors and the live
        settings all travel in one JSON file."""
        eng = self.engine
        with self._lock:
            events = [e.to_dict() for e in self._events]
            snapshots = list(self._snapshots)
        bundle: dict = {
            "reason": reason,
            "at_ms": int(time.time() * 1000),
            "trigger": trigger or {},
            "diagnostic_events_enabled": GLOBAL.enabled,
            "events": events,
            "snapshots": snapshots,
            "final": self._capture(),
        }
        try:
            # explicit top-level ledger stage table (also inside every
            # time-gated snapshot via _capture): the bundle's
            # where-did-the-wall-go surface
            from ..utils import pipeline_ledger
            bundle["pipeline_ledger"] = pipeline_ledger.snapshot_all()
        except Exception:
            pass
        try:
            # continuous-profiler section (observability layer 6): the
            # device-program registry (compile/dispatch/execute +
            # retraces — a retrace-sentinel event in `events` always
            # has its per-program evidence here) and the wall-clock
            # sampler's state + hottest ring stacks
            from . import profiling as _profiling
            from . import sampler as _sampler
            bundle["profile"] = {
                "device_programs":
                    _profiling.GLOBAL.snapshot()["kernels"],
                "retrace_budget": _profiling.GLOBAL.retrace_budget,
                "sampler": _sampler.GLOBAL.stats(),
                "flamegraph": _sampler.GLOBAL.collapsed(limit=40),
            }
        except Exception:
            pass
        if eng is not None:
            bundle["node"] = {"data_dir": eng.data_dir}
            # retained metrics-history window (service/history.py):
            # what LED UP to the event, not just the moment of it. One
            # forced sample at dump time guarantees a non-empty window
            # even with the sampler knob off.
            hist = getattr(eng, "metrics_history", None)
            if hist is not None:
                try:
                    hist.sample()
                    bundle["metrics_history"] = hist.recent_window()
                except Exception:
                    bundle["metrics_history"] = {}
            # adaptive-controller decision tail (control/loop.py):
            # what the controller DID leading up to the event — with
            # config.reload actor attribution, a bundle distinguishes
            # human from controller actuation
            ctrl = getattr(eng, "controller", None)
            if ctrl is not None:
                try:
                    bundle["controller_decisions"] = \
                        ctrl.decisions(limit=32)
                    bundle["controller_state"] = ctrl.stats()
                except Exception:
                    bundle["controller_decisions"] = []
            try:
                bundle["settings"] = [
                    {"name": n, "value": v, "mutable": m}
                    for n, v, m in eng.settings.all()]
            except Exception:
                pass
            failures = getattr(eng, "failures", None)
            if failures is not None:
                with failures._lock:
                    bundle["recent_errors"] = list(failures.errors)
                bundle["failure_state"] = {
                    "disk_policy": failures.disk_policy,
                    "commit_policy": failures.commit_policy,
                    "storage_stopped": failures.storage_stopped,
                    "commits_stopped": failures.commits_stopped,
                    "dead": failures.dead,
                }
            store = getattr(eng, "trace_store", None)
            if store is not None:
                bundle["traces"] = [
                    {"session_id": st.session_id, "request": st.request,
                     "duration_us": st.duration_us,
                     "events": [{"elapsed_us": us, "source": src,
                                 "activity": act}
                                for us, src, act in list(st.events)]}
                    for st in store.sessions()[-8:]]
        if path is None:
            base = eng.data_dir if eng is not None else "."
            ddir = os.path.join(base, "diagnostics")
            os.makedirs(ddir, exist_ok=True)
            path = os.path.join(
                ddir, f"flightrecorder-{int(time.time() * 1000)}-"
                      f"{reason.replace('/', '_')}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, default=repr)
        os.replace(tmp, path)
        self.dumps.append(path)
        return path
