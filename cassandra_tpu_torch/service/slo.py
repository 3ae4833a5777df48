"""SLO service: latency objectives, error budgets, breach artifacts.

Reference counterpart: the reference has no in-tree SLO layer — this is
the operational practice built ON its metrics (the
DecayingEstimatedHistogramReservoir percentiles that feed
`nodetool proxyhistograms`) as codified by the SRE error-budget model:
an objective is a latency percentile target over a sliding window; time
spent out of compliance burns a bounded error budget; exhausting the
budget is an operational event, not a dashboard color.

The pieces:

`SLObjective`
    One objective: a p99 (configurable percentile) threshold over a
    named decaying latency histogram (`client_requests.read` /
    `client_requests.write` by default — the front-door service
    latency), plus an error budget of `budget_s` breach-seconds that
    replenishes at `budget_s / window_s` while compliant. The
    percentile source is injectable (`source`) so tests and the tier-2
    smoke (scripts/check_slo.py) drive breaches deterministically.

`SLOService`
    The per-engine registry. `check()` evaluates every objective
    against the injectable clock: a compliant→breach transition
    publishes a typed `slo.breach` event on the diagnostic bus
    and triggers a DEDUPLICATED flight-recorder dump (reason
    `slo_breach_<objective>`, coalesced by FlightRecorder's dedup
    window) so every SLO violation ships with its own self-contained
    black-box bundle; the budget crossing zero publishes
    `slo.budget_exhausted` (latched until it replenishes above zero)
    and dumps under its own reason. Breach→compliant publishes
    `slo.recover`. Targets hot-reload through the mutable
    `slo_targets` config knob ({objective name: p99 target ms});
    naming an objective that does not exist yet registers a new one
    reading the histogram of the same name, so
    `{"client_requests.read.quorum": 5}` pins a per-consistency-level
    objective without code.

    `set_context(scenario=...)` attaches attribution fields to every
    published event and dump trigger — the saturation matrix
    (scripts/stress.py) stamps its scenario id here, so a chaos-leg
    bundle says WHICH matrix leg breached.

Checks are poll-driven: the matrix and `nodetool slostats` call
`check()`; `start(period)` runs an optional daemon poller (the engine
does NOT start one — no background thread unless asked, the flight
recorder's rule). Counters: `slo.checks`, `slo.breaches`,
`slo.budget_exhausted`, `slo.recorder_dumps`. Surfaces:
`system_views.slos` vtable, `nodetool slostats`.
"""
from __future__ import annotations

import threading
import time

# ctpulint: clock-injectable
# the clock seam is SLOService(clock=) / SLObjective's injectable
# percentile source; `time.monotonic` appears only as the production
# default (a reference, never a direct call)

from .metrics import GLOBAL as METRICS

# default front-door objectives (generous: normal test traffic must not
# breach; the matrix tightens them per leg through the knob)
DEFAULT_TARGET_MS = 250.0
# default error budget: breach-seconds allowed per window
DEFAULT_BUDGET_S = 60.0
DEFAULT_WINDOW_S = 3600.0


class SLObjective:
    """One latency objective + its error budget. All mutable state is
    guarded by the owning service's lock."""

    def __init__(self, name: str, hist: str | None = None,
                 p: float = 0.99, target_ms: float = DEFAULT_TARGET_MS,
                 budget_s: float = DEFAULT_BUDGET_S,
                 window_s: float = DEFAULT_WINDOW_S, source=None):
        self.name = name
        self.hist = hist or name
        self.p = p
        self.target_us = float(target_ms) * 1000.0
        self.budget_s = float(budget_s)
        self.window_s = float(window_s)
        # injectable percentile source (tests / check_slo.py); default
        # reads the named decaying histogram from the global registry
        self._source = source
        # live state
        self.breaching = False
        self.breaches = 0           # compliant->breach transitions
        self.budget_remaining_s = float(budget_s)
        self.exhausted = False      # latched until budget > 0 again
        self.exhaustions = 0
        self.last_p99_us = 0.0
        self.last_check = 0.0       # service-clock time of last check

    def current_us(self) -> float:
        if self._source is not None:
            return float(self._source())
        return float(METRICS.hist(self.hist).percentile(self.p))


class SLOService:
    """Engine-scoped SLO registry over the process-global metrics
    registry (one engine per process in production; in-process
    multi-node tests attach the service to the node taking the wire
    traffic)."""

    def __init__(self, engine=None, clock=time.monotonic):
        self.engine = engine
        self.clock = clock
        # the black box the breach artifact lands in; swappable so
        # tests can pin dedup with an injected-clock recorder
        self.recorder = getattr(engine, "flight_recorder", None)
        self._lock = threading.Lock()
        self._objectives: dict[str, SLObjective] = {}
        self._context: dict = {}
        self._last = clock()
        self.checks = 0
        self._poll_stop: threading.Event | None = None
        self._poll_thread: threading.Thread | None = None

    # ---------------------------------------------------------- registry --

    def register(self, obj: SLObjective) -> SLObjective:
        with self._lock:
            self._objectives[obj.name] = obj
        return obj

    def objective(self, name: str) -> SLObjective | None:
        return self._objectives.get(name)

    def set_targets(self, targets: dict) -> None:
        """Hot-apply the `slo_targets` knob: {name: p99 target ms}.
        Unknown names register a fresh objective over the histogram of
        the same name (the per-CL `client_requests.read.<cl>` rows the
        saturation matrix pins come in this way)."""
        for name, target_ms in (targets or {}).items():
            with self._lock:
                obj = self._objectives.get(name)
                if obj is None:
                    obj = self._objectives[name] = SLObjective(
                        name, target_ms=float(target_ms))
                else:
                    obj.target_us = float(target_ms) * 1000.0

    def reset(self, name: str | None = None) -> None:
        """Return objectives to a clean baseline: compliant, budget
        full, unlatched (tallies are kept — they are lifetime
        counters). The saturation matrix calls this at leg boundaries
        so every leg's breach is a fresh compliant→breach TRANSITION
        that stamps that leg's scenario id, instead of a carried-over
        breaching state from the shared decaying histograms."""
        with self._lock:
            objs = [self._objectives[name]] if name is not None \
                else list(self._objectives.values())
            for obj in objs:
                obj.breaching = False
                obj.exhausted = False
                obj.budget_remaining_s = obj.budget_s

    def set_context(self, **fields) -> None:
        """Attribution fields (scenario id, leg, cl) merged into every
        published event and dump trigger until cleared."""
        with self._lock:
            self._context.update(fields)

    def clear_context(self) -> None:
        with self._lock:
            self._context.clear()

    # ------------------------------------------------------------- check --

    def check(self) -> list[dict]:
        """Evaluate every objective once: burn/replenish budgets by the
        time since the previous check, publish transition events, and
        trigger deduplicated flight-recorder dumps on breach. Returns
        the per-objective verdicts."""
        from . import diagnostics
        now = self.clock()
        out = []
        events = []   # (etype, fields, dump_reason|None) outside lock
        with self._lock:
            dt = max(now - self._last, 0.0)
            self._last = now
            self.checks += 1
            ctx = dict(self._context)
            for obj in self._objectives.values():
                p99 = obj.current_us()
                breaching = p99 > obj.target_us > 0.0
                obj.last_p99_us = p99
                obj.last_check = now
                fields = {"objective": obj.name, "metric": obj.hist,
                          "p99_us": round(p99, 1),
                          "target_us": obj.target_us, **ctx}
                # the interval since the last check is billed to the
                # state the objective was OBSERVED in at its start:
                # intervals that began in breach burn (so a flapping
                # objective burns its real breach share), intervals
                # that began compliant replenish at budget_s/window_s
                # (capped at the full budget)
                was_breaching = obj.breaching
                if was_breaching:
                    obj.budget_remaining_s = max(
                        obj.budget_remaining_s - dt, 0.0)
                    # the zero-crossing is detected AT the burn — an
                    # interval that ends compliant still exhausted the
                    # budget it spent breaching
                    if obj.budget_remaining_s <= 0.0 \
                            and not obj.exhausted:
                        obj.exhausted = True
                        obj.exhaustions += 1
                        events.append((
                            "slo.budget_exhausted",
                            {**fields, "budget_s": obj.budget_s},
                            f"slo_budget_exhausted_{obj.name}"))
                elif obj.window_s > 0:
                    obj.budget_remaining_s = min(
                        obj.budget_remaining_s
                        + dt * (obj.budget_s / obj.window_s),
                        obj.budget_s)
                if breaching:
                    if not was_breaching:
                        obj.breaching = True
                        obj.breaches += 1
                        events.append((
                            "slo.breach",
                            {**fields, "budget_remaining_s":
                                round(obj.budget_remaining_s, 3)},
                            f"slo_breach_{obj.name}"))
                else:
                    if obj.budget_remaining_s > 0.0:
                        obj.exhausted = False
                    if was_breaching:
                        obj.breaching = False
                        events.append(("slo.recover", fields, None))
                out.append(self._verdict_locked(obj))
        METRICS.incr("slo.checks")
        for etype, fields, dump_reason in events:
            if etype == "slo.breach":
                METRICS.incr("slo.breaches")
            elif etype == "slo.budget_exhausted":
                METRICS.incr("slo.budget_exhausted")
            # publish FIRST: the recorder subscribes to the bus, so the
            # breach event is already folded into the ring the bundle
            # serializes when the dump fires
            diagnostics.publish(etype, **fields)
            if not diagnostics.enabled() and self.recorder is not None:
                # bus off (the default): the publish above was a no-op,
                # but the black box must still carry its own breach
                # event — fold it into THIS recorder directly so the
                # bundle stays self-contained either way
                self.recorder.fold(etype, fields)
            if dump_reason is not None and self.recorder is not None:
                path = self.recorder.trigger(dump_reason, **fields)
                if path is not None:
                    METRICS.incr("slo.recorder_dumps")
        return out

    def _verdict_locked(self, obj: SLObjective) -> dict:
        return {
            "objective": obj.name, "metric": obj.hist, "p": obj.p,
            "p99_us": round(obj.last_p99_us, 1),
            "target_us": obj.target_us,
            "breaching": obj.breaching, "breaches": obj.breaches,
            "budget_s": obj.budget_s,
            "budget_remaining_s": round(obj.budget_remaining_s, 3),
            "exhausted": obj.exhausted,
            "exhaustions": obj.exhaustions,
        }

    def snapshot(self) -> list[dict]:
        """Pure view of the last-checked state (the vtable surface —
        reading `system_views.slos` must not publish or dump)."""
        with self._lock:
            return [self._verdict_locked(o)
                    for o in self._objectives.values()]

    # ------------------------------------------------------------- poller --

    def start(self, period_s: float = 1.0) -> None:
        """Optional daemon poller (the saturation matrix runs one);
        idempotent."""
        if self._poll_thread is not None and self._poll_thread.is_alive():
            return
        stop = threading.Event()
        self._poll_stop = stop

        def _run():
            while not stop.wait(period_s):
                try:
                    self.check()
                except Exception:
                    pass   # a broken objective must not kill the poller

        self._poll_thread = threading.Thread(
            target=_run, name="slo-poller", daemon=True)
        self._poll_thread.start()

    def stop(self) -> None:
        if self._poll_stop is not None:
            self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=2.0)
        self._poll_thread = None
        self._poll_stop = None


def default_service(engine) -> SLOService:
    """The engine-wired service: front-door read/write p99 objectives
    (named after their histograms) with generous defaults, targets
    hot-reloadable through the `slo_targets` knob."""
    svc = SLOService(engine=engine)
    for hist in ("client_requests.read", "client_requests.write"):
        svc.register(SLObjective(hist))
    try:
        svc.set_targets(engine.settings.get("slo_targets"))
    except Exception:
        pass
    return svc
