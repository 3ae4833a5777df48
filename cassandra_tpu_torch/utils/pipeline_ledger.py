"""Unified pipeline ledger: one per-stage accounting primitive for every
hand-rolled multi-stage pipeline in the repo.

TPIE (PAPERS.md, arxiv 1710.10091) makes per-stage instrumentation the
organizing principle of external-memory pipelines: you cannot balance a
decode→merge→compress→write chain you cannot see. Before this module,
each pipeline (compaction's compress-pool chain, the flush drain, mesh
fanout lanes, the transport dispatch executor) carried its own ad-hoc
counters — or none. Now they all report through one `Stage` shape:

    busy_s       seconds the stage spent doing its own work
    stall_s      seconds the stage spent BLOCKED on a downstream stage
                 (full queue, exhausted buffer pool — backpressure paid)
    idle_s       seconds the stage spent waiting for upstream input
    items/bytes  units of work through the stage
    queue_hwm    high-water occupancy of the stage's inbound queue

Interpretation rule (docs/observability.md): the stage with the highest
busy_s is the pipeline's capacity bound; a large stall_s on the stage
FEEDING it is the same fact seen from upstream. The where-did-the-wall-go
table bench.py's `pipeline` section prints is exactly this.

The registry is process-global (like the metrics registry): stages
accumulate across tasks under stable `pipeline/stage` names, surfaced as
`pipeline.<pipeline>.<stage>.<stat>` metric gauges, the
`system_views.pipelines` virtual table and `nodetool pipelinestats`.
Recording costs two float adds under a per-stage lock — cheap enough to
stay armed always (the bench's paired A/B pins the data plane within
noise of the un-instrumented path).
"""
from __future__ import annotations

import threading
from . import lockwitness
import time

# ctpulint: clock-injectable
# patchable monotonic clock for the stage timers: tests / a simulated
# deployment swap this for a virtual clock (the timeutil.CLOCK
# pattern); production leaves time.perf_counter. _Timer reads it at
# enter/exit time, so a swap takes effect immediately.
CLOCK = time.perf_counter


class Stage:
    """Accounting for one stage of one pipeline. All mutators take the
    stage lock; they run a handful of times per SEGMENT/SHARD/REQUEST
    (never per cell), so the lock is uncontended noise."""

    __slots__ = ("pipeline", "name", "busy_s", "stall_s", "idle_s",
                 "items", "bytes", "queue_hwm", "_lock")

    def __init__(self, pipeline: str, name: str):
        self.pipeline = pipeline
        self.name = name
        self.busy_s = 0.0
        self.stall_s = 0.0
        self.idle_s = 0.0
        self.items = 0
        self.bytes = 0
        self.queue_hwm = 0
        self._lock = lockwitness.make_lock("pipeline.stage")

    # ------------------------------------------------------------ record --

    def add_busy(self, dt: float) -> None:
        with self._lock:
            self.busy_s += dt

    def add_stall(self, dt: float) -> None:
        with self._lock:
            self.stall_s += dt

    def add_idle(self, dt: float) -> None:
        with self._lock:
            self.idle_s += dt

    def add_items(self, n: int = 1, nbytes: int = 0) -> None:
        with self._lock:
            self.items += n
            self.bytes += nbytes

    def note_queue(self, depth: int) -> None:
        """Record the stage's inbound-queue occupancy at an enqueue
        instant; only the high-water survives (the bound the queue
        actually needed, vs the bound it was given)."""
        if depth > self.queue_hwm:
            with self._lock:
                if depth > self.queue_hwm:
                    self.queue_hwm = depth

    def busy(self) -> "_Timer":
        """`with stage.busy(): ...` — timed busy work."""
        return _Timer(self.add_busy)

    def stall(self) -> "_Timer":
        return _Timer(self.add_stall)

    def idle(self) -> "_Timer":
        return _Timer(self.add_idle)

    # ------------------------------------------------------------- read --

    def snapshot(self) -> dict:
        with self._lock:
            return {"busy_s": round(self.busy_s, 6),
                    "stall_s": round(self.stall_s, 6),
                    "idle_s": round(self.idle_s, 6),
                    "items": self.items, "bytes": self.bytes,
                    "queue_hwm": self.queue_hwm}

    def reset(self) -> None:
        with self._lock:
            self.busy_s = self.stall_s = self.idle_s = 0.0
            self.items = self.bytes = 0
            self.queue_hwm = 0


class _Timer:
    __slots__ = ("_sink", "_t0")

    def __init__(self, sink):
        self._sink = sink

    def __enter__(self):
        self._t0 = CLOCK()
        return self

    def __exit__(self, *exc):
        self._sink(CLOCK() - self._t0)


class PipelineLedger:
    """Ordered stage registry for one named pipeline. Stage creation is
    idempotent, so every writer/task/worker touching the pipeline calls
    `stage(name)` and accumulates into the same accounting."""

    def __init__(self, name: str):
        self.name = name
        self._stages: dict[str, Stage] = {}
        self._lock = threading.Lock()

    def stage(self, name: str) -> Stage:
        st = self._stages.get(name)
        if st is None:
            with self._lock:
                st = self._stages.get(name)
                if st is None:
                    st = Stage(self.name, name)
                    self._stages[name] = st
                    _register_stage_gauges(st)
        return st

    def stages(self) -> list[Stage]:
        with self._lock:
            return list(self._stages.values())

    def snapshot(self) -> dict:
        return {s.name: s.snapshot() for s in self.stages()}

    def reset(self) -> None:
        for s in self.stages():
            s.reset()


# ---------------------------------------------------------------- registry

_LOCK = lockwitness.make_lock("pipeline.registry")
_LEDGERS: dict[str, PipelineLedger] = {}


def ledger(name: str) -> PipelineLedger:
    """Get-or-create the process-global ledger for one pipeline name.
    Established pipelines (docs/observability.md): `compaction` and
    `flush` (SSTableWriter write legs: serialize/compress/io_write +
    the flush `drain` stage), `mesh` (fanout lanes: decode/merge),
    `compress_pool` (shared worker: pack), `transport` (the request
    dispatch executor), `messaging` (the internode verb-dispatch
    pool: `dispatch` plus one lazily-created stage per handled verb)
    and `stream` (the sessioned-transfer legs: read/net/land)."""
    led = _LEDGERS.get(name)
    if led is None:
        with _LOCK:
            led = _LEDGERS.get(name)
            if led is None:
                led = _LEDGERS[name] = PipelineLedger(name)
    return led


def snapshot_all() -> dict:
    """{pipeline: {stage: stats}} — the system_views.pipelines vtable,
    `nodetool pipelinestats` and bench.py's `pipeline` section all read
    this."""
    with _LOCK:
        ledgers = list(_LEDGERS.values())
    return {led.name: led.snapshot() for led in ledgers}


def reset_all() -> None:
    """Zero every stage (bench legs / test isolation). Stages stay
    registered — their metric gauges keep reporting, from zero."""
    with _LOCK:
        ledgers = list(_LEDGERS.values())
    for led in ledgers:
        led.reset()


def _register_stage_gauges(st: Stage) -> None:
    """Export one stage as `pipeline.<pipeline>.<stage>.<stat>` gauges
    in the process-global metrics registry (snapshot / Prometheus /
    system_views.metrics)."""
    from ..service.metrics import GLOBAL

    p, n = st.pipeline, st.name
    GLOBAL.register_gauge(f"pipeline.{p}.{n}.busy_s",
                          lambda: round(st.busy_s, 6))
    GLOBAL.register_gauge(f"pipeline.{p}.{n}.stall_s",
                          lambda: round(st.stall_s, 6))
    GLOBAL.register_gauge(f"pipeline.{p}.{n}.idle_s",
                          lambda: round(st.idle_s, 6))
    GLOBAL.register_gauge(f"pipeline.{p}.{n}.items", lambda: st.items)
    GLOBAL.register_gauge(f"pipeline.{p}.{n}.bytes", lambda: st.bytes)
    GLOBAL.register_gauge(f"pipeline.{p}.{n}.queue_hwm",
                          lambda: st.queue_hwm)
