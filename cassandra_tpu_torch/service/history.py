"""Metrics history: the retained-time-series layer of the observatory.

Reference counterpart: none in-tree — the reference exports point-in-
time metrics over JMX and leaves retention to external scrapers. The
ADAPTIVE compaction controller (ROADMAP item 4) cannot depend on an
external Prometheus: closing the loop on observed read/write/space
amplification needs history the node itself retains, which the LSM
design-space survey (arXiv 2202.04522) frames as the tuner's primary
input signal.

`MetricsHistoryService` (engine-scoped, like the flight recorder):

- A fixed-interval sampler with an injectable clock. Each `sample()`
  captures one flat {name: number} view — the global metrics registry
  snapshot (counters, gauges, histogram summaries), this engine's
  compaction gauges, every store's per-table counters and the derived
  amplification gauges — and appends it to per-series rings.
- **Multi-resolution rings**: the raw ring keeps `raw_capacity`
  samples (360 × the 10 s default interval ≈ 1 hour); every
  `raw_per_coarse` raw samples seal into one coarse bucket
  (min/max/last/sum/n-preserving merge, 288 kept ≈ 24 h at the
  defaults). Raw eviction never loses coarse history — buckets fold at
  sample time, not at eviction time.
- `rate()` derives a per-second rate between consecutive retained raw
  samples of a (monotonic) counter; a negative delta — a counter reset
  across an engine restart — clamps to 0 instead of reporting a
  nonsense negative rate.
- **Zero-cost when off** (the diagnostic-bus rule): while the mutable
  `metrics_history_enabled` knob is false no sampler thread exists and
  nothing is captured; `sample()` stays callable on demand (the flight
  recorder takes one moment-of sample at dump time so a bundle always
  carries a history window). The knob is ENGINE-scoped: each engine
  owns its service, so a co-hosted node's knob never flips a peer's
  sampler.

Surfaces: `system_views.metrics_history`, `nodetool metricshistory`,
the `metrics_history` window in every flight-recorder bundle, and the
`history.samples` counter. `bench.py`'s `observatory` section proves
the sampler's overhead share of a compaction run.
"""
from __future__ import annotations

import threading
import time

# ctpulint: clock-injectable
# every timestamp and duration in this module comes from the service's
# injected clock; `time.monotonic` appears only as the production
# default (a reference, never a direct call)

from collections import deque

from .metrics import GLOBAL as METRICS


class _Series:
    """One metric's retained history: a raw ring of (t, value) samples
    plus a coarse ring of sealed merge buckets. Mutated only under the
    owning service's lock."""

    __slots__ = ("raw", "coarse", "acc")

    def __init__(self, raw_capacity: int, coarse_capacity: int):
        self.raw: deque = deque(maxlen=raw_capacity)
        self.coarse: deque = deque(maxlen=coarse_capacity)
        self.acc: dict | None = None   # open (unsealed) coarse bucket

    def add(self, t: float, v: float, raw_per_coarse: int) -> None:
        self.raw.append((t, v))
        a = self.acc
        if a is None:
            self.acc = {"t0": t, "t1": t, "min": v, "max": v,
                        "last": v, "sum": v, "n": 1}
        else:
            a["t1"] = t
            if v < a["min"]:
                a["min"] = v
            if v > a["max"]:
                a["max"] = v
            a["last"] = v
            a["sum"] += v
            a["n"] += 1
        if self.acc["n"] >= raw_per_coarse:
            self.coarse.append(self.acc)
            self.acc = None


class MetricsHistoryService:
    """Engine-scoped retained metrics history (see module docstring).
    All ring state is guarded by one lock; `sample()` collects OUTSIDE
    the lock (registry snapshots serialize on their own locks) and
    folds under it."""

    RAW_CAPACITY = 360        # 1 h at the 10 s default interval
    RAW_PER_COARSE = 30       # one coarse bucket per 5 min of raw
    COARSE_CAPACITY = 288     # ≈ 24 h of coarse history

    MIN_INTERVAL_S = 0.05   # floor shared by __init__ and set_interval:
    #                         a 0-second knob must not boot a busy-spin
    #                         sampler thread

    def __init__(self, engine=None, clock=time.monotonic,
                 interval_s: float = 10.0,
                 raw_capacity: int | None = None,
                 raw_per_coarse: int | None = None,
                 coarse_capacity: int | None = None,
                 collect_fn=None, wall_clock=time.time):
        self.engine = engine
        self.clock = clock
        # wall-clock reference for rendering surfaces (the vtable's
        # at_ms must be epoch-comparable with telemetry snapshots and
        # diagnostic events); sampling arithmetic stays on the
        # injectable monotonic clock
        self.wall_clock = wall_clock
        self._wall_offset: float | None = None
        self.interval_s = max(float(interval_s), self.MIN_INTERVAL_S)
        self.raw_capacity = int(raw_capacity or self.RAW_CAPACITY)
        self.raw_per_coarse = int(raw_per_coarse or self.RAW_PER_COARSE)
        self.coarse_capacity = int(coarse_capacity
                                   or self.COARSE_CAPACITY)
        # injectable capture source (tests / check_observatory.py
        # determinism); default reads the live registries
        self._collect_fn = collect_fn
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self.samples = 0             # lifetime sample() calls
        self.sample_seconds = 0.0    # cumulative capture cost (the
        #                              bench overhead numerator)
        self._stop: threading.Event | None = None
        self._wake: threading.Event | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ config --

    @property
    def enabled(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def set_enabled(self, on) -> None:
        """The `metrics_history_enabled` knob landing: start or stop
        the sampler thread. Retained rings survive a disable — history
        up to the stop stays queryable."""
        if on:
            self.start()
        else:
            self.stop()

    def set_interval(self, seconds: float) -> None:
        """The `metrics_history_interval` knob: a parked sampler is
        woken so the new period applies NOW, not after the old one
        elapses."""
        self.interval_s = max(float(seconds), self.MIN_INTERVAL_S)
        wake = self._wake
        if wake is not None:
            wake.set()

    # ------------------------------------------------------------ sampler --

    def start(self) -> None:
        """Idempotent sampler start (daemon thread, the SLO poller
        shape)."""
        if self.enabled:
            return
        stop = threading.Event()
        wake = threading.Event()
        self._stop = stop
        self._wake = wake

        def _run():
            while not stop.is_set():
                try:
                    if wake.wait(self.interval_s):
                        wake.clear()   # interval kick: re-read the
                        continue       # new period, no sample yet
                    self.sample()
                except Exception:
                    pass   # a broken gauge must not kill the sampler

        self._thread = threading.Thread(target=_run,
                                        name="metrics-history",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._wake is not None:
            self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._thread = None
        self._stop = None
        self._wake = None

    close = stop

    # ------------------------------------------------------------- sample --

    def _default_collect(self) -> dict:
        """One flat {name: number} capture: global registry snapshot +
        this engine's compaction gauges + per-table counters and the
        derived amplification gauges."""
        out = {}
        for k, v in METRICS.snapshot().items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = float(v)
        eng = self.engine
        if eng is not None:
            try:
                out.update(eng.compactions.gauges())
            except Exception:
                pass
            for cfs in list(eng.stores.values()):
                base = f"table.{cfs.table.keyspace}.{cfs.table.name}"
                for k, v in cfs.metrics.items():
                    out[f"{base}.{k}"] = float(v)
                try:
                    for k, v in cfs.amplification().items():
                        out[f"{base}.{k}"] = float(v)
                except Exception:
                    pass
        return out

    def sample(self) -> int:
        """Take one capture NOW (on-demand callers — the flight
        recorder's dump-time sample, nodetool, tests — need no running
        sampler). Returns the number of series updated."""
        t0 = self.clock()
        values = (self._collect_fn or self._default_collect)()
        t = self.clock()
        with self._lock:
            # latest service-clock → wall-clock mapping (rendering
            # surfaces only; bucket arithmetic stays monotonic)
            self._wall_offset = self.wall_clock() - t
            for name, v in values.items():
                s = self._series.get(name)
                if s is None:
                    s = self._series[name] = _Series(
                        self.raw_capacity, self.coarse_capacity)
                s.add(t, float(v), self.raw_per_coarse)
            self.samples += 1
            self.sample_seconds += max(t - t0, 0.0) \
                + max(self.clock() - t, 0.0)
        METRICS.incr("history.samples")
        return len(values)

    # -------------------------------------------------------------- query --

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def query(self, name: str, resolution: str = "raw",
              limit: int | None = None) -> list[dict]:
        """Retained buckets for one series, oldest first. `raw` rows
        are single samples rendered in the bucket shape (min == max ==
        last == sum, n == 1); `coarse` rows are the sealed
        min/max/last/sum-preserving merge buckets (the open accumulator
        is excluded — it is still absorbing raw samples)."""
        if resolution not in ("raw", "coarse"):
            raise ValueError(f"unknown resolution {resolution!r}")
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return []
            if resolution == "raw":
                rows = [{"t0": t, "t1": t, "min": v, "max": v,
                         "last": v, "sum": v, "n": 1}
                        for t, v in s.raw]
            else:
                rows = [dict(b) for b in s.coarse]
        return rows[-limit:] if limit else rows

    def rate(self, name: str, limit: int | None = None) -> list[dict]:
        """Per-second rate between consecutive retained raw samples of
        a counter: [(t, (v_i − v_{i−1}) / (t_i − t_{i−1}))]. A negative
        delta (counter reset) clamps to 0.0; zero-dt pairs are
        skipped. Ring eviction only shortens the window — rates are
        always between samples that were actually retained."""
        with self._lock:
            s = self._series.get(name)
            pts = list(s.raw) if s is not None else []
        out = []
        for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
            dt = t1 - t0
            if dt <= 0:
                continue
            out.append({"t": t1, "per_s": max(v1 - v0, 0.0) / dt})
        return out[-limit:] if limit else out

    def recent_window(self, max_points: int = 30) -> dict:
        """The flight-recorder bundle view: {name: [[t, value], ...]},
        the newest `max_points` raw samples per series — what *led up
        to* the event, bounded."""
        with self._lock:
            return {name: [[t, v] for t, v in
                           list(s.raw)[-max_points:]]
                    for name, s in self._series.items() if s.raw}

    def to_wall(self, t: float) -> float:
        """Map a bucket's service-clock time onto the wall clock (epoch
        seconds) using the offset captured at the most recent sample —
        so vtable timestamps join against telemetry snapshots and
        diagnostic events. Identity before the first sample."""
        off = self._wall_offset
        return t if off is None else t + off

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "interval_s": self.interval_s,
                    "series": len(self._series),
                    "samples": self.samples,
                    "sample_seconds": round(self.sample_seconds, 6)}
