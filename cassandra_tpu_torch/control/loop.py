"""Adaptive compaction controller: observe → decide → actuate.

Reference counterpart: none in-tree — the reference leaves strategy
choice to the operator. The LSM design-space survey (arXiv 2202.04522)
and the Bigtable merge analysis (arXiv 1407.3008) both treat compaction
trigger, layout and granularity as tunable axes whose optimum shifts
with the read/write/space mix; this loop moves the node along those
axes as the observed mix shifts, so a phase-shifting workload is not
stuck with whichever static strategy the table was created with.

`AdaptiveCompactionController` (engine-scoped, the MetricsHistoryService
shape):

- A fixed-interval decision loop with an injectable clock. Each
  `tick()` reads the SAME per-table counters the metrics-history rings
  retain (window deltas of writes/reads), the derived amplification
  gauges (`ColumnFamilyStore.amplification()`), and the recent
  sstables' tombstone mix, classifies each table's recent window into
  the saturation matrix's workload regimes — write-burst / read-heavy /
  time-series / space-pressured — and picks compaction strategy +
  parameters (STCS↔LCS↔TWCS, thresholds, output sizing) plus the
  engine-level throughput / mesh / compressor-pool posture.
- **Actuation only through existing seams**: per-table strategy changes
  swap `table.params.compaction` through
  `ColumnFamilyStore.set_compaction_params` (the `get_strategy`
  re-selection seam — in-flight tasks are protected by the manager's
  claim registry and finish under their OLD plan); engine knobs go
  through `Settings.set(..., source="controller")`, so every decision
  is a `controller.decision` / `config.reload` diagnostic event in the
  flight recorder.
- **Hysteresis + cooldown**: a candidate regime must persist
  `adaptive_compaction_confirm_ticks` consecutive ticks before it
  actuates, and an applied strategy change starts a per-table
  `adaptive_compaction_cooldown` window inside which no further change
  lands — no A→B→A flapping on a noisy boundary.
- **Freeze**: `freeze()` keeps the loop ticking but applies nothing;
  the frozen flag persists as a marker file under the engine's data
  dir, so it survives loop AND engine restarts (an operator's "stop
  touching my cluster" outlives the process).
- **Zero-cost when off** (the diagnostic-bus rule): while the mutable
  `adaptive_compaction_enabled` knob is false no decision thread
  exists and nothing is classified; `tick()` stays callable on demand
  (tests, `scripts/check_controller.py`, the bench's deterministic
  cadence). The knob is ENGINE-scoped like `metrics_history_enabled`.

Surfaces: `system_views.controller_decisions`, `nodetool
autocompaction [status|history|freeze|unfreeze]`, the `controller.*`
metrics (docs/observability.md), the `controller_decisions` section of
every flight-recorder bundle, and bench.py's `adaptive` section.
"""
from __future__ import annotations

import os
import threading
import time

# ctpulint: clock-injectable
# every timestamp and duration in this module comes from the
# controller's injected clock; `time.monotonic` / `time.time` appear
# only as production defaults (references, never direct calls)

from collections import deque

from ..service.metrics import GLOBAL as METRICS

FROZEN_MARKER = "controller.frozen"

# the decision table: regime -> compaction params (class + thresholds +
# output sizing), docs/adaptive-compaction.md. Values are COMPLETE
# replacement param dicts — the actuation seam swaps atomically, never
# merges, so a decision is exactly reproducible from its ledger entry.
REGIME_PARAMS = {
    # bursty ingest: size-tiered merging amortizes best; reference
    # min_threshold keeps write amplification low under churn
    "write_burst": {"class": "SizeTieredCompactionStrategy",
                    "min_threshold": 4},
    # read-dominated: leveling bounds sstables-per-read; the size
    # target carries into CompactionTask.max_output_bytes
    "read_heavy": {"class": "LeveledCompactionStrategy",
                   "sstable_size_in_mb": 160, "l0_threshold": 4},
    # append-mostly with expiring data: time windows make whole-sstable
    # expiry a rewrite-free DROP
    "time_series": {"class": "TimeWindowCompactionStrategy",
                    "compaction_window_unit": "HOURS",
                    "compaction_window_size": 1},
    # live size far above logical: eager size-tiering (threshold 2)
    # reclaims overlap fastest
    "space_pressured": {"class": "SizeTieredCompactionStrategy",
                        "min_threshold": 2},
}

# regimes whose backlog wants the write path wide open: the engine
# posture unthrottles compaction and widens the mesh/compressor pools
# while any table sits in one of these
BOOST_REGIMES = ("write_burst", "space_pressured")

# engine-posture knob values while boosting (0.0 rate = unthrottled;
# pool widths are modest fixed widths — the pools are shared process
# state and output bytes are width-invariant)
BOOST_KNOBS = {"compaction_throughput_mib_per_sec": 0.0,
               "compaction_mesh_devices": 2,
               "compaction_compressor_threads": 2}


class AdaptiveCompactionController:
    """Engine-scoped adaptive compaction controller (see module
    docstring). All decision state is guarded by one lock; observation
    reads live store surfaces outside it."""

    MIN_INTERVAL_S = 0.05    # same floor rule as MetricsHistoryService:
    #                          a 0-second knob must not boot a busy-spin
    #                          decision thread
    LEDGER_CAPACITY = 256    # bounded decision ring (newest kept)

    # classification thresholds (docs/adaptive-compaction.md): window
    # deltas below MIN_ACTIVITY are idle noise, not a regime
    MIN_ACTIVITY = 16
    READ_WRITE_RATIO = 2.0       # reads >= ratio * writes -> read_heavy
    TOMBSTONE_FRACTION = 0.20    # recent-sstable tombstone share ->
    #                              time_series
    SPACE_AMP_LIMIT = 2.0        # live/logical partition ratio ->
    #                              space_pressured

    def __init__(self, engine=None, clock=time.monotonic,
                 interval_s: float = 30.0, wall_clock=time.time):
        self.engine = engine
        self.clock = clock
        # wall-clock reference for rendering surfaces only (ledger
        # at_ms must join against diagnostic-event timestamps);
        # cooldown/hysteresis arithmetic stays on the injectable
        # monotonic clock
        self.wall_clock = wall_clock
        self.interval_s = max(float(interval_s), self.MIN_INTERVAL_S)
        self._lock = threading.Lock()
        # per-table hysteresis state: table_id -> {regime, candidate,
        # streak, last_change (controller clock), prev counter snapshot,
        # generation watermark bounding the "recent window" sstables}
        self._state: dict = {}
        self._ledger: deque = deque(maxlen=self.LEDGER_CAPACITY)
        self._seq = 0
        # engine-posture memory: knob values saved when boost engaged,
        # restored verbatim on disengage (never clobber an operator's
        # setting with a hardcoded default)
        self._boost_saved: dict | None = None
        self.ticks = 0
        self.decisions_applied = 0
        self.decisions_skipped = 0
        self._frozen = self._load_frozen()
        self._stop: threading.Event | None = None
        self._wake: threading.Event | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ config --

    @property
    def enabled(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def set_enabled(self, on) -> None:
        """The `adaptive_compaction_enabled` knob landing: start or
        stop the decision thread. Ledger and hysteresis state survive a
        disable — history up to the stop stays queryable."""
        if on:
            self.start()
        else:
            self.stop()

    def set_interval(self, seconds: float) -> None:
        """The `adaptive_compaction_interval` knob: a parked loop is
        woken so the new period applies NOW."""
        self.interval_s = max(float(seconds), self.MIN_INTERVAL_S)
        wake = self._wake
        if wake is not None:
            wake.set()

    # ------------------------------------------------------------ freeze --

    def _marker_path(self) -> str | None:
        eng = self.engine
        data_dir = getattr(eng, "data_dir", None) if eng else None
        if not data_dir:
            return None
        return os.path.join(data_dir, FROZEN_MARKER)

    def _load_frozen(self) -> bool:
        p = self._marker_path()
        return bool(p and os.path.exists(p))

    @property
    def frozen(self) -> bool:
        return self._frozen

    def freeze(self) -> None:
        """nodetool autocompaction freeze: the loop keeps ticking (and
        counting) but applies NOTHING. Persisted as a data-dir marker
        so an engine restart comes back frozen."""
        self._frozen = True
        p = self._marker_path()
        if p:
            with open(p, "w") as f:
                f.write("frozen\n")
        from ..service import diagnostics
        diagnostics.publish("controller.freeze", frozen=True)

    def unfreeze(self) -> None:
        self._frozen = False
        p = self._marker_path()
        if p and os.path.exists(p):
            os.remove(p)
        from ..service import diagnostics
        diagnostics.publish("controller.freeze", frozen=False)

    # -------------------------------------------------------------- loop --

    def start(self) -> None:
        """Idempotent decision-loop start (daemon thread, the
        metrics-history sampler shape)."""
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
                        continue       # new period, no tick yet
                    self.tick()
                except Exception:
                    pass   # a broken gauge must not kill the loop

        self._thread = threading.Thread(target=_run,
                                        name="adaptive-compaction",
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

    # ------------------------------------------------------------ observe --

    def _signals(self, cfs, st: dict) -> dict:
        """One table's recent-window signals: counter deltas since the
        last tick (the same per-table counters the metrics-history
        rings retain — same-source with every other surface), the
        derived amplification gauges, and the tombstone mix of sstables
        flushed since the last tick (the generation watermark bounds
        the 'recent window')."""
        m = cfs.metrics
        prev = st.get("snap") or {"writes": 0, "reads": 0}
        writes_d = m.get("writes", 0) - prev["writes"]
        reads_d = m.get("reads", 0) - prev["reads"]
        live = cfs.live_sstables()
        watermark = st.get("gen_watermark", 0)
        recent = [s for s in live if s.desc.generation > watermark]
        tomb = sum(s.n_tombstones for s in recent)
        cells = sum(s.n_cells for s in recent)
        amp = cfs.amplification()
        sig = {
            "writes_delta": writes_d,
            "reads_delta": reads_d,
            "recent_sstables": len(recent),
            "tombstone_fraction": (tomb / cells) if cells else 0.0,
            "write_amplification": amp["write_amplification"],
            "space_amplification": amp["space_amplification"],
        }
        # retained-history rates when the sampler is on: the long-window
        # corroboration of the tick-window deltas (status surface; the
        # rings and the deltas read the SAME counters)
        hist = getattr(self.engine, "metrics_history", None)
        if hist is not None:
            base = f"table.{cfs.table.keyspace}.{cfs.table.name}"
            rate = hist.rate(f"{base}.writes", limit=1)
            if rate:
                sig["write_rate_per_s"] = round(rate[-1]["per_s"], 3)
        st["snap"] = {"writes": m.get("writes", 0),
                      "reads": m.get("reads", 0)}
        st["gen_watermark"] = max(
            [s.desc.generation for s in live], default=watermark)
        return sig

    def _classify(self, sig: dict) -> str | None:
        """Signals -> regime (None = idle window, no opinion). Order
        matters: expiry mix trumps volume, read dominance trumps the
        space check, space pressure trumps plain write burst."""
        active = max(sig["writes_delta"], sig["reads_delta"]) \
            >= self.MIN_ACTIVITY
        if not active:
            return None
        if sig["writes_delta"] >= self.MIN_ACTIVITY \
                and sig["recent_sstables"] > 0 \
                and sig["tombstone_fraction"] >= self.TOMBSTONE_FRACTION:
            return "time_series"
        if sig["reads_delta"] >= self.MIN_ACTIVITY \
                and sig["reads_delta"] >= self.READ_WRITE_RATIO \
                * max(sig["writes_delta"], 1):
            return "read_heavy"
        if sig["writes_delta"] >= self.MIN_ACTIVITY \
                and sig["space_amplification"] >= self.SPACE_AMP_LIMIT:
            return "space_pressured"
        if sig["writes_delta"] >= self.MIN_ACTIVITY:
            return "write_burst"
        return None

    # ------------------------------------------------------------- decide --

    def tick(self) -> int:
        """One decision pass NOW (on-demand callers — tests, the bench's
        deterministic cadence, check_controller — need no running
        thread). Returns decisions APPLIED this tick."""
        METRICS.incr("controller.ticks")
        eng = self.engine
        applied = 0
        with self._lock:
            self.ticks += 1
        if eng is None:
            return 0
        settings = eng.settings
        now = self.clock()
        cooldown = float(settings.get("adaptive_compaction_cooldown"))
        confirm = max(
            int(settings.get("adaptive_compaction_confirm_ticks")), 1)
        regimes: set = set()
        for cfs in list(eng.stores.values()):
            with self._lock:
                st = self._state.setdefault(
                    cfs.table.id,
                    {"regime": None, "candidate": None, "streak": 0,
                     "last_change": None, "snap": None,
                     "gen_watermark": 0, "table":
                     f"{cfs.table.keyspace}.{cfs.table.name}"})
            try:
                sig = self._signals(cfs, st)
            except Exception:
                continue   # a store mid-drop must not kill the pass
            regime = self._classify(sig)
            st["signals"] = sig
            if st["regime"] is not None:
                regimes.add(st["regime"])
            if regime is None or regime == st["regime"]:
                st["candidate"], st["streak"] = None, 0
                continue
            if regime == st["candidate"]:
                st["streak"] += 1
            else:
                st["candidate"], st["streak"] = regime, 1
            if st["streak"] < confirm:
                self._skip()   # hysteresis: unconfirmed candidate
                continue
            if st["last_change"] is not None \
                    and now - st["last_change"] < cooldown:
                self._skip(cfs, regime, "cooldown")
                continue
            if self._frozen:
                self._skip(cfs, regime, "frozen")
                continue
            applied += self._apply_strategy(cfs, st, regime, now)
            regimes.add(regime)
        if not self._frozen:
            applied += self._apply_posture(settings, regimes)
        return applied

    # ------------------------------------------------------------ actuate --

    def _apply_strategy(self, cfs, st: dict, regime: str,
                        now: float) -> int:
        """Confirmed regime change for one table: atomic params swap
        through the ColumnFamilyStore seam (in-flight tasks keep their
        claimed inputs and finish under the OLD plan), ledger + event +
        metric, hysteresis state reset, cooldown armed."""
        new = dict(REGIME_PARAMS[regime])
        old = dict(cfs.table.params.compaction)
        st.update(regime=regime, candidate=None, streak=0,
                  last_change=now)
        if old == new:
            return 0   # regime label changed, params already right
        cfs.set_compaction_params(new)
        self._record(
            keyspace=cfs.table.keyspace, table=cfs.table.name,
            regime=regime, action="strategy",
            old=old.get("class", "SizeTieredCompactionStrategy"),
            new=new["class"], applied=True, reason="confirmed")
        return 1

    def _apply_posture(self, settings, regimes: set) -> int:
        """Engine-level posture: while any table sits in a
        backlog-heavy regime, unthrottle compaction and widen the
        mesh/compressor pools — through Settings.set with
        source=\"controller\", so each change is an attributed
        config.reload event. Disengaging restores the exact values the
        operator had."""
        boost = bool(regimes & set(BOOST_REGIMES))
        n = 0
        if boost and self._boost_saved is None:
            saved = {}
            for name, value in BOOST_KNOBS.items():
                saved[name] = settings.get(name)
                if saved[name] == value:
                    continue
                settings.set(name, value, source="controller")
                self._record(keyspace="", table="", regime="engine",
                             action="knob", old=repr(saved[name]),
                             new=repr(value), applied=True, reason=name)
                n += 1
            self._boost_saved = saved
        elif not boost and self._boost_saved is not None:
            for name, value in self._boost_saved.items():
                cur = settings.get(name)
                if cur == value:
                    continue
                settings.set(name, value, source="controller")
                self._record(keyspace="", table="", regime="engine",
                             action="knob", old=repr(cur),
                             new=repr(value), applied=True, reason=name)
                n += 1
            self._boost_saved = None
        return n

    def _skip(self, cfs=None, regime: str | None = None,
              reason: str | None = None) -> None:
        with self._lock:
            self.decisions_skipped += 1
        METRICS.incr("controller.skipped")
        if cfs is not None and reason is not None:
            self._record(keyspace=cfs.table.keyspace,
                         table=cfs.table.name, regime=regime,
                         action="strategy", old="", new="",
                         applied=False, reason=reason)

    def _record(self, **entry) -> None:
        """Append one bounded-ledger entry and publish the
        controller.decision diagnostic event (no-op while the bus is
        disabled; the vtable serves the ledger regardless)."""
        with self._lock:
            self._seq += 1
            entry.update(seq=self._seq,
                         at_ms=int(self.wall_clock() * 1000))
            self._ledger.append(entry)
            if entry["applied"]:
                self.decisions_applied += 1
        if entry["applied"]:
            METRICS.incr("controller.decisions")
        from ..service import diagnostics
        diagnostics.publish("controller.decision", actor="controller",
                            **{k: v for k, v in entry.items()
                               if k != "at_ms"})

    # ------------------------------------------------------------- query --

    def decisions(self, limit: int | None = None) -> list[dict]:
        """Ledger entries, oldest first (bounded ring — newest
        LEDGER_CAPACITY kept)."""
        with self._lock:
            rows = [dict(e) for e in self._ledger]
        return rows[-limit:] if limit else rows

    def table_regimes(self) -> dict:
        """{keyspace.table: {regime, candidate, streak, signals}} — the
        status surface."""
        with self._lock:
            return {st["table"]: {
                "regime": st["regime"], "candidate": st["candidate"],
                "streak": st["streak"],
                "signals": dict(st.get("signals") or {})}
                for st in self._state.values()}

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "frozen": self._frozen,
                    "interval_s": self.interval_s, "ticks": self.ticks,
                    "decisions": self.decisions_applied,
                    "skipped": self.decisions_skipped,
                    "ledger_entries": len(self._ledger)}
