"""Admission control for the native-protocol front door.

Reference counterparts: transport/Dispatcher.java's concurrent-request
permits (native_transport_max_concurrent_requests), the OverloadedException
shedding path in CQLMessageHandler, and the per-client request-rate
limiting of RateLimitingRequestCallback (cassandra 4.1's
native_transport_rate_limiting_enabled).

Three gates, all consulted on the EVENT LOOP before a request reaches the
dispatch executor — a request that cannot be admitted is answered with a
v4/v5 OVERLOADED error immediately instead of queueing forever (the same
bounded-buffer discipline the TPIE-style pipeline applies to bulk I/O):

  PermitGate        a counted permit per in-flight request (queued or
                    executing); cap hot-reloads from the
                    `native_transport_max_concurrent_requests` setting.
                    Tracks a high-water mark so the bench/overload run
                    can PROVE in-flight never exceeded the cap.
  OverloadSignals   server-busy conditions fed by the data plane: a
                    recent `storage.write_stall` (a writer paid an
                    inline threshold flush) or a commitlog sync backlog
                    (pending group-commit syncs above a threshold).
                    Probes are cached (PROBE_INTERVAL_S) so per-request
                    cost is a clock read and a comparison.
  per-client rate   utils/ratelimit.RateLimiter in ops/s (unit=1), one
                    bucket per connection, non-blocking try_acquire;
                    rate hot-reloads from `native_transport_rate_limit_ops`
                    exactly like compaction_throughput_mib_per_sec.
"""
from __future__ import annotations

import threading
import time


class PermitGate:
    """Counted in-flight-request permits (Dispatcher's concurrent-request
    limit). cap <= 0 disables the gate. `high_water` records the maximum
    concurrently-held permits ever observed."""

    def __init__(self, cap: int):
        self._lock = threading.Lock()
        self.cap = int(cap)
        self.active = 0
        self.high_water = 0

    def set_cap(self, cap: int) -> None:
        """Hot-reload (settings listener). Shrinking below the current
        in-flight count only affects NEW admissions — held permits drain
        naturally."""
        with self._lock:
            self.cap = int(cap)

    def try_acquire(self) -> bool:
        with self._lock:
            if self.cap > 0 and self.active >= self.cap:
                return False
            self.active += 1
            if self.active > self.high_water:
                self.high_water = self.active
            return True

    def release(self) -> None:
        with self._lock:
            self.active -= 1

    def reset_high_water(self) -> None:
        """Start a fresh high-water measurement window (the bench's
        overload run proves in-flight <= cap with this)."""
        with self._lock:
            self.high_water = self.active


class OverloadSignals:
    """Server-busy signal derived from the storage engine's own
    backpressure metrics. `reason()` returns a human-readable cause while
    the server should shed, else None.

    Signals (docs/native-transport.md discusses the thresholds):
      - REPEATED write stalls (engine.write_stalls — the engine-scoped
        count behind the storage.write_stall histogram): at least two
        stalls within STALL_WINDOW_S seconds. One stall is a routine
        threshold flush — every healthy node ingesting data pays one
        per memtable's worth of writes, and shedding 5 s of ALL traffic
        for it would turn normal sustained load into a rolling outage;
        a SECOND stall inside the window means writers are outrunning
        the flush pipeline for real. Engine-scoped deliberately: in a
        multi-node-in-one-process deployment, one node's stall must not
        shed a co-hosted idle node's traffic (the histogram is
        process-global);
      - commitlog pending syncs (parked group-commit writers + retired
        segments awaiting fsync) above PENDING_SYNCS_MAX: the durability
        path is behind.

    The probe itself runs at most every PROBE_INTERVAL_S; between probes
    the cached verdict is served, so the per-request cost stays at a
    clock read."""

    PROBE_INTERVAL_S = 0.1
    STALL_WINDOW_S = 5.0
    PENDING_SYNCS_MAX = 128

    def __init__(self, backend, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._reason: str | None = None
        self._last_probe = -1e18
        self._stall_seen_at = -1e18
        self._prev_stall_at = -1e18
        # the engine sits behind a cluster Node as .engine; a bare
        # StorageEngine carries .commitlog itself
        engine = backend if hasattr(backend, "commitlog") \
            else getattr(backend, "engine", None)
        self._engine = engine
        # only stalls AFTER the server came up count as overload
        self._stall_count = self._stalls_now()

    def _stalls_now(self) -> int:
        return int(getattr(self._engine, "write_stalls", 0) or 0)

    def _pending_syncs(self) -> int:
        cl = getattr(self._engine, "commitlog", None)
        if cl is None:
            return 0
        try:
            return int(getattr(cl, "_waiting", 0)) \
                + len(getattr(cl, "_retiring", ()) or ())
        except Exception:
            return 0

    def reason(self) -> str | None:
        now = self._clock()
        with self._lock:
            if now - self._last_probe < self.PROBE_INTERVAL_S:
                return self._reason
            prior_probe = self._last_probe
            self._last_probe = now
            c = self._stalls_now()
            if c > self._stall_count:
                # a single new stall only arms the window; several
                # stalls landing between two probes count as repeated
                # ONLY if that gap was itself short — probes run on
                # request arrival, so after an idle stretch two stalls
                # in the delta may be minutes apart
                if c - self._stall_count > 1 \
                        and now - prior_probe < self.STALL_WINDOW_S:
                    self._prev_stall_at = now
                else:
                    self._prev_stall_at = self._stall_seen_at
                self._stall_count = c
                self._stall_seen_at = now
            if now - self._prev_stall_at < self.STALL_WINDOW_S:
                self._reason = "server overloaded: memtable flush " \
                    "backpressure (storage.write_stall)"
            elif self._pending_syncs() > self.PENDING_SYNCS_MAX:
                self._reason = "server overloaded: commitlog sync backlog"
            else:
                self._reason = None
            return self._reason
