"""Timestamps and expiry semantics.

Reference semantics: write timestamps are microseconds since epoch
(cql3 'USING TIMESTAMP'); localDeletionTime is seconds since epoch
(db/DeletionTime.java, db/LivenessInfo.java); NO_TTL=0, NO_EXPIRY handled
via sentinel (db/LivenessInfo.java:36-50)."""
from __future__ import annotations

import threading
import time

NO_TIMESTAMP = -(1 << 63)          # LivenessInfo.NO_TIMESTAMP
NO_TTL = 0
NO_DELETION_TIME = 0x7FFFFFFF      # int max: "not deleted / never expires"
LIVE_DELETION = (NO_TIMESTAMP, NO_DELETION_TIME)
# largest TTL CQL accepts: 20 years (cql3/Attributes.java MAX_TTL)
MAX_TTL = 20 * 365 * 24 * 3600

# ctpulint: clock-injectable
# patchable wall clock (seconds, float). Tests install a virtual clock
# here to make TTL expiry deterministic; production leaves time.time.
CLOCK = time.time


def expiration_time(now_s: int, ttl: int) -> int:
    """localDeletionTime of an expiring cell, CAPPED at the int32
    horizon instead of overflowing (the 2038 problem —
    db/ExpirationDateOverflowHandling.java policy CAP: a write whose
    expiry exceeds the representable maximum lives until the cap, it
    does not wrap into the past and vanish)."""
    return min(now_s + ttl, NO_DELETION_TIME - 1)

_last_micros = 0
_micros_lock = threading.Lock()


def now_micros() -> int:
    """Monotonic-per-process microsecond clock (ClientState.getTimestamp
    semantics: never returns the same value twice, even across threads)."""
    global _last_micros
    with _micros_lock:
        # ctpulint: allow(clock-discipline, reason=write timestamps must stay unique and monotonic PROCESS-wide; the sim patches CLOCK (now_seconds/TTL expiry) only — pinning micros to a virtual clock would hand equal timestamps to every write in a tick and break last-write-wins)
        t = time.time_ns() // 1000
        if t <= _last_micros:
            t = _last_micros + 1
        _last_micros = t
        return t


def now_seconds() -> int:
    return int(CLOCK())
