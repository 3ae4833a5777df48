"""Token-bucket rate limiter for background I/O throttling.

Reference counterpart: the Guava RateLimiter used by
CompactionManager.getRateLimiter (db/compaction/CompactionManager.java)
fed from `compaction_throughput` (conf/cassandra.yaml:1243), and the
equivalent stream throttle in streaming/StreamManager.java.

One bucket per consumer group (compaction, streaming): tokens are BYTES,
refilled continuously at the configured rate; `acquire(n)` debits n
tokens, sleeping when the bucket runs dry. A burst allowance of one
second's worth of tokens lets short bursts through without jitter while
holding the long-run average at the configured rate. Rate 0 (or
negative) disarms the limiter entirely — acquire becomes free.

The token unit is configurable: the default (unit=2**20) keeps the
historical MiB/s surface for the I/O throttles; `unit=1.0` makes the
same bucket count OPERATIONS — the native-transport per-client request
limiter (`native_transport_rate_limit_ops`) reuses it that way, through
the non-blocking `try_acquire` (an over-limit client is answered with
an OVERLOADED error, never slept on).

The clock and sleep functions are injectable so token accounting is
testable without real sleeps (and so a simulated deployment could drive
it on virtual time).
"""
from __future__ import annotations

import threading
import time

# ctpulint: clock-injectable
# the clock/sleep seam is the constructor's clock=/sleep= parameters;
# `time.monotonic`/`time.sleep` appear below only as the production
# DEFAULTS (references, never direct calls)


class RateLimiter:
    """Thread-safe token-bucket limiter in rate×unit tokens/s
    (0 = unthrottled); unit defaults to MiB."""

    def __init__(self, mib_per_s: float = 0.0, clock=time.monotonic,
                 sleep=time.sleep, unit: float = 2**20):
        self._clock = clock
        self._sleep = sleep
        self._unit = unit
        self.rate = max(mib_per_s, 0.0) * unit    # tokens/s
        self._allowance = self.rate               # burst: 1s of tokens
        self._last = clock()
        self._lock = threading.Lock()
        # cumulative accounting (compactionstats / metrics)
        self.bytes_acquired = 0
        self.seconds_throttled = 0.0

    @property
    def mib_per_s(self) -> float:
        return self.rate / self._unit

    def set_rate(self, mib_per_s: float) -> None:
        """Hot-reload (nodetool setcompactionthroughput /
        DatabaseDescriptor.setCompactionThroughputMebibytesPerSec)."""
        with self._lock:
            self.rate = max(mib_per_s, 0.0) * self._unit
            self._allowance = min(self._allowance, self.rate)
            self._last = self._clock()

    def try_acquire(self, n: int = 1) -> bool:
        """Non-blocking acquire: True iff n tokens were available right
        now (no debt is taken on, nothing sleeps). The shedding-style
        consumers (per-client request limiting) use this; the throttling
        consumers (compaction/stream I/O) use acquire."""
        if self.rate <= 0:
            return True
        with self._lock:
            if self.rate <= 0:
                return True
            now = self._clock()
            self._allowance = min(
                self.rate, self._allowance + (now - self._last) * self.rate)
            self._last = now
            if self._allowance < n:
                return False
            self._allowance -= n
            self.bytes_acquired += n
            return True

    def acquire(self, nbytes: int, cancel=None) -> float:
        """Debit nbytes tokens, sleeping until the bucket allows them.
        Returns seconds slept (0.0 on the unthrottled fast path).

        cancel: an optional threading.Event — a set event cuts the
        sleep short and REFUNDS the debit (the caller is abandoning the
        work the tokens were for, so its debt must not throttle the
        task that replaces it)."""
        if self.rate <= 0:
            return 0.0
        with self._lock:
            if self.rate <= 0:   # re-check: set_rate(0) may have raced
                return 0.0
            now = self._clock()
            self._allowance = min(
                self.rate, self._allowance + (now - self._last) * self.rate)
            self._last = now
            self.bytes_acquired += nbytes
            # debit may drive the bucket NEGATIVE (debt, Guava-style):
            # the debt is visible to every later acquirer, so concurrent
            # compactors' waits stack arithmetically and the AGGREGATE
            # rate holds even though the sleeps themselves overlap
            self._allowance -= nbytes
            wait = (-self._allowance / self.rate
                    if self._allowance < 0 else 0.0)
            if wait > 0.0:
                self.seconds_throttled += wait
        # sleep OUTSIDE the lock: a throttled task must not block other
        # compactors' token accounting
        if wait > 0.0:
            if cancel is not None and cancel.is_set():
                # cancelled before sleeping at all: full refund
                with self._lock:
                    self._allowance = min(self.rate,
                                          self._allowance + nbytes)
                    self.bytes_acquired -= nbytes
                    self.seconds_throttled -= wait
                return 0.0
            if cancel is not None and self._sleep is time.sleep:
                t0 = self._clock()
                if cancel.wait(wait):
                    slept = min(max(self._clock() - t0, 0.0), wait)
                    with self._lock:
                        self._allowance = min(self.rate,
                                              self._allowance + nbytes)
                        self.bytes_acquired -= nbytes
                        # the refund covers the TIME too: the portion of
                        # the projected wait the cancel cut short never
                        # throttled anything
                        self.seconds_throttled -= wait - slept
                    return slept
            else:
                # injected sleep/clock (tests, simulation): keep the
                # 'testable without real sleeps' contract — the virtual
                # sleep runs in full and cancellation is observed at
                # the call boundaries above, never via a real-time wait
                self._sleep(wait)
        return wait
