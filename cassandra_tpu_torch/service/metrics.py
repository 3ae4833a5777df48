"""Metrics registry v2: counters, gauges and DECAYING latency histograms.

Reference counterpart: metrics/CassandraMetricsRegistry.java (Dropwizard)
with TableMetrics / ClientRequestMetrics / CompactionMetrics groups and
DecayingEstimatedHistogramReservoir latency tracking.

What changed from v1 (the immortal histogram): percentiles now come from
a sliding two-chunk window (default 60 s per chunk), so a latency spike
an hour ago no longer pollutes p99 forever — the reference solves the
same problem with a forward-decaying reservoir; a chunked window is the
equivalent that stays exact, lock-cheap and unit-testable with an
injected clock. Lifetime count / mean are still tracked (they are
monotonic by nature); percentiles and max decay.

Naming scheme (enforced by scripts/check_metric_names.py and documented
in docs/observability.md): dot-separated lowercase components,
`group.sub…name`, at least two components, each matching
[a-z0-9_]+ — e.g. `cql.request`, `compaction.tasks_completed`,
`table.<ks>.<table>.writes`, `verb.read_req.received`.

Export surfaces: snapshot() (flat dict — the system_views.metrics
vtable), group() (prefixed facade for per-table / per-verb metrics),
register_gauge() (callables polled at snapshot time), and
prometheus_text() (Prometheus exposition format, served by
`nodetool exportmetrics` and embedded in bench.py output).
"""
from __future__ import annotations

import math
import re
import threading
import time


class LatencyHistogram:
    """Log-scale bucket histogram of microsecond latencies with a
    sliding-window decay: updates land in the CURRENT chunk; reads
    aggregate the current + previous chunk and rotate expired ones, so
    percentiles/max reflect roughly the last `window_s`..2×`window_s`
    seconds. Lifetime count/total are immortal (monotonic)."""

    N_BUCKETS = 64

    def __init__(self, window_s: float = 60.0, clock=time.monotonic):
        self.window_s = float(window_s)
        self.clock = clock
        self.count = 0          # lifetime
        self.total_us = 0       # lifetime
        self._lock = threading.Lock()
        self._chunks: list = []  # [chunk_start, buckets, max_us], newest last
        self._new_chunk()

    def _new_chunk(self) -> None:
        self._chunks.append([self.clock(), [0] * self.N_BUCKETS, 0.0])

    def _rotate_locked(self) -> None:
        now = self.clock()
        if now - self._chunks[-1][0] >= self.window_s:
            self._new_chunk()
        # keep current + previous only
        while len(self._chunks) > 2 or (
                len(self._chunks) == 2
                and now - self._chunks[0][0] >= 2 * self.window_s):
            if len(self._chunks) == 1:
                break
            self._chunks.pop(0)

    def update_us(self, us: float) -> None:
        b = min(int(math.log2(max(us, 1))), self.N_BUCKETS - 1)
        with self._lock:
            self._rotate_locked()
            self._chunks[-1][1][b] += 1
            if us > self._chunks[-1][2]:
                self._chunks[-1][2] = us
            self.count += 1
            self.total_us += us

    # ---- windowed reads (all take the lock: the count/mean/bucket race
    # of v1 is gone — see MetricsRegistry.snapshot)

    def _window_buckets_locked(self):
        self._rotate_locked()
        agg = [0] * self.N_BUCKETS
        for _t0, buckets, _mx in self._chunks:
            for i, c in enumerate(buckets):
                agg[i] += c
        return agg

    def _percentile_of(self, buckets, total, p: float) -> float:
        if not total:
            return 0.0
        target = total * p
        acc = 0
        for b, c in enumerate(buckets):
            acc += c
            if acc >= target:
                return float(2 ** b)
        return float(2 ** (self.N_BUCKETS - 1))

    def percentile(self, p: float) -> float:
        with self._lock:
            buckets = self._window_buckets_locked()
            return self._percentile_of(buckets, sum(buckets), p)

    @property
    def max_us(self) -> float:
        with self._lock:
            self._rotate_locked()
            return max((c[2] for c in self._chunks), default=0.0)

    @property
    def mean_us(self) -> float:
        with self._lock:
            return self.total_us / self.count if self.count else 0.0

    def summary(self) -> dict:
        """One consistent read of count/mean/percentiles/max under a
        single lock acquisition (the snapshot surface)."""
        with self._lock:
            buckets = self._window_buckets_locked()
            total = sum(buckets)
            return {
                "count": self.count,
                "total_us": self.total_us,
                "mean_us": round(self.total_us / self.count, 1)
                if self.count else 0.0,
                "p50_us": self._percentile_of(buckets, total, 0.50),
                "p95_us": self._percentile_of(buckets, total, 0.95),
                "p99_us": self._percentile_of(buckets, total, 0.99),
                "max_us": max((c[2] for c in self._chunks), default=0.0),
            }


class Timer:
    def __init__(self, hist: LatencyHistogram):
        self.hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.update_us((time.perf_counter() - self._t0) * 1e6)


class MetricGroup:
    """Prefix facade: metrics.group('table.ks.t').incr('writes') lands
    on 'table.ks.t.writes' (the TableMetrics / per-verb group role)."""

    def __init__(self, registry: "MetricsRegistry", prefix: str):
        self.registry = registry
        self.prefix = prefix

    def _n(self, name: str) -> str:
        return f"{self.prefix}.{name}"

    def incr(self, name: str, n: int = 1) -> None:
        self.registry.incr(self._n(name), n)

    def counter(self, name: str) -> int:
        return self.registry.counter(self._n(name))

    def hist(self, name: str) -> LatencyHistogram:
        return self.registry.hist(self._n(name))

    def timer(self, name: str) -> Timer:
        return self.registry.timer(self._n(name))


class MetricsRegistry:
    """Grouped counters + gauges + decaying histograms:
    metrics.group('table.ks.t').incr(..)"""

    def __init__(self, window_s: float = 60.0):
        self.window_s = window_s
        self._counters: dict[str, int] = {}
        self._hists: dict[str, LatencyHistogram] = {}
        self._gauges: dict[str, callable] = {}
        self._lock = threading.Lock()

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        return self._counters.get(name, 0)

    def hist(self, name: str) -> LatencyHistogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram(self.window_s)
            return h

    def timer(self, name: str) -> Timer:
        return Timer(self.hist(name))

    def group(self, prefix: str) -> MetricGroup:
        return MetricGroup(self, prefix)

    def register_gauge(self, name: str, fn) -> None:
        """fn() -> number, polled at snapshot/export time (Dropwizard
        Gauge role). Re-registering a name replaces the callable."""
        with self._lock:
            self._gauges[name] = fn

    def unregister_gauge(self, name: str) -> None:
        with self._lock:
            self._gauges.pop(name, None)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            hists = list(self._hists.items())
            gauges = list(self._gauges.items())
        # histogram reads happen OUTSIDE the registry lock (each hist
        # serializes its own summary): keeps snapshot cheap under
        # concurrent updates while reading count/mean/buckets
        # consistently. Live engine-scoped gauges remain engine-scoped
        # by design — see CompactionManager.gauges() / the
        # system_views.metrics vtable — so in-process multi-node
        # deployments never cross-report.
        for name, h in hists:
            s = h.summary()
            out[f"{name}.count"] = s["count"]
            out[f"{name}.mean_us"] = s["mean_us"]
            out[f"{name}.p50_us"] = s["p50_us"]
            out[f"{name}.p95_us"] = s["p95_us"]
            out[f"{name}.p99_us"] = s["p99_us"]
            out[f"{name}.max_us"] = s["max_us"]
        for name, fn in gauges:
            try:
                out[name] = fn()
            except Exception:
                pass   # a dead gauge must not break the whole snapshot
        return out


def _prom_name(name: str) -> str:
    return "ctpu_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _escape_label(value: str) -> str:
    """Prometheus exposition label-value escaping (backslash, quote,
    newline — in that order, so the escapes themselves survive). A
    hostile metric/label value must never be able to inject extra
    labels or lines into the scrape."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def prometheus_text(registry: "MetricsRegistry" = None,
                    extra_gauges: dict | None = None) -> str:
    """Render the registry in Prometheus exposition format: counters as
    `counter`, gauges as `gauge`, histograms as `summary` (quantile
    labels from the decayed window + lifetime _count/_sum). Served by
    `nodetool exportmetrics` and embedded in bench output."""
    reg = registry if registry is not None else GLOBAL
    with reg._lock:
        counters = sorted(reg._counters.items())
        hists = sorted(reg._hists.items())
        gauges = sorted(reg._gauges.items())
    lines = []
    for name, v in counters:
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {v}")
    for name, h in hists:
        s = h.summary()   # count/sum from ONE lock acquisition: a scrape
        # racing updates must never emit a _sum that includes samples
        # its _count does not
        pn = _prom_name(name) + "_us"
        lines.append(f"# TYPE {pn} summary")
        for q, key in (("0.5", "p50_us"), ("0.95", "p95_us"),
                       ("0.99", "p99_us")):
            lines.append(
                f'{pn}{{quantile="{_escape_label(q)}"}} {s[key]}')
        lines.append(f"{pn}_count {s['count']}")
        lines.append(f"{pn}_sum {float(s['total_us'])}")
    for name, fn in gauges:
        try:
            v = fn()
        except Exception:
            continue
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {v}")
    if extra_gauges:
        for name, v in sorted(extra_gauges.items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {v}")
    return "\n".join(lines) + "\n"


GLOBAL = MetricsRegistry()
