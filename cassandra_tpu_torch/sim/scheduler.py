"""Deterministic simulation: virtual time + a seeded event queue that
owns EVERY message delivery, callback timeout, retry sleep, and
background tick in a simulated cluster.

Reference counterpart: the simulator (test/simulator/asm/
InterceptClasses.java role — there via bytecode interception of
monitors/threads; here by construction): the cluster's nondeterminism
sources are funneled through one scheduler so a failing interleaving
REPLAYS byte-for-byte from its seed.

Design — single real thread, inline pumping:
  * `SimTransport.deliver` enqueues the delivery as a virtual-time
    event with a seeded jitter instead of handing it to a per-node
    delivery thread. `MessagingService` detects the sim transport and
    starts no worker/reaper threads; callback timeouts become
    scheduler events (`messaging._expire_one`).
  * Blocking waits (`threading.Event.wait`) become `SimEvent.wait`:
    the caller PUMPS the scheduler inline — processing deliveries,
    timeouts and ticks (possibly re-entrantly triggering nested waits)
    — until its event is set or its virtual deadline passes. One real
    thread, total order chosen only by (virtual time, seeded seq).
  * `time.sleep/monotonic/time/time_ns` in the cluster modules map to
    the virtual clock; `random` in gossip maps to a seeded RNG.
  * Background LOOPS (gossip rounds, hint dispatch) run as recurring
    scheduler timers, never threads: a thread loop would hog the pump.

Within one `simulated(seed)` scope every run of the same scenario
executes the same event sequence; `SimScheduler.trace` records it so
tests can assert replay identity and diff divergent seeds.
"""
from __future__ import annotations

import heapq
import itertools
import random as _random_mod
import threading as _real_threading
import time as _real_time
from contextlib import contextmanager

_MAX_IDLE_ADVANCE = 3600.0     # virtual seconds with an empty queue


class SimScheduler:
    def __init__(self, seed: int):
        self.seed = seed
        self.rng = _random_mod.Random(seed)
        self.now = 0.0                     # virtual seconds
        self._heap: list = []              # (time, seq, fn, desc)
        self._seq = itertools.count()
        self.trace: list[tuple] = []       # (t, seq, desc) as processed
        self.epoch = 1_750_000_000.0       # virtual wall-clock base
        # ONLY this thread may pump: a leaked background thread from
        # earlier tests hitting the patched time.sleep must not drive
        # the queue concurrently — that would corrupt both determinism
        # and the heap (see _FakeTime.sleep's owner guard)
        self.owner = _real_threading.current_thread()

    # ------------------------------------------------------- enqueue --

    def at(self, t: float, fn, desc: str = "") -> None:
        heapq.heappush(self._heap, (max(t, self.now), next(self._seq),
                                    fn, desc))

    def after(self, delay: float, fn, desc: str = "") -> None:
        self.at(self.now + max(delay, 0.0), fn, desc)

    def every(self, interval: float, fn, desc: str = "") -> None:
        """Recurring tick (gossip rounds, hint dispatch)."""
        def tick():
            try:
                fn()
            finally:
                self.after(interval, tick, desc)
        self.after(interval, tick, desc)

    def jitter(self, lo: float = 1e-4, hi: float = 5e-3) -> float:
        """Seeded per-message network delay — the interleaving lever."""
        return self.rng.uniform(lo, hi)

    # ----------------------------------------------------------- pump --

    def step(self) -> bool:
        """Process the single next event; False when the queue is empty."""
        if not self._heap:
            return False
        t, seq, fn, desc = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        self.trace.append((round(t, 9), seq, desc))
        fn()
        return True

    def pump_until(self, pred, deadline: float) -> bool:
        """Process events in order until pred() or virtual `deadline`.
        Re-entrant: events may themselves block on SimEvent.wait, which
        pumps this same queue deeper on the stack."""
        while True:
            if pred():
                return True
            if not self._heap:
                # idle: nothing can ever set pred — advance to deadline
                self.now = min(deadline, self.now + _MAX_IDLE_ADVANCE)
                return pred()
            t = self._heap[0][0]
            if t > deadline:
                self.now = deadline
                return pred()
            self.step()

    def run(self, duration: float) -> None:
        """Advance virtual time by `duration`, draining due events."""
        end = self.now + duration
        self.pump_until(lambda: False, end)

    def drain(self, max_events: int = 100_000) -> None:
        """Run until the queue is empty (recurring timers excluded by
        cancelling them first) or the event budget trips."""
        n = 0
        while self._heap and n < max_events:
            self.step()
            n += 1


class SimEvent:
    """threading.Event whose wait() pumps the scheduler (virtual time)
    instead of blocking a real thread."""

    def __init__(self, sched: SimScheduler):
        self._sched = sched
        self._set = False

    def set(self) -> None:
        self._set = True

    def clear(self) -> None:
        self._set = False

    def is_set(self) -> bool:
        return self._set

    def wait(self, timeout: float | None = None) -> bool:
        if _real_threading.current_thread() is not self._sched.owner:
            # foreign threads may not pump; poll in real time instead
            deadline = _real_time.monotonic() + (timeout or 60.0)
            while not self._set and _real_time.monotonic() < deadline:
                _real_time.sleep(0.01)
            return self._set
        deadline = self._sched.now + (1e12 if timeout is None
                                      else max(timeout, 0.0))
        return self._sched.pump_until(self.is_set, deadline)


class SimCondition:
    """threading.Condition whose wait() pumps the scheduler (virtual
    time). The underlying lock stays a REAL RLock — the single pumping
    thread holds it re-entrancy-safely — and wait() releases it while
    pumping so events fired by the pump (acks, failures) can take it
    to notify."""

    def __init__(self, sched: SimScheduler, lock=None):
        self._sched = sched
        self._lock = lock if lock is not None else _real_threading.RLock()
        self._seq = 0   # bumped per notify; waiters watch for a change

    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self):
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()

    def notify(self, n: int = 1) -> None:
        self._seq += 1

    def notify_all(self) -> None:
        self._seq += 1

    def wait(self, timeout: float | None = None) -> bool:
        start = self._seq
        if _real_threading.current_thread() is not self._sched.owner:
            # foreign threads may not pump; poll in real time instead
            deadline = _real_time.monotonic() + (timeout or 60.0)
            self._lock.release()
            try:
                while self._seq == start and \
                        _real_time.monotonic() < deadline:
                    _real_time.sleep(0.01)
            finally:
                self._lock.acquire()
            return self._seq != start
        deadline = self._sched.now + (1e12 if timeout is None
                                      else max(timeout, 0.0))
        self._lock.release()
        try:
            return self._sched.pump_until(lambda: self._seq != start,
                                          deadline)
        finally:
            self._lock.acquire()

    def wait_for(self, predicate, timeout: float | None = None):
        deadline = None if timeout is None else self._sched.now + timeout
        result = predicate()
        while not result:
            if deadline is not None and self._sched.now >= deadline:
                break
            self.wait(None if deadline is None
                      else deadline - self._sched.now)
            result = predicate()
        return result


class SimThread:
    """threading.Thread stand-in: the target runs as ONE scheduled
    event on the pumping thread (it may itself block via SimEvent,
    nesting the pump). Loop bodies must NOT use this — drive them with
    SimScheduler.every instead."""

    def __init__(self, sched: SimScheduler, target=None, args=(),
                 kwargs=None, daemon=None, name=None):
        self._sched = sched
        self._target = target
        self._args = args
        self._kwargs = kwargs or {}
        self._done = False
        self.name = name or "sim-thread"
        self.daemon = daemon

    def start(self) -> None:
        def run():
            try:
                if self._target is not None:
                    self._target(*self._args, **self._kwargs)
            finally:
                self._done = True
        self._sched.after(self._sched.jitter(), run,
                          f"thread:{self.name}")

    def join(self, timeout: float | None = None) -> None:
        self._sched.pump_until(lambda: self._done,
                               self._sched.now + (timeout or 1e12))

    def is_alive(self) -> bool:
        return not self._done


class _FakeThreading:
    """Module-attribute replacement for `threading` inside simulated
    cluster modules: Event/Thread become scheduler-driven; locks stay
    real (a single pumping thread holds them re-entrancy-safely via the
    same discipline as production — blocking waits never happen while a
    plain Lock is held)."""

    def __init__(self, sched: SimScheduler):
        self._sched = sched
        self.Lock = _real_threading.Lock
        self.RLock = _real_threading.RLock
        self.local = _real_threading.local
        self.current_thread = _real_threading.current_thread

    def Event(self):
        return SimEvent(self._sched)

    def Condition(self, lock=None):
        return SimCondition(self._sched, lock)

    def Thread(self, target=None, args=(), kwargs=None, daemon=None,
               name=None):
        return SimThread(self._sched, target=target, args=args,
                         kwargs=kwargs, daemon=daemon, name=name)


class _FakeTime:
    """Module-attribute replacement for `time`: virtual clock."""

    def __init__(self, sched: SimScheduler):
        self._sched = sched

    def monotonic(self) -> float:
        return self._sched.now

    def perf_counter(self) -> float:
        return self._sched.now

    def time(self) -> float:
        return self._sched.epoch + self._sched.now

    def time_ns(self) -> int:
        return int((self._sched.epoch + self._sched.now) * 1e9)

    def sleep(self, seconds: float) -> None:
        if _real_threading.current_thread() is not self._sched.owner:
            # a foreign (leaked/background) thread must never pump the
            # scheduler — give it a bounded real sleep instead
            _real_time.sleep(min(seconds, 0.05))
            return
        self._sched.run(seconds)


# modules whose top-level `threading`/`time`/`random` are redirected
# while a simulation is active
_PATCH_MODULES = (
    "cassandra_tpu_torch.cluster.messaging",
    "cassandra_tpu_torch.cluster.coordinator",
    "cassandra_tpu_torch.cluster.schema_sync",
    "cassandra_tpu_torch.cluster.cms",
    "cassandra_tpu_torch.cluster.paxos",
    "cassandra_tpu_torch.cluster.gossip",
    "cassandra_tpu_torch.cluster.node",
    "cassandra_tpu_torch.cluster.counters",
    "cassandra_tpu_torch.cluster.repair",
)


@contextmanager
def simulated(seed: int):
    """Activate deterministic simulation: patches the cluster modules'
    time/threading/random onto a fresh SimScheduler, yields it, and
    restores everything on exit. Build nodes INSIDE the scope (their
    Events must be SimEvents) — or use SimCluster, which does."""
    import importlib

    from ..utils import lockwitness

    sched = SimScheduler(seed)
    fthreading = _FakeThreading(sched)
    ftime = _FakeTime(sched)
    # the lock-order witness is armed for the scope: every witnessed
    # lock the simulated cluster creates records acquisition edges, and
    # a cycle-closing acquisition raises deterministically (same seed →
    # same event order → same first-cycle edge). The graph resets at
    # entry so a replay of the same seed sees the same empty graph —
    # UNLESS the witness was already armed externally
    # (CTPU_LOCK_WITNESS=1 whole-suite runs): wiping the accumulated
    # process-global graph there would silently drop edges other tests
    # recorded, degrading whole-suite coverage to per-scope coverage.
    _witness_was_armed = lockwitness.armed()
    if not _witness_was_armed:
        lockwitness.reset()
        lockwitness.arm()
    saved: list[tuple] = []
    for name in _PATCH_MODULES:
        mod = importlib.import_module(name)
        for attr, repl in (("threading", fthreading), ("time", ftime)):
            if hasattr(mod, attr):
                saved.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, repl)
    # TTL expiry and write-time now-seconds follow the virtual clock too
    from ..utils import timeutil
    saved.append((timeutil, "CLOCK", timeutil.CLOCK))
    timeutil.CLOCK = ftime.time
    try:
        yield sched
    finally:
        if not _witness_was_armed:
            lockwitness.disarm()
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


class SimTransport:
    """LocalTransport-shaped transport whose deliveries are scheduler
    events with seeded jitter (the nondeterminism lever). Carries the
    scheduler so MessagingService skips its threads."""

    def __init__(self, scheduler: SimScheduler):
        from ..cluster.messaging import MessageFilters
        self.scheduler = scheduler
        self.filters = MessageFilters()
        self._nodes: dict = {}

    def register(self, ep, svc) -> None:
        self._nodes[ep] = svc

    def unregister(self, ep) -> None:
        self._nodes.pop(ep, None)

    def deliver(self, msg) -> None:
        if self.filters.should_drop(msg):
            return

        def run():
            target = self._nodes.get(msg.to)
            if target is not None and not target.closed:
                target._process(msg)
        self.scheduler.after(
            self.scheduler.jitter(), run,
            f"{msg.verb} {msg.sender.name}->{msg.to.name}#{msg.id}")


class SimCluster:
    """N nodes in the noded deployment shape (per-node Schema/Ring/
    SchemaSync) over a SimTransport, with gossip + hint dispatch as
    recurring scheduler timers. Must be constructed inside a
    simulated(seed) scope.

    `device` is the torch device of every node's engine, resolved once
    as LocalCluster does: `cuda` unless the caller asks for `cpu`."""

    def __init__(self, sched: SimScheduler, base_dir: str, n: int = 3,
                 gossip_interval: float = 0.25, schema_sync: bool = True,
                 device=None):
        import os

        from ..cluster.node import Node
        from ..device import resolve
        from ..cluster.ring import Endpoint, Ring, even_tokens
        from ..cluster.schema_sync import SchemaSync
        from ..schema import Schema
        self.sched = sched
        self.device = resolve(device)
        self.engine_opts = {"device": self.device}
        self.transport = SimTransport(sched)
        self.eps = [Endpoint(f"node{i + 1}", host="127.0.0.1", port=0)
                    for i in range(n)]
        tokens = even_tokens(n, vnodes=4)
        self.nodes = []
        for ep in self.eps:
            ring = Ring()
            for e, toks in zip(self.eps, tokens):
                ring.add_node(e, toks)
            node = Node(ep, os.path.join(base_dir, ep.name), Schema(),
                        ring, self.transport, seeds=[self.eps[0]],
                        gossip_interval=gossip_interval,
                        engine_opts=self.engine_opts)
            node.cluster_nodes = [node]
            # the Node constructor's hint thread became a no-op SimThread
            # loop; stop it and drive dispatch as a timer instead
            node._stop_hints.set()
            sched.every(0.5, node.hint_round, f"hints:{ep.name}")
            node.gossiper.clock = lambda: sched.now
            # per-node seeded RNG: gossip target selection replays
            # (and no foreign thread can consume our draws)
            node.gossiper.rng = __import__("random").Random(
                (sched.seed << 8) ^ len(self.nodes))
            sched.every(gossip_interval, node.gossiper.round,
                        f"gossip:{ep.name}")
            if schema_sync:
                node.schema_sync = SchemaSync(
                    node, os.path.join(base_dir, ep.name))
            self.nodes.append(node)
        # seed full mutual liveness (LocalCluster does the same)
        from ..cluster.gossip import EndpointState
        for node in self.nodes:
            for other in self.nodes:
                if other.endpoint != node.endpoint:
                    st = node.gossiper.states.setdefault(
                        other.endpoint, EndpointState(generation=1))
                    node.gossiper.detector.report(other.endpoint, st,
                                                  sched.now)

    @property
    def filters(self):
        return self.transport.filters

    def node(self, i: int):
        return self.nodes[i - 1]

    def session(self, i: int = 1):
        return self.nodes[i - 1].session()

    def partition(self, *eps):
        """Cut the given endpoints off from the rest, both directions."""
        rules = []
        for ep in eps:
            rules.append(self.filters.drop(frm=ep))
            rules.append(self.filters.drop(to=ep))
        return rules

    def shutdown(self):
        for n in self.nodes:
            try:
                n.engine.close()
            except Exception:
                pass
