"""LockWitness — runtime lock-order witness (the dynamic half of
ctpulint's lock-order check).

The static pass (analysis/checks/lock_order.py) sees syntactic nesting
through an approximate call graph; callbacks, engine-scoped registries
and closures handed across threads are invisible to it. The witness
closes that gap at RUNTIME: instrumented Lock/RLock/Condition wrappers
record, per thread, every "acquired B while holding A" edge into one
process-global order graph, and the first acquisition that would close
a cycle raises `LockOrderError` carrying BOTH stacks — the acquisition
being attempted and the recorded stack that created the reverse path —
so the existing test suite catches dynamic inversions for free, at the
moment they become possible rather than the run they finally deadlock.

Zero-cost when disarmed: the `make_lock/make_rlock/make_condition`
factories return RAW threading primitives unless the witness is armed
at creation time, so production pays nothing — not even a branch per
acquire. Arming therefore only affects locks created AFTER `arm()`:
arm first (tests, scripts/check_static.py full mode, the deterministic
simulator scope), then build the engine. `CTPU_LOCK_WITNESS=1` arms at
import for whole-suite runs.

Identity is the NAME given at the factory (one node per declaration
site, matching the static pass): all instances of `gossip.lock` are one
graph node, so an inversion between two instances of the same class is
caught as an order violation too (conservative, like the static side).
Re-entrant re-acquisition adds no edge; `Condition.wait` releases its
lock for the wait's duration and the held-stack mirrors that.
"""
from __future__ import annotations

import os
import threading
import traceback

__all__ = ["arm", "disarm", "armed", "reset", "make_lock", "make_rlock",
           "make_condition", "LockOrderError", "graph_snapshot"]


class LockOrderError(RuntimeError):
    """Cycle-closing acquisition. The message carries the cycle and
    both stacks (current + the recorded first-creation stack of the
    reverse path's head edge)."""


_armed = os.environ.get("CTPU_LOCK_WITNESS", "") == "1"

_graph_lock = threading.Lock()
# name -> {name -> (thread_name, stack_str)} recorded at first creation
_edges: dict[str, dict[str, tuple]] = {}
_tls = threading.local()


def arm() -> None:
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def armed() -> bool:
    return _armed


def reset() -> None:
    """Drop the recorded order graph (test isolation)."""
    with _graph_lock:
        _edges.clear()


def graph_snapshot() -> dict:
    """{holder: [acquired, ...]} — check_static.py prints this after
    the witness-armed smoke."""
    with _graph_lock:
        return {a: sorted(b) for a, b in _edges.items()}


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _find_path(start: str, goal: str) -> list | None:
    """Edge path start→...→goal in the recorded graph (graph lock
    held)."""
    stack = [(start, [start])]
    seen = {start}
    while stack:
        node, path = stack.pop()
        for nxt in _edges.get(node, ()):
            if nxt == goal:
                return path + [goal]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _stack() -> str:
    return "".join(traceback.format_stack(limit=16)[:-2])


def _record(name: str) -> None:
    """Before blocking on `name`: record edges from every held lock and
    raise if one closes a cycle."""
    held = _held()
    if not held:
        return
    me = threading.current_thread().name
    with _graph_lock:
        for h in held:
            if h == name:
                continue
            # would h -> name close a cycle? i.e. is h reachable FROM
            # name already?
            path = _find_path(name, h)
            if path is not None:
                rev_head = path[0], path[1]
                thread, stack = _edges[rev_head[0]][rev_head[1]]
                cycle = " -> ".join(path + [name])
                raise LockOrderError(
                    f"lock-order cycle closed: acquiring '{name}' "
                    f"while holding '{h}', but the reverse order "
                    f"{cycle} is already recorded.\n"
                    f"--- this acquisition (thread {me}):\n{_stack()}"
                    f"--- recorded '{rev_head[0]}' -> '{rev_head[1]}' "
                    f"(thread {thread}):\n{stack}")
            slot = _edges.setdefault(h, {})
            if name not in slot:
                slot[name] = (me, _stack())


class _WitnessLock:
    """Witnessed threading.Lock. Only exists when created armed."""

    _inner_factory = staticmethod(threading.Lock)
    _reentrant = False

    def __init__(self, name: str):
        self.name = name
        self._inner = self._inner_factory()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        held = _held()
        depth = held.count(self.name)
        if depth == 0 or not self._reentrant:
            _record(self.name)
        got = self._inner.acquire(blocking, timeout) if blocking \
            else self._inner.acquire(False)
        if got:
            held.append(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        held = _held()
        # remove the innermost occurrence (release order may interleave)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()


class _WitnessRLock(_WitnessLock):
    _inner_factory = staticmethod(threading.RLock)
    _reentrant = True


class _WitnessCondition:
    """Witnessed threading.Condition over a witnessed (or raw) lock."""

    def __init__(self, name: str, lock=None):
        self.name = name
        self._wlock = lock if lock is not None else _WitnessRLock(name)
        inner = getattr(self._wlock, "_inner", self._wlock)
        self._inner = threading.Condition(inner)

    def acquire(self, *a, **kw):
        return self._wlock.acquire(*a, **kw)

    def release(self):
        self._wlock.release()

    def __enter__(self):
        self._wlock.acquire()
        return self

    def __exit__(self, *exc):
        self._wlock.release()

    def wait(self, timeout: float | None = None):
        # the wait releases the lock: mirror that in the held stack so
        # a notifier path acquiring other locks meanwhile is not seen
        # as nested under ours (all re-entrant depths pop)
        held = _held()
        removed = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                removed += 1
        try:
            return self._inner.wait(timeout)
        finally:
            held.extend([self.name] * removed)

    def wait_for(self, predicate, timeout: float | None = None):
        held = _held()
        removed = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                removed += 1
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            held.extend([self.name] * removed)

    def notify(self, n: int = 1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()


def make_lock(name: str):
    """A threading.Lock, witnessed under `name` iff the witness is
    armed right now (zero-cost otherwise: the raw primitive comes
    back)."""
    return _WitnessLock(name) if _armed else threading.Lock()


def make_rlock(name: str):
    return _WitnessRLock(name) if _armed else threading.RLock()


def make_condition(name: str, lock=None):
    if not _armed:
        inner = getattr(lock, "_inner", lock)
        return threading.Condition(inner)
    return _WitnessCondition(name, lock)
