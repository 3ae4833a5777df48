"""Device program registry: dispatch/execute accounting for every kernel
entry point (counterpart of cassandra_tpu/service/profiling.py).

The surface is the JAX package's:

  record_dispatch(kernel, shape_key, s) -> bool
      host seconds spent issuing one call. The first dispatch of a
      (kernel, shape_key) pair is recorded apart (compile_s/compiles;
      here that is the first launch of a shape, which also pays the
      kernel library's build and load) and returns True; later
      dispatches of the same shape are warm. A program whose first-seen
      shapes cross `retrace_budget` publishes a `profile.retrace`
      diagnostic event once and counts the rest in `profile.retraces`.
  record_execute(kernel, s)
      host seconds spent waiting for a result.
  wrap(name, fn, cost=None)
      instruments one entry point: host dispatch time with the shape
      key of its arguments; at each new shape, when `cost` is given,
      the kernel's least work for those arguments (`cost(*args,
      **kwargs)` -> (bytes, operations), ops/costs.py), reported as
      cost_bytes and cost_flops; and, when an argument is a CUDA tensor, the
      device time between two CUDA events recorded on the current
      stream around the call. Such a call only appends a record; the
      records are accounted in order at the next drain (once
      DRAIN_EVERY wait, or at snapshot()), where the events are read
      if they have completed (else at a later drain), so the wrapper
      takes no lock per call and never synchronises. The events go
      back to a pool per device: a call creates none once the pool
      holds enough (ops/cuda_lib.py: raw event handles, one ctypes
      call to record one, one to read a batch).
  add_phases({phase: seconds})
      folds a CompactionTask.profile into the process aggregate.

There is no tracer check (PyTorch runs eagerly, every call is a real
launch) and no XLA cost analysis: the costs are the kernels' byte and
operation counts from their shapes.

Per-program shape keys are tracked in a bounded LRU (SHAPE_CAP).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from ..ops import cuda_lib

# patchable clock seam (the pipeline-ledger pattern): tests freeze it,
# production leaves time.perf_counter
CLOCK = time.perf_counter

SHAPE_CAP = 256
# CUDA event pairs held until they complete; beyond this the oldest is
# waited for, so an unread backlog cannot grow without bound
PENDING_CAP = 4096
# calls on a card are accounted, and their completed event pairs read,
# once this many wait (one lock and one pass for a batch of calls)
DRAIN_EVERY = 32


_LITERALS = (int, float, str, bool, type(None))
_LITERAL_TYPES = frozenset(_LITERALS)


def _shape_of(x):
    """Hashable shape signature of one operand tree: tensors and arrays
    collapse to (shape, dtype), containers recurse, everything else to
    its literal or type name."""
    if type(x) in _LITERAL_TYPES:
        return ("lit", x)
    shape = getattr(x, "shape", None)
    if shape is not None:
        return ("arr", tuple(shape), getattr(x, "dtype", None))
    if isinstance(x, (tuple, list)):
        return ("seq",) + tuple([_shape_of(v) for v in x])
    if isinstance(x, dict):
        return ("dict",) + tuple(
            (k, _shape_of(v)) for k, v in sorted(x.items()))
    if isinstance(x, _LITERALS):
        return ("lit", x)
    return ("obj", type(x).__name__)


def _signature(args: tuple):
    """(shape key, _cuda_device(args)) of a call's positional operands
    in one pass: the key is flat (each array's shape and dtype, each
    literal as is, anything else its _shape_of), the cheapest to build
    and hash on a path that runs once a launch."""
    dev, parts = None, []
    for a in args:
        if type(a) in _LITERAL_TYPES:
            parts.append(a)
            continue
        shape = getattr(a, "shape", None)
        if shape is None:
            parts.append(_shape_of(a))
            dev = dev or _cuda_device(a)
            continue
        parts.append(shape)
        parts.append(getattr(a, "dtype", None))
        if dev is None:
            d = getattr(a, "device", None)
            if getattr(d, "type", None) == "cuda":
                dev = d
    return tuple(parts), dev


def _cuda_device(x):
    """The device of the first CUDA tensor in an operand tree, or None."""
    if type(x) in _LITERAL_TYPES:
        return None
    dev = getattr(x, "device", None)
    if dev is not None and getattr(dev, "type", None) == "cuda":
        return dev
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        for v in x:
            d = _cuda_device(v)
            if d is not None:
                return d
    return None


class DeviceProgramRegistry:
    def __init__(self, shape_cap: int = SHAPE_CAP):
        self._lock = threading.Lock()
        self._kernels: dict[str, dict] = {}
        self._phases: dict[str, float] = {}
        # the calls on a card, accounted at the next drain: (kernel,
        # shape key, host seconds, cost or None, device index, start
        # event, end event); appended without the lock (a deque's
        # append is atomic), drained under it
        self._calls: deque = deque()
        # (kernel, device index, start event, end event)
        self._pending: list = []
        # free event pairs per device: a call pops one (list.pop is
        # atomic), the drain appends the pairs it has read
        self._free: dict[int, list] = {}
        self.shape_cap = int(shape_cap)
        # <= 0 disables the sentinel; the mutable
        # profiler_retrace_budget knob lands here (engine wiring)
        self.retrace_budget = 0

    def set_retrace_budget(self, budget) -> None:
        """The `profiler_retrace_budget` knob landing (process-global
        like the registry itself: last writer wins across co-hosted
        engines)."""
        self.retrace_budget = int(budget)

    def _kernel_locked(self, name: str) -> dict:
        k = self._kernels.get(name)
        if k is None:
            k = self._kernels[name] = {
                "calls": 0, "compiles": 0, "compile_s": 0.0,
                "dispatch_s": 0.0, "execute_s": 0.0, "device_s": 0.0,
                "device_calls": 0, "shapes": OrderedDict(),
                "shape_evictions": 0, "retraces": 0,
                "sentinel_fired": False, "cost": None}
        return k

    def record_dispatch(self, kernel: str, shape_key,
                        seconds: float) -> bool:
        with self._lock:
            new, retraces = self._dispatch_locked(kernel, shape_key,
                                                  seconds)
        if retraces is not None:
            self._publish(retraces)
        return new

    def _dispatch_locked(self, kernel: str, shape_key, seconds: float):
        """(new shape?, None or the retrace sentinel's (program,
        compiles, retraces, fire)), under the lock."""
        k = self._kernel_locked(kernel)
        k["calls"] += 1
        shapes = k["shapes"]
        if shape_key in shapes:
            shapes.move_to_end(shape_key)
            k["dispatch_s"] += seconds
            return False, None
        shapes[shape_key] = True
        if len(shapes) > self.shape_cap:
            shapes.popitem(last=False)
            k["shape_evictions"] += 1
        k["compiles"] += 1
        k["compile_s"] += seconds
        budget = self.retrace_budget
        if budget > 0 and k["compiles"] > budget:
            k["retraces"] += 1
            fire = not k["sentinel_fired"]
            k["sentinel_fired"] = True
            return True, (kernel, k["compiles"], k["retraces"], fire)
        return True, None

    def _publish(self, retraces) -> None:
        # metrics + event OUTSIDE the registry lock (publish takes the
        # bus lock; never nest foreign locks under ours)
        kernel, compiles, count, fire = retraces
        from .metrics import GLOBAL as METRICS
        METRICS.incr("profile.retraces")
        if fire:
            from . import diagnostics
            diagnostics.publish(
                "profile.retrace", program=kernel, compiles=compiles,
                budget=self.retrace_budget, retraces=count)

    def record_execute(self, kernel: str, seconds: float) -> None:
        with self._lock:
            self._kernel_locked(kernel)["execute_s"] += seconds

    # ------------------------------------------------------ device time --

    def _drain(self, wait_oldest: bool = False) -> None:
        """Account the calls made on a card since the last drain (in
        order: the first call of a shape is its compile), then fold the
        device time of completed event pairs (oldest first; stops at the
        first pair still running) and return the pairs to their
        device's pool."""
        published = []
        with self._lock:
            calls, pending, kernels = self._calls, self._pending, \
                self._kernels
            while calls:
                name, key, seconds, cost, dev, start, end = calls.popleft()
                k = kernels.get(name)
                if k is not None and key in k["shapes"]:   # warm
                    k["calls"] += 1
                    k["shapes"].move_to_end(key)
                    k["dispatch_s"] += seconds
                else:
                    new, retraces = self._dispatch_locked(name, key,
                                                          seconds)
                    if new and cost is not None:
                        kernels[name]["cost"] = cost
                    if retraces is not None:
                        published.append(retraces)
                pending.append((name, dev, start, end))
            if pending:
                times = cuda_lib.events_ms([p[2:] for p in pending],
                                           wait=wait_oldest)
                for (name, dev, start, end), ms in zip(pending, times):
                    k = kernels[name]
                    k["device_s"] += ms / 1e3
                    k["device_calls"] += 1
                    self._free[dev].append((start, end))
                del pending[:len(times)]
        for retraces in published:
            self._publish(retraces)

    def _event_pair(self, dev) -> tuple:
        """(start, end) from dev's pool, new ones when it is empty."""
        pool = self._free.get(dev.index)
        if pool is None:
            with self._lock:
                pool = self._free.setdefault(dev.index, [])
        try:
            return pool.pop()
        except IndexError:      # empty, or another thread took the last
            return cuda_lib.event_create(dev), cuda_lib.event_create(dev)

    # ------------------------------------------------- auto-instrument --

    def wrap(self, name: str, fn, cost=None):
        """Instrument one kernel entry point (see module docstring)."""
        registry = self

        def dispatched(key, seconds, args, kwargs):
            with registry._lock:
                new, retraces = registry._dispatch_locked(name, key,
                                                          seconds)
            if retraces is not None:
                registry._publish(retraces)
            if new and cost is not None:
                c = cost(*args, **kwargs)
                with registry._lock:
                    registry._kernel_locked(name)["cost"] = c

        def wrapped(*args, **kwargs):
            if kwargs:
                key = (_shape_of(args),
                       _shape_of(tuple(sorted(kwargs.items()))))
                dev = _cuda_device(args) or _cuda_device(kwargs)
            else:
                key, dev = _signature(args)
            if dev is None:
                t0 = CLOCK()
                out = fn(*args, **kwargs)
                dispatched(key, CLOCK() - t0, args, kwargs)
                return out
            start, end = registry._event_pair(dev)
            stream = cuda_lib.raw_stream(dev)
            record = cuda_lib.lib().ctpu_event_record
            cuda_lib.check(record(start, stream), "ctpu_event_record")
            t0 = CLOCK()
            out = fn(*args, **kwargs)
            t1 = CLOCK()
            cuda_lib.check(record(end, stream), "ctpu_event_record")
            # the cost at a shape not seen yet (read without the lock:
            # at worst computed twice)
            k = registry._kernels.get(name)
            c = cost(*args, **kwargs) if cost is not None and (
                k is None or key not in k["shapes"]) else None
            calls = registry._calls
            calls.append((name, key, t1 - t0, c, dev.index, start, end))
            if len(calls) >= DRAIN_EVERY:
                registry._drain(
                    wait_oldest=len(registry._pending) > PENDING_CAP)
            return out

        wrapped.__name__ = getattr(fn, "__name__", name)
        wrapped.__doc__ = getattr(fn, "__doc__", None)
        wrapped.__wrapped__ = fn
        return wrapped

    # ---------------------------------------------------------- phases --

    def add_phases(self, profile: dict) -> None:
        with self._lock:
            for phase, seconds in profile.items():
                self._phases[phase] = self._phases.get(phase, 0.0) \
                    + float(seconds)

    def snapshot(self) -> dict:
        """{"kernels": {name: {calls, compiles, shapes, shape_count,
        shape_evictions, retraces, compile_s, dispatch_s, execute_s,
        device_s, device_calls, cost_bytes, cost_flops}}, "phases":
        {name: seconds}}. device_s sums the completed CUDA-event
        intervals; the costs are the most recent new shape's (None for
        a program wrapped without a cost)."""
        self._drain()
        with self._lock:
            kernels = {}
            for name, k in self._kernels.items():
                kernels[name] = {
                    "calls": k["calls"], "compiles": k["compiles"],
                    "shapes": len(k["shapes"]),
                    "shape_count": len(k["shapes"]),
                    "shape_evictions": k["shape_evictions"],
                    "retraces": k["retraces"],
                    "compile_s": round(k["compile_s"], 6),
                    "dispatch_s": round(k["dispatch_s"], 6),
                    "execute_s": round(k["execute_s"], 6),
                    "device_s": round(k["device_s"], 6),
                    "device_calls": k["device_calls"],
                    "cost_bytes": None if k["cost"] is None
                    else float(k["cost"][0]),
                    "cost_flops": None if k["cost"] is None
                    else float(k["cost"][1])}
            phases = {p: round(s, 6) for p, s in self._phases.items()}
        return {"kernels": kernels, "phases": phases}

    def reset(self) -> None:
        with self._lock:
            self._kernels.clear()
            self._phases.clear()
            for _name, dev, start, end in self._pending:
                self._free[dev].append((start, end))
            while self._calls:
                call = self._calls.popleft()
                self._free[call[4]].append(call[5:])
            self._pending.clear()

GLOBAL = DeviceProgramRegistry()
