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
      stream around the call. The events are read when they have
      completed (at the next call or at snapshot()), so the wrapper
      never synchronises.
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
from collections import OrderedDict

# patchable clock seam (the pipeline-ledger pattern): tests freeze it,
# production leaves time.perf_counter
CLOCK = time.perf_counter

SHAPE_CAP = 256
# CUDA event pairs held until they complete; beyond this the oldest is
# waited for, so an unread backlog cannot grow without bound
PENDING_CAP = 4096


def _shape_of(x):
    """Hashable shape signature of one operand tree: tensors and arrays
    collapse to (shape, dtype), containers recurse, everything else to
    its literal or type name."""
    shape = getattr(x, "shape", None)
    if shape is not None:
        return ("arr", tuple(shape), str(getattr(x, "dtype", "?")))
    if isinstance(x, dict):
        return ("dict",) + tuple(
            (k, _shape_of(v)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return ("seq",) + tuple(_shape_of(v) for v in x)
    if isinstance(x, (int, float, str, bool, type(None))):
        return ("lit", x)
    return ("obj", type(x).__name__)


def _cuda_device(x):
    """The device of the first CUDA tensor in an operand tree, or None."""
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
        self._pending: list = []      # (kernel, start event, end event)
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
        fire = compiles = retraces = None
        with self._lock:
            k = self._kernel_locked(kernel)
            k["calls"] += 1
            shapes = k["shapes"]
            if shape_key in shapes:
                shapes.move_to_end(shape_key)
                k["dispatch_s"] += seconds
                return False
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
                compiles, retraces = k["compiles"], k["retraces"]
        if retraces is not None:
            # metrics + event OUTSIDE the registry lock (publish takes
            # the bus lock; never nest foreign locks under ours)
            from .metrics import GLOBAL as METRICS
            METRICS.incr("profile.retraces")
            if fire:
                from . import diagnostics
                diagnostics.publish(
                    "profile.retrace", program=kernel,
                    compiles=compiles, budget=self.retrace_budget,
                    retraces=retraces)
        return True

    def record_execute(self, kernel: str, seconds: float) -> None:
        with self._lock:
            self._kernel_locked(kernel)["execute_s"] += seconds

    # ------------------------------------------------------ device time --

    def _drain(self, wait_oldest: bool = False) -> None:
        """Fold the device time of completed event pairs (oldest first;
        stops at the first pair still running)."""
        with self._lock:
            pending = self._pending
            done = 0
            for i, (name, start, end) in enumerate(pending):
                if i == 0 and wait_oldest:
                    end.synchronize()
                elif not end.query():
                    break
                k = self._kernel_locked(name)
                k["device_s"] += start.elapsed_time(end) / 1e3
                k["device_calls"] += 1
                done += 1
            del pending[:done]

    def _note_events(self, name: str, start, end) -> None:
        with self._lock:
            self._pending.append((name, start, end))
            full = len(self._pending) > PENDING_CAP
        self._drain(wait_oldest=full)

    # ------------------------------------------------- auto-instrument --

    def wrap(self, name: str, fn, cost=None):
        """Instrument one kernel entry point (see module docstring)."""
        registry = self

        def dispatched(key, seconds, args, kwargs):
            if registry.record_dispatch(name, key, seconds) \
                    and cost is not None:
                c = cost(*args, **kwargs)
                with registry._lock:
                    registry._kernel_locked(name)["cost"] = c

        def wrapped(*args, **kwargs):
            key = _shape_of(args) if not kwargs \
                else (_shape_of(args),
                      _shape_of(tuple(sorted(kwargs.items()))))
            dev = _cuda_device(args) or _cuda_device(kwargs)
            if dev is None:
                t0 = CLOCK()
                out = fn(*args, **kwargs)
                dispatched(key, CLOCK() - t0, args, kwargs)
                return out
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stream = torch.cuda.current_stream(dev)
            start.record(stream)
            t0 = CLOCK()
            out = fn(*args, **kwargs)
            t1 = CLOCK()
            end.record(stream)
            dispatched(key, t1 - t0, args, kwargs)
            registry._note_events(name, start, end)
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
            self._pending.clear()

GLOBAL = DeviceProgramRegistry()
