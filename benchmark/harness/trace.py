"""The traced window of a `--trace 1` run: torch.profiler over the
card, and a sampler of what the host's threads run in the program while
the card waits.

Device busy time is the union of the intervals in which a kernel, copy
or memset ran on the card, from the profiler's trace. The sampler reads
every thread's stack about every SAMPLE_S seconds and names each by the
innermost frame inside the program (`module:function`); each sample
stands for the time since the one before it, and a sample taken while
the card is busy is not counted as idle.
"""
from __future__ import annotations

import os
import sys
import threading
import time

SAMPLE_S = 0.005
_PKG = os.sep + "cassandra_tpu_torch" + os.sep
_WAITING = (os.sep + "threading.py", os.sep + "queue.py")


def _label(frame) -> str | None:
    """The innermost program frame's `module:function`, or None for a
    thread outside the program or blocked on a lock, queue or event."""
    if frame.f_code.co_filename.endswith(_WAITING):
        return None
    while frame is not None:
        path = frame.f_code.co_filename
        i = path.rfind(_PKG)
        if i >= 0:
            mod = path[i + len(_PKG):].removesuffix(".py").replace(
                os.sep, ".")
            return f"{mod}:{frame.f_code.co_name}"
        frame = frame.f_back
    return None


class Sampler:
    def __init__(self):
        # (time ns, seconds since the previous sample, labels)
        self.samples: list[tuple[int, float, tuple[str, ...]]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bench-sampler")

    def _run(self) -> None:
        me = threading.get_ident()
        names = {}
        prev = time.time_ns()
        while not self._stop.wait(SAMPLE_S):
            t = time.time_ns()
            labels = []
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                lab = _label(frame)
                if lab is None:
                    continue
                if tid not in names:
                    names = {th.ident: th.name
                             for th in threading.enumerate()}
                labels.append(f"{names.get(tid, tid)}|{lab}")
            self.samples.append((t, (t - prev) / 1e9, tuple(labels)))
            prev = t

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


class Window:
    """Profiles the card and samples the host between enter and exit."""

    def __init__(self):
        self.prof = None
        self.sampler = Sampler()
        self.t0 = self.t1 = 0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.sampler.start()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        self.sampler.stop()
        self.prof.__exit__(*exc)
        return False

    def device_events(self) -> list[tuple[int, int, str]]:
        """(start ns, end ns, name) of every operation on the card."""
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                s = int(e.start_ns())
                out.append((s, s + int(e.duration_ns()), e.name()))
        return out

    def summary(self) -> dict:
        """busy_s and window_s of the card, the seconds of each of its
        operations (`ops`), and the breakdown: the ten longest
        operations, and the host's work while the card idled."""
        events = self.device_events()
        busy = []
        for s, e, _n in sorted(events):
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        busy_s = sum(e - s for s, e in busy) / 1e9
        by_op: dict[str, float] = {}
        for s, e, n in events:
            by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e9
        idle: dict[str, float] = {}
        j = 0
        for t, dt, labels in self.sampler.samples:
            while j < len(busy) and busy[j][1] < t:
                j += 1
            if j < len(busy) and busy[j][0] <= t:
                continue
            for lab in labels:
                idle[lab] = idle.get(lab, 0.0) + dt
        top = (lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:10]])
        return {"busy_s": busy_s, "window_s": (self.t1 - self.t0) / 1e9,
                "ops": by_op, "device_ops": top(by_op),
                "idle_gaps": top(idle)}
