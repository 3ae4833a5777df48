"""Continuous wall-clock sampling profiler (observability layer 6,
host half).

The metrics/ledger/SLO layers say WHICH phase or stage is slow; nothing
said which frames burned the CPU or which threads sat blocked. This
module closes that gap with a `sys._current_frames()` sampler over the
process's named daemon threads:

- **Always-on ring** (the `profiler_enabled` knob): a low-overhead
  aggregate of folded stacks that is always absorbing while any
  engine demands it. Process-global like the device-program registry —
  threads are process-wide — so the knob follows the diagnostic-bus
  DEMAND pattern: each engine's knob adds/withdraws only its own
  demand and a co-hosted engine cannot silence a peer.
- **On-demand sessions** (`nodetool profiler start/stop`): a bounded
  window with its own aggregate, independent of the knob — starting a
  session boots the sampler thread even with every knob off, stopping
  the last demand stops it. Zero cost when off: no thread exists, and
  `sample_once()` stays callable (the metric-name smoke and the flight
  recorder take moment-of captures).
- **on-CPU vs blocked** classification per sample: a thread whose LEAF
  frame sits in a blocking stdlib module (threading/queue/selectors/
  socket/ssl/subprocess) is parked on a lock, queue, poll or socket —
  `blocked`; any other leaf is presumed running — `cpu`. A documented
  approximation: C-level waits that show the caller's Python frame
  (time.sleep, native I/O) classify as cpu. The split is what
  reconciles against the pipeline ledger's busy/stall accounting
  (bench.py `profiler` section).
- **Collapsed-stack export** (`collapsed()`): Brendan-Gregg collapsed
  lines `state;thread;frame;...;leaf N`, flamegraph.pl-compatible;
  `parse_collapsed()` round-trips them (scripts/check_profiler.py
  gates it).

Aggregates are bounded: at most `STACK_CAP` distinct (state, thread,
stack) keys per aggregate; overflow folds into a per-thread
`<overflow>` bucket and is counted, so totals still reconcile.

Surfaces: `system_views.profiles`, `nodetool profiler`, the
`profile.samples` counter, the `profile` section of flight-recorder
bundles and bench.py's `profiler` attribution block.
"""
from __future__ import annotations

import sys
import threading
import time

# ctpulint: clock-injectable
# every duration in this module comes from the injected clock;
# `time.perf_counter` appears only as the production default (a
# reference, never a direct call)

from .metrics import GLOBAL as METRICS

# a leaf frame parked at one of these stdlib wait points means the
# thread is blocked on a lock / queue / selector / socket, not
# running. BOTH halves are required: module alone is not enough — hot
# loops touch threading.py constantly through non-blocking calls
# (Event.is_set, Lock.locked) that must still read as on-CPU.
_BLOCKING_TAILS = ("threading.py", "queue.py", "selectors.py",
                   "socket.py", "ssl.py", "subprocess.py")
_BLOCKING_FUNCS = frozenset((
    "wait", "wait_for", "_wait_for_tstate_lock", "join", "acquire",
    "get", "put", "select", "poll", "recv", "recv_into", "recvfrom",
    "accept", "read", "readinto", "send", "sendall", "communicate",
    "_try_wait"))

MAX_DEPTH = 48        # frames kept per stack (root-most dropped past it)
STACK_CAP = 2048      # distinct stack keys per aggregate
DONE_SESSIONS = 8     # finished session aggregates retained


def _frame_label(code) -> str:
    """`file:func` with the path collapsed to its basename — compact,
    collision-tolerant flamegraph frame names."""
    fname = code.co_filename
    slash = fname.rfind("/")
    if slash >= 0:
        fname = fname[slash + 1:]
    if fname.endswith(".py"):
        fname = fname[:-3]
    return f"{fname}:{code.co_name}"


def _sanitize(s: str) -> str:
    """Collapsed-stack field: `;` separates frames and the trailing
    space separates the count — neither may appear inside a field."""
    return str(s).replace(";", "_").replace(" ", "_")


class _Agg:
    """One bounded folded-stack aggregate (the ring, or one session).
    Mutated only under the owning profiler's lock."""

    __slots__ = ("counts", "ticks", "cpu", "blocked", "dropped")

    def __init__(self):
        self.counts: dict = {}   # (state, thread, frames) -> samples
        self.ticks = 0           # sampler ticks folded
        self.cpu = 0             # thread-samples classified on-CPU
        self.blocked = 0         # thread-samples classified blocked
        self.dropped = 0         # folds past STACK_CAP (overflow bucket)

    def fold(self, stacks) -> None:
        self.ticks += 1
        for state, tname, frames in stacks:
            if state == "cpu":
                self.cpu += 1
            else:
                self.blocked += 1
            key = (state, tname, frames)
            n = self.counts.get(key)
            if n is None and len(self.counts) >= STACK_CAP:
                self.dropped += 1
                key = (state, tname, ("<overflow>",))
                n = self.counts.get(key)
            self.counts[key] = (n or 0) + 1


class WallProfiler:
    MIN_INTERVAL_S = 0.005   # floor shared by __init__ and
    #                          set_interval: a 0-second knob must not
    #                          boot a busy-spin sampler thread

    def __init__(self, clock=time.perf_counter,
                 interval_s: float = 0.05):
        self.clock = clock
        self.interval_s = max(float(interval_s), self.MIN_INTERVAL_S)
        self._lock = threading.Lock()
        self._demands: set = set()          # engine ids wanting the ring
        self._ring = _Agg()
        self._sessions: dict[str, dict] = {}
        self._done: dict[str, dict] = {}    # finished, newest last
        self._next_sid = 0
        self.samples = 0             # lifetime sample_once() calls
        self.sample_seconds = 0.0    # cumulative capture cost (the
        #                              overhead-guard numerator)
        self._stop: threading.Event | None = None
        self._wake: threading.Event | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ config --

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def set_demand(self, owner, on) -> None:
        """The `profiler_enabled` knob landing (per-engine demand on
        this process-global sampler): flipping one engine's knob off
        withdraws only ITS demand. Ring contents survive a stop — the
        window up to it stays queryable."""
        with self._lock:
            if on:
                self._demands.add(owner)
            else:
                self._demands.discard(owner)
        self._reconcile_thread()

    def set_interval(self, seconds: float) -> None:
        """The `profiler_interval` knob: a parked sampler is woken so
        the new period applies NOW, not after the old one elapses."""
        self.interval_s = max(float(seconds), self.MIN_INTERVAL_S)
        wake = self._wake
        if wake is not None:
            wake.set()

    # ----------------------------------------------------------- sampler --

    def _want_thread(self) -> bool:
        with self._lock:
            return bool(self._demands or self._sessions)

    def _reconcile_thread(self) -> None:
        if self._want_thread():
            self._start()
        else:
            self._stop_thread()

    def _start(self) -> None:
        if self.running:
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
                        continue       # new period, no sample yet
                    self.sample_once()
                except Exception:
                    pass   # a torn frame map must not kill the sampler


        self._thread = threading.Thread(target=_run,
                                        name="wall-profiler",
                                        daemon=True)
        self._thread.start()

    def _stop_thread(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._wake is not None:
            self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._thread = None
        self._stop = None
        self._wake = None

    # ------------------------------------------------------------ sample --

    def sample_once(self) -> int:
        """Take one capture NOW (on-demand callers need no running
        sampler thread): snapshot every other thread's stack, classify
        cpu/blocked by leaf frame, fold into the ring and every live
        session. Returns the number of threads sampled."""
        t0 = self.clock()
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        stacks = []
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue   # the sampler observing itself is noise
            code = frame.f_code
            state = "blocked" \
                if (code.co_filename.endswith(_BLOCKING_TAILS)
                    and code.co_name in _BLOCKING_FUNCS) \
                else "cpu"
            frames: list = []
            f, depth = frame, 0
            while f is not None and depth < MAX_DEPTH:
                frames.append(_frame_label(f.f_code))
                f = f.f_back
                depth += 1
            frames.reverse()   # collapsed lines read root -> leaf
            stacks.append((state, _sanitize(
                names.get(ident, f"tid-{ident}")), tuple(frames)))
        with self._lock:
            self._ring.fold(stacks)
            for s in self._sessions.values():
                s["agg"].fold(stacks)
            self.samples += 1
            self.sample_seconds += max(self.clock() - t0, 0.0)
        METRICS.incr("profile.samples")
        return len(stacks)

    # ---------------------------------------------------------- sessions --

    def start_session(self, name: str | None = None) -> str:
        """Boot an on-demand profiling window (and the sampler thread,
        knob or no knob). Returns the session id `nodetool profiler
        stop/dump` take."""
        with self._lock:
            self._next_sid += 1
            sid = f"s{self._next_sid}"
            self._sessions[sid] = {"id": sid, "name": name or sid,
                                   "agg": _Agg(), "t0": self.clock()}
        self._reconcile_thread()
        return sid

    def stop_session(self, session: str | None = None) -> dict:
        """Seal a session (newest if unnamed); its aggregate stays
        dumpable among the retained finished sessions. Stopping the
        last demand parks the sampler thread."""
        with self._lock:
            if session is None:
                if not self._sessions:
                    raise ValueError("no live profiling session")
                session = next(reversed(self._sessions))
            s = self._sessions.pop(session, None)
            if s is None:
                raise ValueError(f"unknown session {session!r}")
            s["wall_s"] = max(self.clock() - s.pop("t0"), 0.0)
            self._done[session] = s
            while len(self._done) > DONE_SESSIONS:
                self._done.pop(next(iter(self._done)))
        self._reconcile_thread()
        return self.split(session)

    def _agg(self, target: str | None) -> _Agg:
        """The ring (None/"ring") or one session's aggregate, live or
        finished."""
        if target is None or target == "ring":
            return self._ring
        s = self._sessions.get(target) or self._done.get(target)
        if s is None:
            raise ValueError(f"unknown profile target {target!r}")
        return s["agg"]

    # ------------------------------------------------------------- query --

    def collapsed(self, target: str | None = None,
                  limit: int | None = None) -> list[str]:
        """Collapsed-stack flamegraph lines, hottest first:
        `state;thread;frame;...;leaf N`."""
        with self._lock:
            agg = self._agg(target)
            rows = sorted(agg.counts.items(),
                          key=lambda kv: (-kv[1], kv[0]))
        out = [";".join((state, tname) + frames) + f" {n}"
               for (state, tname, frames), n in rows]
        return out[:limit] if limit else out

    def split(self, target: str | None = None) -> dict:
        """The busy/blocked totals of one aggregate — the numbers the
        bench attribution block reconciles against the pipeline
        ledger's busy/stall split."""
        with self._lock:
            agg = self._agg(target)
            total = agg.cpu + agg.blocked
            out = {"target": target or "ring", "ticks": agg.ticks,
                   "cpu": agg.cpu, "blocked": agg.blocked,
                   "stacks": len(agg.counts), "dropped": agg.dropped,
                   "cpu_share": round(agg.cpu / total, 4)
                   if total else 0.0}
            s = self._sessions.get(target) or self._done.get(target) \
                if target not in (None, "ring") else None
            if s is not None and "wall_s" in s:
                out["wall_s"] = round(s["wall_s"], 4)
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"running": self.running,
                    "interval_s": self.interval_s,
                    "demands": len(self._demands),
                    "sessions": sorted(self._sessions),
                    "finished_sessions": sorted(self._done),
                    "samples": self.samples,
                    "sample_seconds": round(self.sample_seconds, 6),
                    "ring": {"ticks": self._ring.ticks,
                             "cpu": self._ring.cpu,
                             "blocked": self._ring.blocked,
                             "stacks": len(self._ring.counts),
                             "dropped": self._ring.dropped}}

    def reset(self) -> None:
        """Drop every aggregate (tests / bench isolation); demands,
        sessions-in-flight and the thread state are untouched."""
        with self._lock:
            self._ring = _Agg()
            for s in self._sessions.values():
                s["agg"] = _Agg()
            self._done.clear()


def parse_collapsed(lines) -> dict:
    """Round-trip a collapsed-stack dump back into totals:
    {"cpu": thread-samples, "blocked": thread-samples, "stacks": n}.
    The check_profiler.py gate asserts these equal the source
    aggregate's split()."""
    cpu = blocked = stacks = 0
    for line in lines:
        body, _, count = line.rpartition(" ")
        parts = body.split(";")
        if len(parts) < 2 or not count.isdigit():
            raise ValueError(f"bad collapsed line {line!r}")
        n = int(count)
        stacks += 1
        if parts[0] == "cpu":
            cpu += n
        elif parts[0] == "blocked":
            blocked += n
        else:
            raise ValueError(f"bad state {parts[0]!r} in {line!r}")
    return {"cpu": cpu, "blocked": blocked, "stacks": stacks}


GLOBAL = WallProfiler()
