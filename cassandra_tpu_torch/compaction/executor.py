"""CompactionExecutor: concurrent compactor slots + active-task registry.

Reference counterparts: db/compaction/CompactionManager.java:2042
(CompactionExecutor — a JMXEnabledThreadPoolExecutor sized by
`concurrent_compactors`), db/compaction/ActiveCompactions.java (the
registry behind `nodetool compactionstats` and the
system_views.sstable_tasks virtual table) and CompactionInfo.java /
CompactionInfo.Holder (per-task progress: operation type, total/completed
bytes, unit).

Shape here:

  CompactionExecutor   N worker threads pulling from a task queue;
                       N is hot-resizable (nodetool
                       setconcurrentcompactors). `inline=True` (or
                       submit(..., inline=True)) executes on the caller
                       thread — the deterministic path sim/ and tests
                       drive; the worker pool never sees the task.
  ActiveCompactions    begin/finish registry of CompactionProgress
                       handles; snapshot() feeds nodetool
                       compactionstats, the
                       system_views.compactions_in_progress virtual
                       table and service/metrics gauges.
  CompactionProgress   mutable per-task holder the task updates as it
                       runs: phase (decode/merge/compress/io_write),
                       bytes read/written, ETA from the observed rate.

Completion statistics land in service/metrics.GLOBAL
(compaction.tasks_completed, compaction.bytes_read, ...) — the
CompactionMetrics group of the reference.
"""
from __future__ import annotations

import itertools
import threading
import time


class CompactionProgress:
    """Per-task progress holder (CompactionInfo role). The running task
    mutates it; readers take snapshot() — single attribute writes are
    atomic under the GIL, and a torn multi-field read only skews a
    progress row, never correctness."""

    _ids = itertools.count(1)

    def __init__(self, keyspace: str = "", table: str = "",
                 kind: str = "Compaction", total_bytes: int = 0):
        self.op_id = next(self._ids)
        self.keyspace = keyspace
        self.table = table
        self.kind = kind                 # OperationType
        self.total_bytes = total_bytes
        self.bytes_read = 0
        self.bytes_written = 0
        self.phase = "pending"
        self.started_at = time.time()
        self._t0 = time.monotonic()
        # `nodetool stop` lands HERE, per task (CompactionInfo.Holder
        # .stop()): a shared event cleared by one slot would silently
        # cancel a stop another slot's task had not yet polled
        self.stop_requested = False

    def request_stop(self) -> None:
        self.stop_requested = True

    def add_read(self, n: int) -> None:
        self.bytes_read += n

    def add_written(self, n: int) -> None:
        self.bytes_written += n

    def set_phase(self, phase: str) -> None:
        self.phase = phase

    def snapshot(self) -> dict:
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        read = self.bytes_read
        total = self.total_bytes
        rate = read / elapsed
        remaining = max(total - read, 0)
        eta = remaining / rate if rate > 0 and total else None
        return {
            "id": self.op_id,
            "keyspace": self.keyspace,
            "table": self.table,
            "kind": self.kind,
            "phase": self.phase,
            "total_bytes": total,
            "bytes_read": read,
            "bytes_written": self.bytes_written,
            "progress_pct": round(100.0 * read / total, 2) if total else 0.0,
            "active_seconds": round(elapsed, 3),
            "eta_seconds": round(eta, 3) if eta is not None else None,
            "started_at": self.started_at,
        }


class ActiveCompactions:
    """Registry of in-flight CompactionProgress handles
    (ActiveCompactions.java). begin/finish bracket task execution;
    snapshot() is the read surface for nodetool + virtual tables."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active: dict[int, CompactionProgress] = {}

    def begin(self, progress: CompactionProgress) -> None:
        with self._lock:
            self._active[progress.op_id] = progress

    def finish(self, progress: CompactionProgress) -> None:
        with self._lock:
            self._active.pop(progress.op_id, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._active)

    def snapshot(self) -> list[dict]:
        with self._lock:
            handles = list(self._active.values())
        return [h.snapshot() for h in handles]

    def stop_all(self) -> int:
        """Request cooperative stop of every in-flight task (`nodetool
        stop`); each aborts at its next between-rounds poll. Returns the
        number of tasks signalled."""
        with self._lock:
            handles = list(self._active.values())
        for h in handles:
            h.request_stop()
        return len(handles)


class CompactionFuture:
    """Result handle for a submitted task (the executor is stdlib-free by
    design: concurrent.futures would drag in its own shutdown semantics
    that fight the hot-resize path)."""

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._error: BaseException | None = None

    def _complete(self, result=None, error: BaseException | None = None):
        self._result = result
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise TimeoutError("compaction task still running")
        if self._error is not None:
            raise self._error
        return self._result


class CompactionExecutor:
    """N concurrent compactor slots over a shared task queue.

    Workers are plain threads (compaction work releases the GIL in its
    hot paths: native merge FFI, compression FFI, O_DIRECT writes), so
    N slots genuinely overlap on multi-core hosts and still interleave
    usefully on one core (CPU work overlaps another task's disk waits).
    """

    def __init__(self, concurrent: int = 1, name: str = "CompactionExecutor"):
        import queue

        self.name = name
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._workers: list[threading.Thread] = []
        self._target = 0
        self._active_count = 0
        self._completed = 0
        self._shutdown = False
        self.set_concurrent(max(int(concurrent), 1))

    # ---------------------------------------------------------- sizing --

    @property
    def concurrent(self) -> int:
        return self._target

    def set_concurrent(self, n: int) -> None:
        """Hot-resize the slot count (nodetool setconcurrentcompactors).
        Growing raises the target (workers spawn lazily on submit, so
        inline-only deployments — tests, sim — never carry idle
        threads); shrinking lowers it and surplus workers exit after
        their CURRENT task (or within one poll tick when idle),
        immediately, not after the queued backlog drains."""
        n = max(int(n), 1)
        with self._lock:
            if self._shutdown:
                raise RuntimeError("executor is shut down")
            self._target = n
            if self._workers:          # pool already live: grow now
                self._spawn_locked()

    def _spawn_locked(self) -> None:
        while len(self._workers) < self._target:
            w = threading.Thread(target=self._work_loop,
                                 name=f"{self.name}-w", daemon=True)
            self._workers.append(w)
            w.start()

    # ---------------------------------------------------------- submit --

    def submit(self, fn, *args, inline: bool = False) -> CompactionFuture:
        """Queue fn(*args) for a compactor slot; returns a future.
        inline=True runs it on the CALLER thread before returning — the
        synchronous mode sim/ determinism and run_pending() rely on (no
        worker-thread scheduling enters the picture)."""
        fut = CompactionFuture()
        if inline:
            self._run_one(fn, args, fut)
            return fut
        # enqueue under the lock: a shutdown() racing this submit must
        # either see the task (and fail its future) or reject it here —
        # never strand an un-completed future on an abandoned queue
        with self._lock:
            if self._shutdown:
                raise RuntimeError("executor is shut down")
            self._queue.put((fn, args, fut))
            self._spawn_locked()
        return fut

    def _run_one(self, fn, args, fut: CompactionFuture) -> None:
        with self._lock:
            self._active_count += 1
        try:
            fut._complete(result=fn(*args))
        except BaseException as e:
            fut._complete(error=e)
        finally:
            with self._lock:
                self._active_count -= 1
                self._completed += 1

    # idle poll period: the latency bound on a shrunk/shut-down worker
    # noticing it should exit while blocked on an empty queue
    POLL_SECONDS = 0.2

    def _work_loop(self) -> None:
        import queue as _queue

        me = threading.current_thread()
        while True:
            with self._lock:
                if self._shutdown or len(self._workers) > self._target:
                    if me in self._workers:
                        self._workers.remove(me)
                    return
            try:
                fn, args, fut = self._queue.get(timeout=self.POLL_SECONDS)
            except _queue.Empty:
                continue
            self._run_one(fn, args, fut)

    # ----------------------------------------------------------- stats --

    def stats(self) -> dict:
        """tpstats row (JMXEnabledThreadPoolExecutor gauges)."""
        with self._lock:
            return {"pool": self.name, "active": self._active_count,
                    "pending": self._queue.qsize(),
                    "completed": self._completed,
                    "concurrent": self._target}

    def shutdown(self, wait: bool = True, timeout: float = 10.0) -> None:
        import queue as _queue

        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            workers = list(self._workers)
            # fail queued-but-never-started tasks: their futures must
            # complete or a result() with no timeout hangs forever
            while True:
                try:
                    _fn, _args, fut = self._queue.get_nowait()
                except _queue.Empty:
                    break
                fut._complete(error=RuntimeError(
                    "executor shut down before task ran"))
        if wait:
            deadline = time.monotonic() + timeout
            for w in workers:
                w.join(timeout=max(deadline - time.monotonic(), 0.0))


def record_completion(stats: dict, seconds: float) -> None:
    """Fold one finished task into the global metrics registry
    (CompactionMetrics: totalCompactionsCompleted, bytesCompacted)."""
    from ..service.metrics import GLOBAL

    GLOBAL.incr("compaction.tasks_completed")
    GLOBAL.incr("compaction.bytes_read", int(stats.get("bytes_read", 0)))
    GLOBAL.incr("compaction.bytes_written",
                int(stats.get("bytes_written", 0)))
    GLOBAL.incr("compaction.cells_written",
                int(stats.get("cells_written", 0)))
    GLOBAL.hist("compaction.task").update_us(seconds * 1e6)
