"""CompactionManager: background compaction scheduling over the
concurrent CompactionExecutor.

Reference counterpart: db/compaction/CompactionManager.java:142
(submitBackground:237, CompactionExecutor:2042, ActiveCompactions, rate
limiting via compaction_throughput). Tasks execute on the executor's N
compactor slots (`concurrent_compactors`); tests and sim/ drive the
executor's synchronous inline mode with run_pending(), so scheduling
stays deterministic there. The shared token-bucket limiter is debited by
each task per merge round (utils/ratelimit.py).

Input claiming: every task executed through the manager first CLAIMS
its input generations in a per-table registry and a task that cannot
claim all inputs is dropped (the store gets re-enqueued by the next
flush notification). The per-store cfs_lock — which serializes
selection+execution per table — is the PRIMARY overlap guard; the claim
registry is the enforced invariant behind it: it catches tasks driven
onto the executor outside the lock, keeps `compactionstats` able to
report what is being rewritten, and is what would make narrowing
cfs_lock to selection-only safe later. The reference's analog is
lifecycle transaction ownership (LifecycleTransaction.obsoletes /
Tracker.tryModify).
"""
from __future__ import annotations

import queue
import threading
from ..utils import lockwitness
import time

from ..utils.ratelimit import RateLimiter  # noqa: F401  (re-exported)
from .executor import (ActiveCompactions, CompactionExecutor,
                       CompactionProgress, record_completion)
from .strategies import get_strategy


class CompactionManager:
    def __init__(self, throughput_mib_s: float = 0.0, auto: bool = False,
                 concurrent: int = 1):
        self.limiter = RateLimiter(throughput_mib_s)
        self.active = ActiveCompactions()
        self.executor = CompactionExecutor(concurrent)
        self.auto = auto
        # nodetool disableautocompaction: queued stores stay queued,
        # nothing new runs until re-enabled
        self.paused = False
        self._queue: queue.Queue = queue.Queue()
        self._pending_cfs: set = set()
        self._lock = lockwitness.make_lock("compaction.manager")
        self._cfs_locks: dict = {}   # table_id -> rewrite mutex
        # mesh-width source for the gauges: the owning engine points
        # this at ITS settings knob (the fanout global is process-wide
        # last-writer-wins state — a co-hosted engine's knob must not
        # leak into this engine's engine-scoped metrics vtable)
        from ..parallel import fanout
        self.mesh_devices_fn = fanout.mesh_devices
        self._compacting: dict = {}  # table_id -> set of claimed gens
        self._stop = threading.Event()
        # programmatic kill switch wired onto every registered store as
        # cfs.compaction_abort: tasks poll it each round and abort (their
        # lifecycle txn rolls back). The SETTER owns clearing it — while
        # set, every new task aborts too. `nodetool stop` does not use
        # it; operator stops land per-task via stop_active()
        self.abort_event = threading.Event()
        self._worker: threading.Thread | None = None
        self.completed: list[dict] = []
        if auto:
            self._worker = threading.Thread(target=self._run_loop,
                                            daemon=True)
            self._worker.start()

    def set_throughput(self, mib_per_s: float) -> None:
        self.limiter.set_rate(mib_per_s)

    def pending_tasks(self) -> int:
        """Submissions not yet running: executor backlog + stores queued
        with the manager (the single source for every pending surface —
        compactionstats, tpstats, the metrics gauge)."""
        return self.executor.stats()["pending"] + self._queue.qsize()

    def gauges(self) -> dict:
        """Live CompactionMetrics gauges (pendingTasks/activeTasks),
        ENGINE-scoped: served through this engine's system_views.metrics
        vtable rather than the process-global registry, so multi-node
        processes (SimCluster, LocalCluster) never cross-report."""
        return {
            "compaction.active_tasks": float(len(self.active)),
            "compaction.pending_tasks": float(self.pending_tasks()),
            "compaction.throughput_mib_per_sec": self.limiter.mib_per_s,
            "compaction.mesh_devices": float(self.mesh_devices_fn()),
        }

    def set_concurrent_compactors(self, n: int) -> None:
        """nodetool setconcurrentcompactors: hot-resize the slot count."""
        self.executor.set_concurrent(n)

    # ----------------------------------------------------------- register --

    def register(self, cfs) -> None:
        """Hook the CFS flush notification (Tracker -> strategy manager
        notification path in the reference)."""
        cfs.compaction_listener = self.submit_background
        cfs.compaction_abort = self.abort_event

    def enable_auto(self) -> None:
        """Start the background worker (daemon deployments; tests keep
        auto off and drain with run_pending())."""
        if self.auto:
            return
        self.auto = True
        self._worker = threading.Thread(target=self._run_loop,
                                        daemon=True)
        self._worker.start()

    def submit_background(self, cfs) -> None:
        with self._lock:
            if cfs in self._pending_cfs:
                return
            self._pending_cfs.add(cfs)
        self._queue.put(cfs)
        if not self.auto:
            return  # tests call run_pending() explicitly

    # ------------------------------------------------------------- claims --

    def _claim(self, cfs, readers) -> bool:
        """Atomically claim the input generations; False if ANY is
        already owned by an in-flight task (overlap = stale selection)."""
        gens = {r.desc.generation for r in readers}
        with self._lock:
            claimed = self._compacting.setdefault(cfs.table.id, set())
            if gens & claimed:
                return False
            claimed |= gens
        return True

    def _release(self, cfs, readers) -> None:
        with self._lock:
            claimed = self._compacting.get(cfs.table.id)
            if claimed is not None:
                claimed -= {r.desc.generation for r in readers}

    def compacting_generations(self, cfs) -> set:
        with self._lock:
            return set(self._compacting.get(cfs.table.id, set()))

    # ------------------------------------------------------------ execute --

    def run_pending(self, max_tasks: int = 100) -> int:
        """Drain the queue synchronously (executor inline mode: tasks run
        on THIS thread, deterministically); returns tasks executed."""
        done = 0
        while done < max_tasks:
            try:
                cfs = self._queue.get_nowait()
            except queue.Empty:
                break
            with self._lock:
                self._pending_cfs.discard(cfs)
            done += self.executor.submit(self._maybe_compact, cfs,
                                         inline=True).result()
        return done

    MAX_TASKS_PER_SUBMISSION = 4  # bounds livelock if a strategy re-selects

    def cfs_lock(self, cfs) -> threading.Lock:
        """Per-store mutex serializing sstable-set rewrites: background
        compaction vs cleanup/scrub/anticompaction. Without it, a
        compaction selected before a maintenance rewrite could merge
        the REPLACED original back into the live set, resurrecting the
        cells the maintenance op dropped. Task SELECTION and execution
        must both happen under it."""
        with self._lock:
            return self._cfs_locks.setdefault(cfs.table.id,
                                              lockwitness.make_lock("compaction.cfs_rewrite"))

    def _execute_task(self, cfs, task, kind: str = "Compaction"):
        """Claim inputs, run one task with progress + throttle + metrics
        plumbing, release. Returns the stats dict, or None when the
        selection lost the claim race (caller may reselect)."""
        if not self._claim(cfs, task.inputs):
            return None
        info = CompactionProgress(
            keyspace=cfs.table.keyspace, table=cfs.table.name, kind=kind,
            total_bytes=sum(r.data_size for r in task.inputs))
        task.limiter = self.limiter
        task.progress = info
        self.active.begin(info)
        from ..service import diagnostics
        diagnostics.publish("compaction.start",
                            keyspace=cfs.table.keyspace,
                            table=cfs.table.name, kind=kind,
                            inputs=len(task.inputs),
                            bytes=info.total_bytes)
        t0 = time.monotonic()
        stats = None
        try:
            stats = task.execute()
        except BaseException as e:
            diagnostics.publish("compaction.abort",
                                keyspace=cfs.table.keyspace,
                                table=cfs.table.name, kind=kind,
                                error=repr(e))
            raise
        finally:
            self.active.finish(info)
            self._release(cfs, task.inputs)
        record_completion(stats, time.monotonic() - t0)
        self.completed.append(stats)
        diagnostics.publish("compaction.finish",
                            keyspace=cfs.table.keyspace,
                            table=cfs.table.name, kind=kind,
                            bytes_read=stats.get("bytes_read", 0),
                            bytes_written=stats.get("bytes_written", 0),
                            seconds=round(stats.get("seconds", 0.0), 3))
        return stats

    def _maybe_compact(self, cfs, locked: bool = False) -> int:
        from ..storage.sstable.reader import CorruptSSTableError
        n = 0
        lock = self.cfs_lock(cfs)
        if not locked:
            lock.acquire()
        try:
            strategy = get_strategy(cfs)
            while n < self.MAX_TASKS_PER_SUBMISSION:
                task = strategy.next_background_task()
                if task is None:
                    break
                try:
                    stats = self._execute_task(cfs, task)
                except CorruptSSTableError:
                    # the task aborted itself (txn rolled back) and —
                    # under best_effort — quarantined the rotten input.
                    # If the input left the live set, re-select: the
                    # strategy re-plans without it. If it is still
                    # live (policy ignore/stop/die), stop: re-selecting
                    # would pick the same doomed inputs forever.
                    live = {s.desc.generation for s in cfs.live_sstables()}
                    if all(r.desc.generation in live for r in task.inputs):
                        break
                    strategy = get_strategy(cfs)
                    continue
                if stats is None:
                    break   # input claimed elsewhere: drop this
                    #         selection (a later flush re-enqueues)
                n += 1
        finally:
            if not locked:
                lock.release()
        return n

    def stop_active(self) -> int:
        """`nodetool stop`: request cooperative abort of every in-flight
        task, each through ITS OWN progress handle — no shared-event
        clear can cancel a stop another slot has not polled yet."""
        return self.active.stop_all()

    def major_compaction(self, cfs) -> dict | None:
        """nodetool compact equivalent (synchronous). A prior `nodetool
        stop` never carries over: stop requests land on the in-flight
        tasks' own progress handles, and this task gets a fresh one."""
        with self.cfs_lock(cfs):
            task = get_strategy(cfs).major_task()
            if task is None:
                return None
            return self._execute_task(cfs, task, kind="Major")

    def major_compaction_async(self, cfs):
        """Submit a major compaction to a compactor slot; returns a
        CompactionFuture. While it runs, active.snapshot() / nodetool
        compactionstats report its live progress."""
        return self.executor.submit(self.major_compaction, cfs)

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            if self.paused:
                self._stop.wait(0.2)
                continue
            try:
                cfs = self._queue.get(timeout=0.5)
            except queue.Empty:
                continue
            with self._lock:
                self._pending_cfs.discard(cfs)
            try:
                # hand the store to a compactor slot: up to N stores
                # compact concurrently (same-store tasks still serialize
                # on cfs_lock). The shared abort_event is NOT cleared
                # here — that would cancel a `nodetool stop` another
                # slot's task has not polled yet; executor-era stops go
                # through per-task progress handles (stop_active)
                self.executor.submit(self._compact_bg, cfs)
            except Exception:   # background task failure must not kill loop
                import traceback
                traceback.print_exc()

    RETRY_DELAY = 0.25   # backoff when a store's lock is held elsewhere

    def _compact_bg(self, cfs) -> int:
        """Background-slot entry: try-acquire the store lock so a slot
        never PARKS behind another slot's long compaction of the same
        store (that would starve other tables of a worker); on
        contention, requeue the store after a short delay."""
        lock = self.cfs_lock(cfs)
        if not lock.acquire(blocking=False):
            t = threading.Timer(self.RETRY_DELAY,
                                lambda: self.submit_background(cfs))
            t.daemon = True
            t.start()
            return 0
        try:
            return self._maybe_compact(cfs, locked=True)
        except Exception:
            import traceback
            traceback.print_exc()
            return 0
        finally:
            lock.release()

    def close(self) -> None:
        self._stop.set()
        if self._worker:
            self._worker.join(timeout=5)
        self.executor.shutdown(wait=True, timeout=5)
