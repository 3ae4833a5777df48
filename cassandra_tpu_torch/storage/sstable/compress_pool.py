"""Shared compressor-worker pool for the bulk write path.

The write phase of compaction and flush was, until this module, bounded
by ONE thread running the native compressor (ops/codec.py SegmentPacker
— the FFI releases the GIL, so threads genuinely scale on multi-core
hosts). LUDA (PAPERS.md, arxiv 2004.03054) makes the same observation
for GPU-resident LSM compaction: once the merge is accelerator-fast,
throughput is unlocked by parallelizing the encode/compress leg. This
pool is that leg: SSTableWriter (parallel-compress mode) submits
per-segment pack jobs here and re-sequences the results through an
ordered completion queue, so file bytes are identical to the serial
path regardless of worker count (docs/compaction-executor.md).

One process-global pool serves every writer — compaction tasks and
memtable flushes share the workers (they also share the physical
cores). Sized by the `compaction_compressor_threads` knob (0 = auto:
one worker per core, capped), hot-resizable through the settings
machinery exactly like `concurrent_compactors`: growing spawns workers
immediately, shrinking retires them after their current job. Tests and
bench sweeps construct private pools to pin the worker count.

Workers are plain daemon threads pulling closures off one queue (the
CompactionExecutor shape, compaction/executor.py); jobs are expected to
capture their own error channel — a raise out of a job is recorded but
never kills the worker.
"""
from __future__ import annotations

import os
import queue
import threading
from ...utils import lockwitness
import time


def auto_workers() -> int:
    """0 = auto resolution for compaction_compressor_threads: one
    worker per core MINUS one (the FFI compress releases the GIL so
    workers scale with real cores, but the decode/merge/serialize and
    I/O stages need a core too — measured on a 2-core box, a second
    worker oversubscribes and LOSES ~10%), capped — past the disk's
    write bandwidth extra workers only add memory pressure."""
    return max(1, min((os.cpu_count() or 2) - 1, 8))


class CompressorPool:
    """N hot-resizable worker threads over one job queue.

    submit() enqueues a zero-argument callable; ordering/backpressure
    are the CALLER's concern (SSTableWriter bounds in-flight segments
    with its pack-buffer pool and ordered completion queue). Worker
    threads spawn lazily on first submit, so writers that never enter
    parallel mode cost nothing.
    """

    # idle poll period: how long a surplus/shut-down worker can linger
    # blocked on an empty queue before noticing it should exit
    POLL_SECONDS = 0.2

    def __init__(self, workers: int = 1, name: str = "compress"):
        self.name = name
        self._q: queue.Queue = queue.Queue()
        self._lock = lockwitness.make_lock("compress_pool.pool")
        self._workers: list[threading.Thread] = []
        self._target = max(int(workers), 1)
        self._shutdown = False
        self._jobs = 0
        # unified pipeline ledger stage: worker-side busy seconds +
        # jobs, inbound-queue high-water at submit. Every pool
        # (shared or pinned) accumulates into the one process stage —
        # they share the physical cores anyway.
        from ...utils import pipeline_ledger
        self._stage = pipeline_ledger.ledger("compress_pool") \
            .stage("pack")

    # ---------------------------------------------------------- sizing --

    @property
    def workers(self) -> int:
        return self._target

    def set_workers(self, n: int) -> None:
        """Hot-resize (nodetool/settings: compaction_compressor_threads).
        Growing spawns immediately when the pool is live; shrinking
        retires surplus workers after their CURRENT job — a mid-flight
        compaction keeps draining, just on fewer threads."""
        n = max(int(n), 1)
        with self._lock:
            if self._shutdown:
                raise RuntimeError("compressor pool is shut down")
            self._target = n
            if self._workers:
                self._spawn_locked()

    def _spawn_locked(self) -> None:
        while len(self._workers) < self._target:
            w = threading.Thread(target=self._work_loop,
                                 name=f"{self.name}-w", daemon=True)
            self._workers.append(w)
            w.start()

    # ---------------------------------------------------------- submit --

    def submit(self, fn) -> None:
        """Queue fn() for a worker. fn must trap its own exceptions
        into its result slot (SSTableWriter._PackJob.error) — the pool
        only guarantees fn runs exactly once."""
        with self._lock:
            if self._shutdown:
                raise RuntimeError("compressor pool is shut down")
            self._q.put(fn)
            self._stage.note_queue(self._q.qsize())
            self._spawn_locked()

    def queue_depth(self) -> int:
        return self._q.qsize()

    def try_run_one(self) -> bool:
        """Caller work-stealing: pop ONE queued job and run it on the
        calling thread; False when the queue is empty. A producer
        blocked on the pipeline's backpressure (exhausted pack-buffer
        pool, outcome-stream lag, the finish() drain) is an idle core
        standing next to a queue of compress work — stealing turns that
        stall into throughput with ZERO oversubscription, because the
        thread was provably not doing anything else. Output bytes are
        unaffected: jobs produce the same result on any thread and the
        writer's ordered completion queue re-sequences them regardless
        of who ran them."""
        try:
            fn = self._q.get_nowait()
        except queue.Empty:
            return False
        t0 = time.perf_counter()
        try:
            fn()
        except BaseException:
            pass   # jobs own their error channel (see _work_loop)
        finally:
            self._stage.add_busy(time.perf_counter() - t0)
            self._stage.add_items(1)
            with self._lock:
                self._jobs += 1
        return True

    @property
    def jobs_completed(self) -> int:
        return self._jobs

    def _work_loop(self) -> None:
        me = threading.current_thread()
        while True:
            with self._lock:
                if self._shutdown or len(self._workers) > self._target:
                    if me in self._workers:
                        self._workers.remove(me)
                    return
            try:
                fn = self._q.get(timeout=self.POLL_SECONDS)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            try:
                fn()
            except BaseException:
                # jobs own their error channel; a raise here is a job
                # bug, and one bad job must not retire a shared worker
                pass
            finally:
                self._stage.add_busy(time.perf_counter() - t0)
                self._stage.add_items(1)
                with self._lock:
                    self._jobs += 1

    def shutdown(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._shutdown = True
            workers = list(self._workers)
        # run never-started jobs inline: exiting workers do not drain
        # the queue, and a stranded job would leave its writer's
        # ordered completion thread parked on ready.wait() forever —
        # jobs trap their own errors into their slots, so completing
        # them here always unblocks a mid-flight writer
        while True:
            try:
                fn = self._q.get_nowait()
            except queue.Empty:
                break
            try:
                fn()
            except BaseException:
                pass
        for w in workers:
            w.join(timeout=timeout)


# ---------------------------------------------------------- global pool --

_LOCK = lockwitness.make_lock("compress_pool.registry")
_GLOBAL: CompressorPool | None = None


def get_pool() -> CompressorPool:
    """The process-global pool every parallel-compress writer shares.
    Created on first use at auto size; `compaction_compressor_threads`
    (engine settings listener) resizes it live."""
    global _GLOBAL
    with _LOCK:
        if _GLOBAL is None:
            _GLOBAL = CompressorPool(auto_workers(),
                                     name="sstable-compress")
            _register_gauges(_GLOBAL)
        return _GLOBAL


def configure(n: int) -> None:
    """Apply the compaction_compressor_threads knob: 0 = auto."""
    n = int(n)
    get_pool().set_workers(n if n > 0 else auto_workers())


def _register_gauges(pool: CompressorPool) -> None:
    from ...service.metrics import GLOBAL

    GLOBAL.register_gauge("compress_pool.workers",
                          lambda: float(pool.workers))
    GLOBAL.register_gauge("compress_pool.queue_depth",
                          lambda: float(pool.queue_depth()))
    GLOBAL.register_gauge("compress_pool.jobs_completed",
                          lambda: float(pool.jobs_completed))
