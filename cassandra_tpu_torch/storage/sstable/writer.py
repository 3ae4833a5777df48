"""SSTable writer: sorted CellBatches -> ctpu components.

Reference counterpart: io/sstable/format/SortedTableWriter.java:76 (append
loop), io/compress/CompressedSequentialWriter.java:43 (chunk+CRC write
path), BigTableWriter.java:237-254 (bloom + index build during append).

The writer consumes *sorted* batches (flush output or merge-kernel output),
cuts fixed-size segments, compresses each segment's three blocks through
the table codec's batch API (one FFI crossing per segment), and maintains
the bloom filter / partition directory / stats as it goes.

Write-leg staging (docs/compaction-executor.md):

  serial        compress + write on the caller thread.
  threaded_io   compressed segments stage through a bounded queue to a
                dedicated I/O thread (compress k+1 overlaps write k).
  parallel      compress_pool= set: segments compress CONCURRENTLY on a
                shared worker pool (ops/codec.py native calls release
                the GIL) and re-sequence through the ordered completion
                queue drained by the I/O thread — file bytes identical
                to the serial path for ANY pool size (the adaptive-skip
                decisions run on a fixed SKIP_DECISION_LAG outcome
                stream, see _decide_attempt). Requires the fused native
                packer; encrypted tables / codecs without a native id
                silently keep the serial per-block chain.
"""
from __future__ import annotations

import json
import mmap
import os
import queue
import struct
import threading
import time
import zlib

import numpy as np

from ...ops.codec import CompressionParams, SegmentPacker, lanes_shuffle
from ...schema import TableMetadata
from ...utils import bloom, faultfs
from ..cellbatch import CellBatch
from .format import SEGMENT_CELLS, Component, Descriptor


# test seam: per-segment delay hook run by pool workers before packing
# (tests/test_parallel_compress.py forces adversarial completion order
# to prove the ordered queue re-sequences); None in production.
_TEST_SEGMENT_DELAY = None

# sentinel on the outcome stream: the completion stage died — wake a
# producer parked in _decide_attempt so it surfaces the error
_ACCT_FAILED = object()


class _PackJob:
    """One segment's compress work in flight between the producer, a
    CompressorPool worker and the writer's ordered completion (I/O)
    thread. The worker fills total/sizes/crcs (or error) and sets
    ready; the completion thread consumes jobs in submit order."""

    __slots__ = ("seq", "blocks", "attempt", "buf", "n", "raw_lens",
                 "lane_head", "lane_tail", "total", "sizes", "crcs",
                 "compress_s", "error", "ready", "trace")

    def __init__(self, seq: int, blocks: list, attempt: list[bool],
                 buf: "np.ndarray", n: int, lane_head: bytes,
                 lane_tail: bytes):
        self.seq = seq
        self.blocks = blocks
        self.attempt = attempt
        self.buf = buf
        self.n = n
        self.raw_lens = [b.nbytes for b in blocks]
        self.lane_head = lane_head
        self.lane_tail = lane_tail
        self.total = 0
        self.sizes = None
        self.crcs = None
        self.compress_s = 0.0
        self.error: BaseException | None = None
        self.ready = threading.Event()
        self.trace = None   # active TraceState at submit, if any


def build_meta_block(ts: "np.ndarray", ldt: "np.ndarray",
                     ttl: "np.ndarray", flags: "np.ndarray",
                     frame_len: "np.ndarray", val_rel: "np.ndarray"
                     ) -> "np.ndarray":
    """The "ce" META block: ts-delta 8 + ldt 4 + ttl 4 + flags 1 +
    frame_len u32 + val_rel u32 = 25 B/cell. The ts lane is stored as
    per-segment wraparound deltas (first cell absolute; format.py "ce")
    — mod-2^64 arithmetic, so the reader's cumsum rebuild is exact for
    any i64 timestamps. ONE definition of the layout: the host write
    path serializes through here and the device fused-serialize kernel
    (ops/device_write.py) is pinned byte-identical to it by test."""
    n = len(ts)
    tsd = np.empty(n, dtype=np.int64)
    if n:
        tsd[0] = ts[0]
        np.subtract(ts[1:], ts[:-1], out=tsd[1:])
    meta = np.empty(n * 25, dtype=np.uint8)
    pos = 0
    for arr, width in ((tsd, 8),
                       (ldt.astype("<i4", copy=False), 4),
                       (ttl.astype("<i4", copy=False), 4),
                       (flags.astype("u1", copy=False), 1),
                       (frame_len, 4), (val_rel, 4)):
        end = pos + n * width
        meta[pos:end] = np.ascontiguousarray(arr).view(np.uint8)
        pos = end
    return meta


def _part_starts(lanes_c: "np.ndarray", n: int) -> "np.ndarray":
    """Row indices where the partition (first 4 lanes) changes — native
    single pass with a numpy fallback."""
    try:
        from ...ops.native import build as native_build
        lib = native_build.load()
        out = np.empty(n, dtype=np.int64)
        import ctypes
        cnt = lib.part_boundaries(
            lanes_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            n, lanes_c.shape[1],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out[:cnt]
    except Exception:
        part_new = np.ones(n, dtype=bool)
        part_new[1:] = (lanes_c[1:, :4] != lanes_c[:-1, :4]).any(axis=1)
        return np.flatnonzero(part_new)


class SSTableWriter:
    # trickle fsync (conf trickle_fsync role), used by the BUFFERED
    # fallback path only: push dirty pages to disk WHILE later segments
    # compress/serialize, so the commit-time fsync only pays for the tail.
    TRICKLE_FSYNC_BYTES = 16 << 20
    # block preallocation ahead of the write cursor: avoids the
    # delayed-allocation path (and fragmentation) on every extend.
    PREALLOC_BYTES = 32 << 20
    # Data.db is written O_DIRECT through an aligned bounce buffer.
    # Rationale (measured on this box): buffered writes interleaved with
    # compression CPU work collapse to ~60-90 MiB/s under kernel dirty-
    # page throttling (state-dependent, not controllable from userspace),
    # while O_DIRECT runs at ~700 MiB/s steady and leaves the final fsync
    # nearly free because data blocks are already on disk. It also keeps
    # compaction output from evicting the read-path page cache — the
    # reference wants the same and uses posix_fadvise/direct IO options
    # (io/util/SequentialWriterOption, conf commitlog_disk_access_mode).
    DIRECT_ALIGN = 4096
    BOUNCE_BYTES = 8 << 20

    # bounded staging queue for the threaded-I/O mode: compression of
    # segment k+1 overlaps the disk write of segment k; 4 buffers bound
    # the memory held and give backpressure when the disk falls behind
    IO_QUEUE_DEPTH = 4
    # parallel-compress mode: up to this many segments in flight through
    # the pool + ordered completion queue (each holds one pack buffer —
    # the memory bound — and gives the pool its concurrency headroom)
    PARALLEL_QUEUE_DEPTH = 8
    # the adaptive-compression-skip machine decides segment k's attempt
    # flags from the outcomes of segments <= k - LAG (both serial and
    # parallel paths): a FIXED lag makes the decision sequence — and so
    # every stored byte — identical for any compressor pool size, while
    # letting the pool keep LAG segments in flight without stalling.
    SKIP_DECISION_LAG = 8

    def __init__(self, descriptor: Descriptor, table: TableMetadata,
                 estimated_partitions: int = 1024,
                 segment_cells: int = SEGMENT_CELLS,
                 prof: dict | None = None,
                 threaded_io: bool = False,
                 compress_pool=None,
                 metrics_group: str | None = None,
                 device_compress=False):
        """prof: optional dict accumulating per-phase wall seconds
        ('compress' = compress+CRC — plus serialization when no pool;
        'serialize' = block prep when a pool carries the compress leg;
        'io_write' = fd writes).
        threaded_io: stage compressed segments through a bounded queue
        drained by a dedicated I/O thread, so compression of the next
        segment overlaps the previous segment's disk write (the write
        stage of the compaction pipeline; see compaction/executor.py).
        compress_pool: a compress_pool.CompressorPool — segments
        compress concurrently on its workers and re-sequence through
        the ordered completion queue (implies threaded_io). Output is
        byte-identical to the serial path for any worker count. Falls
        back to the serial chain when the fused native packer is
        unavailable (encrypted tables, codecs without a native id).
        metrics_group: service/metrics group prefix ('compaction',
        'flush') for the compress-stage queue-depth/stall metrics.
        device_compress: bool or zero-arg callable — whether the
        device-resident write lane (ops/device_write.py) should hand
        this writer segments it already compressed on-device. A
        callable is re-read PER SEGMENT, so a mid-compaction
        `compaction_device_compress` knob flip takes effect at the
        next segment boundary; output bytes are identical either way
        (the device runs the same deterministic policy encoder as the
        native packer)."""
        self.desc = descriptor
        self.table = table
        self.prof = prof
        self.params: CompressionParams = table.params.compression
        self.compressor = self.params.compressor_or_noop()
        self.segment_cells = segment_cells
        self.K = None  # lanes, learned from first batch
        # fused native write path (ops/native/codec.cpp segment_pack):
        # one GIL-released call per segment does delta+compress+CRC+copy.
        # Encrypted tables keep the per-block Python chain (the AES-CTR
        # keystream lives in storage/encryption.py).
        self._packer = None if getattr(table.params, "encryption", False) \
            else SegmentPacker.create(self.compressor)
        self._pack_out: np.ndarray | None = None
        self._cpool = compress_pool if self._packer is not None else None
        if self._cpool is not None:
            threaded_io = True
        # device-side block compression gate (bool or callable; the
        # lane consults it through _device_compress_now per segment)
        self.device_compress = device_compress if self._packer is not None \
            else False
        self._threaded_io = threaded_io
        self._io_thread: threading.Thread | None = None
        self._io_error: list[BaseException] = []
        self._wq = None
        self._metrics = None
        self._ledger = None
        if metrics_group:
            from ...service.metrics import GLOBAL as _METRICS
            self._metrics = _METRICS.group(metrics_group)
            # unified pipeline ledger (utils/pipeline_ledger.py): the
            # write leg's stages accumulate process-wide under the
            # pipeline named after the metrics group — serialize /
            # compress / io_write busy seconds, producer stalls and the
            # staging-queue high-water all land there
            from ...utils import pipeline_ledger
            led = pipeline_ledger.ledger(metrics_group)
            self._ledger = {
                "serialize": led.stage("serialize"),
                "compress": led.stage("compress"),
                "io_write": led.stage("io_write"),
            }
        if threaded_io:
            # pack-buffer pool: the compress stage packs segment k+1
            # into a free buffer while the I/O thread drains segment k
            # — ZERO copies between stages (ownership travels through
            # the queue and returns here). 2 buffers double-buffer the
            # serial compress thread; parallel mode carries one per
            # in-flight segment plus the one being written.
            depth = self.PARALLEL_QUEUE_DEPTH if self._cpool is not None \
                else self.IO_QUEUE_DEPTH
            self._wq = queue.Queue(maxsize=depth)
            self._pack_free: queue.Queue = queue.Queue()
            n_bufs = depth + 1 if self._cpool is not None else 2
            for _ in range(n_bufs):
                self._pack_free.put(np.empty(0, dtype=np.uint8))

        os.makedirs(descriptor.directory, exist_ok=True)
        data_path = descriptor.tmp_path(Component.DATA)
        self._data_path = data_path   # flush.write fault checkpoint id
        self._direct = True
        try:
            self._data_fd = os.open(
                data_path,
                os.O_WRONLY | os.O_CREAT | os.O_TRUNC | os.O_DIRECT, 0o644)
        except OSError:       # fs without O_DIRECT: buffered + trickle
            self._direct = False
            self._data_fd = os.open(
                data_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        # unbuffered FileIO over the fd: segment blocks are MB-sized
        # memoryviews already — BufferedWriter would only add a copy
        self._data = open(self._data_fd, "wb", buffering=0, closefd=True)
        if self._direct:
            # page-aligned bounce buffer (mmap is always page-aligned);
            # O_DIRECT requires aligned address, offset and length
            self._bounce = mmap.mmap(-1, self.BOUNCE_BYTES)
            self._bounce_mv = memoryview(self._bounce)
            self._bounce_fill = 0
        self._data_crc = 0
        self._data_off = 0
        self._written_off = 0   # bytes actually handed to the fd (the
        #                         I/O thread's cursor in threaded mode)
        self._allocated = 0
        self._index_entries: list[bytes] = []
        self._bloom = bloom.BloomFilter.create(max(estimated_partitions, 16))
        # partition directory accumulators
        self._part_lane4: list[bytes] = []
        self._part_first_cell: list[int] = []
        self._part_pk: list[bytes] = []
        self._last_lane4: bytes | None = None
        # adaptive compression skip, per block stream (meta/lanes/payload):
        # after 4 consecutive raw-stored blocks the next 15 skip the
        # compression attempt entirely, then one probe re-checks. Random
        # blob values (the stress default) store ~every payload block raw,
        # so attempting LZ4 on them was pure CPU waste; compressible
        # streams never enter skip mode. Chunk-granular analog of lz4's
        # own acceleration heuristic. Decisions consume the outcome
        # stream with a fixed SKIP_DECISION_LAG (see _decide_attempt).
        self._raw_streak = [0, 0, 0]
        self._skip_left = [0, 0, 0]
        self._acct_outcomes: queue.SimpleQueue = queue.SimpleQueue()
        self._seq_submitted = 0   # segments whose attempt flags are decided
        self._seq_applied = 0     # outcomes folded into the skip machine
        # monotonic published copy of _data_off: safe to read from any
        # thread (compaction's output-roll check) regardless of which
        # thread owns the real cursor in the current mode
        self._published_off = 0
        self._ck_fits = True   # AND over appended batches' ck_fits_prefix
        # TDE: encrypted tables XOR the on-disk stream with an AES-CTR
        # keystream at its file offset; CRCs/digest cover the CIPHERTEXT
        # so integrity checks don't need keys (storage/encryption.py)
        self._enc = None
        if getattr(table.params, "encryption", False):
            from .. import encryption as enc_mod
            ctx = enc_mod.get_context()
            if ctx is None:
                raise enc_mod.EncryptionError(
                    f"table {table.keyspace}.{table.name} requires "
                    f"encryption but no EncryptionContext is installed")
            self._enc = (ctx, ctx.current_key_id,
                         {c: ctx.new_nonce()
                          for c in (Component.DATA, Component.INDEX,
                                    Component.PARTITIONS)})
        # pending cells not yet cut into a segment
        self._pending: list[CellBatch] = []
        self._pending_cells = 0
        self._total_cells = 0
        # flush/compaction-time zone maps (index/sstable_index.py ZMP1):
        # _emit_segment accumulates per-segment per-column min/max scan
        # keys + live/dead counts on the appending thread (covers the
        # serial, pooled and device-packed legs alike); finish() writes
        # the component. Encrypted tables skip it — plaintext bounds
        # would leak TDE data.
        self._zone_cols = None   # resolved lazily from the table schema
        self._zone_acc: list | None = [] if self._enc is None else None
        self._stats = {
            "min_ts": None, "max_ts": None, "min_ldt": None, "max_ldt": None,
            "tombstones": 0,
        }
        self.level = 0   # LCS level (recorded in Statistics.db)
        # repairedAt epoch millis; 0 = unrepaired (reference
        # StatsMetadata.repairedAt — the repaired/unrepaired compaction
        # split and incremental repair key off this)
        self.repaired_at = 0
        self._finished = False
        self._sync_req = threading.Event()
        self._sync_stop = False
        self._sync_error: OSError | None = None
        self._bytes_since_sync = 0
        # started lazily on the first threshold crossing: small writers
        # (memtable flushes, mesh shards) never pay thread create/join,
        # and an abandoned writer (caller crashed before finish/abort)
        # leaks nothing
        self._syncer: threading.Thread | None = None

    # ---------------------------------------------------------------- api --

    def append(self, batch: CellBatch) -> None:
        """Append a sorted batch; cells must follow all previously appended
        cells in identity-lane order (enforced cheaply at segment cut)."""
        if len(batch) == 0:
            return
        if self.K is None:
            self.K = batch.n_lanes
        assert batch.n_lanes == self.K
        self._ck_fits = self._ck_fits and batch.ck_fits_prefix
        self._pending.append(batch)
        self._pending_cells += len(batch)
        while self._pending_cells >= self.segment_cells:
            self._cut_segment(self.segment_cells)

    def data_offset(self) -> int:
        """Data.db bytes committed by the write pipeline so far — the
        cross-thread-safe progress/roll-check surface (compaction's
        output-size cut-over reads this from its merge-feed thread
        while another thread advances the file). Monotonic; in
        parallel-compress mode it trails appends by the in-flight
        segments, so size-based rolls land a bounded overshoot late."""
        return self._published_off

    def finish(self) -> dict:
        """Flush remaining cells, write all components, atomically rename.
        Returns the stats dict."""
        assert not self._finished
        while self._pending_cells > 0:
            self._cut_segment(min(self.segment_cells, self._pending_cells))
        if self.K is None:
            self.K = 13
        self._stop_io_thread()   # drain staged segments, surface errors
        self._stop_syncer()   # join BEFORE the final fsync + close
        if self._sync_error is not None:
            raise self._sync_error
        if self._direct:
            self._flush_bounce(final=True)
        self._data.flush()
        # drop alignment padding / unused preallocation before the
        # commit-point rename
        os.ftruncate(self._data.fileno(), self._data_off)
        os.fsync(self._data.fileno())
        self._data.close()
        if self._direct:
            self._bounce_mv.release()
            self._bounce.close()

        self._write_index()
        self._write_partitions()
        self._write_filter()
        stats = self._write_stats()
        self._write_digest()
        self._write_zonemap()
        comps = list(Component.ALL)
        if self._enc is not None:
            _ctx, kid, nonces = self._enc
            with open(self.desc.tmp_path(Component.ENCRYPTION), "w") as f:
                json.dump({"key_id": kid,
                           "nonces": {c: n.hex()
                                      for c, n in nonces.items()}}, f)
                f.flush()
                os.fsync(f.fileno())
            comps.insert(-1, Component.ENCRYPTION)
        # TOC last, then atomic renames (TOC rename LAST = commit point).
        # Every component is fsynced before its rename and the directory
        # is fsynced after the TOC rename — otherwise a crash can persist
        # the commit point over truncated/unrenamed components.
        with open(self.desc.tmp_path(Component.TOC), "w") as f:
            f.write("\n".join(comps) + "\n")
            f.flush()
            os.fsync(f.fileno())
        # fsync the components CONCURRENTLY (os.fsync releases the GIL, so
        # the per-file device-flush latencies overlap in the disk queue —
        # serially they cost ~20ms each). Data.db was already fsynced
        # above; TOC in its own write block.
        to_sync = [self.desc.tmp_path(c) for c in comps
                   if c not in (Component.TOC, Component.DATA)]
        sync_errs: list[OSError] = []

        def _sync(p):
            try:
                self._fsync_path(p)
            except OSError as e:
                sync_errs.append(e)

        if len(to_sync) > 1:
            ts = [threading.Thread(target=_sync, args=(p,))
                  for p in to_sync]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
        else:
            for p in to_sync:
                _sync(p)
        if sync_errs:
            raise sync_errs[0]
        for comp in comps:
            if comp != Component.TOC:
                os.replace(self.desc.tmp_path(comp), self.desc.path(comp))
        # component renames must be durable BEFORE the TOC commit point
        # lands, and the TOC rename itself needs a second dir sync
        self._fsync_path(self.desc.directory)
        os.replace(self.desc.tmp_path(Component.TOC),
                   self.desc.path(Component.TOC))
        self._fsync_path(self.desc.directory)
        self._finished = True
        return stats

    def _ensure_alloc(self, end: int) -> None:
        if end <= self._allocated:
            return
        new_alloc = end + self.PREALLOC_BYTES
        try:
            os.posix_fallocate(self._data.fileno(), self._allocated,
                               new_alloc - self._allocated)
            self._allocated = new_alloc
        except OSError:
            # fs without fallocate support: fall back to plain extend
            self._allocated = 1 << 62

    def _acct(self, key: str, dt: float) -> None:
        if self.prof is not None:
            self.prof[key] = self.prof.get(key, 0.0) + dt
        if self._ledger is not None:
            st = self._ledger.get(key)
            if st is not None:
                st.add_busy(dt)

    def _write_all(self, mv: memoryview, reclaim=None) -> None:
        """Hand a compressed run of bytes to the data file. In threaded
        mode ownership of `reclaim` (the pack scratch backing mv) moves
        to the I/O thread and returns via the free pool — zero copy;
        without a reclaimable buffer the bytes are copied onto the
        queue. Otherwise written synchronously."""
        if self._threaded_io:
            if self._io_error:
                raise self._io_error[0]   # fail the producer fast
            if self._io_thread is None:
                self._io_thread = threading.Thread(
                    target=self._io_loop, name="sstable-io", daemon=True)
                self._io_thread.start()
            self._wq.put((mv if reclaim is not None else bytes(mv),
                          reclaim))
            if self._ledger is not None:
                self._ledger["io_write"].note_queue(self._wq.qsize())
            return
        t0 = time.perf_counter()
        self._write_sync(mv)
        self._acct("io_write", time.perf_counter() - t0)

    def _steal_wait(self, take_nowait, take_blocking):
        """Producer-side wait with caller work-stealing: while the
        wanted resource is unavailable, run queued pack jobs inline
        (CompressorPool.try_run_one) instead of sleeping — the blocked
        producer is an idle core and the jobs it runs are exactly what
        unblocks it. Returns (value, genuine_stall_seconds): time spent
        stealing is compress BUSY work (billed by the pool's pack
        stage), not backpressure, so only the blocking remainder counts
        as stall."""
        stall = 0.0
        while True:
            try:
                return take_nowait(), stall
            except queue.Empty:
                pass
            if self._io_error:
                raise self._io_error[0]
            if self._cpool is not None and self._cpool.try_run_one():
                continue
            t0 = time.perf_counter()
            try:
                return take_blocking(), \
                    stall + time.perf_counter() - t0
            except queue.Empty:
                stall += time.perf_counter() - t0

    def _take_pack_buf(self, need: int) -> "np.ndarray":
        """Borrow a pack buffer from the free pool (blocks when all are
        in flight — the pipeline's backpressure), growing it if this
        segment needs more room. An empty pool means the producer
        outran compress+disk: it steals queued pack jobs while waiting
        and the un-stolen remainder counts as a compress-stage stall."""
        try:
            buf = self._pack_free.get_nowait()
        except queue.Empty:
            if self._metrics is not None:
                self._metrics.incr("compress_stalls")
            buf, dt = self._steal_wait(
                self._pack_free.get_nowait,
                lambda: self._pack_free.get(timeout=0.05))
            if dt > 0 and self.prof is not None:
                # producer wall genuinely blocked on the write leg —
                # bench.py's write_phase attribution reads this
                self.prof["write_stall"] = \
                    self.prof.get("write_stall", 0.0) + dt
            if self._metrics is not None and dt > 0:
                self._metrics.hist("compress_stall").update_us(dt * 1e6)
                if self._ledger is not None:
                    # producer blocked on the compress+io stages: the
                    # backpressure seconds the ledger attributes to the
                    # stage being waited ON
                    self._ledger["compress"].add_stall(dt)
        if buf.nbytes < need:
            buf = np.empty(need, dtype=np.uint8)
        return buf

    # ------------------------------------------- adaptive-skip decisions --

    def _decide_attempt(self) -> list[bool]:
        """Attempt-compression flags for the next segment's three block
        streams. The skip machine folds in COMPLETED outcomes strictly
        lagged SKIP_DECISION_LAG segments behind the decision point —
        in serial mode every outcome is long since available; in
        parallel mode the lag is exactly the pipeline depth the pool
        may run ahead. Because both modes fold the same (decision_k,
        outcome_{k-LAG}) sequence, the decisions — and therefore the
        stored bytes — are identical for any pool size."""
        k = self._seq_submitted
        stall_s = 0.0
        stalled = False
        while self._seq_applied <= k - self.SKIP_DECISION_LAG:
            if self._io_error:
                raise self._io_error[0]
            try:
                out = self._acct_outcomes.get_nowait()
            except queue.Empty:
                # genuine lag: LAG segments in flight, oldest not done —
                # steal queued pack jobs while waiting (the oldest job
                # may be sitting un-started in the pool queue)
                if not stalled:
                    stalled = True
                    if self._metrics is not None:
                        self._metrics.incr("compress_stalls")
                out, dt = self._steal_wait(
                    self._acct_outcomes.get_nowait,
                    lambda: self._acct_outcomes.get(timeout=0.05))
                stall_s += dt
            if out is _ACCT_FAILED:
                raise self._io_error[0] if self._io_error else \
                    RuntimeError("compress pipeline failed")
            self._apply_outcome(out)
            self._seq_applied += 1
        if stall_s > 0:
            if self.prof is not None:
                self.prof["write_stall"] = \
                    self.prof.get("write_stall", 0.0) + stall_s
            if self._ledger is not None:
                self._ledger["compress"].add_stall(stall_s)
        attempt = []
        for i in range(3):
            if self._skip_left[i] > 0:
                self._skip_left[i] -= 1
                attempt.append(False)
            else:
                attempt.append(True)
        self._seq_submitted += 1
        return attempt

    def _apply_outcome(self, outcome) -> None:
        """Fold one segment's (stored, raw_len, attempted) per-stream
        outcome into the skip machine. A POOR ratio counts toward the
        skip streak — e.g. zstd squeezes 4.5% out of random framed
        blobs at ~155 MiB/s; 26ms per segment to save 4.5% is a bad
        trade. A raw store always satisfies the ratio test."""
        for i, (stored, raw_len, attempted) in enumerate(outcome):
            if not attempted:
                continue
            if stored * 10 > raw_len * 9:
                self._raw_streak[i] += 1
                if self._raw_streak[i] >= 4:
                    self._skip_left[i] = 15
            else:
                self._raw_streak[i] = 0

    def _fold_block(self, stored: int, raw_len: int, crc: int) -> bytes:
        """Per-block sequential bookkeeping: the index-entry triple and
        the digest fold (digest = crc32 over the per-block crc words —
        every byte is covered via its block crc without a second full
        pass). Runs on whichever single thread owns segment order in
        the current mode (producer, or the ordered completion loop)."""
        self._data_crc = zlib.crc32(struct.pack("<I", crc),
                                    self._data_crc)
        return struct.pack("<QQI", stored, raw_len, crc)

    def _device_compress_now(self) -> bool:
        """Whether the NEXT segment should arrive device-compressed:
        the gate the device write lane consults per segment. Callable
        gates (the hot-reloadable `compaction_device_compress` knob)
        re-read here, so a mid-compaction flip moves the compress work
        between device and host at a segment boundary without touching
        output bytes. Only the LZ4 policy codec has a device twin."""
        dc = self.device_compress
        if not dc:
            return False
        if self._packer is None or getattr(self._packer, "_cid", 0) != 1:
            return False
        return bool(dc() if callable(dc) else dc)

    # --------------------------------------------- parallel compress leg --

    def _submit_pack(self, blocks: list, attempt: list[bool],
                     need: int, n: int, lane_head: bytes,
                     lane_tail: bytes) -> None:
        """Hand one segment to the compressor pool; its index entry,
        digest fold and disk write happen on the ordered completion
        thread when its turn comes."""
        if self._io_error:
            raise self._io_error[0]   # fail the producer fast
        if self._io_thread is None:
            self._io_thread = threading.Thread(
                target=self._io_loop, name="sstable-io", daemon=True)
            self._io_thread.start()
        buf = self._take_pack_buf(need)
        if self._ledger is not None:
            self._ledger["compress"].add_items(1, need)
        job = _PackJob(self._seq_submitted - 1, blocks, attempt, buf,
                       n, lane_head, lane_tail)
        if self._metrics is not None:
            # per-consumer segment counter + stall hist live here;
            # queue depth is the POOL's gauge (compress_pool.queue_depth)
            # — a histogram of a dimensionless depth would come out
            # log2-quantized under a _us unit
            self._metrics.incr("compress_segments")
        # pack jobs become trace events when the producing statement is
        # traced (an inline threshold flush under a traced write): the
        # submit lands here, the completion on the ordered I/O thread
        from ...service import tracing
        job.trace = tracing.active()
        if job.trace is not None:
            job.trace.add(f"Compress pool: segment {job.seq} submitted "
                          f"({job.n} cells)")
        self._cpool.submit(lambda: self._run_pack_job(job))
        self._wq.put(job)   # single producer: queue order == seq order
        if self._ledger is not None:
            self._ledger["compress"].note_queue(self._wq.qsize())

    def _submit_packed(self, blocks: list, attempt: list[bool],
                       need: int, n: int, lane_head: bytes,
                       lane_tail: bytes, packed, t0: float) -> None:
        """Enqueue a segment the device already compressed: the job
        enters the SAME ordered completion queue as pool jobs, born
        finished (ready pre-set, stored bytes staged in a pack buffer),
        so device-compressed and pool-compressed segments interleave in
        submit order and the completion thread cannot tell them apart
        — entry/digest/write bookkeeping is one code path."""
        if self._io_error:
            raise self._io_error[0]   # fail the producer fast
        if self._io_thread is None:
            self._io_thread = threading.Thread(
                target=self._io_loop, name="sstable-io", daemon=True)
            self._io_thread.start()
        if faultfs.GLOBAL.active:
            # same checkpoint the pool workers honour: an injected EIO
            # must fail the device-compress leg like a real fault, and
            # unwind through the task's txn rollback
            faultfs.GLOBAL.check("sstable.compress", self._data_path)
        total, sizes, crcs, parts = packed
        buf = self._take_pack_buf(need)
        if self._ledger is not None:
            self._ledger["compress"].add_items(1, need)
        off = 0
        for p in parts:
            ln = len(p)
            buf[off:off + ln] = np.frombuffer(p, dtype=np.uint8)
            off += ln
        job = _PackJob(self._seq_submitted - 1, blocks, attempt, buf,
                       n, lane_head, lane_tail)
        if self._metrics is not None:
            self._metrics.incr("compress_segments")
            self._metrics.incr("device_compress_segments")
        from ...service import tracing
        job.trace = tracing.active()
        if job.trace is not None:
            job.trace.add(f"Device compress: segment {job.seq} arrived "
                          f"finished ({job.n} cells)")
        job.total = int(total)
        job.sizes = sizes
        job.crcs = crcs
        job.compress_s = time.perf_counter() - t0
        job.blocks = None
        job.ready.set()
        self._wq.put(job)   # single producer: queue order == seq order
        if self._ledger is not None:
            self._ledger["compress"].note_queue(self._wq.qsize())

    def _run_pack_job(self, job: _PackJob) -> None:
        """Pool-worker side: pack (delta + compress-or-raw + CRC) one
        segment into its buffer. Errors land in the job and surface on
        the completion thread exactly like a serial compress error."""
        try:
            hook = _TEST_SEGMENT_DELAY
            if hook is not None:
                hook(job.seq)
            if faultfs.GLOBAL.active:
                # sstable.compress checkpoint: an injected EIO here must
                # fail the writer like a real compressor/allocator fault
                faultfs.GLOBAL.check("sstable.compress", self._data_path)
            t0 = time.perf_counter()
            total, sizes, _raws, crcs = self._packer.pack(
                job.blocks, job.attempt, self.params.max_compressed_length,
                shuffle_block=1, lane_width=self.K, out=job.buf)
            job.total = total
            job.sizes = sizes
            job.crcs = crcs
            job.compress_s = time.perf_counter() - t0
        except BaseException as e:
            job.error = e
        finally:
            job.blocks = None   # drop ndarray refs as soon as packed
            job.ready.set()

    def _io_loop_ordered(self) -> None:
        """Ordered completion stage of the parallel-compress pipeline:
        jobs leave the pool in ANY order; this thread consumes them in
        SUBMIT order, so every sequential piece of writer state — file
        offsets, index entries, the digest fold, the skip-machine
        outcome stream — sees segments exactly as the serial writer
        would. Byte-identity for any pool size follows."""
        job = None
        try:
            while True:
                job = self._wq.get()
                if job is None:
                    return
                # waiting on the head job means compress is the
                # bottleneck RIGHT NOW — this otherwise-idle thread
                # steals queued pack jobs (possibly the very one it
                # waits on) instead of sleeping; the disk never idles
                # behind a ready job because stealing only happens
                # while the head is NOT ready
                while not job.ready.is_set():
                    if not self._cpool.try_run_one():
                        job.ready.wait(0.02)
                if job.error is not None:
                    raise job.error
                entry = struct.pack("<QI", self._data_off, job.n)
                outcome = []
                for i in range(3):
                    stored = int(job.sizes[i])
                    entry += self._fold_block(stored, job.raw_lens[i],
                                              int(job.crcs[i]))
                    outcome.append((stored, job.raw_lens[i],
                                    job.attempt[i]))
                entry += job.lane_head + job.lane_tail
                self._index_entries.append(entry)
                self._acct_outcomes.put(tuple(outcome))
                self._acct("compress", job.compress_s)
                if job.trace is not None:
                    job.trace.add(
                        f"Compress pool: segment {job.seq} packed "
                        f"({job.total} bytes, "
                        f"{job.compress_s * 1e3:.1f} ms)")
                t0 = time.perf_counter()
                self._write_sync(memoryview(job.buf)[:job.total])
                self._acct("io_write", time.perf_counter() - t0)
                self._data_off += job.total
                self._published_off = self._data_off
                self._pack_free.put(job.buf)
                job = None
        except BaseException as e:
            self._io_error.append(e)
            # wake a producer parked on the outcome stream, then return
            # every pack buffer (the failed job's included) and drain:
            # the producer must block on neither the pool nor the queue
            # — it surfaces the error at its next submit or at finish()
            self._acct_outcomes.put(_ACCT_FAILED)
            if job is not None:
                job.ready.wait()
                self._pack_free.put(job.buf)
            while True:
                job = self._wq.get()
                if job is None:
                    return
                job.ready.wait()
                self._pack_free.put(job.buf)

    def _io_loop(self) -> None:
        if self._cpool is not None:
            self._io_loop_ordered()
            return
        item = None
        try:
            while True:
                item = self._wq.get()
                if item is None:
                    return
                buf, reclaim = item
                t0 = time.perf_counter()
                self._write_sync(memoryview(buf) if not
                                 isinstance(buf, memoryview) else buf)
                self._acct("io_write", time.perf_counter() - t0)
                if reclaim is not None:
                    self._pack_free.put(reclaim)
        except BaseException as e:
            self._io_error.append(e)
            # return every owned scratch buffer (including the one whose
            # write just failed) and drain: the producer must block on
            # neither the pool nor the queue — it surfaces the error at
            # its next _write_all
            if item is not None and item[1] is not None:
                self._pack_free.put(item[1])
            while True:
                item = self._wq.get()
                if item is None:
                    return
                if item[1] is not None:
                    self._pack_free.put(item[1])

    def _stop_io_thread(self) -> None:
        if self._io_thread is None:
            return
        self._wq.put(None)
        if self._cpool is not None:
            # seal drain: the producer is done producing and about to
            # park in join() — steal queued pack jobs instead (the
            # un-overlapped end of the pipeline was a measured chunk of
            # the `seal` phase; two threads drain it in half the wall).
            # Bounded by OUR io thread's lifetime: it exits right after
            # this writer's tail completes, so a busy co-tenant's job
            # stream can extend this loop by at most one stolen job —
            # never unboundedly.
            while self._io_thread.is_alive() and self._cpool.try_run_one():
                pass
        self._io_thread.join()
        self._io_thread = None
        if self._io_error:
            raise self._io_error[0]

    def _write_sync(self, mv: memoryview) -> None:
        fault_after = None
        if faultfs.GLOBAL.active:
            # flush.write checkpoint: error mode raises here (nothing
            # lands), torn_write persists a prefix then raises from the
            # tail of this call, bitflip corrupts the bytes in flight —
            # the reader-side CRCs must catch it
            mv, fault_after = faultfs.GLOBAL.on_write(
                "flush.write", self._data_path, mv)
        total = mv.nbytes
        if self._ledger is not None:
            self._ledger["io_write"].add_items(1, total)
        self._ensure_alloc(self._written_off + total)
        self._written_off += total
        if self._direct:
            # stage into the aligned bounce buffer; flush full buffers
            # (BOUNCE_BYTES is a multiple of DIRECT_ALIGN, so steady-state
            # flushes are always aligned and leave no remainder)
            while mv.nbytes:
                take = min(self.BOUNCE_BYTES - self._bounce_fill, mv.nbytes)
                self._bounce_mv[self._bounce_fill:
                                self._bounce_fill + take] = mv[:take]
                self._bounce_fill += take
                mv = mv[take:]
                if self._bounce_fill == self.BOUNCE_BYTES:
                    self._flush_bounce()
            if fault_after is not None:
                raise fault_after
            return
        # buffered fallback: raw FileIO.write may write short (and caps
        # single writes around 2 GiB on Linux) — loop until all lands
        while mv.nbytes:
            n = self._data.write(mv)
            if n is None or n <= 0:
                raise OSError("short write to Data.db")
            mv = mv[n:]
        if fault_after is not None:
            raise fault_after
        self._bytes_since_sync += total
        if self._bytes_since_sync >= self.TRICKLE_FSYNC_BYTES:
            self._bytes_since_sync = 0
            if self._syncer is None:
                self._syncer = threading.Thread(
                    target=self._trickle_sync, daemon=True,
                    name="sstable-trickle-fsync")
                self._syncer.start()
            self._sync_req.set()       # syncer flushes in the background

    def _flush_bounce(self, final: bool = False) -> None:
        end = self._bounce_fill
        if final:
            aligned = -(-end // self.DIRECT_ALIGN) * self.DIRECT_ALIGN
            if aligned > end:   # zero-pad; finish() truncates back
                self._bounce_mv[end:aligned] = bytes(aligned - end)
            end = aligned
        pos = 0
        while pos < end:
            n = self._data.write(self._bounce_mv[pos:end])
            if n is None or n <= 0:
                raise OSError("short write to Data.db")
            if n % self.DIRECT_ALIGN and pos + n < end:
                raise OSError("misaligned partial O_DIRECT write")
            pos += n
        self._bounce_fill = 0

    def _trickle_sync(self) -> None:
        while True:
            self._sync_req.wait()
            self._sync_req.clear()
            if self._sync_stop:
                return
            try:
                os.fsync(self._data.fileno())
            except Exception as e:
                # a writeback error (EIO/ENOSPC) — or a racing close
                # (ValueError: fd already gone) — is reported ONCE per
                # fd; swallowing it here would let finish()'s final
                # fsync succeed and commit an sstable with lost pages.
                # Record it — finish() re-raises before the commit
                # point — instead of silently ending the trickle-sync
                # thread (ctpulint worker-loops).
                self._sync_error = e
                return

    def _stop_syncer(self) -> None:
        # join blocks for at most one in-flight fsync, bounded by
        # TRICKLE_FSYNC_BYTES of dirty pages (~0.15s on this disk)
        if self._syncer is None:
            return
        self._sync_stop = True
        self._sync_req.set()
        self._syncer.join()

    @staticmethod
    def _fsync_path(path: str) -> None:
        """fsync a file or directory by path (directories need an fd too —
        the rename itself is only durable once the dir entry is synced)."""
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def abort(self) -> None:
        if self._io_thread is not None:   # stop without raising
            self._wq.put(None)
            self._io_thread.join(timeout=30.0)
            self._io_thread = None
        self._stop_syncer()
        if not self._data.closed:
            self._data.close()
        if self._direct and not self._bounce.closed:
            self._bounce_mv.release()
            self._bounce.close()
        for comp in Component.ALL + Component.OPTIONAL:
            p = self.desc.tmp_path(comp)
            if os.path.exists(p):
                os.remove(p)

    # ------------------------------------------------------------ internals

    def _take(self, n: int) -> CellBatch:
        """Pop exactly n cells from pending batches."""
        taken = []
        got = 0
        while got < n:
            b = self._pending[0]
            need = n - got
            if len(b) <= need:
                taken.append(b)
                self._pending.pop(0)
                got += len(b)
            else:
                taken.append(b.slice_range(0, need))
                self._pending[0] = b.slice_range(need, len(b))
                got = n
        self._pending_cells -= n
        return CellBatch.concat(taken) if len(taken) > 1 else taken[0]

    def _cut_segment(self, n: int) -> None:
        seg = self._take(n)
        # --- blocks: vectorized serialization into one scratch buffer,
        # then zero-copy scatter-gather compression (the previous
        # tobytes/join/ctypes staging copied every byte ~4x — measured as
        # the dominant write-path cost)
        # "ce" meta layout (build_meta_block): ts-delta 8 + ldt 4 +
        # ttl 4 + flags 1 + frame_len u32 + val_rel u32 = 25 B/cell.
        # Frame lengths are the off deltas and val_rel the value offset
        # inside each frame — half the bytes of the absolute i64 pair
        # they replace, and far more compressible (small near-constant
        # integers); the ts lane is delta'd per segment for the same
        # reason (format.py "ce")
        t_ser = time.perf_counter()
        deltas = seg.off[1:] - seg.off[:-1]
        vrel64 = seg.val_start - seg.off[:-1]
        if len(deltas) and (int(deltas.max()) >= 1 << 32
                            or int(vrel64.max()) >= 1 << 32):
            # u32 lanes cannot hold a >=4GiB frame — fail loudly
            # instead of wrapping into silent corruption
            raise ValueError(
                f"cell frame exceeds the u32 offset lane "
                f"(max frame {int(deltas.max())} bytes)")
        meta = build_meta_block(seg.ts.astype(np.int64, copy=False),
                                seg.ldt, seg.ttl, seg.flags,
                                deltas.astype("<u4"),
                                vrel64.astype("<u4"))
        payload_b = np.ascontiguousarray(seg.payload)
        lanes_c = np.ascontiguousarray(seg.lanes)
        from ..cellbatch import DEATH_FLAGS
        seg_stats = (int(seg.ts.min()), int(seg.ts.max()),
                     int(seg.ldt.min()), int(seg.ldt.max()),
                     int(((seg.flags & DEATH_FLAGS) != 0).sum()))
        self._acct("serialize", time.perf_counter() - t_ser)
        self._emit_segment(n, meta, lanes_c, payload_b, seg.pk_map,
                           seg_stats)

    def _accumulate_zone(self, n: int, meta: "np.ndarray",
                         lanes_c: "np.ndarray",
                         payload_b: "np.ndarray") -> None:
        """Fold one segment's per-column (min key, max key, live, dead)
        zone entries from the already-serialized blocks — the cells are
        in META/LANES form here whichever leg built them, so this is
        the one place that covers host, pooled and device serialize
        paths identically."""
        from ...ops import device_scan as _ds
        if self._zone_cols is None:
            self._zone_cols = _ds.zonemap_columns(self.table)
        if not self._zone_cols:
            self._zone_acc = None   # nothing to map for this schema
            return
        flags = meta[16 * n:17 * n]
        frame = meta[17 * n:21 * n].copy().view("<u4").astype(np.int64)
        vrel = meta[21 * n:25 * n].copy().view("<u4").astype(np.int64)
        off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(frame, out=off[1:])
        C = lanes_c.shape[1] - 9
        self._zone_acc.append(_ds.segment_zone_entries(
            self._zone_cols, lanes_c[:, 6 + C], flags,
            off[:-1] + vrel, off[1:], payload_b))

    def _write_zonemap(self) -> None:
        """ZoneMap.db, written to its FINAL path outside the TOC (the
        attached-index contract: a missing/stale component is rebuilt
        from the sstable, so it needs no commit-point coupling)."""
        if self._zone_acc is None or self._zone_cols is None \
                or not self._zone_cols:
            return
        from ...index import sstable_index as ssi
        ssi.write_zonemap(ssi.zonemap_path(self.desc),
                          self._zone_cols, self._zone_acc)

    def _emit_segment(self, n: int, meta: "np.ndarray",
                      lanes_c: "np.ndarray", payload_b: "np.ndarray",
                      pk_map: dict, seg_stats: tuple,
                      device_pack=None) -> None:
        """Everything downstream of block serialization for ONE segment:
        ordering guards, partition directory + bloom, stats fold,
        adaptive-skip attempt decision, compress (pool / serial / the
        per-block fallback), index entry and digest bookkeeping. The
        host path enters from _cut_segment with blocks it built in
        numpy; the device-resident lane (ops/device_write.py) enters
        with blocks its fused kernel built from device arrays — one
        tail, so the two paths cannot diverge on any sequential writer
        state. seg_stats: (min_ts, max_ts, min_ldt, max_ldt,
        tombstones) computed by whichever side owned the columns.
        device_pack: optional (attempt, maxlen) -> (total, sizes,
        crcs, parts) closure from the device lane — the segment's
        blocks ALREADY policy-compressed on-device
        (ops/device_compress.pack_device_segment). Called after the
        skip-machine attempt decision so device and host legs consume
        identical attempt vectors; a failure raises (the compaction
        fails through its normal unwind; nothing falls back)."""
        # cross-segment ordering guard; the intra-segment check runs
        # inside segment_pack's delta loop (fast path) or the numpy
        # comparison below (fallback path)
        first = lanes_c[0].astype(">u4").tobytes()
        if self._last_lane_end is not None and first < self._last_lane_end:
            raise ValueError("appended cells out of order")
        if n > 1 and self._packer is None:
            a, b = lanes_c[:-1], lanes_c[1:]
            neq = a != b
            anyneq = neq.any(axis=1)
            if anyneq.any():
                fi = neq.argmax(axis=1)
                rows = np.arange(n - 1)
                if ((a[rows, fi] > b[rows, fi]) & anyneq).any():
                    raise ValueError("appended cells out of order")

        # zone-map accumulation: once per segment, in append order, on
        # the appending thread — BEFORE the compress legs fork, so the
        # serial, pooled and device-packed paths all feed it
        if self._zone_acc is not None:
            self._accumulate_zone(n, meta, lanes_c, payload_b)

        # --- partition directory + bloom: one native pass over the
        # lanes finds the rows where the 4 pk lanes change (the numpy
        # strided slice-copy + row-compare this replaces was a measured
        # write-leg hotspot)
        starts = _part_starts(lanes_c, n)
        new_keys = []
        for s in starts:
            l4 = lanes_c[s, :4].astype(">u4").tobytes()
            if l4 == self._last_lane4:
                continue  # partition continues from previous segment
            pk = pk_map.get(l4)
            if pk is None:
                raise ValueError("pk_map missing partition key")
            self._part_lane4.append(l4)
            self._part_first_cell.append(self._total_cells + int(s))
            self._part_pk.append(pk)
            new_keys.append(pk)
            self._last_lane4 = l4
        self._bloom.add_batch(new_keys)

        # --- stats
        st = self._stats

        def _lo(key, v):
            st[key] = v if st[key] is None else min(st[key], v)

        def _hi(key, v):
            st[key] = v if st[key] is None else max(st[key], v)

        mn_ts, mx_ts, mn_ldt, mx_ldt, tombs = seg_stats
        _lo("min_ts", mn_ts)
        _hi("max_ts", mx_ts)
        _lo("min_ldt", mn_ldt)
        _hi("max_ldt", mx_ldt)
        self._stats["tombstones"] += tombs

        attempt = self._decide_attempt()
        maxlen = self.params.max_compressed_length
        lane_head = lanes_c[0].astype("<u4").tobytes()
        lane_tail = lanes_c[-1].astype("<u4").tobytes()
        t_pack = time.perf_counter()

        if self._packer is not None:
            # fused native path: delta + order check + compress-or-raw +
            # CRC + sequential placement, one GIL-released call
            blocks = [meta, lanes_c, payload_b]
            need = sum(b.nbytes for b in blocks)
            packed = None
            if device_pack is not None:
                # a failure of the device leg propagates: no host
                # fallback hides it
                packed = device_pack(attempt, maxlen)
            if packed is not None and self._cpool is not None:
                self._submit_packed(blocks, attempt, need, n,
                                    lane_head, lane_tail, packed, t_pack)
                self._total_cells += n
                self._last_lane_end = lanes_c[-1].astype(">u4").tobytes()
                return
            if self._cpool is not None:
                # parallel leg: the pool compresses this segment while
                # this thread packs the NEXT one's lanes; the ordered
                # completion thread does entry/digest/write in seq
                # order (index entry + _total_cells stay consistent:
                # entries append in seq order over there, cells here)
                self._submit_pack(blocks, attempt, need, n,
                                  lane_head, lane_tail)
                self._total_cells += n
                self._last_lane_end = lanes_c[-1].astype(">u4").tobytes()
                return
            entry = struct.pack("<QI", self._data_off, n)
            if packed is not None:
                # device-compressed, serial/threaded completion: same
                # entry/digest/outcome bookkeeping as the native pack,
                # fed from the device lane's finished bytes
                total, sizes, crcs, parts = packed
                outcome = []
                for i in range(3):
                    stored = int(sizes[i])
                    entry += self._fold_block(stored, blocks[i].nbytes,
                                              int(crcs[i]))
                    outcome.append((stored, blocks[i].nbytes, attempt[i]))
                self._acct_outcomes.put(tuple(outcome))
                self._acct("compress", time.perf_counter() - t_pack)
                if self._ledger is not None:
                    self._ledger["compress"].add_items(1, need)
                if self._metrics is not None:
                    self._metrics.incr("device_compress_segments")
                self._write_all(memoryview(b"".join(parts)))
                self._data_off += int(total)
                self._published_off = self._data_off
            else:
                if self._threaded_io:
                    out = self._take_pack_buf(need)
                else:
                    if self._pack_out is None or self._pack_out.nbytes < need:
                        self._pack_out = np.empty(need, dtype=np.uint8)
                    out = self._pack_out
                total, sizes, raws, crcs = self._packer.pack(
                    blocks, attempt, maxlen, shuffle_block=1,
                    lane_width=lanes_c.shape[1], out=out)
                outcome = []
                for i in range(3):
                    stored = int(sizes[i])
                    entry += self._fold_block(stored, blocks[i].nbytes,
                                              int(crcs[i]))
                    outcome.append((stored, blocks[i].nbytes, attempt[i]))
                self._acct_outcomes.put(tuple(outcome))
                self._acct("compress", time.perf_counter() - t_pack)
                if self._ledger is not None:
                    self._ledger["compress"].add_items(1, need)
                self._write_all(memoryview(out)[:total],
                                reclaim=out if self._threaded_io else None)
                self._data_off += total
                self._published_off = self._data_off
        else:
            # per-block fallback (encrypted tables / codecs without a
            # native id). Lanes are still byte-plane shuffled — the
            # on-disk format is identical either way.
            entry = struct.pack("<QI", self._data_off, n)
            lanes_b = lanes_shuffle(
                lanes_c.astype(np.uint32, copy=False))
            blocks = [meta, lanes_b, payload_b]
            tried = [b for b, a in zip(blocks, attempt) if a]
            dst, dst_offs, sizes = self.compressor.compress_iov(tried)
            self._acct("compress", time.perf_counter() - t_pack)
            # min_compress_ratio fallback: store uncompressed when too
            # poor (CompressedSequentialWriter.java:160-175 semantics)
            ti = 0
            outcome = []
            for i, raw in enumerate(blocks):
                if attempt[i]:
                    c = dst[int(dst_offs[ti]):
                            int(dst_offs[ti]) + int(sizes[ti])]
                    ti += 1
                    if c.nbytes >= min(raw.nbytes, maxlen):
                        c = raw
                else:
                    c = raw
                mv = memoryview(c).cast("B")
                if self._enc is not None:
                    ctx, kid, nonces = self._enc
                    mv = memoryview(ctx.xor_at(kid, nonces[Component.DATA],
                                               self._data_off, mv))
                crc = zlib.crc32(mv)
                entry += self._fold_block(c.nbytes, raw.nbytes, crc)
                outcome.append((c.nbytes, raw.nbytes, attempt[i]))
                self._write_all(mv)
                self._data_off += c.nbytes
            self._acct_outcomes.put(tuple(outcome))
            self._published_off = self._data_off
        entry += lane_head
        entry += lane_tail
        self._index_entries.append(entry)
        self._total_cells += n
        self._last_lane_end = lanes_c[-1].astype(">u4").tobytes()

    _last_lane_end: bytes | None = None

    def _write_component(self, comp: str, data: bytes) -> None:
        """Write a small component, encrypting payload-bearing ones on
        encrypted tables (whole-file keystream from offset 0)."""
        if self._enc is not None:
            ctx, kid, nonces = self._enc
            if comp in nonces:
                data = ctx.xor_at(kid, nonces[comp], 0, data)
        with open(self.desc.tmp_path(comp), "wb") as f:
            f.write(data)

    def _write_index(self) -> None:
        out = bytearray(struct.pack("<III", len(self._index_entries),
                                    self.K, self.segment_cells))
        for e in self._index_entries:
            out += e
        self._write_component(Component.INDEX, bytes(out))

    def _write_partitions(self) -> None:
        np_count = len(self._part_lane4)
        out = bytearray(struct.pack("<I", np_count))
        out += b"".join(self._part_lane4)
        out += np.array(self._part_first_cell, dtype="<i8").tobytes()
        pk_off = np.zeros(np_count + 1, dtype="<i8")
        np.cumsum([len(p) for p in self._part_pk], out=pk_off[1:])
        out += pk_off.tobytes()
        out += b"".join(self._part_pk)
        self._write_component(Component.PARTITIONS, bytes(out))

    def _write_filter(self) -> None:
        with open(self.desc.tmp_path(Component.FILTER), "wb") as f:
            f.write(self._bloom.serialize())

    def _write_stats(self) -> dict:
        stats = {
            "version": self.desc.version,
            "keyspace": self.table.keyspace,
            "table": self.table.name,
            "table_id": str(self.table.id),
            "n_lanes": self.K,
            "segment_cells": self.segment_cells,
            "n_cells": self._total_cells,
            "n_partitions": len(self._part_lane4),
            "compression": self.params.to_dict(),
            "level": self.level,
            "repaired_at": self.repaired_at,
            "ck_fits_prefix": self._ck_fits,
            **self._stats,
        }
        with open(self.desc.tmp_path(Component.STATS), "w") as f:
            json.dump(stats, f)
        return stats

    def _write_digest(self) -> None:
        with open(self.desc.tmp_path(Component.DIGEST), "w") as f:
            f.write(f"{self._data_crc & 0xFFFFFFFF}\n")
