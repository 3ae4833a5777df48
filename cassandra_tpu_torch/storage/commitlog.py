"""Commitlog: segmented durable WAL with CRC-framed records and replay.

Reference counterpart: db/commitlog/CommitLog.java:300 (add),
CommitLogSegment, AbstractCommitLogSegmentManager (segment rotation,
per-table dirty tracking), CommitLogReplayer (boot replay). Sync
strategies (AbstractCommitLogService subclasses, conf/cassandra.yaml
commitlog_sync options):
  'periodic'  buffered appends, background fsync every sync_period_ms;
              acked writes may be lost on crash inside the window.
  'batch'     durable before ack. Fast lane (CTPU_WRITE_FASTPATH=1):
              writers append to the buffered segment and PARK on a sync
              barrier; a SYNC LEADER elected among the parked writers
              runs one flush+fsync that acks every writer it covers, so
              N concurrent writers pay ~1 fsync instead of N
              (BatchCommitLogService with a zero window).
              Fast lane off: fsync inline under the segment lock.
  'group'     durable before ack like batch, but the syncer thread
              paces fsyncs commitlog_sync_group_window apart, trading
              ack latency for larger coalesced groups
              (GroupCommitLogService). Fast lane off: degrades to the
              inline-fsync batch behavior (same durability, no grouping).

Rotation is double-buffered on the fast lane: the outgoing segment is
handed to the syncer to flush+fsync+close+archive off the write path,
so appends to segment k+1 proceed while k syncs. Segments are block-
preallocated at open (fsutil.preallocate_keep_size).

Record frame: [u32 length][u32 crc32-of-payload][payload]. A zero length
or short read terminates replay of a segment (torn tail after crash).
"""
from __future__ import annotations

import logging
import os
import re
import struct
import threading
from ..utils import lockwitness
import time
import zlib

from ..utils import fsutil
from .mutation import Mutation

_SEG_RE = re.compile(r"^commitlog-(\d+)\.log$")

_log = logging.getLogger(__name__)


def write_fastpath_enabled() -> bool:
    """CTPU_WRITE_FASTPATH=0 disables the write-path fast lane (commitlog
    group commit, sharded memtable ingest, pipelined flush) for A/B runs
    (bench.py write_path section, scripts/check_writepath_ab.py). Read
    per call so a toggle mid-process takes effect immediately."""
    return os.environ.get("CTPU_WRITE_FASTPATH", "1") != "0"


class CommitLogPosition(tuple):
    """(segment_id, offset) — totally ordered."""
    def __new__(cls, segment_id: int, offset: int):
        return super().__new__(cls, (segment_id, offset))

    @property
    def segment_id(self):
        return self[0]

    @property
    def offset(self):
        return self[1]


_ENC_MAGIC = b"CTPUCLE1"   # encrypted segment: magic + u32 key id + nonce16
_ENC_HDR = len(_ENC_MAGIC) + 4 + 16
# compressed segment (db/commitlog/CompressedSegment.java role): magic +
# u8 codec-name length + codec name. Records in such a segment use the
# 12-byte frame [u32 stored_len][u32 crc][u32 raw_len]; raw_len ==
# stored_len marks an incompressible record stored raw. Composes with
# encryption as compress-then-encrypt (the reference's EncryptedSegment
# also compresses before encrypting); the CRC covers the stored bytes.
_COMP_MAGIC = b"CTPUCLC1"


class CommitLog:
    def __init__(self, directory: str, segment_size: int = 32 * 1024 * 1024,
                 sync_mode: str = "periodic", sync_period_ms: int = 1000,
                 archive_dir: str | None = None, encrypt: bool = False,
                 compression: str | None = None,
                 group_window_ms: float = 10.0,
                 failure_handler=None):
        """archive_dir: finished segments are copied there on rotation
        and at close (CommitLogArchiver role — the restore half is
        replay_archived / StorageEngine.restore_point_in_time).
        encrypt: segments carry an AES-CTR header and record payloads
        are keystream-XORed at their file offset
        (db/commitlog/EncryptedSegment.java role; CRCs cover ciphertext).
        group_window_ms: minimum spacing between fsyncs under
        sync_mode='group' (commitlog_sync_group_window).
        failure_handler: a storage.failures.FailureHandler — every sync
        failure funnels into its commit_failure_policy (stop_commit
        halts new writes while reads continue; ignore keeps the
        count-and-propagate behavior)."""
        self.directory = directory
        self._failure_handler = failure_handler
        self.segment_size = segment_size
        self.sync_mode = sync_mode
        self.sync_period_ms = sync_period_ms
        self.group_window_ms = group_window_ms
        self.archive_dir = archive_dir
        self.encrypt = encrypt
        self.compression = compression or None
        self._compressor = None
        if self.compression:
            from ..ops.codec import get_compressor
            self._compressor = get_compressor(self.compression)
        if archive_dir:
            os.makedirs(archive_dir, exist_ok=True)
        os.makedirs(directory, exist_ok=True)
        self._lock = lockwitness.make_lock("commitlog.append")
        existing = self.segment_ids()
        self._seg_id = (existing[-1] + 1) if existing else 1
        self._file = None
        self._seg_enc = None      # (key_id, nonce) of the open segment
        # archiver worker: rotation must not stall writers on a 32MB
        # copy+fsync (the reference archives asynchronously too); a
        # segment awaiting archive is protected from deletion
        self._archive_q: list[int] = []
        self._archiving: set[int] = set()
        self._archive_ev = threading.Event()
        self._archive_thread = None
        if archive_dir:
            # crash recovery: segments already on disk were finished by
            # the crash and were never archived (there was no clean
            # close) — archive them NOW, before boot replay flushes and
            # deletes them, or PITR silently loses the tail
            for seg in existing:
                self._archive(seg)
            self._archive_thread = threading.Thread(
                target=self._archive_loop, daemon=True,
                name="commitlog-archiver")
            self._archive_thread.start()
        # ---- group-commit sync barrier (AbstractCommitLogService role):
        # writers park in _await_sync until _synced covers their frame;
        # the syncer thread coalesces all parked writers into one fsync.
        self._sync_cond = lockwitness.make_condition("commitlog.sync_barrier")
        self._synced = CommitLogPosition(0, 0)
        self._sync_req = threading.Event()   # "waiters (or dirty retired
        #                                       segments) need a sync"
        self._waiting = 0                    # writers parked on the barrier
        self._leader_active = False          # a writer is running the sync
        self._sync_error: BaseException | None = None
        # serializes sync CYCLES (leader writer vs syncer thread): two
        # concurrent _do_sync calls could otherwise race a rotation —
        # one closing a just-retired file the other captured for fsync
        self._sync_mutex = lockwitness.make_lock("commitlog.sync_cycle")
        self._sync_failures = 0
        self._failure_logged = False
        self._last_sync = 0.0
        # rotated-but-unsynced segments: (seg_id, file) pairs the syncer
        # flushes, fsyncs, closes and hands to the archiver — the double
        # buffer that keeps rotation off the write path
        self._retiring: list[tuple[int, object]] = []
        from ..service.metrics import GLOBAL as _METRICS
        self._wait_hist = _METRICS.hist("commitlog.waiting_on_commit")
        self._sync_hist = _METRICS.hist("commitlog.sync_latency")
        self._metrics = _METRICS
        self._open_segment()
        # dirty tracking: segment -> set of table ids with unflushed writes
        self._dirty: dict[int, set] = {}
        self._stop = threading.Event()
        # ONE syncer for every mode: periodic ticks on sync_period_ms;
        # batch/group wake on _sync_req (fast lane) and stay idle when
        # writers fsync inline (fast lane off)
        self._syncer = threading.Thread(target=self._sync_loop,
                                        daemon=True,
                                        name="commitlog-syncer")
        self._syncer.start()

    # ------------------------------------------------------------ segments

    def _seg_path(self, seg_id: int) -> str:
        return os.path.join(self.directory, f"commitlog-{seg_id}.log")

    def segment_ids(self) -> list[int]:
        out = []
        for fn in os.listdir(self.directory):
            m = _SEG_RE.match(fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _open_segment(self) -> None:
        """Open the segment for _seg_id, retiring the previous file to
        the syncer (flush to the OS now so a concurrent _do_sync never
        misses buffered bytes; fsync+close+archive happen off the write
        path — the rotation half of the double buffer). Callers hold
        _lock except the __init__ call, which races nothing."""
        if self._file:
            prev = self._seg_id - 1
            self._file.flush()
            if self.archive_dir:
                # deletion must wait for the PITR copy; claim BEFORE the
                # retire becomes visible to discard_completed
                self._archiving.add(prev)
            self._retiring.append((prev, self._file))
            self._sync_req.set()
        self._file = open(self._seg_path(self._seg_id), "ab")
        self._seg_comp = None
        if self.encrypt:
            from . import encryption as enc_mod
            ctx = enc_mod.get_context()
            if ctx is None:
                raise enc_mod.EncryptionError(
                    "commitlog encryption requires an EncryptionContext")
            if self._file.tell() == 0:
                kid = ctx.current_key_id
                nonce = ctx.new_nonce()
                self._file.write(_ENC_MAGIC + kid.to_bytes(4, "little")
                                 + nonce)
                self._file.flush()
                self._seg_enc = (kid, nonce)
            else:   # restart onto a partially-written encrypted segment
                with open(self._seg_path(self._seg_id), "rb") as f:
                    hdr = f.read(_ENC_HDR)
                if not hdr.startswith(_ENC_MAGIC):
                    raise enc_mod.EncryptionError(
                        "existing active segment is not encrypted; "
                        "rotate before enabling encryption")
                self._seg_enc = (int.from_bytes(hdr[8:12], "little"),
                                 hdr[12:28])
        if self._compressor is not None:
            if self._file.tell() == 0 or (
                    self.encrypt and self._file.tell() == _ENC_HDR):
                name = self.compression.encode()
                self._file.write(_COMP_MAGIC + bytes([len(name)]) + name)
                self._file.flush()
            self._seg_comp = self._compressor
        # reserve the whole segment's blocks up front (KEEP_SIZE: st_size
        # stays at the append point so replay's EOF/torn-tail detection is
        # unaffected). The reference pre-creates fixed-size segments for
        # the same reason (CommitLogSegment); on this box extending
        # writes are ~75x slower than writes into reserved blocks.
        fsutil.preallocate_keep_size(
            self._file.fileno(), self._file.tell(),
            max(0, self.segment_size - self._file.tell()))

    # ----------------------------------------------------------------- add

    def _append_locked(self, mutation: Mutation,
                       payload: bytes) -> CommitLogPosition:
        """Frame + write one serialized mutation; caller holds _lock."""
        if self._file.tell() + len(payload) + 12 > self.segment_size:
            self._seg_id += 1
            self._open_segment()
        pos = CommitLogPosition(self._seg_id, self._file.tell())
        raw_len = len(payload)
        if self._seg_comp is not None:
            c = self._seg_comp.compress(payload)
            if len(c) < raw_len:
                payload = c
        if self._seg_enc is not None:
            from . import encryption as enc_mod
            kid, nonce = self._seg_enc
            hdr = 12 if self._seg_comp is not None else 8
            payload = enc_mod.get_context().xor_at(
                kid, nonce, pos.offset + hdr, payload)
        if self._seg_comp is not None:
            frame = struct.pack("<III", len(payload),
                                zlib.crc32(payload), raw_len) + payload
        else:
            frame = struct.pack("<II", len(payload),
                                zlib.crc32(payload)) + payload
        self._file.write(frame)
        self._dirty.setdefault(self._seg_id, set()).add(mutation.table_id)
        return pos

    def append(self, mutation: Mutation
               ) -> tuple[CommitLogPosition, CommitLogPosition | None]:
        """Append WITHOUT waiting for durability: returns (position,
        barrier) where barrier is the position await_durable must reach
        before the write may be acked (None when the mode needs no wait
        — periodic, or the record was inline-fsynced). Callers that
        hold a coarser lock (the ColumnFamilyStore write barrier) use
        this so the durability wait happens OUTSIDE that lock — parked
        writers must not serialize the writers behind them, or group
        commit coalesces nothing."""
        poss, barrier = self.append_batch([mutation])
        return poss[0], barrier

    def append_batch(self, mutations: list[Mutation]
                     ) -> tuple[list[CommitLogPosition],
                                CommitLogPosition | None]:
        """Batch form of append(): the whole batch lands under ONE lock
        acquisition and shares one durability barrier (the commitlog
        half of the batched write fast lane)."""
        if not mutations:
            return [], None
        payloads = [m.serialize() for m in mutations]
        fast = self.sync_mode in ("batch", "group") \
            and write_fastpath_enabled()
        barrier = None
        with self._lock:
            out = [self._append_locked(m, p)
                   for m, p in zip(mutations, payloads)]
            if self.sync_mode in ("batch", "group"):
                end = CommitLogPosition(self._seg_id, self._file.tell())
                if fast:
                    barrier = end
                else:
                    self._file.flush()
                    os.fsync(self._file.fileno())
        if not fast and self.sync_mode in ("batch", "group"):
            self._advance_synced(end)
        return out, barrier

    def await_durable(self, barrier: CommitLogPosition | None) -> None:
        """Block until a barrier returned by append/append_batch is
        durable (no-op for None)."""
        if barrier is not None:
            self._await_sync(barrier)

    def add(self, mutation: Mutation) -> CommitLogPosition:
        """Append a mutation; returns its position. With
        sync_mode='batch'/'group' the record is durable when this
        returns (CommitLog.add:300). Fast lane: the writer appends
        buffered and parks on the sync barrier; one syncer fsync acks
        every parked writer at once."""
        pos, barrier = self.append(mutation)
        self.await_durable(barrier)
        return pos

    def add_batch(self, mutations: list[Mutation]) -> list[CommitLogPosition]:
        """add() for a batch: one lock acquisition, one sync barrier."""
        out, barrier = self.append_batch(mutations)
        self.await_durable(barrier)
        return out

    # ------------------------------------------------------ sync barrier --

    def _advance_synced(self, pos: CommitLogPosition) -> None:
        with self._sync_cond:
            if pos > self._synced:
                self._synced = pos
            self._sync_error = None
            self._sync_cond.notify_all()

    def _await_sync(self, pos: CommitLogPosition) -> None:
        """Park until `pos` is durable (the reference's WaitQueue in
        AbstractCommitLogService.finishWriteFor).

        batch mode elects a SYNC LEADER among the parked writers: the
        first unsynced writer runs flush+fsync itself and releases
        everyone its sync covered; writers arriving during that fsync
        park, and one of them leads the next cycle back-to-back. A
        dedicated syncer thread would add a thread handoff (and, in a
        GIL runtime, a scheduling gap that measured LARGER than the
        fsync itself) to every cycle. group mode keeps the syncer
        thread: the window is a pacing decision, not a handoff."""
        t0 = time.perf_counter()
        lead_mode = self.sync_mode == "batch"
        with self._sync_cond:
            self._waiting += 1
            fail0 = self._sync_failures
        try:
            while True:
                lead = False
                with self._sync_cond:
                    if self._synced >= pos:
                        return
                    if self._sync_failures > fail0 \
                            and self._sync_error is not None:
                        # a sync attempted AFTER this append failed:
                        # durability cannot be confirmed — fail the
                        # write like the inline fsync would have.
                        # (An error predating this writer is not fatal
                        # on sight: this writer triggers a fresh sync,
                        # which either succeeds — releasing it — or
                        # fails anew and raises here.)
                        raise self._sync_error
                    if lead_mode and not self._leader_active:
                        self._leader_active = True
                        lead = True
                    else:
                        if not lead_mode:
                            # group mode: the syncer paces the cycles.
                            # (batch mode must NOT wake it — a leader
                            # exists or will be elected next iteration,
                            # and a parallel syncer cycle would double
                            # the fsyncs group commit just coalesced.)
                            self._sync_req.set()
                        self._sync_cond.wait(0.05)
                        if not lead_mode:
                            # re-arm against a lost wakeup (the syncer
                            # may have cleared the request while this
                            # writer was between append and park)
                            self._sync_req.set()
                if lead:
                    try:
                        self._do_sync()
                    except (OSError, ValueError) as e:
                        self._record_sync_failure(e)
                    finally:
                        with self._sync_cond:
                            self._leader_active = False
                            self._sync_cond.notify_all()
        finally:
            with self._sync_cond:
                self._waiting -= 1
            self._wait_hist.update_us((time.perf_counter() - t0) * 1e6)

    def sync(self) -> None:
        """Flush + fsync everything appended so far (public surface for
        close/tests; the syncer thread uses the same primitive)."""
        self._do_sync()

    def _do_sync(self) -> None:
        """One coalesced sync cycle: flush the active segment's python
        buffer under the lock, then fsync OUTSIDE it (appends to the
        same — or the next — segment proceed during the device flush),
        then release every writer parked at or before the synced
        position. Retired segments sync first so the position order
        (segment, offset) stays truthful. Cycles are serialized by
        _sync_mutex: a concurrent cycle could close a just-retired file
        this one captured for fsync."""
        t0 = time.perf_counter()
        with self._sync_mutex:
            with self._lock:
                from ..utils import faultfs
                # commitlog.fsync fault checkpoint: an injected EIO here
                # takes the same path a dying device would — caught by
                # the sync loop / leader, counted, routed to the commit
                # failure policy, propagated to parked writers
                faultfs.check("commitlog.fsync", self.directory)
                retiring = self._retiring
                self._retiring = []
                f = self._file
                target = None
                if f is not None and not f.closed:
                    f.flush()
                    target = CommitLogPosition(self._seg_id, f.tell())
            try:
                while retiring:
                    seg, rf = retiring[0]
                    rf.flush()
                    os.fsync(rf.fileno())
                    # durable: safe to drop from the re-queue window
                    # even if close/archive below has trouble
                    retiring.pop(0)
                    rf.close()
                    if self.archive_dir:
                        with self._lock:
                            self._archive_q.append(seg)
                        self._archive_ev.set()
                if target is not None:
                    os.fsync(f.fileno())
            except BaseException:
                # un-synced retired segments go BACK on the queue: a
                # later successful cycle advancing _synced past their
                # positions must not ack writers whose bytes were never
                # fsynced (and the archiver claim must stay honorable)
                with self._lock:
                    self._retiring[:0] = retiring
                raise
        self._sync_hist.update_us((time.perf_counter() - t0) * 1e6)
        self._last_sync = time.perf_counter()
        if target is not None:
            self._advance_synced(target)

    def _record_sync_failure(self, exc: BaseException) -> None:
        """Satellite fix: a failing sync used to kill the loop silently.
        Count it (commitlog.sync_failures), log ONCE, propagate to
        parked writers (their ack must not lie), keep the loop alive —
        a transient EIO/ENOSPC must not permanently disable syncing."""
        self._metrics.incr("commitlog.sync_failures")
        if not self._failure_logged:
            self._failure_logged = True
            _log.warning("commitlog sync failed (%s); further failures "
                         "are counted in commitlog.sync_failures", exc)
        with self._sync_cond:
            self._sync_failures += 1
            self._sync_error = exc
            self._sync_cond.notify_all()
        if self._failure_handler is not None:
            # commit_failure_policy decision (stop_commit halts future
            # writes at the engine gate; die/stop take the node out) —
            # AFTER the parked writers were released with the error
            self._failure_handler.handle_commit(exc)

    def _sync_loop(self) -> None:
        period = self.sync_period_ms / 1000.0
        while True:
            if self.sync_mode == "periodic":
                if self._stop.wait(period):
                    return
            else:
                self._sync_req.wait(timeout=0.2)
                if self._stop.is_set():
                    return
                if not self._sync_req.is_set():
                    continue
                self._sync_req.clear()
                if self.sync_mode == "group":
                    # spacing, not latency-from-request: coalesce every
                    # writer arriving inside the window since last sync
                    rem = self.group_window_ms / 1000.0 \
                        - (time.perf_counter() - self._last_sync)
                    if rem > 0 and self._stop.wait(rem):
                        return
            try:
                self._do_sync()
            except Exception as e:
                # EVERY sync failure — EIO, a closed fd (ValueError),
                # or an outright bug — routes through the
                # commit_failure_policy funnel; the syncer thread
                # itself must survive, or parked writers wait forever
                # on a durability that will never come (ctpulint
                # worker-loops; the _sync_loop bug class)
                self._record_sync_failure(e)

    # -------------------------------------------------------------- replay

    def replay(self):
        """Yield (position, Mutation) for every intact record on disk
        (CommitLogReplayer semantics: stop a segment at the first torn
        record)."""
        for seg_id in self.segment_ids():
            yield from self._replay_file(self._seg_path(seg_id), seg_id)

    @staticmethod
    def _replay_file(path: str, seg_id: int):
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        enc = None
        comp = None
        if data.startswith(_ENC_MAGIC):
            from . import encryption as enc_mod
            ctx = enc_mod.get_context()
            if ctx is None:
                raise enc_mod.EncryptionError(
                    f"{path} is encrypted but no EncryptionContext is "
                    f"installed")
            enc = (ctx, int.from_bytes(data[8:12], "little"),
                   data[12:_ENC_HDR])
            pos = _ENC_HDR
        if data[pos:pos + len(_COMP_MAGIC)] == _COMP_MAGIC:
            from ..ops.codec import get_compressor
            nlen = data[pos + len(_COMP_MAGIC)]
            name = data[pos + len(_COMP_MAGIC) + 1:
                        pos + len(_COMP_MAGIC) + 1 + nlen].decode()
            comp = get_compressor(name)
            pos += len(_COMP_MAGIC) + 1 + nlen
        hdr = 12 if comp is not None else 8
        while pos + hdr <= len(data):
            if comp is not None:
                length, crc, raw_len = struct.unpack_from("<III", data,
                                                          pos)
            else:
                length, crc = struct.unpack_from("<II", data, pos)
                raw_len = length
            if length == 0 or pos + hdr + length > len(data):
                break  # torn tail
            payload = data[pos + hdr: pos + hdr + length]
            if zlib.crc32(payload) != crc:
                break  # corrupt tail
            if enc is not None:
                ctx, kid, nonce = enc
                payload = ctx.xor_at(kid, nonce, pos + hdr, payload)
            if comp is not None and length < raw_len:
                payload = comp.uncompress(bytes(payload), raw_len)
            yield CommitLogPosition(seg_id, pos), \
                Mutation.deserialize(bytes(payload))
            pos += hdr + length

    # ------------------------------------------------------------ archive

    def _archive(self, seg_id: int) -> None:
        """Copy a FINISHED (rotated/closed) segment to the archive
        (CommitLogArchiver.java:54 role; a directory copy stands in for
        the archive_command hook)."""
        if not self.archive_dir:
            return
        src = self._seg_path(seg_id)
        if not os.path.exists(src):
            return
        dst = os.path.join(self.archive_dir, os.path.basename(src))
        import shutil
        tmp = dst + ".tmp"
        shutil.copy2(src, tmp)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, dst)

    def _archive_loop(self) -> None:
        while True:
            self._archive_ev.wait()
            self._archive_ev.clear()
            while True:
                with self._lock:
                    if not self._archive_q:
                        break
                    seg = self._archive_q.pop(0)
                try:
                    self._archive(seg)
                except Exception:
                    # archiving is best-effort PITR copy; any failure
                    # (I/O or bug) skips this segment but must not end
                    # the archiver thread (ctpulint worker-loops)
                    pass
                with self._lock:
                    self._archiving.discard(seg)

    def _deletable(self, seg_id: int) -> bool:
        """A segment pending archive must not be deleted: its PITR copy
        hasn't landed yet."""
        return seg_id not in self._archiving

    @classmethod
    def replay_archived(cls, archive_dir: str):
        """Yield (position, Mutation) from archived segments in order —
        the restore half of PITR (CommitLogArchiver restore_directories
        + restore_point_in_time)."""
        segs = []
        for fn in os.listdir(archive_dir):
            m = _SEG_RE.match(fn)
            if m:
                segs.append((int(m.group(1)), fn))
        for seg_id, fn in sorted(segs):
            yield from cls._replay_file(os.path.join(archive_dir, fn),
                                        seg_id)

    # ----------------------------------------------------- flush lifecycle

    def discard_completed(self, table_id, upto: CommitLogPosition) -> None:
        """Mark a table's writes flushed up to `upto`; delete segments no
        table dirties anymore (CommitLog.discardCompletedSegments)."""
        with self._lock:
            # a segment at/after the flush point may hold post-switch writes
            # for this table, so only older segments become clean
            for seg_id in list(self._dirty):
                if seg_id < upto.segment_id:
                    self._dirty[seg_id].discard(table_id)
                    if not self._dirty[seg_id] and seg_id != self._seg_id \
                            and self._deletable(seg_id):
                        try:
                            os.remove(self._seg_path(seg_id))
                        except FileNotFoundError:
                            pass
                        del self._dirty[seg_id]

    def forget_table(self, table_id) -> None:
        """A dropped table's writes no longer pin segments."""
        with self._lock:
            for seg_id in list(self._dirty):
                self._dirty[seg_id].discard(table_id)
                if not self._dirty[seg_id] and seg_id != self._seg_id \
                        and self._deletable(seg_id):
                    try:
                        os.remove(self._seg_path(seg_id))
                    except FileNotFoundError:
                        pass
                    del self._dirty[seg_id]

    def current_position(self) -> CommitLogPosition:
        with self._lock:
            return CommitLogPosition(self._seg_id, self._file.tell())

    def delete_segments_before(self, seg_id: int) -> None:
        for s in self.segment_ids():
            if s < seg_id and self._deletable(s):
                try:
                    os.remove(self._seg_path(s))
                except FileNotFoundError:
                    pass
                self._dirty.pop(s, None)

    def stats(self) -> dict:
        """One consistent operator view (nodetool commitlogstats + the
        system_views.commitlog status row)."""
        with self._lock:
            dirty = sorted(self._dirty)
            retiring = len(self._retiring)
            pos = CommitLogPosition(
                self._seg_id,
                self._file.tell() if self._file and not self._file.closed
                else 0)
        with self._sync_cond:
            waiting = self._waiting
            synced = self._synced
        files = []
        for seg in self.segment_ids():
            p = self._seg_path(seg)
            try:
                files.append((os.path.basename(p), os.path.getsize(p)))
            except OSError:
                continue
        return {
            "sync_mode": self.sync_mode,
            "segments": len(files),
            "total_bytes": sum(sz for _fn, sz in files),
            "files": files,
            "active_segment": pos.segment_id,
            "active_offset": pos.offset,
            "oldest_dirty": dirty[0] if dirty else None,
            "pending_syncs": waiting + retiring,
            "synced_segment": synced.segment_id,
            "synced_offset": synced.offset,
            "sync_failures": self._sync_failures,
        }

    def close(self) -> None:
        self._stop.set()
        self._sync_req.set()
        if self._syncer:
            self._syncer.join(timeout=2)
        # retired segments the syncer didn't get to: finish them inline
        # (flush+fsync+close, then the PITR copy)
        with self._lock:
            retiring = self._retiring
            self._retiring = []
        for seg, rf in retiring:
            try:
                rf.flush()
                os.fsync(rf.fileno())
                rf.close()
            except (OSError, ValueError):
                pass
            self._archive(seg)
            with self._lock:
                self._archiving.discard(seg)
        # drain pending async archives BEFORE the final archive so the
        # directory copy is complete when close() returns
        deadline = 50
        while deadline and self._archiving:
            import time as _t
            _t.sleep(0.1)
            deadline -= 1
        with self._lock:
            if self._file and not self._file.closed:
                self._file.flush()
                os.fsync(self._file.fileno())
                final = CommitLogPosition(self._seg_id, self._file.tell())
                self._file.close()
                # a cleanly-closed active segment is archivable too
                self._archive(self._seg_id)
            else:
                final = None
        if final is not None:
            # everything is durable: release any writer still parked
            self._advance_synced(final)
