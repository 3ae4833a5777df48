"""Fault-injection filesystem checkpoints for the storage layer.

Reference counterpart: the reference exercises its FSError /
CorruptSSTableException machinery with byteman-injected faults in
dtests; this repo has no bytecode weaving, so the storage layer's file
I/O routes through thin named checkpoints instead. A test (or
scripts/chaos_storage.py) ARMS a failure point and the next I/O that
crosses the matching checkpoint fails exactly the way real hardware
would: EIO, a short read, a flipped bit, or a write torn after N bytes.

Failure points wired into the codebase (docs/fault-tolerance.md):

    sstable.open      component reads at SSTableReader open
    sstable.read      the Data.db segment pread in _decode_segment
    sstable.compress  the parallel-compress pool worker's pack job
                      (SSTableWriter._run_pack_job) — a worker EIO must
                      fail the writer like a serial compress error
    flush.write       SSTableWriter's data-write funnel (_write_sync) —
                      covers memtable flush AND compaction output
    commitlog.fsync   the fsync inside CommitLog._do_sync
    hints.read        the hint-file read in HintsService.dispatch
    stream.read       the sender pump's snapshot-chunk read
                      (cluster/stream_session.py)
    stream.net        the sender pump's chunk send — the only point
                      where the network modes (disconnect/latency)
                      bind; the path is the snapshot file behind the
                      chunk, so path_substr scopes by component
    stream.land       the receiver's staging writes AND the final
                      component landing (path = the component file, so
                      path_substr="TOC.txt" kills exactly the commit
                      point)

Modes:
    error        raise OSError(errno, ...) at the checkpoint (default
                 errno EIO)
    bitflip      flip one bit of the data crossing the checkpoint (the
                 CRC machinery downstream must detect it)
    short_read   deliver one byte less than requested
    torn_write   persist only the first `tear_bytes` bytes, then raise
    disconnect   drop the message crossing a network checkpoint (the
                 sender observes nothing — retransmit must recover)
    latency      delay the message crossing a network checkpoint by
                 `delay_s` seconds before delivering it intact

Arming is process-global (faults don't respect object boundaries any
more than disks do) and zero-cost when nothing is armed: every
checkpoint guards on `GLOBAL.active` first. `times`/`after` bound and
delay firing; `path_substr` scopes a point to matching paths so one
sstable's Data.db can be corrupted while its siblings stay healthy.
"""
from __future__ import annotations

import errno as _errno
import threading


class FaultPoint:
    """One armed failure point. Mutable counters are guarded by the
    registry lock."""

    __slots__ = ("point", "mode", "errno_", "times", "after",
                 "path_substr", "bit_offset", "tear_bytes", "delay_s",
                 "hits", "fires")

    def __init__(self, point: str, mode: str = "error",
                 errno_: int = _errno.EIO, times: int | None = None,
                 after: int = 0, path_substr: str | None = None,
                 bit_offset: int | None = None, tear_bytes: int = 0,
                 delay_s: float = 0.05):
        if mode not in ("error", "bitflip", "short_read", "torn_write",
                        "disconnect", "latency"):
            raise ValueError(f"unknown fault mode {mode!r}")
        self.point = point
        self.mode = mode
        self.errno_ = errno_
        self.times = times          # fire at most N times (None = forever)
        self.after = after          # skip the first N matching hits
        self.path_substr = path_substr
        self.bit_offset = bit_offset  # byte to flip (None = middle)
        self.tear_bytes = tear_bytes  # bytes persisted before the tear
        self.delay_s = delay_s        # latency-mode injected delay
        self.hits = 0
        self.fires = 0

    def make_error(self, path: str) -> OSError:
        return OSError(self.errno_,
                       f"injected fault at {self.point}", path or None)


class FaultRegistry:
    """Process-global registry of armed failure points."""

    def __init__(self):
        self._lock = threading.Lock()
        self._points: dict[str, FaultPoint] = {}

    # ------------------------------------------------------------- arming

    @property
    def active(self) -> bool:
        """Cheap guard for the hot paths: False ⇒ every checkpoint is a
        single attribute read."""
        return bool(self._points)

    def arm(self, point: str, mode: str = "error", **kw) -> FaultPoint:
        fp = FaultPoint(point, mode, **kw)
        with self._lock:
            self._points[point] = fp
        return fp

    def disarm(self, point: str | None = None) -> None:
        with self._lock:
            if point is None:
                self._points.clear()
            else:
                self._points.pop(point, None)

    def armed(self, point: str) -> FaultPoint | None:
        return self._points.get(point)

    def fires(self, point: str) -> int:
        fp = self._points.get(point)
        return fp.fires if fp is not None else 0

    # ----------------------------------------------------------- matching

    def _take(self, point: str, path: str, modes: tuple) -> FaultPoint | None:
        """Consume one firing of `point` if it is armed in one of
        `modes` and matches `path`; None otherwise. Each checkpoint
        kind consumes only its own modes so a bitflip-armed point is
        never double-counted by the error check at the same site."""
        fp = self._points.get(point)
        if fp is None or fp.mode not in modes:
            return None
        if fp.path_substr and fp.path_substr not in path:
            return None
        with self._lock:
            fp.hits += 1
            if fp.hits <= fp.after:
                return None
            if fp.times is not None and fp.fires >= fp.times:
                return None
            fp.fires += 1
        return fp

    # -------------------------------------------------------- checkpoints

    def check(self, point: str, path: str = "") -> None:
        """Error-mode checkpoint: raise the injected OSError."""
        fp = self._take(point, path, ("error",))
        if fp is not None:
            raise fp.make_error(path)

    def on_read(self, point: str, path: str, data: bytes) -> bytes:
        """Whole-buffer read checkpoint (component opens, hint files):
        error raises; bitflip/short_read transform the bytes."""
        self.check(point, path)
        fp = self._take(point, path, ("bitflip", "short_read"))
        if fp is None or not data:
            return data
        if fp.mode == "short_read":
            return data[:max(len(data) - 1, 0)]
        buf = bytearray(data)
        i = fp.bit_offset if fp.bit_offset is not None else len(buf) // 2
        buf[min(i, len(buf) - 1)] ^= 0x01
        return bytes(buf)

    def on_pread(self, point: str, path: str, iovs: list, got: int) -> int:
        """Scatter-read checkpoint (the sstable segment pread): error
        raises; short_read shrinks the byte count the caller observed;
        bitflip flips one bit in the largest landed buffer (the CRC
        check downstream must turn it into corruption). Returns the
        (possibly reduced) byte count."""
        self.check(point, path)
        fp = self._take(point, path, ("bitflip", "short_read"))
        if fp is None:
            return got
        if fp.mode == "short_read":
            return max(got - 1, 0)
        target = max(iovs, key=lambda v: v.nbytes)
        if target.nbytes:
            i = fp.bit_offset if fp.bit_offset is not None \
                else target.nbytes // 2
            i = min(i, target.nbytes - 1)
            target[i] ^= 0x01
        return got

    def on_net(self, point: str, path: str = "") -> bool:
        """Network checkpoint (the stream sender's chunk send): error
        raises; latency sleeps `delay_s` and delivers; disconnect
        returns True — the caller must DROP the message silently (a
        dead wire acks nothing; only retransmit recovers)."""
        self.check(point, path)
        fp = self._take(point, path, ("latency",))
        if fp is not None and fp.delay_s > 0:
            import time
            time.sleep(fp.delay_s)
        fp = self._take(point, path, ("disconnect",))
        return fp is not None

    def on_write(self, point: str, path: str, mv):
        """Write checkpoint: returns (bytes_to_write, error_to_raise).
        error raises before anything lands; torn_write returns the
        prefix that DOES land plus the OSError the caller must raise
        after writing it; bitflip returns a corrupted copy."""
        self.check(point, path)
        fp = self._take(point, path, ("bitflip", "torn_write"))
        if fp is None:
            return mv, None
        buf = bytearray(mv)
        if fp.mode == "torn_write":
            tear = min(fp.tear_bytes, len(buf))
            return memoryview(bytes(buf[:tear])), fp.make_error(path)
        i = fp.bit_offset if fp.bit_offset is not None else len(buf) // 2
        if buf:
            buf[min(i, len(buf) - 1)] ^= 0x01
        return memoryview(bytes(buf)), None


GLOBAL = FaultRegistry()


# module-level conveniences (tests / chaos driver)

def arm(point: str, mode: str = "error", **kw) -> FaultPoint:
    return GLOBAL.arm(point, mode, **kw)


def disarm(point: str | None = None) -> None:
    GLOBAL.disarm(point)


def check(point: str, path: str = "") -> None:
    if GLOBAL.active:
        GLOBAL.check(point, path)


def on_net(point: str, path: str = "") -> bool:
    """True = drop the message (disconnect armed); may sleep (latency)
    or raise (error). Zero-cost when nothing is armed."""
    if GLOBAL.active:
        return GLOBAL.on_net(point, path)
    return False


class inject:
    """Context manager: arm on enter, disarm on exit.

        with faultfs.inject("sstable.read", "bitflip",
                            path_substr="Data.db"):
            ...
    """

    def __init__(self, point: str, mode: str = "error", **kw):
        self.point = point
        self.mode = mode
        self.kw = kw
        self.fp: FaultPoint | None = None

    def __enter__(self) -> FaultPoint:
        self.fp = GLOBAL.arm(self.point, self.mode, **self.kw)
        return self.fp

    def __exit__(self, *exc):
        GLOBAL.disarm(self.point)
