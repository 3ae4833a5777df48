"""Hinted handoff: mutations for unreachable replicas, stored locally and
replayed when the target comes back.

Reference counterpart: hints/ (HintsBuffer/HintsWriter — per-host
append-only files, HintsDispatchExecutor replay on recovery), entry via
StorageProxy.submitHint.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib

from ..storage.mutation import Mutation
from .ring import Endpoint


class HintsService:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self.metrics = {"written": 0, "replayed": 0}
        # nodetool disablehandoff: new hints are dropped (the reference's
        # StorageProxy.shouldHint gate)
        self.enabled = True
        # nodetool disablehintsfordc: DCs whose targets get no new hints
        self.disabled_dcs: set[str] = set()

    def _path(self, target: Endpoint) -> str:
        return os.path.join(self.directory, f"hints-{target.name}.db")

    def store(self, target: Endpoint, mutation: Mutation,
              redelivery: bool = False) -> None:
        """redelivery=True marks a hint being RE-stored after a failed
        dispatch send — those bypass the disablehandoff gate (the gate
        stops NEW hints only; already-persisted hints must never be
        silently dropped mid-replay; `nodetool truncatehints` is the
        explicit delete)."""
        if not self.enabled and not redelivery:
            return
        payload = mutation.serialize()
        frame = struct.pack("<II", len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            with open(self._path(target), "ab") as f:
                f.write(frame)
            self.metrics["written"] += 1

    def has_hints(self, target: Endpoint) -> bool:
        p = self._path(target)
        return os.path.exists(p) and os.path.getsize(p) > 0

    def dispatch(self, target: Endpoint, send_fn) -> int:
        """Replay hints for a recovered target through send_fn(mutation);
        the file is removed once fully dispatched.

        A CRC-corrupt RECORD is skipped and replay continues with the
        remainder (its length header still frames the stream; only the
        payload is rotten) — one flipped bit must not drop every hint
        queued behind it. Structural corruption (zero/overrunning
        length) makes the rest of the stream unframeable: replay stops
        there. Both count hints.corrupt_records."""
        from ..service.metrics import GLOBAL
        from ..utils import faultfs
        p = self._path(target)
        with self._lock:
            if not os.path.exists(p):
                return 0
            faultfs.check("hints.read", p)
            with open(p, "rb") as f:
                data = f.read()
            if faultfs.GLOBAL.active:
                data = faultfs.GLOBAL.on_read("hints.read", p, data)
            n = 0
            pos = 0
            while pos + 8 <= len(data):
                length, crc = struct.unpack_from("<II", data, pos)
                if length == 0 or pos + 8 + length > len(data):
                    GLOBAL.incr("hints.corrupt_records")
                    break
                payload = data[pos + 8: pos + 8 + length]
                pos += 8 + length
                if zlib.crc32(payload) != crc:
                    GLOBAL.incr("hints.corrupt_records")
                    continue
                send_fn(Mutation.deserialize(payload))
                n += 1
            os.remove(p)
            self.metrics["replayed"] += n
            return n

    def truncate(self, endpoint_name: str | None = None) -> int:
        """Delete persisted hint files (all, or one target's) under the
        service lock — `nodetool truncatehints` must not race a
        concurrent store()/dispatch() holding a file open (reference
        HintsService.deleteAllHints serializes through the catalog).
        Returns the number of files removed."""
        n = 0
        with self._lock:
            for fn in list(os.listdir(self.directory)):
                if not fn.startswith("hints-") or not fn.endswith(".db"):
                    continue
                if endpoint_name and fn != f"hints-{endpoint_name}.db":
                    continue
                os.remove(os.path.join(self.directory, fn))
                n += 1
        return n
