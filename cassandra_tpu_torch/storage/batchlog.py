"""Batchlog: atomicity for logged batches.

Reference counterpart: batchlog/BatchlogManager.java:89 — a logged batch is
persisted before any mutation applies and replayed on restart if the
coordinator died mid-batch; the record is deleted once every mutation is
durably applied. (The reference stores batches on remote batchlog
endpoints; this stores them in the coordinator's local batchlog directory —
same crash-atomicity per coordinator, remote placement arrives with
multi-node batchlog endpoints.)
"""
from __future__ import annotations

import os
import struct
import uuid as uuid_mod
import zlib

from .mutation import Mutation


class Batchlog:
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, bid: str) -> str:
        return os.path.join(self.directory, f"batch-{bid}.log")

    def store(self, mutations: list[Mutation]) -> str:
        bid = uuid_mod.uuid4().hex
        out = bytearray()
        for m in mutations:
            p = m.serialize()
            out += struct.pack("<II", len(p), zlib.crc32(p)) + p
        tmp = self._path(bid) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(out)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(bid))
        self._fsync_dir()   # the rename itself must survive power loss
        return bid

    def _fsync_dir(self) -> None:
        try:
            fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def remove(self, bid: str) -> None:
        try:
            os.remove(self._path(bid))
        except FileNotFoundError:
            pass
        self._fsync_dir()

    def pending(self):
        """Yield (bid, [mutations]) for batches whose apply never finished."""
        for fn in sorted(os.listdir(self.directory)):
            if not (fn.startswith("batch-") and fn.endswith(".log")):
                continue
            bid = fn[len("batch-"):-len(".log")]
            with open(os.path.join(self.directory, fn), "rb") as f:
                data = f.read()
            muts = []
            pos = 0
            ok = True
            while pos + 8 <= len(data):
                length, crc = struct.unpack_from("<II", data, pos)
                payload = data[pos + 8: pos + 8 + length]
                if len(payload) != length or zlib.crc32(payload) != crc:
                    ok = False
                    break
                muts.append(Mutation.deserialize(payload))
                pos += 8 + length
            if ok:
                yield bid, muts
