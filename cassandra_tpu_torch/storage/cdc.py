"""Change data capture: a durable per-table stream of committed writes.

Reference counterpart: db/commitlog/CommitLogSegmentManagerCDC.java (the
reference hardlinks commitlog segments containing cdc-enabled tables'
writes into cdc_raw/ for consumers). The redesign here writes an
explicit per-table CDC log at apply time — the consumer reads clean,
single-table, CRC-framed mutation records instead of scanning shared
commitlog segments, and the space-cap semantics carry over
(cdc_total_space: writes to cdc tables FAIL when consumers lag, exactly
the reference's WriteTimeout-on-full behaviour).

Enable per table: CREATE TABLE ... WITH cdc = true. Consume:
    for offset, mutation in engine.cdc.read(table_id): ...
    engine.cdc.discard(table_id, upto_offset)   # consumer checkpoint
"""
from __future__ import annotations

import os
import struct
import threading
import zlib

from .mutation import Mutation

DEFAULT_SPACE_CAP = 64 << 20   # cdc_total_space default-ish bound


class CDCFullException(Exception):
    """cdc_raw is at capacity: the consumer is not keeping up (the
    reference fails cdc-table writes the same way)."""


class CDCLog:
    def __init__(self, directory: str,
                 space_cap: int = DEFAULT_SPACE_CAP):
        self.directory = directory
        self.space_cap = space_cap
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, table_id) -> str:
        return os.path.join(self.directory, f"{table_id.hex}.cdc")

    def append(self, mutation: Mutation) -> None:
        payload = mutation.serialize()
        frame = struct.pack("<II", len(payload), zlib.crc32(payload)) \
            + payload
        path = self._path(mutation.table_id)
        with self._lock:
            size = os.path.getsize(path) if os.path.exists(path) else 0
            if size + len(frame) > self.space_cap:
                raise CDCFullException(
                    f"cdc_raw at capacity for table {mutation.table_id}")
            with open(path, "ab") as f:
                f.write(frame)

    def read(self, table_id, from_offset: int = 0):
        """Yield (next_offset, Mutation) from the table's stream; a torn
        tail ends the iteration cleanly."""
        path = self._path(table_id)
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            f.seek(from_offset)
            data = f.read()
        pos = 0
        while pos + 8 <= len(data):
            ln, crc = struct.unpack_from("<II", data, pos)
            body = data[pos + 8:pos + 8 + ln]
            if len(body) < ln or zlib.crc32(body) != crc:
                return
            pos += 8 + ln
            yield from_offset + pos, Mutation.deserialize(body)

    def discard(self, table_id, upto_offset: int) -> None:
        """Consumer checkpoint: drop everything before upto_offset (the
        reference's cdc_raw file deletion after consumption)."""
        path = self._path(table_id)
        with self._lock:
            if not os.path.exists(path):
                return
            with open(path, "rb") as f:
                f.seek(upto_offset)
                rest = f.read()
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(rest)
            os.replace(tmp, path)

    def size(self, table_id) -> int:
        path = self._path(table_id)
        return os.path.getsize(path) if os.path.exists(path) else 0
