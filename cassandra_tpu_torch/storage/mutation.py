"""Mutation: the unit of write, serializable for the commitlog and for
internode transport.

Reference counterpart: db/Mutation.java:56 (a per-partition set of updates,
applied to commitlog + memtable in Keyspace.applyInternal, db/Keyspace.java:515).
Here a mutation is a flat list of cell operations on one partition of one
table — exactly what CellBatchBuilder.append_raw consumes, so commitlog
replay and memtable apply share one code path.
"""
from __future__ import annotations

import uuid as uuid_mod

from ..utils import varint as vi
from ..utils.timeutil import NO_DELETION_TIME


class Mutation:
    __slots__ = ("table_id", "pk", "ops")

    def __init__(self, table_id: uuid_mod.UUID, pk: bytes,
                 ops: list[tuple] | None = None):
        self.table_id = table_id
        self.pk = pk
        # op = (ck, column, path, value, ts, ldt, ttl, flags)
        self.ops: list[tuple] = ops or []

    def add(self, ck: bytes, column: int, path: bytes, value: bytes,
            ts: int, ldt: int = NO_DELETION_TIME, ttl: int = 0,
            flags: int = 0) -> None:
        self.ops.append((ck, column, path, value, ts, ldt, ttl, flags))

    def apply_to(self, builder) -> None:
        for ck, column, path, value, ts, ldt, ttl, flags in self.ops:
            builder.append_raw(self.pk, ck, column, path, value, ts,
                               ldt=ldt, ttl=ttl, flags=flags)

    @property
    def size(self) -> int:
        return sum(len(o[0]) + len(o[2]) + len(o[3]) + 32 for o in self.ops) \
            + len(self.pk) + 24

    # ------------------------------------------------------------- serde --

    def serialize(self) -> bytes:
        out = bytearray()
        out += self.table_id.bytes
        vi.write_unsigned_vint(len(self.pk), out)
        out += self.pk
        vi.write_unsigned_vint(len(self.ops), out)
        for ck, column, path, value, ts, ldt, ttl, flags in self.ops:
            vi.write_unsigned_vint(len(ck), out)
            out += ck
            vi.write_unsigned_vint(column, out)
            vi.write_unsigned_vint(len(path), out)
            out += path
            vi.write_unsigned_vint(len(value), out)
            out += value
            vi.write_signed_vint(ts, out)
            vi.write_signed_vint(ldt, out)
            vi.write_unsigned_vint(ttl, out)
            vi.write_unsigned_vint(flags, out)
        return bytes(out)

    @classmethod
    def deserialize(cls, data: bytes) -> "Mutation":
        tid = uuid_mod.UUID(bytes=bytes(data[:16]))
        pos = 16
        n, pos = vi.read_unsigned_vint(data, pos)
        pk = bytes(data[pos:pos + n])
        pos += n
        nops, pos = vi.read_unsigned_vint(data, pos)
        m = cls(tid, pk)
        for _ in range(nops):
            n, pos = vi.read_unsigned_vint(data, pos)
            ck = bytes(data[pos:pos + n])
            pos += n
            column, pos = vi.read_unsigned_vint(data, pos)
            n, pos = vi.read_unsigned_vint(data, pos)
            path = bytes(data[pos:pos + n])
            pos += n
            n, pos = vi.read_unsigned_vint(data, pos)
            value = bytes(data[pos:pos + n])
            pos += n
            ts, pos = vi.read_signed_vint(data, pos)
            ldt, pos = vi.read_signed_vint(data, pos)
            ttl, pos = vi.read_unsigned_vint(data, pos)
            flags, pos = vi.read_unsigned_vint(data, pos)
            m.ops.append((ck, column, path, value, ts, ldt, ttl, flags))
        return m
