"""CQL type system: Python value <-> serialized bytes (native-protocol
binary formats) and serialized bytes -> byte-comparable encoding.

Reference: src/java/org/apache/cassandra/db/marshal/ (50 AbstractType
subclasses; serialization formats are the public native-protocol v5 binary
formats, doc/native_protocol_v5.spec section 6). Byte-comparable encodings
are our own order-preserving design (utils/bytecomp.py) — the device merge
kernel compares them as fixed-width unsigned lanes.

Each type provides:
  serialize(py) -> bytes          deserialize(bytes) -> py
  to_bytecomp(serialized) -> bytes    (order == type's comparison order)
  validate(serialized)            (raises on malformed input)
"""
from __future__ import annotations

import ipaddress
import socket
import struct
import uuid as uuid_mod
from datetime import date, datetime, timedelta, timezone
from decimal import Decimal

from ..utils import bytecomp
from ..utils import varint as vi

_EPOCH_DATE_BIAS = 1 << 31  # SimpleDateType: unsigned days with 2^31 = 1970-01-01


class CQLType:
    name: str = "?"
    is_counter = False
    is_collection = False
    is_multicell = False  # non-frozen collections/UDTs

    def serialize(self, value) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes):
        raise NotImplementedError

    def to_bytecomp(self, data: bytes) -> bytes:
        """Map serialized form to byte-comparable form."""
        return data

    def validate(self, data: bytes) -> None:
        self.deserialize(data)

    def freeze(self) -> "CQLType":
        return self

    def __repr__(self):
        return self.name

    def __eq__(self, other):
        return isinstance(other, CQLType) and repr(self) == repr(other)

    def __hash__(self):
        return hash(repr(self))


class AsciiType(CQLType):
    name = "ascii"

    def serialize(self, value) -> bytes:
        b = value.encode("ascii") if isinstance(value, str) else bytes(value)
        b.decode("ascii")
        return b

    def deserialize(self, data: bytes):
        return data.decode("ascii")


class TextType(CQLType):
    name = "text"

    def serialize(self, value) -> bytes:
        return value.encode("utf-8") if isinstance(value, str) else bytes(value)

    def deserialize(self, data: bytes):
        return data.decode("utf-8")


class BlobType(CQLType):
    name = "blob"

    def serialize(self, value) -> bytes:
        return bytes(value)

    def deserialize(self, data: bytes):
        return bytes(data)

    def validate(self, data: bytes) -> None:
        pass


class BooleanType(CQLType):
    name = "boolean"

    def serialize(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def deserialize(self, data: bytes):
        return data != b"\x00"

    def to_bytecomp(self, data: bytes) -> bytes:
        return b"\x01" if data != b"\x00" else b"\x00"


class _FixedIntType(CQLType):
    width = 4

    def serialize(self, value) -> bytes:
        return int(value).to_bytes(self.width, "big", signed=True)

    def deserialize(self, data: bytes):
        return int.from_bytes(data, "big", signed=True)

    def to_bytecomp(self, data: bytes) -> bytes:
        # flip sign bit: unsigned lexicographic == signed numeric order
        return bytes([data[0] ^ 0x80]) + data[1:]

    def validate(self, data: bytes) -> None:
        if len(data) != self.width:
            raise ValueError(f"{self.name}: expected {self.width} bytes, got {len(data)}")


class TinyIntType(_FixedIntType):
    name = "tinyint"
    width = 1


class SmallIntType(_FixedIntType):
    name = "smallint"
    width = 2


class Int32Type(_FixedIntType):
    name = "int"
    width = 4


class LongType(_FixedIntType):
    name = "bigint"
    width = 8


class CounterColumnType(LongType):
    name = "counter"
    is_counter = True


class TimestampType(_FixedIntType):
    """Milliseconds since epoch, signed 64-bit (db/marshal/TimestampType)."""
    name = "timestamp"
    width = 8

    def serialize(self, value) -> bytes:
        if isinstance(value, datetime):
            value = int(value.timestamp() * 1000)
        return super().serialize(value)

    def deserialize(self, data: bytes):
        ms = int.from_bytes(data, "big", signed=True)
        return datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)


class SimpleDateType(CQLType):
    """Unsigned 32-bit days with 2^31 = 1970-01-01 (db/marshal/SimpleDateType)."""
    name = "date"

    def serialize(self, value) -> bytes:
        if isinstance(value, date) and not isinstance(value, datetime):
            days = (value - date(1970, 1, 1)).days
        else:
            days = int(value)
        return (days + _EPOCH_DATE_BIAS).to_bytes(4, "big")

    def deserialize(self, data: bytes):
        days = int.from_bytes(data, "big") - _EPOCH_DATE_BIAS
        return date(1970, 1, 1) + timedelta(days=days)

    def to_bytecomp(self, data: bytes) -> bytes:
        return data  # already unsigned big-endian


class TimeType(CQLType):
    """Nanoseconds since midnight, signed 64-bit, always >= 0."""
    name = "time"

    def serialize(self, value) -> bytes:
        return int(value).to_bytes(8, "big", signed=True)

    def deserialize(self, data: bytes):
        return int.from_bytes(data, "big", signed=True)

    def to_bytecomp(self, data: bytes) -> bytes:
        return data  # non-negative => plain BE ordering is numeric


class FloatType(CQLType):
    name = "float"

    def serialize(self, value) -> bytes:
        return struct.pack(">f", value)

    def deserialize(self, data: bytes):
        return struct.unpack(">f", data)[0]

    def to_bytecomp(self, data: bytes) -> bytes:
        return bytecomp.encode_float(struct.unpack(">f", data)[0], double=False)


class DoubleType(CQLType):
    name = "double"

    def serialize(self, value) -> bytes:
        return struct.pack(">d", value)

    def deserialize(self, data: bytes):
        return struct.unpack(">d", data)[0]

    def to_bytecomp(self, data: bytes) -> bytes:
        return bytecomp.encode_float(struct.unpack(">d", data)[0], double=True)


class IntegerType(CQLType):
    """Arbitrary-precision integer (varint): two's-complement BE bytes."""
    name = "varint"

    def serialize(self, value) -> bytes:
        v = int(value)
        # minimal two's-complement length (BigInteger.toByteArray semantics)
        length = ((v if v >= 0 else -v - 1).bit_length() // 8) + 1
        return v.to_bytes(length, "big", signed=True)

    def deserialize(self, data: bytes):
        return int.from_bytes(data, "big", signed=True)

    def to_bytecomp(self, data: bytes) -> bytes:
        return bytecomp.encode_varint(self.deserialize(data))


class DecimalType(CQLType):
    """scale (int32 BE) + unscaled varint (db/marshal/DecimalType)."""
    name = "decimal"

    def serialize(self, value) -> bytes:
        d = Decimal(value)
        sign, digits, exp = d.as_tuple()
        unscaled = int("".join(map(str, digits)))
        if sign:
            unscaled = -unscaled
        scale = -exp
        iv = IntegerType().serialize(unscaled)
        return struct.pack(">i", scale) + iv

    def deserialize(self, data: bytes):
        scale = struct.unpack_from(">i", data)[0]
        unscaled = int.from_bytes(data[4:], "big", signed=True)
        return Decimal(unscaled).scaleb(-scale)

    def to_bytecomp(self, data: bytes) -> bytes:
        """Order-preserving decimal: sign class byte, then exponent
        (complemented for negatives), then normalised mantissa digits."""
        d = self.deserialize(data)
        if d == 0:
            return b"\x80"
        sign, digits, exp = d.normalize().as_tuple()
        # value = mantissa(0.d1d2..) * 10^adj  with d1 != 0
        adj = exp + len(digits)
        mant = bytes(d + 1 for d in digits)  # digits 1..10, avoids 0x00
        eb = bytecomp.encode_int(adj, 4)
        if not sign:
            return b"\xc0" + eb + mant
        # negative: flip exponent and mantissa order
        inv_eb = bytes(0xFF - b for b in eb)
        inv_m = bytes(0xFF - b for b in mant)
        return b"\x40" + inv_eb + inv_m + b"\xff"  # terminator keeps prefix order


class UUIDType(CQLType):
    """Compare by version first, then v1 timestamp, then raw bytes
    (db/marshal/UUIDType.java compareCustom)."""
    name = "uuid"

    def serialize(self, value) -> bytes:
        if isinstance(value, uuid_mod.UUID):
            return value.bytes
        if isinstance(value, str):
            return uuid_mod.UUID(value).bytes
        return bytes(value)

    def deserialize(self, data: bytes):
        return uuid_mod.UUID(bytes=bytes(data))

    def to_bytecomp(self, data: bytes) -> bytes:
        u = uuid_mod.UUID(bytes=bytes(data))
        version = u.version or 0
        out = bytes([version])
        if version == 1:
            out += u.time.to_bytes(8, "big")
        return out + data

    def validate(self, data: bytes) -> None:
        if len(data) != 16:
            raise ValueError("uuid must be 16 bytes")


class TimeUUIDType(UUIDType):
    name = "timeuuid"

    def to_bytecomp(self, data: bytes) -> bytes:
        u = uuid_mod.UUID(bytes=bytes(data))
        return u.time.to_bytes(8, "big") + data

    def validate(self, data: bytes) -> None:
        super().validate(data)
        if uuid_mod.UUID(bytes=bytes(data)).version != 1:
            raise ValueError("timeuuid must be a version-1 uuid")


class InetAddressType(CQLType):
    name = "inet"

    def serialize(self, value) -> bytes:
        if isinstance(value, (bytes, bytearray)):
            return bytes(value)
        return ipaddress.ip_address(value).packed

    def deserialize(self, data: bytes):
        if len(data) == 4:
            return socket.inet_ntop(socket.AF_INET, data)
        return socket.inet_ntop(socket.AF_INET6, data)

    def validate(self, data: bytes) -> None:
        if len(data) not in (4, 16):
            raise ValueError("inet must be 4 or 16 bytes")


class DurationType(CQLType):
    """(months, days, nanos) signed vints (db/marshal/DurationType).
    Not orderable (cannot be a clustering column) — no to_bytecomp."""
    name = "duration"

    def serialize(self, value) -> bytes:
        months, days, nanos = value
        out = bytearray()
        vi.write_signed_vint(months, out)
        vi.write_signed_vint(days, out)
        vi.write_signed_vint(nanos, out)
        return bytes(out)

    def deserialize(self, data: bytes):
        months, pos = vi.read_signed_vint(data, 0)
        days, pos = vi.read_signed_vint(data, pos)
        nanos, _ = vi.read_signed_vint(data, pos)
        return (months, days, nanos)

    def to_bytecomp(self, data: bytes) -> bytes:
        raise TypeError("duration is not orderable")


class EmptyType(CQLType):
    name = "empty"

    def serialize(self, value) -> bytes:
        return b""

    def deserialize(self, data: bytes):
        if data:
            raise ValueError("empty type must have zero-length value")
        return None


# ------------------------------------------------------------ collections --

def _pack_elems(elems: list[bytes]) -> bytes:
    """Native-protocol collection body: count then [len][bytes] per element
    (len=-1 encodes null)."""
    out = bytearray(struct.pack(">i", len(elems)))
    for e in elems:
        if e is None:
            out += struct.pack(">i", -1)
        else:
            out += struct.pack(">i", len(e)) + e
    return bytes(out)


def _unpack_elems(data: bytes) -> list[bytes]:
    n = struct.unpack_from(">i", data, 0)[0]
    pos = 4
    out = []
    for _ in range(n):
        ln = struct.unpack_from(">i", data, pos)[0]
        pos += 4
        if ln < 0:
            out.append(None)
        else:
            out.append(bytes(data[pos:pos + ln]))
            pos += ln
    return out


class ListType(CQLType):
    is_collection = True

    def __init__(self, elem: CQLType, frozen: bool = False):
        self.elem = elem
        self.frozen = frozen
        self.is_multicell = not frozen

    @property
    def name(self):
        inner = f"list<{self.elem!r}>"
        return f"frozen<{inner}>" if self.frozen else inner

    def freeze(self):
        return ListType(self.elem, frozen=True)

    def serialize(self, value) -> bytes:
        return _pack_elems([self.elem.serialize(v) for v in value])

    def deserialize(self, data: bytes):
        return [self.elem.deserialize(e) for e in _unpack_elems(data)]

    def to_bytecomp(self, data: bytes) -> bytes:
        elems = _unpack_elems(data)
        return bytecomp.encode_composite(
            [self.elem.to_bytecomp(e) for e in elems])


class SetType(ListType):
    def __init__(self, elem: CQLType, frozen: bool = False):
        super().__init__(elem, frozen)

    @property
    def name(self):
        inner = f"set<{self.elem!r}>"
        return f"frozen<{inner}>" if self.frozen else inner

    def freeze(self):
        return SetType(self.elem, frozen=True)

    def serialize(self, value) -> bytes:
        # store in comparator (byte-comparable) element order
        elems = sorted((self.elem.serialize(v) for v in value),
                       key=self.elem.to_bytecomp)
        return _pack_elems(elems)

    def deserialize(self, data: bytes):
        return {self.elem.deserialize(e) for e in _unpack_elems(data)}

    def to_bytecomp(self, data: bytes) -> bytes:
        elems = sorted((self.elem.to_bytecomp(e) for e in _unpack_elems(data)))
        return bytecomp.encode_composite(elems)


class MapType(CQLType):
    is_collection = True

    def __init__(self, key: CQLType, val: CQLType, frozen: bool = False):
        self.key = key
        self.val = val
        self.frozen = frozen
        self.is_multicell = not frozen

    @property
    def name(self):
        inner = f"map<{self.key!r}, {self.val!r}>"
        return f"frozen<{inner}>" if self.frozen else inner

    def freeze(self):
        return MapType(self.key, self.val, frozen=True)

    def serialize(self, value) -> bytes:
        # comparator (byte-comparable) key order, like SetType
        items = sorted(((self.key.serialize(k), self.val.serialize(v))
                        for k, v in value.items()),
                       key=lambda kv: self.key.to_bytecomp(kv[0]))
        out = bytearray(struct.pack(">i", len(items)))
        for k, v in items:
            out += struct.pack(">i", len(k)) + k
            out += struct.pack(">i", len(v)) + v
        return bytes(out)

    def deserialize(self, data: bytes):
        n = struct.unpack_from(">i", data, 0)[0]
        pos = 4
        out = {}
        for _ in range(n):
            lk = struct.unpack_from(">i", data, pos)[0]
            pos += 4
            k = data[pos:pos + lk]
            pos += lk
            lv = struct.unpack_from(">i", data, pos)[0]
            pos += 4
            v = data[pos:pos + lv]
            pos += lv
            out[self.key.deserialize(k)] = self.val.deserialize(v)
        return out

    def to_bytecomp(self, data: bytes) -> bytes:
        d = self.deserialize(data)
        comps = []
        for k in sorted(d, key=lambda k: self.key.to_bytecomp(self.key.serialize(k))):
            comps.append(self.key.to_bytecomp(self.key.serialize(k)))
            comps.append(self.val.to_bytecomp(self.val.serialize(d[k])))
        return bytecomp.encode_composite(comps)


class TupleType(CQLType):
    def __init__(self, elems: list[CQLType]):
        self.elems = elems

    @property
    def name(self):
        return f"tuple<{', '.join(map(repr, self.elems))}>"

    def serialize(self, value) -> bytes:
        out = bytearray()
        for t, v in zip(self.elems, value):
            if v is None:
                out += struct.pack(">i", -1)
            else:
                s = t.serialize(v)
                out += struct.pack(">i", len(s)) + s
        return bytes(out)

    def deserialize(self, data: bytes):
        out = []
        pos = 0
        for t in self.elems:
            if pos >= len(data):
                out.append(None)
                continue
            ln = struct.unpack_from(">i", data, pos)[0]
            pos += 4
            if ln < 0:
                out.append(None)
            else:
                out.append(t.deserialize(data[pos:pos + ln]))
                pos += ln
        return tuple(out)

    def to_bytecomp(self, data: bytes) -> bytes:
        vals = self.deserialize(data)
        comps = []
        for t, v in zip(self.elems, vals):
            comps.append(b"" if v is None else b"\x01" + t.to_bytecomp(t.serialize(v)))
        return bytecomp.encode_composite(comps)


class UserType(TupleType):
    """Frozen UDT: same wire format as a tuple plus field names."""

    def __init__(self, keyspace: str, type_name: str, field_names: list[str],
                 field_types: list[CQLType]):
        super().__init__(field_types)
        self.keyspace = keyspace
        self.type_name = type_name
        self.field_names = field_names

    @property
    def name(self):
        return self.type_name

    def serialize(self, value) -> bytes:
        if isinstance(value, dict):
            value = tuple(value.get(f) for f in self.field_names)
        return super().serialize(value)

    def deserialize(self, data: bytes):
        vals = super().deserialize(data)
        return dict(zip(self.field_names, vals))


class VectorType(CQLType):
    """Fixed-dimension float32 vector (db/marshal/VectorType.java:45) —
    the ANN/SAI showcase type. Serialized as dim * 4 BE floats."""

    def __init__(self, elem: CQLType, dimension: int):
        if not isinstance(elem, FloatType):
            # reference supports any element type; we start with float32
            raise ValueError("vector element type must be float (round 1)")
        self.elem = elem
        self.dimension = dimension

    @property
    def name(self):
        return f"vector<float, {self.dimension}>"

    def serialize(self, value) -> bytes:
        if len(value) != self.dimension:
            raise ValueError(f"vector dimension mismatch: {len(value)} != {self.dimension}")
        return struct.pack(f">{self.dimension}f", *value)

    def deserialize(self, data: bytes):
        return list(struct.unpack(f">{self.dimension}f", data))

    def validate(self, data: bytes) -> None:
        if len(data) != 4 * self.dimension:
            raise ValueError("bad vector length")


# ---------------------------------------------------------------- parsing --

_SIMPLE_TYPES: dict[str, CQLType] = {}
for _cls in (AsciiType, TextType, BlobType, BooleanType, TinyIntType,
             SmallIntType, Int32Type, LongType, CounterColumnType, FloatType,
             DoubleType, DecimalType, IntegerType, TimestampType,
             SimpleDateType, TimeType, UUIDType, TimeUUIDType,
             InetAddressType, DurationType, EmptyType):
    _SIMPLE_TYPES[_cls.name] = _cls()
_SIMPLE_TYPES["varchar"] = _SIMPLE_TYPES["text"]

TYPE_REGISTRY = _SIMPLE_TYPES


def _split_args(s: str) -> list[str]:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur).strip())
    return parts


def parse_type(s: str, udts: dict[str, UserType] | None = None) -> CQLType:
    """Parse a CQL type string, e.g. 'map<text, frozen<list<int>>>'."""
    s = s.strip()
    low = s.lower()
    if low in _SIMPLE_TYPES:
        return _SIMPLE_TYPES[low]
    if low.startswith("frozen<") and s.endswith(">"):
        return parse_type(s[7:-1], udts).freeze()
    if low.startswith("list<") and s.endswith(">"):
        return ListType(parse_type(s[5:-1], udts))
    if low.startswith("set<") and s.endswith(">"):
        return SetType(parse_type(s[4:-1], udts))
    if low.startswith("map<") and s.endswith(">"):
        k, v = _split_args(s[4:-1])
        return MapType(parse_type(k, udts), parse_type(v, udts))
    if low.startswith("tuple<") and s.endswith(">"):
        return TupleType([parse_type(a, udts) for a in _split_args(s[6:-1])])
    if low.startswith("vector<") and s.endswith(">"):
        elem, dim = _split_args(s[7:-1])
        return VectorType(parse_type(elem, udts), int(dim))
    if udts and low in udts:
        return udts[low]
    raise ValueError(f"unknown type: {s!r}")
