"""CQL native-protocol wire codec: envelopes, v5 segments, primitives.

Reference counterpart: transport/Envelope.java + transport/CQLMessageHandler
framing and the doc/native_protocol_v4.spec / v5.spec body notations.
Extracted from the original monolithic transport_server.py so the codec
is shared byte-for-byte by the event-loop server (transport/server.py),
the client driver (client.py) and the stress harness (scripts/stress.py).

Protocol v4 envelopes travel bare on the socket; v5 connections switch
to the modern segment framing after STARTUP: 3-byte little-endian header
(17-bit payload length + self-contained flag) protected by CRC24, then
the payload with a CRC32 trailer (v5.spec "Crc" section). Segments are a
transport-level layer: one segment may carry several envelopes and one
envelope may span several non-self-contained segments.
"""
from __future__ import annotations

import struct

VERSION_REQ = 0x04
VERSION_RSP = 0x84
SUPPORTED_VERSIONS = (0x04, 0x05)

OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_OPTIONS = 0x05
OP_SUPPORTED = 0x06
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_PREPARE = 0x09
OP_EXECUTE = 0x0A
OP_REGISTER = 0x0B
OP_EVENT = 0x0C
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

RESULT_VOID = 0x0001
RESULT_ROWS = 0x0002
RESULT_SET_KEYSPACE = 0x0003
RESULT_PREPARED = 0x0004
RESULT_SCHEMA_CHANGE = 0x0005

ERR_SERVER = 0x0000
ERR_PROTOCOL = 0x000A
ERR_BAD_CREDENTIALS = 0x0100
ERR_OVERLOADED = 0x1001
ERR_INVALID = 0x2200
ERR_UNPREPARED = 0x2500

EVENT_TYPES = ("TOPOLOGY_CHANGE", "STATUS_CHANGE", "SCHEMA_CHANGE")

# consistency-level wire codes (spec §3) — the ONE table both sides of
# the wire derive from: the client encodes names through it, the server
# tags the per-CL client_requests hists through its inverse
CONSISTENCY_CODES = {
    "ANY": 0x00, "ONE": 0x01, "TWO": 0x02, "THREE": 0x03,
    "QUORUM": 0x04, "ALL": 0x05, "LOCAL_QUORUM": 0x06,
    "EACH_QUORUM": 0x07, "SERIAL": 0x08, "LOCAL_SERIAL": 0x09,
    "LOCAL_ONE": 0x0A,
}
CONSISTENCY_NAMES = {code: name.lower()
                     for name, code in CONSISTENCY_CODES.items()}

# envelope body length cap (native_transport_max_frame_size ceiling —
# a length field larger than this is a framing error, not an allocation)
MAX_ENVELOPE_BODY = 256 << 20


# ------------------------------------------------- v5 segment framing ------

_CRC24_INIT = 0x875060
_CRC24_POLY = 0x1974F0B
_CRC32_INIT_BYTES = b"\xfa\x2d\x55\xca"
MAX_SEGMENT_PAYLOAD = (1 << 17) - 1


def _crc24(data: bytes) -> int:
    crc = _CRC24_INIT
    for b in data:
        crc ^= b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24_POLY
    return crc & 0xFFFFFF


def _crc32_v5(data: bytes) -> int:
    import zlib
    return zlib.crc32(data, zlib.crc32(_CRC32_INIT_BYTES)) & 0xFFFFFFFF


def encode_segment(payload: bytes, self_contained: bool = True) -> bytes:
    if len(payload) > MAX_SEGMENT_PAYLOAD:
        raise ValueError("segment payload too large")
    h = len(payload) | ((1 << 17) if self_contained else 0)
    hdr = h.to_bytes(3, "little")
    hdr += _crc24(hdr).to_bytes(3, "little")
    return hdr + payload + _crc32_v5(payload).to_bytes(4, "little")


def decode_segment_header(hdr6: bytes) -> tuple[int, bool]:
    """(payload_length, self_contained); raises on CRC mismatch."""
    if int.from_bytes(hdr6[3:6], "little") != _crc24(hdr6[:3]):
        raise ValueError("segment header CRC mismatch")
    h = int.from_bytes(hdr6[:3], "little")
    return h & MAX_SEGMENT_PAYLOAD, bool(h & (1 << 17))


def encode_envelope(ver_rsp: int, stream: int, op: int,
                    body: bytes) -> bytes:
    return struct.pack(">BBhBI", ver_rsp, 0, stream, op, len(body)) + body


def frame_envelope(env: bytes, modern: bool) -> bytes:
    """An envelope as it goes on the socket: bare (v4 / pre-STARTUP) or
    wrapped in one self-contained segment, split across several
    non-self-contained ones when it exceeds the 17-bit payload limit."""
    if not modern:
        return env
    if len(env) <= MAX_SEGMENT_PAYLOAD:
        return encode_segment(env, self_contained=True)
    out = bytearray()
    for i in range(0, len(env), MAX_SEGMENT_PAYLOAD):
        out += encode_segment(env[i:i + MAX_SEGMENT_PAYLOAD],
                              self_contained=False)
    return bytes(out)


class WireValue(bytes):
    """A bound value still in wire encoding; bind_term deserializes it
    against the statement's target type."""


# --------------------------------------------------------- body primitives --

def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def _long_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">I", len(b)) + b


def _bytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def _read_string(buf: bytes, pos: int) -> tuple[str, int]:
    (n,) = struct.unpack_from(">H", buf, pos)
    return buf[pos + 2:pos + 2 + n].decode(), pos + 2 + n


def _read_long_string(buf: bytes, pos: int) -> tuple[str, int]:
    (n,) = struct.unpack_from(">I", buf, pos)
    return buf[pos + 4:pos + 4 + n].decode(), pos + 4 + n


def _read_bytes(buf: bytes, pos: int):
    (n,) = struct.unpack_from(">i", buf, pos)
    pos += 4
    if n < 0:
        return None, pos
    return bytes(buf[pos:pos + n]), pos + n


def _read_string_map(buf: bytes, pos: int) -> tuple[dict, int]:
    (n,) = struct.unpack_from(">H", buf, pos)
    pos += 2
    out = {}
    for _ in range(n):
        k, pos = _read_string(buf, pos)
        v, pos = _read_string(buf, pos)
        out[k] = v
    return out, pos


def _inet(host: str, port: int) -> bytes:
    import ipaddress
    addr = ipaddress.ip_address(host).packed
    return bytes([len(addr)]) + addr + struct.pack(">i", port)


# ------------------------------------------------------- result encoding ---

def _infer_type(v):
    """(option_id, encoder) inferred from the Python value — metadata and
    encoding stay consistent with each other."""
    import datetime
    import uuid as uuid_mod
    if isinstance(v, bool):
        return 0x04, lambda x: b"\x01" if x else b"\x00"
    if isinstance(v, int):
        return 0x02, lambda x: struct.pack(">q", x)       # bigint
    if isinstance(v, float):
        return 0x07, lambda x: struct.pack(">d", x)       # double
    if isinstance(v, uuid_mod.UUID):
        return 0x0C, lambda x: x.bytes
    if isinstance(v, bytes):
        return 0x03, lambda x: x
    if isinstance(v, datetime.datetime):
        return 0x0B, lambda x: struct.pack(
            ">q", int(x.timestamp() * 1000))
    return 0x0D, lambda x: str(x).encode()                # varchar


def _encode_rows(rs) -> bytes:
    names = rs.column_names
    rows = rs.rows
    # per-column type from the first non-null value (varchar fallback)
    col_types = []
    for i in range(len(names)):
        sample = next((r[i] for r in rows if r[i] is not None), None)
        col_types.append(_infer_type(sample))
    flags = 0x0001                       # global table spec
    paging = getattr(rs, "paging_state", None)
    if paging is not None:
        flags |= 0x0002                  # has_more_pages
    body = bytearray()
    body += struct.pack(">i", RESULT_ROWS)
    body += struct.pack(">I", flags)
    body += struct.pack(">i", len(names))
    if paging is not None:
        body += _bytes(paging)
    body += _string("") + _string("")    # keyspace/table (opaque here)
    for name, (tid, _enc) in zip(names, col_types):
        body += _string(name)
        body += struct.pack(">H", tid)
    body += struct.pack(">i", len(rows))
    for r in rows:
        for v, (_tid, enc) in zip(r, col_types):
            body += _bytes(None if v is None else enc(v))
    return bytes(body)


def error_body(code: int, msg: str) -> bytes:
    return struct.pack(">i", code) + _string(msg)


def unprepared_body(qid: bytes) -> bytes:
    """v4/v5 UNPREPARED error: [int code][string msg][short bytes id] —
    the id echo is what lets drivers re-prepare and retry transparently
    (ErrorMessage.UnpreparedException encoding)."""
    return error_body(ERR_UNPREPARED,
                      "Prepared statement is stale or was evicted; "
                      "re-prepare and retry") \
        + struct.pack(">H", len(qid)) + qid
