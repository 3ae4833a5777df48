"""Wire codec for internode messages: a small self-describing binary
format for the payload shapes the verbs actually exchange — scalars,
str/bytes, tuples/lists/dicts, numpy arrays (columnar CellBatch fields
travel as raw dtype+shape+buffer), and Endpoints.

Reference counterpart: net/Message.java serializer + the per-verb
serializers (net/Verb.java payload serializers). Deliberately NOT pickle:
network input is untrusted, and pickle is an RCE surface
(the reference's serializers are likewise explicit per-type codecs).

Frame layout (tcp.py): [u32 length][u32 crc32(body)][body]
Body: encoded tuple (id, reply_to, verb, sender, to, payload,
trace_session, trace_events) — the trailing tracing headers are None
when the request is untraced; decoders tolerate legacy 6-tuples.
"""
from __future__ import annotations

import struct

import numpy as np

from ..utils import varint as vi
from .ring import Endpoint

_T_NONE = 0
_T_FALSE = 1
_T_TRUE = 2
_T_INT = 3          # signed vint
_T_FLOAT = 4        # f64
_T_STR = 5
_T_BYTES = 6
_T_TUPLE = 7
_T_LIST = 8
_T_DICT = 9
_T_NDARRAY = 10     # dtype-str, ndim, shape..., raw buffer
_T_ENDPOINT = 11
_T_BIGINT = 12      # arbitrary precision (ts values fit vint; uuids don't)

_MAX_DEPTH = 16


def _enc(obj, out: bytearray, depth: int = 0) -> None:
    if depth > _MAX_DEPTH:
        raise ValueError("wire object too deeply nested")
    if obj is None:
        out.append(_T_NONE)
    elif obj is False:
        out.append(_T_FALSE)
    elif obj is True:
        out.append(_T_TRUE)
    elif isinstance(obj, int):
        if -(1 << 62) <= obj < (1 << 62):
            out.append(_T_INT)
            vi.write_signed_vint(obj, out)
        else:
            out.append(_T_BIGINT)
            raw = obj.to_bytes((obj.bit_length() + 8) // 8 + 1, "big",
                               signed=True)
            vi.write_unsigned_vint(len(raw), out)
            out += raw
    elif isinstance(obj, float):
        out.append(_T_FLOAT)
        out += struct.pack("<d", obj)
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(_T_STR)
        vi.write_unsigned_vint(len(b), out)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(_T_BYTES)
        vi.write_unsigned_vint(len(b), out)
        out += b
    elif isinstance(obj, tuple):
        out.append(_T_TUPLE)
        vi.write_unsigned_vint(len(obj), out)
        for x in obj:
            _enc(x, out, depth + 1)
    elif isinstance(obj, list):
        out.append(_T_LIST)
        vi.write_unsigned_vint(len(obj), out)
        for x in obj:
            _enc(x, out, depth + 1)
    elif isinstance(obj, dict):
        out.append(_T_DICT)
        vi.write_unsigned_vint(len(obj), out)
        for k, v in obj.items():
            _enc(k, out, depth + 1)
            _enc(v, out, depth + 1)
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        ds = a.dtype.str.encode()
        out.append(_T_NDARRAY)
        vi.write_unsigned_vint(len(ds), out)
        out += ds
        vi.write_unsigned_vint(a.ndim, out)
        for d in a.shape:
            vi.write_unsigned_vint(d, out)
        raw = a.tobytes()
        vi.write_unsigned_vint(len(raw), out)
        out += raw
    elif isinstance(obj, Endpoint):
        out.append(_T_ENDPOINT)
        for f in (obj.name, obj.dc, obj.rack, obj.host):
            b = f.encode()
            vi.write_unsigned_vint(len(b), out)
            out += b
        vi.write_unsigned_vint(obj.port, out)
    elif isinstance(obj, (np.integer,)):
        _enc(int(obj), out, depth)
    elif isinstance(obj, (np.floating,)):
        _enc(float(obj), out, depth)
    else:
        raise TypeError(f"wire codec cannot encode {type(obj).__name__}")


# sane ceilings so a malformed/hostile frame cannot demand absurd allocs
_MAX_ELEMS = 1 << 24
_MAX_BLOB = 1 << 31


def _dec(buf: bytes, pos: int, depth: int = 0):
    if depth > _MAX_DEPTH:
        raise ValueError("wire object too deeply nested")
    tag = buf[pos]
    pos += 1
    if tag == _T_NONE:
        return None, pos
    if tag == _T_FALSE:
        return False, pos
    if tag == _T_TRUE:
        return True, pos
    if tag == _T_INT:
        return vi.read_signed_vint(buf, pos)
    if tag == _T_BIGINT:
        n, pos = vi.read_unsigned_vint(buf, pos)
        if n > 64:
            raise ValueError("bigint too large")
        return int.from_bytes(buf[pos:pos + n], "big", signed=True), pos + n
    if tag == _T_FLOAT:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag == _T_STR:
        n, pos = vi.read_unsigned_vint(buf, pos)
        if n > _MAX_BLOB:
            raise ValueError("string too large")
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if tag == _T_BYTES:
        n, pos = vi.read_unsigned_vint(buf, pos)
        if n > _MAX_BLOB:
            raise ValueError("blob too large")
        return bytes(buf[pos:pos + n]), pos + n
    if tag in (_T_TUPLE, _T_LIST):
        n, pos = vi.read_unsigned_vint(buf, pos)
        if n > _MAX_ELEMS:
            raise ValueError("sequence too large")
        items = []
        for _ in range(n):
            v, pos = _dec(buf, pos, depth + 1)
            items.append(v)
        return (tuple(items) if tag == _T_TUPLE else items), pos
    if tag == _T_DICT:
        n, pos = vi.read_unsigned_vint(buf, pos)
        if n > _MAX_ELEMS:
            raise ValueError("dict too large")
        d = {}
        for _ in range(n):
            k, pos = _dec(buf, pos, depth + 1)
            v, pos = _dec(buf, pos, depth + 1)
            d[k] = v
        return d, pos
    if tag == _T_NDARRAY:
        n, pos = vi.read_unsigned_vint(buf, pos)
        ds = bytes(buf[pos:pos + n]).decode()
        pos += n
        ndim, pos = vi.read_unsigned_vint(buf, pos)
        if ndim > 4:
            raise ValueError("ndarray rank too large")
        shape = []
        for _ in range(ndim):
            d, pos = vi.read_unsigned_vint(buf, pos)
            shape.append(d)
        nb, pos = vi.read_unsigned_vint(buf, pos)
        if nb > _MAX_BLOB:
            raise ValueError("ndarray too large")
        dt = np.dtype(ds)
        if dt.hasobject:
            raise ValueError("object dtypes are not wire-safe")
        a = np.frombuffer(buf[pos:pos + nb], dtype=dt).reshape(shape).copy()
        return a, pos + nb
    if tag == _T_ENDPOINT:
        fields = []
        for _ in range(4):
            n, pos = vi.read_unsigned_vint(buf, pos)
            fields.append(bytes(buf[pos:pos + n]).decode())
            pos += n
        port, pos = vi.read_unsigned_vint(buf, pos)
        return Endpoint(fields[0], fields[1], fields[2], fields[3],
                        port), pos
    raise ValueError(f"unknown wire tag {tag}")


def encode_message(msg) -> bytes:
    out = bytearray()
    _enc((msg.id, msg.reply_to, msg.verb, msg.sender, msg.to, msg.payload,
          msg.trace_session, msg.trace_events), out)
    return bytes(out)


def decode_message(buf: bytes):
    from .messaging import Message
    fields, _ = _dec(buf, 0)
    # 6-tuple frames predate the tracing headers; tolerate both
    mid, reply_to, verb, sender, to, payload = fields[:6]
    trace_session = fields[6] if len(fields) > 6 else None
    trace_events = fields[7] if len(fields) > 7 else None
    return Message(verb, payload, sender, to, mid, reply_to,
                   trace_session=trace_session,
                   trace_events=trace_events)
