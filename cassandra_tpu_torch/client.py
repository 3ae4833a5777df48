"""Minimal native-protocol client driver.

Reference counterpart: the DataStax python-driver's Cluster/Session
surface (the reference ships no in-tree driver; this one exists so the
framework is drivable over the WIRE without any external dependency, and
doubles as the conformance test harness for transport_server.py).

    from cassandra_tpu_torch.client import Cluster
    session = Cluster("127.0.0.1", 9042).connect()
    session.execute("USE ks")
    rows = session.execute("SELECT ... WHERE k = ?", [b"..."]).rows

Bound values are sent in wire encoding: pass `bytes` you serialized with
the column's CQL type, or let `serialize_params` do it from a schema
table. Paging: pass fetch_size / paging_state like the server-side
Session.
"""
from __future__ import annotations

import socket
import struct
import threading

from .transport import frame as ts


class DriverError(Exception):
    pass


# consistency-level names -> wire codes, shared with the server side
# (transport/frame.py is the single source of truth). The server tags
# the per-CL client_requests hists off the declared level; coordination
# CL policy is the backend's (cluster Node default_cl) for now.
CONSISTENCY_CODES = ts.CONSISTENCY_CODES


def _cl_code(consistency: str | int) -> int:
    if isinstance(consistency, int):
        return consistency
    try:
        return CONSISTENCY_CODES[consistency.upper()]
    except KeyError:
        raise DriverError(f"unknown consistency {consistency!r}") from None


class Rows:
    def __init__(self, column_names, rows, paging_state=None):
        self.column_names = column_names
        self.rows = rows
        self.paging_state = paging_state

    def __iter__(self):
        return iter(self.rows)


_DECODERS = {
    0x02: lambda b: struct.unpack(">q", b)[0],
    0x03: lambda b: b,
    0x04: lambda b: b != b"\x00",
    0x07: lambda b: struct.unpack(">d", b)[0],
    0x0B: lambda b: struct.unpack(">q", b)[0],
    0x0C: lambda b: __import__("uuid").UUID(bytes=b),
    0x0D: lambda b: b.decode(),
}


class ClientSession:
    def __init__(self, host: str, port: int, user: str | None = None,
                 password: str | None = None, tls: bool = False,
                 cafile: str | None = None, certfile: str | None = None,
                 keyfile: str | None = None, protocol_version: int = 5):
        """tls=True (or any of cafile/certfile) speaks TLS: the server
        is verified against `cafile` when given, and `certfile`/
        `keyfile` are presented when the server demands client certs.
        protocol_version 5 (default) switches to the v5 segment framing
        after the handshake; 4 keeps the legacy envelope stream."""
        self._sock = socket.create_connection((host, port), timeout=10.0)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if tls or cafile or certfile:
            from .cluster.tls import client_side_context
            self._sock = client_side_context(
                cafile, certfile, keyfile).wrap_socket(self._sock)
        self.version = protocol_version
        self._modern = False
        self._buf = bytearray()    # reassembled envelope bytes (v5)
        self._rbuf = bytearray()   # raw socket bytes (survives timeouts)
        self._stream = 0
        self._lock = threading.Lock()
        self._events: list = []
        self.on_event = None     # fn(event_type, info_dict)
        op, body = self._request(ts.OP_STARTUP,
                                 struct.pack(">H", 1)
                                 + ts._string("CQL_VERSION")
                                 + ts._string("3.4.5"))
        if op == ts.OP_READY and self.version >= 5:
            self._modern = True
        if op == ts.OP_AUTHENTICATE:
            if self.version >= 5:
                self._modern = True   # auth continues under v5 framing
            token = b"\x00" + (user or "").encode() + b"\x00" \
                + (password or "").encode()
            op, body = self._request(ts.OP_AUTH_RESPONSE, ts._bytes(token))
            if op != ts.OP_AUTH_SUCCESS:
                raise DriverError("authentication failed")
        elif op != ts.OP_READY:
            raise DriverError(f"unexpected startup response {op}")

    # ------------------------------------------------------------- frames

    def _send_envelope(self, stream: int, opcode: int,
                       body: bytes) -> None:
        env = struct.pack(">BBhBI", self.version, 0, stream, opcode,
                          len(body)) + body
        if self._modern:
            out = bytearray()
            for i in range(0, len(env), ts.MAX_SEGMENT_PAYLOAD):
                chunk = env[i:i + ts.MAX_SEGMENT_PAYLOAD]
                out += ts.encode_segment(
                    chunk, self_contained=len(env) == len(chunk))
            self._sock.sendall(bytes(out))
        else:
            self._sock.sendall(env)

    def _fill(self, n: int) -> None:
        """Buffer at least n raw bytes WITHOUT consuming them — a socket
        timeout mid-frame leaves everything read so far in _rbuf and the
        next call resumes cleanly (wait_event polls with timeouts)."""
        while len(self._rbuf) < n:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise DriverError("connection closed")
            self._rbuf += chunk

    def _take(self, n: int) -> bytes:
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    def _read_envelope(self):
        if not self._modern:
            self._fill(9)
            (length,) = struct.unpack_from(">I", self._rbuf, 5)
            self._fill(9 + length)
            hdr = self._take(9)
            _ver, _flags, rstream, op = struct.unpack(">BBhB", hdr[:5])
            return rstream, op, self._take(length)
        while True:
            if len(self._buf) >= 9:
                (length,) = struct.unpack_from(">I", self._buf, 5)
                if len(self._buf) >= 9 + length:
                    hdr = bytes(self._buf[:9])
                    body = bytes(self._buf[9:9 + length])
                    del self._buf[:9 + length]
                    _ver, _flags, rstream, op = struct.unpack(
                        ">BBhB", hdr[:5])
                    return rstream, op, body
            self._fill(6)
            plen, _sc = ts.decode_segment_header(bytes(self._rbuf[:6]))
            self._fill(6 + plen + 4)
            seg = self._take(6 + plen + 4)
            payload, crc = seg[6:6 + plen], seg[6 + plen:]
            if int.from_bytes(crc, "little") != ts._crc32_v5(payload):
                raise DriverError("segment CRC mismatch")
            self._buf += payload

    def _request(self, opcode: int, body: bytes):
        with self._lock:
            self._stream = (self._stream + 1) % 32768
            stream = self._stream
            self._send_envelope(stream, opcode, body)
            while True:
                rstream, op, rbody = self._read_envelope()
                if rstream == -1 and op == ts.OP_EVENT:
                    self._deliver_event(rbody)
                    continue
                if rstream != stream:
                    raise DriverError("stream mismatch")
                break
        self._fire_callbacks()
        return op, rbody

    # ------------------------------------------------------------- events

    def register(self, event_types: list[str]) -> None:
        """REGISTER for server-push events (STATUS_CHANGE /
        TOPOLOGY_CHANGE / SCHEMA_CHANGE); received events are queued and
        handed to self.on_event when set."""
        body = struct.pack(">H", len(event_types))
        for t in event_types:
            body += ts._string(t)
        op, _ = self._request(ts.OP_REGISTER, body)
        if op != ts.OP_READY:
            raise DriverError("REGISTER refused")

    def _deliver_event(self, body: bytes) -> None:
        """Parse an EVENT body onto the queue. Called under _lock;
        callbacks fire later via _fire_callbacks OUTSIDE the lock so an
        on_event handler may itself use this session."""
        etype, pos = ts._read_string(body, 0)
        info: dict = {"type": etype}
        if etype in ("STATUS_CHANGE", "TOPOLOGY_CHANGE"):
            info["change"], pos = ts._read_string(body, pos)
            alen = body[pos]
            pos += 1
            import ipaddress
            info["host"] = str(ipaddress.ip_address(
                bytes(body[pos:pos + alen])))
            pos += alen
            (info["port"],) = struct.unpack_from(">i", body, pos)
        elif etype == "SCHEMA_CHANGE":
            info["change"], pos = ts._read_string(body, pos)
            info["target"], pos = ts._read_string(body, pos)
            info["keyspace"], pos = ts._read_string(body, pos)
            if info["target"] != "KEYSPACE":
                info["name"], pos = ts._read_string(body, pos)
        self._events.append(info)

    def _fire_callbacks(self) -> None:
        cb = self.on_event
        if cb is None:
            return
        while True:
            with self._lock:
                if not self._events:
                    return
                info = self._events.pop(0)
            try:
                cb(info["type"], info)
            except Exception:
                pass

    def wait_event(self, timeout: float = 5.0):
        """Next pushed event (dict) or None on timeout. Must not race
        concurrent requests on this session (same lock). A timeout
        mid-frame is safe: partial bytes stay buffered and the next
        read resumes."""
        with self._lock:
            if self._events:
                return self._events.pop(0)
            old = self._sock.gettimeout()
            self._sock.settimeout(timeout)
            try:
                rstream, op, body = self._read_envelope()
                if rstream == -1 and op == ts.OP_EVENT:
                    self._deliver_event(body)
            except (TimeoutError, socket.timeout):
                return None
            finally:
                self._sock.settimeout(old)
            return self._events.pop(0) if self._events else None

    # -------------------------------------------------------------- query

    def execute(self, query: str, params: list[bytes | None] | None = None,
                fetch_size: int | None = None,
                paging_state: bytes | None = None,
                consistency: str | int = "ONE") -> Rows:
        body = bytearray()
        body += ts._long_string(query)
        body += struct.pack(">H", _cl_code(consistency))
        flags = 0
        if params:
            flags |= 0x01
        if fetch_size is not None:
            flags |= 0x04
        if paging_state is not None:
            flags |= 0x08
        if self.version >= 5:
            body += struct.pack(">I", flags)   # v5 widened flags to [int]
        else:
            body.append(flags)
        if params:
            body += struct.pack(">H", len(params))
            for p in params:
                body += ts._bytes(p)
        if fetch_size is not None:
            body += struct.pack(">i", fetch_size)
        if paging_state is not None:
            body += ts._bytes(paging_state)
        op, rbody = self._request(ts.OP_QUERY, bytes(body))
        return self._decode_result(op, rbody)

    def _decode_result(self, op: int, body: bytes) -> Rows:
        if op == ts.OP_ERROR:
            (code,) = struct.unpack_from(">i", body, 0)
            msg, _ = ts._read_string(body, 4)
            raise DriverError(f"[{code:#06x}] {msg}")
        if op != ts.OP_RESULT:
            raise DriverError(f"unexpected opcode {op}")
        (kind,) = struct.unpack_from(">i", body, 0)
        pos = 4
        if kind in (ts.RESULT_VOID, ts.RESULT_SCHEMA_CHANGE):
            return Rows([], [])
        if kind == ts.RESULT_SET_KEYSPACE:
            ks, _ = ts._read_string(body, pos)
            return Rows([], [])
        if kind != ts.RESULT_ROWS:
            raise DriverError(f"unsupported result kind {kind}")
        (flags,) = struct.unpack_from(">I", body, pos)
        pos += 4
        (ncols,) = struct.unpack_from(">i", body, pos)
        pos += 4
        paging = None
        if flags & 0x0002:
            paging, pos = ts._read_bytes(body, pos)
        if flags & 0x0001:
            _, pos = ts._read_string(body, pos)
            _, pos = ts._read_string(body, pos)
        names = []
        tids = []
        for _ in range(ncols):
            name, pos = ts._read_string(body, pos)
            (tid,) = struct.unpack_from(">H", body, pos)
            pos += 2
            names.append(name)
            tids.append(tid)
        (nrows,) = struct.unpack_from(">i", body, pos)
        pos += 4
        rows = []
        for _ in range(nrows):
            row = []
            for tid in tids:
                b, pos = ts._read_bytes(body, pos)
                if b is None:
                    row.append(None)
                else:
                    row.append(_DECODERS.get(tid, lambda x: x)(b))
            rows.append(tuple(row))
        return Rows(names, rows, paging)

    def prepare(self, query: str) -> bytes:
        req = ts._long_string(query)
        if self.version >= 5:
            req += struct.pack(">I", 0)    # v5 prepare flags
        op, body = self._request(ts.OP_PREPARE, req)
        if op == ts.OP_ERROR:
            (code,) = struct.unpack_from(">i", body, 0)
            msg, _ = ts._read_string(body, 4)
            raise DriverError(f"[{code:#06x}] {msg}")
        (kind,) = struct.unpack_from(">i", body, 0)
        if kind != ts.RESULT_PREPARED:
            raise DriverError(f"unexpected result kind {kind}")
        (n,) = struct.unpack_from(">H", body, 4)
        return bytes(body[6:6 + n])

    def execute_prepared(self, qid: bytes,
                         params: list[bytes | None] | None = None,
                         fetch_size: int | None = None,
                         paging_state: bytes | None = None,
                         consistency: str | int = "ONE") -> Rows:
        body = bytearray()
        body += struct.pack(">H", len(qid)) + qid
        if self.version >= 5:
            # v5 EXECUTE carries the result_metadata_id (server issues
            # the statement id for both)
            body += struct.pack(">H", len(qid)) + qid
        body += struct.pack(">H", _cl_code(consistency))
        flags = 0
        if params:
            flags |= 0x01
        if fetch_size is not None:
            flags |= 0x04
        if paging_state is not None:
            flags |= 0x08
        if self.version >= 5:
            body += struct.pack(">I", flags)
        else:
            body.append(flags)
        if params:
            body += struct.pack(">H", len(params))
            for p in params:
                body += ts._bytes(p)
        if fetch_size is not None:
            body += struct.pack(">i", fetch_size)
        if paging_state is not None:
            body += ts._bytes(paging_state)
        op, rbody = self._request(ts.OP_EXECUTE, bytes(body))
        return self._decode_result(op, rbody)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class Cluster:
    def __init__(self, host: str = "127.0.0.1", port: int = 9042,
                 user: str | None = None, password: str | None = None,
                 tls: bool = False, cafile: str | None = None,
                 certfile: str | None = None, keyfile: str | None = None,
                 protocol_version: int = 5):
        self.host, self.port = host, port
        self.user, self.password = user, password
        self.tls, self.cafile = tls, cafile
        self.certfile, self.keyfile = certfile, keyfile
        self.protocol_version = protocol_version

    def connect(self) -> ClientSession:
        return ClientSession(self.host, self.port, self.user,
                             self.password, tls=self.tls,
                             cafile=self.cafile, certfile=self.certfile,
                             keyfile=self.keyfile,
                             protocol_version=self.protocol_version)


def serialize_params(table, columns: list[str], values: list) -> list:
    """Wire-encode bind values using a schema table's column types."""
    out = []
    for c, v in zip(columns, values):
        out.append(None if v is None
                   else table.columns[c].cql_type.serialize(v))
    return out
