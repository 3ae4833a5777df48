"""TCP internode transport: real sockets behind the LocalTransport seam.

Reference counterpart: net/MessagingService.java:208 (outbound connection
pool per peer), net/HandshakeProtocol.java (magic + version + sender
identification before frames flow), net/FrameEncoder/FrameDecoderCrc
(length-prefixed CRC-protected frames).

Protocol:
  handshake: [8B magic b"CTPUNET1"][u32 crc of sender-endpoint blob]
             [u32 len][sender endpoint blob (wire codec)]
  frames:    [u32 len][u32 crc32(body)][body = wire-encoded message]

Failure model: a send to an unreachable/broken peer drops the frame and
tears down the cached connection — callers' callback timeouts drive
retries/hints exactly as with dropped packets. With a TLSConfig, every
internode connection is mutual TLS against the cluster CA (reference
server_encryption_options); without one, inbound connections are
accepted from anyone who completes the handshake (trusted network).
"""
from __future__ import annotations

import socket
import struct
import threading
import zlib

from . import wire
from .messaging import MessageFilters
from .ring import Endpoint

_MAGIC = b"CTPUNET1"
_MAX_FRAME = 256 << 20


class _Conn:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.lock = threading.Lock()

    def send_frame(self, body: bytes) -> None:
        hdr = struct.pack("<II", len(body), zlib.crc32(body))
        with self.lock:
            self.sock.sendall(hdr + body)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _read_frame(sock: socket.socket) -> bytes | None:
    hdr = _read_exact(sock, 8)
    if hdr is None:
        return None
    length, crc = struct.unpack("<II", hdr)
    if length > _MAX_FRAME:
        raise ValueError("frame too large")
    body = _read_exact(sock, length)
    if body is None or zlib.crc32(body) != crc:
        return None
    return body


class TcpTransport:
    """Socket transport for ONE node's MessagingService. register() binds
    the listen socket at the endpoint's (host, port); deliver() sends
    through a per-peer pooled connection, dialing on demand."""

    def __init__(self, tls=None):
        """tls: a cluster.tls.TLSConfig — when set, every internode
        connection is mutual TLS against the cluster CA (reference
        server_encryption_options internode_encryption: all); plaintext
        dials are rejected at handshake."""
        self.filters = MessageFilters()
        self._svc = None
        self._listen: socket.socket | None = None
        self._out: dict[Endpoint, _Conn] = {}
        self._lock = threading.Lock()
        self._closed = False
        # decode/deliver bugs that cost a serving thread its connection
        # (the broad guard in _serve_conn): counted so a silent
        # connect/drop loop is visible, not invisible
        self.serve_failures = 0
        self.tls = tls
        self._srv_ctx = tls.server_context() if tls else None
        self._cli_ctx = tls.client_context() if tls else None

    # ---------------------------------------------------------- lifecycle --

    def register(self, ep: Endpoint, svc) -> None:
        if self._svc is not None:
            raise RuntimeError("TcpTransport hosts exactly one node")
        self._svc = svc
        self._ep = ep
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((ep.host, ep.port))
        s.listen(64)
        if ep.port == 0:
            # kernel-assigned port: callers read it back via bound_port
            self.bound_port = s.getsockname()[1]
        else:
            self.bound_port = ep.port
        self._listen = s
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"tcp-accept-{ep.name}")
        t.start()

    def unregister(self, ep: Endpoint) -> None:
        self._closed = True
        if self._listen is not None:
            try:
                self._listen.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._out.values())
            self._out.clear()
        for c in conns:
            c.close()

    # ------------------------------------------------------------ outbound --

    def deliver(self, msg) -> None:
        if self.filters.should_drop(msg):
            return
        body = wire.encode_message(msg)
        conn = self._connection(msg.to)
        if conn is None:
            return          # unreachable: timeouts drive the failure path
        try:
            conn.send_frame(body)
        except OSError:
            with self._lock:
                if self._out.get(msg.to) is conn:
                    del self._out[msg.to]
            conn.close()

    def _connection(self, to: Endpoint) -> _Conn | None:
        with self._lock:
            conn = self._out.get(to)
        if conn is not None:
            return conn
        try:
            sock = socket.create_connection((to.host, to.port), timeout=2.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._cli_ctx is not None:
                import ssl
                try:
                    sock = self._cli_ctx.wrap_socket(sock)
                except (ssl.SSLError, OSError):
                    sock.close()
                    return None
            blob = bytearray()
            wire._enc(self._ep, blob)
            sock.sendall(_MAGIC + struct.pack("<II", zlib.crc32(bytes(blob)),
                                              len(blob)) + bytes(blob))
        except OSError:
            return None
        conn = _Conn(sock)
        with self._lock:
            existing = self._out.get(to)
            if existing is not None:
                conn.close()
                return existing
            self._out[to] = conn
        return conn

    # ------------------------------------------------------------- inbound --

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _addr = self._listen.accept()
            except OSError:
                return
            try:
                threading.Thread(target=self._serve_conn, args=(sock,),
                                 daemon=True).start()
            except Exception:
                # thread-limit exhaustion under a connection burst must
                # drop THIS connection, not end the accept loop — the
                # peer retries; a dead accept loop partitions the node
                # silently (ctpulint worker-loops)
                try:
                    sock.close()
                except OSError:
                    pass

    def _serve_conn(self, sock: socket.socket) -> None:
        if self._srv_ctx is not None:
            import ssl
            try:
                sock = self._srv_ctx.wrap_socket(sock, server_side=True)
            except (ssl.SSLError, OSError):
                # plaintext or untrusted-cert dial: refuse silently
                try:
                    sock.close()
                except OSError:
                    pass
                return
        try:
            magic = _read_exact(sock, len(_MAGIC))
            if magic != _MAGIC:
                sock.close()
                return
            hdr = _read_exact(sock, 8)
            if hdr is None:
                sock.close()
                return
            crc, length = struct.unpack("<II", hdr)
            if length > 65536:   # handshake blob is one Endpoint
                sock.close()
                return
            blob = _read_exact(sock, length)
            if blob is None or zlib.crc32(blob) != crc:
                sock.close()
                return
            wire._dec(blob, 0)   # sender endpoint (identification only)
            while not self._closed:
                body = _read_frame(sock)
                if body is None:
                    return
                try:
                    msg = wire.decode_message(body)
                except (ValueError, IndexError, KeyError, TypeError,
                        struct.error):
                    continue     # malformed frame: drop, keep the conn
                if self.filters.should_drop(msg):
                    continue
                svc = self._svc
                if svc is not None and not svc.closed:
                    svc.inbound(msg)
        except OSError:
            pass   # normal socket teardown: peer reset, EOF mid-frame
        except Exception:
            # a decode/deliver BUG also ends only this peer's
            # connection (the finally closes it; the peer reconnects) —
            # but unlike routine socket errors it is counted, so a
            # silent connect/drop loop shows up in the transport stats
            # instead of wedging invisibly (ctpulint worker-loops)
            self.serve_failures += 1
        finally:
            try:
                sock.close()
            except OSError:
                pass
