"""Selector-based event-loop CQL native-protocol server.

Reference counterpart: transport/Server.java (Netty boss/worker event
loops), Dispatcher.java:104 (the request executor decoupling protocol
I/O from query execution) and CQLMessageHandler.java (framing state
machine). Replaces the original thread-per-connection transport_server:
a FIXED set of threads now serves any number of connections —

  N event-loop threads   (`native_transport_event_loops`) multiplex all
                         sockets through `selectors`: accept, TLS
                         handshakes, framing reassembly, response
                         writes. Connections are assigned round-robin
                         at accept time and owned by one loop for life.
  M dispatch workers     (`native_transport_max_threads`) execute
                         QUERY/PREPARE/EXECUTE bodies pulled from a
                         bounded hand-off queue — protocol parsing never
                         blocks on storage, and a slow query never
                         stalls unrelated connections on the same loop.

Admission control (transport/admission.py) runs on the event loop
BEFORE a request reaches the workers: per-client ops rate limiting,
data-plane overload signals (storage.write_stall / commitlog sync
backlog) and the `native_transport_max_concurrent_requests` permit gate
each answer with a v5 OVERLOADED error instead of queueing forever.

Wire behavior (STARTUP/AUTH/OPTIONS/QUERY/PREPARE/EXECUTE/REGISTER,
v4 envelopes + v5 CRC segment framing, paging, events) is byte-
compatible with the original server — the codec lives in frame.py and
every pre-existing protocol test runs unchanged against this server.

Writes are never performed off-loop: responses and event pushes append
to a per-connection outgoing buffer and the owning loop flushes when
the socket is writable. A client that stops reading (slow consumer) is
disconnected and counted (`clients.slow_consumer_disconnects`) once its
buffer exceeds the cap, rather than wedging a loop or an emitter.
"""
from __future__ import annotations

import collections
import queue as queue_mod
import selectors
import socket
import ssl
import struct
import threading
import time

from ..cql.processor import QueryProcessor
from ..service.metrics import GLOBAL as METRICS
from ..utils.ratelimit import RateLimiter
from ..utils import lockwitness
from .admission import OverloadSignals, PermitGate
from .frame import (CONSISTENCY_NAMES, ERR_BAD_CREDENTIALS, ERR_INVALID,
                    ERR_OVERLOADED, ERR_PROTOCOL, ERR_SERVER, EVENT_TYPES,
                    MAX_ENVELOPE_BODY, OP_AUTH_RESPONSE, OP_AUTH_SUCCESS,
                    OP_AUTHENTICATE, OP_ERROR, OP_EVENT, OP_EXECUTE,
                    OP_OPTIONS, OP_PREPARE,
                    OP_QUERY, OP_READY, OP_REGISTER, OP_RESULT, OP_STARTUP,
                    OP_SUPPORTED, RESULT_PREPARED, RESULT_SET_KEYSPACE,
                    RESULT_VOID, SUPPORTED_VERSIONS, WireValue, _bytes,
                    _crc32_v5, _encode_rows, _inet, _read_bytes,
                    _read_long_string, _read_string, _string,
                    decode_segment_header, encode_envelope, error_body,
                    frame_envelope, unprepared_body)

# opcodes that run on the dispatch executor; everything else (handshake,
# registration) is cheap enough to handle inline on the event loop
DISPATCH_OPCODES = frozenset((OP_QUERY, OP_PREPARE, OP_EXECUTE))

# a connection whose unsent response bytes exceed this is a slow
# consumer and gets disconnected rather than growing without bound
OUT_BUFFER_CAP = 32 << 20
# server-push events are fire-and-forget: a much smaller backlog of
# unread pushes already proves the client stopped reading
EVENT_BACKLOG_CAP = 256 << 10


def server_thread_count(port: int) -> int:
    """Live threads belonging to the CQLServer on `port` (event loops +
    dispatch workers) — the measuring stick for the fixed-thread-set
    contract, shared by the stress smoke drill, the bench sampler and
    the tests so they can never drift from the naming scheme."""
    pfx = (f"cql-loop-{port}-", f"cql-exec-{port}-")
    return len([t for t in threading.enumerate()
                if t.name.startswith(pfx) and t.is_alive()])


def _error_response(e: Exception) -> tuple[int, bytes]:
    """Uncaught execution error -> wire ERROR (InvalidRequest subclasses
    ValueError, so CQL-level rejections map to 0x2200; everything else
    is a server bug, 0x0000)."""
    code = ERR_INVALID if isinstance(e, ValueError) else ERR_SERVER
    return OP_ERROR, error_body(code, f"{type(e).__name__}: {e}")


def _cert_identity(sock) -> str | None:
    """The VERIFIED client certificate's identity: SAN URI (SPIFFE
    style) preferred, else subject CN (MutualTlsAuthenticator's
    identity extraction). None for plaintext / cert-less TLS."""
    if not isinstance(sock, ssl.SSLSocket):
        return None
    try:
        cert = sock.getpeercert()
    except ssl.SSLError:
        return None
    if not cert:
        return None
    for typ, val in cert.get("subjectAltName", ()):
        if typ == "URI":
            return val
    for rdn in cert.get("subject", ()):
        for k, v in rdn:
            if k == "commonName":
                return v
    return None


class Connection:
    """Per-connection state, owned by exactly one event loop (the
    ServerConnection + CQLMessageHandler roles). Reads, framing and
    socket writes happen only on the owning loop thread; dispatch
    workers and event emitters hand bytes over via `enqueue`."""

    def __init__(self, server: "CQLServer", loop: "_EventLoop", sock,
                 cid: int, peer: str, peer_ip: str | None,
                 handshaking: bool):
        self.server = server
        self.loop = loop
        self.sock = sock
        self.cid = cid
        self.peer = peer
        self.peer_ip = peer_ip
        self.version: int | None = None
        self.modern = False            # v5 segment framing active
        self.keyspace: str | None = None
        self.user: str | None = None
        self.authed = False
        self.tls_identity: str | None = None
        self.registrations: set[str] = set()
        self.handshaking = handshaking  # TLS handshake still pending
        self.closing = False
        self.close_when_drained = False  # flush the error, then close
        self.rbuf = bytearray()        # raw (decrypted) socket bytes
        self.ebuf = bytearray()        # reassembled envelope bytes (v5)
        self.out = bytearray()         # encoded, not-yet-sent bytes
        self._wchunk: bytes | None = None   # chunk mid-send
        self._write_armed = False
        self._event_backlog = 0        # event bytes since the last drain
        self.paused_reads = False      # response backpressure engaged
        self.wlock = lockwitness.make_lock("transport.conn.wlock")
        self.in_flight = 0             # admitted, response not yet queued
        self.rate_limited = 0          # requests shed by the ops limiter
        self.limiter = RateLimiter(server.rate_limit_ops, unit=1.0)

    # ------------------------------------------------------ write path --

    def send_envelope(self, ver_rsp: int, stream: int, op: int,
                      body: bytes, legacy: bool = False) -> None:
        env = encode_envelope(ver_rsp, stream, op, body)
        self.enqueue(frame_envelope(env, self.modern and not legacy))

    def send_error(self, stream: int, code: int, msg: str) -> None:
        self.send_envelope(0x80 | (self.version or 0x04), stream,
                           OP_ERROR, error_body(code, msg))

    def enqueue(self, data: bytes, event: bool = False) -> bool:
        """Append encoded bytes for the loop to flush. Never blocks the
        caller. Two distinct protections:

        - RESPONSE backlog past OUT_BUFFER_CAP engages BACKPRESSURE:
          the loop stops reading this connection (no new requests get
          parsed or admitted) until the buffer drains — the event-loop
          analog of the old server blocking in sendall. Memory stays
          bounded (already-admitted responses only), the client keeps
          its data, nobody is disconnected for being slower than
          in-process response production.
        - EVENT pushes are fire-and-forget with no request to pace
          them, so a push backlog (own accumulated bytes since the
          last full drain — a draining response must not count) past
          EVENT_BACKLOG_CAP marks a true slow consumer: disconnected
          and counted rather than growing without bound."""
        wake = slow = pause = dropped = False
        with self.wlock:
            if self.closing:
                return False
            if event:
                if len(self.out) + len(data) > OUT_BUFFER_CAP:
                    # fire-and-forget: a client this far behind does
                    # not need more events QUEUED — drop the push,
                    # keep the connection (the old server dropped the
                    # oldest event when its queue filled)
                    dropped = True
                else:
                    self._event_backlog += len(data)
                    if self._event_backlog > EVENT_BACKLOG_CAP:
                        slow = True
                        self.closing = True
            if not slow and not dropped:
                self.out += data
                if not event and len(self.out) > OUT_BUFFER_CAP \
                        and not self.paused_reads:
                    self.paused_reads = True
                    pause = True
                if not self._write_armed:
                    self._write_armed = True
                    wake = True
        if dropped:
            METRICS.incr("clients.events_dropped")
            return False
        if slow:
            METRICS.incr("clients.slow_consumer_disconnects")
            from ..service import diagnostics
            diagnostics.publish("transport.slow_consumer",
                                address=self.peer,
                                backlog=self._event_backlog)
            self.loop.call(lambda: self.loop.close_conn(self))
            return False
        if pause:
            self.loop.call(lambda: self.loop.pause_reads(self))
        if wake:
            self.loop.call(lambda: self.loop.arm_write(self))
        return True

    def take_chunk(self):
        """What to send next (loop thread only). Swaps the WHOLE
        accumulated buffer out in one move and walks it with a
        memoryview cursor — a del-from-front drain would memmove the
        remaining buffer per send call, quadratic for multi-MiB
        responses, stalling every connection sharing the loop. The view
        stays stable across partial sends (the OpenSSL retry rule)."""
        if self._wchunk is None:
            with self.wlock:
                if not self.out:
                    return None
                self._wchunk = memoryview(bytes(self.out))
                self.out = bytearray()
        return self._wchunk

    def chunk_sent(self, n: int) -> None:
        assert self._wchunk is not None
        self._wchunk = self._wchunk[n:] if n < len(self._wchunk) else None
        if n > 0:
            # forward progress proves the client is reading: reset the
            # event-backlog accounting, so a steadily-draining (however
            # slow) consumer of a large response is never killed by an
            # unlucky event. A truly stalled client makes no progress,
            # accumulates, and still gets disconnected; memory for a
            # trickling one stays bounded by the event-drop rule above.
            self._event_backlog = 0

    def drained(self) -> bool:
        """True (and disarms the write interest) iff nothing is pending;
        called by the loop after a flush pass. A full drain also resets
        the event-backlog accounting: this client is provably reading."""
        if self._wchunk is not None:
            return False
        with self.wlock:
            if self.out:
                return False
            self._write_armed = False
            self._event_backlog = 0
            return True


class _EventLoop(threading.Thread):
    """One selector thread serving many connections. Work from other
    threads (response enqueues, close requests, new connections) arrives
    through `call`, which wakes the selector via a socketpair."""

    def __init__(self, server: "CQLServer", idx: int):
        super().__init__(daemon=True,
                         name=f"cql-loop-{server.port}-{idx}")
        self.server = server
        self.sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self.sel.register(self._wake_r, selectors.EVENT_READ,
                          ("wake", None))
        self._jobs: collections.deque = collections.deque()
        self.conns: set[Connection] = set()

    def call(self, fn) -> None:
        """Run fn on the loop thread. Calls made FROM the loop thread
        (inline responses, event pushes fanned out by a handler) run
        immediately — no queue round trip, no self-wake."""
        if threading.current_thread() is self:
            try:
                fn()
            except Exception:
                pass
            return
        self._jobs.append(fn)
        self.wake()

    def wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except (OSError, BlockingIOError):
            pass   # full pipe still wakes the selector

    # --------------------------------------------------- loop lifecycle --

    def run(self) -> None:
        while not self.server._closed:
            try:
                events = self.sel.select(timeout=0.5)
            except OSError:
                break
            while self._jobs:
                fn = self._jobs.popleft()
                try:
                    fn()
                except Exception:
                    pass
            for key, mask in events:
                kind, obj = key.data
                try:
                    if kind == "wake":
                        self._drain_wake()
                    elif kind == "accept":
                        self.server._on_accept()
                    elif kind == "conn" and obj in self.conns:
                        self._on_ready(obj, mask)
                except Exception:
                    # a bug in one connection's handling costs THAT
                    # connection at most — never the loop, which owns
                    # every other connection assigned to it (ctpulint
                    # worker-loops; the close path below is defensive
                    # against double-close). Counted: a recurring loop
                    # error must show in clientstats, not vanish.
                    METRICS.incr("clients.loop_errors")
                    if kind == "conn":
                        try:
                            self.close_conn(obj)
                        except Exception:
                            pass
        for conn in list(self.conns):
            self.close_conn(conn)
        try:
            self.sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    # ------------------------------------------------ connection events --

    def add_conn(self, conn: Connection) -> None:
        conn.sock.setblocking(False)
        self.conns.add(conn)
        try:
            self.sel.register(conn.sock, selectors.EVENT_READ,
                              ("conn", conn))
        except (OSError, ValueError):
            self.close_conn(conn)
            return
        if conn.handshaking:
            self._continue_handshake(conn)

    def _interest(self, conn: Connection, mask: int) -> None:
        try:
            self.sel.modify(conn.sock, mask, ("conn", conn))
        except (KeyError, OSError, ValueError):
            pass

    def arm_write(self, conn: Connection) -> None:
        if conn.closing or conn not in self.conns:
            return
        if conn.handshaking:
            return   # handshake owns the interest set until done
        # opportunistic immediate flush: the socket is almost always
        # writable, so most responses go out right here instead of
        # paying another select round; _flush arms EVENT_WRITE interest
        # only for the leftover-bytes case
        self._flush(conn)

    def pause_reads(self, conn: Connection) -> None:
        """Response backpressure: stop reading (and so admitting) from
        this connection until its outgoing buffer drains."""
        if conn.closing or conn not in self.conns or conn.handshaking:
            return
        if conn.paused_reads:
            self._interest(conn, selectors.EVENT_WRITE)

    def close_conn(self, conn: Connection) -> None:
        if conn not in self.conns:
            return
        with conn.wlock:
            conn.closing = True
        self.conns.discard(conn)
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, OSError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self.server._forget(conn)

    def _continue_handshake(self, conn: Connection) -> None:
        try:
            conn.sock.do_handshake()
        except ssl.SSLWantReadError:
            self._interest(conn, selectors.EVENT_READ)
            return
        except ssl.SSLWantWriteError:
            self._interest(conn, selectors.EVENT_WRITE)
            return
        except (ssl.SSLError, OSError):
            self.close_conn(conn)
            return
        conn.handshaking = False
        conn.tls_identity = _cert_identity(conn.sock)
        self._interest(conn, selectors.EVENT_READ)
        if conn._write_armed:
            self.arm_write(conn)
        # a client may pipeline its first envelope into the final
        # handshake flight: OpenSSL has already pulled those bytes off
        # the kernel socket, so the selector will never fire for them —
        # drain the SSL layer's buffer now
        if conn in self.conns:
            self._read_ready(conn)

    def _on_ready(self, conn: Connection, mask: int) -> None:
        if conn.handshaking:
            self._continue_handshake(conn)
            return
        if mask & selectors.EVENT_WRITE:
            self._flush(conn)
        if conn.closing or conn not in self.conns:
            return
        if mask & selectors.EVENT_READ:
            self._read_ready(conn)

    def _flush(self, conn: Connection) -> None:
        while True:
            chunk = conn.take_chunk()
            if chunk is None:
                # out looked empty — but a worker may have appended
                # between take_chunk's lock release and here, with
                # _write_armed still set (so it sent no wake). Only
                # drained() — which clears _write_armed under the same
                # lock — decides the buffer is truly dry; if it says
                # no, loop and pick the new bytes up NOW, or the
                # connection would stall forever with read-only
                # interest and no future wake.
                if conn.drained():
                    if conn.close_when_drained:
                        self.close_conn(conn)
                        return
                    resume = False
                    with conn.wlock:
                        if conn.paused_reads:
                            conn.paused_reads = False
                            resume = True
                    self._interest(conn, selectors.EVENT_READ)
                    if resume:
                        # bytes may have piled up in the kernel while
                        # reads were paused — pick them up now
                        self._read_ready(conn)
                    return
                continue
            try:
                sent = conn.sock.send(chunk)
            except (BlockingIOError, ssl.SSLWantWriteError,
                    ssl.SSLWantReadError):
                # kernel buffer full: let the selector call us back
                # (write-only while response backpressure is engaged)
                self._interest(conn, selectors.EVENT_WRITE if
                               conn.paused_reads else
                               selectors.EVENT_READ
                               | selectors.EVENT_WRITE)
                return
            except OSError:
                self.close_conn(conn)
                return
            conn.chunk_sent(sent)

    def _read_ready(self, conn: Connection) -> None:
        while True:
            try:
                chunk = conn.sock.recv(1 << 16)
            except (BlockingIOError, ssl.SSLWantReadError,
                    ssl.SSLWantWriteError):
                break
            except (OSError, ssl.SSLError):
                self.close_conn(conn)
                return
            if not chunk:
                self.close_conn(conn)
                return
            if conn.close_when_drained or conn.closing:
                # dying connection: keep recv'ing only to notice EOF —
                # buffering a stream we will never parse would let a
                # client that ignores its error grow rbuf without bound
                continue
            conn.rbuf += chunk
        if not conn.close_when_drained and not conn.closing:
            self.server._parse(conn)


class _Dispatcher:
    """Bounded request executor (Dispatcher.java role): admitted
    requests are handed from the event loops to `n_threads` workers.
    The queue never grows past the permit cap — admission happens
    before submit — so there is no unbounded queueing anywhere on the
    request path."""

    def __init__(self, server: "CQLServer", n_threads: int):
        self.server = server
        self.queue: queue_mod.Queue = queue_mod.Queue()
        # unified pipeline ledger stage (utils/pipeline_ledger.py):
        # busy = request execution, idle = workers parked on an empty
        # queue, queue_hwm = dispatch backlog high-water — the
        # front-door leg of the where-did-the-wall-go table
        from ..utils import pipeline_ledger
        self._stage = pipeline_ledger.ledger("transport") \
            .stage("dispatch")
        self.threads = [
            threading.Thread(target=self._work, daemon=True,
                             name=f"cql-exec-{server.port}-{i}")
            for i in range(max(1, n_threads))]
        for t in self.threads:
            t.start()

    def submit(self, conn: Connection, stream: int, opcode: int,
               body: bytes) -> None:
        self.queue.put((conn, stream, opcode, body))
        self._stage.note_queue(self.queue.qsize())

    def shutdown(self) -> None:
        for _ in self.threads:
            self.queue.put(None)

    def _work(self) -> None:
        srv = self.server
        while True:
            t_idle = time.monotonic()
            item = self.queue.get()
            t0 = time.monotonic()
            self._stage.add_idle(t0 - t_idle)
            if item is None:
                return
            conn, stream, opcode, body = item
            billed = False
            try:
                try:
                    op, rsp = srv._dispatch(srv.processor, conn,
                                            srv._need_auth, srv._auth,
                                            opcode, body)
                except Exception as e:
                    op, rsp = _error_response(e)
                # bill the ledger BEFORE the response leaves: a client
                # that has already READ its response must be able to
                # observe this request's dispatch busy/items — billing
                # after send_envelope raced exactly that observation
                # (the send only enqueues to the out buffer anyway;
                # the socket write is the loop thread's work)
                self._stage.add_busy(time.monotonic() - t0)
                self._stage.add_items(1, len(body))
                billed = True
                try:
                    conn.send_envelope(0x80 | (conn.version or 0x04),
                                       stream, op, rsp)
                except Exception:
                    # an encode/enqueue failure (e.g. a response body
                    # overflowing the envelope length field) must cost
                    # THAT connection, never this shared worker — a
                    # dead worker would strand queued requests holding
                    # permits until the whole front door wedges
                    conn.loop.call(
                        lambda c=conn: c.loop.close_conn(c))
            finally:
                if not billed:   # _error_response itself raised
                    self._stage.add_busy(time.monotonic() - t0)
                    self._stage.add_items(1, len(body))
                with conn.wlock:
                    conn.in_flight -= 1
                srv.permits.release()


class CQLServer:
    """Event-loop native-protocol endpoint over a backend (StorageEngine
    or cluster Node) — transport/Server.java role. The public surface
    (port, paused, min_version, clients, processor, close) matches the
    original thread-per-connection server."""

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 tls=None):
        """tls: a cluster.tls.TLSConfig — client_encryption_options
        role: connections are TLS, with client certs demanded only when
        the config sets require_client_auth."""
        self.backend = backend
        self._tls_ctx = tls.server_context() if tls else None
        # ONE processor for the whole server: prepared-statement ids are
        # server-global like the reference's (drivers prepare on one
        # connection and execute on another); keyspace/user stay
        # per-connection
        self.processor = QueryProcessor(backend)
        self._auth = getattr(backend, "auth", None)
        self._need_auth = self._auth is not None and self._auth.enabled
        settings = getattr(backend, "settings", None)
        if settings is None:
            from ..config import Settings
            settings = Settings()
        self._settings = settings
        self.permits = PermitGate(
            self._setting("native_transport_max_concurrent_requests", 256))
        self.rate_limit_ops = float(
            self._setting("native_transport_rate_limit_ops", 0))
        self.overload = OverloadSignals(backend)
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, port))
        self._listen.listen(256)
        self._listen.setblocking(False)
        self.port = self._listen.getsockname()[1]
        self._closed = False
        self._close_lock = threading.Lock()
        # nodetool disablebinary: new connections are refused while
        # paused (existing ones keep serving)
        self.paused = False
        # nodetool disableoldprotocolversions
        self.min_version = min(SUPPORTED_VERSIONS)
        self._event_conns: set[Connection] = set()
        self._conn_lock = threading.Lock()
        # live connection registry (system_views.clients / `nodetool
        # clientstats`; transport/ConnectedClient role)
        self.clients: dict[int, dict] = {}
        self._client_ids = 0
        self._next_loop = 0
        try:
            if not hasattr(backend, "cql_servers"):
                backend.cql_servers = []
            backend.cql_servers.append(self)
        except Exception:
            pass
        # settings listeners: both admission knobs hot-reload like
        # compaction_throughput_mib_per_sec
        self._knob_listeners = []
        for knob, cb in (
                ("native_transport_max_concurrent_requests",
                 self.permits.set_cap),
                ("native_transport_rate_limit_ops",
                 self._set_rate_limit)):
            try:
                settings.on_change(knob, cb)
                self._knob_listeners.append((knob, cb))
            except Exception:
                pass
        n_loops = max(1, int(self._setting(
            "native_transport_event_loops", 2)))
        self.event_loops = [_EventLoop(self, i) for i in range(n_loops)]
        self.event_loops[0].sel.register(self._listen,
                                         selectors.EVENT_READ,
                                         ("accept", None))
        self.dispatcher = _Dispatcher(
            self, int(self._setting("native_transport_max_threads", 4)))
        for lp in self.event_loops:
            lp.start()
        # server-push events: a cluster Node surfaces liveness/topology/
        # schema transitions through add_event_listener. Pushes are
        # non-blocking appends to each registered connection's outgoing
        # buffer — the emitting thread (gossiper, DDL executor) never
        # touches a socket, and a client that stops reading is dropped
        # by the buffer cap rather than wedging fan-out.
        if hasattr(backend, "add_event_listener"):
            backend.add_event_listener(self._on_node_event)

    def _setting(self, name: str, default):
        try:
            return self._settings.get(name)
        except Exception:
            return default

    def _set_rate_limit(self, ops: float) -> None:
        self.rate_limit_ops = float(ops)
        for info in list(self.clients.values()):
            info["conn"].limiter.set_rate(ops)

    # -------------------------------------------------------- event push --

    def _on_node_event(self, kind: str, info: dict) -> None:
        """Translate a node event into a wire EVENT envelope and append
        it to every registered connection's outgoing buffer
        (EventMessage + Server.EventNotifier roles). Never blocks the
        emitter; a slow consumer is disconnected by the buffer cap."""
        body = _string(kind)
        if kind in ("STATUS_CHANGE", "TOPOLOGY_CHANGE"):
            body += _string(info["change"])
            body += _inet(info.get("host", "127.0.0.1"),
                          int(info.get("port", 0)))
        elif kind == "SCHEMA_CHANGE":
            body += _string(info["change"])       # CREATED/UPDATED/DROPPED
            body += _string(info["target"])       # KEYSPACE/TABLE/...
            body += _string(info.get("keyspace") or "")
            if info["target"] != "KEYSPACE":
                body += _string(info.get("name") or "")
        else:
            return
        with self._conn_lock:
            conns = [c for c in self._event_conns
                     if kind in c.registrations]
        for c in conns:
            env = encode_envelope(0x80 | (c.version or 0x04), -1,
                                  OP_EVENT, body)
            c.enqueue(frame_envelope(env, c.modern), event=True)

    # ------------------------------------------------------------ accept --

    def _on_accept(self) -> None:
        """Runs on event loop 0 when the listen socket is readable."""
        while True:
            try:
                sock, _ = self._listen.accept()
            except (BlockingIOError, OSError):
                return
            if self.paused or self._closed:
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            try:
                # response envelopes are small and latency-bound: Nagle
                # + delayed ACK would add ~40ms to every round trip
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            handshaking = False
            if self._tls_ctx is not None:
                try:
                    sock = self._tls_ctx.wrap_socket(
                        sock, server_side=True,
                        do_handshake_on_connect=False)
                    handshaking = True
                except (ssl.SSLError, OSError):
                    try:
                        sock.close()
                    except OSError:
                        pass
                    continue
            try:
                try:
                    peername = sock.getpeername()[:2]
                    peer = "%s:%d" % peername
                    peer_ip = peername[0]
                except OSError:
                    peer, peer_ip = "?", None
                with self._conn_lock:
                    self._client_ids += 1
                    cid = self._client_ids
                    loop = self.event_loops[self._next_loop]
                    self._next_loop = (self._next_loop + 1) \
                        % len(self.event_loops)
                conn = Connection(self, loop, sock, cid, peer, peer_ip,
                                  handshaking)
                self.clients[cid] = {"id": cid, "address": peer,
                                     "requests": 0, "conn": conn}
                if loop is self.event_loops[0]:
                    loop.add_conn(conn)
                else:
                    loop.call(lambda lp=loop, c=conn: lp.add_conn(c))
            except Exception:
                # a bug in per-connection setup must not leak the
                # accepted fd (the client would hang to timeout) or
                # kill the accept pass for later connections
                METRICS.incr("clients.loop_errors")
                try:
                    sock.close()
                except OSError:
                    pass

    def _forget(self, conn: Connection) -> None:
        self.clients.pop(conn.cid, None)
        with self._conn_lock:
            self._event_conns.discard(conn)

    # ------------------------------------------------------------- close --

    def close(self) -> None:
        """Idempotent shutdown: stop accepting, close every connection,
        then JOIN the event loops and dispatch workers under a deadline
        so callers never race a half-dead server."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        servers = getattr(self.backend, "cql_servers", None)
        if servers is not None and self in servers:
            servers.remove(self)
        remove = getattr(self.backend, "remove_event_listener", None)
        if remove is not None:
            remove(self._on_node_event)
        for knob, cb in self._knob_listeners:
            try:
                self._settings.remove_listener(knob, cb)
            except Exception:
                pass
        try:
            self._listen.close()
        except OSError:
            pass
        self.dispatcher.shutdown()
        for lp in self.event_loops:
            lp.wake()
        import time as _time
        deadline = _time.monotonic() + 5.0
        for t in self.event_loops + self.dispatcher.threads:
            t.join(max(0.0, deadline - _time.monotonic()))

    # ------------------------------------------------------------ framing --

    def _parse(self, conn: Connection) -> None:
        """Drain as many complete envelopes as conn's buffers hold.
        Runs on the owning loop; a framing error answers a PROTOCOL
        error and closes (never a silent hang). Both layers walk a
        cursor and compact ONCE per pass — a del-from-front per
        envelope/segment would memmove the remaining buffer each time,
        quadratic for a client pipelining many small envelopes (the
        same defect class take_chunk's memoryview cursor fixes on the
        write side), and it runs on the shared loop thread."""
        while not conn.closing and not conn.close_when_drained:
            if conn.modern:
                # segment layer: rbuf -> ebuf (envelope bytes)
                rbuf = conn.rbuf
                pos = 0
                err = None
                while len(rbuf) - pos >= 6:
                    try:
                        plen, _sc = decode_segment_header(
                            bytes(rbuf[pos:pos + 6]))
                    except ValueError as e:
                        err = str(e)
                        break
                    if len(rbuf) - pos < 6 + plen + 4:
                        break
                    payload = bytes(rbuf[pos + 6:pos + 6 + plen])
                    crc = rbuf[pos + 6 + plen:pos + 6 + plen + 4]
                    if int.from_bytes(crc, "little") != _crc32_v5(payload):
                        err = "segment payload CRC mismatch"
                        break
                    conn.ebuf += payload
                    pos += 6 + plen + 4
                if pos:
                    del rbuf[:pos]
                if err is not None:
                    self._protocol_error(conn, err)
                    return
                buf = conn.ebuf
            else:
                buf = conn.rbuf
            pos = 0
            progressed = False
            while len(buf) - pos >= 9:
                (length,) = struct.unpack_from(">I", buf, pos + 5)
                if length > MAX_ENVELOPE_BODY:
                    del buf[:pos]
                    self._protocol_error(conn, "envelope too large")
                    return
                if len(buf) - pos < 9 + length:
                    break
                ver_raw, flags, stream, opcode = struct.unpack_from(
                    ">BBhB", buf, pos)
                body = bytes(buf[pos + 9:pos + 9 + length])
                pos += 9 + length
                progressed = True
                self._handle_envelope(conn, ver_raw & 0x7F, flags,
                                      stream, opcode, body)
                if conn.closing or conn.close_when_drained:
                    break
                if conn.modern and buf is conn.rbuf:
                    # STARTUP just switched framing: the rest of rbuf
                    # is segment-framed — stop consuming it as bare
                    # envelopes and let the outer loop re-read it
                    break
            if pos:
                del buf[:pos]
            if not progressed:
                return

    def _protocol_error(self, conn: Connection, msg: str) -> None:
        """A framing-level error: answer PROTOCOL (so the client learns
        WHY, instead of hanging on a dead socket) and close once the
        error has flushed. The stream id is 0 — a corrupt frame has no
        trustworthy stream to echo. The flag goes up BEFORE the enqueue:
        the loop may flush (and must then close) within the send."""
        conn.close_when_drained = True
        # already-buffered input will never be parsed — release it
        conn.rbuf.clear()
        conn.ebuf.clear()
        conn.send_error(0, ERR_PROTOCOL, msg)

    def _handle_envelope(self, conn: Connection, ver: int, flags: int,
                         stream: int, opcode: int, body: bytes) -> None:
        info = self.clients.get(conn.cid)
        if info is not None:
            info["requests"] += 1
        if ver not in SUPPORTED_VERSIONS or ver < self.min_version:
            # reject cleanly (spec: respond with a PROTOCOL error naming
            # the supported versions) and close
            env = encode_envelope(
                0x80 | max(SUPPORTED_VERSIONS), stream, OP_ERROR,
                error_body(ERR_PROTOCOL,
                           f"Invalid or unsupported protocol version "
                           f"({ver}); supported versions are "
                           f"(4/v4, 5/v5)"))
            conn.close_when_drained = True
            conn.enqueue(env)            # always legacy-framed
            return
        if conn.version is None:
            conn.version = ver
        elif ver != conn.version:
            conn.close_when_drained = True
            conn.send_error(stream, ERR_PROTOCOL,
                            "protocol version changed mid-stream")
            return
        if flags & 0x01:
            conn.close_when_drained = True
            conn.send_error(stream, ERR_PROTOCOL,
                            "compression is not supported")
            return
        if opcode in DISPATCH_OPCODES:
            self._admit(conn, stream, opcode, body)
            return
        # handshake / registration: cheap, handled inline on the loop
        try:
            op, rsp = self._dispatch(self.processor, conn,
                                     self._need_auth, self._auth,
                                     opcode, body)
        except Exception as e:
            op, rsp = _error_response(e)
        conn.send_envelope(0x80 | conn.version, stream, op, rsp)
        if opcode == OP_STARTUP and conn.version >= 0x05:
            # STARTUP processed: v5 switches to segment framing (the
            # STARTUP response itself goes out legacy; any auth
            # exchange continues framed)
            conn.modern = True

    # --------------------------------------------------------- admission --

    def _admit(self, conn: Connection, stream: int, opcode: int,
               body: bytes) -> None:
        """All three admission gates, on the event loop. A request that
        cannot be admitted is answered OVERLOADED right now — bounded
        buffers all the way down, no unbounded queueing."""
        from ..service import diagnostics
        if self.rate_limit_ops > 0 and not conn.limiter.try_acquire(1):
            conn.rate_limited += 1
            METRICS.incr("clients.rate_limited_requests")
            diagnostics.publish("transport.overload_shed",
                                reason="rate_limited",
                                address=conn.peer)
            conn.send_error(stream, ERR_OVERLOADED,
                            "Request rate limited "
                            "(native_transport_rate_limit_ops)")
            return
        reason = self.overload.reason()
        if reason is not None:
            METRICS.incr("clients.overload_shed")
            diagnostics.publish("transport.overload_shed",
                                reason=reason[:120],
                                address=conn.peer)
            conn.send_error(stream, ERR_OVERLOADED, reason)
            return
        if not self.permits.try_acquire():
            METRICS.incr("clients.overload_shed")
            diagnostics.publish("transport.overload_shed",
                                reason="permit_cap",
                                address=conn.peer)
            conn.send_error(
                stream, ERR_OVERLOADED,
                f"Maximum concurrent requests "
                f"({self.permits.cap}) reached "
                f"(native_transport_max_concurrent_requests)")
            return
        with conn.wlock:
            conn.in_flight += 1
        self.dispatcher.submit(conn, stream, opcode, body)

    # ------------------------------------------------------------- opcodes

    def _post_auth_checks(self, auth, conn: Connection, user: str) -> None:
        """CIDR + network (datacenter) authorization at connect time
        (auth/CIDRPermissionsManager, CassandraNetworkAuthorizer)."""
        if conn.peer_ip:
            auth.check_cidr(user, conn.peer_ip)
        ep = getattr(self.backend, "endpoint", None)
        if ep is not None:
            auth.check_datacenter(user, ep.dc)

    def _dispatch(self, processor, conn: Connection, need_auth, auth,
                  opcode, body):
        if opcode == OP_OPTIONS:
            return OP_SUPPORTED, struct.pack(">H", 2) + \
                _string("CQL_VERSION") + struct.pack(">H", 1) + \
                _string("3.4.5") + \
                _string("PROTOCOL_VERSIONS") + struct.pack(">H", 2) + \
                _string("4/v4") + _string("5/v5")
        if opcode == OP_STARTUP:
            if need_auth:
                # mutual-TLS path (MutualTlsAuthenticator): a VERIFIED
                # client certificate authenticates by identity mapping
                # without a password exchange
                ident = conn.tls_identity
                if ident is not None and ident in auth.identities:
                    # mapped identity: cert authenticates; an UNMAPPED
                    # cert falls through to the password exchange
                    # (optional-mTLS upgrade path)
                    try:
                        user = auth.authenticate_identity(ident)
                        self._post_auth_checks(auth, conn, user)
                    except Exception as e:
                        return OP_ERROR, error_body(ERR_BAD_CREDENTIALS,
                                                    str(e))
                    conn.user = user
                    conn.authed = True
                    return OP_READY, b""
                return OP_AUTHENTICATE, _string(
                    "org.apache.cassandra.auth.PasswordAuthenticator")
            conn.authed = True
            return OP_READY, b""
        if opcode == OP_AUTH_RESPONSE:
            token, _ = _read_bytes(body, 0)
            parts = (token or b"").split(b"\x00")
            if len(parts) >= 3:
                user, pw = parts[1].decode(), parts[2].decode()
                try:
                    auth.authenticate(user, pw)
                    self._post_auth_checks(auth, conn, user)
                except Exception:
                    return OP_ERROR, error_body(ERR_BAD_CREDENTIALS,
                                                "bad credentials")
                conn.user = user
                conn.authed = True
                return OP_AUTH_SUCCESS, _bytes(None)
            return OP_ERROR, error_body(ERR_BAD_CREDENTIALS,
                                        "malformed SASL token")
        if not conn.authed:
            return OP_ERROR, error_body(ERR_PROTOCOL, "STARTUP required")
        if opcode == OP_REGISTER:
            (n,) = struct.unpack_from(">H", body, 0)
            pos = 2
            for _ in range(n):
                etype, pos = _read_string(body, pos)
                if etype not in EVENT_TYPES:
                    return OP_ERROR, error_body(
                        ERR_PROTOCOL, f"unknown event type {etype!r}")
                conn.registrations.add(etype)
            with self._conn_lock:
                self._event_conns.add(conn)
            return OP_READY, b""
        if opcode == OP_QUERY:
            query, pos = _read_long_string(body, 0)
            return self._run(processor, conn, query, body, pos)
        if opcode == OP_PREPARE:
            query, pos = _read_long_string(body, 0)
            if conn.version >= 0x05 and pos < len(body):
                (_pflags,) = struct.unpack_from(">I", body, pos)  # keyspace
            qid, prep = processor.prepare_full(query)
            n_binds = getattr(prep.statement, "n_markers", 0)
            rsp = bytearray()
            rsp += struct.pack(">i", RESULT_PREPARED)
            rsp += struct.pack(">H", len(qid)) + qid
            if conn.version >= 0x05:
                # result_metadata_id (short bytes): stable per statement
                rsp += struct.pack(">H", len(qid)) + qid
            # bind metadata: declared as BLOB — the server deserializes
            # wire bytes against the real column type at bind time, so
            # clients pass pre-serialized values (documented subset)
            rsp += struct.pack(">Ii", 0x0001, n_binds)   # flags, count
            rsp += struct.pack(">i", 0)                   # pk_count
            rsp += _string("") + _string("")              # global spec
            for i in range(n_binds):
                rsp += _string(f"p{i}") + struct.pack(">H", 0x03)
            # result metadata: clients re-read it from each RESULT
            rsp += struct.pack(">Ii", 0, 0)
            return OP_RESULT, bytes(rsp)
        if opcode == OP_EXECUTE:
            (n,) = struct.unpack_from(">H", body, 0)
            qid = bytes(body[2:2 + n])
            pos = 2 + n
            if conn.version >= 0x05:
                # v5 EXECUTE carries the result_metadata_id
                (mn,) = struct.unpack_from(">H", body, pos)
                pos += 2 + mn
            prep = processor.get_prepared(qid)
            if prep is None:
                # evicted or never prepared: the UNPREPARED error tells
                # drivers to re-PREPARE and retry (spec §9 / 0x2500)
                return OP_ERROR, unprepared_body(qid)
            return self._run(processor, conn, None, body, pos, prep=prep)
        return OP_ERROR, error_body(ERR_PROTOCOL,
                                    f"unsupported opcode {opcode}")

    def _run(self, processor, conn: Connection, query, body: bytes,
             pos: int, prep=None):
        import time as time_mod
        consistency, = struct.unpack_from(">H", body, pos)
        pos += 2
        if conn.version >= 0x05:          # v5 widened flags to [int]
            (flags,) = struct.unpack_from(">I", body, pos)
            pos += 4
        else:
            flags = body[pos]
            pos += 1
        params: tuple = ()
        page_size = None
        paging_state = None
        if flags & 0x01:                 # values
            (nv,) = struct.unpack_from(">H", body, pos)
            pos += 2
            vals = []
            for _ in range(nv):
                b, pos = _read_bytes(body, pos)
                vals.append(None if b is None else WireValue(b))
            params = tuple(vals)
        if flags & 0x04:                 # page_size
            (page_size,) = struct.unpack_from(">i", body, pos)
            pos += 4
        if flags & 0x08:                 # paging_state
            paging_state, pos = _read_bytes(body, pos)
        # per-verb client-request latency (ClientRequestMetrics role):
        # SELECTs are reads, everything else mutates
        if prep is not None:
            is_read = type(prep.statement).__name__ == "SelectStatement"
        else:
            is_read = query.lstrip()[:6].upper() == "SELECT"
        t0 = time_mod.perf_counter()
        if prep is not None:   # EXECUTE: resolved statement, no re-parse
            rs = processor.execute_statement(
                prep, params, conn.keyspace, user=conn.user,
                page_size=page_size, paging_state=paging_state)
        else:
            rs = processor.process(query, params, conn.keyspace,
                                   user=conn.user,
                                   page_size=page_size,
                                   paging_state=paging_state)
        us = (time_mod.perf_counter() - t0) * 1e6
        verb = "read" if is_read else "write"
        # the per-CL tag uses the level the client DECLARED, so a
        # saturation-matrix breach attributes to ONE vs QUORUM instead
        # of blending them; a code outside the spec table lands in an
        # explicit "unknown" bucket, never mis-attributed to a real CL
        cl = CONSISTENCY_NAMES.get(consistency, "unknown")
        # blended hist (the historical surface + default SLO objective)
        # AND the per-CL family the matrix attributes breaches through
        METRICS.hist(f"client_requests.{verb}").update_us(us)
        METRICS.hist(f"client_requests.{verb}.{cl}").update_us(us)
        new_ks = getattr(rs, "keyspace", None)
        if new_ks is not None:
            conn.keyspace = new_ks
            return OP_RESULT, struct.pack(">i", RESULT_SET_KEYSPACE) \
                + _string(new_ks)
        if not rs.column_names:
            return OP_RESULT, struct.pack(">i", RESULT_VOID)
        return OP_RESULT, _encode_rows(rs)
