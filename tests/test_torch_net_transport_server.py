"""The port's counterpart of tests/test_transport_server.py:
the same assertions on cassandra_tpu_torch, every engine on the CPU
(device="cpu").

Event-loop native-protocol server: v5 framing edge cases, admission
control (permits / overload signals / per-client rate limiting),
prepared-statement LRU + UNPREPARED, shutdown and slow-consumer
behavior (cassandra_tpu/transport/; docs/native-transport.md).

The happy-path wire conformance lives in test_native_protocol.py and
runs unchanged against this server — these tests pin the parts the
thread-per-connection predecessor could not: bounded in-flight
requests, shedding instead of queueing, fixed thread count at high
connection counts, and framing corruption answered with PROTOCOL
errors instead of hangs."""
import socket
import struct
import threading
import time

import pytest

from cassandra_tpu_torch.client import Cluster, DriverError
from cassandra_tpu_torch.schema import Schema
from cassandra_tpu_torch.service.metrics import GLOBAL as METRICS
from cassandra_tpu_torch.storage.engine import StorageEngine
from cassandra_tpu_torch.transport import frame as fr
from cassandra_tpu_torch.transport.admission import (OverloadSignals,
                                                     PermitGate)
from cassandra_tpu_torch.transport.server import CQLServer
from torch_tmp import tmp_path  # noqa: F401


@pytest.fixture
def server(tmp_path):
    eng = StorageEngine(str(tmp_path / "data"), Schema(),
                        commitlog_sync="batch", device="cpu")
    srv = CQLServer(eng)
    yield eng, srv
    srv.close()
    eng.close()


# ---------------------------------------------------------- raw helpers --

def _read_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError(f"EOF after {len(buf)}/{n} bytes")
        buf += chunk
    return bytes(buf)


def _read_envelope_legacy(sock):
    hdr = _read_exact(sock, 9)
    (length,) = struct.unpack(">I", hdr[5:9])
    body = _read_exact(sock, length) if length else b""
    _ver, _flags, stream, op = struct.unpack(">BBhB", hdr[:5])
    return stream, op, body


def _read_envelope_v5(sock, buf: bytearray):
    """Reassemble one envelope from v5 segments."""
    while True:
        if len(buf) >= 9:
            (length,) = struct.unpack_from(">I", buf, 5)
            if len(buf) >= 9 + length:
                hdr = bytes(buf[:9])
                body = bytes(buf[9:9 + length])
                del buf[:9 + length]
                _v, _f, stream, op = struct.unpack(">BBhB", hdr[:5])
                return stream, op, body
        seg_hdr = _read_exact(sock, 6)
        plen, _sc = fr.decode_segment_header(seg_hdr)
        payload = _read_exact(sock, plen + 4)
        assert int.from_bytes(payload[plen:], "little") \
            == fr._crc32_v5(payload[:plen])
        buf += payload[:plen]


def _startup(sock, version: int = 4) -> None:
    body = struct.pack(">H", 1) + fr._string("CQL_VERSION") \
        + fr._string("3.4.5")
    sock.sendall(struct.pack(">BBhBI", version, 0, 0, fr.OP_STARTUP,
                             len(body)) + body)
    _stream, op, _body = _read_envelope_legacy(sock)   # READY is legacy
    assert op == fr.OP_READY


def _query_envelope(query: str, stream: int, version: int = 4) -> bytes:
    body = fr._long_string(query) + struct.pack(">H", 1)
    if version >= 5:
        body += struct.pack(">I", 0)
    else:
        body += b"\x00"
    return struct.pack(">BBhBI", version, 0, stream, fr.OP_QUERY,
                       len(body)) + body


def _connect(port: int) -> socket.socket:
    s = socket.create_connection(("127.0.0.1", port), timeout=10.0)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


# ------------------------------------------------------ v5 framing edges --

def test_v5_envelope_spans_non_self_contained_segments(server):
    """One envelope split across two non-self-contained segments must
    reassemble (CQLMessageHandler's accumulating path)."""
    _eng, srv = server
    sock = _connect(srv.port)
    _startup(sock, version=5)
    env = _query_envelope("SELECT * FROM system.local", 3, version=5)
    half = len(env) // 2
    sock.sendall(fr.encode_segment(env[:half], self_contained=False))
    sock.sendall(fr.encode_segment(env[half:], self_contained=False))
    buf = bytearray()
    stream, op, _body = _read_envelope_v5(sock, buf)
    assert (stream, op) == (3, fr.OP_RESULT)
    sock.close()


def test_v5_several_envelopes_in_one_segment(server):
    """The inverse packing: two whole envelopes inside one
    self-contained segment both get answered."""
    _eng, srv = server
    sock = _connect(srv.port)
    _startup(sock, version=5)
    env_a = _query_envelope("SELECT * FROM system.local", 11, version=5)
    env_b = _query_envelope("SELECT * FROM system.local", 12, version=5)
    sock.sendall(fr.encode_segment(env_a + env_b, self_contained=True))
    buf = bytearray()
    got = {_read_envelope_v5(sock, buf)[0] for _ in range(2)}
    assert got == {11, 12}
    sock.close()


def test_v5_header_crc_corruption_protocol_error_not_hang(server):
    """A corrupted CRC24 segment header must answer a PROTOCOL error
    and close — never hang the connection or the loop."""
    _eng, srv = server
    sock = _connect(srv.port)
    _startup(sock, version=5)
    env = _query_envelope("SELECT * FROM system.local", 1, version=5)
    seg = bytearray(fr.encode_segment(env))
    seg[3] ^= 0xFF                       # first CRC24 byte
    sock.sendall(bytes(seg))
    buf = bytearray()
    _stream, op, body = _read_envelope_v5(sock, buf)
    assert op == fr.OP_ERROR
    (code,) = struct.unpack_from(">i", body, 0)
    assert code == fr.ERR_PROTOCOL
    with pytest.raises(EOFError):        # server closed after the error
        _read_exact(sock, 1)
    sock.close()


def test_v5_payload_crc_corruption_protocol_error(server):
    _eng, srv = server
    sock = _connect(srv.port)
    _startup(sock, version=5)
    env = _query_envelope("SELECT * FROM system.local", 1, version=5)
    seg = bytearray(fr.encode_segment(env))
    seg[7] ^= 0xFF                       # second payload byte
    sock.sendall(bytes(seg))
    buf = bytearray()
    _stream, op, body = _read_envelope_v5(sock, buf)
    assert op == fr.OP_ERROR
    (code,) = struct.unpack_from(">i", body, 0)
    assert code == fr.ERR_PROTOCOL
    with pytest.raises(EOFError):
        _read_exact(sock, 1)
    sock.close()


def test_interleaved_streams_on_one_connection(server):
    """Two requests written back-to-back on different stream ids both
    get answered, matched by stream id (the event-loop server executes
    them on the dispatch pool, so responses may arrive in any order)."""
    _eng, srv = server
    sock = _connect(srv.port)
    _startup(sock, version=4)
    sock.sendall(_query_envelope("SELECT * FROM system.local", 7)
                 + _query_envelope("SELECT * FROM system.local", 9))
    got = {}
    for _ in range(2):
        stream, op, _body = _read_envelope_legacy(sock)
        got[stream] = op
    assert got == {7: fr.OP_RESULT, 9: fr.OP_RESULT}
    sock.close()


# -------------------------------------------------------- admission -----

def test_permit_exhaustion_returns_overloaded(server):
    """With the permit cap pinched and execution slowed, concurrent
    requests past the cap are answered OVERLOADED immediately — and the
    in-flight high-water mark proves nothing ever queued past the cap."""
    eng, srv = server
    eng.settings.set("native_transport_max_concurrent_requests", 2)
    orig = srv.processor.process

    def slow_process(*a, **kw):
        time.sleep(0.25)
        return orig(*a, **kw)
    srv.processor.process = slow_process
    srv.permits.reset_high_water()
    results = []

    def one():
        s = Cluster("127.0.0.1", srv.port).connect()
        try:
            s.execute("SELECT * FROM system.local")
            results.append(("ok", None))
        except DriverError as e:
            results.append(("err", str(e)))
        finally:
            s.close()
    threads = [threading.Thread(target=one) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ok = [r for r in results if r[0] == "ok"]
    shed = [r for r in results if r[0] == "err" and "0x1001" in r[1]]
    assert ok, results
    assert shed, results
    assert srv.permits.high_water <= 2
    srv.processor.process = orig


def test_rate_limit_sheds_and_hot_reloads(server):
    """native_transport_rate_limit_ops sheds per-client with OVERLOADED
    (rate-limit message), counts into clientstats, and hot-reloads off
    — existing connections included (the settings listener reaches live
    limiters like the compaction throughput knob reaches the live
    compaction limiter)."""
    eng, srv = server
    s = Cluster("127.0.0.1", srv.port).connect()
    s.execute("SELECT * FROM system.local")          # unlimited: clean
    # rate=1: hot-enabling starts the bucket empty (refill 1 op/s), so
    # the shed assertion holds however slow the box is
    eng.settings.set("native_transport_rate_limit_ops", 1)
    shed = 0
    for _ in range(20):
        try:
            s.execute("SELECT * FROM system.local")
        except DriverError as e:
            assert "0x1001" in str(e) and "rate limit" in str(e).lower()
            shed += 1
    assert shed > 0
    from cassandra_tpu_torch.tools.nodetool import clientstats
    stats = clientstats(eng)
    assert sum(c["rate_limited"] for c in stats) >= shed
    assert METRICS.counter("clients.rate_limited_requests") >= shed
    eng.settings.set("native_transport_rate_limit_ops", 0)
    for _ in range(5):
        s.execute("SELECT * FROM system.local")      # off again: clean
    s.close()


def test_overload_signal_from_write_stall():
    """REPEATED write stalls on the SERVER'S OWN engine trip the
    overload signal for STALL_WINDOW_S, then it clears (injected clock
    — no real sleeping). One stall is a routine threshold flush and
    must NOT shed; engine-scoped so a co-hosted node's stall can't shed
    this node's traffic."""
    class _Engine:
        write_stalls = 0
        commitlog = None
    eng = _Engine()
    clock = [1000.0]
    sig = OverloadSignals(eng, clock=lambda: clock[0])
    assert sig.reason() is None
    eng.write_stalls += 1                # ONE routine threshold flush
    clock[0] += 0.2                      # past the probe cache
    assert sig.reason() is None          # not overload
    eng.write_stalls += 1                # second stall inside the window
    clock[0] += 0.2
    assert "write_stall" in sig.reason()
    clock[0] += OverloadSignals.STALL_WINDOW_S + 0.1
    assert sig.reason() is None
    # a burst of stalls between two RECENT probes counts as repeated
    eng.write_stalls += 3
    clock[0] += 0.2
    assert "write_stall" in sig.reason()
    clock[0] += OverloadSignals.STALL_WINDOW_S + 0.1
    assert sig.reason() is None
    # ...but a multi-stall delta observed across a LONG probe gap does
    # not: probes only run on request arrival, so those stalls may be
    # minutes apart on an idle front door
    clock[0] += 600.0
    eng.write_stalls += 2
    clock[0] += 600.0
    assert sig.reason() is None
    # another engine's stalls are invisible to this signal
    other = OverloadSignals(object(), clock=lambda: clock[0])
    eng.write_stalls += 5
    clock[0] += 0.2
    assert other.reason() is None


def test_overload_signal_from_commitlog_backlog():
    class _CL:
        _waiting = OverloadSignals.PENDING_SYNCS_MAX + 1
        _retiring = []

    class _Engine:
        commitlog = _CL()
    sig = OverloadSignals(_Engine())
    assert "commitlog" in sig.reason()
    _CL._waiting = 0
    # the signal re-probes after PROBE_INTERVAL_S: wait for it to clear
    deadline = time.monotonic() + 5.0
    while sig.reason() is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sig.reason() is None


def test_permit_gate_cap_and_high_water():
    g = PermitGate(2)
    assert g.try_acquire() and g.try_acquire()
    assert not g.try_acquire()
    assert g.high_water == 2
    g.release()
    assert g.try_acquire()               # freed permit is reusable
    g.set_cap(0)                         # 0 = unlimited
    assert all(g.try_acquire() for _ in range(10))


# -------------------------------------------- prepared-statement LRU ----

def test_prepared_lru_eviction_unprepared_and_reprepare(server):
    """Bounding the registry: the LRU evicts, the evicted id answers
    the wire UNPREPARED error (0x2500, id echoed), re-PREPARE works,
    and prepared_statements.evicted counts."""
    eng, srv = server
    s = Cluster("127.0.0.1", srv.port).connect()
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE ks")
    s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
    s.execute("INSERT INTO kv (k, v) VALUES (1, 'one')")
    eng.settings.set("prepared_statements_cache_size", 3)
    evicted0 = METRICS.counter("prepared_statements.evicted")
    qid = s.prepare("SELECT v FROM kv WHERE k = 1")
    assert s.execute_prepared(qid).rows == [("one",)]
    for i in range(4):                   # push qid out of the LRU
        s.prepare(f"SELECT v FROM kv WHERE k = {10 + i}")
    assert METRICS.counter("prepared_statements.evicted") > evicted0
    with pytest.raises(DriverError, match="0x2500"):
        s.execute_prepared(qid)
    qid2 = s.prepare("SELECT v FROM kv WHERE k = 1")   # driver retry
    assert qid2 == qid                   # MD5 ids are stable
    assert s.execute_prepared(qid2).rows == [("one",)]
    s.close()


def test_unprepared_error_echoes_statement_id(server):
    """The UNPREPARED body carries [short bytes id] after the message
    so drivers know WHICH statement to re-prepare."""
    _eng, srv = server
    sock = _connect(srv.port)
    _startup(sock, version=4)
    bogus = b"\x01" * 16
    body = struct.pack(">H", len(bogus)) + bogus \
        + struct.pack(">H", 1) + b"\x00"
    sock.sendall(struct.pack(">BBhBI", 4, 0, 5, fr.OP_EXECUTE,
                             len(body)) + body)
    _stream, op, rbody = _read_envelope_legacy(sock)
    assert op == fr.OP_ERROR
    (code,) = struct.unpack_from(">i", rbody, 0)
    assert code == fr.ERR_UNPREPARED
    _msg, pos = fr._read_string(rbody, 4)
    (n,) = struct.unpack_from(">H", rbody, pos)
    assert rbody[pos + 2:pos + 2 + n] == bogus
    sock.close()


# --------------------------------------------------- lifecycle / close --

from cassandra_tpu_torch.transport.server import server_thread_count


def test_close_is_idempotent_and_joins_threads(tmp_path):
    eng = StorageEngine(str(tmp_path / "d"), Schema(),
                        commitlog_sync="batch", device="cpu")
    srv = CQLServer(eng)
    s = Cluster("127.0.0.1", srv.port).connect()
    s.execute("SELECT * FROM system.local")
    assert server_thread_count(srv.port)
    t0 = time.monotonic()
    srv.close()
    srv.close()                          # second close: no-op, no raise
    assert time.monotonic() - t0 < 5.5
    assert not server_thread_count(srv.port)
    # the open client observes the shutdown as EOF, not a hang
    with pytest.raises(Exception):
        s.execute("SELECT * FROM system.local")
    s.close()
    eng.close()


def test_fixed_thread_count_serving_256_connections(server):
    """The event-loop contract: 256 concurrent connections are all
    served by the same fixed thread set (no thread-per-connection)."""
    _eng, srv = server
    baseline = server_thread_count(srv.port)
    assert baseline == len(srv.event_loops) + len(srv.dispatcher.threads)
    socks = []
    try:
        for _ in range(256):
            sock = _connect(srv.port)
            _startup(sock, version=4)
            socks.append(sock)
        assert len(srv.clients) >= 256
        assert server_thread_count(srv.port) == baseline
        # and they all still work: a request on the last and first
        for sock in (socks[0], socks[-1]):
            sock.sendall(_query_envelope("SELECT * FROM system.local", 2))
            _stream, op, _b = _read_envelope_legacy(sock)
            assert op == fr.OP_RESULT
        assert server_thread_count(srv.port) == baseline
    finally:
        for sock in socks:
            sock.close()


def test_slow_event_push_consumer_disconnected_not_stalling(server,
                                                            monkeypatch):
    """A registered event client that stops reading is disconnected and
    counted once its push backlog passes the cap — the emitter and the
    event loop never block on it, and other clients keep being served."""
    from cassandra_tpu_torch.transport import server as srvmod
    _eng, srv = server
    monkeypatch.setattr(srvmod, "EVENT_BACKLOG_CAP", 8192)
    sock = _connect(srv.port)
    _startup(sock, version=4)
    body = struct.pack(">H", 1) + fr._string("SCHEMA_CHANGE")
    sock.sendall(struct.pack(">BBhBI", 4, 0, 1, fr.OP_REGISTER,
                             len(body)) + body)
    _stream, op, _b = _read_envelope_legacy(sock)
    assert op == fr.OP_READY
    # shrink the kernel's appetite so the backlog builds fast
    info = next(iter(srv.clients.values()))
    try:
        info["conn"].sock.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_SNDBUF, 4096)
    except OSError:
        pass
    before = METRICS.counter("clients.slow_consumer_disconnects")
    healthy = Cluster("127.0.0.1", srv.port).connect()
    deadline = time.monotonic() + 20.0
    dropped = False
    ev = {"change": "CREATED", "target": "TABLE",
          "keyspace": "k" * 256, "name": "t" * 256}
    while time.monotonic() < deadline:
        for _ in range(200):             # flood, never reading
            srv._on_node_event("SCHEMA_CHANGE", ev)
        if METRICS.counter("clients.slow_consumer_disconnects") > before:
            dropped = True
            break
    assert dropped, "slow event consumer was never disconnected"
    # the event loop survived: a healthy client still gets answers
    assert healthy.execute("SELECT * FROM system.local").rows
    healthy.close()
    sock.close()


def test_response_backpressure_pauses_reads_not_disconnects(server,
                                                            monkeypatch):
    """Pipelining queries whose responses overrun the out-buffer cap
    engages BACKPRESSURE (reads pause until the client drains), not a
    slow-consumer disconnect — every response is delivered and the
    connection keeps working afterwards (the old sendall server's
    blocking semantics, kept on the event loop)."""
    from cassandra_tpu_torch.client import serialize_params
    from cassandra_tpu_torch.transport import server as srvmod
    monkeypatch.setattr(srvmod, "OUT_BUFFER_CAP", 1 << 20)   # 1 MiB
    eng, srv = server
    s = Cluster("127.0.0.1", srv.port).connect()
    s.execute("CREATE KEYSPACE bp WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE bp")
    s.execute("CREATE TABLE blobs (k int PRIMARY KEY, v blob)")
    t = eng.schema.get_table("bp", "blobs")
    wq = s.prepare("INSERT INTO blobs (k, v) VALUES (?, ?)")
    for i in range(8):
        s.execute_prepared(wq, serialize_params(
            t, ["k", "v"], [i, bytes(65536)]))   # ~512 KiB per SELECT
    before = METRICS.counter("clients.slow_consumer_disconnects")
    sock = _connect(srv.port)
    _startup(sock, version=4)
    n_q = 8                                      # ~4 MiB total >> cap
    sock.sendall(b"".join(
        _query_envelope("SELECT k, v FROM bp.blobs", i) for i in range(n_q)))
    got = set()
    for _ in range(n_q):
        stream, op, body = _read_envelope_legacy(sock)
        assert op == fr.OP_RESULT
        got.add(stream)
    assert got == set(range(n_q))
    # connection still alive and reads resumed after the drain
    sock.sendall(_query_envelope("SELECT k FROM bp.blobs WHERE k = 1", 99))
    stream, op, _b = _read_envelope_legacy(sock)
    assert (stream, op) == (99, fr.OP_RESULT)
    assert METRICS.counter("clients.slow_consumer_disconnects") == before
    sock.close()
    s.close()


def test_clientstats_reports_in_flight_and_rate_limited(server):
    eng, srv = server
    s = Cluster("127.0.0.1", srv.port).connect()
    s.execute("SELECT * FROM system.local")
    from cassandra_tpu_torch.tools.nodetool import clientstats
    stats = clientstats(eng)
    assert stats
    for c in stats:
        assert {"in_flight", "rate_limited", "requests",
                "version", "address"} <= set(c)
    # in_flight drains EVENTUALLY: the worker decrements after the
    # response envelope is queued, so a client that already read its
    # response can observe 1 for an instant — poll to the invariant
    deadline = time.time() + 2.0
    while time.time() < deadline:
        stats = clientstats(eng)
        if all(c["in_flight"] == 0 for c in stats):
            break
        time.sleep(0.01)
    assert all(c["in_flight"] == 0 for c in stats)
    s.close()


def test_clients_vtable_has_admission_columns(tmp_path):
    """system_views.clients exposes in_flight + rate_limited (the
    ClientsTable role) through the same clientstats source."""
    from cassandra_tpu_torch.cluster.node import LocalCluster
    cluster = LocalCluster(1, str(tmp_path), rf=1, device="cpu")
    srv = CQLServer(cluster.node(1))
    try:
        s = Cluster("127.0.0.1", srv.port).connect()
        rows = s.execute("SELECT address, in_flight, rate_limited "
                         "FROM system_views.clients")
        assert rows.rows
        s.close()
    finally:
        srv.close()
        cluster.shutdown()


# ----------------------------------------- tests/test_slo.py's wire test --

@pytest.fixture
def slo_eng(tmp_path):
    """tests/test_slo.py's `eng`: diagnostic events on, periodic sync."""
    from cassandra_tpu_torch.config import Config, Settings
    from cassandra_tpu_torch.service import diagnostics
    settings = Settings(Config.load({"diagnostic_events_enabled": True}))
    e = StorageEngine(str(tmp_path / "d"), Schema(),
                      commitlog_sync="periodic", settings=settings,
                      device="cpu")
    yield e
    e.close()
    diagnostics.GLOBAL.reset()


def test_client_requests_tagged_by_declared_cl(slo_eng):
    """tests/test_slo.py's counterpart: the front door's latency hists
    are tagged by the consistency level the client declared."""
    from cassandra_tpu_torch.transport import CQLServer as Server
    srv = Server(slo_eng)
    before_one = METRICS.hist("client_requests.write.one").count
    before_q = METRICS.hist("client_requests.write.quorum").count
    before_blend = METRICS.hist("client_requests.write").count
    try:
        s = Cluster("127.0.0.1", srv.port).connect()
        s.execute("CREATE KEYSPACE cltag WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 1}")
        s.execute("CREATE TABLE cltag.t (k int PRIMARY KEY, v text)")
        s.execute("INSERT INTO cltag.t (k, v) VALUES (1, 'a')")
        s.execute("INSERT INTO cltag.t (k, v) VALUES (2, 'b')",
                  consistency="QUORUM")
        s.close()
    finally:
        srv.close()
    assert METRICS.hist("client_requests.write.one").count \
        >= before_one + 1
    assert METRICS.hist("client_requests.write.quorum").count \
        == before_q + 1
    # the blended hist still sees every request
    assert METRICS.hist("client_requests.write").count \
        >= before_blend + 2
