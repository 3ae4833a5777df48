"""The port's counterpart of tests/test_native_protocol.py:
the same assertions on cassandra_tpu_torch, every engine on the CPU
(device="cpu").

Native-protocol server + client driver over real sockets
(transport/Server.java + Dispatcher.java roles, protocol v4 subset)."""
import pytest

from cassandra_tpu_torch.client import Cluster, DriverError, serialize_params
from cassandra_tpu_torch.schema import Schema
from cassandra_tpu_torch.storage.engine import StorageEngine
from cassandra_tpu_torch.transport_server import CQLServer
from torch_tmp import tmp_path  # noqa: F401


@pytest.fixture
def server(tmp_path):
    eng = StorageEngine(str(tmp_path / "data"), Schema(),
                        commitlog_sync="batch", device="cpu")
    srv = CQLServer(eng)
    yield eng, srv
    srv.close()
    eng.close()


def test_wire_query_roundtrip(server):
    eng, srv = server
    s = Cluster("127.0.0.1", srv.port).connect()
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE ks")
    s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text, n bigint)")
    s.execute("INSERT INTO kv (k, v, n) VALUES (1, 'hello', 42)")
    rows = s.execute("SELECT k, v, n FROM kv WHERE k = 1")
    assert rows.column_names == ["k", "v", "n"]
    assert rows.rows == [(1, "hello", 42)]
    s.close()


def test_wire_bound_values(server):
    eng, srv = server
    s = Cluster("127.0.0.1", srv.port).connect()
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE ks")
    s.execute("CREATE TABLE b (k int PRIMARY KEY, v text)")
    t = eng.schema.get_table("ks", "b")
    params = serialize_params(t, ["k", "v"], [7, "bound"])
    s.execute("INSERT INTO b (k, v) VALUES (?, ?)", params)
    rows = s.execute("SELECT v FROM b WHERE k = ?",
                     serialize_params(t, ["k"], [7]))
    assert rows.rows == [("bound",)]
    s.close()


def test_wire_paging(server):
    eng, srv = server
    s = Cluster("127.0.0.1", srv.port).connect()
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE ks")
    s.execute("CREATE TABLE p (k int PRIMARY KEY, v int)")
    for i in range(40):
        s.execute(f"INSERT INTO p (k, v) VALUES ({i}, {i})")
    got, state, pages = [], None, 0
    while True:
        rows = s.execute("SELECT k FROM p", fetch_size=12,
                         paging_state=state)
        got.extend(r[0] for r in rows.rows)
        pages += 1
        state = rows.paging_state
        if state is None:
            break
    assert sorted(got) == list(range(40))
    assert pages >= 4
    s.close()


def test_wire_errors(server):
    eng, srv = server
    s = Cluster("127.0.0.1", srv.port).connect()
    with pytest.raises(DriverError, match="0x2200"):
        s.execute("SELECT * FROM nosuch.table")
    s.close()


def test_wire_auth(tmp_path):
    eng = StorageEngine(str(tmp_path / "data"), Schema(),
                        commitlog_sync="batch", auth_enabled=True,
                        device="cpu")
    srv = CQLServer(eng)
    try:
        with pytest.raises(DriverError):
            Cluster("127.0.0.1", srv.port, "cassandra", "wrong").connect()
        s = Cluster("127.0.0.1", srv.port, "cassandra",
                    "cassandra").connect()
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 1}")
        s.close()
    finally:
        srv.close()
        eng.close()


@pytest.mark.slow
def test_wire_client_against_noded_daemon(tmp_path):
    """Full stack over processes and sockets: noded daemon serving the
    native protocol; a client connects to its port and runs CQL."""
    import json
    import os
    import subprocess
    import sys

    from cassandra_tpu_torch.cluster.ring import even_tokens
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = {
        "name": "solo", "host": "127.0.0.1", "port": 0,
        "tokens": even_tokens(1, vnodes=4)[0],
        "data_dir": str(tmp_path / "solo"),
        "peers": [], "seeds": [], "device": "cpu",
        "native_port": 0,
        "ddl": ["CREATE KEYSPACE ks WITH replication = "
                "{'class': 'SimpleStrategy', 'replication_factor': 1}",
                "CREATE TABLE ks.kv (k int PRIMARY KEY, v text)"],
    }
    cfile = tmp_path / "solo.json"
    cfile.write_text(json.dumps(cfg))
    p = subprocess.Popen(
        [sys.executable, "-m", "cassandra_tpu_torch.tools.noded", str(cfile)],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = p.stdout.readline()
        assert line.startswith("READY"), (line, p.stderr.read())
        native_port = int(line.split("NATIVE")[1].strip())
        s = Cluster("127.0.0.1", native_port).connect()
        s.execute("USE ks")
        s.execute("INSERT INTO kv (k, v) VALUES (5, 'from-the-wire')")
        assert s.execute("SELECT v FROM kv WHERE k = 5").rows \
            == [("from-the-wire",)]
        s.close()
    finally:
        p.terminate()
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()


def test_wire_prepare_execute(server):
    eng, srv = server
    s = Cluster("127.0.0.1", srv.port).connect()
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE ks")
    s.execute("CREATE TABLE pr (k int PRIMARY KEY, v text)")
    t = eng.schema.get_table("ks", "pr")
    qid = s.prepare("INSERT INTO pr (k, v) VALUES (?, ?)")
    for i in range(5):
        s.execute_prepared(qid, serialize_params(t, ["k", "v"],
                                                 [i, f"v{i}"]))
    sel = s.prepare("SELECT v FROM pr WHERE k = ?")
    rows = s.execute_prepared(sel, serialize_params(t, ["k"], [3]))
    assert rows.rows == [("v3",)]
    s.close()


def test_wire_v4_still_supported(server):
    eng, srv = server
    s = Cluster("127.0.0.1", srv.port, protocol_version=4).connect()
    s.execute("CREATE KEYSPACE v4ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE v4ks")
    s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
    s.execute("INSERT INTO kv (k, v) VALUES (1, 'legacy')")
    assert s.execute("SELECT v FROM kv WHERE k = 1").rows == [("legacy",)]
    s.close()


def test_wire_unsupported_version_rejected(server):
    import socket
    import struct
    _eng, srv = server
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5.0)
    # protocol v3 STARTUP: server must answer a PROTOCOL error, not
    # misparse the stream
    body = struct.pack(">H", 1) + b"\x00\x0bCQL_VERSION\x00\x053.4.5"
    sock.sendall(struct.pack(">BBhBI", 0x03, 0, 0, 0x01, len(body)) + body)
    hdr = sock.recv(9)
    opcode = hdr[4]
    (length,) = struct.unpack(">I", hdr[5:9])
    rbody = sock.recv(length)
    (code,) = struct.unpack_from(">i", rbody, 0)
    assert opcode == 0x00 and code == 0x000A   # ERROR / PROTOCOL
    sock.close()


def test_wire_compression_flag_rejected(server):
    import socket
    import struct
    _eng, srv = server
    sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5.0)
    body = struct.pack(">H", 1) + b"\x00\x0bCQL_VERSION\x00\x053.4.5"
    # flags=0x01 claims lz4 compression that was never negotiated
    sock.sendall(struct.pack(">BBhBI", 0x04, 0x01, 0, 0x01, len(body))
                 + body)
    hdr = sock.recv(9)
    (length,) = struct.unpack(">I", hdr[5:9])
    rbody = sock.recv(length)
    (code,) = struct.unpack_from(">i", rbody, 0)
    assert hdr[4] == 0x00 and code == 0x000A
    sock.close()


def test_v5_segment_crc_utilities():
    from cassandra_tpu_torch import transport_server as ts
    payload = b"hello v5 framing" * 100
    seg = ts.encode_segment(payload)
    plen, sc = ts.decode_segment_header(seg[:6])
    assert plen == len(payload) and sc
    # corrupt the header -> CRC24 failure
    import pytest as _pytest
    bad = bytearray(seg[:6])
    bad[0] ^= 0xFF
    with _pytest.raises(ValueError):
        ts.decode_segment_header(bytes(bad))


def test_v5_prepared_roundtrip(server):
    eng, srv = server
    s = Cluster("127.0.0.1", srv.port, protocol_version=5).connect()
    s.execute("CREATE KEYSPACE pks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE pks")
    s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
    t = eng.schema.get_table("pks", "kv")
    qid = s.prepare("INSERT INTO kv (k, v) VALUES (?, ?)")
    for i in range(5):
        s.execute_prepared(qid, serialize_params(t, ["k", "v"],
                                                 [i, f"p{i}"]))
    rid = s.prepare("SELECT v FROM kv WHERE k = ?")
    rows = s.execute_prepared(rid, serialize_params(t, ["k"], [3]))
    assert rows.rows == [("p3",)]
    s.close()


def test_events_status_topology_schema(tmp_path):
    """A registered driver observes a node death, a topology change and
    DDL performed by ANOTHER session (RegisterMessage/EventMessage +
    Server push; VERDICT round-2 item 7's done-criterion)."""
    import time
    from cassandra_tpu_torch.cluster.node import LocalCluster

    cluster = LocalCluster(2, str(tmp_path), rf=1,
                           gossip_interval=0.05, device="cpu")
    srv = CQLServer(cluster.node(1))
    try:
        s = Cluster("127.0.0.1", srv.port).connect()
        s.register(["STATUS_CHANGE", "TOPOLOGY_CHANGE", "SCHEMA_CHANGE"])

        # schema change from a DIFFERENT session (direct node session)
        other = cluster.session(1)
        other.execute("CREATE KEYSPACE evks WITH replication = "
                      "{'class': 'SimpleStrategy', "
                      "'replication_factor': 2}")
        ev = s.wait_event(10.0)
        assert ev and ev["type"] == "SCHEMA_CHANGE" \
            and ev["change"] == "CREATED" and ev["keyspace"] == "evks"

        # node death: stop node2, wait for conviction -> STATUS DOWN
        cluster.stop_node(2)
        deadline = time.time() + 30
        ev = None
        while time.time() < deadline:
            ev = s.wait_event(2.0)
            if ev and ev["type"] == "STATUS_CHANGE" \
                    and ev["change"] == "DOWN":
                break
        assert ev and ev["type"] == "STATUS_CHANGE" \
            and ev["change"] == "DOWN"

        # topology change: replace the dead node -> NEW_NODE event
        cluster.replace_dead_node(2)
        deadline = time.time() + 10
        saw_new = False
        while time.time() < deadline and not saw_new:
            ev = s.wait_event(2.0)
            if ev and ev["type"] == "TOPOLOGY_CHANGE" \
                    and ev["change"] == "NEW_NODE":
                saw_new = True
        assert saw_new
        s.close()
    finally:
        srv.close()
        cluster.shutdown()
