"""The networked stack's modules, one at a time, against the JAX package
on the same seeded inputs: the bytes each puts on a socket must be the
same in both packages.

- cluster/wire: encode_message of seeded Messages (scalars, big ints,
  floats, text, nested containers, endpoints, and a CellBatch's columns
  as the coordinator ships them), and each package decodes the other's;
- cluster/tcp: the handshake a TcpTransport sends when it dials a peer;
- transport/server: the raw response bytes for the same v4 and v5
  request sequences (rows, paging, errors, prepared statements);
- client.serialize_params over most CQL types;
- service/admin: the request line admin_call sends and the response
  lines an AdminServer answers;
- cluster/snitch: the dc/rack of a seeded set of endpoints and the
  NetworkTopologyStrategy placement that follows from them."""
from __future__ import annotations

import socket
import threading
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from cassandra_tpu import client as j_client
from cassandra_tpu.cluster import coordinator as j_coord
from cassandra_tpu.cluster import messaging as j_msg
from cassandra_tpu.cluster import replication as j_repl
from cassandra_tpu.cluster import ring as j_ring
from cassandra_tpu.cluster import snitch as j_snitch
from cassandra_tpu.cluster import tcp as j_tcp
from cassandra_tpu.cluster import wire as j_wire
from cassandra_tpu.cluster.node import LocalCluster as JCluster
from cassandra_tpu.schema import Schema as JSchema
from cassandra_tpu.schema import make_table as j_make_table
from cassandra_tpu.service import admin as j_admin
from cassandra_tpu.storage.engine import StorageEngine as JEngine
from cassandra_tpu.tools import bulk as j_bulk
from cassandra_tpu.transport.server import CQLServer as JServer

from cassandra_tpu_torch import client as t_client
from cassandra_tpu_torch.cluster import coordinator as t_coord
from cassandra_tpu_torch.cluster import messaging as t_msg
from cassandra_tpu_torch.cluster import replication as t_repl
from cassandra_tpu_torch.cluster import ring as t_ring
from cassandra_tpu_torch.cluster import snitch as t_snitch
from cassandra_tpu_torch.cluster import tcp as t_tcp
from cassandra_tpu_torch.cluster import wire as t_wire
from cassandra_tpu_torch.cluster.node import LocalCluster as TCluster
from cassandra_tpu_torch.schema import Schema as TSchema
from cassandra_tpu_torch.schema import make_table as t_make_table
from cassandra_tpu_torch.service import admin as t_admin
from cassandra_tpu_torch.storage.engine import StorageEngine as TEngine
from cassandra_tpu_torch.tools import bulk as t_bulk
from cassandra_tpu_torch.transport.server import CQLServer as TServer
from torch_tmp import tmp_path  # noqa: F401

JAX = SimpleNamespace(
    name="jax", client=j_client, coord=j_coord, msg=j_msg, repl=j_repl,
    ring=j_ring, snitch=j_snitch, tcp=j_tcp, wire=j_wire, admin=j_admin,
    bulk=j_bulk, make_table=j_make_table, Server=JServer,
    engine=lambda d: JEngine(d, JSchema(), commitlog_sync="batch"),
    cluster=lambda d: JCluster(2, d, rf=2))
PORT = SimpleNamespace(
    name="port", client=t_client, coord=t_coord, msg=t_msg, repl=t_repl,
    ring=t_ring, snitch=t_snitch, tcp=t_tcp, wire=t_wire, admin=t_admin,
    bulk=t_bulk, make_table=t_make_table, Server=TServer,
    engine=lambda d: TEngine(d, TSchema(), commitlog_sync="batch",
                             device="cpu"),
    cluster=lambda d: TCluster(2, d, rf=2, device="cpu"))


def _batch(pkg, seed: int):
    rng = np.random.default_rng(seed)
    t = pkg.make_table("ks", "w", pk=["id"], ck=["c"],
                       cols={"id": "int", "c": "int", "v": "blob"})
    n = 40
    return pkg.bulk.build_int_batch(
        t, rng.integers(0, 9, n), rng.integers(0, 99, n),
        rng.integers(0, 256, (n, 11), dtype=np.uint8),
        rng.integers(1, 1 << 40, n).astype(np.int64))


def _messages(pkg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    a = pkg.ring.Endpoint("node1", "dc1", "rack1", "127.0.0.1", 9001)
    b = pkg.ring.Endpoint("node2", "dc2", "rack3", "10.0.0.2", 9002)
    batch = _batch(pkg, seed)
    scalars = (None, True, False, 0, -1, (1 << 62) - 1, -(1 << 62),
               1 << 80, -(1 << 100), uuid.UUID(int=int(rng.integers(
                   1 << 62))).int, 0.5, float(rng.standard_normal()),
               "", "ünïcode", b"", bytes(rng.integers(0, 256, 33,
                                                      dtype=np.uint8)))
    return [
        pkg.msg.Message("MUTATION_REQ", scalars, a, b, 7, 0),
        pkg.msg.Message("RANGE_RSP", pkg.coord.cb_serialize(batch), b, a,
                        8, 7, trace_session="s-1",
                        trace_events=[(12, "node2", "read")]),
        pkg.msg.Message("INDEX_REQ", ("ks", "t", "v", "ANN",
                                      ([0.25, -1.5, 3.0], 5)), a, b, 9, 0),
        pkg.msg.Message("GOSSIP", {"eps": [a, b], "gen": {"node1": 3},
                                   "nested": [[1, [2, [3]]], (4, 5)],
                                   "arr": rng.integers(
                                       0, 1 << 30, (3, 4)).astype(
                                       np.int64)}, a, b, 10, 0),
    ]


def _same(x, y) -> bool:
    if isinstance(x, dict):
        return isinstance(y, dict) and x.keys() == y.keys() and \
            all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return type(x) is type(y) and len(x) == len(y) and \
            all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, np.ndarray):
        return isinstance(y, np.ndarray) and x.dtype == y.dtype and \
            np.array_equal(x, y)
    if hasattr(x, "name") and hasattr(x, "dc"):     # an Endpoint
        return (x.name, x.dc, x.rack, x.host, x.port) == \
            (y.name, y.dc, y.rack, y.host, y.port)
    return x == y


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_wire_messages_byte_equal(seed):
    j = [j_wire.encode_message(m) for m in _messages(JAX, seed)]
    t = [t_wire.encode_message(m) for m in _messages(PORT, seed)]
    assert t == j
    for jb, tb in zip(j, t):
        for dec, other in ((t_wire.decode_message, jb),
                           (j_wire.decode_message, tb)):
            m = dec(other)
            ref = j_wire.decode_message(jb)
            assert (m.id, m.reply_to, m.verb, m.trace_session) == \
                (ref.id, ref.reply_to, ref.verb, ref.trace_session)
            assert _same(m.payload, ref.payload)
            assert _same(m.sender, ref.sender) and _same(m.to, ref.to)


def _handshake(pkg) -> bytes:
    """The bytes a TcpTransport sends when it dials a peer."""
    lis = socket.socket()
    lis.bind(("127.0.0.1", 0))
    lis.listen(1)
    tr = pkg.tcp.TcpTransport()
    tr._ep = pkg.ring.Endpoint("node7", "dc2", "rack5", "127.0.0.1", 7007)
    peer = pkg.ring.Endpoint("peer", host="127.0.0.1",
                             port=lis.getsockname()[1])
    try:
        conn = tr._connection(peer)
        sock, _ = lis.accept()
        sock.settimeout(5.0)
        data = b""
        while True:
            try:
                chunk = sock.recv(4096)
            except socket.timeout:
                break
            if not chunk:
                break
            data += chunk
            if len(data) >= 16 and len(data) >= 16 + int.from_bytes(
                    data[12:16], "little"):
                break
        sock.close()
        conn.close()
        return data
    finally:
        lis.close()


def test_tcp_handshake_byte_equal():
    j, t = _handshake(JAX), _handshake(PORT)
    assert t == j and t.startswith(b"CTPUNET1")


class _Recorder:
    """A socket stand-in that keeps every byte the server sends."""

    def __init__(self, sock):
        self.sock, self.got = sock, bytearray()

    def recv(self, n):
        chunk = self.sock.recv(n)
        self.got += chunk
        return chunk

    def __getattr__(self, name):
        return getattr(self.sock, name)


SETUP = [
    "CREATE KEYSPACE ks WITH replication = {'class': 'SimpleStrategy', "
    "'replication_factor': 1}",
    "USE ks",
    "CREATE TABLE t (k int, c int, v text, n bigint, PRIMARY KEY (k, c)) "
    "WITH id = 5d3c9a60-0000-4000-8000-00000000c001",
]


def _server_bytes(pkg, d: str, version: int) -> tuple:
    eng = pkg.engine(d)
    srv = pkg.Server(eng)
    try:
        s = pkg.client.Cluster("127.0.0.1", srv.port,
                               protocol_version=version).connect()
        rec = _Recorder(s._sock)
        s._sock = rec
        for q in SETUP:
            s.execute(q)
        t = eng.schema.get_table("ks", "t")
        cols = ["k", "c", "v", "n"]
        for i in range(30):
            s.execute(f"INSERT INTO t (k, c, v, n) VALUES (?, ?, ?, ?) "
                      f"USING TIMESTAMP {1000 + i}",
                      pkg.client.serialize_params(
                          t, cols, [i % 4, i, f"row{i}", i * 1_000_003]))
        pages, state = [], None
        while True:
            rs = s.execute("SELECT k, c, v, n FROM t", fetch_size=7,
                           paging_state=state)
            pages.append(rs.rows)
            state = rs.paging_state
            if state is None:
                break
        errs = []
        for bad in ("SELECT * FROM nosuch", "SELEC k FROM t",
                    "SELECT k FROM t WHERE v = 'x'"):
            try:
                s.execute(bad)
            except pkg.client.DriverError as e:
                errs.append(str(e))
        qid = s.prepare("SELECT v, n FROM t WHERE k = ? AND c = ?")
        prepared = [s.execute_prepared(qid, pkg.client.serialize_params(
            t, ["k", "c"], [i % 4, i])).rows for i in range(0, 30, 5)]
        ins = s.prepare("INSERT INTO t (k, c, v, n) VALUES (?, ?, ?, ?) "
                        "USING TIMESTAMP 9")
        s.execute_prepared(ins, pkg.client.serialize_params(
            t, cols, [9, 9, "p", None]))
        s.close()
        return bytes(rec.got), pages, errs, prepared
    finally:
        srv.close()
        eng.close()


@pytest.mark.parametrize("version", [4, 5])
def test_server_responses_byte_equal(tmp_path, version):
    j = _server_bytes(JAX, str(tmp_path / "jax"), version)
    t = _server_bytes(PORT, str(tmp_path / "port"), version)
    assert len(t[1]) == 5 and sum(len(p) for p in t[1]) == 30
    assert len(t[2]) == 3 and len(t[3]) == 6
    assert t[1:] == j[1:]
    assert t[0] == j[0]


TYPES = {"k": "int", "a": "bigint", "b": "text", "c": "blob",
         "d": "double", "e": "boolean", "f": "uuid", "g": "timestamp",
         "h": "list<int>", "i": "set<text>", "j": "map<text, int>",
         "l": "vector<float, 3>", "m": "float", "n": "smallint",
         "o": "tinyint", "p": "varint", "q": "inet"}


def _params(pkg, seed: int) -> list:
    import datetime
    import ipaddress
    rng = np.random.default_rng(seed)
    t = pkg.make_table("ks", "types", pk=["k"], cols=TYPES)
    vals = {"k": int(rng.integers(-1 << 31, 1 << 31)),
            "a": int(rng.integers(-1 << 62, 1 << 62)),
            "b": "text-" + str(int(rng.integers(1 << 30))),
            "c": bytes(rng.integers(0, 256, 17, dtype=np.uint8)),
            "d": float(rng.standard_normal()), "e": bool(seed % 2),
            "f": uuid.UUID(int=int(rng.integers(1 << 62)) << 60),
            "g": datetime.datetime(2024, 5, 6, 7, 8, 9,
                                   tzinfo=datetime.timezone.utc),
            "h": [int(x) for x in rng.integers(-99, 99, 4)],
            "i": {"x", "y", "z"}, "j": {"a": 1, "b": -2},
            "l": [float(x) for x in
                  rng.standard_normal(3).astype(np.float32)],
            "m": 1.5, "n": -7, "o": 3, "p": 1 << 70,
            "q": ipaddress.ip_address("10.1.2.3")}
    cols = list(TYPES)
    return pkg.client.serialize_params(t, cols, [vals[c] for c in cols]) \
        + pkg.client.serialize_params(t, ["b", "c"], [None, None])


@pytest.mark.parametrize("seed", [1, 2])
def test_client_serialize_params_byte_equal(seed):
    t = _params(PORT, seed)
    assert t == _params(JAX, seed)
    assert len(t) == len(TYPES) + 2 and t[-2:] == [None, None]


def _admin_request_line(pkg) -> bytes:
    """The line admin_call sends, read by a one-shot server that answers
    a canned response."""
    lis = socket.socket()
    lis.bind(("127.0.0.1", 0))
    lis.listen(1)
    got = {}

    def serve():
        sock, _ = lis.accept()
        f = sock.makefile("rwb")
        got["line"] = f.readline()
        f.write(b'{"ok": true, "result": {"n": [1, 2]}}\n')
        f.flush()
        sock.close()
    th = threading.Thread(target=serve)
    th.start()
    try:
        res = pkg.admin.admin_call("127.0.0.1", lis.getsockname()[1],
                                   "getendpoints",
                                   {"keyspace": "ks", "table": "t",
                                    "key": "7"}, secret="s3cret")
    finally:
        th.join(10)
        lis.close()
    assert res == {"n": [1, 2]}
    return got["line"]


REQUESTS = [
    b'{"cmd": "status", "args": {}}\n',
    b'{"cmd": "describering", "args": {"keyspace": "ks"}}\n',
    b'{"cmd": "getendpoints", "args": {"keyspace": "ks", "table": "t", '
    b'"key": "5"}}\n',
    b'{"cmd": "flush", "args": {"keyspace": "ks"}}\n',
    b'{"cmd": "nosuch", "args": {}}\n',
    b'{"cmd": "getendpoints", "args": {"bogus": 1}}\n',
    b'not json\n',
]


def _admin_responses(pkg, d: str) -> list:
    c = pkg.cluster(d)
    adm = pkg.admin.AdminServer(c.node(1))
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = {'class': "
                  "'SimpleStrategy', 'replication_factor': 2}")
        s.execute("CREATE TABLE ks.t (k int PRIMARY KEY, v int)")
        out = []
        with socket.create_connection(("127.0.0.1", adm.port),
                                      timeout=30) as sock:
            f = sock.makefile("rwb")
            for req in REQUESTS:
                f.write(req)
                f.flush()
                out.append(f.readline())
        return out
    finally:
        adm.close()
        c.shutdown()


def test_admin_lines_byte_equal(tmp_path):
    assert _admin_request_line(PORT) == _admin_request_line(JAX)
    j = _admin_responses(JAX, str(tmp_path / "jax"))
    t = _admin_responses(PORT, str(tmp_path / "port"))
    assert t == j
    assert t[0].startswith(b'{"ok": true') and \
        t[4].startswith(b'{"ok": false')


def _placement(pkg, topo: str, names: list, tokens: list) -> tuple:
    sn = pkg.snitch.create({"class": "PropertyFileSnitch",
                            "topology": topo})
    where = [sn.local_dc_rack(n) for n in names]
    ring = pkg.ring.Ring()
    for name, (dc, rack), toks in zip(
            names, where, pkg.ring.even_tokens(len(names), vnodes=4)):
        ring.add_node(pkg.ring.Endpoint(name, dc, rack), toks)
    strat = pkg.repl.NetworkTopologyStrategy({"dc1": 3, "dc2": 2})
    return where, [[e.name for e in strat.replicas(ring, tok)]
                   for tok in tokens]


def test_snitch_placement_equal(tmp_path):
    rng = np.random.default_rng(5)
    names = [f"n{i}" for i in range(12)]
    lines = [f"{n}=dc{1 + int(rng.integers(2))}:r{int(rng.integers(3))}"
             for n in names[:10]] + ["default=dc1:r9"]
    topo = tmp_path / "topology"
    topo.write_text("\n".join(lines) + "\n")
    tokens = [int(x) for x in rng.integers(-(1 << 63), (1 << 63) - 1,
                                           64, dtype=np.int64)]
    j = _placement(JAX, str(topo), names, tokens)
    t = _placement(PORT, str(topo), names, tokens)
    assert t == j
    assert {dc for dc, _ in t[0]} == {"dc1", "dc2"}
    assert t[0][10:] == [("dc1", "r9")] * 2         # the default
    assert all(len(r) == 5 for r in t[1])

