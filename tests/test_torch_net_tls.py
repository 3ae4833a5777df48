"""The port's counterpart of tests/test_tls.py:
the same assertions on cassandra_tpu_torch, every engine on the CPU
(device="cpu").

TLS on the internode and native-protocol transports.

Reference: security/SSLFactory + cassandra.yaml
server_encryption_options (internode mutual TLS) and
client_encryption_options (native protocol)."""
import socket
import subprocess
import time

import pytest

from cassandra_tpu_torch.cluster.ring import Endpoint, Ring, even_tokens
from cassandra_tpu_torch.cluster.tls import TLSConfig
from torch_tmp import tmp_path  # noqa: F401


def make_certs(d):
    """Cluster CA + one node cert signed by it (operator workflow)."""
    d = str(d)

    def run(*args):
        subprocess.run(["openssl", *args], cwd=d, check=True,
                       capture_output=True)

    run("req", "-x509", "-newkey", "rsa:2048", "-days", "1", "-nodes",
        "-keyout", "ca.key", "-out", "ca.crt", "-subj", "/CN=ctpu-ca")
    run("req", "-newkey", "rsa:2048", "-nodes", "-keyout", "node.key",
        "-out", "node.csr", "-subj", "/CN=ctpu-node")
    run("x509", "-req", "-in", "node.csr", "-CA", "ca.crt", "-CAkey",
        "ca.key", "-CAcreateserial", "-days", "1", "-out", "node.crt")
    return TLSConfig(f"{d}/node.crt", f"{d}/node.key", f"{d}/ca.crt")


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return make_certs(tmp_path_factory.mktemp("certs"))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_internode_mutual_tls(tmp_path, certs):
    """Two nodes over TLS TcpTransports gossip and serve quorum writes;
    a plaintext dial to the TLS listener is refused."""
    from cassandra_tpu_torch.cluster.node import Node
    from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
    from cassandra_tpu_torch.cluster.tcp import TcpTransport
    from cassandra_tpu_torch.schema import Schema

    eps = [Endpoint(n, host="127.0.0.1", port=_free_port())
           for n in ("node1", "node2")]
    tokens = even_tokens(2, vnodes=4)
    ring = Ring()
    for ep, toks in zip(eps, tokens):
        ring.add_node(ep, toks)
    nodes = []
    schema = Schema()          # shared, LocalCluster-style: the WRITES
    try:                       # and READS cross the TLS sockets
        for ep in eps:
            n = Node(ep, str(tmp_path / ep.name), schema, ring,
                     TcpTransport(tls=certs), seeds=[eps[0]],
                     gossip_interval=0.05, engine_opts={"device": "cpu"})
            nodes.append(n)
        for n in nodes:
            n.cluster_nodes = nodes
            n.gossiper.start()
        deadline = time.time() + 10
        while time.time() < deadline:
            if all(a.is_alive(b.endpoint) for a in nodes for b in nodes):
                break
            time.sleep(0.05)
        assert nodes[0].is_alive(eps[1]), "TLS gossip never converged"

        s = nodes[0].session()
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 2}")
        s.execute("USE ks")
        s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
        nodes[0].default_cl = ConsistencyLevel.ALL
        for i in range(5):
            s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'tls{i}')")
        got = {r[0] for r in s.execute("SELECT k FROM kv").rows}
        assert got == set(range(5))

        # plaintext client: the listener refuses at TLS handshake
        raw = socket.create_connection(("127.0.0.1", eps[0].port),
                                       timeout=2)
        raw.sendall(b"CTPUNET1" + b"\x00" * 8)
        raw.settimeout(2)
        try:
            data = raw.recv(64)
            assert data == b""      # closed without serving
        except (ConnectionError, TimeoutError, OSError):
            pass
        finally:
            raw.close()
    finally:
        for n in nodes:
            n.engine.close()
            n.gossiper.stop()
            n.messaging.close()


def test_native_protocol_tls(tmp_path, certs):
    """CQLServer with client_encryption_options: TLS clients work
    (verified against the CA), plaintext clients fail."""
    from cassandra_tpu_torch.client import ClientSession, DriverError
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.transport_server import CQLServer

    eng = StorageEngine(str(tmp_path / "d"), Schema(),
                        commitlog_sync="batch", device="cpu")
    Session(eng).execute("CREATE KEYSPACE ks WITH replication = "
                         "{'class': 'SimpleStrategy', "
                         "'replication_factor': 1}")
    cfg = TLSConfig(certs.certfile, certs.keyfile, certs.cafile,
                    require_client_auth=False)
    srv = CQLServer(eng, tls=cfg)
    try:
        c = ClientSession("127.0.0.1", srv.port, tls=True,
                          cafile=certs.cafile)
        c.execute("CREATE TABLE ks.kv (k int PRIMARY KEY, v text)")
        c.execute("INSERT INTO ks.kv (k, v) VALUES (1, 'sec')")
        assert c.execute("SELECT v FROM ks.kv WHERE k = 1").rows \
            == [("sec",)]

        with pytest.raises((DriverError, OSError)):
            ClientSession("127.0.0.1", srv.port)   # plaintext refused
    finally:
        srv.close()
        eng.close()


def test_native_tls_requires_client_cert_when_configured(tmp_path,
                                                         certs):
    from cassandra_tpu_torch.client import ClientSession, DriverError
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.transport_server import CQLServer

    eng = StorageEngine(str(tmp_path / "d"), Schema(),
                        commitlog_sync="batch", device="cpu")
    srv = CQLServer(eng, tls=certs)   # require_client_auth=True
    try:
        # no client cert -> handshake fails
        with pytest.raises((DriverError, OSError)):
            c = ClientSession("127.0.0.1", srv.port, tls=True,
                              cafile=certs.cafile)
            c.execute("SELECT * FROM system.local")
        # with the CA-signed cert -> accepted
        c = ClientSession("127.0.0.1", srv.port, tls=True,
                          cafile=certs.cafile, certfile=certs.certfile,
                          keyfile=certs.keyfile)
        assert c.execute("SELECT * FROM system.local").rows
    finally:
        srv.close()
        eng.close()


def test_mutual_tls_requires_ca(certs):
    """A config claiming client-auth without a CA must not build — it
    would silently verify nothing."""
    with pytest.raises(ValueError, match="cafile"):
        TLSConfig(certs.certfile, certs.keyfile, cafile=None)
    # encryption-only is an explicit choice
    TLSConfig(certs.certfile, certs.keyfile, cafile=None,
              require_client_auth=False)
