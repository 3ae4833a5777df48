"""The port's counterpart of tests/test_auth_depth.py:
the same assertions on cassandra_tpu_torch, every engine on the CPU
(device="cpu").

Auth depth (round 3): CIDR authorization, network (datacenter)
authorization, mTLS identity mapping, auth caches, ALTER ROLE / ADD
IDENTITY CQL — auth/CIDRPermissionsManager, CassandraNetworkAuthorizer,
MutualTlsAuthenticator, AuthCache counterparts."""
import time

import pytest

from cassandra_tpu_torch.service.auth import (AuthCache, AuthenticationError,
                                        AuthService, UnauthorizedError)
from torch_tmp import tmp_path  # noqa: F401


@pytest.fixture
def auth(tmp_path):
    return AuthService(str(tmp_path), enabled=True)


def test_cidr_groups(auth):
    auth.create_role("app", "pw")
    auth.set_cidr_group("office", ["10.1.0.0/16", "192.168.7.0/24"])
    auth.alter_role_access("app", cidr_groups=["office"])
    auth.check_cidr("app", "10.1.2.3")          # inside
    auth.check_cidr("app", "192.168.7.200")     # inside
    with pytest.raises(UnauthorizedError, match="may not connect"):
        auth.check_cidr("app", "172.16.0.1")    # outside
    # superusers and unrestricted roles connect from anywhere
    auth.check_cidr("cassandra", "8.8.8.8")
    auth.create_role("free", "pw")
    auth.check_cidr("free", "8.8.8.8")
    # unknown group rejected at grant time
    with pytest.raises(ValueError, match="unknown CIDR groups"):
        auth.alter_role_access("app", cidr_groups=["nope"])
    # clearing restores access
    auth.alter_role_access("app", cidr_groups=[])
    auth.check_cidr("app", "172.16.0.1")


def test_network_authorization(auth):
    auth.create_role("dc1only", "pw")
    auth.alter_role_access("dc1only", datacenters=["dc1"])
    auth.check_datacenter("dc1only", "dc1")
    with pytest.raises(UnauthorizedError, match="no access to datacenter"):
        auth.check_datacenter("dc1only", "dc2")
    auth.check_datacenter("cassandra", "dc2")   # superuser unrestricted
    auth.alter_role_access("dc1only", datacenters=[])   # ALL DATACENTERS
    auth.check_datacenter("dc1only", "dc2")


def test_mtls_identities(auth):
    auth.create_role("svc", None, login=True)
    auth.add_identity("spiffe://cluster/ns/prod/svc", "svc")
    assert auth.authenticate_identity(
        "spiffe://cluster/ns/prod/svc") == "svc"
    with pytest.raises(AuthenticationError, match="no role"):
        auth.authenticate_identity("spiffe://evil")
    auth.drop_identity("spiffe://cluster/ns/prod/svc")
    with pytest.raises(AuthenticationError):
        auth.authenticate_identity("spiffe://cluster/ns/prod/svc")
    with pytest.raises(ValueError, match="unknown role"):
        auth.add_identity("x", "ghost")


def test_auth_cache_memoizes_and_invalidates(auth):
    auth.create_role("u", "pw")
    auth.grant("SELECT", "ks", "u")
    auth.check("u", "SELECT", "ks")
    # revoke invalidates the verdict cache immediately (persisted save
    # path calls invalidate_all), so the next check fails
    auth.revoke("SELECT", "ks", "u")
    with pytest.raises(UnauthorizedError):
        auth.check("u", "SELECT", "ks")


def test_auth_cache_ttl():
    c = AuthCache(validity=0.05)
    calls = []
    assert c.get("k", lambda: calls.append(1) or "v") == "v"
    assert c.get("k", lambda: calls.append(1) or "v") == "v"
    assert len(calls) == 1          # cached
    # past the validity the entry expires: wait until a get re-loads
    deadline = time.monotonic() + 5.0
    while len(calls) == 1 and time.monotonic() < deadline:
        assert c.get("k", lambda: calls.append(1) or "v") == "v"
        time.sleep(0.01)
    assert len(calls) == 2          # expired, re-loaded


def test_persistence_roundtrip(tmp_path):
    a = AuthService(str(tmp_path), enabled=True)
    a.create_role("app", "pw")
    a.set_cidr_group("office", ["10.0.0.0/8"])
    a.alter_role_access("app", cidr_groups=["office"],
                        datacenters=["dc2"])
    a.add_identity("CN=app", "app")
    b = AuthService(str(tmp_path), enabled=True)
    assert b.cidr_groups == {"office": ["10.0.0.0/8"]}
    assert b.authenticate_identity("CN=app") == "app"
    with pytest.raises(UnauthorizedError):
        b.check_cidr("app", "11.0.0.1")
    with pytest.raises(UnauthorizedError):
        b.check_datacenter("app", "dc1")


def test_cql_role_access_and_identity(tmp_path):
    """CREATE/ALTER ROLE ... WITH ACCESS TO DATACENTERS / FROM CIDRS and
    ADD/DROP IDENTITY through the full CQL path."""
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine

    eng = StorageEngine(str(tmp_path), Schema(), durable_writes=False,
                        auth_enabled=True, device="cpu")
    try:
        from cassandra_tpu_torch.cql.processor import QueryProcessor
        qp = QueryProcessor(eng)

        def ex(q):
            return qp.process(q, user="cassandra")

        eng.auth.set_cidr_group("office", ["10.0.0.0/8"])
        ex("CREATE ROLE app WITH password = 'pw' AND "
           "ACCESS TO DATACENTERS {'dc1', 'dc3'}")
        assert eng.auth.roles["app"]["datacenters"] == ["dc1", "dc3"]
        ex("ALTER ROLE app WITH ACCESS FROM CIDRS {'office'}")
        assert eng.auth.roles["app"]["cidr_groups"] == ["office"]
        ex("ALTER ROLE app WITH superuser = true")
        assert eng.auth.roles["app"]["superuser"] is True
        ex("ALTER ROLE app WITH ACCESS TO ALL DATACENTERS")
        assert eng.auth.roles["app"]["datacenters"] == []
        ex("ADD IDENTITY 'spiffe://c/app' TO ROLE 'app'")
        assert eng.auth.authenticate_identity("spiffe://c/app") == "app"
        ex("DROP IDENTITY 'spiffe://c/app'")
        with pytest.raises(AuthenticationError):
            eng.auth.authenticate_identity("spiffe://c/app")
        # non-superusers cannot manage roles/identities
        ex("CREATE ROLE pleb WITH password = 'x'")
        with pytest.raises(Exception, match="superuser"):
            qp.process("ADD IDENTITY 'i' TO ROLE 'app'", user="pleb")
    finally:
        eng.close()


def _mtls_certs(d):
    """CA + server cert + client cert with CN=svc-client (the mTLS
    identity)."""
    import subprocess

    d = str(d)

    def run(*args):
        subprocess.run(["openssl", *args], cwd=d, check=True,
                       capture_output=True)

    run("req", "-x509", "-newkey", "rsa:2048", "-days", "1", "-nodes",
        "-keyout", "ca.key", "-out", "ca.crt", "-subj", "/CN=ctpu-ca")
    for name, cn in (("server", "127.0.0.1"), ("client", "svc-client")):
        run("req", "-newkey", "rsa:2048", "-nodes", "-keyout",
            f"{name}.key", "-out", f"{name}.csr", "-subj", f"/CN={cn}")
        run("x509", "-req", "-in", f"{name}.csr", "-CA", "ca.crt",
            "-CAkey", "ca.key", "-CAcreateserial", "-days", "1",
            "-out", f"{name}.crt")
    return d


def test_mtls_connect_end_to_end(tmp_path):
    """A client certificate identity authenticates over a real TLS
    native-protocol connection with no password exchange."""
    import shutil

    if shutil.which("openssl") is None:
        pytest.skip("openssl unavailable")
    from cassandra_tpu_torch.client import Cluster
    from cassandra_tpu_torch.cluster.tls import TLSConfig
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.transport_server import CQLServer

    d = _mtls_certs(tmp_path)
    eng = StorageEngine(str(tmp_path / "data"), Schema(),
                        durable_writes=False, auth_enabled=True, device="cpu")
    srv = None
    try:
        eng.auth.create_role("clientrole", None)
        eng.auth.grant("SELECT", "ALL KEYSPACES", "clientrole")
        eng.auth.add_identity("svc-client", "clientrole")
        srv = CQLServer(eng, tls=TLSConfig(
            f"{d}/server.crt", f"{d}/server.key", f"{d}/ca.crt",
            require_client_auth=True))
        sess = Cluster("127.0.0.1", srv.port, tls=True,
                       cafile=f"{d}/ca.crt",
                       certfile=f"{d}/client.crt",
                       keyfile=f"{d}/client.key").connect()
        rows = sess.execute("SELECT * FROM system.local")
        assert rows.rows
    finally:
        if srv is not None:
            srv.close()
        eng.close()
