"""The port's counterpart of tests/test_admin.py:
the same assertions on cassandra_tpu_torch, every engine on the CPU
(device="cpu").

Remote admin protocol (service/admin.py — the JMX/NodeProbe role) and
the round-3 nodetool command set, driven over a real TCP admin socket
against in-process nodes."""
import pytest

from cassandra_tpu_torch.cluster.node import LocalCluster
from cassandra_tpu_torch.service.admin import AdminServer, admin_call
from cassandra_tpu_torch.tools import nodetool
from torch_tmp import tmp_path  # noqa: F401


@pytest.fixture
def cluster(tmp_path):
    c = LocalCluster(2, str(tmp_path), rf=2, device="cpu")
    s = c.nodes[0].session()
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 2}")
    s.execute("CREATE TABLE ks.t (id int PRIMARY KEY, v text)")
    for i in range(20):
        s.execute(f"INSERT INTO ks.t (id, v) VALUES ({i}, 'v{i}')")
    c.nodes[0].engine.flush_all()
    try:
        yield c
    finally:
        c.shutdown()


@pytest.fixture
def admin(cluster):
    srv = AdminServer(cluster.nodes[0])
    try:
        yield ("127.0.0.1", srv.port)
    finally:
        srv.close()


def call(admin, cmd, **args):
    host, port = admin
    return admin_call(host, port, cmd, args)


def test_remote_status_and_info(admin):
    rows = call(admin, "status")
    assert len(rows) == 2 and all(r["status"] == "UN" for r in rows)
    info = call(admin, "info")
    assert "ks.t" in info["tables"]
    assert call(admin, "version")["release"].startswith("cassandra-tpu")


def test_remote_mutable_settings(cluster, admin):
    node = cluster.nodes[0]
    call(admin, "setcompactionthroughput", mib_s=17)
    assert node.engine.settings.get("compaction_throughput") == 17.0
    assert node.engine.compactions.limiter.rate == 17 * 2**20
    assert call(admin, "getcompactionthroughput") == {
        "compaction_throughput_mib": 17}
    call(admin, "settimeout", timeout_type="write", ms=1500)
    assert node.proxy.write_timeout == 1.5
    assert call(admin, "gettimeout", timeout_type="write") == {
        "write": 1500.0}
    call(admin, "settraceprobability", p=0.25)
    assert call(admin, "gettraceprobability") == {"trace_probability": 0.25}


def test_remote_handoff_and_autocompaction_toggles(cluster, admin):
    node = cluster.nodes[0]
    assert call(admin, "statushandoff") == {"handoff": "running"}
    call(admin, "disablehandoff")
    assert node.hints.enabled is False
    # a hint to a dead target is silently dropped while disabled
    from cassandra_tpu_torch.storage.mutation import Mutation
    t = node.schema.get_table("ks", "t")
    m = Mutation(t.id, t.partition_key_columns[0].cql_type.serialize(1))
    m.add(b"", 6, b"", b"x", ts=1)
    node.hints.store(cluster.nodes[1].endpoint, m)
    assert call(admin, "listpendinghints") == []
    call(admin, "enablehandoff")
    assert node.hints.enabled is True

    call(admin, "disableautocompaction")
    assert node.engine.compactions.paused is True
    assert call(admin, "statusautocompaction") == {"running": False}
    call(admin, "enableautocompaction")
    assert node.engine.compactions.paused is False


def test_remote_ops_surface(admin):
    st = call(admin, "netstats")
    assert "messaging" in st and st["messaging"]["sent"] >= 0
    pools = {p["pool"] for p in call(admin, "tpstats")}
    assert "CompactionExecutor" in pools
    hist = call(admin, "proxyhistograms")
    assert "request" in hist
    ver = call(admin, "verify")
    assert ver and all(r["ok"] for r in ver)
    ssts = call(admin, "getsstables", keyspace="ks", table="t", key="3")
    assert isinstance(ssts, list)
    assert call(admin, "statusgossip")["gossip"] in ("running",
                                                     "not running")
    assert call(admin, "statusbinary") == {"native_transport":
                                           "not running"}
    call(admin, "invalidatechunkcache")
    call(admin, "invalidaterowcache")
    call(admin, "invalidatecountercache")
    # flush twice then major-compact so history has a real entry
    call(admin, "flush")
    call(admin, "compact")
    hist = call(admin, "compactionhistory")
    assert hist and all(h["table"] == "ks.t" for h in hist)
    assert hist[0]["cells_read"] >= 20


def test_remote_drain_and_refresh(cluster, admin):
    node = cluster.nodes[0]
    s = node.session()
    s.execute("INSERT INTO ks.t (id, v) VALUES (99, 'pre-drain')")
    assert call(admin, "drain") == {"drained": True}
    assert len(node.engine.store("ks", "t").memtable) == 0
    r = call(admin, "refresh", keyspace="ks", table="t")
    assert r["sstables_after"] >= 1


def test_unknown_command_and_bad_args(admin):
    with pytest.raises(RuntimeError, match="unknown command"):
        call(admin, "nosuchcmd")
    with pytest.raises(RuntimeError, match="unknown endpoint"):
        call(admin, "assassinate", endpoint="ghost")


def test_cli_offline_mode(tmp_path, capsys):
    """nodetool --data offline mode still works for engine commands."""
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine

    eng = StorageEngine(str(tmp_path / "d"), Schema(), device="cpu")
    eng.close()
    nodetool.main(["info", "--data", str(tmp_path / "d"),
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"tables"' in out
