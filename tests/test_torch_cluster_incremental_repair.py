"""The port's counterpart of tests/test_incremental_repair.py: the same
assertions on cassandra_tpu_torch, every engine on the CPU (device="cpu").

Repaired/unrepaired split + incremental repair + anticompaction
(reference CompactionStrategyManager.java:107, CompactionManager.java:838
doAntiCompaction, repair/consistent/)."""
import pytest

from cassandra_tpu_torch.cluster.node import LocalCluster
from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
from cassandra_tpu_torch.compaction.strategies import get_strategy
from cassandra_tpu_torch.compaction.task import CompactionTask
from cassandra_tpu_torch.cql import Session
from cassandra_tpu_torch.schema import Schema
from cassandra_tpu_torch.storage.engine import StorageEngine
from torch_tmp import tmp_path  # noqa: F401


@pytest.fixture
def engine(tmp_path):
    eng = StorageEngine(str(tmp_path / "data"), Schema(),
                        commitlog_sync="batch", device="cpu")
    yield eng
    eng.close()


@pytest.fixture
def session(engine):
    s = Session(engine)
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE ks")
    return s


def _mark_repaired(sst, at=12345):
    """Simulate a prior repair by rewriting the stats metadata."""
    import json
    from cassandra_tpu_torch.storage.sstable.format import Component
    p = sst.desc.path(Component.STATS)
    stats = json.load(open(p))
    stats["repaired_at"] = at
    json.dump(stats, open(p, "w"))
    sst.stats["repaired_at"] = at


def test_compaction_never_crosses_repaired_boundary(session, engine):
    session.execute("CREATE TABLE t (k int PRIMARY KEY, v text)")
    cfs = engine.store("ks", "t")
    for gen in range(8):
        for k in range(20):
            session.execute(f"INSERT INTO t (k, v) VALUES ({k}, 'g{gen}')")
        cfs.flush()
    live = cfs.live_sstables()
    for sst in live[:4]:
        _mark_repaired(sst)
    mgr = get_strategy(cfs)
    # drain background selections: every task stays on one side
    for _ in range(10):
        task = mgr.next_background_task()
        if task is None:
            break
        sides = {s.is_repaired for s in task.inputs}
        assert len(sides) == 1, "compaction crossed the repaired boundary"
        task.execute()
    # major compaction produces one output per side
    task = mgr.major_task()
    if task is not None:
        task.execute()
    repaired = [s for s in cfs.live_sstables() if s.is_repaired]
    unrepaired = [s for s in cfs.live_sstables() if not s.is_repaired]
    assert repaired and unrepaired
    # outputs carry min repairedAt: repaired side kept its stamp
    assert all(s.repaired_at > 0 for s in repaired)


def test_anticompaction_splits_by_range(session, engine):
    from cassandra_tpu_torch.storage.cellbatch import batch_tokens
    from cassandra_tpu_torch.utils import murmur3
    session.execute("CREATE TABLE a (k int PRIMARY KEY, v text)")
    cfs = engine.store("ks", "a")
    t = engine.schema.get_table("ks", "a")
    toks = {}
    for k in range(40):
        session.execute(f"INSERT INTO a (k, v) VALUES ({k}, 'x')")
        toks[k] = murmur3.token_of(t.columns["k"].cql_type.serialize(k))
    cfs.flush()
    median = sorted(toks.values())[20]

    class _FakeNode:
        pass

    # drive anticompact_local directly through a repair service facade
    svc = type("S", (), {"node": type("N", (), {"engine": engine})()})()
    from cassandra_tpu_torch.cluster.repair import RepairService
    n = RepairService.anticompact_local(
        svc, "ks", "a", [(-(1 << 63), median)], repaired_at=777)
    assert n == 1
    live = cfs.live_sstables()
    rep = [s for s in live if s.is_repaired]
    unrep = [s for s in live if not s.is_repaired]
    assert len(rep) == 1 and len(unrep) == 1
    assert rep[0].repaired_at == 777
    # token split is exact
    assert rep[0].max_token() <= median
    assert unrep[0].min_token() > median
    total = sum(s.n_cells for s in live)
    assert total == 40 * 2  # 40 rows x (liveness + value cell)


def test_incremental_repair_end_to_end(tmp_path):
    c = LocalCluster(3, str(tmp_path), rf=3, device="cpu")
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        s.execute("USE ks")
        s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
        n1 = c.node(1)
        n1.default_cl = ConsistencyLevel.ALL
        for k in range(30):
            s.execute(f"INSERT INTO kv (k, v) VALUES ({k}, 'v{k}')")
        for node in c.nodes:
            node.engine.store("ks", "kv").flush()
        stats = n1.repair.repair_table("ks", "kv", incremental=True,
                                       timeout=15.0)
        assert stats["anticompacted"] >= 3   # every replica anticompacted
        for node in c.nodes:
            cfs = node.engine.store("ks", "kv")
            assert all(sst.is_repaired for sst in cfs.live_sstables())
        # a second incremental repair has nothing unrepaired to validate
        stats2 = n1.repair.repair_table("ks", "kv", incremental=True,
                                        timeout=15.0)
        assert stats2["ranges_synced"] == 0
        # reads still correct afterwards
        assert s.execute("SELECT v FROM kv WHERE k = 7").rows == [("v7",)]
    finally:
        c.shutdown()


def test_incremental_repair_refuses_down_replica(tmp_path):
    import time
    c = LocalCluster(3, str(tmp_path), rf=3, gossip_interval=0.05,
                     device="cpu")
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        s.execute("USE ks")
        s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
        victim = c.nodes[2]
        victim.messaging.close()
        victim.gossiper.stop()
        deadline = time.time() + 10
        while time.time() < deadline and \
                c.node(1).is_alive(victim.endpoint):
            time.sleep(0.1)
        assert not c.node(1).is_alive(victim.endpoint)
        with pytest.raises(RuntimeError, match="all replicas up"):
            c.node(1).repair.repair_table("ks", "kv", incremental=True,
                                          timeout=5.0)
    finally:
        c.shutdown()


def test_preview_repair_reports_without_streaming(tmp_path):
    """repair --preview (PreviewKind role): diverged replicas are
    REPORTED but nothing streams and nothing is stamped; a followup
    real repair fixes what preview saw."""
    from cassandra_tpu_torch.cluster.messaging import Verb
    from cassandra_tpu_torch.cluster.node import LocalCluster
    from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
    c = LocalCluster(2, str(tmp_path), rf=2, device="cpu")
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 2}")
        s.execute("CREATE TABLE ks.t (k int PRIMARY KEY, v int)")
        n1 = c.node(1)
        n1.default_cl = ConsistencyLevel.ALL
        for i in range(10):
            s.execute(f"INSERT INTO ks.t (k, v) VALUES ({i}, {i})")
        rule = c.filters.drop(verb=Verb.MUTATION_REQ,
                              to=c.nodes[1].endpoint)
        n1.default_cl = ConsistencyLevel.ONE
        s.execute("INSERT INTO ks.t (k, v) VALUES (99, 99)")
        rule["remaining"] = 0
        before2 = len(c.node(2).engine.store("ks", "t").scan_all())
        stats = n1.repair.repair_table("ks", "t", preview=True)
        assert stats["preview"] and stats["ranges_mismatched"] > 0
        assert stats["cells_streamed"] == 0
        # nothing moved
        assert len(c.node(2).engine.store("ks", "t").scan_all()) == before2
        # the session journal recorded it durably
        sessions = n1.repair.sessions.sessions()
        assert sessions and sessions[-1]["state"] == "COMPLETED"
        assert sessions[-1]["preview"] is True
        # a real repair then converges the replicas
        stats2 = n1.repair.repair_table("ks", "t")
        assert stats2["cells_streamed"] > 0
    finally:
        c.shutdown()


def test_repair_sessions_survive_restart(tmp_path):
    """An IN_PROGRESS record with no FINALIZED pair survives a
    coordinator restart and shows in repair_admin (LocalSessions
    persistence role)."""
    from cassandra_tpu_torch.cluster.repair import RepairSessionStore
    store = RepairSessionStore(str(tmp_path))
    store.begin("s1", keyspace="ks", table="t", incremental=True,
                preview=False, coordinator="node1")
    store.begin("s2", keyspace="ks", table="u", incremental=False,
                preview=False, coordinator="node1")
    store.finish("s2", "COMPLETED")
    # "restart": a fresh store over the same directory
    store2 = RepairSessionStore(str(tmp_path))
    inflight = store2.in_flight()
    assert [s["id"] for s in inflight] == ["s1"]
    states = {s["id"]: s["state"] for s in store2.sessions()}
    assert states == {"s1": "IN_PROGRESS", "s2": "COMPLETED"}
