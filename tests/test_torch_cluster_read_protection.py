"""The port's counterpart of tests/test_read_protection.py: the same
assertions on cassandra_tpu_torch, every engine on the CPU (device="cpu").

Divergent-replica read protections.

Short reads: replicas truncate at the pushed DataLimits before merging
(storage/cellbatch.py truncate_live_rows), so the coordinator carries
short-read protection — re-query with doubled limits on post-merge
shortfall (cluster/coordinator.py read_partition;
service/reads/ShortReadPartitionsProtection.java:40). The first test
pins the reference's canonical failure scenario end-to-end; deeper
SRP coverage lives in tests/test_datalimits.py.

Filtered reads: ReplicaFilteringProtection.java:66 — index candidates
are unioned over blockFor replicas per range and every candidate is
re-read at the read CL and re-checked, so stale matches are dropped and
matches a stale replica missed are found."""
import pytest

from cassandra_tpu_torch.cluster.messaging import Verb
from cassandra_tpu_torch.cluster.node import LocalCluster
from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
from torch_tmp import tmp_path  # noqa: F401


@pytest.fixture
def cluster(tmp_path):
    c = LocalCluster(2, str(tmp_path), rf=2, device="cpu")
    for n in c.nodes:
        n.proxy.timeout = 1.0
    s = c.session(1)
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 2}")
    s.execute("USE ks")
    yield c
    c.shutdown()


def test_limit_correct_under_divergent_tombstones(cluster):
    """The reference short-read scenario: one replica holds newer
    tombstones for the rows the other would contribute under LIMIT.
    A per-replica-LIMIT design returns too few (or stale) rows; the
    post-merge LIMIT here must return the true newest rows."""
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("CREATE TABLE t (k int, c int, v text, "
              "PRIMARY KEY (k, c))")
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ALL
    for c_ in range(1, 6):
        s.execute(f"INSERT INTO t (k, c, v) VALUES (1, {c_}, 'v{c_}')")
    # deletions reach only node1
    victim = cluster.nodes[1].endpoint
    rule = cluster.filters.drop(verb=Verb.MUTATION_REQ, to=victim)
    n1.default_cl = ConsistencyLevel.ONE
    for c_ in range(1, 4):
        s.execute(f"DELETE FROM t WHERE k = 1 AND c = {c_}")
    rule["remaining"] = 0
    # replica 2 still has rows 1..3 live; QUORUM LIMIT 2 must see
    # through them to the true survivors 4, 5
    n1.default_cl = ConsistencyLevel.QUORUM
    rows = s.execute("SELECT c, v FROM t WHERE k = 1 LIMIT 2").rows
    assert rows == [(4, "v4"), (5, "v5")]


def test_replica_filtering_protection_stale_match_dropped(cluster):
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("CREATE TABLE u (k int PRIMARY KEY, v text)")
    s.execute("CREATE INDEX ON u (v)")
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ALL
    s.execute("INSERT INTO u (k, v) VALUES (1, 'x')")
    s.execute("INSERT INTO u (k, v) VALUES (2, 'x')")
    # node2 misses the update of k=1 away from 'x'
    victim = cluster.nodes[1].endpoint
    rule = cluster.filters.drop(verb=Verb.MUTATION_REQ, to=victim)
    n1.default_cl = ConsistencyLevel.ONE
    s.execute("UPDATE u SET v = 'y' WHERE k = 1")
    rule["remaining"] = 0
    n1.default_cl = ConsistencyLevel.QUORUM
    # node2's index still claims k=1 matches 'x' — the CL re-read must
    # surface v='y' and the re-check must drop the stale candidate
    rows = s.execute("SELECT k FROM u WHERE v = 'x'").rows
    assert rows == [(2,)]
    # and the new value is findable even though node2 never indexed it
    rows = s.execute("SELECT k FROM u WHERE v = 'y'").rows
    assert rows == [(1,)]


def test_index_candidates_cover_all_ranges(tmp_path):
    """RF=1 on 3 nodes: every row lives on exactly one node. Candidate
    discovery from the coordinator's local index alone would miss rows
    owned by the other two — the distributed union must find them all."""
    c = LocalCluster(3, str(tmp_path), rf=1, device="cpu")
    try:
        for n in c.nodes:
            n.proxy.timeout = 1.0
        s = c.session(1)
        s.execute("CREATE KEYSPACE r1 WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 1}")
        s.execute("USE r1")
        s.execute("CREATE TABLE w (k int PRIMARY KEY, v text)")
        s.execute("CREATE INDEX ON w (v)")
        c.node(1).default_cl = ConsistencyLevel.ONE
        for k in range(30):
            s.execute(f"INSERT INTO w (k, v) VALUES ({k}, 'tag')")
        rows = s.execute("SELECT k FROM w WHERE v = 'tag'").rows
        assert sorted(r[0] for r in rows) == list(range(30))
        # sanity: the data really is spread across nodes
        t = c.schema.get_table("r1", "w")
        holders = set()
        for k in range(30):
            pk = t.columns["k"].cql_type.serialize(k)
            for i, n in enumerate(c.nodes):
                b = n.engine.store("r1", "w").read_partition(pk)
                if b is not None and len(b):
                    holders.add(i)
        assert len(holders) > 1
    finally:
        c.shutdown()
