"""The port's counterpart of tests/test_cluster.py: the same assertions on
cassandra_tpu_torch, every engine on the CPU (device="cpu").

Multi-node tests over LocalCluster — the jvm-dtest analog (reference:
test/distributed/test/*; in-process nodes, droppable messages)."""
import time

import pytest

from cassandra_tpu_torch.cluster.messaging import Verb
from cassandra_tpu_torch.cluster.node import LocalCluster
from cassandra_tpu_torch.cluster.replication import (ConsistencyLevel,
                                                     NetworkTopologyStrategy)
from cassandra_tpu_torch.cluster.ring import Endpoint, Ring, even_tokens
from cassandra_tpu_torch.cluster.coordinator import (TimeoutException,
                                                     UnavailableException)
from torch_tmp import tmp_path  # noqa: F401


@pytest.fixture
def cluster(tmp_path):
    c = LocalCluster(3, str(tmp_path), rf=3, device="cpu")
    for n in c.nodes:
        n.proxy.timeout = 1.0
    s = c.session(1)
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 3}")
    s.execute("USE ks")
    s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
    yield c
    c.shutdown()


def _poll(cond, timeout=15.0):
    """Poll `cond` until it holds; False if `timeout` seconds pass."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def test_write_one_node_read_another(cluster):
    """A write through node 1 is read through node 2. At QUORUM on both
    sides R + W > RF, so the read sees it at once. At ONE node 1
    acknowledges after its own write, so node 2's local read may run
    before the replica message lands: it must see the value within a
    bounded poll."""
    cluster.node(1).default_cl = ConsistencyLevel.QUORUM
    cluster.node(2).default_cl = ConsistencyLevel.QUORUM
    s1 = cluster.session(1)
    s1.keyspace = "ks"
    s1.execute("INSERT INTO kv (k, v) VALUES (1, 'hello')")
    s2 = cluster.session(2)
    s2.keyspace = "ks"
    assert s2.execute("SELECT v FROM kv WHERE k = 1").rows == [("hello",)]
    cluster.node(1).default_cl = ConsistencyLevel.ONE
    cluster.node(2).default_cl = ConsistencyLevel.ONE
    s1.execute("INSERT INTO kv (k, v) VALUES (2, 'again')")
    assert _poll(lambda: s2.execute(
        "SELECT v FROM kv WHERE k = 2").rows == [("again",)])
    assert s2.execute("SELECT v FROM kv WHERE k = 1").rows == [("hello",)]


def test_replicas_hold_data_locally(cluster):
    s = cluster.session(1)
    s.keyspace = "ks"
    cluster.node(1).default_cl = ConsistencyLevel.ALL
    for i in range(20):
        s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'v{i}')")
    # RF=3 on 3 nodes: every node holds every row locally
    t = cluster.schema.get_table("ks", "kv")
    pk = t.columns["k"].cql_type.serialize(7)
    for n in cluster.nodes:
        batch = n.engine.store("ks", "kv").read_partition(pk)
        assert len(batch) > 0, n.endpoint


def test_quorum_survives_one_dropped_replica(cluster):
    s = cluster.session(1)
    s.keyspace = "ks"
    cluster.node(1).default_cl = ConsistencyLevel.QUORUM
    victim = cluster.nodes[2].endpoint
    cluster.filters.drop(verb=Verb.MUTATION_REQ, to=victim)
    s.execute("INSERT INTO kv (k, v) VALUES (5, 'q')")   # 2/3 acks: ok
    assert s.execute("SELECT v FROM kv WHERE k = 5").rows == [("q",)]
    cluster.filters.clear()


def test_all_fails_when_replica_dropped(cluster):
    s = cluster.session(1)
    s.keyspace = "ks"
    cluster.node(1).default_cl = ConsistencyLevel.ALL
    cluster.filters.drop(verb=Verb.MUTATION_REQ,
                         to=cluster.nodes[2].endpoint)
    with pytest.raises(TimeoutException):
        s.execute("INSERT INTO kv (k, v) VALUES (6, 'x')")
    cluster.filters.clear()


def test_unavailable_when_nodes_down(cluster):
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.QUORUM
    # mark both peers dead in n1's view
    for other in (cluster.nodes[1], cluster.nodes[2]):
        n1.gossiper.states[other.endpoint].alive = False
    s = cluster.session(1)
    s.keyspace = "ks"
    with pytest.raises(UnavailableException):
        s.execute("INSERT INTO kv (k, v) VALUES (7, 'x')")
    for other in (cluster.nodes[1], cluster.nodes[2]):
        n1.gossiper.states[other.endpoint].alive = True


def test_hints_stored_and_replayed(cluster):
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ONE
    victim = cluster.nodes[2]
    # victim is seen dead -> writes hint instead of sending. Gossip
    # keeps running in this fixture, so mute it first: without the
    # drops an in-flight SYN/ACK about the victim can re-mark it alive
    # between the flag flip and the write (a real flake under full-run
    # load).
    cluster.filters.drop(verb=Verb.GOSSIP_SYN)
    cluster.filters.drop(verb=Verb.GOSSIP_ACK)
    n1.gossiper.states[victim.endpoint].alive = False
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("INSERT INTO kv (k, v) VALUES (9, 'hinted')")
    cluster.filters.clear()
    assert n1.hints.has_hints(victim.endpoint)
    # victim had no copy
    t = cluster.schema.get_table("ks", "kv")
    pk = t.columns["k"].cql_type.serialize(9)
    assert len(victim.engine.store("ks", "kv").read_partition(pk)) == 0
    # recovery: replay hints
    n1.gossiper.states[victim.endpoint].alive = True
    n1._on_peer_alive(victim.endpoint)
    deadline = time.time() + 3
    while time.time() < deadline:
        if len(victim.engine.store("ks", "kv").read_partition(pk)) > 0:
            break
        time.sleep(0.05)
    assert len(victim.engine.store("ks", "kv").read_partition(pk)) > 0
    assert not n1.hints.has_hints(victim.endpoint)


def test_read_repair(cluster):
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.QUORUM
    victim = cluster.nodes[2]
    cluster.filters.drop(verb=Verb.MUTATION_REQ, to=victim.endpoint)
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("INSERT INTO kv (k, v) VALUES (11, 'repair-me')")
    cluster.filters.clear()
    t = cluster.schema.get_table("ks", "kv")
    pk = t.columns["k"].cql_type.serialize(11)
    assert len(victim.engine.store("ks", "kv").read_partition(pk)) == 0
    # a CL=ALL read must detect the divergence and repair the victim
    n1.default_cl = ConsistencyLevel.ALL
    assert s.execute("SELECT v FROM kv WHERE k = 11").rows == [("repair-me",)]
    deadline = time.time() + 3
    while time.time() < deadline:
        if len(victim.engine.store("ks", "kv").read_partition(pk)) > 0:
            break
        time.sleep(0.05)
    assert len(victim.engine.store("ks", "kv").read_partition(pk)) > 0


def test_gossip_detects_death_and_recovery(tmp_path):
    c = LocalCluster(3, str(tmp_path), gossip_interval=0.05, device="cpu")
    try:
        # let a few rounds run
        time.sleep(0.5)
        n1 = c.node(1)
        assert all(n1.is_alive(n.endpoint) for n in c.nodes)
        c.stop_node(3)
        dead_ep = c.nodes[2].endpoint
        deadline = time.time() + 10
        while time.time() < deadline and n1.is_alive(dead_ep):
            time.sleep(0.1)
        assert not n1.is_alive(dead_ep), "phi detector never convicted"
    finally:
        c.shutdown()


def test_nts_placement():
    ring = Ring()
    toks = even_tokens(6, vnodes=1)
    for i in range(6):
        dc = "dc1" if i < 3 else "dc2"
        ring.add_node(Endpoint(f"n{i}", dc=dc, rack=f"r{i % 3}"), toks[i])
    strat = NetworkTopologyStrategy({"dc1": 2, "dc2": 2})
    reps = strat.replicas(ring, 0)
    assert len(reps) == 4
    assert sum(1 for r in reps if r.dc == "dc1") == 2
    assert sum(1 for r in reps if r.dc == "dc2") == 2


def test_scan_all_across_cluster(cluster):
    # write at ALL so every replica holds the rows before scanning: the
    # windowed range read serves each arc from blockFor replicas only
    # (real CL=ONE semantics), so ONE-written rows may lag replicas
    s1 = cluster.session(1)
    s1.keyspace = "ks"
    cluster.node(1).default_cl = ConsistencyLevel.ALL
    for i in range(30):
        s1.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'v{i}')")
    cluster.node(1).default_cl = ConsistencyLevel.ONE
    rows = cluster.session(2)
    rows.keyspace = "ks"
    got = rows.execute("SELECT count(*) FROM kv")
    assert got.rows == [(30,)]


def test_repair_reconciles_divergent_replicas(cluster):
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ONE
    victim = cluster.nodes[2]
    s = cluster.session(1)
    s.keyspace = "ks"
    # make node3 miss half the writes
    cluster.filters.drop(verb=Verb.MUTATION_REQ, to=victim.endpoint)
    for i in range(100, 110):
        s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'r{i}')")
    cluster.filters.clear()
    # stop background hint redelivery from masking the divergence: purge
    import glob, os
    for n in cluster.nodes:
        for f in glob.glob(os.path.join(n.hints.directory, "*")):
            os.remove(f)
    t = cluster.schema.get_table("ks", "kv")
    missing = [i for i in range(100, 110)
               if len(victim.engine.store("ks", "kv").read_partition(
                   t.columns["k"].cql_type.serialize(i))) == 0]
    assert missing, "test setup: victim should have missed writes"
    stats = n1.repair.repair_table("ks", "kv")
    assert stats["ranges_synced"] > 0
    import time as _t
    deadline = _t.time() + 5
    def still_missing():
        return [i for i in missing
                if len(victim.engine.store("ks", "kv").read_partition(
                    t.columns["k"].cql_type.serialize(i))) == 0]
    while _t.time() < deadline and still_missing():
        _t.sleep(0.1)
    assert still_missing() == []


def test_merkle_tree_difference():
    from cassandra_tpu_torch.utils.merkle import MerkleTree
    a, b = MerkleTree(8), MerkleTree(8)
    for t in range(-100, 100):
        tok = t * (1 << 55)
        a.add(tok, bytes([t & 0xFF]) * 16)
        b.add(tok, bytes([t & 0xFF]) * 16)
    b.add(42 * (1 << 55), b"\xff" * 16)  # diverge one leaf
    diffs = a.difference(b)
    assert len(diffs) == 1
    lo, hi = diffs[0]
    assert lo <= 42 * (1 << 55) <= hi
    assert a.difference(a) == []


def test_lwt_paxos_basic(cluster):
    s1 = cluster.session(1)
    s1.keyspace = "ks"
    rs = s1.execute("INSERT INTO kv (k, v) VALUES (50, 'first') "
                    "IF NOT EXISTS")
    assert rs.rows[0][0] is True
    # from ANOTHER node: must see the committed value and refuse
    s2 = cluster.session(2)
    s2.keyspace = "ks"
    rs = s2.execute("INSERT INTO kv (k, v) VALUES (50, 'second') "
                    "IF NOT EXISTS")
    assert rs.rows[0][0] is False
    assert "first" in rs.rows[0]  # prior row returned
    rs = s2.execute("UPDATE kv SET v = 'updated' WHERE k = 50 "
                    "IF v = 'first'")
    assert rs.rows[0][0] is True
    # the commit round acks at QUORUM (2/3): a CL.ONE read may hit the
    # straggler replica for a few ms — poll, don't race it
    deadline = time.time() + 10
    rows = None
    while time.time() < deadline:
        rows = s1.execute("SELECT v FROM kv WHERE k = 50").rows
        if rows == [("updated",)]:
            break
        time.sleep(0.05)
    assert rows == [("updated",)]
    rs = s1.execute("UPDATE kv SET v = 'nope' WHERE k = 50 IF v = 'wrong'")
    assert rs.rows[0][0] is False


def test_lwt_paxos_contention(cluster):
    import threading
    results = []
    lock = threading.Lock()

    def contend(i):
        s = cluster.session((i % 3) + 1)
        s.keyspace = "ks"
        try:
            rs = s.execute(
                f"INSERT INTO kv (k, v) VALUES (60, 'w{i}') IF NOT EXISTS")
            with lock:
                results.append(bool(rs.rows[0][0]))
        except Exception:
            with lock:
                results.append(None)   # contention timeout acceptable

    threads = [threading.Thread(target=contend, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    wins = sum(1 for r in results if r is True)
    # at most one winner (a proposer whose in-flight round was finished by
    # a helper may report not-applied even though its value committed —
    # the reference has the same false-negative anomaly, CASSANDRA-12126)
    assert wins <= 1, results
    s = cluster.session(1)
    s.keyspace = "ks"
    rows = s.execute("SELECT v FROM kv WHERE k = 60").rows
    assert len(rows) == 1 and rows[0][0].startswith("w")


def test_logged_batch_atomic_replay(tmp_path):
    # batchlog: a crash after store but before apply replays at boot
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.storage.mutation import Mutation
    d = str(tmp_path / "bl")
    eng = StorageEngine(d, Schema(), commitlog_sync="batch", device="cpu")
    s = Session(eng)
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE ks")
    s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
    t = eng.schema.get_table("ks", "kv")
    # simulate: batch persisted, crash before apply
    m1 = Mutation(t.id, t.columns["k"].cql_type.serialize(1))
    m1.add(b"", t.columns["v"].column_id, b"",
           t.columns["v"].cql_type.serialize("a"), 100)
    m2 = Mutation(t.id, t.columns["k"].cql_type.serialize(2))
    m2.add(b"", t.columns["v"].column_id, b"",
           t.columns["v"].cql_type.serialize("b"), 100)
    eng.batchlog.store([m1, m2])
    eng.close()
    eng2 = StorageEngine(d, Schema(), commitlog_sync="batch", device="cpu")
    s2 = Session(eng2)
    s2.keyspace = "ks"
    assert len(s2.execute("SELECT * FROM kv").rows) == 2
    assert list(eng2.batchlog.pending()) == []
    eng2.close()


def test_logged_batch_through_cql(cluster):
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("""BEGIN BATCH
        INSERT INTO kv (k, v) VALUES (70, 'a');
        INSERT INTO kv (k, v) VALUES (71, 'b');
        APPLY BATCH""")
    assert len(s.execute("SELECT v FROM kv WHERE k IN (70, 71)").rows) == 2


def test_bootstrap_new_node(cluster):
    s = cluster.session(1)
    s.keyspace = "ks"
    cluster.node(1).default_cl = ConsistencyLevel.ALL
    for i in range(200, 260):
        s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'b{i}')")
    n4 = cluster.add_node()
    n4.proxy.timeout = 1.0
    # new node owns some ranges; its local store must hold the data for
    # partitions it now replicates (RF=3 over 4 nodes: NOT everything)
    t = cluster.schema.get_table("ks", "kv")
    from cassandra_tpu_torch.cluster.replication import ReplicationStrategy
    strat = ReplicationStrategy.create(
        cluster.schema.keyspaces["ks"].params.replication)
    owned = missing = 0
    for i in range(200, 260):
        pk = t.columns["k"].cql_type.serialize(i)
        tok = cluster.ring.token_of(pk)
        if n4.endpoint in strat.replicas(cluster.ring, tok):
            owned += 1
            if len(n4.engine.store("ks", "kv").read_partition(pk)) == 0:
                missing += 1
    assert owned > 0, "new node owns nothing — token assignment broken"
    assert missing == 0, f"{missing}/{owned} owned partitions not streamed"
    # reads through the new node see everything
    s4 = n4.session()
    s4.keyspace = "ks"
    assert len(s4.execute(
        "SELECT k FROM kv WHERE k IN (200, 210, 259)").rows) == 3


def test_decommission_preserves_data(tmp_path):
    c = LocalCluster(3, str(tmp_path), gossip_interval=0.05, device="cpu")
    try:
        for n in c.nodes:
            n.proxy.timeout = 1.0
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 2}")
        s.execute("USE ks")
        s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
        c.node(1).default_cl = ConsistencyLevel.ALL
        for i in range(40):
            s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'd{i}')")
        c.nodes[2].decommission()
        import time as _t
        _t.sleep(0.5)   # one-way pushes drain
        s1 = c.session(1)
        s1.keyspace = "ks"
        assert len(s1.execute("SELECT k FROM kv").rows) == 40
    finally:
        c.shutdown()


def test_quorum_unavailable_on_undersized_ring(tmp_path):
    """blockFor comes from the CONFIGURED RF: QUORUM at RF=3 on a 1-node
    ring must refuse (blockFor=2), not silently accept with 1 replica
    (db/ConsistencyLevel.java blockFor)."""
    c = LocalCluster(1, str(tmp_path), rf=3, device="cpu")
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE uks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        s.execute("USE uks")
        s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
        c.node(1).default_cl = ConsistencyLevel.QUORUM
        with pytest.raises(UnavailableException):
            s.execute("INSERT INTO kv (k, v) VALUES (1, 'x')")
        c.node(1).default_cl = ConsistencyLevel.ONE
        s.execute("INSERT INTO kv (k, v) VALUES (1, 'x')")
        c.node(1).default_cl = ConsistencyLevel.QUORUM
        with pytest.raises(UnavailableException):
            s.execute("SELECT v FROM kv WHERE k = 1")
    finally:
        c.shutdown()


def test_range_delete_replicates(cluster):
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("CREATE TABLE rd (k int, c int, v text, PRIMARY KEY (k, c))")
    cluster.node(1).default_cl = ConsistencyLevel.ALL
    for c in range(6):
        s.execute(f"INSERT INTO rd (k, c, v) VALUES (1, {c}, 'x')")
    s.execute("DELETE FROM rd WHERE k = 1 AND c >= 3")
    # every replica applied the range; read from another coordinator
    s2 = cluster.session(2)
    s2.keyspace = "ks"
    got = sorted(r[0] for r in s2.execute("SELECT c FROM rd WHERE k = 1"))
    assert got == [0, 1, 2]


def test_paxos_state_survives_replica_restart(cluster):
    """A restarted replica must still know its promises and in-flight
    accepted values (system.paxos persistence): a prepare after the
    restart sees the accepted proposal and finishes it, and stale
    ballots stay rejected (service/paxos/PaxosState.java)."""
    from cassandra_tpu_torch.cluster.paxos import Ballot, PaxosService
    from cassandra_tpu_torch.cluster.messaging import Message
    from cassandra_tpu_torch.storage.mutation import Mutation

    n2 = cluster.node(2)
    t = cluster.schema.get_table("ks", "kv")
    pk = t.columns["k"].cql_type.serialize(77)
    m = Mutation(t.id, pk)
    m.add(b"", 8, b"", t.columns["v"].cql_type.serialize("inflight"),
          1000, 0x7FFFFFFF, 0, 0)
    ballot = Ballot(500, "node1")

    def call(verb, payload):
        handler = {"PAXOS_PREPARE": n2.paxos._handle_prepare,
                   "PAXOS_PROPOSE": n2.paxos._handle_propose}[verb]
        return handler(Message(verb, payload, n2.endpoint, n2.endpoint))[1]

    assert call("PAXOS_PREPARE", (t.id, pk, ballot.pack()))["promised"]
    assert call("PAXOS_PROPOSE",
                (t.id, pk, ballot.pack(), m.serialize()))["accepted"]

    # crash-restart the replica's paxos service (state only on disk now)
    n2.paxos = PaxosService(n2)

    # a stale ballot must still be rejected after restart
    stale = call("PAXOS_PREPARE", (t.id, pk, Ballot(400, "nodeX").pack()))
    assert not stale["promised"]
    # a newer prepare must SURFACE the in-flight accepted value
    rsp = call("PAXOS_PREPARE", (t.id, pk, Ballot(600, "node3").pack()))
    assert rsp["promised"]
    assert Ballot.unpack(rsp["accepted_ballot"]) == ballot
    assert rsp["accepted_value"] == m.serialize()


def test_lwt_completes_across_replica_restarts(cluster):
    """End-to-end: an IF NOT EXISTS decided before a replica restart must
    keep excluding later contenders afterwards."""
    from cassandra_tpu_torch.cluster.paxos import PaxosService
    s = cluster.session(1)
    s.keyspace = "ks"
    rs = s.execute("INSERT INTO kv (k, v) VALUES (88, 'first') "
                   "IF NOT EXISTS")
    assert rs.rows[0][0] is True
    for i in (1, 2):
        n = cluster.node(i + 1)
        n.paxos = PaxosService(n)     # restart 2 of 3 replicas
    rs = s.execute("INSERT INTO kv (k, v) VALUES (88, 'second') "
                   "IF NOT EXISTS")
    assert rs.rows[0][0] is False
    assert s.execute("SELECT v FROM kv WHERE k = 88").rows == [("first",)]


def test_pending_range_writes_during_bootstrap(tmp_path):
    """Writes landing while a node bootstraps must reach it for the
    ranges it is acquiring: at RF=1 ownership MOVES, so a write that only
    hit the old owner and never streamed would vanish at the flip
    (locator/ReplicaPlans pending replicas)."""
    c = LocalCluster(2, str(tmp_path), rf=1, gossip_interval=0.05,
                     device="cpu")
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 1}")
        s.execute("USE ks")
        s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
        for i in range(30):
            s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'pre{i}')")

        def mid_join():
            # the stream has completed; these writes arrive before the
            # ownership flip and must be duplicated to the pending node
            for i in range(30, 60):
                s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'mid{i}')")

        c.add_node(mid_join_hook=mid_join)
        # every row readable after the join, from any coordinator
        s3 = c.session(3)
        s3.keyspace = "ks"
        got = {r[0]: r[1] for r in s3.execute("SELECT k, v FROM kv").rows}
        assert set(got) == set(range(60)), \
            sorted(set(range(60)) - set(got))
        assert all(got[i] == f"pre{i}" for i in range(30))
        assert all(got[i] == f"mid{i}" for i in range(30, 60))
        # specifically: rows now owned by the NEW node exist locally there
        new = c.nodes[2]
        t = c.schema.get_table("ks", "kv")
        from cassandra_tpu_torch.cluster.replication import ReplicationStrategy
        strat = ReplicationStrategy.create(
            c.schema.keyspaces["ks"].params.replication)
        owned_locally = 0
        for i in range(60):
            pk = t.columns["k"].cql_type.serialize(i)
            if strat.replicas(c.ring, c.ring.token_of(pk))[0] \
                    == new.endpoint:
                batch = new.engine.store("ks", "kv").read_partition(pk)
                assert len(batch) > 0, f"row {i} missing on joined node"
                owned_locally += 1
        assert owned_locally > 0   # the new node really owns some rows
    finally:
        c.shutdown()


def test_speculative_retry_rescues_slow_replica(cluster):
    """A digest replica that never answers must not stall the read until
    the full timeout: after the speculative delay a redundant request to
    a spare replica completes the quorum
    (service/reads/AbstractReadExecutor speculate)."""
    from cassandra_tpu_torch.service.metrics import GLOBAL
    s = cluster.session(1)
    s.keyspace = "ks"
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ALL
    s.execute("INSERT INTO kv (k, v) VALUES (70, 'spec')")
    n1.default_cl = ConsistencyLevel.QUORUM
    # deterministic target choice: node2 looks fastest -> digest target;
    # node3 becomes the spare
    ep2, ep3 = cluster.nodes[1].endpoint, cluster.nodes[2].endpoint
    n1.proxy._latency = {ep2: 0.001, ep3: 0.5}
    cluster.filters.drop(verb=Verb.READ_REQ, to=ep2)
    n1.proxy.timeout = 5.0
    before = GLOBAL.counter("reads.speculative_retries")
    before_won = GLOBAL.counter("reads.speculative_retries_won")
    import time
    t0 = time.time()
    assert s.execute("SELECT v FROM kv WHERE k = 70").rows == [("spec",)]
    assert time.time() - t0 < 2.0, "speculation should beat the timeout"
    assert GLOBAL.counter("reads.speculative_retries") > before
    # the dropped digest never answers, so the spare's response is what
    # completed the round: the retry FIRED and WON
    assert GLOBAL.counter("reads.speculative_retries_won") > before_won
    cluster.filters.clear()


# ------------------------------------------------------ counter leader --

def test_counter_leader_shards(cluster):
    """Increments route through a leader replica and land as CUMULATIVE
    per-leader shard cells: every coordinator reads the same total
    (sum of shards), and replaying a shard mutation — the hint/retry
    case that double-counts naive deltas — changes nothing."""
    s1, s2 = cluster.session(1), cluster.session(2)
    for s in (s1, s2):
        s.keyspace = "ks"
    for n in cluster.nodes:      # leader waits full replication; reads
        n.default_cl = ConsistencyLevel.ALL   # then see every shard
    s1.execute("CREATE TABLE cnt (k int PRIMARY KEY, hits counter)")
    for _ in range(4):
        s1.execute("UPDATE cnt SET hits = hits + 3 WHERE k = 1")
    for _ in range(3):
        s2.execute("UPDATE cnt SET hits = hits - 2 WHERE k = 1")
    for s in (s1, s2):
        assert s.execute("SELECT hits FROM cnt WHERE k = 1").rows \
            == [(6,)]

    # shards are idempotent state: re-apply node1's current shard cell
    # verbatim (what a duplicated hint or a retried replication does)
    from cassandra_tpu_torch.cluster.counters import CounterService
    from cassandra_tpu_torch.storage.mutation import Mutation
    t = cluster.schema.get_table("ks", "cnt")
    pk = t.columns["k"].cql_type.serialize(1)
    col = t.columns["hits"].column_id
    n1 = cluster.node(1)
    batch = n1.engine.store("ks", "cnt").read_partition(pk)
    shard = n1.endpoint.name.encode()
    total, ts = CounterService._own_shard(batch, b"", col, shard)
    assert ts > 0       # node1 coordinated increments -> owns a shard
    replay = Mutation(t.id, pk)
    replay.add(b"", col, shard,
               total.to_bytes(8, "big", signed=True), ts)
    for n in cluster.nodes:
        n.engine.apply(replay)          # duplicated delivery
        n.engine.apply(replay)
    assert s2.execute("SELECT hits FROM cnt WHERE k = 1").rows == [(6,)]

    # flush + survive compaction: shards are plain LWW cells
    for n in cluster.nodes:
        n.engine.store("ks", "cnt").flush()
    assert s1.execute("SELECT hits FROM cnt WHERE k = 1").rows == [(6,)]


def test_counter_hinted_shard_converges(cluster):
    """A replica that missed shard replication converges through hints
    WITHOUT double counting — the hinted payload is cumulative shard
    state, not a delta."""
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ONE
    victim = cluster.nodes[2]
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("CREATE TABLE cnt2 (k int PRIMARY KEY, hits counter)")
    t = cluster.schema.get_table("ks", "cnt2")
    pk = t.columns["k"].cql_type.serialize(7)
    time.sleep(0.1)     # table reaches all stores
    # forced_down, not just alive=False: the victim IS gossiping, and a
    # heartbeat landing mid-test would resurrect a bare alive flip
    # (observed as flaky hint loss); only operator-asserted death
    # survives version churn
    n1.gossiper.states[victim.endpoint].alive = False
    n1.gossiper.states[victim.endpoint].forced_down = True
    for _ in range(5):
        s.execute("UPDATE cnt2 SET hits = hits + 2 WHERE k = 7")
    assert n1.hints.has_hints(victim.endpoint)
    assert len(victim.engine.store("ks", "cnt2").read_partition(pk)) == 0
    n1.gossiper.states[victim.endpoint].forced_down = False
    n1.gossiper.states[victim.endpoint].alive = True
    n1._on_peer_alive(victim.endpoint)
    # victim's LOCAL view alone converges to the full total: 5 hinted
    # cumulative shard mutations collapse to one shard worth +10 (a
    # delta scheme would replay to +30)
    from cassandra_tpu_torch.storage.rows import row_to_dict, rows_from_batch
    store = victim.engine.store("ks", "cnt2")
    deadline = time.time() + 15
    got = None
    while time.time() < deadline:
        rows = list(rows_from_batch(t, store.read_partition(pk)))
        got = row_to_dict(t, rows[0])["hits"] if rows else None
        if got == 10 and not n1.hints.has_hints(victim.endpoint):
            break
        time.sleep(0.1)
    assert got == 10
    assert not n1.hints.has_hints(victim.endpoint)


def test_counter_cache_and_truncate(cluster):
    """The leader's counter cache makes repeat increments skip the
    partition read but must never survive TRUNCATE."""
    s = cluster.session(1)
    s.keyspace = "ks"
    for n in cluster.nodes:
        n.default_cl = ConsistencyLevel.ALL
    s.execute("CREATE TABLE cc (k int PRIMARY KEY, hits counter)")
    for _ in range(10):
        s.execute("UPDATE cc SET hits = hits + 1 WHERE k = 3")
    assert s.execute("SELECT hits FROM cc WHERE k = 3").rows == [(10,)]
    n1 = cluster.node(1)
    assert len(n1.counters._cache) > 0        # warmed
    s.execute("TRUNCATE cc")
    assert len(n1.counters._cache) == 0       # invalidated
    s.execute("UPDATE cc SET hits = hits + 5 WHERE k = 3")
    assert s.execute("SELECT hits FROM cc WHERE k = 3").rows == [(5,)]


def test_entire_sstable_streaming(cluster):
    """A whole in-range sstable ships as verbatim component files
    (CassandraEntireSSTableStreamWriter role): the receiver's Data.db
    bytes are identical to the source's, and straddling sstables fall
    back to batch re-serialization."""
    import os

    s = cluster.session(1)
    s.keyspace = "ks"
    cluster.node(1).default_cl = ConsistencyLevel.ALL
    for i in range(300, 340):
        s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 's{i}')")
    n1 = cluster.node(1)
    src_cfs = n1.engine.store("ks", "kv")
    src_cfs.flush()
    src = src_cfs.live_sstables()[0]
    toks = src.partition_tokens
    lo, hi = int(toks[0]) - 1, int(toks[-1])

    n2 = cluster.node(2)
    files, leftover = n2.streams.fetch_range(
        n1.endpoint, "ks", "kv", lo, hi, 5.0)
    assert files, "whole in-range sstable should ship as files"
    comps = files[0]
    from cassandra_tpu_torch.storage.sstable.format import Component
    assert Component.DATA in comps and Component.TOC in comps
    with open(os.path.join(
            src_cfs.directory,
            f"{src.desc.version}-{src.desc.generation}-"
            f"{Component.DATA}"), "rb") as f:
        assert comps[Component.DATA] == f.read()   # verbatim bytes

    # landing under a fresh generation serves reads
    dst_cfs = n2.engine.store("ks", "kv")
    before = len(dst_cfs.live_sstables())
    n2.streams.land_sstable(dst_cfs, comps)
    dst_cfs.reload_sstables()
    assert len(dst_cfs.live_sstables()) == before + 1

    # a narrower range makes the same sstable PARTIAL: batch fallback
    files2, leftover2 = n2.streams.fetch_range(
        n1.endpoint, "ks", "kv", lo, int(toks[len(toks) // 2]), 5.0)
    assert files2 == []
    assert 0 < len(leftover2) < src.n_cells


def test_paxos_log_compact_preserves_concurrent_append(tmp_path):
    """A promise fsynced while compaction is rewriting the log must
    survive the os.replace — otherwise a crash replays pre-promise state
    and the replica can re-promise a lower ballot (round-2 advisor
    finding on PaxosLog.compact)."""
    import threading
    import uuid

    from cassandra_tpu_torch.cluster.paxos import Ballot, PaxosLog, PaxosState

    log = PaxosLog(str(tmp_path))
    tid = uuid.uuid4()
    st = PaxosState()
    st.promised = Ballot(5, "a")
    log.append(tid, b"k1", PaxosLog.K_PROMISE, Ballot(5, "a"), None)

    ready, proceed = threading.Event(), threading.Event()

    class Gate(dict):
        # compact() iterates items() after arming its pending buffer;
        # block there so the test can interleave an append
        def items(self):
            ready.set()
            proceed.wait(5)
            return super().items()

    t = threading.Thread(target=log.compact,
                         args=(Gate({(tid, b"k1"): st}),))
    t.start()
    assert ready.wait(5)
    log.append(tid, b"k2", PaxosLog.K_PROMISE, Ballot(9, "b"), None)
    proceed.set()
    t.join(5)
    assert not t.is_alive()

    recs = list(PaxosLog(str(tmp_path)).replay())
    by_pk = {pk: ballot for _, pk, _, ballot, _ in recs}
    assert by_pk.get(b"k1") == Ballot(5, "a")
    assert by_pk.get(b"k2") == Ballot(9, "b"), \
        "append during compaction was erased from the durable log"


def test_counter_leader_failure_classified_by_kind(cluster):
    """The origin classifies a remote counter-leader failure by the
    structured exception kind in FAILURE_RSP: a real Unavailable
    surfaces as Unavailable, while an unrelated error whose TEXT merely
    contains 'Unavailable' stays a maybe-applied timeout."""
    s = cluster.session(1)
    s.execute("CREATE KEYSPACE ks2 WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 2}")
    s.keyspace = "ks2"
    s.execute("CREATE TABLE cnt_err (k int PRIMARY KEY, hits counter)")
    time.sleep(0.1)
    n1 = cluster.node(1)
    t = cluster.schema.get_table("ks2", "cnt_err")
    key = None
    for k in range(200):
        pk = t.columns["k"].cql_type.serialize(k)
        reps, _, _ = n1.proxy._plan("ks2", pk)
        if n1.endpoint not in reps:
            key, leader_ep = k, reps[0]
            break
    assert key is not None, "no pk found with node1 as non-replica"
    leader = next(n for n in cluster.nodes if n.endpoint == leader_ep)

    def raise_unavailable(*a, **kw):
        raise UnavailableException("replication needs 2, 1 alive")

    orig = leader.counters.apply_as_leader
    leader.counters.apply_as_leader = raise_unavailable
    try:
        with pytest.raises(UnavailableException):
            s.execute(
                f"UPDATE cnt_err SET hits = hits + 1 WHERE k = {key}")

        def raise_other(*a, **kw):
            raise ValueError("text mentioning Unavailable is not a kind")

        leader.counters.apply_as_leader = raise_other
        with pytest.raises(TimeoutException):
            s.execute(
                f"UPDATE cnt_err SET hits = hits + 1 WHERE k = {key}")
    finally:
        leader.counters.apply_as_leader = orig


def test_range_read_repair_converges_replicas(tmp_path):
    """Range reads repair divergent replicas like single-partition
    reads do (DataResolver over RangeCommands): after a QUORUM scan,
    the replica that missed writes holds them locally."""
    import time

    from cassandra_tpu_torch.cluster.messaging import Verb
    from cassandra_tpu_torch.cluster.node import LocalCluster
    from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
    c = LocalCluster(2, str(tmp_path), rf=2, device="cpu")
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 2}")
        s.execute("USE ks")
        s.execute("CREATE TABLE rr (k int, c int, v text, "
                  "PRIMARY KEY (k, c))")
        n1 = c.node(1)
        n1.default_cl = ConsistencyLevel.ALL
        for k in range(10):
            s.execute(f"INSERT INTO rr (k, c, v) VALUES ({k}, 1, 'a')")
        # node2 misses a batch of updates
        rule = c.filters.drop(verb=Verb.MUTATION_REQ,
                              to=c.nodes[1].endpoint)
        n1.default_cl = ConsistencyLevel.ONE
        for k in range(5):
            s.execute(f"UPDATE rr SET v = 'NEW' WHERE k = {k} AND c = 1")
        rule["remaining"] = 0
        # QUORUM range scan sees the truth AND repairs node2
        n1.default_cl = ConsistencyLevel.QUORUM
        rows = dict((r[0], r[1]) for r in
                    s.execute("SELECT k, v FROM rr").rows)
        assert all(rows[k] == "NEW" for k in range(5))
        # give the one-way repairs a beat to apply, then check node2's
        # LOCAL data alone
        deadline = time.time() + 10
        ok = False
        while time.time() < deadline:
            local = c.node(2).engine.store("ks", "rr").scan_all()
            from cassandra_tpu_torch.storage.rows import rows_from_batch
            t = c.nodes[1].schema.get_table("ks", "rr")
            vals = {}
            for r in rows_from_batch(t, local):
                from cassandra_tpu_torch.storage.rows import row_to_dict
                d = row_to_dict(t, r)
                vals[d["k"]] = d["v"]
            if all(vals.get(k) == "NEW" for k in range(5)):
                ok = True
                break
            time.sleep(0.1)
        assert ok, vals
    finally:
        c.shutdown()


def test_conditional_batch_single_partition(tmp_path):
    """LWT batches (BatchStatement.executeWithConditions): conditions
    over multiple rows of ONE partition decide atomically through the
    partition's Paxos instance; cross-partition conditional batches are
    refused."""
    from cassandra_tpu_torch.cluster.node import LocalCluster
    from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
    c = LocalCluster(3, str(tmp_path), rf=3, device="cpu")
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        s.execute("USE ks")
        s.execute("CREATE TABLE acct (owner text, name text, bal int, "
                  "PRIMARY KEY (owner, name))")
        c.node(1).default_cl = ConsistencyLevel.QUORUM
        s.execute("INSERT INTO acct (owner, name, bal) VALUES "
                  "('alice', 'checking', 100)")
        s.execute("INSERT INTO acct (owner, name, bal) VALUES "
                  "('alice', 'savings', 50)")
        # transfer iff the source still holds the expected balance
        rs = s.execute(
            "BEGIN BATCH "
            "UPDATE acct SET bal = 70 WHERE owner = 'alice' AND "
            "name = 'checking' IF bal = 100; "
            "UPDATE acct SET bal = 80 WHERE owner = 'alice' AND "
            "name = 'savings'; "
            "APPLY BATCH")
        assert rs.rows[0][0] is True
        got = dict(s.execute("SELECT name, bal FROM acct "
                             "WHERE owner = 'alice'").rows)
        assert got == {"checking": 70, "savings": 80}
        # failed condition: NOTHING applies
        rs = s.execute(
            "BEGIN BATCH "
            "UPDATE acct SET bal = 0 WHERE owner = 'alice' AND "
            "name = 'checking' IF bal = 999; "
            "UPDATE acct SET bal = 0 WHERE owner = 'alice' AND "
            "name = 'savings'; "
            "APPLY BATCH")
        assert rs.rows[0][0] is False
        got = dict(s.execute("SELECT name, bal FROM acct "
                             "WHERE owner = 'alice'").rows)
        assert got == {"checking": 70, "savings": 80}
        # IF NOT EXISTS in a batch
        rs = s.execute(
            "BEGIN BATCH "
            "INSERT INTO acct (owner, name, bal) VALUES "
            "('alice', 'broker', 5) IF NOT EXISTS; "
            "APPLY BATCH")
        assert rs.rows[0][0] is True
        rs = s.execute(
            "BEGIN BATCH "
            "INSERT INTO acct (owner, name, bal) VALUES "
            "('alice', 'broker', 9) IF NOT EXISTS; "
            "APPLY BATCH")
        assert rs.rows[0][0] is False
        # cross-partition refusal
        import pytest as _pytest
        with _pytest.raises(Exception, match="single partition"):
            s.execute(
                "BEGIN BATCH "
                "UPDATE acct SET bal = 1 WHERE owner = 'alice' AND "
                "name = 'checking' IF bal = 70; "
                "UPDATE acct SET bal = 1 WHERE owner = 'bob' AND "
                "name = 'checking'; "
                "APPLY BATCH")
    finally:
        c.shutdown()


def test_conditional_batch_json_and_shared_ast(tmp_path):
    """Regression pair: INSERT...JSON works inside conditional batches
    (key columns come from the document), and repeated execution of the
    SAME parsed batch keeps its conditions (no shared-AST stripping)."""
    from cassandra_tpu_torch.cluster.node import LocalCluster
    c = LocalCluster(1, str(tmp_path), rf=1, device="cpu")
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 1}")
        s.execute("USE ks")
        s.execute("CREATE TABLE j (k int, c int, v int, "
                  "PRIMARY KEY (k, c))")
        q = ("BEGIN BATCH "
             "INSERT INTO j JSON '{\"k\": 1, \"c\": 2, \"v\": 9}' "
             "IF NOT EXISTS; APPLY BATCH")
        assert s.execute(q).rows[0][0] is True
        # second run of the same statement text (same prepared-cache
        # entry underneath): the IF must still be there and fail
        assert s.execute(q).rows[0][0] is False
        assert s.execute("SELECT v FROM j WHERE k = 1 AND c = 2"
                         ).rows == [(9,)]
        # unconditional partition delete rides in a conditional batch
        rs = s.execute(
            "BEGIN BATCH "
            "UPDATE j SET v = 10 WHERE k = 1 AND c = 2 IF v = 9; "
            "DELETE FROM j WHERE k = 1; "
            "APPLY BATCH")
        assert rs.rows[0][0] is True
    finally:
        c.shutdown()


def test_dispatch_worker_death_blast_radius(cluster):
    """Worker-death blast radius for the verb-dispatch pool: a handler
    escalating past Exception kills exactly one pool worker — the
    death is counted, the worker replaced (the pool never shrinks
    behind the operator's back), only that message is lost, and the
    node keeps serving replica traffic. A merely-raising handler costs
    its message (process_failures) and nothing else."""
    import threading

    s = cluster.session(1)
    s.keyspace = "ks"
    target = cluster.nodes[1]
    ms = target.messaging
    ms.set_dispatch_workers(2)
    # real replica load so the pool is live before the kill
    for i in range(10):
        s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'v{i}')")
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and ms.pool_width() < 2:
        time.sleep(0.01)
    assert ms.pool_width() == 2

    class _Kill(BaseException):
        pass

    ran = threading.Event()

    def boom(msg):
        ran.set()
        raise _Kill()

    ms.register_handler("TEST_BOOM", boom)
    deaths0 = ms.metrics["dispatch_worker_deaths"]
    fails0 = ms.metrics["process_failures"]
    cluster.nodes[0].messaging.send_one_way("TEST_BOOM", {},
                                            target.endpoint)
    assert ran.wait(5.0)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and (
            ms.metrics["dispatch_worker_deaths"] == deaths0
            or ms.pool_width() < 2):
        time.sleep(0.01)
    assert ms.metrics["dispatch_worker_deaths"] == deaths0 + 1
    assert ms.metrics["process_failures"] == fails0 + 1
    assert ms.pool_width() == 2      # respawned, not silently narrower

    def soft(msg):
        raise RuntimeError("handler bug")

    ms.register_handler("TEST_SOFT", soft)
    failed = threading.Event()
    cluster.nodes[0].messaging.send_with_callback(
        "TEST_SOFT", {}, target.endpoint,
        on_response=lambda m: None, on_failure=lambda m: failed.set(),
        timeout=5.0)
    # a merely-raising handler becomes a FAILURE_RSP to the sender —
    # no worker dies, the pool stays at width
    assert failed.wait(5.0)
    assert ms.metrics["dispatch_worker_deaths"] == deaths0 + 1
    # the node still serves QUORUM traffic after the kill
    for i in range(10, 30):
        s.execute(f"INSERT INTO kv (k, v) VALUES ({i}, 'v{i}')")
    assert s.execute("SELECT v FROM kv WHERE k = 15").rows == [("v15",)]
