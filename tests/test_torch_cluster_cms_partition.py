"""The port's counterpart of tests/test_cms_partition.py: the same
assertions on cassandra_tpu_torch, every engine on the CPU (device="cpu").

CMS linearizability under partition: the minority side CANNOT commit
metadata (DDL or topology), the majority can, and healing produces ONE
log — no fork, no displaced client-acked entries.

Reference: tcm/PaxosBackedProcessor.java:57 (every metadata commit goes
through Paxos on the CMS replica set), tcm/Commit.java. The round-3
designated-coordinator scheme allowed both sides of a partition to
append the same epoch; this test pins the property that replaced it.

Rig: three in-process nodes with PER-NODE Schema/Ring/SchemaSync (the
noded deployment shape) over a LocalTransport, whose MessageFilters
implement the partition.
"""
import time

import pytest

from cassandra_tpu_torch.cluster.cms import MetadataUnavailable
from cassandra_tpu_torch.cluster.messaging import LocalTransport
from cassandra_tpu_torch.cluster.node import Node
from cassandra_tpu_torch.cluster.ring import Endpoint, Ring, even_tokens
from cassandra_tpu_torch.cluster.schema_sync import SchemaSync
from cassandra_tpu_torch.schema import Schema
from torch_tmp import tmp_path  # noqa: F401


def _mk_cluster(tmp_path, n=3):
    eps = [Endpoint(f"node{i + 1}", host="127.0.0.1", port=0)
           for i in range(n)]
    tokens = even_tokens(n, vnodes=4)
    transport = LocalTransport()
    nodes = []
    for ep in eps:
        ring = Ring()
        for e, toks in zip(eps, tokens):
            ring.add_node(e, toks)
        node = Node(ep, str(tmp_path / ep.name), Schema(), ring,
                    transport, seeds=[eps[0]], gossip_interval=0.05,
                    engine_opts={"device": "cpu"})
        node.cluster_nodes = [node]
        node.schema_sync = SchemaSync(node, str(tmp_path / ep.name))
        node.gossiper.start()
        nodes.append(node)
    return transport, eps, nodes


def _wait(cond, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _partition_node1(transport, eps):
    """Cut node1 off from node2+node3 in both directions."""
    transport.filters.drop(frm=eps[0])
    transport.filters.drop(to=eps[0])


def test_minority_cannot_commit_majority_can_no_fork(tmp_path):
    transport, eps, nodes = _mk_cluster(tmp_path)
    n1, n2, n3 = nodes
    try:
        _wait(lambda: all(n1.is_alive(e) for e in eps[1:])
              and n2.is_alive(eps[0]),
              msg="full liveness")
        # baseline entry committed cluster-wide
        s1 = n1.session()
        s1.execute("CREATE KEYSPACE ks WITH replication = "
                   "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        _wait(lambda: all(n.schema_sync.epoch >= 1 for n in nodes),
              msg="baseline epoch everywhere")

        _partition_node1(transport, eps)
        _wait(lambda: not n1.is_alive(eps[1])
              and not n1.is_alive(eps[2]),
              msg="node1 convicts the majority side")
        _wait(lambda: not n2.is_alive(eps[0]),
              msg="majority convicts node1")

        # ---- minority side: node1 (a CMS member, and the node the old
        # designated-coordinator scheme would have let commit!) must
        # FAIL, leaving no local residue
        with pytest.raises(MetadataUnavailable):
            s1.execute("CREATE TABLE ks.minority_t (k int PRIMARY KEY)")
        assert n1.schema_sync.epoch == 1
        with pytest.raises(KeyError):
            n1.schema.get_table("ks", "minority_t")
        # topology changes ride the same committed log: also refused
        with pytest.raises(MetadataUnavailable):
            n1.topology_commit({"op": "leave",
                                "node": {"name": "node3"}})

        # ---- majority side commits fine
        s2 = n2.session()
        s2.execute("CREATE TABLE ks.majority_t (k int PRIMARY KEY, "
                   "v text)")
        _wait(lambda: n2.schema_sync.epoch >= 2
              and n3.schema_sync.epoch >= 2,
              msg="majority epoch 2")
        t2 = n2.schema.get_table("ks", "majority_t")
        assert n3.schema.get_table("ks", "majority_t").id == t2.id
        # node1 (partitioned) knows nothing of it
        assert n1.schema_sync.epoch == 1

        # ---- heal: node1 catches up; ONE history, no fork
        transport.filters.clear()
        assert n1.schema_sync.pull_from_peers(timeout=5.0)
        _wait(lambda: n1.schema_sync.epoch >= 2, msg="node1 caught up")
        assert n1.schema.get_table("ks", "majority_t").id == t2.id
        logs = [n.schema_sync.entries_after(0) for n in nodes]
        assert logs[0] == logs[1] == logs[2]
        assert not any("minority_t" in rec[1] for rec in logs[0])

        # ---- and the healed node can commit again, on the SAME log
        _wait(lambda: n1.is_alive(eps[1]) and n1.is_alive(eps[2]),
              msg="liveness restored")
        s1.execute("CREATE TABLE ks.after_heal (k int PRIMARY KEY)")
        _wait(lambda: all(n.schema_sync.epoch >= 3 for n in nodes),
              msg="post-heal epoch everywhere")
        ids = {str(n.schema.get_table("ks", "after_heal").id)
               for n in nodes}
        assert len(ids) == 1
    finally:
        for n in nodes:
            n.shutdown()


def test_concurrent_commits_serialize_without_displacement(tmp_path):
    """Two CMS members committing concurrently: Paxos serializes them
    into DIFFERENT epochs; both statements survive (the round-3 scheme
    could displace one), and every node agrees on the order."""
    transport, eps, nodes = _mk_cluster(tmp_path)
    n1, n2, n3 = nodes
    try:
        _wait(lambda: all(n1.is_alive(e) for e in eps[1:])
              and all(n2.is_alive(e) for e in (eps[0], eps[2])),
              msg="full liveness")
        s1, s2 = n1.session(), n2.session()
        s1.execute("CREATE KEYSPACE ks WITH replication = "
                   "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        _wait(lambda: all(n.schema_sync.epoch >= 1 for n in nodes),
              msg="baseline epoch")

        import threading
        errs = []

        def ddl(sess, q):
            try:
                sess.execute(q)
            except Exception as e:       # surfaced below
                errs.append(e)

        t1 = threading.Thread(target=ddl, args=(
            s1, "CREATE TABLE ks.t_from_n1 (k int PRIMARY KEY)"))
        t2 = threading.Thread(target=ddl, args=(
            s2, "CREATE TABLE ks.t_from_n2 (k int PRIMARY KEY)"))
        t1.start()
        t2.start()
        # wait on the epochs themselves (or a failed commit), not on a
        # fixed join: a loaded host stretches the Paxos rounds
        _wait(lambda: errs or all(n.schema_sync.epoch >= 3
                                  for n in nodes),
              timeout=120.0, msg="both entries everywhere")
        assert not errs, errs
        for t in (t1, t2):
            _wait(lambda: not t.is_alive(), timeout=120.0,
                  msg="the committing threads")
        assert not errs, errs
        logs = [n.schema_sync.entries_after(1) for n in nodes]
        assert logs[0] == logs[1] == logs[2]
        queries = [rec[1] for rec in logs[0]]
        assert sorted(queries) == [
            "CREATE TABLE ks.t_from_n1 (k int PRIMARY KEY)",
            "CREATE TABLE ks.t_from_n2 (k int PRIMARY KEY)"]
        # each table exists everywhere with one id
        for name in ("t_from_n1", "t_from_n2"):
            ids = {str(n.schema.get_table("ks", name).id) for n in nodes}
            assert len(ids) == 1, (name, ids)
    finally:
        for n in nodes:
            n.shutdown()
