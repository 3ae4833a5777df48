"""The port's counterpart of tests/test_cms_reconfig.py: the same assertions on
cassandra_tpu_torch, every engine on the CPU (device="cpu").

CMS membership reconfiguration is log-derived and safe: DDL committed
DURING the join of a lexically-lowest-named node (which will displace a
sitting CMS member once joined) uses the OLD member set consistently on
every node, and the handover happens exactly at the committed
finish_join entry — the old set decides the slot that admits the
newcomer, so no two proposers of one slot can ever hold
non-intersecting quorums.

Reference: tcm/membership/ + tcm/ClusterMetadataService.java — CMS
membership is explicit logged state reconfigured through the log it
guards, never re-derived from a live view that can differ across nodes
mid-change.
"""
import time

from cassandra_tpu_torch.cluster.messaging import LocalTransport
from cassandra_tpu_torch.cluster.node import Node
from cassandra_tpu_torch.cluster.ring import Endpoint, Ring, even_tokens
from cassandra_tpu_torch.cluster.schema_sync import SchemaSync
from cassandra_tpu_torch.schema import Schema
from torch_tmp import tmp_path  # noqa: F401


def _wait(cond, timeout=15.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _mk_node(ep, tmp_path, eps_with_tokens, transport, seeds):
    ring = Ring()
    for e, toks in eps_with_tokens:
        ring.add_node(e, toks)
    node = Node(ep, str(tmp_path / ep.name), Schema(), ring,
                transport, seeds=seeds, gossip_interval=0.05,
                engine_opts={"device": "cpu"})
    node.cluster_nodes = [node]
    node.schema_sync = SchemaSync(node, str(tmp_path / ep.name))
    node.gossiper.start()
    return node


def test_ddl_during_join_of_lowest_named_node(tmp_path):
    # node2/3/4 form the cluster (CMS = all three); node1 — lexically
    # LOWEST, so it will claim a CMS seat the moment it joins — arrives
    # mid-test.
    eps = [Endpoint(f"node{i}", host="127.0.0.1", port=0)
           for i in (2, 3, 4)]
    new_ep = Endpoint("node1", host="127.0.0.1", port=0)
    tokens = even_tokens(4, vnodes=4)
    transport = LocalTransport()
    existing = list(zip(eps, tokens[:3]))
    nodes = [_mk_node(ep, tmp_path, existing, transport, [eps[0]])
             for ep in eps]
    n2, n3, n4 = nodes
    joiner = None
    try:
        _wait(lambda: all(n2.is_alive(e) for e in eps[1:])
              and all(n3.is_alive(e) for e in (eps[0], eps[2])),
              msg="full liveness")
        s2 = n2.session()
        s2.execute("CREATE KEYSPACE ks WITH replication = "
                   "{'class': 'SimpleStrategy', 'replication_factor': 3}")
        _wait(lambda: all(n.schema_sync.epoch >= 1 for n in nodes),
              msg="baseline epoch")

        # ---- the newcomer discovers the cluster and catches up on the
        # log (tcm/Discovery + FetchCMSLog role)
        joiner = _mk_node(new_ep, tmp_path, existing, transport, [eps[0]])
        assert joiner.schema_sync.pull_from_peers(timeout=5.0, peers=eps)
        assert joiner.schema_sync.epoch >= 1
        _wait(lambda: all(joiner.is_alive(e) for e in eps),
              msg="joiner sees cluster")

        # not joined yet: NOBODY counts it as a CMS member
        for n in nodes + [joiner]:
            assert [m.name for m in n.schema_sync.cms_members()] == \
                ["node2", "node3", "node4"]

        # ---- start_join: node1's tokens go PENDING. Pending nodes are
        # NOT CMS-eligible — membership may move only at finish_join.
        joiner.topology_commit({
            "op": "start_join",
            "node": {"name": new_ep.name, "dc": new_ep.dc,
                     "rack": new_ep.rack, "host": new_ep.host,
                     "port": new_ep.port},
            "tokens": [int(t) for t in tokens[3]]})
        _wait(lambda: all(new_ep in n.ring.pending
                          for n in nodes + [joiner]),
              msg="start_join everywhere")
        for n in nodes + [joiner]:
            assert [m.name for m in n.schema_sync.cms_members()] == \
                ["node2", "node3", "node4"], \
                "pending joiner must not claim a CMS seat"

        # ---- DDL DURING the join window commits on the OLD set, from
        # both a sitting member and the pending joiner (which forwards)
        s2.execute("CREATE TABLE ks.mid_join_a (k int PRIMARY KEY)")
        joiner.session().execute(
            "CREATE TABLE ks.mid_join_b (k int PRIMARY KEY)")
        _wait(lambda: all(n.schema_sync.epoch >= 4
                          for n in nodes + [joiner]),
              msg="mid-join DDL everywhere (incl. pending joiner)")
        for name in ("mid_join_a", "mid_join_b"):
            ids = {str(n.schema.get_table("ks", name).id)
                   for n in nodes + [joiner]}
            assert len(ids) == 1, (name, ids)

        # ---- finish_join: the HANDOVER entry. From this epoch on,
        # node1 holds a CMS seat and node4 does not.
        joiner.topology_commit({
            "op": "finish_join",
            "node": {"name": new_ep.name, "dc": new_ep.dc,
                     "rack": new_ep.rack, "host": new_ep.host,
                     "port": new_ep.port}})
        _wait(lambda: all(new_ep in n.ring.endpoints
                          for n in nodes + [joiner]),
              msg="finish_join everywhere")
        for n in nodes + [joiner]:
            assert [m.name for m in n.schema_sync.cms_members()] == \
                ["node1", "node2", "node3"]

        # ---- the NEW set commits: from the newly-seated member and
        # from the displaced one (now forwarding like any non-member)
        joiner.session().execute(
            "CREATE TABLE ks.post_join_a (k int PRIMARY KEY)")
        n4.session().execute(
            "CREATE TABLE ks.post_join_b (k int PRIMARY KEY)")
        _wait(lambda: all(n.schema_sync.epoch >= 7
                          for n in nodes + [joiner]),
              msg="post-join DDL everywhere")

        # ---- ONE history everywhere, ids agree
        logs = [n.schema_sync.entries_after(0) for n in nodes + [joiner]]
        assert all(lg == logs[0] for lg in logs[1:])
        for name in ("post_join_a", "post_join_b"):
            ids = {str(n.schema.get_table("ks", name).id)
                   for n in nodes + [joiner]}
            assert len(ids) == 1, (name, ids)
    finally:
        for n in nodes + ([joiner] if joiner else []):
            n.shutdown()
