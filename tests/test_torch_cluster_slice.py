"""The in-process cluster as a whole: one scenario through the JAX
package's LocalCluster and the port's LocalCluster(device="cpu").

Three nodes, RF 3, autocompaction off, on one ring (interop.ring_from
carries the JAX package's ring across and it must equal the port's). A
few hundred seeded rows are written with USING TIMESTAMP at QUORUM
through node 1, with a flush of every live node after each quarter;
node 3 is stopped, with hinted handoff off, for the last quarter and
restarted. A full repair then puts node 3 right, and every node's
table is major-compacted through CompactionTask(engine="device") (the
JAX package's jit programs on the CPU, the port's plain versions).
Before each flush and the compaction the test waits until every live
replica holds what was acknowledged. Each node's local rows, Merkle
roots per range, nodetool getendpoints / describering answers and the
sha256 of its compaction output are then exactly equal across the two
packages. A second scenario holds nodetool's cleanup and rebuild to the
JAX package the same way."""
from __future__ import annotations

import hashlib
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from cassandra_tpu.cluster import node as j_node
from cassandra_tpu.cluster import repair as j_repair
from cassandra_tpu.cluster.replication import ConsistencyLevel as JCL
from cassandra_tpu.compaction.task import CompactionTask as JTask
from cassandra_tpu.storage import cellbatch as j_cb
from cassandra_tpu.tools import nodetool as j_tool

from cassandra_tpu_torch import interop
from cassandra_tpu_torch.cluster import node as t_node
from cassandra_tpu_torch.cluster import repair as t_repair
from cassandra_tpu_torch.cluster.replication import ConsistencyLevel as TCL
from cassandra_tpu_torch.compaction.task import CompactionTask as TTask
from cassandra_tpu_torch.storage import cellbatch as t_cb
from cassandra_tpu_torch.tools import nodetool as t_tool
from torch_tmp import tmp_path  # noqa: F401

JAX = SimpleNamespace(
    name="jax", cluster=lambda n, d, rf: j_node.LocalCluster(n, d, rf=rf),
    CL=JCL, repair=j_repair, Task=JTask, cb=j_cb, tool=j_tool, task_kw={})
PORT = SimpleNamespace(
    name="port",
    cluster=lambda n, d, rf: t_node.LocalCluster(n, d, rf=rf, device="cpu"),
    CL=TCL, repair=t_repair, Task=TTask, cb=t_cb, tool=t_tool,
    task_kw={"device": "cpu"})

ROWS = 320
KEYS = 80
KS, TABLE = "sl", "t"
DDL = [
    f"CREATE KEYSPACE {KS} WITH replication = {{'class': "
    "'SimpleStrategy', 'replication_factor': 3}",
    # an explicit id: Statistics.db records the table id
    f"CREATE TABLE {KS}.{TABLE} (k int, c int, v text, PRIMARY KEY (k, c))"
    " WITH id = 5d3c9a60-0000-4000-8000-00000000c105",
]
INSERT = (f"INSERT INTO {KS}.{TABLE} (k, c, v) VALUES (?, ?, ?) "
          "USING TIMESTAMP {ts}")
COMPONENTS = ("Data.db", "Index.db", "Partitions.db", "Filter.db",
              "Statistics.db", "Summary.db", "Digest.crc32", "TOC.txt",
              "CompressionInfo.db")
WAIT_S = 60.0


def seeded_rows(seed: int, n: int = ROWS) -> list:
    """(k, c, v, ts) rows from a seed; every (k, c) distinct."""
    rng = np.random.default_rng(seed)
    kc = rng.choice(KEYS * 64, size=n, replace=False)
    vals = rng.integers(0, 1 << 40, size=n)
    return [(int(x) // 64, int(x) % 64, f"v{int(v):x}", 1_000_000 + i)
            for i, (x, v) in enumerate(zip(kc, vals))]


def wait_for(cond, what: str, timeout: float = WAIT_S) -> None:
    """Poll `cond` until it holds; fail after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def local_rows(node) -> int:
    """The (k, c) rows node's own store holds (memtable and sstables)."""
    batch = node.engine.store(KS, TABLE).scan_all()
    if len(batch) == 0:
        return 0
    # a row's identity: every lane before the column's (the last three
    # lanes are the column id and the cell's path)
    ident = np.asarray(batch.lanes)[:, :batch.n_lanes - 3]
    return len(np.unique(ident, axis=0))


def drain(nodes, rows: int) -> None:
    """Wait until every node in `nodes` holds `rows` rows locally: the
    replica messages of QUORUM writes may land after the coordinator
    returned."""
    for nd in nodes:
        wait_for(lambda: local_rows(nd) == rows,
                 f"{nd.endpoint.name} to hold {rows} rows")


def flush(nodes) -> None:
    for nd in nodes:
        nd.engine.store(KS, TABLE).flush()


def merkle_roots(pkg, node) -> list:
    """Per token range of the ring, the root of the validation tree over
    node's cells in that range."""
    table = node.schema.get_table(KS, TABLE)
    batch = node.engine.store(KS, TABLE).scan_all()
    out = []
    for lo, hi in node.ring.all_ranges():
        part = pkg.cb.filter_token_range(batch, lo, hi)
        tree = pkg.repair.build_validation_tree(table, part)
        out.append((lo, hi, tree.root().hex()))
    return out


def cell_columns(node) -> dict:
    """node's own merged cells, column by column."""
    b = node.engine.store(KS, TABLE).scan_all()
    return {k: np.asarray(getattr(b, k)).tobytes()
            for k in ("lanes", "ts", "ldt", "ttl", "flags", "off",
                      "payload")}


def component_hashes(directory: str) -> dict:
    out = {}
    for fn in sorted(os.listdir(directory)):
        p = os.path.join(directory, fn)
        if os.path.isfile(p) and fn.endswith(COMPONENTS):
            with open(p, "rb") as f:
                out[fn] = hashlib.sha256(f.read()).hexdigest()
    return out


def device_major(pkg, node) -> dict:
    """node's table major-compacted through the device engine; the
    sha256 of every component of the result."""
    cfs = node.engine.store(KS, TABLE)
    stats = pkg.Task(cfs, cfs.live_sstables(), engine="device",
                     **pkg.task_kw).execute()
    assert stats["cells_written"] > 0
    return component_hashes(cfs.directory)


def scenario(pkg, base: str, rows: list) -> dict:
    c = pkg.cluster(3, os.path.join(base, pkg.name), 3)
    out: dict = {}
    try:
        for nd in c.nodes:
            pkg.tool.disableautocompaction(nd.engine)
            nd.default_cl = pkg.CL.QUORUM
        s = c.session(1)
        for q in DDL:
            s.execute(q)
        live = list(c.nodes)
        quarter = len(rows) // 4
        for qi in range(4):
            if qi == 3:
                for nd in c.nodes:
                    pkg.tool.disablehandoff(nd)
                c.stop_node(3)
                live = c.nodes[:2]
            for k, ck, v, ts in rows[qi * quarter:(qi + 1) * quarter]:
                s.execute(INSERT.format(ts=ts), [k, ck, v])
            drain(live, (qi + 1) * quarter)
            flush(live)
        out["node3_before"] = local_rows(c.node(3))
        c.restart_node(3)
        for nd in c.nodes:
            wait_for(lambda: all(nd.is_alive(o.endpoint) for o in c.nodes
                                 if o is not nd),
                     f"{nd.endpoint.name} to see every peer alive")
        out["repair"] = pkg.tool.repair(c.node(1), KS, TABLE, full=True)
        drain(c.nodes, len(rows))
        out["preview"] = pkg.tool.repair(c.node(1), KS, TABLE, full=True,
                                         preview=True)
        flush(c.nodes)
        out["rows"] = [cell_columns(nd) for nd in c.nodes]
        out["merkle"] = [merkle_roots(pkg, nd) for nd in c.nodes]
        out["getendpoints"] = [
            pkg.tool.getendpoints(c.node(1), KS, TABLE, str(k))
            for k in range(KEYS)]
        out["describering"] = pkg.tool.describering(c.node(2), KS)
        out["ring"] = c.ring
        out["compaction"] = [device_major(pkg, nd) for nd in c.nodes]
        return out
    finally:
        c.shutdown()


def ring_state(ring) -> dict:
    return {"endpoints": {(e.name, e.dc, e.rack, e.host, e.port):
                          sorted(t) for e, t in ring.endpoints.items()},
            "pending": {e.name: sorted(t) for e, t in ring.pending.items()},
            "ranges": ring.all_ranges()}


def test_cluster_slice_equals_jax(tmp_path):
    rows = seeded_rows(12)
    j = scenario(JAX, str(tmp_path), rows)
    t = scenario(PORT, str(tmp_path), rows)
    # one ring: the JAX package's, carried across, is the port's
    assert ring_state(interop.ring_from(j["ring"])) == ring_state(t["ring"])
    # node 3 missed the last quarter, and the repair streamed it back
    assert j["node3_before"] == t["node3_before"] == 3 * (ROWS // 4)
    assert t["repair"] == j["repair"]
    assert t["repair"][0]["ranges_synced"] > 0
    assert t["preview"] == j["preview"]
    assert t["preview"][0]["ranges_mismatched"] == 0
    for i in range(3):
        assert t["rows"][i] == j["rows"][i], f"node{i + 1}'s cells"
        assert t["merkle"][i] == j["merkle"][i], f"node{i + 1}'s roots"
        assert t["compaction"][i] == j["compaction"][i], \
            f"node{i + 1}'s compaction output"
        assert t["compaction"][i]
    # after the repair every replica holds the same cells
    assert t["rows"][0] == t["rows"][1] == t["rows"][2]
    assert t["getendpoints"] == j["getendpoints"]
    assert t["describering"] == j["describering"]


def admin_scenario(pkg, base: str, rows: list) -> dict:
    """Two nodes at RF 2; node 2 is down, with hinted handoff off, while
    the rows are written at ONE, and rebuild fills it from node 1. Then
    a third node joins, and cleanup drops from each node the ranges it
    no longer replicates."""
    c = pkg.cluster(2, os.path.join(base, pkg.name), 2)
    out: dict = {}
    try:
        for nd in c.nodes:
            pkg.tool.disableautocompaction(nd.engine)
            pkg.tool.disablehandoff(nd)
        s = c.session(1)
        s.execute(DDL[0].replace("'replication_factor': 3",
                                 "'replication_factor': 2"))
        s.execute(DDL[1])
        c.stop_node(2)
        for k, ck, v, ts in rows:
            s.execute(INSERT.format(ts=ts), [k, ck, v])
        c.restart_node(2)
        flush(c.nodes)
        out["before"] = [local_rows(nd) for nd in c.nodes]
        out["rebuild"] = pkg.tool.rebuild(c.node(2), KS)
        flush(c.nodes)
        out["rebuilt"] = [local_rows(nd) for nd in c.nodes]
        pkg.tool.disableautocompaction(c.add_node().engine)
        flush(c.nodes)
        out["joined"] = [local_rows(nd) for nd in c.nodes]
        out["cleanup"] = [pkg.tool.cleanup(nd, KS, TABLE) for nd in c.nodes]
        out["after"] = [local_rows(nd) for nd in c.nodes]
        out["cells"] = [cell_columns(nd) for nd in c.nodes]
        return out
    finally:
        c.shutdown()


def test_nodetool_rebuild_cleanup_equal_jax(tmp_path):
    rows = seeded_rows(5, n=160)
    j = admin_scenario(JAX, str(tmp_path), rows)
    t = admin_scenario(PORT, str(tmp_path), rows)
    assert t["before"] == [len(rows), 0]
    assert t["rebuilt"] == [len(rows), len(rows)]
    # RF 2 on three nodes: each row on two of them after the cleanup
    assert sum(t["after"]) == 2 * len(rows)
    assert sum(t["after"]) < sum(t["joined"])
    for key in ("before", "rebuild", "rebuilt", "joined", "cleanup",
                "after", "cells"):
        assert t[key] == j[key], key


def test_local_cluster_device(tmp_path):
    """Every node's engine runs on the cluster's one device, including a
    node added later; without a card the default (cuda) raises."""
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_node.LocalCluster(1, str(tmp_path / "cuda"))
    c = PORT.cluster(2, str(tmp_path / "cpu"), 1)
    try:
        added = c.add_node()
        assert {nd.engine.device.type for nd in c.nodes} == {"cpu"}
        assert added.engine.device == c.device
    finally:
        c.shutdown()
