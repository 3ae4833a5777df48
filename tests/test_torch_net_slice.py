"""The networked stack as a whole: one scenario through the JAX package's
daemons and the port's (device="cpu"), each run in this process.

Each package builds three nodes with its `tools.noded.build_node` (the
daemon's static-ring shape: per-node Schema, the config's DDL with
explicit table ids, TcpTransport on loopback), fronts each with a
`CQLServer` and an `AdminServer`, and turns autocompaction off through
the admin socket. Seeded rows are written with USING TIMESTAMP through
`client.Cluster` at QUORUM; an offline directory of vector rows is
bulkloaded through `admin_call("bulkload")`; every node is flushed over
the admin socket. Each node's table is then compacted on a copy with
CompactionTask(engine="device") (the JAX package's jit programs on the
CPU, the port's plain versions) and by `nodetool compact` over the
admin socket. The rows read back over the wire and the sha256 of every
compaction output are exactly equal across the two packages (and the
copy's equal to the node's own); ANN queries at ALL over the wire give
the same ids in both packages, equal to a numpy oracle, with the
vectors as loaded. The CQL rows carry no scores: the scores every
replica's index computes for its coordinator lie within ANN_TOL of the
oracle's and of the JAX package's."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import socket
import time
from types import SimpleNamespace

import numpy as np

from cassandra_tpu import client as j_client
from cassandra_tpu.cluster.replication import ConsistencyLevel as JCL
from cassandra_tpu.compaction.task import CompactionTask as JTask
from cassandra_tpu.service import admin as j_admin
from cassandra_tpu.storage import cellbatch as j_cb
from cassandra_tpu.storage import sstable as j_sst
from cassandra_tpu.storage.table import ColumnFamilyStore as JCFS
from cassandra_tpu.tools import bulk as j_bulk
from cassandra_tpu.tools import noded as j_noded
from cassandra_tpu.transport.server import CQLServer as JServer

from cassandra_tpu_torch import client as t_client
from cassandra_tpu_torch.cluster.replication import ConsistencyLevel as TCL
from cassandra_tpu_torch.cluster.ring import even_tokens
from cassandra_tpu_torch.compaction.task import CompactionTask as TTask
from cassandra_tpu_torch.service import admin as t_admin
from cassandra_tpu_torch.storage import cellbatch as t_cb
from cassandra_tpu_torch.storage import sstable as t_sst
from cassandra_tpu_torch.storage.table import ColumnFamilyStore as TCFS
from cassandra_tpu_torch.tools import bulk as t_bulk
from cassandra_tpu_torch.tools import noded as t_noded
from cassandra_tpu_torch.transport.server import CQLServer as TServer
from torch_tmp import tmp_path  # noqa: F401

JAX = SimpleNamespace(
    name="jax", noded=j_noded, Server=JServer, admin=j_admin,
    client=j_client, CL=JCL, Task=JTask, CFS=JCFS, cb=j_cb, sst=j_sst,
    bulk=j_bulk, cfg={}, task_kw={})
PORT = SimpleNamespace(
    name="port", noded=t_noded, Server=TServer, admin=t_admin,
    client=t_client, CL=TCL, Task=TTask, CFS=TCFS, cb=t_cb, sst=t_sst,
    bulk=t_bulk, cfg={"device": "cpu"}, task_kw={"device": "cpu"})

KS = "net"
IDS = {"kv": "5d3c9a60-0000-4000-8000-00000000b001",
       "emb": "5d3c9a60-0000-4000-8000-00000000b002"}
DIM = 16
DDL = [
    f"CREATE KEYSPACE {KS} WITH replication = {{'class': "
    "'SimpleStrategy', 'replication_factor': 3}",
    f"CREATE TABLE {KS}.kv (k int, c int, v text, PRIMARY KEY (k, c)) "
    f"WITH id = {IDS['kv']}",
    f"CREATE TABLE {KS}.emb (id int, c int, v vector<float, {DIM}>, "
    f"PRIMARY KEY (id, c)) WITH id = {IDS['emb']}",
    f"CREATE CUSTOM INDEX ON {KS}.emb (v) USING 'SAI'",
]
ROWS = 240
KEYS = 60
VECTORS = 300
ANN = ((5, 3), (20, 1))              # (k, queries)
ANN_TOL = 1e-5                       # cosine, as chip_smoke.ANN_TOL
COMPONENTS = ("Data.db", "Index.db", "Partitions.db", "Filter.db",
              "Statistics.db", "Summary.db", "Digest.crc32", "TOC.txt",
              "CompressionInfo.db")
WAIT_S = 60.0


def seeded_rows(seed: int) -> list:
    """(k, c, v, ts) rows from a seed; every (k, c) distinct."""
    rng = np.random.default_rng(seed)
    kc = rng.choice(KEYS * 64, size=ROWS, replace=False)
    vals = rng.integers(0, 1 << 40, size=ROWS)
    return [(int(x) // 64, int(x) % 64, f"v{int(v):x}", 1_000_000 + i)
            for i, (x, v) in enumerate(zip(kc, vals))]


def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def wait_for(cond, what: str, timeout: float = WAIT_S) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def local_rows(node, table: str) -> int:
    """The rows node's own store holds (memtable and sstables)."""
    batch = node.engine.store(KS, table).scan_all()
    if len(batch) == 0:
        return 0
    ident = np.asarray(batch.lanes)[:, :batch.n_lanes - 3]
    return len(np.unique(ident, axis=0))


def component_hashes(directory: str) -> dict:
    out = {}
    for fn in sorted(os.listdir(directory)):
        p = os.path.join(directory, fn)
        if os.path.isfile(p) and fn.endswith(COMPONENTS):
            with open(p, "rb") as f:
                out[fn] = hashlib.sha256(f.read()).hexdigest()
    return out


def write_offline(pkg, table, vecs: np.ndarray, directory: str) -> None:
    """The vector rows as two sstables written by the package's own
    SSTableWriter: what an external pipeline hands sstableloader."""
    os.makedirs(directory)
    n = len(vecs)
    col = table.columns["v"].column_id
    batch = pkg.cb.merge_sorted([pkg.bulk.build_int_batch(
        table, np.arange(n, dtype=np.int64), np.zeros(n, np.int64),
        vecs.astype(">f4").view(np.uint8).reshape(n, -1),
        np.full(n, 5_000_000, np.int64), column_id=col)])
    half = len(batch) // 2
    for gen, (a, b) in enumerate(((0, half), (half, len(batch))), start=1):
        w = pkg.sst.SSTableWriter(pkg.sst.Descriptor(directory, gen), table)
        w.append(batch.slice_range(a, b))
        w.finish()


def oracle(m64: np.ndarray, q: np.ndarray, k: int):
    """Cosine top k in float64: (ids, scores, the (k+1)-th score)."""
    q64 = q.astype(np.float64)
    s = m64 @ q64 / np.maximum(np.linalg.norm(m64, axis=1), 1e-9) \
        / max(float(np.linalg.norm(q64)), 1e-9)
    order = np.argsort(-s, kind="stable")[:k + 1]
    return order[:k], s[order[:k]], s[order[k]]


def scenario(pkg, base: str, rows: list, vecs: np.ndarray,
             queries: list) -> dict:
    base = os.path.join(base, pkg.name)
    ports = free_ports(3)
    tokens = even_tokens(3, vnodes=4)
    names = ["node1", "node2", "node3"]

    def peer(i):
        return {"name": names[i], "host": "127.0.0.1", "port": ports[i],
                "tokens": tokens[i]}
    built, servers, admins = [], [], []
    out: dict = {}
    try:
        for i in range(3):
            built.append(pkg.noded.build_node({
                **peer(i), "data_dir": os.path.join(base, names[i]),
                "peers": [peer(j) for j in range(3) if j != i],
                "seeds": [names[0]], "gossip_interval": 0.05, "ddl": DDL,
                **pkg.cfg}))
        nodes = [nd for nd, _ in built]
        wait_for(lambda: all(a.is_alive(b.endpoint) for a in nodes
                             for b in nodes if a is not b),
                 "gossip to converge")
        servers = [pkg.Server(nd) for nd in nodes]
        admins = [pkg.admin.AdminServer(nd) for nd in nodes]

        def call(i, cmd, args=None):
            return pkg.admin.admin_call("127.0.0.1", admins[i].port, cmd,
                                        args)
        for i in range(3):
            call(i, "disableautocompaction")
            nodes[i].default_cl = pkg.CL.QUORUM
        s = pkg.client.Cluster("127.0.0.1", servers[0].port).connect()
        kv = nodes[0].schema.get_table(KS, "kv")
        for k, ck, v, ts in rows:
            s.execute(f"INSERT INTO {KS}.kv (k, c, v) VALUES (?, ?, ?) "
                      f"USING TIMESTAMP {ts}",
                      pkg.client.serialize_params(kv, ["k", "c", "v"],
                                                  [k, ck, v]),
                      consistency="QUORUM")
        for nd in nodes:
            wait_for(lambda: local_rows(nd, "kv") == len(rows),
                     f"{nd.endpoint.name} to hold every row")

        offline = os.path.join(base, "offline")
        write_offline(pkg, nodes[0].schema.get_table(KS, "emb"), vecs,
                      offline)
        out["bulkload"] = call(0, "bulkload", {"directory": offline,
                                               "keyspace": KS,
                                               "table": "emb"})
        out["flush"] = [call(i, "flush", {"keyspace": KS})
                        for i in range(3)]

        s2 = pkg.client.Cluster("127.0.0.1", servers[1].port).connect()
        out["rows"] = sorted(s2.execute(
            f"SELECT k, c, v FROM {KS}.kv", consistency="QUORUM").rows)
        out["by_key"] = [s2.execute(
            f"SELECT c, v FROM {KS}.kv WHERE k = ?",
            pkg.client.serialize_params(kv, ["k"], [k]),
            consistency="QUORUM").rows for k in range(0, KEYS, 7)]
        s2.close()

        nodes[0].default_cl = pkg.CL.ALL
        out["ann"] = []
        for q, k in queries:
            lit = "[" + ", ".join(repr(float(x)) for x in q) + "]"
            got = s.execute(f"SELECT id, v FROM {KS}.emb ORDER BY v ANN OF "
                            f"{lit} LIMIT {k}", consistency="ALL").rows
            out["ann"].append(([r[0] for r in got],
                               [json.loads(r[1]) for r in got]))
        s.close()
        # the scores each replica's index hands its coordinator in
        # INDEX_RSP (the CQL rows carry none)
        index = [nd.engine.indexes.get(KS, "emb", "v") for nd in nodes]
        out["scores"] = [[[score for _pk, _ck, score in ix.ann(q, k)]
                          for ix in index] for q, k in queries]

        out["compaction"] = []
        for i, nd in enumerate(nodes):
            cfs = nd.engine.store(KS, "kv")
            stage = os.path.join(base, f"copy{i}")
            shutil.copytree(cfs.directory, os.path.join(
                stage, KS, os.path.basename(cfs.directory)))
            copy = pkg.CFS(cfs.table, stage, commitlog=None)
            copy.reload_sstables()
            stats = pkg.Task(copy, copy.tracker.view(), engine="device",
                             **pkg.task_kw).execute()
            assert stats["cells_written"] > 0
            device = component_hashes(copy.directory)
            for r in copy.live_sstables():
                r.close()
            own = call(i, "compact", {"keyspace": KS, "table": "kv"})
            assert own[0]["cells_written"] == stats["cells_written"]
            out["compaction"].append(
                (device, component_hashes(cfs.directory)))
        return out
    finally:
        for srv in servers:
            srv.close()
        for adm in admins:
            adm.close()
        for nd, _transport in built:
            nd.shutdown()


def test_net_slice_equals_jax(tmp_path):
    rows = seeded_rows(13)
    rng = np.random.default_rng(14)
    vecs = rng.standard_normal((VECTORS, DIM)).astype(np.float32)
    queries = [(rng.standard_normal(DIM).astype(np.float32), k)
               for k, count in ANN for _ in range(count)]
    j = scenario(JAX, str(tmp_path), rows, vecs, queries)
    t = scenario(PORT, str(tmp_path), rows, vecs, queries)
    assert t["bulkload"] == j["bulkload"] == {
        "sstables": 2, "cells": VECTORS, "partitions": VECTORS}
    assert t["flush"] == j["flush"]
    # every row as written, read back over the wire at QUORUM
    assert t["rows"] == j["rows"] == sorted((k, c, v)
                                            for k, c, v, _ in rows)
    assert t["by_key"] == j["by_key"]
    m64 = vecs.astype(np.float64)
    for (q, k), (t_ids, t_vecs), (j_ids, _), t_sc, j_sc in zip(
            queries, t["ann"], j["ann"], t["scores"], j["scores"]):
        o_ids, o_s, nxt = oracle(m64, q, k)
        assert o_s[-1] - nxt > ANN_TOL           # the ids are decided
        assert t_ids == j_ids == o_ids.tolist()
        assert np.array_equal(np.asarray(t_vecs, dtype=np.float64),
                              m64[o_ids])
        for t_node, j_node in zip(t_sc, j_sc):
            assert len(t_node) == len(j_node) == k
            assert np.abs(np.asarray(t_node) - o_s).max() <= ANN_TOL
            assert np.abs(np.asarray(t_node) - np.asarray(j_node)).max() \
                <= ANN_TOL
    for i in range(3):
        (t_dev, t_own), (j_dev, j_own) = t["compaction"][i], \
            j["compaction"][i]
        assert t_dev and t_dev == t_own, f"node{i + 1}: copy vs own"
        assert t_dev == j_dev and t_own == j_own, \
            f"node{i + 1}'s compaction output"
