"""The port's cluster modules one by one against the JAX package's, on the
same seeded numpy inputs, with exact comparisons: the ring's tokens and
replica placement (SimpleStrategy, NetworkTopologyStrategy over two
DCs), the coordinator's CellBatch messages, Paxos ballots, and the four
files the cluster keeps on disk (hints, the Paxos log, the CMS Paxos
log and the schema epoch log): each written by the JAX package reads
back in the port to the same records, and the port writes the same
bytes for the same inputs."""
from __future__ import annotations

import json
import os
import shutil
import uuid

import numpy as np
import pytest

from cassandra_tpu.cluster import coordinator as j_coord
from cassandra_tpu.cluster import hints as j_hints
from cassandra_tpu.cluster import paxos as j_paxos
from cassandra_tpu.cluster import replication as j_repl
from cassandra_tpu.cluster import ring as j_ring
from cassandra_tpu.cluster.messaging import LocalTransport as JTransport
from cassandra_tpu.cluster.node import Node as JNode
from cassandra_tpu.cluster.schema_sync import SchemaSync as JSync
from cassandra_tpu.cql import Session as JSession
from cassandra_tpu.schema import Schema as JSchema
from cassandra_tpu.storage.engine import StorageEngine as JEngine
from cassandra_tpu.storage.mutation import Mutation as JMutation
from cassandra_tpu.utils import timeutil as j_timeutil

from cassandra_tpu_torch import interop
from cassandra_tpu_torch.cluster import coordinator as t_coord
from cassandra_tpu_torch.cluster import hints as t_hints
from cassandra_tpu_torch.cluster import paxos as t_paxos
from cassandra_tpu_torch.cluster import replication as t_repl
from cassandra_tpu_torch.cluster import ring as t_ring
from cassandra_tpu_torch.cluster.messaging import LocalTransport as TTransport
from cassandra_tpu_torch.cluster.node import Node as TNode
from cassandra_tpu_torch.cluster.schema_sync import SchemaSync as TSync
from cassandra_tpu_torch.cql import Session as TSession
from cassandra_tpu_torch.schema import Schema as TSchema
from cassandra_tpu_torch.storage.engine import StorageEngine as TEngine
from cassandra_tpu_torch.storage.mutation import Mutation as TMutation
from cassandra_tpu_torch.utils import timeutil as t_timeutil
from torch_tmp import tmp_path  # noqa: F401

TABLE_ID = uuid.UUID("5d3c9a60-0000-4000-8000-00000000c106")


def seeded_ring(ring_mod, seed: int):
    """Six endpoints over two DCs and two racks each, four seeded tokens
    each, and one joining endpoint with pending tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.choice(np.arange(-(1 << 62), 1 << 62, 1 << 40,
                                dtype=np.int64), size=28, replace=False)
    ring = ring_mod.Ring()
    for i in range(6):
        ep = ring_mod.Endpoint(f"n{i + 1}", dc=f"dc{i % 2 + 1}",
                               rack=f"r{i // 2 % 2 + 1}")
        ring.add_node(ep, [int(t) for t in toks[4 * i:4 * i + 4]])
    ring.add_pending(ring_mod.Endpoint("n7", dc="dc2", rack="r1"),
                     [int(t) for t in toks[24:]])
    return ring


def names(eps) -> list:
    return [e.name for e in eps]


@pytest.mark.parametrize("n,vnodes", [(1, 1), (3, 4), (5, 16), (7, 3)])
def test_even_tokens(n, vnodes):
    assert t_ring.even_tokens(n, vnodes) == j_ring.even_tokens(n, vnodes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocate_tokens_and_ranges(seed):
    jr = seeded_ring(j_ring, seed)
    tr = seeded_ring(t_ring, seed)
    for vnodes in (1, 4, 8):
        assert t_ring.allocate_tokens(tr, vnodes) == \
            j_ring.allocate_tokens(jr, vnodes)
    assert tr.all_ranges() == jr.all_ranges()
    assert t_ring.allocate_tokens(t_ring.Ring(), 4) == \
        j_ring.allocate_tokens(j_ring.Ring(), 4)


def test_ring_from_carries_moves_and_replacements():
    jr = seeded_ring(j_ring, 7)
    n1, n2 = sorted(jr.endpoints, key=lambda e: e.name)[:2]
    jr.start_move(n1, [17, 19])
    jr.start_replace(j_ring.Endpoint("n8", dc="dc1"), n2)
    tr = interop.ring_from(jr)
    assert {e.name: t for e, t in tr.moving.items()} == \
        {e.name: t for e, t in jr.moving.items()}
    assert {a.name: b.name for a, b in tr.replacing.items()} == {"n8": "n2"}
    assert sorted(tr.pending[t_ring.Endpoint("n1", dc="dc1",
                                             rack="r1")]) == [17, 19]
    assert tr.all_ranges() == jr.all_ranges()
    fj, ft = jr.future_ring(), tr.future_ring()
    assert ft.all_ranges() == fj.all_ranges()
    for lo, hi in fj.all_ranges():
        assert ft.primary(hi).name == fj.primary(hi).name


@pytest.mark.parametrize("options", [
    {"class": "SimpleStrategy", "replication_factor": 3},
    {"class": "SimpleStrategy", "replication_factor": 1},
    {"class": "NetworkTopologyStrategy", "dc1": 2, "dc2": 2},
    {"class": "NetworkTopologyStrategy", "dc1": 3, "dc2": 1},
], ids=["simple3", "simple1", "nts22", "nts31"])
def test_replicas_of_seeded_keys(options):
    jr = seeded_ring(j_ring, 4)
    # the port's ring twice: built directly, and carried across
    rings = [seeded_ring(t_ring, 4), interop.ring_from(jr)]
    js = j_repl.ReplicationStrategy.create(options)
    ts = t_repl.ReplicationStrategy.create(options)
    assert ts.replication_factor() == js.replication_factor()
    rng = np.random.default_rng(9)
    for _ in range(300):
        key = rng.bytes(int(rng.integers(1, 24)))
        tok = jr.token_of(key)
        want = names(js.replicas(jr, tok))
        for tr in rings:
            assert tr.token_of(key) == tok
            assert names(ts.replicas(tr, tok)) == want
            assert names(ts.replicas(tr.future_ring(), tok)) == \
                names(js.replicas(jr.future_ring(), tok))
    for lo, hi in jr.all_ranges():
        for tr in rings:
            assert names(ts.replicas(tr, hi)) == names(js.replicas(jr, hi))


@pytest.mark.parametrize("cl", ["ANY", "ONE", "TWO", "THREE", "QUORUM",
                                "ALL", "LOCAL_QUORUM", "LOCAL_ONE",
                                "EACH_QUORUM"])
@pytest.mark.parametrize("options", [
    {"class": "SimpleStrategy", "replication_factor": 3},
    {"class": "NetworkTopologyStrategy", "dc1": 3, "dc2": 2},
], ids=["simple3", "nts32"])
def test_consistency_block_for(cl, options):
    jr = seeded_ring(j_ring, 3)
    tr = interop.ring_from(jr)
    js = j_repl.ReplicationStrategy.create(options)
    ts = t_repl.ReplicationStrategy.create(options)
    jcl = getattr(j_repl.ConsistencyLevel, cl)
    tcl = getattr(t_repl.ConsistencyLevel, cl)
    assert tcl == jcl
    for dc in ("dc1", "dc2"):
        assert t_repl.ConsistencyLevel.block_for(tcl, ts, dc) == \
            j_repl.ConsistencyLevel.block_for(jcl, js, dc)
    tok = int(tr.all_ranges()[2][1])
    live_t = ts.replicas(tr, tok)[1:]
    live_j = js.replicas(jr, tok)[1:]
    assert t_repl.ConsistencyLevel.each_quorum_unavailable_dcs(
        ts, live_t) == j_repl.ConsistencyLevel.each_quorum_unavailable_dcs(
        js, live_j)


def _engine_rows(engine_cls, session_cls, schema_cls, directory, seed):
    eng = engine_cls(directory, schema_cls(), **(
        {"device": "cpu"} if engine_cls is TEngine else {}))
    s = session_cls(eng)
    s.execute("CREATE KEYSPACE ks WITH replication = {'class': "
              "'SimpleStrategy', 'replication_factor': 1}")
    s.execute("CREATE TABLE ks.t (k int, c int, v text, m map<int, text>, "
              f"PRIMARY KEY (k, c)) WITH id = {TABLE_ID}")
    rng = np.random.default_rng(seed)
    for i in range(120):
        k, c = int(rng.integers(0, 6)), int(rng.integers(0, 40))
        v = "x" * int(rng.integers(0, 30))
        s.execute(f"INSERT INTO ks.t (k, c, v, m) VALUES (?, ?, ?, ?) "
                  f"USING TIMESTAMP {1000 + i}", [k, c, v, {i: v}])
        if i % 17 == 0:
            s.execute(f"DELETE FROM ks.t USING TIMESTAMP {1000 + i} "
                      "WHERE k = ? AND c = ?", [k, c])
    cfs = eng.store("ks", "t")
    return eng, cfs.table, cfs.scan_all(now=2_000_000_000)


COLS = ("lanes", "ts", "ldt", "ttl", "flags", "off", "val_start",
        "payload")


def _columns(batch) -> dict:
    return {k: np.asarray(getattr(batch, k)).tobytes() for k in COLS}


def test_cellbatch_messages_round_trip(tmp_path, monkeypatch):
    # the deletions' local deletion time: one instant in both packages
    for mod in (j_timeutil, t_timeutil):
        monkeypatch.setattr(mod, "CLOCK", lambda: 1_790_000_000.25)
    je, jt, jb = _engine_rows(JEngine, JSession, JSchema,
                              str(tmp_path / "j"), 5)
    te, tt, tb = _engine_rows(TEngine, TSession, TSchema,
                              str(tmp_path / "t"), 5)
    try:
        assert _columns(tb) == _columns(jb)
        assert len(tb) > 100
        # each package's round trip, and the JAX message into the port
        for msg in (t_coord.cb_serialize(tb), j_coord.cb_serialize(jb)):
            deser = t_coord.cb_deserialize(msg)
            assert _columns(deser) == _columns(tb)
            assert dict(deser.pk_map) == dict(tb.pk_map)
            assert deser.sorted == tb.sorted
        # one partition's batch as a mutation: the same bytes
        from cassandra_tpu.storage import cellbatch as j_cb
        from cassandra_tpu_torch.storage import cellbatch as t_cb
        jtok, ttok = j_cb.batch_tokens(jb), t_cb.batch_tokens(tb)
        assert np.array_equal(jtok, ttok)
        for tok in sorted(set(int(x) for x in ttok)):
            jm = j_coord.batch_to_mutation(
                jt, j_cb.filter_token_range(jb, tok - 1, tok))
            tm = t_coord.batch_to_mutation(
                tt, t_cb.filter_token_range(tb, tok - 1, tok))
            assert tm.serialize() == jm.serialize()
            assert TMutation.deserialize(jm.serialize()).serialize() == \
                jm.serialize()
        assert t_coord.batch_to_mutation(tt, tb.slice_range(0, 0)) is None
    finally:
        je.close()
        te.close()


def seeded_mutations(mod, seed: int, n: int = 40) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = mod(TABLE_ID, rng.bytes(int(rng.integers(1, 12))))
        for j in range(int(rng.integers(1, 5))):
            m.add(rng.bytes(8), int(rng.integers(0, 4)), b"",
                  rng.bytes(int(rng.integers(0, 40))),
                  int(rng.integers(1, 1 << 50)), int(rng.integers(0, 1 << 30)),
                  int(rng.integers(0, 100)), int(rng.integers(0, 2)))
        out.append(m)
    return out


def test_hints_file_across_packages(tmp_path):
    jm = seeded_mutations(JMutation, 3)
    tm = seeded_mutations(TMutation, 3)
    assert [m.serialize() for m in tm] == [m.serialize() for m in jm]
    jh = j_hints.HintsService(str(tmp_path / "j"))
    th = t_hints.HintsService(str(tmp_path / "t"))
    jt, tt = j_ring.Endpoint("node2"), t_ring.Endpoint("node2")
    for m in jm:
        jh.store(jt, m)
    for m in tm:
        th.store(tt, m)
    jp = tmp_path / "j" / "hints-node2.db"
    tp = tmp_path / "t" / "hints-node2.db"
    assert tp.read_bytes() == jp.read_bytes()
    # the JAX package's file, replayed by the port
    shutil.copy(jp, tmp_path / "t" / "hints-node3.db")
    got = []
    assert th.dispatch(t_ring.Endpoint("node3"), got.append) == len(jm)
    assert [m.serialize() for m in got] == [m.serialize() for m in jm]
    assert not th.has_hints(t_ring.Endpoint("node3"))


def test_ballot_order():
    rng = np.random.default_rng(11)
    pairs = [(int(rng.integers(0, 50)), f"node{int(rng.integers(1, 4))}")
             for _ in range(200)]
    jb = sorted(j_paxos.Ballot(*p) for p in pairs)
    tb = sorted(t_paxos.Ballot(*p) for p in pairs)
    assert [b.pack() for b in tb] == [b.pack() for b in jb]
    assert all(t_paxos.ZERO < b for b in tb if b.pack() != (0, ""))
    assert t_paxos.Ballot.unpack(jb[3].pack()) == tb[3]
    assert t_paxos.Ballot.unpack(None) is None


def paxos_records(seed: int, n: int = 60) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = int(rng.integers(0, 3))
        value = rng.bytes(int(rng.integers(1, 30))) if kind == 1 else None
        out.append((TABLE_ID, rng.bytes(int(rng.integers(1, 10))), kind,
                    (int(rng.integers(-5, 1 << 60)),
                     f"node{int(rng.integers(1, 4))}"), value))
    return out


def _replayed(log) -> list:
    return [(tid, pk, kind, b.pack(), v) for tid, pk, kind, b, v in
            log.replay()]


def test_paxos_log_across_packages(tmp_path):
    recs = paxos_records(6)
    jl = j_paxos.PaxosLog(str(tmp_path / "j" / "paxos"))
    tl = t_paxos.PaxosLog(str(tmp_path / "t" / "paxos"))
    for tid, pk, kind, b, v in recs:
        jl.append(tid, pk, kind, j_paxos.Ballot(*b), v)
        tl.append(tid, pk, kind, t_paxos.Ballot(*b), v)
    with open(jl.path, "rb") as f1, open(tl.path, "rb") as f2:
        assert f2.read() == f1.read()
    # the JAX package's log, replayed by the port
    back = t_paxos.PaxosLog(str(tmp_path / "j" / "paxos"))
    assert _replayed(back) == [(t, pk, k, b, v) for t, pk, k, b, v in recs]
    assert _replayed(back) == _replayed(jl)


def single_node(node_cls, sync_cls, ring_mod, transport_cls, schema_cls,
                directory: str, **kw):
    """One node owning the whole ring, with its schema epoch log and
    CMS (as the CMS tests build them)."""
    ep = ring_mod.Endpoint("node1", host="127.0.0.1", port=0)
    ring = ring_mod.Ring()
    ring.add_node(ep, ring_mod.even_tokens(1, vnodes=4)[0])
    node = node_cls(ep, directory, schema_cls(), ring, transport_cls(),
                    seeds=[ep], gossip_interval=0.05, **kw)
    node.cluster_nodes = [node]
    node.schema_sync = sync_cls(node, directory)
    node.gossiper.start()
    return node


SCHEMA_DDL = [
    "CREATE KEYSPACE ks WITH replication = {'class': 'SimpleStrategy', "
    "'replication_factor': 1}",
    f"CREATE TABLE ks.t (k int PRIMARY KEY, v text) WITH id = {TABLE_ID}",
    "CREATE TABLE ks.u (k int PRIMARY KEY, n int) WITH id = "
    "5d3c9a60-0000-4000-8000-00000000c107",
    "ALTER TABLE ks.t ADD w int",
    "DROP TABLE ks.u",
]


def test_schema_and_cms_logs_across_packages(tmp_path):
    jn = single_node(JNode, JSync, j_ring, JTransport, JSchema,
                     str(tmp_path / "j"))
    tn = single_node(TNode, TSync, t_ring, TTransport, TSchema,
                     str(tmp_path / "t"), engine_opts={"device": "cpu"})
    try:
        for node in (jn, tn):
            s = node.session()
            for q in SCHEMA_DDL:
                s.execute(q)
        assert tn.schema_sync.epoch == jn.schema_sync.epoch == \
            len(SCHEMA_DDL)
        assert tn.schema_sync.entries_after(0) == \
            jn.schema_sync.entries_after(0)
        # the port writes the same epoch log
        with open(jn.schema_sync.path, "rb") as f1, \
                open(tn.schema_sync.path, "rb") as f2:
            assert f2.read() == f1.read()
        jcms = jn.schema_sync.cms.log
        jrecs = _replayed(jcms)
        assert len(jrecs) >= 3 * len(SCHEMA_DDL)
    finally:
        jn.shutdown()
        tn.shutdown()
    # the JAX package's logs, read back by the port
    tl = t_paxos.PaxosLog(os.path.join(str(tmp_path / "j"), "cms_paxos"))
    assert _replayed(tl) == jrecs
    other = tmp_path / "copy"
    os.makedirs(other)
    shutil.copy(jn.schema_sync.path, other / "schema_log.jsonl")
    tn2 = single_node(TNode, TSync, t_ring, TTransport, TSchema,
                      str(other), engine_opts={"device": "cpu"})
    try:
        assert tn2.schema_sync.epoch == len(SCHEMA_DDL)
        with open(jn.schema_sync.path) as f:
            lines = f.read().splitlines()
        assert [e[1] for e in tn2.schema_sync.entries_after(0)] == \
            [json.loads(x)["query"] for x in lines]
    finally:
        tn2.shutdown()
