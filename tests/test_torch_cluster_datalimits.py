"""The port's counterpart of tests/test_datalimits.py: the same assertions on
cassandra_tpu_torch, every engine on the CPU (device="cpu").

DataLimits pushdown + short-read protection.

Replicas truncate reads at the pushed row limit (cells up to the
limit-th live row ship; the rest stays home — db/filter/DataLimits.java:44),
so LIMIT 1 on a huge partition moves bytes proportional to the LIMIT.
Because each replica truncates on its own view, one replica's tombstones
can shadow another's contributions and leave the merged result short:
the coordinator re-queries with doubled limits until the target count is
met or no replica was truncated
(service/reads/ShortReadPartitionsProtection.java:40).
"""
import numpy as np
import pytest

from cassandra_tpu_torch.cluster.messaging import Verb
from cassandra_tpu_torch.cluster.node import LocalCluster
from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
from cassandra_tpu_torch.storage.cellbatch import (CellBatchBuilder,
                                                   DataLimits, live_row_count,
                                                   merge_sorted,
                                                   truncate_live_rows)
from cassandra_tpu_torch.schema import COL_REGULAR_BASE, make_table
from torch_tmp import tmp_path  # noqa: F401


# ------------------------------------------------------------- unit ----

def _mk_table():
    return make_table("ks", "t", pk=["k"], ck=["c"],
                      cols={"k": "int", "c": "int", "v": "text"})


def _batch(table, rows, pk_val=1, dead=()):
    """rows: list of c values; dead: subset emitted as tombstones."""
    b = CellBatchBuilder(table)
    pk = table.columns["k"].cql_type.serialize(pk_val)
    for c in rows:
        ck = table.serialize_clustering([c])
        if c in dead:
            b.add_tombstone(pk, ck, COL_REGULAR_BASE, ts=2, ldt=100)
        else:
            b.add_cell(pk, ck, COL_REGULAR_BASE, f"v{c}".encode(), ts=1)
    return merge_sorted([b.seal()])


def test_truncate_counts_live_rows_only():
    t = _mk_table()
    batch = _batch(t, rows=[1, 2, 3, 4, 5, 6], dead=(1, 2, 3))
    # 3 dead rows first, then live 4,5,6: limit 2 must keep the dead
    # prefix (merge needs those tombstones) plus live rows 4 and 5
    out, more = truncate_live_rows(batch, DataLimits(row_limit=2))
    assert more
    assert live_row_count(out) == 2
    # tombstones before the cutoff survived
    from cassandra_tpu_torch.storage.cellbatch import DEATH_FLAGS
    assert int(((out.flags & DEATH_FLAGS) != 0).sum()) == 3
    # no truncation when the partition has fewer live rows than asked
    out2, more2 = truncate_live_rows(batch, DataLimits(row_limit=10))
    assert not more2 and len(out2) == len(batch)


def test_truncate_per_partition():
    t = _mk_table()
    b1 = _batch(t, rows=[1, 2, 3], pk_val=1)
    b2 = _batch(t, rows=[1, 2, 3], pk_val=2)
    cat = merge_sorted([b1, b2])
    out, more = truncate_live_rows(cat, DataLimits(per_partition=1))
    assert more and live_row_count(out) == 2   # one row from EACH pk


# ------------------------------------------------------- distributed ----

@pytest.fixture
def cluster(tmp_path):
    c = LocalCluster(2, str(tmp_path), rf=2, device="cpu")
    for n in c.nodes:
        n.proxy.timeout = 2.0
    s = c.session(1)
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 2}")
    s.execute("USE ks")
    yield c
    c.shutdown()


def _payload_cells(msg):
    """Cell count inside a limited READ_RSP/RANGE_RSP data payload
    (digests and unlimited responses return 0)."""
    p = msg.payload
    if isinstance(p, tuple) and isinstance(p[0], dict):
        return len(p[0]["ts"])
    return 0


def test_limit_bounds_bytes_on_the_wire(cluster):
    """LIMIT 2 over a 200-row partition: every replica data response
    carries cells for at most LIMIT(+static pad) rows, never the whole
    partition."""
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("CREATE TABLE big (k int, c int, v text, "
              "PRIMARY KEY (k, c))")
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ALL
    for c_ in range(200):
        s.execute(f"INSERT INTO big (k, c, v) VALUES (1, {c_}, 'v{c_}')")
    # one row misses node2: the digest mismatch forces a full-data round,
    # so node2 must ship an actual (limited) data response over the wire
    victim = cluster.nodes[1].endpoint
    rule = cluster.filters.drop(verb=Verb.MUTATION_REQ, to=victim)
    n1.default_cl = ConsistencyLevel.ONE
    s.execute("INSERT INTO big (k, c, v) VALUES (1, 0, 'v0')")
    rule["remaining"] = 0
    shipped = []
    cluster.filters.intercept(
        lambda m: shipped.append(_payload_cells(m))
        if m.verb == Verb.READ_RSP else None)
    n1.default_cl = ConsistencyLevel.QUORUM
    rows = s.execute("SELECT c, v FROM big WHERE k = 1 LIMIT 2").rows
    assert rows == [(0, "v0"), (1, "v1")]
    data_sizes = [n for n in shipped if n > 0]
    assert data_sizes, "expected at least one remote data response"
    # 2 cells per CQL row (value + row liveness); the unlimited
    # partition would ship ~400 cells
    assert max(data_sizes) <= 2 * 2, data_sizes
    cluster.filters.clear()


def test_short_read_protection_recovers_shadowed_rows(cluster):
    """node1 holds only tombstones for rows 0..7 (8 dead rows, 1 live);
    node2 holds rows 0..9 live. A QUORUM LIMIT 3 initially merges too
    few live rows (node2's contribution is truncated at 3, all shadowed)
    — short-read re-query with doubled limits must converge on the true
    survivors 8, 9."""
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("CREATE TABLE sr (k int, c int, v text, "
              "PRIMARY KEY (k, c))")
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ALL
    for c_ in range(10):
        s.execute(f"INSERT INTO sr (k, c, v) VALUES (1, {c_}, 'v{c_}')")
    # deletions of rows 0..7 reach only node1
    victim = cluster.nodes[1].endpoint
    rule = cluster.filters.drop(verb=Verb.MUTATION_REQ, to=victim)
    n1.default_cl = ConsistencyLevel.ONE
    for c_ in range(8):
        s.execute(f"DELETE FROM sr WHERE k = 1 AND c = {c_}")
    rule["remaining"] = 0
    from cassandra_tpu_torch.service.metrics import GLOBAL
    before = GLOBAL.counter("reads.short_read_retries")
    n1.default_cl = ConsistencyLevel.QUORUM
    rows = s.execute("SELECT c, v FROM sr WHERE k = 1 LIMIT 3").rows
    assert rows == [(8, "v8"), (9, "v9")]
    assert GLOBAL.counter("reads.short_read_retries") > before


def test_short_read_no_resurrection_past_truncation(cluster):
    """A truncated replica vouches only for rows up to its LAST shipped
    row: a stale live row contributed by the OTHER replica beyond that
    frontier must not satisfy the limit (the shadowing tombstone sits
    in the truncated tail). node1: tombstone c=1 (newer) + live 1..4;
    node2: tombstone c=3 (newer) + live 1..4. Truth: survivors 2, 4.
    A frontier-blind stop condition returns (2, 3-stale)."""
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("CREATE TABLE rz (k int, c int, v text, "
              "PRIMARY KEY (k, c))")
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ALL
    for c_ in range(1, 5):
        s.execute(f"INSERT INTO rz (k, c, v) VALUES (1, {c_}, 'v{c_}') "
                  f"USING TIMESTAMP 10")
    n1.default_cl = ConsistencyLevel.ONE
    # DELETE c=1 lands only on node1 (the coordinator itself)
    rule = cluster.filters.drop(verb=Verb.MUTATION_REQ,
                                to=cluster.nodes[1].endpoint)
    s.execute("DELETE FROM rz USING TIMESTAMP 20 WHERE k = 1 AND c = 1")
    rule["remaining"] = 0
    # DELETE c=3 lands only on node2
    s2 = cluster.session(2)
    s2.keyspace = "ks"
    rule = cluster.filters.drop(verb=Verb.MUTATION_REQ,
                                to=cluster.nodes[0].endpoint)
    cluster.node(2).default_cl = ConsistencyLevel.ONE
    s2.execute("DELETE FROM rz USING TIMESTAMP 20 WHERE k = 1 AND c = 3")
    rule["remaining"] = 0
    n1.default_cl = ConsistencyLevel.QUORUM
    rows = s.execute("SELECT c, v FROM rz WHERE k = 1 LIMIT 2").rows
    assert rows == [(2, "v2"), (4, "v4")], rows


def test_per_partition_limit_pushdown_multi_pk(cluster):
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("CREATE TABLE pp (k int, c int, v text, "
              "PRIMARY KEY (k, c))")
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ALL
    for k in (1, 2):
        for c_ in range(50):
            s.execute(f"INSERT INTO pp (k, c, v) VALUES ({k}, {c_}, 'x')")
    # diverge one row so the digest mismatch forces remote DATA responses
    victim = cluster.nodes[1].endpoint
    rule = cluster.filters.drop(verb=Verb.MUTATION_REQ, to=victim)
    n1.default_cl = ConsistencyLevel.ONE
    s.execute("INSERT INTO pp (k, c, v) VALUES (1, 0, 'x')")
    s.execute("INSERT INTO pp (k, c, v) VALUES (2, 0, 'x')")
    rule["remaining"] = 0
    shipped = []
    cluster.filters.intercept(
        lambda m: shipped.append(_payload_cells(m))
        if m.verb == Verb.READ_RSP else None)
    n1.default_cl = ConsistencyLevel.QUORUM
    rows = s.execute("SELECT k, c FROM pp WHERE k IN (1, 2) "
                     "PER PARTITION LIMIT 2").rows
    assert sorted(rows) == [(1, 0), (1, 1), (2, 0), (2, 1)]
    data_sizes = [n for n in shipped if n > 0]
    # 2 partitions x PER PARTITION LIMIT 2 rows x 2 cells/row; the
    # unlimited read would ship ~200 cells
    assert data_sizes and max(data_sizes) <= 2 * 2 * 2, data_sizes
    cluster.filters.clear()


def test_pushdown_skipped_when_filters_present(cluster):
    """A non-key filter means fetched rows aren't result rows: the limit
    must NOT be pushed (the replica would count rows the filter later
    drops)."""
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("CREATE TABLE f (k int, c int, v int, "
              "PRIMARY KEY (k, c))")
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ALL
    for c_ in range(20):
        s.execute(f"INSERT INTO f (k, c, v) VALUES (1, {c_}, {c_ % 2})")
    n1.default_cl = ConsistencyLevel.QUORUM
    rows = s.execute("SELECT c FROM f WHERE k = 1 AND v = 1 LIMIT 3 "
                     "ALLOW FILTERING").rows
    assert rows == [(1,), (3,), (5,)]


def test_range_scan_limit_bounds_bytes(cluster):
    """SELECT ... LIMIT n over a full scan: each arc's replicas truncate
    at the pushed limit, so RANGE responses are bounded by the LIMIT,
    not the arc (DataLimits over RangeCommands)."""
    s = cluster.session(1)
    s.keyspace = "ks"
    s.execute("CREATE TABLE rng (k int, c int, v text, "
              "PRIMARY KEY (k, c))")
    n1 = cluster.node(1)
    n1.default_cl = ConsistencyLevel.ALL
    for k in range(50):
        for c_ in range(10):
            s.execute(f"INSERT INTO rng (k, c, v) VALUES ({k}, {c_}, "
                      f"'v{k}x{c_}')")
    shipped = []
    cluster.filters.intercept(
        lambda m: shipped.append(_payload_cells(m))
        if m.verb == Verb.RANGE_RSP else None)
    n1.default_cl = ConsistencyLevel.ONE
    rows = s.execute("SELECT k, c FROM rng LIMIT 4").rows
    assert len(rows) == 4
    data_sizes = [n for n in shipped if n > 0]
    # 2 cells per row; without pushdown a window ships its whole arc
    # (hundreds of cells)
    if data_sizes:       # remote arcs only exist when node2 owns some
        assert max(data_sizes) <= 4 * 2, data_sizes
    cluster.filters.clear()
    # correctness at QUORUM with divergent tombstones (range SRP)
    victim = cluster.nodes[1].endpoint
    rule = cluster.filters.drop(verb=Verb.MUTATION_REQ, to=victim)
    for c_ in range(10):
        s.execute(f"DELETE FROM rng WHERE k = 7 AND c = {c_}")
    rule["remaining"] = 0
    n1.default_cl = ConsistencyLevel.QUORUM
    rows = s.execute("SELECT k, c FROM rng LIMIT 200").rows
    ks = {r[0] for r in rows}
    assert 7 not in ks and len(rows) == 200
