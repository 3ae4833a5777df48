"""The CQL read path of the PyTorch/CUDA port (`Session` over
`StorageEngine(device="cpu")`) against the JAX package's, on the
fixture of scripts/check_scan_ab.py: three flushes and a memtable tail
with deletions at every scope, expired TTL cells, statics, text
prefixes, doubles, booleans and IN lists. Every query's rows and
aggregates must be identical to the JAX package's materializing scan,
with the scan kernels (K9, here their plain PyTorch versions) on and
off. The vector search (K10) query of
tests/test_sai_indexes.py::test_vector_index_persists must agree too."""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest

from cassandra_tpu.cql import Session as JSession
from cassandra_tpu.schema import Schema as JSchema
from cassandra_tpu.storage.engine import StorageEngine as JEngine

from cassandra_tpu_torch.cql import Session as TSession
from cassandra_tpu_torch.ops import cuda_lib
from cassandra_tpu_torch.ops import device_scan as tds
from cassandra_tpu_torch.schema import Schema as TSchema
from cassandra_tpu_torch.service.metrics import GLOBAL as TMETRICS
from cassandra_tpu_torch.storage.engine import StorageEngine as TEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "check_scan_ab", os.path.join(REPO, "scripts", "check_scan_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


AB = _script()


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both packages' engines over the same fixture (built once)."""
    root = tmp_path_factory.mktemp("cql")
    je = JEngine(str(root / "jax"), JSchema(), commitlog_sync="batch")
    te = TEngine(str(root / "torch"), TSchema(), commitlog_sync="batch",
                 device="cpu")
    js, ts = JSession(je), TSession(te)
    for s in (js, ts):
        AB._build(s)
    for s, e in ((js, je), (ts, te)):
        AB._workload(s, e)
    yield (je, js), (te, ts)
    je.close()
    te.close()


def _port_leg(te, ts, device_filter: bool) -> list:
    te.settings.set("scan_device_filter", device_filter)
    try:
        return [(q, sorted(map(repr, ts.execute(q).rows)))
                for q in AB._queries()]
    finally:
        te.settings.set("scan_device_filter", True)


def test_engine_device_reaches_stores_and_indexes(engines):
    from cassandra_tpu_torch.compaction.task import CompactionTask
    _j, (te, _ts) = engines
    assert te.device.type == "cpu"
    cfs = te.store("ab", "t")
    assert cfs.device == te.device
    assert te.indexes.device == te.device
    # a device-engine compaction of the store runs on the store's device
    assert CompactionTask(cfs, [], engine="device").device == te.device


def test_scan_queries_match_jax(engines):
    (je, js), (te, ts) = engines
    assert len(te.store("ab", "t").live_sstables()) >= 3
    naive = AB._run_leg(js, je, "naive")
    assert naive == AB._run_leg(js, je, "device")
    c = TMETRICS.counter
    before = {k: c(k) for k in ("scan.device_segments",
                                "scan.host_segments", "scan.fallback",
                                "scan.agg_pushdown")}
    launches = cuda_lib.launches()
    on = _port_leg(te, ts, True)
    mid = {k: c(k) for k in before}
    off = _port_leg(te, ts, False)
    after = {k: c(k) for k in before}
    for (q, want), (q1, got_on), (q2, got_off) in zip(naive, on, off):
        assert q == q1 == q2
        assert got_on == want, q
        assert got_off == want, q
    # the K9 leg ran with the knob on, the numpy mask with it off, and
    # every query went through the pushdown (no fallback)
    assert mid["scan.device_segments"] > before["scan.device_segments"]
    assert mid["scan.host_segments"] == before["scan.host_segments"]
    assert after["scan.host_segments"] > mid["scan.host_segments"]
    assert after["scan.device_segments"] == mid["scan.device_segments"]
    assert after["scan.fallback"] == before["scan.fallback"]
    assert after["scan.agg_pushdown"] == before["scan.agg_pushdown"] + 6
    # the CPU runs the plain versions: no kernel launch is counted
    assert cuda_lib.launches() == launches


@pytest.mark.parametrize("query", [
    "SELECT k, c, v FROM t WHERE v < 5 ALLOW FILTERING",
    "SELECT count(*), min(v), max(v) FROM t WHERE v > 3 ALLOW FILTERING",
])
def test_k9_failure_reaches_the_caller(engines, monkeypatch, query):
    """A failing K9 launch surfaces from Session.execute: the executor
    does not answer the query with its row scan instead."""
    _j, (_te, ts) = engines

    def broken(*_a, **_k):
        raise RuntimeError("CUDA kernel ctpu_scan_mask failed: cudaError 700")

    monkeypatch.setattr(tds, "scan_mask", broken)
    f0 = TMETRICS.counter("scan.fallback")
    with pytest.raises(RuntimeError, match="cudaError 700"):
        ts.execute(query)
    assert TMETRICS.counter("scan.fallback") == f0


def test_unkeyable_column_still_counts_its_fallback(engines):
    """varint has no scan-key kind: the row scan answers, counted."""
    (je, js), (te, ts) = engines
    out = []
    for s, e in ((js, je), (ts, te)):
        s.execute("CREATE TABLE pf (k int PRIMARY KEY, v int, w varint)")
        for i in range(20):
            s.execute(f"INSERT INTO pf (k, v, w) VALUES ({i}, {i}, {i})")
        e.store("ab", "pf").flush()
        out.append(sorted(s.execute(
            "SELECT k FROM pf WHERE v < 5 ALLOW FILTERING").rows))
    f0 = TMETRICS.counter("scan.fallback")
    assert sorted(ts.execute(
        "SELECT k FROM pf WHERE w = 7 ALLOW FILTERING").rows) == \
        sorted(js.execute("SELECT k FROM pf WHERE w = 7 ALLOW FILTERING")
               .rows) == [(7,)]
    assert TMETRICS.counter("scan.fallback") == f0 + 1
    assert out[0] == out[1] == [(i,) for i in range(5)]


def _vector_flow(engine_cls, schema_cls, session_cls, data_dir, **kw):
    """test_vector_index_persists: write, flush, close, reopen, query."""
    eng = engine_cls(data_dir, schema_cls(), commitlog_sync="batch", **kw)
    s = session_cls(eng)
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{'class': 'SimpleStrategy', 'replication_factor': 1}")
    s.execute("USE ks")
    s.execute("CREATE TABLE emb (id int PRIMARY KEY, v vector<float, 4>)")
    s.execute("CREATE CUSTOM INDEX ON emb (v) USING 'SAI'")
    rng = np.random.default_rng(11)
    for i in range(6):
        vec = [float(i), 0.0, 0.0, 1.0]
        s.execute(f"INSERT INTO emb (id, v) VALUES ({i}, {vec})")
    for i in range(6, 40):
        vec = [round(float(x), 3) for x in rng.standard_normal(4)]
        s.execute(f"INSERT INTO emb (id, v) VALUES ({i}, {vec})")
    eng.store("ks", "emb").flush()
    s.execute("INSERT INTO emb (id, v) VALUES (40, [4.9, 0.1, 0.0, 1.0])")
    eng.close()
    eng2 = engine_cls(data_dir, schema_cls(), commitlog_sync="batch", **kw)
    s2 = session_cls(eng2)
    s2.execute("USE ks")
    out = [s2.execute("SELECT id FROM emb ORDER BY v ANN OF "
                      "[5.0, 0.0, 0.0, 1.0] LIMIT 2").rows,
           s2.execute("SELECT id, v FROM emb ORDER BY v ANN OF "
                      "[0.5, -1.0, 0.25, 2.0] LIMIT 7").rows,
           s2.execute("SELECT id FROM emb ORDER BY v ANN OF "
                      "[5.0, 0.0, 0.0, 1.0] LIMIT 0").rows]
    idx = eng2.indexes.get("ks", "emb", "v")
    q = np.array([0.3, 0.2, -0.7, 1.1], dtype=np.float32)
    direct = {sim: idx.ann(q, 9, sim) for sim in ("dot", "euclidean")}
    eng2.close()
    return out, direct


def test_vector_search_matches_jax(tmp_path):
    jout, jdirect = _vector_flow(JEngine, JSchema, JSession,
                                 str(tmp_path / "jax"))
    tout, tdirect = _vector_flow(TEngine, TSchema, TSession,
                                 str(tmp_path / "torch"), device="cpu")
    assert jout[0][0][0] == tout[0][0][0] == 5
    assert tout[2] == []                    # LIMIT 0: no row
    assert tout == jout
    for sim, want in jdirect.items():
        got = tdirect[sim]
        assert [g[:2] for g in got] == [w[:2] for w in want], sim
        np.testing.assert_allclose([g[2] for g in got],
                                   [w[2] for w in want], rtol=1e-5,
                                   atol=1e-5)
