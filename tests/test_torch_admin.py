"""The port's snapshot, audit and nodetool modules on its engine
(StorageEngine(device="cpu")) against the JAX package's engine on the
same writes: system_views.thread_pools and system_views.snapshots, the
audit log, the engine-level nodetool commands, and `nodetool compact`'s
output sstables (sha256 of every component). Without these modules the
port's engine raised ModuleNotFoundError on each of them."""
from __future__ import annotations

import hashlib
import json
import os
import time

import pytest

from cassandra_tpu.cql import Session as JSession
from cassandra_tpu.schema import Schema as JSchema
from cassandra_tpu.storage.engine import StorageEngine as JEngine
from cassandra_tpu.tools import nodetool as jtool
from cassandra_tpu.utils import timeutil as j_timeutil

from cassandra_tpu_torch.cql import Session as TSession
from cassandra_tpu_torch.schema import Schema as TSchema
from cassandra_tpu_torch.storage.engine import StorageEngine as TEngine
from cassandra_tpu_torch.tools import nodetool as ttool
from cassandra_tpu_torch.utils import timeutil as t_timeutil
from torch_tmp import tmp_path  # noqa: F401

FROZEN = 1_790_000_000.25

# a keyspace of its own: the per-table histograms (sstables per read)
# live in each package's process-wide metrics registry, which other
# test files running in this process feed under their table names
SETUP = [
    "CREATE KEYSPACE adm WITH replication = {'class': 'SimpleStrategy', "
    "'replication_factor': 1}",
    "USE adm",
    # explicit ids: Statistics.db records the table id
    "CREATE TABLE t (k int, c int, v text, PRIMARY KEY (k, c)) WITH id = "
    "5d3c9a60-0000-4000-8000-000000000001",
    "CREATE TABLE u (k int PRIMARY KEY, n int) WITH id = "
    "5d3c9a60-0000-4000-8000-000000000002",
]


def _writes(run: int) -> list:
    out = []
    for i in range(40):
        out.append((f"INSERT INTO t (k, c, v) VALUES (?, ?, ?) USING "
                    f"TIMESTAMP {1000 + run * 100 + i}",
                    [i % 5, i % 13, f"v{run}-{i}"]))
    out.append((f"DELETE FROM t USING TIMESTAMP {1050 + run * 100} "
                "WHERE k = ? AND c = ?", [1, run + 1]))
    for i in range(10):
        out.append((f"INSERT INTO u (k, n) VALUES (?, ?) USING TIMESTAMP "
                    f"{2000 + run}", [i, i * run]))
    return out


def _drive(eng, session_cls):
    s = session_cls(eng)
    for q in SETUP:
        s.execute(q)
    for run in range(3):
        for q, params in _writes(run):
            s.execute(q, params)
        for name in ("t", "u"):
            eng.store("adm", name).flush()
    s.execute("SELECT * FROM t WHERE k = ?", [1])
    return s


@pytest.fixture
def frozen(monkeypatch):
    """Wall-clock reads (deletion times, snapshot manifests, scrub's
    snapshot tag, audit stamps) return one instant in both packages."""
    monkeypatch.setattr(time, "time", lambda: FROZEN)
    for mod in (j_timeutil, t_timeutil):
        monkeypatch.setattr(mod, "CLOCK", lambda: FROZEN)


@pytest.fixture
def engines(tmp_path, frozen):
    jeng = JEngine(str(tmp_path / "jax"), JSchema(), commitlog_sync="batch",
                   audit_log_path=str(tmp_path / "jax-audit.jsonl"))
    teng = TEngine(str(tmp_path / "port"), TSchema(), commitlog_sync="batch",
                   device="cpu",
                   audit_log_path=str(tmp_path / "port-audit.jsonl"))
    js, ts = _drive(jeng, JSession), _drive(teng, TSession)
    yield (jeng, js, jtool), (teng, ts, ttool)
    jeng.close()
    teng.close()


def _table_files(cfs) -> dict:
    out = {}
    for fn in sorted(os.listdir(cfs.directory)):
        p = os.path.join(cfs.directory, fn)
        if os.path.isfile(p):
            with open(p, "rb") as f:
                out[fn] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_flushed_sstables_equal(engines):
    (jeng, _js, _jt), (teng, _ts, _tt) = engines
    for name in ("t", "u"):
        a = _table_files(jeng.store("adm", name))
        assert a and _table_files(teng.store("adm", name)) == a


def test_thread_pools_vtable_matches_jax(engines):
    (_je, js, _jt), (_te, ts, _tt) = engines
    q = "SELECT * FROM system_views.thread_pools"
    rows = ts.execute(q).rows
    assert rows and rows == js.execute(q).rows


def test_snapshots_vtable_matches_jax(engines):
    (jeng, js, jt), (teng, ts, tt) = engines
    q = "SELECT * FROM system_views.snapshots"
    assert ts.execute(q).rows == js.execute(q).rows == []
    for eng, tool in ((jeng, jt), (teng, tt)):
        tool.run_command("snapshot", engine=eng, tag="snap1")
        tool.run_command("snapshot", engine=eng, tag="snap2",
                         keyspace="adm", table="u")
    rows = ts.execute(q).rows
    assert len(rows) == 3 and rows == js.execute(q).rows


def test_audit_log_matches_jax(engines, tmp_path):
    (jeng, _js, _jt), (teng, _ts, _tt) = engines

    def entries(name):
        with open(tmp_path / name) as f:
            recs = [json.loads(line) for line in f]
        assert all(r["ts_ms"] == int(FROZEN * 1000) for r in recs)
        return recs

    port = entries("port-audit.jsonl")
    assert port == entries("jax-audit.jsonl")
    assert {r["category"] for r in port} == {"DDL", "DML", "OTHER", "QUERY"}
    assert len(port) == len(SETUP) + 3 * len(_writes(0)) + 1


# (command, kwargs): the engine-level commands whose results carry no
# wall-clock duration
COMMANDS = [
    ("tpstats", {}),
    ("tablestats", {}),
    ("snapshot", {"tag": "s1"}),
    ("listsnapshots", {}),
    ("clearsnapshot", {"tag": "s1"}),
    ("scrub", {}),
    ("upgradesstables", {}),
    ("verify", {}),
]


@pytest.mark.parametrize("cmd,kw", COMMANDS, ids=[c for c, _ in COMMANDS])
def test_nodetool_command_matches_jax(engines, cmd, kw):
    (jeng, _js, jt), (teng, _ts, tt) = engines
    if cmd in ("listsnapshots", "clearsnapshot"):
        for eng, tool in ((jeng, jt), (teng, tt)):
            tool.run_command("snapshot", engine=eng, tag="s1")
    got = tt.run_command(cmd, engine=teng, **kw)
    want = jt.run_command(cmd, engine=jeng, **kw)
    assert got == want
    assert got not in ([], {}, 0, None)
    for name in ("t", "u"):
        assert _table_files(teng.store("adm", name)) \
            == _table_files(jeng.store("adm", name))


def test_nodetool_compact_sstables_sha256_equal(engines):
    (jeng, js, jt), (teng, ts, tt) = engines
    timing = ("seconds", "read_mib_s", "write_mib_s")
    got = tt.run_command("compact", engine=teng)
    want = jt.run_command("compact", engine=jeng)
    assert [{k: v for k, v in r.items() if k not in timing} for r in got] \
        == [{k: v for k, v in r.items() if k not in timing} for r in want]
    assert len(got) == 2 and all(r["inputs"] == 3 for r in got)
    for name in ("t", "u"):
        files = _table_files(teng.store("adm", name))
        assert files == _table_files(jeng.store("adm", name))
        assert sum(fn.endswith("Data.db") for fn in files) == 1
    q = "SELECT * FROM t"
    assert ts.execute(q).rows == js.execute(q).rows


def _bulkload(pkg, base: str) -> dict:
    """tests/test_bulkload.py's scenario in one package: offline sstables
    written by the package's SSTableWriter, `nodetool bulkload` through
    node 1 of a 3-node RF 2 cluster; the load's answer and each node's
    own cells."""
    import numpy as np
    cluster = pkg["LocalCluster"](3, os.path.join(base, "cluster"))
    try:
        s = cluster.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = {'class': "
                  "'SimpleStrategy', 'replication_factor': 2}")
        s.execute("CREATE TABLE ks.t (id int, c int, v text, "
                  "PRIMARY KEY (id, c)) WITH id = "
                  "5d3c9a60-0000-4000-8000-000000000003")
        table = cluster.node(1).schema.get_table("ks", "t")
        rng = np.random.default_rng(3)
        n = 500
        batch = pkg["cb"].merge_sorted([pkg["bulk"].build_int_batch(
            table, rng.integers(0, 64, n), rng.integers(0, 1000, n),
            rng.integers(97, 122, (n, 8), dtype=np.uint8),
            rng.integers(1, 1 << 30, n).astype(np.int64))])
        outdir = os.path.join(base, "external")
        os.makedirs(outdir)
        sst = pkg["sst"]
        for gen, (a, b) in enumerate(((0, len(batch) // 2),
                                      (len(batch) // 2, len(batch))), 1):
            w = sst.SSTableWriter(sst.Descriptor(outdir, gen), table)
            w.append(batch.slice_range(a, b))
            w.finish()
        out = pkg["tool"].run_command("bulkload", node=cluster.node(1),
                                      directory=outdir, keyspace="ks",
                                      table="t")
        cells = []
        for nd in cluster.nodes:
            b = nd.engine.store("ks", "t").scan_all()
            cells.append({k: np.asarray(getattr(b, k)).tobytes()
                          for k in ("lanes", "ts", "ttl", "flags", "off",
                                    "payload")})
        return {"out": out, "cells": cells, "batch": len(batch)}
    finally:
        cluster.shutdown()


def test_nodetool_bulkload_equals_jax(tmp_path):
    """`nodetool bulkload` (tools/sstableloader.py, ported with the
    networked stack) streams an offline directory to every replica: the
    same answer and the same cells on every node as the JAX package's.
    (Until then the command failed at the sstableloader import.)"""
    from cassandra_tpu.cluster.node import LocalCluster as JCluster
    from cassandra_tpu.storage import cellbatch as j_cb
    from cassandra_tpu.storage import sstable as j_sst
    from cassandra_tpu.tools import bulk as j_bulk

    from cassandra_tpu_torch.cluster.node import LocalCluster as TCluster
    from cassandra_tpu_torch.storage import cellbatch as t_cb
    from cassandra_tpu_torch.storage import sstable as t_sst
    from cassandra_tpu_torch.tools import bulk as t_bulk

    j = _bulkload({"LocalCluster": lambda n, d: JCluster(n, d, rf=2),
                   "cb": j_cb, "sst": j_sst, "bulk": j_bulk,
                   "tool": jtool}, str(tmp_path / "jax"))
    t = _bulkload({"LocalCluster": lambda n, d: TCluster(n, d, rf=2,
                                                         device="cpu"),
                   "cb": t_cb, "sst": t_sst, "bulk": t_bulk,
                   "tool": ttool}, str(tmp_path / "port"))
    assert t["out"] == j["out"]
    assert t["out"]["sstables"] == 2 and t["out"]["cells"] == t["batch"]
    assert t["cells"] == j["cells"]
    # RF 2 on three nodes: every cell on two of them
    assert sum(len(c["ts"]) for c in t["cells"]) == 2 * 8 * t["batch"]


def test_device_programs_cost_columns(tmp_path):
    """system_views.device_programs reports each launched kernel's least
    work at its most recent new shape (ops/costs.py): K1 and K6 here,
    through their wrappers on the CPU, at shapes no other test uses."""
    from chip_smoke import make_fast_round, make_round

    from cassandra_tpu_torch.ops import costs
    from cassandra_tpu_torch.ops import merge as tmerge
    N, K = 1031, 11
    ops = tmerge.operands_to_device(make_round(3, 1000, N, K), "cpu")
    tmerge.device_sort_perm(ops)
    buf, cfg = make_fast_round(3, 2000, 3072, k=5)
    tmerge.plane_program_fast(tmerge.planes_to_device(buf, "cpu"), cfg)
    eng = TEngine(str(tmp_path / "port"), TSchema(), device="cpu")
    try:
        rows = {name: (nbytes, flops) for name, nbytes, flops in
                TSession(eng).execute(
                    "SELECT name, cost_bytes, cost_flops FROM "
                    "system_views.device_programs").rows}
    finally:
        eng.close()
    want = {"merge.sort_perm": costs.sort_perm(N, K),
            "merge.plane_fast": costs.plane_fast(buf.size, 3072)}
    for name, (nbytes, flops) in want.items():
        assert rows[name] == (nbytes, flops), name
        assert nbytes > 0


@pytest.mark.cuda
def test_pooled_events_time_every_call():
    """The profiling registry's timing events come from a pool per
    device: on the card, every call of a wrapped kernel still adds its
    interval (device_calls == calls) and device_s grows. Needs a card;
    the test imports no jax, so it also runs on a machine without one:

        python -m pytest --noconftest tests/test_torch_admin.py -m cuda
    """
    import numpy as np
    import torch

    from cassandra_tpu_torch.ops import device_scan as ds
    from cassandra_tpu_torch.service import profiling
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the timing events are CUDA's")
    keys = ds.keys_tensor(np.arange(70_000, dtype=np.uint64), "cuda")
    q = np.array([5], np.uint64)
    calls = 3 * profiling.DRAIN_EVERY + 7

    def row():
        return profiling.GLOBAL.snapshot()["kernels"].get(
            "scan.mask", {"calls": 0, "device_calls": 0, "device_s": 0.0})

    torch.cuda.synchronize()
    before = row()
    for _ in range(calls):
        ds.scan_mask(keys, "lt", q)
    torch.cuda.synchronize()
    after = row()
    assert after["calls"] - before["calls"] == calls
    assert after["device_calls"] - before["device_calls"] == calls
    assert after["device_s"] > before["device_s"]
