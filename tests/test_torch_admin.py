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


def test_nodetool_unported_module_raises(engines):
    """A command whose module the port does not have yet (copyutil)
    fails at that import; nothing answers in its place."""
    _j, (teng, _ts, tt) = engines
    with pytest.raises(ImportError, match="copyutil"):
        tt.run_command("getsstables", engine=teng, keyspace="adm",
                       table="t", key="1")
