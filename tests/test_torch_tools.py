"""The port's single-node tools (utils/merkle, tools/copyutil, cqlsh,
sstabletools, stress, harry) against the JAX package's on the same
seeded inputs, on the CPU (StorageEngine(device="cpu")), with exact
comparisons: digests, CSV bytes, transcripts, tool outputs and sstable
bytes. Clocks are frozen (time.time, time.time_ns, timeutil.CLOCK) so
both engines stamp the same writes with the same timestamps."""
from __future__ import annotations

import hashlib
import io
import os
import random
import time

import pytest
import torch

from cassandra_tpu.compaction.task import CompactionTask as JTask
from cassandra_tpu.cql import Session as JSession
from cassandra_tpu.schema import Schema as JSchema
from cassandra_tpu.storage.engine import StorageEngine as JEngine
from cassandra_tpu.tools import copyutil as jcopy
from cassandra_tpu.tools import cqlsh as jcqlsh
from cassandra_tpu.tools import harry as jharry
from cassandra_tpu.tools import nodetool as jnodetool
from cassandra_tpu.tools import sstabletools as jsst
from cassandra_tpu.tools import stress as jstress
from cassandra_tpu.utils import merkle as jmerkle
from cassandra_tpu.utils import timeutil as j_timeutil

from cassandra_tpu_torch.compaction.task import CompactionTask as TTask
from cassandra_tpu_torch.cql import Session as TSession
from cassandra_tpu_torch.schema import Schema as TSchema
from cassandra_tpu_torch.storage.sstable.format import Component
from cassandra_tpu_torch.storage.engine import StorageEngine as TEngine
from cassandra_tpu_torch.tools import copyutil as tcopy
from cassandra_tpu_torch.tools import cqlsh as tcqlsh
from cassandra_tpu_torch.tools import harry as tharry
from cassandra_tpu_torch.tools import nodetool as tnodetool
from cassandra_tpu_torch.tools import sstabletools as tsst
from cassandra_tpu_torch.tools import stress as tstress
from cassandra_tpu_torch.utils import merkle as tmerkle
from cassandra_tpu_torch.utils import timeutil as t_timeutil
from torch_tmp import tmp_path  # noqa: F401

FROZEN = 1_790_000_000.25

JAX = {"name": "jax", "engine": JEngine, "schema": JSchema,
       "session": JSession, "copy": jcopy, "cqlsh": jcqlsh,
       "harry": jharry, "nodetool": jnodetool, "sst": jsst,
       "stress": jstress, "task": JTask, "timeutil": j_timeutil, "kw": {}}
PORT = {"name": "port", "engine": TEngine, "schema": TSchema,
        "session": TSession, "copy": tcopy, "cqlsh": tcqlsh,
        "harry": tharry, "nodetool": tnodetool, "sst": tsst,
        "stress": tstress, "task": TTask, "timeutil": t_timeutil,
        "kw": {"device": "cpu"}}
PKGS = (JAX, PORT)

KS = ("CREATE KEYSPACE ks WITH replication = {'class': 'SimpleStrategy', "
      "'replication_factor': 1}")
# explicit ids: Statistics.db records the table id
SRC_DDL = ("CREATE TABLE src (id int, seq int, name text, score double, "
           "ok boolean, data blob, tags set<text>, nums list<int>, "
           "m map<text, int>, PRIMARY KEY (id, seq)) WITH id = "
           "7a1c0000-0000-4000-8000-000000000001")
STRESS_DDL = (jstress.DDL.replace(" IF NOT EXISTS", "")
              + " WITH id = 7a1c0000-0000-4000-8000-000000000002")


@pytest.fixture
def frozen(monkeypatch):
    """One instant for every wall-clock read in both packages; write
    timestamps (now_micros) then count up from the same start."""
    monkeypatch.setattr(time, "time", lambda: FROZEN)
    monkeypatch.setattr(time, "time_ns", lambda: int(FROZEN * 1e9))
    for p in PKGS:
        monkeypatch.setattr(p["timeutil"], "CLOCK", lambda: FROZEN)


def _restart_micros(p, monkeypatch) -> None:
    monkeypatch.setattr(p["timeutil"], "_last_micros", 0)


def _engine(p, path, **kw):
    return p["engine"](str(path), p["schema"](), commitlog_sync="batch",
                       **p["kw"], **kw)


def _files(directory: str) -> dict:
    out = {}
    for fn in sorted(os.listdir(directory)):
        full = os.path.join(directory, fn)
        if os.path.isfile(full):
            with open(full, "rb") as f:
                out[fn] = hashlib.sha256(f.read()).hexdigest()
    return out


# list elements are keyed by time-based UUIDs (a random clock sequence
# in both packages), so a table whose sstables compare by bytes or by
# size holds no list
NOLIST_DDL = (SRC_DDL.replace("nums list<int>, ", "").replace("src", "nl")
              .replace("0001", "0008"))


def _fill_src(s, table: str = "src") -> None:
    rng = random.Random(5)
    lists = table == "src"
    cols = "id, seq, name, score, ok, data, tags, " + \
        ("nums, m" if lists else "m")
    for i in range(40):
        vals = [i % 6, i, f"n{i}'q" if i % 7 == 0 else f"n{i}",
                i * 1.5, i % 2 == 0, rng.randbytes(5),
                {f"t{i % 3}", "b'q"} if i % 4 else None]
        if lists:
            vals.append([i, 1] if i % 3 else None)
        vals.append({"x": i, "y": -i} if i % 5 else None)
        s.execute(f"INSERT INTO {table} ({cols}) VALUES "
                  f"({', '.join('?' * len(vals))})", tuple(vals))
    s.execute(f"DELETE FROM {table} WHERE id = 1 AND seq = 7")


# --------------------------------------------------------------- merkle --

@pytest.mark.parametrize("depth", [1, 4, 10])
def test_merkle_digests_match_jax(depth):
    rng = random.Random(depth)
    adds = [(rng.randrange(-(1 << 63), 1 << 63),
             rng.randbytes(rng.choice((8, 16, 20)))) for _ in range(300)]
    trees = []
    for mod in (jmerkle, tmerkle):
        a, b = mod.MerkleTree(depth), mod.MerkleTree(depth)
        for i, (tok, dig) in enumerate(adds):
            a.add(tok, dig)
            if i % 37:          # b misses some partitions
                b.add(tok, dig)
        trees.append((a.root(), a.serialize(), a.difference(b),
                      [a.leaf_range(i) for i in range(a.n_leaves)],
                      mod.MerkleTree.deserialize(a.serialize()).root()))
    assert trees[0] == trees[1]
    assert trees[1][2], "the trees must differ somewhere"


# ------------------------------------------------------------- copyutil --

@pytest.mark.parametrize("stmt", [
    "COPY ks.t (a, b) TO '/tmp/x.csv' WITH HEADER = false;",
    "COPY t FROM 'f.csv'",
    "copy ks.t to 'o.csv' with header = 'true' and delimiter = ','",
    "SELECT * FROM t",
])
def test_copy_parse_matches_jax(stmt):
    assert tcopy.parse_copy(stmt) == jcopy.parse_copy(stmt)


def test_copy_to_and_from_match_jax(tmp_path, frozen, monkeypatch):
    """COPY TO writes the same bytes (paged, with collections, quotes
    and blobs); COPY FROM reads them back, scalar tables through one
    prepared statement and collection tables literal by literal, to the
    same rows and, for the scalar table, the same flushed sstables."""
    csvs, rows, files = [], [], []
    for p in PKGS:
        _restart_micros(p, monkeypatch)
        eng = _engine(p, tmp_path / p["name"])
        s = p["session"](eng)
        s.execute(KS)
        s.execute("USE ks")
        s.execute(SRC_DDL)
        _fill_src(s)
        out = str(tmp_path / f"{p['name']}.csv")
        assert p["copy"].copy_to(s, "src", [], out, fetch_size=7) == 39
        scal = str(tmp_path / f"{p['name']}-scalar.csv")
        assert p["copy"].copy_to(s, "ks.src", ["id", "seq", "name", "data"],
                                 scal, header=False, fetch_size=100) == 39
        s.execute(SRC_DDL.replace("src", "dst").replace("0001", "0003"))
        assert p["copy"].copy_from(s, eng.schema, "ks", "dst", [], out) == 39
        s.execute("CREATE TABLE sc (id int, seq int, name text, data blob, "
                  "PRIMARY KEY (id, seq)) WITH id = "
                  "7a1c0000-0000-4000-8000-000000000004")
        assert p["copy"].copy_from(s, eng.schema, "ks", "ks.sc",
                                   ["id", "seq", "name", "data"], scal,
                                   header=False) == 39
        a = sorted(s.execute("SELECT * FROM src").rows)
        assert sorted(s.execute("SELECT * FROM dst").rows) == a
        rows.append((a, sorted(s.execute("SELECT * FROM sc").rows)))
        eng.store("ks", "sc").flush()
        files.append(_files(eng.store("ks", "sc").directory))
        with open(out, "rb") as f1, open(scal, "rb") as f2:
            csvs.append((f1.read(), f2.read()))
        eng.close()
    assert csvs[0] == csvs[1]
    assert rows[0] == rows[1]
    assert files[0] == files[1] and all(files[1])


# --------------------------------------------------------- sstabletools --

def test_sstabletools_match_jax(tmp_path, frozen, monkeypatch):
    out = []
    for p in PKGS:
        _restart_micros(p, monkeypatch)
        eng = _engine(p, tmp_path / p["name"])
        s = p["session"](eng)
        s.execute(KS)
        s.execute("USE ks")
        s.execute(NOLIST_DDL)
        _fill_src(s, "nl")
        eng.store("ks", "nl").flush()
        s.execute("INSERT INTO nl (id, seq, name) VALUES (9, 9, 'late')")
        eng.store("ks", "nl").flush()
        d, sst = eng.data_dir, p["sst"]
        res = {"dump": sst.dump(d, "ks", "nl"),
               "dump1": sst.dump(d, "ks", "nl", generation=1),
               "metadata": sst.metadata(d, "ks", "nl"),
               "verify": sst.verify(d, "ks", "nl")}
        assert [v["status"] for v in res["verify"]] == ["ok", "ok"]
        assert sum(m["cells"] for m in res["metadata"]) > 0
        # one flipped byte in the newest Data.db: verify names it
        cfs = eng.store("ks", "nl")
        newest = max(cfs.live_sstables(), key=lambda r: r.desc.generation)
        path = newest.desc.path(Component.DATA)
        eng.close()
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        res["corrupt"] = sst.verify(d, "ks", "nl")
        assert [v["status"] for v in res["corrupt"]][0] == "ok"
        assert res["corrupt"][1]["status"] != "ok"
        out.append(res)
    assert out[0] == out[1]


# ---------------------------------------------------------------- cqlsh --

def _transcript(p, root, with_auth: bool) -> tuple:
    eng = _engine(p, root / "data", auth_enabled=with_auth)
    s = (p["session"](eng, user="cassandra", password="cassandra")
         if with_auth else p["session"](eng))
    d = str(root)
    stdin = io.StringIO(f"""CREATE KEYSPACE ks WITH replication = {{'class': 'SimpleStrategy', 'replication_factor': 1}};
USE ks;
{SRC_DDL};
INSERT INTO src (id, seq, name, score, ok, data, tags, nums, m) VALUES (1, 1, 'hello', 2.5, true, 0x0102, {{'a', 'b'}}, [3, 1], {{'x': 9}});
INSERT INTO src (id, seq, name) VALUES (1, 2, 'it''s');
INSERT INTO src (id, seq, name)
  VALUES (2, 1, 'two lines');
SELECT * FROM src;
SELECT name FROM src WHERE id = 1;
DESCRIBE keyspaces
DESCRIBE tables
DESCRIBE src
DESC TABLE ks.src
COPY src TO '{d}/out.csv';
COPY ks.src (id, seq, name) TO '{d}/names.csv' WITH HEADER = false;
CREATE TABLE dst (id int, seq int, name text, score double, ok boolean, data blob, tags set<text>, nums list<int>, m map<text, int>, PRIMARY KEY (id, seq));
COPY dst FROM '{d}/out.csv';
SELECT * FROM dst;
COPY nowhere FROM '{d}/missing.csv';
COPY src SIDEWAYS;
CREATE ROLE reader WITH password = 'secret';
GRANT SELECT ON KEYSPACE ks TO reader;
LIST ROLES;
BEGIN BATCH
INSERT INTO src (id, seq, name) VALUES (3, 1, 'b1');
INSERT INTO src (id, seq, name) VALUES (3, 2, 'b2');
APPLY BATCH;
SELECT count(*) FROM src;
BOGUS STATEMENT;
EXIT
""")
    out = io.StringIO()
    p["cqlsh"].repl(s, stdin=stdin, stdout=out)
    with open(root / "out.csv", "rb") as f1, \
            open(root / "names.csv", "rb") as f2:
        csvs = (f1.read(), f2.read())
    eng.close()
    return out.getvalue().replace(d, "<dir>"), csvs


@pytest.mark.parametrize("with_auth", [False, True])
def test_cqlsh_repl_transcripts_match_jax(tmp_path, frozen, monkeypatch,
                                          with_auth):
    got = []
    for p in PKGS:
        _restart_micros(p, monkeypatch)
        root = tmp_path / p["name"]
        root.mkdir()
        got.append(_transcript(p, root, with_auth))
    (jt, jcsv), (tt, tcsv) = got
    assert tt == jt
    assert tcsv == jcsv
    assert "Exported 3 rows to <dir>/out.csv" in tt
    assert "Imported 3 rows from <dir>/out.csv" in tt
    assert "CREATE TABLE ks.src" in tt and "it's" in tt
    assert "ParseError" in tt
    assert "reader" in tt                        # LIST ROLES


def test_cqlsh_format_rows_and_describe_match_jax(tmp_path, frozen,
                                                  monkeypatch):
    got = []
    for p in PKGS:
        _restart_micros(p, monkeypatch)
        eng = _engine(p, tmp_path / p["name"])
        s = p["session"](eng)
        s.execute(KS)
        s.execute("USE ks")
        s.execute(SRC_DDL)
        _fill_src(s)
        rs = s.execute("SELECT * FROM src WHERE id = 2")
        c = p["cqlsh"]
        got.append((c.format_rows(rs), c.format_rows(rs, header=False,
                                                     footer_count=-1),
                    c.describe(s, "ks.src"), c.describe(s, "tables"),
                    c.describe(s, "")))
        eng.close()
    assert got[0] == got[1]


# --------------------------------------------------------------- stress --

def test_stress_matches_jax(tmp_path, frozen, monkeypatch):
    """write / read / mixed give the same results apart from the timings,
    the same rows and, flushed, the same sstable bytes."""
    out = []
    for p in PKGS:
        _restart_micros(p, monkeypatch)
        eng = _engine(p, tmp_path / p["name"])
        s = p["session"](eng)
        st = p["stress"]
        # the tool's own timer ticks (the engine's clock stays frozen)
        ticks = iter(range(1, 1 << 30))
        monkeypatch.setattr(st, "time", type("T", (), {
            "time": staticmethod(lambda: FROZEN + next(ticks))}))
        # the table first, with an id (Statistics.db records it); setup
        # then finds it
        s.execute(KS.replace("ks", "stress"))
        s.execute(STRESS_DDL)
        st.setup(s)
        res = [st.write(s, 300), st.read(s, 120, keys=300),
               st.read(s, 50, keys=600), st.mixed(s, 200)]
        for r in res:
            assert r.pop("seconds") >= 0 and r.pop("ops_s") > 0
        assert res[1]["hits"] == 120 and res[2]["hits"] < 50
        rows = sorted(s.execute("SELECT * FROM stress.standard1").rows)
        eng.store("stress", "standard1").flush()
        out.append((res, rows,
                    _files(eng.store("stress", "standard1").directory)))
        eng.close()
    assert len(out[1][1]) == 300
    assert out[0] == out[1]


def test_stress_setup_swallows_ddl_errors_like_jax(tmp_path):
    """setup() ignores its CREATE TABLE's failure, as the JAX tool does:
    a caller that needs the table checks for it."""
    for p in PKGS:
        eng = _engine(p, tmp_path / p["name"])
        s = p["session"](eng)
        s.execute("CREATE KEYSPACE stress WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 1}")
        s.execute("CREATE TABLE stress.standard1 (key int PRIMARY KEY, "
                  "other text)")
        p["stress"].setup(s)
        t = eng.schema.get_table("stress", "standard1")
        assert sorted(t.columns) == ["key", "other"]
        eng.close()


def test_tool_mains_take_device(tmp_path, capsys, monkeypatch):
    """stress and cqlsh build a StorageEngine: `cuda` unless --device
    says otherwise, so without a card they raise rather than run on the
    host."""
    monkeypatch.setattr("sys.stdin", io.StringIO("EXIT\n"))
    tstress.main(["write", "-n", "20", "--data", str(tmp_path / "s"),
                  "--device", "cpu"])
    assert '"n": 20' in capsys.readouterr().out
    tcqlsh.main(["--data", str(tmp_path / "s"), "--device", "cpu",
                 "-e", "SELECT count(*) FROM stress.standard1"])
    assert "20" in capsys.readouterr().out
    tcqlsh.main(["--data", str(tmp_path / "s"), "--device", "cpu"])
    assert "Connected to cassandra_tpu" in capsys.readouterr().out
    if torch.cuda.is_available():
        return
    for main, argv in ((tstress.main, ["read", "-n", "5", "--data",
                                       str(tmp_path / "r")]),
                       (tcqlsh.main, ["--data", str(tmp_path / "c"),
                                      "-e", "SELECT * FROM x"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


# ---------------------------------------------------------------- harry --

HARRY_DDL = ("CREATE TABLE t (k int, c int, v text, w int, st text static, "
             "m map<text,int>, PRIMARY KEY (k, c)) WITH id = "
             "7a1c0000-0000-4000-8000-000000000006")
SEED = 20260729


def _harry_reads(s, n_pks: int) -> list:
    return [sorted(s.execute(f"SELECT c, v, w, st, m FROM t WHERE k = {pk}")
                   .rows, key=repr) for pk in range(n_pks)]


def test_harry_model_and_jax_agree_through_device_compaction(
        tmp_path, frozen, monkeypatch):
    """harry's op stream (TTLs on a virtual clock, cell, row, range,
    partition and collection deletions, statics) on both engines: every
    partition equals the model and the JAX engine's read, before and
    after a device-engine major compaction (the port's on the CPU
    plain versions), and the compacted sstables are byte-equal."""
    clock = {"now": int(FROZEN)}
    for p in PKGS:
        monkeypatch.setattr(p["timeutil"], "CLOCK", lambda: clock["now"])
    n_ops, n_pks = 1500, 12
    gens = [p["harry"].OpGenerator(SEED, n_pks=n_pks, n_cks=16)
            for p in PKGS]
    models = [p["harry"].Model() for p in PKGS]
    engs, sess = [], []
    for p in PKGS:
        _restart_micros(p, monkeypatch)
        eng = _engine(p, tmp_path / p["name"])
        s = p["session"](eng)
        s.execute(KS)
        s.execute("USE ks")
        s.execute(HARRY_DDL)
        engs.append(eng)
        sess.append(s)
    kinds = set()
    for _ in range(n_ops):
        ops = [next(g) for g in gens]
        assert vars(ops[0]) == vars(ops[1])
        op = ops[0]
        kinds.add(op.kind)
        if op.kind == "advance":
            clock["now"] += op.seconds
        for p, eng, s, model, o in zip(PKGS, engs, sess, models, ops):
            if o.kind == "flush":
                eng.store("ks", "t").flush()
            elif o.kind != "compact" and o.kind != "advance":
                s.execute(o.cql("t"))
            model.apply(o, now_s=clock["now"])
    assert {"del_part", "del_range", "del_row", "del_col", "advance",
            "map_del_elem", "set_static"} <= kinds

    def check(upto):
        reads = []
        for p, s, model in zip(PKGS, sess, models):
            for pk in range(n_pks):
                p["harry"].check_partition(s, model, "t", pk, SEED, upto,
                                           now=clock["now"])
            reads.append(_harry_reads(s, n_pks))
        assert reads[0] == reads[1]
        assert any(reads[1])

    check(n_ops)
    outs = []
    for p, eng in zip(PKGS, engs):
        cfs = eng.store("ks", "t")
        cfs.flush()
        inputs = list(cfs.live_sstables())
        assert len(inputs) >= 4
        kw = {"device": "cpu"} if p is PORT else {}
        p["task"](cfs, inputs, engine="device", **kw).execute()
        outs.append([_files(cfs.directory)])
    check(n_ops)
    clock["now"] += 200_000          # every short TTL has expired
    check(n_ops)
    for eng in engs:
        eng.close()
    assert outs[0] == outs[1]


# ------------------------------------------------------------- nodetool --

def test_nodetool_getsstables_matches_jax(tmp_path, frozen, monkeypatch):
    got = []
    for p in PKGS:
        _restart_micros(p, monkeypatch)
        eng = _engine(p, tmp_path / p["name"])
        s = p["session"](eng)
        s.execute(KS)
        s.execute("USE ks")
        s.execute(SRC_DDL)
        s.execute("CREATE TABLE txt (k text, n int, v int, PRIMARY KEY "
                  "((k, n))) WITH id = 7a1c0000-0000-4000-8000-000000000007")
        _fill_src(s)
        eng.store("ks", "src").flush()
        s.execute("INSERT INTO src (id, seq, name) VALUES (2, 99, 'x')")
        eng.store("ks", "src").flush()
        s.execute("INSERT INTO txt (k, n, v) VALUES ('7', 1, 1)")
        eng.store("ks", "txt").flush()
        nt = p["nodetool"]
        got.append([nt.getsstables(eng, "ks", "src", str(k))
                    for k in range(8)]
                   + [nt.getsstables(eng, "ks", "txt", "7:1"),
                      nt.run_command("getsstables", engine=eng,
                                     keyspace="ks", table="src", key="2")])
        eng.close()
    assert got[0] == got[1]
    assert len(got[1][2]) == 2 and got[1][8]
