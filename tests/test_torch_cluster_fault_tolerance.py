"""The port's counterpart of tests/test_fault_tolerance.py: the same
assertions on cassandra_tpu_torch, every engine on the CPU (device="cpu").

Storage fault tolerance: fault-injection filesystem, disk/commit
failure policies, corrupt-sstable quarantine.

(Reference test model: the corruption/FSError dtests —
CorruptedSSTablesCompactionsTest, OutOfSpaceTest, the
JVMStabilityInspector unit tests — driven here through the faultfs
checkpoints instead of byteman.)
"""
import os

import pytest

from cassandra_tpu_torch.config import Config, ConfigError, Settings
from cassandra_tpu_torch.schema import COL_ROW_LIVENESS, Schema, make_table
from cassandra_tpu_torch.service.metrics import GLOBAL as METRICS
from cassandra_tpu_torch.storage.engine import StorageEngine
from cassandra_tpu_torch.storage.failures import (CommitLogStoppedError,
                                                  FailureHandler,
                                                  StorageStoppedError)
from cassandra_tpu_torch.storage.mutation import Mutation
from cassandra_tpu_torch.storage.sstable import Component
from cassandra_tpu_torch.storage.sstable.format import FORMAT_VERSION as FMT
from cassandra_tpu_torch.storage.sstable.reader import CorruptSSTableError
from cassandra_tpu_torch.utils import faultfs, timeutil
from torch_tmp import tmp_path  # noqa: F401


@pytest.fixture(autouse=True)
def _disarm_all_faults():
    """faultfs is process-global: a leaked arm must never poison the
    next test."""
    faultfs.disarm()
    yield
    faultfs.disarm()


def new_engine(path, disk_policy="best_effort", commit_policy="ignore",
               **kw):
    schema = Schema()
    schema.create_keyspace("ks")
    t = make_table("ks", "t", pk=["id"], ck=["c"],
                   cols={"id": "int", "c": "int", "v": "text"})
    schema.add_table(t)
    settings = Settings(Config.load({
        "disk_failure_policy": disk_policy,
        "commit_failure_policy": commit_policy}))
    eng = StorageEngine(str(path), schema, commitlog_sync="batch",
                        settings=settings, **kw, device="cpu")
    return eng, t


def put(eng, t, pk, c, v, ts=None):
    m = Mutation(t.id, t.columns["id"].cql_type.serialize(pk))
    ck = t.serialize_clustering([c])
    ts = ts or timeutil.now_micros()
    m.add(ck, COL_ROW_LIVENESS, b"", b"", ts)
    m.add(ck, t.columns["v"].column_id, b"",
          t.columns["v"].cql_type.serialize(v), ts)
    eng.apply(m)


def pk_of(t, v):
    return t.columns["id"].cql_type.serialize(v)


def seeded(eng, t, rounds=2, pks=12):
    """rounds × pks rows, one flush per round → `rounds` sstables."""
    cfs = eng.store("ks", "t")
    for r in range(rounds):
        for i in range(pks):
            put(eng, t, i, r, f"r{r}-{i}")
        cfs.flush()
    return cfs


def flip_on_disk(path, offset=None):
    raw = bytearray(open(path, "rb").read())
    raw[offset if offset is not None else len(raw) // 2] ^= 0x01
    open(path, "wb").write(bytes(raw))


# ------------------------------------------------------------- faultfs --

def test_faultfs_times_after_and_path_filter(tmp_path):
    fp = faultfs.arm("sstable.read", "error", times=1, after=1,
                     path_substr="wanted")
    # wrong path: no hit consumed
    faultfs.GLOBAL.check("sstable.read", "/other/file")
    assert fp.fires == 0
    # first matching hit skipped (after=1)
    faultfs.GLOBAL.check("sstable.read", "/wanted/file")
    assert fp.fires == 0
    with pytest.raises(OSError):
        faultfs.GLOBAL.check("sstable.read", "/wanted/file")
    assert fp.fires == 1
    # times=1: exhausted
    faultfs.GLOBAL.check("sstable.read", "/wanted/file")
    assert fp.fires == 1
    faultfs.disarm("sstable.read")
    assert not faultfs.GLOBAL.active


def test_faultfs_inject_context_manager():
    with faultfs.inject("hints.read", "error"):
        assert faultfs.GLOBAL.armed("hints.read") is not None
    assert faultfs.GLOBAL.armed("hints.read") is None


def test_policy_values_validated():
    with pytest.raises(ConfigError):
        FailureHandler(Settings(Config.load(
            {"disk_failure_policy": "bogus"})))
    s = Settings(Config())
    h = FailureHandler(s)
    with pytest.raises(ConfigError):
        s.set("commit_failure_policy", "nope")
    s.set("disk_failure_policy", "stop")     # hot-set reaches the handler
    assert h.disk_policy == "stop"
    h.close()


# ------------------------------------- per-policy read-path corruption --

def test_bitflip_data_best_effort_quarantines_and_serves(tmp_path):
    eng, t = new_engine(tmp_path)
    cfs = seeded(eng, t)
    gens = [s.desc.generation for s in cfs.live_sstables()]
    bad = gens[0]
    c0 = METRICS.counter("storage.corruption_detected")
    with faultfs.inject("sstable.read", "bitflip",
                        path_substr=f"-{bad}-Data.db"):
        batch = cfs.read_partition(pk_of(t, 3))
    # the read SUCCEEDED from the remaining sources (round-1 values)
    assert len(batch) > 0
    assert METRICS.counter("storage.corruption_detected") == c0 + 1
    assert [q["generation"] for q in cfs.quarantined] == [bad]
    assert bad not in [s.desc.generation for s in cfs.live_sstables()]
    # forensics: the components moved into quarantine/, gone from live dir
    qdir = cfs.quarantined[0]["path"]
    assert os.path.exists(os.path.join(qdir, f"{FMT}-{bad}-Data.db"))
    assert not os.path.exists(
        os.path.join(cfs.directory, f"{FMT}-{bad}-TOC.txt"))
    # vtable + nodetool surfaces
    vt = eng.virtual_tables.get("system_views", "quarantined_sstables")
    assert [r["generation"] for r in vt.rows()] == [bad]
    from cassandra_tpu_torch.tools import nodetool
    assert [r["generation"] for r in nodetool.listquarantine(eng)] == [bad]
    # unaffected partitions and later reads keep working, fault disarmed
    assert len(cfs.read_partition(pk_of(t, 7))) > 0
    eng.close()


def test_bitflip_data_ignore_raises_and_stays_live(tmp_path):
    eng, t = new_engine(tmp_path, disk_policy="ignore")
    cfs = seeded(eng, t)
    gens = [s.desc.generation for s in cfs.live_sstables()]
    with faultfs.inject("sstable.read", "bitflip",
                        path_substr=f"-{gens[0]}-Data.db"):
        with pytest.raises(CorruptSSTableError):
            cfs.read_partition(pk_of(t, 3))
    # pre-policy behavior: nothing quarantined, the sstable stays live
    assert cfs.quarantined == []
    assert gens == [s.desc.generation for s in cfs.live_sstables()]
    # and with the fault gone the same read works again
    assert len(cfs.read_partition(pk_of(t, 3))) > 0
    eng.close()


def test_bitflip_data_stop_takes_storage_out(tmp_path):
    eng, t = new_engine(tmp_path, disk_policy="stop")
    cfs = seeded(eng, t)
    gens = [s.desc.generation for s in cfs.live_sstables()]
    with faultfs.inject("sstable.read", "bitflip",
                        path_substr=f"-{gens[0]}-Data.db"):
        with pytest.raises(CorruptSSTableError):
            cfs.read_partition(pk_of(t, 3))
    assert eng.failures.storage_stopped
    with pytest.raises(StorageStoppedError):
        cfs.read_partition(pk_of(t, 7))
    with pytest.raises(StorageStoppedError):
        cfs.scan_all()          # range reads are gated too
    with pytest.raises(StorageStoppedError):
        cfs.scan_window(-(1 << 63), (1 << 63) - 1)
    with pytest.raises(StorageStoppedError):
        put(eng, t, 99, 0, "nope")
    eng.close()


def test_corrupt_index_quarantined_at_store_open(tmp_path):
    """Index/Statistics corruption surfaces at OPEN, not read: a fresh
    engine over the directory must come up with the rotten sstable
    quarantined instead of crashing."""
    eng, t = new_engine(tmp_path)
    seeded(eng, t)
    eng._save_schema()
    cfs = eng.store("ks", "t")
    gens = [s.desc.generation for s in cfs.live_sstables()]
    directory = cfs.directory
    eng.close()
    # flip the header's lane-count field: the open-time
    # "index/stats lane mismatch" corruption check must fire
    # (mid-file index bytes carry no CRC and can rot silently)
    flip_on_disk(os.path.join(directory, f"{FMT}-{gens[0]}-Index.db"),
                 offset=4)
    c0 = METRICS.counter("storage.corruption_detected")
    eng2 = StorageEngine(str(tmp_path), Schema(), commitlog_sync="batch",
                         device="cpu")
    cfs2 = eng2.store("ks", "t")
    assert [q["generation"] for q in cfs2.quarantined] == [gens[0]]
    assert METRICS.counter("storage.corruption_detected") == c0 + 1
    live = [s.desc.generation for s in cfs2.live_sstables()]
    assert gens[0] not in live and gens[1] in live
    assert len(cfs2.read_partition(pk_of(t, 3))) > 0
    eng2.close()


def test_corrupt_stats_quarantined_at_store_open(tmp_path):
    eng, t = new_engine(tmp_path)
    cfs = seeded(eng, t)
    eng._save_schema()
    gens = [s.desc.generation for s in cfs.live_sstables()]
    directory = cfs.directory
    eng.close()
    # truncate Statistics.db to garbage: json decode error → corruption
    with open(os.path.join(directory,
                           f"{FMT}-{gens[1]}-Statistics.db"), "w") as f:
        f.write('{"n_lanes": 13, "broke')
    eng2 = StorageEngine(str(tmp_path), Schema(), commitlog_sync="batch",
                         device="cpu")
    cfs2 = eng2.store("ks", "t")
    assert [q["generation"] for q in cfs2.quarantined] == [gens[1]]
    # quarantine records survive a SECOND restart (on-disk manifest)
    eng2.close()
    eng3 = StorageEngine(str(tmp_path), Schema(), commitlog_sync="batch",
                         device="cpu")
    assert [q["generation"]
            for q in eng3.store("ks", "t").quarantined] == [gens[1]]
    eng3.close()


def test_corrupt_digest_verify_quarantine_handoff(tmp_path):
    """A flipped Digest.crc32 only surfaces at verify time; the
    --quarantine handoff must move the file out of the live set."""
    from cassandra_tpu_torch.tools import nodetool
    eng, t = new_engine(tmp_path)
    cfs = seeded(eng, t)
    gens = [s.desc.generation for s in cfs.live_sstables()]
    # rewrite the digest file with a wrong value
    dpath = os.path.join(cfs.directory, f"{FMT}-{gens[0]}-Digest.crc32")
    with open(dpath) as f:
        expected = int(f.read().strip())
    with open(dpath, "w") as f:
        f.write(str((expected + 1) & 0xFFFFFFFF))
    rep = nodetool.verify(eng, "ks", "t", quarantine=True)
    by_gen = {r["sstable"]: r for r in rep}
    assert by_gen[gens[0]]["ok"] is False
    assert by_gen[gens[0]].get("quarantined") is True
    assert by_gen[gens[1]]["ok"] is True
    assert gens[0] not in [s.desc.generation for s in cfs.live_sstables()]
    assert len(cfs.read_partition(pk_of(t, 3))) > 0
    eng.close()


# ------------------------------------------------------------ flush EIO --

def test_flush_eio_keeps_live_set_and_memtable(tmp_path):
    eng, t = new_engine(tmp_path)
    cfs = eng.store("ks", "t")
    for i in range(10):
        put(eng, t, i, 0, f"v{i}")
    d0 = METRICS.counter("storage.disk_failures")
    faultfs.arm("flush.write", "error")
    with pytest.raises(OSError):
        cfs.flush()
    faultfs.disarm()
    assert METRICS.counter("storage.disk_failures") == d0 + 1
    # live set unchanged, no half-written sstable committed
    assert cfs.live_sstables() == []
    # the memtable is still readable — nothing acked was lost
    assert not cfs.memtable.is_empty
    assert len(cfs.read_partition(pk_of(t, 3))) == 2
    # writes that landed DURING the failed flush survive the restore
    r = cfs.flush()
    assert r is not None and r.n_cells > 0
    assert len(cfs.read_partition(pk_of(t, 3))) == 2
    eng.close()


def test_flush_eio_absorbs_writes_during_failed_flush(tmp_path):
    """A write applied between the memtable switch and the flush
    failure must survive the restore (Memtable.absorb)."""
    eng, t = new_engine(tmp_path)
    cfs = eng.store("ks", "t")
    put(eng, t, 1, 0, "before")
    old = cfs.memtable

    # fail the flush, but sneak a write into the REPLACEMENT memtable
    # first: patch flush_shards to write mid-flush deterministically
    orig = type(old).flush_shards

    def trapped(self):
        if self is old:
            put(eng, t, 2, 0, "during")
            raise OSError(5, "injected mid-flush failure")
        return orig(self)

    type(old).flush_shards = trapped
    try:
        with pytest.raises(OSError):
            cfs.flush()
    finally:
        type(old).flush_shards = orig
    assert len(cfs.read_partition(pk_of(t, 1))) == 2
    assert len(cfs.read_partition(pk_of(t, 2))) == 2
    r = cfs.flush()
    assert r is not None
    assert len(cfs.read_partition(pk_of(t, 1))) == 2
    assert len(cfs.read_partition(pk_of(t, 2))) == 2
    eng.close()


def test_flush_readback_failure_restores_memtable(tmp_path):
    """EIO while RE-OPENING the just-written sstable (after finish)
    must restore the memtable exactly like a write failure — otherwise
    acked writes vanish from reads while the sstable sits untracked."""
    eng, t = new_engine(tmp_path)
    cfs = eng.store("ks", "t")
    for i in range(10):
        put(eng, t, i, 0, f"v{i}")
    faultfs.arm("sstable.open", "error", path_substr=cfs.directory)
    with pytest.raises(OSError):
        cfs.flush()
    faultfs.disarm()
    assert cfs.live_sstables() == []
    assert not cfs.memtable.is_empty
    assert len(cfs.read_partition(pk_of(t, 3))) == 2
    # retry works and content stays correct (the orphan on-disk output
    # from the failed read-back reconciles away if ever reloaded)
    assert cfs.flush() is not None
    assert len(cfs.read_partition(pk_of(t, 3))) == 2
    eng.close()


def test_quarantined_generation_never_reused(tmp_path):
    """After a restart, generation allocation must skip quarantined
    generations (their files left the live directory) — re-minting one
    would corrupt the quarantine records and block a future quarantine
    of the new sstable."""
    eng, t = new_engine(tmp_path)
    cfs = seeded(eng, t)
    eng._save_schema()
    gens = [s.desc.generation for s in cfs.live_sstables()]
    bad_reader = next(s for s in cfs.live_sstables()
                      if s.desc.generation == gens[-1])
    cfs.quarantine_sstable(bad_reader, "test")
    eng.close()
    eng2 = StorageEngine(str(tmp_path), Schema(), commitlog_sync="batch",
                         device="cpu")
    cfs2 = eng2.store("ks", "t")
    assert cfs2.next_generation() > gens[-1]
    for i in range(4):
        put(eng2, t, i, 9, "fresh")
    r = cfs2.flush()
    assert r.desc.generation > gens[-1]
    # the quarantine record still refers to the OLD generation only
    assert [q["generation"] for q in cfs2.quarantined] == [gens[-1]]
    eng2.close()


def test_torn_write_aborts_cleanly(tmp_path):
    eng, t = new_engine(tmp_path)
    cfs = eng.store("ks", "t")
    for i in range(10):
        put(eng, t, i, 0, f"v{i}")
    faultfs.arm("flush.write", "torn_write", tear_bytes=64)
    with pytest.raises(OSError):
        cfs.flush()
    faultfs.disarm()
    # the torn output never reached the live set; no TOC committed
    assert cfs.live_sstables() == []
    assert not any(fn.endswith("TOC.txt")
                   for fn in os.listdir(cfs.directory))
    assert cfs.flush() is not None
    eng.close()


# ----------------------------------------------------- compaction paths --

def test_compaction_corruption_aborts_task_not_executor(tmp_path):
    eng, t = new_engine(tmp_path)
    cfs = seeded(eng, t, rounds=5)
    gens = [s.desc.generation for s in cfs.live_sstables()]
    bad = gens[1]
    faultfs.arm("sstable.read", "bitflip", path_substr=f"-{bad}-Data.db")
    eng.compactions.submit_background(cfs)
    n = eng.compactions.run_pending()
    faultfs.disarm()
    # the corrupt input was quarantined and the strategy re-planned
    # WITHOUT it: the surviving inputs compacted in the same submission
    assert [q["generation"] for q in cfs.quarantined] == [bad]
    live = [s.desc.generation for s in cfs.live_sstables()]
    assert bad not in live
    assert n >= 1
    # the executor survived: another submission still runs
    seeded(eng, t, rounds=2)
    eng.compactions.submit_background(cfs)
    assert eng.compactions.run_pending() >= 0
    assert len(cfs.read_partition(pk_of(t, 3))) > 0
    eng.close()


def test_quarantined_excluded_from_next_compaction_round(tmp_path):
    from cassandra_tpu_torch.compaction.strategies import get_strategy
    eng, t = new_engine(tmp_path)
    # 5 rounds so FOUR survive the quarantine (STCS min threshold)
    cfs = seeded(eng, t, rounds=5)
    gens = [s.desc.generation for s in cfs.live_sstables()]
    bad_reader = next(s for s in cfs.live_sstables()
                      if s.desc.generation == gens[0])
    cfs.failures.handle_corruption(
        CorruptSSTableError("test", descriptor=bad_reader.desc))
    cfs.quarantine_sstable(bad_reader, "test")
    task = get_strategy(cfs).next_background_task()
    assert task is not None
    assert gens[0] not in {r.desc.generation for r in task.inputs}
    eng.close()


def test_compaction_corruption_ignore_policy_stops_replanning(tmp_path):
    eng, t = new_engine(tmp_path, disk_policy="ignore")
    cfs = seeded(eng, t, rounds=4)
    gens = [s.desc.generation for s in cfs.live_sstables()]
    faultfs.arm("sstable.read", "bitflip",
                path_substr=f"-{gens[0]}-Data.db")
    eng.compactions.submit_background(cfs)
    n = eng.compactions.run_pending()   # must not raise or spin forever
    faultfs.disarm()
    assert n == 0
    assert cfs.quarantined == []
    assert gens == [s.desc.generation for s in cfs.live_sstables()]
    eng.close()


# -------------------------------------------------- commit failure policy --

def _fail_one_sync(eng, t):
    faultfs.arm("commitlog.fsync", "error", times=1)
    with pytest.raises(OSError):
        put(eng, t, 1, 1, "doomed")
    faultfs.disarm()


def test_commit_policy_ignore_keeps_accepting(tmp_path):
    eng, t = new_engine(tmp_path, commit_policy="ignore")
    c0 = METRICS.counter("storage.commit_failures")
    put(eng, t, 1, 0, "a")
    _fail_one_sync(eng, t)
    assert METRICS.counter("storage.commit_failures") == c0 + 1
    put(eng, t, 1, 2, "recovered")   # today's behavior: writes continue
    # 6 cells: the doomed write is memtable-visible even though its ack
    # failed (same as the reference — a failed write may still be seen)
    assert len(eng.store("ks", "t").read_partition(pk_of(t, 1))) == 6
    eng.close()


def test_commit_policy_stop_commit_halts_writes_serves_reads(tmp_path):
    eng, t = new_engine(tmp_path, commit_policy="stop_commit")
    put(eng, t, 1, 0, "a")
    _fail_one_sync(eng, t)
    assert eng.failures.commits_stopped
    with pytest.raises(CommitLogStoppedError):
        put(eng, t, 1, 2, "refused")
    # reads continue (CommitLogStoppedError is write-only); 4 cells:
    # the acked write plus the doomed-but-memtable-visible one — the
    # REFUSED write after the halt is absent
    assert len(eng.store("ks", "t").read_partition(pk_of(t, 1))) == 4
    eng.close()


def test_commit_policy_stop_halts_reads_and_writes(tmp_path):
    eng, t = new_engine(tmp_path, commit_policy="stop")
    put(eng, t, 1, 0, "a")
    _fail_one_sync(eng, t)
    assert eng.failures.storage_stopped
    with pytest.raises(StorageStoppedError):
        put(eng, t, 1, 2, "refused")
    with pytest.raises(StorageStoppedError):
        eng.store("ks", "t").read_partition(pk_of(t, 1))
    eng.close()


def test_commit_policy_die_marks_node_dead(tmp_path):
    eng, t = new_engine(tmp_path, commit_policy="die")
    died = []
    eng.failures.on_die(died.append)
    put(eng, t, 1, 0, "a")
    _fail_one_sync(eng, t)
    assert eng.failures.dead and len(died) == 1
    with pytest.raises(StorageStoppedError):
        put(eng, t, 1, 2, "refused")
    eng.close()


# ------------------------------------------------------------- hints --

def test_hint_replay_skips_corrupt_record(tmp_path):
    import struct
    import zlib

    from cassandra_tpu_torch.cluster.hints import HintsService
    from cassandra_tpu_torch.cluster.ring import Endpoint
    eng, t = new_engine(tmp_path / "e")
    hs = HintsService(str(tmp_path / "hints"))
    target = Endpoint("n2", "127.0.0.1", 7001)
    muts = []
    for i in range(3):
        m = Mutation(t.id, pk_of(t, i))
        m.add(t.serialize_clustering([0]), COL_ROW_LIVENESS, b"", b"",
              timeutil.now_micros())
        muts.append(m)
        hs.store(target, m)
    # flip one payload byte of the MIDDLE record (header intact)
    p = hs._path(target)
    raw = bytearray(open(p, "rb").read())
    l0, = struct.unpack_from("<I", raw, 0)
    raw[8 + l0 + 8] ^= 0x01      # first payload byte of record 2
    open(p, "wb").write(bytes(raw))
    h0 = METRICS.counter("hints.corrupt_records")
    got = []
    n = hs.dispatch(target, got.append)
    # records 1 and 3 replayed; the corrupt middle one skipped + counted
    assert n == 2 and len(got) == 2
    assert {m.pk for m in got} == {muts[0].pk, muts[2].pk}
    assert METRICS.counter("hints.corrupt_records") == h0 + 1
    assert not hs.has_hints(target)
    eng.close()


def test_hint_read_eio_fault_point(tmp_path):
    from cassandra_tpu_torch.cluster.hints import HintsService
    from cassandra_tpu_torch.cluster.ring import Endpoint
    eng, t = new_engine(tmp_path / "e")
    hs = HintsService(str(tmp_path / "hints"))
    target = Endpoint("n2", "127.0.0.1", 7001)
    m = Mutation(t.id, pk_of(t, 1))
    m.add(t.serialize_clustering([0]), COL_ROW_LIVENESS, b"", b"",
          timeutil.now_micros())
    hs.store(target, m)
    with faultfs.inject("hints.read", "error"):
        with pytest.raises(OSError):
            hs.dispatch(target, lambda _m: None)
    # the file survived the failed dispatch; a retry replays it
    assert hs.has_hints(target)
    assert hs.dispatch(target, lambda _m: None) == 1
    eng.close()


# ------------------------------------------------------------- scrub --

def test_scrub_snapshots_before_rewriting(tmp_path):
    from cassandra_tpu_torch.storage.snapshot import list_snapshots
    from cassandra_tpu_torch.tools import nodetool
    eng, t = new_engine(tmp_path)
    cfs = seeded(eng, t)
    pre_files = {fn for fn in os.listdir(cfs.directory)
                 if fn.endswith("Data.db")}
    rep = nodetool.scrub(eng, "ks", "t")
    tags = {r["snapshot"] for r in rep}
    assert len(tags) == 1 and next(iter(tags)).startswith("pre-scrub-")
    snaps = list_snapshots(cfs)
    assert len(snaps) == 1
    # every pre-scrub data file is preserved in the snapshot
    assert pre_files <= set(snaps[0]["files"])
    eng.close()


def test_scrub_quarantine_handoff_for_unopenable_sstable(tmp_path):
    from cassandra_tpu_torch.tools import nodetool
    eng, t = new_engine(tmp_path)
    cfs = seeded(eng, t)
    gens = [s.desc.generation for s in cfs.live_sstables()]
    # segment-read corruption inside scrub's fill drops segments; an
    # OPEN-level error (rewrite re-reads via the live reader whose
    # decode hits EIO every time) can only abort — the handoff must
    # quarantine instead of leaving the file live
    faultfs.arm("sstable.read", "error",
                path_substr=f"-{gens[0]}-Data.db")
    rep = nodetool.scrub(eng, "ks", "t", quarantine=True)
    faultfs.disarm()
    by_gen = {r["generation"]: r for r in rep}
    assert by_gen[gens[0]].get("quarantined") is True
    assert gens[0] not in [s.desc.generation for s in cfs.live_sstables()]
    assert len(cfs.read_partition(pk_of(t, 3))) > 0
    eng.close()


def test_sstableverify_offline_quarantine(tmp_path):
    from cassandra_tpu_torch.tools import sstabletools
    eng, t = new_engine(tmp_path)
    cfs = seeded(eng, t)
    eng._save_schema()
    gens = [s.desc.generation for s in cfs.live_sstables()]
    directory = cfs.directory
    data_dir = eng.data_dir
    eng.close()
    flip_on_disk(os.path.join(directory, f"{FMT}-{gens[0]}-Data.db"))
    rep = sstabletools.verify(data_dir, "ks", "t", quarantine=True)
    by_gen = {r["generation"]: r for r in rep}
    assert by_gen[gens[0]]["status"] != "ok"
    assert "quarantined" in by_gen[gens[0]]
    assert by_gen[gens[1]]["status"] == "ok"
    # the rotten generation left the live directory: a fresh engine
    # opens clean without tripping over it (commitlog replay may add a
    # NEW generation — only the quarantined one must stay gone)
    eng2 = StorageEngine(data_dir, Schema(), commitlog_sync="batch",
                         device="cpu")
    cfs2 = eng2.store("ks", "t")
    live = [s.desc.generation for s in cfs2.live_sstables()]
    assert gens[0] not in live and gens[1] in live
    eng2.close()


# ------------------------------------------- coordinator failover path --

def test_replica_read_error_fails_over_to_spare(tmp_path):
    """A corrupt local replica (policy=ignore so the error surfaces)
    must produce a failed response that the coordinator's speculative
    retry turns into data from another replica — instead of burning
    the read timeout or crashing the client read."""
    import time as _time

    from cassandra_tpu_torch.cluster.node import LocalCluster
    from cassandra_tpu_torch.cluster.replication import ConsistencyLevel
    c = LocalCluster(2, str(tmp_path), rf=2, device="cpu")
    try:
        for n in c.nodes:
            n.proxy.timeout = 2.0
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 2}")
        s.execute("USE ks")
        s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
        n1 = c.node(1)
        n1.engine.settings.set("disk_failure_policy", "ignore")
        s.execute("INSERT INTO kv (k, v) VALUES (1, 'payload')")
        for n in c.nodes:
            n.engine.store("ks", "kv").flush()
        t = c.schema.get_table("ks", "kv")
        pk = t.columns["k"].cql_type.serialize(1)
        # corrupt ONLY the coordinator's own replica
        faultfs.arm("sstable.read", "bitflip",
                    path_substr=n1.engine.data_dir)
        from cassandra_tpu_torch.storage.chunk_cache import GLOBAL as chunks
        chunks.clear()
        t0 = _time.monotonic()
        merged = n1.proxy.read_partition("ks", "kv", pk,
                                         ConsistencyLevel.ONE)
        elapsed = _time.monotonic() - t0
        faultfs.disarm()
        assert len(merged) > 0          # served by the healthy replica
        assert elapsed < 1.5            # failover, not a timeout burn
    finally:
        faultfs.disarm()
        c.shutdown()


def test_stop_policy_leaves_the_ring(tmp_path):
    from cassandra_tpu_torch.cluster.node import LocalCluster
    c = LocalCluster(2, str(tmp_path), rf=2, device="cpu")
    try:
        s = c.session(1)
        s.execute("CREATE KEYSPACE ks WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 2}")
        s.execute("USE ks")
        s.execute("CREATE TABLE kv (k int PRIMARY KEY, v text)")
        n1 = c.node(1)
        n1.engine.settings.set("disk_failure_policy", "stop")
        s.execute("INSERT INTO kv (k, v) VALUES (1, 'x')")
        cfs = n1.engine.store("ks", "kv")
        cfs.flush()
        t = c.schema.get_table("ks", "kv")
        pk = t.columns["k"].cql_type.serialize(1)
        from cassandra_tpu_torch.storage.chunk_cache import GLOBAL as chunks
        chunks.clear()
        with faultfs.inject("sstable.read", "bitflip",
                            path_substr=n1.engine.data_dir):
            with pytest.raises(CorruptSSTableError):
                cfs.read_partition(pk)
        assert n1.engine.failures.storage_stopped
        # the node left the ring: own gossip status flipped and the
        # gossiper no longer speaks
        st = n1.gossiper.states[n1.endpoint]
        assert st.app_states.get("status") == "shutdown"
        assert not n1.gossiper.is_running()
        with pytest.raises(StorageStoppedError):
            n1.engine.apply(Mutation(t.id, pk))
    finally:
        c.shutdown()
