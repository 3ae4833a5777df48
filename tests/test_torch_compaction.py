"""The port as a whole: CompactionTask(engine="device") of the
PyTorch/CUDA port (device="cpu", the plain PyTorch versions of the
kernels) against the JAX package's on the same input sstables, through
the resident rounds (K1-K4), the non-resident and mesh rounds (the
plane programs K6, K7) and counter rounds (K7). The output sstables'
component sha256s must be equal, and the port's reader must read the
JAX package's output cell for cell. The device-compress leg (K5) is
tests/test_torch_device_compress.py."""
from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from cassandra_tpu.compaction.task import CompactionTask as JTask
from cassandra_tpu.storage.table import ColumnFamilyStore as JStore
from test_device_resident import _build_big, _build_inputs, _hashes, _table

from cassandra_tpu_torch.compaction.task import CompactionTask as TTask
from cassandra_tpu_torch.ops.codec import CompressionParams as TCP
from cassandra_tpu_torch.schema import TableParams as TParams
from cassandra_tpu_torch.schema import make_table as t_make_table
from cassandra_tpu_torch.service.profiling import GLOBAL as TPROF
from cassandra_tpu_torch.storage.sstable import Descriptor as TDesc
from cassandra_tpu_torch.storage.sstable import SSTableReader as TReader
from cassandra_tpu_torch.storage.table import ColumnFamilyStore as TStore
from torch_tmp import tmp_path  # noqa: F401


def _port_table(jt):
    t = t_make_table(
        jt.keyspace, jt.name, pk=["id"], ck=["c"],
        cols={"id": "int", "c": "int", "v": "blob"},
        params=TParams(compression=TCP("LZ4Compressor",
                                       chunk_length=16 * 1024)))
    t.id = jt.id            # same table directory name in both packages
    return t


def _calls(name: str) -> int:
    return TPROF.snapshot()["kernels"].get(name, {}).get("calls", 0)


# (case, fixture, round_cells): the first cuts tests/test_device_resident.py's
# fixture (partition deletions, tombstones, equal-ts duplicates) into
# small rounds, so host fallback rounds interleave with resident ones;
# the second is a multi-round, multi-segment input (a full 65,536-cell
# segment through K4, then the partial tail)
CASES = [
    ("deletions-small-rounds", lambda cfs, t: _build_inputs(cfs, t), 4096),
    ("multi-round", lambda cfs, t: _build_big(cfs, t, n_per=30_000),
     16_384),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_device_engine_matches_jax(tmp_path, case):
    name, build, round_cells = case
    jt = _table(name.replace("-", "_"))
    jcfs = JStore(jt, str(tmp_path / "jax"), commitlog=None)
    build(jcfs, jt)
    rel = os.path.relpath(jcfs.directory, str(tmp_path / "jax"))
    shutil.copytree(jcfs.directory, str(tmp_path / "port" / rel))

    jcfs.reload_sstables()
    jstats = JTask(jcfs, jcfs.tracker.view(), engine="device",
                   device_compress=False, round_cells=round_cells).execute()
    jh = _hashes(jcfs.directory)

    tt = _port_table(jt)
    tcfs = TStore(tt, str(tmp_path / "port"), commitlog=None)
    assert os.path.relpath(tcfs.directory, str(tmp_path / "port")) == rel
    tcfs.reload_sstables()
    before = {k: _calls(k) for k in ("merge.sort_perm", "write.meta_block")}
    tstats = TTask(tcfs, tcfs.tracker.view(), engine="device",
                   device_compress=False, device="cpu",
                   round_cells=round_cells).execute()
    th = _hashes(tcfs.directory)
    assert tstats["cells_written"] == jstats["cells_written"] > 0
    assert th == jh and len(th) == 6
    assert _calls("merge.sort_perm") > before["merge.sort_perm"]
    if name == "multi-round":
        assert _calls("write.meta_block") > before["write.meta_block"]
    for r in list(jcfs.live_sstables()) + list(tcfs.live_sstables()):
        r.close()


def test_port_reader_reads_jax_output(tmp_path):
    jt = _table("reader")
    jcfs = JStore(jt, str(tmp_path), commitlog=None)
    _build_inputs(jcfs, jt, n_ssts=2, n=8_000)
    jcfs.reload_sstables()
    JTask(jcfs, jcfs.tracker.view(), engine="device",
          device_compress=False).execute()
    (jr,) = jcfs.live_sstables()
    tr = TReader(TDesc(jcfs.directory, jr.desc.generation), _port_table(jt))
    assert tr.n_cells == jr.n_cells > 0
    jb = list(jr.scanner())
    tb = list(tr.scanner())
    assert [len(b) for b in tb] == [len(b) for b in jb]
    for a, b in zip(jb, tb):
        for k in ("lanes", "ts", "ldt", "ttl", "flags", "off", "val_start",
                  "payload"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert tr.verify_digest()
    tr.close()
    jr.close()


def _counter_inputs(cfs, table, n_ssts=3, parts=300):
    """Counter sstables: every input holds deltas for the same counters,
    so each round sums runs across inputs (K7, then the host's
    counter summation)."""
    from cassandra_tpu.storage import cellbatch as jcb
    from cassandra_tpu.storage.sstable import Descriptor, SSTableWriter
    cid = table.columns["hits"].column_id
    idt = table.columns["id"].cql_type
    for gen in range(1, n_ssts + 1):
        b = jcb.CellBatchBuilder(table)
        for p in range(parts):
            d = (p * 7 + gen) % 11 - 5
            b.append_raw(idt.serialize(p), b"", cid, b"",
                         (d & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big"),
                         ts=100 * gen + p, flags=jcb.FLAG_COUNTER)
        w = SSTableWriter(Descriptor(cfs.directory, gen), table,
                          estimated_partitions=parts)
        w.append(jcb.merge_sorted([b.seal()]))
        w.finish()


def _counter_tables():
    from cassandra_tpu.schema import make_table as j_make_table
    jt = j_make_table("devres", "counters", pk=["id"],
                      cols={"id": "int", "hits": "counter"})
    tt = t_make_table("devres", "counters", pk=["id"],
                      cols={"id": "int", "hits": "counter"})
    tt.id = jt.id
    return jt, tt


# (case, fixture, the plane program its rounds run, task options): the
# deletion fixture (partition deletions, tombstones, equal-ts duplicates)
# runs K7, the deletion-free one K6; each through the non-resident
# device engine and through the mesh execution mode (two lanes)
PLANE_CASES = [
    ("deletions-nonresident", lambda cfs, t: _build_inputs(cfs, t),
     "merge.plane_v2", {"device_resident": False, "round_cells": 8192}),
    ("deletions-mesh2", lambda cfs, t: _build_inputs(cfs, t),
     "merge.plane_v2", {"mesh_devices": 2}),
    ("live-nonresident",
     lambda cfs, t: _build_inputs(cfs, t, deletions=False),
     "merge.plane_fast", {"device_resident": False, "round_cells": 8192}),
    ("live-mesh2", lambda cfs, t: _build_inputs(cfs, t, deletions=False),
     "merge.plane_fast", {"mesh_devices": 2}),
]


@pytest.mark.parametrize("case", PLANE_CASES, ids=[c[0] for c in PLANE_CASES])
def test_plane_program_engines_match_jax(tmp_path, case):
    name, build, kernel, kw = case
    jt = _table(name.replace("-", "_"))
    jcfs = JStore(jt, str(tmp_path / "jax"), commitlog=None)
    build(jcfs, jt)
    rel = os.path.relpath(jcfs.directory, str(tmp_path / "jax"))
    shutil.copytree(jcfs.directory, str(tmp_path / "port" / rel))
    jcfs.reload_sstables()
    jstats = JTask(jcfs, jcfs.tracker.view(), engine="device",
                   **kw).execute()
    jh = _hashes(jcfs.directory)

    tcfs = TStore(_port_table(jt), str(tmp_path / "port"), commitlog=None)
    tcfs.reload_sstables()
    before = {k: _calls(k) for k in ("merge.plane_fast", "merge.plane_v2",
                                     "merge.sort_perm")}
    task = TTask(tcfs, tcfs.tracker.view(), engine="device", device="cpu",
                 **kw)
    tstats = task.execute()
    assert tstats["cells_written"] == jstats["cells_written"] > 0
    assert _hashes(tcfs.directory) == jh and len(jh) == 6
    assert _calls(kernel) > before[kernel]
    assert _calls("merge.sort_perm") == before["merge.sort_perm"]
    if "mesh_devices" in kw:
        assert "mesh_plan" in task.profile      # the mesh mode really ran
    for r in list(jcfs.live_sstables()) + list(tcfs.live_sstables()):
        r.close()


def test_counter_table_device_engine_matches_jax(tmp_path):
    """Counter rounds leave the resident path for merge.submit_merge
    (K7) in both packages; the outputs are sha256-equal."""
    jt, tt = _counter_tables()
    jcfs = JStore(jt, str(tmp_path / "jax"), commitlog=None)
    _counter_inputs(jcfs, jt)
    rel = os.path.relpath(jcfs.directory, str(tmp_path / "jax"))
    shutil.copytree(jcfs.directory, str(tmp_path / "port" / rel))
    jcfs.reload_sstables()
    JTask(jcfs, jcfs.tracker.view(), engine="device").execute()
    tcfs = TStore(tt, str(tmp_path / "port"), commitlog=None)
    tcfs.reload_sstables()
    before = _calls("merge.plane_v2")
    TTask(tcfs, tcfs.tracker.view(), engine="device", device="cpu").execute()
    assert _calls("merge.plane_v2") > before
    jh = _hashes(jcfs.directory)
    assert _hashes(tcfs.directory) == jh and len(jh) == 6
    for r in list(jcfs.live_sstables()) + list(tcfs.live_sstables()):
        r.close()
