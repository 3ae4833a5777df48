"""The PyTorch/CUDA port (cassandra_tpu_torch) stands alone: importing it,
and chip_smoke.py's imports, pulls in no `jax` and no module of the JAX
package; its entry points default to `cuda` and raise without a card."""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_tmp import tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None          # any `import jax` now fails
    sys.path.insert(0, {repo!r})
    import cassandra_tpu_torch
    for m in pkgutil.walk_packages(cassandra_tpu_torch.__path__,
                                   "cassandra_tpu_torch."):
        if not m.name.rsplit(".", 1)[-1].startswith("lib"):  # built .so
            importlib.import_module(m.name)
    import chip_smoke                  # its module-level imports
    chip_smoke.stcs_table()
    from cassandra_tpu_torch.ops import device_compress   # K5's module
    import numpy as np, torch
    out = device_compress.segment_scan(
        torch.zeros(64, dtype=torch.uint8),
        torch.from_numpy(chip_smoke.make_lanes(1, 16).view(np.int32)))
    assert bool(out[5]) and out[0].numel() == 4 * 16 * chip_smoke.LANES
    # the CQL read path end to end on the CPU: its lazy imports too
    import tempfile
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine
    eng = StorageEngine(tempfile.mkdtemp(), Schema(),
                        commitlog_sync="batch", device="cpu")
    s = Session(eng)
    s.execute("CREATE KEYSPACE ks WITH replication = "
              "{{'class': 'SimpleStrategy', 'replication_factor': 1}}")
    s.execute("USE ks")
    s.execute("CREATE TABLE t (k int, c int, v int, e vector<float, 2>, "
              "PRIMARY KEY (k, c))")
    s.execute("CREATE CUSTOM INDEX ON t (e) USING 'SAI'")
    for i in range(8):
        s.execute("INSERT INTO t (k, c, v, e) VALUES (?, ?, ?, ?)",
                  [i % 3, i, i, [float(i), 1.0]])
    eng.store("ks", "t").flush()
    assert s.execute("SELECT c FROM t WHERE v = ? ALLOW FILTERING",
                     [5]).rows == [(5,)]
    assert s.execute("SELECT count(*), sum(v) FROM t WHERE v < 4 "
                     "ALLOW FILTERING").rows == [(4, 6)]
    assert s.execute("SELECT c FROM t ORDER BY e ANN OF [1.0, 0.0] "
                     "LIMIT 1").rows == [(7,)]
    # the admin surfaces: vtables, nodetool, audit
    from cassandra_tpu_torch.tools import nodetool
    nodetool.run_command("snapshot", engine=eng, tag="p")
    assert len(s.execute("SELECT * FROM system_views.snapshots").rows) == 1
    assert s.execute("SELECT * FROM system_views.thread_pools").rows
    eng.close()
    from cassandra_tpu_torch.service.audit import AuditLog
    AuditLog(tempfile.mkdtemp() + "/a.jsonl").log("UseStatement", "USE ks",
                                                  None, None)
    # the mesh step on two CPU shards
    from cassandra_tpu_torch.parallel import make_mesh, sharded_merge_step
    from cassandra_tpu_torch.parallel.mesh import shard_batch
    from cassandra_tpu_torch.storage.cellbatch import CellBatchBuilder
    from cassandra_tpu_torch.schema import make_table
    tt = make_table("ks", "m", pk=["id"], ck=["c"],
                    cols={{"id": "int", "c": "int", "v": "blob"}})
    b = CellBatchBuilder(tt)
    for i in range(6):
        b.add_cell(tt.serialize_partition_key([i]),
                   tt.serialize_clustering([i]), tt.columns["v"].column_id,
                   b"x", 5)
    st = sharded_merge_step(make_mesh(2, device="cpu"))(
        shard_batch(b.seal(), 2)[0])[2]
    assert st.tolist() == [6, 0]
    for m in ("cassandra_tpu_torch.cql.execution",
              "cassandra_tpu_torch.storage.engine",
              "cassandra_tpu_torch.storage.paging",
              "cassandra_tpu_torch.transport.frame",
              "cassandra_tpu_torch.control.loop",
              "cassandra_tpu_torch.ops.ann",
              "cassandra_tpu_torch.parallel.mesh",
              "cassandra_tpu_torch.storage.snapshot",
              "cassandra_tpu_torch.storage.rewrite",
              "cassandra_tpu_torch.storage.saved_caches",
              "cassandra_tpu_torch.service.audit",
              "cassandra_tpu_torch.tools.nodetool"):
        assert m in sys.modules, m
    bad = sorted(m for m in sys.modules
                 if (m == "cassandra_tpu" or m.startswith("cassandra_tpu."))
                 or m == "jax" or m.startswith("jax.")
                 or m.startswith("jaxlib"))
    bad = [m for m in bad if sys.modules[m] is not None]
    print("BAD", bad)
    print("N", sum(m.startswith("cassandra_tpu_torch") for m in sys.modules))
""")


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE.format(repo=REPO)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("BAD ", "N ")))
    assert lines["BAD"] == "[]"
    assert int(lines["N"]) >= 90      # the whole port was imported


def test_entry_points_default_to_cuda(tmp_path):
    from cassandra_tpu_torch import device as devmod
    from cassandra_tpu_torch.compaction.task import CompactionTask
    from cassandra_tpu_torch.ops import device_write as dw
    from cassandra_tpu_torch.ops import merge as dm
    from cassandra_tpu_torch.schema import make_table
    from cassandra_tpu_torch.storage.cellbatch import CellBatchBuilder

    t = make_table("ks", "imp", pk=["id"], ck=["c"],
                   cols={"id": "int", "c": "int", "v": "blob"})
    b = CellBatchBuilder(t)
    b.add_cell(t.serialize_partition_key([1]), t.serialize_clustering([1]),
               t.columns["v"].column_id, b"x", 5)
    batch = b.seal()
    if torch.cuda.is_available():
        assert devmod.resolve().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devmod.resolve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dw.submit_merge_resident([batch])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompactionTask(None, [], engine="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dw.DeviceWriteLane(writer=type("W", (), {"segment_cells": 8})())
    from cassandra_tpu_torch.storage.engine import StorageEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StorageEngine(str(tmp_path / "eng"))
    assert not (tmp_path / "eng").exists()   # raised before any write
    # the CPU runs the plain versions only when asked for
    assert devmod.resolve("cpu").type == "cpu"
    h = dw.submit_merge_resident([batch], device="cpu")
    r = dw.collect_merge_resident(h)
    assert r.n == 1 and r.cols["lanes"].device.type == "cpu"
    # a kernel entry point given CPU tensors runs its plain version
    ops = dm.operands_to_device(dm.build_operands(batch), "cpu")
    assert dm.device_sort_perm(ops).dtype == torch.int32
    assert np.array_equal(dm.device_sort_perm(ops).numpy(),
                          dm.sort_perm_plain(ops).numpy())


def test_unported_kernels_raise_instead_of_falling_back():
    """Every kernel is ported: the mesh step (K8, parallel.mesh), the
    scan kernels (K9) and vector search (K10) launch on the default
    `cuda` device or raise without a card: none of them runs on the
    host behind the caller's back."""
    import importlib

    from cassandra_tpu_torch.index.manager import VectorIndex
    from cassandra_tpu_torch.ops import device_scan

    mesh = importlib.import_module("cassandra_tpu_torch.parallel.mesh")
    assert mesh.make_mesh(3, device="cpu").devices.size == 3
    if torch.cuda.is_available():
        return
    pred = device_scan.CompiledPredicate(
        9, "v", "i64", 4, "<", "lt", np.zeros(1, np.uint64), True, False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_scan.mask_device(np.zeros(1, np.uint64), pred)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_scan.segment_mask(np.zeros(1, np.uint64), pred, True)
    idx = object.__new__(VectorIndex)
    idx.device, idx._device_cache = None, None
    idx._gather = lambda: (np.ones((2, 2), np.float32), [(b"a", b""),
                                                         (b"b", b"")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        idx.ann(np.ones(2, np.float32), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    cuda_mesh = mesh.Mesh([torch.device("cuda", 0)] * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.sharded_merge_step(cuda_mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.run_sharded_merge(None, cuda_mesh)


def test_plane_program_entry_points_default_to_cuda():
    """The non-resident round API (K6/K7) takes device= like the other
    entry points: `cuda` by default (raises without a card), `cpu` on
    request."""
    from cassandra_tpu_torch.compaction.task import CompactionTask
    from cassandra_tpu_torch.ops import merge
    from cassandra_tpu_torch.schema import make_table
    from cassandra_tpu_torch.storage.cellbatch import (FLAG_COUNTER,
                                                       CellBatchBuilder)

    t = make_table("ks", "cnt", pk=["id"], cols={"id": "int",
                                                 "hits": "counter"})
    b = CellBatchBuilder(t)
    b.append_raw(t.columns["id"].cql_type.serialize(1), b"",
                 t.columns["hits"].column_id, b"", (3).to_bytes(8, "big"),
                 ts=1, flags=FLAG_COUNTER)
    batch = b.seal()
    task = CompactionTask(None, [], engine="device", device="cpu",
                          device_resident=False)
    assert task.device.type == "cpu" and not task.device_resident
    h = merge.submit_merge([batch], device="cpu")
    assert h.mode == "v2" and h.fut.device.type == "cpu"
    assert len(merge.collect_merge(h)) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            merge.submit_merge([batch])
