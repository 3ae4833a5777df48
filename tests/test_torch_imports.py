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
    assert int(lines["N"]) >= 40      # the whole port was imported


def test_entry_points_default_to_cuda():
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
    from cassandra_tpu_torch.compaction.task import CompactionTask
    from cassandra_tpu_torch.ops import device_scan, merge
    from cassandra_tpu_torch.schema import make_table
    from cassandra_tpu_torch.storage.cellbatch import (FLAG_COUNTER,
                                                       CellBatchBuilder)

    with pytest.raises(NotImplementedError, match="K9"):
        device_scan.mask_device(np.zeros(1, np.uint64), None)
    with pytest.raises(NotImplementedError, match="K9"):
        device_scan.segment_mask(np.zeros(1, np.uint64), None, True)
    with pytest.raises(NotImplementedError, match="K6/K7"):
        CompactionTask(None, [], engine="device", device="cpu",
                       device_resident=False)
    t = make_table("ks", "cnt", pk=["id"], cols={"id": "int",
                                                 "hits": "counter"})
    b = CellBatchBuilder(t)
    b.append_raw(t.columns["id"].cql_type.serialize(1), b"",
                 t.columns["hits"].column_id, b"", (3).to_bytes(8, "big"),
                 ts=1, flags=FLAG_COUNTER)
    with pytest.raises(NotImplementedError, match="K6/K7"):
        merge.submit_merge([b.seal()], device="cpu")
