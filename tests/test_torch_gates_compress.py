"""The device_compress leg of the port's compaction A/B gate against
the JAX package's, on the CPU: the gate's fixture at 3 x 30,000 cells
(built by each package's `_mixed_batch`), whose merged output fills a
65,536-cell segment, so the leg reaches K5's path (its plain version
here). The leg must agree with its package's serial leg, and its
sstables must be equal across the packages."""
from __future__ import annotations

import os

from cassandra_tpu_torch.scripts import check_compaction_ab as port
from gates_ab import compaction_legs_both
from torch_tmp import tmp_path  # noqa: F401

LEGS = ["serial", "device_compress"]
SEGMENT_CELLS = 65_536


def test_device_compress_leg_matches_jax_package(tmp_path, monkeypatch):
    j_res, t_res, table = compaction_legs_both(str(tmp_path), monkeypatch,
                                               LEGS, seed=15_101)
    assert port.compare_legs(j_res, "compaction") == []
    assert port.compare_legs(t_res, "compaction") == []
    for tag in LEGS:
        assert t_res[tag] == j_res[tag], tag

    # the merged output fills at least one full segment (the writer
    # cuts 65,536-cell segments): K4's and K5's path
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore
    cfs = ColumnFamilyStore(
        table, os.path.join(str(tmp_path), "port", "device_compress"),
        commitlog=None)
    cfs.reload_sstables()
    try:
        assert sum(r.n_cells for r in cfs.live_sstables()) >= SEGMENT_CELLS
    finally:
        for r in cfs.live_sstables():
            r.close()
