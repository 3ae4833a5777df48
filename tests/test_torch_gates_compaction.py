"""The port's compaction A/B gate
(`cassandra_tpu_torch.scripts.check_compaction_ab`) against the JAX
package's (`scripts/check_compaction_ab.py`), on the CPU.

The tier-1 test builds the gate's fixture at 3 x 30,000 cells through
each package's own `_mixed_batch` and runs the serial, device and
mesh2 legs through each package's `_compaction_leg` (the
device_compress leg is `test_torch_gates_compress.py`'s): each
package's legs must agree with its serial leg, and each leg's sstables
must be equal across the packages. The full gate of both packages, at
its own fixture of 3 x 200,000 cells, eleven legs and the flush A/B,
is marked slow."""
from __future__ import annotations

import os

import pytest

from cassandra_tpu.utils import timeutil as j_timeutil
from cassandra_tpu_torch.scripts import check_compaction_ab as port
from cassandra_tpu_torch.utils import timeutil as t_timeutil
from gates_ab import (compaction_legs_both, component_hashes, freeze,
                      jax_gate, tree_bytes)
from torch_tmp import tmp_path  # noqa: F401

LEGS = ["serial", "device", "mesh2"]


def test_compaction_legs_match_jax_package(tmp_path, monkeypatch):
    j_res, t_res, _table = compaction_legs_both(str(tmp_path), monkeypatch,
                                                LEGS, seed=15_100)
    assert port.compare_legs(j_res, "compaction") == []
    assert port.compare_legs(t_res, "compaction") == []
    for tag in LEGS:
        assert t_res[tag] == j_res[tag], tag


def test_compaction_gate_raises_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.check_compaction(str(tmp_path))


@pytest.mark.slow
def test_full_compaction_gate_both_packages(tmp_path, monkeypatch):
    """Both packages' whole gate (eleven compaction legs, the flush
    A/B) at its own fixture: zero divergence in each, and every
    compaction leg's sstables equal across the packages."""
    clock = {}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    freeze(monkeypatch, (j_timeutil, t_timeutil), clock, seed=15_200)
    assert jax_gate("check_compaction_ab").run_check(jdir) == []
    freeze(monkeypatch, (j_timeutil, t_timeutil), clock, seed=15_200)
    assert port.run_check(tdir, device="cpu") == []
    j_hashes = component_hashes(os.path.join(jdir, "compaction"))
    t_hashes = component_hashes(os.path.join(tdir, "compaction"))
    assert j_hashes and t_hashes == j_hashes
    print(f"bytes written: jax {tree_bytes(jdir)}, port {tree_bytes(tdir)}")
