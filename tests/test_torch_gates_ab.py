"""The port's read, scan and write A/B gates
(`cassandra_tpu_torch.scripts.check_{scan,readpath,writepath}_ab`)
against the JAX package's (`scripts/`), on the CPU.

Each package runs its own gate on the same fixture, in sibling
directories, under one virtual clock and one uuid4 sequence: each gate
must report no divergence between its legs, and the sstables the two
packages wrote must be equal component by component (sha256)."""
from __future__ import annotations

import os

import pytest

from cassandra_tpu.utils import timeutil as j_timeutil
from cassandra_tpu_torch.scripts import check_readpath_ab as t_readpath
from cassandra_tpu_torch.scripts import check_scan_ab as t_scan
from cassandra_tpu_torch.scripts import check_writepath_ab as t_writepath
from cassandra_tpu_torch.utils import timeutil as t_timeutil
from gates_ab import component_hashes, freeze, jax_gate, virtual_time
from torch_tmp import tmp_path  # noqa: F401

GATES = [("check_scan_ab", t_scan), ("check_readpath_ab", t_readpath),
         ("check_writepath_ab", t_writepath)]


def _run(mod, seed: int, base: str, clock: dict, monkeypatch,
         **kw) -> list:
    freeze(monkeypatch, (j_timeutil, t_timeutil), clock, seed)
    monkeypatch.setattr(mod, "time", virtual_time(clock), raising=False)
    return mod.run_check(base, **kw)


@pytest.mark.parametrize("name,port", GATES, ids=[g[0] for g in GATES])
def test_gate_matches_jax_package(name, port, tmp_path, monkeypatch):
    clock = {}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    os.makedirs(tdir)
    # a seed per gate: the key and chunk caches are process-wide and
    # keyed by directory and generation, and a removed tmp_path's name
    # comes back for the next test, so each gate's tables need ids (and
    # so directories) of their own
    seed = 15_000 + [g[0] for g in GATES].index(name)
    j_div = _run(jax_gate(name), seed, jdir, clock, monkeypatch)
    t_div = _run(port, seed, tdir, clock, monkeypatch, device="cpu")
    assert j_div == [], "\n".join(j_div)
    assert t_div == [], "\n".join(t_div)
    j_hashes, t_hashes = component_hashes(jdir), component_hashes(tdir)
    assert j_hashes, f"{name} wrote no sstable"
    assert t_hashes == j_hashes


def test_scan_gate_runs_the_device_legs_through_the_lane(tmp_path):
    """The device and mesh2 legs mask segments through K9's path (its
    plain version on the CPU: counted by scan.device_segments, no
    launch), and the naive leg goes through no lane at all."""
    from cassandra_tpu_torch.service.metrics import GLOBAL as METRICS

    before = METRICS.counter("scan.device_segments")
    launches: dict = {}
    assert t_scan.run_check(str(tmp_path), device="cpu",
                            launches=launches) == []
    assert METRICS.counter("scan.device_segments") > before
    assert list(launches) == list(t_scan.LEGS)
    assert all(v == {} for v in launches.values())


@pytest.mark.parametrize("name,port", GATES, ids=[g[0] for g in GATES])
def test_gate_raises_without_a_card(name, port, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.run_check(str(tmp_path))
