"""The port's tier-2 tools (`cassandra_tpu_torch.scripts`): the wire
stress driver's key streams against the JAX package's
(`scripts/stress.py`), the profiler gate's retrace sentinel, the
metric-name check over the port's tree and the lint driver, on the
CPU."""
from __future__ import annotations

import os

import numpy as np
import pytest

from cassandra_tpu_torch.scripts import check_metric_names
from cassandra_tpu_torch.scripts import check_profiler
from cassandra_tpu_torch.scripts import check_static
from cassandra_tpu_torch.scripts import stress
from gates_ab import jax_gate
from torch_tmp import tmp_path  # noqa: F401

DISTS = ["uniform", "zipf", "sequential"]


@pytest.mark.parametrize("dist", DISTS)
def test_stress_keys_equal_the_jax_package(dist):
    """The streams tests/test_slo.py pins for the JAX driver: seeded
    streams, sequential slices per worker (divisible and not), and the
    wrap past a slice's share."""
    jst = jax_gate("stress")
    for n, space, worker, workers in ((64, 512, 3, 8), (40, 320, 2, 8),
                                      (120, 320, 2, 8), (512, 512, 5, 6)):
        seed = 7 * 100_000 + worker
        a = stress._keys(dist, n, space, np.random.default_rng(seed),
                         worker, workers)
        b = jst._keys(dist, n, space, np.random.default_rng(seed),
                      worker, workers)
        assert np.array_equal(np.asarray(a), np.asarray(b)), \
            (dist, n, space, worker, workers)


def test_stress_sequential_slices_cover_the_key_space():
    seen = set()
    for w in range(6):
        sl = {int(k) for k in stress._keys("sequential", 512, 512, None,
                                           w, 6)}
        assert sl.isdisjoint(seen)
        seen |= sl
    assert seen == set(range(512))


def test_profiler_retrace_sentinel_counts(tmp_path):
    """7 shapes at budget 2: 7 compiles, 5 retraces, exactly one
    profile.retrace event, through a plain torch probe on the CPU."""
    from cassandra_tpu_torch.service import profiling

    before = profiling.GLOBAL.retrace_budget
    assert check_profiler.check_sentinel(str(tmp_path), device="cpu") == []
    # the gate puts the registry's budget back
    assert profiling.GLOBAL.retrace_budget == before


def test_profiler_gate_exits_zero(tmp_path, monkeypatch):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert check_profiler.main(["--device", "cpu"]) == 0


def test_metric_names_scan_the_port_tree():
    assert check_metric_names.scan() == []
    assert check_metric_names.check_name("incr", "cql.request")
    assert check_metric_names.check_name("incr", "table.{ks}.{t}.writes")
    assert check_metric_names.check_name("hist", "read_latency")
    assert not check_metric_names.check_name("incr", "NoDots")
    assert not check_metric_names.check_name("incr", "Bad.Name")
    assert not check_metric_names.check_name("incr", "bad..name")


def test_metric_names_scan_walks_the_scripts_and_the_port_groups():
    """The scan reads this subpackage's files with the rest of the
    port, and a port-only group passes only as listed."""
    from cassandra_tpu_torch.analysis.walker import project_files

    scripts = os.path.dirname(os.path.abspath(stress.__file__))
    assert any(p.startswith(scripts) for p in project_files())
    assert check_metric_names.check_name("incr", "device_pack.tried.meta")
    assert "device_pack" in check_metric_names.PORT_GROUPS
    assert not check_metric_names.check_name("incr", "nogroup.tried.meta")


def test_metric_names_docs_match_the_smoke(monkeypatch):
    """The smoke's names against the catalog, from a registry without
    counters or histograms (the registry is process-wide: earlier
    tests' engines would add their own tables' names, as a fresh
    process's run does not; the process-wide gauges, such as the
    compress pool's, stay)."""
    from cassandra_tpu_torch.service.metrics import GLOBAL

    monkeypatch.setattr(GLOBAL, "_counters", {})
    monkeypatch.setattr(GLOBAL, "_hists", {})
    monkeypatch.setattr(GLOBAL, "_gauges", dict(GLOBAL._gauges))
    assert check_metric_names.diff_docs(device="cpu") == []


def test_check_static_fast_exits_zero(capsys):
    assert check_static.main(["--fast"]) == 0
    assert "ctpulint OK" in capsys.readouterr().out


def test_check_static_lists_its_checks(capsys):
    assert check_static.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in ("lock-order", "loop-blocking", "knob-wiring",
                 "worker-loops", "clock-discipline"):
        assert name in out
