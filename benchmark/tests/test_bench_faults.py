"""A run driven on the CPU (the program's plain kernel versions, the
look for a card skipped) with the timed path broken underneath: each
fault a compaction cell can have must turn `correct` false. A
compaction runs on one card, so no exchange between cards can be left
out. And the control, the reference with millisecond timestamps, must
fail the comparison."""
import json
import os
import time

import pytest
import torch

import _paths
import run
from harness import spec

N = 3000


def _cell(name):
    """A cell of BENCHMARK.json, or `stress-stcs.major`: the default
    deployment's cell, which PERF.md keeps out of the benchmark for now,
    with its configuration file under benchmark/configs/."""
    if name != "stress-stcs.major":
        return spec.Cell(name)
    with open(os.path.join(_paths.ROOT, "BENCHMARK.json")) as f:
        full = json.load(f)
    full["configs"] = full["configs"] + [
        {"name": "stress-stcs",
         "file": "benchmark/configs/stress-stcs.json"}]
    full["workloads"] = full["workloads"] + [
        {"name": name, "config": "stress-stcs", "traffic": "major",
         "chips": 1}]
    return spec.Cell(name, full)


def _run(monkeypatch, name="stress-stcs-hostlz4.major-overwrite", n=N,
         seconds=0.5):
    cell = _cell(name)
    cell.config["n"] = n
    t0 = time.time()
    return run.run_cell(cell, 2**31 + 5, seconds, False,
                        torch.device("cpu"),
                        setup_clock=lambda: time.time() - t0)


@pytest.mark.parametrize("name", ["stress-stcs-hostlz4.major",
                                  "stress-stcs-hostlz4.major-overwrite",
                                  "stress-stcs.major"])
def test_sound_run_is_correct(monkeypatch, name):
    r = _run(monkeypatch, name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"compaction_mib_s", "setup_s"}
    assert list(r)[-1] == "checks"


def test_state_returned_unchanged(monkeypatch):
    from cassandra_tpu_torch.compaction import task
    monkeypatch.setattr(task.CompactionTask, "execute",
                        lambda self: {"cells_written": 0})
    assert not _run(monkeypatch)["correct"]


def test_half_of_each_round_left_out(monkeypatch):
    from cassandra_tpu_torch.ops import device_write
    submit = device_write.submit_merge_resident

    def half(batches, *a, **kw):
        return submit([b.slice_range(0, len(b) // 2) for b in batches],
                      *a, **kw)
    monkeypatch.setattr(device_write, "submit_merge_resident", half)
    r = _run(monkeypatch)
    assert not r["correct"]
    assert r["checks"]["cells_wrong"]["value"] > 0


@pytest.mark.parametrize("column", ["ts_l", "ldt"])
def test_answer_altered_where_produced(monkeypatch, column):
    from cassandra_tpu_torch.ops import device_write
    collect = device_write.collect_merge_resident

    def altered(h):
        r = collect(h)
        r.cols[column].view(-1)[3] += 1
        return r
    monkeypatch.setattr(device_write, "collect_merge_resident", altered)
    r = _run(monkeypatch)
    assert not r["correct"]


def test_outputs_that_differ_between_compactions(monkeypatch):
    """Every second compaction writes one Data.db byte wrong: the checked
    output is sound, the others are not."""
    from cassandra_tpu_torch.compaction import task
    from reference import ctpu_format
    execute = task.CompactionTask.execute
    calls = []

    def flaky(self):
        stats = execute(self)
        calls.append(1)
        if len(calls) % 2 == 0:
            prefix = ctpu_format.sstables_in(self.cfs.directory)[0]
            with open(prefix + "Data.db", "r+b") as f:
                f.seek(100)
                b = f.read(1)
                f.seek(100)
                f.write(bytes([b[0] ^ 1]))
        return stats
    monkeypatch.setattr(task.CompactionTask, "execute", flaky)
    # a window long enough for two compactions or more
    r = _run(monkeypatch, "stress-stcs-hostlz4.major", seconds=3.0)
    assert r["attempted"] >= 2
    assert r["checks"]["outputs_unlike"]["value"] > 0
    assert not r["correct"]


@pytest.mark.parametrize("name", ["stress-stcs.major",
                                  "stress-stcs-hostlz4.major-overwrite"])
def test_control_fails(name):
    import control
    got = control.readings(_cell(name), 11, n=N)
    assert got["cells_wrong"] > 0


@pytest.mark.cuda
def test_cell_correct_on_card():
    """A short run of the host-LZ4 cell on the card (skips without
    one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = run.run_cell(spec.Cell("stress-stcs-hostlz4.major"), 2**31 + 9,
                     2.0, False, torch.device("cuda", 0))
    assert r["correct"], r["checks"]
