"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and per-layer metric loads by its name."""
import json
import os
import re

import pytest

import _paths
from harness import costs, spec

with open(os.path.join(_paths.ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = spec.Cell(name, SPEC)
    assert cell.chips == 1
    for key in ("source", "n", "reduced", "assumed", "reference",
                "compaction_throughput", "compaction_compressor_threads"):
        assert key in cell.config
    assert cell.config["reduced"] == ["n"]
    assert {"passes", "flushes_per_pass", "ts_step_us"} <= set(cell.traffic)
    assert {m["name"] for m in cell.end_to_end} == {"compaction_mib_s",
                                                    "setup_s"}
    assert cell.per_layer
    assert cell.reference().LIMITS


def test_per_layer_metrics_have_readers_and_cells():
    moves = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in moves
        assert set(m["workloads"]) <= set(CELLS)
        assert callable(spec.reader(m["name"]))


def test_readers_return_none_where_nothing_is_read():
    ctx = {"profile": {}, "input_bytes": 1 << 30, "lanes": 13,
           "transfers": {"h2d": {"bytes": 0}, "d2h": {"bytes": 0}},
           "launch_sizes": {}, "trace": None}
    for m in SPEC["per_layer"]:
        assert spec.reader(m["name"])(ctx) is None, m["name"]


def test_roofline_reader_sums_launches():
    """The device time is the profiler's, of K1's functions alone (not
    the memsets or torch's kernels beside them)."""
    t = 2 * 1024 * 68 / 3.35e12 * 4
    ops = {"ctpu::(anonymous namespace)::round_pass(ctpu::(anonymous "
           "namespace)::PassArgs, int)": t / 2,
           "void ctpu::(anonymous namespace)::plan_hist<true>(ctpu::"
           "RoundKey, int, int, int*, int*)": t / 2,
           "Memset (Device)": t,
           "void at::native::(anonymous namespace)::CatArrayBatchedCopy"
           "_vectorized<int>(char*)": t}
    ctx = {"lanes": 13, "launch_sizes": {"merge.sort_perm": {1024: 2}},
           "trace": {"ops": ops}}
    got = spec.reader("kernel_roofline_pct.compaction")(ctx)
    assert got == pytest.approx(25.0)


@pytest.mark.parametrize("event, kernel", [
    ("ctpu::(anonymous namespace)::split_pack(ctpu::RoundKey, int, long, "
     "int const*, unsigned int*, int*, int*)", "merge.sort_perm"),
    ("ctpu::(anonymous namespace)::rec_tiles(ctpu::(anonymous namespace)"
     "::RecArgs)", "merge.reconcile"),
    ("ctpu::(anonymous namespace)::cmp_gather(ctpu::(anonymous namespace)"
     "::GatherArgs)", "write.compact_gather"),
    ("ctpu::(anonymous namespace)::meta_tiles(ctpu::(anonymous namespace)"
     "::MetaArgs)", "write.meta_block"),
    ("ctpu::(anonymous namespace)::lz_segment(ctpu::(anonymous namespace)"
     "::LzArgs)", "write.segment_scan"),
    ("Memcpy HtoD (Pinned -> Device)", None),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", None)])
def test_profiler_events_are_matched_to_kernels(event, kernel):
    assert costs.kernel_of(event) == kernel


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        spec.Cell("no-such-cell", SPEC)
