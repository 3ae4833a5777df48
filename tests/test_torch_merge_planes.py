"""K6 (`plane_program_fast`, v3 truncated-key planes) and K7
(`plane_program`, v2 planes) of the PyTorch/CUDA port against the JAX
package's `_plane_program_fast` and `_plane_program`, the port's host
packers against the JAX package's byte for byte, and
`merge_sorted_device(device="cpu")` against the JAX package's on the
cases of tests/test_merge_device.py and tests/test_merge_fastpath.py.
Every comparison is exact; the port's wrappers get CPU tensors here and
run the plain PyTorch versions (the CUDA kernels are held against those
on the card: tests/test_torch_cuda.py, chip_smoke.py)."""
from __future__ import annotations

import numpy as np
import pytest

from cassandra_tpu.ops import merge as jmerge
from cassandra_tpu.schema import COL_REGULAR_BASE, make_table
from cassandra_tpu.storage import cellbatch as jcb
from test_merge_device import T, ck, pk, random_batches
from test_merge_fastpath import sorted_live_batches

from cassandra_tpu_torch import interop
from cassandra_tpu_torch.ops import merge as tmerge


def _port(batches):
    return [interop.cellbatch_from(b) for b in batches]


def _guard(s):
    return (s.ts % 7) * 5


def _guard_fast(s):
    return (s.ts % 7) * (1 << 28)


def _directed():
    b = jcb.CellBatchBuilder(T)
    V = COL_REGULAR_BASE
    b.add_cell(pk(1), ck(1), V, b"old", 100)
    b.add_cell(pk(1), ck(1), V, b"new", 200)
    b.add_tombstone(pk(1), ck(2), V, 100, 1000)
    b.add_cell(pk(1), ck(2), V, b"dead", 100)
    b.add_cell(pk(2), ck(1), V, b"abcdA", 100)
    b.add_cell(pk(2), ck(1), V, b"abcdZ", 100)
    b.add_partition_deletion(pk(3), 500, 1000)
    b.add_cell(pk(3), ck(1), V, b"shadowed", 400)
    b.add_row_deletion(pk(4), ck(1), 300, 50)
    b.add_cell(pk(4), ck(1), V, b"under-row-del", 250)
    b.add_complex_deletion(pk(4), ck(2), V + 1, 270, 60)
    b.add_cell(pk(4), ck(2), V + 1, b"under-cdel", 260)
    return [b.seal()]


def _single():
    b = jcb.CellBatchBuilder(T)
    b.add_cell(pk(1), ck(1), COL_REGULAR_BASE, b"v", 1)
    return [b.seal()]


def _counters():
    Tc = make_table("ks", "cnt", pk=["id"], cols={"id": "int",
                                                  "hits": "counter"})
    cid = Tc.columns["hits"].column_id
    idt = Tc.columns["id"].cql_type
    batches = []
    for gen, deltas in enumerate([(3, 4), (5,), (-2,)]):
        b = jcb.CellBatchBuilder(Tc)
        for j, d in enumerate(deltas):
            b.append_raw(idt.serialize(1), b"", cid, b"",
                         (d & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big"),
                         ts=100 * gen + j, flags=jcb.FLAG_COUNTER)
        batches.append(b.seal())
    return batches


# (id, batches, gc_before, now, purge guard, the round's program)
CASES = [
    ("random-1", lambda: random_batches(1), 0, 0, None, "v2"),
    ("random-2", lambda: random_batches(2), 0, 0, None, "v2"),
    ("random-3", lambda: random_batches(3), 0, 0, None, "v2"),
    ("gc-7", lambda: random_batches(7), 50, 60, None, "v2"),
    ("gc-8", lambda: random_batches(8), 50, 60, None, "v2"),
    ("purge-guard", lambda: random_batches(11), 80, 60, _guard, "v2"),
    ("directed", _directed, 0, 0, None, "v2"),
    ("empty", lambda: [jcb.CellBatchBuilder(T).seal()], 0, 0, None, "done"),
    ("single", _single, 0, 0, None, "v2"),
    ("counter-sum", _counters, 0, 0, None, "v2"),
    ("collision-1", lambda: sorted_live_batches(1), 0, 0, None, "fast"),
    ("collision-2", lambda: sorted_live_batches(2), 0, 0, None, "fast"),
    ("collision-3", lambda: sorted_live_batches(3), 0, 0, None, "fast"),
    ("collision-4", lambda: sorted_live_batches(4), 0, 0, None, "fast"),
    ("wide-ts-5", lambda: sorted_live_batches(5, collide=False), 0, 0, None,
     "fast"),
    ("wide-ts-6", lambda: sorted_live_batches(6, collide=False), 0, 0, None,
     "fast"),
    ("ttl-7", lambda: sorted_live_batches(7, ttl_frac=0.3), 35, 30, None,
     "fast"),
    ("ttl-8-guard", lambda: sorted_live_batches(8, ttl_frac=0.3), 35, 30,
     _guard_fast, "fast"),
]


def _assert_equal_batches(a, b):
    assert len(a) == len(b)
    for k in ("lanes", "ts", "ldt", "ttl", "flags", "payload", "off",
              "val_start"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_merge_sorted_device_matches_jax(case):
    _name, make, gc_before, now, guard, mode = case
    batches = make()
    jh = jmerge.submit_merge(batches, gc_before, now, guard)
    assert jh.mode == mode
    ref = jmerge.collect_merge(jh)
    th = tmerge.submit_merge(_port(batches), gc_before, now, guard,
                             device="cpu")
    assert th.mode == mode
    _assert_equal_batches(tmerge.collect_merge(th), ref)
    _assert_equal_batches(
        tmerge.merge_sorted_device(_port(batches), gc_before, now, guard,
                                   device="cpu"), ref)


V2_CASES = [c for c in CASES if c[5] == "v2"]
FAST_CASES = [c for c in CASES if c[5] == "fast"]


@pytest.mark.parametrize("case", V2_CASES, ids=[c[0] for c in V2_CASES])
def test_plane_pack_v2_and_k7_match_jax(case):
    batches = case[1]()
    cat = jcb.CellBatch.concat(batches)
    jplanes, jcfg = jmerge._plane_pack_v2(cat, batches)
    tb = _port(batches)
    tplanes, tcfg = tmerge._plane_pack_v2(tmerge.CellBatch.concat(tb), tb)
    assert tcfg == jcfg
    assert sorted(tplanes) == sorted(jplanes)
    for k, v in jplanes.items():
        assert np.asarray(tplanes[k]).dtype == np.asarray(v).dtype, k
        assert np.array_equal(np.asarray(tplanes[k]), np.asarray(v)), k
    jout = np.asarray(jmerge._plane_program(jplanes, jcfg))
    tout = tmerge.plane_program(interop.planes_from_numpy(jplanes, "cpu"),
                                jcfg)
    assert np.array_equal(tout.numpy().view(np.uint32), jout)


@pytest.mark.parametrize("case", FAST_CASES, ids=[c[0] for c in FAST_CASES])
def test_plane_pack_fast_and_k6_match_jax(case):
    batches = case[1]()
    jbuf, jcfg, jmeta = jmerge._plane_pack_fast(
        jcb.CellBatch.concat(batches), batches)
    tb = _port(batches)
    tbuf, tcfg, tmeta = tmerge._plane_pack_fast(
        tmerge.CellBatch.concat(tb), tb)
    assert tcfg == jcfg
    assert tbuf.dtype == np.uint8 and np.array_equal(tbuf, jbuf)
    for k in ("n", "k", "bases", "counts"):
        assert np.array_equal(tmeta[k], jmeta[k]), k
    jout = np.asarray(jmerge._plane_program_fast(jbuf, jcfg))
    tout = tmerge.plane_program_fast(interop.planes_from_numpy(jbuf, "cpu"),
                                     jcfg)
    assert np.array_equal(tout.numpy(), jout)


def test_cdel_and_wide_hi_planes_match_jax():
    """A v2 round with complex deletions (the cdel plane) and stamps
    whose top 16 bits vary (the ts_hi plane)."""
    batches = _directed()
    b = jcb.CellBatchBuilder(T)
    b.add_cell(pk(5), ck(1), COL_REGULAR_BASE, b"far", 1 << 50)
    b.add_cell(pk(5), ck(1), COL_REGULAR_BASE, b"near", 1 << 20)
    batches.append(b.seal())
    cat = jcb.CellBatch.concat(batches)
    jplanes, jcfg = jmerge._plane_pack_v2(cat, batches)
    assert jcfg[3] and jcfg[4]                 # has_hi, has_cdel
    jout = np.asarray(jmerge._plane_program(jplanes, jcfg))
    tout = tmerge.plane_program(interop.planes_from_numpy(jplanes, "cpu"),
                                jcfg)
    assert np.array_equal(tout.numpy().view(np.uint32), jout)
    _assert_equal_batches(
        tmerge.merge_sorted_device(_port(batches), device="cpu"),
        jmerge.merge_sorted_device(batches))


@pytest.mark.parametrize("program", ["fast", "v2"])
def test_non_power_of_two_pad(monkeypatch, program):
    """With the pad quantum at 4,096 in both packages, a round of 8,193 to
    12,288 cells pads to N = 12,288, which is not a power of two."""
    monkeypatch.setattr(jmerge, "_PAD_QUANTUM", 4096)
    monkeypatch.setattr(tmerge, "_PAD_QUANTUM", 4096)
    if program == "fast":
        batches = sorted_live_batches(9, n_cells=2600, n_parts=400,
                                      n_cks=50)
    else:
        batches = random_batches(9, n_cells=2500, n_parts=400, n_cks=50)
    n = sum(len(b) for b in batches)
    assert 8192 < n <= 12288
    assert tmerge._plane_pad(n) == jmerge._plane_pad(n) == 12288
    jh = jmerge.submit_merge(batches)
    th = tmerge.submit_merge(_port(batches), device="cpu")
    assert jh.mode == th.mode == program
    assert th.fut.shape[0] == 12288
    assert np.array_equal(th.fut.numpy().view(np.asarray(jh.fut).dtype),
                          np.asarray(jh.fut))
    _assert_equal_batches(tmerge.collect_merge(th), jmerge.collect_merge(jh))


def test_unsorted_run_rebuild_raises():
    """The v3 permutation rebuild counts each run's rows in the sorted
    output; a count that disagrees with the run's length raises, as in
    the JAX package."""
    batches = sorted_live_batches(3)
    tb = _port(batches)
    h = tmerge.submit_merge(tb, device="cpu")
    assert h.mode == "fast"
    h.meta["counts"] = h.meta["counts"].copy()
    h.meta["counts"][0] += 1
    with pytest.raises(RuntimeError, match="src-count mismatch"):
        tmerge.collect_merge(h)
