"""K1 (sort permutation) and K2 (reconcile) of the PyTorch/CUDA port
against the JAX package's `device_sort_perm` and `reconcile_kernel`.

The same CellBatches (built by the JAX package, the random and directed
cases of tests/test_merge_device.py) go through both packages' operand
packers and kernels; every comparison is exact. Here the port's kernel
wrappers get CPU tensors and so run the plain PyTorch versions; the CUDA
kernels are held against those versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
from __future__ import annotations

import numpy as np
import pytest

from cassandra_tpu.ops import merge as jmerge
from cassandra_tpu.schema import COL_REGULAR_BASE
from cassandra_tpu.storage import cellbatch as jcb
from test_merge_device import T, ck, pk, random_batches

from cassandra_tpu_torch import interop
from cassandra_tpu_torch.ops import merge as tmerge


def _directed_batch():
    b = jcb.CellBatchBuilder(T)
    V = COL_REGULAR_BASE
    b.add_cell(pk(1), ck(1), V, b"old", 100)
    b.add_cell(pk(1), ck(1), V, b"new", 200)
    b.add_tombstone(pk(1), ck(2), V, 100, 1000)
    b.add_cell(pk(1), ck(2), V, b"dead", 100)      # equal ts: tombstone wins
    b.add_cell(pk(2), ck(1), V, b"abcdA", 100)
    b.add_cell(pk(2), ck(1), V, b"abcdZ", 100)     # tie beyond prefix
    b.add_partition_deletion(pk(3), 500, 1000)
    b.add_cell(pk(3), ck(1), V, b"shadowed", 400)
    b.add_row_deletion(pk(4), ck(1), 300, 50)
    b.add_cell(pk(4), ck(1), V, b"under-row-del", 250)
    b.add_cell(pk(4), ck(2), V, b"ttl", 260, ttl=5, now=10)
    return [b.seal()]


def _guard(s):
    return (s.ts % 7) * 5          # arbitrary per-cell purge guard


# (case, n_cells per batch, gc_before, now, purge guard): N = 1024 and 4096
CASES = [
    ("random-1", 1, 200, 0, 0, None),
    ("random-2", 2, 900, 0, 0, None),
    ("random-gc", 7, 200, 50, 60, None),
    ("random-gc-4k", 8, 900, 50, 60, None),
    ("purge-guard", 11, 200, 80, 60, _guard),
    ("directed", None, None, 0, 0, None),
    ("directed-gc", None, None, 2000, 2000, None),
]


def _operands(case):
    _name, seed, n_cells, gc_before, now, guard = case
    batches = _directed_batch() if seed is None \
        else random_batches(seed, n_cells=n_cells)
    cat = jcb.CellBatch.concat(batches)
    jops = jmerge.build_operands(cat, gc_before=gc_before, now=now,
                                 purgeable_ts_fn=guard)
    return cat, jops, guard, gc_before, now


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sort_and_reconcile_match_jax(case):
    cat, jops, guard, gc_before, now = _operands(case)
    N = jops["lanes"].shape[0]
    assert N in (1024, 4096)
    jperm = jmerge.device_sort_perm(jops)
    jpacked = np.asarray(jmerge.reconcile_kernel(jops, jperm))

    # the port's own packer, fed the same cells, gives the same operands
    tcat = interop.cellbatch_from(cat)
    tops_np = tmerge.build_operands(tcat, gc_before=gc_before, now=now,
                                    purgeable_ts_fn=guard)
    assert set(tops_np) == set(jops)
    for k, v in tops_np.items():
        assert np.array_equal(np.asarray(v), np.asarray(jops[k])), k

    tops = interop.operands_from_numpy(jops, "cpu")
    tperm = tmerge.device_sort_perm(tops)
    assert np.array_equal(tperm.numpy(), np.asarray(jperm))
    tpacked = tmerge.reconcile_kernel(tops, tperm)
    assert tpacked.numpy().dtype == np.uint8
    assert np.array_equal(tpacked.numpy(), jpacked)
    # the masks are not trivial on these inputs
    keep, amb, expired, shadowed = tmerge.unpack_masks(tpacked.numpy())
    assert keep.any() and (~keep[:len(cat)]).any()


def test_sort_is_stable_on_equal_keys():
    """Equal (identity, ts) rows keep their input order (the host
    tie-break's first-seen rule depends on it)."""
    cat, jops, *_ = _operands(CASES[0])
    dup = {k: (np.asarray(v).copy() if np.ndim(v) else v)
           for k, v in jops.items()}
    n = len(cat)
    dup["lanes"][1:n] = dup["lanes"][0]
    dup["ts_h"][1:n] = dup["ts_h"][0]
    dup["ts_l"][1:n] = dup["ts_l"][0]
    tperm = tmerge.device_sort_perm(interop.operands_from_numpy(dup, "cpu"))
    assert np.array_equal(tperm.numpy()[:n], np.arange(n))
    assert np.array_equal(np.asarray(jmerge.device_sort_perm(dup)),
                          tperm.numpy())


def test_host_passes_match_jax():
    """host_tiebreak + finalize_merged (copies) over the kernels' masks
    give the JAX package's merged batch."""
    cat, jops, guard, gc_before, now = _operands(CASES[2])
    tops = interop.operands_from_numpy(jops, "cpu")
    perm = tmerge.device_sort_perm(tops).numpy().astype(np.int64)[:len(cat)]
    keep, amb, expired, shadowed = tmerge.unpack_masks(
        tmerge.reconcile_kernel(tops, tmerge.device_sort_perm(tops))
        .numpy()[:len(cat)])
    tcat = interop.cellbatch_from(cat)
    tmerge.host_tiebreak(tcat, perm, keep, amb, shadowed, expired,
                         gc_before, None)
    out = tmerge.finalize_merged(tcat, perm, keep, expired, shadowed)
    ref = jcb.merge_sorted(random_batches(7, n_cells=200),
                           gc_before=gc_before, now=now)
    assert len(out) == len(ref)
    for k in ("lanes", "ts", "ldt", "flags", "payload", "off"):
        assert np.array_equal(getattr(out, k), getattr(ref, k)), k
