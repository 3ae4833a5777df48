"""K9 (the scan pushdown's predicate masks and aggregate fold) of the
PyTorch/CUDA port against the JAX package's jitted `mask_device` /
`_fold` and its numpy `mask_host`, on the same numpy keys from a seed.
Every comparison is exact. The port's wrappers get CPU tensors here
and run the plain PyTorch versions, which compare unsigned 64-bit keys
as int64 after flipping the sign bit."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cassandra_tpu.ops import device_scan as jds
from cassandra_tpu.schema import make_table as j_make_table
from cassandra_tpu.storage import cellbatch as jcb

from cassandra_tpu_torch import interop
from cassandra_tpu_torch.ops import cuda_lib
from cassandra_tpu_torch.ops import device_scan as tds

U64_MAX = (1 << 64) - 1
EDGES = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, U64_MAX - 1, U64_MAX]
OPS = ("eq", "ne", "lt", "ge", "gt", "le", "in", "all")


def _keys(seed: int, n: int) -> np.ndarray:
    """Random u64 keys over the whole range, the edge keys, and
    repeats of them (so every op has hits and misses)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 64, n, dtype=np.uint64, endpoint=False)
    k[:len(EDGES)] = EDGES
    k[len(EDGES):2 * len(EDGES)] = EDGES
    return k


def _pred(kop: str, qkeys, kind: str = "i64", op: str = "<"):
    return jds.CompiledPredicate(9, "v", kind, 4, op, kop,
                                 np.asarray(qkeys, dtype=np.uint64),
                                 True, False)


def _cases():
    for kop in OPS:
        if kop == "in":
            for q in ([], [0], [U64_MAX, 1 << 63, 12345], EDGES):
                yield kop, q
        elif kop == "all":
            yield kop, []
        else:
            for q in EDGES:
                yield kop, [q]


@pytest.mark.parametrize("kop,qkeys", list(_cases()))
def test_mask_matches_jax(kop, qkeys):
    keys = _keys(3, 517)
    pred = _pred(kop, qkeys)
    want = np.asarray(jds.mask_device(keys, pred))
    assert np.array_equal(want, jds.mask_host(keys, pred))
    kt = tds.keys_tensor(keys, "cpu")
    got = tds.scan_mask(kt, kop, pred.qkeys)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    # the entry the store calls, on the CPU device: the same mask, and
    # reported as the K9 leg
    tp = tds.CompiledPredicate(9, "v", "i64", 4, "<", kop, pred.qkeys,
                               True, False)
    mask, on_dev = tds.segment_mask(keys, tp, True, device="cpu")
    assert on_dev and np.array_equal(mask, want)
    if kop == "in" and not qkeys:
        assert not want.any()


@pytest.mark.parametrize("seed,n,p", [(1, 300, 0.5), (2, 64, 0.0),
                                      (4, 1, 1.0), (5, 0, 0.5)])
def test_fold_matches_jax(seed, n, p):
    keys = _keys(seed, max(n, 2 * len(EDGES)))[:n]
    mask = np.random.default_rng(seed).random(n) < p
    fold = jds._kernels()[1]
    hi, lo = jds._split(keys)
    if n:
        cnt, mnh, mnl, mxh, mxl = (int(x) for x in fold(hi, lo, mask))
        want = [cnt, (mnh << 32) | mnl, (mxh << 32) | mxl]
    else:
        want = [0, U64_MAX, 0]       # the fold's sentinels
    got = tds.scan_fold(tds.keys_tensor(keys, "cpu"),
                        torch.from_numpy(mask))
    assert [int(v) & U64_MAX for v in got.tolist()] == want
    if mask.any():
        assert want[1:] == [int(keys[mask].min()), int(keys[mask].max())]


def test_nan_keys_through_nan_fix():
    """f64 keys holding NaNs (both signs) and the signed zeros: the K9
    mask goes through the same host nan_fix as the JAX package's."""
    vals = np.array([1.5, np.nan, -np.nan, -0.0, 0.0, -np.inf, np.inf,
                     -3.25, 2.0, np.nan])
    bits = vals.view(np.uint64)
    neg = (bits >> np.uint64(63)) != 0
    keys = np.where(neg, ~bits, bits | np.uint64(1 << 63))
    for op, kop in (("<", "lt"), ("!=", "ne"), ("=", "eq"),
                    (">=", "ge")):
        q = np.asarray([jds.key_of_value("f64", 0.5)], dtype=np.uint64)
        jp = jds.CompiledPredicate(3, "d", "f64", 8, op, kop, q, True,
                                   False)
        tp = tds.CompiledPredicate(3, "d", "f64", 8, op, kop, q, True,
                                   False)
        want, _ = jds.segment_mask(keys, jp, True)
        got, on_dev = tds.segment_mask(keys, tp, True, device="cpu")
        assert on_dev and np.array_equal(got, want), op
        assert np.array_equal(got, tds.segment_mask(keys, tp, False)[0])
        assert bool(got[1]) is (op == "!=")


def _int_batch(seed: int, n: int):
    """A reconciled JAX CellBatch of n int cells (the value column) with
    some cell tombstones."""
    rng = np.random.default_rng(seed)
    t = j_make_table("ks", "f", pk=["k"], ck=["c"],
                     cols={"k": "int", "c": "int", "v": "int"})
    b = jcb.CellBatchBuilder(t)
    col = t.columns["v"].column_id
    vals = rng.integers(-50, 50, n)
    vals[:2] = [-(1 << 31), (1 << 31) - 1]
    for i, v in enumerate(vals.tolist()):
        pk = t.serialize_partition_key([i % 7])
        ck = t.serialize_clustering([i])
        if i % 11 == 5:
            b.add_tombstone(pk, ck, col, 10, 100)
        else:
            b.add_cell(pk, ck, col, int(v).to_bytes(4, "big", signed=True),
                       10)
    return t, jcb.merge_sorted([b.seal()], now=0)


@pytest.mark.parametrize("op,val", [("<", 0), ("=", 7), (">=", -(1 << 31)),
                                    ("IN", [3, -4, 99]), ("=", 1000)])
def test_fold_batch_matches_jax(op, val):
    t, jb = _int_batch(8, 200)
    jp = jds.compile_predicate(t, [(t.columns["v"], op, val)])
    from cassandra_tpu_torch.schema import make_table
    tt = make_table("ks", "f", pk=["k"], ck=["c"],
                    cols={"k": "int", "c": "int", "v": "int"})
    tp = tds.compile_predicate(tt, [(tt.columns["v"], op, val)])
    assert np.array_equal(tp.qkeys, jp.qkeys) and tp.kop == jp.kop
    tb = interop.cellbatch_from(jb)
    want = jds.fold_batch(jb, jp, True)
    before = cuda_lib.launches()
    got = tds.fold_batch(tb, tp, True, device="cpu")
    assert got == want
    assert tds.fold_batch(tb, tp, False) == want[:4] + (False,)
    # the CPU runs the plain versions: nothing counts as a launch
    assert cuda_lib.launches() == before
    if op == "=" and val == 1000:
        assert got == (0, None, None, 0, True)      # all-false fold


def test_fold_batch_with_no_cell_reports_the_leg():
    t, jb = _int_batch(9, 10)
    from cassandra_tpu_torch.schema import make_table
    tt = make_table("ks", "f", pk=["k"], ck=["c"],
                    cols={"k": "int", "c": "int", "v": "int", "w": "int"})
    tp = tds.compile_predicate(tt, [(tt.columns["w"], "=", 1)])
    tb = interop.cellbatch_from(jb)
    # no cell of the column: (0, None, None, 0, use_device)
    assert tds.fold_batch(tb, tp, True, device="cpu") == \
        (0, None, None, 0, True)
    assert tds.fold_batch(tb, tp, False) == (0, None, None, 0, False)


def test_device_leg_raises_without_a_card():
    """With the gate on, the default device is `cuda`: without a card
    the K9 leg raises instead of running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device launches")
    keys = _keys(1, 20)
    tp = tds.CompiledPredicate(9, "v", "i64", 4, "<", "lt",
                               np.asarray([5], dtype=np.uint64), True, False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.segment_mask(keys, tp, True)
    from cassandra_tpu_torch.schema import make_table
    tt = make_table("ks", "f", pk=["k"], ck=["c"],
                    cols={"k": "int", "c": "int", "v": "int"})
    tp = tds.compile_predicate(tt, [(tt.columns["v"], "<", 5)])
    _t, jb = _int_batch(2, 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tds.fold_batch(interop.cellbatch_from(jb), tp, True)
