"""K3 (the resident round: sort + reconcile + kept-first gather) and K4
(the META-block serializer) of the PyTorch/CUDA port against the JAX
package's `_resident_program`, `_meta_block_kernel` and the host
`build_meta_block`. Same numpy inputs from a seed; every comparison is
exact. The port's wrappers get CPU tensors here and run the plain
PyTorch versions."""
from __future__ import annotations

import numpy as np
import pytest

from cassandra_tpu.ops import device_write as jdw
from cassandra_tpu.storage import cellbatch as jcb
from cassandra_tpu.storage.sstable.writer import build_meta_block
from test_merge_device import random_batches

from cassandra_tpu_torch import interop
from cassandra_tpu_torch.ops import device_write as tdw
from cassandra_tpu_torch.storage.sstable.writer import \
    build_meta_block as t_build_meta_block


def _guard(s):
    return (s.ts % 7) * 5


@pytest.mark.parametrize("seed,n_cells,gc_before,now,guard", [
    (1, 200, 0, 0, None),
    (7, 900, 50, 60, None),
    (11, 200, 80, 60, _guard),
])
def test_resident_program_matches_jax(seed, n_cells, gc_before, now, guard):
    cat = jcb.CellBatch.concat(random_batches(seed, n_cells=n_cells))
    jops, jpts = jdw.build_resident_operands(cat, gc_before, now, guard)
    jout = jdw._resident_program(jops)

    tcat = interop.cellbatch_from(cat)
    tops_np, tpts = tdw.build_resident_operands(tcat, gc_before, now, guard)
    for k, v in tops_np.items():
        assert np.array_equal(np.asarray(v), np.asarray(jops[k])), k
    assert (tpts is None) == (jpts is None)

    tops = interop.operands_from_numpy(jops, "cpu")
    counts, perm_out, cols, perm, packed = tdw.resident_program(tops)
    # the JAX program's seven outputs: n_keep, n_amb, n_exp_kept,
    # perm_out, cols, perm, packed
    assert counts.tolist() == [int(x) for x in jout[:3]]
    assert counts[0] > 0 and counts[1] > 0         # kept and tied cells
    assert np.array_equal(perm_out.numpy(), np.asarray(jout[3]))
    assert set(cols) == set(jout[4]) == set(tdw.RESIDENT_COLS)
    for k in tdw.RESIDENT_COLS:
        t = cols[k].numpy()
        j = np.asarray(jout[4][k])
        assert np.array_equal(t.view(j.dtype) if t.dtype != j.dtype else t,
                              j), k
    assert np.array_equal(perm.numpy(), np.asarray(jout[5]))
    assert np.array_equal(packed.numpy(), np.asarray(jout[6]))


def _segment(seed: int, n: int):
    rng = np.random.default_rng(seed)
    ts = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    ts[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]
    ldt = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    ldt[4:6] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    ttl = rng.integers(0, 1 << 20, n).astype(np.int32)
    flags = rng.integers(0, 256, n).astype(np.uint8)
    fl = rng.integers(0, 1 << 16, n).astype(np.uint32)
    fl[6] = 0xFFFFFFFF
    vr = rng.integers(0, 1 << 12, n).astype(np.uint32)
    return ts, ldt, ttl, flags, fl, vr


@pytest.mark.parametrize("seed,n", [(3, 4096), (4, 1027)])
def test_meta_block_matches_jax_and_host(seed, n):
    """Byte identity with the JAX kernel and the host builder, extreme
    timestamps and an n that is not a multiple of 4 included."""
    import jax.numpy as jnp
    import torch

    ts, ldt, ttl, flags, fl, vr = _segment(seed, n)
    with np.errstate(over="ignore"):
        uts = ts.astype(np.uint64) ^ np.uint64(1 << 63)
    ts_h = (uts >> np.uint64(32)).astype(np.uint32)
    ts_l = (uts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    host = build_meta_block(ts, ldt, ttl, flags,
                            fl.astype("<u4"), vr.astype("<u4"))
    assert np.array_equal(
        t_build_meta_block(ts, ldt, ttl, flags, fl.astype("<u4"),
                           vr.astype("<u4")), host)
    jmeta, jst = jdw._meta_block_kernel(
        jnp.asarray(ts_h), jnp.asarray(ts_l), jnp.asarray(ldt),
        jnp.asarray(ttl), jnp.asarray(flags), jnp.asarray(fl),
        jnp.asarray(vr))

    cols = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                             else a) for a in (ts_h, ts_l, ldt, ttl, flags,
                                               fl, vr)]
    tmeta, tst = tdw.meta_block_kernel(*cols)
    assert tmeta.dtype == torch.uint8 and tmeta.shape == (25 * n,)
    assert bytes(tmeta.numpy()) == bytes(np.asarray(jmeta)) == bytes(host)
    jstats = (jdw._uts_pair_to_i64(jst[0], jst[1]),
              jdw._uts_pair_to_i64(jst[2], jst[3]),
              int(jst[4]), int(jst[5]), int(jst[6]))
    assert tdw.meta_stats(tst) == jstats
    assert jstats[:4] == (int(ts.min()), int(ts.max()), int(ldt.min()),
                          int(ldt.max()))
