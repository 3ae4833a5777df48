"""The port's mesh data plane (cassandra_tpu_torch/parallel/mesh.py, the
mesh step K8) against the JAX package's parallel/mesh.py on the CPU.
The same numpy inputs build each package's CellBatches; JAX runs on its
8 virtual CPU devices (tests/conftest.py) and the port on
make_mesh(8, device="cpu"), where the kernels run their plain PyTorch
versions. Every comparison is exact."""
from __future__ import annotations

import hashlib
import os
import threading

import numpy as np
import pytest
import torch

from cassandra_tpu.parallel import mesh as jm
from cassandra_tpu.schema import make_table as j_make_table
from cassandra_tpu.storage import cellbatch as jcb
from cassandra_tpu.tools import bulk as jbulk

from cassandra_tpu_torch.ops import cuda_lib
from cassandra_tpu_torch.parallel import mesh as tm
from cassandra_tpu_torch.schema import make_table as t_make_table
from cassandra_tpu_torch.service.profiling import DeviceProgramRegistry
from cassandra_tpu_torch.storage import cellbatch as tcb
from cassandra_tpu_torch.tools import bulk as tbulk
from torch_tmp import tmp_path  # noqa: F401

S = 8
NOW = 1_700_000_000


def _tables(name: str, value: str = "blob"):
    cols = {"id": "int", "c": "int", "v": value}
    jt = j_make_table("ks", name, pk=["id"], ck=["c"], cols=cols)
    tt = t_make_table("ks", name, pk=["id"], ck=["c"], cols=cols)
    tt.id = jt.id
    return jt, tt


def _meshes():
    return jm.make_mesh(S), tm.make_mesh(S, device="cpu")


def _uniform(seed: int, n: int = 4096, parts: int = 64):
    """__graft_entry__._example_operands' inputs, as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, parts, n), rng.integers(1, 50, n),
            rng.integers(97, 122, (n, 16), dtype=np.uint8),
            rng.integers(1, 1000, n).astype(np.int64))


def _skewed(seed: int, n: int, parts: int = 4096):
    """__graft_entry__._skewed_batch's inputs: ~40% in 2 partitions."""
    rng = np.random.default_rng(seed)
    hot = rng.random(n) < 0.4
    pk = np.where(hot, rng.integers(0, 2, n), rng.integers(2, parts, n))
    return (pk, rng.integers(1, 10_000, n),
            rng.integers(97, 122, (n, 16), dtype=np.uint8),
            rng.integers(1, 1 << 40, n).astype(np.int64))


def _bulk(inputs: list, name: str):
    """(jax table, port table, jax batches, port batches)."""
    jt, tt = _tables(name)
    return (jt, tt, [jbulk.build_int_batch(jt, *x) for x in inputs],
            [tbulk.build_int_batch(tt, *x) for x in inputs])


def _deletions(cbmod, table, seed: int):
    """Two runs over 40 partitions with cell, row and partition
    deletions, TTL cells (some expired at NOW), equal-ts duplicates and
    old tombstones that gc_before purges."""
    rng = np.random.default_rng(seed)
    pk = [table.serialize_partition_key([p]) for p in range(40)]
    col = table.columns["v"].column_id
    out = []
    for g in range(2):
        b = cbmod.CellBatchBuilder(table)
        for _ in range(600):
            p, c = int(rng.integers(0, 40)), int(rng.integers(0, 12))
            ts = int(rng.choice([100, 101, int(rng.integers(1, 500))]))
            ck = table.serialize_clustering([c])
            r = rng.random()
            if r < 0.1:
                b.add_tombstone(pk[p], ck, col, ts,
                                int(rng.choice([1000, NOW])))
            elif r < 0.15:
                b.add_row_deletion(pk[p], ck, ts, NOW)
            elif r < 0.3:
                b.add_cell(pk[p], ck, col, b"ttl%d" % g, ts, ttl=60,
                           now=NOW - int(rng.choice([0, 120])))
            else:
                b.add_cell(pk[p], ck, col, bytes(rng.integers(97, 122, 3)),
                           ts)
        for p in rng.choice(40, 2, replace=False).tolist():
            b.add_partition_deletion(pk[p], 150 + g, NOW)
        out.append(b.seal())
    return out


def _deletion_case():
    jt, tt = _tables("dels", "text")
    return jt, tt, _deletions(jcb, jt, 5), _deletions(tcb, tt, 5)


CASES = {
    "uniform-8k": lambda: _bulk([_uniform(0), _uniform(1)], "uni"),
    "deletions": _deletion_case,
}
GC = {"uniform-8k": (0, 0), "deletions": (2000, NOW)}


def _batch_fields(b) -> dict:
    return {f: getattr(b, f) for f in ("lanes", "ts", "ldt", "ttl", "flags",
                                       "off", "val_start", "payload")}


def test_port_batches_equal_jax_batches():
    for case in CASES.values():
        _jt, _tt, jb, tb = case()
        for a, b in zip(jb, tb):
            for f, v in _batch_fields(a).items():
                np.testing.assert_array_equal(v, getattr(b, f), err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_sharded_merge_matches_jax(case):
    _jt, _tt, jb, tb = CASES[case]()
    gc_before, now = GC[case]
    jmesh, tmesh = _meshes()
    jout = jm.run_sharded_merge(jcb.CellBatch.concat(jb), jmesh,
                                gc_before, now)
    tout = tm.run_sharded_merge(tcb.CellBatch.concat(tb), tmesh,
                                gc_before, now)
    for name, a, b in zip(("keep", "perm", "stats", "shard_of", "pos"),
                          jout, tout):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    assert int(tout[2][0]) > 0 and int(tout[2][1]) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_materialize_sharded_merge_matches_jax(case):
    _jt, _tt, jb, tb = CASES[case]()
    gc_before, now = GC[case]
    jmesh, tmesh = _meshes()
    jw, tw, jd, td = [], [], [], []
    js = jm.materialize_sharded_merge(jcb.CellBatch.concat(jb), jmesh,
                                      gc_before, now, walls_out=jw,
                                      dispatch_out=jd)
    ts = tm.materialize_sharded_merge(tcb.CellBatch.concat(tb), tmesh,
                                      gc_before, now, walls_out=tw,
                                      dispatch_out=td)
    assert len(ts) == len(js) == S
    assert len(tw) == S and len(td) == 1 and td[0] > 0
    for a, b in zip(js, ts):
        for f, v in _batch_fields(a).items():
            np.testing.assert_array_equal(v, getattr(b, f), err_msg=f)
    # and the shards concatenate to the port's single host merge
    merged = tcb.CellBatch.concat([x for x in ts if len(x)])
    ref = tcb.merge_sorted(tb, gc_before, now)
    for f, v in _batch_fields(ref).items():
        np.testing.assert_array_equal(v, getattr(merged, f), err_msg=f)


def _full_and_empty_boundaries(cat) -> np.ndarray:
    """Token boundaries for S shards over a batch of 8 input cells per
    partition: shard 0 takes the first 128 partitions in token order
    (exactly 1,024 cells, the padded N: a full shard), shard 1 none (an
    empty shard), the rest split the remaining partitions."""
    uniq = np.unique(tm.batch_tokens_u64(cat))
    first = uniq[127]
    rest = np.array_split(uniq[128:], S - 2)
    return np.array([first, first] + [r[-1] for r in rest[:-1]],
                    dtype=np.uint64)


def _full_shard_case():
    """300 partitions x 8 input cells: cks 0-3 in one run and 2-5 in
    the other, so two cells per partition collide (newer or equal ts)."""
    def run(seed, cks):
        rng = np.random.default_rng(seed)
        pk = np.repeat(np.arange(300), len(cks))
        ck = np.tile(cks, 300)
        ts = rng.choice(np.array([7, 8, 9]), len(pk)).astype(np.int64)
        vals = rng.integers(97, 122, (len(pk), 8), dtype=np.uint8)
        return pk, ck, vals, ts
    return _bulk([run(1, np.arange(4)), run(2, np.arange(2, 6))], "full")


def test_sharded_merge_step_matches_jax_with_full_and_empty_shard():
    _jt, _tt, jb, tb = _full_shard_case()
    jcat, tcat = jcb.CellBatch.concat(jb), tcb.CellBatch.concat(tb)
    bounds = _full_and_empty_boundaries(jcat)
    jops, jso, jpos, jmem = jm.shard_batch(jcat, S, boundaries=bounds)
    tops, tso, tpos, tmem = tm.shard_batch(tcat, S, boundaries=bounds)
    assert [len(m) for m in tmem][:2] == [1024, 0]
    assert tops["valid"].shape == (S, 1024)          # shard 0 is full
    for k, v in jops.items():
        np.testing.assert_array_equal(v, tops[k], err_msg=k)
    np.testing.assert_array_equal(jso, tso)
    np.testing.assert_array_equal(jpos, tpos)
    jmesh, tmesh = _meshes()
    jperm, jpacked, jstats = jm.sharded_merge_step(jmesh)(jops)
    tperm, tpacked, tstats = tm.sharded_merge_step(tmesh)(tops)
    np.testing.assert_array_equal(np.asarray(jperm), tperm.numpy())
    np.testing.assert_array_equal(np.asarray(jpacked), tpacked.numpy())
    np.testing.assert_array_equal(np.asarray(jstats), tstats.numpy())
    assert tm.sharded_merge_step(tmesh) is tm.sharded_merge_step(tmesh)
    # the step's masks are the per-device path's before its tie-break
    keep, perm, _stats, _so, _pos = tm.run_sharded_merge(
        tcat, tmesh, boundaries=bounds)
    for s in range(S):
        c = len(tmem[s])
        np.testing.assert_array_equal(perm[s, :c], tperm[s, :c].numpy())
    assert (tpacked[:, :] & 2).any()                   # ties were seen


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_jax(case):
    _jt, _tt, jb, tb = CASES[case]()
    gc_before, now = GC[case]
    jops = jm.shard_batch(jcb.CellBatch.concat(jb), S, gc_before, now)[0]
    tops = tm.shard_batch(tcb.CellBatch.concat(tb), S, gc_before, now)[0]
    jmesh, tmesh = _meshes()
    jout = jm.sharded_merge_step(jmesh)(jops)
    tout = tm.sharded_merge_step(tmesh)(tops)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _sha(directory: str) -> dict:
    out = {}
    for fn in sorted(os.listdir(directory)):
        with open(os.path.join(directory, fn), "rb") as f:
            out[fn] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_compact_to_sstables_sha256_equal(tmp_path, case):
    jt, tt, jb, tb = CASES[case]()
    gc_before, now = GC[case]
    jmesh, tmesh = _meshes()
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jr = jm.sharded_compact_to_sstables(jb, jt, jmesh, str(tmp_path / "jax"),
                                        generation_base=10,
                                        gc_before=gc_before, now=now)
    tr = tm.sharded_compact_to_sstables(tb, tt, tmesh,
                                        str(tmp_path / "port"),
                                        generation_base=10,
                                        gc_before=gc_before, now=now)
    assert [d.generation for d, _ in tr] == [d.generation for d, _ in jr]
    assert len(tr) >= 2
    jh, th = _sha(str(tmp_path / "jax")), _sha(str(tmp_path / "port"))
    assert th == jh and len(th) >= 4 * len(tr)


def _equal_ts_pair(cbmod, table):
    col = table.columns["v"].column_id
    pk = table.serialize_partition_key([1])
    ck = table.serialize_clustering([1])
    b1 = cbmod.CellBatchBuilder(table)
    b1.add_cell(pk, ck, col, b"live", 100)
    b2 = cbmod.CellBatchBuilder(table)
    b2.add_tombstone(pk, ck, col, 100, 1000)
    return cbmod.CellBatch.concat([b1.seal(), b2.seal()])


@pytest.mark.parametrize("gc_before", [0, 2000])
def test_equal_ts_tombstone_and_stats_before_and_after_tiebreak(gc_before):
    """tests/test_parallel.py:51 on the port: the host tie-break runs on
    the sharded path, so the tombstone wins. sharded_merge_step's stats
    are the kernel's, before the tie-break; run_sharded_merge's after
    it. With gc_before past the tombstone's ldt the winner is purged:
    the step counts the live cell it kept (1, 1), the sharded merge
    nothing (0, 2). Both as in the JAX package."""
    jt, tt = _tables("eqts")
    jcat, tcat = _equal_ts_pair(jcb, jt), _equal_ts_pair(tcb, tt)
    jmesh, tmesh = _meshes()
    keep, perm, stats, shard_of, pos = tm.run_sharded_merge(
        tcat, tmesh, gc_before)
    jout = jm.run_sharded_merge(jcat, jmesh, gc_before)
    for a, b in zip(jout, (keep, perm, stats, shard_of, pos)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    step_stats = tm.sharded_merge_step(tmesh)(
        tm.shard_batch(tcat, S, gc_before)[0])[2]
    jstep = jm.sharded_merge_step(jmesh)(jm.shard_batch(jcat, S,
                                                        gc_before)[0])[2]
    np.testing.assert_array_equal(np.asarray(jstep), step_stats.numpy())
    assert step_stats.tolist() == [1, 1]
    if gc_before == 0:
        assert stats.tolist() == [1, 1]
        s = int(shard_of[0])
        kept_pos = np.flatnonzero(keep[s])[0]
        members = np.flatnonzero(shard_of == s)
        assert tcat.flags[members[perm[s, kept_pos]]] & tcb.FLAG_TOMBSTONE
    else:
        assert stats.tolist() == [0, 2]


def test_failed_shard_write_leaves_no_partial_round(tmp_path, monkeypatch):
    """tests/test_parallel.py:163 on the port: one shard's writer dies
    mid-round and no earlier shard's sstable survives."""
    from cassandra_tpu_torch.storage.sstable import writer as writer_mod

    _jt, tt, _jb, tb = CASES["uniform-8k"]()
    calls = {"n": 0}
    real_finish = writer_mod.SSTableWriter.finish

    def failing_finish(self):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("injected shard write failure")
        return real_finish(self)

    monkeypatch.setattr(writer_mod.SSTableWriter, "finish", failing_finish)
    with pytest.raises(OSError, match="injected"):
        tm.sharded_compact_to_sstables(tb, tt, tm.make_mesh(S, device="cpu"),
                                       str(tmp_path))
    assert calls["n"] == 3
    assert os.listdir(tmp_path) == []


def test_skewed_round_imbalance_and_shards_match_jax():
    """The skewed round's shape (~40% of the cells in two hot partitions,
    4,096 partitions, seeds 2 and 3) at 2 x 131,072 cells: the shards'
    kept cells are as the JAX package's, and max/mean <= 1.2."""
    n = 131_072
    _jt, _tt, jb, tb = _bulk([_skewed(2, n), _skewed(3, n)], "skew")
    jcat, tcat = jcb.CellBatch.concat(jb), tcb.CellBatch.concat(tb)
    jmesh, tmesh = _meshes()
    tsh = tm.materialize_sharded_merge(tcat, tmesh)
    jsh = jm.materialize_sharded_merge(jcat, jmesh)
    sizes = [len(x) for x in tsh]
    assert sizes == [len(x) for x in jsh]
    assert all(sizes)
    assert tm.shard_imbalance(sizes) <= 1.2, sizes
    for a, b in zip(jsh, tsh):
        np.testing.assert_array_equal(a.lanes, b.lanes)
        np.testing.assert_array_equal(a.ts, b.ts)


def test_mesh_shapes_and_cpu_mesh():
    mesh = tm.make_mesh(S, device="cpu")
    assert mesh.devices.size == S
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert tm.make_mesh(device="cpu").devices.size == 1
    four = tm.Mesh([torch.device("cpu")] * 4)
    assert four.devices.shape == (4,)
    with pytest.raises(ValueError, match="4 shards"):
        _jt, _tt, _jb, tb = CASES["uniform-8k"]()
        tm.sharded_merge_step(mesh)(tm.shard_batch(
            tcb.CellBatch.concat(tb), 4)[0])


def test_step_over_several_devices_sums_their_stats_on_the_host():
    """Shards on two devices (cpu and cpu:0, interleaved): each device
    runs its own shards, the pairs are summed on the host, and perm and
    packed come back in shard order, as on one device."""
    _jt, _tt, _jb, tb = CASES["deletions"]()
    ops = tm.shard_batch(tcb.CellBatch.concat(tb), S, *GC["deletions"])[0]
    one = tm.sharded_merge_step(tm.make_mesh(S, device="cpu"))(ops)
    two = tm.sharded_merge_step(tm.Mesh(["cpu", "cpu:0"] * (S // 2)))(ops)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert two[2].device.type == "cpu" and int(two[2][0]) > 0


def test_shard_threads_count_launches_and_profile_exactly():
    """The shard threads share cuda_lib's launch counters and the
    profiling registry: both stay exact under concurrent calls."""
    reg = DeviceProgramRegistry()
    calls = []

    def body(x):
        cuda_lib.count_launch("mesh.sharded_step", (x, 1024))
        calls.append(x)
        return x

    wrapped = reg.wrap("mesh.sharded_step", body)
    before = cuda_lib.launch_sizes()["mesh.sharded_step"]
    threads = [threading.Thread(target=lambda i=i: [wrapped(i % 4)
                                                    for _ in range(500)])
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    after = cuda_lib.launch_sizes()["mesh.sharded_step"]
    for x in range(4):
        assert after.get((x, 1024), 0) - before.get((x, 1024), 0) == 1000
    assert len(calls) == 4000
    k = reg.snapshot()["kernels"]["mesh.sharded_step"]
    assert k["calls"] == 4000 and k["compiles"] == 4
