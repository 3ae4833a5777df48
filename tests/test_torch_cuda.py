"""The port's CUDA kernels against their plain PyTorch versions on the
card, at a small size (chip_smoke.py repeats this at the main path's
shapes). Each test decides inside itself whether a card is present and
skips without one. This file needs no jax, so it also runs without
the jax-importing tests/conftest.py, on a machine that has no jax:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import make_round  # noqa: E402  (the smoke's round builder)
from cassandra_tpu_torch.ops import cuda_lib  # noqa: E402
from cassandra_tpu_torch.ops import device_write as dw  # noqa: E402
from cassandra_tpu_torch.ops import merge as dm  # noqa: E402

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,N", [(1000, 1024), (3000, 4096)])
def test_round_kernels_match_plain(n, N):
    dev = _card()
    # few partitions, so a small round still holds every mask bit
    ops = dm.operands_to_device(make_round(n, n, N, partitions=8), dev)
    before = cuda_lib.launch_sizes()
    perm = dm.device_sort_perm(ops)
    assert torch.equal(perm, dm.sort_perm_plain(ops))
    assert cuda_lib.last_sort("merge.sort_perm")["passes"] == 22
    packed = dm.reconcile_kernel(ops, perm)
    assert torch.equal(packed, dm.reconcile_plain(ops, perm))
    counts, perm_out, cols = dw.compact_gather(ops, perm, packed)
    c2, p2, cols2 = dw.compact_gather_plain(ops, perm, packed)
    assert torch.equal(counts, c2) and torch.equal(perm_out, p2)
    for k in dw.RESIDENT_COLS:
        assert torch.equal(cols[k], cols2[k]), k
    after = cuda_lib.launch_sizes()
    for k in ("merge.sort_perm", "merge.reconcile", "write.compact_gather"):
        assert after[k].get(N, 0) == before[k].get(N, 0) + 1, k


# (case, live rows, padded rows, lanes) at the edges of the pass's tile
# (4,096 rows) and of half a tile: one row, an edge less one and plus
# one, 2^16 + 1, an odd pass count (21) and no pass at all (equal keys,
# all padding)
ROUND_SORT_CASES = [
    ("pad", 1, 1, 13), ("pad", 0, 1, 13), ("pad", 2047, 2047, 13),
    ("pad", 2049, 2049, 13), ("pad", 2047, 4096, 13),
    ("pad", 4095, 4095, 13), ("pad", 4097, 8192, 13),
    ("pad", 65_537, 65_537, 13), ("pad", 32_769, 65_537, 13),
    ("odd-passes", 2049, 4096, 13), ("equal-keys", 2047, 2049, 13),
    ("pad", 0, 2049, 13), ("pad-zero-lanes", 2049, 4096, 13),
    ("pad-valid-varies", 1000, 2049, 13), ("every-byte", 2049, 2049, 13),
    ("ts-edges", 2047, 4096, 13), ("pad", 3000, 4096, 7),
    ("pad", 1500, 2048, 64),
]


@pytest.mark.parametrize("case,n,N,K", ROUND_SORT_CASES,
                         ids=[f"{c[0]}-{c[1]}of{c[2]}-K{c[3]}"
                              for c in ROUND_SORT_CASES])
def test_round_sort_matches_plain(case, n, N, K):
    """K1's kernel against its plain version and the packed mirror of
    its design, with the passes it reports equal to the plan's."""
    from sort_cases import build
    dev = _card()
    ops = dm.operands_to_device(build(case, n, N, K, seed=n), dev)
    perm = dm.device_sort_perm(ops)
    run = cuda_lib.last_sort("merge.sort_perm")
    plain = dm.sort_perm_plain(ops)
    assert torch.equal(perm, plain)
    assert torch.equal(dm.sort_perm_packed_plain(ops), plain)
    assert run["passes"] == dm.sort_plan_plain(ops)["passes"]
    if case == "odd-passes":
        assert run["passes"] == 21
    if case == "equal-keys" or n == 0:
        assert run["passes"] == 0
        assert torch.equal(perm.cpu(), torch.arange(N, dtype=torch.int32))


@pytest.mark.parametrize("shards,N", [
    ([("every-byte", 1000), ("pad-valid-varies", 700), ("equal-keys", 2049),
      ("pad", 0), ("hot", 2049)], 2049),
    ([("pad", 65_537), ("odd-passes", 30_000)], 65_537),
], ids=["S5-edges", "S2-2^16+1"])
def test_mesh_sort_edges_match_plain(shards, N):
    """K8 on shards whose (shard, group) ranges run different pass
    counts, at tile edges; passes equal to the plan's."""
    from sort_cases import mesh
    from cassandra_tpu_torch.parallel import mesh as pm
    dev = _card()
    ops = dm.operands_to_device(mesh(shards, N, seed=N), dev)
    perm, packed, stats = pm.sharded_step(ops)
    run = cuda_lib.last_sort("mesh.sharded_step")
    perm_p, packed_p, stats_p = pm.sharded_step_plain(ops)
    assert torch.equal(perm, perm_p)
    assert torch.equal(packed, packed_p)
    assert torch.equal(stats, stats_p)
    assert torch.equal(dm.sort_perm_packed_plain(ops), perm_p)
    assert run["passes"] == dm.sort_plan_plain(ops)["passes"]


@pytest.mark.parametrize("n", [4096, 1027])
def test_meta_block_matches_plain(n):
    dev = _card()
    rng = np.random.default_rng(n)
    ts = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
    ts[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]
    uts = ts.view(np.uint64) ^ np.uint64(1 << 63)
    cols = [torch.from_numpy(a).to(dev) for a in (
        (uts >> np.uint64(32)).astype(np.uint32).view(np.int32),
        (uts & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32),
        rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
        rng.integers(0, 1 << 20, n).astype(np.int32),
        rng.integers(0, 256, n).astype(np.uint8),
        rng.integers(0, 1 << 16, n).astype(np.int32),
        rng.integers(0, 1 << 12, n).astype(np.int32))]
    meta, st = dw.meta_block_kernel(*cols)
    meta_p, st_p = dw.meta_block_plain(*cols)
    assert torch.equal(meta, meta_p)
    assert torch.equal(st, st_p)
    assert dw.meta_stats(st)[:2] == (int(ts.min()), int(ts.max()))


def test_segment_scan_matches_plain():
    """K5 on a sorted stcs-like lane slice (whole constant byte planes,
    so the match runs cross many tiles) and on an unsorted copy."""
    from chip_smoke import make_scan_segment
    from cassandra_tpu_torch.ops import device_compress as dc
    dev = _card()
    meta, lanes = make_scan_segment(3, 4096)
    m = torch.from_numpy(meta).to(dev)
    before = cuda_lib.launches()["write.segment_scan"]
    for rows, ok in ((lanes, True), (lanes[[0, 2, 1] + list(range(3, 4096))],
                                     False)):
        t = torch.from_numpy(np.ascontiguousarray(rows).view(np.int32)).to(dev)
        out = dc.segment_scan(m, t)
        ref = dc.segment_scan_plain(m, t)
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        assert bool(out[5]) is ok
    assert cuda_lib.launches()["write.segment_scan"] == before + 2


@pytest.mark.parametrize("n", [70_000, 300_001])
def test_policy_scan_long_runs_match_plain(n):
    from cassandra_tpu_torch.ops import device_compress as dc
    dev = _card()
    rng = np.random.default_rng(n)
    src = np.zeros(n, dtype=np.uint8)
    src[n // 3:n // 3 + 5000] = rng.integers(0, 4, 5000)
    src[-7:] = 1
    t = torch.from_numpy(src).to(dev)
    no_rows = torch.empty((0, 1), dtype=torch.int32, device=dev)
    out = dc.segment_scan(t, no_rows)
    for a, b in zip(out[1:3], dc.policy_scan_plain(t)):
        assert torch.equal(a, b)
    assert bool(out[5])


@pytest.mark.parametrize("n,N", [(1000, 1024), (9000, 12288)])
def test_plane_programs_match_plain(n, N):
    from chip_smoke import make_fast_round, make_v2_round
    dev = _card()
    buf, cfg = make_fast_round(n, n, N, partitions=8)
    b = dm.planes_to_device(buf, dev)
    before = cuda_lib.launch_sizes()
    out = dm.plane_program_fast(b, cfg)
    assert torch.equal(out, dm.plane_program_fast_plain(b, cfg))
    planes, cfg2 = make_v2_round(n, n, N, partitions=8)
    p = dm.planes_to_device(planes, dev)
    out2 = dm.plane_program(p, cfg2)
    assert torch.equal(out2, dm.plane_program_plain(p, cfg2))
    masks = (out2[:n].to(torch.int64) >> 24)
    for bit in (1, 2, 8):                     # keep, ambiguous, shadowed
        assert bool(((masks & bit) != 0).any()), bit
    after = cuda_lib.launch_sizes()
    for k in ("merge.plane_fast", "merge.plane_v2"):
        assert after[k].get(N, 0) == before[k].get(N, 0) + 1, k


@pytest.mark.parametrize("n", [1, 4099, 65_536])
def test_scan_mask_and_fold_match_plain(n):
    """K9's eight ops (IN with 0 and several keys) and the fold, on keys
    over the whole u64 range with the edge keys, exact."""
    from cassandra_tpu_torch.ops import device_scan as ds
    dev = _card()
    rng = np.random.default_rng(n)
    edges = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1],
                     dtype=np.uint64)
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    keys[:min(n, 5)] = edges[:min(n, 5)]
    kc, kp = ds.keys_tensor(keys, dev), ds.keys_tensor(keys, "cpu")
    before = cuda_lib.launches()
    cases = [(op, edges[[i]]) for op in ("eq", "ne", "lt", "ge", "gt", "le")
             for i in range(5)]
    cases += [("in", edges[:0]), ("in", edges[[0, 3, 4]]),
              ("in", keys[:7]), ("all", edges[:0])]
    for op, q in cases:
        m = ds.scan_mask(kc, op, q)
        assert torch.equal(m.cpu(), ds.scan_mask_plain(kp, op, q)), op
        for mask in (m, torch.zeros_like(m), torch.ones_like(m)):
            assert torch.equal(ds.scan_fold(kc, mask).cpu(),
                               ds.scan_fold_plain(kp, mask.cpu())), op
    after = cuda_lib.launches()
    assert after["scan.mask"] == before["scan.mask"] + len(cases)
    assert after["scan.fold"] == before["scan.fold"] + 3 * len(cases)


@pytest.mark.parametrize("sim", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("n,d,k", [(1000, 128, 10), (5000, 7, 100),
                                   (300, 64, 300)])
def test_ann_topk_matches_plain(sim, n, d, k):
    """K10 against its plain version: the same indices, scores within
    1e-5 (float sums in another order), and exact ties (repeated rows)
    lower index first."""
    from cassandra_tpu_torch.ops import ann
    dev = _card()
    rng = np.random.default_rng(n + d)
    m = rng.standard_normal((n, d)).astype(np.float32)
    m[n // 2:n // 2 + 5] = m[3]                 # ties with row 3
    q = rng.standard_normal(d).astype(np.float32)
    if sim == "cosine":
        q /= np.linalg.norm(q)
    for qq in (q, m[3].copy()):
        mc = torch.from_numpy(m).to(dev)
        qc = torch.from_numpy(qq).to(dev)
        before = cuda_lib.launches()["index.ann"]
        s, i = ann.ann_topk(mc, qc, k, sim)
        assert cuda_lib.launches()["index.ann"] == before + 1
        sp, ip = ann.ann_topk_plain(mc, qc, k, sim)
        assert torch.equal(i, ip), (sim, n, d, k)
        torch.testing.assert_close(s, sp, rtol=1e-5, atol=1e-5)


def test_ann_limit_below_one_launches_nothing():
    """k = 0 (LIMIT 0) gives no row and no launch; the wrapper takes
    only 1 <= k <= n, as its plain version does."""
    from cassandra_tpu_torch.index.manager import VectorIndex
    from cassandra_tpu_torch.ops import ann
    dev = _card()
    rng = np.random.default_rng(3)
    m = rng.standard_normal((64, 8)).astype(np.float32)
    q = rng.standard_normal(8).astype(np.float32)
    idx = object.__new__(VectorIndex)
    keys = [(b"pk%d" % i, b"ck%d" % i) for i in range(len(m))]
    idx.__dict__.update(_gather=lambda: (m, keys), device=dev,
                        _device_cache=None)
    before = cuda_lib.launches()["index.ann"]
    for k in (0, -3):
        assert idx.ann(q, k, "dot") == []
    assert cuda_lib.launches()["index.ann"] == before
    assert [h[:2] for h in idx.ann(q, 64, "dot")][0] in keys
    assert cuda_lib.launches()["index.ann"] == before + 1
    mc, qc = torch.from_numpy(m).to(dev), torch.from_numpy(q).to(dev)
    for k in (0, 65):
        with pytest.raises(ValueError, match="outside 1..64"):
            ann.ann_topk(mc, qc, k, "dot")


@pytest.mark.parametrize("S,N", [(1, 1024), (2, 1024), (4, 2048),
                                 (8, 1024), (4, 4096)])
def test_mesh_step_matches_plain(S, N):
    """K8 over [S, N] shards on one card against its plain version:
    perm, packed and stats exact, with a full and an empty shard, and
    from S = 3 two full one-cell shards side by side (no pad row
    between them); one launch, counted under its (S, N)."""
    from chip_smoke import make_mesh_operands
    from cassandra_tpu_torch.parallel import mesh as pm
    dev = _card()
    ops = dm.operands_to_device(make_mesh_operands(S + N, S, N), dev)
    before = cuda_lib.launch_sizes()["mesh.sharded_step"].get((S, N), 0)
    perm, packed, stats = pm.sharded_step(ops)
    perm_p, packed_p, stats_p = pm.sharded_step_plain(ops)
    assert torch.equal(perm, perm_p)
    assert torch.equal(packed, packed_p)
    assert torch.equal(stats, stats_p)
    kept = int((packed & 1).sum())
    assert stats.tolist() == [kept, int((ops["valid"] == 0).sum()) - kept]
    after = cuda_lib.launch_sizes()["mesh.sharded_step"].get((S, N), 0)
    assert after == before + 1
    assert cuda_lib.last_sort("mesh.sharded_step")["passes"] == \
        dm.sort_plan_plain(ops)["passes"]
