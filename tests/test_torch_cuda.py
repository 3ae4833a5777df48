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


# (live rows, padded rows): K2's tiles are 1,024 positions; a length
# that is no multiple of 4, a round of two long partitions, and whole
# tiles of padding
RECONCILE_CASES = [(3000, 4099, "edges"), (60_000, 65_536 + 2051, "edges"),
                   (3000, 8192, "edges"), (40_000, 65_536, "two-partitions")]


@pytest.mark.parametrize("n,N,kind", RECONCILE_CASES,
                         ids=[f"{c[2]}-{c[0]}of{c[1]}"
                              for c in RECONCILE_CASES])
def test_reconcile_tiles_match_plain(n, N, kind):
    """K2 against its plain version and the mirror of its tiles, on
    rounds whose partitions span its tiles: a partition, row or complex
    deletion at every tile's edge (make_edge_round), or a sorted round
    of two partitions; one launch counted a call."""
    from chip_smoke import make_edge_round
    dev = _card()
    if kind == "edges":
        ops_np, perm_np = make_edge_round(n, n, N)
        ops = dm.operands_to_device(ops_np, dev)
        perm = torch.from_numpy(perm_np).to(dev)
    else:
        ops = dm.operands_to_device(make_round(n, n, N, partitions=2), dev)
        perm = dm.device_sort_perm(ops)
    before = cuda_lib.launches()["merge.reconcile"]
    packed = dm.reconcile_kernel(ops, perm)
    assert cuda_lib.launches()["merge.reconcile"] == before + 1
    plain = dm.reconcile_plain(ops, perm)
    assert torch.equal(packed, plain)
    assert torch.equal(dm.reconcile_tiled_plain(ops, perm), plain)
    assert int((packed & 8).count_nonzero()) > 0


@pytest.mark.parametrize("S,N", [(4, 3000), (3, 1024), (2, 4096)])
def test_mesh_reconcile_matches_the_tiled_mirror(S, N):
    """K8's reconcile (reconcile_seg over equal segments) against the
    mirror of K2's tiles with seg_len = N, at shard lengths that are
    and are not multiples of its tile: full, empty and hot shards."""
    from chip_smoke import make_mesh_operands
    from cassandra_tpu_torch.parallel import mesh as pm
    dev = _card()
    ops = dm.operands_to_device(make_mesh_operands(S * N, S, N), dev)
    perm, packed, _stats = pm.sharded_step(ops)
    flat = {k: (v.reshape(S * N, -1) if k == "lanes" else v.reshape(-1))
            if torch.is_tensor(v) else v for k, v in ops.items()}
    base = torch.arange(S, device=dev, dtype=perm.dtype)[:, None] * N
    mirror = dm.reconcile_tiled_plain(flat, (perm + base).reshape(-1),
                                      seg_len=N)
    assert torch.equal(packed.reshape(-1), mirror)


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


def _device_launches(fn) -> int:
    """Device launches (kernels, memsets and copies) of one call of fn,
    the nodes of a CUDA graph captured from it
    (chip_smoke.graph_launches)."""
    from chip_smoke import graph_launches
    return graph_launches(fn)


# (kind, live rows, padded rows, lanes): K3's tiles are 4,096 sorted
# positions; N no multiple of the tile or of 16, several tiles, nothing
# kept, everything kept, K at its limits
COMPACT_CASES = [("mixed", 3000, 4099, 13), ("mixed", 60_000, 67_587, 13),
                 ("none", 0, 4099, 7), ("all", 4099, 4099, 64),
                 ("runs", 60_000, 65_536, 7), ("mixed", 9000, 12_288, 64)]


@pytest.mark.parametrize("kind,n,N,K", COMPACT_CASES,
                         ids=[f"{c[0]}-{c[1]}of{c[2]}-K{c[3]}"
                              for c in COMPACT_CASES])
def test_compact_gather_tiles_match_plain(kind, n, N, K):
    """K3 against its plain version and the mirror of its tiles; one
    launch counted a call, at most three device launches (a memset and
    two kernels)."""
    from chip_smoke import make_keep_round
    dev = _card()
    if kind == "runs":
        ops_np = make_keep_round(n, n, N, 5000, K)[0]
    else:
        ops_np = make_round(n + K, n, N, K, partitions=8)
        if kind == "none":
            ops_np["valid"][:] = 1
        elif kind == "all":
            ops_np["lanes"][:, K - 3] = 8
            ops_np["lanes"][:, K - 2] = np.arange(N)
            for k in ("death", "cdel", "expiring"):
                ops_np[k][:] = 0
    ops = dm.operands_to_device(ops_np, dev)
    perm = dm.device_sort_perm(ops)
    packed = dm.reconcile_kernel(ops, perm)
    before = cuda_lib.launches()["write.compact_gather"]
    counts, perm_out, cols = dw.compact_gather(ops, perm, packed)
    assert cuda_lib.launches()["write.compact_gather"] == before + 1
    for ref in (dw.compact_gather_plain(ops, perm, packed),
                dw.compact_gather_tiled_plain(ops, perm, packed)):
        assert torch.equal(counts, ref[0])
        assert torch.equal(perm_out, ref[1])
        for k in dw.RESIDENT_COLS:
            assert torch.equal(cols[k], ref[2][k]), k
    n_keep = int(counts[0])
    assert n_keep == {"none": 0, "all": N}.get(kind, n_keep)
    assert 0 < n_keep < N or kind in ("none", "all")
    raw = dw.compact_gather.__wrapped__
    assert _device_launches(lambda: raw(ops, perm, packed)) <= 3


@pytest.mark.parametrize("n", [1, 1027, 4099, 65_536])
def test_meta_block_tiles_match_plain(n):
    """K4 against its plain version and the mirror of its tiles, with
    aligned columns and with columns one cell off a 16-byte boundary
    (the scalar loads); the stats decoded from the one buffer; one
    launch counted a call, at most two device launches (a memset and
    the kernel)."""
    from chip_smoke import make_segment
    dev = _card()
    _ts, seg_np = make_segment(n, n + 1)
    full = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                             else a).to(dev) for a in seg_np]
    for cols in ([c[:n] for c in full], [c[1:] for c in full]):
        before = cuda_lib.launches()["write.meta_block"]
        meta, st = dw.meta_block_kernel(*cols)
        assert cuda_lib.launches()["write.meta_block"] == before + 1
        for ref in (dw.meta_block_plain(*cols),
                    dw.meta_block_tiled_plain(*cols, tile=dw.META_TILE)):
            assert torch.equal(meta, ref[0])
            assert torch.equal(st, ref[1])
        block = dw.meta_block_buffer(*cols).cpu().numpy()
        assert dw.stats_of_block(block, n) == dw.meta_stats(st)
        assert bytes(block[:25 * n]) == bytes(meta.cpu().numpy())
    raw = dw.meta_block_buffer.__wrapped__
    assert _device_launches(lambda: raw(*cols)) <= 2


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


@pytest.mark.parametrize("rows,meta_len,kind", [
    (4097, 25 * 4097 + 3, "sorted"), (1, 30, "sorted"),
    (9000, 25 * 9000 + 1, "constant"), (2, 8195, "unaligned")])
def test_segment_scan_edges_match_plain(rows, meta_len, kind):
    """K5 at a META length that is no multiple of 4, at one lane row,
    on constant planes (every lane row equal: runs across all tiles)
    and on a META block that does not start on a 4-byte boundary,
    against its plain version and the mirror of its tiles; one launch
    counted a call."""
    from chip_smoke import make_lanes
    from cassandra_tpu_torch.ops import device_compress as dc
    dev = _card()
    rng = np.random.default_rng(rows)
    meta = torch.from_numpy(rng.integers(0, 3, meta_len + 1,
                                         dtype=np.uint8)).to(dev)
    meta = meta[1:] if kind == "unaligned" else meta[:-1]
    lanes = make_lanes(rows, rows)
    if kind == "constant":
        lanes[:] = lanes[0]
    t = torch.from_numpy(lanes.view(np.int32)).to(dev)
    before = cuda_lib.launches()["write.segment_scan"]
    out = dc.segment_scan(meta, t)
    assert cuda_lib.launches()["write.segment_scan"] == before + 1
    ref = dc.segment_scan_plain(meta, t)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert bool(out[5])
    for src, bl, bd in ((meta, out[1], out[2]), (out[0], out[3], out[4])):
        tl, td = dc.policy_scan_tiled_plain(src)
        assert torch.equal(bl, tl) and torch.equal(bd, td)
    if kind == "constant":                 # a run spans a whole plane
        assert int(out[3].max()) >= rows - 1 > dc.LZ_TILE


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
    assert cuda_lib.last_sort("merge.plane_fast")["passes"] == \
        dm.sort_plan_plain(dm.fast_sort_key(b, cfg))["passes"]
    planes, cfg2 = make_v2_round(n, n, N, partitions=8)
    p = dm.planes_to_device(planes, dev)
    out2 = dm.plane_program(p, cfg2)
    assert torch.equal(out2, dm.plane_program_plain(p, cfg2))
    assert cuda_lib.last_sort("merge.plane_v2")["passes"] == \
        dm.sort_plan_plain(dm.v2_sort_key(p, cfg2))["passes"]
    masks = (out2[:n].to(torch.int64) >> 24)
    for bit in (1, 2, 8):                     # keep, ambiguous, shadowed
        assert bool(((masks & bit) != 0).any()), bit
    after = cuda_lib.launch_sizes()
    for k in ("merge.plane_fast", "merge.plane_v2"):
        assert after[k].get(N, 0) == before[k].get(N, 0) + 1, k


# K6 rounds (widths, live rows, padded rows; N % 1024 == 0) and K7
# rounds (live rows, padded rows, ts_hi, cdel) at the pass tile's edges
# (4,096 rows), all padding, one live row and all live
PLANE_FAST_CASES = [("u8", 3000, 4096), ("u16", 4097, 8192),
                    ("u32", 4095, 4096), ("u16", 0, 2048), ("u8", 1, 1024),
                    ("u32", 1024, 1024)]
PLANE_V2_CASES = [(3000, 4096, False, True), (4097, 8192, True, True),
                  (4095, 4096, True, False), (0, 2048, False, False),
                  (1, 1024, True, True), (12288, 12288, False, True)]


@pytest.mark.parametrize("widths,n,N", PLANE_FAST_CASES,
                         ids=[f"{c[0]}-{c[1]}of{c[2]}"
                              for c in PLANE_FAST_CASES])
def test_plane_fast_sort_matches_plain(widths, n, N):
    """K6 on planes of width 1, 2 and 4 against its plain version and
    the packed mirror of its sort, with the passes it reports equal to
    the plan's."""
    from plane_cases import FAST_WIDTHS, fast_round
    dev = _card()
    buf, cfg = fast_round(n + N, n, N, FAST_WIDTHS[widths])
    b = dm.planes_to_device(buf, dev)
    out = dm.plane_program_fast(b, cfg)
    run = cuda_lib.last_sort("merge.plane_fast")
    assert torch.equal(out, dm.plane_program_fast_plain(b, cfg))
    key = dm.fast_sort_key(b, cfg)
    assert torch.equal(dm.plane_fast_tail_plain(
        b, cfg, dm.sort_perm_packed_plain(key)), out)
    assert run["passes"] == dm.sort_plan_plain(key)["passes"]
    if n <= 1:
        assert run["passes"] == 0


@pytest.mark.parametrize("n,N,has_hi,has_cdel", PLANE_V2_CASES,
                         ids=[f"{c[0]}of{c[1]}" + ("-hi" if c[2] else "")
                              + ("-cdel" if c[3] else "")
                              for c in PLANE_V2_CASES])
def test_plane_v2_sort_matches_plain(n, N, has_hi, has_cdel):
    """K7 with and without ts_hi and cdel against its plain version and
    the packed mirror of its sort, with the passes it reports equal to
    the plan's."""
    from plane_cases import v2_round
    dev = _card()
    planes, cfg = v2_round(n + N, n, N, has_hi, has_cdel)
    p = dm.planes_to_device(planes, dev)
    out = dm.plane_program(p, cfg)
    run = cuda_lib.last_sort("merge.plane_v2")
    assert torch.equal(out, dm.plane_program_plain(p, cfg))
    key = dm.v2_sort_key(p, cfg)
    perm = dm.sort_perm_packed_plain(key)
    assert torch.equal(perm, out & 0xFFFFFF)
    assert run["passes"] == dm.sort_plan_plain(key)["passes"]
    if n <= 1:
        assert run["passes"] == 0


def _port_batches(seed: int, deletions: bool) -> list:
    """Four runs of 3,000 cells of the port's CellBatch (no jax): sorted
    live runs with colliding stamps (a K6 round), or unsorted runs with
    cell, row and partition deletions (a K7 round)."""
    import random

    from cassandra_tpu_torch.schema import COL_REGULAR_BASE, make_table
    from cassandra_tpu_torch.storage import cellbatch as cb
    t = make_table("ks", "t", pk=["id"], ck=["c"],
                   cols={"id": "int", "c": "int", "v": "text"})
    idt = t.columns["id"].cql_type
    rng = random.Random(seed)
    out = []
    for _ in range(4):
        b = cb.CellBatchBuilder(t)
        for _ in range(3000):
            p = idt.serialize(rng.randrange(64))
            c = t.serialize_clustering([rng.randrange(40)])
            ts = (1 << 30) + rng.choice([rng.randrange(1 << 24),
                                         rng.randrange(4)])
            kind = rng.random() if deletions else 0.0
            if kind < 0.8:
                b.add_cell(p, c, COL_REGULAR_BASE,
                           rng.choice([b"a", b"zz", b"x" * 9]), ts)
            elif kind < 0.9:
                b.add_tombstone(p, c, COL_REGULAR_BASE, ts, 10)
            elif kind < 0.98:
                b.add_row_deletion(p, c, ts, 10)
            else:
                b.add_partition_deletion(p, ts, 10)
        out.append(b.seal() if deletions else cb.merge_sorted([b.seal()]))
    return out


def _same_batch(a, b) -> None:
    assert len(a) == len(b)
    for k in ("lanes", "ts", "ldt", "flags", "payload", "off"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_submits_return_while_the_stream_is_busy():
    """submit_merge_resident (K1-K3) and submit_merge on a K6 round and
    a K7 round enqueue their work behind a kernel that keeps the card
    busy and return before it ends (the round sort never waits for the
    device); collect then gives the batch the CPU gives."""
    dev = _card()
    live, dels = _port_batches(1, False), _port_batches(2, True)
    cpu_res = dw.collect_merge_resident(
        dw.submit_merge_resident(live, device="cpu"))
    rounds = [(dm.submit_merge, dm.collect_merge, live, "fast"),
              (dm.submit_merge, dm.collect_merge, dels, "v2"),
              (dw.submit_merge_resident, dw.collect_merge_resident, live,
               "resident")]
    for submit, collect, batches, _mode in rounds:   # build, warm caches
        collect(submit(batches, device=dev))
    stream = torch.cuda.current_stream(dev)
    for submit, collect, batches, mode in rounds:
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(1 << 31)                    # about a second
        h = submit(batches, device=dev)
        assert not stream.query(), mode               # still sleeping
        assert h.mode == mode
        got = collect(h)
        if mode == "resident":
            assert got.n == cpu_res.n
            for k, col in got.cols.items():
                assert torch.equal(col[:got.n].cpu(),
                                   cpu_res.cols[k][:cpu_res.n]), k
            np.testing.assert_array_equal(got.payload, cpu_res.payload)
            np.testing.assert_array_equal(got.off, cpu_res.off)
        else:
            _same_batch(got, collect(submit(batches, device="cpu")))


@pytest.mark.parametrize("n", [1, 4099, 65_536, 1 << 20])
def test_scan_mask_and_fold_match_plain(n):
    """K9's eight ops (IN with 0 and several keys) and the fold, on keys
    over the whole u64 range with the edge keys, exact; at a segment's
    65,536 keys and at a scan run's cap (device_scan.RUN_KEYS)."""
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
                                   (300, 64, 300), (3000, 128, 257),
                                   (700, 128, 700)])
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


def _ann_matrix(kind: str, n: int, d: int, seed: int):
    """A gaussian matrix with rows 3 repeated (exact ties), or one whose
    dot scores against q = e0 rise with the row ("ascending": every row
    beats the rows before it, so each block merges its buffer as often
    as it can)."""
    rng = np.random.default_rng(seed)
    if kind == "ascending":
        m = rng.standard_normal((n, d)).astype(np.float32) * 1e-3
        m[:, 0] = np.arange(n, dtype=np.float32)
        q = np.zeros(d, np.float32)
        q[0] = 1.0
        return m, q
    m = rng.standard_normal((n, d)).astype(np.float32)
    m[n // 2:n // 2 + 5] = m[3]
    q = rng.standard_normal(d).astype(np.float32)
    return m, q / np.linalg.norm(q)


@pytest.mark.parametrize("sim", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("kind,n,d", [("gaussian", 200_000, 128),
                                      ("gaussian", 3000, 7),
                                      ("gaussian", 5000, 256),
                                      ("ascending", 100_000, 128)])
@pytest.mark.parametrize("k", [1, 10, 256])      # 256: K_FUSED
def test_ann_fused_equals_select(sim, kind, n, d, k):
    """K10's fused path (k <= K_FUSED) gives the select path's bits, and
    the plain version's indices, at the fused path's edges: k = 1, 10
    and K_FUSED, rows tied, every row a survivor (ascending; held to
    the plain version for dot, whose scores there are exact)."""
    from cassandra_tpu_torch.ops import ann
    dev = _card()
    assert cuda_lib.lib().ctpu_ann_k_fused() == ann.K_FUSED
    m, q = _ann_matrix(kind, n, d, n + d + k)
    mc, qc = torch.from_numpy(m).to(dev), torch.from_numpy(q).to(dev)
    s_f, i_f = ann.ann_topk_fused_cuda(mc, qc, k, sim)
    s_s, i_s = ann.ann_topk_select_cuda(mc, qc, k, sim)
    assert torch.equal(i_f, i_s), (sim, kind, n, d, k)
    assert torch.equal(s_f.view(torch.int32), s_s.view(torch.int32))
    if kind == "gaussian" or sim == "dot":
        sp, ip = ann.ann_topk_plain(mc, qc, k, sim)
        assert torch.equal(i_f, ip)
        torch.testing.assert_close(s_f, sp, rtol=1e-5, atol=1e-5)
    before = cuda_lib.launches()["index.ann"]
    ann.ann_topk(mc, qc, k, sim)                # k <= K_FUSED: fused
    assert cuda_lib.launches()["index.ann"] == before + 1


def test_scan_filtered_runs_match_the_knob_off():
    """Phase A on the card over small segments (a cap of two and a bit):
    the same candidates as the numpy masks, one K9 launch per run of
    device-gated segments, each of the run's keys."""
    import tempfile

    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.index import sstable_index as ssi
    from cassandra_tpu_torch.ops import device_scan as ds
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage import cellbatch as cb
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.storage.sstable import (Descriptor,
                                                     SSTableWriter)
    from cassandra_tpu_torch.tools import bulk
    from scan_runs import CAP, runs, segment_keys, write_sources
    dev = _card()
    root = tempfile.mkdtemp(prefix="scan-runs-")
    eng = StorageEngine(os.path.join(root, "d"), Schema(),
                        commitlog_sync="batch", device=dev)
    saved = ds.RUN_KEYS
    try:
        cfs = write_sources(eng, Session(eng), (cb, bulk, Descriptor,
                                                SSTableWriter), 5)
        pred = ds.compile_predicate(cfs.table,
                                    [(cfs.table.columns["v"], "<", 0)])
        want, off = cfs.scan_filtered(pred, use_device=False)
        ds.RUN_KEYS = CAP
        cuda_lib.reset_launches()
        got, on = cfs.scan_filtered(pred, use_device=True)
        torch.cuda.synchronize()
        assert [pk for pk, _ in got] == [pk for pk, _ in want]
        assert on["device_segments"] == off["host_segments"] > 0
        expect = runs(segment_keys(cfs, pred, ssi, ds),
                      [True] * on["device_segments"], CAP)
        assert cuda_lib.launches()["scan.mask"] == len(expect)
        assert cuda_lib.launch_sizes()["scan.mask"] == {
            size: expect.count(size) for size in set(expect)}
    finally:
        ds.RUN_KEYS = saved
        eng.close()
        import shutil
        shutil.rmtree(root, ignore_errors=True)


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


def test_stress_then_device_compaction_matches_native(tmp_path):
    """A small stress.write on a card engine (five flushes), every
    stress.read a hit, then the table's major compaction on the card,
    with device compress off (K1-K4) and at the default (K1-K5), each
    sha256-equal to a native compaction of the same sstables."""
    import shutil

    import chip_smoke
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.tools import stress

    dev = _card()
    n = 20_000
    eng = StorageEngine(str(tmp_path / "eng"), Schema(), device=dev,
                        flush_threshold=n * chip_smoke.STRESS_ROW_BYTES // 5)
    try:
        s = Session(eng)
        stress.write(s, n)
        cfs = eng.store("stress", "standard1")
        cfs.flush()
        assert len(cfs.live_sstables()) >= 4
        assert stress.read(s, n // 10, keys=n)["hits"] == n // 10
        table = cfs.table
        roots = {}
        for leg in ("native", "off", "default"):
            roots[leg] = str(tmp_path / leg)
            shutil.copytree(cfs.directory, os.path.join(
                roots[leg], "stress", os.path.basename(cfs.directory)))
    finally:
        eng.close()
    native = chip_smoke.compact_leg(roots["native"], table, engine="native")
    for leg, kw in (("off", {"device_compress": False}), ("default", {})):
        cuda_lib.reset_launches()
        out = chip_smoke.compact_leg(roots[leg], table, engine="device",
                                     device=dev, **kw)
        got = cuda_lib.launches()
        assert out["hashes"] == native["hashes"], leg
        for k in ("merge.sort_perm", "merge.reconcile",
                  "write.compact_gather", "write.meta_block"):
            assert got[k] > 0, (leg, k)
        assert (got["write.segment_scan"] > 0) == (leg == "default")


def test_harry_under_device_compaction_matches_model(tmp_path,
                                                     monkeypatch):
    """harry's op stream on a card engine, every partition equal to the
    model before and after a device major compaction that is
    sha256-equal to a native one (chip_smoke's phase 8 (d) at a small
    size)."""
    import chip_smoke

    _card()
    monkeypatch.setattr(chip_smoke, "HARRY_OPS", 4000)
    monkeypatch.setattr(chip_smoke, "HARRY_FLUSH_EVERY", 400)
    monkeypatch.setattr(chip_smoke, "HARRY_PKS", 48)
    monkeypatch.setattr(chip_smoke, "HARRY_CKS", 16)
    ids = {name: kid for kid, name in chip_smoke.KERNEL_NAMES.items()}
    # under one full segment: K4 and K5 do not run
    out = chip_smoke.tools_harry(11, str(tmp_path), ids,
                                 must=("K1", "K2", "K3"))
    comp = out["legs"][0]
    assert comp["stats"]["cells_written"] < comp["stats"]["cells_read"]
    assert all(comp["launches"][k] > 0 for k in ("K1", "K2", "K3"))
