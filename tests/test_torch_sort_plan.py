"""The round sort's design (K1 and the sort of the mesh step K8) held
exactly against the JAX package on the CPU: the plan of the key bytes
that vary per (segment, live or pad group), and the sort it gives
(split, pack the varying bytes, one stable pass per packed byte), in
plain PyTorch (`sort_plan_plain`, `sort_perm_packed_plain`), against
JAX `device_sort_perm` and the perms of JAX `sharded_merge_step`. The
CUDA kernel is held against the same cases on the card
(tests/test_torch_cuda.py)."""
from __future__ import annotations

import numpy as np
import pytest

from cassandra_tpu.ops import merge as jmerge
from cassandra_tpu.parallel import mesh as jm
from sort_cases import build, mesh

from cassandra_tpu_torch.ops import merge as tmerge
from chip_smoke import make_round, round_cells_for

# (case, live rows, padded rows, lanes)
ROUNDS = [
    ("pad", 3000, 4096, 13),
    ("pad-zero-lanes", 3000, 4096, 13),
    ("pad", 4096, 4096, 13),                 # all live
    ("pad", 0, 2048, 13),                    # all pad
    ("pad", 1, 1, 13),                       # a single row
    ("pad", 0, 1, 13),                       # a single pad row
    ("equal-keys", 2048, 2048, 13),
    ("equal-keys", 1500, 2048, 13),
    ("pad-valid-varies", 1000, 2048, 13),
    ("every-byte", 2000, 2048, 13),
    ("pad", 3000, 4096, 7),
    ("pad", 1500, 2048, 64),
    ("ts-edges", 2000, 2048, 13),
    ("odd-passes", 2049, 4096, 13),
]

# [S, N] steps: (shards as (case, live rows), N)
MESHES = [
    ([("pad", 2048), ("pad", 0), ("hot", 2048), ("pad", 1025)], 2048),
    ([("every-byte", 1000), ("pad-valid-varies", 700), ("equal-keys", 2048),
      ("pad-zero-lanes", 1)], 2048),
]


def _ids(cases):
    return [f"{c[0]}-{c[1]}of{c[2]}-K{c[3]}" for c in cases]


@pytest.mark.parametrize("case,n,N,K", ROUNDS, ids=_ids(ROUNDS))
def test_packed_sort_matches_jax(case, n, N, K):
    ops = build(case, n, N, K, seed=n + K)
    jperm = np.asarray(jmerge.device_sort_perm(ops))
    tops = tmerge.operands_to_device(ops, "cpu")
    packed = tmerge.sort_perm_packed_plain(tops).numpy()
    np.testing.assert_array_equal(packed, jperm)
    np.testing.assert_array_equal(tmerge.device_sort_perm(tops).numpy(),
                                  jperm)
    plan = tmerge.sort_plan_plain(tops)
    (live_bytes, pad_bytes), = plan["bytes"]
    assert plan["sizes"].tolist() == [[n, N - n]]
    assert plan["key_bytes"] == 4 * (K + 3)
    assert plan["passes"] == max(len(live_bytes), len(pad_bytes))
    assert not any(b < 4 for b in live_bytes)       # valid is 0 there
    if case == "equal-keys":
        np.testing.assert_array_equal(packed, np.arange(N))
        assert plan["passes"] == 0
    if case == "pad-valid-varies":
        assert 3 in pad_bytes and 0 in pad_bytes    # valid's bytes count
    if case == "every-byte":
        assert len(pad_bytes) == 4 * (K + 3)
        assert len(live_bytes) == 4 * (K + 2)
    if case == "odd-passes":
        assert plan["passes"] == 21
    if case in ("pad", "ts-edges", "odd-passes") and n < N:
        assert pad_bytes == []                      # padding runs no pass


@pytest.mark.parametrize("shards,N", MESHES,
                         ids=[f"S{len(m[0])}-{i}" for i, m in
                              enumerate(MESHES)])
def test_packed_sort_matches_jax_mesh(shards, N):
    ops = mesh(shards, N, seed=N + len(shards))
    S = len(shards)
    jperm = np.asarray(jm.sharded_merge_step(jm.make_mesh(S))(ops)[0])
    tops = tmerge.operands_to_device(ops, "cpu")
    packed = tmerge.sort_perm_packed_plain(tops).numpy()
    assert packed.shape == (S, N)
    np.testing.assert_array_equal(packed, jperm)
    plan = tmerge.sort_plan_plain(tops)
    assert plan["sizes"].tolist() == [
        [N if c == "hot" else n, 0 if c == "hot" else N - n]
        for c, n in shards]
    assert plan["passes"] == max(len(b) for g in plan["bytes"] for b in g)
    for (case, _n), groups in zip(shards, plan["bytes"]):
        if case == "equal-keys":
            assert groups[0] == []                  # one key: no pass
        if case == "hot":                           # one cell: stamps only
            assert groups[0] and min(groups[0]) >= 4 * 14


@pytest.mark.parametrize("N", [1024, 4096, 1 << 16, 1 << 19])
def test_plan_passes_on_smoke_rounds(N):
    """22 of 64 key bytes vary among the live rows of any round
    chip_smoke.make_round builds at K = 13 (16 partition-hash bytes,
    the clustering prefix, the column, the cell path and 3 stamp
    bytes); its padding rows, all alike, vary in none. An all-pad round
    runs no pass."""
    for n in sorted({round_cells_for(N), N, 1000}):
        plan = tmerge.sort_plan_plain(
            tmerge.operands_to_device(make_round(N + n, n, N), "cpu"))
        assert plan["passes"] == 22, n
        assert [len(b) for b in plan["bytes"][0]] == [22, 0], n
    empty = tmerge.sort_plan_plain(
        tmerge.operands_to_device(make_round(N, 0, N), "cpu"))
    assert empty["passes"] == 0
    assert empty["sizes"].tolist() == [[0, N]]
