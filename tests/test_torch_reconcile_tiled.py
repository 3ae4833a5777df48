"""K2's tiled design (`reconcile_tiled_plain`, the plain mirror of
csrc/reconcile.cu) against the JAX package's `reconcile_kernel`, exactly.

The rounds come from chip_smoke.make_edge_round: laid out in sorted
order under a random storage permutation, with partitions spanning many
tiles and a partition, row or complex deletion starting at each tile's
last, first and second position. Tiles of 32-64 positions put many of
those edges into a small round. Equal segments are K8's: the shards of
a mesh step, each starting a partition at its first row."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from cassandra_tpu.ops import merge as jmerge

from cassandra_tpu_torch import interop
from cassandra_tpu_torch.ops import merge as tmerge

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import make_edge_round  # noqa: E402


def _jax(ops: dict, perm: np.ndarray) -> np.ndarray:
    return np.asarray(jmerge.reconcile_kernel(ops, perm))


def _tiled(ops: dict, perm: np.ndarray, tile: int, seg_len=None):
    return tmerge.reconcile_tiled_plain(
        interop.operands_from_numpy(ops, "cpu"), torch.from_numpy(perm),
        tile, seg_len).numpy()


# (live rows, padded rows, tile): partitions across tiles, every tile
# edge a deletion, and (third case) two tiles of padding only
ROUNDS = [(2000, 2048, 32), (3000, 4096, 64), (1900, 2048, 64),
          (4096, 4096, 32)]


@pytest.mark.parametrize("n,N,tile", ROUNDS,
                         ids=[f"{n}of{N}-t{t}" for n, N, t in ROUNDS])
def test_tiled_reconcile_matches_jax(n, N, tile):
    ops, perm = make_edge_round(n + tile, n, N, tile)
    ref = _jax(ops, perm)
    got = _tiled(ops, perm, tile)
    assert np.array_equal(got, ref)
    bits = ref[:n].astype(np.int64)
    for b in range(4):                      # every mask bit is exercised
        assert ((bits >> b) & 1).any(), b
    # the deletions at tile edges shadow rows past the edge: the stamps'
    # carry crosses it
    edges = [t * tile + d for t in range(1, n // tile) for d in (0, 1)]
    assert ((bits[edges] >> 3) & 1).any()
    # the mirror equals the plain version whatever its tile
    tops = interop.operands_from_numpy(ops, "cpu")
    assert np.array_equal(
        tmerge.reconcile_plain(tops, torch.from_numpy(perm)).numpy(), ref)
    assert np.array_equal(_tiled(ops, perm, 1024), ref)


@pytest.mark.parametrize("N,tile,kinds", [
    (1024, 64, ("full", "empty", "partial", "full")),
    (1024, 32, ("full", "hot", "hot", "partial"))], ids=["S4", "S4-hot"])
def test_tiled_reconcile_segments_match_jax(N, tile, kinds):
    """Equal segments as K8 runs them: each segment reconciled alone by
    the JAX package, the mirror over all of them with seg_len = N. A
    `hot` segment is full and its first sorted row repeats the previous
    segment's last row (lanes and ts), which only the forced segment
    start tells apart."""
    parts, perms = [], []
    for s, kind in enumerate(kinds):
        n = {"empty": 0, "partial": N // 2 + 5 * s + 1}.get(kind, N)
        ops, perm = make_edge_round(100 + s, n, N, tile)
        if kind == "hot":
            last = perms[-1][-1]
            assert parts[-1]["valid"][last] == 0
            for k in ("lanes", "ts_h", "ts_l"):
                ops[k][perm[0]] = parts[-1][k][last]
        parts.append(ops)
        perms.append(perm)
    ref = np.concatenate([_jax(o, p) for o, p in zip(parts, perms)])
    flat = {k: (np.concatenate([o[k] for o in parts]) if np.ndim(v) else v)
            for k, v in parts[0].items()}
    gperm = np.concatenate([p + s * N for s, p in enumerate(perms)])
    assert np.array_equal(_tiled(flat, gperm.astype(np.int32), tile, N), ref)
