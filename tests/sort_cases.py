"""Operand sets (numpy) for the round sort's exactness tests: K1's and
K8's plan, split, pack and passes. Shared by tests/test_torch_sort_plan.py
(against the JAX package, on the CPU) and tests/test_torch_cuda.py
(kernel against plain, on the card); this module imports no jax.

Every case starts from chip_smoke.make_round(seed, n, N, K): n live
rows (valid == 0) padded to N rows (valid = 1, lanes 0xFFFFFFFF, ts 0),
then changes what its name says."""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import make_round  # noqa: E402

U32 = np.uint64(0xFFFFFFFF)

# (ts_h, ts_l) of the stamps at the u64 edges: 0, 2^63 - 1, 2^63 and
# 2^64 - 1
TS_EDGES = np.array([0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1],
                    dtype=np.uint64)

MESH_COLS = ("lanes", "valid", "ts_h", "ts_l", "death", "cdel", "ldt",
             "expiring", "purge_h", "purge_l")


def _u32(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def build(case: str, n: int, N: int, K: int = 13, seed: int = 0) -> dict:
    """One round's operands:

    pad               make_round as it is (padding lanes 0xFFFFFFFF);
    pad-zero-lanes    padding rows with zero lanes (they share bytes
                      with live rows, so only the live/pad split keeps
                      them apart);
    equal-keys        every live row has row 0's key (the identity);
    pad-valid-varies  pad rows' valid in {1, 2, 7, 2^32 - 1}, their
                      lanes from a few values;
    every-byte        random lanes, stamps and pad valid: every byte
                      varies;
    ts-edges          live stamps at 0, 2^63 - 1, 2^63 and 2^64 - 1;
    odd-passes        the clustering lane zeroed: 21 passes at K = 13.
    """
    r = make_round(seed, n, N, K)
    rng = np.random.default_rng(seed + 1)
    pad = slice(n, N)
    if case == "pad-zero-lanes":
        r["lanes"][pad] = 0
    elif case == "equal-keys":
        for k in ("lanes", "ts_h", "ts_l"):
            r[k][:n] = r[k][:1]
    elif case == "pad-valid-varies":
        r["valid"][pad] = rng.choice(
            np.array([1, 2, 7, 0xFFFFFFFF], np.uint32), N - n)
        r["lanes"][pad] = rng.choice(
            np.array([0, 5, 0xFFFFFFFF], np.uint32), (N - n, K))
    elif case == "every-byte":
        r["lanes"][:] = _u32(rng, (N, K))
        r["ts_h"][:] = _u32(rng, N)
        r["ts_l"][:] = _u32(rng, N)
        r["valid"][pad] = np.maximum(_u32(rng, N - n), 1)
    elif case == "ts-edges":
        uts = rng.choice(TS_EDGES, n)
        r["ts_h"][:n] = (uts >> np.uint64(32)).astype(np.uint32)
        r["ts_l"][:n] = (uts & U32).astype(np.uint32)
    elif case == "odd-passes":
        r["lanes"][:n, 4] = 0
    elif case != "pad":
        raise ValueError(case)
    return r


def mesh(shards: list, N: int, K: int = 13, seed: int = 0) -> dict:
    """[S, N] operands of the mesh step, shard s built from shards[s] =
    (case, n); case "hot" is a full shard of one cell repeated."""
    rounds = []
    for s, (case, n) in enumerate(shards):
        if case == "hot":
            r = make_round(seed + s, N, N, K)
            r["lanes"][:] = r["lanes"][0]
        else:
            r = build(case, n, N, K, seed + s)
        rounds.append(r)
    ops = {k: np.stack([r[k] for r in rounds]) for k in MESH_COLS}
    ops["now"], ops["gc_before"] = rounds[0]["now"], rounds[0]["gc_before"]
    return ops
