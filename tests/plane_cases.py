"""Rounds (numpy) for the plane programs' sort, K6 (v3 buffers) and K7
(v2 plane dicts), over the round sort's plan, split, pack and passes.
Shared by tests/test_torch_plane_plan.py (against the JAX package, on
the CPU) and tests/test_torch_cuda.py (kernel against plain, on the
card); this module imports no jax.

Live rows come first, n of N; padding rows carry the rank's all-ones
sentinel, as the host packers lay them out."""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import make_v2_round  # noqa: E402

TOP = {"uint8": 0xFF, "uint16": 0xFFFF, "uint32": 0xFFFFFFFF}

# K6 plane widths: (rank dtype, lane dtypes, q dtypes)
SMOKE_FAST = ("uint16", ("uint16", "uint8"), ("uint32",))
FAST_WIDTHS = {
    "u8": ("uint8", ("uint8",), ("uint8",)),
    "u16": SMOKE_FAST,
    "u32": ("uint32", ("uint32", "uint16"), ("uint16", "uint32")),
}


def fast_round(seed: int, n: int, N: int, widths=SMOKE_FAST, k: int = 3,
               partitions: int = 4096, const_lane: bool = False):
    """A v3 round of n live rows padded to N: the rank below its
    sentinel (pad rows: the sentinel), lanes over their width's range
    (pad rows: 0; `const_lane`: lane 0 one value), q planes over their
    range with 30% of the rows among four values (ties), then the int32
    offsets of k runs. Returns (buf u8, cfg)."""
    rng = np.random.default_rng(seed)
    rank_dt, lane_dts, q_dts = widths

    def plane(vals, dt, fill):
        a = np.full(N, fill, dtype=dt)
        a[:n] = vals
        return a

    top = TOP[rank_dt]
    parts = [plane(rng.integers(0, min(partitions, top), n), rank_dt, top)]
    for j, dt in enumerate(lane_dts):
        vals = rng.integers(0, TOP[dt] + 1, n, dtype=np.uint64)
        if const_lane and j == 0:
            vals[:] = 1
        parts.append(plane(vals, dt, 0))
    for dt in q_dts:
        q = rng.integers(0, TOP[dt] + 1, n, dtype=np.uint64)
        ties = rng.random(n) < 0.3
        q[ties] = rng.integers(0, 4, int(ties.sum()))
        parts.append(plane(q, dt, 0))
    cuts = np.sort(rng.integers(0, n + 1, k - 1))
    offs = np.concatenate([[0], cuts, [n]]).astype("<i4")
    buf = np.concatenate([p.view(np.uint8) for p in parts]
                         + [offs.view(np.uint8)])
    return buf, (rank_dt, tuple(lane_dts), tuple(q_dts), k)


def v2_round(seed: int, n: int, N: int, has_hi: bool = False,
             has_cdel: bool = True, const_lane: bool = False,
             partitions: int = 4096):
    """chip_smoke.make_v2_round (rank, a row lane, the column lane with
    partition and row deletions, ts_lo, ts_mid, cdel), with a ts_hi
    plane over three values when `has_hi`, without the cdel plane when
    not `has_cdel`, and the row lane one value among the live rows when
    `const_lane`. Returns (planes, cfg)."""
    planes, _cfg = make_v2_round(seed, n, N, partitions)
    rng = np.random.default_rng(seed + 1)
    if has_hi:
        hi = np.zeros(N, dtype=np.uint16)
        hi[:n] = rng.integers(0x8000, 0x8003, n)
        planes["ts_hi"] = hi
    if not has_cdel:
        del planes["cdel"]
    if const_lane:
        planes["lane0"][:n] = 5
    return planes, (1, 1, 0, has_hi, has_cdel)
