"""The round sort over the plane programs' keys (K6's v3 planes, K7's v2
planes) held exactly against the JAX package on the CPU: the plan of
the key bytes that vary among the live rows (rank below its all-ones
sentinel) and among the padding rows, in the (plane, shift) byte order
the kernel uses, and the sort it gives (split, pack, one stable pass
per packed byte), in plain PyTorch (`sort_plan_plain`,
`sort_perm_packed_plain` over `fast_sort_key` / `v2_sort_key`), against
JAX `_plane_lsd_sort`, and with the programs' tails over it against JAX
`_plane_program` and `_plane_program_fast`. The CUDA kernels are held
against the same rounds on the card (tests/test_torch_cuda.py)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassandra_tpu.ops import merge as jmerge
from plane_cases import FAST_WIDTHS, TOP, fast_round, v2_round

from cassandra_tpu_torch.ops import merge as tmerge
from chip_smoke import (PLANE_PADS, make_fast_round, make_v2_round,
                        plane_cells_for)

# (widths, live rows, padded rows, constant lane)
FAST = [(w, n, N, False) for w in FAST_WIDTHS
        for n, N in ((3000, 4096), (0, 2048), (1, 1024))]
FAST += [("u16", 2000, 2048, True), ("u8", 1024, 1024, False)]

# (live rows, padded rows, ts_hi, cdel, constant lane)
V2 = [(3000, 4096, hi, cd, False) for hi in (False, True)
      for cd in (False, True)]
V2 += [(0, 2048, False, True, False), (1, 1024, True, False, False),
       (2000, 2048, False, False, True), (1024, 1024, True, True, False)]


def _check_plan(plan, key, n, N, const_lane):
    widths = [w for _v, w in key.planes]
    assert plan["key_bytes"] == sum(widths)
    assert plan["sizes"].tolist() == [[n, N - n]]
    (live_bytes, pad_bytes), = plan["bytes"]
    assert plan["passes"] == max(len(live_bytes), len(pad_bytes))
    assert pad_bytes == []              # identical padding runs no pass
    if n <= 1:
        assert plan["passes"] == 0
    if const_lane:                      # lane 0: the bytes after the rank
        assert not set(range(widths[0], widths[0] + widths[1])) \
            & set(live_bytes)


@pytest.mark.parametrize("widths,n,N,const_lane", FAST,
                         ids=[f"{c[0]}-{c[1]}of{c[2]}"
                              + ("-const" if c[3] else "") for c in FAST])
def test_fast_plan_matches_jax(widths, n, N, const_lane):
    buf, cfg = fast_round(n + N, n, N, FAST_WIDTHS[widths],
                          const_lane=const_lane)
    b = tmerge.planes_to_device(buf, "cpu")
    key = tmerge.fast_sort_key(b, cfg)
    assert key.live_below == TOP[cfg[0]]     # the rank's sentinel
    _check_plan(tmerge.sort_plan_plain(key), key, n, N, const_lane)
    perm = tmerge.sort_perm_packed_plain(key)
    assert torch.equal(perm.to(torch.int64), tmerge._stable_perm(
        [v for v, _w in key.planes[::-1]]))
    jout = np.asarray(jmerge._plane_program_fast(buf, cfg))
    np.testing.assert_array_equal(
        tmerge.plane_fast_tail_plain(b, cfg, perm).numpy(), jout)
    np.testing.assert_array_equal(
        tmerge.plane_program_fast(b, cfg).numpy(), jout)


def _jax_planes(planes):
    return {k: jnp.asarray(v) for k, v in planes.items()}


@pytest.mark.parametrize("n,N,has_hi,has_cdel,const_lane", V2,
                         ids=[f"{c[0]}of{c[1]}" + ("-hi" if c[2] else "")
                              + ("-cdel" if c[3] else "")
                              + ("-const" if c[4] else "") for c in V2])
def test_v2_plan_matches_jax(n, N, has_hi, has_cdel, const_lane):
    planes, cfg = v2_round(n + N, n, N, has_hi, has_cdel, const_lane)
    p = tmerge.planes_to_device(planes, "cpu")
    key = tmerge.v2_sort_key(p, cfg)
    assert key.live_below == 0xFFFFFFFF
    assert [w for _v, w in key.planes] == \
        [4, 4, 4] + ([2] if has_hi else []) + [2, 4]
    _check_plan(tmerge.sort_plan_plain(key), key, n, N, const_lane)
    perm = tmerge.sort_perm_packed_plain(key)
    jperm = np.asarray(jmerge._plane_lsd_sort(_jax_planes(planes), cfg))
    np.testing.assert_array_equal(perm.numpy(), jperm)
    jout = np.asarray(jmerge._plane_program(planes, cfg))
    out = tmerge.plane_reconcile_plain(p, cfg, perm).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), jout)
    np.testing.assert_array_equal(
        tmerge.plane_program(p, cfg).numpy().view(np.uint32), jout)


@pytest.mark.parametrize("w", ["uint8", "uint16", "uint32"])
def test_pad_sentinel_at_every_width(w):
    """A round whose live ranks reach sentinel - 1: every live row
    sorts before every padding row, and the padding rows (rank = the
    sentinel, lanes and stamps 0) run no pass."""
    n, N = 700, 1024
    buf, cfg = fast_round(5, n, N, (w, ("uint16",), ("uint32",)))
    top = TOP[w]
    rank = np.frombuffer(buf[:N * np.dtype(w).itemsize], dtype=w).copy()
    rank[:n:3] = top - 1
    buf[:rank.nbytes] = rank.view(np.uint8)
    b = tmerge.planes_to_device(buf, "cpu")
    key = tmerge.fast_sort_key(b, cfg)
    plan = tmerge.sort_plan_plain(key)
    assert plan["sizes"].tolist() == [[n, N - n]]
    assert plan["bytes"][0][1] == []
    perm = tmerge.sort_perm_packed_plain(key)
    assert bool((perm[:n] < n).all()) and bool((perm[n:] >= n).all())
    np.testing.assert_array_equal(
        tmerge.plane_fast_tail_plain(b, cfg, perm).numpy(),
        np.asarray(jmerge._plane_program_fast(buf, cfg)))


@pytest.mark.parametrize("N", PLANE_PADS)
def test_smoke_plane_rounds_plan(N):
    """chip_smoke's plane rounds at 2^19 and 786,432 (seed 7): K6 runs 8
    passes of its 9 key bytes (2 rank bytes, 1 + 1 lane bytes, 4 stamp
    bytes), K7 8 of its 18 (2 rank, 1 row lane, 1 column lane, 1 of
    ~ts_mid, 3 of ~ts_lo); their padding rows run none. The mirror
    equals the JAX package."""
    n = plane_cells_for(N)
    buf, cfg = make_fast_round(7 + 3, n, N)
    b = tmerge.planes_to_device(buf, "cpu")
    key = tmerge.fast_sort_key(b, cfg)
    plan = tmerge.sort_plan_plain(key)
    assert (plan["passes"], plan["key_bytes"]) == (8, 9)
    assert [len(g) for g in plan["bytes"][0]] == [8, 0]
    perm = tmerge.sort_perm_packed_plain(key)
    np.testing.assert_array_equal(
        tmerge.plane_fast_tail_plain(b, cfg, perm).numpy(),
        np.asarray(jmerge._plane_program_fast(buf, cfg)))

    planes, cfg2 = make_v2_round(7 + 4, n, N)
    p = tmerge.planes_to_device(planes, "cpu")
    key2 = tmerge.v2_sort_key(p, cfg2)
    plan2 = tmerge.sort_plan_plain(key2)
    assert (plan2["passes"], plan2["key_bytes"]) == (8, 18)
    assert [len(g) for g in plan2["bytes"][0]] == [8, 0]
    perm2 = tmerge.sort_perm_packed_plain(key2)
    np.testing.assert_array_equal(
        perm2.numpy(),
        np.asarray(jmerge._plane_lsd_sort(_jax_planes(planes), cfg2)))
