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
