"""Device merge/reconcile: the sort and reconcile kernels of a
compaction round (counterpart of cassandra_tpu/ops/merge.py).

A merge round concatenates the input runs' cells, sorts them by
(valid, identity lanes, ts descending) and computes winners, deletion
shadowing, TTL expiry and purge as masks over the sorted order. Two
kernels do the device work:

  K1 `device_sort_perm`  the stable lexicographic sort permutation
                         (csrc/sort.cu: LSD radix passes);
  K2 `reconcile_kernel`  boundaries, forward-filled deletion stamps and
                         the packed masks (csrc/reconcile.cu).

Each has its plain PyTorch version beside it (`sort_perm_plain`,
`reconcile_plain`), which the wrapper runs for tensors on the CPU and
only then; for CUDA tensors it launches the kernel or raises.

Operands follow the JAX package's layout: u32 lanes travel as the bit
patterns of int32 tensors (torch has no unsigned 32-bit compares), and
the plain versions widen them to int64 (`& 0xFFFFFFFF`) before they
compare; ldt, now and gc_before compare signed. The `valid` lane is
inverted (0 = a real row); padding rows carry lanes 0xFFFFFFFF and sort
to the tail.

Tie-breaks beyond (identity, timestamp) are resolved on the host
(`host_tiebreak`) with full value bytes, exactly as the JAX package
does; `finalize_merged` materialises the kept cells.

The non-resident round programs of the JAX package (v3 truncated-key
planes, K6; v2 compressed planes, K7) are not ported yet: `submit_merge`
runs range-bound rounds on the host as the JAX package does and raises
for rounds that would need K6 or K7 (ROADMAP queue 2).
"""
from __future__ import annotations

import numpy as np
import torch

from ..schema import COL_PARTITION_DEL, COL_ROW_DEL
from ..service.profiling import GLOBAL as _kprof
from ..storage.cellbatch import (DEATH_FLAGS, FLAG_COMPLEX_DEL,
                                 FLAG_COUNTER, FLAG_EXPIRING,
                                 FLAG_RANGE_BOUND, FLAG_TOMBSTONE, CellBatch,
                                 apply_counter_sums, sum_counter_runs)
from . import cuda_lib

_U32 = 0xFFFFFFFF
OPERAND_COLS = ("lanes", "valid", "ts_h", "ts_l", "death", "cdel", "ldt",
                "expiring", "purge_h", "purge_l")


def _i32(a: np.ndarray) -> np.ndarray:
    """u32 (or i32) numpy column -> its int32 bit pattern (a writable
    array: torch shares its memory on the CPU)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return a.view(np.int32) if a.dtype.itemsize == 4 else \
        a.astype(np.int32)


def host_to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device`. To a card the copy goes
    through pinned memory and does not block the host (a pageable copy
    would wait for the stream, stalling the rounds in flight); on the
    CPU the tensor shares the array's memory."""
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def operands_to_device(operands: dict, device) -> dict:
    """Move a numpy operand dict (build_operands) to `device` as int32
    tensors (flags8 stays uint8); the scalars `now` and `gc_before`
    stay Python ints."""
    out = {}
    for k, v in operands.items():
        if k in ("now", "gc_before"):
            out[k] = int(v)
        elif v.dtype == np.uint8:
            out[k] = host_to_device(np.array(v, order="C"), device)
        else:
            out[k] = host_to_device(_i32(v), device)
    return out


def _wide(t: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern of a u32 lane -> its unsigned value in int64."""
    return t.to(torch.int64) & _U32


def _lt_pair(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al < bl))


def _le_pair(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al <= bl))


def _on_cuda(operands: dict) -> bool:
    """True when the operands live on a CUDA device (launch the kernel),
    False on the CPU (run the plain version); raises otherwise."""
    dev = operands["lanes"].device
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev!s}")


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_operands(operands: dict) -> tuple[int, int]:
    lanes = operands["lanes"]
    if lanes.dim() != 2:
        raise ValueError("lanes must be (N, K)")
    N, K = lanes.shape
    if K < 7 or K > 64:
        raise ValueError(f"lane count {K} outside the kernels' 7..64")
    _check(lanes, "lanes", torch.int32, (N, K), lanes.device)
    for k in OPERAND_COLS[1:]:
        _check(operands[k], k, torch.int32, (N,), lanes.device)
    return N, K


# ------------------------------------------------------------------- sort --

def _sort_keys(operands) -> list:
    """Most-significant first: validity, identity lanes, ~ts (int64)."""
    lanes = _wide(operands["lanes"])
    K = lanes.shape[1]
    keys = [_wide(operands["valid"])]
    keys += [lanes[:, k] for k in range(K)]
    keys += [_U32 - _wide(operands["ts_h"]), _U32 - _wide(operands["ts_l"])]
    return keys


def sort_perm_plain(operands) -> torch.Tensor:
    """Plain PyTorch K1: K+3 chained stable sorts, least significant key
    first (the JAX package's LSD composition). int32[N]."""
    keys = _sort_keys(operands)
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm.to(torch.int32)


def _sort_perm_cuda(operands) -> torch.Tensor:
    N, K = _check_operands(operands)
    lanes = operands["lanes"]
    lib = cuda_lib.lib()
    with torch.cuda.device(lanes.device):
        perm = torch.empty(N, dtype=torch.int32, device=lanes.device)
        tmp = torch.empty_like(perm)
        scratch = torch.empty(lib.ctpu_sort_scratch_bytes(N),
                              dtype=torch.uint8, device=lanes.device)
        rc = lib.ctpu_sort_perm(
            lanes.data_ptr(), K, operands["valid"].data_ptr(),
            operands["ts_h"].data_ptr(), operands["ts_l"].data_ptr(), N,
            perm.data_ptr(), tmp.data_ptr(), scratch.data_ptr(),
            cuda_lib.stream_of(lanes))
        cuda_lib.check(rc, "ctpu_sort_perm")
        cuda_lib.count_launch("merge.sort_perm", N)
    return perm


def device_sort_perm(operands) -> torch.Tensor:
    """K1: the stable lexicographic sort permutation over (valid,
    lanes[0..K-1], ~ts_h, ~ts_l) as int32[N]. CUDA operands launch the
    kernel; CPU operands run `sort_perm_plain`."""
    if _on_cuda(operands):
        return _sort_perm_cuda(operands)
    return sort_perm_plain(operands)


device_sort_perm = _kprof.wrap("merge.sort_perm", device_sort_perm)


# -------------------------------------------------------------- reconcile --

def _seg_carry_pair(vh, vl, is_start):
    """Forward-fill (vh, vl) from each segment start across the segment:
    the value at the latest start at or before each position."""
    idx = torch.arange(is_start.shape[0], device=is_start.device)
    start = torch.cummax(torch.where(is_start, idx, 0), 0).values
    return vh[start], vl[start]


def _prev_eq(a):
    """a shifted by one (the first element compares unequal)."""
    return torch.cat([(~a[:1]) & _U32, a[:-1]])


def reconcile_plain(operands, perm) -> torch.Tensor:
    """Plain PyTorch K2 (the JAX package's `_reconcile_core`): the packed
    u8 masks in sorted order (bit0 keep, bit1 ambiguous, bit2 expired,
    bit3 shadowed)."""
    p = perm.to(torch.int64)
    lanes = _wide(operands["lanes"])[p]
    N, K = lanes.shape
    g = lambda k: operands[k][p]  # noqa: E731
    ts_h, ts_l = _wide(g("ts_h")), _wide(g("ts_l"))
    valid = g("valid") == 0
    ldt = g("ldt")
    expiring = g("expiring") == 1
    is_cd = g("cdel") == 1
    purge_h, purge_l = _wide(g("purge_h")), _wide(g("purge_l"))
    death = g("death") == 1

    # ---- boundaries
    prev = torch.cat([torch.full((1, K), _U32, dtype=torch.int64,
                                 device=lanes.device), lanes[:-1]])
    diff = lanes != prev
    first = torch.zeros(N, dtype=torch.bool, device=lanes.device)
    first[0] = True
    part_new = first | diff[:, :4].any(dim=1)
    row_new = part_new | diff[:, 4:K - 3].any(dim=1)
    col_new = row_new | diff[:, K - 3]
    cell_new = col_new | diff[:, K - 2:].any(dim=1)

    col = lanes[:, K - 3]
    winner = cell_new & valid

    # ---- deletion shadowing
    is_pd = col == COL_PARTITION_DEL
    is_rd = col == COL_ROW_DEL
    zero = torch.zeros_like(ts_h)
    pd_h, pd_l = _seg_carry_pair(torch.where(part_new & is_pd, ts_h, zero),
                                 torch.where(part_new & is_pd, ts_l, zero),
                                 part_new)
    rd_h, rd_l = _seg_carry_pair(torch.where(row_new & is_rd, ts_h, zero),
                                 torch.where(row_new & is_rd, ts_l, zero),
                                 row_new)
    use_pd = _lt_pair(rd_h, rd_l, pd_h, pd_l)
    del_h = torch.where(use_pd, pd_h, rd_h)
    del_l = torch.where(use_pd, pd_l, rd_l)
    cd_h, cd_l = _seg_carry_pair(torch.where(col_new & is_cd, ts_h, zero),
                                 torch.where(col_new & is_cd, ts_l, zero),
                                 col_new)
    use_cd = _lt_pair(del_h, del_l, cd_h, cd_l)
    cdel_h = torch.where(use_cd, cd_h, del_h)
    cdel_l = torch.where(use_cd, cd_l, del_l)

    plain = ~is_pd & ~is_rd & ~is_cd
    false = torch.zeros_like(plain)
    shadowed = torch.where(
        plain, _le_pair(ts_h, ts_l, cdel_h, cdel_l),
        torch.where(is_rd, _le_pair(ts_h, ts_l, pd_h, pd_l),
                    torch.where(is_cd, _le_pair(ts_h, ts_l, del_h, del_l),
                                false)))

    # ---- TTL expiry + purge (ldt, now and gc_before compare signed)
    expired = expiring & (ldt <= int(operands["now"]))
    death_eff = death | expired
    purgeable = _lt_pair(ts_h, ts_l, purge_h, purge_l)
    purged = death_eff & (ldt < int(operands["gc_before"])) & purgeable

    keep = winner & ~shadowed & ~purged

    # ---- ties the sort didn't order: same identity AND same ts
    same_ts = (ts_h == _prev_eq(ts_h)) & (ts_l == _prev_eq(ts_l))
    ambiguous = (~cell_new) & same_ts & valid

    return (keep.to(torch.uint8)
            | (ambiguous.to(torch.uint8) << 1)
            | (expired.to(torch.uint8) << 2)
            | (shadowed.to(torch.uint8) << 3))


def _reconcile_cuda(operands, perm) -> torch.Tensor:
    N, K = _check_operands(operands)
    lanes = operands["lanes"]
    _check(perm, "perm", torch.int32, (N,), lanes.device)
    lib = cuda_lib.lib()
    with torch.cuda.device(lanes.device):
        packed = torch.empty(N, dtype=torch.uint8, device=lanes.device)
        scratch = torch.empty(lib.ctpu_reconcile_scratch_bytes(N),
                              dtype=torch.uint8, device=lanes.device)
        o = operands
        rc = lib.ctpu_reconcile(
            lanes.data_ptr(), K, o["ts_h"].data_ptr(), o["ts_l"].data_ptr(),
            o["valid"].data_ptr(), o["ldt"].data_ptr(),
            o["expiring"].data_ptr(), o["cdel"].data_ptr(),
            o["death"].data_ptr(), o["purge_h"].data_ptr(),
            o["purge_l"].data_ptr(), int(o["now"]), int(o["gc_before"]),
            perm.data_ptr(), N, packed.data_ptr(), scratch.data_ptr(),
            cuda_lib.stream_of(lanes))
        cuda_lib.check(rc, "ctpu_reconcile")
        cuda_lib.count_launch("merge.reconcile", N)
    return packed


def reconcile_kernel(operands, perm) -> torch.Tensor:
    """K2: the packed u8 masks of a round over its sort permutation.
    CUDA operands launch the kernel; CPU operands run
    `reconcile_plain`."""
    if _on_cuda(operands):
        return _reconcile_cuda(operands, perm)
    return reconcile_plain(operands, perm)


reconcile_kernel = _kprof.wrap("merge.reconcile", reconcile_kernel)


# ----------------------------------------------------------------- rounds --

_K67_MSG = ("this round needs the non-resident plane programs (K6/K7: "
            "counter cells, oversized frames or device_resident=False), "
            "which are not ported to the CUDA package yet (ROADMAP "
            "queue 2, K6/K7)")


class DeviceMergeHandle:
    """A merge round submitted through `submit_merge`. In this package
    only host-computed rounds exist (empty and range-bound rounds); the
    rest need the plane programs K6/K7, which are not ported yet."""

    __slots__ = ("mode", "result", "cat", "n")


def submit_merge(batches: list[CellBatch], gc_before: int = 0,
                 now: int = 0, purgeable_ts_fn=None,
                 prof: dict | None = None,
                 device=None) -> DeviceMergeHandle:
    """Submit one non-resident merge round. Empty rounds and rounds with
    range-tombstone bounds compute on the host (numpy spec path), as in
    the JAX package; any other round needs K6/K7 and raises
    NotImplementedError."""
    from ..storage.cellbatch import merge_sorted as cb_merge_fallback

    h = DeviceMergeHandle()
    cat = CellBatch.concat(batches)
    h.cat, h.n = cat, len(cat)
    if h.n == 0:
        h.mode, h.result = "done", cat
        return h
    if ((cat.flags & FLAG_RANGE_BOUND) != 0).any():
        # range tombstone coverage is evaluated host-side on full
        # composites — numpy spec path
        h.mode = "done"
        h.result = cb_merge_fallback(batches, gc_before, now,
                                     purgeable_ts_fn)
        return h
    raise NotImplementedError(_K67_MSG)


def collect_merge(h: DeviceMergeHandle) -> CellBatch:
    """The result of a round from `submit_merge`."""
    return h.result


# ------------------------------------------------------------ host passes --

def _bucket(n: int) -> int:
    """Pad to power-of-two buckets >= 1024: the JAX package's round
    shapes, kept so both packages see the same padded operands."""
    b = 1024
    while b < n:
        b <<= 1
    return b



def build_operands(cat: CellBatch, gc_before: int = 0, now: int = 0,
                   purgeable_ts_fn=None, bucket: int | None = None) -> dict:
    """Pack a CellBatch into the kernels' padded uint32 operand arrays
    (numpy, on the host; `operands_to_device` moves them)."""
    n = len(cat)
    N = bucket or _bucket(n)
    K = cat.n_lanes

    lanes = np.full((N, K), 0xFFFFFFFF, dtype=np.uint32)
    lanes[:n] = cat.lanes
    valid = np.ones(N, dtype=np.uint32)
    valid[:n] = 0
    with np.errstate(over="ignore"):
        uts = cat.ts.astype(np.uint64) ^ np.uint64(1 << 63)
    ts_h = np.zeros(N, dtype=np.uint32)
    ts_l = np.zeros(N, dtype=np.uint32)
    ts_h[:n] = (uts >> np.uint64(32)).astype(np.uint32)
    ts_l[:n] = (uts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    death = np.zeros(N, dtype=np.uint32)
    death[:n] = (cat.flags & DEATH_FLAGS) != 0
    cdel = np.zeros(N, dtype=np.uint32)
    cdel[:n] = (cat.flags & FLAG_COMPLEX_DEL) != 0
    ldt = np.zeros(N, dtype=np.int32)
    ldt[:n] = cat.ldt
    expiring = np.zeros(N, dtype=np.uint32)
    expiring[:n] = (cat.flags & FLAG_EXPIRING) != 0

    if purgeable_ts_fn is not None:
        pts = purgeable_ts_fn(cat).astype(np.int64)
        with np.errstate(over="ignore"):
            upts = pts.astype(np.uint64) ^ np.uint64(1 << 63)
        purge_h = np.zeros(N, dtype=np.uint32)
        purge_l = np.zeros(N, dtype=np.uint32)
        purge_h[:n] = (upts >> np.uint64(32)).astype(np.uint32)
        purge_l[:n] = (upts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    else:
        purge_h = np.full(N, 0xFFFFFFFF, dtype=np.uint32)
        purge_l = np.full(N, 0xFFFFFFFF, dtype=np.uint32)

    return {
        "lanes": lanes, "valid": valid, "ts_h": ts_h, "ts_l": ts_l,
        "death": death, "cdel": cdel, "ldt": ldt, "expiring": expiring,
        "purge_h": purge_h, "purge_l": purge_l,
        "gc_before": np.int32(gc_before), "now": np.int32(now),
    }



def unpack_masks(packed: np.ndarray):
    """(keep, ambiguous, expired, shadowed) from the kernel's packed uint8
    lane — the single definition of the bit layout."""
    return ((packed & 1).astype(bool), (packed & 2).astype(bool),
            (packed & 4).astype(bool), (packed & 8).astype(bool))



def finalize_merged(cat: CellBatch, perm_real: np.ndarray,
                    keep: np.ndarray, expired: np.ndarray,
                    shadowed: np.ndarray) -> CellBatch:
    """Materialize the merged output from kernel masks: gather kept cells
    in sorted order, sum counter runs, convert expired-TTL winners to
    tombstones. Shared by the single-device and mesh-sharded paths."""
    kept_sorted_pos = np.flatnonzero(keep)
    out = cat.apply_permutation(perm_real[kept_sorted_pos])
    out.sorted = True
    if ((cat.flags & FLAG_COUNTER) != 0).any():
        # counter columns reconcile by summation (host pass, as in the
        # numpy path; counter tables are the uncommon case)
        s = cat.apply_permutation(perm_real)
        sums = sum_counter_runs(s, keep, shadowed)
        out = apply_counter_sums(out, kept_sorted_pos, sums)
    converted = expired[kept_sorted_pos]
    if converted.any():
        out.flags[converted] |= FLAG_TOMBSTONE
        out = out.drop_values(converted)
    return out


def host_tiebreak(cat: CellBatch, perm_real: np.ndarray, keep: np.ndarray,
                  amb: np.ndarray, shadowed: np.ndarray,
                  expired: np.ndarray, gc_before: int,
                  pts_sorted: np.ndarray | None,
                  order_by_ts: bool = False) -> None:
    """Resolve equal-(identity, ts) runs with exact Cells.resolveRegular
    rules (db/rows/Cells.java:79, CASSANDRA-14592): expiring-or-tombstone
    beats live, pure tombstone beats expiring, larger localDeletionTime,
    larger value bytes, then first-seen. Mutates `keep` in place. Arrays
    are in SORTED order; perm_real maps sorted position -> index into
    `cat`. Shared by the single-device and the mesh-sharded paths.

    order_by_ts: the truncated-key fast path marks runs whose TRUNCATED
    stamps collide — exact timestamps may differ inside a run, so the
    winner key leads with the full ts before the resolveRegular ranking."""
    if not amb.any():
        return
    n = len(perm_real)
    flags_sorted = cat.flags[perm_real]
    death_orig = (flags_sorted & DEATH_FLAGS) != 0
    # rank-grade tombstone: STATIC isTombstone (death, no ttl) so the
    # rank survives expired->tombstone conversion (CASSANDRA-14592);
    # must mirror CellBatch._pure_death_lane and merge.cpp beats()
    pure_death = death_orig & ((flags_sorted & FLAG_EXPIRING) == 0)
    eot = death_orig | ((flags_sorted & FLAG_EXPIRING) != 0)
    death_eff = death_orig | expired
    ldt_sorted = cat.ldt[perm_real]
    ts_sorted = cat.ts[perm_real]
    lanes_sorted = cat.lanes[perm_real]
    cell_new = np.ones(n, dtype=bool)
    if n > 1:
        cell_new[1:] = (lanes_sorted[1:] != lanes_sorted[:-1]).any(axis=1)

    def orig_value(i):
        j = perm_real[i]
        return cat.payload[cat.val_start[j]:cat.off[j + 1]].tobytes()

    idxs = np.flatnonzero(amb)
    prev_i = -2
    runs = []
    for i in idxs:
        if i != prev_i + 1:
            runs.append([i - 1, i])
        else:
            runs[-1][1] = i
        prev_i = i
    for lo, hi in runs:
        if lo < 0 or not cell_new[lo]:
            continue  # run of older duplicates below the winner
        if order_by_ts:
            best = max(range(lo, hi + 1),
                       key=lambda i: (int(ts_sorted[i]), bool(eot[i]),
                                      bool(pure_death[i]),
                                      int(ldt_sorted[i]), orig_value(i)))
        else:
            best = max(range(lo, hi + 1),
                       key=lambda i: (bool(eot[i]), bool(pure_death[i]),
                                      int(ldt_sorted[i]), orig_value(i)))
        keep[lo:hi + 1] = False
        purgeable = pts_sorted is None or ts_sorted[best] < pts_sorted[best]
        purged = bool(death_eff[best]) and ldt_sorted[best] < gc_before \
            and purgeable
        keep[best] = not (shadowed[best] or purged)
