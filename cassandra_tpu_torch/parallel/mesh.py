"""Multi-card data plane: token-range sharding over a mesh of torch
devices (counterpart of cassandra_tpu/parallel/mesh.py).

Design (SURVEY.md section 5.7): the reference parallelises compaction
within a node via UCS's ShardManager (db/compaction/ShardManager.java:33 —
token-range shards compacted independently) and across the cluster by
ownership. The device formulation is the same idea on a mesh: the
token ring is split into one contiguous range per shard, each shard's
device runs the merge/reconcile kernels on it, and the shard outputs
concatenate — in token order — into exactly the single-device merge.

A mesh (`Mesh`) is the list of the shards' devices: `make_mesh(n)`
gives one shard per card (`cuda:0..n-1`), `make_mesh(n, device="cpu")`
n shards on the CPU (the plain PyTorch versions), and an explicit
`Mesh([torch.device("cuda", 0)] * 4)` four shards on one card.

Two execution paths share the boundary planner:

  per-device dispatch (_run_sharded, the data-plane path): each shard's
      operands go to its own device and its merge (K1 + K2,
      `ops.merge.merge_reconcile_kernel`) is driven from a dedicated
      host thread on a CUDA stream of its own, so shards overlap, also
      when they share a card. Each shard pads to its own power-of-two
      bucket, so a skewed shard does not inflate every other shard's
      padded round the way an [S, N_max] layout does.
  one program (sharded_merge_step): the [S, N] operands of
      `shard_batch`; every card runs all of its shards in one launch
      sequence of the mesh kernel K8 (csrc/mesh.cu, `sharded_step`),
      and the host sums the cards' (kept, dropped) pairs (the psum).

Boundary planning (the ShardManager.computeBoundaries role) lives in
the device-free sibling module `boundaries.py` and is re-exported here
as the JAX package does.

The per-shard stats every path records land in the `mesh.*` metrics
group (service/metrics.py -> Prometheus): shard cells, device wall
time, shard imbalance.
"""
from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

from .. import device as devmod
from ..ops import cuda_lib
from ..ops.merge import (_check, merge_reconcile_kernel,
                         operands_to_device, reconcile_plain,
                         sort_perm_plain)
from ..service.profiling import GLOBAL as _kprof
from ..storage.cellbatch import (DEATH_FLAGS, FLAG_COMPLEX_DEL,
                                 FLAG_EXPIRING, CellBatch)
from .boundaries import (_BIAS, batch_tokens_u64,  # noqa: F401
                         boundaries_from_indexes, boundaries_to_ranges,
                         distinct_token_weights, plan_token_boundaries,
                         record_shard_metrics, shard_imbalance)

_SCALARS = ("gc_before", "now")
_STEP_COLS = ("valid", "ts_h", "ts_l", "death", "cdel", "ldt", "expiring",
              "purge_h", "purge_l")


class Mesh:
    """The shards' devices: `devices` is a numpy object array of
    torch.device (shard s runs on devices.flat[s]), so `devices.size`
    and `devices.flat` read as a jax Mesh's do. Several shards may
    name one device."""

    def __init__(self, devices):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """One shard per card, `cuda:0..n-1` (all the cards when n_devices
    is None); raises when the machine has fewer cards, and without a
    card. device="cpu": n_devices shards on the CPU (one when None), the
    counterpart of the JAX package's virtual CPU devices."""
    dev = devmod.resolve(device)
    if dev.type == "cpu":
        return Mesh([dev] * (1 if n_devices is None else n_devices))
    count = torch.cuda.device_count()
    if n_devices is not None:
        if count < n_devices:
            raise RuntimeError(
                f"mesh needs {n_devices} devices, backend 'cuda' has "
                f"{count}")
        count = n_devices
    return Mesh([torch.device("cuda", i) for i in range(count)])


def _mesh_devices(mesh: Mesh) -> list:
    """The mesh's devices, each resolved (a CUDA device without a card
    raises here)."""
    seen: dict = {}
    out = []
    for d in mesh.devices.flat:
        if d not in seen:
            seen[d] = devmod.resolve(d)
        out.append(seen[d])
    return out


# ---------------------------------------------------- boundary planning --
# (planners live in boundaries.py — device-free — and are re-exported
# above; the split below is the mesh-side consumer)

def compute_shards(cat: CellBatch, n_shards: int, boundaries=None):
    """Assign every cell to its token-range shard. Returns (bounds,
    shard_of, pos_in_shard, members). boundaries=None plans
    distinct-weighted ones from the batch itself."""
    n = len(cat)
    tok = batch_tokens_u64(cat)
    if boundaries is None:
        uniq, w = distinct_token_weights(cat)
        boundaries = plan_token_boundaries(uniq, w, n_shards)
    bounds = np.asarray(boundaries, dtype=np.uint64)
    shard_of = np.searchsorted(bounds, tok, side="left").astype(np.int32)
    pos_in_shard = np.zeros(n, dtype=np.int64)
    members: list[np.ndarray] = []
    for s in range(n_shards):
        idx = np.flatnonzero(shard_of == s)
        members.append(idx)
        pos_in_shard[idx] = np.arange(len(idx))
    return bounds, shard_of, pos_in_shard, members


# ------------------------------------------------------------- host split --

def shard_batch(cat: CellBatch, n_shards: int, gc_before: int = 0,
                now: int = 0, boundaries=None):
    """Split a concatenated (unsorted) batch into n token-range shards of
    equal padded size and build the [S, N] operand arrays for
    sharded_merge_step (the one-program path). Returns
    (operands, shard_of, position_in_shard, shard_members) so the host
    can map kernel outputs back to cells."""
    n = len(cat)
    _bounds, shard_of, pos_in_shard, shard_members = compute_shards(
        cat, n_shards, boundaries)
    counts = np.bincount(shard_of, minlength=n_shards)
    N = max(1024, int(1 << int(np.ceil(np.log2(max(counts.max(), 1))))))

    K = cat.n_lanes
    S = n_shards
    lanes = np.full((S, N, K), 0xFFFFFFFF, dtype=np.uint32)
    valid = np.ones((S, N), dtype=np.uint32)
    ts_h = np.zeros((S, N), dtype=np.uint32)
    ts_l = np.zeros((S, N), dtype=np.uint32)
    death = np.zeros((S, N), dtype=np.uint32)
    cdel = np.zeros((S, N), dtype=np.uint32)
    ldt = np.zeros((S, N), dtype=np.int32)
    expiring = np.zeros((S, N), dtype=np.uint32)
    purge = np.full((S, N), 0xFFFFFFFF, dtype=np.uint32)

    with np.errstate(over="ignore"):
        uts = cat.ts.astype(np.uint64) ^ np.uint64(1 << 63)
    for s in range(S):
        idx = shard_members[s]
        c = len(idx)
        lanes[s, :c] = cat.lanes[idx]
        valid[s, :c] = 0
        ts_h[s, :c] = (uts[idx] >> np.uint64(32)).astype(np.uint32)
        ts_l[s, :c] = (uts[idx] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        death[s, :c] = (cat.flags[idx] & DEATH_FLAGS) != 0
        cdel[s, :c] = (cat.flags[idx] & FLAG_COMPLEX_DEL) != 0
        ldt[s, :c] = cat.ldt[idx]
        expiring[s, :c] = (cat.flags[idx] & FLAG_EXPIRING) != 0

    operands = {
        "lanes": lanes, "valid": valid, "ts_h": ts_h, "ts_l": ts_l,
        "death": death, "cdel": cdel, "ldt": ldt,
        "expiring": expiring, "purge_h": purge, "purge_l": purge.copy(),
        "gc_before": np.int32(gc_before), "now": np.int32(now),
    }
    return operands, shard_of, pos_in_shard, shard_members


# ---------------------------------------------------- K8: the mesh step --

def sharded_step_plain(operands):
    """Plain PyTorch K8 over one device's [S, N] operands: per shard
    `sort_perm_plain` then `reconcile_plain`, then the (kept, dropped)
    sums. Returns (perm int32[S, N] shard-local, packed u8[S, N],
    stats int64[2])."""
    S = operands["valid"].shape[0]
    perms, packs = [], []
    for s in range(S):
        local = {k: (v if k in _SCALARS else v[s])
                 for k, v in operands.items()}
        perm = sort_perm_plain(local)
        perms.append(perm)
        packs.append(reconcile_plain(local, perm))
    perm, packed = torch.stack(perms), torch.stack(packs)
    kept = (packed & 1).to(torch.int64).sum(dim=1)
    live = (operands["valid"] == 0).to(torch.int64).sum(dim=1)
    stats = torch.stack([kept.sum(), (live - kept).sum()])
    return perm, packed, stats


def _check_step_operands(operands) -> tuple[int, int, int]:
    lanes = operands["lanes"]
    if lanes.dim() != 3:
        raise ValueError("lanes must be (S, N, K)")
    S, N, K = lanes.shape
    if K < 7 or K > 64:
        raise ValueError(f"lane count {K} outside the kernels' 7..64")
    if S * N >= 1 << 31:
        raise ValueError(f"{S} x {N} rows exceed the kernel's int32 rows")
    _check(lanes, "lanes", torch.int32, (S, N, K), lanes.device)
    for k in _STEP_COLS:
        _check(operands[k], k, torch.int32, (S, N), lanes.device)
    return S, N, K


def _sharded_step_cuda(operands):
    S, N, K = _check_step_operands(operands)
    lanes = operands["lanes"]
    dev = lanes.device
    lib = cuda_lib.lib()
    o = operands
    info = (ctypes.c_longlong * 2)()
    with torch.cuda.device(dev):
        perm = torch.empty((S, N), dtype=torch.int32, device=dev)
        packed = torch.empty((S, N), dtype=torch.uint8, device=dev)
        stats_s = torch.empty((S, 2), dtype=torch.int64, device=dev)
        stats = torch.empty(2, dtype=torch.int64, device=dev)
        scratch = torch.empty(lib.ctpu_mesh_scratch_bytes(S, N, K),
                              dtype=torch.uint8, device=dev)
        rc = lib.ctpu_mesh_step(
            lanes.data_ptr(), K, o["valid"].data_ptr(),
            o["ts_h"].data_ptr(), o["ts_l"].data_ptr(), o["ldt"].data_ptr(),
            o["expiring"].data_ptr(), o["cdel"].data_ptr(),
            o["death"].data_ptr(), o["purge_h"].data_ptr(),
            o["purge_l"].data_ptr(), int(o["now"]), int(o["gc_before"]),
            S, N, perm.data_ptr(), packed.data_ptr(), stats_s.data_ptr(),
            stats.data_ptr(), scratch.data_ptr(), cuda_lib.stream_of(lanes),
            info)
        cuda_lib.check(rc, "ctpu_mesh_step")
        cuda_lib.count_launch("mesh.sharded_step", (S, N), passes=info[0],
                              sync_ns=info[1])
    return perm, packed, stats


def sharded_step(operands):
    """K8: every shard of one device's [S, N] operands (int32 tensors,
    lanes [S, N, K]; `now`, `gc_before` ints) sorted and reconciled, and
    the sum of their (kept, dropped). Returns (perm int32[S, N]
    shard-local, packed u8[S, N], stats int64[2]), all on the operands'
    device. CUDA operands launch the kernel; CPU operands run
    `sharded_step_plain`."""
    if cuda_lib.is_cuda(operands["lanes"]):
        return _sharded_step_cuda(operands)
    return sharded_step_plain(operands)


sharded_step = _kprof.wrap("mesh.sharded_step", sharded_step)

_step_cache: dict = {}


def sharded_merge_step(mesh: Mesh):
    """Build (or fetch the cached) sharded compaction step for a mesh:
    a callable over shard_batch's [S, N] numpy operands (S = the mesh's
    size) returning (perm, packed, stats). Each device sorts and
    reconciles the token ranges mapped to it in one K8 launch sequence;
    the per-device (kept, dropped) pairs are summed on the host (the
    psum). perm int32[S, N] and packed u8[S, N] come back on the mesh's
    first device, stats as an int64[2] CPU tensor. Stats are the
    kernel's, taken before the host tie-break. Cached per device
    tuple."""
    devices = _mesh_devices(mesh)
    key = tuple(devices)
    cached = _step_cache.get(key)
    if cached is not None:
        return cached
    groups: dict = {}
    for s, d in enumerate(devices):
        groups.setdefault(d, []).append(s)

    def step(operands):
        S = operands["valid"].shape[0]
        if S != len(devices):
            raise ValueError(f"operands hold {S} shards, the mesh "
                             f"{len(devices)}")
        parts = []
        for dev, idx in groups.items():
            whole = idx == list(range(S))
            sub = {k: (v if k in _SCALARS or whole
                       else np.ascontiguousarray(v[idx]))
                   for k, v in operands.items()}
            parts.append((idx, sharded_step(operands_to_device(sub, dev))))
        first = devices[0]
        if len(parts) == 1:
            perm, packed, stats = parts[0][1]
            return perm, packed, stats.cpu()
        perm = torch.empty((S,) + tuple(parts[0][1][0].shape[1:]),
                           dtype=torch.int32, device=first)
        packed = torch.empty(perm.shape, dtype=torch.uint8, device=first)
        stats = torch.zeros(2, dtype=torch.int64)
        for idx, (p, m, st) in parts:
            rows = torch.tensor(idx, device=first)
            perm[rows] = p.to(first)
            packed[rows] = m.to(first)
            stats += st.cpu()
        return perm, packed, stats

    _step_cache[key] = step
    return step


# ------------------------------------------------ per-device dispatch --

def _shard_bucket(n: int) -> int:
    b = 1024
    while b < n:
        b <<= 1
    return b


def _shard_merge_program(operands):
    """One shard's whole merge (K1 then K2) on the operands' device."""
    return merge_reconcile_kernel(operands)


def _pack_shard_operands(cat: CellBatch, idx: np.ndarray,
                         gc_before: int, now: int) -> dict:
    """Kernel operand arrays for one shard, padded to the shard's OWN
    power-of-two bucket (the [S, N_max] layout paid every shard the
    skew of the largest one)."""
    c = len(idx)
    N = _shard_bucket(c)
    K = cat.n_lanes
    lanes = np.full((N, K), 0xFFFFFFFF, dtype=np.uint32)
    lanes[:c] = cat.lanes[idx]
    valid = np.ones(N, dtype=np.uint32)
    valid[:c] = 0
    with np.errstate(over="ignore"):
        uts = cat.ts[idx].astype(np.uint64) ^ np.uint64(1 << 63)
    ts_h = np.zeros(N, dtype=np.uint32)
    ts_l = np.zeros(N, dtype=np.uint32)
    ts_h[:c] = (uts >> np.uint64(32)).astype(np.uint32)
    ts_l[:c] = (uts & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    death = np.zeros(N, dtype=np.uint32)
    death[:c] = (cat.flags[idx] & DEATH_FLAGS) != 0
    cdel = np.zeros(N, dtype=np.uint32)
    cdel[:c] = (cat.flags[idx] & FLAG_COMPLEX_DEL) != 0
    ldt = np.zeros(N, dtype=np.int32)
    ldt[:c] = cat.ldt[idx]
    expiring = np.zeros(N, dtype=np.uint32)
    expiring[:c] = (cat.flags[idx] & FLAG_EXPIRING) != 0
    purge = np.full(N, 0xFFFFFFFF, dtype=np.uint32)
    return {
        "lanes": lanes, "valid": valid, "ts_h": ts_h, "ts_l": ts_l,
        "death": death, "cdel": cdel, "ldt": ldt, "expiring": expiring,
        "purge_h": purge, "purge_l": purge.copy(),
        "gc_before": np.int32(gc_before), "now": np.int32(now),
    }


def _merge_on(ops_np: dict, dev: torch.device):
    """Move one shard's operands to `dev`, run its merge there and bring
    (perm, packed) back as numpy. On a card the work runs on a stream of
    its own, so shards driven from several threads overlap, also on one
    card."""
    if dev.type != "cuda":
        perm_d, packed_d = _shard_merge_program(
            operands_to_device(ops_np, dev))
        return perm_d.numpy(), packed_d.numpy()
    with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
        perm_d, packed_d = _shard_merge_program(
            operands_to_device(ops_np, dev))
        return perm_d.cpu().numpy(), packed_d.cpu().numpy()


def _run_sharded(cat: CellBatch, mesh: Mesh, gc_before: int, now: int,
                 boundaries=None):
    """split -> per-device dispatch -> host tie-break. Each shard's
    merge runs on its own mesh device and is DRIVEN FROM ITS OWN HOST
    THREAD (and its own CUDA stream), so the shards overlap. Returns the
    full per-shard state (keep/perm/masks in shard-padded [S, N] layout,
    member index lists, (kept, dropped) stats) plus per-shard device
    wall seconds."""
    from ..ops.merge import host_tiebreak, unpack_masks

    n_shards = mesh.devices.size
    devices = _mesh_devices(mesh)
    _bounds, shard_of, pos, members = compute_shards(cat, n_shards,
                                                     boundaries)
    results: list = [None] * n_shards
    walls = [0.0] * n_shards
    errors: list[BaseException] = []

    def run_shard(s: int) -> None:
        idx = members[s]
        if len(idx) == 0:
            return
        try:
            ops_np = _pack_shard_operands(cat, idx, gc_before, now)
            t0 = time.perf_counter()
            perm, packed = _merge_on(ops_np, devices[s])
            walls[s] = time.perf_counter() - t0
            results[s] = (perm, packed)
        except BaseException as e:   # surfaced after join
            errors.append(e)

    t_all = time.perf_counter()
    live = [s for s in range(n_shards) if len(members[s])]
    if len(live) <= 1:
        for s in live:
            run_shard(s)
    else:
        threads = [threading.Thread(target=run_shard, args=(s,),
                                    name=f"mesh-shard-{s}")
                   for s in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    dispatch_s = time.perf_counter() - t_all
    _kprof.record_dispatch(
        "merge.sharded_step",
        (n_shards, (len(cat), cat.n_lanes)),
        dispatch_s)
    _kprof.record_execute("merge.sharded_step", max(walls) if walls
                          else 0.0)

    # assemble the shard-padded [S, N] view (N = largest shard bucket)
    N = max((_shard_bucket(len(members[s])) for s in live), default=1024)
    keep = np.zeros((n_shards, N), dtype=bool)
    amb = np.zeros((n_shards, N), dtype=bool)
    expired = np.zeros((n_shards, N), dtype=bool)
    shadowed = np.zeros((n_shards, N), dtype=bool)
    perm = np.zeros((n_shards, N), dtype=np.int32)
    for s in live:
        p, packed = results[s]
        k, a, e, sh = unpack_masks(packed)
        w = len(p)
        keep[s, :w] = k
        amb[s, :w] = a
        expired[s, :w] = e
        shadowed[s, :w] = sh
        perm[s, :w] = p
    # equal-(identity, ts) winners need the exact death/value rules — per
    # shard, map sorted positions back into cat and resolve on host.
    for s in live:
        c = len(members[s])
        if c == 0 or not amb[s, :c].any():
            continue
        perm_real = members[s][perm[s, :c]]
        host_tiebreak(cat, perm_real, keep[s, :c], amb[s, :c],
                      shadowed[s, :c], expired[s, :c], gc_before, None)
    kept = sum(int(keep[s, :len(members[s])].sum()) for s in live)
    stats = np.array([kept, len(cat) - kept], dtype=np.int64)
    record_shard_metrics([len(members[s]) for s in range(n_shards)],
                         walls)
    return (keep, perm, expired, shadowed, stats, shard_of, pos, members,
            walls, dispatch_s)


def run_sharded_merge(cat: CellBatch, mesh: Mesh, gc_before: int = 0,
                      now: int = 0, boundaries=None):
    """Host orchestration: split -> per-device step -> host tie-break ->
    per-shard outputs. Returns (keep [S,N] numpy, perm [S,N],
    stats (kept, dropped), shard_of, pos_in_shard)."""
    keep, perm, _, _, stats, shard_of, pos, _, _, _ = _run_sharded(
        cat, mesh, gc_before, now, boundaries)
    return keep, perm, stats, shard_of, pos


def materialize_sharded_merge(cat: CellBatch, mesh: Mesh,
                              gc_before: int = 0, now: int = 0,
                              boundaries=None,
                              walls_out: list | None = None,
                              dispatch_out: list | None = None
                              ) -> list[CellBatch]:
    """Per-shard merged CellBatches, token-ordered: shard s holds exactly
    the cells whose token falls in its range, reconciled, sorted. The
    concatenation equals the single-device merge output bit-for-bit, and
    each element can feed its own SSTableWriter — the ShardManager model
    (db/compaction/ShardManager.java:33: disjoint token shards feed
    independent writers). walls_out (optional list) receives the
    per-shard device wall seconds; dispatch_out receives the one-element
    [elapsed seconds] of the whole concurrent dispatch (first thread
    start to last join) — the denominator an overlap proof needs (the
    per-shard walls alone cannot distinguish overlap from a sequential
    loop)."""
    from ..ops.merge import finalize_merged

    (keep, perm, expired, shadowed, _, _, _, members, walls,
     dispatch_s) = _run_sharded(cat, mesh, gc_before, now, boundaries)
    if walls_out is not None:
        walls_out[:] = walls
    if dispatch_out is not None:
        dispatch_out[:] = [dispatch_s]
    out: list[CellBatch] = []
    for s in range(len(members)):
        c = len(members[s])
        if c == 0:
            out.append(CellBatch.empty(cat.n_lanes))
            continue
        perm_real = members[s][perm[s, :c]]
        out.append(finalize_merged(cat, perm_real, keep[s, :c],
                                   expired[s, :c], shadowed[s, :c]))
    return out


def sharded_compact_to_sstables(batches: list[CellBatch], table, mesh,
                                directory: str, generation_base: int = 0,
                                gc_before: int = 0, now: int = 0,
                                shards: list[CellBatch] | None = None):
    """One compaction round over the mesh, landing one sstable per shard:
    merge the input CellBatches sharded across devices, then write each
    shard's reconciled output through a real SSTableWriter. Pass
    precomputed `shards` (from materialize_sharded_merge) to skip the
    merge. Returns the list of (Descriptor, stats) for non-empty shards."""
    from ..storage.sstable.format import Descriptor
    from ..storage.sstable.writer import SSTableWriter

    import os

    if shards is None:
        cat = CellBatch.concat(batches)
        shards = materialize_sharded_merge(cat, mesh, gc_before, now)
    results = []
    try:
        for s, shard in enumerate(shards):
            if len(shard) == 0:
                continue
            desc = Descriptor(directory, generation_base + s)
            w = SSTableWriter(desc, table)
            try:
                w.append(shard)
                stats = w.finish()
            except BaseException:
                w.abort()
                raise
            results.append((desc, stats))
    except BaseException:
        # all-or-nothing round (LifecycleTransaction semantics): a failed
        # shard write must not leave earlier shards' sstables behind as a
        # partial compaction output
        for desc, _stats in results:
            for p in desc.all_paths():
                if os.path.exists(p):
                    os.remove(p)
        raise
    return results
