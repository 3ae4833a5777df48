"""CI check: parallel-compression byte-identity A/B.

The parallel compress leg (storage/sstable/compress_pool.py + the
writer's ordered completion queue) promises BYTE-identical sstables for
any compressor pool size — including the serial path. That promise has
two load-bearing parts:

  - the ordered completion queue re-sequences out-of-order worker
    results before any sequential writer state (file offsets, index
    entries, digest folds) sees them;
  - the adaptive-compression-skip machine decides attempt flags from a
    FIXED-lag outcome stream (SSTableWriter.SKIP_DECISION_LAG), so the
    decision sequence cannot depend on completion timing or pool size.

This check exercises both with a workload built to CROSS skip-machine
transitions (alternating compressible text and incompressible random
partitions — the payload stream enters and leaves skip mode):

  1. the same input sstables major-compacted with the serial compress
     thread, a 1-worker pool and a 4-worker pool (+ decode-ahead),
     under the mesh execution mode (2 lanes, and 4 lanes combined with
     a 2-worker pool — docs/multichip.md: token-range shards drained in
     token order), under the DEVICE engine (device-resident rounds,
     ops/device_write.py — the sort K1, reconcile K2, kept-first
     compaction K3 and META serializer K4 on the resolved torch device,
     incl. its per-round host fallbacks, plus the device+mesh-2 cross),
     and with DEVICE-SIDE BLOCK COMPRESSION (ops/device_compress.py —
     the policy-scan kernel K5 compresses META + lanes on the device;
     alone, feeding a 2-worker pool's ordered completion queue, and
     crossed with mesh-2) must produce sha256-identical components AND
     equal merged-view content_digests;
  2. the same mutation set flushed with CTPU_WRITE_FASTPATH=0 (serial
     sort-and-write) and =1 over 1- and 4-worker shared pools must
     produce identical sstable bytes and read-back digests.

The device legs run on `device` (`cuda` by default, which raises
without a card; `cpu` runs the kernels' plain PyTorch versions). A
caller that passes a dict as `launches` gets each leg's launches of the
hand-written kernels in it, by kernel (none on the CPU).

    python -m cassandra_tpu_torch.scripts.check_compaction_ab [--device cpu]

Exit 0 on zero divergence, 1 with a line per divergence.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile


FIXED_NOW = 1_700_000_000
HASHED_COMPONENTS = ("Data.db", "Index.db", "Partitions.db",
                     "Filter.db", "Statistics.db", "Digest.crc32")


def _mk_table(name: str):
    from cassandra_tpu_torch.ops.codec import CompressionParams
    from cassandra_tpu_torch.schema import TableParams, make_table

    return make_table(
        "abks", name, pk=["id"], ck=["c"],
        cols={"id": "int", "c": "int", "v": "blob"},
        params=TableParams(compression=CompressionParams(
            "LZ4Compressor", chunk_length=16 * 1024)))


def _mixed_batch(table, seed: int, n: int):
    """Sorted batch whose payload compressibility ALTERNATES by
    partition: even partitions carry lowercase text (compresses well),
    odd ones uniform random bytes (stores raw) — segments flip between
    the two, driving the skip machine through engage/probe/disengage."""
    import numpy as np

    from cassandra_tpu_torch.storage import cellbatch as cb
    from cassandra_tpu_torch.tools import bulk

    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 256, n)
    ck = rng.integers(0, 100_000, n)
    text = rng.integers(97, 122, (n, 48), dtype=np.uint8)
    blob = rng.integers(0, 256, (n, 48), dtype=np.uint8)
    vals = np.where((pk % 2 == 0)[:, None], text, blob)
    ts = rng.integers(1, 1 << 40, n).astype(np.int64)
    return cb.merge_sorted([bulk.build_int_batch(table, pk, ck, vals, ts)])


def _component_hashes(directory: str) -> dict:
    out = {}
    for fn in sorted(os.listdir(directory)):
        p = os.path.join(directory, fn)
        if not os.path.isfile(p):
            continue
        if not any(fn.endswith(c) for c in HASHED_COMPONENTS):
            continue
        with open(p, "rb") as f:
            out[fn] = hashlib.sha256(f.read()).hexdigest()
    return out


def _scan_digest(cfs) -> bytes:
    from cassandra_tpu_torch.storage.cellbatch import content_digest

    return content_digest(cfs.scan_all(now=FIXED_NOW))


# ------------------------------------------------------------ compaction --

def _compaction_leg(base: str, pristine: str, table, tag: str,
                    **task_kw) -> tuple[dict, bytes]:
    from cassandra_tpu_torch.compaction.task import CompactionTask
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore

    leg = os.path.join(base, tag)
    shutil.copytree(pristine, leg)
    cfs = ColumnFamilyStore(table, leg, commitlog=None)
    cfs.reload_sstables()
    task = CompactionTask(cfs, cfs.tracker.view(), **task_kw)
    task.execute()
    hashes = _component_hashes(cfs.directory)
    digest = _scan_digest(cfs)
    for r in cfs.live_sstables():
        r.close()
    return hashes, digest


def compaction_legs(device) -> dict:
    """The gate's legs, tag -> CompactionTask keyword arguments; the
    device legs run on `device`. Pools are made here, so each call
    returns fresh ones (`shutdown_pools` stops them)."""
    from cassandra_tpu_torch.storage.sstable.compress_pool import \
        CompressorPool

    return {
        "serial": dict(pipelined_io=False, compress_pool=0,
                       decode_ahead=False),
        "threaded": dict(pipelined_io=True, compress_pool=0,
                         decode_ahead=False),
        "pool1": dict(pipelined_io=True, compress_pool=CompressorPool(1),
                      decode_ahead=True),
        "pool4": dict(pipelined_io=True, compress_pool=CompressorPool(4),
                      decode_ahead=True),
        # mesh execution mode (docs/multichip.md): token-range-sharded
        # decode->merge fanned across mesh lanes, drained in token
        # order — bytes must match serial for any lane count, including
        # combined with the parallel compress pool
        "mesh2": dict(pipelined_io=True, compress_pool=0,
                      decode_ahead=False, mesh_devices=2),
        "mesh4_pool2": dict(pipelined_io=True,
                            compress_pool=CompressorPool(2),
                            decode_ahead=False, mesh_devices=4),
        # device engine, device-resident rounds (ops/device_write.py):
        # sort, reconcile, purge, kept-first compaction and the META
        # serialize (K1-K4) run on the device; the mixed fixture's
        # equal-ts duplicates also push rounds through the per-round
        # host fallback — both sides of the residency decision must
        # land the same bytes
        "device": dict(pipelined_io=True, compress_pool=0,
                       decode_ahead=False, engine="device",
                       use_device=True, device_compress=False,
                       device=device),
        # device engine crossed with the mesh execution mode: each
        # shard's round runs the plane programs, and the shards drain
        # host-side in token order
        "device_mesh2": dict(pipelined_io=True, compress_pool=0,
                             decode_ahead=False, engine="device",
                             use_device=True, mesh_devices=2,
                             device=device),
        # device-side block compression (ops/device_compress.py, K5):
        # full segments arrive at the writer ALREADY LZ4-compressed by
        # the policy-scan kernel; the mixed fixture crosses skip-
        # machine transitions, so attempted/raw decisions and the
        # compress-vs-raw boundary must land identically to the native
        # packer on every stream
        "device_compress": dict(pipelined_io=True, compress_pool=0,
                                decode_ahead=False, engine="device",
                                use_device=True, device_compress=True,
                                device=device),
        # device compression feeding the ordered completion queue of a
        # live compressor pool: device-born jobs (ready pre-set) and
        # pool jobs (partial final segment) interleave in submit order
        "device_compress_pool2": dict(pipelined_io=True,
                                      compress_pool=CompressorPool(2),
                                      decode_ahead=False,
                                      engine="device", use_device=True,
                                      device_compress=True,
                                      device=device),
        # the mesh cross: shards drain through the host writer (the
        # device-resident lane is a serial-round mode), so this pins
        # that device_compress=True stays inert — and byte-identical —
        # under the mesh execution mode
        "device_compress_mesh2": dict(pipelined_io=True, compress_pool=0,
                                      decode_ahead=False,
                                      engine="device", use_device=True,
                                      mesh_devices=2,
                                      device_compress=True,
                                      device=device),
    }


def shutdown_pools(legs: dict) -> None:
    for kw in legs.values():
        pool = kw["compress_pool"]
        if pool:
            pool.shutdown(timeout=5.0)


def _write_pristine(pristine: str, table, n: int) -> None:
    """The three input sstables of `n` cells each (seeds 1-3)."""
    from cassandra_tpu_torch.storage.sstable import (Descriptor,
                                                     SSTableWriter)
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore

    cfs = ColumnFamilyStore(table, pristine, commitlog=None)
    for gen in range(1, 4):
        w = SSTableWriter(Descriptor(cfs.directory, gen), table,
                          estimated_partitions=256)
        w.append(_mixed_batch(table, seed=gen, n=n))
        w.finish()


def compare_legs(results: dict, what: str) -> list[str]:
    """Divergences of every leg from the `serial` leg: component
    sha256s and the merged-view content digest."""
    diverged = []
    ref_hashes, ref_digest = results["serial"]
    if not ref_hashes:
        diverged.append(f"{what} produced no components to compare")
    for tag, (hashes, digest) in results.items():
        if tag == "serial":
            continue
        if hashes != ref_hashes:
            bad = sorted(set(hashes) ^ set(ref_hashes)) or sorted(
                k for k in hashes if hashes[k] != ref_hashes.get(k))
            diverged.append(
                f"{what} {tag} vs serial: component bytes differ: {bad}")
        if digest != ref_digest:
            diverged.append(
                f"{what} {tag} vs serial: merged-view content_digest "
                "differs")
    return diverged


def check_compaction(base: str, device=None,
                     launches: dict | None = None) -> list[str]:
    from cassandra_tpu_torch import device as devmod
    from cassandra_tpu_torch.ops import cuda_lib

    dev = devmod.resolve(device)
    table = _mk_table("compact")
    pristine = os.path.join(base, "pristine")
    _write_pristine(pristine, table, 200_000)

    legs = compaction_legs(dev)
    results = {}
    try:
        for tag, kw in legs.items():
            before = cuda_lib.launches()
            results[tag] = _compaction_leg(base, pristine, table, tag,
                                           **kw)
            if launches is not None:
                after = cuda_lib.launches()
                launches[tag] = {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}
    finally:
        shutdown_pools(legs)
    return compare_legs(results, "compaction")


# ----------------------------------------------------------------- flush --

def _flush_mutations(table):
    """Deterministic mutation set, compressibility alternating by
    partition like the compaction fixture; fixed timestamps so every
    leg writes identical cells."""
    from cassandra_tpu_torch.schema import COL_ROW_LIVENESS
    from cassandra_tpu_torch.storage.cellbatch import FLAG_ROW_LIVENESS
    from cassandra_tpu_torch.storage.mutation import Mutation

    vcol = table.columns["v"].column_id
    muts = []
    text = b"abcdefghijklmnopqrstuvwx" * 2
    for k in range(160):
        pkb = table.serialize_partition_key([k])
        for c in range(450):
            m = Mutation(table.id, pkb)
            ck = table.serialize_clustering([c])
            ts = 1_000_000 + k * 1000 + c
            if k % 2 == 0:
                val = text
            else:   # deterministic pseudo-random bytes
                val = hashlib.sha256(b"%d-%d" % (k, c)).digest() + \
                    hashlib.sha256(b"x%d-%d" % (k, c)).digest()[:16]
            m.add(ck, COL_ROW_LIVENESS, b"", b"", ts,
                  flags=FLAG_ROW_LIVENESS)
            m.add(ck, vcol, b"", val, ts)
            muts.append(m)
    return muts


def _flush_leg(base: str, table, tag: str, fast: bool,
               pool_workers: int) -> tuple[dict, bytes]:
    from cassandra_tpu_torch.storage.sstable import compress_pool
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore

    os.environ["CTPU_WRITE_FASTPATH"] = "1" if fast else "0"
    compress_pool.configure(pool_workers)
    try:
        cfs = ColumnFamilyStore(table, os.path.join(base, tag),
                                commitlog=None)
        muts = _flush_mutations(table)
        for i in range(0, len(muts), 512):
            cfs.apply_batch(muts[i:i + 512])
        cfs.flush()
        hashes = _component_hashes(cfs.directory)
        digest = _scan_digest(cfs)
        for r in cfs.live_sstables():
            r.close()
        return hashes, digest
    finally:
        os.environ.pop("CTPU_WRITE_FASTPATH", None)
        compress_pool.configure(0)   # back to auto


def check_flush(base: str) -> list[str]:
    table = _mk_table("flush")
    legs = {
        "serial": (False, 1),
        "fast_pool1": (True, 1),
        "fast_pool4": (True, 4),
    }
    results = {tag: _flush_leg(base, table, tag, fast, w)
               for tag, (fast, w) in legs.items()}
    return compare_legs(results, "flush")


# ------------------------------------------------------------------ main --

def run_check(base_dir: str | None = None, device=None,
              launches: dict | None = None) -> list[str]:
    own = base_dir is None
    base = base_dir or tempfile.mkdtemp(prefix="ctpu-compab-")
    try:
        diverged = check_compaction(os.path.join(base, "compaction"),
                                    device=device, launches=launches)
        diverged += check_flush(os.path.join(base, "flush"))
        return diverged
    finally:
        if own:
            shutil.rmtree(base, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.check_compaction_ab")
    p.add_argument("--device", default="cuda",
                   help="torch device of the device legs (default cuda)")
    args = p.parse_args(argv)
    launches: dict = {}
    diverged = run_check(device=args.device, launches=launches)
    if diverged:
        print("parallel-compression A/B DIVERGED:", file=sys.stderr)
        for d in diverged:
            print(f"  {d}", file=sys.stderr)
        return 1
    print("compaction/flush parallel-compression A/B: zero divergence "
          "(serial vs threaded vs pool-1 vs pool-4 vs mesh-2 vs "
          "mesh-4+pool-2 vs device-resident vs device+mesh-2 vs "
          "device-compress vs device-compress+pool-2 vs "
          "device-compress+mesh-2)")
    for tag, n in launches.items():
        if n:
            print(f"  {tag}: launches {json.dumps(n, sort_keys=True)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
