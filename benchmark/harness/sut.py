"""The system under test: cassandra_tpu_torch, entered as `nodetool
compact` enters it, at `CompactionTask(...).execute()` on the device
engine. The only module of the benchmark that imports the program.

Inputs reach the program as a flush would write them: the benchmark's
row writes become sorted CellBatches (the program's hashing gives the
partition lanes) and the program's SSTableWriter writes them through its
host LZ4 compressor pool.
"""
from __future__ import annotations

import os
import uuid

import numpy as np

NO_DELETION_TIME = 0x7FFFFFFF
FLAG_ROW_LIVENESS = 16
COL_LIVENESS = 2


def make_table(config: dict, mix, seed: int):
    """keyspace1.standard1 (key blob PRIMARY KEY, "C0".. blob) with the
    configuration's compression, and a table id drawn from the seed."""
    from cassandra_tpu_torch.ops.codec import CompressionParams
    from cassandra_tpu_torch.schema import TableParams, make_table as mk
    cols = {"key": "blob", **{c: "blob" for c in mix.column_names()}}
    table = mk("keyspace1", "standard1", pk=["key"], cols=cols,
               params=TableParams(compression=CompressionParams(
                   config["compression"],
                   chunk_length=int(config["chunk_length_in_kb"]) * 1024)))
    table.id = uuid.UUID(int=(seed * 0x9E3779B97F4A7C15) % (1 << 128))
    return table


def build_batch(table, mix, sstable: int):
    """The sorted CellBatch of one flushed sstable of `mix`: per row its
    liveness cell and one cell per column, all at the row's timestamp."""
    from cassandra_tpu_torch.storage.cellbatch import (CellBatch,
                                                       lanes_for_table)
    from cassandra_tpu_torch.utils import murmur3, partitioners

    p, lo, hi = mix.rows(sstable)
    keys = mix.keys()[lo:hi]
    n = hi - lo
    width = ((mix.key_size + 15) // 16 + 1) * 16
    padded = np.zeros((n, width), np.uint8)
    padded[:, :mix.key_size] = keys
    lens = np.full(n, mix.key_size, np.int64)
    _h1, h2 = murmur3.hash128_mat(padded, lens)
    tok = partitioners.current().tokens_mat(padded, lens)
    btok = tok.view(np.uint64) ^ np.uint64(1 << 63)
    order = np.lexsort((h2, btok))
    ids = [table.columns[c].column_id for c in mix.column_names()]
    by_id = np.argsort(ids)
    per = 1 + mix.columns
    K = lanes_for_table(table)
    lanes = np.zeros((n, per, K), np.uint32)
    t, h = btok[order], h2[order]
    lanes[:, :, 0] = (t >> np.uint64(32))[:, None]
    lanes[:, :, 1] = (t & np.uint64(0xFFFFFFFF))[:, None]
    lanes[:, :, 2] = (h >> np.uint64(32))[:, None]
    lanes[:, :, 3] = (h & np.uint64(0xFFFFFFFF))[:, None]
    lanes[:, 0, K - 3] = COL_LIVENESS
    lanes[:, 1:, K - 3] = np.asarray(ids)[by_id][None, :]
    flags = np.zeros((n, per), np.uint8)
    flags[:, 0] = FLAG_ROW_LIVENESS
    flen = np.full((n, per), 2 + mix.column_size, np.int64)
    flen[:, 0] = 2
    frames = np.zeros((n, per, 2 + mix.column_size), np.uint8)
    frames[:, 1:, 2:] = mix.values(p, lo, hi)[order][:, by_id]
    cells = n * per
    keep = np.arange(2 + mix.column_size)[None, :] < flen.reshape(cells, 1)
    off = np.zeros(cells + 1, np.int64)
    np.cumsum(flen.reshape(cells), out=off[1:])
    lane4 = lanes[:, 0, :4].astype(">u4")
    key_rows = keys[order]
    pk_map = {lane4[i].tobytes(): key_rows[i].tobytes() for i in range(n)}
    batch = CellBatch(
        lanes.reshape(cells, K),
        np.repeat(mix.timestamps(p, lo, hi)[order], per),
        np.full(cells, NO_DELETION_TIME, np.int32),
        np.zeros(cells, np.int32), flags.reshape(cells), off,
        off[:-1] + 2, frames.reshape(cells, -1)[keep], pk_map, sorted=True)
    batch.ck_fits_prefix = True
    return batch


def store_dir(root: str, table) -> str:
    """Where a store rooted at `root` keeps the table's sstables."""
    return os.path.join(root, table.keyspace,
                        f"{table.name}-{table.id.hex[:8]}")


def write_inputs(root: str, table, mix, pool) -> list[str]:
    """Write `mix`'s flushed sstables (generations 1..) under `root` with
    the program's writer on its host LZ4 pool; their file paths."""
    from cassandra_tpu_torch.storage.sstable import (Descriptor,
                                                     SSTableWriter)
    directory = store_dir(root, table)
    os.makedirs(directory, exist_ok=True)
    for s in range(mix.sstables):
        batch = build_batch(table, mix, s)
        w = SSTableWriter(Descriptor(directory, s + 1), table,
                          estimated_partitions=len(batch.pk_map),
                          threaded_io=True, compress_pool=pool)
        w.append(batch)
        w.finish()
    return sorted(os.path.join(directory, f)
                  for f in os.listdir(directory))


def link_inputs(files: list[str], root: str, table) -> int:
    """A fresh store under `root` holding hard links to the input files
    (no bytes written); returns the inputs' Data.db bytes."""
    directory = store_dir(root, table)
    os.makedirs(directory)
    data = 0
    for f in files:
        os.link(f, os.path.join(directory, os.path.basename(f)))
        if f.endswith("-Data.db"):
            data += os.path.getsize(f)
    return data


# the compaction strategies this harness runs: under each, `nodetool
# compact` is one major compaction of every live sstable
STRATEGIES = ("SizeTieredCompactionStrategy",)


def compact(root: str, table, device, config: dict, pool,
            device_compress: bool | None = None):
    """One major compaction of the store under `root`, as `nodetool
    compact` runs it under the configuration's strategy and throttle
    (`compaction_throughput` MiB/s, 0 for none), with its
    `compaction_device_compress` unless `device_compress` overrides it:
    (stats, the task's phase profile)."""
    import torch

    from cassandra_tpu_torch.compaction.task import CompactionTask
    from cassandra_tpu_torch.storage.table import ColumnFamilyStore
    from cassandra_tpu_torch.utils.ratelimit import RateLimiter

    if config["compaction"] not in STRATEGIES:
        raise ValueError(f"the harness runs no {config['compaction']}")
    if device_compress is None:
        device_compress = bool(config["compaction_device_compress"])
    rate = float(config["compaction_throughput"])
    cfs = ColumnFamilyStore(table, root, commitlog=None)
    cfs.reload_sstables()
    task = CompactionTask(cfs, cfs.live_sstables(), engine="device",
                          device=device, device_compress=device_compress,
                          compress_pool=pool,
                          limiter=RateLimiter(rate) if rate > 0 else None)
    try:
        stats = task.execute()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        for r in cfs.live_sstables():
            r.close()
    return stats, dict(task.profile)


def make_pool(workers: int):
    from cassandra_tpu_torch.storage.sstable.compress_pool import (
        CompressorPool)
    return CompressorPool(workers)


def counters() -> dict:
    """The program's counters the per-layer metrics read: bytes over the
    host-card link, and launches by kernel and size."""
    from cassandra_tpu_torch.ops import cuda_lib
    return {"transfers": cuda_lib.transfers(),
            "launch_sizes": cuda_lib.launch_sizes()}


def load_kernels(device) -> None:
    """Load the CUDA kernel library, building it with nvcc into the
    program's build directory inside the checkout when it is missing,
    and the host codec library the same way."""
    from cassandra_tpu_torch.ops import cuda_lib
    from cassandra_tpu_torch.ops.native import build as native_build
    native_build.load()
    if device.type == "cuda":
        cuda_lib.lib()
