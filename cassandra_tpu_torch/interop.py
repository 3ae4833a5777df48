"""Carry state across from the JAX package (cassandra_tpu) to the port.

Nothing here imports the JAX package: the functions read plain numpy
columns, so the caller (a test, a migration script) hands over whatever
the other package produced. The on-disk sstable format is shared, so
sstables need no conversion: the port's SSTableReader opens a directory
the JAX package wrote.
"""
from __future__ import annotations

import numpy as np

from .ops.merge import operands_to_device, planes_to_device
from .storage.cellbatch import CellBatch

CELLBATCH_COLUMNS = ("lanes", "ts", "ldt", "ttl", "flags", "off",
                     "val_start", "payload")


def cellbatch_from(batch) -> CellBatch:
    """The port's CellBatch holding copies of another CellBatch's
    columns (lanes, ts, ldt, ttl, flags, off, val_start, payload,
    pk_map, ck_fits_prefix; `sorted` is kept too)."""
    cols = {k: np.array(getattr(batch, k), copy=True)
            for k in CELLBATCH_COLUMNS}
    out = CellBatch(**cols, pk_map=dict(batch.pk_map),
                    sorted=bool(getattr(batch, "sorted", False)))
    out.ck_fits_prefix = bool(batch.ck_fits_prefix)
    return out


def operands_from_numpy(operands: dict, device) -> dict:
    """A numpy operand dict (as `build_operands` makes it, in either
    package; JAX arrays pass through np.asarray first) as the port's
    int32 tensors on `device`."""
    return operands_to_device({k: np.asarray(v) for k, v in operands.items()},
                              device)


def planes_from_numpy(planes_or_buf, device):
    """A non-resident round's device input as the JAX package's packers
    make it (`_plane_pack_v2`'s plane dict, `_plane_pack_fast`'s u8
    buffer; JAX arrays pass through np.asarray first) as the port's
    tensors on `device`, ready for `plane_program` (K7) or
    `plane_program_fast` (K6)."""
    if isinstance(planes_or_buf, dict):
        return planes_to_device({k: np.asarray(v)
                                 for k, v in planes_or_buf.items()}, device)
    return planes_to_device(np.asarray(planes_or_buf), device)
