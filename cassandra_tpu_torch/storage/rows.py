"""Row assembly: merged CellBatches -> typed rows.

Reference counterpart: db/rows/Row.java / BTreeRow (a row as a sorted cell
collection) and cql3 ResultSet building. Operates on RECONCILED batches
(merge_sorted output): remaining cells are the newest versions; tombstone
markers indicate absence.

Multicell collections are reassembled from their path cells:
  list: path = timeuuid-like 16B (ordering = insertion order)
  set:  path = element's serialized bytes, value empty
  map:  path = key's serialized bytes, value = value's serialized bytes
(reference CellPath semantics, db/rows/CellPath.java).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..schema import (COL_PARTITION_DEL, COL_RANGE_TOMB,
                      COL_REGULAR_BASE, COL_ROW_DEL, COL_ROW_LIVENESS,
                      TableMetadata)
from ..types.marshal import ListType, MapType, SetType
from .cellbatch import FLAG_COMPLEX_DEL, FLAG_TOMBSTONE, CellBatch


@dataclass
class RowData:
    pk: bytes                     # serialized partition key
    ck_frame: bytes               # serialized clustering frame
    cells: dict = field(default_factory=dict)   # column_id -> value bytes|None
    multicell: dict = field(default_factory=dict)  # column_id -> {path: bytes}
    cell_meta: dict = field(default_factory=dict)  # column_id -> (ts, ttl, ldt)
    liveness_ts: int | None = None
    liveness_meta: tuple | None = None             # (ts, ttl, ldt)
    max_ts: int = 0
    is_static: bool = False

    def has_live_data(self) -> bool:
        return self.liveness_ts is not None or \
            any(v is not None for v in self.cells.values()) or \
            any(self.multicell.values())


def rows_from_batch(table: TableMetadata, batch: CellBatch):
    """Yield RowData for every row with live content, in storage order.
    Input must be reconciled (deletions already applied by merge)."""
    n = len(batch)
    if n == 0:
        return
    C = batch.n_lanes - 9
    col_lane = batch.lanes[:, 6 + C]
    has_clustering = bool(table.clustering_columns)

    current: RowData | None = None
    for i in range(n):
        col = int(col_lane[i])
        if col in (COL_PARTITION_DEL, COL_ROW_DEL, COL_RANGE_TOMB):
            continue  # markers only matter to merges; reads skip them
        flags = int(batch.flags[i])
        ck, path, value = batch.cell_payload(i)
        pk = batch.partition_key(i)
        if current is None or current.pk != pk or current.ck_frame != ck:
            if current is not None and current.has_live_data():
                yield current
            current = RowData(pk, ck)
            current.is_static = has_clustering and ck == b"" and \
                col >= COL_REGULAR_BASE
        current.max_ts = max(current.max_ts, int(batch.ts[i]))
        if col == COL_ROW_LIVENESS:
            if not (flags & FLAG_TOMBSTONE):
                current.liveness_ts = int(batch.ts[i])
                current.liveness_meta = (int(batch.ts[i]),
                                         int(batch.ttl[i]),
                                         int(batch.ldt[i]))
            continue
        if flags & FLAG_COMPLEX_DEL:
            # collection overwrite marker: column present but reset
            current.multicell.setdefault(col, {})
            continue
        meta = table.columns_by_id.get(col)
        dead = bool(flags & FLAG_TOMBSTONE)
        if meta is not None and getattr(meta.cql_type, "is_counter",
                                        False):
            # counter column = SUM of its live cells: one cumulative
            # shard per leader (distinct paths) in clusters, or the
            # single reconciled delta-sum cell (path=b"") locally
            if not dead:
                prev = current.cells.get(col)
                base = int.from_bytes(prev, "big", signed=True) \
                    if prev else 0
                total = base + int.from_bytes(value, "big", signed=True)
                current.cells[col] = total.to_bytes(8, "big", signed=True)
                old = current.cell_meta.get(col)
                m = (int(batch.ts[i]), int(batch.ttl[i]),
                     int(batch.ldt[i]))
                current.cell_meta[col] = max(old, m) if old else m
            elif col not in current.cells:
                current.cells[col] = None
            continue
        if meta is not None and meta.cql_type.is_multicell:
            if path and not dead:
                current.multicell.setdefault(col, {})[path] = value
        else:
            current.cells[col] = None if dead else value
            current.cell_meta[col] = (int(batch.ts[i]), int(batch.ttl[i]),
                                      int(batch.ldt[i]))
    if current is not None and current.has_live_data():
        yield current


def row_to_dict(table: TableMetadata, row: RowData,
                with_meta: bool = False) -> dict:
    """Decode a RowData into {column_name: python value}. with_meta adds
    '__meta__': {name: (writetime_us, ttl, ldt)} for writetime()/ttl()
    selectors."""
    out: dict = {}
    if with_meta:
        out["__meta__"] = {
            table.columns_by_id[cid].name: m
            for cid, m in row.cell_meta.items()
            if cid in table.columns_by_id}
    for c, v in zip(table.partition_key_columns,
                    table.split_partition_key(row.pk)):
        out[c.name] = v
    if not row.is_static:
        for c, v in zip(table.clustering_columns,
                        table.deserialize_clustering(row.ck_frame)):
            out[c.name] = v
    for col in table.static_columns + table.regular_columns:
        if col.cql_type.is_multicell and col.column_id in row.multicell:
            paths = row.multicell[col.column_id]
            t = col.cql_type
            if isinstance(t, MapType):
                out[col.name] = {t.key.deserialize(p): t.val.deserialize(v)
                                 for p, v in sorted(paths.items())} or None
            elif isinstance(t, SetType):
                out[col.name] = {t.elem.deserialize(p)
                                 for p in sorted(paths)} or None
            elif isinstance(t, ListType):
                out[col.name] = [t.elem.deserialize(v) for _, v in
                                 sorted(paths.items())] or None
            else:
                out[col.name] = None
        elif col.column_id in row.cells:
            v = row.cells[col.column_id]
            out[col.name] = None if v is None \
                else col.cql_type.deserialize(v)
        else:
            out[col.name] = None
    return out
