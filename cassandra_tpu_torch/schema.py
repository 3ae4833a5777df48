"""Schema metadata: keyspaces, tables, columns.

Reference: schema/TableMetadata.java, KeyspaceMetadata.java, TableParams
(compaction/compression per-table options — the TPU backend's opt-in seam,
SURVEY.md section 5.6), schema/Schema.java:66 (global registry).
"""
from __future__ import annotations

import threading
import uuid as uuid_mod
from dataclasses import dataclass, field

from .ops.codec import CompressionParams
from .types import CQLType, parse_type

# column-lane sentinels (storage/cellbatch.py sort order within a clustering)
COL_PARTITION_DEL = 0   # partition-level deletion record
COL_ROW_DEL = 1         # row-level deletion record
COL_ROW_LIVENESS = 2    # primary-key liveness (row exists even if all null)
COL_RANGE_TOMB = 3      # range tombstone slice (storage/rangetomb.py)
COL_REGULAR_BASE = 8    # first real column id


class ColumnKind:
    PARTITION_KEY = "partition_key"
    CLUSTERING = "clustering"
    REGULAR = "regular"
    STATIC = "static"


@dataclass
class ColumnMetadata:
    name: str
    cql_type: CQLType
    kind: str
    position: int          # within its kind
    column_id: int = -1    # dense id >= COL_REGULAR_BASE for regular/static
    reversed: bool = False  # DESC clustering order


@dataclass
class TableParams:
    """Per-table options (reference schema/TableParams.java)."""
    compression: CompressionParams = field(default_factory=CompressionParams)
    compaction: dict = field(default_factory=lambda: {
        "class": "SizeTieredCompactionStrategy"})
    gc_grace_seconds: int = 864000  # 10 days, reference default
    default_ttl: int = 0
    memtable_flush_period_ms: int = 0
    comment: str = ""
    cdc: bool = False       # change data capture stream (storage/cdc.py)
    # row cache (cache/RowCache role): 'NONE' | 'ALL' rows per partition
    caching: dict = field(default_factory=lambda: {
        "keys": "ALL", "rows_per_partition": "NONE"})
    # TPU-format knob: bytes of clustering prefix carried in key lanes
    clustering_prefix_bytes: int = 16
    # at-rest encryption (TDE): sstable components encrypted under the
    # node's EncryptionContext keystore (storage/encryption.py)
    encryption: bool = False


class TableMetadata:
    def __init__(self, keyspace: str, name: str,
                 partition_key: list[tuple[str, CQLType]],
                 clustering: list[tuple[str, CQLType, bool]],
                 regular: list[tuple[str, CQLType]],
                 static: list[tuple[str, CQLType]] | None = None,
                 params: TableParams | None = None,
                 table_id: uuid_mod.UUID | None = None):
        self.keyspace = keyspace
        self.name = name
        self.id = table_id or uuid_mod.uuid4()
        self.params = params or TableParams()
        self.partition_key_columns: list[ColumnMetadata] = []
        self.clustering_columns: list[ColumnMetadata] = []
        self.regular_columns: list[ColumnMetadata] = []
        self.static_columns: list[ColumnMetadata] = []
        self.columns: dict[str, ColumnMetadata] = {}

        for i, (n, t) in enumerate(partition_key):
            self._add(ColumnMetadata(n, t, ColumnKind.PARTITION_KEY, i),
                      self.partition_key_columns)
        for i, (n, t, rev) in enumerate(clustering):
            self._add(ColumnMetadata(n, t, ColumnKind.CLUSTERING, i, reversed=rev),
                      self.clustering_columns)
        next_id = COL_REGULAR_BASE
        for i, (n, t) in enumerate(sorted(static or [])):
            c = ColumnMetadata(n, t, ColumnKind.STATIC, i, column_id=next_id)
            next_id += 1
            self._add(c, self.static_columns)
        for i, (n, t) in enumerate(sorted(regular)):
            c = ColumnMetadata(n, t, ColumnKind.REGULAR, i, column_id=next_id)
            next_id += 1
            self._add(c, self.regular_columns)
        self.columns_by_id = {c.column_id: c
                              for c in self.static_columns + self.regular_columns}

    def _add(self, col: ColumnMetadata, bucket: list[ColumnMetadata]):
        if col.name in self.columns:
            raise ValueError(f"duplicate column {col.name}")
        self.columns[col.name] = col
        bucket.append(col)

    # ------------------------------------------------------------ helpers --

    @property
    def clustering_lanes(self) -> int:
        return self.params.clustering_prefix_bytes // 4

    @property
    def is_counter_table(self) -> bool:
        return any(c.cql_type.is_counter for c in self.regular_columns)

    def primary_key_names(self) -> list[str]:
        return ([c.name for c in self.partition_key_columns]
                + [c.name for c in self.clustering_columns])

    def serialize_partition_key(self, values: list) -> bytes:
        """Single pk column: raw serialized bytes; composite: length-framed
        concatenation (reference CompositeType semantics)."""
        cols = self.partition_key_columns
        if len(cols) == 1:
            return cols[0].cql_type.serialize(values[0])
        out = bytearray()
        for c, v in zip(cols, values):
            b = c.cql_type.serialize(v)
            out += len(b).to_bytes(2, "big") + b + b"\x00"
        return bytes(out)

    def split_partition_key(self, key: bytes) -> list:
        cols = self.partition_key_columns
        if len(cols) == 1:
            return [cols[0].cql_type.deserialize(key)]
        out = []
        pos = 0
        for c in cols:
            ln = int.from_bytes(key[pos:pos + 2], "big")
            out.append(c.cql_type.deserialize(key[pos + 2:pos + 2 + ln]))
            pos += 2 + ln + 1
        return out

    def serialize_clustering(self, values: list) -> bytes:
        """Clustering tuple as a vint-length-framed concatenation of the
        serialized values — the form stored in cell payloads (invertible,
        unlike the byte-comparable form)."""
        from .utils import varint as vi
        out = bytearray()
        for c, v in zip(self.clustering_columns, values):
            b = c.cql_type.serialize(v)
            vi.write_unsigned_vint(len(b), out)
            out += b
        return bytes(out)

    def split_clustering(self, frame: bytes) -> list[bytes]:
        """Serialized clustering values from a payload frame (may be a
        prefix of the full clustering)."""
        from .utils import varint as vi
        vals = []
        pos = 0
        for _ in self.clustering_columns:
            if pos >= len(frame):
                break
            n, pos = vi.read_unsigned_vint(frame, pos)
            vals.append(bytes(frame[pos:pos + n]))
            pos += n
        return vals

    def deserialize_clustering(self, frame: bytes) -> list:
        return [c.cql_type.deserialize(b) for c, b in
                zip(self.clustering_columns, self.split_clustering(frame))]

    def clustering_comp(self, frame: bytes) -> bytes:
        """Byte-comparable composite for a serialized clustering frame."""
        from .utils import bytecomp
        comps = []
        desc = []
        for c, b in zip(self.clustering_columns, self.split_clustering(frame)):
            comps.append(c.cql_type.to_bytecomp(b))
            desc.append(c.reversed)
        return bytecomp.encode_composite(comps, desc)

    def clustering_bytecomp(self, values: list) -> bytes:
        """Byte-comparable composite of clustering values (full precision)."""
        from .utils import bytecomp
        comps = []
        desc = []
        for c, v in zip(self.clustering_columns, values):
            comps.append(c.cql_type.to_bytecomp(c.cql_type.serialize(v)))
            desc.append(c.reversed)
        return bytecomp.encode_composite(comps, desc)

    def full_name(self) -> str:
        return f"{self.keyspace}.{self.name}"

    def __repr__(self):
        return f"TableMetadata({self.full_name()})"


@dataclass
class KeyspaceParams:
    replication: dict = field(default_factory=lambda: {
        "class": "SimpleStrategy", "replication_factor": 1})
    durable_writes: bool = True


class KeyspaceMetadata:
    def __init__(self, name: str, params: KeyspaceParams | None = None):
        self.name = name
        self.params = params or KeyspaceParams()
        self.tables: dict[str, TableMetadata] = {}
        self.user_types: dict[str, CQLType] = {}

    def add_table(self, t: TableMetadata):
        if t.name in self.tables:
            raise ValueError(f"table {t.name} already exists")
        self.tables[t.name] = t


class Schema:
    """Process-global schema registry (reference schema/Schema.java:66).
    Distributed schema agreement arrives with the cluster-metadata layer."""

    def __init__(self):
        self.keyspaces: dict[str, KeyspaceMetadata] = {}
        self._by_id: dict = {}
        self._lock = threading.RLock()
        self.version = 0
        self.listeners: list = []  # persistence hooks (one per engine)
        # (keyspace, view_name) -> {"base": (ks, table)}; the view's own
        # TableMetadata lives in ks.tables like any table
        # (schema/ViewMetadata role)
        self.views: dict[tuple, dict] = {}

    def table_by_id(self, table_id) -> "TableMetadata | None":
        return self._by_id.get(table_id)

    def _changed(self):
        self.version += 1
        for fn in self.listeners:
            try:
                fn(self)
            except Exception as e:
                # a failed persistence write must not be silent: DDL
                # durability is at stake
                import sys
                print(f"schema listener failed: {e!r}", file=sys.stderr)

    def create_keyspace(self, name: str, params: KeyspaceParams | None = None,
                        if_not_exists: bool = False) -> KeyspaceMetadata:
        with self._lock:
            if name in self.keyspaces:
                if if_not_exists:
                    return self.keyspaces[name]
                raise ValueError(f"keyspace {name} already exists")
            ks = KeyspaceMetadata(name, params)
            self.keyspaces[name] = ks
            self._changed()
            return ks

    def drop_keyspace(self, name: str):
        with self._lock:
            ks = self.keyspaces.pop(name)
            for t in ks.tables.values():
                self._by_id.pop(t.id, None)
            self._changed()

    def add_table(self, t: TableMetadata):
        with self._lock:
            self.keyspaces[t.keyspace].add_table(t)
            self._by_id[t.id] = t
            self._changed()

    def drop_table(self, keyspace: str, name: str):
        with self._lock:
            t = self.keyspaces[keyspace].tables.pop(name)
            self._by_id.pop(t.id, None)
            self._changed()

    def get_table(self, keyspace: str, name: str) -> TableMetadata:
        ks = self.keyspaces.get(keyspace)
        if ks is None or name not in ks.tables:
            raise KeyError(f"unknown table {keyspace}.{name}")
        return ks.tables[name]


# ------------------------------------------------------------- persistence --

def table_to_dict(t: TableMetadata) -> dict:
    return {
        "keyspace": t.keyspace, "name": t.name, "id": str(t.id),
        "partition_key": [(c.name, repr(c.cql_type))
                          for c in t.partition_key_columns],
        "clustering": [(c.name, repr(c.cql_type), c.reversed)
                       for c in t.clustering_columns],
        "regular": [(c.name, repr(c.cql_type)) for c in t.regular_columns],
        "static": [(c.name, repr(c.cql_type)) for c in t.static_columns],
        # explicit ids: ALTERed tables must not re-derive ids from sorted
        # name order on reload (cells on disk reference these ids)
        "column_ids": {c.name: c.column_id
                       for c in t.static_columns + t.regular_columns},
        "params": {
            "compression": t.params.compression.to_dict(),
            "compaction": t.params.compaction,
            "gc_grace_seconds": t.params.gc_grace_seconds,
            "default_ttl": t.params.default_ttl,
            "comment": t.params.comment,
            "clustering_prefix_bytes": t.params.clustering_prefix_bytes,
            "cdc": t.params.cdc,
            "caching": t.params.caching,
            "encryption": t.params.encryption,
        },
    }


def table_from_dict(d: dict, udts: dict | None = None) -> TableMetadata:
    p = d["params"]
    params = TableParams(
        compression=CompressionParams.from_dict(p["compression"]),
        compaction=dict(p["compaction"]),
        gc_grace_seconds=int(p["gc_grace_seconds"]),
        default_ttl=int(p["default_ttl"]),
        comment=p.get("comment", ""),
        clustering_prefix_bytes=int(p.get("clustering_prefix_bytes", 16)),
        cdc=bool(p.get("cdc", False)),
        encryption=bool(p.get("encryption", False)),
        caching=dict(p.get("caching") or
                     {"keys": "ALL", "rows_per_partition": "NONE"}))
    t = TableMetadata(
        d["keyspace"], d["name"],
        [(n, parse_type(ts, udts)) for n, ts in d["partition_key"]],
        [(n, parse_type(ts, udts), bool(rev))
         for n, ts, rev in d["clustering"]],
        [(n, parse_type(ts, udts)) for n, ts in d["regular"]],
        [(n, parse_type(ts, udts)) for n, ts in d["static"]],
        params, uuid_mod.UUID(d["id"]))
    ids = d.get("column_ids")
    if ids:
        for c in t.static_columns + t.regular_columns:
            if c.name in ids:
                c.column_id = int(ids[c.name])
        t.columns_by_id = {c.column_id: c
                           for c in t.static_columns + t.regular_columns}
    return t


def schema_to_dict(schema: Schema) -> dict:
    out = {"keyspaces": {}}
    for name, ks in schema.keyspaces.items():
        out["keyspaces"][name] = {
            "replication": ks.params.replication,
            "durable_writes": ks.params.durable_writes,
            "user_types": {tn: [(f, repr(ft)) for f, ft in
                                zip(t.field_names, t.elems)]
                           for tn, t in ks.user_types.items()},
            "tables": {tn: table_to_dict(t) for tn, t in ks.tables.items()},
        }
    out["views"] = [{"keyspace": ks, "name": nm, "base": list(v["base"])}
                    for (ks, nm), v in schema.views.items()]
    udfs = getattr(schema, "udfs", None)
    if udfs is not None:
        out["udfs"] = udfs.to_list()
    return out


def load_schema_dict(schema: Schema, data: dict) -> None:
    """Merge a persisted schema dump into `schema` (existing entries win —
    a process-supplied schema takes priority over the disk copy)."""
    from .types.marshal import UserType
    for name, ksd in data.get("keyspaces", {}).items():
        if name not in schema.keyspaces:
            schema.create_keyspace(name, KeyspaceParams(
                replication=ksd["replication"],
                durable_writes=ksd.get("durable_writes", True)))
        ks = schema.keyspaces[name]
        for tn, fields in ksd.get("user_types", {}).items():
            if tn not in ks.user_types:
                ks.user_types[tn] = UserType(
                    name, tn, [f for f, _ in fields],
                    [parse_type(ft, ks.user_types) for _, ft in fields])
        for tn, td in ksd.get("tables", {}).items():
            if tn not in ks.tables:
                schema.add_table(table_from_dict(td, ks.user_types))
    for v in data.get("views", []):
        schema.views.setdefault((v["keyspace"], v["name"]),
                                {"base": tuple(v["base"])})
    if data.get("udfs"):
        from .cql.functions import FunctionRegistry
        if not hasattr(schema, "udfs"):
            schema.udfs = FunctionRegistry()
        schema.udfs.load_list(data["udfs"])


def make_table(keyspace: str, name: str, *, pk: list[str], ck: list[str] = (),
               cols: dict[str, str], desc: set[str] = frozenset(),
               statics: set[str] = frozenset(),
               params: TableParams | None = None) -> TableMetadata:
    """Convenience constructor from type strings, e.g.
    make_table('ks', 't', pk=['id'], ck=['ts'], cols={'id': 'uuid',
    'ts': 'timestamp', 'v': 'text'})."""
    pkc = [(n, parse_type(cols[n])) for n in pk]
    ckc = [(n, parse_type(cols[n]), n in desc) for n in ck]
    other = [(n, parse_type(t)) for n, t in cols.items()
             if n not in pk and n not in ck and n not in statics]
    stat = [(n, parse_type(cols[n])) for n in statics]
    return TableMetadata(keyspace, name, pkc, ckc, other, stat, params)
