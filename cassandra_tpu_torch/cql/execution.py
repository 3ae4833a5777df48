"""CQL statement execution against a storage backend.

Reference counterpart: cql3/statements/*Statement.execute —
SelectStatement.java:287, ModificationStatement.java:496 (getMutations:526),
and the schema statements under cql3/statements/schema/. The backend here
is the node-local StorageEngine; the coordination layer substitutes a
distributed proxy with the same apply/read surface.
"""
from __future__ import annotations

import time
import uuid as uuid_mod

from .. import schema as schema_mod
from ..schema import (COL_ROW_LIVENESS, KeyspaceParams, TableParams,
                      make_table)
from ..ops.codec import CompressionParams
from ..storage import cellbatch as cb
from ..storage.mutation import Mutation
from ..storage.rows import RowData, row_to_dict, rows_from_batch
from ..types import parse_type
from ..types.marshal import ListType, MapType, SetType
from ..utils import timeutil
from . import ast


class InvalidRequest(ValueError):
    pass


def _check_ttl(ttl: int) -> None:
    """TTL bounds check (cql3/Attributes.java MAX_TTL = 20 years): the
    expiry cap (utils/timeutil.expiration_time) handles the int32
    horizon, this rejects requests the reference would refuse."""
    from ..utils.timeutil import MAX_TTL
    if ttl < 0:
        raise InvalidRequest(f"A TTL must be greater than or equal to 0, "
                             f"but was {ttl}")
    if ttl > MAX_TTL:
        raise InvalidRequest(f"ttl is too large. requested ({ttl}) "
                             f"maximum ({MAX_TTL})")


class ResultSet:
    paging_state: bytes | None = None   # set when a page cut a scan short

    def __init__(self, columns: list[str], rows: list[tuple]):
        self.column_names = columns
        self.rows = rows

    def __iter__(self):
        return iter(self.rows)

    def __len__(self):
        return len(self.rows)

    def dicts(self) -> list[dict]:
        return [dict(zip(self.column_names, r)) for r in self.rows]

    def one(self):
        return self.rows[0] if self.rows else None


APPLIED = ResultSet(["[applied]"], [(True,)])


def _like_match(value: str, pattern: str) -> bool:
    """CQL LIKE: '%' is the only wildcard (multi-char), case-sensitive
    (cql3 Operator.LIKE_* semantics). '_' is NOT a wildcard in CQL."""
    parts = pattern.split("%")
    if len(parts) == 1:
        return value == pattern
    if len(value) < len(parts[0]) + len(parts[-1]):
        return False      # anchored prefix/suffix must not overlap
    if parts[0] and not value.startswith(parts[0]):
        return False
    if parts[-1] and not value.endswith(parts[-1]):
        return False
    pos = len(parts[0])
    end = len(value) - len(parts[-1])
    for mid in parts[1:-1]:
        if not mid:
            continue
        i = value.find(mid, pos, end)
        if i < 0:
            return False
        pos = i + len(mid)
    return True


def _from_json(v, cql_type):
    """JSON value -> the Python value the column type serializes
    (cql3 Json.java fromJson subset): hex strings for blobs, string
    uuids, set/tuple shapes, recursive collections."""
    import uuid as _uuid

    from ..types.marshal import (BlobType, ListType, MapType, SetType,
                                 TimeUUIDType, TupleType, UUIDType,
                                 VectorType)
    if v is None:
        return None
    t = cql_type
    if isinstance(t, BlobType) and isinstance(v, str):
        return bytes.fromhex(v[2:] if v.startswith("0x") else v)
    if isinstance(t, (UUIDType, TimeUUIDType)) and isinstance(v, str):
        return _uuid.UUID(v)
    if isinstance(t, SetType) and isinstance(v, list):
        return {_from_json(x, t.elem) for x in v}
    if isinstance(t, TupleType) and isinstance(v, list):
        return tuple(_from_json(x, e) for x, e in zip(v, t.elems))
    if isinstance(t, (ListType, VectorType)) and isinstance(v, list):
        elem = getattr(t, "elem", None)
        return [_from_json(x, elem) for x in v] if elem is not None else v
    if isinstance(t, MapType) and isinstance(v, dict):
        # JSON object keys are always strings: convert by the map's
        # KEY TYPE (a boolean map key "false" must not serialize as a
        # truthy non-empty string). "" stays "" — JSON keys are never
        # null, unlike CSV cells where empty means null.
        from ..types.textval import parse_text_value
        return {(parse_text_value(k, t.key) if k != "" else k):
                _from_json(x, t.val) for k, x in v.items()}
    return v


def _jsonify_resultset(rs: ResultSet) -> ResultSet:
    """SELECT JSON: one '[json]' column whose values are JSON documents
    of the selected row (cql3 Json.java semantics, subset)."""
    import json as json_mod

    def conv(v):
        if isinstance(v, (bytes, bytearray)):
            return "0x" + bytes(v).hex()
        if isinstance(v, (set, frozenset)):
            return sorted(conv(x) for x in v)
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, dict):
            return {str(k): conv(x) for k, x in v.items()}
        if isinstance(v, (int, float, bool)) or v is None:
            return v
        return str(v)

    out = []
    for row in rs.rows:
        doc = {n: conv(v) for n, v in zip(rs.column_names, row)}
        out.append((json_mod.dumps(doc),))
    new = ResultSet(["[json]"], out)
    new.paging_state = rs.paging_state
    return new


# ------------------------------------------------------------ term binding --

def bind_term(term, cql_type, params):
    """Evaluate a parsed term to a Python value of the target type."""
    if isinstance(term, ast.BindMarker):
        if isinstance(params, dict):
            if term.name is None or term.name not in params:
                raise InvalidRequest(f"missing named parameter {term.name}")
            v = params[term.name]
        else:
            if term.index >= len(params):
                raise InvalidRequest("not enough bind parameters")
            v = params[term.index]
        # native-protocol bound values arrive in wire encoding and
        # deserialize against the statement's target type HERE — the one
        # place the type is known (transport.frame.WireValue)
        from ..transport.frame import WireValue
        if isinstance(v, WireValue):
            if cql_type is not None:
                return cql_type.deserialize(bytes(v))
            # no column type (LIMIT / TTL / USING TIMESTAMP binds):
            # fixed-width big-endian integers cover the numeric contexts
            if len(v) in (1, 2, 4, 8):
                return int.from_bytes(bytes(v), "big", signed=True)
            return bytes(v)
        return v
    if isinstance(term, ast.Literal):
        if term.kind == "null":
            return None
        if term.kind == "ident":
            raise InvalidRequest(f"unexpected identifier {term.value!r}")
        return term.value
    if isinstance(term, ast.CollectionLiteral):
        if term.kind == "map":
            kt = getattr(cql_type, "key", None)
            vt = getattr(cql_type, "val", None)
            return {bind_term(k, kt, params): bind_term(v, vt, params)
                    for k, v in term.items}
        et = getattr(cql_type, "elem", None)
        vals = [bind_term(x, et, params) for x in term.items]
        if term.kind == "set":
            if isinstance(cql_type, MapType):  # {} parsed as map
                return dict()
            return set(vals)
        if term.kind == "tuple":
            return tuple(vals)
        return vals
    if isinstance(term, ast.FunctionCall):
        return _call_function(term, params)
    return term


def _call_function(fn: ast.FunctionCall, params):
    name = fn.name.lower()
    if name == "now":
        return uuid_mod.uuid1()
    if name == "uuid":
        return uuid_mod.uuid4()
    if name == "totimestamp":
        v = bind_term(fn.args[0], None, params)
        if isinstance(v, uuid_mod.UUID):
            ms = (v.time - 0x01B21DD213814000) // 10000
            from datetime import datetime, timezone
            return datetime.fromtimestamp(ms / 1000.0, tz=timezone.utc)
        return v
    if name == "currenttimestamp":
        from datetime import datetime, timezone
        return datetime.now(tz=timezone.utc)
    raise InvalidRequest(f"unknown function {fn.name}")


# ---------------------------------------------------------------- executor --

class _MutationCollector:
    """Backend proxy that records mutations instead of applying them
    (logged-batch collection). fire_triggers=False collects WITHOUT
    trigger augmentation — conditional batches match single-row LWT,
    which never fires triggers."""

    def __init__(self, backend, fire_triggers: bool = True):
        self._backend = backend
        self._fire_triggers = fire_triggers
        self.mutations: list[Mutation] = []

    collects_only = True   # _apply_dml: no view derivation on collect

    @property
    def triggers(self):
        # triggers still augment while collecting: a logged batch must
        # journal the trigger output with the base writes
        if not self._fire_triggers:
            return None
        return getattr(self._backend, "triggers", None)

    def apply(self, mutation, durable: bool = True) -> None:
        self.mutations.append(mutation)

    def __getattr__(self, name):
        return getattr(self._backend, name)


class Executor:
    """Executes parsed statements. `backend` must provide: schema,
    apply(mutation), store(ks, table) with read_partition/scan_all, and
    add_table/drop_table/create-keyspace hooks (StorageEngine satisfies
    this; the distributed StorageProxy will too)."""

    def __init__(self, backend):
        self.backend = backend

    @property
    def schema(self):
        return self.backend.schema

    @property
    def udfs(self):
        from .functions import FunctionRegistry
        sch = self.backend.schema
        if not hasattr(sch, "udfs"):
            sch.udfs = FunctionRegistry()
        return sch.udfs

    PERMISSION_OF = {
        "SelectStatement": "SELECT",
        "InsertStatement": "MODIFY", "UpdateStatement": "MODIFY",
        "DeleteStatement": "MODIFY", "BatchStatement": "MODIFY",
        "TruncateStatement": "MODIFY",
        "CreateTableStatement": "CREATE", "CreateIndexStatement": "CREATE",
        "CreateTypeStatement": "CREATE",
        "CreateKeyspaceStatement": "CREATE",
        "CreateViewStatement": "CREATE",
        "CreateFunctionStatement": "CREATE",
        "CreateAggregateStatement": "CREATE",
        "CreateTriggerStatement": "CREATE",
        "DropTriggerStatement": "DROP",
        "DropStatement": "DROP", "AlterTableStatement": "ALTER",
        "RoleStatement": "AUTHORIZE", "GrantStatement": "AUTHORIZE",
        "ListRolesStatement": "AUTHORIZE",
    }

    def execute(self, stmt, params=(), keyspace: str | None = None,
                now_micros: int | None = None,
                user: str | None = None, page_size: int | None = None,
                paging_state: bytes | None = None) -> ResultSet:
        name = type(stmt).__name__
        auth = getattr(self.backend, "auth", None)
        if auth is not None and auth.enabled:
            perm = self.PERMISSION_OF.get(name)
            if perm is not None:
                ks = getattr(stmt, "keyspace", None) or keyspace
                auth.check(user, perm, ks)
        m = getattr(self, f"_exec_{name}", None)
        if m is None:
            raise InvalidRequest(f"cannot execute {name}")
        if name in ("RoleStatement", "GrantStatement",
                    "ListRolesStatement", "BatchStatement",
                    "IdentityStatement"):
            return m(stmt, params, keyspace, now_micros, user)
        if name == "SelectStatement":
            return m(stmt, params, keyspace, now_micros,
                     page_size=page_size, paging_state=paging_state)
        rs = m(stmt, params, keyspace, now_micros)
        self._emit_schema_event(name, stmt, keyspace)
        return rs

    _SCHEMA_EVENTS = {
        "CreateKeyspaceStatement": ("CREATED", "KEYSPACE"),
        "CreateTableStatement": ("CREATED", "TABLE"),
        "CreateViewStatement": ("CREATED", "TABLE"),
        "CreateIndexStatement": ("UPDATED", "TABLE"),
        "AlterTableStatement": ("UPDATED", "TABLE"),
        "DropStatement": ("DROPPED", None),     # target from stmt.what
    }

    def _emit_schema_event(self, name, stmt, keyspace) -> None:
        """Server-push schema change events (transport Event.SchemaChange
        role) — drivers track DDL from other sessions through these."""
        emit = getattr(self.backend, "emit_event", None)
        info = self._SCHEMA_EVENTS.get(name)
        if emit is None or info is None:
            return
        change, target = info
        if target is None:
            what = getattr(stmt, "what", "table")
            target = "KEYSPACE" if what == "keyspace" else "TABLE"
        ks = getattr(stmt, "keyspace", None) or keyspace
        nm = getattr(stmt, "name", None)
        if target == "KEYSPACE":
            ks = nm or ks     # CREATE/DROP KEYSPACE: the name IS the ks
        emit("SCHEMA_CHANGE", {"change": change, "target": target,
                               "keyspace": ks, "name": nm})

    # ------------------------------------------------------------- auth --

    def _exec_RoleStatement(self, s, params, keyspace, now, user=None):
        auth = getattr(self.backend, "auth", None)
        if auth is None:
            raise InvalidRequest("no auth service on this backend")
        auth.require_superuser(user)
        if s.action == "create":
            try:
                auth.create_role(s.name, s.password, bool(s.superuser))
            except ValueError:
                if not s.if_not_exists:
                    raise InvalidRequest(f"role {s.name} exists")
                # IF NOT EXISTS on an existing role is a FULL no-op —
                # applying the access options would silently rewrite the
                # live role's restrictions
                return ResultSet([], [])
        elif s.action == "drop":
            try:
                auth.drop_role(s.name, if_exists=s.if_not_exists)
            except ValueError as e:
                raise InvalidRequest(str(e))
        elif s.action == "alter":
            r = auth.roles.get(s.name)
            if r is None:
                raise InvalidRequest(f"unknown role {s.name}")
            if s.password is not None or s.superuser is not None:
                auth.alter_role(s.name, password=s.password,
                                superuser=s.superuser)
        if s.action in ("create", "alter") and \
                (s.datacenters is not None or s.cidr_groups is not None):
            try:
                auth.alter_role_access(s.name, cidr_groups=s.cidr_groups,
                                       datacenters=s.datacenters)
            except ValueError as e:
                raise InvalidRequest(str(e))
        return ResultSet([], [])

    def _exec_IdentityStatement(self, s, params, keyspace, now,
                                user=None):
        auth = getattr(self.backend, "auth", None)
        if auth is None:
            raise InvalidRequest("no auth service on this backend")
        auth.require_superuser(user)
        try:
            if s.action == "add":
                auth.add_identity(s.identity, s.role)
            else:
                auth.drop_identity(s.identity)
        except ValueError as e:
            raise InvalidRequest(str(e))
        return ResultSet([], [])

    def _exec_GrantStatement(self, s, params, keyspace, now, user=None):
        auth = getattr(self.backend, "auth", None)
        if auth is None:
            raise InvalidRequest("no auth service on this backend")
        auth.require_superuser(user)
        if s.revoke:
            auth.revoke(s.permission, s.resource, s.role)
        else:
            auth.grant(s.permission, s.resource, s.role)
        return ResultSet([], [])

    def _exec_ListRolesStatement(self, s, params, keyspace, now, user=None):
        auth = getattr(self.backend, "auth", None)
        if auth is None:
            raise InvalidRequest("no auth service on this backend")
        auth.require_superuser(user)
        rows = [(name, r.get("superuser", False), r.get("login", True))
                for name, r in sorted(auth.roles.items())]
        return ResultSet(["role", "super", "login"], rows)

    # ------------------------------------------------------------- helpers

    def _table(self, stmt, keyspace):
        ks = stmt.keyspace or keyspace
        if ks is None:
            raise InvalidRequest("no keyspace specified")
        try:
            return self.schema.get_table(ks, stmt.table
                                         if hasattr(stmt, "table")
                                         else stmt.name)
        except KeyError as e:
            raise InvalidRequest(str(e))

    def _split_where(self, table, where, params):
        """Classify WHERE relations into pk equality, clustering
        restrictions, and regular-column filters
        (cql3/restrictions/StatementRestrictions role)."""
        pk_vals: dict[str, list] = {}
        ck_rel: dict[str, list] = {}
        filters = []
        names = {c.name: c for c in table.columns.values()}
        for rel in where:
            col = names.get(rel.column)
            if col is None:
                raise InvalidRequest(f"unknown column {rel.column}")
            t = col.cql_type
            if col.kind == schema_mod.ColumnKind.PARTITION_KEY:
                if rel.op == "=":
                    pk_vals[col.name] = [bind_term(rel.value, t, params)]
                elif rel.op == "IN":
                    pk_vals[col.name] = [bind_term(v, t, params)
                                         for v in rel.value]
                else:
                    raise InvalidRequest(
                        f"only =/IN allowed on partition key {col.name}")
            elif col.kind == schema_mod.ColumnKind.CLUSTERING:
                if rel.op == "IN":
                    vals = [bind_term(v, t, params) for v in rel.value]
                    ck_rel.setdefault(col.name, []).append(("IN", vals))
                else:
                    ck_rel.setdefault(col.name, []).append(
                        (rel.op, bind_term(rel.value, t, params)))
            else:
                filters.append((col, rel.op,
                                bind_term(rel.value, t, params)
                                if rel.op not in ("IN",)
                                else [bind_term(v, t, params)
                                      for v in rel.value]))
        return pk_vals, ck_rel, filters

    def _pk_bytes_list(self, table, pk_vals) -> list[bytes]:
        cols = table.partition_key_columns
        if len(pk_vals) != len(cols):
            raise InvalidRequest("incomplete partition key")
        combos = [[]]
        for c in cols:
            vals = pk_vals[c.name]
            combos = [prev + [v] for prev in combos for v in vals]
        gr = getattr(self.backend, "guardrails", None)
        if gr is not None:
            gr.check_in_cartesian(len(combos))
        return [table.serialize_partition_key(c) for c in combos]

    def _range_delete_slice(self, table, ck_rel, ts, now_s):
        """DELETE with clustering restrictions: None for full-equality
        (exact row delete), else the range-tombstone Slice — an equality
        prefix plus optional inequalities on the next column (reference
        ClusteringBound semantics: prefix deletes and slice deletes)."""
        from ..storage.rangetomb import Slice

        eq_vals: list = []
        ineqs: list[tuple[str, object]] = []
        seen_end = False
        for c in table.clustering_columns:
            rels = ck_rel.get(c.name)
            if rels is None:
                seen_end = True
                continue
            if seen_end:
                raise InvalidRequest(
                    f"DELETE restriction on {c.name} skips a clustering "
                    "column")
            ops = [op for op, _ in rels]
            if ops == ["="] and not ineqs:
                eq_vals.append(rels[0][1])
                continue
            for op, v in rels:
                if op not in (">", ">=", "<", "<="):
                    raise InvalidRequest(
                        f"unsupported DELETE restriction {op} on {c.name}")
                ineqs.append((op, v))
            seen_end = True
        if len(eq_vals) == len(table.clustering_columns):
            return None
        prefix = table.clustering_bytecomp(eq_vals) if eq_vals else b""
        start, start_incl = prefix, True
        end, end_incl = prefix, True
        seen_start = seen_end = False
        for op, v in ineqs:
            bcomp = table.clustering_bytecomp(eq_vals + [v])
            if op in (">", ">="):
                if seen_start:
                    raise InvalidRequest(
                        "more than one lower bound in DELETE range")
                seen_start = True
                start, start_incl = bcomp, op == ">="
            else:
                if seen_end:
                    raise InvalidRequest(
                        "more than one upper bound in DELETE range")
                seen_end = True
                end, end_incl = bcomp, op == "<="
        return Slice(start, start_incl, end, end_incl, ts, now_s)

    def _full_ck(self, table, ck_rel, params=()):
        """Full-equality clustering frame (for writes)."""
        vals = []
        for c in table.clustering_columns:
            rels = ck_rel.get(c.name)
            if not rels or rels[0][0] != "=":
                raise InvalidRequest(
                    f"write requires full clustering (missing {c.name})")
            vals.append(rels[0][1])
        return table.serialize_clustering(vals)

    # ----------------------------------------------------------------- DDL

    def _exec_CreateKeyspaceStatement(self, s, params, ks, now):
        gr = getattr(self.backend, "guardrails", None)
        if gr is not None:
            gr.check_keyspace_count(1 + len(self.schema.keyspaces))
            rep = s.replication or {}
            rfs = [int(v) for k, v in rep.items()
                   if k not in ("class",) and str(v).isdigit()]
            for rf in rfs:
                gr.check_replication_factor(rf, s.name)
        self.schema.create_keyspace(
            s.name, KeyspaceParams(replication=s.replication,
                                   durable_writes=s.durable_writes),
            if_not_exists=s.if_not_exists)
        return ResultSet([], [])

    def _exec_CreateTableStatement(self, s, params, keyspace, now):
        ks = s.keyspace or keyspace
        if ks is None:
            raise InvalidRequest("no keyspace for CREATE TABLE")
        if ks not in self.schema.keyspaces:
            raise InvalidRequest(f"unknown keyspace {ks}")
        if s.name in self.schema.keyspaces[ks].tables:
            if s.if_not_exists:
                return ResultSet([], [])
            raise InvalidRequest(f"table {ks}.{s.name} exists")
        if not s.partition_key:
            raise InvalidRequest("missing PRIMARY KEY")
        gr = getattr(self.backend, "guardrails", None)
        if gr is not None:
            gr.check_table_count(1 + sum(len(k.tables) for k in
                                         self.schema.keyspaces.values()))
            gr.check_columns_per_table(len(s.columns),
                                       f"{ks}.{s.name}")
        udts = self.schema.keyspaces[ks].user_types
        cols = {n: t for n, t, _ in s.columns}
        statics = {n for n, _, st in s.columns if st}
        params_obj = self._table_params(s.options)
        pkc = [(n, parse_type(cols[n], udts)) for n in s.partition_key]
        ckc = [(n, parse_type(cols[n], udts),
                bool(s.clustering_order.get(n, False)))
               for n in s.clustering]
        other = [(n, parse_type(t, udts)) for n, t, st in s.columns
                 if n not in s.partition_key and n not in s.clustering
                 and not st]
        stat = [(n, parse_type(cols[n], udts)) for n in statics]
        if gr is not None:
            # PARSED types, so frozen<vector<...>> and friends are seen
            from ..types.marshal import VectorType

            def _vec_dims(typ):
                if isinstance(typ, VectorType):
                    yield typ.dimension
                for sub_t in ("elem", "key", "val"):
                    inner = getattr(typ, sub_t, None)
                    if inner is not None and hasattr(inner, "serialize"):
                        yield from _vec_dims(inner)
            for n_, typ in pkc + [(n, t) for n, t, _ in ckc] \
                    + other + stat:
                for dims in _vec_dims(typ):
                    gr.check_vector_dimensions(dims, n_)
        tid = None
        if "id" in s.options:
            # CREATE TABLE ... WITH id = <uuid>: explicit table id —
            # the reference supports this so independently-started nodes
            # (or restores) can agree on the id without schema exchange
            import uuid as uuid_mod
            try:
                tid = uuid_mod.UUID(str(s.options["id"]))
            except ValueError:
                raise InvalidRequest(
                    f"invalid table id {s.options['id']!r}")
        t = schema_mod.TableMetadata(ks, s.name, pkc, ckc, other, stat,
                                     params_obj, table_id=tid)
        self.backend.add_table(t)
        return ResultSet([], [])

    def _exec_CreateViewStatement(self, s, params, keyspace, now):
        """CREATE MATERIALIZED VIEW (db/view/ + schema/ViewMetadata):
        the view is a real table whose rows the DML path derives from
        base-table writes; creation backfills from existing data
        (ViewBuilder role)."""
        ks = s.keyspace or keyspace
        bks = s.base_keyspace or keyspace
        if ks is None or bks is None:
            raise InvalidRequest("no keyspace for CREATE MATERIALIZED VIEW")
        gr = getattr(self.backend, "guardrails", None)
        if gr is not None:
            have = sum(1 for v in self.schema.views.values()
                       if v.get("base") == (bks, s.base_table))
            gr.check_materialized_views(have + 1,
                                        f"{bks}.{s.base_table}")
        if (ks, s.name) in self.schema.views:
            if s.if_not_exists:
                return ResultSet([], [])
            raise InvalidRequest(f"view {ks}.{s.name} exists")
        if s.name in self.schema.keyspaces[ks].tables:
            raise InvalidRequest(f"{ks}.{s.name} already names a table")
        base = self.schema.get_table(bks, s.base_table)
        base_pk = set(base.primary_key_names())
        view_pk = s.partition_key + s.clustering
        missing = base_pk - set(view_pk)
        if missing:
            raise InvalidRequest(
                f"view primary key must include every base primary key "
                f"column (missing {sorted(missing)})")
        extra = [c for c in view_pk if c not in base_pk]
        if len(extra) > 1:
            raise InvalidRequest(
                "view primary key may include at most ONE non-primary-key "
                "base column")
        for c in view_pk:
            col = base.columns.get(c)
            if col is None:
                raise InvalidRequest(f"unknown column {c}")
            if col.kind == schema_mod.ColumnKind.STATIC:
                raise InvalidRequest("static columns cannot be in a view")
        selected = [c.name for c in base.partition_key_columns
                    + base.clustering_columns + base.regular_columns] \
            if s.selected == ["*"] else list(s.selected)
        for c in selected:
            if c not in base.columns:
                raise InvalidRequest(f"unknown column {c}")
        for c in view_pk:
            if c not in selected:
                selected.append(c)
        regulars = [(c, base.columns[c].cql_type) for c in selected
                    if c not in view_pk]
        view_id = None
        if getattr(s, "view_id", None):
            import uuid as _uuid
            view_id = _uuid.UUID(str(s.view_id))
        vt = schema_mod.TableMetadata(
            ks, s.name,
            [(c, base.columns[c].cql_type) for c in s.partition_key],
            [(c, base.columns[c].cql_type, False) for c in s.clustering],
            regulars, table_id=view_id)
        if bks != ks:
            raise InvalidRequest(
                "a materialized view must be in the same keyspace as its "
                "base table")
        self.backend.add_table(vt)
        self.schema.views[(ks, s.name)] = {"base": (bks, s.base_table)}
        self.schema._changed()   # persist the view registration
        try:
            self._backfill_view(base, vt)
        except BaseException:
            # roll the half-created view back fully
            self.schema.views.pop((ks, s.name), None)
            try:
                self.backend.drop_table(ks, s.name)
            except Exception:
                pass
            self.schema._changed()
            raise
        return ResultSet([], [])

    def _backfill_view(self, base, vt) -> None:
        from ..storage.paging import paged_rows
        cfs = self.backend.store(base.keyspace, base.name)
        now = timeutil.now_micros()
        for row in paged_rows(cfs, base):
            if row.is_static:
                continue
            d = row_to_dict(base, row, with_meta=True)
            d["__liveness__"] = row.liveness_meta
            if self._view_key(vt, d) is None:
                continue   # null in a view key column: row not in view
            self._view_row_mutation(vt, d, now, apply=True)

    def _views_of(self, t):
        out = []
        for (ks, name), v in self.schema.views.items():
            if v["base"] == (t.keyspace, t.name):
                try:
                    out.append(self.schema.get_table(ks, name))
                except KeyError:
                    pass
        return out

    def _apply_dml(self, m, now, augment: bool = True) -> None:
        """backend.apply + materialized-view maintenance: read the
        affected rows before and after the base write and derive view
        deletes/inserts (db/view/ViewUpdateGenerator; generation happens
        at the coordinator, so view mutations get their own replication,
        hints and consistency like any write). View mutations use the
        BASE write's timestamp so USING TIMESTAMP ordering carries over
        (a ts-200 delete must shadow the view row of a ts-100 write)."""
        t = self.schema.table_by_id(m.table_id)
        trig = getattr(self.backend, "triggers", None) if augment else None
        if trig is not None and t is not None:
            # coordinator-side augmentation (TriggerExecutor.execute):
            # extras apply as ordinary writes — no re-triggering, no
            # view derivation (single augmentation pass, like the
            # reference). Collecting backends record them so logged
            # batches journal trigger output alongside the base writes.
            for em in trig.augment(t, m, self.backend):
                self.backend.apply(em)
        views = self._views_of(t) if t is not None else []
        if not views or getattr(self.backend, "collects_only", False):
            # a collecting backend (logged batch) records the base
            # mutation only: pre==post there and deriving view updates
            # from it would log stale rows — maintenance happens when
            # the collected mutations are REALLY applied
            self.backend.apply(m)
            return
        view_ts = max((op[4] for op in m.ops), default=now)
        pre = self._affected_rows(t, m)
        self.backend.apply(m)
        post = self._affected_rows(t, m)
        for vt in views:
            for key in set(pre) | set(post):
                self._update_view(vt, pre.get(key), post.get(key),
                                  view_ts)

    def _affected_rows(self, t, m) -> dict:
        """ck_frame -> row dict for the rows this mutation touches (the
        whole partition when it carries partition/range-level ops).
        NOTE: reads the whole base partition (the store's read primitive
        is per-partition), so view-backed writes cost O(partition) — a
        clustering-slice read primitive would narrow this; the reference
        pays an analogous read-before-write on every view update."""
        whole = any(op[1] in (schema_mod.COL_PARTITION_DEL,
                              schema_mod.COL_RANGE_TOMB)
                    for op in m.ops)
        cks = {op[0] for op in m.ops
               if op[1] not in (schema_mod.COL_PARTITION_DEL,
                                schema_mod.COL_RANGE_TOMB)}
        batch = self.backend.store(t.keyspace, t.name).read_partition(m.pk)
        out = {}
        for r in rows_from_batch(t, batch):
            if r.is_static:
                continue
            if whole or r.ck_frame in cks:
                d = row_to_dict(t, r, with_meta=True)
                d["__liveness__"] = r.liveness_meta
                out[r.ck_frame] = d
        return out

    def _view_key(self, vt, row: dict | None):
        if row is None:
            return None
        vals = [row.get(c.name) for c in vt.partition_key_columns
                + vt.clustering_columns]
        if any(v is None for v in vals):
            return None          # view rows require every pk column set
        return tuple(vals)

    def _view_row_mutation(self, vt, row: dict, now: int,
                           apply: bool = False,
                           pre: dict | None = None):
        pk = vt.serialize_partition_key(
            [row[c.name] for c in vt.partition_key_columns])
        ck = vt.serialize_clustering(
            [row[c.name] for c in vt.clustering_columns])
        m = Mutation(vt.id, pk)
        now_s = timeutil.now_seconds()
        # base TTLs carry over: an expiring base row/cell must expire in
        # the view too, or the view outlives its base row forever
        lm = row.get("__liveness__")
        live_ttl = 0
        if lm is not None and lm[1]:
            live_ttl = max(int(lm[2]) - now_s, 1)
        self._add_liveness(m, ck, now, live_ttl, now_s)
        meta = row.get("__meta__", {})
        for c in vt.regular_columns:
            v = row.get(c.name)
            if v is not None:
                cm = meta.get(c.name)
                if cm is not None and cm[1]:          # expiring base cell
                    rem = max(int(cm[2]) - now_s, 1)
                    m.add(ck, c.column_id, b"", c.cql_type.serialize(v),
                          now, now_s + rem, rem, cb.FLAG_EXPIRING)
                else:
                    m.add(ck, c.column_id, b"",
                          c.cql_type.serialize(v), now)
            elif pre is not None and pre.get(c.name) is not None:
                # base write null-ed the column: shadow the view's copy
                m.add(ck, c.column_id, b"", b"", now, now_s, 0,
                      cb.FLAG_TOMBSTONE)
        if apply:
            self.backend.apply(m)
        return m

    def _update_view(self, vt, pre: dict | None, post: dict | None,
                     now: int) -> None:
        old_key = self._view_key(vt, pre)
        new_key = self._view_key(vt, post)
        now_s = timeutil.now_seconds()
        if old_key is not None and old_key != new_key:
            pk = vt.serialize_partition_key(
                [pre[c.name] for c in vt.partition_key_columns])
            ck = vt.serialize_clustering(
                [pre[c.name] for c in vt.clustering_columns])
            m = Mutation(vt.id, pk)
            m.add(ck, schema_mod.COL_ROW_DEL, b"", b"", now, now_s, 0,
                  cb.FLAG_ROW_DEL)
            self.backend.apply(m)
        if new_key is not None:
            self._view_row_mutation(
                vt, post, now, apply=True,
                pre=pre if old_key == new_key else None)

    def _reject_view_write(self, t) -> None:
        if (t.keyspace, t.name) in self.schema.views:
            raise InvalidRequest(
                "cannot directly modify a materialized view")

    def _exec_CreateFunctionStatement(self, s, params, keyspace, now):
        from .functions import UDF, FunctionError
        ks = s.keyspace or keyspace
        if ks is None:
            raise InvalidRequest("no keyspace for CREATE FUNCTION")
        if s.language != "expr":
            raise InvalidRequest(
                "only LANGUAGE expr is supported (a sandboxed expression "
                "language — see cql/functions.py)")
        if self.udfs.get_function(ks, s.name) is not None \
                and s.if_not_exists:
            return ResultSet([], [])
        try:
            self.udfs.add_function(
                UDF(ks, s.name, s.arg_names, s.arg_types, s.returns,
                    s.body), replace=s.or_replace)
        except FunctionError as e:
            raise InvalidRequest(str(e))
        self.schema._changed()
        return ResultSet([], [])

    def _exec_CreateAggregateStatement(self, s, params, keyspace, now):
        from .functions import UDA, FunctionError
        ks = s.keyspace or keyspace
        if ks is None:
            raise InvalidRequest("no keyspace for CREATE AGGREGATE")
        if self.udfs.get_function(ks, s.sfunc) is None:
            raise InvalidRequest(f"unknown SFUNC {s.sfunc}")
        if s.finalfunc and self.udfs.get_function(ks, s.finalfunc) is None:
            raise InvalidRequest(f"unknown FINALFUNC {s.finalfunc}")
        try:
            self.udfs.add_aggregate(
                UDA(ks, s.name, s.arg_type, s.sfunc, s.stype,
                    s.finalfunc, s.initcond), replace=s.or_replace)
        except FunctionError as e:
            raise InvalidRequest(str(e))
        self.schema._changed()
        return ResultSet([], [])

    def _table_params(self, options: dict) -> TableParams:
        p = TableParams()
        if "compression" in options:
            p.compression = CompressionParams.from_dict(options["compression"])
        if "compaction" in options:
            p.compaction = dict(options["compaction"])
        if "gc_grace_seconds" in options:
            p.gc_grace_seconds = int(options["gc_grace_seconds"])
        if "cdc" in options:
            v = options["cdc"]
            p.cdc = v if isinstance(v, bool) \
                else str(v).lower() in ("true", "1")
        if "encryption" in options:
            v = options["encryption"]
            if isinstance(v, dict):
                v = v.get("enabled", False)
            p.encryption = v if isinstance(v, bool) \
                else str(v).lower() in ("true", "1")
            if p.encryption:
                from ..storage import encryption as enc_mod
                if enc_mod.get_context() is None:
                    # reject at DDL time: accepting the table and failing
                    # at first flush would wedge the memtable forever
                    raise InvalidRequest(
                        "encryption requires the node to be started "
                        "with a keystore (keystore_dir)")
        if "default_time_to_live" in options:
            p.default_ttl = int(options["default_time_to_live"])
        if "comment" in options:
            p.comment = str(options["comment"])
        if "caching" in options:
            c = dict(options["caching"])
            rpp = str(c.get("rows_per_partition", "NONE")).upper()
            if rpp not in ("NONE", "ALL"):
                raise InvalidRequest(
                    "caching rows_per_partition must be NONE or ALL")
            p.caching = {"keys": str(c.get("keys", "ALL")).upper(),
                         "rows_per_partition": rpp}
        return p

    def _exec_CreateTypeStatement(self, s, params, keyspace, now):
        gr = getattr(self.backend, "guardrails", None)
        if gr is not None:
            gr.check_fields_per_udt(len(s.fields), s.name)
        ks = s.keyspace or keyspace
        ksm = self.schema.keyspaces.get(ks)
        if ksm is None:
            raise InvalidRequest(f"unknown keyspace {ks}")
        if s.name in ksm.user_types:
            if s.if_not_exists:
                return ResultSet([], [])
            raise InvalidRequest(f"type {s.name} exists")
        from ..types.marshal import UserType
        ftypes = [parse_type(t, ksm.user_types) for _, t in s.fields]
        ksm.user_types[s.name] = UserType(ks, s.name,
                                          [n for n, _ in s.fields], ftypes)
        self.schema._changed()
        return ResultSet([], [])

    def _exec_CreateIndexStatement(self, s, params, keyspace, now):
        t = self._table(s, keyspace)
        if s.column not in t.columns:
            raise InvalidRequest(f"unknown column {s.column}")
        gr = getattr(self.backend, "guardrails", None)
        registry0 = getattr(self.backend, "indexes", None)
        if gr is not None and registry0 is not None:
            have = sum(1 for (ks0, tb0, _c) in registry0.indexes
                       if ks0 == t.keyspace and tb0 == t.name)
            gr.check_secondary_indexes(have + 1, t.full_name())
        # index definitions are per-node structures: register on EVERY
        # node of an in-process cluster (TCP clusters replicate the DDL
        # itself through the schema log, so each process runs this)
        backends = list(getattr(self.backend, "cluster_nodes", ()) or ()) \
            or [self.backend]
        created = False
        first_err = None
        for b in backends:
            registry = getattr(b, "indexes", None)
            if registry is None:
                continue
            try:
                registry.create(t, s.column, s.name, s.custom_class,
                                options=getattr(s, "options", None),
                                if_not_exists=s.if_not_exists)
                created = True
            except ValueError as e:
                # keep going: one node's failure must not leave earlier
                # nodes' registrations unpersisted/divergent
                first_err = first_err or e
        if created:
            self.schema._changed()   # index defs persist with the schema
        if first_err is not None:
            raise InvalidRequest(str(first_err))
        return ResultSet([], [])

    def _exec_CreateTriggerStatement(self, s, params, keyspace, now):
        from ..service.triggers import TriggerError
        t = self._table(s, keyspace)
        trig = getattr(self.backend, "triggers", None)
        if trig is None:
            raise InvalidRequest("backend has no trigger support")
        try:
            trig.create(t.keyspace, t.name, s.name, s.using,
                        if_not_exists=s.if_not_exists)
        except TriggerError as e:
            raise InvalidRequest(str(e))
        self.schema._changed()   # trigger defs persist with the schema
        return ResultSet([], [])

    def _exec_DropTriggerStatement(self, s, params, keyspace, now):
        from ..service.triggers import TriggerError
        t = self._table(s, keyspace)
        trig = getattr(self.backend, "triggers", None)
        if trig is None:
            raise InvalidRequest("backend has no trigger support")
        try:
            trig.drop(t.keyspace, t.name, s.name, if_exists=s.if_exists)
        except TriggerError as e:
            raise InvalidRequest(str(e))
        self.schema._changed()
        return ResultSet([], [])

    def _exec_DropStatement(self, s, params, keyspace, now):
        if s.what in ("table", "keyspace"):
            gr = getattr(self.backend, "guardrails", None)
            if gr is not None:
                gr.check_drop_truncate(f"DROP {s.what.upper()}")
        ks = s.keyspace or keyspace
        try:
            if s.what == "keyspace":
                ksm = self.schema.keyspaces.get(s.name)
                if ksm is None:
                    raise KeyError(s.name)
                for vks, vname in list(self.schema.views):
                    if vks == s.name:
                        del self.schema.views[(vks, vname)]
                trig = getattr(self.backend, "triggers", None)
                for tname in list(ksm.tables):
                    self.backend.drop_table(s.name, tname)
                    if trig is not None:
                        trig.drop_table(s.name, tname)
                self.schema.drop_keyspace(s.name)
            elif s.what == "table":
                if (ks, s.name) in self.schema.views:
                    raise InvalidRequest(
                        f"{ks}.{s.name} is a materialized view — use "
                        "DROP MATERIALIZED VIEW")
                dependents = [nm for (vks, nm), v in
                              self.schema.views.items()
                              if v["base"] == (ks, s.name)]
                if dependents:
                    raise InvalidRequest(
                        f"cannot drop {ks}.{s.name}: materialized views "
                        f"depend on it: {dependents}")
                self.backend.drop_table(ks, s.name)
                trig = getattr(self.backend, "triggers", None)
                if trig is not None:
                    trig.drop_table(ks, s.name)
            elif s.what == "view":
                if (ks, s.name) not in self.schema.views:
                    raise KeyError(s.name)
                del self.schema.views[(ks, s.name)]
                self.backend.drop_table(ks, s.name)
                self.schema._changed()
            elif s.what == "type":
                del self.schema.keyspaces[ks].user_types[s.name]
                self.schema._changed()
            elif s.what == "index":
                backends = list(getattr(self.backend, "cluster_nodes",
                                        ()) or ()) or [self.backend]
                dropped = False
                missing = None
                for b in backends:
                    registry = getattr(b, "indexes", None)
                    if registry is None:
                        continue
                    try:
                        registry.drop(ks, s.name)
                        dropped = True
                    except KeyError as e:
                        # a node without the entry must not stop the
                        # drop from completing on the others
                        missing = e
                if dropped:
                    self.schema._changed()
                elif missing is not None:
                    raise missing
            elif s.what in ("function", "aggregate"):
                self.udfs.drop(ks, s.name, kind=s.what)
                self.schema._changed()
        except KeyError:
            if not s.if_exists:
                raise InvalidRequest(f"unknown {s.what} {s.name}")
        return ResultSet([], [])

    def _exec_AlterTableStatement(self, s, params, keyspace, now):
        ks = s.keyspace or keyspace
        t = self.schema.get_table(ks, s.name)
        if s.action == "add":
            for cname, ctype in s.columns:
                if cname in t.columns:
                    raise InvalidRequest(f"column {cname} exists")
                next_id = max(t.columns_by_id, default=7) + 1
                col = schema_mod.ColumnMetadata(
                    cname, parse_type(ctype), schema_mod.ColumnKind.REGULAR,
                    len(t.regular_columns), column_id=next_id)
                t.regular_columns.append(col)
                t.columns[cname] = col
                t.columns_by_id[next_id] = col
        elif s.action == "drop":
            for cname in s.columns:
                col = t.columns.get(cname)
                if col is None or col.kind != schema_mod.ColumnKind.REGULAR:
                    raise InvalidRequest(f"cannot drop {cname}")
                t.regular_columns.remove(col)
                del t.columns[cname]
                del t.columns_by_id[col.column_id]
        elif s.action == "with":
            p = self._table_params(s.options)
            if "compaction" in s.options:
                t.params.compaction = p.compaction
            if "compression" in s.options:
                t.params.compression = p.compression
            if "gc_grace_seconds" in s.options:
                t.params.gc_grace_seconds = p.gc_grace_seconds
            if "default_time_to_live" in s.options:
                t.params.default_ttl = p.default_ttl
            if "caching" in s.options:
                t.params.caching = p.caching
                # rebuild the LIVE store's row cache to match (the
                # engine's store, not a cluster read facade)
                from ..storage.table import RowCache
                eng = getattr(self.backend, "engine", self.backend)
                try:
                    cfs = eng.store(t.keyspace, t.name)
                except KeyError:
                    cfs = None
                if cfs is not None and hasattr(cfs, "row_cache"):
                    if cfs.row_cache is not None:
                        cfs.row_cache.clear()   # dropping the handle must
                        # not leave entries pinned in the shared service
                    cfs.row_cache = RowCache(cfs.directory) if \
                        p.caching.get("rows_per_partition") != "NONE" \
                        else None
        self.schema._changed()
        return ResultSet([], [])

    def _exec_TruncateStatement(self, s, params, keyspace, now):
        gr = getattr(self.backend, "guardrails", None)
        if gr is not None:
            gr.check_drop_truncate("TRUNCATE")
        t = self._table(s, keyspace)
        self.backend.store(t.keyspace, t.name).truncate()
        return ResultSet([], [])

    def _exec_UseStatement(self, s, params, keyspace, now):
        if s.keyspace not in self.schema.keyspaces:
            raise InvalidRequest(f"unknown keyspace {s.keyspace}")
        rs = ResultSet([], [])
        rs.keyspace = s.keyspace
        return rs

    # ----------------------------------------------------------------- DML


    def _expand_json_insert(self, s, t, params):
        """INSERT JSON -> a COPY of the statement with columns/values
        expanded from the document (Json.java prepareAndCollectMarkers
        + DEFAULT NULL semantics). Shared by the direct insert path and
        conditional batches (which need the key columns up front)."""
        import copy
        import json as json_mod

        from ..transport.frame import WireValue
        doc = s.json_payload
        if isinstance(doc, ast.BindMarker):
            # resolve the marker OURSELVES: the generic no-type wire
            # heuristic would decode small byte payloads as integers
            if isinstance(params, dict):
                if doc.name not in params:
                    raise InvalidRequest(
                        f"missing named parameter {doc.name}")
                doc = params[doc.name]
            else:
                if doc.index >= len(params):
                    raise InvalidRequest("not enough bind parameters")
                doc = params[doc.index]
        else:
            doc = bind_term(doc, None, params)
        if isinstance(doc, (WireValue, bytes, bytearray)):
            doc = bytes(doc).decode()
        try:
            data = json_mod.loads(doc)
        except (TypeError, ValueError) as e:
            raise InvalidRequest(f"bad JSON payload: {e}")
        if not isinstance(data, dict):
            raise InvalidRequest("INSERT JSON expects an object")
        s = copy.copy(s)
        s.json = False
        s.columns, s.values = [], []
        for k, v in data.items():
            col = t.columns.get(k)
            if col is None:
                raise InvalidRequest(f"unknown column {k}")
            s.columns.append(k)
            s.values.append(ast.Literal(
                _from_json(v, col.cql_type), "json"))
        # DEFAULT NULL semantics (reference Json.java): columns the
        # document omits are written null, replacing the whole row
        named = set(data)
        for col in t.regular_columns + t.static_columns:
            if col.name not in named:
                s.columns.append(col.name)
                s.values.append(ast.Literal(None, "null"))
        return s

    def _exec_InsertStatement(self, s, params, keyspace, now):
        t = self._table(s, keyspace)
        self._reject_view_write(t)
        if getattr(s, "json", False):
            s = self._expand_json_insert(s, t, params)
        now = now or timeutil.now_micros()
        ts = now if s.timestamp is None \
            else int(bind_term(s.timestamp, None, params))
        ttl = 0 if s.ttl is None else int(bind_term(s.ttl, None, params))
        ttl = ttl or t.params.default_ttl
        _check_ttl(ttl)
        values = {}
        for cname, term in zip(s.columns, s.values):
            col = t.columns.get(cname)
            if col is None:
                raise InvalidRequest(f"unknown column {cname}")
            values[cname] = bind_term(term, col.cql_type, params)
        for c in t.partition_key_columns:
            if values.get(c.name) is None:
                raise InvalidRequest(f"missing partition key column {c.name}")
        # static-only inserts need no clustering (reference
        # ModificationStatement static-row handling)
        static_names = {c.name for c in t.static_columns}
        static_only = t.clustering_columns and all(
            cname in static_names or values.get(cname) is None
            for cname in s.columns
            if cname not in {c.name for c in t.partition_key_columns})
        if not static_only:
            for c in t.clustering_columns:
                if values.get(c.name) is None:
                    raise InvalidRequest(
                        f"missing primary key column {c.name}")
        pk = t.serialize_partition_key(
            [values[c.name] for c in t.partition_key_columns])
        ck = b"" if static_only else t.serialize_clustering(
            [values[c.name] for c in t.clustering_columns])
        m = Mutation(t.id, pk)
        now_s = timeutil.now_seconds()
        if not static_only:
            self._add_liveness(m, ck, ts, ttl, now_s)
        for cname, v in values.items():
            col = t.columns[cname]
            if col.kind in (schema_mod.ColumnKind.PARTITION_KEY,
                            schema_mod.ColumnKind.CLUSTERING):
                continue
            target_ck = b"" if col.kind == schema_mod.ColumnKind.STATIC else ck
            self._add_cell_ops(m, t, col, target_ck, v, ts, ttl, now_s,
                               overwrite_collection=True)
        if s.if_not_exists:
            casfn = getattr(self.backend, "cas", None)
            if casfn is not None:   # distributed: Paxos round
                applied, cur = casfn(t.keyspace, t, pk, ck,
                                     lambda c: c is None, lambda: m)
                return APPLIED if applied else self._not_applied(t, cur)
            existing = self._read_row(t, pk, ck, now)
            if existing is not None:
                return self._not_applied(t, existing)
        self._apply_dml(m, ts)
        return APPLIED if s.if_not_exists else ResultSet([], [])

    def _add_liveness(self, m, ck, ts, ttl, now_s):
        if ttl:
            m.add(ck, COL_ROW_LIVENESS, b"", b"", ts,
                  timeutil.expiration_time(now_s, ttl), ttl,
                  cb.FLAG_ROW_LIVENESS | cb.FLAG_EXPIRING)
        else:
            m.add(ck, COL_ROW_LIVENESS, b"", b"", ts,
                  flags=cb.FLAG_ROW_LIVENESS)

    def _add_cell_ops(self, m, t, col, ck, v, ts, ttl, now_s,
                      overwrite_collection=False):
        cid = col.column_id
        typ = col.cql_type
        flags = cb.FLAG_EXPIRING if ttl else 0
        ldt = timeutil.expiration_time(now_s, ttl) if ttl \
            else timeutil.NO_DELETION_TIME
        if v is None:
            m.add(ck, cid, b"", b"", ts, now_s, 0, cb.FLAG_TOMBSTONE)
            return
        if typ.is_multicell:
            if overwrite_collection:
                m.add(ck, cid, b"", b"", ts - 1, now_s, 0,
                      cb.FLAG_COMPLEX_DEL)
            self._add_collection_cells(m, t, col, ck, v, ts, ttl, now_s,
                                       flags)
            return
        ser = typ.serialize(v)
        gr = getattr(self.backend, "guardrails", None)
        if gr is not None:
            gr.check_column_value_size(len(ser), col.name)
        m.add(ck, cid, b"", ser, ts, ldt, ttl, flags)

    def _add_collection_cells(self, m, t, col, ck, v, ts, ttl, now_s, flags):
        typ = col.cql_type
        cid = col.column_id
        gr = getattr(self.backend, "guardrails", None)
        if gr is not None and hasattr(v, "__len__"):
            gr.check_items_per_collection(len(v), col.name)
        ldt = timeutil.expiration_time(now_s, ttl) if ttl else 0x7FFFFFFF
        if isinstance(typ, MapType):
            for k, val in v.items():
                m.add(ck, cid, typ.key.serialize(k), typ.val.serialize(val),
                      ts, ldt, ttl, flags)
        elif isinstance(typ, SetType):
            for el in v:
                m.add(ck, cid, typ.elem.serialize(el), b"", ts, ldt, ttl,
                      flags)
        elif isinstance(typ, ListType):
            for el in v:
                path = uuid_mod.uuid1().bytes
                m.add(ck, cid, path, typ.elem.serialize(el), ts, ldt, ttl,
                      flags)
        else:
            raise InvalidRequest(f"bad collection assignment to {col.name}")


    def _static_only_ck(self, t, ck_rel, column_names):
        """ck frame for a write: b"" when every touched column is
        static and no clustering is given (reference
        ModificationStatement.appliesOnlyToStaticColumns waives the
        full-clustering restriction), else the full-equality frame."""
        static_names = {c.name for c in t.static_columns}
        if t.clustering_columns and not ck_rel and column_names and \
                all(n in static_names for n in column_names):
            return b""
        return self._full_ck(t, ck_rel) if t.clustering_columns else b""

    def _exec_UpdateStatement(self, s, params, keyspace, now):
        t = self._table(s, keyspace)
        self._reject_view_write(t)
        now = now or timeutil.now_micros()
        ts = now if s.timestamp is None \
            else int(bind_term(s.timestamp, None, params))
        ttl = 0 if s.ttl is None else int(bind_term(s.ttl, None, params))
        ttl = ttl or t.params.default_ttl
        _check_ttl(ttl)
        pk_vals, ck_rel, filters = self._split_where(t, s.where, params)
        if filters:
            raise InvalidRequest("non-primary-key columns in UPDATE WHERE")
        pks = self._pk_bytes_list(t, pk_vals)
        ck = self._static_only_ck(t, ck_rel,
                                  [op.column for op in s.ops])
        now_s = timeutil.now_seconds()
        conditional = s.if_exists or s.conditions
        if conditional and len(pks) > 1:
            raise InvalidRequest("IN with conditions is not supported")
        for pk in pks:
            m = Mutation(t.id, pk)
            for op in s.ops:
                self._apply_update_op(m, t, op, ck, ts, ttl, now_s, params)
            if conditional:
                def check(cur):
                    if s.if_exists:
                        return cur is not None
                    return self._check_conditions(t, cur, s.conditions,
                                                  params)
                casfn = getattr(self.backend, "cas", None)
                if casfn is not None:
                    applied, cur = casfn(t.keyspace, t, pk, ck, check,
                                         lambda: m)
                    return APPLIED if applied else self._not_applied(t, cur)
                existing = self._read_row(t, pk, ck, now)
                if not check(existing):
                    return self._not_applied(t, existing)
            self._apply_dml(m, ts)
        if conditional:
            return APPLIED
        return ResultSet([], [])

    def _apply_update_op(self, m, t, op: ast.UpdateOp, ck, ts, ttl, now_s,
                         params):
        col = t.columns.get(op.column)
        if col is None:
            raise InvalidRequest(f"unknown column {op.column}")
        if col.kind in (schema_mod.ColumnKind.PARTITION_KEY,
                        schema_mod.ColumnKind.CLUSTERING):
            raise InvalidRequest(f"cannot SET primary key {op.column}")
        target_ck = b"" if col.kind == schema_mod.ColumnKind.STATIC else ck
        typ = col.cql_type
        if typ.is_counter:
            if op.op not in ("add", "sub"):
                raise InvalidRequest("counters only support +/- updates")
            delta = bind_term(op.value, typ, params)
            if op.op == "sub":
                delta = -delta
            # counters NEVER take the statement/batch timestamp: two
            # deltas sharing a ts would LWW-collapse instead of summing
            # (reference: "Cannot provide custom timestamp for counter
            # updates"); now_micros() is unique per call by contract
            m.add(target_ck, col.column_id, b"",
                  typ.serialize(delta), timeutil.now_micros(),
                  0x7FFFFFFF, 0, cb.FLAG_COUNTER)
            return
        if op.op == "set":
            v = bind_term(op.value, typ, params)
            self._add_cell_ops(m, t, col, target_ck, v, ts, ttl, now_s,
                               overwrite_collection=True)
        elif op.op in ("add", "append"):
            v = bind_term(op.value, typ, params)
            if not typ.is_multicell:
                raise InvalidRequest(f"+= on non-collection {col.name}")
            self._add_collection_cells(m, t, col, target_ck, v, ts, ttl,
                                       now_s, cb.FLAG_EXPIRING if ttl else 0)
        elif op.op == "sub":
            # remove elements/keys
            if isinstance(typ, MapType):
                keys = bind_term(op.value, SetType(typ.key), params)
                for k in keys:
                    m.add(target_ck, col.column_id, typ.key.serialize(k),
                          b"", ts, now_s, 0, cb.FLAG_TOMBSTONE)
            elif isinstance(typ, SetType):
                els = bind_term(op.value, typ, params)
                for el in els:
                    m.add(target_ck, col.column_id, typ.elem.serialize(el),
                          b"", ts, now_s, 0, cb.FLAG_TOMBSTONE)
            else:
                raise InvalidRequest("-= supported on set/map only")
        elif op.op == "put_index":
            if not isinstance(typ, MapType):
                raise InvalidRequest("m[k] = v requires a map")
            k = bind_term(op.key, typ.key, params)
            v = bind_term(op.value, typ.val, params)
            if v is None:
                m.add(target_ck, col.column_id, typ.key.serialize(k), b"",
                      ts, now_s, 0, cb.FLAG_TOMBSTONE)
            else:
                m.add(target_ck, col.column_id, typ.key.serialize(k),
                      typ.val.serialize(v), ts,
                      timeutil.expiration_time(now_s, ttl)
                      if ttl else 0x7FFFFFFF, ttl,
                      cb.FLAG_EXPIRING if ttl else 0)
        elif op.op == "prepend":
            v = bind_term(op.value, typ, params)
            if not isinstance(typ, ListType):
                raise InvalidRequest("prepend requires a list")
            for el in reversed(v):
                # reversed-time uuids sort before existing entries
                u = uuid_mod.uuid1()
                path = (0x0FFFFFFFFFFFFFFF - u.time).to_bytes(8, "big") + \
                    u.bytes[8:]
                m.add(target_ck, col.column_id, path, typ.elem.serialize(el),
                      ts, 0x7FFFFFFF, 0, 0)
        else:
            raise InvalidRequest(f"unsupported update op {op.op}")

    def _exec_DeleteStatement(self, s, params, keyspace, now):
        t = self._table(s, keyspace)
        self._reject_view_write(t)
        now = now or timeutil.now_micros()
        ts = now if s.timestamp is None \
            else int(bind_term(s.timestamp, None, params))
        now_s = timeutil.now_seconds()
        pk_vals, ck_rel, filters = self._split_where(t, s.where, params)
        if filters:
            raise InvalidRequest("non-primary-key columns in DELETE WHERE")
        pks = self._pk_bytes_list(t, pk_vals)
        for pk in pks:
            if s.if_exists or s.conditions:
                ck = self._full_ck(t, ck_rel) if ck_rel else b""
                existing = self._read_row(t, pk, ck, now)
                if s.if_exists and existing is None:
                    return ResultSet(["[applied]"], [(False,)])
                if s.conditions and not self._check_conditions(
                        t, existing, s.conditions, params):
                    return self._not_applied(t, existing)
            m = Mutation(t.id, pk)
            if s.columns:
                ck = self._static_only_ck(
                    t, ck_rel,
                    [item[0] if isinstance(item, tuple) else item
                     for item in s.columns])
                for item in s.columns:
                    if isinstance(item, tuple):
                        cname, key_term = item
                        col = t.columns[cname]
                        k = bind_term(key_term, col.cql_type.key
                                      if isinstance(col.cql_type, MapType)
                                      else col.cql_type.elem, params)
                        kb = (col.cql_type.key.serialize(k)
                              if isinstance(col.cql_type, MapType)
                              else col.cql_type.elem.serialize(k))
                        m.add(ck, col.column_id, kb, b"", ts, now_s, 0,
                              cb.FLAG_TOMBSTONE)
                    else:
                        col = t.columns.get(item)
                        if col is None:
                            raise InvalidRequest(f"unknown column {item}")
                        tgt = b"" if col.kind == schema_mod.ColumnKind.STATIC \
                            else ck
                        if col.cql_type.is_multicell:
                            m.add(tgt, col.column_id, b"", b"", ts, now_s, 0,
                                  cb.FLAG_COMPLEX_DEL)
                        else:
                            m.add(tgt, col.column_id, b"", b"", ts, now_s, 0,
                                  cb.FLAG_TOMBSTONE)
            elif not ck_rel:
                m.add(b"", schema_mod.COL_PARTITION_DEL, b"", b"", ts, now_s,
                      0, cb.FLAG_PARTITION_DEL)
            else:
                slc = self._range_delete_slice(t, ck_rel, ts, now_s)
                if slc is None:
                    # full clustering equality: exact row deletion
                    ck = self._full_ck(t, ck_rel)
                    m.add(ck, schema_mod.COL_ROW_DEL, b"", b"", ts, now_s,
                          0, cb.FLAG_ROW_DEL)
                else:
                    # clustering range / prefix: range tombstone slice
                    # (db/RangeTombstone.java; storage/rangetomb.py)
                    m.add(slc.start, schema_mod.COL_RANGE_TOMB,
                          slc.encode_path(), b"", ts, now_s, 0,
                          cb.FLAG_RANGE_BOUND | cb.FLAG_TOMBSTONE)
            self._apply_dml(m, ts)
        if s.if_exists or s.conditions:
            return APPLIED
        return ResultSet([], [])


    def _exec_conditional_batch(self, s, params, keyspace, now,
                                user=None):
        """Conditional (LWT) batch: every statement must target ONE
        partition of ONE table; all conditions evaluate against that
        partition's current rows at the Paxos linearization point, and
        the combined mutations apply atomically iff every condition
        passes (BatchStatement.executeWithConditions — the reference's
        single-partition restriction, CASBatch semantics)."""
        if s.kind == "counter":
            raise InvalidRequest("counter batches cannot be conditional")
        # resolve the common (table, pk); reject cross-partition batches
        table = None
        pk = None
        per_stmt = []    # (sub, ck_bytes)
        for sub in s.statements:
            t = self._table(sub, keyspace)
            if table is None:
                table = t
            elif t.id != table.id:
                raise InvalidRequest(
                    "conditional batches must target a single table")
            is_cond = bool(getattr(sub, "if_not_exists", False)
                           or getattr(sub, "if_exists", False)
                           or getattr(sub, "conditions", None))
            if type(sub).__name__ == "InsertStatement":
                if getattr(sub, "json", False):
                    # expand NOW: the key columns live in the document
                    sub = self._expand_json_insert(sub, t, params)
                vals = {}
                for cname, term in zip(sub.columns, sub.values):
                    col = t.columns.get(cname)
                    if col is None:
                        raise InvalidRequest(f"unknown column {cname}")
                    vals[cname] = bind_term(term, col.cql_type, params)
                try:
                    this_pk = t.serialize_partition_key(
                        [vals[c.name] for c in t.partition_key_columns])
                    ck = t.serialize_clustering(
                        [vals[c.name] for c in t.clustering_columns]) \
                        if t.clustering_columns else b""
                except KeyError as e:
                    raise InvalidRequest(f"missing key column {e}")
            else:
                pk_vals, ck_rel, filters = self._split_where(
                    t, sub.where, params)
                if filters:
                    raise InvalidRequest(
                        "non-primary-key columns in a conditional "
                        "batch WHERE")
                pks = self._pk_bytes_list(t, pk_vals)
                if len(pks) != 1:
                    raise InvalidRequest(
                        "conditional batches must target a single "
                        "partition")
                this_pk = pks[0]
                # the clustering is only needed to READ a condition's
                # row: unconditional partition/range deletes and
                # static-only updates keep their standalone semantics
                ck = self._full_ck(t, ck_rel, params) \
                    if (is_cond and t.clustering_columns) else b""
            if pk is None:
                pk = this_pk
            elif this_pk != pk:
                raise InvalidRequest(
                    "conditional batches must target a single partition")
            per_stmt.append((sub, ck))

        def check_and_build(read_row):
            # evaluate EVERY condition against the partition's current
            # rows (LWT reads happen under the promised ballot)
            for sub, ck in per_stmt:
                if not (getattr(sub, "if_not_exists", False)
                        or getattr(sub, "if_exists", False)
                        or getattr(sub, "conditions", None)):
                    continue
                existing = read_row(ck)
                if getattr(sub, "if_not_exists", False):
                    if existing is not None:
                        return None, existing
                elif getattr(sub, "if_exists", False):
                    if existing is None:
                        return None, None
                if getattr(sub, "conditions", None):
                    if not self._check_conditions(
                            table, existing, sub.conditions, params):
                        return None, existing
            # all conditions passed: collect the batch's mutations.
            # fire_triggers=False matches single-row LWT (which never
            # fires triggers); conditions are stripped on COPIES — the
            # originals may be shared prepared-statement ASTs executing
            # concurrently on other connections
            import copy as copy_mod
            collector = _MutationCollector(self.backend,
                                           fire_triggers=False)
            sub_exec = Executor(collector)
            for sub, _ck in per_stmt:
                sub2 = copy_mod.copy(sub)
                if hasattr(sub2, "if_not_exists"):
                    sub2.if_not_exists = False
                if hasattr(sub2, "if_exists"):
                    sub2.if_exists = False
                if hasattr(sub2, "conditions"):
                    sub2.conditions = None
                sub_exec.execute(sub2, params, keyspace,
                                 now_micros=now, user=user)
            combined = Mutation(table.id, pk)
            for m in collector.mutations:
                if m.table_id != table.id or m.pk != pk:
                    raise InvalidRequest(
                        "conditional batches must mutate only their "
                        "own partition")
                combined.ops.extend(m.ops)
            return combined, None

        casfn = getattr(self.backend, "cas_partition", None)
        if casfn is not None:
            applied, info = casfn(table.keyspace, table, pk,
                                  check_and_build)
        else:
            # single-engine backend: no distributed linearization needed
            m, info = check_and_build(
                lambda ck: self._read_row(table, pk, ck, now))
            applied = m is not None
            if applied:
                self._apply_dml(m, now, augment=False)
        if applied:
            return APPLIED
        return self._not_applied(table, info)

    def _exec_BatchStatement(self, s, params, keyspace, now, user=None):
        now = now or timeutil.now_micros()
        gr = getattr(self.backend, "guardrails", None)
        if gr is not None:
            gr.check_batch_size(len(s.statements))
        conditional = [sub for sub in s.statements
                       if getattr(sub, "if_not_exists", False)
                       or getattr(sub, "if_exists", False)
                       or getattr(sub, "conditions", None)]
        if conditional:
            return self._exec_conditional_batch(s, params, keyspace, now,
                                                user)
        def _targets_counter(sub) -> bool:
            try:
                t = self.schema.get_table(
                    getattr(sub, "keyspace", None) or keyspace,
                    getattr(sub, "table", ""))
            except KeyError:
                return False
            return t.is_counter_table

        n_counter = sum(_targets_counter(sub) for sub in s.statements)
        if n_counter and s.kind != "counter":
            # reference BatchStatement.verifyBatchSize/Type: replaying a
            # LOGGED delta from the batchlog would double-count — the
            # increment is not idempotent, so it may never be journaled
            raise InvalidRequest(
                "cannot include counter updates in a "
                f"{s.kind.upper()} batch; use BEGIN COUNTER BATCH")
        if s.kind == "counter" and n_counter != len(s.statements):
            raise InvalidRequest(
                "COUNTER batches may only contain counter updates")
        batchlog = getattr(self.backend, "batchlog", None)
        if s.kind == "logged" and batchlog is not None \
                and len(s.statements) > 1:
            # collect all mutations first, persist the batch, then apply —
            # a crash mid-apply replays the remainder at boot
            # (BatchStatement.executeWithConditions logged path)
            collector = _MutationCollector(self.backend)
            sub_exec = Executor(collector)
            for sub in s.statements:
                sub_exec.execute(sub, params, keyspace, now_micros=now,
                                 user=user)
            bid = batchlog.store(collector.mutations)
            # augment=False: triggers already ran during collection
            # (their output IS in collector.mutations and the
            # batchlog); a second pass here would double-fire.
            # Mutations for view-less tables take the backend's batched
            # fast lane (one commitlog barrier + one memtable shard
            # pass — StorageEngine.apply_batch); view-bearing tables
            # need per-mutation pre/post reads and stay on _apply_dml.
            apply_b = getattr(self.backend, "apply_batch", None)
            plain, viewed = [], []
            for m in collector.mutations:
                t = self.schema.table_by_id(m.table_id)
                if apply_b is not None and (t is None
                                            or not self._views_of(t)):
                    plain.append(m)
                else:
                    viewed.append(m)
            if plain:
                apply_b(plain)
            for m in viewed:
                self._apply_dml(m, now, augment=False)
            batchlog.remove(bid)
            return ResultSet([], [])
        for sub in s.statements:
            self.execute(sub, params, keyspace, now_micros=now, user=user)
        return ResultSet([], [])

    # -------------------------------------------------------------- SELECT

    def _read_row(self, t, pk, ck, now_micros) -> dict | None:
        cfs = self.backend.store(t.keyspace, t.name)
        batch = cfs.read_partition(pk)
        for r in rows_from_batch(t, batch):
            if r.ck_frame == ck and not r.is_static:
                return row_to_dict(t, r)
        return None

    def _check_conditions(self, t, existing, conditions, params) -> bool:
        if existing is None:
            return False
        for rel in conditions:
            col = t.columns.get(rel.column)
            v = bind_term(rel.value, col.cql_type, params)
            cur = existing.get(rel.column)
            ok = {"=": cur == v, "!=": cur != v,
                  "<": cur is not None and cur < v,
                  "<=": cur is not None and cur <= v,
                  ">": cur is not None and cur > v,
                  ">=": cur is not None and cur >= v}.get(rel.op, False)
            if not ok:
                return False
        return True

    def _not_applied(self, t, existing) -> ResultSet:
        if existing is None:
            return ResultSet(["[applied]"], [(False,)])
        cols = ["[applied]"] + list(existing.keys())
        return ResultSet(cols, [(False, *existing.values())])

    def _exec_SelectStatement(self, s, params, keyspace, now,
                              page_size=None, paging_state=None):
        # virtual tables (db/virtual role) intercept before real schema
        vts = getattr(self.backend, "virtual_tables", None)
        vks = s.keyspace or keyspace
        if vts is not None and vks in ("system", "system_views",
                                       "system_traces"):
            vt = vts.get(vks, s.table)
            if vt is not None:
                rows = vt.rows()
                for rel in s.where:
                    col = vt.table.columns.get(rel.column)
                    typ = col.cql_type if col else None
                    v = bind_term(rel.value, typ, params) \
                        if rel.op != "IN" else \
                        [bind_term(x, typ, params) for x in rel.value]
                    rows = [r for r in rows
                            if self._match(r.get(rel.column), rel.op, v)]
                rs = self._project_with_limit(vt.table, s, rows, params)
                if getattr(s, "json", False):
                    rs = _jsonify_resultset(rs)
                return rs

        t = self._table(s, keyspace)
        cfs = self.backend.store(t.keyspace, t.name)
        pk_vals, ck_rel, filters = self._split_where(t, s.where, params)

        if s.ann is not None:
            rs = self._ann_select(t, cfs, s, params)
            if getattr(s, "json", False):
                rs = _jsonify_resultset(rs)
            return rs

        if s.allow_filtering:
            gr = getattr(self.backend, "guardrails", None)
            if gr is not None:
                gr.check_allow_filtering()
        index_rows = None
        if filters and not s.allow_filtering:
            index_rows = self._indexed_lookup(t, cfs, filters, params)
            if index_rows is None:
                raise InvalidRequest(
                    "filtering on non-key columns requires ALLOW FILTERING"
                    " (or an index on the column)")

        rows: list[dict] = []
        statics_by_pk: dict[bytes, dict] = {}
        want_meta = any(isinstance(expr, ast.FunctionCall)
                        and expr.name.lower() in ("writetime", "ttl")
                        for expr, _ in s.selectors)
        new_paging_state = None
        paged = False
        pushdown_scan = False
        if index_rows is not None:
            rows = index_rows
            # an accompanying pk restriction still applies
            for cname, vals in pk_vals.items():
                rows = [r for r in rows if r.get(cname) in vals]
            statics_by_pk = {}
            batches = []
        elif pk_vals:
            push = self._pushdown_limits(t, s, params, ck_rel, filters)
            pks = self._pk_bytes_list(t, pk_vals)
            if len(pks) > 1 and hasattr(cfs, "read_partitions"):
                # IN (...) / multi-key reads: one batched bloom +
                # key-cache + segment-gather pass per sstable instead of
                # len(pks) independent read_partition walks
                batches = cfs.read_partitions(pks, limits=push)
            else:
                batches = [(pk, cfs.read_partition(pk, limits=push))
                           for pk in pks]
        else:
            pushed = None
            if (filters and s.allow_filtering and paging_state is None
                    and not page_size and hasattr(cfs, "scan_filtered")):
                pushed = self._scan_pushdown(t, cfs, s, params, ck_rel,
                                             filters, now)
            if pushed is not None and pushed[0] == "agg":
                # the whole answer folded on device/host keys — zero
                # rows materialized (scan.rows_materialized untouched)
                rs = pushed[1]
                if getattr(s, "json", False):
                    rs = _jsonify_resultset(rs)
                return rs
            if pushed is not None:
                # candidate partitions ride the generic batches loop
                # below: ck restrictions and ALL filters re-verify
                # every row exactly, statics/phantoms/guardrail reuse
                # the proven code — bit-identical to the naive scan by
                # construction, minus the partitions the zone maps and
                # kernels proved irrelevant
                batches = pushed[1]
                pushdown_scan = True
            else:
                if filters and s.allow_filtering:
                    from ..service.metrics import GLOBAL as _SCAN_M
                    _SCAN_M.incr("scan.fallback")
                # full scan: paged, windowed, bounded memory
                # (QueryPagers)
                rows, statics_by_pk, new_paging_state = self._paged_scan(
                    t, cfs, s, params, ck_rel, filters, want_meta,
                    page_size, paging_state)
                if filters and s.allow_filtering:
                    from ..service.metrics import GLOBAL as _SCAN_M
                    _SCAN_M.incr("scan.rows_materialized", len(rows))
                batches = []
                paged = True
                ck_rel, filters = {}, []   # applied inline by the pager
        for _, batch in batches:
            saw_regular = False
            static_d = None
            for r in rows_from_batch(t, batch):
                d = row_to_dict(t, r, with_meta=want_meta)
                if r.is_static:
                    statics_by_pk[r.pk] = d
                    static_d = d
                    continue
                saw_regular = True
                d["__pk"] = r.pk
                rows.append(d)
            if static_d is not None and not saw_regular and not ck_rel:
                # a partition with ONLY static content still produces
                # one CQL row (null clusterings/regulars) — reference
                # SelectStatement static-row semantics; clustering
                # restrictions exclude it. The null columns are
                # populated explicitly so ORDER BY and projections see
                # real keys.
                phantom = dict(static_d)
                for col in t.clustering_columns + t.regular_columns:
                    phantom.setdefault(col.name, None)
                rows.append(phantom)
        if pushdown_scan:
            from ..service.metrics import GLOBAL as _SCAN_M
            _SCAN_M.incr("scan.rows_materialized", len(rows))
        # join static values (and their cell metadata) onto the rows
        # (the pager already joined + filtered + applied ppl inline)
        for d in [] if paged else rows:
            st = statics_by_pk.get(d.pop("__pk", None), None)
            if st:
                for c in t.static_columns:
                    if d.get(c.name) is None:
                        d[c.name] = st.get(c.name)
                        if want_meta and c.name in st.get("__meta__", {}):
                            d.setdefault("__meta__", {})[c.name] = \
                                st["__meta__"][c.name]

        gr = getattr(self.backend, "guardrails", None)
        if gr is not None and batches:
            # tombstone pressure: count death-flagged cells merged for
            # this read (TombstoneOverwhelmingException role)
            from ..storage.cellbatch import DEATH_FLAGS
            dead = int(sum(int(((b.flags & DEATH_FLAGS) != 0).sum())
                           for _, b in batches))
            if dead:
                gr.check_tombstones(dead, t.full_name())

        rows = self._apply_ck_restrictions(t, rows, ck_rel)
        for col, op, v in filters:
            rows = [r for r in rows if self._match(r.get(col.name), op, v)]

        if s.order_by:
            col, desc = s.order_by[0]
            # nulls (static-only phantom rows) group after values
            rows.sort(key=lambda r: (r.get(col) is None, r.get(col)
                                     if r.get(col) is not None else 0),
                      reverse=desc)


        if s.per_partition_limit is not None and not paged:
            limit = int(bind_term(s.per_partition_limit, None, params))
            seen: dict[tuple, int] = {}
            out = []
            for r in rows:
                key = tuple(r[c.name] for c in t.partition_key_columns)
                seen[key] = seen.get(key, 0) + 1
                if seen[key] <= limit:
                    out.append(r)
            rows = out
        rs = self._project_with_limit(t, s, rows, params)
        rs.paging_state = new_paging_state
        if getattr(s, "json", False):
            rs = _jsonify_resultset(rs)
        return rs

    def _project_with_limit(self, t, s, rows, params) -> ResultSet:
        """LIMIT applies to *result* rows: for aggregates / GROUP BY /
        DISTINCT the reference truncates after aggregation and dedup (cql3
        SelectStatement userLimit on the grouped result), never the source
        rows feeding them."""
        limit = int(bind_term(s.limit, None, params)) \
            if s.limit is not None else None
        post = self._limit_after_projection(s, t)
        if limit is not None and not post:
            rows = rows[:limit]
        rs = self._project(t, s, rows)
        if limit is not None and post:
            rs = ResultSet(rs.column_names, rs.rows[:limit])
        return rs

    def _pushdown_limits(self, t, s, params, ck_rel, filters):
        """DataLimits for a single-partition read, or None when pushdown
        is unsafe. Safe only when every fetched row is a result row:
        no clustering restrictions or column filters (applied POST-fetch
        here — a pushed limit would count rows they later drop), no
        ORDER BY re-sort, no aggregation/GROUP BY/DISTINCT. Static
        columns pad the limit by one: the static pseudo-row occupies
        the partition's first row slot at the replica."""
        if ck_rel or filters or s.order_by or \
                self._limit_after_projection(s, t):
            return None
        lim = int(bind_term(s.limit, None, params)) \
            if s.limit is not None else None
        ppl = int(bind_term(s.per_partition_limit, None, params)) \
            if s.per_partition_limit is not None else None
        if lim is None and ppl is None:
            return None
        if (lim is not None and lim <= 0) or \
                (ppl is not None and ppl <= 0):
            # a non-positive limit would make every replica return an
            # empty truncated batch forever — the retry loop could
            # never converge, so don't push
            return None
        from ..storage.cellbatch import DataLimits
        pad = 1 if t.static_columns else 0
        return DataLimits(
            row_limit=None if lim is None else lim + pad,
            per_partition=None if ppl is None else ppl + pad)

    def _limit_after_projection(self, s, t=None) -> bool:
        if getattr(s, "group_by", None) or getattr(s, "distinct", False):
            return True
        agg_fns = {"count", "min", "max", "sum", "avg"}
        for expr, _ in s.selectors:
            if not isinstance(expr, ast.FunctionCall):
                continue
            name = expr.name.lower()
            if name in agg_fns:
                return True
            if t is not None and self.udfs.get_aggregate(
                    t.keyspace, name) is not None:
                return True
        return False

    def _scan_pushdown(self, t, cfs, s, params, ck_rel, filters, now):
        """ALLOW FILTERING fast lane (ops/device_scan.py + the ZMP1
        zone maps): compile the first supported filter to scan-key
        space and ask the store for just the partitions that can
        match, instead of materializing every row of the table. Two
        shapes:
          * aggregate pushdown — a SELECT of builtin aggregates over
            the filtered column (or count(*)) with a single EXACT
            predicate folds entirely on the keys: zero rows
            materialized host-side.
          * row pushdown — candidates come back as (pk, merged batch)
            and ride the generic batches loop, where ck restrictions
            and ALL filters re-verify every row with the exact
            `_match` — bit-identical to the naive scan by
            construction.
        Returns ("agg", ResultSet) | ("batches", [(pk, batch)]) |
        None (unsupported shape: the Python path keeps the wheel)."""
        from ..ops import device_scan as ds
        from ..service.metrics import GLOBAL as _M
        pred = ds.compile_predicate(t, filters)
        if pred is None:
            return None
        spec = self._agg_pushdown_shape(t, s, ck_rel, filters, pred)
        # only a stored cell the predicate cannot key hands the query
        # to the Python path; any other error (a K9 launch, the
        # device) reaches the caller
        if spec is not None:
            try:
                cnt, vmin, vmax, sm, _info = \
                    cfs.scan_filtered_aggregate(pred, now=now)
            except ds.ScanKeyError:
                _M.incr("scan.fallback")
                return None   # fold refused: the Python path answers
            _M.incr("scan.pushdown")
            _M.incr("scan.agg_pushdown")
            if len(spec) == 1 and spec[0][0] == "count":
                # _project's single-count shape: the name is "count"
                # and the argument is ignored — replicated exactly
                return ("agg", ResultSet(["count"], [(cnt,)]))
            names, out = [], []
            for fname, _cname, argnames, alias in spec:
                names.append(
                    alias or f"{fname}({', '.join(map(str, argnames))})")
                if fname == "count":
                    out.append(cnt)
                elif fname == "min":
                    out.append(vmin if cnt else None)
                elif fname == "max":
                    out.append(vmax if cnt else None)
                elif fname == "sum":
                    out.append(sm if cnt else 0)
                else:   # avg — true division, like _project's fold
                    out.append(sm / cnt if cnt else 0)
            return ("agg", ResultSet(names, [tuple(out)]))
        try:
            batches, _info = cfs.scan_filtered(pred, now=now)
        except ds.ScanKeyError:
            _M.incr("scan.fallback")
            return None   # key surprise: results still correct
        _M.incr("scan.pushdown")
        return ("batches", batches)

    def _agg_pushdown_shape(self, t, s, ck_rel, filters, pred):
        """[(fname, cname, argnames, alias)] when the SELECT is a pure
        builtin-aggregate fold the scan keys can answer EXACTLY, else
        None. The conditions mirror _project's aggregate fold: a
        single exact predicate on a regular column, every selector a
        builtin aggregate over that column (count also takes */none),
        no UDA shadowing, no grouping/ordering/limits."""
        if (len(filters) != 1 or ck_rel or not pred.exact
                or pred.is_static
                or getattr(s, "group_by", None)
                or getattr(s, "distinct", False)
                or s.order_by or s.per_partition_limit is not None
                or s.limit is not None):
            return None
        agg_fns = {"count", "min", "max", "sum", "avg"}
        col = pred.col_name
        spec = []
        for expr, alias in s.selectors:
            if not isinstance(expr, ast.FunctionCall):
                return None
            fname = expr.name.lower()
            if self.udfs.get_aggregate(t.keyspace, fname) is not None:
                return None   # UDA shadows the builtin
            if fname not in agg_fns:
                return None
            argnames = []
            for a in expr.args:
                argnames.append(a if isinstance(a, str)
                                else (a.value
                                      if isinstance(a, ast.Literal)
                                      else None))
            cname = argnames[0] if argnames else None
            if fname == "count":
                if cname not in ("*", None, col):
                    return None
            elif cname != col:
                return None
            if fname in ("min", "max") and pred.kind == "f64":
                # a NaN in the fold makes Python's min/max order-
                # dependent; the Python path keeps its own behavior
                return None
            if fname in ("sum", "avg") and not (pred.kind == "i64"
                                                and pred.width <= 4):
                return None   # 64-bit accumulator exactness bound
            spec.append((fname, cname, argnames, alias))
        return spec if spec else None

    def _paged_scan(self, t, cfs, s, params, ck_rel, filters, want_meta,
                    page_size, paging_state):
        """Full-table SELECT through the pager: rows stream window by
        window (bounded memory), restrictions apply inline so page counts
        reflect returned rows, and the result carries a resumable paging
        state when page_size cut the scan short (service/pager/
        PartitionRangeQueryPager role)."""
        from ..storage import paging as paging_mod

        state = paging_mod.PagingState.deserialize(paging_state) \
            if paging_state else None
        if page_size:
            gr = getattr(self.backend, "guardrails", None)
            if gr is not None:
                gr.check_page_size(page_size)
        post_agg = self._limit_after_projection(s, t) or bool(s.order_by)
        if post_agg:
            # aggregates / GROUP BY / DISTINCT / sorted scans consume all
            # windows internally (AggregationQueryPager role) — memory
            # stays window-bounded, the result is small or must be whole
            page_size = None
        limit = int(bind_term(s.limit, None, params)) \
            if s.limit is not None else None
        # the user LIMIT is decremented ACROSS pages via the state (the
        # reference pagers do the same) — a paged LIMIT 10 returns 10
        # rows total, not 10 per page
        if state is not None and state.remaining >= 0:
            limit = state.remaining
        ppl = int(bind_term(s.per_partition_limit, None, params)) \
            if s.per_partition_limit is not None else None

        rows: list[dict] = []
        statics: dict[bytes, dict] = {}
        if state is not None and state.ck:
            # resuming mid-partition: the static row was emitted with an
            # earlier page — rebuild it so static columns still join
            for r in rows_from_batch(t, cfs.read_partition(state.pk)):
                if r.is_static:
                    statics[r.pk] = row_to_dict(t, r, with_meta=want_meta)
                break
        seen_per_pk: dict[bytes, int] = {}
        if state is not None and ppl is not None:
            seen_per_pk[state.pk] = state.ppl_seen
        gr = getattr(self.backend, "guardrails", None)
        dead_total = [0]   # tombstones accumulate over the WHOLE read
        # range-read DataLimits pushdown: only when every fetched row is
        # a result row AND this is a single unpaged pass (paged resumes
        # re-fetch windows from their start, so a truncated window could
        # hide rows a later page needs), AND no statics (a static
        # pseudo-row per partition would pad the limit unboundedly)
        push = None
        if page_size is None and state is None and not ck_rel \
                and not filters and not post_agg and ppl is None \
                and limit is not None and limit > 0 \
                and not t.static_columns:
            from ..storage.cellbatch import DataLimits
            push = DataLimits(row_limit=limit)

        def on_batch(batch):
            if gr is not None:
                from ..storage.cellbatch import DEATH_FLAGS
                dead_total[0] += int(((batch.flags & DEATH_FLAGS) != 0)
                                     .sum())
                if dead_total[0]:
                    gr.check_tombstones(dead_total[0], t.full_name())

        last_row = None
        more = False
        # static-only partition tracking: a partition whose only live
        # content is its static row still yields ONE result row (null
        # clusterings/regulars — reference SelectStatement semantics).
        # Resuming mid-partition counts as already-emitted.
        cur_pk = state.pk if state is not None and state.ck else None
        cur_emitted = cur_pk is not None
        cur_static = None

        def flush_static_only():
            if cur_pk is None or cur_emitted or cur_static is None \
                    or ck_rel:
                return
            if not post_agg and limit is not None \
                    and len(rows) >= limit:
                return
            if page_size is not None and len(rows) + 1 >= page_size:
                # a phantom row must never fill or split a page: the
                # paging position tracks the last REGULAR row, so an
                # emitted phantom past it would duplicate on resume —
                # leave it for the next page's re-scan instead
                return
            d = dict(cur_static)
            for col in t.clustering_columns + t.regular_columns:
                d.setdefault(col.name, None)
            ok = all(self._match(d.get(col.name), op, v)
                     for col, op, v in filters)
            if ok:
                rows.append(d)

        for row in paging_mod.paged_rows(cfs, t, state=state,
                                         on_batch=on_batch, limits=push):
            if row.pk != cur_pk:
                flush_static_only()
                # a flushed phantom can meet the limit exactly — the
                # regular path's append-then-break invariant assumes
                # len(rows) < limit before every append, so re-check
                # here before consuming the next partition
                if not post_agg and limit is not None \
                        and len(rows) >= limit:
                    break
                cur_pk, cur_emitted, cur_static = row.pk, False, None
            if row.is_static:
                sd = row_to_dict(t, row, with_meta=want_meta)
                statics[row.pk] = sd
                cur_static = sd
                continue
            d = row_to_dict(t, row, with_meta=want_meta)
            # join static values BEFORE filtering — a filter on a static
            # column must see the partition's value
            st = statics.get(row.pk)
            if st:
                for c in t.static_columns:
                    if d.get(c.name) is None:
                        d[c.name] = st.get(c.name)
                        if want_meta and c.name in st.get("__meta__", {}):
                            d.setdefault("__meta__", {})[c.name] = \
                                st["__meta__"][c.name]
            ok = True
            for cname, rels in ck_rel.items():
                for op, v in rels:
                    if not self._match(d.get(cname), op, v):
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                for col, op, v in filters:
                    if not self._match(d.get(col.name), op, v):
                        ok = False
                        break
            if not ok:
                continue
            if ppl is not None:
                c = seen_per_pk.get(row.pk, 0) + 1
                seen_per_pk[row.pk] = c
                if c > ppl:
                    continue
            rows.append(d)
            cur_emitted = True
            last_row = row
            if not post_agg and limit is not None and len(rows) >= limit:
                break                         # limit satisfied: no more
            if page_size is not None and len(rows) >= page_size:
                more = True
                break
        else:
            flush_static_only()               # stream ended cleanly
        new_state = None
        if more and last_row is not None:
            rem = (limit - len(rows)) if limit is not None else -1
            new_state = paging_mod.position_of(
                t, last_row, remaining=rem,
                ppl_seen=seen_per_pk.get(last_row.pk, 0)).serialize()
        return rows, statics, new_state

    def _indexed_lookup(self, t, cfs, filters, params):
        """Serve a single-column filter from a secondary index: locators
        from the index, base rows re-read and re-checked (stale-entry
        filtering — index/internal 2i semantics). Equality uses the 2i;
        LIKE uses a SASI text index, with candidates re-verified by the
        case-sensitive predicate."""
        registry = getattr(self.backend, "indexes", None)
        if registry is None or len(filters) != 1:
            return None
        col, op, v = filters[0]
        proxy = getattr(self.backend, "proxy", None)
        distributed = proxy is not None and \
            hasattr(proxy, "index_candidates")
        if op == "LIKE":
            idx = registry.get(t.keyspace, t.name, col.name)
            if idx is None or not hasattr(idx, "search"):
                return None
            # the local search doubles as the servability probe (None =
            # pattern this index type can't serve -> caller falls back)
            locators = idx.search(str(v))
            if locators is None:
                return None
            dist_value = str(v)
        elif op == "=":
            idx = registry.get(t.keyspace, t.name, col.name)
            if idx is None or not hasattr(idx, "lookup"):
                return None
            dist_value = col.cql_type.serialize(v)
            # distributed: the coordinator is one of the queried
            # targets, so a local materialization here would just be
            # recomputed — skip it
            locators = None if distributed else idx.lookup(dist_value)
        else:
            return None
        if distributed:
            # candidate discovery must cover every token range at the
            # read CL, not just this coordinator's local index
            # (ReplicaFilteringProtection union-over-quorum; the
            # re-read + re-check below drops stale matches)
            locators = proxy.index_candidates(
                t.keyspace, t.name, col.name, op, dist_value,
                getattr(self.backend, "default_cl", "ONE"))
        out = []
        for pk, ck in locators:
            batch = cfs.read_partition(pk)
            static_row = None
            hit = None
            for r in rows_from_batch(t, batch):
                if r.is_static:
                    static_row = row_to_dict(t, r)
                elif r.ck_frame == ck:
                    hit = row_to_dict(t, r, with_meta=True)
            cur = None if hit is None else hit.get(col.name)
            keep = (isinstance(cur, str) and _like_match(cur, str(v))) \
                if op == "LIKE" else (cur == v)
            if hit is not None and keep:                   # drop stale
                if static_row:
                    for c in t.static_columns:
                        if hit.get(c.name) is None:
                            hit[c.name] = static_row.get(c.name)
                out.append(hit)
        return out

    def _ann_select(self, t, cfs, s, params):
        """ORDER BY col ANN OF <vector> LIMIT k (SAI vector search)."""
        registry = getattr(self.backend, "indexes", None)
        col_name, term = s.ann
        col = t.columns.get(col_name)
        if col is None:
            raise InvalidRequest(f"unknown column {col_name}")
        idx = registry.get(t.keyspace, t.name, col_name) \
            if registry is not None else None
        if idx is None or not hasattr(idx, "ann"):
            raise InvalidRequest(
                f"ANN requires a vector index on {col_name}")
        import numpy as np
        q = np.asarray(bind_term(term, col.cql_type, params),
                       dtype=np.float32)
        k = int(bind_term(s.limit, None, params)) if s.limit is not None \
            else 10
        proxy = getattr(self.backend, "proxy", None)
        if proxy is not None and hasattr(proxy, "index_candidates"):
            # distributed ANN: per-replica local top-k, global top-k of
            # the union (bigger score = better)
            cands = proxy.index_candidates(
                t.keyspace, t.name, col_name, "ANN",
                (q.tolist(), k), getattr(self.backend, "default_cl", "ONE"))
            cands.sort(key=lambda x: -x[2])
            hits = cands[:k]
        else:
            hits = idx.ann(q, k)
        rows = []
        for pk, ck, score in hits:
            batch = cfs.read_partition(pk)
            for r in rows_from_batch(t, batch):
                if r.ck_frame == ck and not r.is_static:
                    rows.append(row_to_dict(t, r, with_meta=True))
        return self._project(t, s, rows)

    def _apply_ck_restrictions(self, t, rows, ck_rel):
        for cname, rels in ck_rel.items():
            for op, v in rels:
                if op == "IN":
                    rows = [r for r in rows if r[cname] in v]
                else:
                    rows = [r for r in rows
                            if self._match(r.get(cname), op, v)]
        return rows

    @staticmethod
    def _match(cur, op, v) -> bool:
        if op == "LIKE":
            return isinstance(cur, str) and _like_match(cur, v)
        if op == "CONTAINS":
            return cur is not None and v in cur
        if op == "CONTAINS_KEY":
            return isinstance(cur, dict) and v in cur
        if op == "IN":
            return cur in v
        if cur is None:
            return False
        return {"=": cur == v, "!=": cur != v, "<": cur < v,
                "<=": cur <= v, ">": cur > v, ">=": cur >= v}[op]

    def _project(self, t, s, rows) -> ResultSet:
        sel = s.selectors
        group_by = getattr(s, "group_by", [])
        if len(sel) == 1 and isinstance(sel[0][0], ast.FunctionCall) \
                and sel[0][0].name.lower() == "count" and not group_by:
            return ResultSet(["count"], [(len(rows),)])
        if sel and sel[0][0] == "*":
            names = [c.name for c in t.partition_key_columns
                     + t.clustering_columns + t.static_columns
                     + t.regular_columns]
            if group_by:
                # first row of each group (reference GroupMaker behavior)
                seen = {}
                for r in rows:
                    key = tuple(r.get(g) for g in group_by)
                    seen.setdefault(key, r)
                return ResultSet(names,
                                 [tuple(r.get(n) for n in names)
                                  for r in seen.values()])
            if s.distinct:
                names = [c.name for c in t.partition_key_columns]
                seen = []
                for r in rows:
                    key = tuple(r[n] for n in names)
                    if key not in seen:
                        seen.append(key)
                return ResultSet(names, seen)
            return ResultSet(names,
                             [tuple(r.get(n) for n in names) for r in rows])
        names = []
        exprs = []
        for expr, alias in sel:
            if isinstance(expr, ast.FunctionCall):
                fname = expr.name.lower()
                argnames = []
                for a in expr.args:
                    argnames.append(a if isinstance(a, str)
                                    else (a.value
                                          if isinstance(a, ast.Literal)
                                          else None))
                colname = argnames[0] if argnames else None
                names.append(alias or
                             f"{fname}({', '.join(map(str, argnames))})")
                exprs.append((fname, colname, argnames))
            else:
                if expr not in t.columns:
                    raise InvalidRequest(f"unknown column {expr}")
                names.append(alias or expr)
                exprs.append((None, expr, [expr]))
        _now_s = timeutil.now_seconds()   # one 'now' for the whole result
        agg_fns = {"count", "min", "max", "sum", "avg"}

        if s.group_by:
            # GROUP BY over primary-key prefix columns (reference
            # cql3 SelectStatement/GroupMaker semantics): aggregates per
            # group; plain selectors must be grouped columns (their value
            # is constant within a group)
            pk_prefix = [c.name for c in t.partition_key_columns] + \
                [c.name for c in t.clustering_columns]
            for g in s.group_by:
                if g not in pk_prefix:
                    raise InvalidRequest(
                        f"GROUP BY only supports primary key columns "
                        f"({g} is not one)")
            if pk_prefix[:len(s.group_by)] != s.group_by:
                raise InvalidRequest(
                    "GROUP BY columns must form a primary-key prefix")
            for f, cname, _args in exprs:
                if f is None and cname not in s.group_by:
                    raise InvalidRequest(
                        f"selecting {cname} without an aggregate requires "
                        "it in GROUP BY")
            groups: dict = {}
            for r in rows:
                key = tuple(r.get(g) for g in s.group_by)
                groups.setdefault(key, []).append(r)
            out_rows = []
            for key, grp in groups.items():
                row = []
                for f, cname, _args in exprs:
                    if f is None:
                        row.append(grp[0].get(cname))
                        continue
                    vals = [r.get(cname) for r in grp
                            if r.get(cname) is not None]
                    uda = self.udfs.get_aggregate(t.keyspace, f)
                    if uda is not None:
                        row.append(uda.aggregate(self.udfs, vals))
                    elif f == "count":
                        row.append(len(grp) if cname in ("*", None)
                                   else len(vals))
                    elif f == "min":
                        row.append(min(vals) if vals else None)
                    elif f == "max":
                        row.append(max(vals) if vals else None)
                    elif f == "sum":
                        row.append(sum(vals) if vals else 0)
                    elif f == "avg":
                        row.append(sum(vals) / len(vals) if vals else 0)
                    else:
                        raise InvalidRequest(
                            f"{f}() not allowed with GROUP BY")
                out_rows.append(tuple(row))
            return ResultSet(names, out_rows)

        is_uda = lambda f: f is not None \
            and self.udfs.get_aggregate(t.keyspace, f) is not None
        if any(f in agg_fns or is_uda(f) for f, _c, _a in exprs if f):
            out = []
            for f, cname, _args in exprs:
                vals = [r.get(cname) for r in rows
                        if r.get(cname) is not None]
                uda = self.udfs.get_aggregate(t.keyspace, f) if f else None
                if uda is not None:
                    out.append(uda.aggregate(self.udfs, vals))
                elif f == "count":
                    out.append(len(rows) if cname in ("*", None)
                               else len(vals))
                elif f == "min":
                    out.append(min(vals) if vals else None)
                elif f == "max":
                    out.append(max(vals) if vals else None)
                elif f == "sum":
                    out.append(sum(vals) if vals else 0)
                elif f == "avg":
                    out.append(sum(vals) / len(vals) if vals else 0)
                else:
                    raise InvalidRequest(f"unknown aggregate {f}")
            return ResultSet(names, [tuple(out)])
        result_rows = []
        for r in rows:
            row = []
            for f, cname, fargs in exprs:
                if f is not None and f not in ("token", "writetime",
                                               "ttl"):
                    udf = self.udfs.get_function(t.keyspace, f)
                    if udf is None:
                        raise InvalidRequest(f"unknown function {f}")
                    row.append(udf([
                        r.get(a) if isinstance(a, str) and a in t.columns
                        else a for a in fargs]))
                    continue
                if f == "token":
                    from ..utils import murmur3
                    pkb = t.serialize_partition_key(
                        [r[c.name] for c in t.partition_key_columns])
                    from ..utils import partitioners
                    row.append(partitioners.token_of(pkb))
                elif f in ("writetime", "ttl"):
                    meta = r.get("__meta__", {}).get(cname)
                    # a deleted column has null writetime/ttl (the meta of
                    # its tombstone must not leak)
                    if meta is None or r.get(cname) is None:
                        row.append(None)
                    elif f == "writetime":
                        row.append(meta[0])
                    else:
                        _, ttl_s, ldt = meta
                        remaining = ldt - _now_s
                        row.append(remaining if ttl_s and remaining > 0
                                   else None)
                else:
                    row.append(r.get(cname))
            result_rows.append(tuple(row))
        if s.distinct:
            uniq = []
            for row in result_rows:
                if row not in uniq:
                    uniq.append(row)
            result_rows = uniq
        return ResultSet(names, result_rows)
