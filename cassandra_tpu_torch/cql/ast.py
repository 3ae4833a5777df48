"""CQL statement AST (the parser's output; execution in execution.py).

Reference counterpart: cql3/statements/*.Raw classes — parse produces an
unprepared statement; preparation binds it to schema and markers.
"""
from __future__ import annotations

from dataclasses import dataclass, field


# ------------------------------------------------------------------ terms --

@dataclass
class Literal:
    value: object
    kind: str  # int float string bool null uuid hex


@dataclass
class BindMarker:
    index: int
    name: str | None = None


@dataclass
class CollectionLiteral:
    kind: str            # list set map tuple
    items: list          # terms; for map: list of (k, v) term pairs


@dataclass
class FunctionCall:
    name: str
    args: list


Term = object  # Literal | BindMarker | CollectionLiteral | FunctionCall


# -------------------------------------------------------------- relations --

@dataclass
class Relation:
    column: str
    op: str              # = < <= > >= IN CONTAINS CONTAINS_KEY !=
    value: Term          # or list of terms for IN


# ------------------------------------------------------------- statements --

@dataclass
class SelectStatement:
    keyspace: str | None
    table: str
    selectors: list      # list of (expr, alias|None); expr: '*'|name|FunctionCall
    where: list[Relation] = field(default_factory=list)
    order_by: list[tuple[str, bool]] = field(default_factory=list)  # (col, desc)
    ann: tuple | None = None          # (column, query-vector term)
    group_by: list[str] = field(default_factory=list)
    limit: Term | None = None
    per_partition_limit: Term | None = None
    allow_filtering: bool = False
    distinct: bool = False
    json: bool = False


@dataclass
class UpdateOp:
    column: str
    op: str              # set | add | sub | append | prepend | put_index
    value: Term
    key: Term | None = None   # for m[k] = v / l[i] = v


@dataclass
class InsertStatement:
    keyspace: str | None
    table: str
    columns: list[str]
    values: list
    if_not_exists: bool = False
    ttl: Term | None = None
    timestamp: Term | None = None
    json: bool = False


@dataclass
class UpdateStatement:
    keyspace: str | None
    table: str
    ops: list[UpdateOp]
    where: list[Relation]
    if_exists: bool = False
    conditions: list[Relation] = field(default_factory=list)
    ttl: Term | None = None
    timestamp: Term | None = None


@dataclass
class DeleteStatement:
    keyspace: str | None
    table: str
    columns: list        # [] = whole row/partition; items: name or (name, key)
    where: list[Relation] = field(default_factory=list)
    if_exists: bool = False
    conditions: list[Relation] = field(default_factory=list)
    timestamp: Term | None = None


@dataclass
class BatchStatement:
    kind: str            # logged | unlogged | counter
    statements: list
    timestamp: Term | None = None


@dataclass
class CreateKeyspaceStatement:
    name: str
    replication: dict
    durable_writes: bool = True
    if_not_exists: bool = False


@dataclass
class CreateTableStatement:
    keyspace: str | None
    name: str
    columns: list[tuple[str, str, bool]]      # (name, type string, static)
    partition_key: list[str]
    clustering: list[str]
    clustering_order: dict = field(default_factory=dict)  # col -> desc?
    options: dict = field(default_factory=dict)
    if_not_exists: bool = False


@dataclass
class CreateIndexStatement:
    name: str | None
    keyspace: str | None
    table: str
    column: str
    custom_class: str | None = None
    if_not_exists: bool = False
    options: dict = field(default_factory=dict)   # WITH OPTIONS = {...}


@dataclass
class CreateTypeStatement:
    keyspace: str | None
    name: str
    fields: list[tuple[str, str]]
    if_not_exists: bool = False


@dataclass
class CreateViewStatement:
    keyspace: str | None
    name: str
    base_keyspace: str | None
    base_table: str
    selected: list          # column names, or ["*"]
    partition_key: list
    clustering: list
    if_not_exists: bool = False


@dataclass
class CreateFunctionStatement:
    keyspace: str | None
    name: str
    arg_names: list
    arg_types: list
    returns: str
    language: str
    body: str
    or_replace: bool = False
    if_not_exists: bool = False


@dataclass
class CreateAggregateStatement:
    keyspace: str | None
    name: str
    arg_type: str
    sfunc: str
    stype: str
    finalfunc: str | None = None
    initcond: object = None
    or_replace: bool = False


@dataclass
class CreateTriggerStatement:
    keyspace: str | None
    table: str
    name: str
    using: str           # '<file>:<function>' under <data_dir>/triggers
    if_not_exists: bool = False


@dataclass
class DropTriggerStatement:
    keyspace: str | None
    table: str
    name: str
    if_exists: bool = False


@dataclass
class DropStatement:
    what: str            # keyspace | table | index | type
    keyspace: str | None
    name: str
    if_exists: bool = False


@dataclass
class AlterTableStatement:
    keyspace: str | None
    name: str
    action: str          # add | drop | with
    columns: list = field(default_factory=list)   # (name, type) or names
    options: dict = field(default_factory=dict)


@dataclass
class TruncateStatement:
    keyspace: str | None
    table: str


@dataclass
class UseStatement:
    keyspace: str


@dataclass
class RoleStatement:
    action: str          # create | drop | alter
    name: str
    password: str | None = None
    superuser: bool | None = False
    if_not_exists: bool = False
    # CEP-33 access options: None = leave unchanged, [] = unrestricted
    datacenters: list | None = None
    cidr_groups: list | None = None


@dataclass
class IdentityStatement:
    """ADD/DROP IDENTITY — mTLS certificate identity to role mapping
    (auth/MutualTlsAuthenticator, identity_to_role)."""
    action: str          # add | drop
    identity: str
    role: str | None


@dataclass
class GrantStatement:
    permission: str      # SELECT | MODIFY | CREATE | DROP | ALL | ...
    resource: str        # keyspace name or 'all keyspaces'
    role: str
    revoke: bool = False


@dataclass
class ListRolesStatement:
    pass
