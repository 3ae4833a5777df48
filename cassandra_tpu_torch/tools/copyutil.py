"""cqlsh COPY TO / COPY FROM — CSV import/export.

Reference counterpart: pylib/cqlshlib/copyutil.py (cqlsh's COPY command).
This is the supported migration path from a reference cluster: export
there with its own cqlsh (`COPY ks.t TO 'x.csv'`), import here with
`COPY ks.t FROM 'x.csv'` — data-level interop that works against every
reference version, independent of sstable format internals (see
SURVEY.md "SSTable format scope").

Syntax: COPY <table> [(col, ...)] TO|FROM '<file>' [WITH HEADER = true]
Export pages through the normal query pager (bounded memory).
"""
from __future__ import annotations

import csv
import datetime
import re
import uuid

_COPY_RE = re.compile(
    r"^\s*copy\s+(?P<table>[\w.]+)\s*(?:\((?P<cols>[^)]*)\))?\s*"
    r"(?P<dir>to|from)\s+'(?P<path>[^']+)'\s*"
    r"(?:with\s+(?P<opts>.*?))?\s*;?\s*$", re.I | re.S)


def parse_copy(stmt: str):
    m = _COPY_RE.match(stmt)
    if not m:
        return None
    cols = [c.strip() for c in (m.group("cols") or "").split(",")
            if c.strip()]
    opts = {}
    for part in re.split(r"\s+and\s+", m.group("opts") or "", flags=re.I):
        if "=" in part:
            k, v = part.split("=", 1)
            opts[k.strip().lower()] = v.strip().strip("'\"").lower()
    return {"table": m.group("table"), "columns": cols,
            "direction": m.group("dir").lower(), "path": m.group("path"),
            "header": opts.get("header", "true") in ("true", "1", "yes")}


def _cql_literal(v) -> str:
    """A value as a CQL literal (quoted strings) — collection exports
    must re-parse through the CQL grammar on import."""
    if v is None:
        return "null"
    if isinstance(v, bytes):
        return "0x" + v.hex()
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return "'" + v.replace("'", "''") + "'"
    if isinstance(v, uuid.UUID):
        return str(v)
    if isinstance(v, (datetime.datetime, datetime.date, datetime.time)):
        return "'" + v.isoformat() + "'"
    if isinstance(v, (set, frozenset)):
        return "{" + ", ".join(sorted(_cql_literal(x) for x in v)) + "}"
    if isinstance(v, tuple):
        return "(" + ", ".join(_cql_literal(x) for x in v) + ")"
    if isinstance(v, list):
        return "[" + ", ".join(_cql_literal(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{" + ", ".join(
            f"{_cql_literal(k)}: {_cql_literal(x)}"
            for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))) + "}"
    return str(v)


def _fmt(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bytes):
        return "0x" + v.hex()
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (set, frozenset, list, tuple, dict)):
        return _cql_literal(v)   # CQL literal: round-trips via the parser
    return str(v)


from ..types.textval import parse_text_value as _parse_value  # noqa: E402


def copy_to(session, table_name: str, columns: list[str],
            path: str, header: bool = True, fetch_size: int = 5000) -> int:
    """Paged export; returns rows written."""
    cols = ", ".join(columns) if columns else "*"
    n = 0
    state = None
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        first = True
        while True:
            rs = session.execute(f"SELECT {cols} FROM {table_name}",
                                 fetch_size=fetch_size,
                                 paging_state=state)
            if first and header:
                w.writerow(rs.column_names)
            first = False
            for row in rs.rows:
                w.writerow([_fmt(v) for v in row])
                n += 1
            state = rs.paging_state
            if state is None:
                return n


def copy_from(session, schema, keyspace: str, table_name: str,
              columns: list[str], path: str, header: bool = True) -> int:
    """CSV import, streaming (never materializes the file). Scalar-only
    tables go through ONE prepared statement; tables with collection/
    tuple/UDT/vector columns splice those values as CQL literals (the
    export wrote them in literal syntax) and parse per row. Returns rows
    read."""
    import itertools

    if "." in table_name:
        keyspace, table_name = table_name.split(".", 1)
    t = schema.get_table(keyspace, table_name)
    with open(path, newline="") as f:
        r = csv.reader(f)
        rows = iter(r)
        first = next(rows, None)
        if first is None:
            return 0
        if not columns:
            columns = list(first) if header else \
                [c.name for c in (t.partition_key_columns
                                  + t.clustering_columns
                                  + t.static_columns + t.regular_columns)]
        if not header:
            rows = itertools.chain([first], rows)
        types = [t.columns[c].cql_type for c in columns]
        complex_cols = [getattr(ty, "is_multicell", False)
                        or type(ty).__name__ in ("TupleType", "UserType",
                                                 "VectorType")
                        for ty in types]
        col_list = ", ".join(columns)
        n = 0
        if not any(complex_cols):
            placeholders = ", ".join("?" for _ in columns)
            qid = session.processor.prepare(
                f"INSERT INTO {keyspace}.{table_name} "
                f"({col_list}) VALUES ({placeholders})")
            for row in rows:
                params = tuple(_parse_value(v, ty)
                               for v, ty in zip(row, types))
                session.processor.execute_prepared(
                    qid, params, keyspace, user=session.user)
                n += 1
            return n
        for row in rows:
            vals = []
            for v, ty, cx in zip(row, types, complex_cols):
                if cx:
                    vals.append(v if v else "null")
                else:
                    vals.append(_cql_literal(_parse_value(v, ty)))
            session.execute(
                f"INSERT INTO {keyspace}.{table_name} "
                f"({col_list}) VALUES ({', '.join(vals)})")
            n += 1
        return n
