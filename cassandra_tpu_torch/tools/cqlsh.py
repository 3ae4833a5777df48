"""cqlsh: interactive CQL shell.

Reference counterpart: bin/cqlsh.py + pylib/cqlshlib (9.5k LoC of
completion/formatting; this is the working core: statement loop, table
formatting, DESCRIBE, TRACING, COPY, EXIT).
`python -m cassandra_tpu_torch.tools.cqlsh --data <dir> [--device cpu]`
opens the engine in <dir> (its kernels on `cuda` unless `--device` says
otherwise).
"""
from __future__ import annotations

import argparse
import sys


def format_rows(rs, header: bool = True,
                footer_count: int | None = None) -> str:
    """Render a result table. For paged output: header only on the first
    page, footer only on the last (with the TRUE total row count)."""
    names = rs.column_names
    if not names:
        return ""
    rows = [[_fmt(v) for v in r] for r in rs.rows]
    widths = [max(len(n), *(len(r[i]) for r in rows)) if rows else len(n)
              for i, n in enumerate(names)]
    out = ""
    if header:
        head = " | ".join(n.ljust(w) for n, w in zip(names, widths))
        sep = "-+-".join("-" * w for w in widths)
        out = f" {head}\n-{sep}-"
    body = "\n".join(" | ".join(c.rjust(w) for c, w in zip(r, widths))
                     for r in rows)
    if body:
        out += ("\n " if out else " ") + body
    if footer_count is None:
        footer_count = len(rs.rows)
    if footer_count >= 0:
        out += f"\n\n({footer_count} rows)"
    return out


def _fmt(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bytes):
        return "0x" + v.hex()
    if isinstance(v, bool):
        return str(v)
    return str(v)


def describe(session, what: str) -> str:
    schema = session.processor.executor.schema
    what = what.strip().lower()
    if what in ("keyspaces", ""):
        return "\n".join(schema.keyspaces) or "(none)"
    if what == "tables":
        out = []
        for ks in schema.keyspaces.values():
            for t in ks.tables:
                out.append(f"{ks.name}.{t}")
        return "\n".join(out) or "(none)"
    if what.startswith("table "):
        what = what[len("table "):]
    parts = what.strip().split(".")
    if len(parts) == 2:
        ksn, tn = parts
    else:
        ksn, tn = session.keyspace, parts[0]
    t = schema.get_table(ksn, tn)
    cols = []
    for c in t.partition_key_columns:
        cols.append(f"    {c.name} {c.cql_type!r}")
    for c in t.clustering_columns:
        cols.append(f"    {c.name} {c.cql_type!r}")
    for c in t.static_columns:
        cols.append(f"    {c.name} {c.cql_type!r} static")
    for c in t.regular_columns:
        cols.append(f"    {c.name} {c.cql_type!r}")
    pk = ", ".join(c.name for c in t.partition_key_columns)
    if len(t.partition_key_columns) > 1:
        pk = f"({pk})"
    key = ", ".join([pk] + [c.name for c in t.clustering_columns])
    return (f"CREATE TABLE {t.keyspace}.{t.name} (\n"
            + ",\n".join(cols)
            + f",\n    PRIMARY KEY ({key})\n)")


def repl(session, stdin=None, stdout=None):
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    tracing = False
    buf = ""
    prompt = "cqlsh> "

    def emit(s):
        print(s, file=stdout)

    emit("Connected to cassandra_tpu. Type EXIT to quit.")
    while True:
        try:
            stdout.write(prompt if not buf else "   ... ")
            stdout.flush()
            line = stdin.readline()
        except KeyboardInterrupt:
            buf = ""
            continue
        if not line:
            break
        stripped = line.strip()
        if not buf:
            low = stripped.lower().rstrip(";")
            if low in ("exit", "quit"):
                break
            if low.startswith("describe") or low.startswith("desc "):
                try:
                    emit(describe(session,
                                  stripped.rstrip(";").split(None, 1)[1]
                                  if " " in stripped else ""))
                except Exception as e:
                    emit(f"error: {e}")
                continue
            if low.startswith("copy "):
                from . import copyutil
                spec = copyutil.parse_copy(stripped)
                if spec is None:
                    emit("Bad COPY syntax: COPY <table> [(cols)] TO|FROM "
                         "'<file>' [WITH HEADER = true]")
                    continue
                try:
                    if spec["direction"] == "to":
                        n = copyutil.copy_to(session, spec["table"],
                                             spec["columns"], spec["path"],
                                             spec["header"])
                        emit(f"Exported {n} rows to {spec['path']}")
                    else:
                        n = copyutil.copy_from(
                            session, session.processor.executor.schema,
                            session.keyspace, spec["table"],
                            spec["columns"], spec["path"], spec["header"])
                        emit(f"Imported {n} rows from {spec['path']}")
                except Exception as e:
                    emit(f"{type(e).__name__}: {e}")
                continue
            if low == "tracing on":
                tracing = True
                emit("Tracing enabled")
                continue
            if low == "tracing off":
                tracing = False
                emit("Tracing disabled")
                continue
            if not stripped:
                continue
        buf += line
        is_batch = buf.strip().lower().startswith("begin")
        # statements end with ';'; BEGIN BATCH blocks span lines until
        # APPLY BATCH
        if not is_batch and ";" not in buf:
            continue
        if is_batch and "apply batch" not in buf.lower():
            continue
        stmt = buf
        buf = ""
        try:
            # SELECTs page like the reference cqlsh (default 5000 rows a
            # page) — a huge table never materializes client-side at once
            if stmt.strip().lower().startswith("select"):
                rs = session.execute(stmt, trace=tracing, fetch_size=5000)
                # one table across pages: header once, rows streamed,
                # one footer with the true total
                total = len(rs.rows)
                last = rs.paging_state is None
                out = format_rows(rs, header=True,
                                  footer_count=total if last else -1)
                if out:
                    emit(out)
                page = rs
                while page.paging_state is not None:
                    page = session.execute(stmt, fetch_size=5000,
                                           paging_state=page.paging_state)
                    total += len(page.rows)
                    last = page.paging_state is None
                    out = format_rows(page, header=False,
                                      footer_count=total if last else -1)
                    if out:
                        emit(out)
                # rs stays the FIRST page: its trace block prints below
            else:
                rs = session.execute(stmt, trace=tracing)
                out = format_rows(rs)
                if out:
                    emit(out)
            if tracing and hasattr(rs, "trace"):
                emit("\nTracing session: " + str(rs.trace.session_id))
                for us, src, activity in rs.trace.events:
                    emit(f"  {activity} [{src}] -- +{us} us")
        except Exception as e:
            emit(f"{type(e).__name__}: {e}")
    emit("")


def main(argv=None):
    p = argparse.ArgumentParser(prog="cqlsh")
    p.add_argument("--data", required=True)
    p.add_argument("-e", "--execute", help="run one statement and exit")
    p.add_argument("-f", "--file", help="run statements from a file")
    p.add_argument("-u", "--user", help="role name (auth-enabled dirs)")
    p.add_argument("-p", "--password", default="")
    p.add_argument("--device", help="the torch device of the engine's "
                   "kernels (default cuda)")
    args = p.parse_args(argv)

    from ..cql import Session
    from ..schema import Schema
    from ..storage.engine import StorageEngine
    import os as _os
    auth_on = _os.path.exists(_os.path.join(args.data, "system_auth.json"))
    engine = StorageEngine(args.data, Schema(), auth_enabled=auth_on,
                           device=args.device)
    session = Session(engine, user=args.user, password=args.password)
    try:
        if args.execute:
            rs = session.execute(args.execute)
            out = format_rows(rs)
            if out:
                print(out)
        elif args.file:
            with open(args.file) as f:
                for stmt in f.read().split(";"):
                    if stmt.strip():
                        session.execute(stmt)
        else:
            repl(session)
    finally:
        engine.close()


if __name__ == "__main__":
    main()
