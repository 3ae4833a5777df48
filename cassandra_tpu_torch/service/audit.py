"""Audit / full query logging.

Reference counterpart: audit/AuditLogManager.java (category-filtered
audit records) + fql/FullQueryLogger.java (every request, replayable).
One JSONL stream covers both roles here: each record carries timestamp,
user, keyspace, statement category and the query string; `categories`
filters like the reference's included_categories.

Enable per engine: StorageEngine(..., audit_log_path=...) or at runtime
via engine.audit_log = AuditLog(path).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time

_PASSWORD_RE = re.compile(r"(password\s*=\s*)'(?:[^']|'')*'", re.I)
# prepared-statement form: the credential arrives as a BIND VALUE
# ("... WITH password = ?"), so scrubbing the statement text alone
# leaks it through the params list — any statement matching this
# pattern gets EVERY bind value redacted (cheap and safe: password-
# bearing statements are DCL, never data-path hot)
_PASSWORD_BIND_RE = re.compile(r"password\s*=\s*(\?|:\w+)", re.I)

CATEGORY_OF = {
    "SelectStatement": "QUERY",
    "InsertStatement": "DML", "UpdateStatement": "DML",
    "DeleteStatement": "DML", "BatchStatement": "DML",
    "TruncateStatement": "DML",
    "CreateKeyspaceStatement": "DDL", "CreateTableStatement": "DDL",
    "CreateIndexStatement": "DDL", "CreateTypeStatement": "DDL",
    "CreateViewStatement": "DDL", "DropStatement": "DDL",
    "AlterTableStatement": "DDL",
    "RoleStatement": "DCL", "GrantStatement": "DCL",
    "ListRolesStatement": "DCL",
    "UseStatement": "OTHER",
}


class AuditLog:
    def __init__(self, path: str, categories: set[str] | None = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.categories = categories    # None = everything (FQL mode)
        self._lock = threading.Lock()
        self._f = open(path, "a")

    def log(self, stmt_type: str, query: str, user: str | None,
            keyspace: str | None, params=None) -> None:
        category = CATEGORY_OF.get(stmt_type, "OTHER")
        if self.categories is not None \
                and category not in self.categories:
            return
        # credentials never reach the log (the reference obfuscates
        # passwords in audit/FQL records)
        query = _PASSWORD_RE.sub(r"\1'***'", query)
        rec = {"ts_ms": int(time.time() * 1000), "category": category,
               "type": stmt_type, "user": user, "keyspace": keyspace,
               "query": query}
        if params:
            if _PASSWORD_BIND_RE.search(query):
                # a prepared EXECUTE carries the credential as a bind
                # value — redact them all, mirroring the text scrub
                rec["params"] = ["***"] * len(params)
            else:
                rec["params"] = [p.hex()
                                 if isinstance(p, (bytes, bytearray))
                                 else repr(p) for p in
                                 (params.values()
                                  if isinstance(params, dict)
                                  else params)]
        line = json.dumps(rec) + "\n"
        from .metrics import GLOBAL
        try:
            with self._lock:
                self._f.write(line)
                self._f.flush()
        except (OSError, ValueError):
            # a wedged/closed log file must be OBSERVABLE, not fatal to
            # the request: audit.dropped vs audit.records is the gap an
            # operator alerts on
            GLOBAL.incr("audit.dropped")
            return
        GLOBAL.incr("audit.records")

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()
