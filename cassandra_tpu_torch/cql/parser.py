"""Recursive-descent CQL parser.

Reference counterpart: src/antlr/Parser.g (cql3 grammar). Covers the DML
and DDL surface of this round: SELECT / INSERT / UPDATE / DELETE / BATCH /
CREATE (KEYSPACE, TABLE, INDEX, TYPE) / DROP / ALTER TABLE / TRUNCATE /
USE, with USING TTL/TIMESTAMP, IF [NOT] EXISTS, collections, bind markers.
"""
from __future__ import annotations

from . import ast
from .lexer import Token, tokenize


class ParseError(ValueError):
    pass


class Parser:
    def __init__(self, text: str):
        self.toks = tokenize(text)
        self.i = 0
        self.n_markers = 0

    # ------------------------------------------------------------ helpers --

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_kw(self, *words: str) -> str:
        t = self.next()
        if t.kind != "KEYWORD" or t.value not in words:
            raise ParseError(f"expected {'/'.join(words).upper()}, got {t}")
        return t.value

    def accept_kw(self, *words: str) -> str | None:
        t = self.peek()
        if t.kind == "KEYWORD" and t.value in words:
            self.i += 1
            return t.value
        return None

    def expect_op(self, op: str) -> None:
        t = self.next()
        if t.kind != "OP" or t.value != op:
            raise ParseError(f"expected {op!r}, got {t}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "OP" and t.value == op:
            self.i += 1
            return True
        return False

    def accept_ident(self, word: str) -> bool:
        t = self.peek()
        if t.kind == "IDENT" and t.value == word:
            self.i += 1
            return True
        return False

    def ident(self) -> str:
        t = self.next()
        if t.kind == "IDENT":
            return t.value
        if t.kind == "KEYWORD" and t.value in ("key", "type", "timestamp",
                                               "ttl", "list", "index", "role",
                                               "user", "counter", "token",
                                               "options", "custom", "view",
                                               "function", "aggregate",
                                               "returns", "language",
                                               "trigger"):
            return t.value  # unreserved keywords usable as identifiers
        raise ParseError(f"expected identifier, got {t}")

    def qualified_name(self) -> tuple[str | None, str]:
        a = self.ident()
        if self.accept_op("."):
            return a, self.ident()
        return None, a

    # --------------------------------------------------------------- terms --

    def term(self):
        t = self.peek()
        if t.kind == "MARKER":
            self.next()
            m = ast.BindMarker(self.n_markers, t.value)
            self.n_markers += 1
            return m
        if t.kind in ("INT", "FLOAT", "STRING", "UUID", "HEX"):
            self.next()
            return ast.Literal(t.value, t.kind.lower())
        if t.kind == "KEYWORD" and t.value in ("null",):
            self.next()
            return ast.Literal(None, "null")
        if t.kind == "IDENT" and t.value in ("true", "false"):
            self.next()
            return ast.Literal(t.value == "true", "bool")
        if t.kind == "OP" and t.value == "[":
            self.next()
            items = self._term_list("]")
            return ast.CollectionLiteral("list", items)
        if t.kind == "OP" and t.value == "{":
            self.next()
            return self._map_or_set()
        if t.kind == "OP" and t.value == "(":
            self.next()
            items = self._term_list(")")
            return ast.CollectionLiteral("tuple", items)
        if t.kind in ("IDENT", "KEYWORD"):
            name = self.ident()
            if self.accept_op("("):
                args = self._term_list(")")
                return ast.FunctionCall(name, args)
            return ast.Literal(name, "ident")  # e.g. column ref in SET x = y
        raise ParseError(f"unexpected term {t}")

    def _term_list(self, closing: str) -> list:
        items = []
        if self.accept_op(closing):
            return items
        while True:
            items.append(self.term())
            if self.accept_op(closing):
                return items
            self.expect_op(",")

    def _map_value_after_colon(self, first):
        """Parse map pairs where the first key was already consumed. Note:
        ':name' lexes as a named bind marker, which is exactly CQL's
        meaning for an unquoted word in value position."""
        pairs = [(first, self.term())]
        while self.accept_op(","):
            k = self.term()
            if not self.accept_op(":"):
                t = self.peek()
                if t.kind == "MARKER" and t.value is not None:
                    pass  # ':name' marker doubles as ': name'
                else:
                    raise ParseError(f"expected ':' in map literal, got {t}")
            pairs.append((k, self.term()))
        self.expect_op("}")
        return ast.CollectionLiteral("map", pairs)

    def _map_or_set(self):
        if self.accept_op("}"):
            return ast.CollectionLiteral("map", [])  # {} is empty map/set
        first = self.term()
        if self.accept_op(":"):
            return self._map_value_after_colon(first)
        t = self.peek()
        if t.kind == "MARKER" and t.value is not None:
            return self._map_value_after_colon(first)
        items = [first]
        while self.accept_op(","):
            items.append(self.term())
        self.expect_op("}")
        return ast.CollectionLiteral("set", items)

    # ---------------------------------------------------------- statements --

    def parse_statement(self):
        t = self.peek()
        if t.kind != "KEYWORD":
            raise ParseError(f"expected statement, got {t}")
        kw = t.value
        fn = {
            "select": self.select, "insert": self.insert,
            "update": self.update, "delete": self.delete,
            "begin": self.batch, "create": self.create,
            "drop": self.drop, "alter": self.alter,
            "truncate": self.truncate, "use": self.use,
            "grant": self.grant, "revoke": self.grant,
            "list": self.list_stmt, "add": self.add_identity,
        }.get(kw)
        if fn is None:
            raise ParseError(f"unsupported statement {kw.upper()}")
        stmt = fn()
        self.accept_op(";")
        t = self.peek()
        if t.kind != "EOF":
            raise ParseError(f"trailing input at {t}")
        try:
            stmt.n_markers = self.n_markers   # bind-variable count for
        except Exception:                     # prepared-statement metadata
            pass
        return stmt

    # SELECT
    def select(self):
        self.expect_kw("select")
        json = False
        t = self.peek()
        if t.kind == "IDENT" and t.value == "json":
            # 'json' only acts as the modifier when another selector
            # follows — `SELECT json FROM t` must keep reading a column
            # named json (the reference grammar backtracks the same way)
            nxt = self.toks[self.i + 1]
            if not (nxt.kind == "KEYWORD" and nxt.value == "from") \
                    and not (nxt.kind == "OP" and nxt.value in (",", "(")):
                self.next()
                json = True
        distinct = bool(self.accept_kw("distinct"))
        selectors = []
        if self.accept_op("*"):
            selectors.append(("*", None))
        else:
            while True:
                sel = self._selector()
                alias = None
                if self.accept_kw("as"):
                    alias = self.ident()
                selectors.append((sel, alias))
                if not self.accept_op(","):
                    break
        self.expect_kw("from")
        ks, table = self.qualified_name()
        where = []
        if self.accept_kw("where"):
            where = self._relations()
        group_by = []
        if self.accept_ident("group"):
            self.expect_kw("by")
            while True:
                group_by.append(self.ident())
                if not self.accept_op(","):
                    break
        order = []
        ann = None
        if self.accept_kw("order"):
            self.expect_kw("by")
            col = self.ident()
            if self.accept_ident("ann"):
                # SAI vector search: ORDER BY v ANN OF [..] (CEP-30 syntax)
                self.expect_kw("of")
                ann = (col, self.term())
            else:
                while True:
                    desc = False
                    if self.accept_kw("desc"):
                        desc = True
                    else:
                        self.accept_kw("asc")
                    order.append((col, desc))
                    if not self.accept_op(","):
                        break
                    col = self.ident()
        per_partition = None
        limit = None
        if self.accept_kw("per"):
            self.expect_kw("partition")
            self.expect_kw("limit")
            per_partition = self.term()
        if self.accept_kw("limit"):
            limit = self.term()
        allow = False
        if self.accept_kw("allow"):
            self.expect_kw("filtering")
            allow = True
        return ast.SelectStatement(ks, table, selectors, where, order, ann,
                                   group_by, limit, per_partition, allow,
                                   distinct, json)

    def _selector(self):
        t = self.peek()
        if t.kind in ("IDENT", "KEYWORD"):
            name = self.ident()
            if self.accept_op("("):
                if self.accept_op("*"):
                    self.expect_op(")")
                    return ast.FunctionCall(name, ["*"])
                args = self._term_list(")")
                return ast.FunctionCall(name, args)
            return name
        raise ParseError(f"bad selector {t}")

    def _relations(self) -> list:
        rels = []
        while True:
            rels.append(self._relation())
            if not self.accept_kw("and"):
                break
        return rels

    def _relation(self):
        col = self.ident()
        key = None
        if self.accept_op("["):
            key = self.term()
            self.expect_op("]")
        t = self.next()
        if t.kind == "KEYWORD" and t.value == "in":
            self.expect_op("(")
            vals = self._term_list(")")
            return ast.Relation(col, "IN", vals)
        if t.kind == "KEYWORD" and t.value == "like":
            return ast.Relation(col, "LIKE", self.term())
        if t.kind == "KEYWORD" and t.value == "contains":
            if self.accept_kw("key"):
                return ast.Relation(col, "CONTAINS_KEY", self.term())
            return ast.Relation(col, "CONTAINS", self.term())
        if t.kind == "OP" and t.value in ("=", "<", "<=", ">", ">=", "!="):
            r = ast.Relation(col, t.value, self.term())
            if key is not None:
                r = ast.Relation(col, f"[{t.value}]", (key, r.value))
            return r
        raise ParseError(f"bad relation operator {t}")

    # INSERT
    def insert(self):
        self.expect_kw("insert")
        self.expect_kw("into")
        ks, table = self.qualified_name()
        if self.accept_ident("json"):
            payload = self.term()     # string literal or bind marker
            ine = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                ine = True
            ttl, ts = self._using()
            stmt = ast.InsertStatement(ks, table, [], [], ine, ttl, ts)
            stmt.json = True
            stmt.json_payload = payload
            return stmt
        self.expect_op("(")
        cols = []
        while True:
            cols.append(self.ident())
            if self.accept_op(")"):
                break
            self.expect_op(",")
        self.expect_kw("values")
        self.expect_op("(")
        vals = self._term_list(")")
        if len(vals) != len(cols):
            raise ParseError("column/value count mismatch")
        ine = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            ine = True
        ttl, ts = self._using()
        return ast.InsertStatement(ks, table, cols, vals, ine, ttl, ts)

    def _using(self):
        ttl = ts = None
        if self.accept_kw("using"):
            while True:
                w = self.expect_kw("ttl", "timestamp")
                if w == "ttl":
                    ttl = self.term()
                else:
                    ts = self.term()
                if not self.accept_kw("and"):
                    break
        return ttl, ts

    # UPDATE
    def update(self):
        self.expect_kw("update")
        ks, table = self.qualified_name()
        ttl, ts = self._using()
        self.expect_kw("set")
        ops = []
        while True:
            ops.append(self._update_op())
            if not self.accept_op(","):
                break
        self.expect_kw("where")
        where = self._relations()
        if_exists = False
        conditions = []
        if self.accept_kw("if"):
            if self.accept_kw("exists"):
                if_exists = True
            else:
                conditions = self._relations()
        return ast.UpdateStatement(ks, table, ops, where, if_exists,
                                   conditions, ttl, ts)

    def _update_op(self):
        col = self.ident()
        if self.accept_op("["):
            key = self.term()
            self.expect_op("]")
            self.expect_op("=")
            return ast.UpdateOp(col, "put_index", self.term(), key)
        t = self.next()
        if t.kind == "OP" and t.value == "=":
            # col = col + x / col = col - x / col = x + col / col = x
            save = self.i
            first = self.term()
            if isinstance(first, ast.Literal) and first.kind == "ident" \
                    and first.value == col:
                if self.accept_op("+"):
                    return ast.UpdateOp(col, "add", self.term())
                if self.accept_op("-"):
                    return ast.UpdateOp(col, "sub", self.term())
                self.i = save
                first = self.term()
                return ast.UpdateOp(col, "set", first)
            if self.accept_op("+"):
                self.term()  # the column ref on the right: x + col
                return ast.UpdateOp(col, "prepend", first)
            return ast.UpdateOp(col, "set", first)
        if t.kind == "OP" and t.value in ("+=", "-="):
            return ast.UpdateOp(col, "add" if t.value == "+=" else "sub",
                                self.term())
        raise ParseError(f"bad SET op {t}")

    # DELETE
    def delete(self):
        self.expect_kw("delete")
        cols = []
        if not (self.peek().kind == "KEYWORD"
                and self.peek().value == "from"):
            while True:
                name = self.ident()
                if self.accept_op("["):
                    key = self.term()
                    self.expect_op("]")
                    cols.append((name, key))
                else:
                    cols.append(name)
                if not self.accept_op(","):
                    break
        self.expect_kw("from")
        ks, table = self.qualified_name()
        ts = None
        if self.accept_kw("using"):
            self.expect_kw("timestamp")
            ts = self.term()
        self.expect_kw("where")
        where = self._relations()
        if_exists = False
        conditions = []
        if self.accept_kw("if"):
            if self.accept_kw("exists"):
                if_exists = True
            else:
                conditions = self._relations()
        return ast.DeleteStatement(ks, table, cols, where, if_exists,
                                   conditions, ts)

    # BATCH
    def batch(self):
        self.expect_kw("begin")
        kind = self.accept_kw("unlogged", "counter", "logged") or "logged"
        self.expect_kw("batch")
        ttl, ts = self._using()
        stmts = []
        while not (self.peek().kind == "KEYWORD"
                   and self.peek().value == "apply"):
            kw = self.peek().value
            fn = {"insert": self.insert, "update": self.update,
                  "delete": self.delete}.get(kw)
            if fn is None:
                raise ParseError(f"only DML allowed in batch, got {kw}")
            stmts.append(fn())
            self.accept_op(";")
        self.expect_kw("apply")
        self.expect_kw("batch")
        return ast.BatchStatement(kind, stmts, ts)

    # CREATE
    def create(self):
        self.expect_kw("create")
        what = self.next()
        if what.kind == "KEYWORD" and what.value == "keyspace":
            return self._create_keyspace()
        if what.kind == "KEYWORD" and what.value == "table":
            return self._create_table()
        if what.kind == "KEYWORD" and what.value == "index":
            return self._create_index(custom=False)
        if what.kind == "KEYWORD" and what.value == "custom":
            self.expect_kw("index")
            return self._create_index(custom=True)
        if what.kind == "KEYWORD" and what.value == "type":
            return self._create_type()
        if what.kind == "KEYWORD" and what.value in ("role", "user"):
            return self._create_role()
        if what.kind == "KEYWORD" and what.value == "materialized":
            self.expect_kw("view")
            return self._create_view()
        if what.kind == "KEYWORD" and what.value == "or":
            self.expect_kw("replace")
            nxt = self.expect_kw("function", "aggregate")
            if nxt == "function":
                return self._create_function(or_replace=True)
            return self._create_aggregate(or_replace=True)
        if what.kind == "KEYWORD" and what.value == "function":
            return self._create_function()
        if what.kind == "KEYWORD" and what.value == "aggregate":
            return self._create_aggregate()
        if what.kind == "KEYWORD" and what.value == "trigger":
            return self._create_trigger()
        raise ParseError(f"unsupported CREATE {what}")

    def _create_trigger(self):
        # CREATE TRIGGER [IF NOT EXISTS] name ON [ks.]table USING '<src>'
        ine = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            ine = True
        name = self.ident()
        self.expect_kw("on")
        ks, table = self.qualified_name()
        self.expect_kw("using")
        src = self.next()
        if src.kind != "STRING":
            raise ParseError("USING expects a quoted trigger source")
        return ast.CreateTriggerStatement(ks, table, name, src.value,
                                          if_not_exists=ine)

    def _create_function(self, or_replace: bool = False):
        """CREATE [OR REPLACE] FUNCTION [IF NOT EXISTS] name
        (arg type, ...) RETURNS type LANGUAGE <lang> AS '<body>'
        (cql3/functions/UDFunction grammar subset)."""
        ine = self._if_not_exists()
        ks, name = self.qualified_name()
        self.expect_op("(")
        arg_names, arg_types = [], []
        if not self.accept_op(")"):
            while True:
                arg_names.append(self.ident())
                arg_types.append(self._type_string())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        self.expect_kw("returns")
        returns = self._type_string()
        self.expect_kw("language")
        language = self.ident()
        self.expect_kw("as")
        t = self.next()
        if t.kind != "STRING":
            raise ParseError(f"expected function body string, got {t}")
        return ast.CreateFunctionStatement(ks, name, arg_names, arg_types,
                                           returns, language, t.value,
                                           or_replace, ine)

    def _create_aggregate(self, or_replace: bool = False):
        """CREATE [OR REPLACE] AGGREGATE name (type) SFUNC f STYPE t
        [FINALFUNC g] [INITCOND x] (UDAggregate grammar subset)."""
        ks, name = self.qualified_name()
        self.expect_op("(")
        arg_type = self._type_string()
        self.expect_op(")")
        if not self.accept_ident("sfunc"):
            raise ParseError("expected SFUNC")
        sfunc = self.ident()
        if not self.accept_ident("stype"):
            raise ParseError("expected STYPE")
        stype = self._type_string()
        finalfunc = None
        initcond = None
        if self.accept_ident("finalfunc"):
            finalfunc = self.ident()
        if self.accept_ident("initcond"):
            t = self.next()
            if t.kind in ("INT", "FLOAT", "STRING"):
                initcond = t.value
            else:
                raise ParseError(f"bad INITCOND {t}")
        return ast.CreateAggregateStatement(ks, name, arg_type, sfunc,
                                            stype, finalfunc, initcond,
                                            or_replace)

    def _set_literal(self) -> list:
        """{'a', 'b'} — the set form used by ACCESS TO DATACENTERS /
        ACCESS FROM CIDRS role options."""
        self.expect_op("{")
        out: list = []
        if self.accept_op("}"):
            return out
        while True:
            t = self.next()
            if t.kind not in ("STRING", "IDENT"):
                raise ParseError(f"expected set element, got {t}")
            out.append(str(t.value))
            if self.accept_op("}"):
                return out
            self.expect_op(",")

    def _role_options(self):
        """WITH password = '..' AND superuser = true AND
        ACCESS TO DATACENTERS {'dc1'} AND ACCESS FROM CIDRS {'office'}
        (auth/CassandraRoleManager role options + CEP-33 access)."""
        password = None
        superuser = None
        datacenters = None
        cidr_groups = None
        while True:
            if self.accept_ident("access"):
                if self.accept_kw("from"):
                    if not self.accept_ident("cidrs"):
                        raise ParseError("expected CIDRS after ACCESS FROM")
                    cidr_groups = self._set_literal()
                else:
                    if not (self.accept_kw("to") or self.accept_ident("to")):
                        raise ParseError("expected TO or FROM after ACCESS")
                    if self.accept_kw("all") or self.accept_ident("all"):
                        if not self.accept_ident("datacenters"):
                            raise ParseError("expected DATACENTERS")
                        datacenters = []   # clear the restriction
                    else:
                        if not self.accept_ident("datacenters"):
                            raise ParseError("expected DATACENTERS")
                        datacenters = self._set_literal()
            else:
                opt = self.ident()
                self.expect_op("=")
                v = self._option_value()
                if opt == "password":
                    password = str(v)
                elif opt == "superuser":
                    superuser = bool(v)
            if not self.accept_kw("and"):
                break
        return password, superuser, datacenters, cidr_groups

    def _create_role(self):
        ine = self._if_not_exists()
        name = self.ident()
        password = None
        superuser = False
        datacenters = cidr_groups = None
        if self.accept_kw("with"):
            password, superuser, datacenters, cidr_groups = \
                self._role_options()
            superuser = bool(superuser)
        return ast.RoleStatement("create", name, password, superuser, ine,
                                 datacenters=datacenters,
                                 cidr_groups=cidr_groups)

    def _alter_role(self):
        name = self.ident()
        self.expect_kw("with")
        password, superuser, datacenters, cidr_groups = \
            self._role_options()
        return ast.RoleStatement("alter", name, password, superuser,
                                 datacenters=datacenters,
                                 cidr_groups=cidr_groups)

    def add_identity(self):
        """ADD IDENTITY '<identity>' TO ROLE 'r' (mTLS, CEP-34)."""
        self.expect_kw("add")
        if not self.accept_ident("identity"):
            raise ParseError("expected IDENTITY after ADD")
        t = self.next()
        if t.kind != "STRING":
            raise ParseError("expected identity string")
        if not (self.accept_kw("to") or self.accept_ident("to")):
            raise ParseError("expected TO ROLE")
        self.expect_kw("role")
        r = self.next()
        if r.kind not in ("STRING", "IDENT"):
            raise ParseError("expected role name")
        return ast.IdentityStatement("add", str(t.value), str(r.value))

    def grant(self):
        revoke = bool(self.accept_kw("revoke"))
        if not revoke:
            self.expect_kw("grant")
        t = self.next()
        perm = str(t.value).upper()
        if perm == "ALL":
            self.accept_ident("permissions")   # GRANT ALL [PERMISSIONS]
        self.expect_kw("on")
        if self.accept_kw("keyspace"):
            resource = self.ident()
        else:
            # ALL KEYSPACES / TABLE ks.t (table scope maps to its keyspace)
            w = self.next()
            if str(w.value) == "all":
                self.next()   # 'keyspaces'
                resource = "all keyspaces"
            elif str(w.value) == "table":
                ks, tb = self.qualified_name()
                if ks is None:
                    raise ParseError(
                        "GRANT/REVOKE ON TABLE requires a qualified "
                        "ks.table name")
                resource = ks
            else:
                resource = str(w.value)
        self.expect_kw("from" if revoke else "to")
        role = self.ident()
        return ast.GrantStatement(perm, resource, role, revoke)

    def list_stmt(self):
        self.expect_kw("list")
        t = self.next()
        if str(t.value) in ("roles", "users", "role", "user"):
            return ast.ListRolesStatement()
        raise ParseError(f"unsupported LIST {t}")

    def _if_not_exists(self) -> bool:
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            return True
        return False

    def _create_keyspace(self):
        ine = self._if_not_exists()
        name = self.ident()
        replication = {"class": "SimpleStrategy", "replication_factor": 1}
        durable = True
        if self.accept_kw("with"):
            while True:
                opt = self.ident()
                self.expect_op("=")
                val = self._option_value()
                if opt == "replication":
                    replication = val
                elif opt == "durable_writes":
                    durable = bool(val)
                if not self.accept_kw("and"):
                    break
        return ast.CreateKeyspaceStatement(name, replication, durable, ine)

    def _option_value(self):
        t = self.peek()
        if t.kind == "OP" and t.value == "{":
            self.next()
            out = {}
            if self.accept_op("}"):
                return out
            while True:
                k = self.next()
                if k.kind not in ("STRING", "IDENT"):
                    raise ParseError(f"bad option key {k}")
                self._expect_colon_or_marker()
                v = self.next()
                if v.kind not in ("STRING", "INT", "FLOAT", "IDENT"):
                    raise ParseError(f"bad option value {v}")
                out[str(k.value)] = v.value
                if self.accept_op("}"):
                    return out
                self.expect_op(",")
        t = self.next()
        if t.kind in ("STRING", "INT", "FLOAT"):
            return t.value
        if t.kind == "IDENT" and t.value in ("true", "false"):
            return t.value == "true"
        if t.kind in ("IDENT",):
            return t.value
        if t.kind == "UUID":
            # CREATE TABLE ... WITH id = <uuid> (explicit table id)
            return str(t.value)
        raise ParseError(f"bad option value {t}")

    def _expect_colon_or_marker(self):
        # ':' followed by an identifier-like value lexes as MARKER; undo it
        t = self.next()
        if t.kind == "OP" and t.value == ":":
            return
        if t.kind == "MARKER" and t.value is not None:
            # re-inject the marker's name as an IDENT token
            self.toks.insert(self.i, Token("IDENT", t.value, t.pos))
            return
        raise ParseError(f"expected ':', got {t}")

    def _create_table(self):
        ine = self._if_not_exists()
        ks, name = self.qualified_name()
        self.expect_op("(")
        columns = []
        pk: list[str] = []
        ck: list[str] = []
        while True:
            if self.accept_kw("primary"):
                self.expect_kw("key")
                self.expect_op("(")
                if self.accept_op("("):   # composite partition key
                    while True:
                        pk.append(self.ident())
                        if self.accept_op(")"):
                            break
                        self.expect_op(",")
                else:
                    pk.append(self.ident())
                while self.accept_op(","):
                    ck.append(self.ident())
                self.expect_op(")")
            else:
                cname = self.ident()
                ctype = self._type_string()
                static = bool(self.accept_kw("static"))
                inline_pk = False
                if self.accept_kw("primary"):
                    self.expect_kw("key")
                    pk.append(cname)
                    inline_pk = True
                columns.append((cname, ctype, static))
            if self.accept_op(")"):
                break
            self.expect_op(",")
        order = {}
        options = {}
        if self.accept_kw("with"):
            while True:
                if self.accept_ident("clustering"):
                    self.expect_kw("order")
                    self.expect_kw("by")
                    self.expect_op("(")
                    while True:
                        col = self.ident()
                        desc = bool(self.accept_kw("desc"))
                        if not desc:
                            self.accept_kw("asc")
                        order[col] = desc
                        if self.accept_op(")"):
                            break
                        self.expect_op(",")
                else:
                    opt = self.ident()
                    self.expect_op("=")
                    options[opt] = self._option_value()
                if not self.accept_kw("and"):
                    break
        return ast.CreateTableStatement(ks, name, columns, pk, ck, order,
                                        options, ine)

    def _type_string(self) -> str:
        """Consume a type expression, returning its flat string form."""
        t = self.next()
        if t.kind not in ("IDENT", "KEYWORD"):
            raise ParseError(f"expected type, got {t}")
        s = str(t.value)
        if self.accept_op("<"):
            parts = []
            depth = 1
            while depth:
                tt = self.next()
                if tt.kind == "OP" and tt.value == "<":
                    depth += 1
                    parts.append("<")
                elif tt.kind == "OP" and tt.value == ">":
                    depth -= 1
                    if depth:
                        parts.append(">")
                elif tt.kind == "OP" and tt.value == ",":
                    parts.append(", ")
                elif tt.kind in ("IDENT", "KEYWORD", "INT"):
                    parts.append(str(tt.value))
                else:
                    raise ParseError(f"bad type token {tt}")
            s += "<" + "".join(parts) + ">"
        return s

    def _create_view(self):
        """CREATE MATERIALIZED VIEW [IF NOT EXISTS] name AS
        SELECT cols FROM base WHERE <pk IS NOT NULL ...>
        PRIMARY KEY ((..), ..) — cql3/statements/schema/
        CreateViewStatement grammar subset."""
        ine = self._if_not_exists()
        ks, name = self.qualified_name()
        self.expect_kw("as")
        self.expect_kw("select")
        selected = []
        if self.accept_op("*"):
            selected = ["*"]
        else:
            while True:
                selected.append(self.ident())
                if not self.accept_op(","):
                    break
        self.expect_kw("from")
        bks, btable = self.qualified_name()
        if self.accept_kw("where"):
            # the standard guards: <col> IS NOT NULL [AND ...]
            while True:
                self.ident()
                self.expect_kw("is")
                self.expect_kw("not")
                self.expect_kw("null")
                if not self.accept_kw("and"):
                    break
        self.expect_kw("primary")
        self.expect_kw("key")
        pk, ck = self._primary_key_spec()
        return ast.CreateViewStatement(ks, name, bks, btable, selected,
                                       pk, ck, ine)

    def _primary_key_spec(self):
        """((a, b), c, d) or (a, b, c): partition key + clustering."""
        self.expect_op("(")
        pk = []
        if self.accept_op("("):
            while True:
                pk.append(self.ident())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        else:
            pk.append(self.ident())
        ck = []
        while self.accept_op(","):
            ck.append(self.ident())
        self.expect_op(")")
        return pk, ck

    def _create_index(self, custom: bool):
        ine = self._if_not_exists()
        name = None
        if not (self.peek().kind == "KEYWORD"
                and self.peek().value == "on"):
            name = self.ident()
            ine = ine or self._if_not_exists()
        self.expect_kw("on")
        ks, table = self.qualified_name()
        self.expect_op("(")
        col = self.ident()
        self.expect_op(")")
        cls = None
        if custom:
            self.expect_kw("using")
            cls = self.next().value
        opts = {}
        if self.accept_kw("with"):
            self.expect_kw("options")
            self.expect_op("=")
            opts = self._option_value() or {}
        return ast.CreateIndexStatement(name, ks, table, col, cls, ine,
                                        options=opts)

    def _create_type(self):
        ine = self._if_not_exists()
        ks, name = self.qualified_name()
        self.expect_op("(")
        fields = []
        while True:
            fname = self.ident()
            ftype = self._type_string()
            fields.append((fname, ftype))
            if self.accept_op(")"):
                break
            self.expect_op(",")
        return ast.CreateTypeStatement(ks, name, fields, ine)

    # DROP / ALTER / TRUNCATE / USE
    def drop(self):
        self.expect_kw("drop")
        if self.accept_ident("identity"):
            t = self.next()
            if t.kind != "STRING":
                raise ParseError("expected identity string")
            return ast.IdentityStatement("drop", str(t.value), None)
        what = self.next().value
        if what in ("role", "user"):
            ife = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                ife = True
            return ast.RoleStatement("drop", self.ident(),
                                     if_not_exists=ife)
        if what == "materialized":
            self.expect_kw("view")
            what = "view"
        if what == "trigger":
            # DROP TRIGGER [IF EXISTS] name ON [ks.]table
            ife = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                ife = True
            tname = self.ident()
            self.expect_kw("on")
            ks, table = self.qualified_name()
            return ast.DropTriggerStatement(ks, table, tname,
                                            if_exists=ife)
        if what not in ("keyspace", "table", "index", "type", "view",
                        "function", "aggregate"):
            raise ParseError(f"unsupported DROP {what}")
        ife = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            ife = True
        ks, name = self.qualified_name()
        return ast.DropStatement(what, ks, name, ife)

    def alter(self):
        self.expect_kw("alter")
        if self.accept_kw("role") or self.accept_kw("user"):
            return self._alter_role()
        self.expect_kw("table")
        ks, name = self.qualified_name()
        if self.accept_kw("add"):
            cols = []
            paren = self.accept_op("(")
            while True:
                cname = self.ident()
                ctype = self._type_string()
                cols.append((cname, ctype))
                if not self.accept_op(","):
                    break
            if paren:
                self.expect_op(")")
            return ast.AlterTableStatement(ks, name, "add", cols)
        if self.accept_kw("drop"):
            cols = [self.ident()]
            while self.accept_op(","):
                cols.append(self.ident())
            return ast.AlterTableStatement(ks, name, "drop", cols)
        if self.accept_kw("with"):
            options = {}
            while True:
                opt = self.ident()
                self.expect_op("=")
                options[opt] = self._option_value()
                if not self.accept_kw("and"):
                    break
            return ast.AlterTableStatement(ks, name, "with", [], options)
        raise ParseError("unsupported ALTER TABLE action")

    def truncate(self):
        self.expect_kw("truncate")
        self.accept_kw("table")
        ks, table = self.qualified_name()
        return ast.TruncateStatement(ks, table)

    def use(self):
        self.expect_kw("use")
        return ast.UseStatement(self.ident())


def parse(text: str):
    return Parser(text).parse_statement()
