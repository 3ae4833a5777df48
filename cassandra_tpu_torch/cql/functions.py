"""User-defined functions and aggregates.

Reference counterpart: cql3/functions/ (UDFunction.java — sandboxed
java/javascript bodies — and UDAggregate.java). The sandbox problem is
solved differently here: function bodies are written in a deliberately
tiny EXPRESSION language (LANGUAGE expr) evaluated over a strict Python
AST whitelist — arithmetic, comparisons, boolean logic, conditionals and
a fixed builtin set over the declared arguments. No attribute access, no
imports, no subscripts, no statements: the evaluator cannot reach
anything beyond its arguments, which is the property the reference's
sandbox exists to enforce.

    CREATE FUNCTION ks.double_it (x int) RETURNS int
        LANGUAGE expr AS 'x * 2';
    CREATE AGGREGATE ks.my_sum (int) SFUNC plus STYPE int INITCOND 0;
"""
from __future__ import annotations

import ast as py_ast
import operator as _op_mod
from dataclasses import dataclass

_ALLOWED_NODES = (
    py_ast.Expression, py_ast.BinOp, py_ast.UnaryOp, py_ast.BoolOp,
    py_ast.Compare, py_ast.IfExp, py_ast.Call, py_ast.Name,
    py_ast.Constant, py_ast.Load,
    # NOTE: Pow is deliberately absent — '9**9**9**9' would pin the CPU
    # before any result-size check could run (the reference sandbox uses
    # execution timeouts for this; an allowlist without ** is simpler)
    py_ast.Add, py_ast.Sub, py_ast.Mult, py_ast.Div, py_ast.FloorDiv,
    py_ast.Mod, py_ast.USub, py_ast.UAdd, py_ast.Not,
    py_ast.And, py_ast.Or, py_ast.Eq, py_ast.NotEq, py_ast.Lt,
    py_ast.LtE, py_ast.Gt, py_ast.GtE,
)

class FunctionError(ValueError):
    pass


# Result-size cap for any single evaluation step. Without it the
# allowlist still permits unbounded MEMORY amplification ('x * 10**9'
# with a string x allocates gigabytes in one op, before any post-hoc
# check could run), so every BinOp is rewritten to route through
# _guarded_binop which estimates the result size from the operands
# BEFORE executing the op.
_MAX_RESULT_BYTES = 1 << 20


def _approx_size(x) -> int:
    if isinstance(x, (str, bytes, bytearray)):
        return len(x)
    if isinstance(x, (list, tuple)):
        return 16 * len(x)      # per-element slot cost, contents uncounted
    if isinstance(x, int):
        return x.bit_length() >> 3
    return 8


_BINOPS = {
    "Add": _op_mod.add, "Sub": _op_mod.sub, "Mult": _op_mod.mul,
    "Div": _op_mod.truediv, "FloorDiv": _op_mod.floordiv,
    "Mod": _op_mod.mod,
}


def _guarded_binop(op: str, a, b):
    # list/tuple included: row values hand UDFs real Python lists, and
    # list * int amplifies exactly like str * int
    seq = (str, bytes, bytearray, list, tuple)
    if op == "Mult":
        if isinstance(a, int) and isinstance(b, seq):
            est = max(a, 0) * max(_approx_size(b), 1)
        elif isinstance(b, int) and isinstance(a, seq):
            est = max(b, 0) * max(_approx_size(a), 1)
        else:
            est = _approx_size(a) + _approx_size(b)
    elif op == "Mod" and isinstance(a, seq):
        # '%0999999999d' % x pads to a width the operand sizes don't
        # reveal — printf-style formatting is simply not allowed
        raise FunctionError("string formatting (%) not allowed in UDFs")
    else:
        est = _approx_size(a) + _approx_size(b) + 1
    if est > _MAX_RESULT_BYTES:
        raise FunctionError(
            f"expression result too large (~{est} bytes > "
            f"{_MAX_RESULT_BYTES} cap)")
    return _BINOPS[op](a, b)


def _guarded_concat(*xs):
    parts = [str(x) for x in xs]
    if sum(map(len, parts)) > _MAX_RESULT_BYTES:
        raise FunctionError("concat result too large")
    return "".join(parts)


_BUILTINS = {
    "abs": abs, "min": min, "max": max, "len": len, "round": round,
    "int": int, "float": float, "str": str,
    "upper": lambda s: s.upper(), "lower": lambda s: s.lower(),
    "concat": _guarded_concat,
}


class _GuardBinOps(py_ast.NodeTransformer):
    """Rewrite `a <op> b` to `__binop__('<Op>', a, b)` AFTER the
    allowlist check (the injected name never appears in user source)."""

    def visit_BinOp(self, node):
        self.generic_visit(node)
        return py_ast.copy_location(
            py_ast.Call(
                func=py_ast.Name(id="__binop__", ctx=py_ast.Load()),
                args=[py_ast.Constant(type(node.op).__name__),
                      node.left, node.right],
                keywords=[]),
            node)


def compile_expression(body: str, arg_names: list[str]):
    """Parse + whitelist-check the expression once; returns a callable.
    Anything outside the allowlist (attributes, subscripts, lambdas,
    comprehensions, walrus, f-strings, imports...) is rejected at
    CREATE time."""
    if "__binop__" in arg_names:
        raise FunctionError("'__binop__' is a reserved argument name")
    try:
        tree = py_ast.parse(body, mode="eval")
    except SyntaxError as e:
        raise FunctionError(f"bad expression: {e}")
    for node in py_ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise FunctionError(
                f"disallowed construct {type(node).__name__} in function "
                "body (LANGUAGE expr allows arithmetic, comparisons, "
                "boolean logic, conditionals and the builtin set)")
        if isinstance(node, py_ast.Call):
            if not isinstance(node.func, py_ast.Name) \
                    or node.func.id not in _BUILTINS:
                raise FunctionError(
                    f"unknown function call in body "
                    f"(allowed: {sorted(_BUILTINS)})")
            if node.keywords:
                raise FunctionError("keyword arguments not allowed")
        if isinstance(node, py_ast.Name) and node.id not in arg_names \
                and node.id not in _BUILTINS:
            raise FunctionError(f"unknown name {node.id!r} in body")
    tree = py_ast.fix_missing_locations(_GuardBinOps().visit(tree))
    code = compile(tree, "<udf>", "eval")

    def call(args: list):
        scope = dict(_BUILTINS)
        scope.update(zip(arg_names, args))
        # after the args: an argument named __binop__ must not shadow
        # the guard every binary op routes through
        scope["__binop__"] = _guarded_binop
        try:
            return eval(code, {"__builtins__": {}}, scope)
        except FunctionError:
            raise
        except Exception as e:
            raise FunctionError(f"function evaluation failed: {e}")
    return call


@dataclass
class UDF:
    keyspace: str
    name: str
    arg_names: list
    arg_types: list          # type strings (repr of CQLType)
    returns: str
    body: str

    def __post_init__(self):
        self._call = compile_expression(self.body, list(self.arg_names))

    def __call__(self, args: list):
        if any(a is None for a in args):
            return None      # RETURNS NULL ON NULL INPUT semantics
        return self._call(args)


@dataclass
class UDA:
    keyspace: str
    name: str
    arg_type: str
    sfunc: str               # state UDF name: (state, value) -> state
    stype: str
    finalfunc: str | None
    initcond: object

    def aggregate(self, registry, values: list):
        sf = registry.get_function(self.keyspace, self.sfunc)
        if sf is None:
            raise FunctionError(f"unknown SFUNC {self.sfunc}")
        state = self.initcond
        for v in values:
            if v is None:
                continue
            state = sf._call([state, v])
        if self.finalfunc:
            ff = registry.get_function(self.keyspace, self.finalfunc)
            if ff is None:
                raise FunctionError(f"unknown FINALFUNC {self.finalfunc}")
            state = ff._call([state])
        return state


class FunctionRegistry:
    def __init__(self):
        self.functions: dict[tuple, UDF] = {}
        self.aggregates: dict[tuple, UDA] = {}

    def add_function(self, f: UDF, replace: bool = False) -> None:
        key = (f.keyspace, f.name)
        if key in self.functions and not replace:
            raise FunctionError(f"function {f.name} exists")
        self.functions[key] = f

    def add_aggregate(self, a: UDA, replace: bool = False) -> None:
        key = (a.keyspace, a.name)
        if key in self.aggregates and not replace:
            raise FunctionError(f"aggregate {a.name} exists")
        self.aggregates[key] = a

    def get_function(self, keyspace: str, name: str) -> UDF | None:
        return self.functions.get((keyspace, name))

    def get_aggregate(self, keyspace: str, name: str) -> UDA | None:
        return self.aggregates.get((keyspace, name))

    def drop(self, keyspace: str, name: str,
             kind: str | None = None) -> None:
        """kind 'function'/'aggregate' scopes the drop — DROP AGGREGATE
        must never delete a scalar function sharing the name."""
        key = (keyspace, name)
        if kind in (None, "function") and key in self.functions:
            del self.functions[key]
        elif kind in (None, "aggregate") and key in self.aggregates:
            del self.aggregates[key]
        else:
            raise KeyError(name)

    # ------------------------------------------------------------ serde --

    def to_list(self) -> list[dict]:
        out = []
        for f in self.functions.values():
            out.append({"kind": "function", "keyspace": f.keyspace,
                        "name": f.name, "arg_names": list(f.arg_names),
                        "arg_types": list(f.arg_types),
                        "returns": f.returns, "body": f.body})
        for a in self.aggregates.values():
            out.append({"kind": "aggregate", "keyspace": a.keyspace,
                        "name": a.name, "arg_type": a.arg_type,
                        "sfunc": a.sfunc, "stype": a.stype,
                        "finalfunc": a.finalfunc,
                        "initcond": a.initcond})
        return out

    def load_list(self, items: list[dict]) -> None:
        for d in items:
            try:
                if d["kind"] == "function":
                    self.add_function(UDF(
                        d["keyspace"], d["name"], d["arg_names"],
                        d["arg_types"], d["returns"], d["body"]),
                        replace=True)
                else:
                    self.add_aggregate(UDA(
                        d["keyspace"], d["name"], d["arg_type"],
                        d["sfunc"], d["stype"], d.get("finalfunc"),
                        d.get("initcond")), replace=True)
            except FunctionError:
                pass   # a body the current allowlist rejects is dropped
