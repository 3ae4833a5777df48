"""worker-loops: a daemon worker loop must not be killable by one
exception.

The bug class: `_sync_loop` and dispatch workers are
`while True:` bodies on daemon threads — an uncaught exception ends the
thread SILENTLY (daemon threads print nothing on the way out), and the
subsystem it powered (commitlog durability, the whole front door)
wedges later, far from the cause.

Rule: in every function used as a `threading.Thread(..., daemon=True)`
target (or the `run` method of a Thread subclass), each `while` loop's
body must consist of statements that are either

  * inside a `try` with a broad handler (`except`/`except Exception`/
    `except BaseException`) that does not just re-raise — the loop
    itself may also sit inside such a try: exiting into an error
    funnel is loud, not silent — or
  * of provably-boring shape: assignments/expressions whose only calls
    are queue/event/clock/ledger/container primitives (SAFE_CALLS
    below) or sibling nested functions that are themselves fully
    guarded, `if`/`while`/`for`/`with` recursing the same rule,
    `pass`/`break`/`continue`/`return`.

Anything else can raise past the loop and is reported at its line.
Loops that EXIT on exception deliberately carry an allow naming the
error funnel that hears about it.
"""
from __future__ import annotations

import ast

from ..report import Violation

NAME = "worker-loops"

# calls that cannot realistically raise out of a healthy loop body:
# queue/deque/set ops, event flags, injected clocks, pipeline-ledger
# accounting (two float adds under a lock), selector/socket polls,
# builtins
SAFE_CALLS = frozenset({
    "get", "get_nowait", "put", "put_nowait", "popleft", "pop",
    "append", "appendleft", "task_done", "qsize", "empty",
    "remove", "discard", "add",
    "is_set", "set", "clear", "wait",
    "monotonic", "perf_counter", "time", "sleep",
    "acquire", "release", "locked",
    "add_idle", "add_busy", "add_stall", "add_items", "note_queue",
    "idle", "busy", "stall",
    "select", "accept",
    "len", "min", "max", "int", "float", "str", "list", "tuple",
    "dict", "isinstance", "getattr", "id", "repr", "range", "any",
    "all", "sorted", "sum", "enumerate", "zip",
    "items", "values", "keys",
})


def _broad_guard(try_node: ast.Try) -> bool:
    """True iff some handler catches Exception/BaseException (or is
    bare) and does more than unconditionally re-raise."""
    for h in try_node.handlers:
        names = set()
        if h.type is None:
            names.add("Exception")
        elif isinstance(h.type, ast.Name):
            names.add(h.type.id)
        elif isinstance(h.type, ast.Tuple):
            names.update(e.id for e in h.type.elts
                         if isinstance(e, ast.Name))
        if not names & {"Exception", "BaseException"}:
            continue
        if all(isinstance(s, ast.Raise) and s.exc is None
               for s in h.body):
            continue   # `except Exception: raise` is not a guard
        return True
    return False


def _safe_expr(node, nested, seen) -> bool:
    for call in (n for n in ast.walk(node) if isinstance(n, ast.Call)):
        f = call.func
        tail = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if tail in SAFE_CALLS:
            continue
        # a sibling nested function or same-class `self.` method whose
        # own body is fully guarded (the run_shard / _run_one pattern:
        # it traps BaseException into an error channel) is safe to call
        callee = None
        if isinstance(f, ast.Name):
            callee = f.id
        elif isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and f.value.id == "self":
            callee = f.attr
        if callee is not None and callee in nested \
                and callee not in seen \
                and not _unguarded(nested[callee].body, nested,
                                   seen | {callee}):
            continue
        return False
    return True


def _unguarded(stmts, nested, seen=frozenset()) -> list:
    """Statements (recursively) that can raise out of the loop."""
    bad = []
    for s in stmts:
        if isinstance(s, ast.Try):
            if _broad_guard(s):
                # trust a broad-guarded try entirely: the bug class is
                # uncaught MAIN-BODY exceptions; a raising
                # handler is second-order and auditing it here would
                # drown the signal
                continue
            bad.extend(_unguarded(s.body, nested, seen))
            for h in s.handlers:
                bad.extend(_unguarded(h.body, nested, seen))
            bad.extend(_unguarded(s.orelse, nested, seen))
            bad.extend(_unguarded(s.finalbody, nested, seen))
        elif isinstance(s, (ast.Pass, ast.Break, ast.Continue,
                            ast.Global, ast.Nonlocal)):
            continue
        elif isinstance(s, ast.Return):
            if s.value is not None and not _safe_expr(s.value, nested,
                                                      seen):
                bad.append(s)
        elif isinstance(s, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                            ast.Expr, ast.Delete)):
            if not _safe_expr(s, nested, seen):
                bad.append(s)
        elif isinstance(s, ast.If):
            if not _safe_expr(s.test, nested, seen):
                bad.append(s)
            bad.extend(_unguarded(s.body, nested, seen))
            bad.extend(_unguarded(s.orelse, nested, seen))
        elif isinstance(s, ast.While):
            if not _safe_expr(s.test, nested, seen):
                bad.append(s)
            bad.extend(_unguarded(s.body, nested, seen))
            bad.extend(_unguarded(s.orelse, nested, seen))
        elif isinstance(s, ast.For):
            if not _safe_expr(s.iter, nested, seen):
                bad.append(s)
            bad.extend(_unguarded(s.body, nested, seen))
            bad.extend(_unguarded(s.orelse, nested, seen))
        elif isinstance(s, ast.With):
            if not all(_safe_expr(i.context_expr, nested, seen) or
                       isinstance(i.context_expr, (ast.Attribute,
                                                   ast.Name))
                       for i in s.items):
                bad.append(s)
            bad.extend(_unguarded(s.body, nested, seen))
        else:
            bad.append(s)   # raise, assert, match, import, ...
    return bad


def _covered_whiles(fnnode) -> set:
    """While nodes sitting inside a broad-guarded try: the loop can die
    but NOT silently — the handler is the error funnel."""
    covered = set()
    for n in ast.walk(fnnode):
        if isinstance(n, ast.Try) and _broad_guard(n):
            for sub in n.body:
                covered.update(w for w in ast.walk(sub)
                               if isinstance(w, ast.While))
    return covered


def _siblings(index, fn_cls, node):
    """Callable-by-name helpers visible from the worker body: its own
    nested defs + same-class methods (for the `self.m()` rule)."""
    out = {}
    if fn_cls is not None:
        out.update({name: m.node for name, m in fn_cls.methods.items()})
    out.update({n.name: n for n in ast.walk(node)
                if isinstance(n, ast.FunctionDef) and n is not node})
    return out


def _spawn_targets(index):
    """Yield (worker ast node, qualname, module, class, extra
    siblings) for every daemon Thread target resolvable statically —
    including nested `def`s used as targets inside the spawning
    function (whose SIBLING nested defs, like run_shard next to
    work_loop, stay callable by name) — plus `run` methods of Thread
    subclasses."""
    for fn in index.all_functions():
        nested = {n.name: n for n in ast.walk(fn.node)
                  if isinstance(n, ast.FunctionDef) and n is not fn.node}
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            tail = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else None)
            if tail != "Thread":
                continue
            kw = {k.arg: k.value for k in node.keywords}
            d = kw.get("daemon")
            if not (isinstance(d, ast.Constant) and d.value is True):
                continue
            tgt = kw.get("target")
            if tgt is None:
                continue
            if isinstance(tgt, ast.Attribute) and \
                    isinstance(tgt.value, ast.Name) and \
                    tgt.value.id == "self" and fn.cls is not None:
                m = index._method(fn.cls, tgt.attr)
                if m is not None:
                    yield (m.node, m.qualname, m.module, m.cls, {})
            elif isinstance(tgt, ast.Name):
                if tgt.id in nested:
                    yield (nested[tgt.id],
                           f"{fn.qualname}.<locals>.{tgt.id}",
                           fn.module, fn.cls, nested)
                elif tgt.id in fn.module.functions:
                    m = fn.module.functions[tgt.id]
                    yield (m.node, m.qualname, m.module, None, {})
    for mod in index.modules.values():
        for ci in mod.classes.values():
            if any(b == "Thread" for b in ci.bases) and \
                    "run" in ci.methods:
                m = ci.methods["run"]
                yield (m.node, m.qualname, m.module, ci, {})


def run(index) -> list[Violation]:
    out = []
    seen = set()
    for node, qualname, mod, cls, extra in _spawn_targets(index):
        if (mod.relpath, node.lineno) in seen:
            continue
        seen.add((mod.relpath, node.lineno))
        nested = dict(extra)
        nested.update(_siblings(index, cls, node))
        covered = _covered_whiles(node)
        for loop in (n for n in ast.walk(node)
                     if isinstance(n, ast.While) and n not in covered):
            bad = _unguarded(loop.body, nested)
            if not bad:
                continue
            first = min(bad, key=lambda s: s.lineno)
            out.append(Violation(
                NAME, mod.relpath, loop.lineno,
                f"daemon worker loop in {qualname} can die silently: "
                f"statement at line {first.lineno} (+{len(bad) - 1} "
                f"more) can raise past the loop — wrap the body in a "
                f"broad try/except or allowlist with the error-funnel "
                f"reason"))
    return out
