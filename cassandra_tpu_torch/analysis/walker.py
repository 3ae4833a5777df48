"""Shared AST module walker + call-graph approximation for ctpulint.

One parse of the project feeds every check: module discovery (the same
"what are the project's modules" answer every tool over the tree
uses), per-function call sites, a name-resolution call graph, lock
acquisition sites, and `# ctpulint:` comment directives.

Approximation contract (documented, deliberate):

  * Call edges are resolved by NAME through a small, conservative rule
    set — `self.m()` to the same class (+ bases found by name),
    `mod.f()` through the module's imports, `obj.m()` through parameter
    annotations and `self.attr = <annotated param | Class()>` attribute
    typing. Dynamic dispatch (callbacks stored in attributes, closures
    handed across threads) is invisible — that half of the story is the
    runtime LockWitness (utils/lockwitness.py).
  * Lock identity is the DECLARATION site (`module:Class.attr` or
    `module:GLOBAL`), merging all instances of a class; per-instance
    hierarchies that intentionally nest same-class locks need an
    allowlist entry (none exist today).
  * Unresolvable calls produce no edge: the checks err toward false
    negatives code review can still catch, never toward a wall of false
    positives that teaches people to ignore the tool.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

from .report import Suppression, parse_suppressions

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# module-level directive comments other than allow(): `# ctpulint: <word>`
_MARKER_RE = re.compile(r"#\s*ctpulint:\s*([a-z][a-z0-9-]*)\s*$")

_LOCK_FACTORIES = {
    # threading primitives
    ("threading", "Lock"): "lock",
    ("threading", "RLock"): "rlock",
    ("threading", "Condition"): "condition",
    ("_real_threading", "Lock"): "lock",
    ("_real_threading", "RLock"): "rlock",
    # lockwitness factories (utils/lockwitness.py)
    ("lockwitness", "make_lock"): "lock",
    ("lockwitness", "make_rlock"): "rlock",
    ("lockwitness", "make_condition"): "condition",
    (None, "make_lock"): "lock",
    (None, "make_rlock"): "rlock",
    (None, "make_condition"): "condition",
}


def project_files(root: str = REPO,
                  tops: tuple = ("cassandra_tpu_torch",),
                  extras: tuple = ("chip_smoke.py", "kernel_ab.py"),
                  exclude: tuple = ()) -> list[str]:
    """The project's .py files — THE module-discovery answer shared by
    every tool that walks the port's tree, so no two tools can
    disagree on what gets scanned."""
    paths = []
    for top in tops:
        base = os.path.join(root, top)
        for dirpath, _dirs, files in os.walk(base):
            for f in sorted(files):
                if f.endswith(".py"):
                    p = os.path.join(dirpath, f)
                    if os.path.relpath(p, root) not in exclude:
                        paths.append(p)
    for extra in extras:
        p = os.path.join(root, extra)
        if os.path.exists(p) and os.path.relpath(p, root) not in exclude:
            paths.append(p)
    return sorted(paths)


def _modname(relpath: str) -> str:
    return relpath[:-3].replace("/", ".") if relpath.endswith(".py") \
        else relpath.replace("/", ".")


def _ann_name(node) -> str | None:
    """Extract a class name from an annotation node: Name, 'quoted'
    string, `X | None`, `Optional[X]`/`list[X]` -> X."""
    if node is None:
        return None
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        # quoted forward ref, possibly itself "X | None"
        return node.value.split("|")[0].strip().strip("'\"") or None
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        left = _ann_name(node.left)
        return left if left not in (None, "None") else _ann_name(node.right)
    if isinstance(node, ast.Subscript):
        # Optional[X] / list[X] / set[X]: the element type is what the
        # for-loop variable or .get() result will be — good enough
        return _ann_name(node.slice)
    return None


def _dotted(node) -> tuple | None:
    """Call target / with-expr as a tuple of name parts:
    self.a.b -> ("self","a","b"); f -> ("f",). None if not a plain
    name/attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


@dataclass(frozen=True)
class LockId:
    module: str        # dotted module name
    owner: str         # class name or "" for module-global
    attr: str          # attribute / global name

    def __str__(self) -> str:
        own = f"{self.owner}." if self.owner else ""
        return f"{self.module}:{own}{self.attr}"


@dataclass(eq=False)
class CallSite:
    parts: tuple       # dotted name parts
    line: int
    held: tuple = ()   # LockIds held (innermost last) at the call


@dataclass(eq=False)
class FunctionInfo:
    module: "ModuleInfo"
    cls: "ClassInfo | None"
    name: str
    node: ast.AST
    calls: list[CallSite] = field(default_factory=list)
    # (lock, line, held-at-acquisition) for every acquisition event
    acquisitions: list[tuple] = field(default_factory=list)
    param_types: dict = field(default_factory=dict)

    @property
    def qualname(self) -> str:
        cls = f"{self.cls.name}." if self.cls else ""
        return f"{self.module.name}:{cls}{self.name}"


@dataclass(eq=False)
class ClassInfo:
    module: "ModuleInfo"
    name: str
    node: ast.ClassDef
    bases: list[str] = field(default_factory=list)
    methods: dict = field(default_factory=dict)
    attr_types: dict = field(default_factory=dict)   # attr -> class name
    lock_attrs: dict = field(default_factory=dict)   # attr -> kind


@dataclass(eq=False)
class ModuleInfo:
    path: str          # absolute or fixture path
    relpath: str       # repo-relative (reported in violations)
    name: str          # dotted module name
    tree: ast.Module
    text: str
    package: str       # dotted parent package
    imports: dict = field(default_factory=dict)      # alias -> module
    from_imports: dict = field(default_factory=dict)  # alias -> (mod, name)
    functions: dict = field(default_factory=dict)    # name -> FunctionInfo
    classes: dict = field(default_factory=dict)      # name -> ClassInfo
    global_locks: dict = field(default_factory=dict)  # name -> kind
    suppressions: list = field(default_factory=list)
    markers: set = field(default_factory=set)

    def marker_lines(self) -> set[str]:
        return self.markers


class ProjectIndex:
    """Parsed project: modules, classes, functions, locks, and the
    resolve()/callees() call-graph approximation every check shares."""

    def __init__(self):
        self.modules: dict[str, ModuleInfo] = {}      # by dotted name
        self.by_relpath: dict[str, ModuleInfo] = {}
        self._closure_cache: dict | None = None
        # roots a check asked for that the tree does not hold: that
        # check's rule did not run on them (see root())
        self.absent_roots: set[str] = set()

    # ------------------------------------------------------------ build --

    @classmethod
    def build(cls, root: str = REPO,
              tops: tuple = ("cassandra_tpu_torch",),
              extras: tuple = ("chip_smoke.py", "kernel_ab.py")
              ) -> "ProjectIndex":
        idx = cls()
        for path in project_files(root, tops=tops, extras=extras):
            rel = os.path.relpath(path, root)
            with open(path, encoding="utf-8") as f:
                idx._add(path, rel, f.read())
        idx._link()
        return idx

    @classmethod
    def from_sources(cls, sources: dict) -> "ProjectIndex":
        """{relpath: source text} — synthetic fixtures for the tests."""
        idx = cls()
        for rel, text in sources.items():
            idx._add(rel, rel, text)
        idx._link()
        return idx

    def root(self, name: str) -> "ModuleInfo | None":
        """The module a check starts from, by dotted name. A root the
        tree does not hold is recorded in absent_roots, so a check whose
        subject is not ported yet says so instead of passing
        silently."""
        mod = self.modules.get(name)
        if mod is None:
            self.absent_roots.add(name)
        return mod

    def _add(self, path: str, rel: str, text: str) -> None:
        tree = ast.parse(text)
        name = _modname(rel)
        package = name.rsplit(".", 1)[0] if "." in name else ""
        if rel.endswith("__init__.py"):
            name = package = _modname(os.path.dirname(rel))
        mod = ModuleInfo(path=path, relpath=rel, name=name, tree=tree,
                         text=text, package=package)
        mod.suppressions = parse_suppressions(rel, text)
        for line in text.splitlines():
            m = _MARKER_RE.search(line)
            if m and m.group(1) != "allow":
                mod.markers.add(m.group(1))
        self.modules[name] = mod
        self.by_relpath[rel] = mod
        _ModuleVisitor(mod).visit(tree)

    def _link(self) -> None:
        """Second pass needing the full module set: resolve imports to
        project modules and collect lock acquisition/call info (which
        needs attribute types of OTHER classes)."""
        for mod in self.modules.values():
            self._resolve_imports(mod)
        for mod in self.modules.values():
            for fn in self._all_functions(mod):
                _BodyVisitor(self, fn).run()
        self._closure_cache = None

    def _resolve_imports(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name.split(".")[0]
                    mod.imports[alias] = a.name
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    pkg_parts = mod.package.split(".") if mod.package else []
                    keep = pkg_parts[:len(pkg_parts) - (node.level - 1)]
                    base = ".".join(keep + ([base] if base else []))
                for a in node.names:
                    alias = a.asname or a.name
                    target = f"{base}.{a.name}" if base else a.name
                    if target in self.modules:
                        # `from x import submod`
                        mod.imports[alias] = target
                    else:
                        mod.from_imports[alias] = (base, a.name)

    def _all_functions(self, mod: ModuleInfo):
        yield from mod.functions.values()
        for ci in mod.classes.values():
            yield from ci.methods.values()

    # ---------------------------------------------------------- resolve --

    def find_class(self, mod: ModuleInfo, name: str) -> ClassInfo | None:
        if name in mod.classes:
            return mod.classes[name]
        fi = mod.from_imports.get(name)
        if fi and fi[0] in self.modules:
            return self.modules[fi[0]].classes.get(fi[1])
        # last resort: unique class of this name anywhere in the project
        hits = [m.classes[name] for m in self.modules.values()
                if name in m.classes]
        return hits[0] if len(hits) == 1 else None

    def _method(self, ci: ClassInfo | None, name: str,
                _depth=0) -> FunctionInfo | None:
        if ci is None or _depth > 4:
            return None
        if name in ci.methods:
            return ci.methods[name]
        for b in ci.bases:
            base = self.find_class(ci.module, b)
            if base is not None and base is not ci:
                m = self._method(base, name, _depth + 1)
                if m is not None:
                    return m
        return None

    def _attr_type(self, ci: ClassInfo | None, attr: str,
                   _depth=0) -> ClassInfo | None:
        if ci is None or _depth > 4:
            return None
        tname = ci.attr_types.get(attr)
        if tname:
            return self.find_class(ci.module, tname)
        for b in ci.bases:
            base = self.find_class(ci.module, b)
            if base is not None and base is not ci:
                t = self._attr_type(base, attr, _depth + 1)
                if t is not None:
                    return t
        return None

    def resolve_call(self, fn: FunctionInfo,
                     parts: tuple) -> FunctionInfo | None:
        """Best-effort resolution of a call site to a project function;
        None when the target is dynamic / stdlib / ambiguous."""
        mod = fn.module
        if len(parts) == 1:
            name = parts[0]
            if name in mod.functions:
                return mod.functions[name]
            ci = mod.classes.get(name) or (
                self.find_class(mod, name)
                if name in mod.from_imports else None)
            if ci is not None:
                return self._method(ci, "__init__")
            fi = mod.from_imports.get(name)
            if fi and fi[0] in self.modules:
                return self.modules[fi[0]].functions.get(fi[1])
            return None
        head, rest = parts[0], parts[1:]
        # module-qualified: mod.f() / mod.Class() (one attribute deep)
        if head in mod.imports and mod.imports[head] in self.modules:
            target = self.modules[mod.imports[head]]
            if len(rest) == 1:
                if rest[0] in target.functions:
                    return target.functions[rest[0]]
                if rest[0] in target.classes:
                    return self._method(target.classes[rest[0]],
                                        "__init__")
            elif len(rest) == 2 and rest[0] in target.classes:
                return self._method(target.classes[rest[0]], rest[1])
            return None
        ci = self._receiver_class(fn, parts[:-1])
        if ci is not None:
            return self._method(ci, parts[-1])
        return None

    def _receiver_class(self, fn: FunctionInfo,
                        recv: tuple) -> ClassInfo | None:
        """Type of a receiver chain like ("self","server") or
        ("conn",)."""
        if not recv:
            return None
        head = recv[0]
        if head == "self":
            ci = fn.cls
            walk = recv[1:]
        else:
            tname = fn.param_types.get(head)
            if tname is None:
                return None
            ci = self.find_class(fn.module, tname)
            walk = recv[1:]
        for attr in walk:
            ci = self._attr_type(ci, attr)
            if ci is None:
                return None
        return ci

    def resolve_lock(self, fn: FunctionInfo,
                     parts: tuple) -> LockId | None:
        """Resolve a with-expr / .acquire() receiver to a lock
        declaration."""
        if len(parts) == 1:
            kind = fn.module.global_locks.get(parts[0])
            if kind:
                return LockId(fn.module.name, "", parts[0])
            fi = fn.module.from_imports.get(parts[0])
            if fi and fi[0] in self.modules \
                    and parts[0] in self.modules[fi[0]].global_locks:
                return LockId(fi[0], "", fi[1])
            # a bare local named like a lock: only if it is a parameter
            # typed to a class with exactly that story — skip
            return None
        ci = self._receiver_class(fn, parts[:-1])
        if ci is None:
            return None
        attr = parts[-1]
        probe = ci
        for _ in range(5):
            if probe is None:
                break
            if attr in probe.lock_attrs:
                return LockId(probe.module.name, probe.name, attr)
            nxt = None
            for b in probe.bases:
                base = self.find_class(probe.module, b)
                if base is not None and attr in base.lock_attrs:
                    nxt = base
                    break
            probe = nxt
        return None

    # ---------------------------------------------------------- closure --

    def all_functions(self):
        for mod in self.modules.values():
            yield from self._all_functions(mod)

    def callees(self, fn: FunctionInfo) -> list:
        out = []
        for cs in fn.calls:
            tgt = self.resolve_call(fn, cs.parts)
            if tgt is not None and tgt is not fn:
                out.append((tgt, cs))
        return out

    def lock_closure(self) -> dict:
        """{FunctionInfo: frozenset(LockId)} — locks a call to the
        function may acquire, transitively (fixpoint over the call
        graph)."""
        if self._closure_cache is not None:
            return self._closure_cache
        fns = list(self.all_functions())
        direct = {fn: {lid for lid, _ln, _held in fn.acquisitions}
                  for fn in fns}
        edges = {fn: [t for t, _cs in self.callees(fn)] for fn in fns}
        closure = {fn: set(direct[fn]) for fn in fns}
        changed = True
        while changed:
            changed = False
            for fn in fns:
                cur = closure[fn]
                before = len(cur)
                for tgt in edges[fn]:
                    cur |= closure.get(tgt, set())
                if len(cur) != before:
                    changed = True
        self._closure_cache = closure
        return closure

    def reachable(self, roots: list) -> dict:
        """BFS over the call graph from `roots`:
        {FunctionInfo: (via FunctionInfo | None, CallSite | None)} —
        the predecessor map lets checks print a call chain."""
        seen = {fn: (None, None) for fn in roots}
        frontier = list(roots)
        while frontier:
            fn = frontier.pop()
            for tgt, cs in self.callees(fn):
                if tgt not in seen:
                    seen[tgt] = (fn, cs)
                    frontier.append(tgt)
        return seen

    def chain(self, reach: dict, fn: FunctionInfo) -> list:
        """Root→fn call chain (qualnames) from a reachable() map."""
        out = []
        cur = fn
        while cur is not None:
            out.append(cur.qualname)
            cur = reach.get(cur, (None, None))[0]
        return list(reversed(out))

    def suppressions(self) -> list[Suppression]:
        out = []
        for mod in self.modules.values():
            out.extend(mod.suppressions)
        return out


class _ModuleVisitor(ast.NodeVisitor):
    """First pass: classes, methods, module functions, lock
    declarations, attribute types."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self._cls: ClassInfo | None = None

    def visit_ClassDef(self, node: ast.ClassDef):
        ci = ClassInfo(self.mod, node.name, node,
                       bases=[b for b in
                              (_ann_name(x) for x in node.bases) if b])
        self.mod.classes[node.name] = ci
        prev, self._cls = self._cls, ci
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(stmt)
            elif isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                t = _ann_name(stmt.annotation)
                if t:
                    ci.attr_types[stmt.target.id] = t
        self._cls = prev

    def visit_FunctionDef(self, node):
        if self._cls is None:
            self._add_function(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def _add_function(self, node) -> None:
        fn = FunctionInfo(self.mod, self._cls, node.name, node)
        for arg in (node.args.posonlyargs + node.args.args
                    + node.args.kwonlyargs):
            t = _ann_name(arg.annotation)
            if t and arg.arg != "self":
                fn.param_types[arg.arg] = t
        if self._cls is not None:
            self._cls.methods[node.name] = fn
            self._harvest_attrs(node)
        else:
            self.mod.functions[node.name] = fn

    def _lock_kind(self, value) -> str | None:
        for call in ast.walk(value):
            if isinstance(call, ast.Call):
                parts = _dotted(call.func)
                if parts is None:
                    continue
                if len(parts) == 2 and (parts[0], parts[1]) \
                        in _LOCK_FACTORIES:
                    return _LOCK_FACTORIES[(parts[0], parts[1])]
                if len(parts) == 1 and (None, parts[0]) \
                        in _LOCK_FACTORIES:
                    return _LOCK_FACTORIES[(None, parts[0])]
        return None

    def _harvest_attrs(self, fnnode) -> None:
        """self.x = <annotated param / Class() / lock factory> inside a
        method body -> attribute type / lock declarations."""
        params = {}
        for arg in (fnnode.args.posonlyargs + fnnode.args.args
                    + fnnode.args.kwonlyargs):
            t = _ann_name(arg.annotation)
            if t:
                params[arg.arg] = t
        for node in ast.walk(fnnode):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                continue
            attr = tgt.attr
            kind = self._lock_kind(node.value)
            if kind:
                self._cls.lock_attrs.setdefault(attr, kind)
                continue
            v = node.value
            if isinstance(v, ast.Name) and v.id in params:
                self._cls.attr_types.setdefault(attr, params[v.id])
            elif isinstance(v, ast.Call):
                parts = _dotted(v.func)
                if parts and parts[-1][:1].isupper():
                    self._cls.attr_types.setdefault(attr, parts[-1])

    def visit_Assign(self, node: ast.Assign):
        if self._cls is None and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            kind = self._lock_kind_top(node.value)
            if kind:
                self.mod.global_locks[node.targets[0].id] = kind
        self.generic_visit(node)

    def _lock_kind_top(self, value) -> str | None:
        if isinstance(value, ast.Call):
            parts = _dotted(value.func)
            if parts:
                if len(parts) == 2 and (parts[0], parts[1]) \
                        in _LOCK_FACTORIES:
                    return _LOCK_FACTORIES[(parts[0], parts[1])]
                if len(parts) == 1 and (None, parts[0]) \
                        in _LOCK_FACTORIES:
                    return _LOCK_FACTORIES[(None, parts[0])]
        return None


class _BodyVisitor:
    """Second pass, per function: call sites + lock acquisitions with
    the held-stack context (syntactic `with` nesting)."""

    def __init__(self, idx: ProjectIndex, fn: FunctionInfo):
        self.idx = idx
        self.fn = fn
        self.held: list = []    # LockIds, outermost first

    def run(self) -> None:
        for stmt in self.fn.node.body:
            self._stmt(stmt)

    def _stmt(self, node) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return   # nested defs: no implicit edge (see module doc)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in node.items:
                self._exprs(item.context_expr)
                parts = _dotted(item.context_expr)
                lid = self.idx.resolve_lock(self.fn, parts) \
                    if parts else None
                if lid is not None:
                    self.fn.acquisitions.append(
                        (lid, node.lineno, tuple(self.held)))
                    self.held.append(lid)
                    pushed += 1
            for inner in node.body:
                self._stmt(inner)
            for _ in range(pushed):
                self.held.pop()
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._exprs(child)
            elif isinstance(child, ast.stmt):
                self._stmt(child)
            else:
                # handlers, withitems inside other stmts, etc.
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, ast.stmt):
                        self._stmt(sub)
                    elif isinstance(sub, ast.expr):
                        self._exprs(sub)

    def _exprs(self, node) -> None:
        for call in [n for n in ast.walk(node)
                     if isinstance(n, ast.Call)]:
            parts = _dotted(call.func)
            if parts is None:
                continue
            self.fn.calls.append(
                CallSite(parts, call.lineno, tuple(self.held)))
            # lock.acquire() outside a with-statement is an acquisition
            # event too (edge source only at this instant — the walker
            # does not model its scope)
            if parts[-1] == "acquire" and len(parts) >= 2:
                lid = self.idx.resolve_lock(self.fn, parts[:-1])
                if lid is not None:
                    self.fn.acquisitions.append(
                        (lid, call.lineno, tuple(self.held)))
