"""lock-order: the static lock-acquisition graph must be acyclic.

An edge A→B means "some code path acquires B while holding A": either
syntactic nesting (`with a: ... with b:`) or a call made under A to a
function whose transitive lock closure contains B (the call-graph
approximation in walker.py). A cycle is a potential deadlock — two
threads entering the cycle from different edges can each hold the lock
the other wants.

Lock identity is the declaration site (`module:Class.attr`), merging
instances; the runtime LockWitness (utils/lockwitness.py) covers the
dynamic orders this pass cannot see (callbacks, engine-scoped
registries).

Suppression: a `ctpulint: allow` comment for lock-order on an inner
acquisition line (or the line above) removes the edges CREATED at that
line before cycle detection — so the reason documents why that nesting
is ordered safely.
"""
from __future__ import annotations

from ..report import Violation

NAME = "lock-order"


def _edges(index, suppressed_sites):
    """{(A, B): (relpath, line, via)} — first site wins (stable
    reporting); edges born at an allowlisted site are dropped."""
    closure = index.lock_closure()
    edges: dict = {}

    def add(a, b, rel, line, via):
        if a == b:
            return
        site = suppressed_sites.get((rel, line)) \
            or suppressed_sites.get((rel, line - 1))
        if site is not None:
            site.used = True
            return
        edges.setdefault((a, b), (rel, line, via))

    for fn in index.all_functions():
        rel = fn.module.relpath
        for lid, line, held in fn.acquisitions:
            for h in held:
                add(h, lid, rel, line, f"nested in {fn.qualname}")
        for cs in fn.calls:
            if not cs.held:
                continue
            tgt = index.resolve_call(fn, cs.parts)
            if tgt is None:
                continue
            for inner in closure.get(tgt, ()):
                for h in cs.held:
                    add(h, inner, rel, cs.line,
                        f"{fn.qualname} calls {tgt.qualname}")
    return edges


def _find_cycle(graph, start):
    """One simple cycle through `start`, as a node list, or None."""
    stack = [(start, [start])]
    seen = set()
    while stack:
        node, path = stack.pop()
        for nxt in graph.get(node, ()):
            if nxt == start:
                return path
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def run(index) -> list[Violation]:
    supp = {}
    for s in index.suppressions():
        if s.check == NAME and s.reason:
            supp[(s.path, s.line)] = s
    edges = _edges(index, supp)
    graph: dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)

    out = []
    reported = set()
    for node in sorted(graph, key=str):
        if node in reported:
            continue
        cyc = _find_cycle(graph, node)
        if cyc is None:
            continue
        reported.update(cyc)
        ring = cyc + [cyc[0]]
        legs = []
        anchor = None
        for a, b in zip(ring, ring[1:]):
            rel, line, via = edges[(a, b)]
            if anchor is None:
                anchor = (rel, line)
            legs.append(f"{a} -> {b} at {rel}:{line} ({via})")
        out.append(Violation(
            NAME, anchor[0], anchor[1],
            "lock-order cycle (potential deadlock): "
            + "; ".join(legs)))
    return out
