"""loop-blocking: nothing blocking may be reachable from the transport
event loop's selector callbacks, nor from code running under the gossip
lock.

The event-loop threads (`transport/server.py::_EventLoop.run`) own
every connection assigned to them: one blocking call stalls ALL of that
loop's clients (and a blocked gossip lock stalls liveness for the whole
node). Queries don't run on the loop — the bounded dispatch executor
does — so the loop-reachable closure must stay free of:

    os.fsync / os.fdatasync      durability waits
    time.sleep                   (and sim-patched module-attr sleeps)
    <x>.wait() / .wait_for()     condition/event/process waits
    <thread-ish>.join()          thread & pool joins
    <sock>.sendall()             blocking socket writes
    <queue>.get()                blocking queue takes (argless)

Roots:
  * `_EventLoop.run` in cassandra_tpu_torch/transport/server.py — everything
    the selector thread runs inline.
  * every call made while holding the Gossiper lock
    (cassandra_tpu_torch/cluster/gossip.py) — gossip handlers run on the
    messaging dispatch path and the lock guards liveness.

Reachability is the walker's name-resolution call graph: dynamic
callbacks escape it (that is the LockWitness's domain); unresolvable
calls make the check err quiet, not noisy.
"""
from __future__ import annotations

import ast
import re

from ..report import Violation

NAME = "loop-blocking"

SERVER_MOD = "cassandra_tpu_torch.transport.server"
GOSSIP_MOD = "cassandra_tpu_torch.cluster.gossip"

_THREADISH = re.compile(
    r"(thread|worker|loop|pool|proc|syncer|executor)", re.I)
_WAIT_ATTRS = {"wait", "wait_for"}
_FSYNC = {("os", "fsync"), ("os", "fdatasync")}


def _blocking(call_parts: tuple, call_node: ast.Call | None) -> str | None:
    """Why this dotted call is blocking, or None."""
    tail = call_parts[-1]
    if len(call_parts) >= 2 and (call_parts[-2], tail) in _FSYNC:
        return "fsync"
    if tail == "fsync" or tail == "fdatasync":
        return "fsync"
    if tail == "sleep" and (len(call_parts) == 1
                            or call_parts[-2] in ("time", "_time")):
        return "sleep"
    if tail in _WAIT_ATTRS and len(call_parts) >= 2:
        return "condition/event wait"
    if tail == "join" and len(call_parts) >= 2 \
            and _THREADISH.search(call_parts[-2]):
        return "thread join"
    if tail == "sendall":
        return "blocking socket sendall"
    if tail == "get" and len(call_parts) >= 2 \
            and "queue" in call_parts[-2].lower() \
            and call_node is not None and not call_node.args \
            and not call_node.keywords:
        return "blocking queue get"
    return None


def _blocking_sites(fn):
    """[(line, why, parts)] direct blocking calls in fn. Re-walks the
    AST for the argless-queue-get rule (CallSites don't carry args)."""
    node_by_line = {}
    for n in ast.walk(fn.node):
        if isinstance(n, ast.Call):
            node_by_line.setdefault(n.lineno, n)
    out = []
    for cs in fn.calls:
        why = _blocking(cs.parts, node_by_line.get(cs.line))
        if why:
            out.append((cs.line, why, ".".join(cs.parts)))
    return out


def run(index) -> list[Violation]:
    out = []
    seen = set()

    def report(reach, ctx):
        for fn in reach:
            for line, why, dotted in _blocking_sites(fn):
                key = (fn.module.relpath, line)
                if key in seen:
                    continue
                seen.add(key)
                chain = " -> ".join(index.chain(reach, fn))
                out.append(Violation(
                    NAME, fn.module.relpath, line,
                    f"{why} (`{dotted}`) reachable from {ctx} via "
                    f"{chain}"))

    server = index.root(SERVER_MOD)
    if server is not None:
        loop_cls = server.classes.get("_EventLoop")
        run_fn = loop_cls.methods.get("run") if loop_cls else None
        if run_fn is not None:
            report(index.reachable([run_fn]),
                   "the transport event loop")

    gossip = index.root(GOSSIP_MOD)
    if gossip is not None:
        gossip_roots = []
        for ci in gossip.classes.values():
            for fn in ci.methods.values():
                for cs in fn.calls:
                    if not any(h.module == GOSSIP_MOD for h in cs.held):
                        continue
                    # the blocking primitive may BE the held call
                    why = _blocking(cs.parts, None)
                    if why:
                        key = (fn.module.relpath, cs.line)
                        if key not in seen:
                            seen.add(key)
                            out.append(Violation(
                                NAME, fn.module.relpath, cs.line,
                                f"{why} (`{'.'.join(cs.parts)}`) while "
                                f"holding the gossip lock in "
                                f"{fn.qualname}"))
                        continue
                    tgt = index.resolve_call(fn, cs.parts)
                    if tgt is not None:
                        gossip_roots.append(tgt)
        if gossip_roots:
            report(index.reachable(gossip_roots),
                   "code holding the gossip lock")
    return out
