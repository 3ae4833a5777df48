"""clock-discipline: modules that promise an injectable clock must not
bind the real one.

Two module populations, two rules:

1. MARKED modules — carry `# ctpulint: clock-injectable` and expose a
   clock seam (`clock=` parameter, module-level `CLOCK`). Direct CALLS
   to `time.time/monotonic/perf_counter/time_ns/sleep` are violations:
   they bypass the seam, so tests and the simulator silently get real
   time. References (`clock=time.monotonic` as a default) are the seam
   itself and stay legal. The floor set below MUST be marked — deleting
   a marker is reported, so the discipline cannot rot away.

2. SIM-PATCHED modules — listed in `sim/scheduler.py::_PATCH_MODULES`;
   the simulator swaps their module-level `time`/`threading` attributes
   for virtual ones. Module-attribute calls (`time.monotonic()`) are
   therefore FINE; what breaks determinism is anything that captures
   the real module before patching:

     * `from time import sleep` / `import time as _t` (the patched
       attribute is named `time`; aliases escape), and
     * `time.xxx` as a DEFAULT ARGUMENT value (evaluated at import
       time — the captured function is the real clock forever, even
       under simulation).
"""
from __future__ import annotations

import ast

from ..report import Violation

NAME = "clock-discipline"

MARKER = "clock-injectable"

# modules that must carry the marker (the declared clock-seam surface;
# every one of them is in the tree)
REQUIRED_MARKED = (
    "cassandra_tpu_torch.service.slo",
    "cassandra_tpu_torch.utils.ratelimit",
    "cassandra_tpu_torch.utils.pipeline_ledger",
    "cassandra_tpu_torch.utils.timeutil",
)

CLOCK_FNS = {"time", "monotonic", "perf_counter", "time_ns", "sleep"}

SIM_SCHED_MOD = "cassandra_tpu_torch.sim.scheduler"


def sim_patched_modules(index) -> list[str]:
    """Read _PATCH_MODULES out of sim/scheduler.py's AST so the check
    and the simulator can never disagree about which modules are
    virtual-clock territory."""
    mod = index.root(SIM_SCHED_MOD)
    if mod is None:
        return []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "_PATCH_MODULES" \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            return [e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)]
    return []


def _time_aliases(mod) -> set[str]:
    """Names the module binds to the real `time` module (incl.
    function-level imports — ast.walk sees them)."""
    out = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    out.add(a.asname or "time")
    return out


def _marked_violations(mod) -> list[Violation]:
    aliases = _time_aliases(mod)
    out = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and \
                f.value.id in aliases and f.attr in CLOCK_FNS:
            out.append(Violation(
                NAME, mod.relpath, node.lineno,
                f"direct `{f.value.id}.{f.attr}()` call in a "
                f"clock-injectable module — route it through the "
                f"module's clock seam so tests/sim stay virtual"))
    return out


def _sim_violations(mod) -> list[Violation]:
    out = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module in (
                "time", "threading"):
            out.append(Violation(
                NAME, mod.relpath, node.lineno,
                f"`from {node.module} import ...` in a sim-patched "
                f"module captures the real module — the simulator "
                f"patches the `{node.module}` attribute only; use "
                f"module-level `import {node.module}`"))
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name in ("time", "threading") and a.asname \
                        and a.asname != a.name:
                    out.append(Violation(
                        NAME, mod.relpath, node.lineno,
                        f"`import {a.name} as {a.asname}` in a "
                        f"sim-patched module escapes the simulator's "
                        f"attribute patch (it replaces `{a.name}`, "
                        f"not `{a.asname}`)"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defaults = (node.args.defaults
                        + [d for d in node.args.kw_defaults if d])
            for d in defaults:
                for sub in ast.walk(d):
                    if isinstance(sub, ast.Attribute) and \
                            isinstance(sub.value, ast.Name) and \
                            sub.value.id in ("time", "threading"):
                        out.append(Violation(
                            NAME, mod.relpath, node.lineno,
                            f"default argument `{sub.value.id}."
                            f"{sub.attr}` in sim-patched module is "
                            f"bound at import time, BEFORE the "
                            f"simulator patches the module — default "
                            f"to None and bind inside the function"))
    return out


def run(index) -> list[Violation]:
    out = []
    for name in REQUIRED_MARKED:
        mod = index.root(name)
        if mod is None:
            continue
        if MARKER not in mod.markers:
            out.append(Violation(
                NAME, mod.relpath, 1,
                f"module must declare `# ctpulint: {MARKER}` — it is "
                f"part of the injectable-clock surface (and the "
                f"marker is what activates this check on it)"))
    for mod in index.modules.values():
        if MARKER in mod.markers:
            out.extend(_marked_violations(mod))
    for name in sim_patched_modules(index):
        mod = index.modules.get(name)
        if mod is not None:
            out.extend(_sim_violations(mod))
    return out
