"""knob-wiring: every `mutable=True` knob in config.py must actually be
wired — `nodetool setX` succeeding while nothing re-reads the value is
a silent lie to the operator (the `slow_query_log_timeout` bug class,
once caught by hand).

Wiring evidence, anywhere in cassandra_tpu_torch/ outside config.py:

  * an `on_change("<knob>", ...)` listener registration, or
  * a `.get("<knob>")` settings read, or
  * an attribute re-read site `<something>.<knob>` (the per-use pattern:
    `self.settings.config.read_request_timeout` at request time).

A knob with none of these is reported at its config.py declaration
line; a deliberate exception carries its reason there:

    some_knob: int = mut(0)   # + an allow(knob-wiring) comment w/ reason
"""
from __future__ import annotations

import ast

from ..report import Violation

NAME = "knob-wiring"

CONFIG_MOD = "cassandra_tpu_torch.config"


def mutable_knobs(index, config_mod: str = CONFIG_MOD) -> list[tuple]:
    """[(knob name, line)] for every mutable field of the Config
    dataclass."""
    mod = index.root(config_mod)
    if mod is None:
        return []
    cfg = mod.classes.get("Config")
    if cfg is None:
        return []
    out = []
    for stmt in cfg.node.body:
        if not (isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
                and isinstance(stmt.value, ast.Call)):
            continue
        call = stmt.value
        fname = call.func.id if isinstance(call.func, ast.Name) else None
        mutable = False
        if fname == "mut":
            mutable = True
        elif fname in ("spec", "field"):
            for kw in call.keywords:
                if kw.arg == "mutable" and \
                        isinstance(kw.value, ast.Constant) and \
                        kw.value.value is True:
                    mutable = True
                if kw.arg == "metadata" and \
                        isinstance(kw.value, ast.Dict):
                    for k, v in zip(kw.value.keys, kw.value.values):
                        if isinstance(k, ast.Constant) \
                                and k.value == "mutable" \
                                and isinstance(v, ast.Constant) \
                                and v.value is True:
                            mutable = True
        if mutable:
            out.append((stmt.target.id, stmt.lineno))
    return out


def _wired_names(index, config_mod: str) -> set[str]:
    """Every knob name with wiring evidence outside config.py.

    Evidence = an attribute re-read site (`cfg.<knob>`) or the knob's
    name as a STRING CONSTANT (`on_change("<knob>", ...)`,
    `.get("<knob>")`, name tuples driving listener loops). Knob names
    are long and distinctive, so a stray constant collision is
    unlikely — but `tools/` is excluded: nodetool's settings get/set
    side-doors mention every knob without wiring anything (the
    `slow_query_log_timeout` lesson: only its side-door worked)."""
    wired: set[str] = set()
    for mod in index.modules.values():
        if mod.name == config_mod \
                or mod.name.startswith("cassandra_tpu_torch.tools"):
            continue
        docstrings = {node.value for node in ast.walk(mod.tree)
                      if isinstance(node, ast.Expr)
                      and isinstance(node.value, ast.Constant)}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute):
                wired.add(node.attr)
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and node not in docstrings:
                wired.add(node.value)
    return wired


def run(index, config_mod: str = CONFIG_MOD) -> list[Violation]:
    knobs = mutable_knobs(index, config_mod)
    if not knobs:
        return []
    wired = _wired_names(index, config_mod)
    relpath = index.modules[config_mod].relpath
    out = []
    for name, line in knobs:
        if name not in wired:
            out.append(Violation(
                NAME, relpath, line,
                f"mutable knob `{name}` has no on_change listener, "
                f".get(\"{name}\") read, or attribute re-read site "
                f"anywhere outside config.py — `nodetool set` would "
                f"silently change nothing"))
    return out
