"""ctpulint check registry. Each check is `run(index) -> [Violation]`;
the entry point (`analysis/__main__.py`) owns suppression filtering and
exit-code policy."""
from . import (clock_discipline, knob_wiring, lock_order, loop_blocking,
               worker_loops)

# name -> (module, one-line description printed by --list / docs)
CHECKS = {
    "lock-order": (
        lock_order,
        "static lock-acquisition graph across the call graph must be "
        "acyclic"),
    "loop-blocking": (
        loop_blocking,
        "no fsync/sleep/wait/join reachable from transport event-loop "
        "callbacks or under the gossip lock"),
    "knob-wiring": (
        knob_wiring,
        "every mutable=True config knob has an on_change listener or a "
        "per-use re-read site"),
    "worker-loops": (
        worker_loops,
        "daemon worker loops are guarded so an exception cannot kill "
        "them silently"),
    "clock-discipline": (
        clock_discipline,
        "clock-injectable / sim-patched modules never bind the real "
        "clock"),
}


def run_all(index, names=None):
    out = []
    for name, (mod, _desc) in CHECKS.items():
        if names is None or name in names:
            out.extend(mod.run(index))
    return out
