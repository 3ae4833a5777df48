"""CI check (tier-2): the continuous profiler — wall-clock sampler +
device-program registry (docs/observability.md layer 6).

Leg 1 (zero-cost-off + knob lifecycle): an engine with the profiler
knob at its default (off) must leave NO `wall-profiler` thread in the
process; flipping `profiler_enabled` live must start it, flipping it
back must park it, and `engine.close()` must withdraw the engine's
demand (the sampler is process-global — the demand pattern, same as
the diagnostic bus).

Leg 2 (flamegraph round-trip): a profiled session over a known
workload — one spinning thread, one parked on an Event — must produce
a collapsed-stack dump whose `parse_collapsed` totals equal the
session's split() (same aggregate, two encodings), classify the
spinner on-CPU and the parked thread blocked, and surface the same
stacks through `system_views.profiles` and `nodetool profiler dump`.

Leg 3 (retrace sentinel under forced shape churn): with
`profiler_retrace_budget` set low and the diagnostic bus on, a device
program dispatched across more distinct operand shapes than the budget
must increment `profile.retraces` per recompile past the budget,
publish exactly ONE `profile.retrace` diagnostic event for the
program (the sentinel is once-per-program until reset), expose the
count through `system_views.device_programs`, and land a `profile`
section in an on-demand flight-recorder bundle naming the program.

The engines run on `device` (`cuda` by default, which raises without
a card; `cpu` runs the kernels' plain PyTorch versions), and the
sentinel's probe is a plain torch function on that device, wrapped by
the device-program registry as the port's kernels are.

    python -m cassandra_tpu_torch.scripts.check_profiler [--device cpu]

Exit 0 = clean; exit 1 prints each violation.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time


def _build(base_dir: str, overrides: dict, device=None):
    from cassandra_tpu_torch.config import Config, Settings
    from cassandra_tpu_torch.schema import Schema, make_table
    from cassandra_tpu_torch.storage.engine import StorageEngine
    schema = Schema()
    schema.create_keyspace("prof")
    t = make_table("prof", "t", pk=["id"], ck=["c"],
                   cols={"id": "int", "c": "int", "v": "text"})
    schema.add_table(t)
    settings = Settings(Config.load(overrides))
    return StorageEngine(base_dir, schema, commitlog_sync="periodic",
                         settings=settings, device=device), t


def _wall_threads() -> list:
    return [th for th in threading.enumerate()
            if th.name == "wall-profiler"]


def _await(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def check_lifecycle(base_dir: str, device=None) -> list[str]:
    from cassandra_tpu_torch.service import sampler
    errs: list[str] = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    eng, _t = _build(os.path.join(base_dir, "n1"), {}, device)
    try:
        # default off: zero cost means ZERO threads, not an idle one
        need(not sampler.GLOBAL.running,
             "sampler running with profiler_enabled at default (off)")
        need(not _wall_threads(),
             "wall-profiler thread exists with the knob off")
        eng.settings.set("profiler_interval", "10ms")
        eng.settings.set("profiler_enabled", True)
        need(_await(lambda: sampler.GLOBAL.running),
             "profiler_enabled=true did not start the sampler")
        before = sampler.GLOBAL.samples
        need(_await(lambda: sampler.GLOBAL.samples > before, 3.0),
             "running sampler ring is not accruing samples")
        eng.settings.set("profiler_enabled", False)
        need(_await(lambda: not sampler.GLOBAL.running),
             "profiler_enabled=false did not park the sampler")
        need(_await(lambda: not _wall_threads()),
             "wall-profiler thread survived the knob going off")
        # close() must withdraw demand even if the operator forgot
        eng.settings.set("profiler_enabled", True)
        need(_await(lambda: sampler.GLOBAL.running),
             "re-enable did not restart the sampler")
    finally:
        eng.close()
    need(_await(lambda: not sampler.GLOBAL.running),
         "engine.close() did not withdraw the sampler demand")
    return errs


def check_flamegraph(base_dir: str, device=None) -> list[str]:
    from cassandra_tpu_torch.service import sampler
    from cassandra_tpu_torch.tools import nodetool
    errs: list[str] = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    eng, _t = _build(os.path.join(base_dir, "n2"), {}, device)
    stop = threading.Event()

    def _spin():
        x = 0
        while not stop.is_set():
            x = (x * 1103515245 + 12345) % (1 << 31)

    def _park():
        stop.wait(30.0)

    spinner = threading.Thread(target=_spin, name="gate-spin",
                               daemon=True)
    parked = threading.Thread(target=_park, name="gate-park",
                              daemon=True)
    live = None     # the session while it is open
    try:
        eng.settings.set("profiler_interval", "5ms")
        out = nodetool.profiler(eng, "start")
        sid = live = out["session"]
        need(sampler.GLOBAL.running,
             "a live session did not start the sampler thread "
             "(sessions must work with the knob off)")
        spinner.start()
        parked.start()
        _await(lambda: sampler.GLOBAL.split(sid)["ticks"] >= 40,
               timeout_s=15.0)

        # vtable while the session is live: target = the session id
        vt = eng.virtual_tables.get("system_views", "profiles")
        vrows = [r for r in vt.rows() if r["target"] == sid]
        need(vrows, "system_views.profiles has no rows for the "
             "live session")

        split = nodetool.profiler(eng, "stop", session=sid)
        live = None
        stop.set()
        dump = nodetool.profiler(eng, "dump", session=sid,
                                 limit=100_000)
        need(dump["target"] == sid, "dump targeted the wrong agg")

        # the round-trip: collapsed text -> parse -> same totals as
        # the structured split (one aggregate, two encodings)
        parsed = sampler.parse_collapsed(dump["flamegraph"])
        need(parsed["cpu"] == split["cpu"]
             and parsed["blocked"] == split["blocked"]
             and parsed["stacks"] == split["stacks"],
             f"flamegraph does not round-trip: parsed {parsed} vs "
             f"split cpu={split['cpu']} blocked={split['blocked']} "
             f"stacks={split['stacks']}")
        need(split["ticks"] >= 30,
             f"session collected only {split['ticks']} ticks")

        # classification: the spinner burns CPU, the parked thread
        # waits in threading.Event.wait -> blocked. DOMINANT state,
        # not exclusive: a thread's first ticks can land in the
        # threading.py bootstrap (-> blocked) before its target runs.
        counts: dict[tuple, int] = {}
        for line in dump["flamegraph"]:
            stack, _, n = line.rpartition(" ")
            state, tname = stack.split(";")[:2]
            key = (tname, state)
            counts[key] = counts.get(key, 0) + int(n)
        need(counts.get(("gate-spin", "cpu"), 0)
             > counts.get(("gate-spin", "blocked"), 0),
             f"spinner thread not dominantly on-CPU: {counts}")
        need(counts.get(("gate-park", "blocked"), 0)
             > counts.get(("gate-park", "cpu"), 0),
             f"parked thread not dominantly blocked: {counts}")
    finally:
        stop.set()
        if live is not None:    # a failure left the session open
            sampler.GLOBAL.stop_session(live)
        eng.close()
    return errs


def check_sentinel(base_dir: str, device=None) -> list[str]:
    import torch

    from cassandra_tpu_torch import device as devmod
    from cassandra_tpu_torch.service import diagnostics, profiling
    from cassandra_tpu_torch.tools import nodetool
    errs: list[str] = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    dev = devmod.resolve(device)
    prev_budget = profiling.GLOBAL.retrace_budget
    diagnostics.GLOBAL.clear()
    eng, _t = _build(os.path.join(base_dir, "n3"),
                     {"diagnostic_events_enabled": True,
                      "profiler_retrace_budget": 2}, dev)
    try:
        profiling.GLOBAL.reset()   # fresh kernels, budget stays 2
        probe = profiling.GLOBAL.wrap("check.churn",
                                      lambda x: torch.sum(x) + 1)
        churn = 7   # distinct shapes; budget 2 -> 5 past-budget traces
        for n in range(1, churn + 1):
            probe(torch.zeros(n, dtype=torch.float32, device=dev))

        snap = profiling.GLOBAL.snapshot()["kernels"].get(
            "check.churn", {})
        need(snap.get("compiles") == churn,
             f"expected {churn} compiles, got {snap.get('compiles')}")
        need(snap.get("retraces") == churn - 2,
             f"expected {churn - 2} retraces past the budget, got "
             f"{snap.get('retraces')}")

        evs = [e.to_dict()
               for e in diagnostics.GLOBAL.events("profile.retrace")]
        need(len(evs) == 1,
             f"sentinel published {len(evs)} profile.retrace events "
             "(must be exactly one per program until reset)")
        if evs:
            need(evs[0].get("program") == "check.churn"
                 and evs[0].get("budget") == 2,
                 f"sentinel event fields wrong: {evs[0]}")

        vt = eng.virtual_tables.get("system_views", "device_programs")
        rows = {r["name"]: r for r in vt.rows()}
        need("check.churn" in rows
             and rows["check.churn"]["retraces"] == churn - 2,
             "system_views.device_programs does not carry the "
             "retrace count")

        out = nodetool.flightrecorder(eng)
        with open(out["bundle"]) as f:
            bundle = json.load(f)
        prof = bundle.get("profile", {})
        need(prof.get("retrace_budget") == 2,
             "bundle profile section lacks the retrace budget")
        need(prof.get("device_programs", {})
             .get("check.churn", {}).get("retraces") == churn - 2,
             "bundle profile section does not name the churning "
             "program")
    finally:
        eng.close()
        profiling.GLOBAL.reset()
        profiling.GLOBAL.set_retrace_budget(prev_budget)
        diagnostics.GLOBAL.reset()
    return errs


def run_check(base_dir: str, device=None) -> list[str]:
    """Every leg; human-readable violations (empty = pass)."""
    errs = check_lifecycle(os.path.join(base_dir, "lifecycle"), device)
    errs += check_flamegraph(os.path.join(base_dir, "flame"), device)
    errs += check_sentinel(os.path.join(base_dir, "sentinel"), device)
    return errs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.check_profiler")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engines and the probe "
                        "(default cuda)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        errs = run_check(d, device=args.device)
    if errs:
        print("check_profiler: FAIL", file=sys.stderr)
        for e in errs:
            print(f"  - {e}", file=sys.stderr)
        return 1
    print("check_profiler: zero-cost-off, flamegraph round-trip and "
          "retrace sentinel OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
