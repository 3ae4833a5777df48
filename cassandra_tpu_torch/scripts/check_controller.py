"""CI check (tier-2): the adaptive compaction controller — the
observe/decide/actuate loop (docs/adaptive-compaction.md).

A deterministic engine run drives one table through three workload
phases (write burst -> tombstone/time-series -> read heavy) with
explicit on-demand ticks and asserts

  - zero-cost-off: no decision thread while the knob is off, and the
    knob hot-starts/stops the loop;
  - CONVERGENCE: each phase settles on the expected regime and
    compaction strategy within MAX_TICKS decision intervals
    (STCS under the burst, TWCS under the tombstone flood, LCS under
    the read plateau);
  - every decision is visible end-to-end: ledger == diagnostics ring
    (`controller.decision`) == `system_views.controller_decisions`
    rows, knob actuations as `config.reload` with `actor=controller`;
  - freeze actually freezes: while frozen a confirmed regime change is
    recorded as skipped and the strategy does NOT move; unfreeze
    resumes actuation. Frozen state survives an engine restart.

The engines run on `device` (`cuda` by default, which raises without
a card; `cpu` runs the kernels' plain PyTorch versions).

    python -m cassandra_tpu_torch.scripts.check_controller [--device cpu]

Exit 0 = clean; exit 1 prints each violation.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


MAX_TICKS = 4   # convergence bound per phase (decision intervals)


def check_controller(base_dir: str, device=None) -> list[str]:
    from cassandra_tpu_torch.config import Config, Settings
    from cassandra_tpu_torch.cql import Session
    from cassandra_tpu_torch.schema import Schema
    from cassandra_tpu_torch.service import diagnostics
    from cassandra_tpu_torch.storage.cellbatch import FLAG_TOMBSTONE
    from cassandra_tpu_torch.storage.engine import StorageEngine
    from cassandra_tpu_torch.storage.mutation import Mutation
    from cassandra_tpu_torch.tools import nodetool

    errs: list[str] = []

    def need(cond, msg):
        if not cond:
            errs.append(msg)

    settings = Settings(Config.load({
        "compaction_throughput": 0,
        "diagnostic_events_enabled": True,
        "adaptive_compaction_confirm_ticks": 1,
        "adaptive_compaction_cooldown": "1ms",
    }))
    eng = StorageEngine(base_dir, Schema(), commitlog_sync="batch",
                        settings=settings, device=device)
    try:
        s = Session(eng)
        s.execute("CREATE KEYSPACE ctl WITH replication = "
                  "{'class': 'SimpleStrategy', 'replication_factor': 1}")
        s.execute("USE ctl")
        s.execute("CREATE TABLE t (k int PRIMARY KEY, v text) "
                  "WITH gc_grace_seconds = 0")
        cfs = eng.store("ctl", "t")
        t = cfs.table
        ctrl = eng.controller

        # --- zero-cost-off + knob hot-enable/disable
        need(not ctrl.enabled,
             "decision thread running with the knob off (zero-cost)")
        settings.set("adaptive_compaction_enabled", True)
        need(ctrl.enabled, "knob hot-enable did not start the loop")
        settings.set("adaptive_compaction_enabled", False)
        need(not ctrl.enabled, "knob hot-disable did not stop the loop")

        def converge(expect_regime, expect_class, activity):
            """Ticks until the table lands on the expected regime;
            returns ticks spent (MAX_TICKS+1 = never converged)."""
            for n in range(1, MAX_TICKS + 1):
                activity()
                ctrl.tick()
                time.sleep(0.002)   # let the 1 ms cooldown lapse
                reg = ctrl.table_regimes().get("ctl.t", {})
                if reg.get("regime") == expect_regime \
                        and t.params.compaction["class"] == expect_class:
                    return n
            return MAX_TICKS + 1

        # --- phase 1: write burst -> STCS
        def burst():
            base = int(time.time() * 1000) % 100_000
            for i in range(32):
                s.execute(f"INSERT INTO t (k, v) VALUES ({base + i}, "
                          f"'v{i}')")
            cfs.flush()
        took = converge("write_burst", "SizeTieredCompactionStrategy",
                        burst)
        need(took <= MAX_TICKS,
             f"phase 1 (write burst) did not converge to "
             f"write_burst/STCS within {MAX_TICKS} ticks")

        # --- phase 2: tombstone flood -> time_series/TWCS
        now = int(time.time())
        marker = [10_000]

        def tombstones():
            for i in range(32):
                p = marker[0] + i
                m = Mutation(t.id, t.columns["k"].cql_type.serialize(p))
                m.add(t.serialize_clustering([]),
                      t.columns["v"].column_id, b"", b"", 1_000 + p,
                      ldt=now - 7200, flags=FLAG_TOMBSTONE)
                eng.apply(m)
            marker[0] += 100
            cfs.flush()
        took = converge("time_series", "TimeWindowCompactionStrategy",
                        tombstones)
        need(took <= MAX_TICKS,
             f"phase 2 (tombstones) did not converge to "
             f"time_series/TWCS within {MAX_TICKS} ticks")

        # --- phase 3: read plateau -> read_heavy/LCS
        def reads():
            for i in range(48):
                s.execute(f"SELECT v FROM t WHERE k = {i}")
        took = converge("read_heavy", "LeveledCompactionStrategy",
                        reads)
        need(took <= MAX_TICKS,
             f"phase 3 (reads) did not converge to read_heavy/LCS "
             f"within {MAX_TICKS} ticks")

        # --- every decision visible end-to-end
        ledger = ctrl.decisions()
        need(ledger, "empty decision ledger after three phases")
        ring = [e for e in diagnostics.GLOBAL.events()
                if e.type == "controller.decision"]
        need(len(ring) == len(ledger),
             f"diagnostics ring has {len(ring)} controller.decision "
             f"events, ledger has {len(ledger)}")
        vt = eng.virtual_tables.get("system_views",
                                    "controller_decisions")
        rows = list(vt.rows_fn())
        need(len(rows) == len(ledger),
             f"controller_decisions vtable rows {len(rows)} != "
             f"ledger {len(ledger)}")
        applied_strats = [e for e in ledger
                         if e["action"] == "strategy" and e["applied"]]
        need(len(applied_strats) >= 3,
             f"{len(applied_strats)} applied strategy decisions "
             "across three phases (expected >= 3)")
        knob_evs = [e for e in diagnostics.GLOBAL.events()
                    if e.type == "config.reload"
                    and e.fields.get("actor") == "controller"]
        need(knob_evs,
             "no config.reload events attributed to the controller "
             "(posture actuation invisible)")

        # --- freeze actually freezes; unfreeze resumes
        nodetool.run_command("autocompaction", engine=eng,
                             action="freeze")
        before = dict(t.params.compaction)
        for _ in range(2):
            burst()
            ctrl.tick()
            time.sleep(0.002)
        need(t.params.compaction == before,
             "strategy moved while frozen")
        frozen_skips = [e for e in ctrl.decisions()
                        if e.get("reason") == "frozen"]
        need(frozen_skips and not any(e["applied"]
                                      for e in frozen_skips),
             "frozen window left no skipped ledger entries")
        st = nodetool.run_command("autocompaction", engine=eng)
        need(st["frozen"] is True,
             "nodetool autocompaction status not frozen")
        nodetool.run_command("autocompaction", engine=eng,
                             action="unfreeze")
        took = converge("write_burst", "SizeTieredCompactionStrategy",
                        burst)
        need(took <= MAX_TICKS,
             "controller did not resume actuation after unfreeze")

        # --- freeze marker survives an engine restart
        ctrl.freeze()
    finally:
        eng.close()
        diagnostics.GLOBAL.reset()

    eng2 = StorageEngine(base_dir, Schema(), commitlog_sync="batch",
                         settings=Settings(Config.load({})), device=device)
    try:
        need(eng2.controller.frozen is True,
             "frozen marker did not survive the engine restart")
    finally:
        eng2.close()
        diagnostics.GLOBAL.reset()
    return errs


def run_check(base_dir: str, device=None) -> list[str]:
    return check_controller(os.path.join(base_dir, "engine"), device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.check_controller")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engines (default cuda)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        errs = run_check(d, device=args.device)
    if errs:
        print("check_controller: FAIL", file=sys.stderr)
        for e in errs:
            print(f"  - {e}", file=sys.stderr)
        return 1
    print("check_controller: regime convergence, decision visibility "
          "and freeze semantics OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
