"""ctpulint tier-2 driver: the concurrency & invariant static-analysis
suite (cassandra_tpu_torch/analysis/) + the witness-armed engine smoke.
Run as `python -m cassandra_tpu_torch.scripts.check_static`:

    (no flag)     all five AST checks, then arm the runtime
                  LockWitness over the deterministic engine smoke
                  shared with check_metric_names (dynamic lock orders
                  the AST cannot see); the engine runs on --device
                  (`cuda` by default, which raises without a card)
    --fast        AST-only: no engine boot, ~5 s — the pre-commit shape
    --explain     also print every active allowlist entry with its
                  reason (the allowlist is documentation; this is its
                  audit)
    --list        print the check catalog

Exit 0 = clean. Any unallowlisted violation, any `allow()` missing its
reason=, or a LockOrderError under the armed smoke exits 1 with
file:line per finding. Policy: docs/static-analysis.md.
"""
from __future__ import annotations

import argparse
import sys

# the AST half is the lint's own driver (`python -m
# cassandra_tpu_torch.analysis`), so the two cannot disagree
from cassandra_tpu_torch.analysis.__main__ import run_ast_checks


def run_witness_smoke(device=None) -> int:
    """Arm the LockWitness, then drive the deterministic engine smoke
    check_metric_names.py uses — every witnessed lock created by the
    engine records its acquisition edges; a cycle-closing acquisition
    raises with both stacks."""
    from cassandra_tpu_torch.scripts import check_metric_names
    from cassandra_tpu_torch.utils import lockwitness

    lockwitness.reset()
    lockwitness.arm()
    try:
        check_metric_names.smoke_emitted(device)
    except lockwitness.LockOrderError as e:
        print(f"LockWitness cycle under the engine smoke:\n{e}",
              file=sys.stderr)
        return 1
    finally:
        lockwitness.disarm()
    graph = lockwitness.graph_snapshot()
    n_edges = sum(len(v) for v in graph.values())
    print(f"LockWitness smoke OK: {len(graph)} holder locks, "
          f"{n_edges} acquisition edges, no cycle")
    lockwitness.reset()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.check_static")
    p.add_argument("--fast", action="store_true",
                   help="AST checks only, no engine smoke")
    p.add_argument("--explain", action="store_true",
                   help="print every active allowlist entry")
    p.add_argument("--list", action="store_true",
                   help="print the check catalog")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine smoke (default cuda)")
    args = p.parse_args(argv)
    if args.list:
        from cassandra_tpu_torch.analysis import checks
        for name, (_mod, desc) in checks.CHECKS.items():
            print(f"  {name:18s} {desc}")
        return 0
    rc = run_ast_checks(args.explain)
    if not args.fast:
        rc = run_witness_smoke(args.device) or rc
    if rc == 0:
        print("ctpulint OK")
    return rc


if __name__ == "__main__":
    sys.exit(main())
