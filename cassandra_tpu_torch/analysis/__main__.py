"""ctpulint over the port: the five AST checks on cassandra_tpu_torch/
(and chip_smoke.py, kernel_ab.py), without an engine boot.

    python -m cassandra_tpu_torch.analysis            the checks
    python -m cassandra_tpu_torch.analysis --explain  also every active
                                                      allowlist entry
                                                      with its reason
    python -m cassandra_tpu_torch.analysis --list     the check catalog

Exit 0 = clean. Any unallowlisted violation or any `allow()` missing
its reason= exits 1 with file:line per finding. A check whose root
module the tree does not hold yet (the transport server, gossip, the
simulator) is named on a `note:` line: its rule did not run.
"""
from __future__ import annotations

import sys


def run_ast_checks(explain: bool = False, index=None) -> int:
    from . import checks
    from .report import apply_suppressions, reasonless
    from .walker import ProjectIndex

    if index is None:
        index = ProjectIndex.build()
    violations = checks.run_all(index)
    supps = index.suppressions()
    meta = reasonless(supps)
    remaining = apply_suppressions(violations, supps) + meta

    rc = 0
    if remaining:
        print("ctpulint violations:", file=sys.stderr)
        for v in sorted(remaining, key=lambda v: (v.path, v.line)):
            print(f"  {v}", file=sys.stderr)
        rc = 1
    suppressed = [v for v in violations if v.suppressed_by is not None]
    unused = [s for s in supps if s.reason and not s.used]
    print(f"ctpulint: {len(checks.CHECKS)} checks, "
          f"{len(violations) + len(meta)} findings, "
          f"{len(suppressed)} allowlisted, "
          f"{len(remaining)} violations")
    if index.absent_roots:
        print("note: roots not in the tree (their rules did not run): "
              + ", ".join(sorted(index.absent_roots)))
    if unused:
        print("note: stale allowlist entries (matched nothing):")
        for s in unused:
            print(f"  {s}")
    if explain:
        used = [s for s in supps if s.used]
        if used:
            print("active allowlist:")
            for s in sorted(used, key=lambda s: (s.path, s.line)):
                print(f"  {s}")
    return rc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--list" in argv:
        from . import checks
        for name, (_mod, desc) in checks.CHECKS.items():
            print(f"  {name:18s} {desc}")
        return 0
    rc = run_ast_checks("--explain" in argv)
    if rc == 0:
        print("ctpulint OK")
    return rc


if __name__ == "__main__":
    sys.exit(main())
