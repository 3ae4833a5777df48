"""ctpulint — project-specific concurrency & invariant static analysis.

Reference counterpart: the reference ships build-time checkers enforcing
exactly this discipline (checkstyle + custom ant tasks: no synchronized
on monitors the simulator cannot intercept, no blocking calls on Netty
event loops, DatabaseDescriptor mutability audited by hand). Here the
same bug taxonomy — the one dominating every recent PR's post-review
hardening list — is machine-checked:

  lock-order        static lock-acquisition graph must be acyclic
  loop-blocking     nothing blocking reachable from the transport event
                    loop or under the gossip lock
  knob-wiring       every mutable=True config knob is actually wired
                    (on_change listener or per-use re-read site)
  worker-loops      daemon worker loops cannot die silently
  clock-discipline  clock-injectable / sim-patched modules never bind
                    the real clock

`walker.ProjectIndex` is the shared AST index (module discovery, call
graph approximation, lock sites, `# ctpulint: allow(...)` suppressions);
each check in `checks/` is a pure function `run(index) -> [Violation]`.
`python -m cassandra_tpu_torch.analysis` runs them; the runtime half of the
lock-order story is `utils/lockwitness.py` (docs/static-analysis.md).
"""
from .report import Violation  # noqa: F401
from .walker import ProjectIndex, project_files  # noqa: F401
