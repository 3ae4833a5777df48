"""The port's tier-2 checks and drivers: the deterministic,
minutes-scale gates run beside the unit suite (tier-1), the
counterparts of the JAX package's `scripts/`. Each runs as

    python -m cassandra_tpu_torch.scripts.<name> [--device cpu]

on `cuda` by default (it raises without a card; `--device cpu` runs the
kernels' plain PyTorch versions), and exits 0 clean / 1 with a line per
finding. Importing a module here only defines it.

| script | gate |
|---|---|
| `check_static` | **ctpulint**: five concurrency/invariant AST checks (lock-order, loop-blocking, knob-wiring, worker-loops, clock-discipline) over the shared walker, `# ctpulint: allow(check, reason=...)` suppressions with mandatory reasons; full mode also arms the runtime LockWitness over the engine smoke. `--fast` = AST-only (~5 s, pre-commit shape); `--explain` audits the allowlist; `--list` prints the catalog. See docs/static-analysis.md. |
| `check_metric_names` | every registered metric name follows the documented scheme AND the docs/observability.md catalog matches a deterministic engine smoke both directions (emitted-but-undocumented / documented-but-dead); names only the port emits are its own group (`PORT_CATALOG`). Module discovery is the ctpulint walker's, so the two tools scan the same file set. |
| `check_compaction_ab` | serial vs threaded vs pooled vs mesh vs device-resident compaction legs: sha256 component identity + merged-view digests, zero divergence |
| `check_readpath_ab` | read fast lane vs naive collation: zero divergence incl. deletions at all scopes |
| `check_scan_ab` | analytical ALLOW FILTERING lane: naive Python scan vs zone-map + device-kernel pushdown vs mesh-2 fanned Phase A vs host-numpy lane — zero divergence on a mixed fixture (tombstones at every scope, expired TTL, statics, text prefixes, IN lists, aggregates) |
| `check_writepath_ab` | write fast lane vs naive: crash-copy replay + content-digest equality |
| `chaos_storage` | storage fault drills (EIO/bit-flip/torn-write) end in the policy-mandated states |
| `chaos_streaming` | streaming fault drills over the sessioned transfer path: latency + disconnect retransmit converge digest-identical to a clean control, EIO at the TOC commit point leaves zero visible sstables and the restart sweep removes orphans, a sender killed mid-session resumes from the durable watermark byte-identically, bootstrap completes under wire chaos; a disarmed re-run shows zero divergence. See docs/streaming.md. |
| `check_diagnostics` | terminal failures auto-dump well-formed flight-recorder bundles |
| `check_slo` | SLO breach/budget edges, breach bundles (incl. the non-empty metrics-history window + pipeline-ledger table every bundle carries), knob hot-reload (`--smoke`) |
| `check_controller` | adaptive compaction controller: a 3-phase shifting workload (write burst → tombstone flood → read plateau) converges to the expected regime/strategy within a bounded number of decision ticks; every decision visible in the ledger == diagnostics ring == `system_views.controller_decisions`, posture knob actuations as `config.reload` `actor=controller`; freeze blocks actuation (skipped ledger entries) and survives an engine restart. See docs/adaptive-compaction.md. |
| `check_observatory` | workload observatory: metrics-history rings populated from a deterministic engine run, WA/SA gauges arithmetically reconciled against the run's actual flushed/compacted byte counters, `clusterstats` over a 3-node LocalCluster incl. the dark-node staleness path |
| `check_profiler` | continuous profiler: zero-cost-off (no `wall-profiler` thread until a knob or session demands one, `engine.close()` withdraws the demand), flamegraph round-trip (`parse_collapsed` totals == the session `split()`, spinner dominantly on-CPU / parked thread dominantly blocked, same stacks through `system_views.profiles` and `nodetool profiler dump`), retrace sentinel under forced shape churn (counter per past-budget recompile, exactly one `profile.retrace` event per program, `system_views.device_programs` row, `profile` section in the flight bundle) |
| `stress` | wire-level stress driver; `--smoke` is the deterministic front-door drill; `--matrix` the saturation scenario matrix |

Non-gate utilities: `device_accounting` (the device engine's gap to
the native engine against the host-card link, one JSON line),
`prof_device` (the merge round's sub-phases, CUDA-event timed).
"""
