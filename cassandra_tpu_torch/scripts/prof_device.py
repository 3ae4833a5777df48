"""Profile the device merge round's sub-phases (dev tool).

One round of N_RUNS sorted runs (production-like: 4 x 65,536 cells, a
pipelined CompactionTask round; --cells overrides the cells per run)
goes through ops/merge.py's shipped submit/collect API on the device:
the concat, the plane pack (the v3 fast planes when the round
qualifies, K6, else v2, K7), the submit, the collect. On a card the
round's device work is the device time the device-program registry
(service/profiling.py, `system_views.device_programs`) took with its
CUDA events around the round's kernel calls; the host walls stand
beside. Then the registry's view of all the calls.

    python -m cassandra_tpu_torch.scripts.prof_device [--device cpu]

`cuda` is the default and raises without a card; on `cpu` the plain
versions run and the device times are null.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

N_RUNS = 4
CELLS = 65_536
VB = 64
NPART = 4096


def make_batches(cells: int, seed: int = 2) -> list:
    """N_RUNS sorted runs of `cells` random cells each."""
    from cassandra_tpu_torch.ops.codec import CompressionParams
    from cassandra_tpu_torch.schema import TableParams, make_table
    from cassandra_tpu_torch.storage import cellbatch as cb
    from cassandra_tpu_torch.tools import bulk

    table = make_table("bench", "stress", pk=["id"], ck=["c"],
                       cols={"id": "int", "c": "int", "v": "blob"},
                       params=TableParams(compression=CompressionParams(
                           "LZ4Compressor")))
    rng = np.random.default_rng(seed)
    batches = []
    for _run in range(N_RUNS):
        pk = rng.integers(0, NPART, cells)
        ck = rng.integers(1, 10_000, cells)
        vals = rng.integers(0, 256, (cells, VB), dtype=np.uint8)
        ts = rng.integers(1, 1 << 40, cells).astype(np.int64)
        b = bulk.build_int_batch(table, pk, ck, vals, ts)
        batches.append(cb.merge_sorted([b]))
    return batches


def _device_s() -> float:
    """The device seconds the registry's CUDA events have timed, over
    every kernel (the calls completed so far)."""
    from cassandra_tpu_torch.service import profiling

    return sum(k["device_s"]
               for k in profiling.GLOBAL.snapshot()["kernels"].values())


def one(batches: list, device) -> dict:
    """Profile one round through the ACTIVE device path: host seconds
    by step, the submit's prof dict, and on a card the device ms of the
    round's kernels (CUDA events)."""
    from cassandra_tpu_torch.ops import merge as dmerge
    from cassandra_tpu_torch.storage import cellbatch as cb

    t, prof = {}, {}
    t0 = time.perf_counter()
    cat = cb.CellBatch.concat(batches)
    n = len(cat)
    t["concat"] = time.perf_counter() - t0

    fast = dmerge._plane_pack_fast(cat, batches)
    if fast is not None:
        push_bytes = fast[0].nbytes
    else:
        planes, _cfg = dmerge._plane_pack_v2(cat, batches)
        push_bytes = sum(v.nbytes for v in planes.values()
                         if hasattr(v, "nbytes"))

    on_card = device.type == "cuda"
    d0 = _device_s() if on_card else 0.0
    t0 = time.perf_counter()
    h = dmerge.submit_merge(batches, prof=prof, device=device)
    t["submit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    merged = dmerge.collect_merge(h)
    t["collect"] = time.perf_counter() - t0
    # collect waited for the round: its events are complete
    device_ms = (_device_s() - d0) * 1e3 if on_card else None
    return {"mode": h.mode, "n": n, "push_bytes": push_bytes,
            "host_s": t, "prof": prof, "device_ms": device_ms,
            "kept": len(merged)}


def run(device=None, cells: int = CELLS, rounds: int = 4) -> list:
    """`rounds` rounds (the first cold) on the resolved device."""
    from cassandra_tpu_torch import device as devmod

    dev = devmod.resolve(device)
    batches = make_batches(cells)
    return [one(batches, dev) for _ in range(rounds)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m cassandra_tpu_torch.scripts.prof_device")
    p.add_argument("--device", default="cuda",
                   help="torch device of the round (default cuda)")
    p.add_argument("--cells", type=int, default=CELLS,
                   help=f"cells per run, {N_RUNS} runs (default {CELLS:,})")
    args = p.parse_args(argv)
    for tag, r in zip(("cold", "warm1", "warm2", "warm3"),
                      run(args.device, args.cells)):
        dms = ("not measured" if r["device_ms"] is None
               else f"{r['device_ms']:.4f}")
        print(tag, f"mode={r['mode']} n={r['n']} "
              f"push_bytes={r['push_bytes']} "
              f"({r['push_bytes'] / r['n']:.1f} B/cell)",
              {k: round(v, 4) for k, v in r["host_s"].items()},
              {k: round(v, 4) for k, v in r["prof"].items()},
              f"device_ms={dms} kept={r['kept']}")

    # the same rounds as the device-program registry sees them:
    # compile (first call of a shape) vs warm dispatch vs execute,
    # tracked shapes, recompiles past the budget, device seconds, and
    # each kernel's bytes and operations (ops/costs.py)
    from cassandra_tpu_torch.service import profiling

    snap = profiling.GLOBAL.snapshot()
    for name, k in sorted(snap["kernels"].items()):
        print(f"{name}: calls={k['calls']} compiles={k['compiles']} "
              f"shapes={k['shape_count']} evictions={k['shape_evictions']} "
              f"retraces={k['retraces']} compile={k['compile_s']:.3f}s "
              f"dispatch={k['dispatch_s']:.3f}s "
              f"execute={k['execute_s']:.3f}s "
              f"device={k['device_s']:.4f}s/{k['device_calls']} "
              f"flops={k['cost_flops'] or 0:.0f} "
              f"bytes={k['cost_bytes'] or 0:.0f}")
    for phase, secs in sorted(snap["phases"].items()):
        print(f"phase {phase}: {secs:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
