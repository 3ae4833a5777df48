#!/usr/bin/env python3
"""Count torch.profiler windows that record no device time, over the
life of one process on a card.

    python3 profile_windows.py [SECONDS]

Builds the kernels (chip_smoke's phase 2), then, until SECONDS (200 by
default) have passed, takes rounds of windows around one K4 call
(`meta_block_kernel` on a 65,536-cell segment) in four ways: a plain
window (as chip_smoke.sort_breakdown takes it), a window after a
warm-up step of the profiler's schedule, and windows padded by 20 ms
and by 200 ms of host sleep on either side of the call. Between rounds
the card runs a short elementwise loop and the host sleeps 5 s. Per
round it prints one JSON line: the seconds since the first round and,
per way, [windows of 10 that saw no K4 kernel, the first three offsets
in microseconds from the launching runtime call's start to the kernel's
start as the profiler reports them]. The last line sums the empty
windows per way. Needs one card.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

ROUND_WINDOWS = 10
WAYS = ("plain", "warm", "pad20", "pad200")


def main(argv=None) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    argv = sys.argv[1:] if argv is None else argv
    seconds = float(argv[0]) if argv else 200.0
    if not torch.cuda.is_available():
        print("profile_windows: no CUDA device", file=sys.stderr)
        return 2
    cs.phase_card()
    cs.phase_build()
    from cassandra_tpu_torch.ops import device_write as dw

    dev = torch.device("cuda")
    _ts, seg_np = cs.make_segment(8, cs.SEGMENT)
    seg = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a).to(dev) for a in seg_np]

    def fn():
        dw.meta_block_kernel(*seg)
        torch.cuda.synchronize()

    fn()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def padded(pad: float):
        with profile(activities=acts, acc_events=True) as prof:
            time.sleep(pad)
            fn()
            time.sleep(pad)
        return prof

    def warm():
        with profile(activities=acts, acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            prof.step()
            fn()
            prof.step()
        return prof

    ways = {"plain": lambda: padded(0.0), "warm": warm,
            "pad20": lambda: padded(0.02), "pad200": lambda: padded(0.2)}

    def seen(prof) -> tuple:
        evs = list(prof.events())
        kern = [e for e in evs if e.device_type == DeviceType.CUDA
                and "meta_tiles" in e.name]
        launch = [e for e in evs if e.device_type != DeviceType.CUDA
                  and "LaunchKernel" in e.name]
        off = (kern[0].time_range.start - launch[-1].time_range.start
               if kern and launch else None)
        return bool(kern), off

    empty = dict.fromkeys(WAYS, 0)
    rounds = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        rounds += 1
        row: dict = {"t": round(time.perf_counter() - t0, 1)}
        for way in WAYS:
            n_empty, offs = 0, []
            for _ in range(ROUND_WINDOWS):
                ok, off = seen(ways[way]())
                n_empty += not ok
                if off is not None:
                    offs.append(round(off))
            empty[way] += n_empty
            row[way] = [n_empty, offs[:3]]
        print(json.dumps(row), flush=True)
        x = torch.randn(1 << 24, device=dev)
        for _ in range(50):
            x = x * 1.0001
        torch.cuda.synchronize()
        time.sleep(5)
    print(json.dumps({"windows_per_way": ROUND_WINDOWS * rounds,
                      "empty": empty}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
