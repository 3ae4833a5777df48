"""Everything of one cell, found by name: BENCHMARK.json at the checkout's
root lists the cells and metrics; a configuration is the JSON file it
names, with its plain reference under benchmark/reference/; a traffic
mix is benchmark/traffic/<name>.json; a per-layer metric is read by
benchmark/metrics/<name>.py, whose `read(ctx)` returns the value, or None
where the cell gives it nothing to read."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    def __init__(self, name: str, spec: dict | None = None):
        spec = spec or _json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.cell = cells[name]
        cfg = {c["name"]: c for c in spec["configs"]}[self.cell["config"]]
        self.config = _json(os.path.join(ROOT, cfg["file"]))
        self.traffic = _json(os.path.join(
            BENCH, "traffic", self.cell["traffic"] + ".json"))
        self.chips = int(self.cell["chips"])

        def here(m):
            return name in m.get("workloads", [name])
        self.end_to_end = [m for m in spec["end_to_end"] if here(m)]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in spec["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]

    def reference(self):
        return importlib.import_module(
            f"reference.{self.config['reference']}")


def reader(metric: str):
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
