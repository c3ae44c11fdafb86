"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root and the
files it names under ``benchmark/``, found by name.

    benchmark/workloads/<cell>.json   config, traffic, why, limits
    benchmark/configs/<config>.json   the model as run, its source
    benchmark/traffic/<mix>.json      the mix's kind and parameters
    benchmark/traffic/<kind>.py       the driver of that kind
    benchmark/metrics/<metric>.py     the reader of that metric

A cell, configuration, mix, kind or metric is added by adding files and
entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """Import the file ``path`` as a module of its own."""
    if not path.exists():
        raise FileNotFoundError(path)
    name = f"{prefix}_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell of ``BENCHMARK.json`` with everything its files say."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        bench = load_json(self.root / "BENCHMARK.json")
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"cells: {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.workload = load_json(self.dir / "workloads" / f"{name}.json")
        for key in ("config", "traffic"):
            if self.workload[key] != self.entry[key]:
                raise ValueError(f"{name}: {key} is {self.entry[key]!r} in "
                                 f"BENCHMARK.json but "
                                 f"{self.workload[key]!r} in its file")
        configs = {c["name"]: c for c in bench["configs"]}
        self.model = load_json(self.root / configs[self.entry["config"]]
                               ["file"])
        self.mix = load_json(self.dir / "traffic"
                             / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])
        self.limits = self.workload["limits"]

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]
        self.end_to_end = mine(bench["end_to_end"])
        self.per_layer = mine(bench["per_layer"])

    def driver(self):
        return load_module(self.dir / "traffic" / f"{self.mix['kind']}.py",
                           "traffic")

    def reader(self, metric: str):
        return load_module(self.dir / "metrics" / f"{metric}.py", "metric")
