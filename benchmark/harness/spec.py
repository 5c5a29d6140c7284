"""``BENCHMARK.json`` read by name: a workload's configuration, traffic
mix, limits and metrics, each from a file of its own.

* the configuration: the ``file`` its ``configs`` entry names;
* the traffic mix: ``benchmark/traffic/<traffic>.json``;
* the limits of the numbers ``correct`` compares:
  ``benchmark/limits/<workload>.json``;
* a per-layer metric's reader: ``benchmark/metrics/<metric>.py``, whose
  ``read(reading)`` returns the value or None.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_spec(root=ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """Everything one workload of ``BENCHMARK.json`` names, resolved."""

    def __init__(self, spec: dict, name: str, root=ROOT):
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r}; BENCHMARK.json has {sorted(entries)}")
        self.entry = w = entries[name]
        self.name = name
        self.chips = int(w["chips"])
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = load_json(os.path.join(root, configs[w["config"]]["file"]))
        self.traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
        self.limits = load_json(os.path.join(HERE, "limits", f"{name}.json"))["limits"]
        self.end_to_end = [m for m in spec["end_to_end"] if _applies(m, name)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, metric: str):
        path = os.path.join(HERE, "metrics", f"{metric}.py")
        mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        return mod.read
