"""Finds a cell's files by the names ``BENCHMARK.json`` gives.

- a configuration: the ``file`` its ``configs`` entry names (a JSON object
  holding the program's configuration as it is run);
- a traffic mix: ``traffic/<traffic>.json`` beside this file;
- a metric: ``metrics/<name>.py`` beside this file, whose ``read(ctx)``
  returns the value or None where the run gives it nothing to read;
- a configuration's correctness limits: ``limits/<config>.json``.

A later change adds a cell, a configuration, a mix or a metric by adding
such files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


class Registry:
    def __init__(self, bench_json: str = "BENCHMARK.json",
                 root: str = HERE):
        with open(bench_json) as f:
            self.spec = json.load(f)
        self.base = os.path.dirname(os.path.abspath(bench_json))
        self.root = root

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.base, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.root, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def limits(self, config: str) -> dict:
        with open(os.path.join(self.root, "limits", f"{config}.json")) as f:
            return json.load(f)

    def metrics(self, workload: str, kind: str) -> list:
        """The metric entries of ``kind`` ('end_to_end' or 'per_layer')
        that the cell reports: those listing it, or listing no cells."""
        return [m for m in self.spec[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        path = os.path.join(self.root, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
