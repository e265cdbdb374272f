"""The benchmark's definition, read from data: `BENCHMARK.json` at the
root, and under `kmebench/` one file per configuration
(`configs/<config>.json`), traffic mix (`traffic/<mix>.json`, read by
`arrivals.py`), cell (`cells/<cell>.json`) and metric
(`metrics/<metric>.py`). Everything is found by the names in
`BENCHMARK.json`, so a new cell, mix or metric is new files and
entries, never an edit."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, Dict, List, Optional

from kmebench.arrivals import check as check_traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Benchmark:
    def __init__(self, path: str = BENCHMARK, base: str = HERE) -> None:
        self.doc = _load_json(path)
        self.base = base
        self.configs = {c["name"]: c for c in self.doc["configs"]}
        self.cells = {w["name"]: w for w in self.doc["workloads"]}
        self.end_to_end = list(self.doc["end_to_end"])
        self.per_layer = list(self.doc["per_layer"])

    # -- files by name ----------------------------------------------

    def config(self, name: str) -> dict:
        return _load_json(os.path.join(self.base, "configs", name + ".json"))

    def traffic(self, name: str) -> dict:
        return _load_json(os.path.join(self.base, "traffic", name + ".json"))

    def cell_file(self, name: str) -> dict:
        return _load_json(os.path.join(self.base, "cells", name + ".json"))

    def metric_path(self, name: str) -> str:
        """`metrics/<name>.py`; for a quantity split by the end-to-end
        metric it moves (`device.idle_pct.steady`) whose arithmetic is
        the same in every cell, the one reader of its stem
        (`metrics/device.idle_pct.py`)."""
        path = os.path.join(self.base, "metrics", name + ".py")
        if not os.path.exists(path) and "." in name:
            stem = os.path.join(self.base, "metrics",
                                name.rsplit(".", 1)[0] + ".py")
            if os.path.exists(stem):
                return stem
        return path

    def cell(self, name: str) -> dict:
        """The cell's entry, its file, configuration and mix, checked
        against one another."""
        if name not in self.cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = self.cells[name]
        cf = self.cell_file(name)
        for k in ("config", "traffic", "chips", "why"):
            if cf.get(k) != entry[k]:
                raise ValueError(f"cells/{name}.json says {k}="
                                 f"{cf.get(k)!r}, BENCHMARK.json says "
                                 f"{entry[k]!r}")
        traffic = self.traffic(entry["traffic"])
        check_traffic(traffic)
        return {"name": name, "entry": entry,
                "params": cf.get("params", {}),
                "config": self.config(entry["config"]),
                "traffic": traffic}

    # -- which metrics a cell reports --------------------------------

    @staticmethod
    def _listed(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def e2e_for(self, cell: str) -> List[dict]:
        return [m for m in self.end_to_end if self._listed(m, cell)]

    def per_layer_for(self, cell: str) -> List[dict]:
        e2e = {m["name"] for m in self.e2e_for(cell)}
        return [m for m in self.per_layer
                if m["moves"] in e2e and self._listed(m, cell)]


def load_reader(path: str) -> Callable:
    """A metric's `read(run)` from its file (a metric name may hold
    dots, so the file is loaded by path, not imported by name)."""
    mod_name = "kmebench_metric_" + re.sub(r"\W", "_",
                                           os.path.basename(path)[:-3])
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(bench: Benchmark, metrics: List[dict], run) -> Dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read."""
    out: Dict[str, dict] = {}
    for m in metrics:
        v: Optional[float] = load_reader(bench.metric_path(m["name"]))(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
