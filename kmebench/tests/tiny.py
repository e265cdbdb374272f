"""A copy of the benchmark's definition at a size a CPU test can hold:
the same files, with the configurations' widths and the warm prefix cut
and the open-loop rate lowered, for runs of the plain PyTorch kernels.
Cells whose files wait outside BENCHMARK.json (a configuration the
program cannot serve yet, a mix too noisy for a bound) join it here,
reporting what the listed cell of their traffic mix reports, or the rate
of messages completed where no listed cell runs their mix, so that they
keep running."""

from __future__ import annotations

import json
import os
import shutil

from kmebench import spec as S

CPU_RATE = 300          # msgs/s: below what the CPU's plain kernels serve


def _waiting_rate(doc: dict, name: str) -> None:
    """A waiting cell of a mix that no listed cell runs (a closed loop)
    reports the rate of messages completed, `metrics/msgs_per_s.py`."""
    m = next((m for m in doc["end_to_end"] if m["name"] == "msgs_per_s"),
             None)
    if m is None:
        m = {"name": "msgs_per_s", "unit": "msgs/s", "better": "higher",
             "bound": 0.25, "source": "host_clock", "workloads": []}
        doc["end_to_end"].append(m)
    m["workloads"].append(name)


def tiny_bench(tmp: str) -> S.Benchmark:
    base = os.path.join(tmp, "kmebench")
    for d in ("metrics", "traffic"):
        shutil.copytree(os.path.join(S.HERE, d), os.path.join(base, d))
    os.makedirs(os.path.join(base, "configs"))
    os.makedirs(os.path.join(base, "cells"))
    doc = json.load(open(S.BENCHMARK))
    listed = {w["name"]: w for w in doc["workloads"]}
    for f in sorted(os.listdir(os.path.join(S.HERE, "cells"))):
        name = f[:-len(".json")]
        cf = json.load(open(os.path.join(S.HERE, "cells", f)))
        if "rate_per_s" in cf.get("params", {}):
            cf["params"]["rate_per_s"] = CPU_RATE
        with open(os.path.join(base, "cells", f), "w") as out:
            json.dump(cf, out)
        if name in listed:
            continue
        twin = next((w["name"] for w in doc["workloads"]
                     if w["traffic"] == cf["traffic"]), None)
        doc["workloads"].append({"name": name, **{
            k: cf[k] for k in ("config", "traffic", "chips", "why")}})
        if twin is None:
            _waiting_rate(doc, name)
        for m in doc["end_to_end"] + doc["per_layer"]:
            if twin is not None and twin in m.get("workloads", []):
                m["workloads"].append(name)
    for w in doc["workloads"]:
        path = os.path.join(base, "configs", w["config"] + ".json")
        if os.path.exists(path):
            continue
        cfg = json.load(open(os.path.join(S.HERE, "configs",
                                          w["config"] + ".json")))
        cfg["serve"].update(batch=128, accounts=64,
                            symbols=min(cfg["serve"]["symbols"], 16))
        if cfg["serve"]["slots"] > 256:
            cfg["serve"]["slots"] = 256
        cfg["warm_events"] = 256
        with open(path, "w") as f:
            json.dump(cfg, f)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return S.Benchmark(path, base)
