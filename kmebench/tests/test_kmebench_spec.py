"""The benchmark's definition: every cell of BENCHMARK.json resolves to
its files, names and units hold only the allowed characters, the
format's counts and limits hold, and a new cell, mix and metric
placed as files are found with no existing file edited."""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest

from kmebench import arrivals as A
from kmebench import spec as S
from kmebench.reference import opcodes as op
from kmebench.streams import MessageStream

DOC = json.load(open(S.BENCHMARK))
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(DOC) == TOP_KEYS
    assert DOC["paths"] == ["kmebench"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert len(DOC["command"]) <= 32
    for w in DOC["command"]:
        assert not w.startswith("/") and ".." not in w
    assert len(json.dumps(DOC)) <= 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in DOC["configs"]]
             + [w["name"] for w in DOC["workloads"]]
             + [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]])
    assert len(set(names)) == len(names)
    for n in names + [w["traffic"] for w in DOC["workloads"]]:
        assert S.NAME_RE.match(n), n
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert S.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = ([w["why"] for w in DOC["workloads"]]
             + [c["why"] for c in DOC["configs"]]
             + [c["source"] for c in DOC["configs"]]
             + [m["layer"] for m in DOC["per_layer"]])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_every_cell_resolves_to_its_files():
    b = S.Benchmark()
    for name in b.cells:
        cell = b.cell(name)
        assert cell["config"]["name"] == cell["entry"]["config"]
        if "arrivals" in cell["traffic"]:
            assert cell["params"]["rate_per_s"] > 0
        for m in b.e2e_for(name) + b.per_layer_for(name):
            assert os.path.exists(b.metric_path(m["name"])), m["name"]
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer one
        e2e = {m["name"] for m in b.e2e_for(name)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert b.per_layer_for(name)
    for c in DOC["configs"]:
        assert os.path.exists(os.path.join(S.ROOT, c["file"]))
        assert c["file"].startswith("kmebench/")
        cfg = json.load(open(os.path.join(S.ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in DOC["workloads"])


def test_metrics_and_bounds_follow_the_format():
    cells = {w["name"] for w in DOC["workloads"]}
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    # a run length at which a check of 24 cells, 14 runs each, fits 12 h
    rs = DOC["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in DOC["workloads"]) <= 1


def _digest_tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_mix_and_metric_are_files_and_entries(tmp_path):
    base = tmp_path / "kmebench"
    shutil.copytree(S.HERE, base, ignore=shutil.ignore_patterns(
        "_build", "__pycache__", "tests"))
    before = _digest_tree(base)
    doc = json.loads(json.dumps(DOC))
    # a new traffic mix (bursts of twice the rate one second in four), a
    # new configuration (70% of the trades on one book), a new cell and
    # a new per-layer metric: files and entries only
    (base / "traffic" / "bursty.json").write_text(json.dumps(
        {"arrivals": "poisson", "shape": [[3, 2 / 3], [1, 2]],
         "tick_ms": 1, "why": "bursts"}))
    cfg = json.load(open(os.path.join(S.HERE, "configs",
                                      "serve-fixed.json")))
    cfg["name"] = "serve-hot"
    cfg["stream"].update(symbols=16, preamble_symbols=16,
                         symbol_draw={"hot": 0.7})
    (base / "configs" / "serve-hot.json").write_text(json.dumps(cfg))
    (base / "cells" / "serve-hot.bursty.json").write_text(json.dumps(
        {"config": "serve-hot", "traffic": "bursty", "chips": 1,
         "why": "a test cell", "params": {"rate_per_s": 1000}}))
    (base / "metrics" / "extra.count.py").write_text(
        "def read(run):\n    return 42.0\n")
    doc["configs"].append({"name": "serve-hot", "source": cfg["source"],
                           "file": "kmebench/configs/serve-hot.json",
                           "reduced": [], "why": "a test config"})
    doc["workloads"].append({"name": "serve-hot.bursty",
                             "config": "serve-hot", "traffic": "bursty",
                             "chips": 1, "why": "a test cell"})
    for m in doc["end_to_end"]:
        if m["name"] in ("answered_100ms_pct", "setup_s") \
                and "workloads" in m:
            m["workloads"].append("serve-hot.bursty")
    doc["per_layer"].append({"name": "extra.count", "unit": "n",
                             "better": "lower", "source": "host_clock",
                             "layer": "the device",
                             "moves": "answered_100ms_pct",
                             "workloads": ["serve-hot.bursty"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(doc))
    b = S.Benchmark(str(path), str(base))
    cell = b.cell("serve-hot.bursty")
    # the new mix's schedule differs from the steady mix's: a quarter of
    # the time carries half of the messages
    offs = A.due_offsets(cell["traffic"], cell["params"], 1, 40.0)
    assert abs(np.mean(offs % 4.0 >= 3.0) - 0.5) < 0.02
    steady = A.due_offsets(b.traffic("steady"), cell["params"], 1, 40.0)
    assert abs(np.mean(steady % 4.0 >= 3.0) - 0.25) < 0.02
    # the new configuration's stream puts 70% of the trades on symbol 0
    ev = MessageStream(cell["config"]["stream"], 1).take(20_000)
    trade = (ev["action"] == op.BUY) | (ev["action"] == op.SELL)
    assert (ev["sid"][trade] == 0).mean() > 0.65
    got = S.read_metrics(b, b.per_layer_for("serve-hot.bursty"), None)
    assert got == {"extra.count": {"value": 42.0, "unit": "n"}}
    after = _digest_tree(base)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_split_metric_shares_the_reader_of_its_stem():
    b = S.Benchmark()
    for name in ("device.idle_pct.backlog", "device.idle_pct.steady"):
        assert b.metric_path(name).endswith("metrics/device.idle_pct.py")
    assert b.metric_path("lat_p99_ms").endswith("metrics/lat_p99_ms.py")


def test_a_cell_file_that_disagrees_is_refused(tmp_path):
    base = tmp_path / "kmebench"
    shutil.copytree(S.HERE, base, ignore=shutil.ignore_patterns(
        "_build", "__pycache__", "tests"))
    name = DOC["workloads"][0]["name"]
    p = base / "cells" / (name + ".json")
    cf = json.loads(p.read_text())
    cf["chips"] = 4
    p.write_text(json.dumps(cf))
    with pytest.raises(ValueError):
        S.Benchmark(S.BENCHMARK, str(base)).cell(name)
