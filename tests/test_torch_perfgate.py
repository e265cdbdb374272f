"""The port's perf-regression gate and stage attribution
(`kme_tpu_torch/perfgate.py`, `kme-torch-prof --diff`).

- analogs of tests/test_perfgate.py (metric extraction from truncated
  artifacts, direction-aware comparison, the gate's exit codes, here
  through `python -m kme_tpu_torch.perfgate`) and of the attribution
  cases of tests/test_prof.py;
- held against `kme_tpu.perfgate` in the same process, exactly: every
  recorded artifact loads to the same dict, and every ordered pair of
  them compares, reports, attributes and gates alike;
- `kme-torch-prof --diff` prints what `kme-prof --diff` prints over TSDB
  stores written by either package, and over artifacts.
"""

import glob
import itertools
import json
import os
import subprocess
import sys

import pytest
import torch

from kme_tpu import cli as JCLI
from kme_tpu import perfgate as JPG
from kme_tpu.telemetry.tsdb import TSDB as JTSDB
from kme_tpu_torch import cli as PCLI
from kme_tpu_torch import perfgate
from kme_tpu_torch.telemetry.tsdb import TSDB

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "BENCH_r05.json")
ARTIFACTS = sorted(
    os.path.basename(p) for pat in ("BENCH_r0*.json", "MULTICHIP_r0*.json",
                                    "BASELINE*.json")
    for p in glob.glob(os.path.join(REPO, pat)))

# a driver-format artifact whose tail starts MID-OBJECT, the way the
# recorded BENCH_r0N.json files are truncated; the java sub-dict
# repeats metric names and must NOT shadow the root values
_TAIL = (
    '_ms": 1.23, "local_orders_per_sec": 100000.0, '
    '"engine_side_p50_ms": 2.0, "engine_side_p99_ms": 4.0, '
    '"device_ms_per_batch": 5.0, "backend": "cuda", '
    '"pipeline_speedup": 1.4, '
    '"java": {"local_orders_per_sec": 5000.0, "engine_side_p99_ms": 99.0}'
)


def _artifact(tmp_path, name="base.json", tail=_TAIL):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        json.dump({"n": 5, "cmd": ["kme-bench"], "rc": 0,
                   "tail": tail, "parsed": None}, f)
    return p


def test_extract_metrics_truncated_first_wins():
    m = perfgate.extract_metrics(_TAIL)
    assert m["local_orders_per_sec"] == 100000.0     # root, not java's
    assert m["engine_side_p99_ms"] == 4.0
    assert perfgate.extract_backend(_TAIL) == "cuda"
    # scientific notation and negatives parse
    m2 = perfgate.extract_metrics('"p99_ms": 1.5e-2, "x": -3')
    assert m2["p99_ms"] == pytest.approx(0.015) and m2["x"] == -3


def test_load_artifact_shapes(tmp_path):
    art = perfgate.load_artifact(_artifact(tmp_path))
    assert art["source"] == "driver-tail"
    assert art["metrics"]["device_ms_per_batch"] == 5.0
    # plain detail JSON and raw text both load
    pj = str(tmp_path / "detail.json")
    with open(pj, "w") as f:
        json.dump({"p99_ms": 3.0, "backend": "tpu"}, f)
    art2 = perfgate.load_artifact(pj)
    assert art2["source"] == "json" and art2["backend"] == "tpu"
    pt = str(tmp_path / "raw.txt")
    with open(pt, "w") as f:
        f.write('garbage then "p50_ms": 7 more garbage')
    assert perfgate.load_artifact(pt)["metrics"]["p50_ms"] == 7.0
    # a live detail dict adapts to the same shape
    live = perfgate.detail_to_artifact({"p99_ms": 2.5, "backend": "cuda",
                                        "java": {"p99_ms": 9.0}})
    assert live == {"metrics": {"p99_ms": 2.5}, "backend": "cuda",
                    "source": "live"}


def test_compare_direction_aware():
    base = {"metrics": {"local_orders_per_sec": 100.0, "p99_ms": 10.0},
            "backend": "cuda"}
    # throughput UP and latency DOWN are both improvements
    good = {"metrics": {"local_orders_per_sec": 150.0, "p99_ms": 5.0},
            "backend": "cuda"}
    rep = perfgate.compare(base, good, tolerance=0.25)
    assert rep["ok"] and rep["regressions"] == []
    # throughput falling 2x regresses; latency rising 2x regresses
    bad = {"metrics": {"local_orders_per_sec": 50.0, "p99_ms": 20.0},
           "backend": "cuda"}
    rep = perfgate.compare(base, bad, tolerance=0.25)
    assert not rep["ok"]
    assert set(rep["regressions"]) == {"local_orders_per_sec", "p99_ms"}
    # inside tolerance is clean
    meh = {"metrics": {"local_orders_per_sec": 90.0, "p99_ms": 11.0},
           "backend": "cuda"}
    assert perfgate.compare(base, meh, tolerance=0.25)["ok"]


def test_compare_backend_mismatch_is_advisory():
    # a TPU or CPU baseline against a card run: magnitudes do not compare
    for other in ("tpu", "cpu"):
        base = {"metrics": {"p99_ms": 10.0}, "backend": other}
        bad = {"metrics": {"p99_ms": 100.0}, "backend": "cuda"}
        rep = perfgate.compare(base, bad)
        assert rep["backend_mismatch"] and rep["advisory"]
        assert rep["regressions"] == ["p99_ms"]   # reported...
        assert rep["ok"]                          # ...but not enforced
        assert "ADVISORY" in perfgate.format_report(rep)


def test_compare_advisory_metrics_never_regress():
    base = {"metrics": {"pipeline_speedup": 2.0, "p99_ms": 1.0},
            "backend": "cuda"}
    cur = {"metrics": {"pipeline_speedup": 0.5, "p99_ms": 1.0},
           "backend": "cuda"}
    rep = perfgate.compare(base, cur)
    assert rep["ok"] and rep["regressions"] == []
    row = [r for r in rep["metrics"] if r["name"] == "pipeline_speedup"]
    assert row and row[0]["status"] == "advisory"


def test_checked_in_baseline_is_usable():
    """BENCH_r05.json keeps yielding gated metrics through the
    truncated-tail loader."""
    art = perfgate.load_artifact(BASELINE)
    assert art["source"] == "driver-tail"
    gated = set(art["metrics"]) & set(perfgate.GATED_METRICS)
    assert gated, "no gated metrics extracted from BENCH_r05.json"
    assert art["backend"] == "tpu"


def test_gate_cli_exit_codes(tmp_path, capsys):
    base = _artifact(tmp_path, "base.json")
    # self-compare: clean, exit 0
    assert perfgate.main([base, base]) == 0
    assert "gate clean" in capsys.readouterr().err
    # doctored 2x slowdown: exit 1 with the regression named
    slow = _artifact(tmp_path, "slow.json", tail=_TAIL
                     .replace('"local_orders_per_sec": 100000.0',
                              '"local_orders_per_sec": 50000.0')
                     .replace('"engine_side_p99_ms": 4.0',
                              '"engine_side_p99_ms": 8.0'))
    report = str(tmp_path / "report.json")
    rc = perfgate.main([base, slow, "--tolerance", "0.25",
                        "--report", report])
    assert rc == 1
    err = capsys.readouterr().err
    assert "REGRESSION" in err and "engine_side_p99_ms" in err
    assert "the device stage moved the most" in err
    rep = json.loads(open(report).read())
    assert "local_orders_per_sec" in rep["regressions"]
    assert rep["attribution"]["suspect"] == "device"
    # backend mismatch (cuda current vs tpu-flagged baseline): advisory 0
    tpu_base = _artifact(tmp_path, "tpu.json",
                         tail=_TAIL.replace('"backend": "cuda"',
                                            '"backend": "tpu"'))
    assert perfgate.main([tpu_base, slow]) == 0
    assert "ADVISORY" in capsys.readouterr().err


def test_gate_cli_unusable_baseline_exits_2(tmp_path, capsys):
    empty = str(tmp_path / "empty.json")
    with open(empty, "w") as f:
        f.write("no numbers here")
    base = _artifact(tmp_path)
    # metric-less BASELINE → 2
    assert perfgate.main([empty, base]) == 2
    assert "kme-torch-perfgate: no metrics found" in capsys.readouterr().err
    # a metric-less CURRENT compares nothing: clean, as in the reference;
    # attribution needs metrics on both sides → 2
    assert perfgate.main([base, empty]) == JPG.main([base, empty]) == 0
    assert perfgate.main([base, empty, "--attribute"]) == 2
    assert "no metrics on one side" in capsys.readouterr().err


def test_gate_requires_both_operands():
    with pytest.raises(SystemExit):
        perfgate.main([])
    with pytest.raises(SystemExit):
        perfgate.main([BASELINE])


# ---------------------------------------------------------------------------
# stage-level regression attribution


def _window(p99_device=2.0, p99_e2e=5.0, frac_dispatch=0.3):
    return {"lat_ingress.p99_ms": 0.4, "lat_plan.p99_ms": 0.6,
            "lat_device.p99_ms": p99_device, "lat_produce.p99_ms": 0.8,
            "lat_e2e.p99_ms": p99_e2e, "prof_stage_frac_parse": 0.1,
            "prof_stage_frac_plan": 0.2,
            "prof_stage_frac_dispatch": frac_dispatch,
            "prof_stage_frac_produce": 0.3}


def test_attribution_names_planted_device_regression():
    """A planted 2x device-stage slowdown (which also moves e2e): the
    verdict names `device`, never the e2e symptom."""
    att = perfgate.attribute_regression(
        _window(), _window(p99_device=4.0, p99_e2e=8.5, frac_dispatch=0.55))
    assert att["suspect"] == "device"
    assert att["stages"][0]["stage"] == "device"
    ev = {e["name"]: e["ratio"] for e in att["stages"][0]["evidence"]}
    assert ev["lat_device.p99_ms"] == 2.0
    txt = perfgate.format_attribution(att)
    assert "the device stage moved the most" in txt

    # unchanged windows: nobody accused
    att = perfgate.attribute_regression(_window(), _window())
    assert att["suspect"] is None
    assert "no stage moved beyond 5%" in perfgate.format_attribution(att)

    # only the symptom moved: e2e is named
    att = perfgate.attribute_regression(_window(), _window(p99_e2e=9.0))
    assert att["suspect"] == "e2e"


def _stores(tmp_path, make_a, make_b, prefix=""):
    """Two TSDB windows, a planted produce-stage slowdown in the second;
    `make_a` writes the base store, `make_b` the current one."""
    base = str(tmp_path / f"{prefix}base")
    cur = str(tmp_path / f"{prefix}cur")
    for make, store, p99, frac in ((make_a, base, 1.0, 0.2),
                                   (make_b, cur, 3.0, 0.6)):
        db = make(store, source="serve")
        for i in range(4):
            db.append_snapshot(
                {"gauges": {"prof_stage_frac_produce": frac,
                            "prof_stage_frac_plan": 0.1},
                 "latencies": {
                     "lat_produce": {"p99_ms": p99},
                     "lat_plan": {"p99_ms": 0.5},
                     "lat_e2e": {"p99_ms": 2.0 + p99}}},
                i)
        db.close()
    return base, cur


def test_kme_torch_prof_diff_names_planted_regression(tmp_path, capsys):
    """End to end over real TSDB history: two windows, a planted
    produce-stage slowdown, kme-torch-prof --diff names the stage."""
    base, cur = _stores(tmp_path, TSDB, TSDB)
    assert PCLI.prof_main(["--diff", base, cur, "--json"]) == 0
    att = json.loads(capsys.readouterr().out)
    assert att["suspect"] == "produce"
    assert PCLI.prof_main(["--diff", base, cur]) == 0
    assert "the produce stage moved the most" in capsys.readouterr().out
    # a store against itself: nobody accused
    assert PCLI.prof_main(["--diff", base, base, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["suspect"] is None
    # another writer's series only: nothing on either side → 2
    assert PCLI.prof_main(["--diff", base, cur, "--source", "feed"]) == 2
    assert "no metrics on one side" in capsys.readouterr().err


def test_perfgate_attribute_cli_over_bench_artifacts(tmp_path):
    """`python -m kme_tpu_torch.perfgate BASELINE CURRENT --attribute`
    over bench detail files: exit 1 + suspect named when a stage moved."""
    base, cur = str(tmp_path / "b.json"), str(tmp_path / "c.json")
    for path, dev in ((base, 2.0), (cur, 5.0)):
        with open(path, "w") as f:
            json.dump({"metric": "orders_per_sec", "value": 1.0,
                       "detail": {"device_ms_per_batch": dev,
                                  "p99_ms": 3.0 + dev,
                                  "plan_s": 0.1}}, f)
    rep = str(tmp_path / "att.json")
    assert perfgate.main([base, cur, "--attribute", "--report", rep]) == 1
    att = json.load(open(rep))
    assert att["suspect"] == "device"
    # clean pair: exit 0, no suspect
    assert perfgate.main([base, base, "--attribute"]) == 0


# ---------------------------------------------------------------------------
# held against kme_tpu.perfgate


def test_tables_equal_the_reference():
    assert perfgate.GATED_METRICS == JPG.GATED_METRICS
    assert list(perfgate.GATED_METRICS) == list(JPG.GATED_METRICS)
    assert perfgate.ADVISORY_METRICS == JPG.ADVISORY_METRICS
    assert perfgate.STAGE_ATTRIBUTION == JPG.STAGE_ATTRIBUTION
    assert list(perfgate.STAGE_ATTRIBUTION) == list(JPG.STAGE_ATTRIBUTION)


def test_recorded_artifacts_are_all_there():
    assert len(ARTIFACTS) == 19
    backends = {perfgate.load_artifact(os.path.join(REPO, a))["backend"]
                for a in ARTIFACTS}
    assert {"tpu", "cpu", "native", "oracle", None} <= backends


@pytest.mark.parametrize("name", ARTIFACTS)
def test_load_artifact_equals_reference(name):
    path = os.path.join(REPO, name)
    got = perfgate.load_artifact(path)
    assert got == JPG.load_artifact(path)
    text = open(path, encoding="utf-8", errors="replace").read()
    assert perfgate.extract_metrics(text) == JPG.extract_metrics(text)
    assert perfgate.extract_backend(text) == JPG.extract_backend(text)


def test_every_pair_of_artifacts_equals_reference(capsys):
    """Every ordered pair of the recorded artifacts (a pair with itself
    too): the report dicts, the report text, the attribution and its
    text, and the gate's exit code and stderr (modulo the program name)
    equal the JAX package's."""
    arts = {a: (perfgate.load_artifact(os.path.join(REPO, a)),
                JPG.load_artifact(os.path.join(REPO, a))) for a in ARTIFACTS}
    gated = 0
    for a, b in itertools.product(ARTIFACTS, repeat=2):
        (pa, ja), (pb, jb) = arts[a], arts[b]
        for tol in (0.25, 0.05):
            rep = perfgate.compare(pa, pb, tolerance=tol)
            assert rep == JPG.compare(ja, jb, tolerance=tol), (a, b, tol)
            assert perfgate.format_report(rep) == JPG.format_report(rep)
        att = perfgate.attribute_regression(pa["metrics"], pb["metrics"])
        assert att == JPG.attribute_regression(ja["metrics"], jb["metrics"])
        assert perfgate.format_attribution(att) == \
            JPG.format_attribution(att)
        prc = perfgate.run_gate(os.path.join(REPO, a), pb)
        perr = capsys.readouterr().err
        jrc = JPG.run_gate(os.path.join(REPO, a), jb)
        jerr = capsys.readouterr().err
        assert prc == jrc, (a, b)
        assert perr == jerr.replace("kme-bench --gate", "kme-torch-perfgate")
        gated += prc != 2
    # some pairs gate, and some exit 1: the comparison is not vacuous
    assert gated > 0


def test_main_equals_reference_over_artifacts(tmp_path, capsys):
    """`main` of both modules over recorded artifacts: exit codes and
    printed attribution equal, gate and --attribute."""
    pairs = (("BENCH_r05.json", "BENCH_r06.json"),
             ("BENCH_r03.json", "BENCH_r04.json"),
             ("BASELINE_host.json", "BASELINE_host.json"),
             ("BENCH_r01.json", "BENCH_r05.json"))
    for a, b in pairs:
        for extra in ([], ["--attribute"], ["--tolerance", "0.01"]):
            argv = [os.path.join(REPO, a), os.path.join(REPO, b), *extra]
            prc = perfgate.main(argv)
            pout = capsys.readouterr()
            jrc = JPG.main(argv)
            jout = capsys.readouterr()
            assert prc == jrc, (a, b, extra)
            assert pout.out == jout.out
            assert pout.err == (jout.err.replace("kme-bench --gate",
                                                 "kme-torch-perfgate")
                                .replace("kme-perfgate",
                                         "kme-torch-perfgate"))


def _prof(cli, argv, capsys):
    rc = cli.prof_main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("writers", ["port,port", "jax,jax", "port,jax",
                                     "jax,port"])
def test_prof_diff_equals_reference_over_stores(tmp_path, capsys, writers):
    """`kme-torch-prof --diff` == `kme-prof --diff` over stores that
    either package's TSDB wrote, both ways round: --json, text, a
    store against itself and an artifact against a store."""
    make = {"port": TSDB, "jax": JTSDB}
    wa, wb = writers.split(",")
    base, cur = _stores(tmp_path, make[wa], make[wb])
    for argv in (["--diff", base, cur, "--json"], ["--diff", cur, base],
                 ["--diff", base, base, "--json"],
                 ["--diff", base, cur, "--source", "serve", "--json"],
                 ["--diff", base, cur, "--source", "feed"],
                 ["--diff", BASELINE, cur, "--json"]):
        p = _prof(PCLI, argv, capsys)
        j = _prof(JCLI, argv, capsys)
        assert p[:2] == j[:2], argv
        assert p[2] == j[2].replace("kme-prof", "kme-torch-prof")
    rc, out, _ = _prof(PCLI, ["--diff", base, cur, "--json"], capsys)
    assert rc == 0 and json.loads(out)["suspect"] == "produce"


def test_python_m_perfgate_mirrors_reference(tmp_path):
    """`python -m kme_tpu_torch.perfgate` with the JAX package blocked
    gives `python -m kme_tpu.perfgate`'s exit codes and stdout."""
    base = _artifact(tmp_path, "base.json")
    slow = _artifact(tmp_path, "slow.json",
                     tail=_TAIL.replace('"device_ms_per_batch": 5.0',
                                        '"device_ms_per_batch": 10.0'))
    block = ("import runpy, sys\n"
             "class B:\n"
             "    def find_spec(self, n, p=None, t=None):\n"
             "        if n.split('.')[0] in ('jax', 'kme_tpu', 'torch'):\n"
             "            raise ImportError('blocked: ' + n)\n"
             "sys.meta_path.insert(0, B())\n"
             "sys.argv = ['perfgate'] + sys.argv[1:]\n"
             "runpy.run_module('kme_tpu_torch.perfgate', "
             "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    for argv, want in (([base, base], 0), ([base, slow], 1),
                       ([base, slow, "--attribute"], 1)):
        p = subprocess.run([sys.executable, "-c", block, *argv], cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=60)
        j = subprocess.run([sys.executable, "-m", "kme_tpu.perfgate",
                            *argv], cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=120)
        assert p.returncode == j.returncode == want, (argv, p.stderr)
        assert p.stdout == j.stdout
