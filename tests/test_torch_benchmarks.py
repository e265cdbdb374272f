"""The port's benchmark (`kme_tpu_torch/benchmarks.py`, `kme-torch-bench`):
the main-path suites, the CLI and the gate, held against the JAX
package's `kme_tpu.benchmarks` on the CPU.

Each suite runs through both modules with the same small arguments and
seed (the port on `device="cpu"`, the kernels' plain versions; JAX on the
CPU as tests/conftest.py sets it). The two sides must give the same
`metric` and `unit`, the same detail keys (nested dicts included) and the
same deterministic fields: message, record, batch and step counts,
output sizes, parity verdicts, rejects, the engines' own counters. No
timing is compared. The deployment suites are in
tests/test_torch_benchmarks_deploy.py.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import kme_tpu.benchmarks as JB
import kme_tpu_torch.benchmarks as PB
from kme_tpu_torch import cli as PCLI

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# string fields that name the implementation: present on both sides,
# their values differ by design (the JAX package names its Pallas kernel
# and XLA platform, the port its CUDA kernel and torch device)
IMPL_FIELDS = ("engine", "method", "device_path_method", "backend")


def key_paths(d, pre=""):
    """Dotted paths of every key of a detail dict, into nested dicts; the
    `*_warning` keys, which a suite adds when a wall-clock ratio falls
    under its advisory mark, are left out."""
    out = set()
    for k, v in d.items():
        k = str(k)
        if k.endswith("_warning"):
            continue
        out.add(pre + k)
        if isinstance(v, dict):
            out |= key_paths(v, pre + k + ".")
    return out


def held(j, p, fields=(), nested=(), backend="cpu"):
    """`p` (the port's record) against `j` (the JAX package's); a
    `backend` of None leaves the detail's backend to `fields`."""
    assert (p["metric"], p["unit"]) == (j["metric"], j["unit"])
    assert set(p) == set(j) == {"metric", "value", "unit", "vs_baseline",
                                "detail"}
    jd, pd = j["detail"], p["detail"]
    assert key_paths(pd) == key_paths(jd)
    for f in fields:
        assert pd[f] == jd[f], f
    for f in nested:
        assert pd[f] == jd[f], f
    if "per_batch" in jd:
        assert len(pd["per_batch"]) == len(jd["per_batch"])
        assert [set(b) for b in pd["per_batch"]] == \
            [set(b) for b in jd["per_batch"]]
    for f in IMPL_FIELDS:
        assert (f in pd) == (f in jd), f
    if "backend" in pd and backend is not None:
        assert pd["backend"] == backend


SEQ_FIELDS = ("compat", "events", "symbols", "accounts", "workload",
              "zipf_a", "slots", "max_fills", "batch", "fetched_mb",
              "out_records", "out_mb", "cap_rejects", "parity_checked_msgs",
              "parity", "baseline_assumption_ops", "vs_baseline_note")


@pytest.fixture
def dev_reps(monkeypatch):
    monkeypatch.setenv("KME_BENCH_DEV_REPS", "1")


def test_seq_suite_fixed_with_journal_and_audit(tmp_path, dev_reps,
                                                cpu_devices):
    """`--suite lanes --engine seq` in fixed mode (full-stream parity
    against the native judge inside both runs), with the journal and
    audit rows."""
    kw = dict(events=600, symbols=8, accounts=128, seed=3, zipf_a=1.2,
              slots=128, max_fills=16, batch=256, with_java=False,
              audit=True)
    j = JB.bench_seq_engine(journal_out=str(tmp_path / "j.jsonl"), **kw)
    p = PB.bench_seq_engine(journal_out=str(tmp_path / "p.jsonl"),
                            device="cpu", **kw)
    held(j, p, SEQ_FIELDS, nested=("device_metrics",))
    jj, pj = j["detail"]["journal"], p["detail"]["journal"]
    assert (pj["events"], pj["audit_violations"]) == \
        (jj["events"], jj["audit_violations"]) == (jj["events"], 0)
    assert p["detail"]["parity_checked_msgs"] == p["detail"]["events"]
    assert p["detail"]["device_path_s"] > 0
    assert p["detail"]["device_metrics"]["trades_ok"] > 0
    # the journals record the same lifecycle events, line for line but
    # the wall clock
    def events(path):
        out = []
        with open(path) as f:
            for ln in f:
                ev = json.loads(ln)
                ev.pop("ts", None)
                ev.pop("wall", None)
                out.append(ev)
        return out
    assert events(pj["path"]) == events(jj["path"])


@pytest.mark.parametrize("events", [
    200, pytest.param(600, marks=pytest.mark.slow)])
def test_seq_suite_java(events, dev_reps, cpu_devices):
    """`--compat java`: the stock harness shape at 8192 slots, the full
    stream against the java judge inside both runs."""
    kw = dict(events=events, seed=1, batch=256, compat="java",
              with_java=False)
    j = JB.bench_seq_engine(**kw)
    p = PB.bench_seq_engine(device="cpu", **kw)
    held(j, p, SEQ_FIELDS, nested=("device_metrics",))
    assert p["metric"] == "orders_per_sec_java_exact_tpu"
    assert p["detail"]["cap_rejects"] == 0


@pytest.mark.slow
def test_seq_suite_java_sub_run(monkeypatch, dev_reps, cpu_devices):
    """The java sub-run that a fixed-mode run carries (`with_java`), its
    100,000 events cut to 200 on both sides through the module-level
    name the suite calls itself by."""
    def cut(mod):
        orig = mod.bench_seq_engine

        def small(**kw):
            kw["events"] = 200
            return orig(**kw)
        monkeypatch.setattr(mod, "bench_seq_engine", small)
        return orig

    kw = dict(events=300, symbols=8, accounts=128, seed=2, slots=128,
              batch=256, with_java=True)
    j = cut(JB)(**kw)
    p = cut(PB)(device="cpu", **kw)
    held(j, p, SEQ_FIELDS)
    for f in ("events", "parity_checked_msgs", "cap_rejects",
              "out_records"):
        assert p["detail"]["java"][f] == j["detail"]["java"][f], f


LANES_FIELDS = ("events", "symbols", "accounts", "workload", "zipf_a",
                "shards", "slots", "max_fills", "width", "sched_steps",
                "msgs_per_step", "trades", "out_records", "cap_rejects",
                "rejects", "parity_checked_msgs", "baseline_assumption_ops")


@pytest.mark.parametrize("workload", ["zipf", "cancel"])
def test_lanes_suite_sweep(workload, tmp_path, cpu_devices):
    """`--suite lanes --engine sweep`: the parity prefix inside both
    runs, the phased run's steps, trades and rejects; the port's
    `--profile` writes a Chrome trace."""
    kw = dict(events=600, symbols=8, accounts=64, seed=3, steps=16,
              slots=32, max_fills=16, parity_prefix=300,
              workload=workload)
    j = JB.bench_lane_engine(**kw)
    prof = str(tmp_path / "prof") if workload == "cancel" else None
    p = PB.bench_lane_engine(device="cpu", profile_dir=prof, **kw)
    held(j, p, LANES_FIELDS, nested=("device_metrics",))
    if prof:
        with open(os.path.join(prof, "trace.json")) as f:
            assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("engine", ["seq", "sweep"])
def test_latency_suite(engine, cpu_devices):
    kw = dict(events=600, symbols=8, accounts=32, seed=5, slots=32,
              max_fills=16, batch=256, engine=engine)
    j = JB.bench_latency(**kw)
    p = PB.bench_latency(device="cpu", **kw)
    held(j, p, ("events", "batch", "engine", "slots", "width", "shards",
                "batches"))
    d = p["detail"]
    assert d["p50_ms"] <= d["p99_ms"] <= d["max_ms"]


def test_seq_latency_row(cpu_devices):
    """The streaming-latency row that a fixed seq run of 50,000 events or
    more carries: submit/collect double-buffered, device time per batch
    from one timed scan over the whole stream."""
    args = (8, 128, 0, 1.2)
    kw = dict(events=1024, batch=256)
    j = JB._bench_seq_latency(*args, **kw)
    p = PB._bench_seq_latency(*args, device="cpu", **kw)
    assert key_paths(p) == key_paths(j)
    for f in ("batch", "batches", "events"):
        assert p[f] == j[f]
    assert len(p["per_batch"]) == len(j["per_batch"]) == p["batches"]
    assert p["backend"] == "cpu" and p["device_ms_per_batch"] > 0


def test_pipeline_suite(cpu_devices):
    """The in-process pipelined serving suite: pipelined bytes == serial
    bytes inside both runs, the same batches and output."""
    kw = dict(events=2048, symbols=8, accounts=128, seed=0, batch=512,
              depth=2)
    j = JB.bench_pipeline(**kw)
    p = PB.bench_pipeline(device="cpu", **kw)
    held(j, p, ("engine", "events", "symbols", "accounts", "batch",
                "depth", "batches", "out_mb", "parity"))
    assert p["detail"]["local_s"] > 0


def test_native_suite():
    kw = dict(events=3000, batch=1000)
    j = JB.bench_native_engine(**kw)
    p = PB.bench_native_engine(**kw)
    held(j, p, ("events", "batch", "compat", "out_lines",
                "baseline_assumption_ops"))
    with pytest.raises(ValueError, match="must exceed"):
        PB.bench_native_engine(events=100, batch=1000)


def test_parity_suite(cpu_devices):
    """The serial parity replica at the suite's caps."""
    kw = dict(events=300, seed=0, batch=128)
    j = JB.bench_parity_engine(**kw)
    p = PB.bench_parity_engine(device="cpu", **kw)
    held(j, p, ("events", "batch", "compat", "baseline_assumption_ops"))


def test_prof_suite(cpu_devices):
    """The profiling-overhead suite (host oracle service, observability
    off and on): MatchOut parity and the artifact's host plane inside
    both runs; the ceiling relaxed as in tests/test_prof.py, since the
    timing is not what is compared here."""
    kw = dict(events=1500, seed=7, batch=256, repeats=1,
              overhead_ceiling=10.0)
    j = JB.bench_prof(**kw)
    p = PB.bench_prof(**kw)
    held(j, p, ("suite", "events", "records", "seed", "batch", "repeats",
                "overhead_ceiling"))
    assert set(p["detail"]["prof_stage_fracs"]) == \
        set(j["detail"]["prof_stage_fracs"])
    assert p["detail"]["tsdb_samples"] > 0


def test_constants_equal_the_reference():
    for name in ("REFERENCE_BASELINE_OPS", "DEFAULT_WIDTH",
                 "DEFAULT_LATENCY_BATCH", "STORM_WORKLOADS",
                 "SEQ_DEFAULT_SLOTS"):
        assert getattr(PB, name) == getattr(JB, name), name
    for args in ((1025, 4096, 128, 16, 8), (1024, 2048, 128, 16, 1024),
                 (9, 64, 32, 16, 4)):
        assert PB._est_step_bytes(*args) == JB._est_step_bytes(*args)


def test_publish_pipeline_gauges():
    from kme_tpu_torch.telemetry import Registry

    reg = Registry()
    PB.publish_pipeline_gauges(reg, {
        "pipeline_speedup": 0.8, "device_ms_per_batch": 3.5,
        "measured_overlap_frac": 0.4, "pipeline_warning": "slow"})
    g = reg.snapshot()["gauges"]
    assert g["pipeline_speedup"] == 0.8
    assert g["pipeline_warning"] == 1


# ---- main: the flags, the gate, the card


def _actions(parser_main):
    """{dest: default} of every option `main` defines (its parser is
    built inside main, so capture it at parse time)."""
    import argparse

    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen.update({a.dest: (a.default, tuple(a.choices or ()))
                     for a in self._actions if a.dest != "help"})
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            parser_main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen


def test_main_flags_equal_the_reference_plus_device():
    j, p = _actions(JB.main), _actions(PB.main)
    assert p.pop("device") == ("cuda", ("cuda", "cpu"))
    assert p == j
    assert set(p["suite"][1]) == {
        "lanes", "parity", "native", "latency", "pipeline", "shards",
        "groups", "storms", "wire", "feed", "multihost", "prof"}


GATE_PAIRS = (("BENCH_r05.json", "BENCH_r05.json"),
              ("BENCH_r05.json", "BENCH_r06.json"),
              ("BENCH_r03.json", "BENCH_r04.json"),
              ("BASELINE_host.json", "BASELINE_host.json"),
              ("BASELINE_groups.json", "BASELINE_groups.json"),
              ("BASELINE_wire.json", "BASELINE_storms.json"),
              ("BENCH_r01.json", "BENCH_r05.json"))


@pytest.mark.parametrize("base,cur", GATE_PAIRS)
def test_gate_current_equals_reference(base, cur, tmp_path, capsys):
    """`--baseline B --gate-current C` over the recorded artifacts: the
    exit code, the report JSON and the printed report equal `kme-bench`'s
    (modulo the program name)."""
    for tol in ("0.25", "0.01"):
        argv = ["--baseline", os.path.join(REPO, base), "--gate",
                "--gate-current", os.path.join(REPO, cur),
                "--tolerance", tol]
        prc = PB.main(argv + ["--gate-report", str(tmp_path / "p.json")])
        perr = capsys.readouterr().err
        jrc = JB.main(argv + ["--gate-report", str(tmp_path / "j.json")])
        jerr = capsys.readouterr().err
        assert prc == jrc, (base, cur, tol)
        assert perr.replace("p.json", "j.json") == jerr.replace(
            "kme-bench --gate", "kme-torch-perfgate")
        if jrc == 2:    # no metrics to compare: no report either
            assert not (tmp_path / "p.json").exists()
            continue
        with open(tmp_path / "p.json") as f, open(tmp_path / "j.json") as g:
            assert json.load(f) == json.load(g)


def test_gate_exit_codes_equal_reference(tmp_path, capsys):
    """The cases of tests/test_perfgate.py's gate test, through both
    mains: clean 0, a planted 2x slowdown 1, a backend mismatch 0
    (advisory), metric-less baseline or current 2."""
    tail = ('_ms": 1.23, "local_orders_per_sec": 100000.0, '
            '"engine_side_p99_ms": 4.0, "backend": "cpu", '
            '"java": {"local_orders_per_sec": 5000.0}')

    def art(name, t):
        path = str(tmp_path / name)
        with open(path, "w") as f:
            json.dump({"n": 5, "cmd": ["kme-bench"], "rc": 0, "tail": t,
                       "parsed": None}, f)
        return path

    base = art("base.json", tail)
    slow = art("slow.json", tail.replace("100000.0", "50000.0")
               .replace('p99_ms": 4.0', 'p99_ms": 8.0'))
    tpu = art("tpu.json", tail.replace('"cpu"', '"tpu"'))
    empty = str(tmp_path / "empty.json")
    with open(empty, "w") as f:
        f.write("no numbers here")
    for b, c, want in ((base, base, 0), (base, slow, 1), (tpu, slow, 0),
                       (empty, base, 2), (base, empty, 2)):
        argv = ["--baseline", b, "--gate", "--gate-current", c]
        prc = PB.main(argv)
        capsys.readouterr()
        assert prc == JB.main(argv) == want, (b, c)
        capsys.readouterr()


def test_gate_requires_baseline():
    for argv in (["--gate"], ["--gate-current", "x.json"]):
        with pytest.raises(SystemExit):
            PB.main(argv)


def test_gate_on_a_live_run(tmp_path, capsys, cpu_devices):
    """`--gate` after a run: the live detail (with the headline value as
    `orders_per_sec` when its unit is orders/sec) gated against itself
    passes; against a baseline of twice its rate it fails."""
    argv = ["--suite", "prof", "--events", "1500", "--batch", "256",
            "--device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        # the always-on ceiling is a timing assertion; relax it here
        real = PB.bench_prof
        mp.setattr(PB, "bench_prof",
                   lambda *a, **k: real(*a, **dict(k, repeats=1,
                                                   overhead_ceiling=10.0)))
        assert PB.main(argv) == 0
        out = capsys.readouterr()
        head = json.loads(out.out.strip().splitlines()[-1])
        detail = json.loads(out.err.strip().splitlines()[-1])
        assert set(head) == {"metric", "value", "unit", "vs_baseline"}
        assert head["metric"] == "orders_per_sec"
        base = tmp_path / "fast.json"
        base.write_text(json.dumps(dict(detail,
                                        orders_per_sec=head["value"] * 4)))
        rc = PB.main(argv + ["--baseline", str(base), "--gate"])
        assert rc == 1
        assert "orders_per_sec" in capsys.readouterr().err


def test_cli_bench_without_a_card_exits_nonzero():
    """`kme-torch-bench` (here `python -m kme_tpu_torch.cli bench` and
    `python -m kme_tpu_torch.benchmarks`) on this card-less box exits
    non-zero naming the card, and never runs a suite on the CPU unless
    `--device cpu` says so; `--gate-current` runs no suite and needs no
    card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    for cmd in (["-m", "kme_tpu_torch.cli", "bench"],
                ["-m", "kme_tpu_torch.benchmarks", "--suite", "storms"]):
        r = subprocess.run([sys.executable, *cmd], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 2, r.stderr
        assert "no CUDA card" in r.stderr
        assert r.stdout == ""
    base = os.path.join(REPO, "BASELINE_host.json")
    r = subprocess.run([sys.executable, "-m", "kme_tpu_torch.cli", "bench",
                        "--baseline", base, "--gate-current", base],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "gate clean" in r.stderr


def test_cli_bench_runs_a_suite_on_the_cpu_when_asked():
    """`python -m kme_tpu_torch.cli bench --device cpu` with the JAX
    package blocked: one JSON line on stdout, the detail on stderr."""
    block = ("import runpy, sys\n"
             "class B:\n"
             "    def find_spec(self, n, p=None, t=None):\n"
             "        if n.split('.')[0] in ('jax', 'kme_tpu'):\n"
             "            raise ImportError('blocked: ' + n)\n"
             "sys.meta_path.insert(0, B())\n"
             "sys.argv = ['cli'] + sys.argv[1:]\n"
             "runpy.run_module('kme_tpu_torch.cli', run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", block, "bench", "--suite",
                        "storms", "--events", "1000", "--device", "cpu"],
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    head = json.loads(lines[0])
    assert head["metric"] == "storm_shed_frac_max"
    detail = json.loads(r.stderr.strip().splitlines()[-1])
    assert detail["suite"] == "storms"


def test_bench_is_a_cli_command():
    assert PCLI.bench_main is not None
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["kme-torch-bench"] == "kme_tpu_torch.cli:bench_main"
