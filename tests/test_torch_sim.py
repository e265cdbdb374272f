"""The port's deterministic whole-cluster simulation
(`kme_tpu_torch/sim/`): the analogs of tests/test_sim.py, and the port
held against the JAX package's simulator on the same schedules.

- the analogs pin the simulation's own contracts on the port: one seed
  gives byte-identical digests, the virtual clock and the seeded
  scheduler are the only time and ordering sources, generated gates can
  fire, the transport delivers in stamp order across a crash window, a
  calm run, a crash, a reshard and grammar faults stay green, and the
  planted stamp-reset bug is found, shrunk and replayed red;
- across packages: `generate_schedule`, the trace and MatchOut digests,
  verdicts, counters and virtual time of `run_sim` for the reference
  tests' seeds (5, 6, 11, 13, 17, the planted bug included), the
  shrinker's repro, and the digests `chip_smoke.py` holds the card
  machine's `kme-torch-sim` to;
- both packages keep a process-global fault plan: neither run leaves a
  plan behind, and neither package's plan reaches the other's run.
"""

import json
import os
import shlex
import sys

import pytest
import torch

from kme_tpu import faults as jfaults
from kme_tpu.sim import cluster as JCL
from kme_tpu.sim import schedule as JSCH
from kme_tpu.sim import shrink as JSHR
from kme_tpu_torch import faults
from kme_tpu_torch.sim.cluster import PLANTED_BUGS, run_sim
from kme_tpu_torch.sim.sched import SimClockView, SimScheduler
from kme_tpu_torch.sim.schedule import (SIM_POINTS, SIM_STORMS,
                                        FaultSchedule, generate_schedule)
from kme_tpu_torch.sim.transport import SimTransport

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as CS  # noqa: E402


# ---------------------------------------------------------------------------
# scheduler + clock units


def test_virtual_clock_view_shares_now_with_private_skew():
    sched = SimScheduler(seed=1)
    a, b = SimClockView(sched), SimClockView(sched)
    sched.now = 5.0
    a.skew = 0.25
    assert a.time() == 5.25 and b.time() == 5.0
    assert a.monotonic() == 5.0     # skew never touches monotonic
    assert a.time_ns() == int(5.25e9)


def test_virtual_sleep_charges_scheduler_not_wall_clock():
    sched = SimScheduler(seed=1)
    view = SimClockView(sched)
    view.sleep(3.0)
    assert sched.sleep_charge == 3.0
    assert sched.now == 0.0         # nothing blocked, nothing advanced


def test_scheduler_same_seed_same_interleaving():
    def run(seed):
        sched = SimScheduler(seed=seed)

        class A:
            def __init__(self, name):
                self.name, self.n, self.stopped = name, 0, False

            def step(self):
                self.n += 1
                sched.trace(self.name, "step", n=self.n)
                if self.n >= 5:
                    self.stopped = True
                return True

        for name in ("x", "y", "z"):
            sched.add_actor(name, A(name))
        sched.run(until=lambda: False, max_vtime=10.0)
        return sched.digest()

    assert run(7) == run(7)
    assert run(7) != run(8)


def test_scheduler_tie_break_is_insertion_order():
    sched = SimScheduler(seed=1)
    seen = []
    for i in range(5):
        sched.post(1.0, lambda i=i: seen.append(i))
    sched.run(until=lambda: False, max_vtime=10.0)
    assert seen == [0, 1, 2, 3, 4]


# ---------------------------------------------------------------------------
# schedule generation


def test_generate_schedule_is_deterministic_and_serializable():
    a = generate_schedule(42, num_events=200)
    b = generate_schedule(42, num_events=200)
    assert a.to_json() == b.to_json()
    assert generate_schedule(43, num_events=200).to_json() != a.to_json()
    rt = FaultSchedule.from_json(a.to_json())
    assert rt.to_json() == a.to_json()


def test_generated_gates_can_actually_fire():
    """broker./ckpt. call sites pass no offset to faults.fire, so an
    `at=` gate there would never trigger: the generator uses hit-count
    (`after=`) gates for them."""
    for seed in range(60):
        s = generate_schedule(seed, num_events=100)
        for clause in s.clauses:
            point = clause.split(":", 1)[0]
            assert point in SIM_POINTS
            if point.startswith(("broker.", "ckpt.")):
                assert "after=" in clause and "at=" not in clause, clause
            else:
                assert "at=" in clause, clause
        for ev in s.events:
            if ev["kind"] == "reshard":
                assert ev["to"] in (2, 3, 4) and ev["to"] != s.ngroups
            if ev["kind"] == "storm":
                assert ev["profile"] in SIM_STORMS


def test_schedule_spec_prefixes_grammar_seed():
    s = FaultSchedule(seed=9, clauses=["broker.produce:n=1:after=3"])
    assert s.spec() == "seed=9;broker.produce:n=1:after=3"
    assert FaultSchedule(seed=9).spec() is None


@pytest.mark.parametrize("num_events", [40, 100, 400])
def test_generate_schedule_equals_jax_package(num_events):
    """Every seed's schedule, and its canonical JSON, is the JAX
    package's (both draw from the same seeded stream in the same order
    over the same storm profiles)."""
    assert SIM_POINTS == JSCH.SIM_POINTS and SIM_STORMS == JSCH.SIM_STORMS
    for seed in range(40):
        for profile in (None, "hot-book"):
            got = generate_schedule(seed, num_events=num_events,
                                    ngroups=2 + seed % 3, profile=profile)
            want = JSCH.generate_schedule(seed, num_events=num_events,
                                          ngroups=2 + seed % 3,
                                          profile=profile)
            assert got.to_json() == want.to_json()
            assert got.describe() == want.describe()
            assert got.spec() == want.spec()


# ---------------------------------------------------------------------------
# transport: stamp-ordered delivery across a crash window


def test_transport_fifo_survives_crash_window(tmp_path):
    from kme_tpu_torch.bridge.broker import InProcessBroker
    from kme_tpu_torch.bridge.provision import provision

    sched = SimScheduler(seed=3)
    view = SimClockView(sched)
    broker = InProcessBroker(persist_dir=str(tmp_path / "log"),
                             clock=view)
    provision(broker, topics=("MatchIn.g0",))
    up = [True]
    t = SimTransport(sched, 1,
                     broker_for=lambda g: broker if up[0] else None,
                     topic_for=lambda g: "MatchIn.g0")

    def feeder():
        # 30 sends; the "leader" dies under the middle third, so those
        # deliveries park while later ones keep arriving
        for i in range(30):
            t.send(0, None, f"rec{i}")

    sched.post(0.0, feeder)
    sched.post(0.003, lambda: up.__setitem__(0, False))

    def restart():
        up[0] = True
        t.flush_held(0)

    sched.post(0.010, restart)
    sched.run(until=lambda: False, max_vtime=5.0)

    recs = broker.fetch("MatchIn.g0", 0, 10 ** 6)
    assert [r.value for r in recs] == [f"rec{i}" for i in range(30)]
    assert [r.out_seq for r in recs] == list(range(30))
    assert broker.dup_suppressed == 0       # no input loss, no dups
    assert t.idle()


def test_transport_reshape_resumes_cursors():
    sched = SimScheduler(seed=3)
    t = SimTransport(sched, 2, broker_for=lambda g: None,
                     topic_for=lambda g: f"MatchIn.g{g}")
    t.reshape(3, cursors=[5, 0, 7])
    assert [l.seq for l in t.links] == [5, 0, 7]
    assert [l.next_deliver for l in t.links] == [5, 0, 7]


# ---------------------------------------------------------------------------
# whole-cluster runs (small workloads: tier-1 budget)


def _calm(seed, num_events=40, **kw):
    return FaultSchedule(seed=seed, num_events=num_events, **kw)


def test_sim_calm_run_is_green(tmp_path):
    res = run_sim(_calm(3), str(tmp_path))
    assert res.ok, res.verdicts
    assert res.red_verdicts() == []
    assert res.counters["crashes"] == 0
    assert res.counters["delivered"] > 0


def test_sim_same_seed_byte_identical_digests(tmp_path):
    sched = FaultSchedule(
        seed=11, num_events=40,
        clauses=["net.delay:n=1:at=9:ms=50"],
        events=[{"kind": "crash", "group": 0, "at": 25}])
    a = run_sim(sched, str(tmp_path / "a"))
    b = run_sim(sched, str(tmp_path / "b"))
    assert a.trace_digest == b.trace_digest
    assert a.out_digest == b.out_digest
    assert a.ok and b.ok and a.counters == b.counters


def test_sim_different_seeds_diverge(tmp_path):
    a = run_sim(_calm(21), str(tmp_path / "a"))
    b = run_sim(_calm(22), str(tmp_path / "b"))
    assert a.trace_digest != b.trace_digest
    assert a.out_digest != b.out_digest


def test_sim_crash_recovery_is_green(tmp_path):
    sched = FaultSchedule(
        seed=5, num_events=40,
        events=[{"kind": "crash", "group": 1, "at": 20}])
    res = run_sim(sched, str(tmp_path))
    assert res.ok, res.verdicts
    assert res.counters["crashes"] == 1


def test_sim_reshard_mid_run_is_green(tmp_path):
    sched = FaultSchedule(
        seed=13, num_events=40,
        events=[{"kind": "reshard", "at": 22, "to": 3}])
    res = run_sim(sched, str(tmp_path))
    assert res.ok, res.verdicts
    assert res.counters["resharded"] == 1
    # post-reshard topology really served: three final-gen groups
    assert len(res.verdicts["conservation"]["pending_reserve"]) == 3


def test_sim_grammar_faults_fire_and_stay_green(tmp_path):
    sched = FaultSchedule(
        seed=17, num_events=40,
        clauses=["net.partition:n=1:at=7:ms=50",
                 "net.reorder:n=1:at=30:ms=20",
                 "broker.produce:n=1:after=25"])
    res = run_sim(sched, str(tmp_path))
    assert res.ok, res.verdicts
    assert res.counters["faults_fired"] >= 2


def test_sim_faults_never_leak_into_process_plan(tmp_path):
    run_sim(_calm(3, clauses=["broker.fetch:n=1:after=5"]),
            str(tmp_path))
    assert not faults.active()      # run_sim clears on every exit


def test_sim_rejects_ungrouped_topology(tmp_path):
    with pytest.raises(ValueError):
        run_sim(_calm(3, ngroups=1), str(tmp_path))


# ---------------------------------------------------------------------------
# the planted-bug drill: find -> shrink -> offline red replay


def test_planted_bug_is_red_only_when_armed(tmp_path):
    sched = FaultSchedule(
        seed=5, num_events=40,
        events=[{"kind": "crash", "group": 0, "at": 20}])
    clean = run_sim(sched, str(tmp_path / "clean"))
    assert clean.ok
    assert "stamp-reset" in PLANTED_BUGS
    bugged = run_sim(sched, str(tmp_path / "bug"),
                     planted_bug="stamp-reset")
    assert not bugged.ok
    assert "stamps" in bugged.red_verdicts()


def test_unknown_planted_bug_is_an_error(tmp_path):
    with pytest.raises(ValueError):
        run_sim(_calm(3), str(tmp_path), planted_bug="nope")


# a noisy schedule: the planted bug needs only the crash; everything else
# is shrinkable adversity
NOISY = FaultSchedule(
    seed=6, num_events=40,
    clauses=["net.delay:n=1:at=9:ms=20",
             "broker.fetch:n=1:after=30"],
    events=[{"kind": "crash", "group": 0, "at": 20},
            {"kind": "storm", "profile": "cancel-storm",
             "at": 28, "n": 30}])


def test_shrinker_reduces_to_minimal_crash_and_repro_replays_red(
        tmp_path):
    from kme_tpu_torch.sim.shrink import shrink_schedule

    sr = shrink_schedule(FaultSchedule.from_json(NOISY.to_json()),
                         str(tmp_path), max_runs=32,
                         planted_bug="stamp-reset")
    assert sr is not None and sr.removed >= 2
    assert sr.schedule.size() <= 3
    assert any(ev["kind"] == "crash" for ev in sr.schedule.events)
    assert not sr.result.ok

    # the written repro is self-contained and replays red offline
    with open(sr.repro_path) as f:
        rt = FaultSchedule.from_json(f.read())
    replay = run_sim(rt, str(tmp_path / "replay"),
                     planted_bug="stamp-reset")
    assert not replay.ok
    # and the same schedule without the bug is green (the shrink kept
    # a real repro, not a broken harness state)
    assert run_sim(rt, str(tmp_path / "replay-clean")).ok

    # audit.py-format dump with an xray bisect line
    with open(sr.dump_path) as f:
        doc = json.load(f)
    assert doc["violations"] and doc["inputs"]
    assert doc["xray"] and doc["xray"].startswith("kme-torch-xray --bisect")
    assert os.path.exists(doc["checkpoint_ref"])


def test_shrink_returns_none_for_green_schedule(tmp_path):
    from kme_tpu_torch.sim.shrink import shrink_schedule

    assert shrink_schedule(_calm(3), str(tmp_path), max_runs=4) is None


# ---------------------------------------------------------------------------
# CLI


def test_cli_dump_schedule_roundtrip(capsys):
    from kme_tpu_torch.sim.cli import sim_main

    assert sim_main(["--seed", "4", "--dump-schedule"]) == 0
    dumped = capsys.readouterr().out.strip()
    assert FaultSchedule.from_json(dumped).seed == 4


def test_cli_single_seed_green(tmp_path, capsys):
    from kme_tpu_torch.sim.cli import sim_main

    rc = sim_main(["--seed", "3", "--events", "40",
                   "--out", str(tmp_path), "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["ok"] is True
    assert out["trace_digest"] and out["out_digest"]


def test_cli_repro_red_exit_code(tmp_path, capsys):
    from kme_tpu_torch.cli import main

    sched = FaultSchedule(
        seed=5, num_events=40,
        events=[{"kind": "crash", "group": 0, "at": 20}])
    path = tmp_path / "r.json"
    path.write_text(sched.to_json())
    assert main(["sim", "--repro", str(path), "--out",
                 str(tmp_path / "g")]) == 0
    capsys.readouterr()
    assert main(["sim", "--repro", str(path), "--planted-bug",
                 "stamp-reset", "--out", str(tmp_path / "r")]) == 1


def test_cli_requires_exactly_one_mode():
    from kme_tpu_torch.sim.cli import sim_main

    with pytest.raises(SystemExit):
        sim_main([])
    with pytest.raises(SystemExit):
        sim_main(["--seed", "1", "--seeds", "0..2"])


@pytest.mark.slow
def test_cli_sweep_finds_and_shrinks_planted_bug(tmp_path, capsys):
    """A short sweep with the bug armed goes red on a crash-bearing seed
    and prints a one-line repro, as `kme-sim`'s does."""
    from kme_tpu.sim.cli import sim_main as jsim_main
    from kme_tpu_torch.sim.cli import sim_main

    argv = ["--seeds", "5..9", "--events", "60",
            "--planted-bug", "stamp-reset", "--json"]
    rc = sim_main(argv + ["--out", str(tmp_path / "p")])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["red"]
    shrunk = [s for s in out["shrunk"] if s.get("reproduced")]
    assert shrunk and all(s["size"] <= 3 for s in shrunk)
    assert all(s["repro"].startswith("kme-torch-sim --repro")
               for s in shrunk)
    # the JAX package's sweep finds the same red seeds, digests and
    # minimal schedules
    assert jsim_main(argv + ["--out", str(tmp_path / "j")]) == 1
    want = json.loads(capsys.readouterr().out)
    assert out["red"] == want["red"]
    for key in ("seed", "ok", "red", "trace_digest", "out_digest",
                "vtime", "counters", "schedule"):
        assert [s.get(key) for s in out["results"]] == \
            [s.get(key) for s in want["results"]]
    for key in ("seed", "reproduced", "minimal", "size", "removed",
                "shrink_runs"):
        assert [s.get(key) for s in out["shrunk"]] == \
            [s.get(key) for s in want["shrunk"]]


# ---------------------------------------------------------------------------
# the port against the JAX package


# the reference tests' schedules (tests/test_sim.py), by seed
REF_SCHEDULES = {
    "calm-3": dict(seed=3, num_events=40),
    "crash-5": dict(seed=5, num_events=40,
                    events=[{"kind": "crash", "group": 1, "at": 20}]),
    "planted-5": dict(seed=5, num_events=40,
                      events=[{"kind": "crash", "group": 0, "at": 20}]),
    "noisy-6": json.loads(NOISY.to_json()),
    "digests-11": dict(seed=11, num_events=40,
                       clauses=["net.delay:n=1:at=9:ms=50"],
                       events=[{"kind": "crash", "group": 0, "at": 25}]),
    "reshard-13": dict(seed=13, num_events=40,
                       events=[{"kind": "reshard", "at": 22, "to": 3}]),
    "grammar-17": dict(seed=17, num_events=40,
                       clauses=["net.partition:n=1:at=7:ms=50",
                                "net.reorder:n=1:at=30:ms=20",
                                "broker.produce:n=1:after=25"]),
}


def _both(doc, tmp_path, planted_bug=None, **kw):
    text = json.dumps(doc, sort_keys=True)
    got = run_sim(FaultSchedule.from_json(text), str(tmp_path / "p"),
                  planted_bug=planted_bug, **kw)
    assert not faults.active() and not jfaults.active()
    want = JCL.run_sim(JSCH.FaultSchedule.from_json(text),
                       str(tmp_path / "j"), planted_bug=planted_bug, **kw)
    assert not faults.active() and not jfaults.active()
    return got, want


def _same_run(got, want):
    for i, (a, b) in enumerate(zip(got.events, want.events)):
        assert a == b, f"the traces first differ at event {i}"
    assert len(got.events) == len(want.events)
    assert got.trace_digest == want.trace_digest
    assert got.out_digest == want.out_digest
    assert got.verdicts == want.verdicts
    assert got.red_verdicts() == want.red_verdicts()
    assert got.counters == want.counters
    assert got.vtime == want.vtime
    assert got.schedule.to_json() == want.schedule.to_json()


@pytest.mark.parametrize("name", sorted(REF_SCHEDULES))
def test_run_sim_equals_jax_package(name, tmp_path):
    """One schedule, both packages' simulators: the same event trace,
    MatchOut digest, verdicts (red ones included), counters and virtual
    time. The planted bug runs armed in its own case."""
    planted = "stamp-reset" if name.startswith(("planted", "noisy")) \
        else None
    got, want = _both(REF_SCHEDULES[name], tmp_path, planted_bug=planted)
    _same_run(got, want)
    assert got.ok == (planted is None)


@pytest.mark.parametrize("seed", [5, 6, 11, 13, 17])
def test_generated_seed_equals_jax_package(seed, tmp_path):
    """The reference tests' seeds through `generate_schedule` at the CLI's
    defaults (400 events, 2 groups): the whole cluster under each seed's
    own adversity gives the same run in both packages."""
    doc = json.loads(generate_schedule(seed).to_json())
    got, want = _both(doc, tmp_path)
    _same_run(got, want)
    assert got.ok


def test_shrunk_repro_equals_jax_package(tmp_path):
    """The shrinker walks the same candidates to the same minimal schedule
    in both packages: repro.json byte for byte, the same steps, runs and
    red verdicts; the dumps differ only in the command names."""
    from kme_tpu_torch.sim.shrink import shrink_schedule

    got = shrink_schedule(FaultSchedule.from_json(NOISY.to_json()),
                          str(tmp_path / "p"), max_runs=32,
                          planted_bug="stamp-reset")
    want = JSHR.shrink_schedule(JSCH.FaultSchedule.from_json(
        NOISY.to_json()), str(tmp_path / "j"), max_runs=32,
        planted_bug="stamp-reset")
    with open(got.repro_path) as f, open(want.repro_path) as g:
        assert f.read() == g.read()
    assert (got.runs, got.removed, got.steps) == \
        (want.runs, want.removed, want.steps)
    assert got.result.red_verdicts() == want.result.red_verdicts()
    assert got.result.trace_digest == want.result.trace_digest
    assert got.result.out_digest == want.result.out_digest
    with open(got.dump_path) as f, open(want.dump_path) as g:
        pd, jd = json.load(f), json.load(g)
    for key in ("violations", "events", "inputs", "schedule", "batch",
                "pre_state"):
        assert pd[key] == jd[key]
    assert pd["repro"] == want.repro_line.replace(
        "kme-sim", "kme-torch-sim").replace(str(tmp_path / "j"),
                                            str(tmp_path / "p"))


def test_repro_kit_xray_line_fails_in_both_packages(tmp_path, capsys):
    """A reference bug the port keeps (ROADMAP Queue C): the repro kit's
    `xray` line passes `--hi-batch`, which neither package's xray CLI
    has, so it exits 2 in both."""
    from kme_tpu.cli import xray_main as jxray_main
    from kme_tpu_torch.cli import xray_main
    from kme_tpu_torch.sim.shrink import shrink_schedule

    sr = shrink_schedule(FaultSchedule.from_json(
        json.dumps(REF_SCHEDULES["planted-5"])), str(tmp_path), max_runs=4,
        planted_bug="stamp-reset")
    with open(sr.dump_path) as f:
        line = json.load(f)["xray"]
    argv = shlex.split(line)[1:]
    assert "--hi-batch" in argv
    for fn in (xray_main, jxray_main):
        with pytest.raises(SystemExit) as e:
            fn(argv)
        assert e.value.code == 2
        assert "--hi-batch" in capsys.readouterr().err


def test_fault_plans_stay_in_their_package(tmp_path):
    """Each package's fault plan is its own process-global: a plan armed
    in one package neither fires in nor is cleared by the other's run."""
    faults.configure("seed=1;broker.fetch:n=1:after=1000000")
    try:
        res = JCL.run_sim(JSCH.FaultSchedule(
            seed=3, num_events=40, clauses=["broker.fetch:n=1:after=5"]),
            str(tmp_path / "j"))
        assert res.ok
        assert faults.active()          # the JAX run left the port's plan
        assert not jfaults.active()
    finally:
        faults.clear()
    jfaults.configure("seed=1;broker.fetch:n=1:after=1")
    try:
        got = run_sim(_calm(3), str(tmp_path / "p"))
        assert got.counters["faults_fired"] == 0
        assert jfaults.active()
    finally:
        jfaults.clear()
    want = JCL.run_sim(JSCH.FaultSchedule(seed=3, num_events=40),
                       str(tmp_path / "j2"))
    assert got.trace_digest == want.trace_digest


@pytest.mark.parametrize("seed", sorted(CS.SIM_DIGESTS))
def test_chip_smoke_sim_digests(seed, tmp_path, capsys):
    """`chip_smoke.py` 16d holds `python -m kme_tpu_torch.cli sim --seed N
    --json` on the card machine (no JAX there) to recorded digests: both
    packages' CLIs give them here."""
    from kme_tpu.sim.cli import sim_main as jsim_main
    from kme_tpu_torch.cli import main

    docs = []
    for fn, argv in ((main, ["sim"]), (jsim_main, [])):
        assert fn(argv + ["--seed", str(seed), "--json", "--out",
                          str(tmp_path / str(len(docs)))]) == 0
        docs.append(json.loads(capsys.readouterr().out))
    for doc in docs:
        assert (doc["trace_digest"], doc["out_digest"]) == \
            CS.SIM_DIGESTS[seed]
        assert doc["ok"] is True
    assert docs[0]["counters"] == docs[1]["counters"]
    assert docs[0]["verdicts"] == docs[1]["verdicts"]
