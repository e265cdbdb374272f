"""The port's chaos harness (`kme_tpu_torch/bridge/chaos.py`): the
analogs of tests/test_chaos.py and of the chaos registry cases of
tests/test_overload.py, the verifiers, schedules and registry against
the JAX package's on the same inputs, the child commands every scenario
builds, and the CLI's defaults against `kme-chaos`'s.

The end-to-end drills (`slow`) run `python -m kme_tpu_torch.cli chaos`
as a subprocess, with the oracle engine or the seq engine's plain
version (`--device cpu`)."""

import argparse
import json
import os
import subprocess
import sys

import pytest
import torch

import kme_tpu.bridge.chaos as JC
from kme_tpu.bridge.broker import Record as JRecord
from kme_tpu.wire import dumps_order as j_dumps_order
from kme_tpu.workload import harness_stream as j_harness_stream
from kme_tpu_torch.bridge import chaos as C
from kme_tpu_torch.bridge.broker import BrokerError, Record
from kme_tpu_torch.bridge.chaos import default_schedule, verify_stream

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# oracle groups: message 0 -> [a0, a1], message 1 -> [b0], message 2 ->
# [] (a dropped/rejected-silent record), message 3 -> [d0, d1, d2]
G = [["a0", "a1"], ["b0"], [], ["d0", "d1", "d2"]]
FLAT = [ln for g in G for ln in g]


def test_verify_exact_stream_passes():
    ok, d = verify_stream(list(FLAT), G)
    assert ok
    assert d["replays"] == 0 and d["replayed_messages"] == 0
    assert d["messages"] == 4 and d["expected_lines"] == len(FLAT)


def test_verify_replay_from_snapshot_passes():
    # crash after message 1, resume from a snapshot at message 0
    got = ["a0", "a1", "b0"] + FLAT
    ok, d = verify_stream(got, G)
    assert ok
    assert d["replays"] == 1 and d["replayed_messages"] == 2


def test_verify_partial_group_then_replay_passes():
    # crash MID-message-3 (one of three lines produced), resume from
    # message 1
    got = ["a0", "a1", "b0", "d0", "b0", "d0", "d1", "d2"]
    ok, d = verify_stream(got, G)
    assert ok
    assert d["replays"] == 1 and d["replayed_messages"] == 2


def test_verify_trailing_replay_passes():
    got = FLAT + ["d0", "d1", "d2"]
    ok, d = verify_stream(got, G)
    assert ok and d["replays"] == 1


def test_verify_double_replay_passes():
    got = ["a0", "a1"] + ["a0", "a1", "b0"] + FLAT
    ok, d = verify_stream(got, G)
    assert ok and d["replays"] == 2 and d["replayed_messages"] == 3


def test_verify_rejects_divergence():
    bad = list(FLAT)
    bad[2] = "WRONG"
    ok, d = verify_stream(bad, G)
    assert not ok and "divergence" in d["error"]


def test_verify_rejects_missing_tail():
    ok, d = verify_stream(FLAT[:-1], G)
    assert not ok and "incomplete" in d["error"]


def test_verify_rejects_skipped_message():
    ok, _ = verify_stream(["a0", "a1", "d0", "d1", "d2"], G)
    assert not ok


def test_verify_empty_inputs():
    ok, _ = verify_stream([], [])
    assert ok
    ok, _ = verify_stream([], [["x"]])
    assert not ok


def test_default_schedule_covers_required_fault_classes():
    sched = default_schedule(0, 1000, journal=True)
    for point in ("broker.produce", "broker.fetch", "tcp.partial",
                  "ckpt.torn", "ckpt.bitflip", "serve.kill",
                  "serve.stuck", "journal.torn"):
        assert point in sched
    assert "seed=0" in sched
    assert "serve.kill:at=500" in sched
    assert "journal.torn" not in default_schedule(0, 1000, journal=False)


def _recs(*rows, record=Record):
    """(value, epoch, out_seq) triples -> stamped MatchOut Records."""
    return [record(i, "OUT", v, e, s) for i, (v, e, s) in enumerate(rows)]


OUT_G = [["OUT a0", "OUT a1"], ["OUT b0"], [], ["OUT d0"]]


def test_failover_schedule_is_one_seeded_midstream_kill():
    sched = C.failover_schedule(3, 600)
    assert "seed=3" in sched
    assert "serve.kill:at=300" in sched
    assert sched.count(";") == 1
    assert C.failover_schedule(0, 1) == "seed=0;serve.kill:at=1"


def test_verify_failover_passes_clean_two_epoch_stream():
    ok, d = C.verify_failover(_recs(("a0", 1, 0), ("a1", 1, 1),
                                    ("b0", 2, 2), ("d0", 2, 3)), OUT_G)
    assert ok, d
    assert d["epochs"] == [1, 2]
    assert d["duplicates_in_log"] == 0


def test_verify_failover_rejects_duplicate_stamps_in_the_log():
    ok, d = C.verify_failover(_recs(("a0", 1, 0), ("a1", 1, 1),
                                    ("a1", 1, 1), ("b0", 2, 2),
                                    ("d0", 2, 3)), OUT_G)
    assert not ok
    assert d["duplicates_in_log"] == 1
    assert "duplicate produce stamp" in d["error"]


def test_verify_failover_rejects_divergence():
    ok, d = C.verify_failover(_recs(("a0", 1, 0), ("aX", 1, 1),
                                    ("b0", 2, 2), ("d0", 2, 3)), OUT_G)
    assert not ok
    assert "diverges" in d["error"]


def test_verify_failover_requires_a_promoted_epoch():
    ok, d = C.verify_failover(_recs(("a0", 1, 0), ("a1", 1, 1),
                                    ("b0", 1, 2), ("d0", 1, 3)), OUT_G)
    assert not ok
    assert "failover never happened" in d["error"]
    assert d["epochs"] == [1]


def test_chaos_scenario_registry_lists_all_scenarios():
    from kme_tpu_torch.workload import STORM_PROFILES

    reg = C.scenario_registry()
    assert {"default", "failover", "shard-failover"} <= set(reg)
    assert set(STORM_PROFILES) <= set(reg)
    assert all(isinstance(v, str) and v for v in reg.values())


def test_chaos_list_scenarios_flag(capsys):
    assert C.main(["--list-scenarios"]) == 0
    out = capsys.readouterr().out
    for name in ("default", "failover", "payout-storm-wide",
                 "liquidation-cascade"):
        assert name in out


# ---------------------------------------------------------------------------
# the same inputs through both packages


_STREAMS = {
    "exact": list(FLAT),
    "replay": ["a0", "a1", "b0"] + FLAT,
    "partial": ["a0", "a1", "b0", "d0", "b0", "d0", "d1", "d2"],
    "trailing": FLAT + ["d0", "d1", "d2"],
    "double": ["a0", "a1"] + ["a0", "a1", "b0"] + FLAT,
    "divergent": FLAT[:2] + ["WRONG"] + FLAT[3:],
    "short": FLAT[:-1],
    "skipped": ["a0", "a1", "d0", "d1", "d2"],
    "empty": [],
}
_FAILOVER_ROWS = {
    "clean": [("a0", 1, 0), ("a1", 1, 1), ("b0", 2, 2), ("d0", 2, 3)],
    "dup": [("a0", 1, 0), ("a1", 1, 1), ("a1", 1, 1), ("b0", 2, 2),
            ("d0", 2, 3)],
    "divergent": [("a0", 1, 0), ("aX", 1, 1), ("b0", 2, 2), ("d0", 2, 3)],
    "one_epoch": [("a0", 1, 0), ("a1", 1, 1), ("b0", 1, 2), ("d0", 1, 3)],
    "unstamped": [("a0", None, None), ("a1", 1, 1), ("b0", 3, 2),
                  ("d0", 3, 3)],
}


@pytest.mark.parametrize("fn", ["verify_stream", "verify_failover",
                                "expected_groups", "default_schedule",
                                "failover_schedule", "_busy_rate",
                                "scenario_registry"])
def test_equal_to_jax(fn):
    if fn == "verify_stream":
        for name, got in _STREAMS.items():
            for groups in (G, [], [["x"]], G + [["e0"]]):
                assert verify_stream(list(got), groups) == \
                    JC.verify_stream(list(got), groups), name
    elif fn == "verify_failover":
        for name, rows in _FAILOVER_ROWS.items():
            for floor in (2, 3):
                a = C.verify_failover(_recs(*rows), OUT_G, floor)
                b = JC.verify_failover(_recs(*rows, record=JRecord), OUT_G,
                                       floor)
                assert a == b, name
    elif fn == "expected_groups":
        lines = [j_dumps_order(m) for m in j_harness_stream(
            400, seed=5, num_accounts=10, num_symbols=3,
            payout_opcode_bug=False, validate=True)]
        for slots, fills in ((128, 32), (128, 16), (8, 2)):
            assert C.expected_groups(lines, slots, fills) == \
                JC.expected_groups(lines, slots, fills)
    elif fn == "default_schedule":
        for seed, events in ((0, 20_000), (7, 600), (3, 1), (1, 2)):
            for journal in (True, False):
                assert default_schedule(seed, events, journal) == \
                    JC.default_schedule(seed, events, journal)
    elif fn == "failover_schedule":
        for seed, events in ((0, 20_000), (7, 600), (3, 1), (1, 0)):
            assert C.failover_schedule(seed, events) == \
                JC.failover_schedule(seed, events)
    elif fn == "_busy_rate":
        series = [(0.0, 0), (0.1, 5), (0.2, 12), (0.3, 20), (0.4, 20),
                  (0.5, 20)]
        for samples in (series, series[:1], [], series[:4],
                        [(t, 7) for t, _ in series]):
            for lo, hi in ((0.0, float("inf")), (0.1, 0.3), (0.25, 0.26),
                           (0.35, 0.5), (-1.0, 0.15)):
                assert C._busy_rate(samples, lo, hi) == \
                    JC._busy_rate(samples, lo, hi)
    else:
        assert C.scenario_registry() == JC.scenario_registry()


# ---------------------------------------------------------------------------
# the CLI: defaults, the card, the child commands


class _Parsed(Exception):
    pass


def _parsed(main, argv, monkeypatch):
    """The namespace `main(argv)` parses (it stops right after)."""
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as e:
        main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return vars(e.value.args[0])


def test_cli_defaults_are_the_references_but_engine_and_device(monkeypatch):
    ours = _parsed(C.main, [], monkeypatch)
    ref = _parsed(JC.main, [], monkeypatch)
    assert ours.pop("engine") == "seq" and ref.pop("engine") == "oracle"
    assert ours.pop("device") == "cuda"
    assert ours == ref
    assert (ours["max_failover"], ours["grace"], ours["stall_after"],
            ours["stale_after"], ours["min_restarts"], ours["min_sheds"],
            ours["storm_p99_ms"], ours["storm_min_tput"],
            ours["overload_high_lag"]) == (2.0, 30.0, 2.5, 5.0, 1, 1,
                                           2000.0, 10.0, 48)


def test_cli_refuses_without_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for argv in ([], ["--scenario", "failover"],
                 ["--scenario", "flash-crowd", "--engine", "lanes"]):
        assert C.main(argv + ["--dir", str(tmp_path / "r")]) == 2
        assert "needs a CUDA card" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "r")


class _FakeChild:
    """A child process that has already exited 0."""

    def __init__(self, args, **kw):
        self.args, self.returncode, self.pid = args, 0, 1

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0

    def communicate(self, input=None, timeout=None):
        return "", ""

    def kill(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Stop(Exception):
    pass


SCENARIOS = ["default", "failover", "shard-failover", "feed-failover",
             "reshard-under-storm", "payout-storm-wide", "flash-crowd"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_child_commands_name_the_port(scenario, tmp_path, monkeypatch):
    """Every child a scenario spawns runs `kme_tpu_torch` (never
    `kme_tpu.`), every serve child (direct or under the supervisor) is
    handed `--device`, and no child is given JAX_PLATFORMS."""
    calls = []
    # the spawns after which a scenario would only wait for brokers
    # that never come up: feed-failover's one supervisor, the reshard's
    # 2 + 4 generations of supervisors
    last = {"feed-failover": 1, "reshard-under-storm": 6}.get(scenario)

    def record(args, **kw):
        calls.append((list(args), dict(kw.get("env") or {})))
        if sum("supervise" in a for a, _ in calls) == last:
            raise _Stop
        return _FakeChild(args, **kw)

    monkeypatch.setattr(subprocess, "Popen", record)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    argv = ["--scenario", scenario, "--engine", "oracle", "--device", "cpu",
            "--events", "120", "--timeout", "1", "--dir", str(tmp_path),
            "--storm-symbols", "8", "--storm-accounts", "16",
            "--symbols", "16", "--accounts", "16"]
    try:
        C.main(argv)
    except (_Stop, BrokerError):
        pass        # the post-mortem of a run whose children did nothing
    assert calls
    serves = 0
    for args, env in calls:
        assert args[0] == sys.executable and args[1] == "-m"
        assert args[2].startswith("kme_tpu_torch."), args
        assert not any("kme_tpu." in a for a in args), args
        assert "JAX_PLATFORMS" not in env
        if args[2] == "kme_tpu_torch.cli":
            assert args[3] in ("supervise", "serve"), args
            i = args.index("--device")
            assert args[i + 1] == "cpu"
            serves += 1
        else:
            assert args[2] == "kme_tpu_torch.bridge.reshard", args
    assert serves >= (6 if scenario == "reshard-under-storm" else
                      2 if scenario == "shard-failover" else 1)


def test_shard_failover_input_waits_for_every_child(tmp_path, monkeypatch):
    """shard-failover starts no group's producer before every group's
    leader and the victim's hot standby have written a heartbeat: a card
    child takes seconds to start, and a survivor that starts serving
    after the victim's kill shows no rate during the outage."""
    import glob
    import threading
    import time

    class Child(_FakeChild):
        def poll(self):
            return None

    spawned = []

    def spawn(args, **kw):
        ck = args[args.index("--checkpoint-dir") + 1]
        names = ["serve.health"] + (["standby.health"]
                                    if "--standby" in args else [])
        delay = 0.3 * len(spawned)      # later groups come up later

        def beat():
            time.sleep(delay)
            for name in names:
                with open(os.path.join(ck, name), "w") as f:
                    f.write("{}")

        threading.Thread(target=beat, daemon=True).start()
        spawned.append(ck)
        return Child(args, **kw)

    seen = []

    class Producer:
        def __init__(self, host, port, lines, topic=None, topics=None):
            pass

        def start(self):
            seen.append(sorted(os.path.relpath(p, tmp_path) for p in
                               glob.glob(str(tmp_path / "group*" / "state"
                                             / "*.health"))))
            raise _Stop

    monkeypatch.setattr(subprocess, "Popen", spawn)
    monkeypatch.setattr(C, "_Producer", Producer)
    with pytest.raises(_Stop):
        C.main(["--scenario", "shard-failover", "--engine", "oracle",
                "--device", "cpu", "--events", "120", "--timeout", "30",
                "--dir", str(tmp_path)])
    assert len(spawned) == 2
    assert len(seen[0]) == 3 and sum("standby" in p for p in seen[0]) == 1


@pytest.mark.parametrize("engine", ["oracle", "native"])
def test_host_engine_service_loop_imports_no_torch(engine):
    """A host engine's service must not import torch inside its serve
    loop (seconds on a small host): when the first batch's parse pulled
    it in through runtime/sequencer, the frozen loop tripped a
    supervisor's 2.5 s stall bound and held a standby's promotion past
    the 2.0 s failover bound. Malformed input (the envelope check's
    error path), snapshots, a journal and spans included."""
    code = f"""
import os, sys, tempfile
from kme_tpu_torch.bridge.broker import InProcessBroker
from kme_tpu_torch.bridge.provision import provision
from kme_tpu_torch.bridge.service import TOPIC_IN, MatchService
from kme_tpu_torch.wire import dumps_order
from kme_tpu_torch.workload import harness_stream
d = tempfile.mkdtemp()
b = InProcessBroker(persist_dir=os.path.join(d, "broker-log"))
provision(b)
for m in harness_stream(150, seed=0, payout_opcode_bug=False, validate=True):
    b.produce(TOPIC_IN, None, dumps_order(m))
b.produce(TOPIC_IN, None, '{{"action":2,"oid":5,"aid":1,"sid":0,'
                          '"price":99999999999,"size":1}}')
svc = MatchService(b, engine="{engine}", batch=64, checkpoint_dir=d,
                   checkpoint_every=60, exactly_once=True,
                   journal=os.path.join(d, "j.jsonl"), trace_spans=True)
svc.run(max_messages=174, poll_timeout=0.05)
svc.close()
print(svc.offset, "torch" in sys.modules)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["174", "False"], r.stdout


# ---------------------------------------------------------------------------
# end to end (slow): `python -m kme_tpu_torch.cli chaos` as a user runs it


def _chaos(tmp_path, *argv, limit=600):
    run_dir = str(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-m", "kme_tpu_torch.cli", "chaos", *argv,
         "--dir", run_dir],
        cwd=ROOT, capture_output=True, text=True, timeout=limit)
    sys.stderr.write(proc.stderr[-4000:])
    assert proc.returncode == 0, proc.stderr[-2000:]
    with open(os.path.join(run_dir, "chaos-report.json")) as f:
        report = json.load(f)
    assert report["ok"] and not report["failures"]
    return run_dir, report


@pytest.mark.slow
def test_chaos_end_to_end_byte_exact(tmp_path):
    """Every fault class against the oracle engine: the completed
    MatchOut stream verifies against the oracle with >= 1 restart."""
    run_dir, report = _chaos(tmp_path, "--engine", "oracle", "--seed", "0",
                             "--events", "600", "--timeout", "180")
    assert report["restarts_total"] >= 1
    assert report["verify"]["replayed_messages"] >= 0
    fired_points = {k.split(".", 1)[1] for k in report["fault_fires"]}
    assert {"serve.kill", "ckpt.torn", "ckpt.bitflip"} <= fired_points
    assert report["recovery_seconds_max"] is not None
    assert os.path.exists(os.path.join(run_dir, "journal.jsonl"))


@pytest.mark.slow
def test_chaos_seq_engine_on_the_cpu(tmp_path):
    """The default gauntlet against the seq engine's plain version at
    the serve defaults' width: every rule of the schedule fires."""
    _, report = _chaos(tmp_path, "--engine", "seq", "--device", "cpu",
                       "--seed", "0", "--events", "600", "--timeout", "400")
    assert report["engine"] == "seq"
    assert report["restarts_total"] >= 2
    assert len(report["fault_fires"]) == 8
    assert all(n >= 1 for n in report["fault_fires"].values())


@pytest.mark.slow
def test_chaos_failover_end_to_end_exactly_once(tmp_path):
    """A hot standby promoted after a seeded SIGKILL: exactly-once
    MatchOut, dedup exercised, zombie produces fenced, the promotion
    under the failover bound."""
    _, report = _chaos(tmp_path, "--scenario", "failover", "--seed", "0",
                       "--events", "600", "--engine", "oracle",
                       "--checkpoint-every", "60", "--timeout", "120")
    fo = report["failover"]
    assert fo["promotions"] >= 1
    assert fo["failover_seconds"] and max(fo["failover_seconds"]) <= 2.0
    assert fo["dup_suppressed_total"] > 0
    assert fo["stale_epoch_fenced"] is True
    assert fo["leader_epoch"] >= 2
    assert report["verify"]["epochs"][-1] >= 2
    assert report["verify"]["duplicates_in_log"] == 0


@pytest.mark.slow
def test_chaos_shard_failover(tmp_path):
    _, report = _chaos(tmp_path, "--scenario", "shard-failover", "--seed",
                       "0", "--groups", "2", "--engine", "oracle",
                       "--events", "8000", "--timeout", "300", limit=420)
    assert report["promotions"] >= 1
    assert sum(report["duplicate_stamps"].values()) == 0
    assert report["stale_epoch_fenced"] and report["verify"]["ok"]


@pytest.mark.slow
def test_chaos_feed_failover(tmp_path):
    _, report = _chaos(tmp_path, "--scenario", "feed-failover", "--seed",
                       "0", "--engine", "oracle", "--events", "600",
                       "--timeout", "180")
    assert report["promotions"] >= 1 and report["feed_reconnects"] >= 1
    assert all(s["byte_exact"] and not s["gaps"] and not s["dups"]
               for s in report["subscribers"])


@pytest.mark.slow
def test_chaos_reshard_under_storm(tmp_path):
    _, report = _chaos(tmp_path, "--scenario", "reshard-under-storm",
                       "--seed", "0", "--groups", "2", "--groups-to", "4",
                       "--events", "800", "--timeout", "300", limit=420)
    assert report["settle"]["dup_suppressed"] == 5
    assert report["coordinator_crash_rc"] == -9
    assert sum(report["duplicate_stamps"].values()) == 0
    assert report["old_fenced"] == [True, True] and report["verify"]["ok"]


@pytest.mark.slow
def test_chaos_flash_crowd_storm(tmp_path):
    """Reduced scale: 2,000 events over 8 symbols and 16 accounts, with
    the shedding watermark at 8: at chaos's 48 the oracle service kept
    the lag under it in some runs here (0 of 2,040 shed, p99 7.4 ms) and
    shed 8-12 in others. (The JAX package's drill misses the 2000 ms p99
    bound at this scale on the CPU: its serve admits records while its
    service starts.)"""
    _, report = _chaos(tmp_path, "--scenario", "flash-crowd", "--seed", "0",
                       "--engine", "oracle", "--events", "2000",
                       "--storm-symbols", "8", "--storm-accounts", "16",
                       "--overload-high-lag", "8", "--timeout", "180")
    assert report["shed"] >= 1
    assert report["parity"]["duplicate_stamps"] == 0
    assert "error" not in report["parity"]
    assert report["slo"]["ok"]
