"""The port's supervisor (`kme_tpu_torch/bridge/supervise.py`) under an
injectable clock, against the JAX package's.

The analogs of tests/test_supervise_unit.py's cases: detection (stale
heartbeat, frozen tick, grace window), jittered exponential backoff keyed
on failure fingerprints, the healthy-uptime budget refund, recovery-time
measurement, the supervisor.json mirror and the hot-standby promotion —
in milliseconds of real time (no child processes, no sleeps). Then:
- one scripted popen/clock/mtime/rng drives both packages' Supervisor
  through a promotion, a failed adoptee and a cold restart: equal
  supervisor.json, event logs and child environments, argv equal apart
  from the CLI module (`kme_tpu.cli` / `kme_tpu_torch.cli`);
- `supervise_groups` builds `--group k/N --listen host:port_base+k` under
  `group{k}` and refuses `--listen` / `--group` in serve_args; with an
  autoscale policy its trace replays to its proposals in both packages;
- the standby takes `--device` from the forwarded serve args.
"""

import json
import os
import random
import sys
import time

import pytest
import torch

from kme_tpu.bridge import autoscale as JAS
from kme_tpu.bridge import supervise as JSUP
from kme_tpu_torch.bridge import autoscale as AS
from kme_tpu_torch.bridge import replica as REP
from kme_tpu_torch.bridge import supervise as SUP
from kme_tpu_torch.bridge.supervise import STATE_FILE, Supervisor

torch.set_num_threads(1)


class FakeChild:
    """A scripted child: exits `rc` once the fake clock passes
    spawn + exit_after (None = runs forever until killed). Standby
    fakes additionally "write" a heartbeat file on every poll
    (hb_path), the way the real replica's follow loop does."""

    _next_pid = iter(range(40_000, 50_000))

    def __init__(self, clock, exit_after=None, rc=1):
        self._clock = clock
        self.exit_after = exit_after
        self.rc = rc
        self.returncode = None
        self.spawned_at = None
        self.env = None
        self.pid = next(FakeChild._next_pid)
        self.hb_path = None

    def poll(self):
        if (self.returncode is None and self.exit_after is not None
                and self._clock() - self.spawned_at >= self.exit_after):
            self.returncode = self.rc
        if self.returncode is None and self.hb_path is not None:
            open(self.hb_path, "a").close()
        return self.returncode

    def send_signal(self, sig):
        self.returncode = -9

    def terminate(self):
        if self.returncode is None:
            self.returncode = -15

    def kill(self):
        self.returncode = -9

    def wait(self, timeout=None):
        return self.returncode


class Harness:
    """Fake clock + scripted children wired into a Supervisor."""

    def __init__(self, tmp_path, n_children=8, sup_cls=Supervisor, **kw):
        self.now = 0.0
        self.sleeps = []
        self.spawned = []
        self._pending = [FakeChild(self.clock) for _ in range(n_children)]
        # heartbeat model: age() -> seconds (inf = no file yet);
        # tick() -> loop tick value. Tests swap these mid-run.
        self.age = lambda: 0.1
        self.tick = lambda: int(self.now * 10)    # always advancing
        sup = sup_cls([], str(tmp_path),
                         popen=self._popen, clock=self.clock,
                         sleep=self._sleep,
                         mtime=lambda p: self._mtime(),
                         rng=random.Random(0), poll=0.5, **kw)
        sup._hb_tick = self.tick_wrap
        self.sup = sup

    def clock(self):
        return self.now

    def _sleep(self, s):
        self.sleeps.append(s)
        self.now += s
        if self.now > 100000:
            raise AssertionError("supervisor loop ran away")

    def _mtime(self):
        age = self.age()
        if age == float("inf"):
            raise OSError("no heartbeat file")
        return self.now - age

    def tick_wrap(self):
        return self.tick()

    def _popen(self, cmd, env):
        child = self._pending[len(self.spawned)]
        child.spawned_at = self.now
        child.env = env
        self.spawned.append(child)
        return child

    @property
    def backoffs(self):
        """Sleeps that are not the 0.5s poll cadence."""
        return [s for s in self.sleeps if s != 0.5]


def test_clean_exit_no_restart(tmp_path):
    h = Harness(tmp_path)
    h._pending[0].exit_after, h._pending[0].rc = 2.0, 0
    assert h.sup.run() == 0
    assert len(h.spawned) == 1
    assert h.sup.restarts_total == 0
    assert h.spawned[0].env["KME_RESTART_ORDINAL"] == "0"
    assert "KME_FAILED_AT" not in h.spawned[0].env


def test_crash_loop_exhausts_budget_with_growing_backoff(tmp_path):
    h = Harness(tmp_path, max_restarts=3, healthy_decay=10_000,
                backoff_base=1.0, backoff_cap=100.0)
    for c in h._pending:
        c.exit_after, c.rc = 0.0, 1        # dies instantly, forever
    assert h.sup.run() == 1
    assert len(h.spawned) == 4             # initial + 3 restarts
    assert h.sup.restarts_total == 4
    assert h.sup.fingerprints == {"exit:1": 4}
    # three backoff sleeps (the 4th failure exhausts the budget before
    # any backoff), doubling with jitter in [0.5, 1.5)x
    b = h.backoffs
    assert len(b) == 3
    assert 0.5 <= b[0] < 1.5
    assert 1.0 <= b[1] < 3.0
    assert 2.0 <= b[2] < 6.0
    # restart ordinals stamped into each incarnation's environment
    assert [c.env["KME_RESTART_ORDINAL"] for c in h.spawned] == \
        ["0", "1", "2", "3"]
    assert all("KME_FAILED_AT" in c.env for c in h.spawned[1:])


def test_novel_fingerprint_resets_backoff_streak(tmp_path):
    h = Harness(tmp_path, max_restarts=10, healthy_decay=10_000,
                backoff_base=1.0, backoff_cap=100.0)
    for i, c in enumerate(h._pending):
        c.exit_after = 0.0
        c.rc = 1 if i < 2 else 2           # fingerprint changes
        if i >= 3:
            c.rc = 0                       # then exit cleanly
    assert h.sup.run() == 0
    assert h.sup.fingerprints == {"exit:1": 2, "exit:2": 1}
    b = h.backoffs
    assert len(b) == 3
    assert 1.0 <= b[1] < 3.0               # streak 2 of exit:1
    assert 0.5 <= b[2] < 1.5               # exit:2 resets to streak 1


def test_stale_heartbeat_detected(tmp_path):
    h = Harness(tmp_path, stale_after=5.0, grace=1.0)
    h._pending[1].exit_after, h._pending[1].rc = 1.0, 0
    # the FIRST incarnation's heartbeat freezes at t=3; the restarted
    # child beats normally
    h.age = lambda: (0.1 if len(h.spawned) >= 2 or h.now < 3.0
                     else h.now - 3.0)
    assert h.sup.run() == 0
    assert h.sup.fingerprints == {"stale": 1}
    assert h.sup.restarts_total == 1
    assert h.spawned[0].returncode == -9   # SIGKILLed after detection


def test_frozen_tick_is_a_stall_even_with_fresh_heartbeat(tmp_path):
    h = Harness(tmp_path, stall_after=3.0, stale_after=10_000)
    h._pending[1].exit_after, h._pending[1].rc = 1.0, 0
    h.age = lambda: 0.1                        # beater thread alive
    h.tick = lambda: min(int(h.now), 2)        # advances, then freezes
    assert h.sup.run() == 0
    assert h.sup.fingerprints == {"stall": 1}


def test_stall_after_ticks_the_supervisor_never_saw_advance(tmp_path):
    """The loop ticked before the supervisor's first look and froze
    there (a fast host-engine child replaying its log into a stuck
    step): its tick is past 0, so a step returned and the detector arms.
    `kme_tpu`'s supervisor arms only on a tick it saw change, and waits
    on such a child forever."""
    h = Harness(tmp_path, stall_after=3.0, stale_after=10_000)
    h._pending[1].exit_after, h._pending[1].rc = 1.0, 0
    h.age = lambda: 0.1                        # beater thread alive
    h.tick = lambda: 7 if len(h.spawned) < 2 else int(h.now * 10)
    assert h.sup.run() == 0
    assert h.sup.fingerprints == {"stall": 1}


def test_no_heartbeat_within_grace_fails(tmp_path):
    h = Harness(tmp_path, grace=4.0)
    h._pending[1].exit_after, h._pending[1].rc = 1.0, 0
    first = {"done": False}

    def age():
        # first incarnation never writes a heartbeat; the restarted
        # one is healthy immediately
        return float("inf") if len(h.spawned) < 2 else 0.1

    h.age = age
    assert h.sup.run() == 0
    assert h.sup.fingerprints == {"stale": 1}
    # detection happened only after the grace window
    assert h.sup.recoveries == [] or h.sup.recoveries[0]["detected_at"] >= 4.0


def test_healthy_uptime_refunds_budget(tmp_path):
    h = Harness(tmp_path, max_restarts=2, healthy_decay=5.0)
    h._pending[0].exit_after, h._pending[0].rc = 0.0, 1
    h._pending[1].exit_after, h._pending[1].rc = 12.0, 0  # long healthy run
    assert h.sup.run() == 0
    assert h.sup.restarts_total == 1       # lifetime count unchanged
    assert h.sup.budget_used == 0          # refunded by healthy uptime


def test_recovery_time_measured_and_state_mirrored(tmp_path):
    h = Harness(tmp_path, grace=30.0)
    h._pending[0].exit_after, h._pending[0].rc = 2.0, 1
    h._pending[1].exit_after, h._pending[1].rc = 10.0, 0

    def age():
        if len(h.spawned) < 2:
            return 0.1
        # restarted child's first heartbeat lands 1.5s after spawn
        born = h.spawned[1].spawned_at
        return float("inf") if h.now < born + 1.5 else 0.1

    h.age = age
    assert h.sup.run() == 0
    assert len(h.sup.recoveries) == 1
    rec = h.sup.recoveries[0]
    assert rec["fingerprint"] == "exit:1"
    assert 1.0 <= rec["recovered_in"] <= 4.0
    # the child was told when the failure was detected
    assert float(h.spawned[1].env["KME_FAILED_AT"]) == rec["detected_at"]
    # supervisor.json mirrors the final state
    with open(os.path.join(str(tmp_path), STATE_FILE)) as f:
        state = json.load(f)
    assert state["restarts_total"] == 1
    assert state["fingerprints"] == {"exit:1": 1}
    assert state["recoveries"][0]["recovered_in"] == rec["recovered_in"]


def test_closing_heartbeat_suppresses_the_stall_detector(tmp_path):
    """Same frozen-tick script as the stall test above, but the child's
    final heartbeat carries closing=true (deliberate idle-exit): the
    stall detector must stand down and let the clean exit land."""
    h = Harness(tmp_path, stall_after=3.0, stale_after=10_000)
    h._pending[0].exit_after, h._pending[0].rc = 10.0, 0
    h.age = lambda: 0.1
    h.tick = lambda: min(int(h.now), 2)        # advances, then freezes
    h.sup._hb_closing = lambda: True
    assert h.sup.run() == 0
    assert h.sup.fingerprints == {}
    assert h.sup.restarts_total == 0


# ---------------------------------------------------------------------------
# hot-standby failover


class StandbyHarness(Harness):
    """Harness plus a second scripted-child lane for kme-standby
    spawns (the supervisor's popen is dispatched on the subcommand)."""

    def __init__(self, tmp_path, n_standby=4, standby_beats=True, **kw):
        self.standby_spawned = []
        self._standby_pending = []
        super().__init__(tmp_path, standby=True, **kw)
        for _ in range(n_standby):
            c = FakeChild(self.clock)
            if standby_beats:
                c.hb_path = self.sup.standby_hb
            self._standby_pending.append(c)

    def _popen(self, cmd, env):
        if "standby" in cmd:
            child = self._standby_pending[len(self.standby_spawned)]
            child.spawned_at = self.now
            child.env = env
            self.standby_spawned.append(child)
            return child
        return super()._popen(cmd, env)


def test_failure_promotes_a_ready_standby_without_backoff(tmp_path):
    h = StandbyHarness(tmp_path)
    h._pending[0].exit_after, h._pending[0].rc = 2.0, 1
    adoptee = h._standby_pending[0]
    adoptee.exit_after, adoptee.rc = 8.0, 0    # serves, then exits clean
    assert h.sup.run() == 0
    # the standby was adopted, not a cold serve restart
    assert len(h.spawned) == 1
    assert len(h.standby_spawned) == 2         # adoptee + replacement
    assert h.backoffs == []                    # adoption is not paced
    assert h.sup.restarts_total == 1
    rec = h.sup.recoveries[0]
    assert rec["promoted"] is True
    assert rec["failover_seconds"] == rec["recovered_in"]
    # the promote order is addressed to the adoptee and SPARED by the
    # replacement-standby launch (the adoptee may not have read it yet)
    with open(h.sup.promote_file) as f:
        order = json.load(f)
    assert order["pid"] == adoptee.pid
    assert order["fingerprint"] == "exit:1"
    # clean exit stops the replacement replica
    assert h.standby_spawned[1].returncode == -15


def test_unready_standby_falls_back_to_cold_restart(tmp_path):
    h = StandbyHarness(tmp_path, standby_beats=False)  # never heartbeats
    h._pending[0].exit_after, h._pending[0].rc = 1.0, 1
    h._pending[1].exit_after, h._pending[1].rc = 1.0, 0
    assert h.sup.run() == 0
    assert len(h.spawned) == 2                 # ordinary restart path
    assert len(h.backoffs) == 1
    assert not os.path.exists(h.sup.promote_file)
    assert "promoted" not in h.sup.recoveries[0]


def test_stale_promote_file_is_cleared_at_standby_launch(tmp_path):
    h = StandbyHarness(tmp_path)
    with open(h.sup.promote_file, "w") as f:   # yesterday's order
        json.dump({"failed_at": 1.0, "pid": 12345}, f)
    h._pending[0].exit_after, h._pending[0].rc = 1.0, 0
    assert h.sup.run() == 0
    assert not os.path.exists(h.sup.promote_file)


def test_dead_standby_is_relaunched(tmp_path):
    h = StandbyHarness(tmp_path)
    h._standby_pending[0].exit_after = 1.0     # replica dies early
    h._pending[0].exit_after, h._pending[0].rc = 4.0, 0
    assert h.sup.run() == 0
    assert len(h.standby_spawned) == 2
    assert h.sup.standby_restarts == 1


def test_reserved_serve_args_rejected(tmp_path):
    for bad in ("--checkpoint-dir", "--checkpoint-dir=/x",
                "--health-file", "--health", "--check"):
        with pytest.raises(ValueError, match="managed by the supervisor"):
            Supervisor([bad, "v"], str(tmp_path))
    # non-prefix flags pass through
    Supervisor(["--engine", "oracle", "--batch", "64"], str(tmp_path))


# ---------------------------------------------------------------------------
# parity with the JAX package's supervisor under one script


def _scripted_run(tmp_path, sup_cls):
    """A leader that crashes at t=2 with a beating standby (promoted and
    adopted), an adoptee that dies with rc 3 at t=6 while its replacement
    standby never beats (cold restart with backoff), and a last serve
    that exits cleanly. -> (rc, harness)."""
    FakeChild._next_pid = iter(range(40_000, 50_000))
    h = StandbyHarness(tmp_path, sup_cls=sup_cls, n_standby=3,
                       max_restarts=4, backoff_base=0.5, grace=3.0)
    h._standby_pending[1].hb_path = None     # the replacement never beats
    h._standby_pending[2].hb_path = None
    h._pending[0].exit_after, h._pending[0].rc = 2.0, 1
    h._standby_pending[0].exit_after, h._standby_pending[0].rc = 6.0, 3
    h._pending[1].exit_after, h._pending[1].rc = 5.0, 0
    adoptee = h._standby_pending[0]
    beat = adoptee.poll

    def poll():
        # a promoted replica stops writing the standby heartbeat
        if h.sup._adopted_pid == adoptee.pid:
            adoptee.hb_path = None
        return beat()

    adoptee.poll = poll

    def age():
        # the adoptee's first heartbeat lands 0.7 s after its promotion
        # order, the cold restart's 1.2 s after its spawn
        if len(h.spawned) == 1 and h.sup.recoveries == [] \
                and h.sup._adopted_pid is not None:
            return float("inf") if h.now < 2.5 + 0.7 else 0.1
        if len(h.spawned) == 2:
            return float("inf") if h.now < h.spawned[1].spawned_at + 1.2 \
                else 0.1
        return 0.1

    h.age = age
    return h.sup.run(), h


def _norm_argv(cmd, ck):
    return [a.replace(ck, "<ck>") for a in cmd]


def test_supervisor_state_and_events_match_jax(tmp_path):
    runs = {}
    for name, cls in (("jax", JSUP.Supervisor), ("port", Supervisor)):
        d = tmp_path / name
        d.mkdir()
        rc, h = _scripted_run(d, cls)
        h.sup.events.close()
        with open(d / STATE_FILE) as f:
            state = json.load(f)
        with open(d / "events-supervisor.jsonl") as f:
            events = [json.loads(ln) for ln in f]
        runs[name] = (rc, h, state, events, str(d))
    (jrc, jh, jstate, jev, jck), (rc, h, state, ev, ck) = \
        runs["jax"], runs["port"]
    assert rc == jrc == 0
    assert state == jstate
    assert state["recoveries"][0]["promoted"] is True
    assert "promoted" not in state["recoveries"][1]
    assert state["fingerprints"] == {"exit:1": 1, "exit:3": 1}
    kinds = [e["kind"] for e in ev]
    assert kinds == [e["kind"] for e in jev]
    for k in ("supervisor.spawn", "supervisor.promote", "supervisor.adopt",
              "supervisor.backoff", "supervisor.restart",
              "supervisor.recover", "supervisor.exit"):
        assert k in kinds
    assert ev == jev
    assert h.sleeps == jh.sleeps
    # the children: argv equal apart from the CLI module, equal stamps
    for mine, theirs in ((h.spawned, jh.spawned),
                         (h.standby_spawned, jh.standby_spawned)):
        assert len(mine) == len(theirs)
    cmds = [(c.env["KME_RESTART_ORDINAL"], c.env.get("KME_FAILED_AT"))
            for c in h.spawned]
    assert cmds == [(c.env["KME_RESTART_ORDINAL"],
                     c.env.get("KME_FAILED_AT")) for c in jh.spawned]
    for mine, theirs in ((h.sup.base_cmd, jh.sup.base_cmd),
                         (h.sup.standby_cmd, jh.sup.standby_cmd)):
        assert mine[2] == "kme_tpu_torch.cli" and theirs[2] == "kme_tpu.cli"
        assert _norm_argv(mine[:2] + mine[3:], ck) == \
            _norm_argv(theirs[:2] + theirs[3:], jck)
    with open(os.path.join(ck, "promote.json")) as f:
        order = json.load(f)
    with open(os.path.join(jck, "promote.json")) as f:
        assert order == json.load(f)


# ---------------------------------------------------------------------------
# supervise_groups: per-group roots, ports and children; the autoscale
# monitor


class _ExitingChild:
    """A child that exits cleanly after `after` seconds of real time."""

    _pids = iter(range(60_000, 70_000))

    def __init__(self, cmd, after):
        self.cmd = cmd
        self.pid = next(_ExitingChild._pids)
        self.returncode = None
        self._end = time.monotonic() + after

    def poll(self):
        if self.returncode is None and time.monotonic() >= self._end:
            self.returncode = 0
        return self.returncode

    def send_signal(self, sig):
        self.returncode = -9

    def terminate(self):
        if self.returncode is None:
            self.returncode = -15

    def kill(self):
        self.returncode = -9

    def wait(self, timeout=None):
        return self.returncode


def test_supervise_groups_builds_per_group_children(tmp_path):
    spawned = []

    def popen(cmd, env):
        # serves exit cleanly, standbys follow until they are stopped
        spawned.append(_ExitingChild(cmd, 0.05 if cmd[3] == "serve"
                                     else float("inf")))
        return spawned[-1]

    root = str(tmp_path)
    rc = SUP.supervise_groups(
        ["--engine", "seq", "--device", "cpu"], root, 3, port_base=7100,
        host="127.0.0.2", echo=False, popen=popen, poll=0.01,
        standby=True, mtime=lambda p: time.time())
    assert rc == 0
    serves = sorted((c.cmd for c in spawned if c.cmd[3] == "serve"),
                    key=lambda c: c[c.index("--group") + 1])
    standbys = [c.cmd for c in spawned if c.cmd[3] == "standby"]
    assert len(serves) == 3 and len(standbys) == 3
    for k, cmd in enumerate(serves):
        gdir = os.path.join(root, f"group{k}")
        assert os.path.isdir(gdir)
        assert cmd[:4] == [sys.executable, "-m", "kme_tpu_torch.cli",
                           "serve"]
        assert cmd[4:8] == ["--checkpoint-dir", gdir, "--health-file",
                            os.path.join(gdir, "serve.health")]
        assert cmd[8:] == ["--engine", "seq", "--device", "cpu",
                           "--group", f"{k}/3",
                           "--listen", f"127.0.0.2:{7100 + k}"]
    for cmd in standbys:
        assert cmd[3] == "standby" and cmd[-6:-4] == ["--device", "cpu"]
    for bad in ("--listen", "--listen=127.0.0.1:1", "--group", "--gr",
                "--lis"):
        with pytest.raises(ValueError, match="managed per group"):
            SUP.supervise_groups([bad, "x"], root, 2, echo=False,
                                 popen=popen)
    with pytest.raises(ValueError):
        SUP.supervise_groups([], root, 0, echo=False, popen=popen)


def test_autoscale_monitor_trace_replays_in_both_packages(tmp_path):
    """`--groups auto`: the monitor's trace, replayed by either
    package's simulate_autoscale, gives the proposals it wrote to
    autoscale.json; the flight recorder logged every tick."""
    root = str(tmp_path)
    lags = (120.0, 90.0)

    def popen(cmd, env):
        # each serve child writes its heartbeat with its group's gauges
        hb = cmd[cmd.index("--health-file") + 1]
        k = int(cmd[cmd.index("--group") + 1].split("/")[0])
        with open(hb, "w") as f:
            json.dump({"metrics": {"gauges": {f"group{k}_lag": lags[k],
                                              "overload_state": k}}}, f)
        return _ExitingChild(cmd, 0.6)

    cfg = AS.AutoscaleConfig(dwell=2, cooldown=3)
    rc = SUP.supervise_groups([], root, 2, echo=False, popen=popen,
                              poll=0.01, autoscale_cfg=cfg,
                              autoscale_poll=0.02,
                              mtime=lambda p: time.time())
    assert rc == 0
    trace = AS.load_trace(os.path.join(root, "autoscale.trace.jsonl"))
    assert len(trace) >= 3
    # (a tick before the children's first heartbeats reads them as idle)
    assert {"groups": 2, "lags": [120.0, 90.0],
            "overload": [0, 1]} in trace
    with open(os.path.join(root, "autoscale.json")) as f:
        doc = json.load(f)
    assert doc["config"]["dwell"] == 2 and doc["ticks"] == len(trace)
    # the monitor holds `groups` fixed (it only proposes), so replay
    # each sample with its groups pinned
    got = AS.simulate_autoscale(trace, cfg)
    want = JAS.simulate_autoscale(JAS.load_trace(
        os.path.join(root, "autoscale.trace.jsonl")),
        JAS.AutoscaleConfig(dwell=2, cooldown=3))
    assert got == want
    assert got["decisions"] == doc["decisions"]
    assert "split" in [d["action"] for d in doc["decisions"]]
    with open(os.path.join(root, "events-autoscale.jsonl")) as f:
        kinds = [json.loads(ln)["kind"] for ln in f]
    assert len(kinds) == len(trace)
    assert "autoscale.propose" in kinds


# ---------------------------------------------------------------------------
# the standby takes --device from the forwarded serve args


def test_standby_parses_device_from_forwarded_serve_args(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    seen = {}

    class FakeReplica:
        def __init__(self, checkpoint_dir, **kw):
            seen.update(kw, checkpoint_dir=checkpoint_dir)
            self.tsdb = self.metrics_server = None

        def run(self):
            return 0

    monkeypatch.setattr(REP, "Replica", FakeReplica)
    sup = Supervisor(["--engine", "seq", "--device", "cpu", "--pipeline",
                      "2", "--listen", "127.0.0.1:9"], str(tmp_path))
    argv = sup.standby_cmd[4:]
    assert sup.standby_cmd[2:4] == ["kme_tpu_torch.cli", "standby"]
    assert REP.main(argv) == 0
    assert seen["device"] == "cpu" and seen["engine"] == "seq"
    assert seen["listen"] == "127.0.0.1:9"
    assert seen["health_file"] == os.path.join(str(tmp_path),
                                               "standby.health")
    assert "ignoring serve-only flag(s): --pipeline 2" in \
        capsys.readouterr().err
    seen.clear()
    assert REP.main(["--checkpoint-dir", str(tmp_path)]) == 0
    assert seen["device"] == "cuda"         # the card unless told


def test_supervisor_imports_no_torch():
    """The supervisor launches, watches files and signals: its import
    chain holds no torch, so it can make no CUDA context."""
    import subprocess

    code = ("import sys; import kme_tpu_torch.bridge.supervise, "
            "kme_tpu_torch.cli; "
            "sys.exit('torch' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
