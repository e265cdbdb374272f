"""kme-torch-supervise: failure detection + automatic restart for
kme-torch-serve.

The port of `kme_tpu/bridge/supervise.py`: the same policy, the same
`supervisor.json`, `promote.json`, `autoscale.json`,
`autoscale.trace.jsonl` and `supervisor.*` / `autoscale.*` events, so
either package reads the other's files. Its children are the port's
(`python -m kme_tpu_torch.cli serve|standby`), which run their engines
on the card unless the forwarded serve args say `--device cpu`. The
supervisor itself imports no torch and touches no device: it launches,
watches files and signals. On the card a child's first heartbeat comes
after the torch import, the CUDA context, the kernel library load and
the snapshot restore; pass `--grace` above that start-up time.

The reference gets this for free from Kafka Streams group membership —
a died instance's partitions are reassigned and state is restored from
changelogs (KProcessor.java:59-60, library behavior). Here the same
role is played by a supervisor process: it launches `kme-torch-serve` as a
child with a heartbeat file (--health-file) and a checkpoint directory,
and restarts the child from its newest checkpoint whenever

- the child process exits with a non-zero status, or
- the heartbeat goes STALE (mtime older than --stale-after seconds:
  the process froze or died), or
- the serve LOOP TICK in the heartbeat stops advancing for
  --stall-after seconds (the loop iterates even when idle, so a frozen
  tick means a hang inside step() — e.g. a stuck device call — even
  while the heartbeat thread keeps the mtime fresh).

Restart policy (the production-shaped part):

- restarts are paced by JITTERED EXPONENTIAL BACKOFF keyed on the
  failure FINGERPRINT (exit:<rc> / stale / stall): a crash LOOP — the
  same fingerprint repeating — doubles the delay each round up to
  --backoff-cap, while a novel failure resets to --backoff-base, so a
  one-off blip restarts fast and a deterministic crash does not spin.
- the restart BUDGET (--max-restarts) counts failures but DECAYS: each
  --healthy-decay seconds of continuous healthy child uptime refunds
  one unit. A service that crashes once a day never exhausts a budget
  of 5; only a crash loop does. (`restarts_total` stays lifetime for
  reporting — only the budget decays.)
- each incarnation is stamped via environment: KME_RESTART_ORDINAL
  (lifetime restart count) and KME_FAILED_AT (wall time the failure
  was detected), which the child surfaces as the restarts_total and
  recovery_seconds telemetry gauges.
- supervisor state (restarts, budget, fingerprints, per-recovery
  timings) is mirrored to <checkpoint-dir>/supervisor.json after every
  transition — the chaos report reads it post-mortem.

Hot-standby failover (--standby): the supervisor also keeps a
`kme-torch-standby` replica (bridge/replica.py) running against the same
checkpoint dir. The replica restores the newest snapshot and tails the
durable MatchIn log, staying within one batch of the leader. When the
leader FAILS and the standby looks ready (alive + writing its
heartbeat), the supervisor skips the cold restart entirely: it writes
<checkpoint-dir>/promote.json and ADOPTS the standby process as the
serving child — the replica acquires the next leader epoch, fences the
old one at the broker, binds the leader's endpoint and keeps serving
(no backoff, no snapshot reload, no input replay from disk). The
recovery entry is marked promoted:true with its failover_seconds; a
replacement standby is then launched behind the new leader. Failures
with no ready standby fall back to the ordinary restart path.

Durability is the existing checkpoint/resume contract: broker topic
logs persist under the checkpoint dir, the child resumes from the
newest fsync'd snapshot, and at-least-once replay of the input tail
reproduces the byte-exact output stream
(tests/test_torch_supervise.py kills the child mid-stream and requires
the completed MatchOut stream to equal the oracle's).

The Supervisor class takes injectable clock / sleep / popen / mtime
hooks so the detection and policy logic is unit-testable in
milliseconds (tests/test_torch_supervise_unit.py) — the defaults are the
real OS facilities.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
import time
from typing import Optional

STATE_FILE = "supervisor.json"


class Supervisor:
    def __init__(self, serve_args, checkpoint_dir: str,
                 stale_after: float = 10.0, max_restarts: int = 5,
                 grace: float = 5.0, poll: float = 0.5, echo: bool = True,
                 stall_after: float = 300.0,
                 backoff_base: float = 0.25, backoff_cap: float = 10.0,
                 healthy_decay: float = 60.0, standby: bool = False,
                 tag: str = "",
                 popen=None, clock=None, sleep=None, mtime=None,
                 rng=None) -> None:
        """serve_args: argv tail passed to `kme-torch-serve` verbatim (the
        supervisor adds --checkpoint-dir and --health-file itself; a
        user-supplied occurrence of either inside serve_args would
        silently WIN under argparse's last-occurrence rule, leaving the
        supervisor watching a heartbeat file the child never writes —
        so both are rejected)."""
        reserved = ("--checkpoint-dir", "--health-file")
        for a in serve_args:
            flag = a.split("=", 1)[0]
            # argparse abbreviation: any prefix of a reserved flag
            # resolves to it in the child (allow_abbrev default), so
            # prefixes are rejected too
            if (flag.startswith("--") and len(flag) > 2
                    and any(r.startswith(flag) for r in reserved)):
                raise ValueError(
                    f"{flag} is managed by the supervisor and cannot "
                    f"appear in serve_args (the child must write the "
                    f"heartbeat/checkpoints the supervisor watches)")
        self.checkpoint_dir = checkpoint_dir
        self.tag = tag          # log prefix, e.g. "[g0]" in groups mode
        self.stale_after = stale_after
        self.max_restarts = max_restarts
        self.grace = grace
        self.poll = poll
        self.echo = echo
        self.stall_after = stall_after
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.healthy_decay = healthy_decay
        # injectable OS facilities (unit tests script these)
        self._popen = popen or (
            lambda cmd, env: subprocess.Popen(cmd, env=env))
        self._clock = clock or time.time
        self._sleep = sleep or time.sleep
        self._mtime = mtime or (lambda p: os.stat(p).st_mtime)
        self._rng = rng or random.Random()
        self.hb = os.path.join(checkpoint_dir, "serve.health")
        self.base_cmd = [sys.executable, "-m", "kme_tpu_torch.cli", "serve",
                         "--checkpoint-dir", checkpoint_dir,
                         "--health-file", self.hb] + list(serve_args)
        # hot-standby failover (module docstring): the standby child is
        # a kme-torch-standby replica over the SAME serve_args — it parses the
        # engine-shape flags and loudly ignores serve-only ones
        self.standby = standby
        self.promote_file = os.path.join(checkpoint_dir, "promote.json")
        self.standby_hb = os.path.join(checkpoint_dir, "standby.health")
        self.standby_cmd = [sys.executable, "-m", "kme_tpu_torch.cli",
                            "standby",
                            "--checkpoint-dir", checkpoint_dir,
                            "--health-file", self.standby_hb,
                            ] + list(serve_args)
        self._standby_proc = None
        self._adopted_pid = None     # pid the live promote file targets
        self.standby_restarts = 0
        # policy state
        self.restarts_total = 0      # lifetime, for reporting
        self.budget_used = 0         # decays over healthy uptime
        self.fingerprints: dict = {}
        self.recoveries: list = []
        self._last_fingerprint: Optional[str] = None
        self._streak = 0
        # control-plane flight recorder (telemetry/events.py): every
        # supervision decision — spawn, crash fingerprint, backoff,
        # restart, promotion/adoption — lands in the durable timeline.
        # The group ordinal is recovered from the "[gK]" tag so merged
        # timelines anchor per group; ts comes from the injected clock
        # (fake-clock unit tests get deterministic stamps for free).
        from kme_tpu_torch.telemetry import events as cpevents

        self._group = -1
        if tag.startswith("[g") and tag.endswith("]"):
            with contextlib.suppress(ValueError):
                self._group = int(tag[2:-1])
        src = ("supervisor" if self._group < 0
               else f"supervisor.g{self._group}")
        self.events = cpevents.open_log(checkpoint_dir, src,
                                        clock=self._clock)

    def _event(self, kind: str, severity: str = "info",
               **detail) -> None:
        """Append one timeline event; the recorder must never be able
        to kill supervision."""
        try:
            self.events.emit(kind, severity=severity,
                             group=self._group, **detail)
        except Exception:
            pass

    # -- small injectable-friendly primitives --------------------------

    def _say(self, msg: str) -> None:
        if self.echo:
            print(f"kme-supervise{self.tag}: {msg}", file=sys.stderr)

    def _hb_age(self) -> float:
        try:
            return self._clock() - self._mtime(self.hb)
        except OSError:
            return float("inf")

    def _hb_tick(self):
        try:
            with open(self.hb) as f:
                return json.load(f).get("tick")
        except (OSError, ValueError):
            return None

    def _hb_closing(self) -> bool:
        """True when the child's FINAL heartbeat says the serve loop
        ended ON PURPOSE (idle-exit / max-messages): its tick is frozen
        by definition, so the stall detector stands down and lets the
        exit (or, if teardown truly hangs, the stale branch) decide."""
        try:
            with open(self.hb) as f:
                return bool(json.load(f).get("closing"))
        except (OSError, ValueError):
            return False

    def _write_state(self) -> None:
        """Mirror policy state to <checkpoint-dir>/supervisor.json
        (atomic replace) — the chaos report reads it post-mortem."""
        path = os.path.join(self.checkpoint_dir, STATE_FILE)
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"restarts_total": self.restarts_total,
                           "budget_used": self.budget_used,
                           "max_restarts": self.max_restarts,
                           "fingerprints": self.fingerprints,
                           "recoveries": self.recoveries,
                           "standby": self.standby,
                           "standby_restarts": self.standby_restarts},
                          f, indent=1)
            os.replace(tmp, path)
        except OSError:
            pass    # reporting surface only; never kill supervision

    # -- hot-standby management (module docstring) ---------------------

    def _ensure_standby(self, env) -> None:
        """(Re)launch the kme-torch-standby replica if it is not running. A
        stale promote file or heartbeat from a previous incarnation is
        removed FIRST — a fresh standby reading yesterday's promote.json
        would instantly (and wrongly) promote itself."""
        if not self.standby:
            return
        if self._standby_proc is not None \
                and self._standby_proc.poll() is None:
            return
        if self._standby_proc is not None:
            self.standby_restarts += 1
            self._say(f"standby died rc="
                      f"{self._standby_proc.returncode}; relaunching")
        # drop a STALE promote file (from a previous run) — but never
        # one addressed to the child we just adopted: it has not
        # necessarily read its promotion order yet, and deleting it
        # here would strand the adoptee following forever
        with contextlib.suppress(OSError, ValueError):
            with open(self.promote_file) as f:
                pid = json.load(f).get("pid")
            if pid is None or pid != self._adopted_pid:
                os.unlink(self.promote_file)
        with contextlib.suppress(OSError):
            os.unlink(self.standby_hb)
        self._say("starting kme-torch-standby replica")
        self._standby_proc = self._popen(self.standby_cmd, env)
        self._event("supervisor.standby_spawn",
                    restarts=self.standby_restarts)

    def _standby_ready(self) -> bool:
        """Promotable = the replica process is alive AND has written a
        heartbeat (it restored a snapshot and entered the follow loop)."""
        return (self._standby_proc is not None
                and self._standby_proc.poll() is None
                and os.path.exists(self.standby_hb))

    def _stop_standby(self) -> None:
        proc, self._standby_proc = self._standby_proc, None
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=5.0)
        except Exception:
            proc.kill()
            proc.wait()

    def _write_promote(self, failed_at: float, pid: int) -> None:
        """The promotion trigger: atomic so the replica never reads a
        torn JSON mid-write, and ADDRESSED to the adoptee's pid so no
        other (older, replacement) standby ever acts on it."""
        tmp = self.promote_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"failed_at": failed_at, "pid": pid,
                       "fingerprint": self._last_fingerprint}, f)
        os.replace(tmp, self.promote_file)
        self._adopted_pid = pid

    def _backoff(self) -> float:
        """Jittered exponential delay keyed on the fingerprint streak:
        1st occurrence waits ~base, each repeat doubles up to cap, and
        the 0.5–1.5x jitter decorrelates a fleet restarting off the
        same shared-dependency failure."""
        delay = min(self.backoff_cap,
                    self.backoff_base * (2 ** max(0, self._streak - 1)))
        return delay * (0.5 + self._rng.random())

    def _note_failure(self, fingerprint: str) -> None:
        self.restarts_total += 1
        self.budget_used += 1
        self.fingerprints[fingerprint] = \
            self.fingerprints.get(fingerprint, 0) + 1
        if fingerprint == self._last_fingerprint:
            self._streak += 1
        else:
            self._last_fingerprint, self._streak = fingerprint, 1
        self._write_state()

    # -- the supervision loop ------------------------------------------

    def run(self) -> int:
        """Run kme-torch-serve under supervision; returns the child's final
        rc (0 = clean exit, 1 = restart budget exhausted)."""
        failed_at: Optional[float] = None    # wall time of last failure
        adopt = None          # a promoted standby becoming the child
        was_promoted = False
        while True:
            with contextlib.suppress(OSError):
                os.unlink(self.hb)
            env = dict(os.environ)
            env["KME_RESTART_ORDINAL"] = str(self.restarts_total)
            if failed_at is not None:
                env["KME_FAILED_AT"] = repr(failed_at)
            else:
                env.pop("KME_FAILED_AT", None)
            if adopt is not None:
                # hot failover: the standby replica is promoting itself
                # right now — adopt it as the serving child, skip the
                # cold start AND the backoff (there is no crash loop to
                # pace: the failed incarnation is a different process)
                child, adopt = adopt, None
                self._say("failing over to the hot standby "
                          "(promote.json written)")
                self._event("supervisor.adopt", pid=child.pid,
                            fingerprint=self._last_fingerprint)
            else:
                was_promoted = False
                self._say(f"starting kme-torch-serve (restart "
                          f"{self.budget_used}/{self.max_restarts})")
                child = self._popen(self.base_cmd, env)
                self._event(
                    "supervisor.restart" if self.restarts_total
                    else "supervisor.spawn",
                    ordinal=self.restarts_total, pid=child.pid)
            self._ensure_standby(env)
            start = self._clock()
            failed = fingerprint = None
            recovering = failed_at    # measure to the first heartbeat
            # stall detection ARMS only once the loop has ticked at
            # least once: a first batch can legitimately sit in an
            # XLA/Pallas compile for minutes before the first step()
            # returns, and killing it mid-compile would loop forever
            last_tick, tick_since, armed = None, self._clock(), False
            last_decay = self._clock()
            while True:
                self._sleep(self.poll)
                now = self._clock()
                # healthy-uptime budget decay: each healthy_decay
                # seconds of continuous uptime refunds one budget unit
                # (a crash LOOP never stays up long enough to refund)
                if (self.budget_used > 0
                        and now - last_decay >= self.healthy_decay):
                    last_decay = now
                    self.budget_used -= 1
                    self._say(f"healthy for {self.healthy_decay:.0f}s; "
                              f"restart budget refunded "
                              f"({self.budget_used}/{self.max_restarts} "
                              f"used)")
                    self._write_state()
                self._ensure_standby(env)    # relaunch a dead replica
                if child.poll() is not None:
                    rc = child.returncode
                    if rc == 0:
                        self._say("child exited cleanly")
                        self._event("supervisor.exit", rc=0)
                        self._stop_standby()
                        self._write_state()
                        return 0
                    failed = f"child exited rc={rc}"
                    fingerprint = f"exit:{rc}"
                    break
                age = self._hb_age()
                if age == float("inf"):
                    # allow a startup grace window before the first
                    # heartbeat is due
                    if now - start < self.grace:
                        continue
                    failed = (f"no heartbeat within grace "
                              f"({self.grace}s)")
                    fingerprint = "stale"
                    break
                if recovering is not None:
                    # first heartbeat of a restarted incarnation: the
                    # service is serving again — close the recovery
                    # window opened at failure detection
                    took = now - recovering
                    entry = {"fingerprint": self._last_fingerprint,
                             "detected_at": recovering,
                             "recovered_in": round(took, 3)}
                    if was_promoted:
                        # failure detected -> promoted standby serving:
                        # the bounded-failover number the chaos harness
                        # asserts on
                        entry["promoted"] = True
                        entry["failover_seconds"] = round(took, 3)
                    self.recoveries.append(entry)
                    self._say(f"recovered in {took:.2f}s"
                              + (" (hot failover)" if was_promoted
                                 else ""))
                    self._event("supervisor.recover",
                                recovered_in=entry["recovered_in"],
                                fingerprint=self._last_fingerprint,
                                promoted=was_promoted,
                                **({"failover_seconds":
                                    entry["failover_seconds"]}
                                   if was_promoted else {}))
                    recovering = None
                    self._write_state()
                if age > self.stale_after:
                    failed = (f"heartbeat stale ({age:.1f}s > "
                              f"{self.stale_after}s)")
                    fingerprint = "stale"
                    break
                tick = self._hb_tick()
                if tick != last_tick:
                    # an incarnation's loop counts its ticks from 0 (its
                    # heartbeat file is removed before the spawn), so a
                    # first sight of a tick past 0 means a step already
                    # returned: a loop that hangs before this supervisor
                    # saw two ticks is still caught
                    if last_tick is not None or (tick or 0) > 0:
                        armed = True
                    last_tick, tick_since = tick, now
                elif self._hb_closing():
                    # deliberate shutdown in progress — a frozen tick is
                    # expected; keep the stall timer from accruing so a
                    # slow final checkpoint is not read as a hang
                    tick_since = now
                elif armed and now - tick_since > self.stall_after:
                    failed = (f"serve loop stalled (tick {tick} frozen "
                              f"{now - tick_since:.0f}s)")
                    fingerprint = "stall"
                    break
            failed_at = self._clock()
            self._say(f"FAILURE DETECTED: {failed}")
            self._event("supervisor.crash", severity="error",
                        fingerprint=fingerprint, reason=failed)
            if child.poll() is None:
                child.send_signal(signal.SIGKILL)
                child.wait()
            self._note_failure(fingerprint)
            if self.budget_used > self.max_restarts:
                self._say("restart budget exhausted")
                self._event("supervisor.giveup", severity="error",
                            restarts=self.restarts_total)
                self._stop_standby()
                return 1
            if self._standby_ready():
                # hot failover: hand the stream to the replica instead
                # of cold-restarting. The promote file carries the
                # detection time so the replica can report
                # failover_seconds from ITS side too.
                with contextlib.suppress(OSError):
                    os.unlink(self.standby_hb)
                adopt, self._standby_proc = self._standby_proc, None
                self._write_promote(failed_at, adopt.pid)
                was_promoted = True
                self._event("supervisor.promote", pid=adopt.pid,
                            failed_at=failed_at,
                            fingerprint=self._last_fingerprint)
                continue    # no backoff: not the same process crashing
            delay = self._backoff()
            if delay > 0:
                self._say(f"backing off {delay:.2f}s "
                          f"(failure streak {self._streak} "
                          f"x {self._last_fingerprint})")
                self._event("supervisor.backoff", severity="warn",
                            seconds=round(delay, 3),
                            streak=self._streak,
                            fingerprint=self._last_fingerprint)
                self._sleep(delay)


def supervise(serve_args, checkpoint_dir: str, stale_after: float = 10.0,
              max_restarts: int = 5, grace: float = 5.0,
              poll: float = 0.5, echo: bool = True,
              stall_after: float = 300.0, **kw) -> int:
    """Functional wrapper over Supervisor (the original API)."""
    return Supervisor(serve_args, checkpoint_dir, stale_after=stale_after,
                      max_restarts=max_restarts, grace=grace, poll=poll,
                      echo=echo, stall_after=stall_after, **kw).run()


def _autoscale_monitor(state_root: str, groups: int, stop, cfg,
                       poll: float, echo: bool) -> None:
    """`--groups auto` policy loop: each tick reads every group's
    heartbeat, feeds the pure AutoscaleController the `group{k}_lag`
    and `overload_state` gauges, appends the raw sample to
    autoscale.trace.jsonl (the replay input for simulate_autoscale)
    and any proposal to autoscale.json. The supervisor PROPOSES only:
    executing a proposal is a drain + kme-torch-reshard + restart under the
    new topology — an operator/drill decision, never a background one
    (the running serves' topology is immutable by construction)."""
    from kme_tpu_torch.bridge.autoscale import AutoscaleController, tick_event
    from kme_tpu_torch.telemetry import events as cpevents

    ctl = AutoscaleController(cfg)
    dec_path = os.path.join(state_root, "autoscale.json")
    trace_path = os.path.join(state_root, "autoscale.trace.jsonl")
    evlog = cpevents.open_log(state_root, "autoscale")

    def write_decisions() -> None:
        tmp = dec_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"groups": groups, "ticks": ctl.ticks,
                       "config": dataclasses.asdict(ctl.cfg),
                       "decisions": ctl.decisions}, f, indent=1)
        os.replace(tmp, dec_path)

    with open(trace_path, "a", encoding="utf-8") as trace:
        while not stop.wait(poll):
            lags, states = [], []
            for k in range(groups):
                lag = state = 0
                try:
                    with open(os.path.join(state_root, f"group{k}",
                                           "serve.health")) as f:
                        g = json.load(f).get("metrics", {}).get(
                            "gauges", {})
                    lag = float(g.get(f"group{k}_lag", 0) or 0)
                    state = int(g.get("overload_state", 0) or 0)
                except (OSError, ValueError, TypeError):
                    pass    # no heartbeat yet: count as idle
                lags.append(lag)
                states.append(state)
            sample = {"groups": groups, "lags": lags,
                      "overload": states}
            trace.write(json.dumps(sample) + "\n")
            trace.flush()
            d = ctl.observe(groups, lags, states)
            try:
                evlog.emit("autoscale.propose" if d is not None
                           else "autoscale.observe",
                           severity="warn" if d is not None else "info",
                           **tick_event(ctl, groups, lags, states, d))
            except Exception:
                pass    # the recorder never kills the policy loop
            if d is not None:
                write_decisions()
                if echo:
                    print(f"[autoscale] propose {d['action']} "
                          f"{d['from']}→{d['to']} (max_lag "
                          f"{d['max_lag']:.0f}, imbalance "
                          f"{d['imbalance']})", file=sys.stderr)
    write_decisions()
    evlog.close()


def supervise_groups(serve_args, state_root: str, groups: int,
                     port_base: int = 9092, host: str = "127.0.0.1",
                     echo: bool = True, autoscale_cfg=None,
                     autoscale_poll: float = 1.0, **kw) -> int:
    """Multi-leader scale-out: run `groups` independent
    leader/standby pairs under ONE supervisor process. Group k gets its
    own checkpoint root <state_root>/group{k} (lease, snapshots, broker
    log, journal all disjoint), its own broker endpoint at
    port_base + k, and `--group k/N` on its serve/standby children so
    every durable broker topic is namespaced. Each pair has its OWN
    Supervisor instance — backoff fingerprints, restart budgets and
    promotion decisions never couple across groups, which is exactly
    the failure-isolation property the shard-failover drill asserts.
    Returns the max exit code across groups (0 = all healthy exits)."""
    import threading

    if groups < 1:
        raise ValueError(f"--groups wants >= 1, got {groups}")
    for a in serve_args:
        flag = a.split("=", 1)[0]
        if (flag.startswith("--") and len(flag) > 2
                and any(r.startswith(flag)
                        for r in ("--listen", "--group"))):
            raise ValueError(
                f"{flag} is managed per group by the supervisor in "
                f"--groups mode and cannot appear in serve_args")
    sups = []
    for k in range(groups):
        gdir = os.path.join(state_root, f"group{k}")
        os.makedirs(gdir, exist_ok=True)
        gargs = list(serve_args) + [
            "--group", f"{k}/{groups}",
            "--listen", f"{host}:{port_base + k}"]
        sups.append(Supervisor(gargs, gdir, echo=echo,
                               tag=f"[g{k}]", **kw))
    monitor = stop_monitor = None
    if autoscale_cfg is not None:
        stop_monitor = threading.Event()
        monitor = threading.Thread(
            target=_autoscale_monitor,
            args=(state_root, groups, stop_monitor, autoscale_cfg,
                  autoscale_poll, echo),
            daemon=True)
        monitor.start()
    if groups == 1 and monitor is None:
        return sups[0].run()
    rcs = [0] * groups
    threads = []
    for k, sup in enumerate(sups):
        def _run(k=k, sup=sup):
            try:
                rcs[k] = sup.run()
            except ValueError as e:
                print(f"kme-supervise[g{k}]: {e}", file=sys.stderr)
                rcs[k] = 2
        th = threading.Thread(target=_run, name=f"supervise-g{k}",
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    if monitor is not None:
        stop_monitor.set()
        monitor.join(timeout=10.0)
    return max(rcs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kme-torch-supervise", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint-dir", required=True,
                   help="checkpoint + broker-log + heartbeat directory "
                        "(the restart state root)")
    p.add_argument("--stale-after", type=float, default=10.0,
                   help="heartbeat age that counts as a frozen process")
    p.add_argument("--stall-after", type=float, default=300.0,
                   help="seconds without a loop-tick advance that count "
                        "as a hang inside step()")
    p.add_argument("--max-restarts", type=int, default=5,
                   help="restart budget; refunded by healthy uptime "
                        "(--healthy-decay), so only a crash LOOP "
                        "exhausts it")
    p.add_argument("--grace", type=float, default=5.0,
                   help="startup seconds before the first heartbeat is due")
    p.add_argument("--backoff-base", type=float, default=0.25,
                   help="restart delay for a first/novel failure; "
                        "repeats of the same failure fingerprint double "
                        "it up to --backoff-cap (with 0.5-1.5x jitter)")
    p.add_argument("--backoff-cap", type=float, default=10.0)
    p.add_argument("--healthy-decay", type=float, default=60.0,
                   help="seconds of continuous healthy uptime that "
                        "refund one restart-budget unit")
    p.add_argument("--standby", action="store_true",
                   help="keep a kme-torch-standby hot replica tailing the "
                        "durable input; on failure, promote it (write "
                        "promote.json, adopt the process) instead of "
                        "cold-restarting — bounded failover with "
                        "exactly-once output preserved")
    p.add_argument("--poll", type=float, default=0.5,
                   help="watch-loop poll interval (failure detection "
                        "latency bound)")
    p.add_argument("--groups", default="1", metavar="N|auto",
                   help="multi-leader scale-out: run N independent "
                        "leader(/standby) pairs, group k rooted at "
                        "<checkpoint-dir>/group{k} with --group k/N "
                        "and its own broker port (--port-base + k); "
                        "backoff fingerprints and restart budgets "
                        "never couple across groups. 'auto' starts "
                        "--groups-initial groups and runs the "
                        "deterministic autoscale policy over the group "
                        "heartbeats, appending split/merge proposals "
                        "to <checkpoint-dir>/autoscale.json (executed "
                        "via kme-torch-reshard, never in the background)")
    p.add_argument("--groups-initial", type=int, default=2, metavar="N",
                   help="group count '--groups auto' starts with")
    p.add_argument("--autoscale-high-lag", type=float, default=48.0,
                   help="per-group input lag that votes split "
                        "(pairs with kme-torch-serve --overload-high-lag)")
    p.add_argument("--autoscale-low-lag", type=float, default=4.0,
                   help="cluster-wide lag ceiling that votes merge")
    p.add_argument("--autoscale-dwell", type=int, default=3,
                   help="consecutive hot/cold policy ticks before a "
                        "proposal (hysteresis)")
    p.add_argument("--autoscale-cooldown", type=int, default=8,
                   help="quiet policy ticks after any proposal")
    p.add_argument("--port-base", type=int, default=9092,
                   help="first group's broker port in --groups mode "
                        "(group k listens on --port-base + k)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for the per-group broker "
                        "endpoints in --groups mode")
    p.add_argument("serve_args", nargs=argparse.REMAINDER,
                   help="arguments after '--' go to kme-torch-serve verbatim")
    args = p.parse_args(argv)
    serve_args = args.serve_args
    if serve_args and serve_args[0] == "--":
        serve_args = serve_args[1:]
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    policy = dict(stale_after=args.stale_after,
                  max_restarts=args.max_restarts, grace=args.grace,
                  poll=args.poll,
                  stall_after=args.stall_after,
                  backoff_base=args.backoff_base,
                  backoff_cap=args.backoff_cap,
                  healthy_decay=args.healthy_decay,
                  standby=args.standby)
    autoscale_cfg = None
    if args.groups == "auto":
        from kme_tpu_torch.bridge.autoscale import AutoscaleConfig

        groups = args.groups_initial
        autoscale_cfg = AutoscaleConfig(
            high_lag=args.autoscale_high_lag,
            low_lag=args.autoscale_low_lag,
            dwell=args.autoscale_dwell,
            cooldown=args.autoscale_cooldown)
    else:
        try:
            groups = int(args.groups)
        except ValueError:
            p.error(f"--groups wants an integer or 'auto', "
                    f"got {args.groups!r}")
    try:
        if groups > 1 or autoscale_cfg is not None:
            return supervise_groups(serve_args, args.checkpoint_dir,
                                    groups,
                                    port_base=args.port_base,
                                    host=args.host,
                                    autoscale_cfg=autoscale_cfg,
                                    **policy)
        return supervise(serve_args, args.checkpoint_dir, **policy)
    except ValueError as e:
        print(f"kme-supervise: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
