"""kme-torch-chaos: deterministic fault-injection runs with byte-exact verify.

The port of `kme_tpu/bridge/chaos.py`: the same scenarios, schedules,
verifiers, bounds and report, over the port's own children
(`python -m kme_tpu_torch.cli supervise|serve` and `python -m
kme_tpu_torch.bridge.reshard`), which import no JAX.

Where it differs from `kme-chaos`: the engine under attack defaults to
`--engine seq` (`kme-chaos` defaults to the host-only oracle), and
`--device` (default `cuda`) is forwarded to every serve child, so the
children run the seq kernel on the card; the supervisor hands the same
serve arguments to the hot standby. The drills with a hot standby
(failover, shard-failover, feed-failover) hold their input until the
standby's first heartbeat: the supervisor promotes only a standby that
is up, and the port's host-engine leader reaches a short drill's kill
point before its standby is. shard-failover also holds every group's
input until every group's leader is up, so that the survivors are
serving when the victim is killed (a card child takes seconds to
start). Without a card, `--engine seq` or
`lanes` on `--device cuda` exits with an error at once: nothing falls
back to the CPU. Pass `--device cpu` (the kernels' plain versions) or
`--engine oracle` to run a drill without a card, as the tests do.
Every other default and bound is `kme-chaos`'s.

The recovery stack (kme-torch-supervise -> checkpoint/resume ->
at-least-once replay) is only trustworthy if something attacks it on
purpose. This harness is that something: it runs a seeded workload
through a supervised kme-torch-serve while a KME_FAULTS schedule
(kme_tpu_torch/faults.py) injects broker I/O errors, partial TCP frames,
torn and bit-flipped snapshots, torn journal tails, SIGKILLs at exact
input offsets and stuck serve loops — then requires the COMPLETED
MatchOut stream to be byte-exact against an in-process oracle replay of
the same input, modulo the at-least-once duplication the recovery
contract explicitly permits (crash -> resume from snapshot -> replay of
the input tail).

Everything is deterministic from --seed: the workload
(kme_tpu_torch.workload.harness_stream) and every fault rule's RNG
derive from it, so a failing run reproduces from its report's spec
string.

The run:

1. compute the oracle's expected per-message output groups in-process;
2. start `kme-torch-supervise -- kme-torch-serve ...` with KME_FAULTS +
   KME_FAULTS_STATE in its environment (the state dir makes n-limited
   rules fire once across ALL child incarnations);
3. produce the input over the TCP broker protocol, idempotently:
   transport faults reconnect + resync from end_offset(MatchIn), and
   wire-level rej_overload (the bounded-ingress shed) backs off and
   retries — input content is never duplicated or dropped;
4. wait for the supervisor to exit (the child exits cleanly once the
   input is drained and --idle-exit lapses);
5. read the durable MatchOut topic log post-mortem and verify it is a
   prefix+replay composition of the oracle groups (verify_stream);
6. emit a JSON report: verification result, restarts, replayed
   messages, per-fault fire counts, measured recovery times.

Exit 0 iff the stream verifies, the supervisor exited cleanly and at
least --min-restarts automatic restarts happened (a chaos run where
nothing died proves nothing).

--scenario failover drills the exactly-once failover stack instead:
the leader runs with a hot standby (kme-torch-supervise --standby), one
seeded SIGKILL lands mid-stream, and the run only passes if the
supervisor promoted the replica within --max-failover seconds, the
promoted epoch is visible in the log's produce stamps, a stale-epoch
produce is fenced post-mortem, broker-side dedup suppressed the
promoted leader's replayed overlap (dup_suppressed_total > 0), and the
deduped MatchOut stream is BYTE-EXACT against the flat oracle stream —
zero visible duplicates (verify_failover), a strictly stronger contract
than verify_stream's at-least-once composition.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

from kme_tpu_torch.bridge.service import TOPIC_IN, TOPIC_OUT


def default_schedule(seed: int, events: int, journal: bool) -> str:
    """A schedule touching every layer: transport, snapshot integrity,
    journal tail, process death and a hung loop. Offsets scale with the
    workload so the kill lands mid-stream and the stall near the end."""
    kill_at = max(1, events // 2)
    stuck_at = max(2, (events * 3) // 4)
    clauses = [f"seed={seed}",
               "broker.fetch:n=2",          # service poll errors (retried)
               "broker.produce:n=1:after=20",   # producer-side I/O error
               "tcp.partial:n=1:after=10",  # poisoned client stream
               "ckpt.torn:n=1:after=1",     # 2nd snapshot truncated
               "ckpt.bitflip:n=1:after=2",  # 3rd snapshot corrupted
               f"serve.kill:at={kill_at}",  # SIGKILL mid-stream
               f"serve.stuck:at={stuck_at}"]  # hung step() near the end
    if journal:
        clauses.append("journal.torn:n=1:after=5")  # crash mid-append
    return ";".join(clauses)


def failover_schedule(seed: int, events: int) -> str:
    """The failover scenario's schedule: ONE clean SIGKILL mid-stream.
    The point under test is the promotion machinery (standby adoption,
    epoch fencing, idempotent-produce dedup of the replayed overlap),
    so no other fault muddies the failure fingerprint or the timing."""
    return f"seed={seed};serve.kill:at={max(1, events // 2)}"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def expected_groups(lines: List[str], slots: int,
                    max_fills: int) -> List[List[str]]:
    """The oracle's per-input-message MatchOut line groups — the ground
    truth the durable stream must compose from."""
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.wire import parse_order

    eng = OracleEngine("fixed", book_slots=slots, max_fills=max_fills)
    return [[rec.wire() for rec in eng.process(parse_order(ln))]
            for ln in lines]


def verify_stream(got: List[str], per_msg: List[List[str]]
                  ) -> Tuple[bool, dict]:
    """Check `got` (the durable MatchOut lines) against the oracle
    groups under the at-least-once contract: the stream must be a
    concatenation of segments, each a run of consecutive whole groups,
    where a segment may end mid-group (crash between produces) and the
    next segment restarts at an EARLIER group (replay from a snapshot).
    Every group must eventually complete in order. Returns
    (ok, {messages, replays, replayed_messages, got_lines,
    expected_lines, error})."""
    i = j = 0               # i: cursor in got, j: next group to complete
    replays = replayed = 0
    detail: dict = {"got_lines": len(got),
                    "expected_lines": sum(len(g) for g in per_msg),
                    "messages": len(per_msg)}
    while i < len(got) or j < len(per_msg):
        exp = per_msg[j] if j < len(per_msg) else None
        if exp is not None and got[i:i + len(exp)] == exp \
                and i + len(exp) <= len(got):
            i += len(exp)
            j += 1
            continue
        # mismatch, short tail, or all groups done with got remaining:
        # this must be a crash point. Consume any partial prefix of the
        # current group (the child died between produces of one batch)…
        p = 0
        if exp is not None:
            while (p < len(exp) and i + p < len(got)
                   and got[i + p] == exp[p]):
                p += 1
        i += p
        if i >= len(got):
            if j < len(per_msg):
                detail["error"] = (f"stream ends early: group {j} of "
                                   f"{len(per_msg)} incomplete")
                return False, detail
            break
        # …then the next durable line must start a REPLAY: a run that
        # begins at some group S <= j (the snapshot the child resumed
        # from). Prefer the largest S (minimal replay).
        found = None
        for S in range(j, -1, -1):
            e2 = per_msg[S] if S < len(per_msg) else None
            if e2 and got[i:i + len(e2)] == e2:
                found = S
                break
        if found is None or (found == j and p == 0):
            detail["error"] = (f"byte divergence at line {i} "
                               f"(group {j}): {got[i][:100]!r}")
            return False, detail
        replays += 1
        replayed += sum(1 for g in per_msg[found:j] if g) + (1 if p else 0)
        j = found
    if j < len(per_msg):
        detail["error"] = (f"only {j} of {len(per_msg)} groups "
                           f"completed")
        return False, detail
    detail["replays"] = replays
    detail["replayed_messages"] = replayed
    return True, detail


class _Producer(threading.Thread):
    """Idempotent MatchIn feeder: re-syncs from end_offset after any
    transport fault (so injected tcp.partial / disconnects / broker
    errors never duplicate or drop input) and treats rej_overload as
    backpressure (sleep + retry the SAME record)."""

    def __init__(self, host: str, port: int, lines: List[str],
                 topic: str = TOPIC_IN, topics=None) -> None:
        super().__init__(daemon=True)
        self.host, self.port, self.lines = host, port, lines
        self.topic = topic
        self.topics = topics      # provision set (None = classic pair)
        self.sent = 0
        self.overload_retries = 0
        self.reconnects = 0
        self.stop = threading.Event()

    def run(self) -> None:
        from kme_tpu_torch.bridge.broker import BrokerError, BrokerOverload
        from kme_tpu_torch.bridge.provision import provision
        from kme_tpu_torch.bridge.tcp import TcpBroker

        client = None
        while self.sent < len(self.lines) and not self.stop.is_set():
            try:
                if client is None:
                    client = TcpBroker(self.host, self.port, timeout=10.0)
                    provision(client, topics=self.topics)   # idempotent
                    self.sent = client.end_offset(self.topic)
                client.produce(self.topic, None, self.lines[self.sent])
                self.sent += 1
            except BrokerOverload:
                self.overload_retries += 1
                time.sleep(0.05)
            except (BrokerError, OSError):
                # transport fault or the child is restarting: reconnect
                # and resync the resume point from the durable log
                if client is not None:
                    try:
                        client.close()
                    except OSError:
                        pass
                client = None
                self.reconnects += 1
                time.sleep(0.2)
        if client is not None:
            try:
                client.close()
            except OSError:
                pass


def _await_standby(ckpt_dir: str, sup, deadline: float) -> None:
    """Hold a drill's input until the hot standby's first heartbeat: the
    supervisor promotes only a standby that is up, and a leader killed
    before then is restarted cold, which is the default scenario's path,
    not a failover. (A host-engine leader reaches a short drill's kill
    point within half a second of its start.)"""
    _await_heartbeats([os.path.join(ckpt_dir, "standby.health")], [sup],
                      deadline)


def _await_heartbeats(paths: List[str], sups: list,
                      deadline: float) -> None:
    """Wait until every heartbeat file in `paths` exists, a supervisor
    has exited, or the deadline passes."""
    while not all(os.path.exists(p) for p in paths) \
            and all(s.poll() is None for s in sups) \
            and time.time() < deadline:
        time.sleep(0.05)


def read_matchout_records(log_dir: str, topic: str = TOPIC_OUT) -> list:
    """Post-mortem read of a durable topic log (the broker persists
    topics as JSONL under the checkpoint dir) as Records — produce
    stamps included."""
    from kme_tpu_torch.bridge.broker import BrokerError, InProcessBroker

    broker = InProcessBroker(persist_dir=log_dir)
    out: list = []
    try:
        while True:
            recs = broker.fetch(topic, len(out), 4096, timeout=0.0)
            if not recs:
                return out
            out.extend(recs)
    except BrokerError:
        return out          # topic never created (nothing got through)
    finally:
        if hasattr(broker, "close"):
            broker.close()


def read_matchout(log_dir: str) -> List[str]:
    return [f"{r.key} {r.value}" for r in read_matchout_records(log_dir)]


def verify_failover(recs: list, per_msg: List[List[str]],
                    max_epoch_floor: int = 2) -> Tuple[bool, dict]:
    """The exactly-once failover contract over the durable MatchOut
    records: after consumer-side dedup (bridge/consume.DedupRing) the
    visible stream must be BYTE-EXACT equal to the flat oracle stream —
    zero duplicates, zero gaps, zero reordering — and the log must show
    at least two leader epochs (the promotion really happened). The
    broker already suppresses replayed stamps at produce time, so the
    raw log itself should carry no duplicate stamps either; any the
    ring finds are counted and failed on."""
    from kme_tpu_torch.bridge.consume import DedupRing

    ring = DedupRing()
    visible = [f"{r.key} {r.value}" for r in recs
               if not ring.is_dup(r.epoch, r.out_seq)]
    flat = [ln for g in per_msg for ln in g]
    epochs = sorted({r.epoch for r in recs if r.epoch is not None})
    detail = {"got_lines": len(visible),
              "expected_lines": len(flat),
              "messages": len(per_msg),
              "duplicates_in_log": ring.suppressed,
              "unstamped_records": sum(1 for r in recs
                                       if r.epoch is None),
              "epochs": epochs}
    ok = True
    if ring.suppressed:
        detail["error"] = (f"{ring.suppressed} duplicate produce "
                           f"stamp(s) reached the durable log")
        ok = False
    elif visible != flat:
        n = min(len(visible), len(flat))
        div = next((k for k in range(n) if visible[k] != flat[k]), n)
        detail["error"] = (f"deduped stream diverges from the oracle "
                           f"at line {div} (got {len(visible)} lines, "
                           f"want {len(flat)})")
        ok = False
    elif not epochs or epochs[-1] < max_epoch_floor:
        detail["error"] = (f"no promoted epoch in the log (epochs "
                           f"{epochs}); failover never happened")
        ok = False
    return ok, detail


def _check_failover(ckpt_dir: str, log_dir: str, recoveries: list,
                    max_failover: float, failures: List[str]) -> dict:
    """Failover-scenario assertions beyond stream byte-exactness:
    bounded promotion, broker-side dedup actually observed, and a
    stale-epoch produce fenced post-mortem. Appends human-readable
    reasons to `failures`; returns the report sub-dict."""
    out: dict = {}
    promoted = [r for r in recoveries if r.get("promoted")]
    fo = [r["failover_seconds"] for r in promoted
          if r.get("failover_seconds") is not None]
    out["promotions"] = len(promoted)
    out["failover_seconds"] = fo
    if not promoted:
        failures.append("no hot-standby promotion recorded by the "
                        "supervisor")
    elif fo and max(fo) > max_failover:
        failures.append(f"failover took {max(fo):.2f}s "
                        f"(bound {max_failover}s)")

    # the promoted leader's final heartbeat carries the broker-side
    # exactly-once counters: the replayed overlap MUST have been
    # suppressed by the idempotent-produce watermark, otherwise the
    # byte-exact stream above proved nothing about dedup
    dup = fenced = None
    try:
        with open(os.path.join(ckpt_dir, "serve.health")) as f:
            gauges = json.load(f).get("metrics", {}).get("gauges", {})
        dup = gauges.get("dup_suppressed_total")
        fenced = gauges.get("fenced_produces_total")
        out["leader_epoch"] = gauges.get("leader_epoch")
    except (OSError, ValueError):
        pass
    out["dup_suppressed_total"] = dup
    out["fenced_produces_total"] = fenced
    if not dup:
        failures.append("dup_suppressed_total == 0: the promoted "
                        "leader's replayed overlap never exercised "
                        "broker-side dedup")

    # stale-epoch probe: reload the durable logs the way a recovered
    # broker would and produce with epoch 1 — the fence recovered from
    # the log's stamps must reject it BEFORE anything is appended
    from kme_tpu_torch.bridge.broker import BrokerFenced, InProcessBroker

    probe = InProcessBroker(persist_dir=log_dir)
    try:
        try:
            probe.produce(TOPIC_OUT, "OUT", "stale-epoch-probe",
                          epoch=1, out_seq=10 ** 9)
            out["stale_epoch_fenced"] = False
            failures.append("a stale-epoch (zombie leader) produce was "
                            "NOT fenced post-mortem")
        except BrokerFenced:
            out["stale_epoch_fenced"] = True
    finally:
        if hasattr(probe, "close"):
            probe.close()
    return out


def _timeline_section(run_dir: str, tail: int = 12) -> dict:
    """Merge the run's control-plane event logs into the report: the
    causally ordered timeline of what the cluster DECIDED (spawns,
    crash fingerprints, promotions, lease grants, overload
    transitions) during the drill. Also writes the merged
    ``events.jsonl`` artifact next to the per-process logs so
    ``kme-torch-events <run_dir>`` and CI artifact uploads find one file."""
    from kme_tpu_torch.telemetry import events as cpevents

    try:
        timeline = cpevents.merge_logs([run_dir])
    except OSError:
        return {"count": 0, "digest": None, "tail": []}
    merged_path = os.path.join(run_dir, "events.jsonl")
    try:
        cpevents.write_merged(timeline, merged_path)
    except OSError:
        merged_path = None
    return {"count": len(timeline),
            "digest": cpevents.timeline_digest(timeline),
            "merged_path": merged_path,
            "tail": [cpevents.format_event(ev)
                     for ev in timeline[-tail:]]}


def _busy_rate(samples: List[Tuple[float, int]],
               t_lo: float, t_hi: float) -> Optional[float]:
    """Offset-advance rate (msgs/s) of a heartbeat sample series inside
    [t_lo, t_hi], restricted to the series' BUSY interval (before the
    offset reached its final value — a group that already drained its
    substream cannot be slowed down by anything). None = the window
    holds no measurable busy samples."""
    if len(samples) < 2:
        return None
    final = samples[-1][1]
    busy_end = next((t for t, off in samples if off >= final),
                    samples[-1][0])
    lo, hi = max(t_lo, samples[0][0]), min(t_hi, busy_end)
    win = [(t, off) for t, off in samples if lo <= t <= hi]
    if len(win) < 2 or win[-1][0] <= win[0][0]:
        return None
    return (win[-1][1] - win[0][1]) / (win[-1][0] - win[0][0])


def run_shard_failover(args, run_dir: str, report_path: str) -> int:
    """--scenario shard-failover: the multi-leader drill. N
    shard groups (bridge/front.py split, per-group namespaced topics,
    per-group supervisors) serve concurrently; the busiest group's
    leader runs with a hot standby and eats ONE seeded SIGKILL
    mid-substream. Passes iff:

    - the victim's standby promoted within --max-failover seconds;
    - every SURVIVING group kept serving: zero restarts, clean exit,
      and its busy-window throughput during the victim's outage dipped
      < 10% vs its own full-run rate (measured from 10 Hz heartbeat
      offset samples; a survivor that had already drained is exempt —
      nothing was left to slow down);
    - the merged MatchOut (all groups' durable MatchOut.gK + Xfer.gK
      logs, consumer-deduped, re-zipped on the shared out_seq cursor)
      is BYTE-EXACT vs the partitioned single-leader oracle
      (front.verify_groups — the COMPAT.md convention);
    - ZERO duplicate (epoch, out_seq) stamps in ANY durable log: the
      victim's replayed overlap (MatchOut and regenerated transfer
      legs alike) must have been suppressed by the idempotent-produce
      watermark, never appended twice;
    - a stale-epoch produce against the victim's MatchOut is fenced
      post-mortem (no zombie leader can dirty the healed log).
    """
    from kme_tpu_torch.bridge import front
    from kme_tpu_torch.bridge.broker import BrokerFenced, InProcessBroker
    from kme_tpu_torch.bridge.consume import DedupRing
    from kme_tpu_torch.bridge.provision import group_topics
    from kme_tpu_torch.wire import dumps_order
    from kme_tpu_torch.workload import cross_account_stream

    groups = args.groups
    # every group must carry real flow for the drill to mean anything:
    # with few symbols the zipf head lands in one group and the others
    # drain before the kill, leaving the dip check nothing to measure —
    # a wide symbol universe balances the rendezvous placement
    symbols = max(args.symbols, 64 * groups)
    accounts = max(args.accounts, 8 * groups)
    msgs = cross_account_stream(args.events, symbols, accounts, groups,
                                seed=args.seed,
                                cross_frac=args.cross_frac)
    lines = [dumps_order(m) for m in msgs]
    per_group, router = front.split_lines(lines, groups,
                                          prefund=args.prefund)
    # durable copy of the front's input stream: kme-torch-trace --cluster
    # stitches this run dir post-mortem (dtrace.stitch_state_root
    # re-runs the deterministic split over front.in to rebuild the
    # global-offset -> (group, local index) map)
    with open(os.path.join(run_dir, "front.in"), "w") as f:
        f.write("\n".join(lines) + "\n")
    sizes = [len(s) for s in per_group]
    if min(sizes) == 0:
        print(f"kme-torch-chaos: substream sizes {sizes} — empty group; "
              f"raise --symbols", file=sys.stderr)
        return 2
    victim = max(range(groups), key=lambda k: sizes[k])
    # land the kill while EVERY group is still mid-substream (the
    # groups drain concurrently at similar rates, so half the smallest
    # substream is mid-flight for all of them) — otherwise the
    # survivors are already idle and the dip check has nothing to
    # measure
    kill_at = max(1, min(sizes) // 2)
    schedule = f"seed={args.seed};serve.kill:at={kill_at}"
    print(f"kme-torch-chaos: scenario=shard-failover seed={args.seed} "
          f"groups={groups} substreams={sizes} victim=g{victim} "
          f"kill_at={kill_at}\nkme-torch-chaos: run dir {run_dir}",
          file=sys.stderr)

    sups, producers, gdirs = [], [], []
    t0 = time.time()
    for k in range(groups):
        gdir = os.path.join(run_dir, f"group{k}")
        ckpt = os.path.join(gdir, "state")
        os.makedirs(ckpt, exist_ok=True)
        gdirs.append(gdir)
        port = _free_port()
        serve_args = ["--engine", args.engine, "--device", args.device,
                      "--compat", "fixed",
                      "--batch", str(args.batch),
                      "--slots", str(args.slots),
                      "--max-fills", str(args.max_fills),
                      "--checkpoint-every", str(args.checkpoint_every),
                      "--checkpoint-keep", str(args.checkpoint_keep),
                      "--group", f"{k}/{groups}",
                      "--listen", f"127.0.0.1:{port}",
                      "--idle-exit", str(args.idle_exit),
                      "--health-every", "0.1",
                      # per-group latency journal + span tracing: the
                      # post-mortem stitches every admitted order into
                      # a cluster waterfall (journal resume=True, so a
                      # restarted leader appends after the kill)
                      "--journal-out",
                      os.path.join(ckpt, "journal.bin"),
                      "--trace-spans"]
        if args.engine == "seq":
            # pipelined submit/collect arms the async dispatch + H2D
            # double-buffer path inside each group's leader, so
            # the failover drill exercises promotion/replay against
            # in-flight device work rather than the serial loop
            serve_args += ["--pipeline", "1"]
        sup_cmd = [sys.executable, "-m", "kme_tpu_torch.cli", "supervise",
                   "--checkpoint-dir", ckpt,
                   "--stale-after", str(args.stale_after),
                   "--stall-after", str(args.stall_after),
                   "--max-restarts", str(args.max_restarts),
                   "--grace", str(args.grace),
                   "--backoff-base", "0.05", "--backoff-cap", "0.5"]
        if k == victim:
            sup_cmd += ["--standby", "--poll", "0.1"]
        sup_cmd += ["--"] + serve_args
        env = dict(os.environ)
        env.pop("KME_FAULTS", None)       # survivors run fault-free
        env.pop("KME_FAULTS_STATE", None)
        if k == victim:
            env["KME_FAULTS"] = schedule
            env["KME_FAULTS_STATE"] = os.path.join(gdir, "fault-state")
        sups.append(subprocess.Popen(sup_cmd, env=env))
        producers.append(_Producer("127.0.0.1", port, per_group[k],
                                   topic=group_topics(k)[0],
                                   topics=group_topics(k)))
    # hold every group's input until all leaders and the victim's standby
    # are up: a card child takes seconds to start, and a survivor whose
    # input began after the kill (or that had not started by then) shows
    # no rate during the outage, so the dip check would measure nothing
    _await_heartbeats(
        [os.path.join(g, "state", "serve.health") for g in gdirs]
        + [os.path.join(gdirs[victim], "state", "standby.health")],
        sups, t0 + args.timeout)
    for prod in producers:
        prod.start()

    # 10 Hz heartbeat sampling: (wall time, input offset) per group —
    # the survivors' liveness evidence during the victim's outage
    samples: dict = {k: [] for k in range(groups)}
    stop = threading.Event()

    def monitor() -> None:
        while not stop.wait(0.1):
            for k in range(groups):
                try:
                    with open(os.path.join(gdirs[k], "state",
                                           "serve.health")) as f:
                        hb = json.load(f)
                    samples[k].append((time.time(),
                                       int(hb.get("offset", 0))))
                except (OSError, ValueError, TypeError):
                    pass

    mon = threading.Thread(target=monitor, daemon=True)
    mon.start()

    rcs: List[Optional[int]] = [None] * groups
    deadline = t0 + args.timeout
    while time.time() < deadline:
        rcs = [s.poll() for s in sups]
        if all(rc is not None for rc in rcs):
            break
        time.sleep(0.25)
    for s in sups:
        if s.poll() is None:
            print("kme-torch-chaos: TIMEOUT; killing a supervisor",
                  file=sys.stderr)
            s.kill()
            s.wait()
    rcs = [s.returncode for s in sups]
    stop.set()
    mon.join(timeout=2.0)
    for prod in producers:
        prod.stop.set()
        prod.join(timeout=10.0)
    elapsed = time.time() - t0

    failures: List[str] = []
    for k in range(groups):
        if rcs[k] != 0:
            failures.append(f"group {k} supervisor exited rc={rcs[k]}")
        if producers[k].sent < sizes[k]:
            failures.append(f"group {k} producer delivered "
                            f"{producers[k].sent} of {sizes[k]}")

    # victim: promotion happened, and within the bound
    sup_states = []
    for k in range(groups):
        st = {}
        try:
            with open(os.path.join(gdirs[k], "state",
                                   "supervisor.json")) as f:
                st = json.load(f)
        except (OSError, ValueError):
            pass
        sup_states.append(st)
    promoted = [r for r in sup_states[victim].get("recoveries", [])
                if r.get("promoted")]
    fo = [r["failover_seconds"] for r in promoted
          if r.get("failover_seconds") is not None]
    if not promoted:
        failures.append("victim group never promoted its standby")
    elif fo and max(fo) > args.max_failover:
        failures.append(f"failover took {max(fo):.2f}s "
                        f"(bound {args.max_failover}s)")

    # survivors: no restarts, and the throughput dip during the
    # victim's outage window stays under 10%
    outage = None
    if promoted and promoted[0].get("detected_at") is not None:
        det = float(promoted[0]["detected_at"])
        outage = (det, det + float(promoted[0].get("recovered_in", 0)))
    dips: dict = {}
    rates: dict = {}
    for k in range(groups):
        if k == victim:
            continue
        restarts = int(sup_states[k].get("restarts_total", 0))
        if restarts:
            failures.append(f"surviving group {k} restarted "
                            f"{restarts}x during the drill")
        full = _busy_rate(samples[k], 0.0, float("inf"))
        win = (_busy_rate(samples[k], *outage)
               if outage is not None else None)
        rates[f"g{k}"] = {"full": full, "outage": win}
        if full and win is not None:
            dip = max(0.0, 1.0 - win / full)
            dips[f"g{k}"] = round(dip, 4)
            if dip >= 0.10:
                failures.append(f"surviving group {k} throughput "
                                f"dipped {dip:.0%} during failover "
                                f"(bound 10%)")
        else:
            # drained before the outage (or the window was too short
            # to hold two 10 Hz samples): nothing left to slow down
            dips[f"g{k}"] = None

    # durable logs: dedup per topic (ZERO duplicate stamps anywhere),
    # then re-zip each group's MatchOut + Xfer on the shared out_seq
    # cursor and verify the merged stream against the oracle
    dup_stamps: dict = {}
    actual: List[List[str]] = []
    for k in range(groups):
        log_dir = os.path.join(gdirs[k], "state", "broker-log")
        merged = []
        for topic in (group_topics(k)[1], group_topics(k)[2]):
            recs = read_matchout_records(log_dir, topic=topic)
            ring = DedupRing()
            keep = [r for r in recs if not ring.is_dup(r.epoch,
                                                       r.out_seq)]
            dup_stamps[topic] = ring.suppressed
            if ring.suppressed:
                failures.append(f"{ring.suppressed} duplicate "
                                f"(epoch,out_seq) stamp(s) in the "
                                f"durable {topic} log")
            merged.extend(keep)
        merged.sort(key=lambda r: (r.out_seq
                                   if r.out_seq is not None else -1))
        actual.append([f"{r.key} {r.value}" for r in merged])
    verify = front.verify_groups(lines, actual, compat="fixed",
                                 book_slots=args.slots,
                                 max_fills=args.max_fills,
                                 prefund=args.prefund)
    if not verify["ok"]:
        failures.append(f"merged stream diverged from the single-"
                        f"leader oracle: {verify['mismatches'][:1]}")

    # trace integrity post-mortem: the per-group span journals must
    # stitch into exactly one complete waterfall per admitted order.
    # The victim's replayed overlap dedups away by the durable
    # (group, local_off, kind) key — first occurrence wins, mirroring
    # the broker's (epoch, out_seq) dedup — and the standby promotion
    # shows as a span GAP inside one waterfall, never a forked second
    # trace for the same order.
    from kme_tpu_torch.telemetry import dtrace
    from kme_tpu_torch.telemetry.journal import read_events
    trace_post: dict = {}
    try:
        tdoc = dtrace.stitch_state_root(run_dir,
                                        prefund=args.prefund)
        frac = (tdoc["stitched"] / tdoc["admitted"]
                if tdoc["admitted"] else 0.0)
        offs = [o["off"] for o in tdoc["orders"]]
        forked = len(offs) - len(set(offs))
        # raw replay overlap in the victim's journal (pre-dedup):
        # span records the restarted leader re-journaled for offsets
        # the dead leader had already covered
        replay_dups = 0
        jp = dtrace._find_journal(gdirs[victim])
        if jp is not None:
            seen = set()
            for ev in read_events(jp):
                if ev.get("e") == "span":
                    key = (ev.get("off"), ev.get("kind"))
                    if key in seen:
                        replay_dups += 1
                    else:
                        seen.add(key)
        trace_post = {"admitted": tdoc["admitted"],
                      "stitched": tdoc["stitched"],
                      "stitched_frac": round(frac, 5),
                      "forked_waterfalls": forked,
                      "victim_replayed_spans_deduped": replay_dups}
        if tdoc["admitted"] == 0:
            failures.append("tracing: stitched trace admitted zero "
                            "orders")
        elif frac < 0.999:
            failures.append(f"tracing: only {frac:.2%} of admitted "
                            f"orders stitched into complete cluster "
                            f"waterfalls (bound 99.9%)")
        if forked:
            failures.append(f"tracing: {forked} order(s) forked a "
                            f"second waterfall across the failover")
    except (OSError, ValueError) as e:
        trace_post = {"error": str(e)}
        failures.append(f"tracing: post-mortem stitch failed: {e}")

    # zombie fence: a stale-epoch produce against the victim's healed
    # MatchOut log must be rejected before anything is appended
    probe = InProcessBroker(persist_dir=os.path.join(
        gdirs[victim], "state", "broker-log"))
    stale_fenced = False
    try:
        try:
            probe.produce(group_topics(victim)[1], "OUT",
                          "stale-epoch-probe", epoch=1, out_seq=10 ** 9)
            failures.append("a stale-epoch produce against the "
                            "victim's MatchOut was NOT fenced")
        except BrokerFenced:
            stale_fenced = True
    finally:
        if hasattr(probe, "close"):
            probe.close()

    report = {
        "ok": not failures,
        "failures": failures,
        "scenario": "shard-failover",
        "seed": args.seed,
        "events": len(msgs),
        "groups": groups,
        "victim": victim,
        "substreams": sizes,
        "schedule": schedule,
        "elapsed_seconds": round(elapsed, 3),
        "promotions": len(promoted),
        "failover_seconds": fo,
        "survivor_dips": dips,
        "survivor_rates": rates,
        "outage_window_s": (round(outage[1] - outage[0], 3)
                            if outage else None),
        "duplicate_stamps": dup_stamps,
        "cross_shard_transfers":
            router.counters["cross_shard_transfers_total"],
        "trace": trace_post,
        "stale_epoch_fenced": stale_fenced,
        "verify": dict(verify,
                       mismatches=verify.get("mismatches", [])[:3]),
        "supervisors": sup_states,
        "timeline": _timeline_section(run_dir),
        "run_dir": run_dir,
    }
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    status = "OK" if report["ok"] else "FAILED"
    print(f"kme-torch-chaos: {status} — shard-failover groups={groups} "
          f"victim=g{victim} promotions={len(promoted)} "
          f"failover_seconds={fo} dips={dips} "
          f"dup_stamps={sum(dup_stamps.values())} "
          f"waterfalls={trace_post.get('stitched')}/"
          f"{trace_post.get('admitted')} "
          f"stale_epoch_fenced={stale_fenced} parity="
          f"{'byte-exact' if verify['ok'] else 'DIVERGED'} "
          f"elapsed={elapsed:.1f}s", file=sys.stderr)
    for fail in failures:
        print(f"kme-torch-chaos: FAIL: {fail}", file=sys.stderr)
    print(f"kme-torch-chaos: report written to {report_path}",
          file=sys.stderr)
    return 0 if report["ok"] else 1


def run_feed_failover(args, run_dir: str, report_path: str) -> int:
    """--scenario feed-failover: the market-data read path under the
    write path's failover. A supervised kme-torch-serve runs with
    a hot standby and eats ONE seeded SIGKILL mid-stream while a real
    kme-torch-feed fan-out tier (FeedServer over a TcpBroker, reconnect
    armed) serves LIVE subscribers — one wildcard auditor plus filtered
    single/multi-symbol subs. Passes iff:

    - the standby promoted (and within --max-failover seconds);
    - the feed tier actually rode through the outage: at least one
      broker reconnect fired, and the feed consumed the full durable
      MatchOut log;
    - every subscriber's reconstructed book is BYTE-EXACT
      (canonical_books) against an in-process oracle replay of the
      input, restricted to its subscription — the deriver on the
      promoted leader's replayed tail regenerated the exact frames the
      dead one would have sent;
    - ZERO missing and ZERO duplicate per-symbol delta seqs on every
      subscriber (BookBuilder gap/dup accounting), across the kill,
      the reconnect and any conflation/resync cycles.
    """
    from kme_tpu_torch.bridge.tcp import TcpBroker
    from kme_tpu_torch.feed.client import FeedClient
    from kme_tpu_torch.feed.derive import books_from_oracle, canonical_books
    from kme_tpu_torch.feed.server import FeedServer
    from kme_tpu_torch.oracle import OracleEngine
    from kme_tpu_torch.telemetry import Registry
    from kme_tpu_torch.wire import dumps_order, parse_order
    from kme_tpu_torch.workload import harness_stream

    ckpt_dir = os.path.join(run_dir, "state")
    state_dir = os.path.join(run_dir, "fault-state")
    os.makedirs(ckpt_dir, exist_ok=True)
    schedule = args.schedule or failover_schedule(args.seed, args.events)
    print(f"kme-torch-chaos: scenario=feed-failover seed={args.seed} "
          f"events={args.events}\nkme-torch-chaos: schedule {schedule}\n"
          f"kme-torch-chaos: run dir {run_dir}", file=sys.stderr)

    # ground truth: oracle replay of the input under the same envelope
    # the serve runs with; the final resting-order store is what every
    # subscriber book must reduce to
    msgs = harness_stream(args.events, seed=args.seed,
                          num_accounts=args.accounts,
                          num_symbols=max(args.symbols, 6),
                          payout_opcode_bug=False, validate=True)
    lines = [dumps_order(m) for m in msgs]
    eng = OracleEngine("fixed", book_slots=args.slots,
                       max_fills=args.max_fills)
    for ln in lines:
        eng.process(parse_order(ln))
    oracle_levels = books_from_oracle(eng)
    book_sids = sorted({sid for sid, _ in oracle_levels}) or [1]

    # the supervised write path, hot standby armed, one seeded SIGKILL
    port = _free_port()
    serve_args = ["--engine", args.engine, "--device", args.device,
                  "--compat", "fixed",
                  "--batch", str(args.batch),
                  "--slots", str(args.slots),
                  "--max-fills", str(args.max_fills),
                  "--checkpoint-every", str(args.checkpoint_every),
                  "--checkpoint-keep", str(args.checkpoint_keep),
                  "--listen", f"127.0.0.1:{port}",
                  "--idle-exit", str(args.idle_exit),
                  "--health-every", "0.2"]
    sup_cmd = [sys.executable, "-m", "kme_tpu_torch.cli", "supervise",
               "--checkpoint-dir", ckpt_dir,
               "--stale-after", str(args.stale_after),
               "--stall-after", str(args.stall_after),
               "--max-restarts", str(args.max_restarts),
               "--grace", str(args.grace),
               "--backoff-base", "0.05", "--backoff-cap", "0.5",
               "--standby", "--poll", "0.1", "--"] + serve_args
    env = dict(os.environ)
    env["KME_FAULTS"] = schedule
    env["KME_FAULTS_STATE"] = state_dir
    t0 = time.time()
    sup = subprocess.Popen(sup_cmd, env=env)

    # the feed tier: reconnect armed (and counted — the drill requires
    # the outage to have actually hit the read path)
    reconnects = [0]

    def _factory():
        reconnects[0] += 1
        return TcpBroker("127.0.0.1", port, timeout=5.0)

    # the supervised serve is still booting: retry the initial connect
    boot_deadline = time.time() + 30.0
    while True:
        try:
            broker0 = TcpBroker("127.0.0.1", port, timeout=5.0)
            break
        except OSError:
            if time.time() > boot_deadline:
                raise
            time.sleep(0.2)
    registry = Registry()
    feed = FeedServer(broker0, port=0, topic=TOPIC_OUT,
                      depth_every=64, registry=registry,
                      reconnect=_factory)
    stop_ev = threading.Event()
    feed_thread = threading.Thread(target=feed.serve_forever,
                                   args=(stop_ev,), daemon=True)
    feed_thread.start()

    # live subscribers, connected BEFORE the stream flows: a wildcard
    # auditor, a single-symbol sub and a two-symbol sub
    fh, fp = feed.address
    sub_plans = [None, {book_sids[0]},
                 set(book_sids[:2]) if len(book_sids) > 1
                 else {book_sids[0]}]
    clients = [FeedClient(fh, fp, symbols=plan, timeout=1.0)
               for plan in sub_plans]
    done_ev = threading.Event()

    def _drain(c: FeedClient) -> None:
        while not done_ev.is_set():
            got = sum(1 for _ in c.recv_frames())
            if got == 0 and done_ev.is_set():
                return

    client_threads = [threading.Thread(target=_drain, args=(c,),
                                       daemon=True) for c in clients]
    for th in client_threads:
        th.start()

    _await_standby(ckpt_dir, sup, t0 + args.timeout)
    producer = _Producer("127.0.0.1", port, lines)
    producer.start()

    sup_rc: Optional[int] = None
    deadline = t0 + args.timeout
    while time.time() < deadline:
        sup_rc = sup.poll()
        if sup_rc is not None:
            break
        time.sleep(0.25)
    if sup_rc is None:
        print(f"kme-torch-chaos: TIMEOUT after {args.timeout}s; killing the "
              f"supervisor", file=sys.stderr)
        sup.kill()
        sup.wait()
        sup_rc = sup.returncode
    producer.stop.set()
    producer.join(timeout=10.0)
    elapsed = time.time() - t0

    # the write path is gone; the feed must already hold the whole log
    log_dir = os.path.join(ckpt_dir, "broker-log")
    recs = read_matchout_records(log_dir)
    caught_up = feed.offset >= len(recs)
    lag = registry.latency("feed_lag").quantiles()
    # stop() first: the feed is likely spinning in its reconnect loop
    # now that the write path is gone, and only _stop breaks that
    feed.stop()
    stop_ev.set()
    feed_thread.join(timeout=10.0)
    feed.drain(timeout=10.0)
    stats = feed.stats()
    feed.close()                      # EOF to every subscriber
    done_ev.set()
    for th in client_threads:
        th.join(timeout=10.0)
    for c in clients:
        c.close()

    sup_state = {}
    try:
        with open(os.path.join(ckpt_dir, "supervisor.json")) as f:
            sup_state = json.load(f)
    except (OSError, ValueError):
        pass
    recoveries = sup_state.get("recoveries", [])
    promoted = [r for r in recoveries if r.get("promoted")]
    fo = [r["failover_seconds"] for r in promoted
          if r.get("failover_seconds") is not None]

    failures: List[str] = []
    if sup_rc != 0:
        failures.append(f"supervisor exited rc={sup_rc}")
    if producer.sent < len(lines):
        failures.append(f"producer only delivered {producer.sent} of "
                        f"{len(lines)} records")
    if not promoted:
        failures.append("the standby never promoted")
    elif fo and max(fo) > args.max_failover:
        failures.append(f"failover took {max(fo):.2f}s "
                        f"(bound {args.max_failover}s)")
    if reconnects[0] < 1:
        failures.append("the feed tier never reconnected — the kill "
                        "missed the read path, the drill proves "
                        "nothing")
    if not caught_up:
        failures.append(f"feed consumed {feed.offset} of {len(recs)} "
                        f"durable MatchOut records before the write "
                        f"path exited")
    sub_reports = []
    for ci, c in enumerate(clients):
        bb = c.builder
        want = (oracle_levels if c.symbols is None
                else {k: v for k, v in oracle_levels.items()
                      if k[0] in c.symbols})
        exact = canonical_books(bb.book) == canonical_books(want)
        sub_reports.append({
            "symbols": (sorted(c.symbols)
                        if c.symbols is not None else None),
            "frames": bb.frames, "gaps": len(bb.gaps),
            "dups": bb.dups, "resyncs": bb.resyncs,
            "byte_exact": exact,
        })
        tag = f"subscriber {ci} (symbols={sub_reports[-1]['symbols']})"
        if bb.errors:
            failures.append(f"{tag}: {bb.errors[:2]}")
        if bb.gaps:
            failures.append(f"{tag}: {len(bb.gaps)} missing delta "
                            f"seq range(s), e.g. {bb.gaps[:2]}")
        if bb.dups:
            failures.append(f"{tag}: {bb.dups} duplicate seq(s)")
        if not exact:
            failures.append(f"{tag}: book diverged from the oracle "
                            f"replay post-promotion")

    report = {
        "ok": not failures,
        "failures": failures,
        "scenario": "feed-failover",
        "seed": args.seed,
        "events": args.events,
        "schedule": schedule,
        "elapsed_seconds": round(elapsed, 3),
        "promotions": len(promoted),
        "failover_seconds": fo,
        "feed_reconnects": reconnects[0],
        "feed": stats,
        "feed_lag_p99_ms": round(lag[0.99] * 1e3, 3),
        "subscribers": sub_reports,
        "supervisor": sup_state,
        "fault_fires": _fault_fires(state_dir),
        "timeline": _timeline_section(run_dir),
        "run_dir": run_dir,
    }
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    status = "OK" if report["ok"] else "FAILED"
    print(f"kme-torch-chaos: {status} — feed-failover: promotions="
          f"{len(promoted)} failover_seconds={fo} "
          f"feed_reconnects={reconnects[0]} "
          f"frames={stats['frames']} dup_suppressed="
          f"{stats['dup_suppressed']} books="
          f"{sum(1 for s in sub_reports if s['byte_exact'])}/"
          f"{len(sub_reports)} byte-exact, gaps="
          f"{sum(s['gaps'] for s in sub_reports)}, dups="
          f"{sum(s['dups'] for s in sub_reports)}, "
          f"elapsed={elapsed:.1f}s", file=sys.stderr)
    for fail in failures:
        print(f"kme-torch-chaos: FAIL: {fail}", file=sys.stderr)
    print(f"kme-torch-chaos: report written to {report_path}",
          file=sys.stderr)
    return 0 if report["ok"] else 1


def run_reshard_storm(args, run_dir: str, report_path: str) -> int:
    """--scenario reshard-under-storm: the live N→M topology drill. A
    funded flash-crowd workload is split across N shard groups; at a
    batch barrier mid-stream the old generation
    drains and the reshard coordinator (bridge/reshard.py) fences the
    old epochs durably, migrates book/position state through the
    checkpoint codec and settles consolidated balances with stamped
    transfer legs — eating one REAL mid-settle SIGKILL and re-running
    to the identical end state — then an M-group new generation resumes
    the suffix over the multi-host front links (front.FrontLinks, real
    TCP, reconnect-with-resume off the out_seq cursor). Passes iff:

    - BYTE PARITY across both generations: each group's deduped durable
      MatchOut + Xfer merge equals the single-leader oracle partitioned
      by the pre/post topologies (front.verify_groups_reshard — the
      resharding-is-pure-topology contract);
    - ZERO duplicate (epoch, out_seq) stamps in ANY durable log of
      either generation, MatchIn included: the crashed coordinator's
      replayed legs and the front's reconnect re-sends must have been
      watermark-suppressed, never appended twice;
    - the settlement survived the crash EXACTLY ONCE: every journaled
      leg appears exactly once in its group's durable MatchIn, the
      re-run visibly suppressed the pre-crash copies, and every new
      group's final pending_reserve checkpoint ledger counts exactly
      coordinator legs + front reserve legs with zero rejects;
    - every old group's log is DURABLY re-fenced (probe_fenced: a
      stale-epoch produce raises BrokerFenced even on a fresh reload);
    - bounded dip: the migration pause (old-generation drain → first
      new-generation progress) stays under --reshard-pause seconds and
      the new generation's final lat_e2e p99 under --reshard-p99-ms
      (the settlement legs are admitted while no leader is up, so that
      histogram deliberately swallows the migration gap).
    """
    import collections
    import signal as _signal

    from kme_tpu_torch import opcodes as op
    from kme_tpu_torch.bridge import front
    from kme_tpu_torch.bridge import reshard as reshard_mod
    from kme_tpu_torch.bridge.broker import BrokerError
    from kme_tpu_torch.bridge.consume import DedupRing
    from kme_tpu_torch.bridge.provision import group_topics, provision
    from kme_tpu_torch.bridge.tcp import TcpBroker
    from kme_tpu_torch.runtime import checkpoint as ck
    from kme_tpu_torch.wire import dumps_order, parse_order
    from kme_tpu_torch.workload import cross_account_stream

    n, m = args.groups, args.groups_to
    engine = args.engine
    if engine != "oracle":
        print(f"kme-torch-chaos: reshard surgery runs on oracle snapshots; "
              f"overriding --engine {engine} -> oracle", file=sys.stderr)
        engine = "oracle"
    # wide universes keep every group busy under BOTH topologies (the
    # shard-failover sizing rule, applied to max(n, m))
    symbols = max(args.symbols, 64 * max(n, m))
    accounts = max(args.accounts, 8 * max(n, m))
    msgs = cross_account_stream(args.events, symbols, accounts, n,
                                seed=args.seed,
                                cross_frac=args.cross_frac)
    lines = [dumps_order(mm) for mm in msgs]
    split_at = len(lines) // 2
    pre_sub, router = front.split_lines(lines[:split_at], n,
                                        prefund=args.prefund)
    reshard_info = router.reshard(m)
    post_sub: List[List[str]] = [[] for _ in range(m)]
    for ln in lines[split_at:]:
        for g, l2 in router.route_line(ln):
            post_sub[g].append(l2)
    sizes_pre = [len(s) for s in pre_sub]
    sizes_post = [len(s) for s in post_sub]
    if min(sizes_pre) == 0 or min(sizes_post) == 0:
        print(f"kme-torch-chaos: substreams pre={sizes_pre} "
              f"post={sizes_post} — empty group; raise --symbols",
              file=sys.stderr)
        return 2
    old_root = os.path.join(run_dir, "r0")
    new_root = os.path.join(run_dir, "r1")
    print(f"kme-torch-chaos: scenario=reshard-under-storm seed={args.seed} "
          f"{n}->{m} groups split_at={split_at} pre={sizes_pre} "
          f"post={sizes_post} kill_after_legs={args.reshard_kill_legs}"
          f"\nkme-torch-chaos: run dir {run_dir}", file=sys.stderr)

    def _serve_cmd(gdir: str, k: int, groups: int, port: int) -> list:
        serve_args = ["--engine", engine, "--device", args.device,
                      "--compat", "fixed",
                      "--batch", str(args.batch),
                      "--slots", str(args.slots),
                      "--max-fills", str(args.max_fills),
                      "--checkpoint-every", str(args.checkpoint_every),
                      "--checkpoint-keep", str(args.checkpoint_keep),
                      "--group", f"{k}/{groups}",
                      "--listen", f"127.0.0.1:{port}",
                      "--idle-exit", str(args.idle_exit),
                      "--health-every", "0.1"]
        return [sys.executable, "-m", "kme_tpu_torch.cli", "supervise",
                "--checkpoint-dir", gdir,
                "--stale-after", str(args.stale_after),
                "--stall-after", str(args.stall_after),
                "--max-restarts", str(args.max_restarts),
                "--grace", str(args.grace),
                "--backoff-base", "0.05", "--backoff-cap", "0.5",
                "--"] + serve_args

    env = dict(os.environ)
    env.pop("KME_FAULTS", None)     # the reshard itself is the attack
    env.pop("KME_FAULTS_STATE", None)

    # 10 Hz heartbeat sampling across BOTH generations: (wall time,
    # input offset) — the migration-pause evidence
    samples: dict = {("old", k): [] for k in range(n)}
    samples.update({("new", k): [] for k in range(m)})
    watch = ([("old", k, os.path.join(old_root, f"group{k}"))
              for k in range(n)]
             + [("new", k, os.path.join(new_root, f"group{k}"))
                for k in range(m)])
    stop_mon = threading.Event()

    def monitor() -> None:
        while not stop_mon.wait(0.1):
            for gen, k, gdir in watch:
                try:
                    with open(os.path.join(gdir, "serve.health")) as f:
                        hb = json.load(f)
                    samples[(gen, k)].append((time.time(),
                                              int(hb.get("offset", 0))))
                except (OSError, ValueError, TypeError):
                    pass

    mon = threading.Thread(target=monitor, daemon=True)
    mon.start()

    failures: List[str] = []
    t0 = time.time()

    def _wait_sups(sups: list, deadline: float) -> List[int]:
        while time.time() < deadline:
            if all(s.poll() is not None for s in sups):
                break
            time.sleep(0.25)
        for s in sups:
            if s.poll() is None:
                print("kme-torch-chaos: TIMEOUT; killing a supervisor",
                      file=sys.stderr)
                s.kill()
                s.wait()
        return [s.returncode for s in sups]

    # -- phase A: the old generation serves the prefix, then drains ----
    sups_a, producers = [], []
    for k in range(n):
        gdir = os.path.join(old_root, f"group{k}")
        os.makedirs(gdir, exist_ok=True)
        port = _free_port()
        sups_a.append(subprocess.Popen(_serve_cmd(gdir, k, n, port),
                                       env=env))
        prod = _Producer("127.0.0.1", port, pre_sub[k],
                         topic=group_topics(k)[0],
                         topics=group_topics(k))
        prod.start()
        producers.append(prod)
    rcs_a = _wait_sups(sups_a, t0 + args.timeout)
    for prod in producers:
        prod.stop.set()
        prod.join(timeout=10.0)
    for k in range(n):
        if rcs_a[k] != 0:
            failures.append(f"old group {k} supervisor exited "
                            f"rc={rcs_a[k]}")
        if producers[k].sent < sizes_pre[k]:
            failures.append(f"old group {k} producer delivered "
                            f"{producers[k].sent} of {sizes_pre[k]}")
    t_drain = time.time()

    # -- the coordinator: one run SIGKILLed mid-settle, one to done ----
    coord_cmd = [sys.executable, "-m", "kme_tpu_torch.bridge.reshard",
                 "--old-root", old_root, "--new-root", new_root,
                 "--old-groups", str(n), "--new-groups", str(m)]
    kenv = dict(env)
    kenv["KME_TEST_HOOKS"] = "1"
    t_coord0 = time.time()
    crash = subprocess.run(
        coord_cmd + ["--test-kill-after-legs",
                     str(args.reshard_kill_legs)],
        env=kenv, capture_output=True, text=True)
    if crash.returncode != -_signal.SIGKILL:
        failures.append(f"coordinator mid-settle SIGKILL never fired "
                        f"(rc={crash.returncode}); the crash-recovery "
                        f"leg proved nothing")
    rerun = subprocess.run(coord_cmd, env=env, capture_output=True,
                           text=True)
    t_coord1 = time.time()
    if rerun.returncode != 0:
        failures.append(f"coordinator re-run after the crash exited "
                        f"rc={rerun.returncode}: "
                        f"{rerun.stderr.strip()[-500:]}")
    jdoc: dict = {}
    try:
        with open(os.path.join(new_root, reshard_mod.JOURNAL)) as f:
            jdoc = json.load(f)
    except (OSError, ValueError) as e:
        failures.append(f"no readable reshard journal: {e}")
    legs = jdoc.get("migrate", {}).get("legs", [])
    settle = jdoc.get("settle", {})
    resume_cursors = settle.get("resume_cursors", [0] * m)
    if not jdoc.get("done"):
        failures.append("reshard journal never reached done")
    if jdoc.get("migrate", {}).get("old_offsets") != sizes_pre:
        failures.append(
            f"old generation drained at offsets "
            f"{jdoc.get('migrate', {}).get('old_offsets')} but the "
            f"substreams hold {sizes_pre} — the barrier leaked")
    if crash.returncode == -_signal.SIGKILL \
            and not settle.get("dup_suppressed"):
        failures.append("the settle re-run suppressed zero legs — the "
                        "pre-crash legs were lost, not deduped")

    # -- phase B: the new generation resumes the suffix over TCP ------
    ports_b = [_free_port() for _ in range(m)]
    sups_b = []
    for k in range(m):
        gdir = os.path.join(new_root, f"group{k}")
        os.makedirs(gdir, exist_ok=True)
        sups_b.append(subprocess.Popen(
            _serve_cmd(gdir, k, m, ports_b[k]), env=env))
    t_b = time.time()
    ready_deadline = t_b + args.timeout
    for k in range(m):
        ok = False
        while time.time() < ready_deadline:
            try:
                c = TcpBroker("127.0.0.1", ports_b[k], timeout=5.0)
                provision(c, topics=group_topics(k))   # idempotent
                c.close()
                ok = True
                break
            except (BrokerError, OSError):
                time.sleep(0.2)
        if not ok:
            failures.append(f"new group {k} broker never came up")
    links = front.FrontLinks(
        [f"127.0.0.1:{p}" for p in ports_b],
        cursors=resume_cursors, retries=40, backoff_s=0.1)
    fed = [0] * m
    feed_err: List[str] = []
    stop_feed = threading.Event()

    def feeder() -> None:
        # round-robin across the links so the groups drain
        # concurrently, one stamped produce per sweep per group
        idx = [0] * m
        left = sum(sizes_post)
        while left and not stop_feed.is_set():
            for g in range(m):
                if idx[g] >= len(post_sub[g]):
                    continue
                try:
                    links.send(g, post_sub[g][idx[g]])
                except Exception as e:      # noqa: BLE001 — report all
                    feed_err.append(f"link {g}: {e}")
                    return
                idx[g] += 1
                fed[g] += 1
                left -= 1

    fthread = threading.Thread(target=feeder, daemon=True)
    fthread.start()
    rcs_b = _wait_sups(sups_b, t_b + args.timeout)
    stop_feed.set()
    fthread.join(timeout=10.0)
    link_state = links.snapshot()
    links.close()
    stop_mon.set()
    mon.join(timeout=2.0)
    elapsed = time.time() - t0
    for k in range(m):
        if rcs_b[k] != 0:
            failures.append(f"new group {k} supervisor exited "
                            f"rc={rcs_b[k]}")
        if fed[k] < sizes_post[k]:
            failures.append(f"new group {k} front link delivered "
                            f"{fed[k]} of {sizes_post[k]}")
    failures.extend(feed_err)

    # -- durable logs: zero dup stamps, then byte parity --------------
    dup_stamps: dict = {}

    def _merged_actual(root: str, k: int, gen: str) -> List[str]:
        log_dir = os.path.join(root, f"group{k}", "broker-log")
        merged = []
        for topic in (group_topics(k)[1], group_topics(k)[2]):
            recs = read_matchout_records(log_dir, topic=topic)
            ring = DedupRing()
            keep = [r for r in recs
                    if not ring.is_dup(r.epoch, r.out_seq)]
            dup_stamps[f"{gen}:{topic}"] = ring.suppressed
            if ring.suppressed:
                failures.append(f"{ring.suppressed} duplicate "
                                f"(epoch,out_seq) stamp(s) in the "
                                f"{gen}-generation {topic} log")
            merged.extend(keep)
        merged.sort(key=lambda r: (r.out_seq
                                   if r.out_seq is not None else -1))
        return [f"{r.key} {r.value}" for r in merged]

    actual_pre = [_merged_actual(old_root, k, "old") for k in range(n)]
    actual_post = [_merged_actual(new_root, k, "new") for k in range(m)]
    # the new generation's MatchIn carries two stamp kinds on one shared
    # sequence space: coordinator legs at (epoch 1, 0..legs-1) and front
    # cursor stamps at (None, legs..) — out_seq alone must be unique
    for k in range(m):
        recs = read_matchout_records(
            os.path.join(new_root, f"group{k}", "broker-log"),
            topic=group_topics(k)[0])
        seqs = [r.out_seq for r in recs if r.out_seq is not None]
        dups = len(seqs) - len(set(seqs))
        dup_stamps[f"new:{group_topics(k)[0]}"] = dups
        if dups:
            failures.append(f"{dups} duplicate out_seq stamp(s) in the "
                            f"new-generation MatchIn.g{k} log")
    verify = front.verify_groups_reshard(
        lines, split_at, actual_pre, actual_post, compat="fixed",
        book_slots=args.slots, max_fills=args.max_fills,
        prefund=args.prefund)
    if not verify["ok"]:
        failures.append(f"reshard parity FAILED: "
                        f"{verify['mismatches'][:1]}")

    # -- the settlement ledger: exactly once, despite the SIGKILL -----
    legs_by_group = collections.Counter(leg[0] for leg in legs)
    ledger_checks = []
    for k in range(m):
        gdir = os.path.join(new_root, f"group{k}")
        matchin = collections.Counter(
            r.value for r in read_matchout_records(
                os.path.join(gdir, "broker-log"),
                topic=group_topics(k)[0]))
        for g, _seq, xid, _aid, _amt, leg_line in legs:
            if g != k:
                continue
            got = matchin.get(leg_line, 0)
            if got != 1:
                failures.append(f"settlement leg xid={xid} appears "
                                f"{got}x in MatchIn.g{k} (want exactly "
                                f"once)")
        eng, off = ck.load_oracle(gdir)
        pend = (ck.snapshot_extra(gdir, off).get("pending_reserve", {})
                if eng is not None else {})
        front_legs = sum(1 for ln in post_sub[k]
                         if front.is_internal_line(ln)
                         and parse_order(ln).action == op.TRANSFER)
        want_legs = legs_by_group.get(k, 0) + front_legs
        check = {"group": k, "coordinator_legs": legs_by_group.get(k, 0),
                 "front_legs": front_legs, "ledger": pend}
        ledger_checks.append(check)
        if eng is None:
            failures.append(f"new group {k} left no final snapshot")
        elif pend.get("legs") != want_legs or pend.get("rejected"):
            failures.append(
                f"new group {k} pending_reserve ledger {pend} != "
                f"{want_legs} settled legs with zero rejects")

    # -- the old epochs stay dead: durable re-fence probes ------------
    probes = [reshard_mod.probe_fenced(os.path.join(old_root,
                                                    f"group{k}"))
              for k in range(n)]
    for k, fenced in enumerate(probes):
        if not fenced:
            failures.append(f"old group {k} is NOT durably fenced — a "
                            f"zombie leader could dirty the retired "
                            f"log")

    # -- bounded dip: migration pause + the new generation's p99 ------
    first_new = [t for k in range(m)
                 for t, off in samples[("new", k)] if off >= 1]
    pause = (min(first_new) - t_drain) if first_new else None
    if pause is None:
        failures.append("the new generation never made progress")
    elif pause > args.reshard_pause:
        failures.append(f"migration pause {pause:.1f}s over the "
                        f"{args.reshard_pause}s bound")
    p99s: dict = {}
    for gen, count, root in (("old", n, old_root), ("new", m, new_root)):
        for k in range(count):
            try:
                with open(os.path.join(root, f"group{k}",
                                       "serve.health")) as f:
                    hb = json.load(f)
                p99s[f"{gen}:g{k}"] = hb.get("metrics", {}).get(
                    "latencies", {}).get("lat_e2e", {}).get("p99_ms")
            except (OSError, ValueError):
                p99s[f"{gen}:g{k}"] = None
    for k in range(m):
        p99 = p99s.get(f"new:g{k}")
        if p99 is None:
            failures.append(f"new group {k} left no lat_e2e p99 in its "
                            f"final heartbeat")
        elif p99 > args.reshard_p99_ms:
            # the new generation's histogram includes the settlement
            # legs, admitted before any leader was up — this bound
            # covers the migration gap, not just steady-state tail
            failures.append(f"SLO: new group {k} p99 {p99:.1f}ms over "
                            f"the {args.reshard_p99_ms}ms bound")

    # -- control-plane timeline: exactly-once phases + wall decompo- --
    # merge every event log the run left behind (old-generation
    # supervisors/serves under r0, coordinator + new generation under
    # r1) into one causally ordered timeline. The coordinator ran
    # TWICE (SIGKILLed mid-settle, then to done) against the same
    # phase-ordinal seqs — the merged timeline must hold each phase
    # EXACTLY once, or the replay-dedup discipline is broken.
    from kme_tpu_torch.telemetry import events as cpevents

    timeline = cpevents.merge_logs([run_dir])
    merged_path = os.path.join(run_dir, "events.jsonl")
    try:
        cpevents.write_merged(timeline, merged_path)
    except OSError:
        merged_path = None
    phase_counts = {p: 0 for p in
                    reshard_mod.ReshardCoordinator.PHASES}
    migrate_off = None
    for ev in timeline:
        kind = str(ev.get("kind", ""))
        if ev.get("src") == "reshard" and kind.startswith("reshard."):
            p = kind.split(".", 1)[1]
            if p in phase_counts:
                phase_counts[p] += 1
            if p == "migrate":
                migrate_off = ev.get("off")
    if not timeline:
        failures.append("the run left no control-plane events — the "
                        "flight recorder never engaged")
    for p, c in phase_counts.items():
        if c != 1:
            failures.append(
                f"merged timeline holds {c} reshard.{p} event(s), "
                f"want exactly 1 — the post-SIGKILL re-run must dedup "
                f"its resumed phases, not duplicate (or drop) them")
    if sizes_pre and migrate_off != max(sizes_pre):
        failures.append(
            f"reshard.migrate offset anchor {migrate_off} != drained "
            f"high-water {max(sizes_pre)} — the timeline would merge "
            f"out of replay order")

    # reshard_pause_ms decomposed by phase: drain->coordinator gap and
    # post-coordinator relaunch measured by the drill's clock,
    # fence/migrate/settle by the coordinator's own (journal walls —
    # each recorded by whichever incarnation ran the phase, so they
    # survive the SIGKILL). Independent clocks, so the sum reconciles
    # against the measured pause within a tolerance that absorbs what
    # no phase owns: two interpreter spawns and the crashed settle
    # attempt.
    jwalls = jdoc.get("walls", {})
    walls_ms = {
        "drain": round(max(0.0, t_coord0 - t_drain) * 1000.0, 3),
        "fence": round(float(jwalls.get("fence_s", 0.0)) * 1000.0, 3),
        "migrate": round(float(jwalls.get("migrate_s", 0.0))
                         * 1000.0, 3),
        "settle": round(float(jwalls.get("settle_s", 0.0))
                        * 1000.0, 3),
        "relaunch": (round(max(0.0, min(first_new) - t_coord1)
                           * 1000.0, 3) if first_new else None),
    }
    for p in ("fence", "migrate", "settle"):
        if f"{p}_s" not in jwalls:
            failures.append(f"reshard journal carries no {p} wall — "
                            f"the pause cannot be attributed by phase")
    unattributed_ms = None
    if pause is not None and walls_ms["relaunch"] is not None:
        walls_sum = sum(v for v in walls_ms.values() if v is not None)
        unattributed_ms = round(pause * 1000.0 - walls_sum, 3)
        tol_ms = args.reshard_walls_tol * 1000.0
        if unattributed_ms < -500.0:
            failures.append(
                f"phase walls sum {walls_sum:.0f}ms EXCEEDS the "
                f"measured pause {pause * 1000.0:.0f}ms — a wall is "
                f"double-counted or a clock ran backwards")
        elif unattributed_ms > tol_ms:
            failures.append(
                f"phase walls account for {walls_sum:.0f}ms of the "
                f"{pause * 1000.0:.0f}ms pause — "
                f"{unattributed_ms:.0f}ms unattributed exceeds the "
                f"{tol_ms:.0f}ms tolerance")

    report = {
        "ok": not failures,
        "failures": failures,
        "scenario": "reshard-under-storm",
        "seed": args.seed,
        "events": len(msgs),
        "old_groups": n,
        "new_groups": m,
        "split_at": split_at,
        "substreams_pre": sizes_pre,
        "substreams_post": sizes_post,
        "elapsed_seconds": round(elapsed, 3),
        "reshard": reshard_info,
        "plan": jdoc.get("migrate", {}).get("plan"),
        "settle": {k: settle.get(k) for k in
                   ("legs", "dup_suppressed", "epochs",
                    "resume_cursors")},
        "coordinator_crash_rc": crash.returncode,
        "duplicate_stamps": dup_stamps,
        "ledger": ledger_checks,
        "old_fenced": probes,
        "migration_pause_s": (round(pause, 3)
                              if pause is not None else None),
        # flat perfgate-scrapeable gauges: reshard_pause_ms decomposed
        # by phase (perfgate.ADVISORY_METRICS — wall clocks, advisory)
        "reshard_pause_ms": (round(pause * 1000.0, 3)
                             if pause is not None else None),
        "reshard_drain_ms": walls_ms["drain"],
        "reshard_fence_ms": walls_ms["fence"],
        "reshard_migrate_ms": walls_ms["migrate"],
        "reshard_settle_ms": walls_ms["settle"],
        "reshard_relaunch_ms": walls_ms["relaunch"],
        "reshard_unattributed_ms": unattributed_ms,
        "timeline": {
            "count": len(timeline),
            "digest": cpevents.timeline_digest(timeline),
            "phase_counts": phase_counts,
            "merged_path": merged_path,
            "tail": [cpevents.format_event(ev)
                     for ev in timeline[-12:]],
        },
        "p99_ms": p99s,
        "front_links": link_state,
        "verify": dict(verify,
                       mismatches=verify.get("mismatches", [])[:3]),
        "run_dir": run_dir,
    }
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    status = "OK" if report["ok"] else "FAILED"
    print(f"kme-torch-chaos: {status} — reshard-under-storm {n}->{m} "
          f"split_at={split_at} legs={settle.get('legs')} "
          f"settle_dedup={settle.get('dup_suppressed')} "
          f"crash_rc={crash.returncode} "
          f"dup_stamps={sum(dup_stamps.values())} "
          f"pause={report['migration_pause_s']}s "
          f"timeline={len(timeline)}ev "
          f"phases={[phase_counts[p] for p in sorted(phase_counts)]} "
          f"fenced={probes} "
          f"parity={'byte-exact' if verify['ok'] else 'DIVERGED'} "
          f"elapsed={elapsed:.1f}s", file=sys.stderr)
    for fail in failures:
        print(f"kme-torch-chaos: FAIL: {fail}", file=sys.stderr)
    print(f"kme-torch-chaos: report written to {report_path}",
          file=sys.stderr)
    return 0 if report["ok"] else 1


def scenario_registry() -> dict:
    """name -> one-line description for every runnable scenario: the
    four recovery drills plus the five adversarial storm profiles
    (workload.STORM_PROFILES). `kme-torch-chaos --list-scenarios` prints it."""
    from kme_tpu_torch.workload import STORM_PROFILES

    reg = {
        "default": "at-least-once recovery gauntlet: every fault class "
                   "(transport, snapshot, journal, kill, stall), "
                   "verify_stream prefix+replay composition",
        "failover": "hot-standby promotion under exactly-once: SIGKILL "
                    "the leader mid-stream, bounded promotion, epoch "
                    "fencing, deduped stream byte-exact",
        "shard-failover": "multi-leader drill: kill the busiest "
                          "group's leader; survivors must not dip, "
                          "merged stream byte-exact, zero duplicate "
                          "stamps",
        "feed-failover": "market-data drill: kill the leader with "
                         "live feed subscribers; books byte-exact "
                         "post-promotion, zero dup/missing delta "
                         "seqs",
        "reshard-under-storm": "live N->M re-split mid-flash-crowd: "
                               "drain at a batch barrier, fence + "
                               "migrate + settle (coordinator "
                               "SIGKILLed mid-settle and re-run), new "
                               "generation resumes over TCP front "
                               "links; byte parity across both "
                               "topologies, zero dup stamps, "
                               "exactly-once settlement, bounded "
                               "pause",
    }
    for name, prof in STORM_PROFILES.items():
        reg[name] = (f"storm: {prof.summary} (adaptive overload "
                     f"control, oracle parity over the admitted "
                     f"stream, SLO verdict)")
    return reg


class _StormProducer(threading.Thread):
    """Per-record MatchIn feeder for the storm scenarios. Unlike
    _Producer it does NOT retry a shed record: the adaptive controller's
    rej_overload means the record was rejected at admission, and
    shedding must act as a pure input filter — the dropped record simply
    never existed as far as the engine (and the oracle replay of the
    admitted stream) is concerned. The producer honors the AIMD backoff
    hint carried on the reject and classifies every offer/shed by
    priority class for the fairness verdict."""

    def __init__(self, host: str, port: int, lines: List[str],
                 windows: List[Tuple[int, int, int]],
                 pace_s: float) -> None:
        super().__init__(daemon=True)
        self.host, self.port = host, port
        self.lines, self.windows, self.pace_s = lines, windows, pace_s
        self.offered = 0
        self.sheds = 0
        self.reconnects = 0
        self.backoff_slept_ms = 0.0
        self.offered_by_class = {0: 0, 1: 0, 2: 0}
        self.shed_by_class = {0: 0, 1: 0, 2: 0}
        self.stop = threading.Event()

    def run(self) -> None:
        from kme_tpu_torch.bridge.broker import (BrokerError, BrokerOverload,
                                           classify_produce)
        from kme_tpu_torch.bridge.provision import provision
        from kme_tpu_torch.bridge.tcp import TcpBroker

        client = None
        i = 0
        while i < len(self.lines) and not self.stop.is_set():
            cls, _, _ = classify_produce(self.lines[i])
            burst = any(lo <= i < hi for lo, hi, _ in self.windows)
            try:
                if client is None:
                    client = TcpBroker(self.host, self.port,
                                       timeout=10.0)
                    provision(client)           # idempotent
                client.produce(TOPIC_IN, None, self.lines[i])
                self.offered += 1
                self.offered_by_class[cls] += 1
                i += 1
                # rate lives in producer pacing: flat-out inside a
                # burst window, paced in the steady state
                if not burst and self.pace_s > 0:
                    time.sleep(self.pace_s)
            except BrokerOverload as e:
                self.offered += 1
                self.offered_by_class[cls] += 1
                self.sheds += 1
                self.shed_by_class[cls] += 1
                i += 1                          # dropped, not retried
                hint = getattr(e, "backoff_ms", None)
                if hint:
                    nap = min(int(hint), 100) / 1e3
                    self.backoff_slept_ms += nap * 1e3
                    time.sleep(nap)
            except (BrokerError, OSError):
                # serve still coming up, or a transient transport blip:
                # reconnect and retry the SAME record (no faults are
                # injected in a storm run, so ambiguity is startup-only)
                if client is not None:
                    try:
                        client.close()
                    except OSError:
                        pass
                client = None
                self.reconnects += 1
                time.sleep(0.2)
        if client is not None:
            try:
                client.close()
            except OSError:
                pass


def run_storm(args, run_dir: str, report_path: str) -> int:
    """--scenario <storm-name>: drive one adversarial storm profile
    (workload.STORM_PROFILES) at a supervise-free kme-torch-serve running the
    adaptive overload controller, then prove graceful degradation:

    - ORACLE PARITY over the admitted stream: the durable MatchIn log
      IS the admitted sequence (everything the controller let through);
      an in-process oracle replay of exactly that sequence must match
      the deduped durable MatchOut BYTE-EXACTLY, with ZERO duplicate
      (epoch, out_seq) stamps — shedding is a pure input filter, never
      a corruption;
    - SLO VERDICT: the final heartbeat's lat_e2e p99 (broker admission
      -> outputs visible) must sit under --storm-p99-ms, and admitted
      throughput must clear --storm-min-tput records/s;
    - PRIORITY FAIRNESS: when anything shed, book-shrinking traffic
      (cancels/payouts, class 0) must shed at a strictly lower rate
      than new orders (class 2) — the whole point of priority-aware
      admission;
    - at least --min-sheds records actually shed (a storm that never
      pushed the controller proves nothing).
    """
    from kme_tpu_torch.bridge.consume import DedupRing
    from kme_tpu_torch.wire import dumps_order
    from kme_tpu_torch.workload import (STORM_PROFILES, storm_stream,
                                  storm_windows)

    prof = STORM_PROFILES[args.scenario]
    symbols = args.storm_symbols or prof.symbols
    accounts = args.storm_accounts or prof.accounts
    msgs = storm_stream(args.scenario, args.events,
                        num_symbols=symbols, num_accounts=accounts,
                        seed=args.seed)
    lines = [dumps_order(m) for m in msgs]
    windows = storm_windows(args.scenario, args.events,
                            num_symbols=symbols, num_accounts=accounts)
    ckpt_dir = os.path.join(run_dir, "state")
    os.makedirs(ckpt_dir, exist_ok=True)
    health = os.path.join(ckpt_dir, "serve.health")
    log_dir = os.path.join(ckpt_dir, "broker-log")
    port = _free_port()
    print(f"kme-torch-chaos: scenario={args.scenario} seed={args.seed} "
          f"events={args.events} symbols={symbols} accounts={accounts} "
          f"records={len(lines)} windows={windows} "
          f"high_lag={args.overload_high_lag}\n"
          f"kme-torch-chaos: run dir {run_dir}", file=sys.stderr)

    serve_cmd = [sys.executable, "-m", "kme_tpu_torch.cli", "serve",
                 "--engine", args.engine, "--device", args.device,
                 "--compat", "fixed",
                 "--batch", str(args.batch),
                 "--slots", str(args.slots),
                 "--max-fills", str(args.max_fills),
                 "--symbols", str(max(symbols, 8)),
                 "--accounts", str(max(accounts + 8, 128)),
                 "--checkpoint-dir", ckpt_dir,
                 "--checkpoint-every", str(args.checkpoint_every),
                 "--overload-high-lag", str(args.overload_high_lag),
                 "--listen", f"127.0.0.1:{port}",
                 "--idle-exit", str(args.idle_exit),
                 "--health-file", health,
                 "--health-every", "0.1"]
    if not args.no_journal:
        serve_cmd += ["--journal-out",
                      os.path.join(run_dir, "journal.jsonl")]
    env = dict(os.environ)
    env.pop("KME_FAULTS", None)     # the storm itself is the attack
    env.pop("KME_FAULTS_STATE", None)
    t0 = time.time()
    srv = subprocess.Popen(serve_cmd, env=env)
    producer = _StormProducer("127.0.0.1", port, lines, windows,
                              pace_s=args.pace_ms / 1e3)
    producer.start()

    rc: Optional[int] = None
    deadline = t0 + args.timeout
    while time.time() < deadline:
        rc = srv.poll()
        if rc is not None:
            break
        time.sleep(0.25)
    if rc is None:
        print(f"kme-torch-chaos: TIMEOUT after {args.timeout}s; killing "
              f"kme-torch-serve", file=sys.stderr)
        srv.kill()
        srv.wait()
        rc = srv.returncode
    producer.stop.set()
    producer.join(timeout=10.0)
    elapsed = time.time() - t0

    failures: List[str] = []
    if rc != 0:
        failures.append(f"kme-torch-serve exited rc={rc}")
    if producer.offered < len(lines):
        failures.append(f"producer only offered {producer.offered} of "
                        f"{len(lines)} records")

    # oracle parity over the ADMITTED stream: the durable MatchIn log
    # is ground truth for what got past the controller
    admitted_lines = [r.value for r in
                      read_matchout_records(log_dir, topic=TOPIC_IN)]
    per_msg = expected_groups(admitted_lines, args.slots,
                              args.max_fills)
    flat = [ln for g in per_msg for ln in g]
    out_recs = read_matchout_records(log_dir)
    ring = DedupRing()
    visible = [f"{r.key} {r.value}" for r in out_recs
               if not ring.is_dup(r.epoch, r.out_seq)]
    parity = {"admitted_records": len(admitted_lines),
              "got_lines": len(visible),
              "expected_lines": len(flat),
              "duplicate_stamps": ring.suppressed}
    if ring.suppressed:
        failures.append(f"{ring.suppressed} duplicate (epoch,out_seq) "
                        f"stamp(s) in the durable MatchOut log")
    if visible != flat:
        n = min(len(visible), len(flat))
        div = next((k for k in range(n) if visible[k] != flat[k]), n)
        parity["error"] = (f"admitted-stream replay diverges at line "
                           f"{div} (got {len(visible)}, want "
                           f"{len(flat)})")
        failures.append(f"oracle parity over the admitted stream "
                        f"FAILED: {parity['error']}")

    # shed accounting + priority fairness (producer-side ground truth)
    shed = producer.sheds
    shed_frac = shed / max(1, producer.offered)
    if shed < args.min_sheds:
        failures.append(f"only {shed} record(s) shed; the storm never "
                        f"pushed the controller (need >= "
                        f"{args.min_sheds})")

    def _rate(cls: int) -> Optional[float]:
        n = producer.offered_by_class[cls]
        return producer.shed_by_class[cls] / n if n else None

    rates = {cls: _rate(cls) for cls in (0, 1, 2)}
    if shed and producer.offered_by_class[0] \
            and rates[2] is not None:
        if rates[0] is None or rates[0] >= rates[2]:
            failures.append(
                f"priority inversion: class-0 (cancel/payout) shed "
                f"rate {rates[0]} is not strictly below class-2 (new "
                f"order) shed rate {rates[2]}")

    # SLO verdict from the final heartbeat
    slo: dict = {"p99_bound_ms": args.storm_p99_ms,
                 "min_tput": args.storm_min_tput}
    gauges: dict = {}
    try:
        with open(health) as f:
            hb = json.load(f)
        met = hb.get("metrics", {})
        gauges = met.get("gauges", {})
        slo["p99_ms"] = met.get("latencies", {}).get(
            "lat_e2e", {}).get("p99_ms")
    except (OSError, ValueError):
        slo["p99_ms"] = None
    admitted = producer.offered - shed
    slo["tput"] = round(admitted / elapsed, 1) if elapsed > 0 else None
    if slo["p99_ms"] is None:
        failures.append("no lat_e2e p99 in the final heartbeat")
    elif slo["p99_ms"] > args.storm_p99_ms:
        failures.append(f"SLO: p99 admission-to-produce "
                        f"{slo['p99_ms']:.1f}ms over the "
                        f"{args.storm_p99_ms}ms bound")
    if slo["tput"] is not None and slo["tput"] < args.storm_min_tput:
        failures.append(f"SLO: survivor throughput {slo['tput']}/s "
                        f"under the {args.storm_min_tput}/s floor")
    slo["ok"] = not any(f.startswith("SLO:") for f in failures)

    report = {
        "ok": not failures,
        "failures": failures,
        "scenario": args.scenario,
        "summary": prof.summary,
        "seed": args.seed,
        "events": args.events,
        "symbols": symbols,
        "accounts": accounts,
        "records": len(lines),
        "windows": [list(w) for w in windows],
        "elapsed_seconds": round(elapsed, 3),
        "offered": producer.offered,
        "admitted": admitted,
        "shed": shed,
        "shed_frac": round(shed_frac, 4),
        "offered_by_class": producer.offered_by_class,
        "shed_by_class": producer.shed_by_class,
        "shed_rates_by_class": {str(k): (round(v, 4)
                                         if v is not None else None)
                                for k, v in rates.items()},
        "backoff_slept_ms": round(producer.backoff_slept_ms, 1),
        "reconnects": producer.reconnects,
        "slo": slo,
        "parity": parity,
        "controller_gauges": {k: v for k, v in gauges.items()
                              if k.startswith("overload_")
                              or k.startswith("shed_by_class")
                              or k.startswith("admitted_by_class")},
        "timeline": _timeline_section(run_dir),
        "run_dir": run_dir,
    }
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    status = "OK" if report["ok"] else "FAILED"
    print(f"kme-torch-chaos: {status} — {args.scenario}: offered "
          f"{producer.offered}, shed {shed} ({shed_frac:.1%}), "
          f"rates by class {report['shed_rates_by_class']}, "
          f"p99={slo['p99_ms']}ms (bound {args.storm_p99_ms}ms), "
          f"tput={slo['tput']}/s, parity="
          f"{'byte-exact' if 'error' not in parity else 'DIVERGED'}, "
          f"dup_stamps={ring.suppressed}, elapsed={elapsed:.1f}s",
          file=sys.stderr)
    for fail in failures:
        print(f"kme-torch-chaos: FAIL: {fail}", file=sys.stderr)
    print(f"kme-torch-chaos: report written to {report_path}",
          file=sys.stderr)
    return 0 if report["ok"] else 1


def _fault_fires(state_dir: str) -> dict:
    fires = {}
    try:
        for name in sorted(os.listdir(state_dir)):
            if name.endswith(".fired"):
                with open(os.path.join(state_dir, name)) as f:
                    fires[name[:-len(".fired")]] = int(f.read().strip()
                                                       or 0)
    except (OSError, ValueError):
        pass
    return fires


def card_missing(args) -> bool:
    """True when the serve children would run the seq or lanes engine on
    a CUDA device and this host has no card: the run cannot start, and
    nothing falls back to the CPU. (reshard-under-storm serves the oracle
    engine whatever --engine says.)"""
    if args.engine not in ("seq", "lanes") \
            or not str(args.device).startswith("cuda") \
            or args.scenario == "reshard-under-storm":
        return False
    import torch

    return not torch.cuda.is_available()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kme-torch-chaos", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the workload AND every fault rule")
    from kme_tpu_torch.workload import STORM_PROFILES

    p.add_argument("--list-scenarios", action="store_true",
                   help="print the scenario registry (name + one-line "
                        "description) and exit")
    p.add_argument("--scenario",
                   choices=("default", "failover", "shard-failover",
                            "feed-failover", "reshard-under-storm")
                   + tuple(STORM_PROFILES),
                   default="default",
                   help="default = the at-least-once recovery gauntlet "
                        "(every fault class, verify_stream); failover "
                        "= hot-standby promotion under exactly-once: "
                        "SIGKILL the leader mid-stream, require the "
                        "supervisor to promote the replica with a "
                        "higher epoch within --max-failover seconds, "
                        "the old epoch to be fenced, and the deduped "
                        "MatchOut stream to be byte-exact with ZERO "
                        "visible duplicates; shard-failover = the "
                        "multi-leader drill: --groups shard groups "
                        "serve concurrently, the busiest group's "
                        "leader is SIGKILLed mid-substream, survivors "
                        "must not dip >=10%, the standby must promote "
                        "within --max-failover, the merged stream "
                        "must be byte-exact and no durable log may "
                        "hold a duplicate (epoch,out_seq) stamp; any "
                        "storm-profile name (--list-scenarios) = drive "
                        "that adversarial workload at the adaptive "
                        "overload controller and verify oracle parity "
                        "over the admitted stream, priority fairness "
                        "and the SLO verdict")
    p.add_argument("--groups", type=int, default=2,
                   help="shard-failover scenario: number of shard "
                        "groups (leader pairs)")
    p.add_argument("--prefund", type=int, default=8,
                   help="shard-failover scenario: chunked reserve "
                        "grant size for cross-shard transfers "
                        "(kme-torch-front --prefund)")
    p.add_argument("--cross-frac", type=float, default=0.5,
                   help="shard-failover scenario: fraction of orders "
                        "placed from non-home accounts (the "
                        "cross-account workload profile)")
    p.add_argument("--groups-to", type=int, default=4, metavar="M",
                   help="reshard-under-storm scenario: the new group "
                        "count the coordinator re-splits to "
                        "mid-stream")
    p.add_argument("--reshard-kill-legs", type=int, default=5,
                   metavar="J",
                   help="reshard-under-storm scenario: SIGKILL the "
                        "coordinator after J settlement legs (the "
                        "crash-during-migration fault; the re-run "
                        "must dedup)")
    p.add_argument("--reshard-pause", type=float, default=90.0,
                   help="reshard-under-storm scenario: bound on the "
                        "migration pause, old-generation drain -> "
                        "first new-generation progress (seconds)")
    p.add_argument("--reshard-walls-tol", type=float, default=20.0,
                   help="reshard-under-storm scenario: tolerance "
                        "(seconds) for the pause left unattributed "
                        "after the per-phase walls (drain/fence/"
                        "migrate/settle/relaunch) are summed — covers "
                        "the two coordinator interpreter spawns and "
                        "the crashed settle attempt, which no phase "
                        "owns")
    p.add_argument("--reshard-p99-ms", type=float, default=10_000.0,
                   help="reshard-under-storm scenario: bound on the "
                        "new generation's final lat_e2e p99. The "
                        "coordinator's settlement legs are admitted "
                        "while no leader is up, so their e2e latency "
                        "IS the migration gap — this bounds the "
                        "user-visible worst case across the re-split, "
                        "not steady-state tail latency")
    p.add_argument("--max-failover", type=float, default=2.0,
                   help="failover scenario: max seconds from failure "
                        "detection to the promoted replica serving")
    p.add_argument("--storm-symbols", type=int, default=None,
                   help="storm scenarios: override the profile's "
                        "symbol-universe width (reduced-scale CI runs)")
    p.add_argument("--storm-accounts", type=int, default=None,
                   help="storm scenarios: override the profile's "
                        "account count")
    p.add_argument("--storm-p99-ms", type=float, default=2000.0,
                   help="storm scenarios: SLO bound on the lat_e2e p99 "
                        "(broker admission -> outputs visible)")
    p.add_argument("--storm-min-tput", type=float, default=10.0,
                   help="storm scenarios: survivor throughput floor "
                        "(admitted records/s over the whole run)")
    p.add_argument("--min-sheds", type=int, default=1,
                   help="storm scenarios: fail unless at least this "
                        "many records were shed (a storm that never "
                        "pushed the controller proves nothing)")
    p.add_argument("--pace-ms", type=float, default=1.0,
                   help="storm scenarios: per-record producer pacing "
                        "OUTSIDE burst windows (inside a window the "
                        "producer runs flat out — that asymmetry IS "
                        "the storm's rate multiplier)")
    p.add_argument("--overload-high-lag", type=int, default=48,
                   help="storm scenarios: the adaptive controller's "
                        "shedding threshold passed to kme-torch-serve")
    p.add_argument("--events", type=int, default=2000)
    p.add_argument("--accounts", type=int, default=10)
    p.add_argument("--symbols", type=int, default=3)
    p.add_argument("--engine", choices=("oracle", "native", "seq",
                                        "lanes"), default="seq",
                   help="serving engine under attack (default the seq "
                        "kernel on --device; oracle is host-only and "
                        "fast on CPU; the recovery machinery under test "
                        "is engine-independent)")
    p.add_argument("--device", default="cuda",
                   help="forwarded to every serve child: where the seq "
                        "and lanes engines run (default the card; 'cpu' "
                        "runs the kernels' plain PyTorch versions); the "
                        "host engines ignore it")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--slots", type=int, default=128)
    p.add_argument("--max-fills", type=int, default=32)
    p.add_argument("--checkpoint-every", type=int, default=60)
    p.add_argument("--checkpoint-keep", type=int, default=3)
    p.add_argument("--schedule", default=None, metavar="SPEC",
                   help="KME_FAULTS spec (default: a seed-derived "
                        "schedule covering transport, snapshot, "
                        "journal, kill and stall faults)")
    p.add_argument("--dir", default=None, metavar="DIR",
                   help="run directory (checkpoints, broker logs, "
                        "journal, report); default: a temp dir, kept "
                        "on failure")
    p.add_argument("--max-lag", type=int, default=None,
                   help="bounded-ingress backlog bound passed to "
                        "kme-torch-serve (producer treats rej_overload as "
                        "backpressure)")
    p.add_argument("--max-restarts", type=int, default=10)
    p.add_argument("--min-restarts", type=int, default=1,
                   help="fail unless at least this many automatic "
                        "restarts happened (a chaos run where nothing "
                        "died proves nothing)")
    p.add_argument("--stale-after", type=float, default=5.0)
    p.add_argument("--stall-after", type=float, default=2.5)
    p.add_argument("--grace", type=float, default=30.0)
    p.add_argument("--idle-exit", type=float, default=5.0)
    p.add_argument("--timeout", type=float, default=300.0,
                   help="overall wall-clock budget for the supervised "
                        "run")
    p.add_argument("--no-journal", action="store_true",
                   help="skip the flight recorder (and the journal.torn "
                        "fault)")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="write the JSON report here (default: "
                        "<dir>/chaos-report.json)")
    args = p.parse_args(argv)

    if args.list_scenarios:
        reg = scenario_registry()
        width = max(len(n) for n in reg)
        for name, desc in reg.items():
            print(f"{name:<{width}}  {desc}")
        return 0

    if card_missing(args):
        print(f"kme-torch-chaos: --engine {args.engine} on --device "
              f"{args.device} needs a CUDA card and none is visible; pass "
              f"--device cpu or --engine oracle to run without one",
              file=sys.stderr)
        return 2

    from kme_tpu_torch.wire import dumps_order
    from kme_tpu_torch.workload import harness_stream

    failover = args.scenario == "failover"
    run_dir = args.dir
    if run_dir is None:
        import tempfile

        run_dir = tempfile.mkdtemp(prefix="kme-torch-chaos-")
    os.makedirs(run_dir, exist_ok=True)
    if args.scenario == "shard-failover":
        report_path = args.report or os.path.join(
            run_dir, "chaos-report.json")
        return run_shard_failover(args, run_dir, report_path)
    if args.scenario == "feed-failover":
        report_path = args.report or os.path.join(
            run_dir, "chaos-report.json")
        return run_feed_failover(args, run_dir, report_path)
    if args.scenario == "reshard-under-storm":
        report_path = args.report or os.path.join(
            run_dir, "chaos-report.json")
        return run_reshard_storm(args, run_dir, report_path)
    if args.scenario in STORM_PROFILES:
        report_path = args.report or os.path.join(
            run_dir, "chaos-report.json")
        return run_storm(args, run_dir, report_path)
    ckpt_dir = os.path.join(run_dir, "state")
    state_dir = os.path.join(run_dir, "fault-state")
    os.makedirs(ckpt_dir, exist_ok=True)
    journal = (None if args.no_journal or failover
               else os.path.join(run_dir, "journal.jsonl"))
    schedule = args.schedule
    if schedule is None:
        schedule = (failover_schedule(args.seed, args.events) if failover
                    else default_schedule(args.seed, args.events,
                                          journal is not None))
    report_path = args.report or os.path.join(run_dir,
                                              "chaos-report.json")

    print(f"kme-torch-chaos: scenario={args.scenario} seed={args.seed} "
          f"events={args.events} "
          f"engine={args.engine}\nkme-torch-chaos: schedule {schedule}\n"
          f"kme-torch-chaos: run dir {run_dir}", file=sys.stderr)

    # 1. the ground truth (in-process; no faults are active here)
    msgs = harness_stream(args.events, seed=args.seed,
                          num_accounts=args.accounts,
                          num_symbols=args.symbols,
                          payout_opcode_bug=False, validate=True)
    lines = [dumps_order(m) for m in msgs]
    per_msg = expected_groups(lines, args.slots, args.max_fills)

    # 2. the supervised service under attack
    port = _free_port()
    serve_args = ["--engine", args.engine, "--device", args.device,
                  "--compat", "fixed",
                  "--batch", str(args.batch),
                  "--slots", str(args.slots),
                  "--max-fills", str(args.max_fills),
                  "--checkpoint-every", str(args.checkpoint_every),
                  "--checkpoint-keep", str(args.checkpoint_keep),
                  "--listen", f"127.0.0.1:{port}",
                  "--idle-exit", str(args.idle_exit),
                  "--health-every", "0.2"]
    if args.max_lag is not None:
        serve_args += ["--max-lag", str(args.max_lag)]
    if journal is not None:
        serve_args += ["--journal-out", journal]
    sup_cmd = [sys.executable, "-m", "kme_tpu_torch.cli", "supervise",
               "--checkpoint-dir", ckpt_dir,
               "--stale-after", str(args.stale_after),
               "--stall-after", str(args.stall_after),
               "--max-restarts", str(args.max_restarts),
               "--grace", str(args.grace),
               "--backoff-base", "0.05", "--backoff-cap", "0.5"]
    if failover:
        # hot standby + a tight watch poll: the failover bound starts
        # at failure DETECTION, but a slow detector makes for a slow
        # drill
        sup_cmd += ["--standby", "--poll", "0.1"]
    sup_cmd += ["--"] + serve_args
    env = dict(os.environ)
    env["KME_FAULTS"] = schedule
    env["KME_FAULTS_STATE"] = state_dir
    t0 = time.time()
    sup = subprocess.Popen(sup_cmd, env=env)

    # 3. feed the input (idempotent; concurrent with the attack)
    if failover:
        _await_standby(ckpt_dir, sup, t0 + args.timeout)
    producer = _Producer("127.0.0.1", port, lines)
    producer.start()

    # 4. wait for the run to finish
    sup_rc: Optional[int] = None
    deadline = t0 + args.timeout
    while time.time() < deadline:
        sup_rc = sup.poll()
        if sup_rc is not None:
            break
        time.sleep(0.25)
    if sup_rc is None:
        print(f"kme-torch-chaos: TIMEOUT after {args.timeout}s; killing the "
              f"supervisor", file=sys.stderr)
        sup.kill()
        sup.wait()
    producer.stop.set()
    producer.join(timeout=10.0)
    elapsed = time.time() - t0

    # 5. post-mortem verification against the oracle
    log_dir = os.path.join(ckpt_dir, "broker-log")
    recs = read_matchout_records(log_dir)
    got = [f"{r.key} {r.value}" for r in recs]
    if failover:
        ok, verify = verify_failover(recs, per_msg)
    else:
        ok, verify = verify_stream(got, per_msg)

    sup_state = {}
    try:
        with open(os.path.join(ckpt_dir, "supervisor.json")) as f:
            sup_state = json.load(f)
    except (OSError, ValueError):
        pass
    restarts = int(sup_state.get("restarts_total", 0))
    recoveries = sup_state.get("recoveries", [])
    rec_times = [r["recovered_in"] for r in recoveries
                 if "recovered_in" in r]

    failures = []
    if sup_rc != 0:
        failures.append(f"supervisor exited rc={sup_rc}")
    if not ok:
        failures.append(f"stream verification failed: "
                        f"{verify.get('error')}")
    if producer.sent < len(lines):
        failures.append(f"producer only delivered {producer.sent} of "
                        f"{len(lines)} records")
    if restarts < args.min_restarts:
        failures.append(f"only {restarts} automatic restart(s); "
                        f"need >= {args.min_restarts}")

    failover_report = None
    if failover:
        failover_report = _check_failover(
            ckpt_dir, log_dir, recoveries, args.max_failover, failures)

    report = {
        "ok": not failures,
        "failures": failures,
        "scenario": args.scenario,
        "failover": failover_report,
        "seed": args.seed,
        "events": args.events,
        "engine": args.engine,
        "schedule": schedule,
        "elapsed_seconds": round(elapsed, 3),
        "verify": verify,
        "restarts_total": restarts,
        "recovery_seconds": rec_times,
        "recovery_seconds_max": max(rec_times) if rec_times else None,
        "supervisor": sup_state,
        "fault_fires": _fault_fires(state_dir),
        "producer": {"sent": producer.sent,
                     "overload_retries": producer.overload_retries,
                     "reconnects": producer.reconnects},
        "timeline": _timeline_section(run_dir),
        "run_dir": run_dir,
    }
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    status = "OK" if report["ok"] else "FAILED"
    if failover_report is not None:
        print(f"kme-torch-chaos: failover — promotions="
              f"{failover_report.get('promotions')} "
              f"failover_seconds={failover_report.get('failover_seconds')} "
              f"dup_suppressed={failover_report.get('dup_suppressed_total')} "
              f"leader_epoch={failover_report.get('leader_epoch')} "
              f"stale_epoch_fenced="
              f"{failover_report.get('stale_epoch_fenced')}",
              file=sys.stderr)
    print(f"kme-torch-chaos: {status} — {len(got)} MatchOut lines verified "
          f"against {len(per_msg)} oracle groups "
          f"(replays={verify.get('replays', '?')}, replayed_messages="
          f"{verify.get('replayed_messages', '?')}), "
          f"restarts={restarts}, "
          f"recovery={rec_times and max(rec_times) or 'n/a'}s, "
          f"elapsed={elapsed:.1f}s", file=sys.stderr)
    for fail in failures:
        print(f"kme-torch-chaos: FAIL: {fail}", file=sys.stderr)
    print(f"kme-torch-chaos: report written to {report_path}", file=sys.stderr)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
