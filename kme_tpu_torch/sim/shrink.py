"""Red-seed shrinking: ddmin over the fault schedule, then input-size
reduction — from "seed 1337 is red under 6 faults and 700 inputs" to
the minimal adversity that still trips the verdict.

The shrink target is the whole ``FaultSchedule``: grammar clauses and
cluster events are the removable units (classic delta debugging — try
dropping complements at coarsening granularity, keep any candidate
that stays red), then ``num_events`` is walked down by halving while
the failure survives (event stream positions clamp to the shorter
stream so a crash-at-600 still fires in a 300-line run).

Because one seed fully determines a run, "stays red" is a pure
function: re-running a candidate schedule in a fresh directory gives
the SAME verdicts every time — no flaky-shrink loops, no
retry-to-confirm. An unexpected exception inside a candidate run
counts as red too (a schedule that crashes the harness is at least as
interesting as one that fails a verdict).

The output is a repro kit under ``out_dir``:

- ``repro.json`` — the minimal schedule, canonical one-line JSON
  (self-contained: seed, clauses, events, workload size, topology);
- ``repro.cmd``  — the one-line ``kme-torch-sim --repro`` invocation;
- ``run/``       — the minimal schedule's final red run, on disk
  (durable logs, checkpoints, journals — everything offline tooling
  needs);
- ``sim_repro.json`` — an ``audit.py``-format dump (violations /
  events / inputs / checkpoint_ref / xray) whose ``xray`` field is a
  ready-to-run ``kme-torch-xray --bisect`` line over the red run's
  journal, so the time-travel debugger picks up exactly where the sim
  verdict left off;
- ``events.jsonl`` — the red run's merged control-plane timeline
  (telemetry/events.py): every lease grant and reshard phase the
  cluster decided on the way to the red verdict.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from kme_tpu_torch.sim.cluster import SimConfig, SimResult, run_sim
from kme_tpu_torch.sim.schedule import FaultSchedule


@dataclass
class ShrinkResult:
    schedule: FaultSchedule          # the minimal red schedule
    result: SimResult                # its (final, red) run
    runs: int                        # candidate executions spent
    removed: int                     # adversity units shrunk away
    repro_path: str = ""
    cmd_path: str = ""
    dump_path: str = ""
    repro_line: str = ""
    steps: List[str] = field(default_factory=list)


def _clamped(sched: FaultSchedule, units: List[Tuple[str, object]],
             num_events: int) -> FaultSchedule:
    """A candidate schedule: the kept adversity units over a possibly
    shorter input stream (event positions clamp into the stream)."""
    cand = FaultSchedule(seed=sched.seed, num_events=num_events,
                         ngroups=sched.ngroups)
    for kind, u in units:
        if kind == "clause":
            cand.clauses.append(u)
        else:
            ev = dict(u)
            if "at" in ev:
                ev["at"] = min(int(ev["at"]), num_events)
            cand.events.append(ev)
    cand.events.sort(key=lambda e: (e.get("at", 0), e["kind"]))
    return cand


def shrink_schedule(schedule: FaultSchedule, workdir: str,
                    cfg: Optional[SimConfig] = None,
                    planted_bug: Optional[str] = None,
                    max_runs: int = 64,
                    max_vtime: float = 600.0,
                    min_events: int = 16,
                    log: Callable[[str], None] = lambda s: None,
                    ) -> Optional[ShrinkResult]:
    """Shrink a red schedule to a locally minimal one. Returns None if
    the schedule is not red in the first place (nothing to shrink)."""
    cfg = cfg or SimConfig()
    os.makedirs(workdir, exist_ok=True)
    runs = [0]
    last_red: List[Optional[SimResult]] = [None]

    def execute(cand: FaultSchedule) -> Optional[SimResult]:
        runs[0] += 1
        root = os.path.join(workdir, f"try{runs[0]:04d}")
        try:
            return run_sim(cand, root, cfg=cfg,
                           planted_bug=planted_bug,
                           max_vtime=max_vtime)
        except Exception as e:      # harness-killing schedule: red
            log(f"candidate raised {type(e).__name__}: {e}")
            return None

    def is_red(cand: FaultSchedule) -> bool:
        if runs[0] >= max_runs:
            return False            # budget spent: stop accepting
        res = execute(cand)
        if res is None:
            last_red[0] = None
            return True
        if not res.ok:
            last_red[0] = res
            return True
        return False

    baseline = execute(schedule)
    if baseline is not None and baseline.ok:
        return None
    last_red[0] = baseline
    original_size = schedule.size()
    steps: List[str] = [f"baseline red: {schedule.describe()}"]

    # -- phase 1: ddmin over the adversity units -----------------------
    units: List[Tuple[str, object]] = (
        [("clause", c) for c in schedule.clauses]
        + [("event", ev) for ev in schedule.events])
    num_events = schedule.num_events
    n = 2
    while len(units) >= 2 and runs[0] < max_runs:
        chunk = max(1, len(units) // n)
        reduced = False
        for i in range(0, len(units), chunk):
            cand_units = units[:i] + units[i + chunk:]
            if is_red(_clamped(schedule, cand_units, num_events)):
                dropped = len(units) - len(cand_units)
                units = cand_units
                steps.append(f"dropped {dropped} unit(s) -> "
                             f"{len(units)} left")
                log(steps[-1])
                n = max(2, n - 1)
                reduced = True
                break
        if not reduced:
            if n >= len(units):
                break
            n = min(len(units), n * 2)
    # singles pass (ddmin can stall above granularity 1)
    i = 0
    while i < len(units) and len(units) > 1 and runs[0] < max_runs:
        cand_units = units[:i] + units[i + 1:]
        if is_red(_clamped(schedule, cand_units, num_events)):
            units = cand_units
            steps.append(f"dropped 1 unit -> {len(units)} left")
            log(steps[-1])
        else:
            i += 1

    # -- phase 2: input-size reduction ---------------------------------
    while num_events // 2 >= min_events and runs[0] < max_runs:
        half = num_events // 2
        if is_red(_clamped(schedule, units, half)):
            num_events = half
            steps.append(f"halved input -> {num_events} events")
            log(steps[-1])
        else:
            break
    three_q = num_events - num_events // 4
    if (min_events <= three_q < num_events and runs[0] < max_runs
            and is_red(_clamped(schedule, units, three_q))):
        num_events = three_q
        steps.append(f"trimmed input -> {num_events} events")

    minimal = _clamped(schedule, units, num_events)
    # one final run into a KEPT directory: the repro kit's artifacts
    final_root = os.path.join(workdir, "run")
    try:
        final = run_sim(minimal, final_root, cfg=cfg,
                        planted_bug=planted_bug, max_vtime=max_vtime)
    except Exception:
        final = last_red[0]
    if final is None:
        final = last_red[0]
    out = ShrinkResult(schedule=minimal, result=final,
                       runs=runs[0],
                       removed=original_size - minimal.size(),
                       steps=steps)
    _write_repro_kit(out, workdir, final_root, cfg, planted_bug)
    return out


# ---------------------------------------------------------------------------
# the repro kit


def _write_repro_kit(out: ShrinkResult, workdir: str, run_root: str,
                     cfg: SimConfig,
                     planted_bug: Optional[str]) -> None:
    from kme_tpu_torch.wire import dumps_order
    from kme_tpu_torch.workload import spliced_stream

    sched = out.schedule
    out.repro_path = os.path.join(workdir, "repro.json")
    with open(out.repro_path, "w") as f:
        f.write(sched.to_json() + "\n")

    out.repro_line = f"kme-torch-sim --repro {out.repro_path}"
    if planted_bug:
        out.repro_line += f" --planted-bug {planted_bug}"
    out.cmd_path = os.path.join(workdir, "repro.cmd")
    with open(out.cmd_path, "w") as f:
        f.write(out.repro_line + "\n")

    # the audit.py repro-dump shape, so every offline tool that eats
    # audit dumps (and every engineer who knows them) can eat this one
    res = out.result
    violations = []
    if res is not None:
        for name in res.red_verdicts():
            violations.append({"invariant": f"sim.{name}",
                               "detail": res.verdicts[name]})
    splices = [(ev["at"], ev["profile"], ev.get("n", 100))
               for ev in sched.events if ev["kind"] == "storm"]
    inputs = [dumps_order(m) for m in
              spliced_stream(sched.num_events, seed=sched.seed,
                             splices=splices,
                             num_accounts=cfg.num_accounts,
                             num_symbols=cfg.num_symbols,
                             prefund_cash=cfg.prefund_cash)]
    gdir, xray = _xray_ref(run_root, res, cfg)
    doc = {"violations": violations,
           "batch": None,
           "pre_state": None,
           "events": list(sched.events),
           "inputs": inputs,
           "checkpoint_ref": gdir,
           "xray": xray,
           "schedule": json.loads(sched.to_json()),
           "repro": out.repro_line}
    out.dump_path = os.path.join(workdir, "sim_repro.json")
    with open(out.dump_path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)

    # the red run's merged control-plane timeline rides along: what
    # the cluster DECIDED (lease grants, reshard phases) on the way to
    # the red verdict, in one causally-ordered events.jsonl artifact
    from kme_tpu_torch.telemetry import events as cpevents

    try:
        tl = cpevents.merge_logs([run_root])
        if tl:
            cpevents.write_merged(
                tl, os.path.join(workdir, "events.jsonl"))
    except OSError:
        pass


def _xray_ref(run_root: str, res: Optional[SimResult],
              cfg: SimConfig) -> Tuple[Optional[str], Optional[str]]:
    """Point kme-torch-xray's divergence bisector at the red run's most
    suspicious group: the first one named by a red verdict, else g0 of
    the final generation."""
    if not os.path.isdir(run_root):
        return None, None
    gens = sorted(d for d in os.listdir(run_root)
                  if d.startswith("gen"))
    if not gens:
        return None, None
    gen_root = os.path.join(run_root, gens[-1])
    suspect = 0
    if res is not None:
        par = res.verdicts.get("parity", {})
        for mm in par.get("mismatches", []):
            if isinstance(mm, dict) and "group" in mm:
                suspect = int(mm["group"])
                break
        else:
            dups = res.verdicts.get("stamps", {}).get("duplicates", [])
            if dups:
                suspect = int(dups[0]["group"])
    gdir = os.path.join(gen_root, f"group{suspect}")
    if not os.path.isdir(gdir):
        gdir = os.path.join(gen_root, "group0")
        if not os.path.isdir(gdir):
            return None, None
    journal = os.path.join(gdir, "journal.bin")
    log_dir = os.path.join(gdir, "broker-log")
    if not os.path.exists(journal):
        return gdir, None
    # hi-batch: an upper bound on the red batch index — every applied
    # batch journaled, so offset/batch rounds up past the last one
    hi = 1
    if res is not None:
        hi = max(1, (res.counters.get("routed", 0) // cfg.batch) + 1)
    xray = (f"kme-torch-xray --bisect --journal {journal} "
            f"--log-dir {log_dir} --hi-batch {hi} "
            f"--checkpoint-dir {gdir}")
    return gdir, xray
