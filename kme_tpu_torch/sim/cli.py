"""``kme-torch-sim`` — the deterministic simulation driver.

Three modes:

- ``--seed N``      one run, full verdicts + both determinism digests;
- ``--seeds A..B``  a sweep: every seed in the range gets its own
  generated schedule and a fresh run directory; red seeds are shrunk
  (ddmin over the fault schedule + input reduction) into a repro kit
  and reported as one-line repros. ``--jobs J`` fans the sweep over
  worker PROCESSES (the fault plan is process-global state, so
  parallelism is process-level by construction — runs never share an
  interpreter);
- ``--repro FILE``  replay a schedule JSON (as written by the shrinker
  or ``--dump-schedule``) offline: no sweep, no shrink, exit red/green.

Exit codes: 0 all green, 1 red verdicts (repros printed), 2 usage.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import List, Optional, Tuple

from kme_tpu_torch.sim.cluster import SimConfig, run_sim
from kme_tpu_torch.sim.schedule import FaultSchedule, generate_schedule


def _parse_seeds(spec: str) -> List[int]:
    if ".." in spec:
        lo, hi = spec.split("..", 1)
        lo, hi = int(lo), int(hi)
        if hi < lo:
            raise ValueError(f"empty seed range {spec!r}")
        return list(range(lo, hi + 1))
    return [int(s) for s in spec.split(",")]


def _cfg_from(args) -> SimConfig:
    return SimConfig(checkpoint_every=args.checkpoint_every,
                     batch=args.batch)


def _one(seed: int, args, out_dir: str) -> dict:
    """Run one seed into ``out_dir`` (sweep worker body — must stay
    importable for process pools). Returns a plain-dict summary."""
    sched = generate_schedule(seed, num_events=args.events,
                              ngroups=args.groups,
                              profile=args.profile)
    root = os.path.join(out_dir, f"seed{seed}")
    try:
        res = run_sim(sched, root, cfg=_cfg_from(args),
                      planted_bug=args.planted_bug,
                      max_vtime=args.max_vtime)
    except Exception as e:
        return {"seed": seed, "ok": False, "error":
                f"{type(e).__name__}: {e}",
                "schedule": sched.to_json()}
    return {"seed": seed, "ok": res.ok,
            "red": res.red_verdicts(),
            "trace_digest": res.trace_digest,
            "out_digest": res.out_digest,
            "vtime": res.vtime,
            "counters": res.counters,
            "describe": sched.describe(),
            "schedule": sched.to_json()}


def _sweep_worker(packed: Tuple[int, dict, str]) -> dict:
    """Top-level so ProcessPoolExecutor can pickle it."""
    seed, argd, out_dir = packed
    args = argparse.Namespace(**argd)
    return _one(seed, args, out_dir)


def _shrink_red(seed: int, summary: dict, args, out_dir: str) -> dict:
    from kme_tpu_torch.sim.shrink import shrink_schedule

    sched = FaultSchedule.from_json(summary["schedule"])
    workdir = os.path.join(out_dir, f"red-seed{seed}")
    sr = shrink_schedule(sched, workdir, cfg=_cfg_from(args),
                         planted_bug=args.planted_bug,
                         max_runs=args.shrink_runs,
                         max_vtime=args.max_vtime,
                         log=lambda s: print(f"  shrink[{seed}]: {s}",
                                             file=sys.stderr))
    if sr is None:      # did not reproduce — report, don't hide
        return {"seed": seed, "reproduced": False}
    return {"seed": seed, "reproduced": True,
            "minimal": sr.schedule.describe(),
            "size": sr.schedule.size(),
            "removed": sr.removed,
            "shrink_runs": sr.runs,
            "repro": sr.repro_line,
            "repro_json": sr.repro_path,
            "dump": sr.dump_path,
            "xray": _dump_field(sr.dump_path, "xray")}


def _dump_field(path: str, key: str):
    try:
        with open(path) as f:
            return json.load(f).get(key)
    except (OSError, ValueError):
        return None


def sim_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="kme-torch-sim",
        description="deterministic whole-cluster simulation: seeded "
                    "virtual-clock runs, seed sweeps, shrinking repros")
    p.add_argument("--seed", type=int, default=None,
                   help="run ONE seed and print its verdicts")
    p.add_argument("--seeds", default=None,
                   help="sweep a range A..B (inclusive) or list A,B,C")
    p.add_argument("--repro", default=None, metavar="FILE",
                   help="replay a schedule JSON (from the shrinker) "
                        "and exit red/green")
    p.add_argument("--events", type=int, default=400,
                   help="baseline workload size per run (default 400)")
    p.add_argument("--groups", type=int, default=2,
                   help="initial shard-group count (default 2)")
    p.add_argument("--profile", default=None,
                   help="pin storm splices to ONE named profile "
                        "(default: schedule-generator's choice)")
    p.add_argument("--jobs", type=int, default=1,
                   help="sweep worker PROCESSES (default 1)")
    p.add_argument("--out", default=None, metavar="DIR",
                   help="keep run artifacts here (default: temp dir, "
                        "green runs deleted)")
    p.add_argument("--planted-bug", default=None,
                   help="arm a known-bug hook (shrinker drill; "
                        "see sim.cluster.PLANTED_BUGS)")
    p.add_argument("--no-shrink", action="store_true",
                   help="report red seeds without shrinking them")
    p.add_argument("--shrink-runs", type=int, default=64,
                   help="candidate-run budget per red seed (default 64)")
    p.add_argument("--max-vtime", type=float, default=600.0,
                   help="virtual-seconds wedge backstop (default 600)")
    p.add_argument("--checkpoint-every", type=int, default=48)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--trace", action="store_true",
                   help="with --seed/--repro: print the event trace")
    p.add_argument("--dump-schedule", action="store_true",
                   help="with --seed: print the generated schedule "
                        "JSON and exit (no run)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    args = p.parse_args(argv)

    modes = sum(x is not None for x in
                (args.seed, args.seeds, args.repro))
    if modes != 1:
        p.error("exactly one of --seed, --seeds, --repro is required")

    if args.repro is not None:
        return _repro_mode(args)
    if args.seed is not None:
        return _single_mode(args)
    return _sweep_mode(args)


# ---------------------------------------------------------------------------


def _print_result(res, args) -> None:
    if args.json:
        print(json.dumps(
            {"seed": res.seed, "ok": res.ok, "verdicts": res.verdicts,
             "trace_digest": res.trace_digest,
             "out_digest": res.out_digest, "vtime": res.vtime,
             "counters": res.counters,
             "schedule": json.loads(res.schedule.to_json())},
            indent=1, sort_keys=True))
        return
    print(f"kme-torch-sim: seed {res.seed} "
          f"{'GREEN' if res.ok else 'RED'} "
          f"(vtime {res.vtime}s, {res.counters['routed']} routed, "
          f"{res.counters['crashes']} crashes, "
          f"{res.counters['faults_fired']} faults)")
    print(f"  schedule: {res.schedule.describe()}")
    for name in sorted(res.verdicts):
        v = res.verdicts[name]
        mark = "ok " if v.get("ok") else "RED"
        extra = {k: w for k, w in v.items() if k != "ok" and w}
        print(f"  [{mark}] {name}"
              + (f" {extra}" if extra and not v.get("ok") else ""))
    print(f"  trace={res.trace_digest[:16]} "
          f"out={res.out_digest[:16]}")


def _single_mode(args) -> int:
    sched = generate_schedule(args.seed, num_events=args.events,
                              ngroups=args.groups,
                              profile=args.profile)
    if args.dump_schedule:
        print(sched.to_json())
        return 0
    out_dir, cleanup = _out_dir(args)
    try:
        res = run_sim(sched, os.path.join(out_dir, f"seed{args.seed}"),
                      cfg=_cfg_from(args),
                      planted_bug=args.planted_bug,
                      max_vtime=args.max_vtime)
        if args.trace:
            for ev in res.events:
                print(f"  {ev[0]:>12.6f} {ev[1]:<14} {ev[2]:<16} "
                      + " ".join(f"{k}={v}" for k, v in ev[3]),
                      file=sys.stderr)
        _print_result(res, args)
        return 0 if res.ok else 1
    finally:
        if cleanup:
            shutil.rmtree(out_dir, ignore_errors=True)


def _repro_mode(args) -> int:
    try:
        with open(args.repro) as f:
            sched = FaultSchedule.from_json(f.read())
    except (OSError, ValueError, KeyError) as e:
        print(f"kme-torch-sim: bad repro file: {e}", file=sys.stderr)
        return 2
    out_dir, cleanup = _out_dir(args)
    try:
        res = run_sim(sched, os.path.join(out_dir, "repro"),
                      cfg=_cfg_from(args),
                      planted_bug=args.planted_bug,
                      max_vtime=args.max_vtime)
        if args.trace:
            for ev in res.events:
                print(f"  {ev[0]:>12.6f} {ev[1]:<14} {ev[2]:<16} "
                      + " ".join(f"{k}={v}" for k, v in ev[3]),
                      file=sys.stderr)
        _print_result(res, args)
        return 0 if res.ok else 1
    finally:
        if cleanup:
            shutil.rmtree(out_dir, ignore_errors=True)


def _out_dir(args) -> Tuple[str, bool]:
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        return args.out, False
    return tempfile.mkdtemp(prefix="kme-torch-sim-"), True


def _sweep_mode(args) -> int:
    try:
        seeds = _parse_seeds(args.seeds)
    except ValueError as e:
        print(f"kme-torch-sim: {e}", file=sys.stderr)
        return 2
    out_dir, cleanup = _out_dir(args)
    argd = vars(args)
    summaries: List[dict] = []
    try:
        if args.jobs > 1:
            import concurrent.futures as cf
            with cf.ProcessPoolExecutor(max_workers=args.jobs) as ex:
                summaries = list(ex.map(
                    _sweep_worker,
                    [(s, argd, out_dir) for s in seeds]))
        else:
            for s in seeds:
                summaries.append(_one(s, args, out_dir))

        reds = [s for s in summaries if not s["ok"]]
        digests = {}
        for s in summaries:
            if "trace_digest" in s:
                digests.setdefault(
                    (s["trace_digest"], s["out_digest"]),
                    []).append(s["seed"])
        if not args.json:
            print(f"kme-torch-sim: swept {len(seeds)} seeds -> "
                  f"{len(seeds) - len(reds)} green, {len(reds)} red")
        shrunk = []
        for s in reds:
            if not args.json:
                why = s.get("red") or [s.get("error", "exception")]
                print(f"  RED seed {s['seed']}: {', '.join(why)}")
                print(f"    schedule: {s.get('describe', '?')}")
            if not args.no_shrink and "error" not in s:
                sk = _shrink_red(s["seed"], s, args, out_dir)
                shrunk.append(sk)
                if not args.json and sk.get("reproduced"):
                    print(f"    shrunk {sk['removed']} unit(s) away "
                          f"in {sk['shrink_runs']} runs -> "
                          f"size {sk['size']}: {sk['minimal']}")
                    print(f"    repro: {sk['repro']}")
                    if sk.get("xray"):
                        print(f"    xray:  {sk['xray']}")
        if args.json:
            print(json.dumps({"seeds": len(seeds),
                              "red": [s["seed"] for s in reds],
                              "results": summaries,
                              "shrunk": shrunk},
                             indent=1, sort_keys=True))
        # a sweep where every green seed collides on one digest pair
        # would mean the schedule generator is inert — flag it
        if (not args.json and len(seeds) > 1
                and len(digests) == 1 and not reds):
            print("kme-torch-sim: WARNING: all seeds produced identical "
                  "digests — nondeterminism sources look disconnected",
                  file=sys.stderr)
        return 1 if reds else 0
    finally:
        if cleanup and not any(not s["ok"] for s in summaries):
            shutil.rmtree(out_dir, ignore_errors=True)
        elif cleanup:
            print(f"kme-torch-sim: red artifacts kept in {out_dir}",
                  file=sys.stderr)
    return 0
