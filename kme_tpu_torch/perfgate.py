"""Perf-regression gate and stage attribution over recorded artifacts.

The port's copy of `kme_tpu/perfgate.py`: the same metric tables,
loader, comparison, report text, stage attribution and exit codes; only
the program names in messages are the port's. Pure Python: it imports
neither torch nor anything of the JAX package.

`python -m kme_tpu_torch.perfgate BASELINE CURRENT` compares the detail
metrics of two benchmark artifacts and exits non-zero on a regression
beyond the noise tolerance; `--attribute` names the pipeline stage that
moved instead. `kme-torch-prof --diff BASE CUR` runs the same
attribution over two TSDB stores (`telemetry.tsdb.window_summary`) or
two artifacts.

Two artifact realities shape the loader:

- A recorded driver artifact holds the bench's stderr under a "tail"
  key that is the LAST N BYTES of the stream — routinely TRUNCATED
  mid-JSON. So metrics are extracted with a `"name": number` regex over
  the raw text, never by parsing the whole document; the first
  occurrence wins (the root detail object precedes the nested java/
  sub-dicts that repeat metric names).
- An artifact names the backend that recorded it (`"backend"`; a card
  run's is `"cuda"`, what the port's device plane calls its backend).
  Cross-backend magnitudes are not comparable, so a backend mismatch
  demotes the gate to ADVISORY: the report is still printed/written,
  but the exit code stays 0.

Direction matters: throughput regresses by FALLING, latency by RISING.
`pipeline_speedup` stays advisory — it is a ratio of two wall clocks
and flaps across runs. `measured_overlap_frac` IS gated since its
definition over the collect wall (overlap / collect_wall converges
structurally to ~1.0 under working double-buffering), as is `local_s`
(the host-path wall the native layer exists to shrink).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

# metric name -> direction ("up" = bigger is better, "down" = smaller
# is better). Anything not listed is reported but never enforced.
GATED_METRICS = {
    "local_orders_per_sec": "up",
    "streamed_orders_per_sec": "up",
    "serial_orders_per_sec": "up",
    "orders_per_sec": "up",
    "engine_side_p50_ms": "down",
    "engine_side_p90_ms": "down",
    "engine_side_p99_ms": "down",
    "device_ms_per_batch": "down",
    "p50_ms": "down",
    "p90_ms": "down",
    "p99_ms": "down",
    # host-path metrics: the wall the host spends off the device, and
    # the fraction of collect wall hidden under device execution
    # (defined over the collect wall, so it is stable enough to gate —
    # unlike the wall-clock speedup ratio)
    "local_s": "down",
    "measured_overlap_frac": "up",
    # elastic sharding: max/mean per-shard occupancy under the skewed
    # suite — scale-free like measured_overlap_frac, so it gates
    # tightly even on jittery shared runners
    "shard_imbalance": "down",
    # multi-leader groups: transfer legs per order under the fixed-seed
    # suite — fully deterministic (router + prefund policy, no
    # wall-clock term), so it gates at zero noise
    "cross_shard_transfer_frac": "down",
    # adversarial storms: per-profile shed fraction from the
    # deterministic overload replay (broker.simulate_overload — no wall
    # clock, no RNG), gated at zero noise; a drift means the admission
    # policy or a profile generator changed behavior
    "shed_frac_payout_storm_wide": "down",
    "shed_frac_flash_crowd": "down",
    "shed_frac_cancel_storm": "down",
    "shed_frac_hot_book": "down",
    "shed_frac_liquidation_cascade": "down",
    # binary wire ingress: loopback-TCP binary produce rate and the
    # frame-decode wall of the timed binary run — wall-clock metrics,
    # gated with the host-gate tolerance
    "ingress_msgs_per_sec": "up",
    "wire_parse_s": "down",
    # market-data fan-out: frames delivered to subscriber sockets per
    # second of fan-out wall, and the admission-stamp -> frame-derivation
    # p99 — wall-clock metrics, gated with the host-gate tolerance
    "feed_msgs_per_sec": "up",
    "feed_lag_p99_ms": "down",
    # per-chip async dispatch: fraction of simulated chip time spent
    # stalled under the deterministic dispatch schedule (weighted
    # message costs, no wall clock, no RNG) — replay-stable, so it
    # gates at zero noise
    "chip_stall_frac": "down",
    # live resharding: fraction of the symbol+account key universe the
    # N→M reshard plan moves (reshard.plan_reshard) — pure rendezvous
    # arithmetic, no wall clock, gated at zero noise; a
    # consistent-hashing regression (salt drift, modulo hashing) jumps
    # it toward 1.0
    "moved_key_frac": "down",
}

# reported-only: too noisy to gate on (documented flappers).
# h2d_overlap_frac and chip_msgs_per_sec ride wall clocks on shared
# runners, so they report advisory-up instead of gating.
ADVISORY_METRICS = ("pipeline_speedup", "journal_overhead_frac",
                    "h2d_overlap_frac", "chip_msgs_per_sec",
                    # continuous profiling: both ride wall
                    # clocks/bandwidth probes on shared runners — the
                    # prof suite enforces its own 3% overhead ceiling
                    # in-process instead
                    "prof_overhead_frac", "transfer_compute_ratio",
                    # control-plane timeline: the reshard drill's
                    # migration pause decomposed by phase (the chaos
                    # reshard-under-storm report) — process spawns and
                    # drill pacing dominate these walls on shared
                    # runners, so they trend advisory-down rather than
                    # gate
                    "reshard_pause_ms", "reshard_drain_ms",
                    "reshard_fence_ms", "reshard_migrate_ms",
                    "reshard_settle_ms", "reshard_relaunch_ms",
                    "reshard_unattributed_ms")

_NUM = r"(-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)"


def extract_metrics(text: str) -> Dict[str, float]:
    """Regex-scrape `"name": number` pairs from artifact text.

    Tolerates truncated JSON (recorded tails start mid-object). First
    occurrence of each name wins — the root detail object precedes the
    nested sub-dicts (e.g. "java": {...}) that reuse metric names."""
    out: Dict[str, float] = {}
    for m in re.finditer(rf'"([A-Za-z_][A-Za-z0-9_]*)"\s*:\s*{_NUM}',
                         text):
        name, val = m.group(1), float(m.group(2))
        if name not in out:
            out[name] = val
    return out


def extract_backend(text: str) -> Optional[str]:
    m = re.search(r'"backend"\s*:\s*"([a-z]+)"', text)
    return m.group(1) if m else None


def load_artifact(path: str) -> Dict:
    """Load a benchmark artifact into {"metrics", "backend", "source"}.

    Accepts any of: a recorded driver artifact {"cmd","rc","tail",...}
    (metrics live in the tail text), a bench detail JSON, a headline
    JSON, or raw mixed stdout+stderr text."""
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    source = "text"
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and isinstance(doc.get("tail"), str):
        text = doc["tail"]
        source = "driver-tail"
    elif doc is not None:
        source = "json"
    return {"metrics": extract_metrics(text),
            "backend": extract_backend(text), "source": source}


def detail_to_artifact(detail: dict) -> Dict:
    """Adapt a live bench `detail` dict to the artifact shape."""
    text = json.dumps(detail)
    return {"metrics": extract_metrics(text),
            "backend": extract_backend(text), "source": "live"}


def compare(baseline: Dict, current: Dict,
            tolerance: float = 0.25) -> Dict:
    """Direction-aware comparison of two artifacts.

    A gated metric regresses when it is worse than baseline by more
    than `tolerance` (fractional: 0.25 allows a 25 % degradation
    before failing — wide enough for shared-CI noise, far inside the
    2x slowdown the gate exists to catch). Returns a report dict;
    `ok` is False only when a gated metric regressed AND the backends
    match (else `advisory` is True and exit stays 0)."""
    bm, cm = baseline["metrics"], current["metrics"]
    rows: List[dict] = []
    regressions: List[str] = []
    for name, direction in GATED_METRICS.items():
        if name not in bm or name not in cm:
            continue
        base, cur = bm[name], cm[name]
        if base <= 0:
            continue
        ratio = cur / base
        # normalize so ratio > 1 always means WORSE
        worse = 1.0 / ratio if direction == "up" else ratio
        status = "ok"
        if worse > 1.0 + tolerance:
            status = "regressed"
            regressions.append(name)
        rows.append({"name": name, "direction": direction,
                     "baseline": base, "current": cur,
                     "ratio": round(ratio, 4), "status": status})
    for name in ADVISORY_METRICS:
        if name in bm and name in cm:
            rows.append({"name": name, "direction": "advisory",
                         "baseline": bm[name], "current": cm[name],
                         "ratio": (round(cm[name] / bm[name], 4)
                                   if bm[name] else None),
                         "status": "advisory"})
    mismatch = (baseline.get("backend") and current.get("backend")
                and baseline["backend"] != current["backend"])
    return {
        "tolerance": tolerance,
        "baseline_backend": baseline.get("backend"),
        "current_backend": current.get("backend"),
        "backend_mismatch": bool(mismatch),
        "advisory": bool(mismatch),
        "compared": len(rows),
        "regressions": regressions,
        "metrics": rows,
        "ok": not regressions or bool(mismatch),
    }


def format_report(report: Dict) -> str:
    lines = []
    for row in report["metrics"]:
        mark = {"ok": " ", "regressed": "!", "advisory": "~"}[
            row["status"]]
        lines.append(
            f"{mark} {row['name']:<28s} base={row['baseline']:<14g} "
            f"cur={row['current']:<14g} ratio={row['ratio']}")
    if report["backend_mismatch"]:
        lines.append(
            f"~ backend mismatch: baseline={report['baseline_backend']} "
            f"current={report['current_backend']} — gate is ADVISORY "
            f"(exit 0)")
    if report["regressions"] and not report["advisory"]:
        lines.append(f"! REGRESSION beyond {report['tolerance']:.0%} "
                     f"tolerance: {', '.join(report['regressions'])}")
    elif report["regressions"]:
        lines.append(f"~ would-be regressions (advisory): "
                     f"{', '.join(report['regressions'])}")
    else:
        lines.append(f"gate clean: {report['compared']} metric(s) "
                     f"within {report['tolerance']:.0%}")
    return "\n".join(lines)


# -- stage-level regression attribution --------------------------------
#
# Given two metric dicts (TSDB window summaries via
# telemetry.tsdb.window_summary, or artifact metrics via
# load_artifact), name the pipeline stage whose evidence moved the
# most. Each stage lists every metric that testifies about it: the
# per-stage latency quantiles (lat_<stage>.p99_ms, flattened TSDB
# names), the host sampling profiler's stage fractions
# (prof_stage_frac_*), and the bench-artifact spellings
# (device_ms_per_batch, p99_ms). A metric missing on either side is
# simply skipped — the verdict is built from whatever evidence both
# windows share.
STAGE_ATTRIBUTION: Dict[str, tuple] = {
    "parse": ("lat_ingress.p99_ms", "prof_stage_frac_parse",
              "wire_parse_s"),
    "plan": ("lat_plan.p99_ms", "prof_stage_frac_plan", "plan_s"),
    "device": ("lat_device.p99_ms", "prof_stage_frac_dispatch",
               "prof_stage_frac_collect", "device_ms_per_batch",
               "engine_side_p99_ms"),
    "produce": ("lat_produce.p99_ms", "prof_stage_frac_produce"),
    "e2e": ("lat_e2e.p99_ms", "p99_ms"),
}


def attribute_regression(base: Dict[str, float],
                         cur: Dict[str, float]) -> Dict:
    """Rank pipeline stages by how much their evidence degraded
    between two metric dicts. Returns {"stages": [...worst first...],
    "suspect": <stage name or None>}; a stage's score is the worst
    relative increase among its shared metrics (1.0 = unchanged)."""
    stages: List[dict] = []
    for stage, names in STAGE_ATTRIBUTION.items():
        evidence = []
        score = 1.0
        for name in names:
            b, c = base.get(name), cur.get(name)
            if b is None or c is None or b <= 0:
                continue
            ratio = c / b
            evidence.append({"name": name, "baseline": b,
                             "current": c, "ratio": round(ratio, 4)})
            score = max(score, ratio)
        if evidence:
            stages.append({"stage": stage, "score": round(score, 4),
                           "evidence": evidence})
    stages.sort(key=lambda s: -s["score"])
    # "e2e" restates the symptom, never the cause: only name it when
    # no concrete stage moved with it
    suspect = None
    for s in stages:
        if s["score"] > 1.05 and s["stage"] != "e2e":
            suspect = s["stage"]
            break
    if suspect is None and stages and stages[0]["score"] > 1.05:
        suspect = stages[0]["stage"]
    return {"stages": stages, "suspect": suspect}


def format_attribution(att: Dict) -> str:
    lines = []
    for s in att["stages"]:
        mark = "!" if s["stage"] == att["suspect"] else " "
        ev = ", ".join(f"{e['name']} x{e['ratio']}"
                       for e in s["evidence"][:3])
        lines.append(f"{mark} stage {s['stage']:<8s} "
                     f"x{s['score']:<8g} {ev}")
    if att["suspect"]:
        lines.append(f"! attribution: the {att['suspect']} stage moved "
                     f"the most")
    else:
        lines.append("attribution: no stage moved beyond 5%")
    return "\n".join(lines)


def run_gate(baseline_path: str, current: Dict,
             tolerance: float = 0.25,
             report_path: Optional[str] = None) -> int:
    """Compare, print, optionally persist the report; return the exit
    code (0 clean/advisory, 1 regression, 2 unusable baseline)."""
    import sys

    baseline = load_artifact(baseline_path)
    if not baseline["metrics"]:
        print(f"kme-torch-perfgate: no metrics found in "
              f"{baseline_path!r}; cannot gate", file=sys.stderr)
        return 2
    report = compare(baseline, current, tolerance=tolerance)
    print(format_report(report), file=sys.stderr)
    if report["regressions"]:
        # a failing (or would-fail) gate names its suspect stage too —
        # the same attribution kme-torch-prof --diff prints over TSDB
        # windows
        att = attribute_regression(baseline["metrics"],
                                   current["metrics"])
        report["attribution"] = att
        print(format_attribution(att), file=sys.stderr)
    if report_path is not None:
        with open(report_path, "w") as f:
            json.dump(report, f, indent=2)
        print(f"kme-torch-perfgate: report written to {report_path}",
              file=sys.stderr)
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    """Standalone gate/attribution CLI:
    `python -m kme_tpu_torch.perfgate BASELINE CURRENT [--attribute]`.
    Both operands are benchmark artifacts (driver tails, detail JSON,
    or raw text). --attribute prints the per-stage verdict instead of
    gating."""
    import argparse
    import sys

    p = argparse.ArgumentParser(prog="kme-torch-perfgate",
                                description=main.__doc__)
    p.add_argument("baseline", help="recorded artifact (BENCH_*.json)")
    p.add_argument("current", help="artifact to judge against it")
    p.add_argument("--tolerance", type=float, default=0.25)
    p.add_argument("--attribute", action="store_true",
                   help="per-stage regression attribution only "
                        "(exit 0 clean, 1 when a stage moved >5%%)")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="write the JSON report here")
    args = p.parse_args(argv)
    if args.attribute:
        base = load_artifact(args.baseline)
        cur = load_artifact(args.current)
        if not base["metrics"] or not cur["metrics"]:
            print("kme-torch-perfgate: no metrics on one side; cannot "
                  "attribute", file=sys.stderr)
            return 2
        att = attribute_regression(base["metrics"], cur["metrics"])
        print(format_attribution(att))
        if args.report is not None:
            with open(args.report, "w") as f:
                json.dump(att, f, indent=2)
        return 1 if att["suspect"] else 0
    return run_gate(args.baseline, load_artifact(args.current),
                    tolerance=args.tolerance, report_path=args.report)


if __name__ == "__main__":
    import sys

    sys.exit(main())
