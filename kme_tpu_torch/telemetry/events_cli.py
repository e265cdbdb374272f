"""kme-torch-events: merge per-process control-plane event logs into one
causally-ordered cluster timeline — filter it, follow it live, explain
one event from the metrics history, or render it into the trace viewer.

The port's copy of `kme_tpu/telemetry/events_cli.py`.

Sources are event-log files or state-root directories (discovered
recursively: every ``events-*.jsonl`` writer plus merged
``events.jsonl`` artifacts, rotated segments included). The merge is
the pure events.py pipeline: first-wins dedup on (source, event_seq),
then offset-anchored causal order with walltime fallback.

``--why SRC:SEQ`` answers "what changed around this decision": it
takes the event's timestamp, summarizes the TSDB metrics history
(``--store``) over the windows before and after it with the same
``window_summary`` machinery kme-torch-prof's regression attribution uses,
and prints the biggest deltas — counters as rate deltas, gauges as
mean shifts.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Set, Tuple

from kme_tpu_torch.telemetry import events as ev_mod


_fmt_event = ev_mod.format_event


def _passes(ev: dict, args) -> bool:
    if args.source and args.source not in str(ev.get("src", "")):
        return False
    if args.kind and args.kind not in str(ev.get("kind", "")):
        return False
    if args.severity and ev.get("sev") != args.severity:
        return False
    if args.group is not None and int(ev.get("g", -1)) != args.group:
        return False
    ts = int(ev.get("ts", 0)) / 1e6
    if args.since is not None and ts < args.since:
        return False
    if args.until is not None and ts > args.until:
        return False
    return True


def _merged(paths: List[str]) -> List[dict]:
    return ev_mod.merge_logs(paths)


def _find_event(timeline: List[dict], ref: str) -> Optional[dict]:
    """Resolve ``--why`` refs: "SRC:SEQ" (exact identity) or a bare
    kind substring (first match, causal order)."""
    if ":" in ref:
        src, _, seq_s = ref.rpartition(":")
        try:
            seq = int(seq_s)
        except ValueError:
            seq = None
        if seq is not None:
            for ev in timeline:
                if ev.get("src") == src and int(ev.get("seq", -1)) == seq:
                    return ev
    for ev in timeline:
        if ref in str(ev.get("kind", "")):
            return ev
    return None


def _why(ev: dict, store: str, window_s: float, top: int,
         out=None) -> int:
    from kme_tpu_torch.telemetry.tsdb import window_summary

    out = out if out is not None else sys.stdout

    ts = int(ev.get("ts", 0))
    w = int(window_s * 1e6)
    before = window_summary(store, t0_us=ts - w, t1_us=ts)
    after = window_summary(store, t0_us=ts, t1_us=ts + w)
    rows: List[Tuple[float, str, float, float]] = []
    for name in sorted(set(before) | set(after)):
        b = before.get(name, 0.0)
        a = after.get(name, 0.0)
        if b == a:
            continue
        denom = max(abs(b), 1e-12)
        rows.append((abs(a - b) / denom, name, b, a))
    rows.sort(reverse=True)
    print(f"why {ev.get('src')}#{ev.get('seq')} {ev.get('kind')} "
          f"@ {ts / 1e6:.6f} (±{window_s:g}s window, store {store})",
          file=out)
    if not rows:
        print("  no metric moved across the window", file=out)
        return 0
    for rel, name, b, a in rows[:top]:
        print(f"  {name}: {b:g} -> {a:g}  ({a - b:+g}, "
              f"{rel:+.1%} rel)", file=out)
    return 0


def _follow(paths: List[str], args, out=None) -> int:
    out = out if out is not None else sys.stdout
    seen: Set[Tuple[str, int]] = set()
    try:
        while True:
            fresh = []
            for ev in _merged(paths):
                key = (str(ev.get("src", "")), int(ev.get("seq", -1)))
                if key in seen:
                    continue
                seen.add(key)
                if _passes(ev, args):
                    fresh.append(ev)
            for ev in fresh:
                print(json.dumps(ev, sort_keys=True) if args.json
                      else _fmt_event(ev), file=out)
            out.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kme-torch-events",
                                description=__doc__)
    p.add_argument("sources", nargs="*", default=None,
                   metavar="PATH",
                   help="event-log files or state-root directories "
                        "(default: current directory)")
    p.add_argument("--source", default=None,
                   help="only events whose src contains this")
    p.add_argument("--kind", default=None,
                   help="only events whose kind contains this")
    p.add_argument("--severity", default=None,
                   choices=list(ev_mod.SEVERITIES))
    p.add_argument("--group", type=int, default=None,
                   help="only events anchored to this group")
    p.add_argument("--since", type=float, default=None,
                   metavar="EPOCH_S")
    p.add_argument("--until", type=float, default=None,
                   metavar="EPOCH_S")
    p.add_argument("--tail", type=int, default=None, metavar="N",
                   help="only the last N matching events")
    p.add_argument("--json", action="store_true",
                   help="JSONL output instead of human lines")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="also write the merged (unfiltered) timeline "
                        "as a canonical events.jsonl artifact")
    p.add_argument("--chrome-out", default=None, metavar="PATH",
                   help="write the filtered timeline as Chrome "
                        "trace-events (control-plane spans in the "
                        "same viewer as the data-plane traces)")
    p.add_argument("--follow", action="store_true",
                   help="poll the sources and stream new events")
    p.add_argument("--interval", type=float, default=0.5,
                   help="--follow poll cadence seconds")
    p.add_argument("--why", default=None, metavar="SRC:SEQ|KIND",
                   help="explain one event: TSDB metric deltas over "
                        "the windows before/after it")
    p.add_argument("--store", default=None, metavar="DIR",
                   help="TSDB store directory for --why")
    p.add_argument("--window", type=float, default=5.0,
                   help="--why window half-width, seconds")
    p.add_argument("--top", type=int, default=12,
                   help="--why: how many deltas to print")
    args = p.parse_args(argv)
    paths = args.sources or ["."]

    if args.follow:
        return _follow(paths, args)

    timeline = _merged(paths)
    if args.out:
        ev_mod.write_merged(timeline, args.out)

    if args.why is not None:
        if not args.store:
            p.error("--why needs --store (TSDB directory)")
        target = _find_event(timeline, args.why)
        if target is None:
            print(f"kme-torch-events: no event matches {args.why!r}",
                  file=sys.stderr)
            return 2
        return _why(target, args.store, args.window, args.top)

    picked = [ev for ev in timeline if _passes(ev, args)]
    if args.tail is not None:
        picked = picked[-max(0, args.tail):]
    if args.chrome_out:
        with open(args.chrome_out, "w") as f:
            json.dump({"traceEvents": ev_mod.to_chrome(picked),
                       "displayTimeUnit": "ms"}, f)
    for ev in picked:
        print(json.dumps(ev, sort_keys=True) if args.json
              else _fmt_event(ev))
    if not args.json:
        print(f"kme-torch-events: {len(picked)}/{len(timeline)} events "
              f"from {len(paths)} source(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":          # pragma: no cover
    raise SystemExit(main())
